"""Eval step and losses of the port (training is not ported yet)."""
