"""Checkpoints of the port: `.pth` state_dicts under the reference's key
names, and the carry of mmtpu variables into them."""

from mmtpu_torch.checkpoints.interop import from_jax_variables, load_pth, save_pth

__all__ = ["from_jax_variables", "load_pth", "save_pth"]
