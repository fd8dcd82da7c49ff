"""Early stopping on a monitored metric (own copy of
`mmtpu/train/early_stopping.py`): 'loss' minimises, every other save
metric maximises; an improvement must beat the best by `min_delta`."""

from __future__ import annotations

from typing import Optional


class EarlyStopping:
    def __init__(self, patience: int = 10, min_delta: float = 0.001, mode: str = "min",
                 enabled: bool = True) -> None:
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.enabled = enabled
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def step(self, value: float) -> bool:
        """Record an epoch's metric; returns True if it is a new best."""
        if self.improved(value):
            self.best = value
            self.counter = 0
            return True
        self.counter += 1
        if self.enabled and self.counter >= self.patience:
            self.should_stop = True
        return False


def mode_for_metric(save_metric: str) -> str:
    return "min" if save_metric == "loss" else "max"
