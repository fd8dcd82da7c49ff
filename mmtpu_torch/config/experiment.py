"""Experiment-level configuration (counterpart of
`mmtpu/config/experiment.py`, the fields the serving and training paths
read).

`device` is kept so mmtpu configs load unchanged, but the port does not
read it: its entry points run on `cuda` unless the caller passes `--cpu`.
`precision` maps onto PyTorch's float32 switches
(`mmtpu_torch.cli.common.apply_precision`); `data_parallel` is checked by
`mmtpu_torch.cli.common.resolve_mesh`. No global RNG is seeded here:
weights and data are made from explicit generators seeded with `seed`, and
the training entry points seed torch's generator (dropout) at run start.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from mmtpu_torch.config.base import BaseConfig


@dataclass
class ExperimentConfig(BaseConfig):
    name: str
    seed: Optional[int] = None
    device: str = "tpu"
    run_id: int = field(default_factory=lambda: int(time.time()))
    is_test: bool = True
    is_train: bool = True
    train_print_interval_epochs: int = 1
    dry_run: bool = False
    cross_validation: Optional[int] = None
    precision: Optional[str] = None
    # None/0/1 and -1 run on one device; N > 1 asks for data parallelism
    # over N devices (`cli.common.resolve_mesh`). --data-parallel overrides it
    data_parallel: Optional[int] = None

    def __post_init__(self) -> None:
        if self.seed is None:
            self.seed = int(time.time())
        if self.train_print_interval_epochs < 1:
            raise ValueError("train_print_interval_epochs must be >= 1")
