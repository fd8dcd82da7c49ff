"""Experiment-level configuration (counterpart of
`mmtpu/config/experiment.py`, the fields the serving path and the AVMNIST
configs use).

`device` is kept so mmtpu configs load unchanged, but the port does not
read it: its entry points run on `cuda` unless the caller passes `--cpu`.
`precision` maps onto PyTorch's float32 switches
(`mmtpu_torch.cli.common.apply_precision`). No global RNG is seeded here;
weights and data are made from explicit generators seeded with `seed`.
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
    precision: Optional[str] = None

    def __post_init__(self) -> None:
        if self.seed is None:
            self.seed = int(time.time())
