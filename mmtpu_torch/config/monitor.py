"""Monitoring toggles and intervals (counterpart of `mmtpu/config/monitor.py`).

`weight_interval` and `enable_information_flow` are accepted and unread, as
in mmtpu and the reference: weights are recorded every epoch whenever
`enable_weight_tracking` is set. They are kept so the reference's configs
load unchanged."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from mmtpu_torch.config.base import BaseConfig


@dataclass
class MonitorConfig(BaseConfig):
    enabled: bool = False
    gradient_interval: int = 100
    activation_interval: int = 100
    weight_interval: int = 200
    buffer_size: int = 1000
    flush_interval: int = 100
    compression: Optional[str] = "gzip"
    compression_opts: int = 4
    enable_gradient_tracking: bool = True
    enable_activation_tracking: bool = True
    enable_weight_tracking: bool = True
    enable_layer_convergence: bool = True
    enable_information_flow: bool = False
    include_layers: Optional[list] = None
    exclude_layers: Optional[list] = None
