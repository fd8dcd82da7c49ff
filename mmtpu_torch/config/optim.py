"""Optimizer configuration with regex-scoped parameter groups (own copy of
`mmtpu/config/optim.py`).

An optimizer name, `default_kwargs`, and `parameter_groups` whose regex
`pattern`s select parameters by their mmtpu path (`audio_encoder/layer1_0/
conv1/kernel`, see `checkpoints.interop.mmtpu_param_path`) with per-group
lr / weight decay; a parameter matched by two groups is an error.
`mmtpu_torch/train/optim.py` builds the torch optimizer from it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from mmtpu_torch.config.base import BaseConfig


@dataclass
class ParameterGroupConfig(BaseConfig):
    pattern: str
    lr: Optional[float] = None
    weight_decay: Optional[float] = None
    kwargs: Dict[str, Any] = field(default_factory=dict)

    def matches(self, param_path: str) -> bool:
        """The group's regex finds the (mmtpu) parameter path."""
        return re.search(self.pattern, param_path) is not None

    def effective_kwargs(self, defaults: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(defaults)
        if self.lr is not None:
            out["lr"] = self.lr
        if self.weight_decay is not None:
            out["weight_decay"] = self.weight_decay
        out.update(self.kwargs)
        return out


@dataclass
class OptimizerConfig(BaseConfig):
    name: str
    default_kwargs: Dict[str, Any] = field(default_factory=dict)
    parameter_groups: List[ParameterGroupConfig] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.parameter_groups = [
            g if isinstance(g, ParameterGroupConfig) else ParameterGroupConfig.from_dict(g)
            for g in (self.parameter_groups or [])
        ]

    def validate_no_overlap(self, param_paths: List[str]) -> None:
        """Reject a parameter path matched by more than one group."""
        seen: Dict[str, str] = {}
        for group in self.parameter_groups:
            for path in param_paths:
                if group.matches(path):
                    if path in seen:
                        raise ValueError(f"Parameter {path!r} matched by both "
                                         f"{seen[path]!r} and {group.pattern!r}")
                    seen[path] = group.pattern

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "default_kwargs": dict(self.default_kwargs),
                "parameter_groups": [g.to_dict() for g in self.parameter_groups]}
