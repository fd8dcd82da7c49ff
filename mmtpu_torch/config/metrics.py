"""Metric configuration (counterpart of `mmtpu/config/metrics.py`).

Metrics are declared by dotted path with kwargs, and gathered into named
groups. `sklearn.metrics.*` names resolve to the port's own numpy
implementations (`mmtpu_torch.metrics.classification`, sklearn's
semantics: the card's machine has no sklearn); `metrics.*` names, which
mmtpu maps onto its own `mmtpu.metrics` package, map onto
`mmtpu_torch.metrics`; any other dotted name is imported as it is. Unlike
mmtpu, a name is resolved when a recorder is built, not when the config is
loaded, so `predict` and `serve` load configs whose metrics are not ported.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

from mmtpu_torch.config.base import BaseConfig

_SKLEARN = "sklearn.metrics."


def import_dotted(path: str) -> Callable:
    if path.startswith(_SKLEARN):
        path = "mmtpu_torch.metrics.classification." + path[len(_SKLEARN):]
    elif path.startswith("metrics."):
        path = "mmtpu_torch." + path
    module_path, attr = path.rsplit(".", 1)
    return getattr(importlib.import_module(module_path), attr)


@dataclass
class MetricDef:
    function: str
    kwargs: Dict[str, Any] = field(default_factory=dict)
    level: str = "epoch"

    def load(self) -> Callable:
        try:
            return import_dotted(self.function)
        except (ImportError, AttributeError) as e:
            raise ValueError(f"cannot import metric {self.function!r}: {e}") from e


@dataclass
class MetricConfig(BaseConfig):
    metrics: Dict[str, MetricDef] = field(default_factory=dict)
    groups: Dict[str, List[str]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.metrics = {
            name: d if isinstance(d, MetricDef) else MetricDef(**d)
            for name, d in self.metrics.items()
        }
        if self.metrics and not self.groups:
            # as mmtpu: configs without a groups block record everything
            # into 'classification'
            self.groups = {"classification": list(self.metrics)}
        for gname, members in self.groups.items():
            missing = [m for m in members if m not in self.metrics]
            if missing:
                raise ValueError(f"Group {gname!r} references unknown metrics {missing}")

    def get_group_metrics(self, group: str) -> Dict[str, MetricDef]:
        if group not in self.groups:
            raise KeyError(f"Unknown metric group: {group!r}")
        return {name: self.metrics[name] for name in self.groups[group]}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "metrics": {n: {"function": d.function, "kwargs": d.kwargs, "level": d.level}
                        for n, d in self.metrics.items()},
            "groups": {g: list(m) for g, m in self.groups.items()},
        }
