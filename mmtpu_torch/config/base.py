"""Dataclass config base (counterpart of `mmtpu/config/base.py`)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T", bound="BaseConfig")


@dataclasses.dataclass
class BaseConfig:
    """from_dict / to_dict for all config dataclasses. Keys that are not
    fields are dropped, as in mmtpu."""

    @classmethod
    def from_dict(cls: Type[T], data: Dict[str, Any], **extra: Any) -> T:
        if isinstance(data, cls):
            return data
        merged = {**data, **extra}
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in merged.items() if k in names})

    @classmethod
    def from_yaml(cls: Type[T], path: str | Path) -> T:
        """The section in a YAML file of its own, parsed with the port's
        tags (`yaml_tags.load_yaml`)."""
        from mmtpu_torch.config.yaml_tags import load_yaml

        return cls.from_dict(load_yaml(path))

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    @classmethod
    def _known_and_kwargs(cls, data: Dict[str, Any]) -> Dict[str, Any]:
        """Fields by name; every other key goes into the `kwargs` field
        (mmtpu's funnel for model and dataset constructor arguments)."""
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in data.items() if k in names}
        unknown = {k: v for k, v in data.items() if k not in names}
        known["kwargs"] = {**unknown, **known.get("kwargs", {})}
        return known

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, BaseConfig):
                v = v.to_dict()
            out[f.name] = v
        return out
