"""ModuleSpec — the deferred-construction record behind every model YAML
tag (counterpart of `mmtpu/config/spec.py`).

`!ResNet18 {hidden_dim: 64}` parses to ``ModuleSpec("resnet18", {...})``;
the torch module is built after the config is validated. A plain-dict
config spells the same record ``{"__module_spec__": "resnet18", ...}``
(`ModuleSpec.to_dict`), and `specs_from_dicts` turns it back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

SPEC_KEY = "__module_spec__"


@dataclasses.dataclass
class ModuleSpec:
    """A deferred module constructor: registry name + constructor kwargs."""

    name: str
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def build(self) -> Any:
        from mmtpu_torch.models.registry import build_module

        return build_module(self.name, **self.kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return {SPEC_KEY: self.name, **self.kwargs}


def specs_from_dicts(obj: Any) -> Any:
    """Recursively turn ``{"__module_spec__": name, ...}`` dicts into
    ModuleSpecs (the plain-dict spelling of a model YAML tag)."""
    if isinstance(obj, ModuleSpec):
        return obj
    if isinstance(obj, dict):
        if SPEC_KEY in obj:
            kwargs = {k: specs_from_dicts(v) for k, v in obj.items() if k != SPEC_KEY}
            return ModuleSpec(obj[SPEC_KEY], kwargs)
        return {k: specs_from_dicts(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(specs_from_dicts(v) for v in obj)
    return obj


def is_spec(obj: Any) -> bool:
    return isinstance(obj, ModuleSpec)


def build_specs(obj: Any) -> Any:
    """Recursively replace ModuleSpecs with built torch modules."""
    if isinstance(obj, ModuleSpec):
        return obj.build()
    if isinstance(obj, dict):
        return {k: build_specs(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(build_specs(v) for v in obj)
    return obj
