"""Model configuration (counterpart of `mmtpu/config/model.py`).

Every YAML key that is not a declared field ends up in `kwargs` and becomes
a model constructor argument. `pretrained_path` (a C-MAM base's checkpoint)
is a field, as in mmtpu, so it never reaches a constructor. Encoder values arrive as ModuleSpecs and are
built into torch modules at model-construction time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from mmtpu_torch.config.base import BaseConfig
from mmtpu_torch.config.spec import specs_from_dicts


@dataclass
class ModelConfig(BaseConfig):
    name: str
    model_type: str
    pretrained_encoders: Optional[Dict[str, str]] = None
    pretrained_path: Optional[str] = None
    kwargs: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, data: Dict[str, Any], **extra: Any) -> "ModelConfig":
        known = cls._known_and_kwargs({**data, **extra})
        known["kwargs"] = specs_from_dicts(known["kwargs"])
        return cls(**known)

    def to_dict(self) -> Dict[str, Any]:
        base = {"name": self.name, "model_type": self.model_type}
        if self.pretrained_path:
            base["pretrained_path"] = self.pretrained_path
        if self.pretrained_encoders:
            base["pretrained_encoders"] = self.pretrained_encoders
        base.update(self.kwargs)
        return base
