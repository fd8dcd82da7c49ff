"""Model configuration (counterpart of `mmtpu/config/model.py`).

Every YAML key that is not a declared field ends up in `kwargs` and becomes
a model constructor argument. `pretrained_path` (a C-MAM base's checkpoint)
is a field, as in mmtpu, so it never reaches a constructor. Encoder values arrive as ModuleSpecs and are
built into torch modules at model-construction time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

from mmtpu_torch.config.base import BaseConfig
from mmtpu_torch.config.spec import specs_from_dicts
from mmtpu_torch.utils import SafeDict


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

    def validate_config(self, run_id: int = 1) -> None:
        """mmtpu's fail-fast check: a `pretrained_path` (formatted with
        `run_id`, `.pth` or its `.ckpt` sibling) must exist; it becomes the
        resolved absolute path. Loading defers the check, as mmtpu's does."""
        if self.pretrained_path is not None:
            from mmtpu_torch.checkpoints.manager import resolve_checkpoint_path

            path = self.format_path(str(self.pretrained_path), run_id)
            try:
                path = resolve_checkpoint_path(path)
            except FileNotFoundError:
                raise FileNotFoundError(f"Pretrained path not found: {path}") from None
            self.pretrained_path = str(path.resolve())

    def get_param(self, param: str, default: Any = None) -> Any:
        if param in {"name", "model_type", "pretrained_path", "version"}:
            return getattr(self, param)
        return self.kwargs.get(param, default)

    def update_kwargs(self, **kwargs: Any) -> None:
        self.kwargs.update(kwargs)

    def format_path(self, path: str, run_id: int) -> Optional[Path]:
        if not path:
            return None
        return Path(str(path).format_map(SafeDict(run_id=run_id)))

    def to_dict(self) -> Dict[str, Any]:
        base = {"name": self.name, "model_type": self.model_type}
        if self.pretrained_path:
            base["pretrained_path"] = self.pretrained_path
        if self.pretrained_encoders:
            base["pretrained_encoders"] = self.pretrained_encoders
        base.update(self.kwargs)
        return base
