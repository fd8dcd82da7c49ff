"""C-MAM experiment config (counterpart of mmtpu/config/cmam.py): the
standard multimodal config, whose `model` is the frozen base model, plus
`cmam`, a second ModelConfig for the cross-modal association model, and
`target_modality`. Loads from YAML (`!CMAMConfig`), from a `.json` file or
from a plain dict (`from_parsed`), as the other configs do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from mmtpu_torch.config.base import BaseConfig
from mmtpu_torch.config.model import ModelConfig
from mmtpu_torch.config.training import StandardMultimodalConfig, plain


@dataclass(kw_only=True)
class AssociationNetworkConfig(BaseConfig):
    input_size: int
    hidden_size: int
    output_size: int
    batch_norm: bool = False
    dropout: float = 0.0


@dataclass
class CMAMConfig(StandardMultimodalConfig):
    cmam: Optional[ModelConfig] = None
    target_modality: Optional[str] = None

    @classmethod
    def from_parsed(cls, raw: Dict[str, Any], run_id: int) -> "CMAMConfig":
        base = StandardMultimodalConfig.from_parsed(raw, run_id=run_id)
        return cls(**{name: getattr(base, name) for name in (
            "experiment", "data", "model", "logging", "training", "metrics", "monitoring")},
            cmam=ModelConfig.from_dict(raw["cmam"]),
            target_modality=raw.get("target_modality"))

    def to_dict(self) -> Dict[str, Any]:
        out = super().to_dict()
        if self.cmam is not None:
            out["cmam"] = plain(self.cmam)
        out["target_modality"] = str(self.target_modality)
        return out
