"""TrainingConfig + the top-level StandardMultimodalConfig (counterpart of
`mmtpu/config/training.py`).

`StandardMultimodalConfig.load` parses a YAML config with the port's tag
registry (`mmtpu_torch.config.yaml_tags`), or a `.json` file; `from_parsed`
assembles the same config from a plain dict (model tags spelled
``{"__module_spec__": name, ...}``), so a program can build its config
without PyYAML.
The optimizer, metrics and monitoring sections are kept as plain mappings:
the serving path does not read them, and training is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from mmtpu_torch.config.base import BaseConfig
from mmtpu_torch.config.data import DataConfig
from mmtpu_torch.config.experiment import ExperimentConfig
from mmtpu_torch.config.logging_ import LoggingConfig
from mmtpu_torch.config.model import ModelConfig
from mmtpu_torch.train.losses import LossFunctionGroup


@dataclass
class TrainingConfig(BaseConfig):
    """The training section as the AVMNIST configs write it. Serving reads
    only `loss_functions`; the optimizer sections stay plain mappings until
    training is ported."""

    epochs: int
    num_modalities: int
    optimizer: Dict[str, Any]
    loss_functions: LossFunctionGroup
    scheduler: Optional[str] = None
    scheduler_args: Dict[str, Any] = field(default_factory=dict)
    early_stopping: bool = False
    early_stopping_patience: int = 10
    encoder_optimizer: Optional[Dict[str, Any]] = None
    modality_specific_params: Optional[Dict[str, Dict[str, Any]]] = None

    @classmethod
    def from_dict(cls, data: Dict[str, Any], **extra: Any) -> "TrainingConfig":
        data = {**data, **extra}
        # YAML uses `scheduler_kwargs`; accept both spellings
        if "scheduler_kwargs" in data and "scheduler_args" not in data:
            data["scheduler_args"] = data.pop("scheduler_kwargs")
        data["loss_functions"] = LossFunctionGroup.from_dict(
            data.get("loss_functions") or {}
        )
        return super().from_dict(data)

    def __post_init__(self) -> None:
        if self.num_modalities < 1:
            raise ValueError("num_modalities must be >= 1")

    def to_dict(self) -> Dict[str, Any]:
        out = super().to_dict()
        out["loss_functions"] = self.loss_functions.to_dict()
        return out


@dataclass
class StandardMultimodalConfig(BaseConfig):
    experiment: ExperimentConfig
    data: DataConfig
    model: ModelConfig
    logging: LoggingConfig
    training: TrainingConfig
    metrics: Dict[str, Any] = field(default_factory=dict)
    monitoring: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def load(cls, path, run_id: int) -> "StandardMultimodalConfig":
        """Parse a YAML config with the port's tag registry, or a `.json`
        file holding the plain-dict form (needs no PyYAML), and assemble it."""
        if str(path).endswith(".json"):
            import json

            with open(path) as f:
                raw = json.load(f)
        else:
            from mmtpu_torch.config.yaml_tags import load_yaml

            raw = load_yaml(path)
        return cls.from_parsed(raw, run_id=run_id)

    @classmethod
    def from_parsed(cls, raw: Dict[str, Any], run_id: int) -> "StandardMultimodalConfig":
        """Assemble from the parsed mapping (YAML or a plain dict)."""
        experiment = ExperimentConfig.from_dict({**raw["experiment"], "run_id": run_id})
        logging_cfg = LoggingConfig.from_dict(
            raw["logging"], experiment_name=experiment.name, run_id=run_id
        )
        return cls(
            experiment=experiment,
            data=DataConfig.from_dict(raw["data"]),
            model=ModelConfig.from_dict(raw["model"]),
            logging=logging_cfg,
            training=TrainingConfig.from_dict(raw["training"]),
            metrics=dict(raw.get("metrics") or {}),
            monitoring=dict(raw.get("monitoring") or {}),
        )

    def to_dict(self) -> Dict[str, Any]:
        def plain(obj: Any) -> Any:
            if hasattr(obj, "to_dict"):
                return plain(obj.to_dict())
            if isinstance(obj, dict):
                return {str(k): plain(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return [plain(v) for v in obj]
            if isinstance(obj, str):
                return str(obj)  # Modality is a str subclass
            return obj

        return {
            name: plain(getattr(self, name))
            for name in ("experiment", "data", "model", "logging", "training",
                         "metrics", "monitoring")
        }
