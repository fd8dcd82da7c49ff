"""TrainingConfig + the top-level StandardMultimodalConfig (counterpart of
`mmtpu/config/training.py`).

`StandardMultimodalConfig.load` parses a YAML config with the port's tag
registry (`mmtpu_torch.config.yaml_tags`), or a `.json` file; `from_parsed`
assembles the same config from a plain dict (model tags spelled
``{"__module_spec__": name, ...}``), so a program can build its config
without PyYAML.
The optimizer sections become `OptimizerConfig`s and the metrics section a
`MetricConfig` (whose dotted metric names are resolved when a recorder is
built, not at load: `predict` and `serve` never read them), and the
monitoring section a `MonitorConfig`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from mmtpu_torch.config.base import BaseConfig
from mmtpu_torch.config.data import DataConfig
from mmtpu_torch.config.experiment import ExperimentConfig
from mmtpu_torch.config.logging_ import LoggingConfig
from mmtpu_torch.config.metrics import MetricConfig
from mmtpu_torch.config.model import ModelConfig
from mmtpu_torch.config.monitor import MonitorConfig
from mmtpu_torch.config.optim import OptimizerConfig
from mmtpu_torch.train.losses import LossFunctionGroup


@dataclass
class TrainingConfig(BaseConfig):
    """The training section: epochs, the optimizer (and the encoders'
    optimizer with per-encoder overrides), the scheduler, early stopping and
    the loss terms."""

    epochs: int
    num_modalities: int
    optimizer: OptimizerConfig
    loss_functions: LossFunctionGroup
    scheduler: Optional[str] = None
    scheduler_args: Dict[str, Any] = field(default_factory=dict)
    early_stopping: bool = False
    early_stopping_patience: int = 10
    early_stopping_min_delta: float = 0.001
    encoder_optimizer: Optional[OptimizerConfig] = None
    modality_specific_params: Optional[Dict[str, Dict[str, Any]]] = None

    @classmethod
    def from_dict(cls, data: Dict[str, Any], **extra: Any) -> "TrainingConfig":
        data = {**data, **extra}
        # YAML uses `scheduler_kwargs`; accept both spellings
        if "scheduler_kwargs" in data and "scheduler_args" not in data:
            data["scheduler_args"] = data.pop("scheduler_kwargs")
        data["optimizer"] = OptimizerConfig.from_dict(data["optimizer"])
        if data.get("encoder_optimizer") is not None:
            data["encoder_optimizer"] = OptimizerConfig.from_dict(data["encoder_optimizer"])
        data["loss_functions"] = LossFunctionGroup.from_dict(
            data.get("loss_functions") or {}
        )
        return super().from_dict(data)

    def __post_init__(self) -> None:
        if self.num_modalities < 1:
            raise ValueError("num_modalities must be >= 1")

    def to_dict(self) -> Dict[str, Any]:
        out = super().to_dict()
        out["optimizer"] = self.optimizer.to_dict()
        if self.encoder_optimizer is not None:
            out["encoder_optimizer"] = self.encoder_optimizer.to_dict()
        out["loss_functions"] = self.loss_functions.to_dict()
        return out


@dataclass
class StandardMultimodalConfig(BaseConfig):
    experiment: ExperimentConfig
    data: DataConfig
    model: ModelConfig
    logging: LoggingConfig
    training: TrainingConfig
    metrics: MetricConfig = field(default_factory=MetricConfig)
    monitoring: MonitorConfig = field(default_factory=MonitorConfig)

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
        from mmtpu_torch.utils import global_state

        experiment = ExperimentConfig.from_dict({**raw["experiment"], "run_id": run_id})
        global_state.set_run_id(run_id)
        global_state.set_experiment_name(experiment.name)
        logging_cfg = LoggingConfig.from_dict(
            raw["logging"], experiment_name=experiment.name, run_id=run_id
        )
        return cls(
            experiment=experiment,
            data=DataConfig.from_dict(raw["data"]),
            model=ModelConfig.from_dict(raw["model"]),
            logging=logging_cfg,
            training=TrainingConfig.from_dict(raw["training"]),
            metrics=MetricConfig.from_dict(raw.get("metrics") or {}),
            monitoring=MonitorConfig.from_dict(raw.get("monitoring") or {}),
        )

    def save(self, path) -> None:
        """The config in its plain-dict form: JSON for a `.json` path (what
        `load` reads without PyYAML), YAML otherwise."""
        if str(path).endswith(".json"):
            import json

            with open(path, "w") as f:
                json.dump(self.to_dict(), f, indent=2)
            return
        from mmtpu_torch.config.yaml_tags import dump_yaml

        dump_yaml(self.to_dict(), path)

    def to_dict(self) -> Dict[str, Any]:
        return {
            name: plain(getattr(self, name))
            for name in ("experiment", "data", "model", "logging", "training",
                         "metrics", "monitoring")
        }


def plain(obj: Any) -> Any:
    """A config section as plain JSON-able containers (ModuleSpecs in their
    `__module_spec__` spelling, Modalities as strings)."""
    if hasattr(obj, "to_dict"):
        return plain(obj.to_dict())
    if isinstance(obj, dict):
        return {str(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, str):
        return str(obj)  # Modality is a str subclass
    return obj
