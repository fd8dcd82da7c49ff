"""Config dataclasses and the YAML/dict loader of the port (counterpart of
`mmtpu/config`, for the sections the AVMNIST configs use)."""

from mmtpu_torch.config.base import BaseConfig
from mmtpu_torch.config.data import (
    DataConfig,
    DatasetConfig,
    MissingPatternConfig,
    ModalityConfig,
)
from mmtpu_torch.config.experiment import ExperimentConfig
from mmtpu_torch.config.logging_ import LoggingConfig
from mmtpu_torch.config.model import ModelConfig
from mmtpu_torch.config.spec import ModuleSpec, specs_from_dicts
from mmtpu_torch.config.training import StandardMultimodalConfig, TrainingConfig

__all__ = [
    "BaseConfig",
    "DataConfig",
    "DatasetConfig",
    "MissingPatternConfig",
    "ModalityConfig",
    "ExperimentConfig",
    "LoggingConfig",
    "ModelConfig",
    "ModuleSpec",
    "specs_from_dicts",
    "StandardMultimodalConfig",
    "TrainingConfig",
]
