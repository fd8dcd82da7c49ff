"""Output path templating + directory creation (counterpart of
`mmtpu/config/logging_.py`): `$ENV` expansion and partial
`{experiment_name}/{run_id}/{timestamp}` interpolation of every path field,
the `save_metric` checkpoint criterion, and `tb_record_only`, the anchored
regexes that select which metrics go to TensorBoard."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

from mmtpu_torch.config.base import BaseConfig
from mmtpu_torch.utils import SafeDict, format_path_with_env


@dataclass
class LoggingConfig(BaseConfig):
    log_path: str
    model_output_path: str
    metrics_path: str
    save_metric: str = "loss"
    monitor_path: Optional[str] = None
    tensorboard_path: Optional[str] = None
    tb_record_only: Optional[List[str]] = None
    experiment_name: str = ""
    run_id: int = 1
    timestamp: str = field(
        default_factory=lambda: datetime.now().strftime("%Y%m%d_%H%M%S")
    )

    _PATH_FIELDS = ("log_path", "model_output_path", "metrics_path", "monitor_path",
                    "tensorboard_path")

    @classmethod
    def from_dict(
        cls, data: Dict[str, Any], experiment_name: str = "", run_id: int = 1, **extra
    ) -> "LoggingConfig":
        cfg = super().from_dict(
            data, experiment_name=experiment_name, run_id=run_id, **extra
        )
        cfg._process_paths()
        return cfg

    def format_path(self, path: str) -> str:
        """Expand $ENV vars and {experiment_name}/{run_id}/{timestamp}."""
        expanded = format_path_with_env(str(path))
        # spaces, hyphens and other specials collapse to underscores, so
        # output dirs match mmtpu's byte for byte
        safe_name = re.sub(r"[^\w\s-]|[\s-]+", "_", self.experiment_name).strip("_")
        return expanded.format_map(
            SafeDict(
                experiment_name=safe_name,
                run_id=self.run_id,
                timestamp=self.timestamp,
            )
        )

    def _process_paths(self) -> None:
        for name in self._PATH_FIELDS:
            value = getattr(self, name)
            if value:
                setattr(self, name, self.format_path(value))

    def create_directories(self) -> None:
        for name in self._PATH_FIELDS:
            value = getattr(self, name)
            if value:
                Path(value).mkdir(parents=True, exist_ok=True)
