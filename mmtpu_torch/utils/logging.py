"""The package's file logger (counterpart of `mmtpu/utils/logging.py`)."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

LOGGER_NAME = "mmtpu_torch"
_configured = False


def configure_logger(log_path: Optional[str] = None, level: int = logging.INFO,
                     suffix: Optional[str] = None) -> logging.Logger:
    """(Re)configure the package's logger, as mmtpu's: with a `log_path`,
    its records go to `<log_path>/<suffix>.log` (the training CLIs pass
    `run_<run_id>`), else nowhere; an earlier call's file is closed."""
    global _configured
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(level)
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    if log_path is not None:
        path = Path(log_path)
        path.mkdir(parents=True, exist_ok=True)
        handler = logging.FileHandler(path / (f"{suffix}.log" if suffix else "mmtpu_torch.log"))
        handler.setFormatter(logging.Formatter(
            "%(asctime)s | %(levelname)s | %(name)s | %(message)s"))
        logger.addHandler(handler)
    else:
        logger.addHandler(logging.NullHandler())
    _configured = True
    return logger


def get_logger() -> logging.Logger:
    """The package's logger, configured (without a file) on first use."""
    if not _configured:
        configure_logger()
    return logging.getLogger(LOGGER_NAME)
