"""The run's identity for path templating (counterpart of
`mmtpu/utils/global_state.py`): `StandardMultimodalConfig.from_parsed` sets
the run id and experiment name, as mmtpu's does."""

from __future__ import annotations

from typing import Optional

_run_id: Optional[int] = None
_experiment_name: Optional[str] = None
_debug: bool = False


def set_run_id(run_id: int) -> None:
    global _run_id
    _run_id = run_id


def get_run_id() -> Optional[int]:
    return _run_id


def set_experiment_name(name: str) -> None:
    global _experiment_name
    _experiment_name = name


def get_experiment_name() -> Optional[str]:
    return _experiment_name


def set_debug(flag: bool) -> None:
    global _debug
    _debug = flag


def get_debug() -> bool:
    return _debug
