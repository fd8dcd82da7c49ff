"""Helpers (own copy of `mmtpu/utils/utils.py`): path templating, the
metric flattens, checkpoint retention, nested lookups. `logging` is the run
log file (`configure_logger`, re-exported here), `global_state` the run's
identity, `tb_writer` the TensorBoard event writer."""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, Iterable, Optional

import numpy as np


class SafeDict(dict):
    """Partial str.format support: unknown keys survive as-is."""

    def __missing__(self, key: str) -> str:  # noqa: D105
        return "{" + key + "}"


def format_path_with_env(path: str) -> str:
    """Expand $VAR / ${VAR} with os.environ; unknown vars expand to ''."""

    def _sub(match: "re.Match[str]") -> str:
        var = match.group(1) or match.group(2)
        return os.environ.get(var, "")

    return re.sub(r"\$\{(\w+)\}|\$(\w+)", _sub, str(path))


def flatten_leaves(d: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's flatten: parent keys are DISCARDED, so metric-group
    names never appear in the output schema ('accuracy_AI', not
    'classification_accuracy_AI'); colliding leaves are overwritten in
    iteration order."""
    out: Dict[str, Any] = {}

    def walk(x: Dict[str, Any]) -> None:
        for k, v in x.items():
            if isinstance(v, dict):
                walk(v)
            else:
                out[str(k)] = v

    walk(d)
    return out


def clean_checkpoints(directory) -> int:
    """Checkpoint retention as mmtpu's (the reference's clean_checkpoints)
    at its defaults: drop the per-epoch `epoch_*.pth` of an earlier run,
    keep `best.*`, rename the newest epoch file to `*_last.pth`. Returns
    the number of files removed."""
    directory = Path(directory)
    # already-renamed *_last files are terminal
    files = sorted((p for p in directory.glob("epoch_*.pth") if not p.stem.endswith("_last")),
                   key=lambda p: p.stat().st_mtime)
    if not files:
        return 0
    for f in files[:-1]:
        f.unlink()
    files[-1].rename(directory / f"{files[-1].stem}_last.pth")
    return len(files) - 1


def flatten_dict(d: Dict[str, Any], parent_key: str = "", sep: str = "_") -> Dict[str, Any]:
    """Flatten nested dicts: {'a': {'b': 1}} → {'a_b': 1}."""
    items: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{parent_key}{sep}{k}" if parent_key else str(k)
        if isinstance(v, dict):
            items.update(flatten_dict(v, key, sep=sep))
        else:
            items[key] = v
    return items


def to_numpy(x: Any) -> np.ndarray:
    """A tensor (on any device), array or list on the host."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def nested_get(d: Dict[str, Any], keys: Iterable[Any], default: Optional[Any] = None) -> Any:
    """Safe nested lookup (the reference's NestedDictAccess)."""
    cur: Any = d
    for k in keys:
        if isinstance(cur, dict):
            if k not in cur:
                return default
            cur = cur[k]
        else:
            try:
                cur = cur[k]
            except Exception:  # noqa: BLE001 — any failed step is the default
                return default
    return cur


from mmtpu_torch.utils.logging import configure_logger  # noqa: E402,F401 — re-export
