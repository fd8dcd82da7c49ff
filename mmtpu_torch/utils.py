"""Helpers (own copy of the pieces of `mmtpu/utils/utils.py` the port
needs): path templating, the reference's metric flatten, checkpoint
retention."""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict


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
