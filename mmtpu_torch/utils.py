"""Path templating helpers (own copy of the pieces of `mmtpu/utils/utils.py`
the config loader needs)."""

from __future__ import annotations

import os
import re


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
