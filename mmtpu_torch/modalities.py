"""Modality registry and missing-mask synthesis (own copy of
`mmtpu/modalities.py`).

A string-valued Modality registry plus `create_missing_mask`. The numpy
RNG calls are the same as mmtpu's, so masks drawn from the same seed are
bit-identical in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


class Modality(str):
    """A named modality. Behaves as its lowercase string name, so batch
    keys like ``f"{mod}_mask"`` render as ``"audio_mask"``."""

    _registry: Dict[str, "Modality"] = {}

    def __new__(cls, name) -> "Modality":
        key = str(name).lower()
        if key in cls._registry:
            return cls._registry[key]
        obj = super().__new__(cls, key)
        cls._registry[key] = obj
        return obj

    @classmethod
    def from_str(cls, name: str) -> "Modality":
        """A registered modality by name; an unknown one raises (the
        constructor registers it)."""
        key = name.lower()
        if key not in cls._registry:
            raise ValueError(f"Unknown modality: {name!r}. Registered: {sorted(cls._registry)}")
        return cls._registry[key]

    @property
    def name(self) -> str:  # enum-like accessor
        return str(self).upper()

    def __repr__(self) -> str:  # noqa: D105
        return f"Modality.{self.name}"


def modality_initials(mods: Sequence[str]) -> str:
    """Canonical pattern name: sorted first letters (audio+image → 'ai')."""
    return "".join(sorted(str(m)[0] for m in mods))


def add_modality(name: str) -> Modality:
    """Register (or fetch) a modality by name. YAML `!Modality` hook."""
    return Modality(name)


Modality.AUDIO = add_modality("audio")
Modality.IMAGE = add_modality("image")
Modality.TEXT = add_modality("text")
Modality.VIDEO = add_modality("video")
Modality.MULTIMODAL = add_modality("multimodal")


def create_missing_mask(
    num_modalities: int,
    length: int,
    keep_probs: Sequence[float],
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Bernoulli keep-masks: shape (length, num_modalities) of {0., 1.}.

    ``keep_probs[m]`` is the probability modality ``m`` is KEPT (keep prob =
    1 - missing_rate; modalities absent from a pattern get 0.0)."""
    if len(keep_probs) != num_modalities:
        raise ValueError(
            f"keep_probs has {len(keep_probs)} entries for {num_modalities} modalities"
        )
    rng = rng if rng is not None else np.random.default_rng()
    probs = np.asarray(keep_probs, dtype=np.float32)
    u = rng.random((length, num_modalities), dtype=np.float32)
    return (u < probs[None, :]).astype(np.float32)

