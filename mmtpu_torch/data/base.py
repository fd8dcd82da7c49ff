"""Host-side multimodal dataset base with missing-pattern machinery (own
copy of `mmtpu/data/base.py`).

- masks: per (pattern, modality, sample) Bernoulli keep-masks precomputed at
  init from keep-probabilities (= 1 - missing_rate; absent modality → 0.0),
  seeded with the same numpy calls as mmtpu, so masks are bit-identical;
- train: one seeded random pattern per sample per epoch;
- eval: deterministic pattern-major blocks, length = num_samples × patterns.

Data lives in numpy arrays; the loader emits fixed-shape batches with raw
modalities + per-modality mask vectors, and the eval step multiplies the
masks in on the device.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Optional, Sequence

import numpy as np

from mmtpu_torch.modalities import Modality, create_missing_mask

VALID_SPLITS = ("train", "valid", "test")


class MultimodalArrayDataset:
    """Arrays + masks + pattern schedule. Subclasses load `self.arrays`
    (modality → (N, ...) float32) and `self.labels`."""

    AVAILABLE_MODALITIES: Dict[str, Modality] = {}
    NUM_CLASSES: int = 0

    def __init__(
        self,
        split: str,
        missing_patterns: Dict[str, Dict[Modality, float]],
        selected_patterns: Optional[List[str]] = None,
        target_modality: Modality = Modality.MULTIMODAL,
        seed: int = 0,
    ) -> None:
        split = {"trn": "train", "val": "valid", "validation": "valid",
                 "tst": "test"}.get(split.lower(), split.lower())
        if split not in VALID_SPLITS:
            raise ValueError(f"invalid split {split}")
        self.split = split
        self.seed = seed
        if isinstance(target_modality, str):
            target_modality = Modality(target_modality)
        self.target_modality = target_modality

        self.missing_patterns = missing_patterns or self.default_patterns()
        if selected_patterns is not None:
            self.selected_patterns = self.validate_patterns(selected_patterns)
        else:
            self.selected_patterns = [
                p for p in self.get_all_possible_patterns()
                if p in self.missing_patterns
            ] or list(self.missing_patterns)

        self.arrays: Dict[Modality, np.ndarray] = {}
        self.labels: np.ndarray = np.zeros((0,), np.int64)
        self.masks: Dict[str, Dict[Modality, np.ndarray]] = {}
        self._mask_cache: Dict[tuple, np.ndarray] = {}

    @classmethod
    def default_patterns(cls) -> Dict[str, Dict[Modality, float]]:
        """Every pattern of the powerset, keep 1 for a present modality and
        0 for an absent one (mmtpu's, when a dataset is given none)."""
        mods = list(cls.AVAILABLE_MODALITIES.values())
        out = {}
        for r in range(1, len(mods) + 1):
            for combo in combinations(sorted(mods), r):
                name = "".join(sorted(str(m)[0] for m in combo))
                out[name] = {m: (1.0 if m in combo else 0.0) for m in mods}
        return out

    @classmethod
    def get_all_possible_patterns(cls) -> List[str]:
        mods = list(cls.AVAILABLE_MODALITIES.keys())
        patterns = []
        for r in range(1, len(mods) + 1):
            for combo in combinations(mods, r):
                patterns.append("".join(sorted(m[0] for m in combo)))
        return sorted(patterns)

    @classmethod
    def get_full_modality(cls) -> str:
        """The pattern with every modality present ("ai" for AVMNIST)."""
        return "".join(sorted(k[0] for k in cls.AVAILABLE_MODALITIES))

    def validate_patterns(self, patterns: Sequence[str]) -> List[str]:
        valid = set(self.get_all_possible_patterns())
        bad = set(patterns) - valid
        if bad:
            raise ValueError(f"Invalid patterns: {bad}; valid: {sorted(valid)}")
        missing = set(patterns) - set(self.missing_patterns)
        if missing:
            raise ValueError(
                f"selected_patterns {sorted(missing)} have no entry in "
                f"missing_patterns {sorted(self.missing_patterns)}"
            )
        return list(patterns)

    def initialise_missing_masks(self) -> None:
        """Precompute the (pattern, modality) → (N,) keep-mask matrices."""
        n = self.num_samples
        rng = np.random.default_rng(self.seed)
        mods = list(self.AVAILABLE_MODALITIES.values())
        self.masks = {}
        self._mask_cache = {}  # stale stacks must not outlive the masks
        for pattern, probs in self.missing_patterns.items():
            keep = [float(probs.get(m, 0.0)) for m in mods]
            mat = create_missing_mask(len(mods), n, keep, rng=rng)
            self.masks[pattern] = {m: mat[:, j] for j, m in enumerate(mods)}

    @property
    def num_samples(self) -> int:
        return int(self.labels.shape[0])

    def __len__(self) -> int:
        if self.split == "train":
            return self.num_samples
        return self.num_samples * len(self.selected_patterns)

    def train_schedule(self, epoch: int) -> np.ndarray:
        """Per-sample pattern indices for a train epoch (seeded draw)."""
        rng = np.random.default_rng((self.seed, epoch, 0xA11CE))
        return rng.integers(0, len(self.selected_patterns), size=self.num_samples)

    def pattern_vocab(self) -> List[str]:
        return list(self.selected_patterns)

    def mask_stack(self, modality: Modality, dtype=np.float32) -> np.ndarray:
        """(num_selected_patterns, N) keep-masks for vectorized batch gather,
        cached per dtype."""
        key = (str(modality), np.dtype(dtype).str)
        if key not in self._mask_cache:
            stack = np.stack(
                [self.masks[p][modality] for p in self.selected_patterns], axis=0
            )
            self._mask_cache[key] = np.ascontiguousarray(
                stack.astype(dtype, copy=False)
            )
        return self._mask_cache[key]
