"""Data configuration: missing-pattern synthesis + dataset/loader builders
(counterpart of `mmtpu/config/data.py`, same pattern semantics).

- `ModalityConfig.missing_rate` with optional `apply_to` pattern scoping;
- `MissingPatternConfig.generate_patterns`: powerset of modalities, per
  pattern keep-probabilities (present → 1.0 or 1-rate when scoped, absent →
  0.0), names are sorted first letters ("ai", "a", "i");
- `DatasetConfig` → dataset; `DataConfig.build_loader`.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from itertools import chain, combinations
from typing import Any, Dict, List, Optional

from mmtpu_torch.config.base import BaseConfig
from mmtpu_torch.modalities import Modality
from mmtpu_torch.utils import format_path_with_env


@dataclass
class ModalityConfig(BaseConfig):
    """Missing rate for one modality, optionally scoped to patterns."""

    missing_rate: float = 0.0
    apply_to: Optional[List[str]] = None

    def __post_init__(self) -> None:
        if not 0.0 <= self.missing_rate <= 1.0:
            raise ValueError(f"missing_rate must be in [0,1], got {self.missing_rate}")

    def should_apply_to(self, pattern: str) -> bool:
        # no apply_to list → never applies (mmtpu and reference semantics)
        return self.apply_to is not None and pattern in self.apply_to


@dataclass
class MissingPatternConfig(BaseConfig):
    modalities: Dict[Modality, ModalityConfig] = field(default_factory=OrderedDict)
    selected_patterns: Optional[List[str]] = None

    def __post_init__(self) -> None:
        if self.selected_patterns:
            self.selected_patterns = ["".join(sorted(p)) for p in self.selected_patterns]
        self.modalities = OrderedDict(
            (
                Modality(str(k)),
                v if isinstance(v, ModalityConfig) else ModalityConfig.from_dict(v or {}),
            )
            for k, v in self.modalities.items()
        )

    @property
    def available_modalities(self):
        return {str(m) for m in self.modalities} | {"multimodal"}

    def generate_patterns(self) -> Dict[str, Dict[Modality, float]]:
        """Pattern name → {modality: keep probability}."""
        mods = sorted(self.modalities.keys())
        combos = list(
            chain.from_iterable(combinations(mods, r) for r in range(1, len(mods) + 1))
        )
        combos.sort(key=lambda c: (len(c), c))

        patterns: Dict[str, Dict[Modality, float]] = {}
        for combo in combos:
            name = "".join(sorted(str(m)[0] for m in combo))
            probs: Dict[Modality, float] = {}
            for m in mods:
                if m in combo:
                    if self.modalities[m].should_apply_to(name):
                        probs[m] = round(1.0 - self.modalities[m].missing_rate, 4)
                    else:
                        probs[m] = 1.0
                else:
                    probs[m] = 0.0
            patterns[name] = probs

        # the full pattern always carries each modality's configured rate
        full_name = "".join(sorted(str(m)[0] for m in mods))
        patterns[full_name] = {
            m: round(1.0 - self.modalities[m].missing_rate, 4) for m in mods
        }

        if self.selected_patterns:
            patterns = {
                k: v for k, v in patterns.items() if k in self.selected_patterns
            }
        return patterns

    def to_dict(self) -> Dict[str, Any]:
        return {
            "modalities": {str(m): c.to_dict() for m, c in self.modalities.items()},
            "selected_patterns": self.selected_patterns,
        }


@dataclass
class DatasetConfig(BaseConfig):
    dataset: str
    data_fp: str
    target_modality: Any = Modality.MULTIMODAL
    split: str = "train"
    batch_size: int = 32
    shuffle: bool = False
    drop_last: bool = False
    kwargs: Dict[str, Any] = field(default_factory=dict)
    missing_patterns: Optional[MissingPatternConfig] = None

    @classmethod
    def from_dict(cls, data: Dict[str, Any], **extra: Any) -> "DatasetConfig":
        if isinstance(data, cls):
            return data
        return cls(**cls._known_and_kwargs({**data, **extra}))

    def __post_init__(self) -> None:
        self.data_fp = format_path_with_env(self.data_fp)
        self.target_modality = Modality(str(self.target_modality))
        if self.missing_patterns is None:
            self.missing_patterns = MissingPatternConfig()
        elif not isinstance(self.missing_patterns, MissingPatternConfig):
            self.missing_patterns = MissingPatternConfig.from_dict(self.missing_patterns)

    def get_dataset_args(self) -> Dict[str, Any]:
        args: Dict[str, Any] = {
            "data_fp": self.data_fp,
            "split": self.split,
            "target_modality": self.target_modality,
        }
        if self.missing_patterns is not None:
            args["missing_patterns"] = self.missing_patterns.generate_patterns()
            args["selected_patterns"] = self.missing_patterns.selected_patterns
        args.update(self.kwargs)
        return args

    def build_dataset(self, seed: int = 0):
        from mmtpu_torch.data import resolve_dataset_name

        cls = resolve_dataset_name(self.dataset)
        return cls(seed=seed, **self.get_dataset_args())

    def to_dict(self) -> Dict[str, Any]:
        out = super().to_dict()
        out["target_modality"] = str(self.target_modality)
        return out


@dataclass
class DataConfig(BaseConfig):
    datasets: Dict[str, DatasetConfig]

    def __post_init__(self) -> None:
        if not self.datasets:
            raise ValueError("No datasets configured")
        # a new dict: the caller's mapping is left as it was given
        self.datasets = {
            name: DatasetConfig.from_dict(cfg) for name, cfg in self.datasets.items()
        }

    def build_loader(self, split: str, seed: int = 0):
        from mmtpu_torch.data.loader import BatchLoader

        if split not in self.datasets:
            raise KeyError(f"Split {split!r} not configured")
        cfg = self.datasets[split]
        return BatchLoader(
            cfg.build_dataset(seed=seed),
            batch_size=cfg.batch_size,
            shuffle=cfg.shuffle,
            drop_last=cfg.drop_last,
            seed=seed,
        )

    def build_all_loaders(self, is_train: bool = True, is_test: bool = True,
                          seed: int = 0) -> Dict[str, Any]:
        """One loader per configured split; train and validation only when
        training, test only when testing."""
        loaders: Dict[str, Any] = {}
        for split in self.datasets:
            if split in ("train", "trn", "validation") and not is_train:
                continue
            if split == "test" and not is_test:
                continue
            loaders[split] = self.build_loader(split, seed=seed)
        return loaders

    def to_dict(self) -> Dict[str, Any]:
        return {"datasets": {k: v.to_dict() for k, v in self.datasets.items()}}
