"""CMU-MOSI / CMU-MOSEI sentiment datasets (own copy of mmtpu/data/mosi.py;
stdlib pickle and numpy only).

Pickle-backed: splits train/valid/test with audio/vision/text arrays,
classification_labels or regression_labels, and (unaligned mode)
audio_lengths/vision_lengths. Default 7 patterns over {a, t, v}. The pickles
store fixed-length padded arrays, so every batch has static shapes; length
vectors ride along for models that mask.

`SyntheticMOSI` makes the same numpy calls in the same order as mmtpu's, so
the same seed gives the same bytes.
"""

from __future__ import annotations

import logging
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from mmtpu_torch.data.base import MultimodalArrayDataset
from mmtpu_torch.modalities import Modality

logger = logging.getLogger(__name__)

DEFAULT_MSA_PATTERNS = {
    "atv": {Modality.AUDIO: 1.0, Modality.TEXT: 1.0, Modality.VIDEO: 1.0},
    "at": {Modality.AUDIO: 1.0, Modality.TEXT: 1.0, Modality.VIDEO: 0.0},
    "av": {Modality.AUDIO: 1.0, Modality.TEXT: 0.0, Modality.VIDEO: 1.0},
    "tv": {Modality.AUDIO: 0.0, Modality.TEXT: 1.0, Modality.VIDEO: 1.0},
    "a": {Modality.AUDIO: 1.0, Modality.TEXT: 0.0, Modality.VIDEO: 0.0},
    "t": {Modality.AUDIO: 0.0, Modality.TEXT: 1.0, Modality.VIDEO: 0.0},
    "v": {Modality.AUDIO: 0.0, Modality.TEXT: 0.0, Modality.VIDEO: 1.0},
}


class MultimodalSentimentDataset(MultimodalArrayDataset):
    NUM_CLASSES = 3

    @staticmethod
    def normalize_features(features: np.ndarray, eps: float = 1e-8) -> np.ndarray:
        """Per-feature z-score over the rows (ddof 1, the std floored at
        `eps`)."""
        mean = features.mean(axis=0, keepdims=True)
        std = np.clip(features.std(axis=0, keepdims=True, ddof=1), eps, None)
        return (features - mean) / std
    AVAILABLE_MODALITIES = {
        "audio": Modality.AUDIO,
        "video": Modality.VIDEO,
        "text": Modality.TEXT,
    }

    def __init__(
        self,
        data_fp,
        split: str,
        target_modality=Modality.MULTIMODAL,
        *,
        missing_patterns=None,
        selected_patterns: Optional[List[str]] = None,
        labels_key: str = "classification_labels",
        aligned: bool = False,
        num_classes: Optional[int] = None,
        seed: int = 0,
        **_unused,
    ) -> None:
        if num_classes is not None:
            self.NUM_CLASSES = num_classes
        super().__init__(
            split=split,
            missing_patterns=missing_patterns or dict(DEFAULT_MSA_PATTERNS),
            selected_patterns=selected_patterns,
            target_modality=target_modality,
            seed=seed,
        )
        self.data_fp = Path(data_fp)
        self.labels_key = labels_key
        self.aligned = aligned  # aligned pickles carry no per-sample lengths
        self._load()
        self.initialise_missing_masks()
        logger.info(
            f"{type(self).__name__}[{split}]: {self.num_samples} samples, "
            f"patterns {self.selected_patterns}"
        )

    def _load(self) -> None:
        if not self.data_fp.exists():
            raise FileNotFoundError(f"Data file not found: {self.data_fp}")
        with open(self.data_fp, "rb") as f:
            # the dataset's own pickle, named by the run's config
            raw = pickle.load(f)  # noqa: S301
        if self.split not in raw:
            raise KeyError(f"Split {self.split!r} not found in data")
        sd = raw[self.split]
        if self.labels_key not in sd:
            raise KeyError(f"Labels key {self.labels_key!r} not found in data")

        label_dtype = np.float32 if "regression" in self.labels_key else np.int64
        self.arrays = {
            Modality.AUDIO: np.asarray(sd["audio"], np.float32),
            Modality.VIDEO: np.asarray(sd["vision"], np.float32),
            Modality.TEXT: np.asarray(sd["text"], np.float32),
        }
        self.labels = np.asarray(sd[self.labels_key], label_dtype).reshape(-1)
        self.lengths: Dict[Modality, np.ndarray] = {}
        if not self.aligned and "audio_lengths" in sd:
            self.lengths[Modality.AUDIO] = np.asarray(sd["audio_lengths"], np.int32)
            self.lengths[Modality.VIDEO] = np.asarray(sd["vision_lengths"], np.int32)


class MOSI(MultimodalSentimentDataset):
    """CMU-MOSI."""

    @staticmethod
    def get_num_classes(is_classification: bool = True) -> int:
        return 3 if is_classification else 1


class MOSEI(MultimodalSentimentDataset):
    """CMU-MOSEI (same pickle layout)."""

    @staticmethod
    def get_num_classes(is_classification: bool = True) -> int:
        return 3 if is_classification else 1


class SyntheticMOSI(MultimodalSentimentDataset):
    """Shape-identical synthetic MOSI (aligned-50 layout): audio (N, seq, 5),
    video (N, seq, 20), text (N, seq, 768), class-dependent means."""

    def __init__(
        self,
        data_fp=None,
        split: str = "train",
        target_modality=Modality.MULTIMODAL,
        *,
        missing_patterns=None,
        selected_patterns=None,
        labels_key: str = "classification_labels",
        num_samples: int = 256,
        seq_len: int = 50,
        num_classes: Optional[int] = None,
        text_mode: str = "features",  # 'features' (B,seq,768) or 'bert' (B,3,seq)
        seed: int = 0,
        **_unused,
    ) -> None:
        if num_classes is not None:
            self.NUM_CLASSES = num_classes
        MultimodalArrayDataset.__init__(
            self,
            split=split,
            missing_patterns=missing_patterns or dict(DEFAULT_MSA_PATTERNS),
            selected_patterns=selected_patterns,
            target_modality=target_modality,
            seed=seed,
        )
        self.labels_key = labels_key
        rng = np.random.default_rng(seed)
        if "regression" in labels_key:
            self.labels = rng.uniform(-3, 3, num_samples).astype(np.float32)
            shift = self.labels
        else:
            self.labels = rng.integers(0, self.NUM_CLASSES, num_samples).astype(np.int64)
            shift = self.labels.astype(np.float32)
        self.arrays = {
            mod: (
                rng.normal(size=(num_samples, seq_len, width)).astype(np.float32)
                + shift[:, None, None] * 0.3
            )
            for mod, width in ((Modality.AUDIO, 5), (Modality.VIDEO, 20), (Modality.TEXT, 768))
        }
        if text_mode == "bert":
            # BERT input rows: ids / attention mask / segment ids
            ids = rng.integers(1, 100, size=(num_samples, seq_len))
            text = np.zeros((num_samples, 3, seq_len), np.float32)
            text[:, 0, :] = ids
            text[:, 1, :] = 1.0
            self.arrays[Modality.TEXT] = text
        self.lengths = {}
        self.initialise_missing_masks()
