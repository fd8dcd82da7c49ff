"""MM-IMDb dataset (own copy of mmtpu/data/mmimdb.py).

`MMIMDb` reads one HDF5 file per split: `vgg_features` (4096-wide image
features), `features` (300-wide word2vec text), `genres` (23-way
multilabel flags); the whole split is loaded into host arrays (the files
hold feature matrices, not media). `h5py` is imported only here, when a
real file is read. `SyntheticMMIMDb` makes the same numpy calls in the
same order as mmtpu's, so the same seed gives the same bytes. Patterns
over {image, text}: `it`, `i`, `t`.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional

import numpy as np

from mmtpu_torch.data.base import MultimodalArrayDataset
from mmtpu_torch.modalities import Modality

logger = logging.getLogger(__name__)

NUM_GENRES = 23
DEFAULT_PATTERNS = {
    "it": {Modality.IMAGE: 1.0, Modality.TEXT: 1.0},
    "i": {Modality.IMAGE: 1.0, Modality.TEXT: 0.0},
    "t": {Modality.IMAGE: 0.0, Modality.TEXT: 1.0},
}


class MMIMDb(MultimodalArrayDataset):
    NUM_CLASSES = NUM_GENRES
    AVAILABLE_MODALITIES = {"image": Modality.IMAGE, "text": Modality.TEXT}

    def __init__(self, data_fp, split: str, target_modality=Modality.MULTIMODAL, *,
                 missing_patterns=None, selected_patterns: Optional[List[str]] = None,
                 image_key: str = "vgg_features", text_key: str = "features",
                 labels_key: str = "genres", imdb_ids_key: str = "imdb_ids", seed: int = 0,
                 **_unused) -> None:
        super().__init__(split=split, missing_patterns=missing_patterns or dict(DEFAULT_PATTERNS),
                         selected_patterns=selected_patterns, target_modality=target_modality,
                         seed=seed)
        path = Path(data_fp)
        if not path.exists():
            raise FileNotFoundError(f"Dataset file not found: {path}")
        import h5py

        with h5py.File(path, "r") as f:
            for key in (image_key, text_key, labels_key):
                if key not in f:
                    raise KeyError(f"Key {key!r} not found in {path}")
            self.arrays = {
                Modality.IMAGE: np.asarray(f[image_key], np.float32),
                Modality.TEXT: np.asarray(f[text_key], np.float32),
            }
            self.labels = np.asarray(f[labels_key], np.float32)
        logger.info(f"MMIMDb[{split}]: {self.num_samples} samples from {path}")
        self.initialise_missing_masks()


class SyntheticMMIMDb(MultimodalArrayDataset):
    """Shape-identical synthetic MM-IMDb: 23 genre flags at rate 0.15, their
    16-wide projection as the first columns of both feature matrices."""

    NUM_CLASSES = NUM_GENRES
    AVAILABLE_MODALITIES = {"image": Modality.IMAGE, "text": Modality.TEXT}

    def __init__(self, data_fp=None, split: str = "train", target_modality=Modality.MULTIMODAL,
                 *, missing_patterns=None, selected_patterns=None, num_samples: int = 256,
                 seed: int = 0, **_unused) -> None:
        super().__init__(split=split, missing_patterns=missing_patterns or dict(DEFAULT_PATTERNS),
                         selected_patterns=selected_patterns, target_modality=target_modality,
                         seed=seed)
        rng = np.random.default_rng(seed)
        self.labels = (rng.random((num_samples, NUM_GENRES)) < 0.15).astype(np.float32)
        signal = self.labels @ rng.normal(size=(NUM_GENRES, 16)).astype(np.float32)
        self.arrays = {
            Modality.IMAGE: np.concatenate(
                [signal, rng.normal(size=(num_samples, 4096 - 16))], axis=1).astype(np.float32),
            Modality.TEXT: np.concatenate(
                [signal, rng.normal(size=(num_samples, 300 - 16))], axis=1).astype(np.float32),
        }
        self.initialise_missing_masks()
