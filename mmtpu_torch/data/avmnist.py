"""AVMNIST datasets (own copy of `AVMNIST`, `_gist_earth_luma_lut` and
`SyntheticAVMNIST`, mmtpu/data/avmnist.py).

`AVMNIST` reads a CSV index (columns audio, image, label by default) of
torch-saved files, as mmtpu does, with the stdlib `csv` module in place of
pandas and a 256-entry constant in place of matplotlib's colormap:
- audio: a float32 spectrogram, cropped or zero-padded into (32, 94);
- image: a uint8 (28, 28) array → `GIST_EARTH_LUMA[img] / 255`, NHWC
  (N, 28, 28, 1): the PIL 'L' luma of matplotlib's gist_earth colormap,
  as the reference converts each image;
- labels: int64; 10 classes; patterns over {audio, image} ("ai", "a", "i").

The whole split is decoded once into contiguous arrays and cached as `.npy`
sidecars next to the CSV, named `<csv stem>.<digest>.{audio,image,labels}.npy`
with digest `sha1(csv bytes + "|".join(columns))[:12]`, and memory-mapped
from then on: the names are mmtpu's, so either package reads the other's
cache. A legacy whole-split `<csv stem>.<digest>.npz` is converted to
sidecars on first touch. A data directory that cannot be written gives a
warning and no cache. The `.pt` files are not hashed: rewrite one in place
and the sidecars must be deleted by hand.

`SyntheticAVMNIST` is the shape-identical stand-in with class-dependent
means; the same numpy calls as mmtpu, so the same seed gives the same bytes.
"""

from __future__ import annotations

import csv
import hashlib
import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from mmtpu_torch.data.base import MultimodalArrayDataset
from mmtpu_torch.modalities import Modality

logger = logging.getLogger(__name__)

AUDIO_SHAPE = (32, 94)
IMAGE_SHAPE = (28, 28)

# uint8 pixel → PIL-'L' luma (R*299 + G*587 + B*114) // 1000 of matplotlib's
# gist_earth(pixel) as uint8 RGBA: mmtpu's `_gist_earth_luma_lut()`
GIST_EARTH_LUMA = np.array([
    0, 4, 6, 7, 9, 10, 12, 13, 15, 17, 18, 20, 21, 23, 25, 26,
    28, 29, 31, 32, 34, 36, 37, 39, 40, 42, 43, 45, 47, 48, 49, 51,
    52, 54, 55, 56, 58, 59, 61, 62, 64, 65, 67, 68, 70, 71, 72, 73,
    74, 76, 77, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90, 92, 92,
    94, 95, 96, 97, 98, 100, 101, 102, 103, 103, 104, 104, 104, 105, 105, 106,
    106, 106, 106, 107, 107, 108, 108, 108, 109, 109, 109, 109, 110, 110, 110, 111,
    111, 112, 112, 112, 113, 113, 113, 113, 114, 115, 115, 115, 115, 116, 116, 116,
    117, 117, 117, 117, 118, 118, 119, 120, 121, 122, 123, 124, 125, 127, 128, 128,
    130, 130, 132, 133, 134, 135, 136, 137, 138, 139, 140, 141, 142, 142, 144, 144,
    145, 146, 146, 147, 148, 149, 150, 151, 151, 152, 153, 154, 155, 155, 156, 157,
    157, 158, 159, 160, 160, 162, 162, 163, 164, 165, 165, 166, 167, 168, 169, 170,
    170, 171, 171, 171, 171, 171, 170, 170, 170, 169, 169, 169, 169, 168, 168, 167,
    167, 166, 167, 166, 166, 165, 165, 164, 164, 164, 165, 165, 167, 168, 169, 170,
    170, 172, 173, 174, 175, 177, 178, 179, 180, 181, 182, 183, 184, 185, 187, 189,
    190, 191, 193, 194, 196, 197, 199, 201, 202, 204, 206, 208, 210, 212, 213, 215,
    217, 219, 221, 223, 225, 227, 229, 231, 234, 236, 239, 241, 243, 246, 248, 250,
], dtype=np.uint8)


def _default_patterns() -> Dict[str, Dict[Modality, float]]:
    return {
        "ai": {Modality.AUDIO: 1.0, Modality.IMAGE: 1.0},
        "a": {Modality.AUDIO: 1.0, Modality.IMAGE: 0.0},
        "i": {Modality.AUDIO: 0.0, Modality.IMAGE: 1.0},
    }


class AVMNIST(MultimodalArrayDataset):
    NUM_CLASSES = 10
    AVAILABLE_MODALITIES = {"audio": Modality.AUDIO, "image": Modality.IMAGE}

    def __init__(
        self,
        data_fp,
        split: str,
        target_modality=Modality.MULTIMODAL,
        *,
        missing_patterns=None,
        selected_patterns: Optional[List[str]] = None,
        audio_column: str = "audio",
        image_column: str = "image",
        labels_column: str = "label",
        seed: int = 0,
        **_unused,
    ) -> None:
        super().__init__(
            split=split,
            missing_patterns=missing_patterns or _default_patterns(),
            selected_patterns=selected_patterns,
            target_modality=target_modality,
            seed=seed,
        )
        self.data_fp = Path(data_fp)
        if not self.data_fp.exists():
            raise FileNotFoundError(f"Data file not found: {data_fp}")
        # the cache identity includes the columns: a cache built from the
        # default columns must not serve a request for other ones
        self._cache_cols = (audio_column, image_column, labels_column)
        self._load(audio_column, image_column, labels_column)
        self.initialise_missing_masks()
        logger.info(f"AVMNIST[{split}]: {self.num_samples} samples, "
                    f"patterns {self.selected_patterns}")

    def _digest(self) -> str:
        if not hasattr(self, "_digest_cache"):
            h = hashlib.sha1(self.data_fp.read_bytes())
            h.update("|".join(self._cache_cols).encode())
            self._digest_cache = h.hexdigest()[:12]
        return self._digest_cache

    def _legacy_path(self) -> Path:
        return self.data_fp.with_suffix(f".{self._digest()}.npz")

    def _npy_path(self, name: str) -> Path:
        return self.data_fp.with_suffix(f".{self._digest()}.{name}.npy")

    def _mmap_cached(self) -> bool:
        paths = {n: self._npy_path(n) for n in ("audio", "image", "labels")}
        if not all(p.exists() for p in paths.values()):
            return False
        self.arrays = {
            Modality.AUDIO: np.load(paths["audio"], mmap_mode="r"),
            Modality.IMAGE: np.load(paths["image"], mmap_mode="r"),
        }
        self.labels = np.load(paths["labels"])
        return True

    def _write_npy_cache(self, audio, image, labels) -> bool:
        try:
            for name, arr in (("audio", audio), ("image", image), ("labels", labels)):
                np.save(self._npy_path(name), arr)
        except OSError as e:  # a read-only data directory: no cache
            logger.warning(f"could not write AVMNIST cache: {e}")
            return False
        logger.info(f"AVMNIST cache written: {self._npy_path('audio')}")
        return True

    def _keep(self, audio, image, labels) -> None:
        """Serve the arrays from the sidecars when they can be written,
        else from memory."""
        if self._write_npy_cache(audio, image, labels) and self._mmap_cached():
            return
        self.arrays = {Modality.AUDIO: audio, Modality.IMAGE: image}
        self.labels = labels

    def _load(self, audio_col: str, image_col: str, labels_col: str) -> None:
        if self._mmap_cached():
            return
        legacy = self._legacy_path()
        if legacy.exists():
            z = np.load(legacy)
            self._keep(z["audio"], z["image"], z["labels"])
            return

        import torch

        with open(self.data_fp, newline="") as f:
            reader = csv.reader(f)
            header = next(reader, [])
            rows = [row for row in reader if row]  # pandas skips blank lines
        missing = [c for c in (audio_col, image_col, labels_col) if c not in header]
        if missing:
            raise ValueError(f"Missing required columns: {missing}")
        ai, ii, li = (header.index(c) for c in (audio_col, image_col, labels_col))

        n = len(rows)
        audio = np.zeros((n, *AUDIO_SHAPE), np.float32)
        image = np.zeros((n, *IMAGE_SHAPE, 1), np.float32)
        for i, row in enumerate(rows):
            a = np.asarray(torch.load(row[ai], weights_only=True), np.float32)
            h, w = min(a.shape[0], AUDIO_SHAPE[0]), min(a.shape[1], AUDIO_SHAPE[1])
            audio[i, :h, :w] = a[:h, :w]
            # mmtpu loads the images with weights_only=False: the reference's
            # files are pickled numpy arrays
            img = np.asarray(torch.load(row[ii], weights_only=False), np.uint8)
            image[i, :, :, 0] = GIST_EARTH_LUMA[img].astype(np.float32) / 255.0
        labels = np.array([int(float(row[li])) for row in rows], np.int64)
        self._keep(audio, image, labels)


class SyntheticAVMNIST(MultimodalArrayDataset):
    NUM_CLASSES = 10
    AVAILABLE_MODALITIES = {"audio": Modality.AUDIO, "image": Modality.IMAGE}

    def __init__(
        self,
        data_fp=None,
        split: str = "train",
        target_modality=Modality.MULTIMODAL,
        *,
        missing_patterns=None,
        selected_patterns=None,
        num_samples: int = 512,
        seed: int = 0,
        **_unused,
    ) -> None:
        super().__init__(
            split=split,
            missing_patterns=missing_patterns or _default_patterns(),
            selected_patterns=selected_patterns,
            target_modality=target_modality,
            seed=seed,
        )
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, 10, size=num_samples).astype(np.int64)
        audio = rng.normal(size=(num_samples, *AUDIO_SHAPE)).astype(np.float32)
        image = rng.normal(size=(num_samples, *IMAGE_SHAPE, 1)).astype(np.float32)
        audio += self.labels[:, None, None] * 0.3
        image += self.labels[:, None, None, None] * 0.3
        self.arrays = {Modality.AUDIO: audio, Modality.IMAGE: image}
        self.initialise_missing_masks()
