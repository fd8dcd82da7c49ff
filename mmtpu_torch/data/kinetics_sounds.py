"""Kinetics-Sounds dataset (own copy of mmtpu/data/kinetics_sounds.py).

A CSV index (columns `audio`, `video` and the label column, `label` by
default; the repository's `DATA/kinetics-sounds` CSVs name it `class`, so
their configs pass `labels_key: class`) of torch-saved tensors: audio a
(128, 128) float32 spectrogram, video a (400,) float32 feature vector; 26
classes; patterns over {audio, video} ("av", "a", "v"). The whole split is
decoded once into contiguous float32 arrays. mmtpu reads the CSV with
pandas; the port reads it with the stdlib `csv` module (pandas is not on the
card's machine) and, like mmtpu, skips blank lines. A `.parquet` index,
which mmtpu reads with pandas, raises here.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import List, Optional

import numpy as np

from mmtpu_torch.data.base import MultimodalArrayDataset
from mmtpu_torch.modalities import Modality

logger = logging.getLogger(__name__)

DEFAULT_PATTERNS = {
    "av": {Modality.AUDIO: 1.0, Modality.VIDEO: 1.0},
    "a": {Modality.AUDIO: 1.0, Modality.VIDEO: 0.0},
    "v": {Modality.AUDIO: 0.0, Modality.VIDEO: 1.0},
}


class KineticsSounds(MultimodalArrayDataset):
    NUM_CLASSES = 26
    AVAILABLE_MODALITIES = {"audio": Modality.AUDIO, "video": Modality.VIDEO}

    def __init__(
        self,
        data_fp,
        split: str,
        target_modality=Modality.MULTIMODAL,
        *,
        missing_patterns=None,
        selected_patterns: Optional[List[str]] = None,
        audio_key: str = "audio",
        video_key: str = "video",
        labels_key: str = "label",
        seed: int = 0,
        **_unused,
    ) -> None:
        super().__init__(
            split=split,
            missing_patterns=missing_patterns or dict(DEFAULT_PATTERNS),
            selected_patterns=selected_patterns,
            target_modality=target_modality,
            seed=seed,
        )
        path = Path(data_fp)
        if not path.exists():
            raise FileNotFoundError(f"File not found: {path}")
        if path.suffix == ".parquet":
            raise ValueError(
                f"{path}: a .parquet index needs pandas, which mmtpu_torch does not use; "
                "give the split as a CSV")

        import torch

        with open(path, newline="") as f:
            reader = csv.reader(f)
            header = next(reader, [])
            rows = [row for row in reader if row]
        for key in (audio_key, video_key, labels_key):
            if key not in header:
                raise ValueError(f"Key not found in the dataset: {key}")
        ai, vi, li = (header.index(k) for k in (audio_key, video_key, labels_key))

        def tensor(file: str) -> np.ndarray:
            return np.asarray(torch.load(file, weights_only=True), np.float32)

        self.arrays = {
            Modality.AUDIO: np.ascontiguousarray(np.stack([tensor(r[ai]) for r in rows])),
            Modality.VIDEO: np.ascontiguousarray(np.stack([tensor(r[vi]) for r in rows])),
        }
        self.labels = np.array([int(float(r[li])) for r in rows], np.int64)
        self.initialise_missing_masks()
        logger.info(f"KineticsSounds[{self.split}]: {self.num_samples} samples")
