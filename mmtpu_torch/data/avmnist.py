"""Synthetic AVMNIST (own copy of `SyntheticAVMNIST`, mmtpu/data/avmnist.py).

Shape-identical stand-in for the AVMNIST spectrogram + image pairs: audio
(N, 32, 94), image (N, 28, 28, 1) NHWC, 10 classes with class-dependent
means. Same numpy calls as mmtpu, so the same seed gives the same bytes.
The CSV/`.pt` reader of the real dataset needs pandas and matplotlib and is
not ported yet.
"""

from __future__ import annotations

import numpy as np

from mmtpu_torch.data.base import MultimodalArrayDataset
from mmtpu_torch.modalities import Modality

AUDIO_SHAPE = (32, 94)
IMAGE_SHAPE = (28, 28)


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
        m_patterns = missing_patterns or {
            "ai": {Modality.AUDIO: 1.0, Modality.IMAGE: 1.0},
            "a": {Modality.AUDIO: 1.0, Modality.IMAGE: 0.0},
            "i": {Modality.AUDIO: 0.0, Modality.IMAGE: 1.0},
        }
        super().__init__(
            split=split,
            missing_patterns=m_patterns,
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
