"""IEMOCAP emotion recognition (own copy of mmtpu/data/iemocap.py).

Multi-file layout under `data_fp`: `A/comparE.h5` (with the folds' mean
and std in `A/comparE_mean_std.h5`), `V/denseface.h5`, `T/bert_large.h5`,
one (T_i, dim) matrix per utterance name; the labels (one-hot) and the
names under `target/{cv_no}/{split}_{label,int2name}.npy`. 10-fold CV
through `cv_no`, 4 classes, the seven patterns over {a, t, v}.

Two steps, which mmtpu's constructor runs as one:
- `read_split` opens the files (h5py, imported there only): the split's
  labels as the argmax of the one-hot, its names decoded as mmtpu decodes
  them (bytes, 1-element arrays, str), each modality's per-utterance
  matrices, and the fold's comparE mean and std (std 0 → 1);
- `assemble` is numpy alone: audio normalised by the fold's statistics
  (`norm_method="trn"`) or per utterance (`"utt"`, std clipped at 1e-8),
  then per modality one (N, L, dim) float32 array, L the split's longest
  utterance capped at `max_len`, zero-padded, with its lengths.

So the padded length differs by split and by modality, as in mmtpu; a
caller with features but no h5py feeds `assemble` directly.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmtpu_torch.data.base import MultimodalArrayDataset
from mmtpu_torch.data.mosi import DEFAULT_MSA_PATTERNS
from mmtpu_torch.modalities import Modality

logger = logging.getLogger(__name__)

SPLIT_ALIASES = {"train": "trn", "valid": "val", "test": "tst"}
FEATURE_DIRS = {Modality.AUDIO: "A", Modality.VIDEO: "V", Modality.TEXT: "T"}


def decode_names(int2name) -> List[str]:
    return [n[0].decode() if isinstance(n, (np.ndarray, list, tuple))
            else (n.decode() if isinstance(n, bytes) else str(n))
            for n in int2name]


def read_targets(cv_root: Path, ref_split: str) -> Tuple[np.ndarray, List[str]]:
    """(labels (N,) int64, utterance names) of one split of one fold."""
    labels = np.argmax(np.load(cv_root / f"{ref_split}_label.npy"), axis=1).astype(np.int64)
    return labels, decode_names(np.load(cv_root / f"{ref_split}_int2name.npy"))


def read_split(root: Path, names: Sequence[str], cv_no: int, feature_types: Dict[Modality, str]):
    """Each modality's per-utterance matrices for `names`, and the fold's
    comparE (mean, std), or (None, None) for another audio type."""
    import h5py

    feats = {}
    for mod, kind in feature_types.items():
        with h5py.File(root / FEATURE_DIRS[mod] / f"{kind}.h5", "r") as f:
            feats[mod] = [np.asarray(f[name], np.float32) for name in names]
    mean = std = None
    if feature_types[Modality.AUDIO] == "comparE":
        with h5py.File(root / "A" / "comparE_mean_std.h5", "r") as ms:
            mean = np.asarray(ms[str(cv_no)]["mean"], np.float32)
            std = np.asarray(ms[str(cv_no)]["std"], np.float32)
            std[std == 0] = 1.0
    return feats, mean, std


def assemble(feats: Dict[Modality, List[np.ndarray]], mean: Optional[np.ndarray],
             std: Optional[np.ndarray], norm_method: str = "trn", max_len: int = 64):
    """(arrays, lengths): per modality the normalised utterances padded to
    the longest (at most `max_len`) as (N, L, dim) float32, and (N,) int32."""
    arrays, lengths = {}, {}
    for mod, xs in feats.items():
        if mod == Modality.AUDIO and mean is not None and norm_method == "trn":
            xs = [(x - mean) / std for x in xs]
        elif mod == Modality.AUDIO and norm_method == "utt":
            xs = [(x - x.mean(0, keepdims=True)) / np.clip(x.std(0, keepdims=True), 1e-8, None)
                  for x in xs]
        dim = xs[0].shape[-1]
        L = min(max((x.shape[0] for x in xs), default=1), max_len)
        arr = np.zeros((len(xs), L, dim), np.float32)
        lens = np.zeros((len(xs),), np.int32)
        for i, x in enumerate(xs):
            n = min(x.shape[0], L)
            arr[i, :n] = x[:n]
            lens[i] = n
        arrays[mod], lengths[mod] = arr, lens
    return arrays, lengths


class IEMOCAP(MultimodalArrayDataset):
    NUM_CLASSES = 4
    AVAILABLE_MODALITIES = {
        "audio": Modality.AUDIO,
        "video": Modality.VIDEO,
        "text": Modality.TEXT,
    }

    def __init__(self, data_fp, split: str, selected_patterns: Optional[List[str]] = None,
                 cv_no: int = 1, missing_patterns=None, target_modality=Modality.MULTIMODAL, *,
                 target_dir_fp_fmt: str = "target/{cv_no}", norm_method: str = "trn",
                 audio_type: str = "comparE", video_type: str = "denseface",
                 text_type: str = "bert_large", max_len: int = 64, seed: int = 0,
                 **_unused) -> None:
        super().__init__(split=split, missing_patterns=missing_patterns or dict(DEFAULT_MSA_PATTERNS),
                         selected_patterns=selected_patterns, target_modality=target_modality,
                         seed=seed)
        if not 1 <= cv_no <= 10:
            raise ValueError(f"IEMOCAP cv_no must be in 1..10, got {cv_no}")
        self.cv_no = cv_no
        self.norm_method = norm_method
        root = Path(data_fp)
        cv_root = root / target_dir_fp_fmt.format(cv_no=cv_no)
        self.labels, names = read_targets(cv_root, SPLIT_ALIASES.get(self.split, self.split))
        feats, mean, std = read_split(root, names, cv_no, {
            Modality.AUDIO: audio_type, Modality.VIDEO: video_type, Modality.TEXT: text_type})
        self.arrays, self.lengths = assemble(feats, mean, std, norm_method, max_len)
        self.initialise_missing_masks()
        logger.info(f"IEMOCAP[{self.split} cv{cv_no}]: {self.num_samples} samples")
