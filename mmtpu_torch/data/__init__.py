"""Dataset registry: the datasets the port has so far."""

from __future__ import annotations

from typing import Type

from mmtpu_torch.data.avmnist import AVMNIST, SyntheticAVMNIST
from mmtpu_torch.data.base import MultimodalArrayDataset
from mmtpu_torch.data.loader import BatchLoader
from mmtpu_torch.data.mmimdb import MMIMDb, SyntheticMMIMDb
from mmtpu_torch.data.mosi import MOSEI, MOSI, SyntheticMOSI

_DATASETS = {
    "avmnist": AVMNIST,
    "synthetic_avmnist": SyntheticAVMNIST,
    "avmnist_synthetic": SyntheticAVMNIST,
    "synthetic_mosi": SyntheticMOSI,
    "mosi": MOSI,
    "mosei": MOSEI,
    "synthetic_mmimdb": SyntheticMMIMDb,
    "mm_imdb": MMIMDb,
}


def resolve_dataset_name(name: str) -> Type[MultimodalArrayDataset]:
    key = name.lower()
    if key not in _DATASETS:
        raise ValueError(
            f"Dataset {name!r} is not ported to mmtpu_torch yet "
            f"(available: {', '.join(sorted(_DATASETS))})"
        )
    return _DATASETS[key]


__all__ = [
    "AVMNIST",
    "MOSEI",
    "MMIMDb",
    "MOSI",
    "SyntheticAVMNIST",
    "SyntheticMMIMDb",
    "SyntheticMOSI",
    "MultimodalArrayDataset",
    "BatchLoader",
    "resolve_dataset_name",
]
