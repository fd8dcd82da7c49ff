"""Dataset registry: every dataset mmtpu's factory resolves."""

from __future__ import annotations

from typing import Type

from mmtpu_torch.data.avmnist import AVMNIST, SyntheticAVMNIST
from mmtpu_torch.data.base import MultimodalArrayDataset
from mmtpu_torch.data.iemocap import IEMOCAP
from mmtpu_torch.data.kinetics_sounds import KineticsSounds
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
    "kinetics_sounds": KineticsSounds,
    "iemocap": IEMOCAP,
}


def resolve_dataset_name(name: str) -> Type[MultimodalArrayDataset]:
    key = name.lower()
    if key == "msp_improv":
        raise NotImplementedError(
            "msp_improv is an empty stub in the reference (data/msp_improv.py)"
        )
    if key not in _DATASETS:
        raise ValueError(f"Unknown dataset: {name}")
    return _DATASETS[key]


__all__ = [
    "AVMNIST",
    "IEMOCAP",
    "KineticsSounds",
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
