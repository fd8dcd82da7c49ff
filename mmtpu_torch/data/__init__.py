"""Dataset registry: the datasets the port has so far."""

from __future__ import annotations

from typing import Type

from mmtpu_torch.data.avmnist import SyntheticAVMNIST
from mmtpu_torch.data.base import MultimodalArrayDataset
from mmtpu_torch.data.loader import BatchLoader


def resolve_dataset_name(name: str) -> Type[MultimodalArrayDataset]:
    key = name.lower()
    if key == "synthetic_avmnist":
        return SyntheticAVMNIST
    raise ValueError(
        f"Dataset {name!r} is not ported to mmtpu_torch yet "
        "(available: synthetic_avmnist)"
    )


__all__ = [
    "SyntheticAVMNIST",
    "MultimodalArrayDataset",
    "BatchLoader",
    "resolve_dataset_name",
]
