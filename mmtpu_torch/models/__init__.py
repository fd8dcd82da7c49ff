"""Torch model families of the port (counterpart of `mmtpu/models`)."""

from mmtpu_torch.models.avmnist import AVMNIST, MonomodalEncoder
from mmtpu_torch.models.registry import build_module
from mmtpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNetEncoder,
)
from mmtpu_torch.models.tools import seeded_init

__all__ = [
    "AVMNIST",
    "MonomodalEncoder",
    "BasicBlock",
    "Bottleneck",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNetEncoder",
    "build_module",
    "seeded_init",
]
