"""Torch model families of the port (counterpart of `mmtpu/models`)."""

from mmtpu_torch.models.avmnist import AVMNIST, MNISTAudio, MNISTImage, MonomodalEncoder
from mmtpu_torch.models.cmam import CMAM, AssociationNetwork, DualCMAM, InputEncoders
from mmtpu_torch.models.conv import ConvBlock, ConvBlockArgs, avg_pool, max_pool
from mmtpu_torch.models.fc import FcClassifier, FcEncoder, MaxPoolFc, SimpleClassifier
from mmtpu_torch.models.lenet import LeNet5, LeNet5Enhanced, LeNetEncoder
from mmtpu_torch.models.lstm import (
    LSTMEncoder,
    LSTMEncoder2,
    can_stack_pair,
    encode_pair_stacked,
)
from mmtpu_torch.models.registry import build_module
from mmtpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNetEncoder,
)
from mmtpu_torch.models.textcnn import TextCNN
from mmtpu_torch.models.tools import seeded_init
from mmtpu_torch.models.utt_fusion import UttFusionModel

__all__ = [
    "AVMNIST",
    "AssociationNetwork",
    "CMAM",
    "DualCMAM",
    "InputEncoders",
    "MonomodalEncoder",
    "MNISTAudio",
    "MNISTImage",
    "ConvBlock",
    "ConvBlockArgs",
    "avg_pool",
    "max_pool",
    "BasicBlock",
    "Bottleneck",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNetEncoder",
    "LeNet5",
    "LeNet5Enhanced",
    "LeNetEncoder",
    "FcClassifier",
    "FcEncoder",
    "MaxPoolFc",
    "SimpleClassifier",
    "LSTMEncoder",
    "LSTMEncoder2",
    "can_stack_pair",
    "encode_pair_stacked",
    "TextCNN",
    "UttFusionModel",
    "build_module",
    "seeded_init",
]
