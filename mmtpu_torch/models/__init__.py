"""Torch model families of the port (counterpart of `mmtpu/models`)."""

from mmtpu_torch.models.autoencoder import ResidualAE, ResidualUnetAE, ResidualXE, SimpleFcAE
from mmtpu_torch.models.avmnist import AVMNIST, MNISTAudio, MNISTImage, MonomodalEncoder
from mmtpu_torch.models.bert_text import BertModel, BertTextEncoder
from mmtpu_torch.models.cmam import CMAM, AssociationNetwork, DualCMAM, InputEncoders
from mmtpu_torch.models.conv import ConvBlock, ConvBlockArgs, avg_pool, max_pool
from mmtpu_torch.models.domain import DIVEncoder, LanguageEmbeddingLayer, SeqEncoder
from mmtpu_torch.models.fc import FcClassifier, FcEncoder, MaxPoolFc, SimpleClassifier
from mmtpu_torch.models.fusion import GatedBiModalNetwork, MaxOut, MultimodalPooling
from mmtpu_torch.models.gcnet import GraphModel, GraphNetwork, MatchingAttention
from mmtpu_torch.models.kinetics_sounds import (
    KineticsSounds,
    KineticsSoundsAudioEncoder,
    KineticsSoundsVideoEncoder,
)
from mmtpu_torch.models.lenet import LeNet5, LeNet5Enhanced, LeNetEncoder
from mmtpu_torch.models.lstm import (
    LSTMClassifier,
    LSTMEncoder,
    LSTMEncoder2,
    can_stack_pair,
    encode_pair_stacked,
)
from mmtpu_torch.models.mmimdb import MLPGenreClassifier, MMIMDb, MMIMDbModalityEncoder
from mmtpu_torch.models.mmin import MMIN
from mmtpu_torch.models.mult import MultModalTransformer
from mmtpu_torch.models.redcore import RedCore
from mmtpu_torch.models.registry import build_module
from mmtpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNetEncoder,
)
from mmtpu_torch.models.self_mm import AuViSubNet, Self_MM
from mmtpu_torch.models.seq_extras import EFModelAL, GatedTransformer
from mmtpu_torch.models.textcnn import TextCNN
from mmtpu_torch.models.tools import seeded_init
from mmtpu_torch.models.transformer import ResidualAttentionBlock, Transformer
from mmtpu_torch.models.utt_fusion import UttFusionModel
from mmtpu_torch.models.variational import (
    LinearVXE,
    VariationalLSTMEncoder,
    VariationalLSTMEncoder2,
    VariationalTextCNN,
)

__all__ = [
    "AVMNIST",
    "AssociationNetwork",
    "AuViSubNet",
    "BertModel",
    "BertTextEncoder",
    "GatedBiModalNetwork",
    "GatedTransformer",
    "GraphModel",
    "GraphNetwork",
    "MatchingAttention",
    "MultModalTransformer",
    "EFModelAL",
    "MaxOut",
    "MLPGenreClassifier",
    "MMIMDb",
    "MMIMDbModalityEncoder",
    "MultimodalPooling",
    "Self_MM",
    "CMAM",
    "DualCMAM",
    "DIVEncoder",
    "LanguageEmbeddingLayer",
    "LinearVXE",
    "SeqEncoder",
    "VariationalLSTMEncoder",
    "VariationalLSTMEncoder2",
    "VariationalTextCNN",
    "InputEncoders",
    "KineticsSounds",
    "KineticsSoundsAudioEncoder",
    "KineticsSoundsVideoEncoder",
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
    "LSTMClassifier",
    "LSTMEncoder",
    "LSTMEncoder2",
    "can_stack_pair",
    "encode_pair_stacked",
    "TextCNN",
    "UttFusionModel",
    "MMIN",
    "RedCore",
    "ResidualAE",
    "ResidualXE",
    "ResidualUnetAE",
    "SimpleFcAE",
    "ResidualAttentionBlock",
    "Transformer",
    "build_module",
    "seeded_init",
]
