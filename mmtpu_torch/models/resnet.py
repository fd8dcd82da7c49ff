"""ResNet encoders (counterpart of `mmtpu/models/resnet.py`).

Same topology — 7×7/s2 stem, 3×3/s2 max pool, [64,128,256,512] stages,
global average pool, Linear to hidden_dim — as torch modules that keep the
reference's key names (`conv1`, `bn1`, `layer1.0.conv1`, `downsample.0/1`,
`fc`), so a port `state_dict` is a reference-layout `.pth`.

Inputs are NHWC, as mmtpu's loader emits them ((B, H, W) gets a channel
axis); the encoder permutes to NCHW inside. BatchNorm is the pad-aware
`models/norm.py` one: eps 1e-5; flax's momentum 0.9 is torch's momentum 0.1.
"""

from __future__ import annotations

from typing import Sequence, Type, Union

import torch
from torch import nn

from mmtpu_torch.models.norm import BatchNorm


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes * self.expansion:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * self.expansion, 1, stride=stride, bias=False),
                _bn(planes * self.expansion),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * self.expansion, 1, bias=False)
        self.bn3 = _bn(planes * self.expansion)
        self.downsample = None
        if stride != 1 or inplanes != planes * self.expansion:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * self.expansion, 1, stride=stride, bias=False),
                _bn(planes * self.expansion),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)


Block = Union[Type[BasicBlock], Type[Bottleneck]]


class ResNetEncoder(nn.Module):
    """Configurable ResNet; expects NHWC (a missing channel dim is added)."""

    def __init__(
        self,
        block: Block = BasicBlock,
        layers: Sequence[int] = (2, 2, 2, 2),
        in_channels: int = 1,
        hidden_dim: int = 128,
    ) -> None:
        super().__init__()
        self.hidden_dim = hidden_dim
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        # flax pads with -inf and pools VALID: the same as torch's padding=1
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stage_blocks = []
            for i in range(blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                stage_blocks.append(block(inplanes, planes, stride))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*stage_blocks))
        self.fc = nn.Linear(inplanes, hidden_dim)

    def get_embedding_size(self) -> int:
        return self.hidden_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:  # (B, H, W) → add channel dim
            x = x.unsqueeze(-1)
        # NHWC → NCHW with NCHW strides. With one channel the permuted view
        # also has channels-last strides, PyTorch then runs the whole network
        # channels-last, and cuDNN's fp32 kernels convert layouts around every
        # convolution (2112 conversions per predict pass, chip_smoke.py)
        x = x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = x.mean(dim=(2, 3))  # adaptive average pool to 1×1
        return self.fc(x)


def ResNet18(in_channels: int = 1, hidden_dim: int = 128, **kwargs) -> ResNetEncoder:
    return ResNetEncoder(BasicBlock, (2, 2, 2, 2), in_channels, hidden_dim)


def ResNet34(in_channels: int = 1, hidden_dim: int = 128, **kwargs) -> ResNetEncoder:
    return ResNetEncoder(BasicBlock, (3, 4, 6, 3), in_channels, hidden_dim)


def ResNet50(in_channels: int = 1, hidden_dim: int = 128, **kwargs) -> ResNetEncoder:
    return ResNetEncoder(Bottleneck, (3, 4, 6, 3), in_channels, hidden_dim)
