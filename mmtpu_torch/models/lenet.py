"""LeNet-5 encoders (counterpart of `mmtpu/models/lenet.py`).

conv5×5/p2 → BN → ReLU → pool2 → conv5×5 → BN → ReLU → pool2 → flatten →
fc(→120) → ReLU → fc(120→hidden), keys `conv1`, `bn1`, `conv2`, `bn2`,
`fc1`, `fc2`. Inputs are NHWC as the loader emits them ((B, H, W) gets a
channel axis); the convolutions run NCHW. The flatten before `fc1` takes
the NHWC order, as mmtpu's, so `fc1`'s weight is mmtpu's kernel transposed
and nothing else (`from_jax_variables`). A flattened width other than
`feature_maps[1]·5·5` is cut or zero-padded to it, mmtpu's static-shape
stand-in for the reference's size fix-up (AVMNIST's (32, 94) spectrogram
flattens to 2016 and keeps its first 400). BatchNorm is the pad-aware one
(`models/norm.py`); `fc1` and `fc2` draw their initial weights from
N(0, 0.01²), as mmtpu's (`init_std`, read by `models/tools.seeded_init`).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from mmtpu_torch.models.conv import max_pool
from mmtpu_torch.models.norm import BatchNorm


class LeNetEncoder(nn.Module):
    def __init__(self, in_channels: int = 1, hidden_dim: int = 84,
                 feature_maps: Sequence[int] = (6, 16)) -> None:
        super().__init__()
        c1, c2 = int(feature_maps[0]), int(feature_maps[1])
        self.hidden_dim = hidden_dim
        self.flat_dim = c2 * 5 * 5
        self.conv1 = nn.Conv2d(in_channels, c1, 5, padding=2)
        self.bn1 = BatchNorm(c1)
        self.conv2 = nn.Conv2d(c1, c2, 5)
        self.bn2 = BatchNorm(c2)
        self.fc1 = nn.Linear(self.flat_dim, 120)
        self.fc2 = nn.Linear(120, hidden_dim)
        for fc in (self.fc1, self.fc2):
            fc.init_std = 0.01

    def get_embedding_size(self) -> int:
        return self.hidden_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x.unsqueeze(-1)
        # NCHW strides: with one channel the permuted view would pass for
        # channels-last (models/resnet.py)
        x = x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
        x = max_pool(torch.relu(self.bn1(self.conv1(x))), 2)
        x = max_pool(torch.relu(self.bn2(self.conv2(x))), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order, as mmtpu
        if x.shape[1] > self.flat_dim:
            x = x[:, :self.flat_dim]
        elif x.shape[1] < self.flat_dim:
            x = F.pad(x, (0, self.flat_dim - x.shape[1]))
        return self.fc2(torch.relu(self.fc1(x)))


def LeNet5(in_channels: int = 1, hidden_dim: int = 84, **kwargs) -> LeNetEncoder:
    return LeNetEncoder(in_channels, hidden_dim, feature_maps=(6, 16))


def LeNet5Enhanced(in_channels: int = 1, hidden_dim: int = 128, **kwargs) -> LeNetEncoder:
    return LeNetEncoder(in_channels, hidden_dim, feature_maps=(16, 32))
