"""Conv building block and torch-semantics pooling (counterpart of
`mmtpu/models/conv.py`).

`ConvBlock` is (Conv → BatchNorm → ReLU) × 2, the block of the MNIST
encoders, under the reference's submodule names `conv_one`,
`batch_norm_one`, `conv_two`, `batch_norm_two` (mmtpu's `conv_1`, `bn_1`,
`conv_2`, `bn_2`), so a reference state dict loads under its own keys. The
BatchNorm is the pad-aware one of `models/norm.py`; with `batch_norm=False`
the block has none, as mmtpu's has no BatchNorm variables then. Inputs are
NCHW.

`max_pool` and `avg_pool` are PyTorch's `MaxPool2d` / `AvgPool2d` as mmtpu
writes them over NHWC: stride equal to the window, floor division, trailing
rows and columns that do not fill a window dropped. Here the input is NCHW
and `F.max_pool2d` / `F.avg_pool2d` with those arguments are the same
operations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from mmtpu_torch.models.norm import BatchNorm


def _pair(v: Union[int, Sequence[int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


@dataclasses.dataclass
class ConvBlockArgs:
    """Constructor args for one conv layer (YAML `!ConvBlockArgs`)."""

    conv_one_in: int
    conv_one_out: int
    conv_one_kernel_size: Union[int, Tuple[int, int]] = (3, 3)
    conv_one_stride: Union[int, Tuple[int, int]] = (1, 1)
    conv_one_padding: Union[int, Tuple[int, int]] = (1, 1)

    def out_size(self, h: int, w: int) -> Tuple[int, int]:
        """The conv's output height and width for an h × w input."""
        k, s, p = (_pair(self.conv_one_kernel_size), _pair(self.conv_one_stride),
                   _pair(self.conv_one_padding))
        return tuple((n + 2 * p[i] - k[i]) // s[i] + 1 for i, n in enumerate((h, w)))


def _as_args(v) -> ConvBlockArgs:
    """Accept ConvBlockArgs, ModuleSpec('conv_block_args', ...), or dict."""
    if isinstance(v, ConvBlockArgs):
        return v
    if hasattr(v, "kwargs"):  # ModuleSpec
        return ConvBlockArgs(**v.kwargs)
    return ConvBlockArgs(**v)


def _conv(args: ConvBlockArgs) -> nn.Conv2d:
    conv = nn.Conv2d(args.conv_one_in, args.conv_one_out, _pair(args.conv_one_kernel_size),
                     stride=_pair(args.conv_one_stride), padding=_pair(args.conv_one_padding))
    # flax's nn.Conv default: LeCun-normal over fan-in (models/tools.seeded_init)
    conv.init_std = math.sqrt(1.0 / (conv.in_channels * conv.kernel_size[0]
                                     * conv.kernel_size[1]))
    return conv


class ConvBlock(nn.Module):
    """Two conv + BatchNorm + ReLU layers over NCHW input."""

    def __init__(self, conv_block_one_args, conv_block_two_args, batch_norm: bool = True) -> None:
        super().__init__()
        self.args = (_as_args(conv_block_one_args), _as_args(conv_block_two_args))
        self.batch_norm = batch_norm
        self.conv_one = _conv(self.args[0])
        if batch_norm:
            self.batch_norm_one = BatchNorm(self.args[0].conv_one_out)
        self.conv_two = _conv(self.args[1])
        if batch_norm:
            self.batch_norm_two = BatchNorm(self.args[1].conv_one_out)

    def out_size(self, h: int, w: int) -> Tuple[int, int]:
        return self.args[1].out_size(*self.args[0].out_size(h, w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_one(x)
        if self.batch_norm:
            x = self.batch_norm_one(x)
        x = self.conv_two(torch.relu(x))
        if self.batch_norm:
            x = self.batch_norm_two(x)
        return torch.relu(x)


def max_pool(x: torch.Tensor, window: Union[int, Sequence[int]]) -> torch.Tensor:
    """MaxPool2d over (B, C, H, W), stride = window, floor mode."""
    w = _pair(window)
    return F.max_pool2d(x, kernel_size=w, stride=w)


def avg_pool(x: torch.Tensor, window: Union[int, Sequence[int]]) -> torch.Tensor:
    """AvgPool2d over (B, C, H, W), stride = window, floor mode."""
    w = _pair(window)
    return F.avg_pool2d(x, kernel_size=w, stride=w)
