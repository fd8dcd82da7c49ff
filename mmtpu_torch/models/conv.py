"""Torch-semantics pooling (own copy of `max_pool`, mmtpu/models/conv.py).

mmtpu writes PyTorch's `MaxPool2d` over NHWC: stride equal to the window,
floor division, trailing rows and columns that do not fill a window
dropped. Here the input is NCHW and `F.max_pool2d` with those arguments
is the same operation.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
from torch.nn import functional as F


def _pair(v: Union[int, Sequence[int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def max_pool(x: torch.Tensor, window: Union[int, Sequence[int]]) -> torch.Tensor:
    """MaxPool2d over (B, C, H, W), stride = window, floor mode."""
    w = _pair(window)
    return F.max_pool2d(x, kernel_size=w, stride=w)
