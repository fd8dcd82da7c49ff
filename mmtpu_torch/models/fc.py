"""MLP encoders and classifiers (counterpart of mmtpu/models/fc.py).

FcEncoder: (Linear → ReLU [→ BN] [→ Dropout]) stack. FcClassifier: the same
stack + an output Linear. SimpleClassifier / MaxPoolFc: small heads of the
MSA models. Key names as in mmtpu: `fc_{i}`, `bn_{i}`, `fc_out`, `C`, `fc`.

`use_bn` is `nn.BatchNorm1d`: at eval it normalises with the running
statistics, as mmtpu does. mmtpu's training statistics leave out zero-padded
tail rows (mmtpu/models/norm.py); that masking is not ported yet, so these
modules are for the eval path until training lands.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


class _FcStack(nn.Module):
    """fc_{i} → ReLU [→ bn_{i}] [→ Dropout] for each width."""

    def __init__(self, input_dim: int, layers: Sequence[int], dropout: float,
                 use_bn: bool) -> None:
        super().__init__()
        self.input_dim = input_dim
        self.layers = tuple(layers)
        self.use_bn = use_bn
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None
        width_in = input_dim
        for i, width in enumerate(self.layers):
            setattr(self, f"fc_{i}", nn.Linear(width_in, width))
            if use_bn:
                setattr(self, f"bn_{i}", nn.BatchNorm1d(width))
            width_in = width

    def stack(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.layers)):
            x = torch.relu(getattr(self, f"fc_{i}")(x))
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x)
            if self.dropout is not None:
                x = self.dropout(x)
        return x


class FcEncoder(_FcStack):
    def __init__(self, input_dim: int, layers: Sequence[int] = (128,),
                 dropout: float = 0.5, use_bn: bool = False) -> None:
        super().__init__(input_dim, layers, dropout, use_bn)

    def get_embedding_size(self) -> int:
        return self.layers[-1] if self.layers else self.input_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        # truncate or zero-pad to the declared input_dim, as mmtpu does
        if x.shape[1] > self.input_dim:
            x = x[:, : self.input_dim]
        elif x.shape[1] < self.input_dim:
            x = F.pad(x, (0, self.input_dim - x.shape[1]))
        return self.stack(x)


class FcClassifier(_FcStack):
    def __init__(self, input_dim: int, layers: Sequence[int], output_dim: int,
                 dropout: float = 0.3, use_bn: bool = False) -> None:
        super().__init__(input_dim, layers, dropout, use_bn)
        self.fc_out = nn.Linear(self.layers[-1] if self.layers else input_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_out(self.stack(x))


class SimpleClassifier(nn.Module):
    def __init__(self, embd_size: int, output_dim: int, dropout: float = 0.0) -> None:
        super().__init__()
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None
        self.C = nn.Linear(embd_size, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dropout is not None:
            x = self.dropout(x)
        return self.C(x)


class MaxPoolFc(nn.Module):
    def __init__(self, hidden_size: int, num_class: int = 4) -> None:
        super().__init__()
        self.fc = nn.Linear(hidden_size, num_class)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, seq, hidden) → max over seq → fc → relu
        return torch.relu(self.fc(x.max(dim=1).values))
