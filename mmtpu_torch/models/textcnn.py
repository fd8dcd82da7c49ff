"""TextCNN (counterpart of mmtpu/models/textcnn.py).

Three parallel convolutions with kernel heights [3, 4, 5] spanning the full
feature width, ReLU, global max-pool over the sequence, concat, dropout,
Linear + ReLU to embd_size. Input (B, seq, feat), convolved as (B, 1, seq,
feat) NCHW; key names `conv1..3`, `embd` as in mmtpu and the reference.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class TextCNN(nn.Module):
    def __init__(self, input_size: int, embd_size: int = 128, in_channels: int = 1,
                 out_channels: int = 128, kernel_heights: Sequence[int] = (3, 4, 5),
                 dropout: float = 0.5) -> None:
        super().__init__()
        self.embd_size = embd_size
        self.kernel_heights = tuple(kernel_heights)
        for i, k in enumerate(self.kernel_heights):
            setattr(self, f"conv{i + 1}", nn.Conv2d(in_channels, out_channels, (k, input_size)))
        self.dropout = nn.Dropout(dropout)
        self.embd = nn.Linear(len(self.kernel_heights) * out_channels, embd_size)

    def get_embedding_size(self) -> int:
        return self.embd_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.unsqueeze(1)  # (B, 1, seq, feat)
        pooled = []
        for i in range(len(self.kernel_heights)):
            c = torch.relu(getattr(self, f"conv{i + 1}")(h)).squeeze(3)  # (B, out, seq-k+1)
            pooled.append(torch.amax(c, dim=2))
        out = self.dropout(torch.cat(pooled, dim=1))
        return torch.relu(self.embd(out))
