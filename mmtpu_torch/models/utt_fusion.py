"""UttFusion — the trimodal MOSI/MOSEI late-fusion model (counterpart of
mmtpu/models/utt_fusion.py).

netA / netV are LSTMEncoders, netT a TextCNN, netC an FcClassifier over
concat(a, v, t). Padded sequences are encoded without length masking, as in
mmtpu and the reference. When the two LSTM encoders have equal hidden sizes
over aligned sequences, both recurrences advance in ONE kernel launch
(`encode_pair_stacked`); otherwise each encoder launches its own.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmtpu_torch.models.lstm import can_stack_pair, encode_pair_stacked


class UttFusionModel(nn.Module):
    def __init__(self, netA: nn.Module, netV: nn.Module, netT: nn.Module, netC: nn.Module,
                 clip: Optional[float] = None, pretrained_path: Optional[str] = None) -> None:
        super().__init__()
        self.netA = netA
        self.netV = netV
        self.netT = netT
        self.netC = netC
        self.clip = clip  # gradient clipping, applied by the trainer when configured
        self.pretrained_path = pretrained_path

    def forward(
        self,
        A: Optional[torch.Tensor] = None,
        V: Optional[torch.Tensor] = None,
        T: Optional[torch.Tensor] = None,
        *,
        is_embd_A: bool = False,
        is_embd_V: bool = False,
        is_embd_T: bool = False,
    ) -> torch.Tensor:
        if A is None and V is None and T is None:
            raise ValueError("UttFusionModel needs at least one of A, V, T")
        if is_embd_A and is_embd_V and is_embd_T:
            raise ValueError("UttFusionModel: at most two inputs may be embeddings")
        embd_A = embd_V = None
        if not is_embd_A and not is_embd_V and can_stack_pair(self.netA, self.netV, A, V):
            embd_A, embd_V = encode_pair_stacked(self.netA, self.netV, A, V)
        embds = []
        if A is not None:
            embds.append(A if is_embd_A else (embd_A if embd_A is not None else self.netA(A)))
        if V is not None:
            embds.append(V if is_embd_V else (embd_V if embd_V is not None else self.netV(V)))
        if T is not None:
            embds.append(T if is_embd_T else self.netT(T))
        return self.netC(torch.cat(embds, dim=-1))

    def encode(self, A, V, T):
        return self.netA(A), self.netV(V), self.netT(T)
