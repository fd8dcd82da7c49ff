"""LSTM sequence encoder (counterpart of `LSTMEncoder`, `can_stack_pair` and
`encode_pair_stacked`, mmtpu/models/lstm.py).

mmtpu's fused parameter layout under mmtpu's names: `wi` is the input
projection `nn.Linear(I, 4H)` (weight and one bias), `wh` a raw (H, 4H)
recurrent matrix, gate order `[i, f, g, o]`; `attention_layer` and the raw
(H, 1) `attention_vector_weight` exist only for `embd_method='attention'`.
The recurrence runs through `mmtpu_torch.ops.lstm`: on CUDA tensors the
hand-written kernel, on the CPU the plain scan.

Pooling methods: 'last' (the last state under length masking), 'attention'
(softmax(u·tanh(W·h))·h), 'maxpool'; padded steps are masked to -inf out of
the attention and maxpool reductions when lengths are given.

mmtpu's `backend='rnn'` (flax's per-gate layout) and `LSTMClassifier` are
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmtpu_torch.ops.lstm import lstm_sequence, lstm_sequence_stacked

EMBD_METHODS = ("last", "attention", "maxpool")


class LSTMEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, embd_method: str = "last",
                 backend: str = "fused") -> None:
        super().__init__()
        if embd_method not in EMBD_METHODS:
            raise ValueError(f"embd_method {embd_method!r} not in {EMBD_METHODS}")
        if backend != "fused":
            raise ValueError(
                f"LSTMEncoder backend {backend!r} is not ported to mmtpu_torch yet "
                "(only 'fused')"
            )
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.embd_method = embd_method
        self.backend = backend
        self.wi = nn.Linear(input_size, 4 * hidden_size)
        self.wh = nn.Parameter(torch.empty(hidden_size, 4 * hidden_size))
        nn.init.orthogonal_(self.wh)
        if embd_method == "attention":
            self.attention_layer = nn.Linear(hidden_size, hidden_size)
            self.attention_vector_weight = nn.Parameter(torch.empty(hidden_size, 1))
            nn.init.normal_(self.attention_vector_weight, std=hidden_size ** -0.5)

    def get_embedding_size(self) -> int:
        return self.hidden_size

    def project(self, x: torch.Tensor):
        """The input projection x·Wi + b (the parallel GEMM) and the recurrent
        weights: what a host model needs to advance several encoders'
        recurrences in one launch."""
        return self.wi(x), self.wh

    def pool(self, outputs: torch.Tensor, carry_h: torch.Tensor,
             lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.embd_method == "last":
            return carry_h
        valid = None
        if lengths is not None:
            steps = torch.arange(outputs.shape[1], device=outputs.device)
            valid = steps[None, :] < lengths[:, None]
        if self.embd_method == "maxpool":
            if valid is not None:
                outputs = outputs.masked_fill(~valid[..., None], float("-inf"))
            return outputs.max(dim=1).values
        hidden = torch.tanh(self.attention_layer(outputs))
        scores = (hidden @ self.attention_vector_weight)[..., 0]  # (B, seq)
        if valid is not None:
            scores = scores.masked_fill(~valid, float("-inf"))
        weights = torch.softmax(scores, dim=-1)[..., None]
        return (outputs * weights).sum(dim=1)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        xw, wh = self.project(x)
        outputs, (carry_h, _) = lstm_sequence(
            xw, wh, lengths=lengths.to(torch.int32) if lengths is not None else None,
        )
        return self.pool(outputs, carry_h, lengths)


# mmtpu registers the reference's near-duplicate LSTMEncoder2 as an alias.
LSTMEncoder2 = LSTMEncoder


def can_stack_pair(netA: nn.Module, netV: nn.Module, A, V) -> bool:
    """True when two sibling encoders' recurrences can be advanced by one
    launch: both LSTMEncoders with equal hidden size over aligned (B, T)
    sequence inputs."""
    return (
        A is not None and V is not None
        and type(netA) is LSTMEncoder and type(netV) is LSTMEncoder
        and netA.hidden_size == netV.hidden_size
        and A.dim() == 3 and V.dim() == 3
        and A.shape[0] == V.shape[0] and A.shape[1] == V.shape[1]
    )


def encode_pair_stacked(netA: LSTMEncoder, netV: LSTMEncoder, A, V):
    """Encode two modalities' sequences with ONE recurrence launch over both
    LSTMs: the same result as two separate calls. The two projections go to
    the kernel by their own base pointers and are not copied into one
    buffer. The caller must have checked `can_stack_pair`."""
    xw_a, wh_a = netA.project(A)
    xw_v, wh_v = netV.project(V)
    outs, (h, _) = lstm_sequence_stacked([xw_a, xw_v], [wh_a, wh_v])
    return netA.pool(outs[0], h[0]), netV.pool(outs[1], h[1])
