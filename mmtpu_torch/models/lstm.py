"""LSTM sequence encoder (counterpart of `LSTMEncoder`, `can_stack_pair` and
`encode_pair_stacked`, mmtpu/models/lstm.py).

Two parameter layouts, as in mmtpu, under mmtpu's names:
- `backend='fused'`: `wi` is the input projection `nn.Linear(I, 4H)`
  (weight and one bias), `wh` a raw (H, 4H) recurrent matrix, gate order
  `[i, f, g, o]`;
- `backend='rnn'`: flax's `nn.RNN(OptimizedLSTMCell)`, whose parameters
  mmtpu's checkpoints hold as a top-level `OptimizedLSTMCell_0` with one
  Dense per gate: `ii`, `if`, `ig`, `io` over the input (no bias) and `hi`,
  `hf`, `hg`, `ho` over h (with bias).
`attention_layer` and the raw (H, 1) `attention_vector_weight` exist only
for `embd_method='attention'`.

Both layouts compute the same recurrence, so both run through
`mmtpu_torch.ops.lstm` (on CUDA tensors the hand-written kernel, on the CPU
the plain scan): the per-gate weights are concatenated into the fused
layout for each call. The two differ only in how lengths are taken. The
fused backend freezes h and c once `t ≥ len` (mmtpu's `lstm_sequence`);
flax's RNN runs every step and returns the carry at index `len - 1`
(`_select_last_carry`: `len = 0` wraps to the last step, `len > T` clamps to
it, with no gradient back through the clamped index, as in JAX), so the
`rnn` backend runs the recurrence without lengths and picks that carry from
the outputs.

Pooling methods: 'last' (the last state under length masking), 'attention'
(softmax(u·tanh(W·h))·h), 'maxpool'; padded steps are masked to -inf out of
the attention and maxpool reductions when lengths are given.

mmtpu's `LSTMClassifier` is not ported: no config and no registry name
reaches it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmtpu_torch.ops.lstm import lstm_sequence, lstm_sequence_stacked

EMBD_METHODS = ("last", "attention", "maxpool")
BACKENDS = ("fused", "rnn")
GATES = ("i", "f", "g", "o")  # the kernel's gate order
RNN_CELL = "OptimizedLSTMCell_0"  # where mmtpu's checkpoints keep the rnn backend's cell


class RNNCell(nn.ModuleDict):
    """flax's `OptimizedLSTMCell` parameters: one Dense per gate, `ii`, `if`,
    `ig`, `io` over the input (no bias) and `hi`, `hf`, `hg`, `ho` over h
    (with bias; their recurrent weights orthogonal)."""

    def __init__(self, input_size: int, hidden_size: int) -> None:
        super().__init__()
        for gate in GATES:
            self[f"i{gate}"] = nn.Linear(input_size, hidden_size, bias=False)
        for gate in GATES:
            self[f"h{gate}"] = nn.Linear(hidden_size, hidden_size)
            nn.init.orthogonal_(self[f"h{gate}"].weight)

    def project(self, x: torch.Tensor):
        """(x·Wi + b, wh (H, 4H)): the per-gate weights concatenated into the
        kernel's fused layout, gate order [i, f, g, o], the h-Dense biases
        as the one bias."""
        wi = torch.cat([self[f"i{gate}"].weight for gate in GATES])
        bias = torch.cat([self[f"h{gate}"].bias for gate in GATES])
        wh = torch.cat([self[f"h{gate}"].weight.t() for gate in GATES], dim=1)
        return F.linear(x, wi, bias), wh


class LSTMEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, embd_method: str = "last",
                 backend: str = "fused") -> None:
        super().__init__()
        if embd_method not in EMBD_METHODS:
            raise ValueError(f"embd_method {embd_method!r} not in {EMBD_METHODS}")
        if backend not in BACKENDS:
            raise ValueError(f"LSTMEncoder backend {backend!r} not in {BACKENDS}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.embd_method = embd_method
        self.backend = backend
        if backend == "fused":
            self.wi = nn.Linear(input_size, 4 * hidden_size)
            self.wh = nn.Parameter(torch.empty(hidden_size, 4 * hidden_size))
            nn.init.orthogonal_(self.wh)
        else:
            self.add_module(RNN_CELL, RNNCell(input_size, hidden_size))
        if embd_method == "attention":
            self.attention_layer = nn.Linear(hidden_size, hidden_size)
            self.attention_vector_weight = nn.Parameter(torch.empty(hidden_size, 1))
            nn.init.normal_(self.attention_vector_weight, std=hidden_size ** -0.5)

    def get_embedding_size(self) -> int:
        return self.hidden_size

    def project(self, x: torch.Tensor):
        """The input projection x·Wi + b (the parallel GEMM) and the recurrent
        weights (H, 4H): what a host model needs to advance several encoders'
        recurrences in one launch. The rnn backend's per-gate weights are
        concatenated into that layout, gate order [i, f, g, o], with the
        biases of its h-Dense layers as the one bias."""
        if self.backend == "fused":
            return self.wi(x), self.wh
        return getattr(self, RNN_CELL).project(x)

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
        if self.backend == "rnn":
            outputs, (carry_h, _) = lstm_sequence(xw, wh)
            if lengths is not None:
                carry_h = carry_at(outputs, lengths)
        else:
            outputs, (carry_h, _) = lstm_sequence(
                xw, wh, lengths=lengths.to(torch.int32) if lengths is not None else None,
            )
        return self.pool(outputs, carry_h, lengths)


def carry_at(outputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """flax's `_select_last_carry` for h: row b's output at step len_b - 1,
    as a JAX gather takes it and as its transpose gives the gradient back.
    An index of -1 (len 0) is taken from the end, a normal index, so the
    gradient reaches the last step. An index past T - 1 is clamped to it in
    the forward, but the transpose (a scatter-add) drops an out-of-bounds
    index: those rows get the last step's value and no gradient."""
    T = outputs.shape[1]
    idx = lengths.to(device=outputs.device, dtype=torch.long) - 1
    idx = torch.where(idx < 0, idx + T, idx)
    h = outputs[torch.arange(outputs.shape[0], device=outputs.device), idx.clamp(0, T - 1)]
    return torch.where((idx > T - 1)[:, None], h.detach(), h)


# mmtpu registers the reference's near-duplicate LSTMEncoder2 as an alias.
LSTMEncoder2 = LSTMEncoder


def can_stack_pair(netA: nn.Module, netV: nn.Module, A, V) -> bool:
    """True when two sibling encoders' recurrences can be advanced by one
    launch: both fused LSTMEncoders with equal hidden size over aligned
    (B, T) sequence inputs (mmtpu's rule: two `rnn` encoders do not stack,
    though the arithmetic would come out the same)."""
    return (
        A is not None and V is not None
        and type(netA) is LSTMEncoder and type(netV) is LSTMEncoder
        and netA.backend == "fused" and netV.backend == "fused"
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
