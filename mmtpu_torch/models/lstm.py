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

`LSTMClassifier` (EFModelAL's lexical branch): two stacked bidirectional
layers of flax's per-gate cells (`OptimizedLSTMCell_{0..3}`: rnn1 forward
and backward, then rnn2's), each layer one G = 2 launch through
`bidirectional_lstm`, lengths from the mask as sum(int(mean(mask, -1))),
flax's LayerNorm between the layers, then [h1; h2] → the pad-aware
BatchNorm `bn` → `fc1` → dropout → ReLU → `fc2`. Returns (logits, the
features after the ReLU).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmtpu_torch.models.bert_text import FlaxLayerNorm
from mmtpu_torch.models.norm import BatchNorm
from mmtpu_torch.models.rng import GeneratorDropout
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
            # amax splits the gradient of tied maxima evenly, as jnp.max does
            # (max(dim).values gives it all to one step)
            return torch.amax(outputs, dim=1)
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


def flip_sequences(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """flax's `flip_sequences` over (B, T, ...) batch-major rows: row b's
    step t taken from step (T − 1 − t + len_b) mod T; a plain reverse
    without lengths. Its own inverse."""
    T = x.shape[1]
    if lengths is None:
        return torch.flip(x, dims=(1,))
    steps = torch.arange(T - 1, -1, -1, device=x.device)
    idx = (steps[None, :] + lengths.to(device=x.device, dtype=torch.long)[:, None]) % T
    idx = idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand_as(x)
    return torch.gather(x, 1, idx)


def bidirectional_lstm(fwd: RNNCell, bwd: RNNCell, x: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None):
    """One bidirectional layer of flax's `nn.RNN(OptimizedLSTMCell,
    return_carry=True)` pair (the backward one `reverse=True,
    keep_order=True`), both directions in ONE `lstm` launch (G = 2).

    The recurrence runs over every step without lengths, as flax's does;
    the backward direction reads `flip_sequences(x, lengths)` and its
    outputs are flipped back. With lengths each direction's final h is its
    output at step len − 1 (`carry_at`), else the state after step T.
    Returns (outputs (B, T, 2H), h_fwd (B, H), h_bwd (B, H))."""
    xs = (x, flip_sequences(x, lengths))
    projected = [cell.project(inp) for cell, inp in zip((fwd, bwd), xs)]
    outs, (hT, _) = lstm_sequence_stacked([p[0] for p in projected],
                                          [p[1] for p in projected])
    h_f, h_b = (hT[d] if lengths is None else carry_at(outs[d], lengths) for d in range(2))
    return torch.cat([outs[0], flip_sequences(outs[1], lengths)], dim=-1), h_f, h_b


class LSTMClassifier(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, fc1_size: int, output_size: int,
                 dropout_rate: float = 0.3) -> None:
        super().__init__()
        for n, width in enumerate((input_size, input_size, 2 * hidden_size, 2 * hidden_size)):
            self.add_module(f"OptimizedLSTMCell_{n}", RNNCell(width, hidden_size))
        self.layer_norm = FlaxLayerNorm(2 * hidden_size, eps=1e-6)
        self.bn = BatchNorm(4 * hidden_size)
        self.fc1 = nn.Linear(4 * hidden_size, fc1_size)
        self.dropout = GeneratorDropout(dropout_rate)
        self.fc2 = nn.Linear(fc1_size, output_size)

    def _layer(self, first: int, x: torch.Tensor, lengths: Optional[torch.Tensor]):
        return bidirectional_lstm(getattr(self, f"OptimizedLSTMCell_{first}"),
                                  getattr(self, f"OptimizedLSTMCell_{first + 1}"), x, lengths)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        lengths = None
        if mask is not None:  # (B, seq, feat) → (B,), the reference's mask2length
            lengths = mask.mean(dim=-1).to(torch.int32).sum(dim=-1)
        out1, h1_f, h1_b = self._layer(0, x, lengths)
        _, h2_f, h2_b = self._layer(2, self.layer_norm(out1), lengths)
        h = self.fc1(self.bn(torch.cat([h1_f, h1_b, h2_f, h2_b], dim=-1)))
        h = torch.relu(self.dropout(h))
        return self.fc2(h), h


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
