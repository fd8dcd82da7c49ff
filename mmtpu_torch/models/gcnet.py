"""GCNet's conversation graph (counterpart of mmtpu/models/gcnet.py).

Conversations stay padded (B, T, F). The window and speaker edges are dense
boolean adjacency masks (B, R, T, T), receiver-major (A[b, j, i]: an edge
from utterance i to utterance j), and the graph convolutions are batched
products over them, as in mmtpu:

- `window_adjacency`: j − i within [−window_past, window_future] (−1:
  unlimited) between valid utterances; `temporal_relation_adjacency`
  splits it into past (j > i), now, future, in that order;
  `speaker_relation_adjacency` into the n² relations q[j]·n + q[i]
  (n ≤ 2).
- `DenseRGCNConv`: raw `w_rel` (R, F, H), `w_root` (F, H) and `bias`;
  out[j] = x[j]·W_root + Σ_r mean_{i ∈ N_r(j)} x[i]·W_r + bias, the degree
  clipped at 1. `DenseGraphConv`: `lin_rel` over the sum of the
  neighbours plus a bias-free `lin_root` over the node itself.
- `MatchingAttention`: `dot`, `general` (bias-free `transform`),
  `general2` (`transform` with bias, the memory and the scores masked,
  tanh before the softmax, then renormalised over the mask with the sum
  clipped at 1e-12) and `concat` (`transform` over [memory; candidate],
  tanh, `vector_prod`), over every candidate at once; a 2-D candidate is
  one step and its output is squeezed. Returns (attended, alpha).
- `_BiRNNStack`: stacked bidirectional LSTM or GRU layers of flax's cells,
  named as mmtpu's tree names them (`OptimizedLSTMCell_{n}` /
  `GRUCell_{n}`: forward then backward, layer by layer), dropout between
  the layers. An LSTM layer is one G = 2 `lstm` launch
  (`bidirectional_lstm`): flax's `nn.RNN` with `seq_lengths` runs the
  forward direction over every step (its state is not frozen past the
  length) and the backward one over `flip_sequences` of its input, so the
  pad rows' outputs match mmtpu's too. A GRU layer is plain torch
  (`bidirectional_gru`): mmtpu has no GRU kernel.
- `GraphNetwork`: `conv1` (RGCN over the relations) → `conv2` (GraphConv
  over the union) → [x; out] zeroed at padded nodes → the 2-layer LSTM
  `grufusion` (H = d_h = F + hidden) → `general2` `matchatt` under
  `time_attention` → `linear` + ReLU.
- `GraphModel`: `base_rnn` (H = D_e) → `graph_net_temporal` (R = 3) +
  `graph_net_speaker` (R = n²) → `smax_fc` and `linear_rec`. Returns
  (logits, reconstruction, hidden).

The port builds every parameter at construction, so the options mmtpu's
flax modules reject at their first call (`n_speakers > 2`, an unknown base
or attention type, `concat` without `alpha_dim`, `dot` across widths)
raise there.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from mmtpu_torch.models.domain import _BiRNNHost
from mmtpu_torch.models.rng import GeneratorDropout

__all__ = [
    "window_adjacency",
    "temporal_relation_adjacency",
    "speaker_relation_adjacency",
    "DenseRGCNConv",
    "DenseGraphConv",
    "MatchingAttention",
    "GraphNetwork",
    "GraphModel",
]

ATT_TYPES = ("dot", "general", "general2", "concat")


def _deltas(T: int, device) -> torch.Tensor:
    idx = torch.arange(T, device=device)
    return idx[None, :, None] - idx[None, None, :]  # [_, j, i] = j − i


def window_adjacency(T: int, lengths: torch.Tensor, window_past: int,
                     window_future: int) -> torch.Tensor:
    """(B, T, T) boolean: A[b, j, i] iff an edge i → j."""
    delta = _deltas(T, lengths.device)
    ok = torch.ones((1, T, T), dtype=torch.bool, device=lengths.device)
    if window_past != -1:
        ok = ok & (delta >= -window_past)
    if window_future != -1:
        ok = ok & (delta <= window_future)
    valid = torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]
    return ok & valid[:, :, None] & valid[:, None, :]


def temporal_relation_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """(B, 3, T, T): past (j > i), now, future (j < i)."""
    delta = _deltas(adj.shape[-1], adj.device)
    return torch.stack([adj & (delta > 0), adj & (delta == 0), adj & (delta < 0)], dim=1)


def speaker_relation_adjacency(adj: torch.Tensor, qmask: torch.Tensor,
                               n_speakers: int) -> torch.Tensor:
    """(B, n², T, T): relation q[j]·n + q[i] of the edge i → j."""
    if n_speakers == 1:
        return adj[:, None]
    q = qmask.to(torch.int32)
    rel = q[:, :, None] * n_speakers + q[:, None, :]  # rel[b, j, i]
    rels = torch.arange(n_speakers * n_speakers, device=adj.device, dtype=torch.int32)
    return adj[:, None] & (rel[:, None] == rels[None, :, None, None])


class DenseRGCNConv(nn.Module):
    def __init__(self, in_features: int, features: int, num_relations: int) -> None:
        super().__init__()
        self.w_rel = nn.Parameter(torch.empty(num_relations, in_features, features))
        self.w_root = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.seeded_reset(None)

    @torch.no_grad()
    def seeded_reset(self, generator: Optional[torch.Generator]) -> None:
        """flax's LeCun normal over each raw kernel's fan-in (R·F for
        `w_rel`, as flax counts the relation axis as receptive field; F for
        `w_root`), the bias zero."""
        R, F, _ = self.w_rel.shape
        self.w_rel.normal_(0.0, math.sqrt(1.0 / (R * F)), generator=generator)
        self.w_root.normal_(0.0, math.sqrt(1.0 / F), generator=generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, adj_rel: torch.Tensor) -> torch.Tensor:
        a = adj_rel.to(x.dtype)  # (B, R, T, T)
        deg = torch.clamp(a.sum(dim=-1, keepdim=True), min=1.0)
        agg = torch.einsum("brji,bif->brjf", a / deg, x)
        out = torch.einsum("brjf,rfh->bjh", agg, self.w_rel)
        return out + x @ self.w_root + self.bias


class DenseGraphConv(nn.Module):
    def __init__(self, in_features: int, features: int) -> None:
        super().__init__()
        self.lin_rel = nn.Linear(in_features, features)
        self.lin_root = nn.Linear(in_features, features, bias=False)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        agg = torch.einsum("bji,bif->bjf", adj.to(x.dtype), x)
        return self.lin_rel(agg) + self.lin_root(x)


class MatchingAttention(nn.Module):
    """memory (B, S, D_mem), candidate (B, T, D_cand) or (B, D_cand), mask
    (B, S) → (attended (B, T, D_mem) or (B, D_mem), alpha (B, T, S))."""

    def __init__(self, mem_dim: int, cand_dim: int, alpha_dim: Optional[int] = None,
                 att_type: str = "general") -> None:
        super().__init__()
        if att_type == "concat" and alpha_dim is None:
            raise ValueError("alpha_dim must be provided for concat attention")
        if att_type == "dot" and mem_dim != cand_dim:
            raise ValueError("mem_dim must equal cand_dim for dot attention")
        if att_type not in ATT_TYPES:
            raise ValueError(f"unknown att_type {att_type!r}")
        self.mem_dim = mem_dim
        self.att_type = att_type
        if att_type in ("general", "general2"):
            self.transform = nn.Linear(cand_dim, mem_dim, bias=att_type == "general2")
        elif att_type == "concat":
            self.transform = nn.Linear(mem_dim + cand_dim, alpha_dim, bias=False)
            self.vector_prod = nn.Linear(alpha_dim, 1, bias=False)

    def forward(self, memory: torch.Tensor, candidate: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        squeeze = candidate.dim() == 2
        if squeeze:
            candidate = candidate[:, None, :]
        B, S = memory.shape[:2]
        mask = memory.new_ones((B, S)) if mask is None else mask.to(memory.dtype)
        if self.att_type == "dot":
            alpha = torch.softmax(torch.einsum("btd,bsd->bts", candidate, memory), dim=-1)
        elif self.att_type == "general":
            x = self.transform(candidate)
            alpha = torch.softmax(torch.einsum("btd,bsd->bts", x, memory), dim=-1)
        elif self.att_type == "general2":
            x = self.transform(candidate)
            m = memory * mask[:, :, None]
            scores = torch.einsum("btd,bsd->bts", x, m) * mask[:, None, :]
            alpha = torch.softmax(torch.tanh(scores), dim=-1) * mask[:, None, :]
            alpha = alpha / torch.clamp(alpha.sum(-1, keepdim=True), min=1e-12)
        else:  # concat
            Tc = candidate.shape[1]
            m = memory[:, None].expand(B, Tc, S, memory.shape[-1])
            c = candidate[:, :, None].expand(B, Tc, S, candidate.shape[-1])
            mx = torch.tanh(self.transform(torch.cat([m, c], dim=-1)))
            alpha = torch.softmax(self.vector_prod(mx)[..., 0], dim=-1)
        attended = torch.einsum("bts,bsd->btd", alpha, memory)
        return (attended[:, 0], alpha) if squeeze else (attended, alpha)


class _BiRNNStack(_BiRNNHost):
    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2,
                 cell: str = "lstm", dropout: float = 0.0) -> None:
        super().__init__()
        if cell not in ("lstm", "gru"):
            raise ValueError(f"cell {cell!r} is neither 'lstm' nor 'gru'")
        self._cells = 0
        self._pairs = [self._add_pair(cell, input_size if layer == 0 else 2 * hidden_size,
                                      hidden_size) for layer in range(num_layers)]
        self.dropout = GeneratorDropout(dropout)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = x
        for layer, pair in enumerate(self._pairs):
            if layer > 0:
                out = self.dropout(out)
            out = self._bi_rnn(pair, out, lengths)[0]
        return out


class GraphNetwork(nn.Module):
    """x (B, T, F), adj_rel (B, R, T, T), adj (B, T, T), valid (B, T),
    umask (B, T) → (B, T, F + hidden_size)."""

    def __init__(self, num_features: int, num_relations: int, time_attention: bool,
                 hidden_size: int = 64, dropout: float = 0.5) -> None:
        super().__init__()
        d_h = num_features + hidden_size
        self.time_attention = time_attention
        self.conv1 = DenseRGCNConv(num_features, hidden_size, num_relations)
        self.conv2 = DenseGraphConv(hidden_size, hidden_size)
        self.grufusion = _BiRNNStack(d_h, d_h, num_layers=2, cell="lstm", dropout=dropout)
        if time_attention:
            self.matchatt = MatchingAttention(2 * d_h, 2 * d_h, att_type="general2")
        self.linear = nn.Linear(2 * d_h, d_h)

    def forward(self, x: torch.Tensor, adj_rel: torch.Tensor, adj: torch.Tensor,
                valid: torch.Tensor, umask: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x, adj_rel), adj)
        cat = torch.cat([x, out], dim=-1) * valid[..., None].to(x.dtype)
        seq = self.grufusion(cat, valid.to(torch.int32).sum(dim=1))
        if self.time_attention:
            seq, _ = self.matchatt(seq, seq, mask=umask)
        return torch.relu(self.linear(seq))


class GraphModel(nn.Module):
    """features (B, T, adim + tdim + vdim), qmask (B, T) speaker ids, umask
    (B, T), lengths (B,) → (logits (B, T, n_classes), reconstruction
    (B, T, adim + tdim + vdim), hidden (B, T, 2·D_e + graph_hidden_size))."""

    def __init__(self, base_model: str, adim: int, tdim: int, vdim: int, D_e: int,  # noqa: N803
                 graph_hidden_size: int, n_speakers: int, window_past: int,
                 window_future: int, n_classes: int, dropout: float = 0.5,
                 time_attn: bool = True) -> None:
        super().__init__()
        if n_speakers > 2:
            raise ValueError("n_speakers must be <= 2 (reference constraint)")
        if base_model not in ("LSTM", "GRU"):
            raise ValueError(f"base_model {base_model!r} is neither 'LSTM' nor 'GRU'")
        self.n_speakers = n_speakers
        self.window_past = window_past
        self.window_future = window_future
        width = adim + tdim + vdim
        self.base_rnn = _BiRNNStack(width, D_e, num_layers=2, cell=base_model.lower(),
                                    dropout=dropout)
        nets = {"graph_net_temporal": 3, "graph_net_speaker": n_speakers * n_speakers}
        for name, relations in nets.items():
            self.add_module(name, GraphNetwork(2 * D_e, relations, time_attn,
                                               graph_hidden_size, dropout))
        d_h = 2 * D_e + graph_hidden_size
        self.smax_fc = nn.Linear(d_h, n_classes)
        self.linear_rec = nn.Linear(d_h, width)

    def forward(self, features: torch.Tensor, qmask: torch.Tensor, umask: torch.Tensor,
                lengths: torch.Tensor):
        T = features.shape[1]
        lengths = lengths.to(device=features.device, dtype=torch.int32)
        seq = self.base_rnn(features, lengths)
        valid = torch.arange(T, device=features.device)[None, :] < lengths[:, None]
        adj = window_adjacency(T, lengths, self.window_past, self.window_future)
        adj_t = temporal_relation_adjacency(adj)
        adj_s = speaker_relation_adjacency(adj, qmask, self.n_speakers)
        hidden = (self.graph_net_temporal(seq, adj_t, adj, valid, umask)
                  + self.graph_net_speaker(seq, adj_s, adj, valid, umask))
        return self.smax_fc(hidden), self.linear_rec(hidden), hidden
