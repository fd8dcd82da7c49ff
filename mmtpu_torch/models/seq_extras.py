"""Sequence-model building blocks (counterpart of mmtpu/models/seq_extras.py):
sinusoidal positions, the gated transformer encoder, the early-fusion
acoustic + lexical head.

- `sinusoidal_positional_embedding`: the (positions, dim) table, half sin,
  half cos, frequencies exp(−k·ln(10⁴)/(half − 1)) (the reference's
  `half − 1`), zero-padded by one column at an odd width.
- `GatedTransformerEncoderLayer`: pre-norm attention (`ln_0`; keys and
  values from `ln_0_k` of the source when one is given, which only a
  layer built with `kv_dim` has), the causal mask only for
  self-attention with `attn_mask`, sigmoid `attention_projection` /
  `memory_projection` gates over [residual; attention], then a pre-norm
  4× ReLU feed-forward with a residual.
- `GatedTransformer`: `proj` × √d plus the positions, the source through
  `proj_k` × √d and its positions into layer 0 only, the layers, then
  `ln_final`. flax builds `proj_k` and layer 0's `ln_0_k` at the first
  call with a source; the port builds them at construction when
  `source_dim` is given, and a source passed to a transformer built
  without it raises.
- `EFModelAL`: an acoustic `FcClassifier` and a lexical `LSTMClassifier`,
  their outputs concatenated, dropout, `out1` + ReLU, dropout, `out2`;
  returns (logits, fused features). `out1` reads `out_dim_a + out_dim_v`
  features, the reference's width (classifier.py:120), where flax infers
  it from the inputs: the two agree when the acoustic classifier's output
  is `out_dim_a` wide and the lexical one's `fc1_size` is `out_dim_v`.

Every LayerNorm is flax's (ε 1e-6, variance E[x²] − E[x]²); the attention
is `MultiHeadAttention` of `models/transformer.py` (flax's logit scale and
masked value, its dropout shared over batch and heads). Dropout draws from
the run's generator (`models/rng.py`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from mmtpu_torch.models.bert_text import FlaxLayerNorm
from mmtpu_torch.models.rng import GeneratorDropout
from mmtpu_torch.models.transformer import MultiHeadAttention

LN_EPS = 1e-6  # flax's LayerNorm epsilon


def sinusoidal_positional_embedding(num_positions: int, embedding_dim: int,
                                    device=None) -> torch.Tensor:
    """(num_positions, embedding_dim) float32 table."""
    half = embedding_dim // 2
    steps = torch.arange(half, dtype=torch.float32, device=device)
    freq = torch.exp(steps * -(math.log(10000.0) / max(half - 1, 1)))
    args = torch.arange(num_positions, dtype=torch.float32, device=device)[:, None] * freq[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if embedding_dim % 2 == 1:
        emb = nn.functional.pad(emb, (0, 1))
    return emb


class SinusoidalPositionalEmbedding(nn.Module):
    """x (B, seq, dim) → x + the table over its positions."""

    def __init__(self, embedding_dim: int, padding_idx: int = 0) -> None:
        super().__init__()
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        table = sinusoidal_positional_embedding(x.shape[1], self.embedding_dim, x.device)
        return x + table[None].to(x.dtype)


def future_mask(length: int, device=None) -> torch.Tensor:
    """Causal mask: True where attention is allowed."""
    return torch.tril(torch.ones(length, length, dtype=torch.bool, device=device))


class GatedTransformerEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 4, attn_dropout: float = 0.1,
                 relu_dropout: float = 0.1, res_dropout: float = 0.1, attn_mask: bool = False,
                 kv_dim: Optional[int] = None) -> None:
        super().__init__()
        self.attn_mask = attn_mask
        self.ln_0 = FlaxLayerNorm(embed_dim, eps=LN_EPS)
        if kv_dim is not None:
            self.ln_0_k = FlaxLayerNorm(kv_dim, eps=LN_EPS)
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, attn_dropout, kv_dim=kv_dim)
        self.attention_projection = nn.Linear(2 * embed_dim, embed_dim)
        self.memory_projection = nn.Linear(2 * embed_dim, embed_dim)
        self.ln_1 = FlaxLayerNorm(embed_dim, eps=LN_EPS)
        self.feed_forward_one = nn.Linear(embed_dim, 4 * embed_dim)
        self.feed_forward_two = nn.Linear(4 * embed_dim, embed_dim)
        self.relu_dropout = GeneratorDropout(relu_dropout)
        self.res_dropout = GeneratorDropout(res_dropout)

    def forward(self, x: torch.Tensor, x_k: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = x
        h = self.ln_0(x)
        if x_k is None:
            kv = h
        elif hasattr(self, "ln_0_k"):
            kv = self.ln_0_k(x_k)
        else:
            raise ValueError("this layer was built without a source (kv_dim)")
        mask = None
        if self.attn_mask and x_k is None:
            mask = future_mask(h.shape[1], h.device)[None, None]
        attn = self.res_dropout(self.self_attn(h, kv, mask))
        gate_in = torch.cat([residual, attn], dim=-1)
        a_gate = torch.sigmoid(self.attention_projection(gate_in))
        m_gate = torch.sigmoid(self.memory_projection(gate_in))
        x = m_gate * residual + a_gate * attn

        residual = x
        h = torch.relu(self.feed_forward_one(self.ln_1(x)))
        h = self.feed_forward_two(self.relu_dropout(h))
        return residual + self.res_dropout(h)


class GatedTransformer(nn.Module):
    def __init__(self, input_dim: int, embed_dim: int, num_heads: int = 4, layers: int = 4,
                 attn_dropout: float = 0.1, relu_dropout: float = 0.1, res_dropout: float = 0.1,
                 embed_dropout: float = 0.25, attn_mask: bool = False,
                 source_dim: Optional[int] = None) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.layers = layers
        self.proj = nn.Linear(input_dim, embed_dim)
        self.pos = SinusoidalPositionalEmbedding(embed_dim)
        self.embed_dropout = GeneratorDropout(embed_dropout)
        self.has_source = source_dim is not None
        if self.has_source:
            self.proj_k = nn.Linear(source_dim, embed_dim)
            self.pos_k = SinusoidalPositionalEmbedding(embed_dim)
        for i in range(layers):
            setattr(self, f"layer_{i}", GatedTransformerEncoderLayer(
                embed_dim, num_heads, attn_dropout, relu_dropout, res_dropout, attn_mask,
                kv_dim=embed_dim if i == 0 and self.has_source else None))
        self.ln_final = FlaxLayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, x_k: Optional[torch.Tensor] = None) -> torch.Tensor:
        scale = math.sqrt(self.embed_dim)
        h = self.embed_dropout(self.pos(self.proj(x) * scale))
        k = None
        if x_k is not None:
            if not self.has_source:
                raise ValueError("GatedTransformer was built without source_dim")
            k = self.pos_k(self.proj_k(x_k) * scale)
        for i in range(self.layers):
            h = getattr(self, f"layer_{i}")(h, k if i == 0 else None)
        return self.ln_final(h)


class EFModelAL(nn.Module):
    def __init__(self, fc_classifier: nn.Module, lstm_classifier: nn.Module, out_dim_a: int,
                 out_dim_v: int, fusion_size: int, num_class: int,
                 dropout: float = 0.3) -> None:
        super().__init__()
        self.fc_classifier = fc_classifier
        self.lstm_classifier = lstm_classifier
        self.dropout = GeneratorDropout(dropout)
        self.out1 = nn.Linear(out_dim_a + out_dim_v, fusion_size)
        self.out2 = nn.Linear(fusion_size, num_class)

    def forward(self, A_feat: torch.Tensor, L_feat: torch.Tensor,  # noqa: N803 (mmtpu's names)
                L_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        a_out = self.fc_classifier(A_feat)
        _, l_out = self.lstm_classifier(L_feat, L_mask)
        feat = self.dropout(torch.cat([a_out, l_out], dim=-1))
        feat = torch.relu(self.out1(feat))
        return self.out2(self.dropout(feat)), feat
