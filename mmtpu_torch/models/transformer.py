"""VAE-transformer encoder (counterpart of mmtpu/models/transformer.py).

`ResidualAttentionBlock`: self-attention and MLP sublayers in the
reference's ``x + ln(attn(ln(x)))`` form (a LayerNorm on each side of every
sublayer), flax's LayerNorm epsilon 1e-6, attention dropout 0.2 and MLP
dropout 0.1. `Transformer`: Linear `proj` → blocks → mean over time →
sigmoid → the μ/logσ² head `muvar`, and the sample z = μ + ε·exp(½·logσ²):
ε standard normal in training, 0 in eval (mmtpu's documented deviation:
the reference samples in eval too). Returns (z, μ, logσ²).

The attention is flax's `MultiHeadDotProductAttention`, written out as
softmax(q·kᵀ/√head_dim)·v over the heads (self-attention here; the gated
transformer of `models/seq_extras.py` also uses its cross-attention and
boolean mask): flax's dropout on the attention
weights is broadcast (one (q, k) keep-mask shared by the batch and the
heads, `broadcast_dropout=True`), which `F.scaled_dot_product_attention`'s
per-element dropout is not. The dropouts and ε come from the run's
generator (`models/rng.py`). The projections `query`, `key`, `value` and
`out` are Linear layers over the flattened heads; `from_jax_variables`
reshapes flax's (d, heads, head_dim) and (heads, head_dim, d) kernels onto
them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)

from mmtpu_torch.models.rng import GeneratorDropout, GeneratorNormal

LN_EPS = 1e-6  # flax's LayerNorm epsilon (torch's default is 1e-5)


class MultiHeadAttention(nn.Module):
    """flax's `MultiHeadDotProductAttention`: queries from `x`, keys and
    values from `kv` (`x` itself when None, self-attention; `kv_dim` is
    its width, `d_model` by default). `mask`, boolean and broadcast as
    (1, 1, Tq, Tk) against (B, heads, Tq, Tk), keeps the logits where it
    is True and sets the rest to float32's most negative value, flax's
    masked-logit value."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.2,
                 kv_dim: Optional[int] = None) -> None:
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} is not divisible by {n_head} heads")
        self.n_head = n_head
        self.head_dim = d_model // n_head
        kv_dim = d_model if kv_dim is None else kv_dim
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(kv_dim, d_model)
        self.value = nn.Linear(kv_dim, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.dropout = GeneratorDropout(dropout, broadcast_dims=(0, 1))

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape
        kv = x if kv is None else kv

        def heads(t: torch.Tensor) -> torch.Tensor:  # (B, T, d) → (B, heads, T, head_dim)
            return t.reshape(B, t.shape[1], self.n_head, self.head_dim).transpose(1, 2)

        q = heads(self.query(x)) / self.head_dim ** 0.5
        k, v = heads(self.key(kv)), heads(self.value(kv))
        logits = q @ k.transpose(-1, -2)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        weights = self.dropout(torch.softmax(logits, dim=-1))
        return self.out((weights @ v).transpose(1, 2).reshape(B, T, -1))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int) -> None:
        super().__init__()
        self.ln_1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = MultiHeadAttention(d_model, n_head, dropout=0.2)
        self.ln_12 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ln_2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.c_fc = nn.Linear(d_model, 4 * d_model)
        self.mlp_dropout = GeneratorDropout(0.1)
        self.c_proj = nn.Linear(4 * d_model, d_model)
        self.ln_22 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ln_12(self.attn(self.ln_1(x)))
        m = self.mlp_dropout(torch.relu(self.c_fc(self.ln_2(x))))
        return x + self.ln_22(self.c_proj(m))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, embd_width: int) -> None:
        super().__init__()
        self.embd_width = embd_width
        self.layers = layers
        self.proj = nn.Linear(width, embd_width)
        for i in range(layers):
            setattr(self, f"resblock_{i}", ResidualAttentionBlock(embd_width, heads))
        self.muvar = nn.Linear(embd_width, 2 * embd_width)
        self.sample = GeneratorNormal()

    def get_embedding_size(self) -> int:
        return self.embd_width

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.proj(x)
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x)
        x = torch.sigmoid(x.mean(dim=1))
        muvar = self.muvar(x).reshape(-1, 2, self.embd_width)
        mu, log_var = muvar[:, 0], muvar[:, 1]
        return mu + self.sample(mu) * torch.exp(0.5 * log_var), mu, log_var
