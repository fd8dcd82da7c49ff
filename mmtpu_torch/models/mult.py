"""MulT, the Multimodal Transformer (counterpart of mmtpu/models/mult.py).

Per-modality 1-D convolutions (`proj_a`, `proj_v`, `proj_t`, each a
`conv` with bias, padding (k − 1) // 2, over channel-last input) to the
shared `attention_dim`; four gated crossmodal stacks (`text_audio_t`: text
attends audio, `text_audio_a`, `text_video_t`, `text_video_v`, each a
`GatedTransformer` named `stack` whose layer 0 cross-attends and whose
later layers self-attend, causally when `attention_mask`); masked mean
pooling over the valid steps (a plain mean without lengths); the residual
head `projection_one` → ReLU → dropout → `projection_two` + the pooled
features → `output_layer`. `attention_dropout_a` / `_v` are accepted and
unread, as in mmtpu (and the reference); `clip_grad_norm` is read from the
config's kwargs by the trainer, not by the model.

With `use_discriminator` the model returns {"logits", "aux_loss"}: a
binary head (`disc_hidden` → ReLU → `discriminator`) over the two
text-audio streams' pooled features stacked along the batch, labels 1 for
the text-conditioned copy and 0 for the audio-conditioned one, its
sigmoid cross-entropy averaged over the rows the published batch mask
marks real (`models/norm.py` `current_mask`, over both copies; every row
without one) and weighted by `lambda_d`. `ClassificationTask` adds it to
the classification loss. Dropouts draw from the run's generator.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmtpu_torch.models.norm import current_mask
from mmtpu_torch.models.rng import GeneratorDropout
from mmtpu_torch.models.seq_extras import GatedTransformer


class ConvProjection(nn.Module):
    """(B, T, in) → (B, T', attention_dim): a Conv1d with padding
    (k − 1) // 2 on both sides (T' = T for odd k)."""

    def __init__(self, input_dim: int, attention_dim: int, ksize: int = 3) -> None:
        super().__init__()
        self.conv = nn.Conv1d(input_dim, attention_dim, ksize, padding=(ksize - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.transpose(1, 2)).transpose(1, 2)


def masked_mean_pool(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, T, F) → (B, F): the mean over the first `lengths` steps (the sum
    divided by max(len, 1)), the plain mean without lengths."""
    if lengths is None:
        return x.mean(dim=1)
    lengths = lengths.to(x.device)
    steps = torch.arange(x.shape[1], device=x.device)
    mask = (steps[None, :] < lengths[:, None]).to(x.dtype)[..., None]
    return (x * mask).sum(dim=1) / torch.clamp(lengths[:, None].to(x.dtype), min=1.0)


class CrossmodalStack(nn.Module):
    """source → target: cross-attention in layer 0, self-attention after."""

    def __init__(self, target_dim: int, source_dim: int, embed_dim: int, num_heads: int,
                 layers: int, attention_dropout: float, relu_dropout: float,
                 residual_dropout: float, embd_dropout: float, attention_mask: bool) -> None:
        super().__init__()
        self.stack = GatedTransformer(
            input_dim=target_dim, embed_dim=embed_dim, num_heads=num_heads, layers=layers,
            attn_dropout=attention_dropout, relu_dropout=relu_dropout,
            res_dropout=residual_dropout, embed_dropout=embd_dropout,
            attn_mask=attention_mask, source_dim=source_dim)

    def forward(self, target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        return self.stack(target, source)


class MultModalTransformer(nn.Module):
    def __init__(self, orig_dim_a: int, orig_dim_t: int, orig_dim_v: int, attention_dim: int,
                 output_dim: int, num_heads: int = 5, num_layers: int = 5,
                 attention_dropout: float = 0.1, attention_dropout_a: float = 0.0,
                 attention_dropout_v: float = 0.0, relu_dropout: float = 0.1,
                 embd_dropout: float = 0.25, residual_dropout: float = 0.1,
                 output_dropout: float = 0.0, attention_mask: bool = True, a_ksize: int = 3,
                 t_ksize: int = 3, v_ksize: int = 3, use_discriminator: bool = False,
                 lambda_d: float = 0.1, clip_grad_norm: float = 0.8) -> None:
        super().__init__()
        d = attention_dim
        self.use_discriminator = bool(use_discriminator)
        self.lambda_d = float(lambda_d)
        self.proj_a = ConvProjection(orig_dim_a, d, a_ksize)
        self.proj_v = ConvProjection(orig_dim_v, d, v_ksize)
        self.proj_t = ConvProjection(orig_dim_t, d, t_ksize)
        for name in ("text_audio_t", "text_audio_a", "text_video_t", "text_video_v"):
            self.add_module(name, CrossmodalStack(
                d, d, d, num_heads, num_layers, attention_dropout, relu_dropout,
                residual_dropout, embd_dropout, attention_mask))
        self.projection_one = nn.Linear(4 * d, 4 * d)
        self.output_dropout = GeneratorDropout(output_dropout)
        self.projection_two = nn.Linear(4 * d, 4 * d)
        self.output_layer = nn.Linear(4 * d, output_dim)
        if self.use_discriminator:
            self.disc_hidden = nn.Linear(d, d)
            self.discriminator = nn.Linear(d, 1)

    def forward(self, A: torch.Tensor, V: torch.Tensor, T: torch.Tensor,  # noqa: N803
                lengths: Optional[torch.Tensor] = None):
        a_seq, v_seq, t_seq = self.proj_a(A), self.proj_v(V), self.proj_t(T)
        a2t = self.text_audio_t(t_seq, a_seq)  # text attends audio
        t2a = self.text_audio_a(a_seq, t_seq)
        v2t = self.text_video_t(t_seq, v_seq)
        t2v = self.text_video_v(v_seq, t_seq)
        pools = [masked_mean_pool(s, lengths) for s in (a2t, t2a, v2t, t2v)]
        pooled = torch.cat(pools, dim=-1)  # (B, 4·attention_dim)
        h = self.output_dropout(torch.relu(self.projection_one(pooled)))
        logits = self.output_layer(self.projection_two(h) + pooled)
        if not self.use_discriminator:
            return logits
        disc_in = torch.cat(pools[:2], dim=0)
        disc = self.discriminator(torch.relu(self.disc_hidden(disc_in))).reshape(-1)
        b = a2t.shape[0]
        labels = torch.cat([disc.new_ones(b), disc.new_zeros(b)])
        per = F.binary_cross_entropy_with_logits(disc, labels, reduction="none")
        sm = current_mask()
        if sm is not None:  # padded tail rows carry no signal, in either copy
            m = torch.cat([sm, sm]).to(per.dtype)
            disc_loss = (per * m).sum() / torch.clamp(m.sum(), min=1.0)
        else:
            disc_loss = per.mean()
        return {"logits": logits, "aux_loss": self.lambda_d * disc_loss}
