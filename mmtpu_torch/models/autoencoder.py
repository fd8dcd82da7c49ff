"""Residual autoencoders (counterpart of mmtpu/models/autoencoder.py).

`ResidualAE`: n cascaded encoder/decoder blocks, block i encoding
x_in = x + Σ previous reconstructions; returns (transition(x_in + x_out),
concat(latents)), the latent `n_blocks × layers[-1]` wide. `ResidualXE`: the
same with a cross-modal output width. `ResidualUnetAE`: U-Net-style blocks
whose decoder levels fuse the same-depth encoder activation. `SimpleFcAE`:
a plain MLP autoencoder returning (recon, latent).

Encoder stacks use LeakyReLU (slope 0.01) with the last layer bare; decoder
stacks ReLU with a bare `fc_out`. With `use_bn`, BatchNorm is the pad-aware
`models/norm.py` one, applied on the layer output (mmtpu's documented
deviation: the reference's decoder BatchNorm has mismatched widths).
Dropout draws from the run's generator (`models/rng.py`).

Key names as mmtpu's flax trees: `encoder_{i}.fc_{j}`, `encoder_{i}.bn_{j}`,
`decoder_{i}.fc_{j}`, `decoder_{i}.fc_out`, `transition_{0,1}`; the U-Net's
`encoder_{i}_fc_{l}`, `decoder_{i}_fc_{l}`; SimpleFcAE's `enc_{i}`,
`enc_bn_{i}`, `dec_{i}`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmtpu_torch.models.norm import BatchNorm
from mmtpu_torch.models.rng import GeneratorDropout


def _dropout(p: float) -> Optional[GeneratorDropout]:
    return GeneratorDropout(p) if p > 0 else None


class _EncoderStack(nn.Module):
    def __init__(self, input_dim: int, layers: Sequence[int], dropout: float,
                 use_bn: bool) -> None:
        super().__init__()
        self.layers = tuple(layers)
        self.use_bn = use_bn
        self.dropout = _dropout(dropout)
        width_in = input_dim
        for i, width in enumerate(self.layers):
            setattr(self, f"fc_{i}", nn.Linear(width_in, width))
            if use_bn and i < len(self.layers) - 1:
                setattr(self, f"bn_{i}", BatchNorm(width))
            width_in = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.layers)):
            x = getattr(self, f"fc_{i}")(x)
            if i < len(self.layers) - 1:  # the last layer stays bare
                x = F.leaky_relu(x, 0.01)
                if self.use_bn:
                    x = getattr(self, f"bn_{i}")(x)
                if self.dropout is not None:
                    x = self.dropout(x)
        return x


class _DecoderStack(nn.Module):
    """`widths`: the reversed encoder layers and the output width."""

    def __init__(self, widths: Sequence[int], dropout: float, use_bn: bool) -> None:
        super().__init__()
        self.widths = tuple(widths)
        self.use_bn = use_bn
        self.dropout = _dropout(dropout)
        for i in range(len(self.widths) - 2):
            setattr(self, f"fc_{i}", nn.Linear(self.widths[i], self.widths[i + 1]))
            if use_bn:
                setattr(self, f"bn_{i}", BatchNorm(self.widths[i + 1]))
        self.fc_out = nn.Linear(self.widths[-2], self.widths[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.widths) - 2):
            x = torch.relu(getattr(self, f"fc_{i}")(x))
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x)
            if self.dropout is not None:
                x = self.dropout(x)
        return self.fc_out(x)


class ResidualXE(nn.Module):
    """Cross-modal residual AE: the transition maps input_dim → output_dim."""

    def __init__(self, layers: Sequence[int], n_blocks: int, input_dim: int, output_dim: int,
                 dropout: float = 0.5, use_bn: bool = False) -> None:
        super().__init__()
        self.layers = tuple(layers)
        self.n_blocks = int(n_blocks)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        dec_widths = list(reversed(self.layers)) + [self.input_dim]
        for i in range(self.n_blocks):
            setattr(self, f"encoder_{i}", _EncoderStack(self.input_dim, self.layers, dropout,
                                                        use_bn))
            setattr(self, f"decoder_{i}", _DecoderStack(dec_widths, dropout, use_bn))
        self.transition_0 = nn.Linear(self.input_dim, self.input_dim)
        self.transition_1 = nn.Linear(self.input_dim, self.output_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x_in, x_out = x, torch.zeros_like(x)
        latents = []
        for i in range(self.n_blocks):
            x_in = x_in + x_out
            latent = getattr(self, f"encoder_{i}")(x_in)
            x_out = getattr(self, f"decoder_{i}")(latent)
            latents.append(latent)
        h = self.transition_1(torch.relu(self.transition_0(x_in + x_out)))
        return h, torch.cat(latents, dim=-1)


class ResidualAE(ResidualXE):
    def __init__(self, layers: Sequence[int], n_blocks: int, input_dim: int,
                 dropout: float = 0.5, use_bn: bool = False) -> None:
        super().__init__(layers, n_blocks, input_dim, input_dim, dropout, use_bn)


class ResidualUnetAE(nn.Module):
    """`layers` lists the encoder half; the decoder mirrors it, each level
    after the deepest fusing the same-depth encoder activation by `fusion`
    ('concat' doubles the width, 'add' keeps it). Blocks chain residually
    as ResidualAE's. Returns (final recon, {block index: recon})."""

    def __init__(self, layers: Sequence[int], n_blocks: int, input_dim: int,
                 dropout: float = 0.5, use_bn: bool = False, fusion: str = "concat") -> None:
        super().__init__()
        assert fusion in ("concat", "add"), "Only concat and add"
        self.layers = tuple(layers)
        self.n_blocks = int(n_blocks)
        self.input_dim = int(input_dim)
        self.use_bn = use_bn
        self.fusion = fusion
        self.dropout = _dropout(dropout)
        depth = len(self.layers)
        dec_widths = list(reversed(self.layers))[1:] + [self.input_dim]
        for i in range(self.n_blocks):
            width_in = self.input_dim
            for lvl, width in enumerate(self.layers):
                setattr(self, f"encoder_{i}_fc_{lvl}", nn.Linear(width_in, width))
                if use_bn:
                    setattr(self, f"encoder_{i}_bn_{lvl}", BatchNorm(width))
                width_in = width
            for lvl in range(depth):
                if lvl > 0 and fusion == "concat":
                    width_in = 2 * width_in
                setattr(self, f"decoder_{i}_fc_{lvl}", nn.Linear(width_in, dec_widths[lvl]))
                width_in = dec_widths[lvl]

    def _block(self, i: int, h: torch.Tensor) -> torch.Tensor:
        depth = len(self.layers)
        skips = []
        for lvl in range(depth):
            h = F.leaky_relu(getattr(self, f"encoder_{i}_fc_{lvl}")(h), 0.01)
            if self.use_bn:
                h = getattr(self, f"encoder_{i}_bn_{lvl}")(h)
            if self.dropout is not None:
                h = self.dropout(h)
            skips.append(h)
        for lvl in range(depth):
            if lvl > 0:
                skip = skips[depth - 1 - lvl]
                h = torch.cat([h, skip], dim=-1) if self.fusion == "concat" else h + skip
            h = getattr(self, f"decoder_{i}_fc_{lvl}")(h)
            if lvl == depth - 1:
                h = torch.relu(h)  # the reference's final Sequential ends in ReLU
            else:
                h = F.leaky_relu(h, 0.01)
                if self.dropout is not None:
                    h = self.dropout(h)
        return h

    def forward(self, x: torch.Tensor):
        x_in, x_out = x, torch.zeros_like(x)
        outputs = {}
        for i in range(self.n_blocks):
            x_in = x_in + x_out
            x_out = self._block(i, x_in)
            outputs[i] = x_out
        return x_out, outputs


class SimpleFcAE(nn.Module):
    def __init__(self, layers: Sequence[int], input_dim: int, dropout: float = 0.5,
                 use_bn: bool = False) -> None:
        super().__init__()
        self.layers = tuple(layers)
        self.use_bn = use_bn
        self.dropout = _dropout(dropout)
        width_in = int(input_dim)
        for i, width in enumerate(self.layers):
            setattr(self, f"enc_{i}", nn.Linear(width_in, width))
            if use_bn:
                setattr(self, f"enc_bn_{i}", BatchNorm(width))
            width_in = width
        self.dec_widths = list(reversed(self.layers)) + [int(input_dim)]
        for i in range(len(self.dec_widths) - 1):
            setattr(self, f"dec_{i}", nn.Linear(self.dec_widths[i], self.dec_widths[i + 1]))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        latent = x
        for i in range(len(self.layers)):
            latent = F.leaky_relu(getattr(self, f"enc_{i}")(latent), 0.01)
            if self.use_bn:
                latent = getattr(self, f"enc_bn_{i}")(latent)
            if self.dropout is not None:
                latent = self.dropout(latent)
        recon = latent
        last = len(self.dec_widths) - 2
        for i in range(last + 1):
            recon = getattr(self, f"dec_{i}")(recon)
            recon = torch.relu(recon) if i == last else F.leaky_relu(recon, 0.01)
            if self.dropout is not None:
                recon = self.dropout(recon)
        return recon, latent
