"""Fusion primitives (counterpart of mmtpu/models/fusion.py): MaxOut,
GatedBiModalNetwork, MultimodalPooling. Small GEMM and elementwise blocks:
stock PyTorch on the card, no kernel of the port's own (mmtpu runs them as
plain XLA too).

- `MaxOut`: ONE Linear `units` of width units·out, its output reshaped
  (…, units, out) as flax reshapes it, then the max over the units. The
  weight's rows are unit-major, so `from_jax_variables`'s plain transpose
  of flax's (in, units·out) kernel keeps each unit's columns.
- `GatedBiModalNetwork` (GMU): tanh projections `fc_one`, `fc_two` of the
  two modalities and one sigmoid gate `hidden_sigmoid` over their concat;
  no biases by default.
- `MultimodalPooling`: tanh projections `proj_a`, `proj_b` (dropout from
  the run's generator), then max, avg/average, sum, attention (a softmax
  over two scores from `att_hidden`, `att_out`) or gated (`gate_hidden`,
  `gate_out`) pooling. Only the layers the kind uses exist, as in flax.
"""

from __future__ import annotations

import torch
from torch import nn

from mmtpu_torch.models.rng import GeneratorDropout

POOLING_KINDS = ("max", "avg", "average", "sum", "attention", "gated")


class MaxOut(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, num_units: int = 2,
                 use_bias: bool = True) -> None:
        super().__init__()
        self.output_dim = output_dim
        self.num_units = num_units
        self.units = nn.Linear(input_dim, output_dim * num_units, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.units(x).reshape(*x.shape[:-1], self.num_units, self.output_dim)
        return y.max(dim=-2).values


class GatedBiModalNetwork(nn.Module):
    def __init__(self, input_one_dim: int, input_two_dim: int, output_one_dim: int,
                 output_two_dim: int, use_bias: bool = False) -> None:
        super().__init__()
        self.fc_one = nn.Linear(input_one_dim, output_one_dim, bias=use_bias)
        self.fc_two = nn.Linear(input_two_dim, output_two_dim, bias=use_bias)
        self.hidden_sigmoid = nn.Linear(output_one_dim + output_two_dim, 1, bias=use_bias)

    def forward(self, modality_one: torch.Tensor, modality_two: torch.Tensor) -> torch.Tensor:
        out_one = torch.tanh(self.fc_one(modality_one))
        out_two = torch.tanh(self.fc_two(modality_two))
        gate = torch.sigmoid(self.hidden_sigmoid(torch.cat([out_one, out_two], dim=1)))
        return gate * out_one + (1.0 - gate) * out_two


class MultimodalPooling(nn.Module):
    def __init__(self, input_dim_a: int, input_dim_b: int, output_dim: int,
                 pooling_type: str = "gated", hidden_dim: int = 0, dropout: float = 0.0) -> None:
        super().__init__()
        self.kind = pooling_type.lower()
        if self.kind not in POOLING_KINDS:
            raise ValueError(f"Unknown pooling type: {pooling_type}")
        hidden = hidden_dim or max(input_dim_a, input_dim_b)
        self.proj_a = nn.Linear(input_dim_a, output_dim)
        self.proj_b = nn.Linear(input_dim_b, output_dim)
        self.dropout_a = GeneratorDropout(dropout)
        self.dropout_b = GeneratorDropout(dropout)
        if self.kind == "attention":
            self.att_hidden = nn.Linear(2 * output_dim, hidden)
            self.att_out = nn.Linear(hidden, 2)
        elif self.kind == "gated":
            self.gate_hidden = nn.Linear(2 * output_dim, hidden)
            self.gate_out = nn.Linear(hidden, 1)

    def forward(self, x_a: torch.Tensor, x_b: torch.Tensor) -> torch.Tensor:
        a = self.dropout_a(torch.tanh(self.proj_a(x_a)))
        b = self.dropout_b(torch.tanh(self.proj_b(x_b)))
        if self.kind == "max":
            return torch.maximum(a, b)
        if self.kind in ("avg", "average"):
            return (a + b) / 2.0
        if self.kind == "sum":
            return a + b
        combined = torch.cat([a, b], dim=1)
        if self.kind == "attention":
            s = torch.tanh(self.att_hidden(combined))
            scores = torch.softmax(self.att_out(s), dim=1)
            return scores[:, 0:1] * a + scores[:, 1:2] * b
        gate = torch.sigmoid(self.gate_out(torch.tanh(self.gate_hidden(combined))))
        return gate * a + (1.0 - gate) * b
