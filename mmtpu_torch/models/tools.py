"""Seeded weight initialisation (counterpart of mmtpu's flax initialisers).

`seeded_init` draws every weight from one explicit `torch.Generator`, on
the CPU, so the same seed gives the same weights on any device. The
distributions follow the flax modules' initialisers: convolutions
He-normal over fan-out unless the layer names its own `init_std` (a
`ConvBlock`'s LeCun-normal over fan-in, flax's `nn.Conv` default), Linear
weights LeCun-normal (untruncated) unless the layer names its own
`init_std` (LeNet's N(0, 0.01²)), biases
zero, BatchNorm scale 1 / shift 0 with running mean 0 and variance 1; an
LSTMEncoder's recurrent matrix orthogonal (every flax-style `RNNCell`:
each gate's recurrent kernel) and its attention vector LeCun-normal;
embedding tables normal with the layer's `init_std` (BERT's 0.02), else
flax's default 1/√dim. A module with weights read from a file at
construction (a pretrained BERT) gets them back last.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from mmtpu_torch.models.lstm import GATES, LSTMEncoder, RNNCell


@torch.no_grad()
def seeded_init(model: nn.Module, seed: int) -> nn.Module:
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            std = getattr(m, "init_std", None) or math.sqrt(2.0 / fan_out)
            w = torch.empty(m.weight.shape).normal_(0.0, std, generator=g)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            std = getattr(m, "init_std", None) or math.sqrt(1.0 / m.in_features)
            w = torch.empty(m.weight.shape).normal_(0.0, std, generator=g)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            std = getattr(m, "init_std", None) or math.sqrt(1.0 / m.embedding_dim)
            m.weight.copy_(torch.empty(m.weight.shape).normal_(0.0, std, generator=g))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
        elif isinstance(m, LSTMEncoder):  # its raw parameters; `wi` is a Linear
            if m.backend == "fused":
                nn.init.orthogonal_(m.wh, generator=g)
            if m.embd_method == "attention":
                m.attention_vector_weight.normal_(
                    0.0, math.sqrt(1.0 / m.hidden_size), generator=g
                )
    for m in model.modules():  # after the Linear rule above has drawn them
        if isinstance(m, RNNCell):
            for gate in GATES:
                nn.init.orthogonal_(m[f"h{gate}"].weight, generator=g)
    for m in model.modules():  # a module's file weights over the draws (BERT's)
        if hasattr(m, "restore_pretrained"):
            m.restore_pretrained()
    return model
