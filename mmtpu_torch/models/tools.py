"""Seeded weight initialisation (counterpart of mmtpu's flax initialisers)
and the network helpers of `mmtpu/models/tools.py`.

`seeded_init` draws every weight from one explicit `torch.Generator`, on
the CPU, so the same seed gives the same weights on any device. The
distributions follow the flax modules' initialisers: convolutions
He-normal over fan-out unless the layer names its own `init_std` (a
`ConvBlock`'s LeCun-normal over fan-in, flax's `nn.Conv` default; a 1-D
convolution always LeCun-normal over fan-in, biases zero), Linear
weights LeCun-normal (untruncated) unless the layer names its own
`init_std` (LeNet's N(0, 0.01²)), biases
zero, BatchNorm scale 1 / shift 0 with running mean 0 and variance 1; an
LSTMEncoder's recurrent matrix orthogonal (every flax-style `RNNCell`:
each gate's recurrent kernel) and its attention vector LeCun-normal;
embedding tables normal with the layer's `init_std` (BERT's 0.02), else
flax's default 1/√dim; a module with raw parameters of its own (GCNet's
`DenseRGCNConv`) draws them in its `seeded_reset(generator)`. A module with
weights read from a file at construction (a pretrained BERT) gets them back
last.

mmtpu's CycleGAN-style helpers (the reference's `networks/tools.py`),
on torch modules as the reference has them:

- `get_norm_layer(kind)` → a factory of `num_features`: "batch" (the port's
  `BatchNorm`, mmtpu's momentum 0.9 and eps 1e-5), "instance" (non-affine,
  no running statistics, over the spatial axes, eps 1e-6), "layer" (over
  the channel axis, eps 1e-6), "none" (`Identity`); another name raises
  `NotImplementedError`, as mmtpu's does;
- `init_weights(model, kind, gain, generator=…)` redraws, in place, every
  Conv/Linear weight (normal | xavier | kaiming | orthogonal; biases zero)
  and BatchNorm scale (N(1, gain), bias zero) from one `torch.Generator`,
  and leaves alone what mmtpu leaves alone: recurrences, attention vectors,
  embeddings and BERT, by mmtpu's path names and by module type; `init_net`
  places the model first;
- `diagnose_network` is the mean over the gradients of their mean |g|;
- `extract_mid_features` returns the named submodules' outputs of one
  forward (forward hooks), by mmtpu's path rule: "C.fc[0]" is `C`'s child
  `fc_0` (flax's name), else its Sequential slot `fc.0`.
"""

from __future__ import annotations

import functools
import math
import re
from typing import Any, Iterable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from mmtpu_torch.models.lstm import GATES, LSTMEncoder, RNNCell
from mmtpu_torch.models.norm import BatchNorm


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
        elif isinstance(m, nn.Conv1d):
            std = math.sqrt(1.0 / (m.in_channels * m.kernel_size[0]))
            m.weight.copy_(torch.empty(m.weight.shape).normal_(0.0, std, generator=g))
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
        elif hasattr(m, "seeded_reset"):
            m.seeded_reset(g)
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


class Identity(nn.Module):
    def forward(self, x, *args, **kwargs):
        return x


class InstanceNorm(nn.Module):
    """flax's `InstanceNorm(use_bias=False, use_scale=False)` on (B, C, ...):
    each sample and channel normalised over its spatial axes."""

    def __init__(self, num_features: Optional[int] = None, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(x.shape[0], x.shape[1], -1)
        mean = flat.mean(-1, keepdim=True)
        var = flat.var(-1, unbiased=False, keepdim=True)
        return ((flat - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)


class ChannelLayerNorm(nn.LayerNorm):
    """flax's `LayerNorm` on (B, C, ...): over the channel axis, affine."""

    def __init__(self, num_features: int, eps: float = 1e-6) -> None:
        super().__init__(num_features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


def get_norm_layer(norm_type: str = "instance"):
    """A normalisation-layer factory of `num_features` (mmtpu's
    `get_norm_layer`)."""
    if norm_type == "batch":
        return functools.partial(BatchNorm, momentum=0.1, eps=1e-5)
    if norm_type == "instance":
        return functools.partial(InstanceNorm, eps=1e-6)
    if norm_type == "layer":
        return functools.partial(ChannelLayerNorm, eps=1e-6)
    if norm_type == "none":
        return lambda *a, **kw: Identity()
    raise NotImplementedError("normalization layer [%s] is not found" % norm_type)


# mmtpu's path names of the parameters its init_weights leaves untouched
# (torch's classname filter never reaches recurrences, attention vectors,
# embeddings or BERT; the port's modules carry mmtpu's names), and the
# recurrent cells, whose gates are Linear layers
RECURRENT_NAMES = frozenset({"wi", "wh", "cell", "rnn", "attention_vector_weight",
                             "embedding", "bert", "OptimizedLSTMCell_0", "GRUCell_0"})
RECURRENT_SUFFIXES = ("_fwd", "_bwd")
_UNTOUCHED_TYPES = (RNNCell, nn.RNNBase)


def _recurrent_path(names: Sequence[str]) -> bool:
    return any(n in RECURRENT_NAMES or n.startswith("rnn") or n.endswith(RECURRENT_SUFFIXES)
               for n in names)


def _fans(shape: Sequence[int]) -> tuple:
    """(fan_in, fan_out) of a torch (out, in, *window) weight."""
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return int(shape[1]) * receptive, int(shape[0]) * receptive


def _kernel(w: torch.Tensor, init_type: str, gain: float, g: torch.Generator) -> torch.Tensor:
    if init_type == "orthogonal":
        out = torch.empty(w.shape, dtype=torch.float64)
        nn.init.orthogonal_(out.reshape(w.shape[0], -1), gain=gain, generator=g)
        return out
    fan_in, fan_out = _fans(w.shape)
    std = {"normal": gain, "xavier": gain * math.sqrt(2.0 / (fan_in + fan_out)),
           "kaiming": math.sqrt(2.0 / fan_in)}.get(init_type)
    if std is None:
        raise NotImplementedError("initialization method [%s] is not implemented" % init_type)
    return torch.empty(w.shape, dtype=torch.float64).normal_(0.0, std, generator=g)


@torch.no_grad()
def init_weights(model: nn.Module, init_type: str = "normal", init_gain: float = 0.02,
                 seed: int = 0, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Redraw, in place, `model`'s Conv/Linear weights (`init_type`, biases
    zero) and its BatchNorm scales (N(1, init_gain), shifts zero) from
    `generator` (one seeded with `seed` by default), in module order; a
    module under a recurrent, attention, embedding or BERT path is left as
    it is (mmtpu's `init_weights`)."""
    g = generator or torch.Generator().manual_seed(int(seed))
    skipped = set()
    for name, m in model.named_modules():
        names = name.split(".") if name else []
        if isinstance(m, _UNTOUCHED_TYPES) or _recurrent_path(names) or any(
                s == "" or name.startswith(s + ".") for s in skipped):
            skipped.add(name)
            continue
        kind = type(m).__name__
        if isinstance(m, nn.modules.batchnorm._BatchNorm) and m.affine:
            m.weight.copy_(torch.empty(m.weight.shape, dtype=torch.float64).normal_(
                1.0, init_gain, generator=g))
            m.bias.zero_()
        elif ("Conv" in kind or "Linear" in kind) and getattr(m, "weight", None) is not None:
            m.weight.copy_(_kernel(m.weight, init_type, init_gain, g))
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
    return model


def init_net(model: nn.Module, init_type: str = "normal", init_gain: float = 0.02,
             device: Union[str, torch.device, None] = None, seed: int = 0,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    """The reference's `init_net`: the model on `device`, then
    `init_weights`."""
    if device is not None:
        model.to(device)
    return init_weights(model, init_type, init_gain, seed, generator)


def diagnose_network(grads: Union[nn.Module, Mapping[str, Any], Iterable[torch.Tensor]],
                     name: str = "network") -> float:
    """The mean over the gradients of their mean |g| (mmtpu's
    `diagnose_network`): a module's parameters' gradients, or a (nested)
    mapping or list of gradient tensors."""
    if isinstance(grads, nn.Module):
        leaves = [p.grad for p in grads.parameters() if p.grad is not None]
    else:
        leaves = list(_leaves(grads))
    if not leaves:
        return 0.0
    return float(np.mean([float(torch.as_tensor(g).abs().double().mean()) for g in leaves]))


def _leaves(tree) -> Iterable[Any]:
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _layer(model: nn.Module, name: str) -> nn.Module:
    """`name` by mmtpu's path rule: "fc[0]" is the child `fc_0`, else `fc`'s
    slot 0."""
    node = model
    for part in name.strip().split("."):
        m = re.match(r"^(.*?)\[(\d+)\]$", part)
        steps = [part] if m is None else [f"{m.group(1)}_{m.group(2)}", (m.group(1), m.group(2))]
        for step in steps:
            child = (node._modules.get(step) if isinstance(step, str) else
                     getattr(node._modules.get(step[0]), "_modules", {}).get(step[1]))
            if child is not None:
                node = child
                break
        else:
            raise KeyError(f"layer {name!r}: {part!r} not found; available: "
                           f"{sorted(node._modules)}")
    return node


def extract_mid_features(model: nn.Module, inputs: Sequence[Any], layers: str,
                         **forward_kwargs) -> List[Any]:
    """One forward of `model(*inputs, **forward_kwargs)` and the outputs of
    the comma-separated `layers` (mmtpu's `extract_mid_features`)."""
    outputs, hooks = {}, []
    names = [n.strip() for n in layers.strip().split(",")]
    try:
        for n in names:
            hooks.append(_layer(model, n).register_forward_hook(
                lambda mod, args, out, n=n: outputs.setdefault(n, out)))
        model(*inputs, **forward_kwargs)
    finally:
        for h in hooks:
            h.remove()
    return [outputs[n] for n in names]
