"""Randomness drawn from the run's `torch.Generator` (counterpart of flax's
`dropout` and `sample` PRNG collections).

`GeneratorDropout` and `GeneratorNormal` draw from `self.generator`, set on
every such module of a model by `use_generator` (a training entry point
gives it the run's generator, whose state the checkpoints carry), never
from torch's global generator; a module that would draw without one
raises. Dropout follows flax's rule: keep with probability 1 − p, scale
kept values by 1 / (1 − p); `broadcast_dims` shares one mask over those
axes, as flax's attention dropout shares its (q, k) mask over the batch
and the heads (`broadcast_dropout=True`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


class _Draws(nn.Module):
    """A module that draws from `self.generator` in training."""

    def __init__(self) -> None:
        super().__init__()
        self.generator: Optional[torch.Generator] = None

    def _generator(self) -> torch.Generator:
        if self.generator is None:
            raise RuntimeError(f"{type(self).__name__} draws from a torch.Generator: give "
                               "the model one with use_generator(model, generator)")
        return self.generator


class GeneratorDropout(_Draws):
    """Dropout whose masks come from `self.generator` (on the input's
    device). Identity in eval mode and at p = 0."""

    def __init__(self, p: float, broadcast_dims: Sequence[int] = ()) -> None:
        super().__init__()
        self.p = float(p)
        self.broadcast_dims = tuple(broadcast_dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        shape = [1 if d in self.broadcast_dims else n for d, n in enumerate(x.shape)]
        keep = torch.rand(shape, generator=self._generator(), device=x.device,
                          dtype=x.dtype) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class GeneratorNormal(_Draws):
    """Standard normal noise shaped like its input from `self.generator` in
    training; zeros in eval mode (the VAE sample's ε)."""

    def forward(self, like: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return torch.zeros_like(like)
        return torch.randn(like.shape, generator=self._generator(), device=like.device,
                           dtype=like.dtype)


def draws(model: nn.Module) -> bool:
    """`model` has a module that draws from a generator."""
    return any(isinstance(m, _Draws) for m in model.modules())


def use_generator(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Point every generator-drawing module of `model` at `generator`."""
    for m in model.modules():
        if isinstance(m, _Draws):
            m.generator = generator
    return model
