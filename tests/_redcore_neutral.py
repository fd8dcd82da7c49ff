"""Neutralised randomness for RedCore's train forward in both packages.

The attention dropout (0.2), the MLP dropout (0.1) and the VAE sample ε are
drawn from different generators in mmtpu and the port, so tests that hold
a RedCore train step (or run) of one against the other take them out of
both: mmtpu's transformer module runs against a stand-in `flax.linen`
whose attention and dropout rates are 0 and a `jax.random.normal` that
returns zeros (nothing in mmtpu changes); the port's dropouts pass their
input through and its ε source returns zeros.
"""

import types

import flax.linen as fnn
import jax.numpy as jnp
import torch

from mmtpu.models import transformer as jax_transformer
from mmtpu_torch.models import rng as port_rng


class _NoDropoutLinen(types.ModuleType):
    """flax.linen as mmtpu's transformer sees it, with its attention and
    MLP dropout rates at 0."""

    def __getattr__(self, name):
        return getattr(fnn, name)

    @staticmethod
    def MultiHeadDotProductAttention(**kw):  # noqa: N802 (flax's name)
        return fnn.MultiHeadDotProductAttention(**{**kw, "dropout_rate": 0.0})

    @staticmethod
    def Dropout(rate, **kw):  # noqa: N802
        return fnn.Dropout(0.0, **kw)


def neutralised(mp) -> None:
    """No dropout and ε = 0 in both packages' train forwards, for the life
    of the pytest MonkeyPatch `mp`."""
    zero_jax = types.SimpleNamespace(random=types.SimpleNamespace(
        normal=lambda key, shape: jnp.zeros(shape)))
    mp.setattr(jax_transformer, "nn", _NoDropoutLinen("flax.linen"))
    mp.setattr(jax_transformer, "jax", zero_jax)
    mp.setattr(port_rng.GeneratorNormal, "forward", lambda self, like: torch.zeros_like(like))
    mp.setattr(port_rng.GeneratorDropout, "forward", lambda self, x: x)
