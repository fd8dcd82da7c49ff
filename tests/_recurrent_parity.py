"""One module of mmtpu against its port counterpart from the same variables.

`check(jax_module, port_module, args)` initialises mmtpu's flax module,
loads its variables into the port's through `from_jax_variables` (which
raises on an unmapped leaf or an unfilled tensor), and holds the two
against each other on the same numpy inputs:

- the forward, in eval mode and in train mode, every output leaf within
  1e-5;
- the gradient of Σ outputs · a fixed cotangent, every parameter's within
  1e-4 of that gradient's norm (a parameter the forward does not reach
  has a zero gradient on both sides); an attention's key bias, whose exact
  gradient is 0 (the softmax over the keys ignores a shift they share),
  holds only rounding on either side, within 1e-4 of the whole gradient's
  norm, as `test_torch_port_redcore.py` holds it;
- the `lstm` launches the port made in one forward: the group count of
  every call of the kernel's plain version, which on the CPU stands in
  for the kernel.

mmtpu's side runs op by op, its forward and gradient as one `jax.vjp`:
within a test process its primitives compile once per shape, so checks of
one family at one size share them.

The train forward's ε (the VAE sample) and dropouts are neutralised in
both packages, as `_redcore_neutral.py` does for RedCore: mmtpu's
`jax.random.normal` returns zeros inside the module under test and flax's
`Dropout` runs at rate 0; the port's `GeneratorNormal` returns zeros and
its dropouts pass their input through.
"""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.models import rng as port_rng
from mmtpu_torch.ops import lstm as lstm_ops

TOL = 1e-5
GRAD_TOL = 1e-4
RNG = jax.random.PRNGKey(0)


class _NoDropoutLinen(types.ModuleType):
    def __getattr__(self, name):
        return getattr(fnn, name)

    @staticmethod
    def Dropout(rate, **kw):  # noqa: N802 (flax's name)
        return fnn.Dropout(0.0, **kw)


def neutralise(mp, jax_module_file) -> None:
    """ε = 0 and no dropout in both packages, for the life of `mp`."""
    zero = types.SimpleNamespace(random=types.SimpleNamespace(
        normal=lambda key, shape: jnp.zeros(shape)))
    mp.setattr(jax_module_file, "jax", zero, raising=False)
    mp.setattr(jax_module_file, "nn", _NoDropoutLinen("flax.linen"))
    mp.setattr(port_rng.GeneratorNormal, "forward", lambda self, like: torch.zeros_like(like))
    mp.setattr(port_rng.GeneratorDropout, "forward", lambda self, x: x)


def leaves(out):
    """The array leaves of a nested output, dict keys in the order of their
    string form (mmtpu's and the port's Modality keys compare by name)."""
    if out is None:
        return []
    if isinstance(out, dict):
        return [x for k in sorted(out, key=str) for x in leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in leaves(o)]
    return [out]


class LaunchCounter:
    """Records the group count of every call of the kernel's plain version."""

    def __init__(self, mp):
        self.groups = []
        real = lstm_ops.lstm_stacked_reference

        def counting(xw, wh, *a, **kw):
            self.groups.append(len(xw) if not isinstance(xw, torch.Tensor) else xw.shape[0])
            return real(xw, wh, *a, **kw)

        mp.setattr(lstm_ops, "lstm_stacked_reference", counting)


def cotangent(shape, i, xp):
    """The cotangent of output `i`, cos(0.37·k + i) over its flat index k,
    computed alike by `jax.numpy` and by torch (`xp`)."""
    n = int(np.prod(shape))
    return xp.cos(xp.arange(n, dtype=xp.float32) * 0.37 + i).reshape(tuple(shape))


def _as_jax(a):
    return None if a is None else jnp.asarray(a)


def _as_torch(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def check(jax_module, port_module, args, kwargs=None, *, launches=None,
          train_modes=(False, True)):
    """Forwards and gradients of `port_module` against `jax_module` (see the
    module docstring); `args`/`kwargs` are numpy arrays or None; `launches`,
    when given, the group counts of the port's launches in its eval
    forward."""
    kwargs = kwargs or {}
    jargs = [_as_jax(a) for a in args]
    jkw = {k: _as_jax(v) for k, v in kwargs.items()}
    targs = [_as_torch(a) for a in args]
    tkw = {k: _as_torch(v) for k, v in kwargs.items()}
    variables = jax_module.init({"params": RNG, "sample": RNG, "dropout": RNG}, *jargs,
                                train=False, **jkw)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    params, stats = variables.get("params", {}), variables.get("batch_stats")
    port_module.load_state_dict(from_jax_variables(params, stats, target=port_module),
                                strict=True)
    mp = pytest.MonkeyPatch()
    counter = LaunchCounter(mp)
    try:
        for train in train_modes:
            rngs = {"sample": RNG, "dropout": RNG}

            def apply(p, train=train):
                v = {"params": p, **({"batch_stats": stats} if stats else {})}
                if train and stats:
                    out, _ = jax_module.apply(v, *jargs, train=True, rngs=rngs,
                                              mutable=["batch_stats"], **jkw)
                    return leaves(out)
                return leaves(jax_module.apply(v, *jargs, train=train, rngs=rngs, **jkw))

            want, vjp = jax.vjp(apply, params)
            jgrads = vjp([cotangent(o.shape, i, jnp).astype(o.dtype)
                          for i, o in enumerate(want)])[0]
            want = [np.asarray(x) for x in want]
            port_module.train(train)
            port_module.zero_grad()
            counter.groups.clear()
            got = leaves(port_module(*targs, **tkw))
            if not train and launches is not None:
                assert counter.groups == launches, counter.groups
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.detach().numpy(), w, rtol=TOL, atol=TOL)
            if any(g.requires_grad for g in got):  # a frozen module's have no graph
                sum((g * cotangent(g.shape, i, torch)).sum()
                    for i, g in enumerate(got)).backward()
            jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
            gstate = from_jax_variables(jgrads, None, target=port_module, require_all=False)
            whole = np.sqrt(sum(float((w.double() ** 2).sum()) for w in gstate.values()))
            for name, p in port_module.named_parameters():
                want_g = gstate[name].numpy()
                got_g = np.zeros_like(want_g) if p.grad is None else p.grad.numpy()
                if name.endswith("key.bias"):
                    assert max(np.abs(want_g).max(), np.abs(got_g).max()) <= GRAD_TOL * whole, \
                        (train, name, whole)
                    continue
                scale = max(float(np.linalg.norm(want_g)), 1e-6)
                assert float(np.abs(got_g - want_g).max()) <= GRAD_TOL * scale, (train, name)
    finally:
        mp.undo()
