"""The port's optimizers beyond Adam, AdamW and SGD against mmtpu's optax
chains (`mmtpu/train/optim.py::_group_tx`), on the CPU: rmsprop (with and
without momentum), adagrad, adadelta, adamax, asgd and sparse_adam, each
without and with coupled weight decay, on a small MLP with two parameter
groups and a global lr_scale of 0.5. The same gradients, made from a numpy
seed (a tenth of their elements scaled into eps's range), go through five
updates of each; after every update the parameters must agree within 1e-6
of their magnitude. Every config also carries kwargs that mmtpu's chain
does not read (torch's own names among them), which both must ignore.
`lbfgs` builds in both packages and fails at its first update in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mmtpu.config.optim import OptimizerConfig as JaxOptimizerConfig
from mmtpu.models.registry import build_module as jax_build_module
from mmtpu.train.optim import build_optimizer as jax_build_optimizer
from mmtpu.train.optim import set_lr_scale as jax_set_lr_scale
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.config.optim import OptimizerConfig
from mmtpu_torch.models import build_module
from mmtpu_torch.train.optim import OptaxTransform, build_optimizer, set_lr_scale
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

RTOL = 1e-6
LR_SCALE = 0.5
STEPS = 5
FC = dict(input_dim=12, layers=[16, 8], output_dim=4, dropout=0.0, use_bn=True)

# per optimizer: the kwargs its chain reads, and kwargs mmtpu's chain ignores
OPTIMIZERS = {
    "rmsprop": ({"lr": 1e-2, "alpha": 0.9, "eps": 1e-6}, {"centered": True, "foreach": True}),
    "rmsprop_momentum": ({"lr": 1e-2, "alpha": 0.95, "eps": 1e-8, "momentum": 0.8},
                         {"centered": True}),
    "adagrad": ({"lr": 5e-2}, {"eps": 0.5, "lr_decay": 0.1, "initial_accumulator_value": 2.0}),
    "adadelta": ({"rho": 0.8, "eps": 1e-5}, {"foreach": False, "maximize": False}),
    "adamax": ({"lr": 2e-2, "betas": [0.8, 0.99]}, {"eps": 0.3}),
    "asgd": ({"lr": 3e-2}, {"lambd": 1e-2, "alpha": 0.5, "t0": 10.0}),
    "sparse_adam": ({"lr": 1e-2}, {"betas": [0.5, 0.6], "eps": 0.1}),
}
CASES = [(name, decay) for name in sorted(OPTIMIZERS) for decay in (False, True)]


def _config(name, decay):
    kwargs, ignored = OPTIMIZERS[name]
    default = {**kwargs, **ignored}
    if decay:
        default["weight_decay"] = 1e-2
    first = {"pattern": "^fc_0/", "lr": 3e-3}
    if decay:
        first["weight_decay"] = 5e-2
    return {"name": name.removesuffix("_momentum"), "default_kwargs": default,
            "parameter_groups": [first]}


def _setup(cfg):
    jm = jax_build_module("fcclassifier", **FC)
    params = jm.init(jax.random.PRNGKey(4), jnp.zeros((2, 12)), train=False)["params"]
    pm = build_module("fcclassifier", **FC)
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, params),
                                          target=pm, require_all=False), strict=False)
    tx, _ = jax_build_optimizer(JaxOptimizerConfig.from_dict(cfg), params)
    optimizer, _ = build_optimizer(OptimizerConfig.from_dict(cfg), pm)
    return params, tx, pm, optimizer


def _gradients(params, g):
    flat = flatten_dict(jax.tree_util.tree_map(np.asarray, params))
    for path, leaf in flat.items():
        grad = g.normal(size=leaf.shape) * 1e-1
        grad[g.uniform(size=leaf.shape) < 0.1] *= 1e-6
        flat[path] = grad.astype(np.float32)
    return unflatten_dict(flat)


@pytest.mark.parametrize("name,decay", CASES, ids=[f"{n}-{'decay' if d else 'plain'}"
                                                   for n, d in CASES])
def test_optimizer_updates_match_mmtpu(name, decay):
    cfg = _config(name, decay)
    params, tx, pm, optimizer = _setup(cfg)
    opt_state = jax_set_lr_scale(tx.init(params), LR_SCALE)
    set_lr_scale(optimizer, LR_SCALE)
    g = np.random.default_rng(len(name) + 10 * decay)
    for step in range(STEPS):
        grads = _gradients(params, g)
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
        carried = from_jax_variables(grads)
        for n, p in pm.named_parameters():
            p.grad = carried[n].clone()
        optimizer.step()
        want = from_jax_variables(jax.tree_util.tree_map(np.asarray, params))
        for n, p in pm.named_parameters():
            w = want[n].numpy()
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=RTOL,
                                       atol=RTOL * np.abs(w).max(),
                                       err_msg=f"{name} step {step + 1} {n}")


@pytest.mark.parametrize("name", ["rmsprop_momentum", "adagrad", "adadelta", "adamax",
                                  "sparse_adam"])
def test_ignored_kwargs_change_nothing(name):
    """The config kwargs mmtpu's chain does not read change nothing in the
    port either: the groups' options are those of the config without them."""
    kwargs, ignored = OPTIMIZERS[name]
    with_ignored = build_optimizer(OptimizerConfig.from_dict(_config(name, True)),
                                   build_module("fcclassifier", **FC))[0]
    plain = _config(name, True)
    plain["default_kwargs"] = {k: v for k, v in plain["default_kwargs"].items()
                               if k not in ignored or k in kwargs}
    without = build_optimizer(OptimizerConfig.from_dict(plain),
                              build_module("fcclassifier", **FC))[0]
    strip = [{k: v for k, v in g.items() if k != "params"} for g in with_ignored.param_groups]
    assert strip == [{k: v for k, v in g.items() if k != "params"}
                     for g in without.param_groups]
    assert type(with_ignored) is type(without)


def test_transforms_keep_state_beside_the_parameters():
    """Each transform's state tensors live on the parameter's device and
    dtype; the step count is a Python int (nothing left on the host when
    the parameters are on the card)."""
    model = build_module("fcclassifier", **FC)
    for kind in OptaxTransform.DEFAULTS:
        opt = OptaxTransform([{"params": list(model.parameters()), "lr": 1e-3,
                               "weight_decay": 0.0}], kind)
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        for st in opt.state.values():
            for v in st.values():
                assert not isinstance(v, torch.Tensor) or (v.device == p.device and
                                                           v.dtype == p.dtype), kind


def test_lbfgs_fails_at_its_first_step_in_both():
    cfg = {"name": "lbfgs", "default_kwargs": {"lr": 1e-2}}
    params, tx, pm, optimizer = _setup(cfg)
    grads = jax.tree_util.tree_map(jnp.asarray, _gradients(params, np.random.default_rng(0)))
    opt_state = tx.init(params)
    with pytest.raises(TypeError, match="value_fn"):
        tx.update(grads, opt_state, params)
    for p in pm.parameters():
        p.grad = torch.zeros_like(p)
    with pytest.raises(NotImplementedError, match="value function"):
        optimizer.step()


def test_unknown_optimizer_names_raise_in_both():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        build_optimizer(OptimizerConfig.from_dict({"name": "Lion"}),
                        build_module("fcclassifier", **FC))
    with pytest.raises(ValueError, match="Unknown optimizer"):
        _setup({"name": "Lion"})
