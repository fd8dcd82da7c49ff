"""The port's MNIST conv encoders (mmtpu_torch.models.conv, MNISTAudio and
MNISTImage) against mmtpu's on the CPU, from the same weights carried by
`from_jax_variables` and the same numpy inputs made from a seed:

- `ConvBlock`, `MNISTAudio` on (B, 32, 94), `MNISTImage` on (B, 28, 28) and
  on NHWC (B, 28, 28, 1): eval outputs; train outputs, new running
  statistics and input gradients, also with a zero-padded tail whose rows
  BatchNorm must leave out (1e-4);
- the fc layer's input width at the shipped configs' widths: 4800 (audio)
  and 3136 (image), as flax infers it;
- the whole AVMNIST with MNIST encoders, three train steps against mmtpu's
  `train_step_core` (1e-5: loss, gradients of their norm, parameters and
  running statistics), with the optimizer groups of
  `shipped_wheights_finetune_audiofix.yaml`. Both packages run these steps
  in float64 (the loss still casts the logits to float32 in both): in
  float32, flax's BatchNorm takes the variance as E[x²] − E[x]², and at
  these narrow widths mmtpu's float32 gradients land up to 9e-4 of their
  norm from its own float64 ones by step 2, while the port's stay within
  1.5e-6 of its float64 ones. A conv bias that feeds a BatchNorm has an
  exact gradient of 0, so its rule is the absolute 1e-12.

Narrow channel counts keep the CPU time small; the flatten geometry comes
from the port module (`flatten_chw`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mmtpu.cli import common as jax_common
from mmtpu.config.training import TrainingConfig as JaxTrainingConfig
from mmtpu.models import conv as jax_conv
from mmtpu.models import norm as jax_norm
from mmtpu.models.registry import build_module as jax_build_module
from mmtpu.train import losses as jax_losses
from mmtpu.train.step import ClassificationTask as JaxTask
from mmtpu.train.step import train_step_core as jax_train_step_core
from mmtpu_torch.checkpoints import from_jax_variables, mmtpu_param_path
from mmtpu_torch.cli import common
from mmtpu_torch.config.training import TrainingConfig
from mmtpu_torch.models import ConvBlock, build_module
from mmtpu_torch.models.norm import batch_mask
from mmtpu_torch.train import losses
from mmtpu_torch.train.step import ClassificationTask, make_train_step
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

TOL = 1e-4
STEP_TOL = 1e-5
CPU = torch.device("cpu")


def _args(c1, c2):
    return [{"conv_one_in": 1, "conv_one_out": c1}, {"conv_one_in": c1, "conv_one_out": c1},
            {"conv_one_in": c1, "conv_one_out": c2}, {"conv_one_in": c2, "conv_one_out": c2}]


def _encoder_kwargs(c1=4, c2=8, hidden=6, **extra):
    names = ("conv_block_one_one_args", "conv_block_one_two_args",
             "conv_block_two_one_args", "conv_block_two_two_args")
    return {**dict(zip(names, _args(c1, c2))), "hidden_dim": hidden, **extra}


def _perturb(variables, seed):
    """BN scale/bias, biases and running statistics drawn from a seed."""
    g = np.random.default_rng(seed)
    out = {}
    for col, tree in variables.items():
        flat = flatten_dict(jax.tree_util.tree_map(np.asarray, tree))
        for path, v in flat.items():
            if path[-1] == "scale":
                v = (1.0 + 0.1 * g.normal(size=v.shape)).astype(np.float32)
            elif path[-1] in ("bias", "mean"):
                v = (0.1 * g.normal(size=v.shape)).astype(np.float32)
            elif path[-1] == "var":
                v = g.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
            flat[path] = v
        out[col] = unflatten_dict(flat)
    return out


def _carry(variables, port_model):
    port_model.load_state_dict(from_jax_variables(
        variables["params"], variables.get("batch_stats"), target=port_model), strict=True)
    return port_model


def _stats(params, tree, target):
    """The port's names for mmtpu's running statistics (the names need the
    params beside them: an MNIST encoder is the subtree with `block_one`
    and `fc`)."""
    return from_jax_variables(params, jax.tree_util.tree_map(np.asarray, tree), target=target)


def _compare(jm, pm, x_jax, x_port, mode, seed, to_port=lambda a: a):
    """Eval output, or train output + running statistics + input gradient,
    mmtpu's module `jm` against the port's `pm`; `to_port` maps mmtpu's
    output layout to the port's."""
    g = np.random.default_rng(seed)
    B = x_jax.shape[0]
    mask = np.ones(B, np.float32)
    if mode == "train_padded":
        mask[B - 2:] = 0.0
        x_jax[B - 2:] = 0.0
        x_port[B - 2:] = 0.0
    v = _perturb(dict(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x_jax), train=False)), seed)
    _carry(v, pm)
    if mode == "eval":
        pm.eval()
        with torch.no_grad():
            got = pm(torch.from_numpy(x_port)).numpy()
        want = to_port(np.asarray(jm.apply(v, jnp.asarray(x_jax), train=False)))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        return
    want_shape = jax.eval_shape(lambda xx: jm.apply(v, xx, train=False), jnp.asarray(x_jax)).shape
    cot = g.normal(size=want_shape).astype(np.float32)

    def f(xx):
        y, upd = jm.apply(v, xx, train=True, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd)

    with jax_norm.batch_mask(jnp.asarray(mask) if mode == "train_padded" else None):
        (_, (want_y, upd)), want_gx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x_jax))
    pm.train()
    xt = torch.from_numpy(x_port).requires_grad_()
    with batch_mask(torch.from_numpy(mask) if mode == "train_padded" else None):
        y = pm(xt)
    (y * torch.from_numpy(to_port(cot))).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), to_port(np.asarray(want_y)), rtol=TOL,
                               atol=TOL)
    for k, w in _stats(v["params"], upd.get("batch_stats", {}), pm).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(pm.state_dict()[k].numpy(), w.numpy(), atol=TOL,
                                       err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), to_port(np.asarray(want_gx)), rtol=TOL,
                               atol=TOL)


MODES = ["eval", "train", "train_padded"]


@pytest.mark.parametrize("batch_norm", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_conv_block_matches_mmtpu(mode, batch_norm):
    args = _args(3, 5)[1:3]
    args[0] = {**args[0], "conv_one_kernel_size": 5, "conv_one_padding": 2}
    args[1] = {**args[1], "conv_one_stride": (2, 1)}
    jm = jax_conv.ConvBlock(args[0], args[1], batch_norm=batch_norm)
    pm = ConvBlock(args[0], args[1], batch_norm=batch_norm)
    x = np.random.default_rng(1).normal(size=(6, 9, 11, 3)).astype(np.float32)
    _compare(jm, pm, x.copy(), np.ascontiguousarray(x.transpose(0, 3, 1, 2)), mode, seed=3,
             to_port=lambda a: np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


ENCODERS = {
    "audio_bhw": ("mnist_audio", (5, 32, 94)),
    "image_bhw": ("mnist_image", (5, 28, 28)),
    "image_nhwc": ("mnist_image", (5, 28, 28, 1)),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(ENCODERS))
def test_mnist_encoder_matches_mmtpu(case, mode):
    name, shape = ENCODERS[case]
    kwargs = _encoder_kwargs()
    jm, pm = jax_build_module(name, **kwargs), build_module(name, **kwargs)
    x = (np.random.default_rng(len(case)).normal(size=shape) * 2 + 0.3).astype(np.float32)
    _compare(jm, pm, x.copy(), x.copy(), mode, seed=5)


@pytest.mark.parametrize("name,shape,width", [("mnist_audio", (2, 32, 94), 4800),
                                              ("mnist_image", (2, 28, 28, 1), 3136)])
def test_fc_input_width_is_mmtpus(name, shape, width):
    """At the shipped configs' widths (32/64 channels, hidden 64) the port's
    Linear takes the width flax infers from the data's geometry."""
    kwargs = _encoder_kwargs(32, 64, 64)
    pm = build_module(name, **kwargs)
    shapes = jax.eval_shape(lambda x: jax_build_module(name, **kwargs).init(
        jax.random.PRNGKey(0), x, train=False), jax.ShapeDtypeStruct(shape, jnp.float32))
    assert shapes["params"]["fc"]["kernel"].shape == (width, 64)
    assert pm.net[5].in_features == width and pm.net[5].out_features == 64
    assert int(np.prod(pm.flatten_chw)) == width
    assert [type(m).__name__ for m in pm.net] == ["ConvBlock", "MaxPool2d", "ConvBlock",
                                                  "MaxPool2d", "Flatten", "Linear"]


def test_reference_state_dict_keys():
    """The reference's Sequential layout: 30 tensors of an MNISTImage, from
    net.0.conv_one.weight to net.5.bias; mmtpu's paths invert onto them."""
    pm = build_module("mnist_image", **_encoder_kwargs(32, 64, 64))
    keys = list(pm.state_dict())
    assert len(keys) == 30 and keys[0] == "net.0.conv_one.weight" and keys[-1] == "net.5.bias"
    assert "net.2.batch_norm_two.running_var" in keys
    params = jax.eval_shape(lambda x: jax_build_module("mnist_image", **_encoder_kwargs(
        32, 64, 64)).init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, 28, 28, 1), jnp.float32))["params"]
    assert {mmtpu_param_path(n, p) for n, p in pm.named_parameters()} == \
        {"/".join(k) for k in flatten_dict(params)}


# -- three train steps of AVMNIST with MNIST encoders ------------------------------

# Adam at eps 1e-3: see tests/test_torch_port_train.py (XLA's and oneDNN's
# convolutions sum in different orders; eps bounds Adam's amplification of it)
TRAINING = {
    "epochs": 1, "num_modalities": 2,
    "optimizer": {"name": "Adam", "default_kwargs": {"lr": 5e-4, "weight_decay": 1e-4,
                                                     "eps": 1e-3}},
    "encoder_optimizer": {"name": "Adam", "default_kwargs": {"lr": 1e-4, "weight_decay": 1e-4,
                                                             "eps": 1e-3}},
    "modality_specific_params": {"audio_encoder": {"lr": 5e-4}},
    "loss_functions": {"cross_entropy": {"loss_name": "cross_entropy", "loss_args": {},
                                         "weight": 1.0}},
}


def _batch(seed, B=6, padded_from=None):
    g = np.random.default_rng(seed)
    labels = g.integers(0, 10, size=B).astype(np.int64)
    batch = {
        "audio": (g.normal(size=(B, 32, 94)) + 0.3 * labels[:, None, None]).astype(np.float32),
        "image": (g.normal(size=(B, 28, 28, 1)) + 0.3 * labels[:, None, None, None]
                  ).astype(np.float32),
        "audio_mask": np.ones(B, np.float32), "image_mask": np.ones(B, np.float32),
        "labels": labels, "pattern_id": np.zeros(B, np.int32),
        "sample_mask": np.ones(B, np.float32),
    }
    batch["audio_mask"][1] = 0.0
    batch["image_mask"][2] = 0.0
    if padded_from is not None:
        for k in ("audio", "image", "labels", "audio_mask", "image_mask", "sample_mask"):
            batch[k][padded_from:] = 0
    return batch


def _float64(batch):
    return {k: a.astype(np.float64) if a.dtype == np.float32 else a for k, a in batch.items()}


@pytest.fixture(scope="module")
def avmnist_steps():
    from mmtpu.config.spec import ModuleSpec as JaxSpec

    from mmtpu_torch.config.spec import specs_from_dicts

    spec = {"audio_encoder": {"__module_spec__": "mnist_audio", **_encoder_kwargs()},
            "image_encoder": {"__module_spec__": "mnist_image", **_encoder_kwargs(3, 8, 10)},
            "hidden_dim": 16, "dropout": 0.0}

    def jax_spec(obj):
        if isinstance(obj, dict) and "__module_spec__" in obj:
            return JaxSpec(obj["__module_spec__"],
                           {k: v for k, v in obj.items() if k != "__module_spec__"})
        return obj

    jm = jax_build_module("avmnist", **{k: jax_spec(v) for k, v in spec.items()})
    pm = build_module("avmnist", **specs_from_dicts(spec))
    batches = [_float64(b) for b in (_batch(1, padded_from=4), _batch(2),
                                     _batch(3, padded_from=5))]
    v = _perturb(dict(jm.init({"params": jax.random.PRNGKey(0)},
                              jnp.zeros((2, 32, 94)), jnp.zeros((2, 28, 28, 1)),
                              train=False)), 9)
    _carry(v, pm)
    pm.double()
    pstate = common.make_state(pm, TrainingConfig.from_dict(TRAINING))
    ptask = ClassificationTask(model=pm, loss_group=losses.LossFunctionGroup.from_dict(
        TRAINING["loss_functions"]), input_keys=["audio", "image"])
    pstep = make_train_step(ptask, pstate, CPU)
    jtask = JaxTask(model=jm, loss_group=jax_losses.LossFunctionGroup.from_dict(
        TRAINING["loss_functions"]), input_keys=["audio", "image"])
    record = []
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        jstate = jax_common.make_state(jm, v64["params"], v64["batch_stats"],
                                       JaxTrainingConfig.from_dict(TRAINING))
        step = jax.jit(lambda s, b: jax_train_step_core(jtask, s, b, jax.random.PRNGKey(1)))
        for b in batches:
            jstate, jloss, _, jgrads, _ = step(jstate, {k: jnp.asarray(a) for k, a in b.items()})
            ploss = float(pstep(b)["loss"])
            grads = {n: p.grad.clone() for n, p in pm.named_parameters()}
            record.append((float(jloss), jax.tree_util.tree_map(np.asarray, jgrads), ploss,
                           grads))
        jstate = jax.tree_util.tree_map(np.asarray, (jstate.params, jstate.batch_stats))
    return {"jstate": jstate, "pstate": pstate, "record": record}


@pytest.mark.parametrize("k", [0, 1, 2])
def test_avmnist_train_step_matches_mmtpu(avmnist_steps, k):
    jloss, jgrads, ploss, pgrads = avmnist_steps["record"][k]
    model = avmnist_steps["pstate"].model
    np.testing.assert_allclose(ploss, jloss, rtol=STEP_TOL, atol=STEP_TOL)
    want = from_jax_variables(jgrads, target=model, require_all=False)
    assert set(want) == set(pgrads)
    for name, g in pgrads.items():
        w = want[name].double().numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= STEP_TOL * np.linalg.norm(w) + 1e-12, (name, err)


def test_avmnist_state_after_three_steps_matches_mmtpu(avmnist_steps):
    (params, batch_stats), ps = avmnist_steps["jstate"], avmnist_steps["pstate"]
    want = from_jax_variables(params, batch_stats, target=ps.model)
    got = ps.model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 3, k
            continue
        np.testing.assert_allclose(got[k].numpy(), w.double().numpy(), rtol=0, atol=STEP_TOL,
                                   err_msg=k)
    lrs = {g["label"]: g["lr"] for g in ps.optimizer.param_groups}
    assert lrs == {"group_0": 5e-4, "group_1": 1e-4, "default": 5e-4}
