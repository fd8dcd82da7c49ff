"""The port's training path (mmtpu_torch.models.norm, train.{losses, optim,
step, early_stopping, recorder}, metrics, the loader's train order) against
mmtpu on the CPU, from the same weights (carried by `from_jax_variables`)
and the same numpy inputs made from a seed.

Tolerances: BatchNorm 1e-5; train steps: loss 1e-5, each gradient within
1e-5 of its tensor's norm, parameters / Adam moments / BatchNorm running
statistics 1e-5 absolute after the steps; schedules, stop decisions and
metric values exactly (metrics to 1e-12)."""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import flatten_dict, unflatten_dict

from mmtpu.cli import common as jax_common
from mmtpu.config.training import TrainingConfig as JaxTrainingConfig
from mmtpu.models import avmnist as jax_avmnist
from mmtpu.models import norm as jax_norm
from mmtpu.models import resnet as jax_resnet
from mmtpu.models.registry import build_module as jax_build_module
from mmtpu.train import losses as jax_losses
from mmtpu.train.early_stopping import EarlyStopping as JaxEarlyStopping
from mmtpu.train.optim import LRController as JaxLRController
from mmtpu.train.optim import _label_tree, build_optimizer as jax_build_optimizer
from mmtpu.train.state import TrainState as JaxTrainState
from mmtpu.train.step import ClassificationTask as JaxTask
from mmtpu.train.step import train_step_core as jax_train_step_core
from mmtpu_torch.checkpoints import from_jax_variables, mmtpu_param_path
from mmtpu_torch.cli import common
from mmtpu_torch.config.training import TrainingConfig
from mmtpu_torch.models import AVMNIST, ResNetEncoder, build_module
from mmtpu_torch.models.norm import BatchNorm, batch_mask
from mmtpu_torch.train import losses
from mmtpu_torch.train.early_stopping import EarlyStopping
from mmtpu_torch.train.optim import LRController, build_optimizer, param_labels
from mmtpu_torch.train.state import TrainState
from mmtpu_torch.train.step import ClassificationTask, make_train_step

TOL = 1e-5
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent


def _perturb(variables, seed):
    """BN scale/bias, biases and running stats drawn from a seed."""
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


def _carried(variables, port_model):
    port_model.load_state_dict(from_jax_variables(
        variables["params"], variables.get("batch_stats"), target=port_model), strict=True)
    return port_model


def _state_of(params, batch_stats, target):
    return from_jax_variables(jax.tree_util.tree_map(np.asarray, params),
                              jax.tree_util.tree_map(np.asarray, batch_stats or {}),
                              target=target)


# -- pad-aware BatchNorm --------------------------------------------------------


class _FlaxBN(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool):
        return jax_norm.batch_norm(x, train=train, name="bn")


@pytest.mark.parametrize("rank", [2, 4])
@pytest.mark.parametrize("padded", [True, False])
def test_batchnorm_matches_mmtpu(rank, padded):
    """Train-mode outputs, new running mean/var and input gradients; a
    padded tail is left out of the statistics (the port publishes no mask
    for a full batch and takes F.batch_norm)."""
    g = np.random.default_rng(rank * 10 + padded)
    B, C = 10, 6
    x = g.normal(size=(B, C) if rank == 2 else (B, 5, 4, C)).astype(np.float32) * 2 + 0.5
    mask = np.ones(B, np.float32)
    if padded:
        mask[7:] = 0.0
        x[7:] = 0.0
    cot = g.normal(size=x.shape).astype(np.float32)
    jm = _FlaxBN()
    v = _perturb(dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)), 3)

    def f(xx):
        y, upd = jm.apply(v, xx, train=True, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd)

    with jax_norm.batch_mask(jnp.asarray(mask)):
        (_, (want_y, upd)), want_gx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    stats = upd["batch_stats"]["bn"]

    bn = BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["bn"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bn"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["bn"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["bn"]["var"]))
    bn.train()
    perm = (0, 3, 1, 2) if rank == 4 else (0, 1)
    xt = torch.from_numpy(x).permute(*perm).contiguous().requires_grad_()
    with batch_mask(torch.from_numpy(mask) if padded else None):
        y = bn(xt)
    (y * torch.from_numpy(cot).permute(*perm)).sum().backward()
    back = (0, 2, 3, 1) if rank == 4 else (0, 1)
    np.testing.assert_allclose(y.detach().permute(*back).numpy(), np.asarray(want_y),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=TOL)
    np.testing.assert_allclose(xt.grad.permute(*back).numpy(), np.asarray(want_gx),
                               rtol=TOL, atol=TOL)
    assert int(bn.num_batches_tracked) == 1


def test_batchnorm_eval_is_running_statistics_and_state_keys_unchanged():
    bn = BatchNorm(3)
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([0.5, -1.0, 2.0]))
        bn.running_var.copy_(torch.tensor([2.0, 0.5, 1.5]))
    bn.eval()
    x = torch.randn(4, 3, 2, 2)
    ref = torch.nn.BatchNorm2d(3).eval()
    ref.load_state_dict(bn.state_dict())
    with batch_mask(torch.tensor([1.0, 1.0, 0.0, 0.0])):  # ignored at eval
        torch.testing.assert_close(bn(x), ref(x), rtol=0, atol=0)
    assert set(bn.state_dict()) == set(ref.state_dict())


def test_batch_mask_is_per_thread_and_unwinds():
    import threading

    from mmtpu_torch.models.norm import current_mask

    seen = []
    m = torch.ones(2)
    with batch_mask(m):
        t = threading.Thread(target=lambda: seen.append(current_mask()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and current_mask() is m
    assert seen == [None] and current_mask() is None


# -- one and three train steps of a tiny AVMNIST --------------------------------

# Adam divides each gradient element by its own magnitude: an element whose
# gradient is near 0 (or near -weight_decay·p, with the coupled L2) moves by up
# to ±lr on a rounding difference. XLA's and oneDNN's convolutions sum in
# different orders (up to 1e-5 apart on this model's gradients), so with
# eps 1e-8 a few elements step in opposite directions after one step (up to
# 1.2·lr apart). eps 1e-3 bounds that effect at lr·1e-5/1e-3; the update
# rule is the same code path, and `test_adam_update_from_the_same_gradients`
# holds it at the default eps.
TRAINING = {
    "epochs": 1, "num_modalities": 2,
    "optimizer": {"name": "Adam", "default_kwargs": {"lr": 5e-4, "weight_decay": 1e-4,
                                                     "eps": 1e-3}},
    "encoder_optimizer": {"name": "Adam", "default_kwargs": {"lr": 1e-4, "weight_decay": 1e-4,
                                                             "eps": 1e-3}},
    "modality_specific_params": {"audio_encoder": {"lr": 2e-4, "weight_decay": 2e-4},
                                 "image_encoder": {"lr": 1e-4, "weight_decay": 3e-4}},
    "loss_functions": {"cross_entropy": {"loss_name": "cross_entropy", "loss_args": {},
                                         "weight": 1.0}},
}


def _batch(seed, B=8, padded_from=None):
    """An AVMNIST-shaped batch with some modalities missing and, from row
    `padded_from` on, a zero-padded tail."""
    g = np.random.default_rng(seed)
    labels = g.integers(0, 10, size=B).astype(np.int64)
    batch = {
        "audio": (g.normal(size=(B, 32, 94)) + 0.3 * labels[:, None, None]).astype(np.float32),
        "image": (g.normal(size=(B, 28, 28, 1)) + 0.3 * labels[:, None, None, None]
                  ).astype(np.float32),
        "audio_mask": np.ones(B, np.float32), "image_mask": np.ones(B, np.float32),
        "labels": labels, "pattern_id": g.integers(0, 3, size=B).astype(np.int32),
        "sample_mask": np.ones(B, np.float32),
    }
    batch["audio_mask"][1::4] = 0.0
    batch["image_mask"][2::4] = 0.0
    if padded_from is not None:
        for k in ("audio", "image", "labels", "audio_mask", "image_mask", "sample_mask"):
            batch[k][padded_from:] = 0
    return batch


@pytest.fixture(scope="module")
def avmnist_run():
    """mmtpu and the port from the same weights through the same three
    batches (the first and last with a padded tail); the JAX side is one
    compiled step (train_step_core, which also returns the gradients)."""
    jm = jax_avmnist.AVMNIST(
        audio_encoder=jax_resnet.ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=16),
        image_encoder=jax_resnet.ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=24),
        hidden_dim=32, dropout=0.0)
    batches = [_batch(1, padded_from=6), _batch(2), _batch(3, padded_from=5)]
    v = _perturb(dict(jm.init({"params": jax.random.PRNGKey(0)},
                              jnp.asarray(batches[0]["audio"][:2]),
                              jnp.asarray(batches[0]["image"][:2]), train=False)), 7)
    jstate = jax_common.make_state(jm, v["params"], v["batch_stats"],
                                   JaxTrainingConfig.from_dict(TRAINING))
    jtask = JaxTask(model=jm, loss_group=jax_losses.LossFunctionGroup.from_dict(
        TRAINING["loss_functions"]), input_keys=["audio", "image"])
    step = jax.jit(lambda s, b: jax_train_step_core(jtask, s, b, jax.random.PRNGKey(1)))

    pm = _carried(v, AVMNIST(ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=16),
                             ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=24),
                             hidden_dim=32, dropout=0.0))
    pstate = common.make_state(pm, TrainingConfig.from_dict(TRAINING))
    ptask = ClassificationTask(model=pm, loss_group=losses.LossFunctionGroup.from_dict(
        TRAINING["loss_functions"]), input_keys=["audio", "image"])
    pstep = make_train_step(ptask, pstate, CPU)

    record = []
    for b in batches:
        jstate, jloss, _, jgrads, _ = step(jstate, {k: jnp.asarray(a) for k, a in b.items()})
        out = pstep(b)
        grads = {n: p.grad.clone() for n, p in pm.named_parameters()}
        record.append((float(jloss), jgrads, float(out["loss"]), grads, out))
    return {"jstate": jstate, "pstate": pstate, "record": record, "params0": v["params"]}


def _assert_grads(jgrads, pgrads, model):
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, jgrads), target=None)
    assert set(want) == set(pgrads)
    for name, g in pgrads.items():
        w = want[name].numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= TOL * max(np.linalg.norm(w), 1e-12) + 1e-12, (name, err, np.linalg.norm(w))


def test_first_train_step_matches_mmtpu(avmnist_run):
    jloss, jgrads, ploss, pgrads, out = avmnist_run["record"][0]
    np.testing.assert_allclose(ploss, jloss, rtol=TOL, atol=TOL)
    _assert_grads(jgrads, pgrads, avmnist_run["pstate"].model)
    assert set(out) == {"loss", "preds", "labels", "pattern_id", "sample_mask"}
    assert out["preds"].shape == (8,)


@pytest.mark.parametrize("k", [1, 2])
def test_later_train_steps_match_mmtpu(avmnist_run, k):
    jloss, jgrads, ploss, pgrads, _ = avmnist_run["record"][k]
    np.testing.assert_allclose(ploss, jloss, rtol=TOL, atol=TOL)
    _assert_grads(jgrads, pgrads, avmnist_run["pstate"].model)


def test_state_after_three_steps_matches_mmtpu(avmnist_run):
    """Parameters and BatchNorm running statistics, and the step count."""
    js, ps = avmnist_run["jstate"], avmnist_run["pstate"]
    want = _state_of(js.params, js.batch_stats, ps.model)
    got = ps.model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 3, k
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=TOL, err_msg=k)
    assert ps.step == int(js.step) == 3


def _adam_moments(opt_state):
    """mmtpu's Adam mu/nu as one params-shaped tree each (every group's
    ScaleByAdamState holds its own parameters; the rest are masked)."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, __import__("optax").ScaleByAdamState))
        if type(s).__name__ == "ScaleByAdamState"]
    merged = {"mu": {}, "nu": {}}
    for s in found:
        for key in merged:
            for path, val in flatten_dict(getattr(s, key)).items():
                if hasattr(val, "shape"):
                    merged[key][path] = np.asarray(val)
    return {k: unflatten_dict(v) for k, v in merged.items()}, int(found[0].count)


def test_adam_moments_match_mmtpu(avmnist_run):
    js, ps = avmnist_run["jstate"], avmnist_run["pstate"]
    moments, count = _adam_moments(js.opt_state)
    names = {id(p): n for n, p in ps.model.named_parameters()}
    for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = from_jax_variables(moments[key])
        for p, st in ps.optimizer.state.items():
            name = names[id(p)]
            np.testing.assert_allclose(st[torch_key].numpy(), want[name].numpy(), rtol=0,
                                       atol=TOL, err_msg=f"{key} {name}")
            assert int(st["step"]) == count == 3


def test_adam_update_from_the_same_gradients():
    """At the default eps 1e-8, three Adam steps of the grouped optimizer
    (coupled L2, encoder groups) from the same gradients: parameters and
    moments as mmtpu's optax chain leaves them. A tenth of the gradient
    elements are scaled into eps's range, where the update is most
    sensitive."""
    training = {**TRAINING,
                "optimizer": {"name": "Adam", "default_kwargs": {"lr": 5e-4,
                                                                 "weight_decay": 1e-4}},
                "encoder_optimizer": {"name": "Adam",
                                      "default_kwargs": {"lr": 1e-4, "weight_decay": 1e-4}}}
    jm = jax_avmnist.AVMNIST(
        audio_encoder=jax_resnet.ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=8),
        image_encoder=jax_resnet.ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=8),
        hidden_dim=16, dropout=0.0)
    b = _batch(4, B=2)
    v = _perturb(dict(jm.init({"params": jax.random.PRNGKey(3)}, jnp.asarray(b["audio"]),
                              jnp.asarray(b["image"]), train=False)), 8)
    jstate = jax_common.make_state(jm, v["params"], v["batch_stats"],
                                   JaxTrainingConfig.from_dict(training))
    pm = _carried(v, AVMNIST(ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=8),
                             ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=8),
                             hidden_dim=16, dropout=0.0))
    pstate = common.make_state(pm, TrainingConfig.from_dict(training))
    g = np.random.default_rng(21)
    for _ in range(3):
        flat = flatten_dict(jax.tree_util.tree_map(np.asarray, v["params"]))
        for path, leaf in flat.items():
            grad = g.normal(size=leaf.shape) * 1e-2
            grad[g.uniform(size=leaf.shape) < 0.1] *= 1e-6
            flat[path] = grad.astype(np.float32)
        jgrads = unflatten_dict(flat)
        jstate = jstate.apply_gradients(grads=jax.tree_util.tree_map(jnp.asarray, jgrads))
        carried = from_jax_variables(jgrads)
        for n, p in pm.named_parameters():
            p.grad = carried[n].clone()
        pstate.optimizer.step()
    want = _state_of(jstate.params, {}, None)
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)
    moments, _ = _adam_moments(jstate.opt_state)
    names = {id(p): n for n, p in pm.named_parameters()}
    for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = from_jax_variables(moments[key])
        for p, st in pstate.optimizer.state.items():
            np.testing.assert_allclose(st[torch_key].numpy(), want[names[id(p)]].numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=f"{key} {names[id(p)]}")


def test_optimizer_groups_match_mmtpu_labels(avmnist_run):
    """Each parameter lands in the group mmtpu's `_label_tree` gives it,
    with that group's lr and weight decay; the default group last."""
    ps = avmnist_run["pstate"]
    training = TrainingConfig.from_dict(TRAINING)
    extra = common.encoder_param_groups(training, ps.model)
    assert [p for p, _ in extra] == ["^audio_encoder/", "^image_encoder/"]
    _, report = jax_build_optimizer(JaxTrainingConfig.from_dict(TRAINING).optimizer,
                                    avmnist_run["params0"], extra_groups=extra)
    jlabels = {"/".join(k): v for k, v in flatten_dict(
        _label_tree(avmnist_run["params0"], [p for p, _ in extra])).items()}
    plabels = param_labels(ps.model, [p for p, _ in extra])
    by_label = {g["label"]: g for g in ps.optimizer.param_groups}
    kwargs = {k.split(":")[0]: v for k, v in report.items()}
    assert {mmtpu_param_path(n, p): plabels[n] for n, p in ps.model.named_parameters()} \
        == jlabels
    for n, p in ps.model.named_parameters():
        group = by_label[plabels[n]]
        assert any(q is p for q in group["params"])
        assert group["base_lr"] == pytest.approx(float(kwargs[plabels[n]]["lr"]))
        assert group["weight_decay"] == pytest.approx(float(kwargs[plabels[n]]["weight_decay"]))
    assert [g["label"] for g in ps.optimizer.param_groups] == ["group_0", "group_1", "default"]


def test_group_overlap_is_an_error():
    model = build_module("fcclassifier", input_dim=6, layers=[4], output_dim=3)
    with pytest.raises(ValueError, match="matched by groups"):
        param_labels(model, ["^fc_0/", "kernel$"])


# -- optimizers, clip and groups on a small MLP with BatchNorm ------------------

FC = dict(input_dim=12, layers=[16, 8], output_dim=4, dropout=0.0, use_bn=True)
OPTIMIZERS = {
    "adam_coupled_l2": ({"name": "Adam", "default_kwargs": {"lr": 1e-2, "weight_decay": 1e-2,
                                                            "betas": [0.8, 0.99]}}, None),
    "adamw_groups": ({"name": "AdamW", "default_kwargs": {"lr": 1e-2, "weight_decay": 5e-2},
                      "parameter_groups": [{"pattern": "^fc_0/", "lr": 3e-3},
                                           {"pattern": "^bn_", "weight_decay": 0.0}]}, None),
    "sgd_nesterov": ({"name": "SGD", "default_kwargs": {"lr": 5e-2, "momentum": 0.9,
                                                        "nesterov": True,
                                                        "weight_decay": 1e-3}}, None),
    "adam_clip": ({"name": "Adam", "default_kwargs": {"lr": 1e-2}}, 0.05),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_mmtpu(name):
    """Three steps (one batch with a padded tail) of an MLP with pad-aware
    BatchNorm: loss each step, then parameters and running statistics."""
    from mmtpu.config.optim import OptimizerConfig as JaxOptimizerConfig

    from mmtpu_torch.config.optim import OptimizerConfig

    opt, clip = OPTIMIZERS[name]
    g = np.random.default_rng(5)
    batches = []
    for i in range(3):
        b = {"x": g.normal(size=(9, 12)).astype(np.float32),
             "labels": g.integers(0, 4, 9).astype(np.int64),
             "sample_mask": np.ones(9, np.float32)}
        if i == 1:
            b["sample_mask"][6:] = 0
            b["x"][6:] = 0
            b["labels"][6:] = 0
        batches.append(b)
    jm = jax_build_module("fcclassifier", **FC)
    v = _perturb(dict(jm.init(jax.random.PRNGKey(2), jnp.asarray(batches[0]["x"]),
                              train=False)), 11)
    tx, _ = jax_build_optimizer(JaxOptimizerConfig.from_dict(opt), v["params"], clip=clip)
    jstate = JaxTrainState.create(apply_fn=jm.apply, params=v["params"],
                                  batch_stats=v["batch_stats"], tx=tx)
    loss_group = {"ce": {"loss_name": "cross_entropy", "weight": 1.0}}
    jtask = JaxTask(model=jm, loss_group=jax_losses.LossFunctionGroup.from_dict(loss_group),
                    input_keys=["x"])
    pm = _carried(v, build_module("fcclassifier", **FC))
    optimizer, _ = build_optimizer(OptimizerConfig.from_dict(opt), pm)
    pstate = TrainState(model=pm, optimizer=optimizer, clip=clip)
    ptask = ClassificationTask(model=pm, loss_group=losses.LossFunctionGroup.from_dict(
        loss_group), input_keys=["x"])
    pstep = make_train_step(ptask, pstate, CPU)
    for b in batches:
        jstate, jloss, *_ = jax_train_step_core(
            jtask, jstate, {k: jnp.asarray(a) for k, a in b.items()}, jax.random.PRNGKey(0))
        np.testing.assert_allclose(float(pstep(b)["loss"]), float(jloss), rtol=TOL, atol=TOL)
    want = _state_of(jstate.params, jstate.batch_stats, pm)
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(pm.state_dict()[k].numpy(), w.numpy(), rtol=0,
                                       atol=TOL, err_msg=k)


def test_unported_optimizer_raises():
    """Every optimizer mmtpu builds is ported; `lbfgs`, which cannot take a
    step in mmtpu (optax's line search needs the loss as a function),
    builds and raises at its first step (tests/test_torch_port_optim.py)."""
    from mmtpu_torch.config.optim import OptimizerConfig

    model = build_module("fcclassifier", input_dim=6, layers=[4], output_dim=3)
    optimizer, _ = build_optimizer(OptimizerConfig.from_dict({"name": "LBFGS"}), model)
    with pytest.raises(NotImplementedError, match="cannot take a step"):
        optimizer.step()


def test_param_path_inverts_the_carry():
    """mmtpu_param_path is the inverse of from_jax_variables' naming, for
    every parameter of the ported model families."""
    from mmtpu.models import lstm as jax_lstm

    cases = [
        (jax_avmnist.AVMNIST(audio_encoder=jax_resnet.ResNetEncoder(layers=(1, 1, 1, 1),
                                                                    hidden_dim=8),
                             image_encoder=jax_resnet.ResNetEncoder(
                                 block=jax_resnet.Bottleneck, layers=(1, 1, 1, 1),
                                 hidden_dim=8), hidden_dim=16),
         (np.zeros((2, 32, 94), np.float32), np.zeros((2, 28, 28, 1), np.float32)),
         build_module("avmnist", audio_encoder=ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=8),
                      image_encoder=build_module("resnetencoder",
                                                 block=__import__(
                                                     "mmtpu_torch.models.resnet",
                                                     fromlist=["x"]).Bottleneck,
                                                 layers=(1, 1, 1, 1), hidden_dim=8),
                      hidden_dim=16)),
        (jax_lstm.LSTMEncoder(input_size=5, hidden_size=8, embd_method="attention"),
         (np.zeros((2, 7, 5), np.float32),),
         build_module("lstmencoder", input_size=5, hidden_size=8, embd_method="attention")),
        (jax_lstm.LSTMEncoder(input_size=5, hidden_size=8, embd_method="attention",
                              backend="rnn"),
         (np.zeros((2, 7, 5), np.float32),),
         build_module("lstmencoder", input_size=5, hidden_size=8, embd_method="attention",
                      backend="rnn")),
        (jax_build_module("fcclassifier", **FC), (np.zeros((2, 12), np.float32),),
         build_module("fcclassifier", **FC)),
    ]
    for jm, inputs, pm in cases:
        params = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs), train=False)["params"]
        want = {"/".join(k) for k in flatten_dict(params)}
        assert {mmtpu_param_path(n, p) for n, p in pm.named_parameters()} == want


# -- schedulers and early stopping -----------------------------------------------

METRICS = [1.0, 0.9, 0.95, 0.96, 0.97, 0.89, 0.99, 1.2, 1.1, 1.05, 0.7, 0.8, 0.8, 0.8,
           0.8, 0.81, 0.82, 0.6, 0.61, 0.62]
SCHEDULERS = {
    "plateau_min": ("plateau", {"mode": "min", "factor": 0.5, "patience": 2,
                                "min_lr": 1e-4, "cooldown": 1}),
    "plateau_max": ("plateau", {"mode": "max", "factor": 0.3, "patience": 1,
                                "threshold": 0.01}),
    "step": ("step", {"step_size": 3, "gamma": 0.5}),
    "multistep": ("multistep", {"milestones": [2, 5, 9], "gamma": 0.2}),
    "exponential": ("exponential", {"gamma": 0.8}),
    "cosine": ("cosine", {"T_max": 7, "eta_min": 1e-5}),
    "cosine_warmup": ("cosine_warmup", {"T_0": 3, "T_mult": 2, "eta_min": 1e-5}),
    "lambda": ("lambda", {"lr_lambda": "lambda epoch: 1.0 - max(0, epoch - 4) / 11.0"}),
    "cyclic": ("cyclic", {"max_lr": 5e-3, "step_size_up": 4}),
    "none": (None, {}),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_controller_matches_mmtpu(name):
    kind, args = SCHEDULERS[name]
    ours, theirs = LRController(kind, args, 1e-3), JaxLRController(kind, args, 1e-3)
    got = [ours.step(m) for m in METRICS]
    want = [theirs.step(m) for m in METRICS]
    assert got == want
    assert ours._scale == theirs._scale


def test_lr_scale_is_one_global_multiplier():
    """The plateau scale multiplies every group's own base lr, floored at
    min_lr / base_lr of the DEFAULT group (mmtpu's rule)."""
    from mmtpu_torch.train.optim import set_lr_scale

    model = build_module("avmnist", audio_encoder=ResNetEncoder(layers=(1, 1, 1, 1),
                                                                hidden_dim=8),
                         image_encoder=ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=8),
                         hidden_dim=16)
    state = common.make_state(model, TrainingConfig.from_dict(TRAINING))
    lr = LRController("plateau", {"factor": 0.1, "patience": 0, "min_lr": 1e-5}, 5e-4)
    for metric in (1.0, 2.0, 3.0, 4.0):
        set_lr_scale(state.optimizer, lr.step(metric))
    assert lr._scale == pytest.approx(1e-5 / 5e-4)
    lrs = {g["label"]: g["lr"] for g in state.optimizer.param_groups}
    assert lrs == pytest.approx({"group_0": 2e-4 * 0.02, "group_1": 1e-4 * 0.02,
                                 "default": 5e-4 * 0.02})


@pytest.mark.parametrize("mode,delta,enabled", [("min", 0.001, True), ("max", 0.05, True),
                                                ("min", 0.0, False)])
def test_early_stopping_matches_mmtpu(mode, delta, enabled):
    ours = EarlyStopping(patience=3, min_delta=delta, mode=mode, enabled=enabled)
    theirs = JaxEarlyStopping(patience=3, min_delta=delta, mode=mode, enabled=enabled)
    seq = [(ours.step(m), ours.should_stop, ours.counter) for m in METRICS]
    assert seq == [(theirs.step(m), theirs.should_stop, theirs.counter) for m in METRICS]
    assert ours.best == theirs.best


# -- losses ---------------------------------------------------------------------

def _loss_inputs(name, g, B=7, C=5):
    logits = g.normal(size=(B, C)).astype(np.float32)
    if name in ("cross_entropy",):
        return logits, g.integers(0, C, B).astype(np.int64)
    if name == "nll":
        return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))), \
            g.integers(0, C, B).astype(np.int64)
    if name in ("bce",):
        return 1 / (1 + np.exp(-logits)), g.integers(0, 2, (B, C)).astype(np.float32)
    if name == "bce_with_logits":
        return logits, g.uniform(size=(B, C)).astype(np.float32)  # soft targets
    if name == "kl_div":
        t = np.exp(g.normal(size=(B, C)))
        t[0, 0] = 0.0
        return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))), \
            (t / t.sum(-1, keepdims=True)).astype(np.float32)
    return logits * 2, g.normal(size=(B, C)).astype(np.float32)  # regression losses


LOSSES = [
    ("cross_entropy", {}), ("cross_entropy", {"label_smoothing": 0.1}),
    ("cross_entropy", {"weight": [1.0, 2.0, 0.5, 1.5, 3.0]}), ("nll", {}), ("mse", {}),
    ("l1", {}), ("smooth_l1", {"beta": 0.5}), ("huber", {"delta": 0.7}), ("bce", {}),
    ("bce_with_logits", {}), ("bce_with_logits", {"pos_weight": [2.0, 1.0, 0.5, 1.0, 3.0]}),
    ("kl_div", {}), ("cycle", {}),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,kwargs", LOSSES, ids=[f"{n}{i}" for i, (n, _) in
                                                    enumerate(LOSSES)])
def test_loss_matches_mmtpu(name, kwargs, masked):
    g = np.random.default_rng(len(name))
    preds, targets = _loss_inputs(name, g)
    mask = np.array([1, 1, 0, 1, 1, 0, 0], np.float32) if masked else None
    spec = {"t": {"loss_name": name, "loss_args": kwargs, "weight": 0.7}}
    want = jax_losses.LossFunctionGroup.from_dict(spec)(
        jnp.asarray(preds), jnp.asarray(targets),
        sample_mask=None if mask is None else jnp.asarray(mask))["total_loss"]
    got = losses.LossFunctionGroup.from_dict(spec)(
        torch.from_numpy(preds), torch.from_numpy(targets),
        sample_mask=None if mask is None else torch.from_numpy(mask))["total_loss"]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


def test_loss_registry_names_match_mmtpu():
    from mmtpu_torch.train.cmam_loss import CMAMLoss

    assert set(losses._CRITERIA) == set(jax_losses._CRITERIA)
    # 'cmam' resolves outside the table in both packages, to the C-MAM loss
    assert losses.resolve_criterion("cmam") is CMAMLoss
    assert jax_losses.resolve_criterion("cmam").__name__ == "CMAMLoss"


# -- metric functions vs sklearn ------------------------------------------------

def _labels(seed, n=60, classes=6, empty=(4,)):
    g = np.random.default_rng(seed)
    pool = [c for c in range(classes) if c not in empty]
    y_true = g.choice(pool, n)
    y_pred = np.where(g.uniform(size=n) < 0.5, y_true, g.integers(0, classes, n))
    return y_true, y_pred


@pytest.mark.parametrize("fn", ["precision_score", "recall_score", "f1_score"])
@pytest.mark.parametrize("average", [None, "micro", "macro", "weighted"])
@pytest.mark.parametrize("zero_division", [0, 1, float("nan")])
def test_prf_metrics_match_sklearn(fn, average, zero_division):
    import sklearn.metrics as skm

    from mmtpu_torch.metrics import classification as ours

    for seed in range(3):
        y_true, y_pred = _labels(seed)
        y_pred[y_pred == 5] = 0  # class 5 never predicted: precision undefined
        kw = dict(average=average, zero_division=zero_division)
        np.testing.assert_allclose(getattr(ours, fn)(y_true, y_pred, **kw),
                                   getattr(skm, fn)(y_true, y_pred, **kw), rtol=1e-12,
                                   equal_nan=True)
        kw["labels"] = [0, 2, 4, 7]  # one empty, one never seen
        np.testing.assert_allclose(getattr(ours, fn)(y_true, y_pred, **kw),
                                   getattr(skm, fn)(y_true, y_pred, **kw), rtol=1e-12,
                                   equal_nan=True)


@pytest.mark.parametrize("case", ["binary", "one_label", "pos_label_2"])
def test_binary_average_matches_sklearn(case):
    import sklearn.metrics as skm

    from mmtpu_torch.metrics import classification as ours

    g = np.random.default_rng(9)
    y_true, y_pred = g.integers(0, 2, 40), g.integers(0, 2, 40)
    kw = {}
    if case == "one_label":
        y_true, y_pred = np.zeros(10, int), np.zeros(10, int)
    elif case == "pos_label_2":
        y_true, y_pred = y_true * 2, y_pred * 2
        kw["pos_label"] = 2
    for fn in ("precision_score", "recall_score", "f1_score"):
        assert getattr(ours, fn)(y_true, y_pred, zero_division=0, **kw) == pytest.approx(
            getattr(skm, fn)(y_true, y_pred, zero_division=0, **kw))
    with pytest.raises(ValueError, match="multiclass"):
        ours.f1_score(*_labels(0))


@pytest.mark.parametrize("seed", range(3))
def test_other_metrics_match_sklearn(seed):
    import sklearn.metrics as skm

    from mmtpu_torch.metrics import classification as ours

    y_true, y_pred = _labels(seed)
    assert ours.accuracy_score(y_true, y_pred) == skm.accuracy_score(y_true, y_pred)
    assert ours.accuracy_score(y_true, y_pred, normalize=False) == \
        skm.accuracy_score(y_true, y_pred, normalize=False)
    for labels in (None, list(range(10)), [3, 1, 0]):
        np.testing.assert_array_equal(ours.confusion_matrix(y_true, y_pred, labels=labels),
                                      skm.confusion_matrix(y_true, y_pred, labels=labels))
    for normalize in ("true", "pred", "all"):
        np.testing.assert_allclose(
            ours.confusion_matrix(y_true, y_pred, labels=list(range(7)), normalize=normalize),
            skm.confusion_matrix(y_true, y_pred, labels=list(range(7)), normalize=normalize))
    with pytest.warns(UserWarning):
        got = ours.balanced_accuracy_score(y_true, y_pred)
    with pytest.warns(UserWarning):
        want = skm.balanced_accuracy_score(y_true, y_pred)
    assert got == pytest.approx(want)
    y_pred = np.where(np.isin(y_pred, np.unique(y_true)), y_pred, y_true)
    for adjusted in (False, True):
        assert ours.balanced_accuracy_score(y_true, y_pred, adjusted=adjusted) == \
            pytest.approx(skm.balanced_accuracy_score(y_true, y_pred, adjusted=adjusted))


def test_sklearn_names_resolve_to_the_ports_metrics():
    from mmtpu_torch.config.metrics import import_dotted
    from mmtpu_torch.metrics import classification

    assert import_dotted("sklearn.metrics.f1_score") is classification.f1_score
    assert import_dotted("numpy.mean") is np.mean
    from mmtpu_torch.config.metrics import MetricDef
    from mmtpu_torch.metrics import msa

    assert MetricDef("metrics.msa_binary_classification").load() is msa.msa_binary_classification
    with pytest.raises(ValueError, match="cannot import"):
        MetricDef("metrics.no_such_metric").load()


def test_recorder_keys_and_values_match_mmtpu():
    """Same per-pattern keys and values from the same batches, padded rows
    dropped, vocabulary overridden as train_monomodal does."""
    from mmtpu.config.metrics import MetricConfig as JaxMetricConfig
    from mmtpu.train.recorder import MetricRecorder as JaxRecorder

    from mmtpu_torch.config.metrics import MetricConfig
    from mmtpu_torch.train.recorder import MetricRecorder

    spec = {"metrics": {
        "accuracy": {"function": "sklearn.metrics.accuracy_score", "kwargs": {}},
        "f1_weighted": {"function": "sklearn.metrics.f1_score",
                        "kwargs": {"average": "weighted", "zero_division": 0}},
        "ConfusionMatrix": {"function": "sklearn.metrics.confusion_matrix",
                            "kwargs": {"labels": list(range(10))}}},
        "groups": {"classification": ["accuracy", "f1_weighted", "ConfusionMatrix"]}}
    ours, theirs = MetricRecorder(MetricConfig.from_dict(spec)), \
        JaxRecorder(JaxMetricConfig.from_dict(spec))
    g = np.random.default_rng(4)
    for vocab in (["ai", "a", "i"], ["audio"] * 3):
        ours.reset()
        theirs.reset()
        for _ in range(3):
            preds, labels = g.integers(0, 10, 16), g.integers(0, 10, 16)
            pids, mask = g.integers(0, 3, 16).astype(np.int32), np.ones(16, np.float32)
            mask[12:] = 0
            ours.update_group_ids("classification", torch.from_numpy(preds),
                                  torch.from_numpy(labels), torch.from_numpy(pids), vocab,
                                  torch.from_numpy(mask))
            theirs.update_group_ids("classification", preds, labels, pids, vocab, mask)
        got = ours.calculate_all_groups(loss=0.5)
        want = theirs.calculate_all_groups(loss=0.5)
        assert got.keys() == want.keys()
        for group in want:
            assert got[group].keys() == want[group].keys()
            for k, w in want[group].items():
                np.testing.assert_allclose(np.asarray(got[group][k]), np.asarray(w),
                                           rtol=1e-12, err_msg=k)


# -- the train loader's order ---------------------------------------------------

def test_train_order_matches_mmtpu_loader_and_schedule():
    """Per-epoch shuffled order, pattern draws, masks and padding: the port's
    BatchLoader against mmtpu's BatchLoader and device_loop.build_schedule,
    for the same seed, over three epochs."""
    from mmtpu.data.avmnist import SyntheticAVMNIST as JaxSynthetic
    from mmtpu.data.loader import BatchLoader as JaxLoader
    from mmtpu.modalities import Modality as JaxModality

    from mmtpu_torch.data import BatchLoader, SyntheticAVMNIST
    from mmtpu_torch.modalities import Modality

    def patterns(M):
        return {"ai": {M.AUDIO: 1.0, M.IMAGE: 0.7}, "a": {M.AUDIO: 1.0, M.IMAGE: 0.0},
                "i": {M.AUDIO: 0.0, M.IMAGE: 1.0}}

    kw = dict(split="train", num_samples=45, seed=13)
    ours = BatchLoader(SyntheticAVMNIST(missing_patterns=patterns(Modality), **kw),
                       batch_size=16, shuffle=True, seed=13)
    jds = JaxSynthetic(missing_patterns=patterns(JaxModality), **kw)
    theirs = JaxLoader(jds, batch_size=16, shuffle=True, seed=13)
    keys = ("sample_idx", "pattern_id", "sample_mask", "audio_mask", "image_mask", "labels",
            "audio", "image")
    _assert_same_train_order(ours, theirs, jds, keys, batches=3, seed=13)


def test_mosi_train_order_matches_mmtpu_loader_and_schedule(tmp_path):
    """The same for MOSI's train split as configs/mosi/synthetic_utt_fusion.yaml
    builds it in each package (pattern `atv`, audio and video each missing
    with probability 0.2 by per-sample Bernoulli masks, shuffled), at 45
    samples in batches of 16 and T = 6."""
    from mmtpu.config import StandardMultimodalConfig as JaxConfig
    from mmtpu_torch.config import StandardMultimodalConfig

    text = (REPO / "configs/mosi/synthetic_utt_fusion.yaml").read_text()
    for old, new in (("num_samples: 128", "num_samples: 45\n        seq_len: 6"),
                     ("batch_size: 32", "batch_size: 16")):
        assert old in text
        text = text.replace(old, new)
    cfg_path = tmp_path / "utt.yaml"
    cfg_path.write_text(text.replace("./experiments_output", str(tmp_path)))
    jcfg, pcfg = JaxConfig.load(cfg_path, run_id=1), StandardMultimodalConfig.load(cfg_path,
                                                                                   run_id=1)
    theirs = jcfg.data.build_loader("train", seed=jcfg.experiment.seed)
    ours = pcfg.data.build_loader("train", seed=pcfg.experiment.seed)
    assert ours.pattern_vocab == theirs.pattern_vocab == ["atv"]
    masks = np.stack([ours.dataset.mask_stack(m) for m in ours.dataset.arrays])
    assert 0 < (masks[:2] == 0).sum() and (masks[2] == 1).all()  # text is never dropped
    keys = ("sample_idx", "pattern_id", "sample_mask", "audio_mask", "video_mask",
            "text_mask", "labels", "audio", "video", "text")
    _assert_same_train_order(ours, theirs, theirs.dataset, keys, batches=3,
                             seed=pcfg.experiment.seed)


def _assert_same_train_order(ours, theirs, jds, keys, batches, seed):
    """Three epochs of the two loaders batch by batch, and the port's
    against mmtpu's device-loop schedule."""
    from mmtpu.train.device_loop import build_schedule

    for epoch in range(3):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == batches
        for a, b in zip(got, want):
            for k in keys:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=f"{epoch} {k}")
        sched = build_schedule(jds, 16, epoch, True, seed, "train")
        np.testing.assert_array_equal(np.stack([b["pattern_id"] for b in got]),
                                      sched["pattern_id"])
        np.testing.assert_array_equal(np.stack([b["sample_mask"] for b in got]),
                                      sched["sample_mask"])
        real = np.stack([b["sample_mask"] for b in got]) > 0
        np.testing.assert_array_equal(np.stack([b["sample_idx"] for b in got])[real],
                                      sched["idx"][real])


def test_padded_batch_publishes_the_mask_and_full_batch_does_not(monkeypatch):
    """The step gives BatchNorm the sample mask only when the host batch
    has padded rows."""
    from mmtpu_torch.train import step as step_mod

    seen = []
    real = step_mod.train_step_core

    def spy(task, state, batch, padded=True, grad_hook=None):
        seen.append(padded)
        return real(task, state, batch, padded, grad_hook)

    monkeypatch.setattr(step_mod, "train_step_core", spy)
    pm = build_module("fcclassifier", **FC)
    opt, _ = build_optimizer(__import__("mmtpu_torch.config.optim", fromlist=["x"])
                             .OptimizerConfig.from_dict({"name": "Adam"}), pm)
    task = ClassificationTask(model=pm, loss_group=losses.LossFunctionGroup.from_dict(
        {"ce": {"loss_name": "cross_entropy"}}), input_keys=["x"])
    step = make_train_step(task, TrainState(pm, opt), CPU)
    b = {"x": np.ones((4, 12), np.float32), "labels": np.zeros(4, np.int64),
         "sample_mask": np.ones(4, np.float32)}
    step(b)
    b["sample_mask"][3] = 0
    step(b)
    assert seen == [False, True]
    assert math.isfinite(float(step(b)["loss"]))
