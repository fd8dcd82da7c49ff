"""The port's MulT (`mmtpu_torch/models/mult.py`) against mmtpu's, on the CPU.

- `ConvProjection` (odd and even kernel widths) and `masked_mean_pool`
  (lengths 0, below T, at T and past it; none);
- `MultModalTransformer` with and without the discriminator, with and
  without lengths, through `from_jax_variables` (`_recurrent_parity`, eval
  mode at the published dropouts): forwards at 1e-5, gradients at 1e-4 of
  each parameter's norm, no `lstm` launch;
- both packages' `ClassificationTask` on the same batch, with and without
  the discriminator and with and without a padded tail (dropouts 0): the
  port's train step's loss and mmtpu's at 1e-6, its gradients at 1e-4 of
  each parameter's norm, its outputs holding the logits' predictions; the
  eval steps' losses at 1e-6 (the discriminator's loss leaves the padded
  rows out in eval too);
- the full variable tree with the discriminator converts with
  `require_all=True` and no leaf left over; the registry's `mult` builds
  the class in both packages.
"""

import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmtpu.models import mult as jax_mult
from mmtpu.models.registry import build_module as jax_build
from mmtpu.train.losses import LossFunctionGroup as JaxLosses
from mmtpu.train.step import ClassificationTask as JaxTask
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.models import build_module, mult
from mmtpu_torch.train.losses import LossFunctionGroup
from mmtpu_torch.train.state import TrainState
from mmtpu_torch.train.step import ClassificationTask, make_eval_step, make_train_step

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _recurrent_parity import check as _check  # noqa: E402
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

B, T = 4, 8
DIMS = dict(orig_dim_a=5, orig_dim_t=6, orig_dim_v=4)
SIZE = dict(attention_dim=8, output_dim=3, num_heads=2, num_layers=2)
NO_DROPOUT = dict(attention_dropout=0.0, relu_dropout=0.0, embd_dropout=0.0,
                  residual_dropout=0.0, output_dropout=0.0)
LENGTHS = np.array([0, 3, 8, 11], np.int32)  # 0, below T, at T and past it
LOSSES = {"cross_entropy": {"loss_name": "cross_entropy", "weight": 1.0}}
KEYS = ("audio", "video", "text")


def check(*args, **kwargs):
    """Eval mode, mmtpu's side op by op: its primitives compile once per
    shape and are shared by every MulT of this file (one compiled program
    per check would cost ~11 s each)."""
    return _check(*args, train_modes=(False,), **kwargs)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _inputs(seed=0):
    return [_x(B, T, DIMS["orig_dim_a"], seed=seed), _x(B, T, DIMS["orig_dim_v"], seed=seed + 1),
            _x(B, T, DIMS["orig_dim_t"], seed=seed + 2)]


class _JaxProj(fnn.Module):
    """A ConvProjection under MulT's name for it, called without `train`."""

    proj_a: fnn.Module

    def __call__(self, x, train=False):
        return self.proj_a(x)


class _PortProj(torch.nn.Module):
    def __init__(self, proj_a):
        super().__init__()
        self.proj_a = proj_a

    def forward(self, x):
        return self.proj_a(x)


@pytest.mark.parametrize("ksize", [3, 4, 1])
def test_conv_projection(ksize):
    check(_JaxProj(jax_mult.ConvProjection(8, ksize)), _PortProj(mult.ConvProjection(5, 8, ksize)),
          [_x(B, T, 5, seed=ksize)])


@pytest.mark.parametrize("lengths", [None, LENGTHS])
def test_masked_mean_pool(lengths):
    x = _x(B, T, 3)
    want = np.asarray(jax_mult.masked_mean_pool(jnp.asarray(x), None if lengths is None
                                                else jnp.asarray(lengths)))
    got = mult.masked_mean_pool(torch.from_numpy(x), None if lengths is None
                                else torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


FORMS = {
    "plain": dict(kw={}, lengths=None),  # built through both registries
    "discriminator_lengths_even_kernels": dict(
        kw=dict(use_discriminator=True, lambda_d=0.3, a_ksize=4, v_ksize=1,
                attention_mask=False), lengths=LENGTHS),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_mult_forward_and_gradients(form):
    kw = {**DIMS, **SIZE, **FORMS[form]["kw"]}
    if form == "plain":
        jmodel, model = jax_build("mult", **kw), build_module("mult", **kw)
        assert type(jmodel) is jax_mult.MultModalTransformer
        assert type(model) is mult.MultModalTransformer
    else:
        jmodel, model = jax_mult.MultModalTransformer(**kw), mult.MultModalTransformer(**kw)
    check(jmodel, model, _inputs(), {"lengths": FORMS[form]["lengths"]}, launches=[])


def _batch(padded):
    g = np.random.default_rng(5)
    a, v, t = _inputs(seed=7)
    batch = {"audio": a, "video": v, "text": t,
             "labels": g.integers(0, 3, B).astype(np.int32),
             "sample_mask": np.ones(B, np.float32)}
    if padded:  # the last row is a zero-padded tail row
        for k in (*KEYS, "labels", "sample_mask"):
            batch[k][-1] = 0
    return batch


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "discriminator"])
def tasks(request):
    """Both packages' task over the same MulT weights, and mmtpu's train loss
    with its gradient and its eval loss."""
    kw = {**DIMS, **SIZE, **NO_DROPOUT, "use_discriminator": request.param, "lambda_d": 0.5}
    jmodel = jax_mult.MultModalTransformer(**kw)
    jtask = JaxTask(model=jmodel, loss_group=JaxLosses.from_dict(LOSSES), input_keys=KEYS,
                    label_key="labels")
    a, v, t = (jnp.asarray(x) for x in _inputs())
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(3), a, v, t)
                                    ["params"])

    def train_loss(p, batch):
        out = jtask.apply({"params": p}, batch, train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jtask.loss(out, batch, sample_mask=batch["sample_mask"])

    def eval_loss(p, batch):
        out = jtask.apply({"params": p}, batch, train=False)
        return jtask.loss(out, batch, sample_mask=batch["sample_mask"]), jtask.predictions(out)

    model = mult.MultModalTransformer(**kw)
    model.load_state_dict(from_jax_variables(params, target=model))
    task = ClassificationTask(model=model, loss_group=LossFunctionGroup.from_dict(LOSSES),
                              input_keys=KEYS)
    return dict(params=params, train=jax.value_and_grad(train_loss), eval=eval_loss,
                task=task, model=model)


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_classification_task_steps(tasks, padded):
    batch = _batch(padded)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, jgrads = tasks["train"](tasks["params"], jbatch)
    want_eval, want_preds = tasks["eval"](tasks["params"], jbatch)

    model, task = tasks["model"], tasks["task"]
    state = TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.0))
    out = make_train_step(task, state, torch.device("cpu"))(batch)
    np.testing.assert_allclose(float(out["loss"]), float(want_loss), rtol=1e-6, atol=1e-6)
    assert out["preds"].shape == (B,)
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, jgrads), target=model)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if name.endswith("key.bias"):  # exactly 0: the softmax ignores a shared shift
            whole = np.sqrt(sum(float((g.double() ** 2).sum()) for g in want.values()))
            assert max(np.abs(w).max(), p.grad.abs().max().item()) <= 1e-4 * whole, name
            continue
        assert np.abs(p.grad.numpy() - w).max() <= 1e-4 * max(np.linalg.norm(w), 1e-6), name

    ev = make_eval_step(task, torch.device("cpu"))(batch)
    np.testing.assert_allclose(float(ev["loss"]), float(want_eval), rtol=1e-6, atol=1e-6)
    assert ev["logits"].shape == (B, SIZE["output_dim"])
    np.testing.assert_array_equal(ev["preds"].numpy(), np.asarray(want_preds))


def test_aux_loss_is_added_once():
    """The task's loss is the classification loss plus `aux_loss`."""
    torch.manual_seed(0)
    model = mult.MultModalTransformer(**DIMS, **SIZE, use_discriminator=True).eval()
    task = ClassificationTask(model=model, loss_group=LossFunctionGroup.from_dict(LOSSES),
                              input_keys=KEYS)
    batch = {k: torch.from_numpy(v) for k, v in _batch(False).items()}
    out = task.apply(batch, train=False)
    assert set(out) == {"logits", "aux_loss"}
    plain = task.loss(out["logits"], batch)
    torch.testing.assert_close(task.loss(out, batch), plain + out["aux_loss"])
    torch.testing.assert_close(task.predictions(out), out["logits"].argmax(-1))


def test_full_tree_converts_without_leftovers():
    kw = {**DIMS, **SIZE, "use_discriminator": True}
    a, v, t = (jnp.asarray(x) for x in _inputs())
    params = jax.tree_util.tree_map(
        np.asarray, jax_mult.MultModalTransformer(**kw).init(jax.random.PRNGKey(0), a, v, t))
    model = mult.MultModalTransformer(**kw)
    state = from_jax_variables(params["params"], target=model, require_all=True)
    assert set(state) == set(model.state_dict())
    assert len(state) == len(jax.tree_util.tree_leaves(params["params"]))
