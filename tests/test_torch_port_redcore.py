"""The port's RedCore (mmtpu_torch.models.transformer, models.redcore,
train.redcore_step) against mmtpu's on the CPU, from the same numpy inputs
made from a seed and mmtpu's weights carried by `from_jax_variables`, at
tiny widths (Transformer embedding 8 with 2 heads, T = 6, B = 8):

- `ResidualAttentionBlock` and `Transformer` (1 and 2 blocks) eval
  forwards, (z, μ, logσ²): 1e-5;
- RedCore's eval forward, every output, with each modality gated by its own
  missing index, and with `share_weight`: 1e-5;
- the loss (four masked CEs, the KLDs over the real rows, the twice-divided
  masked MSEs under β) and its per-modality MSEs on a batch with a padded
  tail and missing modalities: 1e-6;
- eight train steps in float64, the third with a zero-padded tail and the
  sixth with no video at all: loss 1e-5 relative, gradients within 1e-5 of
  each parameter's norm (the attention's key biases, whose exact gradient
  is 0, within 1e-5 of the whole gradient's norm on both sides), parameters
  and Adam's moments after steps 1 and 3 at 1e-5, and the schedule (EMA, β,
  η, `iter_count`) after every step at 1e-6; the eval step after them. In
  float32 the attention's small gradients (~1e-9 of the whole) and the EMA
  after a few steps hold mostly rounding, on either side.

The randomness of a RedCore train forward (attention dropout 0.2, MLP
dropout 0.1, the VAE sample ε) comes from different generators in the two
packages, so the step tests neutralise it in both: mmtpu's transformer
module is run against a stand-in `flax.linen` whose attention and dropout
rates are 0 and a `jax.random.normal` that returns zeros (nothing in mmtpu
changes); the port's dropouts get p = 0 and its ε source returns zeros.
What the port draws, and from which generator, is tested on its own.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mmtpu.cli import common as jax_common
from mmtpu.config.training import TrainingConfig as JaxTrainingConfig
from mmtpu.models import transformer as jax_transformer
from mmtpu.models.registry import build_module as jax_build
from mmtpu.train import redcore_step as jax_rs
from mmtpu.train.losses import LossFunctionGroup as JaxLosses
from mmtpu.train.state import TrainState as JaxTrainState
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.cli import common
from mmtpu_torch.config.training import TrainingConfig
from mmtpu_torch.models import build_module
from mmtpu_torch.models import rng as port_rng
from mmtpu_torch.train import redcore_step as rs
from mmtpu_torch.train.losses import LossFunctionGroup

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _redcore_neutral import neutralised  # noqa: E402
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

CPU = torch.device("cpu")
LOSS_TOL = 1e-6
TOL = 1e-5
RNG = jax.random.PRNGKey(0)
B, T, E = 8, 6, 8
WIDTHS = {"audio": 5, "video": 20, "text": 16}
MODS = ("audio", "video", "text")
LOSSES = {"cross_entropy": {"loss_name": "cross_entropy", "weight": 0.7},
          "mse": {"loss_name": "mse", "weight": 2.0}}
TRAINING = {
    "epochs": 1, "num_modalities": 3,
    "optimizer": {"name": "Adam", "default_kwargs": {"lr": 1e-3, "weight_decay": 1e-4,
                                                     "eps": 1e-3}},
    "loss_functions": LOSSES,
}
# interval 3 and eta_ext 1.7: the schedule's branches differ from the defaults
SCHEDULE = {"loss_beta": 0.9, "interval_i": 3, "eta_ext": 1.7, "lambda_one": 0.01}


def _perturb(variables, seed):
    """Biases, LayerNorm and BatchNorm scales and statistics from a seed."""
    g = np.random.default_rng(seed)
    out = {}
    for col, tree in variables.items():
        flat = flatten_dict(jax.tree_util.tree_map(np.asarray, dict(tree)))
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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float64),
                               np.asarray(want, np.float64), rtol=tol, atol=tol, err_msg=msg)


# -- the Transformer -------------------------------------------------------------------

def test_attention_block_eval_matches_mmtpu():
    x = np.random.default_rng(1).normal(size=(3, T, E)).astype(np.float32)
    jm = jax_transformer.ResidualAttentionBlock(E, 2)
    pm = build_module("transformer", width=E, layers=1, heads=2, embd_width=E).resblock_0
    v = _perturb(dict(jm.init({"params": RNG}, jnp.asarray(x))), 2)
    assert set(v["params"]["attn"]) == {"query", "key", "value", "out"}
    _carry(v, pm).eval()
    _close(pm(_t(x)), jm.apply(v, jnp.asarray(x), train=False))


@pytest.mark.parametrize("layers", [1, 2])
def test_transformer_eval_matches_mmtpu(layers):
    kw = {"width": 5, "layers": layers, "heads": 2, "embd_width": E}
    jm, pm = jax_build("transformer", **kw), build_module("transformer", **kw)
    x = np.random.default_rng(3).normal(size=(4, T, 5)).astype(np.float32)
    v = _perturb(dict(jm.init({"params": RNG}, jnp.asarray(x))), 4)
    _carry(v, pm).eval()
    want = jm.apply(v, jnp.asarray(x), train=False)
    got = pm(_t(x))
    for name, w, p in zip(("z", "mu", "log_var"), want, got):
        _close(p, w, msg=name)
    assert torch.equal(got[0], got[1])  # eval: z = μ


def test_transformer_draws_from_its_generator_only():
    """Train mode without a generator raises; with one, the attention mask
    is one (T, T) draw shared by the batch and the heads, the draws repeat
    with the seed, and torch's global generator is not drawn."""
    tr = build_module("transformer", width=5, layers=1, heads=2, embd_width=E).train()
    x = torch.randn(4, T, 5)
    with pytest.raises(RuntimeError, match="Generator"):
        tr(x)
    seen = []
    tr.resblock_0.attn.dropout.register_forward_hook(lambda m, i, o: seen.append((i[0], o)))
    state = torch.get_rng_state()
    outs = [port_rng.use_generator(tr, torch.Generator().manual_seed(5))(x) for _ in range(2)]
    assert torch.equal(state, torch.get_rng_state())
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert not torch.equal(outs[0][0], outs[0][1])  # z = μ + ε·σ in training
    weights, dropped = seen[0]
    keep = (dropped != 0) | (weights == 0)
    assert keep.shape == (4, 2, T, T)
    assert bool((keep == keep[:1, :1]).all())  # one mask for every row and head
    assert 0 < int(keep[0, 0].sum()) < T * T


# -- RedCore ----------------------------------------------------------------------------

def _fc(build, width):
    return build("fcclassifier", input_dim=width, layers=[10], output_dim=3, dropout=0.0)


def _xe(build):
    return build("residual_xe", layers=[12], n_blocks=2, input_dim=2 * E, output_dim=E,
                 dropout=0.0)


def _redcore(build, share_weight=False):
    tr = functools.partial(build, "transformer", layers=1, heads=2, embd_width=E)
    return build(
        "redcore",
        netA=tr(width=WIDTHS["audio"]), netV=tr(width=WIDTHS["video"]),
        netT=tr(width=WIDTHS["text"]),
        netAE=build("residual_ae", layers=[12, 6], n_blocks=2, input_dim=3 * E, dropout=0.0),
        netC=_fc(build, 3 * E), netC_A=_fc(build, E), netC_V=_fc(build, E), netC_T=_fc(build, E),
        netAT_V=_xe(build), netAV_T=_xe(build), netVT_A=_xe(build),
        share_weight=share_weight, unused_option=1,
    )


def _batch(seed, padded_from=None, no_video=False):
    g = np.random.default_rng(seed)
    labels = g.integers(0, 3, size=B).astype(np.int64)
    batch = {m: (g.normal(size=(B, T, w)) + 0.3 * labels[:, None, None]).astype(np.float32)
             for m, w in WIDTHS.items()}
    for m in MODS:
        batch[f"{m}_mask"] = np.ones(B, np.float32)
    batch["video_mask"][1::3] = 0.0
    batch["audio_mask"][2::4] = 0.0
    batch["text_mask"][5] = 0.0
    if no_video:
        batch["video_mask"][:] = 0.0
    batch.update(labels=labels, pattern_id=np.zeros(B, np.int32),
                 sample_mask=np.ones(B, np.float32))
    if padded_from is not None:
        for k in list(batch):
            if k != "pattern_id":
                batch[k][padded_from:] = 0
    return batch


def _init_args(n=2):
    return ([jnp.zeros((n, T, WIDTHS[m])) for m in MODS] + [jnp.ones((n,))] * 3)


@pytest.mark.parametrize("share_weight", [False, True], ids=["cycle_ae", "shared"])
def test_redcore_eval_forward_matches_mmtpu(share_weight):
    jm, pm = _redcore(jax_build, share_weight), _redcore(build_module, share_weight)
    v = _perturb(dict(jm.init({"params": RNG, "sample": RNG}, *_init_args())), 6)
    assert ("netAE_cycle" in v["params"]) == (not share_weight)
    _carry(v, pm).eval()
    b = _batch(7)
    idx = [b[f"{m}_mask"] for m in MODS]
    want = jm.apply(v, *(jnp.asarray(b[m]) for m in MODS), *map(jnp.asarray, idx), train=False)
    got = pm(*(_t(b[m]) for m in MODS), *map(_t, idx))
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], msg=k)
    # each feature is gated by its own modality's index
    gated = got["logits_A"].detach()
    swapped = pm(*(_t(b[m]) for m in MODS), _t(idx[1]), _t(idx[0]), _t(idx[2]))
    assert not torch.allclose(swapped["logits_A"], gated)


def test_redcore_loss_terms_match_mmtpu():
    """mmtpu's step over fixed model outputs (an apply_fn that returns them)
    gives its total loss, and with loss_beta 1 its EMA is the MSE vector."""
    g = np.random.default_rng(8)
    res = {f"logits{s}": g.normal(size=(B, 3)) for s in ("", "_A", "_V", "_T")}
    for m in "AVT":
        res.update({f"feature_{m}_miss": g.normal(size=(B, E)), f"gen_{m}": g.normal(size=(B, E)),
                    f"fmu_{m}": g.normal(size=(B, E)),
                    f"flog_var_{m}": 0.3 * g.normal(size=(B, E))})
    res = {k: v.astype(np.float32) for k, v in res.items()}
    batch = _batch(9, padded_from=6)
    beta = np.array([0.3, 1.2, 0.7], np.float32)
    kw = {**SCHEDULE, "loss_beta": 1.0}
    jtask = jax_rs.RedCoreTask(model=None, loss_group=JaxLosses.from_dict(LOSSES), **kw)
    state = JaxTrainState.create(apply_fn=lambda *a, **k: {k_: jnp.asarray(v)
                                                          for k_, v in res.items()},
                                 params={"w": jnp.zeros(1)}, tx=optax.sgd(0.0))
    sched = jax_rs.RedCoreSchedState.create().replace(beta=jnp.asarray(beta))
    _, new_sched, out = jax_rs.make_redcore_train_step(jtask)(
        state, sched, {k: jnp.asarray(v) for k, v in batch.items()}, RNG)
    ptask = rs.RedCoreTask(model=None, loss_group=LossFunctionGroup.from_dict(LOSSES), **kw)
    total, mses = rs.redcore_loss(ptask, {k: _t(v) for k, v in res.items()},
                                  {k: _t(v) for k, v in batch.items()}, _t(beta))
    np.testing.assert_allclose(float(total), float(out["loss"]), rtol=LOSS_TOL)
    np.testing.assert_allclose(mses.numpy(), np.asarray(new_sched.loss_ema), rtol=LOSS_TOL)


# -- train steps -----------------------------------------------------------------------

STEPS = 8


def _run_steps():
    jm, pm = _redcore(jax_build), _redcore(build_module)
    v = _perturb(dict(jm.init({"params": RNG, "sample": RNG}, *_init_args())), 11)
    _carry(v, pm).double()
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
    batches = [{k: a.astype(np.float64) if a.dtype == np.float32 else a
                for k, a in _batch(20 + i, padded_from=5 if i == 2 else None,
                                   no_video=i == 5).items()} for i in range(STEPS)]
    jtask = jax_rs.RedCoreTask(model=jm, loss_group=JaxLosses.from_dict(LOSSES), **SCHEDULE)
    ptask = rs.RedCoreTask(model=pm, loss_group=LossFunctionGroup.from_dict(LOSSES), **SCHEDULE)
    pstate = common.make_state(pm, TrainingConfig.from_dict(TRAINING))
    ptrain = rs.RedCoreTrainStep(ptask, pstate, CPU, rs.RedCoreSchedState.create(eta=0.002))

    grads, record, states, scheds = [], [], [], []
    real_apply = JaxTrainState.apply_gradients

    def spy(self, **kwargs):
        grads.append(jax.tree_util.tree_map(np.asarray, kwargs["grads"]))
        return real_apply(self, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxTrainState, "apply_gradients", spy)
    neutralised(mp)
    try:
        with jax.enable_x64(True), jax.disable_jit():
            jstate = jax_common.make_state(jm, v["params"], {}, JaxTrainingConfig.from_dict(
                TRAINING))
            jsched = jax_rs.RedCoreSchedState.create(eta=0.002)
            jtrain = jax_rs.make_redcore_train_step(jtask)
            for i, b in enumerate(batches):
                jstate, jsched, jout = jtrain(jstate, jsched,
                                              {k: jnp.asarray(a) for k, a in b.items()}, RNG)
                pout = ptrain(b)
                record.append((jax.tree_util.tree_map(np.asarray, jout), pout,
                               {n: p.grad.clone() for n, p in pm.named_parameters()}))
                scheds.append((jax.tree_util.tree_map(np.asarray, jsched), ptrain.sched))
                if i in (0, 2):
                    states.append((jax.tree_util.tree_map(np.asarray, (
                        jstate.params, jstate.opt_state)),
                        {k: t.clone() for k, t in pm.state_dict().items()},
                        {id(p): {k: s.clone() for k, s in st.items()}
                         for p, st in pstate.optimizer.state.items()}))
            jev = jax_rs.make_redcore_eval_step(jtask)(
                jstate, {k: jnp.asarray(a) for k, a in batches[2].items()})
            jev = jax.tree_util.tree_map(np.asarray, jev)
        pev = rs.make_redcore_eval_step(ptask, CPU)(batches[2])
    finally:
        mp.undo()
    return {"record": record, "grads": grads, "states": states, "scheds": scheds,
            "pstate": pstate, "eval": (jev, pev)}


@pytest.fixture(scope="module")
def steps():
    return _run_steps()


@pytest.mark.parametrize("k", [0, 1, 2, 5])
def test_train_step_loss_and_gradients_match_mmtpu(steps, k):
    jout, pout, pgrads = steps["record"][k]
    np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=TOL)
    ps = steps["pstate"]
    want = from_jax_variables(steps["grads"][k], target=ps.model, require_all=False)
    assert set(want) == set(pgrads)
    whole = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    for name, g in pgrads.items():
        w = want[name].double().numpy()
        if name.endswith("attn.key.bias"):
            # softmax over the keys ignores a shift shared by them: the exact
            # gradient is 0, and both sides hold only rounding
            assert max(np.abs(w).max(), g.abs().max()) <= TOL * whole, (name, whole)
            continue
        err = np.abs(g.double().numpy() - w).max()
        assert err <= TOL * np.linalg.norm(w) + 1e-12, (name, err, np.linalg.norm(w))
    for key in ("preds", "labels", "sample_mask", "pattern_id"):
        np.testing.assert_array_equal(np.asarray(pout[key]), np.asarray(jout[key]), key)


def test_ae_and_cycle_ae_get_no_gradient(steps):
    """No loss term reads netAE or the cycle AE, in mmtpu or the port."""
    _, _, pgrads = steps["record"][0]
    for name, g in pgrads.items():
        if name.startswith(("netAE.", "netAE_cycle.")):
            assert not g.any(), name


@pytest.mark.parametrize("which", [0, 1], ids=["after_step_1", "after_step_3"])
def test_state_matches_mmtpu(steps, which):
    (params, opt_state), got, moments = steps["states"][which]
    ps = steps["pstate"]
    want = from_jax_variables(params, target=ps.model)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].double().numpy(), w.double().numpy(), rtol=0,
                                   atol=TOL, err_msg=k)
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: type(x).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState"]
    names = {id(p): n for n, p in ps.model.named_parameters()}
    for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        tree = from_jax_variables(unflatten_dict(
            {p: np.asarray(v) for p, v in flatten_dict(getattr(adam[0], key)).items()}),
            target=ps.model, require_all=False)
        for pid, st in moments.items():
            np.testing.assert_allclose(st[torch_key].double().numpy(),
                                       tree[names[pid]].double().numpy(), rtol=0, atol=TOL,
                                       err_msg=f"{key} {names[pid]}")


@pytest.mark.parametrize("k", range(STEPS))
def test_schedule_matches_mmtpu(steps, k):
    want, got = steps["scheds"][k]
    assert int(got.iter_count) == int(want.iter_count) == k + 1
    for field in ("loss_ema", "beta", "eta"):
        np.testing.assert_allclose(getattr(got, field).numpy(), getattr(want, field),
                                   rtol=LOSS_TOL, atol=0, err_msg=field)
    if k == 0:  # η grows at step 0 (0 % 500 == 0), β is rebalanced to 1/√3 each
        np.testing.assert_allclose(float(got.eta), 0.002 * SCHEDULE["eta_ext"], rtol=1e-6)
        np.testing.assert_allclose(got.beta.numpy(), np.full(3, 3 ** -0.5), rtol=1e-6)


def test_eval_step_after_training_matches_mmtpu(steps):
    jev, pev = steps["eval"]
    assert set(pev) == set(jev)
    np.testing.assert_allclose(float(pev["loss"]), float(jev["loss"]), rtol=TOL)
    for key in ("preds", "labels", "sample_mask", "pattern_id"):
        np.testing.assert_array_equal(np.asarray(pev[key]), np.asarray(jev[key]), key)
