"""The port's MMIN (mmtpu_torch.models.autoencoder, models.mmin,
train.mmin_step) against mmtpu's on the CPU, from the same numpy inputs made
from a seed and mmtpu's weights carried by `from_jax_variables`, at tiny
widths (LSTM hidden 8, T = 6, B = 8, TextCNN with 4 channels, dropout 0):

- `apply_missing_mask` with `invert` (the complement inputs), a mask of
  None included: exact;
- `ResidualAE` (with BatchNorm), `ResidualXE`, `ResidualUnetAE` (concat with
  BatchNorm, add) and `SimpleFcAE` eval forwards: 1e-5;
- MMIN's eval forward, all nine outputs, with the stacked pair, without it
  (unequal hidden sizes) and with `share_weight`: 1e-5; the stacked pair is
  one G=2 call of the recurrence's plain path (the kernel's stand-in here);
- `_mmin_losses` in training (the detached cycle target) and in eval: 1e-6;
- three train steps, the third with a zero-padded tail, every batch with a
  missing video, with the frozen UttFusion teacher over the complement
  inputs and a `clip` the gradients exceed (float32) and without a teacher
  over a BatchNorm AE (float64: flax's float32 BatchNorm variance is
  E[x²] − E[x]²): loss and each term 1e-5 relative, gradients within 1e-5
  of each parameter's norm (the port's after the clip against mmtpu's
  scaled by min(1, clip / norm)), parameters and Adam's moments after steps
  1 and 3 at 1e-5; the eval step after them;
- the teacher: its complement embedding, zeros for a modality without a
  mask key, and its state bitwise unchanged, in eval mode, outside MMIN's
  parameters, state dict and optimizer.

mmtpu's steps return no gradients: they are read from its
`TrainState.apply_gradients` with jit disabled. Adam runs at eps 1e-3 (see
tests/test_torch_port_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mmtpu.cli import common as jax_common
from mmtpu.config.training import TrainingConfig as JaxTrainingConfig
from mmtpu.models.registry import build_module as jax_build
from mmtpu.train import mmin_step as jax_ms
from mmtpu.train.losses import LossFunctionGroup as JaxLosses
from mmtpu.train.state import TrainState as JaxTrainState
from mmtpu.train.step import apply_missing_mask as jax_apply_missing_mask
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.cli import common
from mmtpu_torch.config.training import TrainingConfig
from mmtpu_torch.models import build_module
from mmtpu_torch.models.autoencoder import SimpleFcAE
from mmtpu_torch.ops import lstm as lstm_ops
from mmtpu_torch.train import mmin_step as ms
from mmtpu_torch.train import step as step_mod
from mmtpu_torch.train.losses import LossFunctionGroup
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

CPU = torch.device("cpu")
LOSS_TOL = 1e-6
TOL = 1e-5
RNG = jax.random.PRNGKey(0)
B, T, H = 8, 6, 8
WIDTHS = {"audio": 5, "video": 20, "text": 16}
LOSSES = {"cross_entropy": {"loss_name": "cross_entropy", "weight": 1.0},
          "mse": {"loss_name": "mse", "weight": 0.5},
          "cycle": {"loss_name": "cycle", "weight": 0.25}}
TRAINING = {
    "epochs": 1, "num_modalities": 3,
    "optimizer": {"name": "Adam", "default_kwargs": {"lr": 1e-3, "weight_decay": 1e-4,
                                                     "eps": 1e-3}},
    "loss_functions": LOSSES,
}


def _perturb(variables, seed):
    """Biases, BatchNorm scales and running statistics drawn from a seed."""
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
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got, np.float64),
                               np.asarray(want, np.float64), rtol=tol, atol=tol, err_msg=msg)


# -- apply_missing_mask(invert) ----------------------------------------------------

@pytest.mark.parametrize("invert", [False, True], ids=["mask", "complement"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["given", "none"])
def test_apply_missing_mask_matches_mmtpu(invert, with_mask):
    g = np.random.default_rng(1)
    x = g.normal(size=(5, 3, 4)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0], np.float32) if with_mask else None
    want = jax_apply_missing_mask(jnp.asarray(x), None if mask is None else jnp.asarray(mask),
                                  invert=invert)
    got = step_mod.apply_missing_mask(_t(x), None if mask is None else _t(mask), invert=invert)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if invert and not with_mask:
        assert not got.any()


# -- autoencoders ----------------------------------------------------------------------

AE_CASES = {
    "residual_ae_bn": ("residual_ae", {"layers": [16, 8], "n_blocks": 3, "input_dim": 24,
                                       "dropout": 0.3, "use_bn": True}),
    "residual_xe": ("residual_xe", {"layers": [16, 8], "n_blocks": 2, "input_dim": 24,
                                    "output_dim": 7, "dropout": 0.0}),
    "residual_unet_ae_concat_bn": ("residual_unet_ae", {"layers": [16, 8], "n_blocks": 2,
                                                        "input_dim": 24, "use_bn": True}),
    "residual_unet_ae_add": ("residual_unet_ae", {"layers": [16, 8, 6], "n_blocks": 2,
                                                  "input_dim": 24, "fusion": "add"}),
    "simple_fc_ae_bn": (None, {"layers": [16, 8], "input_dim": 24, "use_bn": True}),
}


@pytest.mark.parametrize("case", sorted(AE_CASES))
def test_autoencoder_eval_matches_mmtpu(case):
    name, kw = AE_CASES[case]
    if name is None:
        from mmtpu.models.autoencoder import SimpleFcAE as JaxSimpleFcAE

        jm, pm = JaxSimpleFcAE(**kw), SimpleFcAE(**kw)
    else:
        jm, pm = jax_build(name, **kw), build_module(name, **kw)
    x = np.random.default_rng(2).normal(size=(5, 24)).astype(np.float32)
    v = _perturb(dict(jm.init({"params": RNG}, jnp.asarray(x))), 3)
    _carry(v, pm).eval()
    want = jm.apply(v, jnp.asarray(x))
    got = pm(_t(x))
    _close(got[0], want[0])
    if isinstance(want[1], dict):  # the U-Net's per-block reconstructions
        assert list(got[1]) == list(want[1])
        for k in want[1]:
            _close(got[1][k], want[1][k], msg=str(k))
    else:
        _close(got[1], want[1])


# -- MMIN ----------------------------------------------------------------------------

def _mmin(build, hidden_v=H, share_weight=False, use_bn=False):
    fusion = H + hidden_v + 9
    return build(
        "mmin",
        netA=build("lstmencoder", input_size=5, hidden_size=H),
        netV=build("lstmencoder", input_size=20, hidden_size=hidden_v),
        netT=build("textcnn", input_size=WIDTHS["text"], embd_size=9, out_channels=4,
                   dropout=0.0),
        netAE=build("residual_ae", layers=[12, 6], n_blocks=2, input_dim=fusion, dropout=0.0,
                    use_bn=use_bn),
        netC=build("fcclassifier", input_dim=12, layers=[10], output_dim=3, dropout=0.0),
        share_weight=share_weight,
    )


def _teacher(build):
    return build(
        "utt_fusion",
        netA=build("lstmencoder", input_size=5, hidden_size=H, embd_method="maxpool"),
        netV=build("lstmencoder", input_size=20, hidden_size=H, embd_method="maxpool"),
        netT=build("textcnn", input_size=WIDTHS["text"], embd_size=9, out_channels=4,
                   dropout=0.0),
        netC=build("fcclassifier", input_dim=25, layers=[16], output_dim=3, dropout=0.0),
    )


def _zeros():
    return [jnp.zeros((2, T, WIDTHS[m])) for m in ms.MODS]


def _batch(seed, padded_from=None, masks=True):
    g = np.random.default_rng(seed)
    labels = g.integers(0, 3, size=B).astype(np.int64)
    batch = {m: (g.normal(size=(B, T, w)) + 0.3 * labels[:, None, None]).astype(np.float32)
             for m, w in WIDTHS.items()}
    if masks:
        for m in ms.MODS:
            batch[f"{m}_mask"] = np.ones(B, np.float32)
        batch["video_mask"][1::3] = 0.0
        batch["audio_mask"][2::4] = 0.0
    batch.update(labels=labels, pattern_id=np.zeros(B, np.int32),
                 sample_mask=np.ones(B, np.float32))
    if padded_from is not None:
        for k in list(batch):
            if k != "pattern_id":
                batch[k][padded_from:] = 0
    return batch


MMIN_CASES = {"stacked": {}, "unstacked": {"hidden_v": 7}, "shared": {"share_weight": True},
              "bn": {"use_bn": True}}


@pytest.mark.parametrize("case", sorted(MMIN_CASES))
def test_mmin_eval_forward_matches_mmtpu(case):
    kw = MMIN_CASES[case]
    jm, pm = _mmin(jax_build, **kw), _mmin(build_module, **kw)
    widths = dict(WIDTHS)
    inputs = [jnp.zeros((2, T, widths[m])) for m in ms.MODS]
    v = _perturb(dict(jm.init({"params": RNG}, *inputs)), 4)
    assert ("netAE_cycle" in v["params"]) == (not kw.get("share_weight"))
    _carry(v, pm).eval()
    b = _batch(5)
    want = jm.apply(v, *(jnp.asarray(b[m]) for m in ms.MODS), train=False)
    got = pm(*(_t(b[m]) for m in ms.MODS))
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], msg=k)


def test_mmin_stacked_pair_is_one_g2_call_of_the_recurrence(monkeypatch):
    """The audio and video LSTMs advance together: one call of the plain
    path (what a CUDA tensor would launch once) with two groups; with
    unequal hidden sizes, one call per encoder."""
    calls = []
    real = lstm_ops.lstm_stacked_reference

    def spy(xw, wh, *args, **kwargs):
        calls.append(len(xw) if not isinstance(xw, torch.Tensor) else xw.shape[0])
        return real(xw, wh, *args, **kwargs)

    monkeypatch.setattr(lstm_ops, "lstm_stacked_reference", spy)
    b = _batch(6)
    for kw, want in (({}, [2]), ({"hidden_v": 7}, [1, 1])):
        calls.clear()
        model = common.init_model(_mmin(build_module, **kw), 0, CPU).eval()
        model(*(_t(b[m]) for m in ms.MODS))
        assert calls == want, (kw, calls)


def test_mmin_keeps_the_teacher_a_spec():
    """`pretrained_model` stays the spec the registry was given: no
    submodule, no parameter, no state-dict key."""
    from mmtpu_torch.config.spec import ModuleSpec

    spec = ModuleSpec("utt_fusion", {"netA": ModuleSpec("lstmencoder", {"input_size": 5,
                                                                        "hidden_size": H})})
    model = build_module("mmin", **{k: getattr(_mmin(build_module), k)
                                    for k in ("netA", "netV", "netT", "netAE", "netC")},
                         pretrained_model=spec, unknown_key=3)
    assert model.pretrained_model is spec
    assert not any(k.startswith("pretrained") for k in model.state_dict())
    with pytest.raises(TypeError, match="spec"):
        type(model)(model.netA, model.netV, model.netT, model.netAE, model.netC,
                    pretrained_model=_teacher(build_module))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_mmin_losses_match_mmtpu(train):
    """The weighted (ce, mse, cycle) on a batch with a padded tail; in
    training the cycle term's target carries no gradient."""
    g = np.random.default_rng(7)
    res = {"logits": g.normal(size=(B, 3)), "fusion": g.normal(size=(B, 25)),
           "recon_fusion": g.normal(size=(B, 25)), "recon_cycle": g.normal(size=(B, 25))}
    res = {k: v.astype(np.float32) for k, v in res.items()}
    batch = _batch(8, padded_from=6)
    jtask = jax_ms.MMINTask(model=None, loss_group=JaxLosses.from_dict(LOSSES))
    ptask = ms.MMINTask(model=None, loss_group=LossFunctionGroup.from_dict(LOSSES))
    want = jax_ms._mmin_losses(jtask, {k: jnp.asarray(v) for k, v in res.items()},
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               stop_grad_fusion=train)
    pres = {k: _t(v).requires_grad_() for k, v in res.items()}
    got = ms.mmin_losses(ptask, pres, {k: _t(v) for k, v in batch.items()},
                         stop_grad_fusion=train)
    for name, w, p in zip(("ce", "mse", "cycle"), want, got):
        np.testing.assert_allclose(float(p.detach()), float(w), rtol=LOSS_TOL, err_msg=name)
    got[2].backward()
    assert (pres["fusion"].grad is None) == train
    assert pres["recon_cycle"].grad is not None


# -- train steps -----------------------------------------------------------------------

def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)


def _run_steps(kind):
    """mmtpu's and the port's steps from one set of weights. `teacher`: the
    frozen UttFusion teacher and a clip the gradients exceed, float32.
    `bn`: no teacher, a BatchNorm AE, float64."""
    dtype = np.float64 if kind == "bn" else np.float32
    jm, pm = _mmin(jax_build, use_bn=kind == "bn"), _mmin(build_module, use_bn=kind == "bn")
    v = _perturb(dict(jm.init({"params": RNG}, *_zeros())), 11)
    _carry(v, pm)
    jteacher = pteacher = tv = None
    clip = None
    if kind == "teacher":
        jteacher, pteacher = _teacher(jax_build), _teacher(build_module)
        tv = _perturb(dict(jteacher.init({"params": RNG}, *_zeros())), 12)
        _carry(tv, pteacher)
        clip = 0.05
    batches = [_batch(1), _batch(2), _batch(3, padded_from=5)]
    if dtype == np.float64:
        pm.double()
        batches = [{k: a.astype(np.float64) if a.dtype == np.float32 else a
                    for k, a in b.items()} for b in batches]
    jtask = jax_ms.MMINTask(model=jm, loss_group=JaxLosses.from_dict(LOSSES),
                            teacher_model=jteacher, teacher_variables=tv)
    ptask = ms.MMINTask(model=pm, loss_group=LossFunctionGroup.from_dict(LOSSES),
                        teacher_model=pteacher)
    pstate = common.make_state(pm, TrainingConfig.from_dict(TRAINING), clip=clip)
    ptrain = ms.make_mmin_train_step(ptask, pstate, CPU)
    teacher_before = ({k: t.clone() for k, t in pteacher.state_dict().items()}
                      if pteacher is not None else None)

    grads, raw, record, states = [], [], [], []
    real_apply = JaxTrainState.apply_gradients
    real_clip = step_mod.clip_by_global_norm

    def spy_apply(self, **kwargs):
        grads.append(jax.tree_util.tree_map(np.asarray, kwargs["grads"]))
        return real_apply(self, **kwargs)

    def spy_clip(params, max_norm):
        params = list(params)
        raw.append({id(p): p.grad.clone() for p in params})
        return real_clip(params, max_norm)

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxTrainState, "apply_gradients", spy_apply)
    mp.setattr(step_mod, "clip_by_global_norm", spy_clip)
    try:
        with jax.enable_x64(dtype == np.float64), jax.disable_jit():
            vv = _cast(v, dtype)
            jstate = jax_common.make_state(jm, vv["params"], vv.get("batch_stats", {}),
                                           JaxTrainingConfig.from_dict(TRAINING), clip=clip)
            jtrain = jax_ms.make_mmin_train_step(jtask)
            for i, b in enumerate(batches):
                jstate, jout = jtrain(jstate, {k: jnp.asarray(a) for k, a in b.items()}, RNG)
                pout = ptrain(b)
                record.append((jax.tree_util.tree_map(np.asarray, jout), pout,
                               {n: p.grad.clone() for n, p in pm.named_parameters()}))
                if i in (0, 2):
                    states.append((jax.tree_util.tree_map(np.asarray, (
                        jstate.params, jstate.batch_stats, jstate.opt_state)),
                        {k: t.clone() for k, t in pm.state_dict().items()},
                        {id(p): {k: s.clone() for k, s in st.items()}
                         for p, st in pstate.optimizer.state.items()}))
            eval_batch = batches[2]
            jev = jax_ms.make_mmin_eval_step(jtask)(
                jstate, {k: jnp.asarray(a) for k, a in eval_batch.items()})
            jev = jax.tree_util.tree_map(np.asarray, jev)
    finally:
        mp.undo()
    pev = ms.make_mmin_eval_step(ptask, CPU)(eval_batch)
    return {"record": record, "grads": grads, "raw": raw, "states": states,
            "pstate": pstate, "clip": clip, "eval": (jev, pev),
            "teacher": (teacher_before, pteacher, ptask, tv, jteacher, batches)}


_RUNS = {}


def _steps(kind):
    if kind not in _RUNS:
        _RUNS[kind] = _run_steps(kind)
    return _RUNS[kind]


@pytest.fixture(params=["teacher", "bn"])
def steps(request):
    return _steps(request.param)


def _norm(tree):
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                             for g in jax.tree_util.tree_leaves(tree))))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_train_step_losses_and_gradients_match_mmtpu(steps, k):
    jout, pout, pgrads = steps["record"][k]
    np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=TOL)
    assert list(pout["losses"]) == ["ce", "mse", "cycle"]
    assert set(jout["losses"]) == set(pout["losses"])
    for name in ("ce", "mse", "cycle"):
        np.testing.assert_allclose(float(pout["losses"][name]), float(jout["losses"][name]),
                                   rtol=TOL, atol=TOL * 1e-3, err_msg=name)
    ps = steps["pstate"]
    want = from_jax_variables(steps["grads"][k], target=ps.model, require_all=False)
    assert set(want) == set(pgrads)
    scale = 1.0
    if steps["clip"] is not None:
        norm = _norm(steps["grads"][k])
        assert norm > steps["clip"], norm  # the clip scales every step
        scale = steps["clip"] / norm
        raw = steps["raw"][k]
        for name, p in ps.model.named_parameters():  # before the clip
            w = want[name].double().numpy()
            err = np.abs(raw[id(p)].double().numpy() - w).max()
            assert err <= TOL * np.linalg.norm(w) + 1e-12, (name, err)
    for name, g in pgrads.items():
        w = want[name].double().numpy() * scale
        err = np.abs(g.double().numpy() - w).max()
        assert err <= TOL * np.linalg.norm(w) + 1e-12, (name, err, np.linalg.norm(w))
    for key in ("preds", "labels", "sample_mask", "pattern_id"):
        np.testing.assert_array_equal(np.asarray(pout[key]), np.asarray(jout[key]), key)


@pytest.mark.parametrize("which", [0, 1], ids=["after_step_1", "after_step_3"])
def test_state_matches_mmtpu(steps, which):
    (params, batch_stats, opt_state), got, moments = steps["states"][which]
    ps = steps["pstate"]
    want = from_jax_variables(params, batch_stats or None, target=ps.model)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].double().numpy(), w.double().numpy(), rtol=0,
                                   atol=TOL, err_msg=k)
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: type(x).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState"]
    assert len(adam) == 1
    names = {id(p): n for n, p in ps.model.named_parameters()}
    for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        tree = from_jax_variables(unflatten_dict(
            {p: np.asarray(v) for p, v in flatten_dict(getattr(adam[0], key)).items()}),
            target=ps.model, require_all=False)
        for pid, st in moments.items():
            np.testing.assert_allclose(st[torch_key].double().numpy(),
                                       tree[names[pid]].double().numpy(), rtol=0, atol=TOL,
                                       err_msg=f"{key} {names[pid]}")
    assert ps.step == 3


def test_eval_step_after_training_matches_mmtpu(steps):
    jev, pev = steps["eval"]
    assert set(pev) == set(jev)
    np.testing.assert_allclose(float(pev["loss"]), float(jev["loss"]), rtol=TOL)
    for key in ("preds", "labels", "sample_mask", "pattern_id"):
        np.testing.assert_array_equal(np.asarray(pev[key]), np.asarray(jev[key]), key)


def test_teacher_embeds_the_complement_and_stays_frozen():
    steps = _steps("teacher")
    before, teacher, task, tv, jteacher, batches = steps["teacher"]
    after = teacher.state_dict()
    assert set(before) == set(after)
    for k, t in before.items():
        assert torch.equal(after[k], t), k
    assert not teacher.training
    assert not any(p.requires_grad or p.grad is not None for p in teacher.parameters())
    model, opt = steps["pstate"].model, steps["pstate"].optimizer
    ids = {id(p) for p in teacher.parameters()}
    assert not ids & {id(p) for p in model.parameters()}
    assert not ids & {id(p) for g in opt.param_groups for p in g["params"]}
    assert not any(k.startswith(("teacher", "pretrained")) for k in model.state_dict())
    jtask = jax_ms.MMINTask(model=None, loss_group=JaxLosses.from_dict(LOSSES),
                            teacher_model=jteacher, teacher_variables=tv)
    for b in (batches[0], {k: a for k, a in batches[2].items() if k != "text_mask"}):
        want = jtask.teacher_embeddings({k: jnp.asarray(a) for k, a in b.items()})
        got = task.teacher_embeddings({k: _t(a) for k, a in b.items()})
        _close(got, want)
    # a modality without a mask key enters the teacher as zeros
    b = {k: a for k, a in batches[0].items() if k != "text_mask"}
    zeroed = {**b, "text": np.zeros_like(b["text"])}
    torch.testing.assert_close(task.teacher_embeddings({k: _t(a) for k, a in b.items()}),
                               task.teacher_embeddings({k: _t(a) for k, a in zeroed.items()}),
                               rtol=0, atol=0)
