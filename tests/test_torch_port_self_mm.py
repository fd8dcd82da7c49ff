"""The port's Self-MM (mmtpu_torch.models.self_mm, train.managers,
train.self_mm_step) against mmtpu's on the CPU, from the same numpy inputs
made from a seed and mmtpu's weights carried by `from_jax_variables`, at
tiny widths (AuViSubNet hidden 6, BERT hidden 16 with 1 layer and 2
heads, B = 8, T = 12, dropout 0):

- flax's `flip_sequences` with lengths < T, = 0 and > T (a rotation);
- AuViSubNet at 1 and 2 layers, uni- and bidirectional, without lengths
  and with lengths ≤ T, = 0 and > T (clamped, with no gradient through the
  clamp): outputs at 1e-5, gradients of the parameters and the input at
  1e-4; the two directions of a layer are one G=2 call of the recurrence;
- `Self_MM`'s output dict, every entry, at 1e-5 (text lengths from the
  mask row, an all-zero mask counting as 50 > T);
- every `ManagerState` method: the label and feature banks bit for bit
  through a padded batch whose tail aliases sample 0, the centers (keyed
  by the TEXT labels, the reference's quirk) at 1e-6;
- three train steps (the third with a zero-padded tail) in epoch 1, and
  one in epoch 1 then two in epoch 2 (the refinement from the centers),
  with a frozen BERT under coupled L2 and with a fine-tuned one: the loss
  at 1e-5 relative, gradients within 1e-5 of each parameter's norm,
  parameters (the frozen BERT's moved by the L2 term in both packages),
  Adam's moments and the banks after steps 1 and 3 at 1e-5; the eval step
  after them.

mmtpu's steps return no gradients: they are read from its
`TrainState.apply_gradients` with jit disabled. Adam runs at eps 1e-3 (see
tests/test_torch_port_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen.recurrent import flip_sequences as flax_flip
from flax.traverse_util import flatten_dict, unflatten_dict

from mmtpu.cli import common as jax_common
from mmtpu.config.training import TrainingConfig as JaxTrainingConfig
from mmtpu.models.registry import build_module as jax_build
from mmtpu.train import managers as jax_managers
from mmtpu.train import self_mm_step as jax_step
from mmtpu.train.state import TrainState as JaxTrainState
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.cli import common
from mmtpu_torch.config.training import TrainingConfig
from mmtpu_torch.models import build_module
from mmtpu_torch.models.lstm import flip_sequences
from mmtpu_torch.ops import lstm as lstm_ops
from mmtpu_torch.train import managers
from mmtpu_torch.train import self_mm_step as step

CPU = torch.device("cpu")
TOL = 1e-5
GRAD_TOL = 1e-4
RNG = jax.random.PRNGKey(0)
B, T, N = 8, 12, 24
DIMS = {"multimodal": 10, "audio": 4, "video": 6, "text": 8}
TRAINING = {"epochs": 2, "num_modalities": 3,
            "optimizer": {"name": "Adam", "default_kwargs": {"lr": 1e-3, "weight_decay": 1e-3,
                                                             "eps": 1e-3}},
            "loss_functions": {"l1": {"loss_name": "l1", "weight": 1.0}}}
LENGTHS = np.array([5, 12, 0, 50, 1, 3, 12, 20], np.int32)  # ≤ T, = 0, > T


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got, np.float64),
                               np.asarray(want, np.float64), rtol=tol, atol=tol, err_msg=msg)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("lengths", [None, LENGTHS], ids=["no_lengths", "lengths"])
def test_flip_sequences_matches_flax(lengths):
    x = np.random.default_rng(0).normal(size=(B, T, 3)).astype(np.float32)
    want = np.asarray(flax_flip(jnp.asarray(x), None if lengths is None else jnp.asarray(lengths),
                                num_batch_dims=1, time_major=False))
    got = flip_sequences(_t(x), None if lengths is None else _t(lengths))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        flip_sequences(got, None if lengths is None else _t(lengths)).numpy(), x)


# -- AuViSubNet -------------------------------------------------------------------

SUBNET_CASES = {"1l_uni": (1, False), "1l_bi": (1, True), "2l_uni": (2, False),
                "2l_bi": (2, True)}


@pytest.mark.parametrize("with_lengths", [False, True], ids=["no_lengths", "lengths"])
@pytest.mark.parametrize("case", list(SUBNET_CASES))
def test_auvi_subnet_forward_and_gradients_match_mmtpu(case, with_lengths):
    layers, bi = SUBNET_CASES[case]
    kw = dict(in_size=5, hidden_size=6, out_size=7, num_layers=layers, dropout=0.0,
              bidirectional=bi)
    jm, pm = jax_build("auvi_subnet", **kw), build_module("auvi_subnet", **kw)
    g = np.random.default_rng(1)
    x = g.normal(size=(B, T, 5)).astype(np.float32)
    lengths = LENGTHS if with_lengths else None
    jl = None if lengths is None else jnp.asarray(lengths)
    v = _np(jm.init({"params": RNG}, jnp.asarray(x), jl))
    pm.load_state_dict(from_jax_variables(v["params"], target=pm), strict=True)
    cot = g.normal(size=(B, 7)).astype(np.float32)

    def jloss(params, x):
        return jnp.sum(jm.apply({"params": params}, x, jl) * cot)

    want_out = np.asarray(jm.apply(v, jnp.asarray(x), jl))
    jg_params, jg_x = jax.grad(jloss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    xt = _t(x).requires_grad_()
    out = pm(xt, None if lengths is None else _t(lengths))
    _close(out, want_out)
    (out * _t(cot)).sum().backward()
    _close(xt.grad, np.asarray(jg_x), GRAD_TOL, "input")
    want = from_jax_variables(_np(jg_params), target=pm)
    for name, p in pm.named_parameters():
        _close(p.grad, want[name].numpy(), GRAD_TOL, name)


def test_bidirectional_layer_is_one_g2_call(monkeypatch):
    pm = build_module("auvi_subnet", in_size=5, hidden_size=6, out_size=7, num_layers=2,
                      dropout=0.0, bidirectional=True)
    calls = []
    real = lstm_ops.lstm_stacked_reference

    def spy(xw, wh, *args, **kwargs):
        calls.append(len(xw))
        return real(xw, wh, *args, **kwargs)

    monkeypatch.setattr(lstm_ops, "lstm_stacked_reference", spy)
    pm(torch.zeros(2, 4, 5), torch.tensor([2, 9]))
    assert calls == [2, 2]


# -- Self_MM ---------------------------------------------------------------------

def _self_mm(build, text=None):
    text = text or build("bert_text_encoder", pretrained_path="", hidden_size=16,
                         num_hidden_layers=1, num_attention_heads=2)
    return build(
        "self_mm",
        audio_encoder=build("auvi_subnet", in_size=5, hidden_size=6, out_size=6, dropout=0.0),
        video_encoder=build("auvi_subnet", in_size=20, hidden_size=6, out_size=6, dropout=0.0,
                            bidirectional=True),
        text_encoder=text, need_data_aligned=False, audio_out=6, video_out=6, text_out=16,
        post_fusion_dropout=0.0, post_fusion_dim=DIMS["multimodal"], post_text_dropout=0.0,
        post_text_dim=DIMS["text"], post_audio_dropout=0.0, post_audio_dim=DIMS["audio"],
        post_video_dropout=0.0, post_video_dim=DIMS["video"], H=3.0)


def _batch(seed, first, padded_from=None):
    g = np.random.default_rng(seed)
    text = np.zeros((B, 3, T), np.float32)
    text[:, 0] = g.integers(1, 100, (B, T))
    for i, n in enumerate((12, 7, 0, 12, 3, 12, 9, 12)):  # mask lengths; 0 → 50 > T
        text[i, 1, :n] = 1.0
    text[5, 2, 6:] = 1.0
    idx = np.arange(first, first + B, dtype=np.int32)
    mask = np.ones(B, np.float32)
    if padded_from is not None:
        mask[padded_from:] = 0.0
        idx[padded_from:] = 0  # the loader's padded rows alias sample 0
    return {"audio": g.normal(size=(B, T, 5)).astype(np.float32),
            "video": g.normal(size=(B, T, 20)).astype(np.float32),
            "text": text, "labels": g.uniform(-3, 3, B).astype(np.float32),
            "sample_idx": idx, "sample_mask": mask, "pattern_id": np.zeros(B, np.int32)}


def _zeros():
    b = _batch(0, 0)
    return ((jnp.asarray(b["audio"]), None), (jnp.asarray(b["video"]), None),
            jnp.asarray(b["text"]))


def test_self_mm_forward_matches_mmtpu():
    jm, pm = _self_mm(jax_build), _self_mm(build_module)
    v = _np(jm.init({"params": RNG}, *_zeros(), train=False))
    pm.load_state_dict(from_jax_variables(v["params"], target=pm), strict=True)
    b = _batch(5, 0)
    want = jm.apply(v, (jnp.asarray(b["audio"]), None), (jnp.asarray(b["video"]), None),
                    jnp.asarray(b["text"]), train=False)
    got = pm.eval()((_t(b["audio"]), None), (_t(b["video"]), None), _t(b["text"]))
    assert {g: set(d) for g, d in got.items()} == {g: set(d) for g, d in want.items()}
    for g in want:
        for k in want[g]:
            _close(got[g][k], np.asarray(want[g][k]), msg=f"{g}/{k}")


# -- the banks ----------------------------------------------------------------------

def test_manager_state_methods_match_mmtpu():
    g = np.random.default_rng(3)
    jm = jax_managers.ManagerState.create(N, DIMS)
    pm = managers.ManagerState.create(N, DIMS)
    for a, b in ((jm.features, pm.features), (jm.labels, pm.labels),
                 (jm.centers_pos, pm.centers_pos), (jm.centers_neg, pm.centers_neg)):
        assert {k: tuple(v.shape) for k, v in a.items()} == {
            k: tuple(v.shape) for k, v in b.items()}
    labels = g.uniform(-3, 3, N).astype(np.float32)
    labels[4] = 0.0  # excluded from both centers
    idx = np.arange(N, dtype=np.int32)
    jm = jm.init_labels(jnp.asarray(idx), jnp.asarray(labels))
    pm.init_labels(_t(idx), _t(labels))
    b = _batch(4, 16, padded_from=5)
    sel = _t(b["sample_idx"])
    for m in ("audio", "video", "text"):
        new = g.uniform(-3, 3, B).astype(np.float32)
        jm = jm.update_labels(m, jnp.asarray(b["sample_idx"]), jnp.asarray(new),
                              sample_mask=jnp.asarray(b["sample_mask"]))
        pm.update_labels(m, sel, _t(new), sample_mask=_t(b["sample_mask"]))
        np.testing.assert_array_equal(pm.get_labels(m, sel).numpy(),
                                      np.asarray(jm.get_labels(m, jnp.asarray(b["sample_idx"]))))
    feats = {m: g.normal(size=(B, d)).astype(np.float32) for m, d in DIMS.items()}
    for batch in (_batch(6, 0), b):
        jm = jm.update_features({m: jnp.asarray(f) for m, f in feats.items()},
                                jnp.asarray(batch["sample_idx"]),
                                sample_mask=jnp.asarray(batch["sample_mask"]))
        pm.update_features({m: _t(f) for m, f in feats.items()}, _t(batch["sample_idx"]),
                           sample_mask=_t(batch["sample_mask"]))
    for m in DIMS:  # bit for bit: sample 0 kept its value through the aliasing rows
        np.testing.assert_array_equal(pm.labels[m].numpy(), np.asarray(jm.labels[m]), m)
        np.testing.assert_array_equal(pm.features[m].numpy(), np.asarray(jm.features[m]), m)
    np.testing.assert_array_equal(pm.features["audio"][0].numpy(), feats["audio"][0])
    jm = jm.update_centers()
    pm.update_centers()
    for m in DIMS:
        _close(pm.centers_pos[m], np.asarray(jm.centers_pos[m]), 1e-6, m)
        _close(pm.centers_neg[m], np.asarray(jm.centers_neg[m]), 1e-6, m)
    text = pm.labels["text"].numpy()  # the quirk: audio's centers by the text labels
    _close(pm.centers_pos["audio"], pm.features["audio"].numpy()[text > 0].mean(0), 1e-6)


# -- train and eval steps -------------------------------------------------------------

def _bert_dir(tmp_path_factory):
    """An HF directory (dropouts 0) both packages read: the fine-tuned case."""
    from transformers import BertConfig as HFConfig
    from transformers import BertModel as HFBert

    root = tmp_path_factory.mktemp("bert")
    torch.manual_seed(0)
    HFBert(HFConfig(vocab_size=100, hidden_size=16, num_hidden_layers=1,
                    num_attention_heads=2, intermediate_size=32, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)).save_pretrained(
        root / "bert", safe_serialization=False)
    return str(root / "bert")


def _run_steps(kind, bert_path=None):
    """Three steps in both packages from one set of weights. `epoch1`: all
    at epoch 1; `epoch2`: step 1 at epoch 1, steps 2 and 3 at epoch 2;
    `finetune`: epoch2's schedule with BERT fine-tuned."""
    text_kw = dict(pretrained_path=bert_path or "", hidden_size=16, num_hidden_layers=1,
                   num_attention_heads=2, use_finetune=kind == "finetune")
    jm = _self_mm(jax_build, jax_build("bert_text_encoder", **text_kw))
    pm = _self_mm(build_module, build_module("bert_text_encoder", **text_kw))
    v = _np(jm.init({"params": RNG}, *_zeros(), train=False))
    pm.load_state_dict(from_jax_variables(v["params"], target=pm), strict=True)
    batches = [_batch(11, 0), _batch(12, 8), _batch(13, 16, padded_from=5)]
    epochs = [1, 1, 1] if kind == "epoch1" else [1, 2, 2]
    labels = np.random.default_rng(7).uniform(-3, 3, N).astype(np.float32)
    jmgr = jax_managers.ManagerState.create(N, DIMS).init_labels(
        jnp.arange(N), jnp.asarray(labels))
    pmgr = managers.ManagerState.create(N, DIMS).init_labels(torch.arange(N), _t(labels))
    jtask = jax_step.SelfMMTask(model=jm, need_data_aligned=False)
    ptask = step.SelfMMTask(model=pm, need_data_aligned=False)
    pstate = common.make_state(pm, TrainingConfig.from_dict(TRAINING))
    ptrain = step.make_self_mm_train_step(ptask, pstate, CPU)
    grads, record = [], []
    real_apply = JaxTrainState.apply_gradients

    def spy_apply(self, **kwargs):
        grads.append(_np(kwargs["grads"]))
        return real_apply(self, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxTrainState, "apply_gradients", spy_apply)
    try:
        with jax.disable_jit():
            jstate = jax_common.make_state(jm, v["params"], {},
                                           JaxTrainingConfig.from_dict(TRAINING))
            jtrain = jax_step.make_self_mm_train_step(jtask)
            for b, e in zip(batches, epochs):
                jstate, jmgr, jout = jtrain(jstate, jmgr, {k: jnp.asarray(a)
                                                           for k, a in b.items()},
                                            RNG, jnp.asarray(e))
                pout = ptrain(pmgr, b, e)
                record.append({
                    "out": (_np(jout), pout),
                    "grads": {n: p.grad.clone() for n, p in pm.named_parameters()},
                    "params": (_np(jstate.params), {k: t.clone()
                                                    for k, t in pm.state_dict().items()}),
                    "opt": (_np(jstate.opt_state), {id(p): {k: s.clone() for k, s in st.items()}
                                                    for p, st in pstate.optimizer.state.items()}),
                    "banks": (_np(jmgr), {f: {m: t.clone() for m, t in getattr(pmgr, f).items()}
                                          for f in ("features", "labels", "centers_pos",
                                                    "centers_neg")}),
                })
            jev = _np(jax_step.make_self_mm_eval_step(jtask)(
                jstate, {k: jnp.asarray(a) for k, a in batches[2].items()}))
    finally:
        mp.undo()
    pev = step.make_self_mm_eval_step(ptask, CPU)(batches[2])
    return {"record": record, "grads": grads, "pstate": pstate, "eval": (jev, pev),
            "init": v}


_RUNS = {}


@pytest.fixture(params=["epoch1", "epoch2", "finetune"])
def steps(request, tmp_path_factory):
    kind = request.param
    if kind not in _RUNS:
        _RUNS[kind] = _run_steps(kind, _bert_dir(tmp_path_factory) if kind == "finetune"
                                 else None)
    return _RUNS[kind]


@pytest.mark.parametrize("k", [0, 1, 2])
def test_train_step_loss_and_gradients_match_mmtpu(steps, k):
    rec = steps["record"][k]
    jout, pout = rec["out"]
    np.testing.assert_allclose(float(pout["loss"]), float(jout["loss"]), rtol=TOL)
    ps = steps["pstate"]
    want = from_jax_variables(steps["grads"][k], target=ps.model, require_all=False)
    assert set(want) == set(rec["grads"])
    whole = np.sqrt(sum(np.square(w.double().numpy()).sum() for w in want.values()))
    for name, g in rec["grads"].items():
        w = want[name].double().numpy()
        err = np.abs(g.double().numpy() - w).max()
        # the key biases' exact gradient is 0 (softmax ignores a shift along
        # the keys): both packages' values are rounding, held to the whole
        scale = whole if name.endswith("attention.self.key.bias") else np.linalg.norm(w)
        assert err <= TOL * scale + 1e-12, (name, err, np.linalg.norm(w))
    for key in ("preds", "labels", "sample_mask", "pattern_id"):
        _close(pout[key], np.asarray(jout[key]), msg=key)


def _adam_moments(opt_state):
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: type(x).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState"]
    assert len(adam) == 1
    return adam[0]


@pytest.mark.parametrize("k", [0, 2], ids=["after_step_1", "after_step_3"])
def test_parameters_moments_and_banks_match_mmtpu(steps, k):
    rec = steps["record"][k]
    ps = steps["pstate"]
    jparams, got = rec["params"]
    want = from_jax_variables(jparams, target=ps.model)
    for name, w in want.items():
        _close(got[name], w.numpy(), msg=name)
    bert = "text_encoder.bert.encoder.layer.0.output.dense.weight"
    init = from_jax_variables(steps["init"]["params"], target=ps.model)[bert]
    assert not torch.equal(got[bert], init)  # moved by the L2 term even when frozen
    jopt, moments = rec["opt"]
    adam = _adam_moments(jopt)
    names = {id(p): n for n, p in ps.model.named_parameters()}
    for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        tree = from_jax_variables(unflatten_dict(
            {p: np.asarray(v) for p, v in flatten_dict(getattr(adam, key)).items()}),
            target=ps.model, require_all=False)
        for pid, st in moments.items():
            _close(st[torch_key], tree[names[pid]].numpy(), msg=f"{key} {names[pid]}")
    jbanks, pbanks = rec["banks"]
    for field, banks in pbanks.items():
        for m, t in banks.items():
            _close(t, np.asarray(getattr(jbanks, field)[m]), msg=f"{field} {m}")


def test_eval_step_after_training_matches_mmtpu(steps):
    jev, pev = steps["eval"]
    assert set(pev) == set(jev)
    np.testing.assert_allclose(float(pev["loss"]), float(jev["loss"]), rtol=TOL)
    for key in ("preds", "labels", "sample_mask", "pattern_id"):
        _close(pev[key], np.asarray(jev[key]), msg=key)


def test_frozen_bert_takes_no_gradient_but_stays_in_the_optimizer():
    pm = _self_mm(build_module)
    state = common.make_state(pm, TrainingConfig.from_dict(TRAINING))
    bert = list(pm.text_encoder.parameters())
    held = {id(p) for group in state.optimizer.param_groups for p in group["params"]}
    assert {id(p) for p in bert} <= held
    task = step.SelfMMTask(model=pm, need_data_aligned=False)
    mgr = managers.ManagerState.create(N, DIMS)
    step.make_self_mm_train_step(task, state, CPU)(mgr, _batch(1, 0), 1)
    assert all(p.grad is not None and not p.grad.any() for p in bert)
