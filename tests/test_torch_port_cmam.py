"""The port's C-MAM (mmtpu_torch.train.cmam_loss, models.cmam,
train.cmam_step, the AVMNIST embedding switches, the regression metrics)
against mmtpu's on the CPU, from the same numpy inputs made from a seed and
mmtpu's weights carried by `from_jax_variables`, at tiny widths:

- every `CMAMLoss` term (cosine, MAE, MSE, MMD, moment matching, cyclic
  through a given `forward_func`, MI with mmtpu's permutation handed in, the
  `ce`/`bce`/`mse` classification term), with and without a sample mask:
  1e-6 relative;
- `AssociationNetwork`, `CMAM` (concat, sum, mean) and `DualCMAM` eval
  forwards, and `AVMNIST` with embedding inputs, a missing input and
  `fused_head=False`: 1e-5;
- three train steps, the third with a zero-padded tail, of a `CMAMTask`
  (an MNIST-encoder AVMNIST teacher and an MNIST-encoder student with a
  BatchNorm association network, float64 on both sides: flax's float32
  BatchNorm variance E[x²] − E[x]² would put mmtpu's own gradients ~1e-3 of
  their norm from exact) and of a `DualCMAMTask` (a UttFusion teacher, the
  student's LSTM through the plain scan, float32): loss and each term 1e-5
  relative, gradients within 1e-5 of each parameter's norm, then
  parameters, Adam's moments and BatchNorm statistics 1e-5; the eval step
  after them; the teacher's state dict bitwise unchanged;
- `load_pretrained_encoder_state_for` copies parameters and leaves the
  C-MAM's BatchNorm statistics, as mmtpu's `train_cmam` does;
- `mean_squared_error` / `mean_absolute_error` against sklearn, bit for bit.

mmtpu's C-MAM steps return no gradients: they are read from its
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
from mmtpu.train import cmam_loss as jax_cl
from mmtpu.train import cmam_step as jax_cs
from mmtpu.train.state import TrainState as JaxTrainState
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.cli import common
from mmtpu_torch.cli.train_cmam import copy_encoder_parameters
from mmtpu_torch.config.training import TrainingConfig
from mmtpu_torch.metrics import classification as port_metrics
from mmtpu_torch.models import build_module
from mmtpu_torch.train import cmam_loss as cl
from mmtpu_torch.train import cmam_step as cs

CPU = torch.device("cpu")
LOSS_TOL = 1e-6
TOL = 1e-5
RNG = jax.random.PRNGKey(0)


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


# -- CMAMLoss -------------------------------------------------------------------

B, D, D2, C = 9, 6, 5, 4
MASK = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], np.float32)
LOSS_CASES = {
    "ce": {"cls_weight": 0.3, "cls_loss_type": "ce"},
    "bce": {"cls_weight": 0.3, "cls_loss_type": "bce"},
    "mse": {"cls_weight": 0.3, "cls_loss_type": "mse"},
    "mmd_moments": {"mmd_weight": 0.7, "moment_weight": 0.4, "num_moments": 3,
                    "mmd_sigma": 1.5, "cls_weight": 0.0},
    "cyclic": {"cyclic_weight": 0.6, "cls_weight": 0.0},
    "mi": {"mi_weight": 0.2, "cls_weight": 0.0},
    "all": {"cosine_weight": 0.5, "mae_weight": 2.0, "mse_weight": 0.25, "mmd_weight": 0.3,
            "moment_weight": 0.2, "cyclic_weight": 0.4, "mi_weight": 0.1, "cls_weight": 0.2,
            "rec_weight": 3.0, "maximize_cosine": False},
}


def _loss_inputs(seed, cls_type):
    g = np.random.default_rng(seed)
    p = g.normal(size=(B, D)).astype(np.float32)
    out = {"predictions": p,
           "targets": (g.normal(size=(B, D)) + 0.5 * p).astype(np.float32),
           "originals": g.normal(size=(B, D2)).astype(np.float32),
           "cls_logits": g.normal(size=(B, C)).astype(np.float32)}
    if cls_type == "ce":
        out["cls_labels"] = g.integers(0, C, size=B).astype(np.int64)
    elif cls_type == "bce":
        out["cls_labels"] = (g.uniform(size=(B, C)) < 0.4).astype(np.float32)
    else:
        out["cls_labels"] = g.normal(size=(B, C)).astype(np.float32)
    w = g.normal(size=(D, D2)).astype(np.float32) / 3
    a = g.normal(size=(D2, D)).astype(np.float32) / 3
    return out, w, a


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_cmam_loss_terms_match_mmtpu(case, masked):
    kwargs = LOSS_CASES[case]
    inputs, w, a = _loss_inputs(len(case), kwargs.get("cls_loss_type", "ce"))
    mask = MASK if masked else None
    rng = jax.random.PRNGKey(3)
    perm = np.asarray(jax.random.permutation(rng, B))
    want = jax_cl.CMAMLoss(**kwargs)(
        **{k: jnp.asarray(v) for k, v in inputs.items()},
        reconstructed=jnp.asarray(inputs["predictions"]),
        forward_func=lambda r: r @ jnp.asarray(w),
        mi_critic=lambda o, p: jnp.tanh((o @ jnp.asarray(a)) * p).sum(-1),
        rng=rng, sample_mask=None if mask is None else jnp.asarray(mask))
    got = cl.CMAMLoss(**kwargs)(
        **{k: _t(v) for k, v in inputs.items()},
        reconstructed=_t(inputs["predictions"]),
        forward_func=lambda r: r @ _t(w),
        mi_critic=lambda o, p: torch.tanh((o @ _t(a)) * p).sum(-1),
        perm=_t(perm), sample_mask=None if mask is None else _t(mask))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_TOL,
                                   atol=LOSS_TOL * 1e-2, err_msg=k)
    if case == "all":
        assert set(want) == {"cosine", "mae", "mse", "mmd", "moment_loss", "cyclic_loss",
                             "mi_loss", "cls_loss", "total_loss"}


def test_mi_term_draws_from_the_given_generator_only():
    """Without a generator or a permutation the MI term raises, as mmtpu's
    does without a key; with one, two generators of one seed give one loss,
    and torch's global generator is not drawn."""
    inputs, _, a = _loss_inputs(0, "ce")
    loss = cl.CMAMLoss(mi_weight=0.5, cls_weight=0.0)
    args = {k: _t(v) for k, v in inputs.items() if k in ("predictions", "targets",
                                                        "originals")}

    def critic(o, p):
        return torch.tanh((o @ _t(a)) * p).sum(-1)

    with pytest.raises(ValueError, match="Generator"):
        loss(**args, mi_critic=critic)
    state = torch.get_rng_state()
    values = [float(loss(**args, mi_critic=critic,
                         generator=torch.Generator().manual_seed(7))["mi_loss"])
              for _ in range(2)]
    assert values[0] == values[1]
    assert torch.equal(state, torch.get_rng_state())


def test_cls_loss_type_is_checked():
    with pytest.raises(ValueError, match="cls_loss_type"):
        cl.CMAMLoss(cls_loss_type="hinge")
    with pytest.raises(ValueError, match="cls_loss_type"):
        jax_cl.CMAMLoss(cls_loss_type="hinge")


# -- modules ---------------------------------------------------------------------

def _conv_args(c1, c2):
    names = ("conv_block_one_one_args", "conv_block_one_two_args",
             "conv_block_two_one_args", "conv_block_two_two_args")
    args = [{"conv_one_in": 1, "conv_one_out": c1}, {"conv_one_in": c1, "conv_one_out": c1},
            {"conv_one_in": c1, "conv_one_out": c2}, {"conv_one_in": c2, "conv_one_out": c2}]
    return dict(zip(names, args))


def _mnist(build, modality, hidden, c1=3, c2=4, **extra):
    return build(f"mnist_{modality}", hidden_dim=hidden, **_conv_args(c1, c2), **extra)


def _avmnist(build, audio=6, image=8, hidden=12):
    return build("avmnist", audio_encoder=_mnist(build, "audio", audio),
                 image_encoder=_mnist(build, "image", image), hidden_dim=hidden, dropout=0.0)


def _av_inputs(seed, n=5):
    g = np.random.default_rng(seed)
    return (g.normal(size=(n, 32, 94)).astype(np.float32),
            g.normal(size=(n, 28, 28, 1)).astype(np.float32))


@pytest.mark.parametrize("batch_norm", [False, True], ids=["plain", "bn"])
def test_association_network_eval_matches_mmtpu(batch_norm):
    kw = {"input_size": 6, "hidden_size": 10, "output_size": 4, "batch_norm": batch_norm,
          "dropout": 0.25}
    jm, pm = jax_build("association_network", **kw), build_module("association_network", **kw)
    x = np.random.default_rng(1).normal(size=(7, 6)).astype(np.float32)
    v = _perturb(dict(jm.init({"params": RNG}, jnp.asarray(x))), 2)
    _carry(v, pm).eval()
    want = jm.apply(v, jnp.asarray(x), train=False)
    np.testing.assert_allclose(pm(_t(x)).detach().numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _cmam_pair(fusion_fn):
    width = 6 if fusion_fn == "concat" else 5
    assoc = {"input_size": 2 * width if fusion_fn == "concat" else width,
             "hidden_size": 10, "output_size": 8, "batch_norm": True}
    models = []
    for build in (jax_build, build_module):
        models.append(build("cmam", input_encoders={"image": _mnist(build, "image", width),
                                                    "audio": _mnist(build, "audio", width)},
                            association_network=dict(assoc), target_modality="text",
                            fusion_fn=fusion_fn))
    return models


@pytest.mark.parametrize("fusion_fn", ["concat", "sum", "mean"])
def test_cmam_eval_matches_mmtpu(fusion_fn):
    jm, pm = _cmam_pair(fusion_fn)
    audio, image = _av_inputs(3)
    jin = {"audio": jnp.asarray(audio), "image": jnp.asarray(image)}
    v = _perturb(dict(jm.init({"params": RNG}, jin)), 4)
    assert {"input_encoders_audio", "input_encoders_image", "assoc"} <= set(v["params"])
    _carry(v, pm).eval()
    assert list(pm.input_encoders) == ["image", "audio"]  # run in sorted order all the same
    want = jm.apply(v, jin, train=False)
    got = pm({"audio": _t(audio), "image": _t(image)})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_unknown_fusion_fn_raises_in_both():
    jm, pm = _cmam_pair("max")
    audio, image = _av_inputs(3)
    with pytest.raises(ValueError, match="Unknown fusion function"):
        jm.init({"params": RNG}, {"audio": jnp.asarray(audio), "image": jnp.asarray(image)})
    with pytest.raises(ValueError, match="Unknown fusion function"):
        pm({"audio": _t(audio), "image": _t(image)})


def _lstm(build, input_size, hidden):
    return build("lstmencoder", input_size=input_size, hidden_size=hidden, embd_method="last")


def _dual(build, dropout=0.0):
    return build("dual_cmam", input_encoder={"audio": _lstm(build, 5, 8)},
                 shared_encoder_output_size=8, decoder_hidden_size=12,
                 target_modality_one_embd_size=7, target_modality_two_embd_size=9,
                 input_modality="audio", target_modality_one="video",
                 target_modality_two="text", dropout=dropout)


def test_dual_cmam_eval_matches_mmtpu():
    jm, pm = _dual(jax_build, 0.1), _dual(build_module, 0.1)
    x = np.random.default_rng(5).normal(size=(4, 6, 5)).astype(np.float32)
    v = _perturb(dict(jm.init({"params": RNG}, jnp.asarray(x))), 6)
    # flax names the one-entry mapping's module by its attribute
    assert set(v["params"]) == {"input_encoder_audio", "decoder_one_fc_0", "decoder_one_fc_1",
                                "decoder_two_fc_0", "decoder_two_fc_1"}
    _carry(v, pm).eval()
    want = jm.apply(v, jnp.asarray(x), train=False)
    got = pm(_t(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_cmam_dropout_draws_from_its_generator_only():
    """Train-mode dropout without a generator raises; with one, the masks
    repeat with its seed and torch's global generator is not drawn."""
    from mmtpu_torch.models.cmam import use_generator

    pm = _dual(build_module, 0.5).train()
    x = torch.randn(4, 6, 5)
    with pytest.raises(RuntimeError, match="Generator"):
        pm(x)
    state = torch.get_rng_state()
    outs = [use_generator(pm, torch.Generator().manual_seed(3))(x)[0] for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(state, torch.get_rng_state())
    assert torch.equal(pm.eval()(x)[0], pm(x)[0])


AVMNIST_CALLS = {
    "embedding_A": lambda a, i, ea, ei: ((ea, i), {"is_embd_A": True}),
    "embedding_I": lambda a, i, ea, ei: ((a, ei), {"is_embd_I": True}),
    "missing_A": lambda a, i, ea, ei: ((None, i), {"is_embd_A": True}),
    "missing_I": lambda a, i, ea, ei: ((a, None), {"is_embd_I": True}),
    "plain_head": lambda a, i, ea, ei: ((a, i), {"fused_head": False}),
}


@pytest.mark.parametrize("call", sorted(AVMNIST_CALLS))
def test_avmnist_embedding_switches_match_mmtpu(call):
    jm, pm = _avmnist(jax_build), _avmnist(build_module)
    audio, image = _av_inputs(7)
    g = np.random.default_rng(8)
    emb_a, emb_i = (g.normal(size=(5, n)).astype(np.float32) for n in (6, 8))
    v = _perturb(dict(jm.init({"params": RNG}, jnp.asarray(audio), jnp.asarray(image))), 9)
    _carry(v, pm).eval()
    (ja, ji), kw = AVMNIST_CALLS[call](*(jnp.asarray(x) for x in (audio, image, emb_a, emb_i)))
    (pa, pi), _ = AVMNIST_CALLS[call](*(_t(x) for x in (audio, image, emb_a, emb_i)))
    want = jm.apply(v, ja, ji, train=False, **kw)
    got = pm(pa, pi, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)


# -- train steps -------------------------------------------------------------------

TRAINING = {
    "epochs": 1, "num_modalities": 2,
    "optimizer": {"name": "Adam", "default_kwargs": {"lr": 1e-3, "weight_decay": 1e-4,
                                                     "eps": 1e-3}},
    "loss_functions": {},
}
LOSS_KWARGS = {"cls_weight": 0.05, "mmd_weight": 0.1}


def _av_batch(seed, n=6, padded_from=None):
    g = np.random.default_rng(seed)
    labels = g.integers(0, 10, size=n).astype(np.int64)
    audio, image = _av_inputs(seed + 100, n)
    batch = {"audio": (audio + 0.3 * labels[:, None, None]).astype(np.float32),
             "image": (image + 0.3 * labels[:, None, None, None]).astype(np.float32),
             "audio_mask": np.ones(n, np.float32), "image_mask": np.ones(n, np.float32),
             "labels": labels, "pattern_id": np.zeros(n, np.int32),
             "sample_mask": np.ones(n, np.float32)}
    batch["image_mask"][2] = 0.0
    if padded_from is not None:
        for k in ("audio", "image", "labels", "audio_mask", "image_mask", "sample_mask"):
            batch[k][padded_from:] = 0
    return batch


def _utt_batch(seed, n=8, T=6, padded_from=None):
    g = np.random.default_rng(seed)
    labels = g.integers(0, 3, size=n).astype(np.int64)
    batch = {k: (g.normal(size=(n, T, w)) + 0.3 * labels[:, None, None]).astype(np.float32)
             for k, w in (("audio", 5), ("video", 20), ("text", 16))}
    for k in ("audio", "video", "text"):
        batch[f"{k}_mask"] = np.ones(n, np.float32)
    batch["video_mask"][1::4] = 0.0
    batch["text_mask"][2::4] = 0.0
    batch.update(labels=labels, pattern_id=np.zeros(n, np.int32),
                 sample_mask=np.ones(n, np.float32),
                 audio_lengths=np.full(n, 3, np.int32))  # ignored on this path, as in mmtpu
    if padded_from is not None:
        for k in ("audio", "video", "text", "audio_mask", "video_mask", "text_mask",
                  "labels", "sample_mask"):
            batch[k][padded_from:] = 0
    return batch


def _float64(batch):
    return {k: a.astype(np.float64) if a.dtype == np.float32 else a for k, a in batch.items()}


def _utt_base(build):
    return build("utt_fusion", netA=_lstm(build, 5, 8), netV=_lstm(build, 20, 7),
                 netT=build("textcnn", input_size=16, embd_size=9, out_channels=4),
                 netC=build("fcclassifier", input_dim=24, layers=[16], output_dim=3,
                            dropout=0.0))


def _setup(kind):
    """mmtpu's and the port's task, state and batches, from one set of weights."""
    if kind == "cmam":
        base_j, base_p = _avmnist(jax_build), _avmnist(build_module)
        batches = [_float64(b) for b in (_av_batch(1), _av_batch(2),
                                         _av_batch(3, padded_from=4))]
        base_v = _perturb(dict(base_j.init({"params": RNG}, jnp.zeros((2, 32, 94)),
                                           jnp.zeros((2, 28, 28, 1)))), 11)
        assoc = {"input_size": 6, "hidden_size": 10, "output_size": 8, "batch_norm": True}
        cm_j, cm_p = (build("cmam", input_encoders={"audio": _mnist(build, "audio", 6)},
                            association_network=dict(assoc), target_modality="image")
                      for build in (jax_build, build_module))
        cm_v = _perturb(dict(cm_j.init({"params": RNG}, {"audio": jnp.zeros((2, 32, 94))})), 12)
        extra = {"input_modalities": ["audio"], "target_modality": "image",
                 "base_model_type": "avmnist"}
        classes = (jax_cs.CMAMTask, cs.CMAMTask)
        builders = ((jax_cs.make_cmam_train_step, jax_cs.make_cmam_eval_step),
                    (cs.make_cmam_train_step, cs.make_cmam_eval_step))
    else:
        base_j, base_p = _utt_base(jax_build), _utt_base(build_module)
        batches = [_utt_batch(1), _utt_batch(2), _utt_batch(3, padded_from=5)]
        base_v = _perturb(dict(base_j.init({"params": RNG}, jnp.zeros((2, 6, 5)),
                                           jnp.zeros((2, 6, 20)), jnp.zeros((2, 6, 16)))), 13)
        cm_j, cm_p = _dual(jax_build), _dual(build_module)
        cm_v = _perturb(dict(cm_j.init({"params": RNG}, jnp.zeros((2, 6, 5)))), 14)
        extra = {"input_modalities": ["audio"], "target_modality": "video",
                 "target_modality_two": "text", "base_model_type": "utt-fusion"}
        classes = (jax_cs.DualCMAMTask, cs.DualCMAMTask)
        builders = ((jax_cs.make_dual_cmam_train_step, jax_cs.make_dual_cmam_eval_step),
                    (cs.make_dual_cmam_train_step, cs.make_dual_cmam_eval_step))
    _carry(base_v, base_p)
    _carry(cm_v, cm_p)
    dtype = np.float64 if kind == "cmam" else np.float32
    if kind == "cmam":
        base_p.double()
        cm_p.double()
    return {"kind": kind, "dtype": dtype, "batches": batches, "extra": extra,
            "classes": classes, "builders": builders, "base": (base_j, base_v, base_p),
            "cmam": (cm_j, cm_v, cm_p)}


def _run_steps(kind):
    s = _setup(kind)
    base_j, base_v, base_p = s["base"]
    cm_j, cm_v, cm_p = s["cmam"]
    cast = (lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, s["dtype"]), t))
    jtask = s["classes"][0](cmam_model=cm_j, base_model=base_j, base_variables=cast(base_v),
                            loss=jax_cl.CMAMLoss(**LOSS_KWARGS), **s["extra"])
    ptask = s["classes"][1](cmam_model=cm_p, base_model=base_p,
                            loss=cl.CMAMLoss(**LOSS_KWARGS), **s["extra"])
    pstate = common.make_state(cm_p, TrainingConfig.from_dict(TRAINING))
    ptrain = s["builders"][1][0](ptask, pstate, CPU)
    peval = s["builders"][1][1](ptask, CPU)
    teacher_before = {k: v.clone() for k, v in base_p.state_dict().items()}

    grads, record = [], []
    real_apply = JaxTrainState.apply_gradients

    def spy(self, **kwargs):
        grads.append(jax.tree_util.tree_map(np.asarray, kwargs["grads"]))
        return real_apply(self, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxTrainState, "apply_gradients", spy)
    try:
        with jax.enable_x64(s["dtype"] == np.float64), jax.disable_jit():
            v = cast(cm_v)
            jstate = jax_common.make_state(cm_j, v["params"], v.get("batch_stats", {}),
                                           JaxTrainingConfig.from_dict(TRAINING))
            jtrain = s["builders"][0][0](jtask)
            for b in s["batches"]:
                jstate, jout = jtrain(jstate, {k: jnp.asarray(a) for k, a in b.items()}, RNG)
                pout = ptrain(b)
                record.append((jax.tree_util.tree_map(np.asarray, jout), pout,
                               {n: p.grad.clone() for n, p in cm_p.named_parameters()}))
            eval_batch = s["batches"][2]
            jev = s["builders"][0][1](jtask)(jstate, {k: jnp.asarray(a)
                                                      for k, a in eval_batch.items()})
            jev = jax.tree_util.tree_map(np.asarray, jev)
            jfinal = jax.tree_util.tree_map(np.asarray, (jstate.params, jstate.batch_stats,
                                                         jstate.opt_state))
    finally:
        mp.undo()
    pev = peval(eval_batch)
    return {"record": record, "grads": grads, "jfinal": jfinal, "pstate": pstate,
            "eval": (jev, pev), "teacher": (teacher_before, base_p), "task": ptask}


@pytest.fixture(scope="module", params=["cmam", "dual"])
def steps(request):
    return _run_steps(request.param)


def _scalar(x):
    return float(np.asarray(x))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_train_step_losses_and_gradients_match_mmtpu(steps, k):
    jout, pout, pgrads = steps["record"][k]
    np.testing.assert_allclose(_scalar(pout["loss"]), _scalar(jout["loss"]), rtol=TOL, atol=0)
    assert set(pout["terms"]) == set(jout["terms"])
    for name, value in jout["terms"].items():
        np.testing.assert_allclose(_scalar(pout["terms"][name]), _scalar(value), rtol=TOL,
                                   atol=TOL * 1e-3, err_msg=name)
    want = from_jax_variables(steps["grads"][k], target=steps["pstate"].model,
                              require_all=False)
    assert set(want) == set(pgrads)
    for name, g in pgrads.items():
        w = want[name].double().numpy()
        err = np.abs(g.double().numpy() - w).max()
        # a conv bias feeding a BatchNorm has an exact gradient of 0
        assert err <= TOL * np.linalg.norm(w) + 1e-12, (name, err, np.linalg.norm(w))
    for key in ("rec_embd", "target_embd", "preds", "labels"):
        np.testing.assert_allclose(np.asarray(pout[key].detach(), np.float64),
                                   np.asarray(jout[key], np.float64), rtol=TOL, atol=TOL,
                                   err_msg=key)


def test_state_after_three_steps_matches_mmtpu(steps):
    params, batch_stats, opt_state = steps["jfinal"]
    ps = steps["pstate"]
    want = from_jax_variables(params, batch_stats or None, target=ps.model)
    got = ps.model.state_dict()
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
        moments = from_jax_variables(unflatten_dict(
            {p: np.asarray(v) for p, v in flatten_dict(getattr(adam[0], key)).items()}),
            target=ps.model, require_all=False)
        for p, st in ps.optimizer.state.items():
            np.testing.assert_allclose(st[torch_key].double().numpy(),
                                       moments[names[id(p)]].double().numpy(), rtol=0,
                                       atol=TOL, err_msg=f"{key} {names[id(p)]}")
    assert ps.step == 3


def test_eval_step_after_training_matches_mmtpu(steps):
    jev, pev = steps["eval"]
    assert set(pev) == set(jev)
    np.testing.assert_allclose(_scalar(pev["loss"]), _scalar(jev["loss"]), rtol=TOL)
    for key in [k for k in jev if k.startswith(("rec_embd", "target_embd"))] + ["preds"]:
        np.testing.assert_allclose(np.asarray(pev[key], np.float64),
                                   np.asarray(jev[key], np.float64), rtol=TOL, atol=TOL,
                                   err_msg=key)
    if "terms" in jev:
        for name, value in jev["terms"].items():
            np.testing.assert_allclose(_scalar(pev["terms"][name]), _scalar(value), rtol=TOL,
                                       atol=TOL * 1e-3, err_msg=name)


def test_teacher_is_bitwise_unchanged_and_frozen(steps):
    before, base = steps["teacher"]
    after = base.state_dict()
    assert set(before) == set(after)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert not base.training
    assert not any(p.requires_grad or p.grad is not None for p in base.parameters())


def test_teacher_classify_takes_the_plain_head():
    """The AVMNIST base is called with fused_head=False (the kernel's
    launches on the C-MAM path are counted on the card)."""
    base = _avmnist(build_module)
    cmam = build_module("cmam", input_encoders={"audio": _mnist(build_module, "audio", 6)},
                        association_network={"input_size": 6, "hidden_size": 4,
                                             "output_size": 8}, target_modality="image")
    task = cs.CMAMTask(cmam_model=cmam, base_model=base, base_model_type="AVMNIST",
                       input_modalities=["audio"], target_modality="image",
                       loss=cl.CMAMLoss())
    seen = []
    base.register_forward_pre_hook(lambda m, args, kwargs: seen.append(kwargs),
                                   with_kwargs=True)
    batch = {k: _t(v) for k, v in _av_batch(4).items()}
    task.teacher_classify(batch, {"image": torch.zeros(6, 8)})
    assert seen[0]["fused_head"] is False and seen[0]["is_embd_I"] is True
    assert set(seen[0]) == {"A", "I", "is_embd_I", "fused_head"}


def test_load_pretrained_encoder_state_copies_parameters_only():
    """mmtpu's `train_cmam` overwrites `params["input_encoders_audio"]` with the
    base's `audio_encoder` params: the C-MAM's batch_stats keep their
    initial values. The port copies parameters and leaves buffers. A
    DualCMAM over a UttFusion base finds no `audio_encoder`: nothing copied."""
    base_j, base_p = _avmnist(jax_build), _avmnist(build_module)
    base_v = _perturb(dict(base_j.init({"params": RNG}, jnp.zeros((2, 32, 94)),
                                       jnp.zeros((2, 28, 28, 1)))), 21)
    _carry(base_v, base_p)
    assoc = {"input_size": 6, "hidden_size": 10, "output_size": 8, "batch_norm": True}
    cm_j, cm_p = (build("cmam", input_encoders={"audio": _mnist(build, "audio", 6)},
                        association_network=dict(assoc), target_modality="image")
                  for build in (jax_build, build_module))
    cm_v = jax.tree_util.tree_map(np.asarray, dict(
        cm_j.init({"params": RNG}, {"audio": jnp.zeros((2, 32, 94))})))
    _carry(cm_v, cm_p)
    assert copy_encoder_parameters(base_p, cm_p, ["audio"], dual=False) == ["audio"]
    params = {**cm_v["params"], "input_encoders_audio": base_v["params"]["audio_encoder"]}
    want = from_jax_variables(params, cm_v["batch_stats"], target=cm_p)
    got = cm_p.state_dict()
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    enc = cm_p.input_encoders["audio"].state_dict()
    base_enc = base_p.audio_encoder.state_dict()
    stats = [k for k in enc if k.endswith(("running_mean", "running_var"))]
    assert stats and all(not torch.equal(enc[k], base_enc[k]) for k in stats)
    dual = _dual(build_module)
    before = {k: v.clone() for k, v in dual.state_dict().items()}
    assert copy_encoder_parameters(_utt_base(build_module), dual, ["audio"], dual=True) == []
    assert all(torch.equal(before[k], v) for k, v in dual.state_dict().items())


# -- regression metrics ------------------------------------------------------------

REGRESSION_KWARGS = {
    "plain": lambda g, n, d: {},
    "sample_weight": lambda g, n, d: {"sample_weight": g.uniform(size=n)},
    "raw_values": lambda g, n, d: {"multioutput": "raw_values"},
    "output_weights": lambda g, n, d: {"multioutput": g.uniform(size=d)},
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("kwargs", sorted(REGRESSION_KWARGS))
@pytest.mark.parametrize("name", ["mean_squared_error", "mean_absolute_error"])
def test_regression_metrics_match_sklearn(name, kwargs, dtype):
    import sklearn.metrics

    g = np.random.default_rng(len(name) + len(kwargs))
    y_true = g.normal(size=(40, 7)).astype(dtype)
    y_pred = (y_true + g.normal(size=(40, 7))).astype(dtype)
    kw = REGRESSION_KWARGS[kwargs](g, 40, 7)
    want = getattr(sklearn.metrics, name)(y_true, y_pred, **kw)
    got = getattr(port_metrics, name)(y_true, y_pred, **kw)
    assert type(got) is type(want)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    one_d = getattr(port_metrics, name)(y_true[:, 0], y_pred[:, 0])
    assert one_d == getattr(sklearn.metrics, name)(y_true[:, 0], y_pred[:, 0])


@pytest.mark.parametrize("name", ["mean_squared_error", "mean_absolute_error"])
def test_regression_metrics_refuse_what_sklearn_refuses(name):
    import sklearn.metrics

    for args in ((np.zeros((0, 3)), np.zeros((0, 3))), (np.zeros((4, 3)), np.zeros((4, 2))),
                 (np.zeros((4, 3)), np.zeros((5, 3)))):
        with pytest.raises(ValueError):
            getattr(sklearn.metrics, name)(*args)
        with pytest.raises(ValueError):
            getattr(port_metrics, name)(*args)


# -- the repo's C-MAM configs ---------------------------------------------------------

@pytest.mark.parametrize("path", ["configs/avmnist/cmam_audio_to_image.yaml",
                                  "configs/mosi/synthetic_dual_cmam.yaml"])
def test_cmam_configs_load_and_build(path):
    """The port's CMAMConfig loads each file (`!CMAMConfig`, `!InputEncoders`
    keyed by `!Modality`, `!AssociationNetwork`); its base model, C-MAM,
    `cmam` loss and metrics build, and the C-MAM's initial weights have
    mmtpu's tree; the plain-dict form gives the same config."""
    import json
    from pathlib import Path

    from mmtpu.config.cmam import CMAMConfig as JaxCMAMConfig
    from mmtpu_torch.config import CMAMConfig
    from mmtpu_torch.train.recorder import MetricRecorder

    repo = Path(__file__).resolve().parent.parent
    cfg = CMAMConfig.load(repo / path, run_id=1)
    jcfg = JaxCMAMConfig.load(repo / path, run_id=1)
    assert cfg.cmam.model_type == jcfg.cmam.model_type
    assert str(cfg.target_modality) == str(jcfg.target_modality)
    base = common.build_model_from_config(cfg.model)
    cmam = common.build_model_from_config(cfg.cmam)
    assert type(base).__name__ == {"AVMNIST": "AVMNIST",
                                   "utt-fusion": "UttFusionModel"}[cfg.model.model_type]
    assert isinstance(cfg.training.loss_functions["cmam"].loss_fn, cl.CMAMLoss)
    recorder = MetricRecorder(cfg.metrics)
    assert set(recorder.metrics) == set(jcfg.metrics.metrics)
    jm = jax_build(jcfg.cmam.model_type, **jcfg.cmam.kwargs)
    if cfg.cmam.model_type == "CMAM":
        assert list(cmam.input_encoders) == ["audio"]
        sample = {"audio": jnp.zeros((2, 32, 94))}
        assert recorder.metrics["mse"] is port_metrics.mean_squared_error
    else:
        sample = jnp.zeros((2, 6, 5))
    tree = jm.init({"params": RNG}, sample)
    from_jax_variables(jax.tree_util.tree_map(np.asarray, tree["params"]),
                       jax.tree_util.tree_map(np.asarray, tree.get("batch_stats")) or None,
                       target=cmam)
    again = CMAMConfig.from_parsed(json.loads(json.dumps(cfg.to_dict())), run_id=1)
    assert json.dumps(again.to_dict(), sort_keys=True, default=str) == json.dumps(
        cfg.to_dict(), sort_keys=True, default=str)
