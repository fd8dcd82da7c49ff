"""The port's MOSI UttFusion training path against mmtpu on the CPU, at a
tiny size (LSTM hidden 8, T = 6, B = 8, TextCNN with 8 channels, dropout 0):

- one and three `train_step_core` steps from shared weights (carried by
  `from_jax_variables`), once with a `clip` the gradients exceed and once
  with one they do not: loss, gradients, parameters and Adam moments;
- the LSTM's `autograd.Function` (kernel forward, plain-recompute backward)
  at UttFusion's shapes, with the kernel's launch stood in by the plain scan
  (the CPU has no kernel): 'last' pooling hands it zero output cotangents,
  and one launch over two input widths must reach both encoders' weights;
- mmtpu's and the port's `train_multimodal` on the same tiny synthetic
  UttFusion config from the same initial weights: the same JSON files and
  key structure (the MSA nesting quirk included), the same checkpoint set,
  the first-epoch train loss; `predict` on `best`; `--resume`.

Tolerances: train steps 1e-5 (loss; each gradient within 1e-5 of its
norm; parameters and Adam moments absolute), the Function's gradients
1e-6, the CLI's first-epoch train loss 1e-4. Adam runs at eps 1e-3 (see
`tests/test_torch_port_train.py` for why; the update rule is held at the
default eps there)."""

import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mmtpu.cli import common as jax_common
from mmtpu.config.training import TrainingConfig as JaxTrainingConfig
from mmtpu.models.registry import build_module as jax_build_module
from mmtpu.train import losses as jax_losses
from mmtpu.train.step import ClassificationTask as JaxTask
from mmtpu.train.step import train_step_core as jax_train_step_core
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.cli import common
from mmtpu_torch.config.training import TrainingConfig
from mmtpu_torch.models import build_module
from mmtpu_torch.train import losses
from mmtpu_torch.train import step as step_mod
from mmtpu_torch.train.step import ClassificationTask, make_train_step

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cli_harness import run_cli_inproc  # noqa: E402

TOL = 1e-5
CPU = torch.device("cpu")
KEYS = ["audio", "video", "text"]
WIDTHS = {"audio": 5, "video": 20, "text": 24}
B, T, H = 8, 6, 8
TRAINING = {
    "epochs": 1, "num_modalities": 3,
    "optimizer": {"name": "Adam", "default_kwargs": {"lr": 1e-3, "weight_decay": 1e-4,
                                                     "eps": 1e-3}},
    "loss_functions": {"cross_entropy": {"loss_name": "cross_entropy", "loss_args": {},
                                         "weight": 1.0}},
}
# global gradient norm of the tiny model's first step is about 1: one clip
# that scales every step's gradients, one that leaves them alone
CLIPS = {"scales": 0.05, "idle": 50.0}


def _model(build, embd_method="last", dropout=0.0):
    return build(
        "utt_fusion",
        netA=build("lstmencoder", input_size=5, hidden_size=H, embd_method=embd_method),
        netV=build("lstmencoder", input_size=20, hidden_size=H, embd_method=embd_method),
        netT=build("textcnn", input_size=WIDTHS["text"], embd_size=8, out_channels=8,
                   dropout=dropout),
        netC=build("fcclassifier", input_dim=3 * 8, layers=[16, 8], output_dim=3,
                   dropout=dropout),
    )


def _batch(seed, padded_from=None):
    """A UttFusion batch with modalities missing in some rows and, from row
    `padded_from` on, a zero-padded tail."""
    g = np.random.default_rng(seed)
    labels = g.integers(0, 3, size=B).astype(np.int64)
    batch = {k: (g.normal(size=(B, T, w)) + 0.3 * labels[:, None, None]).astype(np.float32)
             for k, w in WIDTHS.items()}
    for k in KEYS:
        batch[f"{k}_mask"] = np.ones(B, np.float32)
    batch["audio_mask"][1::4] = 0.0
    batch["video_mask"][2::4] = 0.0
    batch["text_mask"][3::4] = 0.0
    batch.update(labels=labels, pattern_id=g.integers(0, 7, size=B).astype(np.int32),
                 sample_mask=np.ones(B, np.float32))
    if padded_from is not None:
        for k in (*KEYS, *(f"{k}_mask" for k in KEYS), "labels", "sample_mask"):
            batch[k][padded_from:] = 0
    return batch


def _perturb_biases(params, seed):
    g = np.random.default_rng(seed)
    flat = flatten_dict(jax.tree_util.tree_map(np.array, dict(params)))
    for path, v in flat.items():
        if path[-1] == "bias":
            flat[path] = (0.1 * g.normal(size=v.shape)).astype(np.float32)
    return unflatten_dict(flat)


@pytest.fixture(scope="module", params=sorted(CLIPS))
def utt_run(request):
    """mmtpu and the port from the same weights through the same three
    batches (the second with missing modalities only, the third with a
    padded tail); the port's gradients are taken before and after its clip."""
    clip = CLIPS[request.param]
    batches = [_batch(1), _batch(2), _batch(3, padded_from=5)]
    jm = _model(jax_build_module)
    sample = [jnp.asarray(batches[0][k][:2]) for k in KEYS]
    params = _perturb_biases(jm.init({"params": jax.random.PRNGKey(0)}, *sample)["params"], 4)
    jstate = jax_common.make_state(jm, params, {}, JaxTrainingConfig.from_dict(TRAINING),
                                   clip=clip)
    jtask = JaxTask(model=jm, loss_group=jax_losses.LossFunctionGroup.from_dict(
        TRAINING["loss_functions"]), input_keys=KEYS)
    jstep = jax.jit(lambda s, b: jax_train_step_core(jtask, s, b, jax.random.PRNGKey(1)))

    pm = _model(build_module)
    pm.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, params),
                                          target=pm), strict=True)
    pstate = common.make_state(pm, TrainingConfig.from_dict(TRAINING), clip=clip)
    ptask = ClassificationTask(model=pm, loss_group=losses.LossFunctionGroup.from_dict(
        TRAINING["loss_functions"]), input_keys=KEYS)
    pstep = make_train_step(ptask, pstate, CPU)

    raw = []
    real_clip = step_mod.clip_by_global_norm

    def spy(params_, max_norm):
        params_ = list(params_)
        raw.append({n: p.grad.clone() for n, p in pm.named_parameters()})
        return real_clip(params_, max_norm)

    record = []
    mp = pytest.MonkeyPatch()
    mp.setattr(step_mod, "clip_by_global_norm", spy)
    try:
        for b in batches:
            jstate, jloss, _, jgrads, _ = jstep(jstate, {k: jnp.asarray(a) for k, a in b.items()})
            out = pstep(b)
            clipped = {n: p.grad.clone() for n, p in pm.named_parameters()}
            record.append((float(jloss), jgrads, float(out["loss"]), raw[-1], clipped))
    finally:
        mp.undo()
    return {"clip": clip, "jstate": jstate, "pstate": pstate, "record": record}


def _norm(grads):
    return float(np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                             for g in jax.tree_util.tree_leaves(grads))))


def _assert_grads(want_tree, got, scale=1.0):
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(want) == set(got)
    for name, g in got.items():
        w = want[name].numpy() * scale
        err = np.abs(g.numpy() - w).max()
        assert err <= TOL * max(np.linalg.norm(w), 1e-12) + 1e-12, (name, err)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_train_steps_match_mmtpu(utt_run, k):
    """Loss and gradients of each step, before the clip (mmtpu's
    train_step_core returns those) and after it (the global-norm scale,
    applied before Adam's coupled L2)."""
    jloss, jgrads, ploss, raw, clipped = utt_run["record"][k]
    np.testing.assert_allclose(ploss, jloss, rtol=TOL, atol=TOL)
    _assert_grads(jgrads, raw)
    norm, clip = _norm(jgrads), utt_run["clip"]
    assert (norm > clip) == (clip == CLIPS["scales"]), (norm, clip)
    _assert_grads(jgrads, clipped, scale=min(1.0, clip / norm))


def test_state_after_three_steps_matches_mmtpu(utt_run):
    """Parameters and Adam's moments after three steps, and the step count."""
    js, ps = utt_run["jstate"], utt_run["pstate"]
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray, js.params), target=ps.model)
    for k, w in want.items():
        np.testing.assert_allclose(ps.model.state_dict()[k].numpy(), w.numpy(), rtol=0,
                                   atol=TOL, err_msg=k)
    states = [s for s in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda x: type(x).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState"]
    assert len(states) == 1
    names = {id(p): n for n, p in ps.model.named_parameters()}
    for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        tree = unflatten_dict({p: np.asarray(v) for p, v in
                               flatten_dict(getattr(states[0], key)).items()})
        moments = from_jax_variables(tree)
        for p, st in ps.optimizer.state.items():
            np.testing.assert_allclose(st[torch_key].numpy(), moments[names[id(p)]].numpy(),
                                       rtol=0, atol=TOL, err_msg=f"{key} {names[id(p)]}")
            assert int(st["step"]) == int(states[0].count) == 3
    assert ps.step == int(js.step) == 3


@pytest.mark.parametrize("embd_method", ["last", "maxpool"])
def test_lstm_function_backward_at_utt_fusion_shapes(embd_method, monkeypatch):
    """`_LSTM` (what a CUDA train step runs) with its launch stood in by the
    plain scan: one G = 2 call over projections of widths 5 and 20. With
    'last' pooling the outputs get a zero cotangent; the gradients of both
    encoders' `wi` and `wh` equal autograd through the plain scan."""
    from mmtpu_torch.models import lstm as plstm
    from mmtpu_torch.ops import lstm as ops_lstm

    def cpu_launch(xws, whs, h0, c0, lengths):
        out, (h, c) = ops_lstm.lstm_stacked_reference(torch.stack(xws), torch.stack(whs),
                                                       h0, c0, lengths)
        ops_lstm.lstm_sequence_stacked.launches += 1
        return out, h, c

    def through_function(xws, whs, h0=None, c0=None, lengths=None):
        out, h, c = ops_lstm._LSTM.apply(len(xws), lengths, h0, c0, *xws, *whs)
        return out, (h, c)

    g = torch.Generator().manual_seed(12)
    netA = plstm.LSTMEncoder(5, H, embd_method)
    netV = plstm.LSTMEncoder(20, H, embd_method)
    A, V = torch.randn(B, T, 5, generator=g), torch.randn(B, T, 20, generator=g)
    cot = torch.randn(B, 2 * H, generator=g)
    grads = []
    for patched in (False, True):
        if patched:
            monkeypatch.setattr(ops_lstm, "_launch", cpu_launch)
            monkeypatch.setattr(plstm, "lstm_sequence_stacked", through_function)
        params = [netA.wi.weight, netA.wi.bias, netA.wh, netV.wi.weight, netV.wi.bias,
                  netV.wh]
        ea, ev = plstm.encode_pair_stacked(netA, netV, A, V)
        grads.append(torch.autograd.grad((torch.cat([ea, ev], -1) * cot).sum(), params))
    for got, want in zip(*reversed(grads)):
        assert got.abs().max() > 0
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_rnn_backend_weight_gradients_match_mmtpu_with_lengths_past_t():
    """backend='rnn' with lengths {0, 3, T, T + 5}: every encoder weight's
    gradient within 1e-5 of its norm of `jax.grad` through mmtpu's encoder.
    Past T, JAX's gather clamps the carry index forward and its transpose
    drops the cotangent; the port gives those rows the same value and no
    gradient through the carry."""
    from mmtpu.models.lstm import LSTMEncoder as JaxLSTMEncoder
    from mmtpu_torch.models import LSTMEncoder

    g = np.random.default_rng(21)
    x = g.normal(size=(8, T, 5)).astype(np.float32)
    lengths = np.array([0, 3, T, T + 5, T + 5, 3, T, 0], np.int32)
    cot = g.normal(size=(8, H)).astype(np.float32)
    jm = JaxLSTMEncoder(input_size=5, hidden_size=H, embd_method="last", backend="rnn")
    pm = LSTMEncoder(input_size=5, hidden_size=H, embd_method="last", backend="rnn")
    v = jax.tree_util.tree_map(np.asarray, dict(jm.init(jax.random.PRNGKey(3), jnp.asarray(x))))
    flat = flatten_dict(v["params"])
    v = {"params": unflatten_dict({k: (a + 0.1 * g.normal(size=a.shape)).astype(np.float32)
                                   for k, a in flat.items()})}
    pm.load_state_dict(from_jax_variables(v["params"], target=pm), strict=True)

    def loss(params):
        return jnp.sum(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(lengths))
                       * cot)

    want = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                     jax.grad(loss)(v["params"])))
    out = pm(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jm.apply(v, jnp.asarray(x), jnp.asarray(lengths))), rtol=TOL, atol=TOL)
    names, params = zip(*pm.named_parameters())
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), params)
    assert set(names) == set(want)
    for name, gr in zip(names, got):
        w = want[name].numpy()
        err = np.abs(gr.numpy() - w).max()
        assert err <= TOL * max(np.linalg.norm(w), 1e-12), (name, err)
    # the rows past T alone: no gradient reaches the weights through them
    rows = lengths > T
    past = torch.autograd.grad((pm(torch.from_numpy(x[rows]), torch.from_numpy(lengths[rows]))
                                * torch.from_numpy(cot[rows])).sum(), params)
    assert all(float(gr.abs().max()) == 0.0 for gr in past)


def test_dropout_is_live_in_train_mode_only():
    """TextCNN's and FcClassifier's dropout draw in a train forward and not
    in an eval forward."""
    model = _model(build_module, dropout=0.5)
    batch = {k: torch.from_numpy(v) for k, v in _batch(6).items()}
    task = ClassificationTask(model=model, loss_group=None, input_keys=KEYS)
    with torch.no_grad():
        train = [task.apply(batch, train=True) for _ in range(2)]
        evals = [task.apply(batch, train=False) for _ in range(2)]
    assert not torch.equal(train[0], train[1])
    assert torch.equal(evals[0], evals[1])
    assert sum(isinstance(m, torch.nn.Dropout) and m.p == 0.5 for m in model.modules()) >= 2


# -- the CLI, both packages ------------------------------------------------------

NAME = "Synthetic_MOSI_UttFusion"


def _tiny_yaml(dst: Path, out_root: Path) -> Path:
    """configs/mosi/synthetic_utt_fusion.yaml at hidden 8, T = 6, TextCNN 8
    channels, dropout 0, Adam eps 1e-3, 40 train samples (batches of 16, a
    padded tail) and 12 validation and test samples (84 visits each)."""
    text = (REPO / "configs/mosi/synthetic_utt_fusion.yaml").read_text()
    subs = [
        ("./experiments_output", str(out_root)),
        ("hidden_size: 32", "hidden_size: 8"),
        ("embd_size: 64\n    dropout: 0.5", "embd_size: 8\n    out_channels: 8\n    dropout: 0.0"),
        ("input_dim: 128\n    layers: [64, 64]", "input_dim: 24\n    layers: [16, 8]"),
        ("dropout: 0.3", "dropout: 0.0"),
        ("weight_decay: 0.0001", "weight_decay: 0.0001\n      eps: 0.001"),
        ("batch_size: 32", "batch_size: 16"),
        ("num_samples: 128", "num_samples: 40\n        seq_len: 6"),
        ("num_samples: 64", "num_samples: 12\n        seq_len: 6"),
    ]
    for old, new in subs:
        assert old in text, old
        text = text.replace(old, new)
    dst.write_text(text)
    return dst


def _structure(obj):
    if isinstance(obj, dict):
        return {k: _structure(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [_structure(v) for v in obj]
    return "·"


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """mmtpu's train_multimodal, then the port's from mmtpu's initial
    weights (its `init_model` hands over mmtpu's, carried); the port's
    in-memory model is kept."""
    mp = pytest.MonkeyPatch()
    out, init = {}, {}
    real_jax_init = jax_common.init_model

    def jax_spy(model, sample, seed):
        params, stats = real_jax_init(model, sample, seed)
        init["params"] = jax.tree_util.tree_map(np.asarray, params)
        return params, stats

    def port_init(model, seed, device):
        state = from_jax_variables(init["params"], target=model)
        model.load_state_dict(state, strict=True)
        torch.manual_seed(int(seed))
        init.update(model=model.to(device), initial=state)
        return init["model"]

    try:
        mp.setattr(jax_common, "init_model", jax_spy)
        mp.setattr(common, "init_model", port_init)
        for pkg in ("mmtpu", "mmtpu_torch"):
            root = tmp_path_factory.mktemp(f"utt_{pkg}")
            cfg = _tiny_yaml(root / "utt.yaml", root)
            assert run_cli_inproc(f"{pkg}.cli.train_multimodal", cfg, run_id="1") == 0
            out[pkg] = {"root": root, "cfg": cfg}
    finally:
        mp.undo()
    out.update(model=init["model"], initial=init["initial"])
    yield out
    for pkg in ("mmtpu", "mmtpu_torch"):
        shutil.rmtree(out[pkg]["root"], ignore_errors=True)


def _json_files(root: Path):
    return {p.relative_to(root).as_posix(): json.loads(p.read_text())
            for p in sorted(root.rglob("*.json")) if "/models/" not in p.as_posix()}


def test_cli_json_files_and_msa_nesting_match_mmtpu(cli_runs):
    ours = _json_files(cli_runs["mmtpu_torch"]["root"])
    theirs = _json_files(cli_runs["mmtpu"]["root"])
    assert sorted(ours) == sorted(theirs)
    for name in ("epoch_metrics.json", "train_metrics.json", "validation_metrics.json",
                 "test_metrics.json"):
        assert f"{NAME}/metrics/1/{name}" in ours
    for name, data in theirs.items():
        assert _structure(ours[name]) == _structure(data), name
    epochs = ours[f"{NAME}/metrics/1/epoch_metrics.json"]
    assert [set(e) for e in epochs] == [{"epoch", "train", "validation"}] * 2 + [{"test"}]
    val = epochs[0]["validation"]
    # the quirk: 5-part MSA keys nest under parts[3]
    assert set(val["weighted"]) == {f"MSA_{s}_{m}" for s in ("Non0", "Has0")
                                    for m in ("F1", "Recall", "Precision")}
    assert set(val["metrics"]) == {f"accuracy_{p}" for p in
                                   ("ATV", "AT", "AV", "TV", "A", "T", "V")}
    test = ours[f"{NAME}/metrics/1/test_metrics.json"][0]
    assert sum(k.startswith("MSA_") for k in test) == 20 * 7


def test_cli_first_epoch_train_loss_matches_mmtpu(cli_runs):
    losses_ = []
    for pkg in ("mmtpu", "mmtpu_torch"):
        fp = cli_runs[pkg]["root"] / NAME / "metrics/1/epoch_metrics.json"
        losses_.append(json.loads(fp.read_text())[0]["train"]["loss"])
    assert abs(losses_[0] - losses_[1]) <= 1e-4, losses_


def test_cli_checkpoint_set_matches_mmtpu(cli_runs):
    def names(pkg, suffix):
        return sorted(p.name.replace(suffix, "·")
                      for p in (cli_runs[pkg]["root"] / NAME / "models/1").iterdir())

    ours = names("mmtpu_torch", ".pth")
    assert ours == names("mmtpu", ".ckpt")
    assert {"best·", "last·", "resume.json", "best.json"} <= set(ours)
    assert any(n.startswith("epoch_") for n in ours)


def test_predict_on_best_gives_the_in_memory_models_logits(cli_runs, tmp_path):
    """After its test phase restored `best`, the run's model gives the
    logits `cli.predict` gives from `best.pth`."""
    import argparse

    from mmtpu_torch.cli import predict
    from mmtpu_torch.train.step import make_eval_step

    args = argparse.Namespace(config=str(cli_runs["mmtpu_torch"]["cfg"]), run_id=1, seed=None,
                              split="test", checkpoint="best", cpu=True,
                              out=str(tmp_path / "p.json"))
    cfg = common.load_config(args)
    task, loader = predict.build_task_and_loader(cfg, args, CPU)
    ours = make_eval_step(task, CPU)
    theirs = make_eval_step(type(task)(model=cli_runs["model"].eval(),
                                       loss_group=task.loss_group,
                                       input_keys=task.input_keys), CPU)
    preds = []
    for batch in loader:
        a, b = ours(batch), theirs(batch)
        torch.testing.assert_close(a["logits"], b["logits"], rtol=0, atol=0)
        preds += b["preds"][b["sample_mask"] > 0].tolist()
    assert task.input_keys == KEYS and len(preds) == 84
    predict.run(args)
    records = json.loads(Path(args.out).read_text())["predictions"]
    assert [r["pred"] for r in records] == preds


def test_resume_after_one_epoch_ends_as_an_uninterrupted_run(cli_runs, tmp_path):
    """--epochs 1, then --resume with the config's 2 epochs, from the
    uninterrupted run's initial weights: last.pth's weights and Adam moments
    and the recorded train losses equal the uninterrupted run's."""
    base = cli_runs["mmtpu_torch"]["root"]
    cfg = _tiny_yaml(tmp_path / "utt.yaml", tmp_path)

    def init_model(model, seed, device):
        torch.manual_seed(int(seed))
        model.load_state_dict(cli_runs["initial"], strict=True)
        return model.to(device)

    mp = pytest.MonkeyPatch()
    mp.setattr(common, "init_model", init_model)
    try:
        assert run_cli_inproc("mmtpu_torch.cli.train_multimodal", cfg, run_id="1",
                              extra=("--epochs", "1")) == 0
        assert run_cli_inproc("mmtpu_torch.cli.train_multimodal", cfg, run_id="1",
                              extra=("--resume",)) == 0
    finally:
        mp.undo()
    want = torch.load(base / NAME / "models/1/last.pth", weights_only=True)
    got = torch.load(tmp_path / NAME / "models/1/last.pth", weights_only=True)
    assert got["step"] == want["step"] == 6
    for k, v in want["model"].items():
        torch.testing.assert_close(got["model"][k], v, rtol=0, atol=0, msg=k)
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(got["optimizer"]["state"][i][k], v, rtol=0, atol=0)
    losses_ = [[e["train"]["loss"] for e in json.loads(
        (r / NAME / "metrics/1/epoch_metrics.json").read_text()) if "train" in e]
        for r in (base, tmp_path)]
    assert losses_[0] == losses_[1]


def test_other_msa_families_still_raise(tmp_path, monkeypatch):
    """Self-MM now trains in the port, through its own driver
    (tests/test_torch_port_self_mm_cli.py holds it against mmtpu); MulT and
    GCNet train only through the registry, so `train_multimodal` refuses
    them with mmtpu's own error."""
    from mmtpu.cli import train_multimodal as jax_train_multimodal
    from mmtpu_torch.cli import train_multimodal

    monkeypatch.chdir(tmp_path)
    self_mm = Path(__file__).resolve().parent.parent / "configs/mosi/synthetic_self_mm.yaml"
    assert train_multimodal.main(["--config", str(self_mm), "--run_id", "1", "--cpu",
                                  "--epochs", "1"]) == 0
    records = json.loads((tmp_path / "experiments_output/Synthetic_MOSI_SelfMM/metrics/1/"
                          "epoch_metrics.json").read_text())
    assert [sorted(e) for e in records] == [["epoch", "train", "validation"], ["test"]]
    cfg = _tiny_yaml(tmp_path / "utt.yaml", tmp_path)
    for model_type in ("mult", "gcnet"):
        text = cfg.read_text().replace('model_type: "utt-fusion"',
                                       f'model_type: "{model_type}"')
        other = tmp_path / f"{model_type}.yaml"
        other.write_text(text)
        for package in (train_multimodal, jax_train_multimodal):
            with pytest.raises(ValueError, match=f"Unknown model type: {model_type}"):
                package.main(["--config", str(other), "--run_id", "1", "--cpu"])
