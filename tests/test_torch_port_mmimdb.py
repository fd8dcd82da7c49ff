"""The port's MM-IMDb slice (mmtpu_torch.models.fusion, models.mmimdb,
data.mmimdb, the multilabel task and metrics) against mmtpu's on the CPU,
from the same numpy inputs made from a seed and mmtpu's weights carried by
`from_jax_variables`:

- MaxOut (with and without bias, 3 units: flax's (…, units, out) reshape),
  the GMU (with and without biases), MultimodalPooling's five kinds (and
  'average'), the modality encoder, the genre classifier and `MMIMDb` with
  the GMU and with pooling, in eval (perturbed BatchNorm statistics) and in
  training (batch statistics, dropout neutralised in both): 1e-5; MMIMDb
  with `is_embd_I` and `encode`;
- three multilabel train steps (sigmoid > 0.5 predictions, BCE with
  logits, the third with a zero-padded tail) in float64 (BatchNorm is on
  the path; flax's float32 variance is E[x²] − E[x]²): loss, gradients of
  their norm, parameters and running statistics at 1e-5;
- `SyntheticMMIMDb` byte for byte; the HDF5 reader on a small file written
  here; both registered under mmtpu's names;
- the multilabel metrics against sklearn bit for bit, rows with no true and
  no predicted genre included;
- configs/mmimdb/synthetic_gmu.yaml at reduced sample counts through both
  packages' `train_multimodal` (the port from mmtpu's initial weights,
  dropout neutralised in both): the same files and records at 1e-4; both
  packages' `predict` on the best checkpoint: the same multilabel records;
  the port's server: multilabel answers equal to the Predictor's, a
  request without `text` refused with 400.
"""

import json
import shutil
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from mmtpu.cli import common as jax_common
from mmtpu.config.training import TrainingConfig as JaxTrainingConfig
from mmtpu.models import mmimdb as jax_mmimdb
from mmtpu.models.registry import build_module as jax_build
from mmtpu.train import losses as jax_losses
from mmtpu.train.step import ClassificationTask as JaxTask
from mmtpu.train.step import train_step_core as jax_train_step_core
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.cli import common
from mmtpu_torch.config.training import TrainingConfig
from mmtpu_torch.data import resolve_dataset_name
from mmtpu_torch.metrics import classification as ours
from mmtpu_torch.models import build_module
from mmtpu_torch.models import rng as port_rng
from mmtpu_torch.train import losses
from mmtpu_torch.train.step import ClassificationTask, make_train_step

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cli_harness import run_cli_inproc  # noqa: E402
from _redcore_neutral import _NoDropoutLinen  # noqa: E402
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

CPU = torch.device("cpu")
TOL = 1e-5
VALUE_TOL = 1e-4
RNG = jax.random.PRNGKey(0)
GMU_CFG = REPO / "configs/mmimdb/synthetic_gmu.yaml"
NAME = "Synthetic_MMIMDb_GMU"
TRAINING = {"epochs": 1, "num_modalities": 2,
            "optimizer": {"name": "Adam", "default_kwargs": {"lr": 1e-3, "weight_decay": 1e-3,
                                                             "eps": 1e-3}},
            "loss_functions": {"bce": {"loss_name": "bce_with_logits", "weight": 1.0}}}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got, np.float64),
                               np.asarray(want, np.float64), rtol=tol, atol=tol, err_msg=msg)


def _perturb(variables, seed):
    """Biases, BatchNorm scales and running statistics drawn from a seed."""
    g = np.random.default_rng(seed)
    out = {}
    for col, tree in variables.items():
        flat = flatten_dict(_np(dict(tree)))
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


@pytest.fixture
def neutral(monkeypatch):
    """No dropout in either package's train forward (their generators differ)."""
    monkeypatch.setattr(jax_mmimdb, "nn", _NoDropoutLinen("flax.linen"))
    monkeypatch.setattr(port_rng.GeneratorDropout, "forward", lambda self, x: x)


# -- the fusion primitives ---------------------------------------------------------

BLOCKS = {
    "maxout": ("maxout", dict(input_dim=7, output_dim=5, num_units=3), 1),
    "maxout_no_bias": ("maxout", dict(input_dim=7, output_dim=5, use_bias=False), 1),
    "gmu": ("gated_bimodal", dict(input_one_dim=7, input_two_dim=4, output_one_dim=6,
                                  output_two_dim=6), 2),
    "gmu_bias": ("gated_bimodal", dict(input_one_dim=7, input_two_dim=4, output_one_dim=6,
                                       output_two_dim=6, use_bias=True), 2),
    **{f"pool_{k}": ("multimodal_pooling", dict(input_dim_a=7, input_dim_b=4, output_dim=6,
                                                pooling_type=k, hidden_dim=5), 2)
       for k in ("max", "avg", "average", "sum", "attention", "gated")},
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_fusion_block_matches_mmtpu(case):
    name, kw, n_in = BLOCKS[case]
    jm, pm = jax_build(name, **kw), build_module(name, **kw)
    g = np.random.default_rng(2)
    xs = [g.normal(size=(6, w)).astype(np.float32) for w in (7, 4)[:n_in]]
    v = _perturb(dict(jm.init({"params": RNG}, *map(jnp.asarray, xs))), 3)
    _carry(v, pm)
    want = np.asarray(jm.apply(v, *map(jnp.asarray, xs)))
    _close(pm.eval()(*map(_t, xs)), want, msg=case)


def test_maxout_keeps_flax_unit_layout():
    pm = build_module("maxout", input_dim=3, output_dim=2, num_units=2, use_bias=False)
    x = torch.randn(4, 3)
    w = pm.units.weight  # (units·out, in), unit-major rows
    want = torch.maximum(x @ w[:2].t(), x @ w[2:].t())
    torch.testing.assert_close(pm(x), want)


# -- the model -------------------------------------------------------------------------

def _model_kwargs(build, fusion):
    kw = dict(image_encoder=build("mmimdb_modality_encoder", input_dim=40, output_dim=12),
              text_encoder=build("mmimdb_modality_encoder", input_dim=9, output_dim=12),
              classifier=build("mlp_genre_classifier", input_size=12, hidden_size=10,
                               output_size=23))
    if fusion == "gmu":
        kw["gated_bimodal_network"] = build("gated_bimodal", input_one_dim=12,
                                             input_two_dim=12, output_one_dim=12,
                                             output_two_dim=12)
    else:
        kw["multimodal_pooling"] = {"pooling_type": "attention", "hidden_dim": 8}
    return kw


def _inputs(seed, B=8):
    g = np.random.default_rng(seed)
    return g.normal(size=(B, 40)).astype(np.float32), g.normal(size=(B, 9)).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("fusion", ["gmu", "pooling"])
def test_mmimdb_forward_matches_mmtpu(fusion, train, neutral):
    jm = jax_build("mmimdb", **_model_kwargs(jax_build, fusion))
    pm = build_module("mmimdb", **_model_kwargs(build_module, fusion))
    image, text = _inputs(4)
    v = _perturb(dict(jm.init({"params": RNG}, jnp.asarray(image), jnp.asarray(text))), 5)
    _carry(v, pm)
    out = jm.apply(v, jnp.asarray(image), jnp.asarray(text), train=train,
                   mutable=["batch_stats"] if train else False)
    want, stats = out if train else (out, None)
    got = pm.train(train)(_t(image), _t(text))
    _close(got, np.asarray(want))
    if train:
        new = from_jax_variables(v["params"], _np(stats["batch_stats"]), target=pm)
        for k, t in pm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                _close(t, new[k].numpy(), msg=k)
    if not train:
        emb_i, emb_t = pm.encode(_t(image), _t(text))
        _close(pm(emb_i, _t(text), is_embd_I=True), np.asarray(want))
        assert emb_t.shape == (8, 12)


# -- three multilabel train steps in float64 --------------------------------------------

def _batch(seed, padded_from=None, B=8):
    image, text = _inputs(seed, B)
    g = np.random.default_rng(seed + 100)
    labels = (g.random((B, 23)) < 0.2).astype(np.float32)
    batch = {"image": image, "text": text, "labels": labels,
             "image_mask": np.ones(B, np.float32), "text_mask": np.ones(B, np.float32),
             "pattern_id": np.zeros(B, np.int32), "sample_mask": np.ones(B, np.float32)}
    batch["image_mask"][1] = 0.0
    batch["text_mask"][2] = 0.0
    if padded_from is not None:
        for k in ("image", "text", "labels", "image_mask", "text_mask", "sample_mask"):
            batch[k][padded_from:] = 0
    return {k: a.astype(np.float64) if a.dtype == np.float32 else a for k, a in batch.items()}


@pytest.fixture(scope="module")
def mmimdb_steps():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_mmimdb, "nn", _NoDropoutLinen("flax.linen"))
    mp.setattr(port_rng.GeneratorDropout, "forward", lambda self, x: x)
    try:
        jm = jax_build("mmimdb", **_model_kwargs(jax_build, "gmu"))
        pm = build_module("mmimdb", **_model_kwargs(build_module, "gmu"))
        image, text = _inputs(0)
        v = _perturb(dict(jm.init({"params": RNG}, jnp.asarray(image), jnp.asarray(text))), 6)
        _carry(v, pm)
        pm.double()
        batches = [_batch(1), _batch(2), _batch(3, padded_from=5)]
        pstate = common.make_state(pm, TrainingConfig.from_dict(TRAINING))
        ptask = ClassificationTask(model=pm, loss_group=losses.LossFunctionGroup.from_dict(
            TRAINING["loss_functions"]), input_keys=["image", "text"], multilabel=True)
        pstep = make_train_step(ptask, pstate, CPU)
        jtask = JaxTask(model=jm, loss_group=jax_losses.LossFunctionGroup.from_dict(
            TRAINING["loss_functions"]), input_keys=["image", "text"], multilabel=True)
        record = []
        with jax.enable_x64():
            v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
            jstate = jax_common.make_state(jm, v64["params"], v64["batch_stats"],
                                           JaxTrainingConfig.from_dict(TRAINING))
            step = jax.jit(lambda s, b: jax_train_step_core(jtask, s, b, RNG))
            for b in batches:
                jstate, jloss, jlogits, jgrads, _ = step(
                    jstate, {k: jnp.asarray(a) for k, a in b.items()})
                pout = pstep(b)
                record.append((float(jloss), _np(jgrads), pout,
                               {n: p.grad.clone() for n, p in pm.named_parameters()},
                               np.asarray(jtask.predictions(jlogits))))
            jfinal = _np((jstate.params, jstate.batch_stats))
    finally:
        mp.undo()
    return {"record": record, "pstate": pstate, "jfinal": jfinal}


@pytest.mark.parametrize("k", [0, 1, 2])
def test_multilabel_train_step_matches_mmtpu(mmimdb_steps, k):
    jloss, jgrads, pout, pgrads, jpreds = mmimdb_steps["record"][k]
    model = mmimdb_steps["pstate"].model
    np.testing.assert_allclose(float(pout["loss"]), jloss, rtol=TOL, atol=TOL)
    want = from_jax_variables(jgrads, target=model, require_all=False)
    assert set(want) == set(pgrads)
    for name, g in pgrads.items():
        w = want[name].double().numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= TOL * np.linalg.norm(w) + 1e-12, (name, err)
    assert pout["preds"].dtype == torch.int32 and tuple(pout["preds"].shape) == (8, 23)
    np.testing.assert_array_equal(pout["preds"].numpy(), jpreds)


def test_state_after_three_multilabel_steps_matches_mmtpu(mmimdb_steps):
    (params, batch_stats), ps = mmimdb_steps["jfinal"], mmimdb_steps["pstate"]
    want = from_jax_variables(params, batch_stats, target=ps.model)
    got = ps.model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        _close(got[k], w.double().numpy(), msg=k)


# -- data -----------------------------------------------------------------------------

@pytest.mark.parametrize("split,patterns", [("train", ["it"]), ("test", ["it", "i", "t"])])
def test_synthetic_mmimdb_is_byte_identical(split, patterns):
    from mmtpu.data import resolve_dataset_name as jax_resolve

    kw = dict(split=split, num_samples=37, seed=5, selected_patterns=patterns)
    theirs = jax_resolve("synthetic_mmimdb")(None, **kw)
    mine = resolve_dataset_name("synthetic_mmimdb")(None, **kw)
    np.testing.assert_array_equal(mine.labels, theirs.labels)
    assert set(mine.arrays) == set(theirs.arrays)
    for m in theirs.arrays:
        assert mine.arrays[m].dtype == theirs.arrays[m].dtype
        np.testing.assert_array_equal(mine.arrays[m], theirs.arrays[m])
    assert mine.selected_patterns == theirs.selected_patterns
    assert mine.arrays["image"].shape == (37, 4096) and mine.arrays["text"].shape == (37, 300)


def test_hdf5_reader_matches_mmtpu(tmp_path):
    import h5py

    from mmtpu.data import resolve_dataset_name as jax_resolve

    g = np.random.default_rng(8)
    path = tmp_path / "split.h5"
    with h5py.File(path, "w") as f:
        f["vgg_features"] = g.normal(size=(11, 16)).astype(np.float64)
        f["features"] = g.normal(size=(11, 6)).astype(np.float32)
        f["genres"] = (g.random((11, 23)) < 0.2).astype(np.int64)
        f["imdb_ids"] = np.arange(11)
    theirs = jax_resolve("mm_imdb")(str(path), split="valid")
    mine = resolve_dataset_name("mm_imdb")(str(path), split="valid")
    np.testing.assert_array_equal(mine.labels, theirs.labels)
    for m in theirs.arrays:
        assert mine.arrays[m].dtype == np.float32
        np.testing.assert_array_equal(mine.arrays[m], theirs.arrays[m])
    assert mine.selected_patterns == theirs.selected_patterns
    with pytest.raises(KeyError, match="nope"):
        resolve_dataset_name("mm_imdb")(str(path), split="valid", labels_key="nope")
    with pytest.raises(FileNotFoundError):
        resolve_dataset_name("mm_imdb")(str(tmp_path / "missing.h5"), split="valid")


# -- multilabel metrics ------------------------------------------------------------------

def _indicators(seed):
    g = np.random.default_rng(seed)
    t = (g.random((30, 23)) < 0.15).astype(np.float32)
    p = (g.random((30, 23)) < 0.2).astype(np.int32)
    t[:3] = 0
    p[:2] = 0  # rows 0-1: no true and no predicted genre; row 2: predictions only
    t[:, 5] = 0
    p[:, 5] = 0  # a genre never true nor predicted
    return t, p


@pytest.mark.parametrize("zero_division", [0, 1, "warn"])
@pytest.mark.parametrize("average", [None, "samples", "macro", "micro", "weighted"])
@pytest.mark.parametrize("fn", ["f1_score", "precision_score", "recall_score"])
def test_multilabel_metrics_match_sklearn(fn, average, zero_division):
    import warnings

    import sklearn.metrics as sk

    t, p = _indicators(9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(sk, fn)(t, p, average=average, zero_division=zero_division)
        got = getattr(ours, fn)(t, p, average=average, zero_division=zero_division)
    np.testing.assert_array_equal(np.asarray(got, np.float64), np.asarray(want, np.float64))


def test_multilabel_metric_errors_and_accuracy_match_sklearn():
    import sklearn.metrics as sk

    t, p = _indicators(10)
    assert ours.accuracy_score(t, p) == sk.accuracy_score(t, p)
    for args, kw in (((t, p), {"average": "binary"}), ((t, p[:, 0]), {"average": "macro"}),
                     ((t[:, 0], p[:, 0]), {"average": "samples"})):
        with pytest.raises(ValueError) as theirs:
            sk.f1_score(*args, **kw)
        with pytest.raises(ValueError) as mine:
            ours.f1_score(*args, **kw)
        assert str(mine.value) == str(theirs.value)


# -- the CLIs ------------------------------------------------------------------------

def _gmu_yaml(root: Path) -> Path:
    text = GMU_CFG.read_text()
    for old, new in (("num_samples: 256", "num_samples: 100"), ("num_samples: 64", "num_samples: 40")):
        text = text.replace(old, new)
    path = root / "gmu.yaml"
    path.write_text(text)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' `train_multimodal` and `predict` in their own
    directories; the port from mmtpu's initial weights, no dropout in either."""
    mp = pytest.MonkeyPatch()
    captured = {}
    real_state = jax_common.make_state

    def jax_make_state(model, params, batch_stats, training, clip=None):
        captured["v"] = _np({"params": params, "batch_stats": batch_stats})
        return real_state(model, params, batch_stats, training, clip=clip)

    def port_init(model, seed, device):
        v = captured["v"]
        model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"], target=model),
                              strict=True)
        torch.manual_seed(int(seed))
        return model.to(device)

    out = {}
    try:
        mp.setattr(jax_common, "make_state", jax_make_state)
        mp.setattr(common, "init_model", port_init)
        mp.setattr(jax_mmimdb, "nn", _NoDropoutLinen("flax.linen"))
        mp.setattr(port_rng.GeneratorDropout, "forward", lambda self, x: x)
        for pkg in ("mmtpu", "mmtpu_torch"):
            root = tmp_path_factory.mktemp(f"mmimdb_{pkg}")
            cfg = _gmu_yaml(root)
            assert run_cli_inproc(f"{pkg}.cli.train_multimodal", cfg, run_id="1",
                                  cwd=root) == 0
            pred = root / "preds.json"
            assert run_cli_inproc(f"{pkg}.cli.predict", cfg, run_id="1",
                                  extra=("--out", str(pred)), cwd=root) == 0
            out[pkg] = (root, cfg)
    finally:
        mp.undo()
    yield out
    for root, _ in out.values():
        shutil.rmtree(root, ignore_errors=True)


def _values(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _values(v, f"{prefix}/{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _values(v, f"{prefix}[{i}]")
    else:
        yield prefix, obj


def _files(root: Path):
    return sorted(p.relative_to(root).as_posix().replace(".pth", "·").replace(".ckpt", "·")
                  for p in root.rglob("*") if p.is_file() and "/report/" not in p.as_posix())


def test_train_writes_mmtpus_files(runs):
    ours_, theirs = (_files(runs[pkg][0] / "experiments_output")
                     for pkg in ("mmtpu_torch", "mmtpu"))
    assert ours_ == theirs
    assert f"{NAME}/models/1/best·" in ours_


@pytest.mark.parametrize("record", ["epoch_metrics", "test_metrics"])
def test_records_match_mmtpu(runs, record):
    path = f"experiments_output/{NAME}/metrics/1/{record}.json"
    mine, theirs = (json.loads((runs[pkg][0] / path).read_text())
                    for pkg in ("mmtpu_torch", "mmtpu"))
    a, b = list(_values(mine)), list(_values(theirs))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path_a, x), (_, y) in zip(a, b):
        if "/timing/" in path_a:
            continue
        if isinstance(y, float):
            assert abs(x - y) <= VALUE_TOL * max(abs(y), 1.0), (path_a, x, y)
        else:
            assert x == y, (path_a, x, y)
    if record == "test_metrics":
        keys = {k for _, k in (p.rsplit("/", 1) for p, _ in a)}
        assert {f"f1_{avg}_{pat}" for avg in ("samples", "macro", "micro")
                for pat in ("IT", "I", "T")} <= keys


def test_predict_writes_mmtpus_multilabel_records(runs):
    mine, theirs = (json.loads((runs[pkg][0] / "preds.json").read_text())
                    for pkg in ("mmtpu_torch", "mmtpu"))
    assert mine["accuracy_per_pattern"] == theirs["accuracy_per_pattern"]
    assert len(mine["predictions"]) == len(theirs["predictions"]) == 120
    assert mine["predictions"] == theirs["predictions"]
    assert len(mine["predictions"][0]["pred"]) == 23


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_answers_multilabel_requests(runs, monkeypatch):
    from mmtpu_torch.cli import serve

    root, cfg = runs["mmtpu_torch"]
    monkeypatch.chdir(root)
    predictor, meta = serve.load_model(serve.arg_parser().parse_args(
        ["--config", str(cfg), "--cpu"]))
    assert meta["multilabel"] is True and meta["input_keys"] == ["image", "text"]
    g = np.random.default_rng(4)
    image = g.normal(size=(3, 4096)).astype(np.float32)
    text = g.normal(size=(3, 300)).astype(np.float32)
    text[1] = 0.0  # text missing
    direct = predictor(image=image, text=text)
    with serve.ServerThread(predictor, meta, max_batch=4, max_wait_ms=20.0) as st:
        rows = [_post(f"{st.url}/predict", {"image": image[i].tolist(),
                                             "text": text[i].tolist()}) for i in range(3)]
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{st.url}/predict", {"image": image[0].tolist()})
        err.value.close()
        assert err.value.code == 400
    for i, row in enumerate(rows):
        np.testing.assert_allclose(row["logits"], direct["logits"][i], rtol=TOL, atol=TOL)
        assert row["preds"] == direct["preds"][i].tolist() and len(row["preds"]) == 23
        np.testing.assert_allclose(row["probs"], 1 / (1 + np.exp(-direct["logits"][i])),
                                   rtol=1e-5)
