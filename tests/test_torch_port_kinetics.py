"""The port's Kinetics-Sounds (mmtpu_torch.data.kinetics_sounds,
models.kinetics_sounds, the `kineticssounds` model type through the CLIs)
against mmtpu's on the CPU:

- the reader, on CSVs this test writes over the repository's
  `DATA/kinetics-sounds/tensors` files (the repository's own CSVs hold
  absolute paths of another checkout), with `labels_key: class`: arrays,
  labels and masks equal to mmtpu's bit for bit; mmtpu's errors for a
  missing file and a missing column; a `.parquet` index raises;
- the eval forward from mmtpu's weights carried by `from_jax_variables`
  (the flatten cropped and zero-padded, NHWC input, an embedding in place of
  either input, an absent modality): 1e-5;
- three train steps at dropout 0 in float64 (BatchNorm), the third with a
  zero-padded tail: loss, gradients within 1e-5 of each parameter's norm,
  then parameters and running statistics 1e-5;
- a YAML twin (ConvBlocks of 3-6 channels, 40/16/16 clips, batch 16, 2
  epochs, dropout 0) through both packages' `train_multimodal` from the
  same initial weights: the same files, the same JSON keys, every value at
  1e-4; `predict` on both (the same records); the port's `serve` on its
  run.
"""

import csv
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

from mmtpu.cli import common as jax_common
from mmtpu.config.training import TrainingConfig as JaxTrainingConfig
from mmtpu.data.kinetics_sounds import KineticsSounds as JaxKineticsSounds
from mmtpu.models.registry import build_module as jax_build
from mmtpu.train import losses as jax_losses
from mmtpu.train.step import ClassificationTask as JaxTask
from mmtpu.train.step import train_step_core as jax_train_step_core
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.cli import common
from mmtpu_torch.config.training import TrainingConfig
from mmtpu_torch.data import KineticsSounds, resolve_dataset_name
from mmtpu_torch.models import build_module
from mmtpu_torch.modalities import Modality
from mmtpu_torch.train import losses
from mmtpu_torch.train.step import ClassificationTask, make_train_step
from test_torch_port_cmam import _carry, _perturb
from test_torch_port_export import _ks

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cli_harness import run_cli_inproc  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
KS_DIR = REPO / "DATA/kinetics-sounds"
TOL = 1e-5
VALUE_TOL = 1e-4
CPU = torch.device("cpu")
NAME = "Tiny_KineticsSounds"


def write_csvs(root: Path, counts: dict) -> dict:
    """The first rows of the repository's split CSVs, their tensor paths
    resolved against this checkout."""
    out = {}
    for split, n in counts.items():
        with open(KS_DIR / f"{split}.csv", newline="") as f:
            rows = list(csv.reader(f))
        path = root / f"{split}.csv"
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(rows[0])
            for audio, video, label in rows[1:n + 1]:
                w.writerow([KS_DIR / "tensors" / Path(audio).name,
                            KS_DIR / "tensors" / Path(video).name, label])
        out[split] = path
    return out


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    return write_csvs(tmp_path_factory.mktemp("ks_csv"),
                      {"train": 40, "validation": 16, "test": 16})


def test_reader_is_bit_identical_to_mmtpus(csvs):
    for split, path in csvs.items():
        kw = dict(labels_key="class", selected_patterns=["av", "a", "v"], seed=3)
        ours = KineticsSounds(path, split, **kw)
        theirs = JaxKineticsSounds(path, split, **kw)
        for mod in ("audio", "video"):
            a, b = ours.arrays[Modality(mod)], theirs.arrays[mod]
            assert a.dtype == b.dtype == np.float32 and a.flags["C_CONTIGUOUS"]
            assert np.array_equal(a, b), (split, mod)
        assert ours.arrays[Modality("audio")].shape[1:] == (128, 128)
        assert ours.arrays[Modality("video")].shape[1:] == (400,)
        assert ours.labels.dtype == np.int64 and np.array_equal(ours.labels, theirs.labels)
        assert ours.pattern_vocab() == theirs.pattern_vocab() == ["av", "a", "v"]
        for p in ours.selected_patterns:
            for mod in ("audio", "video"):
                assert np.array_equal(ours.masks[p][Modality(mod)], theirs.masks[p][mod])
    assert resolve_dataset_name("kinetics_sounds") is KineticsSounds


def test_reader_errors_are_mmtpus(csvs, tmp_path):
    for cls in (KineticsSounds, JaxKineticsSounds):
        with pytest.raises(ValueError, match="Key not found in the dataset: label"):
            cls(csvs["test"], "test")
        with pytest.raises(FileNotFoundError, match="File not found"):
            cls(tmp_path / "absent.csv", "test", labels_key="class")
    parquet = tmp_path / "test.parquet"
    parquet.write_bytes(b"")
    with pytest.raises(ValueError, match="parquet"):
        KineticsSounds(parquet, "test", labels_key="class")


def _pair(fc_one_input_size=16, dropout=None):
    jm, pm = _ks(jax_build, dropout), _ks(build_module, dropout)
    if fc_one_input_size != 16:
        jm = jm.clone(audio_encoder=jm.audio_encoder.clone(fc_one_input_size=fc_one_input_size))
        pm.audio_encoder = build_module(
            "kinetics_sounds_audio_encoder", conv_block_one=pm.audio_encoder.conv_block_one,
            conv_block_two=pm.audio_encoder.conv_block_two,
            conv_block_three=pm.audio_encoder.conv_block_three,
            fc_one_input_size=fc_one_input_size, fc_one_output_size=10, fc_two_output_size=8)
    return jm, pm


def _inputs(seed, B=5):
    g = np.random.default_rng(seed)
    return (g.normal(size=(B, 64, 64)).astype(np.float32),
            g.normal(size=(B, 400)).astype(np.float32))


CALLS = {
    "both": lambda a, v, ea, ev: ((a, v), {}),
    "nhwc": lambda a, v, ea, ev: ((a[..., None], v), {}),
    "embedding_A": lambda a, v, ea, ev: ((ea, v), {"is_embd_A": True}),
    "embedding_V": lambda a, v, ea, ev: ((a, ev), {"is_embd_V": True}),
    "missing_A": lambda a, v, ea, ev: ((None, v), {"is_embd_A": True}),
    "missing_V": lambda a, v, ea, ev: ((a, None), {"is_embd_V": True}),
}


@pytest.mark.parametrize("width", [8, 16], ids=["cropped", "padded"])
@pytest.mark.parametrize("call", list(CALLS))
def test_eval_forward_matches_mmtpu(call, width):
    jm, pm = _pair(width)
    audio, video = _inputs(1)
    g = np.random.default_rng(2)
    emb_a, emb_v = g.normal(size=(5, 8)).astype(np.float32), g.normal(size=(5, 6)).astype(
        np.float32)
    v = _perturb(dict(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(audio),
                              jnp.asarray(video))), 3)
    _carry(v, pm).eval()
    to_t = (lambda x: None if x is None else torch.from_numpy(np.ascontiguousarray(x)))
    to_j = (lambda x: None if x is None else jnp.asarray(x))
    (ja, jv), kw = CALLS[call](*(to_j(x) for x in (audio, video, emb_a, emb_v)))
    (pa, pv), _ = CALLS[call](*(to_t(x) for x in (audio, video, emb_a, emb_v)))
    want = jm.apply(v, ja, jv, train=False, **kw)
    with torch.no_grad():
        got = pm(pa, pv, **kw)
        embeddings = pm.encode(pa, pv) if call == "both" else None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    if call == "both":
        ea, ev = (t.numpy() for t in embeddings)
        wa, wv = jm.apply(v, ja, jv, method="encode")
        np.testing.assert_allclose(ea, np.asarray(wa), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ev, np.asarray(wv), rtol=TOL, atol=TOL)


TRAINING = {
    "epochs": 1, "num_modalities": 2,
    "optimizer": {"name": "Adam", "default_kwargs": {"lr": 1e-3, "weight_decay": 1e-4,
                                                     "eps": 1e-3}},
    "loss_functions": {"cross_entropy": {"loss_name": "cross_entropy", "loss_args": {},
                                         "weight": 1.0}},
}


def _batch(seed, B=6, padded_from=None):
    g = np.random.default_rng(seed)
    labels = g.integers(0, 26, size=B).astype(np.int64)
    audio, video = _inputs(seed, B)
    batch = {"audio": (audio + 0.05 * labels[:, None, None]).astype(np.float64),
             "video": (video + 0.05 * labels[:, None]).astype(np.float64),
             "audio_mask": np.ones(B, np.float64), "video_mask": np.ones(B, np.float64),
             "labels": labels, "pattern_id": np.zeros(B, np.int32),
             "sample_mask": np.ones(B, np.float64)}
    batch["audio_mask"][1] = 0.0
    batch["video_mask"][2] = 0.0
    if padded_from is not None:
        for k in ("audio", "video", "labels", "audio_mask", "video_mask", "sample_mask"):
            batch[k][padded_from:] = 0
    return batch


@pytest.fixture(scope="module")
def ks_steps():
    jm, pm = _pair(dropout=0.0)
    v = _perturb(dict(jm.init({"params": jax.random.PRNGKey(0)}, *map(jnp.asarray, _inputs(0)),
                              train=False)), 4)
    _carry(v, pm).double()
    group = TRAINING["loss_functions"]
    pstate = common.make_state(pm, TrainingConfig.from_dict(TRAINING))
    ptask = ClassificationTask(model=pm, loss_group=losses.LossFunctionGroup.from_dict(group),
                               input_keys=["audio", "video"])
    pstep = make_train_step(ptask, pstate, CPU)
    jtask = JaxTask(model=jm, loss_group=jax_losses.LossFunctionGroup.from_dict(group),
                    input_keys=["audio", "video"])
    record = []
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        jstate = jax_common.make_state(jm, v64["params"], v64["batch_stats"],
                                       JaxTrainingConfig.from_dict(TRAINING))
        step = jax.jit(lambda s, b: jax_train_step_core(jtask, s, b, jax.random.PRNGKey(1)))
        for b in (_batch(1), _batch(2), _batch(3, padded_from=4)):
            jstate, jloss, _, jgrads, _ = step(jstate, {k: jnp.asarray(a) for k, a in b.items()})
            ploss = float(pstep(b)["loss"])
            record.append((float(jloss), jax.tree_util.tree_map(np.asarray, jgrads), ploss,
                           {n: p.grad.clone() for n, p in pm.named_parameters()}))
        jfinal = jax.tree_util.tree_map(np.asarray, (jstate.params, jstate.batch_stats))
    return {"record": record, "jfinal": jfinal, "pstate": pstate}


@pytest.mark.parametrize("k", [0, 1, 2])
def test_train_step_matches_mmtpu(ks_steps, k):
    jloss, jgrads, ploss, pgrads = ks_steps["record"][k]
    np.testing.assert_allclose(ploss, jloss, rtol=TOL, atol=TOL)
    want = from_jax_variables(jgrads, target=ks_steps["pstate"].model, require_all=False)
    assert set(want) == set(pgrads)
    for name, g in pgrads.items():
        w = want[name].double().numpy()
        err = np.abs(g.numpy() - w).max()
        assert err <= TOL * np.linalg.norm(w) + 1e-12, (name, err)


def test_state_after_three_steps_matches_mmtpu(ks_steps):
    params, stats = ks_steps["jfinal"]
    model = ks_steps["pstate"].model
    got = model.state_dict()
    for k, w in from_jax_variables(params, stats, target=model).items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 3, k
            continue
        np.testing.assert_allclose(got[k].numpy(), w.double().numpy(), rtol=0, atol=TOL,
                                   err_msg=k)


# -- both packages' CLIs on a YAML twin ---------------------------------------------

def _block(i, o, indent):
    pad = " " * indent
    return (f"!ConvBlock\n{pad}conv_block_one_args: !ConvBlockArgs {{conv_one_in: {i}, "
            f"conv_one_out: {o}}}\n{pad}conv_block_two_args: !ConvBlockArgs "
            f"{{conv_one_in: {o}, conv_one_out: {o}}}")


def _split(name, path, batch, patterns, extra=""):
    return f"""    {name}: !DatasetConfig
      dataset: "kinetics_sounds"
      data_fp: "{path}"
      split: "{'valid' if name == 'validation' else name}"
      target_modality: !Modality "MULTIMODAL"
      batch_size: {batch}{extra}
      kwargs:
        labels_key: "class"
      missing_patterns: !MissingPatternConfig
        modalities:
          !Modality audio: !ModalityConfig
            missing_rate: 0.0
          !Modality video: !ModalityConfig
            missing_rate: 0.0
        selected_patterns: {json.dumps(patterns)}"""


def ks_yaml(root: Path, csv_paths: dict) -> Path:
    """A twin of a Kinetics-Sounds baseline: the model at narrow widths (a
    128 × 128 spectrogram pools to 4 × 2, so 3 channels flatten to 24),
    dropout 0, two epochs."""
    text = f"""!StandardConfig
experiment: !ExperimentConfig
  name: "{NAME}"
  seed: 42
  device: "tpu"
  is_train: true
  is_test: true
model: !ModelConfig
  name: "KineticsSounds"
  model_type: "kineticssounds"
  audio_encoder: !KineticsSoundsAudioEncoder
    conv_block_one: {_block(1, 2, 6)}
    conv_block_two: {_block(2, 3, 6)}
    conv_block_three: {_block(3, 3, 6)}
    dropout_one: 0.0
    dropout_two: 0.0
    fc_one_input_size: 24
    fc_one_output_size: 8
    fc_two_output_size: 8
  video_encoder: !KineticsSoundsVideoEncoder
    hidden_dim_one: 16
    hidden_dim_two: 8
    dropout: 0.0
  hidden_dim_one: 12
  hidden_dim_two: 8
  dropout: 0.0
training:
  epochs: 2
  early_stopping: false
  num_modalities: 2
  optimizer: !Optimizer
    name: "Adam"
    default_kwargs: {{lr: 0.001, weight_decay: 0.0001, eps: 0.001}}
  loss_functions: !LossFunctionGroup
    cross_entropy: {{loss_name: "cross_entropy", loss_args: {{}}, weight: 1.0}}
data: !DataConfig
  datasets:
{_split("train", csv_paths["train"], 16, ["av"], chr(10) + "      shuffle: true")}
{_split("validation", csv_paths["validation"], 16, ["av", "a", "v"])}
{_split("test", csv_paths["test"], 16, ["av", "a", "v"])}
metrics:
  metrics:
    accuracy: {{function: "sklearn.metrics.accuracy_score", kwargs: {{}}}}
    f1_weighted: {{function: "sklearn.metrics.f1_score",
                  kwargs: {{average: "weighted", zero_division: 0}}}}
  groups:
    classification: ["accuracy", "f1_weighted"]
logging:
  log_path: "{root}/out/{{experiment_name}}/logs/{{run_id}}"
  model_output_path: "{root}/out/{{experiment_name}}/models/{{run_id}}"
  metrics_path: "{root}/out/{{experiment_name}}/metrics/{{run_id}}"
  save_metric: "loss"
monitoring:
  enabled: false
"""
    path = root / "ks.yaml"
    path.write_text(text)
    return path


@pytest.fixture(scope="module")
def runs(csvs, tmp_path_factory):
    """Both packages' train_multimodal and predict, the port from mmtpu's
    initial weights."""
    mp = pytest.MonkeyPatch()
    captured = {}
    real_state = jax_common.make_state

    def jax_make_state(model, params, batch_stats, training, clip=None):
        captured["v"] = jax.tree_util.tree_map(np.asarray, {"params": params,
                                                            "batch_stats": batch_stats})
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
        for pkg in ("mmtpu", "mmtpu_torch"):
            root = tmp_path_factory.mktemp(f"ks_{pkg}")
            cfg = ks_yaml(root, csvs)
            assert run_cli_inproc(f"{pkg}.cli.train_multimodal", cfg, run_id="1",
                                  cwd=root) == 0
            assert run_cli_inproc(f"{pkg}.cli.predict", cfg, run_id="1",
                                  extra=("--out", str(root / "preds.json")), cwd=root) == 0
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
    ours, theirs = (_files(runs[pkg][0] / "out") for pkg in ("mmtpu_torch", "mmtpu"))
    assert ours == theirs
    assert f"{NAME}/models/1/best·" in ours


@pytest.mark.parametrize("record", ["epoch_metrics", "train_metrics", "validation_metrics",
                                    "test_metrics"])
def test_records_match_mmtpu(runs, record):
    path = f"out/{NAME}/metrics/1/{record}.json"
    mine, theirs = (json.loads((runs[pkg][0] / path).read_text())
                    for pkg in ("mmtpu_torch", "mmtpu"))
    a, b = list(_values(mine)), list(_values(theirs))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path_a, x), (_, y) in zip(a, b):
        if "/timing/" in path_a or path_a.endswith(("_time", "/time")):
            continue
        if isinstance(y, float):
            assert abs(x - y) <= VALUE_TOL * max(abs(y), 1.0), (path_a, x, y)
        else:
            assert x == y, (path_a, x, y)


def test_predict_matches_mmtpu(runs):
    mine, theirs = (json.loads((runs[pkg][0] / "preds.json").read_text())
                    for pkg in ("mmtpu_torch", "mmtpu"))
    assert len(mine["predictions"]) == 48
    assert mine["accuracy_per_pattern"] == theirs["accuracy_per_pattern"]
    assert mine["predictions"] == theirs["predictions"]
    assert set(mine["accuracy_per_pattern"]) == {"a", "av", "v"}


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_answers_kinetics_sounds_requests(runs):
    from mmtpu_torch.cli import serve

    _, cfg = runs["mmtpu_torch"]
    predictor, meta = serve.load_model(serve.arg_parser().parse_args(
        ["--config", str(cfg), "--run_id", "1", "--cpu"]))
    assert meta["input_keys"] == ["audio", "video"]
    assert meta["input_shapes"] == [["b", 128, 128], ["b", 400]]
    g = np.random.default_rng(5)
    audio = g.normal(size=(3, 128, 128)).astype(np.float32)
    video = g.normal(size=(3, 400)).astype(np.float32)
    video[1] = 0.0  # the video missing
    direct = predictor(audio=audio, video=video)
    with serve.ServerThread(predictor, meta) as st:
        for i in range(3):
            ans = _post(f"{st.url}/predict", {"audio": audio[i].tolist(),
                                              "video": video[i].tolist()})
            np.testing.assert_allclose(ans["logits"], direct["logits"][i], rtol=1e-5,
                                       atol=1e-5)
            assert len(ans["probs"]) == 26
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{st.url}/predict", {"audio": audio[0].tolist()})
        assert e.value.code == 400
