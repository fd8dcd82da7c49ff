"""The port's `train_cmam` against mmtpu's, end to end on the CPU.

A tiny twin of configs/avmnist/cmam_audio_to_image.yaml (the same sections,
loss weights, metrics and groups; MNIST encoders of 3-4 channels in place of
the ResNets, 40 train and 24 validation and test samples of
`synthetic_avmnist` in batches of 16, dropout 0, Adam eps 1e-3): each
package first trains its frozen base with its own `train_multimodal` (the
port from mmtpu's initial weights, carried), then `train_cmam` restores it
from `pretrained_path` (the `.ckpt` spelling) and trains the C-MAM, the
port from mmtpu's initial C-MAM weights. Held equal: the files each run
writes, the key structure of every metrics JSON (the nested
`classification` and `reconstruction` groups, `loss`, the term columns of
validation and test), every value of `{train,validation,test}_metrics.json`
at 1e-4, and the checkpoint set under the port's `.pth` names. The port is
held to itself: a run resumed after epoch 1 of 2 ends where an
uninterrupted run ends.

configs/mosi/synthetic_dual_cmam.yaml runs through the port's CLI as it
is: its records carry the keys mmtpu's run of the same file writes
(`index`, `classification` {loss, accuracy_ATV}, `reconstruction` {loss},
`loss`, `split`, `Epoch`; DualCMAM's eval step gives no term columns).
"""

import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mmtpu.cli import common as jax_common
from mmtpu_torch.checkpoints import from_jax_variables
from mmtpu_torch.cli import common

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cli_harness import run_cli_inproc  # noqa: E402
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

BASE, CMAM = "Tiny_AVMNIST_Base", "Tiny_AVMNIST_CMAM_A_to_I"
VALUE_TOL = 1e-4


def _encoder(tag, hidden, indent):
    pad = " " * indent
    blocks = (("one_one", 1, 3), ("one_two", 3, 3), ("two_one", 3, 4), ("two_two", 4, 4))
    lines = [f"{tag}", f"{pad}hidden_dim: {hidden}"] + [
        f"{pad}conv_block_{name}_args: {{conv_one_in: {i}, conv_one_out: {o}}}"
        for name, i, o in blocks]
    return "\n".join(lines)


def _splits(batch, train_patterns, eval_patterns):
    out = []
    for split, n, patterns, extra in (("train", 40, train_patterns, "\n      shuffle: true"),
                                      ("validation", 24, eval_patterns, ""),
                                      ("test", 24, eval_patterns, "")):
        out.append(f"""    {split}: !DatasetConfig
      dataset: "synthetic_avmnist"
      data_fp: "unused"
      split: "{'valid' if split == 'validation' else split}"
      target_modality: !Modality "MULTIMODAL"
      batch_size: {batch}{extra}
      kwargs:
        num_samples: {n}
      missing_patterns: !MissingPatternConfig
        modalities:
          !Modality audio: !ModalityConfig
            missing_rate: 0.0
          !Modality image: !ModalityConfig
            missing_rate: 0.0
        selected_patterns: {json.dumps(patterns)}""")
    return "\n".join(out)


def _logging(root):
    return f"""logging:
  log_path: "{root}/{{experiment_name}}/logs/{{run_id}}"
  model_output_path: "{root}/{{experiment_name}}/models/{{run_id}}"
  metrics_path: "{root}/{{experiment_name}}/metrics/{{run_id}}"
  save_metric: "loss"

monitoring:
  enabled: false
"""


def _base_yaml(root: Path) -> Path:
    text = f"""!StandardConfig
experiment: !ExperimentConfig
  name: "{BASE}"
  seed: 42
  device: "tpu"

model: !ModelConfig
  name: "{BASE}"
  model_type: "AVMNIST"
  audio_encoder: {_encoder("!MNISTAudio", 6, 4)}
  image_encoder: {_encoder("!MNISTImage", 8, 4)}
  hidden_dim: 12
  dropout: 0.0
  fusion_fn: "concat"

training:
  epochs: 1
  num_modalities: 2
  optimizer: !Optimizer
    name: "Adam"
    default_kwargs: {{lr: 0.001, eps: 0.001}}
  loss_functions: !LossFunctionGroup
    cross_entropy: {{loss_name: "cross_entropy", loss_args: {{}}, weight: 1.0}}

data: !DataConfig
  datasets:
{_splits(16, ["ai"], ["ai"])}

metrics:
  metrics:
    accuracy: {{function: "sklearn.metrics.accuracy_score", kwargs: {{}}}}
  groups:
    classification: ["accuracy"]

{_logging(root)}"""
    path = root / "base.yaml"
    path.write_text(text)
    return path


def _cmam_yaml(root: Path) -> Path:
    """cmam_audio_to_image.yaml's sections at tiny widths."""
    text = f"""!CMAMConfig
experiment: !ExperimentConfig
  name: "{CMAM}"
  seed: 42
  device: "tpu"
  is_train: true
  is_test: true

model: !ModelConfig
  name: "AVMNIST"
  model_type: "AVMNIST"
  audio_encoder: {_encoder("!MNISTAudio", 6, 4)}
  image_encoder: {_encoder("!MNISTImage", 8, 4)}
  hidden_dim: 12
  dropout: 0.0
  fusion_fn: "concat"
  pretrained_path: "{root}/{BASE}/models/{{run_id}}/best.ckpt"

cmam: !ModelConfig
  name: "CMAM"
  model_type: "CMAM"
  target_modality: !Modality image
  load_pretrained_encoder_state_for: ["audio"]
  input_encoders: !InputEncoders
    !Modality audio: {_encoder("!MNISTAudio", 6, 6)}
  association_network: !AssociationNetwork
    input_size: 6
    hidden_size: 16
    output_size: 8
    dropout: 0.0
    batch_norm: True

target_modality: image

training:
  epochs: 2
  early_stopping: false
  num_modalities: 2
  optimizer: !Optimizer
    name: "Adam"
    default_kwargs:
      lr: 0.001
      weight_decay: 0.0001
      eps: 0.001
  loss_functions: !LossFunctionGroup
    cmam:
      loss_name: "cmam"
      loss_kwargs:
        cosine_weight: 1.0
        mae_weight: 1.0
        mse_weight: 1.0
        cls_weight: 0.005
      weight: 1.0

data: !DataConfig
  datasets:
{_splits(16, ["ai"], ["ai"])}

metrics:
  metrics:
    accuracy:
      function: "sklearn.metrics.accuracy_score"
      kwargs: {{}}
    cosine_sim:
      function: "metrics.cosine_similarity"
      kwargs: {{}}
    mse:
      function: "sklearn.metrics.mean_squared_error"
      kwargs: {{}}
  groups:
    classification: ["accuracy"]
    reconstruction: ["cosine_sim", "mse"]

{_logging(root)}"""
    path = root / "cmam.yaml"
    path.write_text(text)
    return path


def _structure(obj):
    if isinstance(obj, dict):
        return {k: _structure(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_structure(v) for v in obj]
    return "·"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages: base, then C-MAM. The port takes mmtpu's initial
    weights for its base and its C-MAM; the port's C-MAM model is kept."""
    mp = pytest.MonkeyPatch()
    out, captured = {}, {}
    real_init, real_state = jax_common.init_model, jax_common.make_state

    def jax_init(model, sample, seed):
        params, stats = real_init(model, sample, seed)
        captured["base"] = jax.tree_util.tree_map(np.asarray, {"params": params,
                                                               "batch_stats": stats})
        return params, stats

    def jax_make_state(model, params, batch_stats, training, clip=None):
        if type(model).__name__ == "CMAM":  # after train_cmam's encoder copy
            captured["cmam"] = jax.tree_util.tree_map(np.asarray, {
                "params": params, "batch_stats": batch_stats})
        return real_state(model, params, batch_stats, training, clip=clip)

    def port_init(model, seed, device):
        key = "cmam" if type(model).__name__ == "CMAM" else "base"
        v = captured[key]
        model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"] or None,
                                                 target=model), strict=True)
        torch.manual_seed(int(seed))
        if key == "cmam":
            captured["port_cmam"] = model
        return model.to(device)

    try:
        mp.setattr(jax_common, "init_model", jax_init)
        mp.setattr(jax_common, "make_state", jax_make_state)
        mp.setattr(common, "init_model", port_init)
        for pkg in ("mmtpu", "mmtpu_torch"):
            root = tmp_path_factory.mktemp(f"cmam_{pkg}")
            base_cfg, cmam_cfg = _base_yaml(root), _cmam_yaml(root)
            if pkg == "mmtpu_torch":  # the port's base from mmtpu's initial weights
                captured["base"] = captured["base_initial"]
            assert run_cli_inproc(f"{pkg}.cli.train_multimodal", base_cfg, run_id="1") == 0
            captured.setdefault("base_initial", captured["base"])
            assert run_cli_inproc(f"{pkg}.cli.train_cmam", cmam_cfg, run_id="1") == 0
            out[pkg] = {"root": root, "cmam_cfg": cmam_cfg}
    finally:
        mp.undo()
    out["initial"] = captured["cmam"]
    out["model"] = captured["port_cmam"]
    yield out
    for pkg in ("mmtpu", "mmtpu_torch"):
        shutil.rmtree(out[pkg]["root"], ignore_errors=True)


def _files(root: Path, name: str):
    return sorted(p.relative_to(root / name).as_posix()
                  for p in (root / name).rglob("*") if p.is_file())


def test_cmam_run_writes_mmtpus_files(runs):
    def names(pkg):
        return sorted(n.replace(".pth", "·").replace(".ckpt", "·")
                      for n in _files(runs[pkg]["root"], CMAM))

    ours, theirs = names("mmtpu_torch"), names("mmtpu")
    assert ours == theirs
    assert {"models/1/best·", "models/1/last·", "models/1/resume.json",
            "metrics/1/test_metrics.json", "metrics/1/report/report.tex"} <= set(ours)


@pytest.mark.parametrize("split", ["train", "validation", "test"])
def test_split_records_match_mmtpu(runs, split):
    """Keys, their order, the nested groups and every value at 1e-4."""
    path = f"{CMAM}/metrics/1/{split}_metrics.json"
    ours = json.loads((runs["mmtpu_torch"]["root"] / path).read_text())
    theirs = json.loads((runs["mmtpu"]["root"] / path).read_text())
    assert _structure(ours) == _structure(theirs)
    assert [list(r) for r in ours] == [list(r) for r in theirs]
    for a, b in zip(ours, theirs):
        for key in ("classification", "reconstruction"):
            assert list(a[key]) == list(b[key]), key
        assert list(a["reconstruction"]) == ["loss", "cosine_sim_AI", "mse_AI"]
    first = ours[0]
    assert set(first) == {"index", "classification", "reconstruction", "loss", "split",
                          "cosine", "mae", "mse", "cls_loss"} | ({"Epoch"} if split != "test"
                                                                  else set())
    if split == "train":  # the train records carry no term means, as in mmtpu
        assert all(r[k] is None for r in ours for k in ("cosine", "mae", "mse", "cls_loss"))

    def values(obj, prefix=""):
        if isinstance(obj, dict):
            for k, v in obj.items():
                yield from values(v, f"{prefix}/{k}")
        elif isinstance(obj, list):
            for i, v in enumerate(obj):
                yield from values(v, f"{prefix}[{i}]")
        else:
            yield prefix, obj

    for (path_a, a), (path_b, b) in zip(values(ours), values(theirs)):
        assert path_a == path_b
        if isinstance(b, float):
            assert abs(a - b) <= VALUE_TOL * max(abs(b), 1.0), (path_a, a, b)
        else:
            assert a == b, (path_a, a, b)


def test_epoch_metrics_match_mmtpus_structure(runs):
    path = f"{CMAM}/metrics/1/epoch_metrics.json"
    ours = json.loads((runs["mmtpu_torch"]["root"] / path).read_text())
    theirs = json.loads((runs["mmtpu"]["root"] / path).read_text())
    assert _structure(ours) == _structure(theirs)
    assert set(ours[0]["validation"]["metrics"]) >= {"cosine", "mae", "mse", "cls_loss"}


def test_resume_after_one_epoch_ends_as_an_uninterrupted_run(runs, tmp_path):
    """--epochs 1, then --resume with the config's 2 epochs, from the same
    initial C-MAM: last.pth's weights, Adam moments, generator state and the
    nested history equal the uninterrupted run's."""
    src = runs["mmtpu_torch"]["root"]
    shutil.copytree(src / BASE, tmp_path / BASE)
    cfg = _cmam_yaml(tmp_path)
    initial = runs["initial"]

    def init_model(model, seed, device):
        if type(model).__name__ == "CMAM":
            model.load_state_dict(from_jax_variables(
                initial["params"], initial["batch_stats"], target=model), strict=True)
        torch.manual_seed(int(seed))
        return model.to(device)

    mp = pytest.MonkeyPatch()
    mp.setattr(common, "init_model", init_model)
    try:
        assert run_cli_inproc("mmtpu_torch.cli.train_cmam", cfg, run_id="1",
                              extra=("--epochs", "1")) == 0
        assert run_cli_inproc("mmtpu_torch.cli.train_cmam", cfg, run_id="1",
                              extra=("--resume",)) == 0
    finally:
        mp.undo()
    want = torch.load(src / CMAM / "models/1/last.pth", weights_only=False)
    got = torch.load(tmp_path / CMAM / "models/1/last.pth", weights_only=False)
    for k, v in want["model"].items():
        torch.testing.assert_close(got["model"][k], v, rtol=0, atol=0, msg=k)
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(got["optimizer"]["state"][i][k], v, rtol=0, atol=0)
    assert torch.equal(got["generator"], want["generator"])
    meta = [json.loads(m["resume_meta"]) for m in (got, want)]
    assert meta[0]["metrics_history_nested"] == meta[1]["metrics_history_nested"]
    assert len(meta[0]["metrics_history_nested"]["validation"]) == 2


def test_export_serving_writes_a_cmam_artifact(runs, tmp_path):
    """`--export-serving PATH` writes the best checkpoint's C-MAM with the
    frozen base as one artifact: mmtpu's C-MAM meta, the available modality
    in, and answers within 1e-5 of the C-MAM serving function over the
    restored base and the best checkpoint's C-MAM, at a batch size other
    than the export's."""
    from mmtpu_torch.cli import train_cmam
    from mmtpu_torch.config.cmam import CMAMConfig
    from mmtpu_torch.serving import load_artifact, make_cmam_serving_fn

    shutil.copytree(runs["mmtpu_torch"]["root"] / BASE, tmp_path / BASE)
    cfg = _cmam_yaml(tmp_path)
    out = tmp_path / "cmam.mmx"
    assert run_cli_inproc("mmtpu_torch.cli.train_cmam", cfg, run_id="1",
                          extra=("--epochs", "1", "--export-serving", str(out))) == 0
    served = load_artifact(out, "cpu")
    meta = served.meta
    assert (meta["task_type"], meta["imputes"], meta["base_model"], meta["model"]) == (
        "cmam", ["image"], "AVMNIST", "CMAM")
    assert meta["input_keys"] == ["audio"] and meta["config"] == str(cfg)
    assert meta["outputs"] == ["logits", "preds", "probs", "rec_embd"]

    built = train_cmam.assemble(CMAMConfig.load(cfg, run_id=1), torch.device("cpu"))
    best = torch.load(tmp_path / CMAM / "models/1/best.pth", weights_only=False)
    built.cmam.load_state_dict(best["model"])
    audio = np.random.default_rng(3).normal(size=(5, 32, 94)).astype(np.float32)
    got = served(audio=audio)
    with torch.no_grad():
        want = make_cmam_serving_fn(built.task)(torch.from_numpy(audio))
    assert set(got) == set(want) == {"logits", "preds", "probs", "rec_embd"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)


def test_dual_cmam_config_runs_through_the_port_cli(tmp_path):
    cfg = REPO / "configs/mosi/synthetic_dual_cmam.yaml"
    assert run_cli_inproc("mmtpu_torch.cli.train_cmam", cfg, run_id="1", cwd=tmp_path) == 0
    metrics = tmp_path / "experiments_output/Synthetic_MOSI_DualCMAM/metrics/1"
    for split in ("train", "validation"):
        records = json.loads((metrics / f"{split}_metrics.json").read_text())
        assert len(records) == 3
        for r in records:
            assert list(r) == ["index", "classification", "reconstruction", "loss", "split",
                               "Epoch"]
            assert list(r["classification"]) == ["loss", "accuracy_ATV"]
            assert list(r["reconstruction"]) == ["loss"]
            assert np.isfinite(r["loss"])
    assert not (metrics / "test_metrics.json").exists()  # the file has no test split
