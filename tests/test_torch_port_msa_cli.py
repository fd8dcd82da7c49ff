"""The port's MSA driver (`train_multimodal` → `cli/msa_runners.py`) against
mmtpu's, end to end on the CPU:

- configs/mosi/synthetic_mmin.yaml as it is, and a tiny RedCore config
  this test writes (Transformer encoders of width 8, `atv` training with
  audio and video missing at 0.3, the three evaluation patterns), through
  both packages' `train_multimodal`, the port from mmtpu's initial weights
  (RedCore's dropouts and ε neutralised in both, `_redcore_neutral.py`):
  the same files (the checkpoints under the port's `.pth` names), the same
  key structure and order of `epoch_metrics.json` and `test_metrics.json`,
  and every value but the timings at 1e-4;
- configs/mosi/synthetic_mmin_teacher.yaml under `--dry-run`, its teacher
  restored from an mmtpu `.ckpt` and from a port `.pth` (the file's
  `best.pth` name resolves to either), the teacher's weights the file's;
- the same file without `--dry-run`: its teacher embeds 96 features and
  its fusion is 128 wide, so both packages raise at the first train step
  (a fault of the config, recorded in ROADMAP §3; neither pads nor crops);
- `predict` and `serve` refuse `mmin`, `redcore`, `self-mm` and `self_mm`
  with mmtpu's SystemExit message;
- `--stacked-runs 2` and `--stacked-folds` fall back to the sequential
  paths with mmtpu's messages, and cross-validation hands each fold's
  `cv_no` to the datasets (and, as in mmtpu, writes no aggregate).
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
from mmtpu_torch.cli import common, msa_runners

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cli_harness import run_cli_inproc  # noqa: E402
from _redcore_neutral import neutralised  # noqa: E402

MMIN_CFG = REPO / "configs/mosi/synthetic_mmin.yaml"
TEACHER_CFG = REPO / "configs/mosi/synthetic_mmin_teacher.yaml"
VALUE_TOL = 1e-4
REDCORE = "Tiny_MOSI_RedCore"


def _redcore_yaml(root: Path) -> Path:
    def split(name, n, patterns, rates, extra=""):
        mods = "\n".join(f"""          !Modality {m}: !ModalityConfig
            missing_rate: {rates.get(m, 0.0)}""" for m in ("audio", "video", "text"))
        return f"""    {name}: !DatasetConfig
      dataset: "synthetic_mosi"
      data_fp: "unused"
      split: "{'valid' if name == 'validation' else name}"
      target_modality: !Modality "MULTIMODAL"
      batch_size: 16{extra}
      kwargs:
        num_samples: {n}
        seq_len: 8
      missing_patterns: !MissingPatternConfig
        modalities:
{mods}
        selected_patterns: {json.dumps(patterns)}"""

    def tr(width):
        return f"""!Transformer
    width: {width}
    layers: 1
    heads: 2
    embd_width: 8"""

    def fc(width):
        return f"""!FcClassifier
    input_dim: {width}
    layers: [8]
    output_dim: 3
    dropout: 0.0"""

    xe = """!ResidualXE
    layers: [12]
    n_blocks: 1
    input_dim: 16
    output_dim: 8
    dropout: 0.0"""
    text = f"""!StandardConfig
experiment: !ExperimentConfig
  name: "{REDCORE}"
  seed: 7
  device: "tpu"
  is_train: true
  is_test: true

model: !ModelConfig
  name: "RedCore"
  model_type: "redcore"
  netA: {tr(5)}
  netV: {tr(20)}
  netT: {tr(768)}
  netAE: !ResidualAE
    layers: [12, 6]
    n_blocks: 2
    input_dim: 24
    dropout: 0.0
  netC: {fc(24)}
  netC_A: {fc(8)}
  netC_V: {fc(8)}
  netC_T: {fc(8)}
  netAT_V: {xe}
  netAV_T: {xe}
  netVT_A: {xe}
  eta: 0.002
  interval_i: 3
  clip: 0.5

training:
  epochs: 2
  early_stopping: false
  num_modalities: 3
  optimizer: !Optimizer
    name: "Adam"
    default_kwargs: {{lr: 0.001, eps: 0.001}}
  loss_functions: !LossFunctionGroup
    cross_entropy: {{loss_name: "cross_entropy", weight: 1.0}}
    mse: {{loss_name: "mse", weight: 1.0}}

data: !DataConfig
  datasets:
{split("train", 40, ["atv"], {"audio": 0.3, "video": 0.3}, chr(10) + "      shuffle: true")}
{split("validation", 24, ["atv", "at", "tv"], {})}
{split("test", 24, ["atv", "at", "tv"], {})}

metrics:
  metrics:
    accuracy: {{function: "sklearn.metrics.accuracy_score", kwargs: {{}}}}
  groups:
    classification: ["accuracy"]

logging:
  log_path: "./experiments_output/{{experiment_name}}/logs/{{run_id}}"
  model_output_path: "./experiments_output/{{experiment_name}}/models/{{run_id}}"
  metrics_path: "./experiments_output/{{experiment_name}}/metrics/{{run_id}}"
  save_metric: "loss"

monitoring:
  enabled: false
"""
    path = root / "redcore.yaml"
    path.write_text(text)
    return path


def _run_both(tmp_path_factory, cfg_of, neutral=False):
    """Both packages' `train_multimodal` in their own directories; the port
    from mmtpu's initial weights (read where mmtpu builds its state)."""
    mp = pytest.MonkeyPatch()
    captured = {}
    real_state = jax_common.make_state

    def jax_make_state(model, params, batch_stats, training, clip=None):
        captured["v"] = jax.tree_util.tree_map(np.asarray, {"params": params,
                                                           "batch_stats": batch_stats})
        return real_state(model, params, batch_stats, training, clip=clip)

    def port_init(model, seed, device):
        v = captured["v"]
        model.load_state_dict(from_jax_variables(v["params"], v["batch_stats"] or None,
                                                 target=model), strict=True)
        torch.manual_seed(int(seed))
        return model.to(device)

    out = {}
    try:
        mp.setattr(jax_common, "make_state", jax_make_state)
        mp.setattr(common, "init_model", port_init)
        if neutral:
            neutralised(mp)
        for pkg in ("mmtpu", "mmtpu_torch"):
            root = tmp_path_factory.mktemp(f"msa_{pkg}")
            assert run_cli_inproc(f"{pkg}.cli.train_multimodal", cfg_of(root), run_id="1",
                                  cwd=root) == 0
            out[pkg] = root / "experiments_output"
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {"mmin": _run_both(tmp_path_factory, lambda root: MMIN_CFG),
           "redcore": _run_both(tmp_path_factory, _redcore_yaml, neutral=True)}
    yield out
    for pair in out.values():
        for root in pair.values():
            shutil.rmtree(root.parent, ignore_errors=True)


NAMES = {"mmin": "Synthetic_MOSI_MMIN", "redcore": REDCORE}


def _files(root: Path):
    return sorted(p.relative_to(root).as_posix().replace(".pth", "·").replace(".ckpt", "·")
                  for p in root.rglob("*") if p.is_file())


def _values(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _values(v, f"{prefix}/{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _values(v, f"{prefix}[{i}]")
    else:
        yield prefix, obj


@pytest.mark.parametrize("family", ["mmin", "redcore"])
def test_runs_write_mmtpus_files(runs, family):
    ours, theirs = (_files(runs[family][pkg]) for pkg in ("mmtpu_torch", "mmtpu"))
    assert ours == theirs
    name = NAMES[family]
    assert {f"{name}/models/1/best·", f"{name}/models/1/last·",
            f"{name}/metrics/1/test_metrics.json"} <= set(ours)


@pytest.mark.parametrize("record", ["epoch_metrics", "test_metrics"])
@pytest.mark.parametrize("family", ["mmin", "redcore"])
def test_records_match_mmtpu(runs, family, record):
    """Keys, their order, and every value but the timings at 1e-4."""
    path = f"{NAMES[family]}/metrics/1/{record}.json"
    ours, theirs = (json.loads((runs[family][pkg] / path).read_text())
                    for pkg in ("mmtpu_torch", "mmtpu"))
    a, b = list(_values(ours)), list(_values(theirs))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path_a, x), (_, y) in zip(a, b):
        if "/timing/" in path_a:
            continue
        if isinstance(y, float):
            assert abs(x - y) <= VALUE_TOL * max(abs(y), 1.0), (path_a, x, y)
        else:
            assert x == y, (path_a, x, y)
    if record == "epoch_metrics":
        assert len(ours) == 3 and "test" in ours[-1]
        assert set(ours[0]["validation"]["metrics"]) == {"accuracy_ATV", "accuracy_AT",
                                                          "accuracy_TV"}


# -- the teacher chain ---------------------------------------------------------------

def _teacher_file(root: Path, kind: str) -> Path:
    """The teacher synthetic_mmin_teacher.yaml names, at run 7: mmtpu's
    `.ckpt` (flax msgpack) or a port training checkpoint `.pth`."""
    from mmtpu_torch.config import StandardMultimodalConfig

    spec = StandardMultimodalConfig.load(TEACHER_CFG, run_id=7).model.kwargs["pretrained_model"]
    out = root / "teacher_output/models/7"
    out.mkdir(parents=True, exist_ok=True)
    if kind == "pth":
        model = common.init_model(spec.build(), 3, torch.device("cpu"))
        path = out / "best.pth"
        torch.save({"model": model.state_dict(), "optimizer": {}, "step": 0}, path)
        return path
    from flax import serialization

    from mmtpu.models import build_module as jax_build

    kw = {k: jax_build(v.name, **v.kwargs) if hasattr(v, "name") else v
          for k, v in spec.kwargs.items() if k != "pretrained_path"}
    teacher = jax_build("utt-fusion", **kw)
    v = teacher.init({"params": jax.random.PRNGKey(3)}, np.zeros((2, 50, 5), np.float32),
                     np.zeros((2, 50, 20), np.float32), np.zeros((2, 50, 768), np.float32))
    path = out / "best.ckpt"
    path.write_bytes(serialization.msgpack_serialize(
        {"params": serialization.to_state_dict(v["params"])}))
    return path


@pytest.mark.parametrize("kind", ["ckpt", "pth"])
def test_teacher_chain_restores_either_packages_file_under_dry_run(kind, tmp_path, capfd,
                                                                  monkeypatch):
    path = _teacher_file(tmp_path, kind)
    teachers = []
    real = msa_runners._teacher

    def spy(*a, **k):
        teachers.append(real(*a, **k))
        return teachers[-1]

    monkeypatch.setattr(msa_runners, "_teacher", spy)
    assert run_cli_inproc("mmtpu_torch.cli.train_multimodal", TEACHER_CFG, run_id="7",
                          extra=("--dry-run",), env_extra={"EXP_PATH": str(tmp_path)},
                          cwd=tmp_path) == 0
    out = capfd.readouterr().out
    assert f"MMIN teacher restored from {path}" in out
    assert "dry run complete" in out
    (teacher,) = teachers
    assert not teacher.training and not any(p.requires_grad for p in teacher.parameters())
    if kind == "pth":
        want = torch.load(path, weights_only=True)["model"]
    else:
        from flax import serialization

        tree = serialization.msgpack_restore(path.read_bytes())
        want = from_jax_variables(tree["params"], target=teacher)
    got = teacher.state_dict()
    assert set(want) <= set(got)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def test_teacher_config_fails_at_the_first_step_in_both(tmp_path, capfd):
    """The file's teacher embeds 32 + 32 + 32 = 96 features and its MMIN's
    fusion is 32 + 32 + 64 = 128 wide: mmtpu's teacher term cannot
    broadcast, and neither can the port's; neither crops or pads."""
    _teacher_file(tmp_path, "ckpt")
    env = {"EXP_PATH": str(tmp_path)}
    with pytest.raises(TypeError, match=r"\(32, 128\), \(32, 96\)"):
        run_cli_inproc("mmtpu.cli.train_multimodal", TEACHER_CFG, run_id="7",
                       extra=("--epochs", "1"), env_extra=env, cwd=tmp_path)
    with pytest.raises(RuntimeError, match="128.*96|96.*128"):
        run_cli_inproc("mmtpu_torch.cli.train_multimodal", TEACHER_CFG, run_id="7",
                       extra=("--epochs", "1"), env_extra=env, cwd=tmp_path)
    out = capfd.readouterr().out
    assert out.count("MMIN teacher restored from") == 2


# -- predict, serve, the drivers' fallbacks ------------------------------------------

@pytest.mark.parametrize("model_type", ["mmin", "redcore", "self-mm", "self_mm"])
def test_predict_and_serve_refuse_with_mmtpus_message(model_type, tmp_path, monkeypatch):
    from mmtpu.cli import predict as jax_predict
    from mmtpu_torch.cli import predict, serve

    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(MMIN_CFG.read_text().replace('model_type: "mmin"',
                                                f'model_type: "{model_type}"'))
    argv = ["--config", str(cfg), "--run_id", "1", "--cpu"]
    with pytest.raises(SystemExit) as theirs:
        jax_predict.main(argv)
    assert model_type in str(theirs.value)
    with pytest.raises(SystemExit) as ours:
        predict.main(argv)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(SystemExit) as served:
        serve.load_model(serve.arg_parser().parse_args(argv))
    assert str(served.value) == str(theirs.value)


def test_stacked_runs_fall_back_to_sequential_runs(tmp_path, capfd, monkeypatch):
    assert run_cli_inproc("mmtpu_torch.cli.train_multimodal", MMIN_CFG, run_id="1",
                          extra=("--stacked-runs", "2", "--epochs", "1"), cwd=tmp_path) == 0
    assert ("--stacked-runs unsupported for mmin; falling back to sequential runs"
            in capfd.readouterr().out)
    metrics = tmp_path / "experiments_output/Synthetic_MOSI_MMIN/metrics"
    assert sorted(p.name for p in metrics.iterdir()) == ["1", "2"]
    from mmtpu_torch.cli import train_multimodal

    monkeypatch.chdir(tmp_path)
    args = common.standard_arg_parser("x").parse_args(["--config", str(MMIN_CFG),
                                                       "--stacked-folds", "--cpu"])
    cfg = common.load_config(args)
    assert (train_multimodal._stacked_fallback_reason(cfg, args)
            == "--stacked-folds unsupported for mmin")


def test_cross_validation_hands_each_fold_its_cv_no(tmp_path, monkeypatch, capfd):
    cfg = tmp_path / "cv.yaml"
    cfg.write_text(MMIN_CFG.read_text().replace(
        '  is_test: true\n', '  is_test: true\n  cross_validation: 2\n', 1))
    seen = []
    real = msa_runners.run

    def spy(cfg_, args, device, mesh=None):
        seen.append(sorted({d.kwargs.get("cv_no") for d in cfg_.data.datasets.values()}))
        return real(cfg_, args, device, mesh)

    monkeypatch.setattr(msa_runners, "run", spy)
    assert run_cli_inproc("mmtpu_torch.cli.train_multimodal", cfg, run_id="1",
                          extra=("--epochs", "1", "--stacked-folds"), cwd=tmp_path) == 0
    assert seen == [[1], [2]]
    assert "--stacked-folds unsupported for mmin; falling back to sequential CV" in (
        capfd.readouterr().out)
    metrics = tmp_path / "experiments_output/Synthetic_MOSI_MMIN/metrics/1"
    assert (metrics / "fold_1/epoch_metrics.json").exists()
    assert (metrics / "fold_2/test_metrics.json").exists()
    assert not list(metrics.glob("*_agg.json"))
