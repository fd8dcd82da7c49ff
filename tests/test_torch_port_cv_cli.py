"""The port's cross-validation and `--stacked-runs` drivers against mmtpu's,
end to end through the CLIs on the CPU, on the repo's synthetic AVMNIST
configs with LeNet encoders (`configs/avmnist/synthetic_{cv,runs}.yaml`):

- `synthetic_cv.yaml` through both packages' `train_multimodal`: the same
  files and directories (`fold_1/`, `fold_2/`, the run log, the
  `{train,validation,test}_metrics_agg.json`), the same JSON keys, and as
  many fold and epoch records;
- `--stacked-runs 2` on `synthetic_runs.yaml` through both packages'
  `sequential_runs` (called directly, so that both take the sequential
  sweep; the stacked engine is `tests/test_torch_port_stacked.py`'s): the
  same output tree, the same JSON keys, members run 1 and 2 seeded 11 and
  12 in both.

The two packages draw different initial weights, so metric values differ;
checkpoints are compared by name (`.ckpt` in mmtpu, `.pth` in the port).
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs" / "avmnist"

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cli_harness import run_cli_inproc  # noqa: E402
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only


def _config(root: Path, src: str) -> Path:
    text = (CONFIGS / src).read_text().replace('"experiments_output', f'"{root}/out')
    dst = root / src
    dst.write_text(text)
    return dst


def _tree(root: Path):
    """Every file and directory under root/out, with the checkpoint suffix
    erased."""
    return sorted(p.relative_to(root).as_posix().replace(".ckpt", ".·").replace(".pth", ".·")
                  for p in (root / "out").rglob("*"))


def structure(obj):
    if isinstance(obj, dict):
        return {k: structure(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [structure(v) for v in obj]
    return "·"


def _json(root: Path):
    return {p.relative_to(root).as_posix(): json.loads(p.read_text())
            for p in sorted((root / "out").rglob("*.json")) if "/models/" not in p.as_posix()}


def _spy_seeds(monkeypatch, common, seed_at):
    """The seed of each `common.init_model` call (positional `seed_at`)."""
    seeds = []
    real = common.init_model

    def spy(*args):
        seeds.append(int(args[seed_at]))
        return real(*args)

    monkeypatch.setattr(common, "init_model", spy)
    return seeds


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from mmtpu.cli import common as jax_common
    from mmtpu.cli import train_multimodal as jax_train_multimodal

    from mmtpu_torch.cli import common

    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for pkg in ("mmtpu", "mmtpu_torch"):
            root = tmp_path_factory.mktemp(pkg)
            for sub in ("cv", "runs"):
                (root / sub).mkdir()
            cv = _config(root / "cv", "synthetic_cv.yaml")
            assert run_cli_inproc(f"{pkg}.cli.train_multimodal", cv, run_id="1") == 0
            cfg = _config(root / "runs", "synthetic_runs.yaml")
            # mmtpu: init_model(model, sample_inputs, seed); the port's:
            # init_model(model, seed, device)
            seeds = (_spy_seeds(mp, jax_common, 2) if pkg == "mmtpu"
                     else _spy_seeds(mp, common, 1))
            if pkg == "mmtpu":
                args = jax_common.standard_arg_parser("x").parse_args(
                    ["--config", str(cfg), "--run_id", "1", "--cpu", "--stacked-runs", "2"])
                jax_common.apply_platform(args)
                assert jax_train_multimodal.sequential_runs(args, 2) == 0
            else:
                from mmtpu_torch.cli import train_multimodal

                args = common.standard_arg_parser("x").parse_args(
                    ["--config", str(cfg), "--run_id", "1", "--cpu", "--stacked-runs", "2"])
                assert train_multimodal.sequential_runs(args, torch.device("cpu")) == 0
            out[pkg] = {"cv": root / "cv", "runs": root / "runs", "seeds": seeds}
            mp.undo()
    finally:
        mp.undo()
    yield out
    for run in out.values():
        shutil.rmtree(run["cv"].parent, ignore_errors=True)


def test_cv_writes_mmtpus_files_and_directories(runs):
    ours, theirs = _tree(runs["mmtpu_torch"]["cv"]), _tree(runs["mmtpu"]["cv"])
    assert ours == theirs
    metrics = "out/Synthetic_CV/metrics/1"
    for name in ("fold_1/epoch_metrics.json", "fold_2/test_metrics.json",
                 "train_metrics_agg.json", "validation_metrics_agg.json",
                 "test_metrics_agg.json"):
        assert f"{metrics}/{name}" in ours
    assert "out/Synthetic_CV/models/1/fold_2/best.·" in ours
    assert "out/Synthetic_CV/logs/1/run_1.log" in ours


def test_cv_json_keys_and_fold_records_match_mmtpu(runs):
    ours, theirs = _json(runs["mmtpu_torch"]["cv"]), _json(runs["mmtpu"]["cv"])
    assert sorted(ours) == sorted(theirs)
    for name, data in theirs.items():
        assert structure(ours[name]) == structure(data), name
    agg = "out/Synthetic_CV/metrics/1"
    assert [len(ours[f"{agg}/{s}_metrics_agg.json"]) for s in ("train", "validation", "test")] \
        == [2, 2, 1]
    assert set(ours[f"{agg}/test_metrics_agg.json"][0]) == {"loss", "accuracy_AI", "accuracy_A"}


def test_stacked_runs_write_mmtpus_sequential_sweep(runs):
    ours, theirs = _tree(runs["mmtpu_torch"]["runs"]), _tree(runs["mmtpu"]["runs"])
    # the epoch checkpoints a run keeps depend on its own validation losses
    def without_epochs(tree):
        return [p for p in tree if "/epoch_" not in p]

    assert without_epochs(ours) == without_epochs(theirs)
    for member in ("1", "2"):
        assert f"out/Synthetic_Runs/metrics/{member}/test_metrics.json" in ours
        assert f"out/Synthetic_Runs/models/{member}/best.·" in ours
    oj, tj = _json(runs["mmtpu_torch"]["runs"]), _json(runs["mmtpu"]["runs"])
    assert sorted(oj) == sorted(tj)
    for name, data in tj.items():
        assert structure(oj[name]) == structure(data), name


def test_stacked_run_members_are_seeded_as_mmtpus(runs):
    assert runs["mmtpu_torch"]["seeds"] == runs["mmtpu"]["seeds"] == [11, 12]


def test_stacked_runs_on_a_cv_config_run_the_repeats_sequentially(tmp_path, monkeypatch):
    """--stacked-runs with a cross-validation config: mmtpu runs the K
    repeats one after another, each a full CV; so does the port."""
    from mmtpu_torch.cli import train_multimodal

    calls = []

    def spy(cfg, args, device, json_nesting="reference", mesh=None):
        calls.append((args.run_id, cfg.experiment.seed))
        return 0

    monkeypatch.setattr(train_multimodal, "main_cross_validation", spy)
    cfg = _config(tmp_path, "synthetic_cv.yaml")
    assert run_cli_inproc("mmtpu_torch.cli.train_multimodal", cfg, run_id="3",
                          extra=("--stacked-runs", "2")) == 0
    assert calls == [(3, 11), (4, 12)]
