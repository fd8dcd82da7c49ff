"""The port's Self-MM driver (`train_multimodal` → `cli/train_self_mm.py`)
against mmtpu's, end to end on the CPU:

- configs/mosi/synthetic_self_mm.yaml as it is (a fresh BERT of hidden 32,
  2 layers; AuViSubNets over text lengths; 2 epochs, so the second runs the
  label refinement) through both packages' `train_multimodal`, the port
  from mmtpu's initial weights: the same files (checkpoints under the
  port's `.pth` names), the same keys in the same order in
  `epoch_metrics.json` and `test_metrics.json`, and every value but the
  timings at 1e-4;
- `--dry-run` builds everything and trains nothing;
- a two-fold cross-validation hands each fold its `cv_no` and writes each
  fold's records;
- `--stacked-runs 2` and `--stacked-folds` fall back to the sequential
  paths with mmtpu's messages.
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
from mmtpu_torch.cli import common, train_self_mm

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
from _cli_harness import run_cli_inproc  # noqa: E402
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

CFG = REPO / "configs/mosi/synthetic_self_mm.yaml"
NAME = "Synthetic_MOSI_SelfMM"
VALUE_TOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs in their own directories; the port from mmtpu's
    initial weights (read where mmtpu builds its state)."""
    mp = pytest.MonkeyPatch()
    captured = {}
    real_state = jax_common.make_state

    def jax_make_state(model, params, batch_stats, training, clip=None):
        captured["params"] = jax.tree_util.tree_map(np.asarray, params)
        return real_state(model, params, batch_stats, training, clip=clip)

    def port_init(model, seed, device):
        model.load_state_dict(from_jax_variables(captured["params"], target=model),
                              strict=True)
        torch.manual_seed(int(seed))
        return model.to(device)

    out = {}
    try:
        mp.setattr(jax_common, "make_state", jax_make_state)
        mp.setattr(common, "init_model", port_init)
        for pkg in ("mmtpu", "mmtpu_torch"):
            root = tmp_path_factory.mktemp(f"self_mm_{pkg}")
            assert run_cli_inproc(f"{pkg}.cli.train_multimodal", CFG, run_id="1",
                                  cwd=root) == 0
            out[pkg] = root / "experiments_output"
    finally:
        mp.undo()
    yield out
    for root in out.values():
        shutil.rmtree(root.parent, ignore_errors=True)


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


def test_run_writes_mmtpus_files(runs):
    ours, theirs = (_files(runs[pkg]) for pkg in ("mmtpu_torch", "mmtpu"))
    assert ours == theirs
    assert {f"{NAME}/models/1/best·", f"{NAME}/metrics/1/test_metrics.json",
            f"{NAME}/metrics/1/epoch_metrics.json"} <= set(ours)


@pytest.mark.parametrize("record", ["epoch_metrics", "test_metrics"])
def test_records_match_mmtpu(runs, record):
    """Keys, their order, and every value but the timings at 1e-4."""
    path = f"{NAME}/metrics/1/{record}.json"
    ours, theirs = (json.loads((runs[pkg] / path).read_text())
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
        assert len(ours) == 3 and "test" in ours[-1] and "metrics" not in ours[-1]["test"]
        assert set(ours[0]["train"]) == {"loss", "timing", "metrics"}
        assert any(k.startswith("mosei") for k in ours[0]["validation"]["metrics"])


def test_dry_run_trains_nothing(tmp_path, capfd, monkeypatch):
    seen = []
    real = train_self_mm.run

    def spy(cfg, args, device, mesh=None):
        seen.append(cfg.model.model_type)
        return real(cfg, args, device, mesh)

    monkeypatch.setattr(train_self_mm, "run", spy)
    assert run_cli_inproc("mmtpu_torch.cli.train_multimodal", CFG, run_id="1",
                          extra=("--dry-run",), cwd=tmp_path) == 0
    assert seen == ["self-mm"]
    assert "dry run complete" in capfd.readouterr().out
    assert not (tmp_path / f"experiments_output/{NAME}/metrics/1/epoch_metrics.json").exists()


def test_cross_validation_hands_each_fold_its_cv_no(tmp_path, monkeypatch, capfd):
    cfg = tmp_path / "cv.yaml"
    cfg.write_text(CFG.read_text().replace(
        '  is_test: true\n', '  is_test: true\n  cross_validation: 2\n', 1))
    seen = []
    real = train_self_mm.run

    def spy(cfg_, args, device, mesh=None):
        seen.append(sorted({d.kwargs.get("cv_no") for d in cfg_.data.datasets.values()}))
        return real(cfg_, args, device, mesh)

    monkeypatch.setattr(train_self_mm, "run", spy)
    assert run_cli_inproc("mmtpu_torch.cli.train_multimodal", cfg, run_id="1",
                          extra=("--epochs", "1", "--stacked-folds"), cwd=tmp_path) == 0
    assert seen == [[1], [2]]
    assert "--stacked-folds unsupported for self-mm; falling back to sequential CV" in (
        capfd.readouterr().out)
    metrics = tmp_path / f"experiments_output/{NAME}/metrics/1"
    for fold in (1, 2):
        records = json.loads((metrics / f"fold_{fold}/epoch_metrics.json").read_text())
        assert len(records) == 2 and "test" in records[-1]


def test_stacked_runs_fall_back_to_sequential_runs(tmp_path, capfd):
    assert run_cli_inproc("mmtpu_torch.cli.train_multimodal", CFG, run_id="1",
                          extra=("--stacked-runs", "2", "--epochs", "1"), cwd=tmp_path) == 0
    assert ("--stacked-runs unsupported for self-mm; falling back to sequential runs"
            in capfd.readouterr().out)
    metrics = tmp_path / f"experiments_output/{NAME}/metrics"
    assert sorted(p.name for p in metrics.iterdir()) == ["1", "2"]
