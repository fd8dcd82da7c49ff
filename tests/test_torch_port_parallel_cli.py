"""The training CLIs with `--data-parallel 2 --cpu` (two gloo ranks, one
process each, `mmtpu_torch/parallel/launch.py`) against `--data-parallel 1`:

- `train_multimodal` on the synthetic AVMNIST config (LeNet encoders with
  BatchNorm): the records within 1e-4, the same set of files, and every
  file opened for writing by rank 0 alone (the ranks run
  `tests/_mesh_ranks.py::audited_main`);
- `train_multimodal` on the synthetic UttFusion config through `main`'s own
  launch, dropout 0, a train split of 132 whose padded tail (4 real rows of
  32) leaves rank 1 no real row: the records within 1e-4;
- `train_multimodal` on the synthetic MM-IMDb config (a (B, 23) multilabel
  loss, dropout 0), its eval fused so that each rank holds none of one
  original batch's rows: the records within 1e-4;
- a two-fold CV with `--stacked-folds` falls back to sequential folds on
  the mesh;
- `train_monomodal` (a LeNet audio encoder in the synthetic config's
  ResNet18's place): the records within 1e-4 and the encoder handoff;
- `--resume` on the mesh, dropout on: an interrupted and resumed run equals
  an uninterrupted one (the ranks' own RNG states restore);
- a rank that raises ends the run non-zero within the timeout.

MMIN, RedCore, Self-MM and `train_cmam` on the mesh:
`tests/test_torch_port_parallel_drivers.py` and
`tests/test_torch_port_parallel_drivers_mmtpu.py`.
"""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mesh_ranks  # noqa: E402
from _cli_harness import run_cli_inproc  # noqa: E402

from mmtpu_torch.parallel import MeshConfig, create_mesh  # noqa: E402
from mmtpu_torch.parallel.launch import launch  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TOL = 1e-4
MULTI = "mmtpu_torch.cli.train_multimodal"
MONO = "mmtpu_torch.cli.train_monomodal"


def _config(tmp_path, src, edits=()):
    """A repo config with its outputs under tmp_path."""
    text = (REPO / "configs" / src).read_text()
    for prefix in ('"./experiments_output', '"experiments_output'):
        text = text.replace(prefix, f'"{tmp_path}/out')
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    dst = tmp_path / Path(src).name
    dst.write_text(text)
    return dst


def _mesh2():
    return create_mesh(MeshConfig(data_parallel=2), devices=[CPU] * 2)


def _argv(cfg, run_id, *extra):
    return ["--config", str(cfg), "--run_id", str(run_id), "--cpu", "--data-parallel", "2",
            *extra]


def _close(a, b, where="") -> None:
    """Two JSON records equal, floats within TOL (timings left out)."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            if "time" not in k:
                _close(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=TOL, abs=TOL), where
    else:
        assert a == b, where


def _records(metrics: Path) -> dict:
    out = {p.relative_to(metrics).as_posix(): json.loads(p.read_text())
           for p in sorted(metrics.rglob("*.json"))}
    assert "epoch_metrics.json" in out, metrics
    return out


def _files(root: Path) -> set:
    return {p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file()}


def test_avmnist_two_ranks_match_one_and_rank_0_writes_alone(tmp_path):
    cfg = _config(tmp_path, "avmnist/synthetic_dp.yaml")
    out = tmp_path / "out" / "Synthetic_DP"
    assert launch(_mesh2(), _mesh_ranks.audited_main, (MULTI, _argv(cfg, 1), str(tmp_path)),
                  timeout=120) == 0
    assert run_cli_inproc(MULTI, cfg, run_id="2", extra=("--data-parallel", "1")) == 0
    two, one = _records(out / "metrics" / "1"), _records(out / "metrics" / "2")
    assert set(two) >= {"epoch_metrics.json", "test_metrics.json", "validation_metrics.json"}
    _close(two, one)
    for kind in ("metrics", "models", "logs"):
        assert _files(out / kind / "1") == {f.replace("run_2", "run_1")
                                            for f in _files(out / kind / "2")}, kind
    writes = [json.loads((tmp_path / f"writes_rank{r}.json").read_text()) for r in range(2)]
    assert writes[1] == [], writes[1]
    assert any(w.endswith("epoch_metrics.json") for w in writes[0])
    assert any(w.endswith("best.pth.tmp") for w in writes[0])  # through torch.save


def test_uttfusion_two_ranks_through_main_match_one(tmp_path, capfd):
    cfg = _config(tmp_path, "mosi/synthetic_utt_fusion.yaml", [
        ("dropout: 0.5", "dropout: 0.0"), ("dropout: 0.3", "dropout: 0.0"),
        ("num_samples: 128", "num_samples: 132")])
    assert run_cli_inproc(MULTI, cfg, run_id="1", extra=("--data-parallel", "2")) == 0
    said = capfd.readouterr().out
    assert "data-parallel mesh: 2 ranks on cpu, cpu over gloo" in said
    assert said.count("epoch 2/2") == 1  # rank 0 alone prints
    assert run_cli_inproc(MULTI, cfg, run_id="2", extra=("--data-parallel", "1")) == 0
    out = tmp_path / "out" / "Synthetic_MOSI_UttFusion" / "metrics"
    two, one = _records(out / "1"), _records(out / "2")
    _close(two, one)
    assert "MSA_Has0_Accuracy_ATV" in two["test_metrics.json"][0]


def test_mmimdb_two_ranks_with_fused_eval_match_one(tmp_path, monkeypatch):
    # bce_with_logits on (B, 23) logits: a fused eval step of 3 original
    # batches over 2 ranks leaves each rank an empty slice of one of them.
    # The classifier's dropouts (0.5, not in the config) are set to 0 in both
    # runs, as the ranks draw their own masks
    from mmtpu_torch.models.rng import GeneratorDropout

    cfg = _config(tmp_path, "mmimdb/synthetic_gmu.yaml")
    assert launch(_mesh2(), _mesh_ranks.no_dropout_main, (MULTI, _argv(cfg, 1)),
                  timeout=120) == 0
    real = GeneratorDropout.__init__
    monkeypatch.setattr(GeneratorDropout, "__init__",
                        lambda self, p, *a, **k: real(self, 0.0, *a, **k))
    assert run_cli_inproc(MULTI, cfg, run_id="2", extra=("--data-parallel", "1")) == 0
    out = tmp_path / "out" / "Synthetic_MMIMDb_GMU" / "metrics"
    two, one = _records(out / "1"), _records(out / "2")
    _close(two, one)


def test_cv_with_stacked_folds_runs_sequential_folds_on_the_mesh(tmp_path, capfd):
    cfg = _config(tmp_path, "avmnist/synthetic_cv.yaml")
    assert run_cli_inproc(MULTI, cfg, run_id="1",
                          extra=("--data-parallel", "2", "--stacked-folds")) == 0
    said = capfd.readouterr().out
    assert ("stacking is single-device and data_parallel=2 was requested; falling back to "
            "sequential CV") in said
    assert said.count("fold 2/2") == 1
    (metrics,) = (tmp_path / "out").glob("*/metrics/1")
    for fold in (1, 2):
        epochs = json.loads((metrics / f"fold_{fold}" / "epoch_metrics.json").read_text())
        assert [e.get("epoch") for e in epochs] == [1, 2, None]
    for split in ("train", "validation", "test"):
        agg = json.loads((metrics / f"{split}_metrics_agg.json").read_text())
        assert agg and "loss" in agg[0]


def test_monomodal_two_ranks_match_one(tmp_path):
    # LeNet for the config's ResNet18: that float32 run moves by ~1e-3 of its
    # losses with the CPU thread count alone, in one process
    cfg = _config(tmp_path, "avmnist/synthetic_mono_audio.yaml", [
        ("audio_encoder: !ResNet18\n    in_channels: 1\n    hidden_dim: 64",
         "audio_encoder: !LeNetEncoder\n    in_channels: 1\n    hidden_dim: 64")])
    assert run_cli_inproc(MONO, cfg, run_id="1", extra=("--data-parallel", "2")) == 0
    assert run_cli_inproc(MONO, cfg, run_id="2", extra=("--data-parallel", "1")) == 0
    (root,) = (tmp_path / "out").iterdir()
    _close(_records(root / "metrics" / "1"), _records(root / "metrics" / "2"))
    handoff = [torch.load(root / "models" / str(r) / "encoder_audio_best.pth") for r in (1, 2)]
    assert set(handoff[0]) == set(handoff[1])
    for k, v in handoff[1].items():
        torch.testing.assert_close(handoff[0][k], v, rtol=TOL, atol=TOL)


def test_resume_on_the_mesh_equals_an_uninterrupted_run(tmp_path):
    cfg = _config(tmp_path, "avmnist/synthetic_dp.yaml", [("dropout: 0.0", "dropout: 0.3")])
    for argv in (_argv(cfg, 1), _argv(cfg, 2, "--epochs", "1"), _argv(cfg, 2, "--resume")):
        assert run_cli_inproc(MULTI, cfg, run_id=argv[3], extra=argv[4:]) == 0
    out = tmp_path / "out" / "Synthetic_DP" / "metrics"
    whole, resumed = (json.loads((out / r / "epoch_metrics.json").read_text()) for r in "12")
    assert [e.get("epoch") for e in resumed] == [1, 2, None]
    for a, b in zip(whole, resumed):
        for split in ("train", "validation", "test"):
            if split in a:
                body = {k: v for k, v in a[split].items() if k != "timing"}
                assert body == {k: v for k, v in b[split].items() if k != "timing"}, split


def test_a_failing_rank_fails_the_run_within_the_timeout(tmp_path, capfd):
    cfg = _config(tmp_path, "avmnist/synthetic_dp.yaml")
    t0 = time.monotonic()
    rc = launch(_mesh2(), _mesh_ranks.fail_on_rank, (1, MULTI, _argv(cfg, 1)), timeout=60)
    assert rc != 0 and time.monotonic() - t0 < 60
    assert "rank 1 fails on purpose" in capfd.readouterr().err
