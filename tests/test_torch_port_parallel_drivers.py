"""The drivers with their own steps on the port's data-parallel mesh: two gloo
ranks (`--data-parallel 2 --cpu`, one process each) against one process
(`--data-parallel 1`), from the same seed, dropout and RedCore's ε taken
out of both (`tests/_mesh_ranks.py::probes`):

- DualCMAM through `train_cmam` (configs/mosi/synthetic_dual_cmam.yaml with
  100 train samples: a padded tail of 4 real rows of 32, none on rank 1),
  with `--export-serving` on the mesh;
- MMIN (configs/mosi/synthetic_mmin.yaml, 100 train samples), RedCore (the
  tiny config of `tests/test_torch_port_msa_cli.py`, a tail of 8 real rows
  of 16) and Self-MM (configs/mosi/synthetic_self_mm.yaml, 68 train
  samples, two epochs: the second refines the labels) through
  `train_multimodal`.

Held: every value of every metrics JSON within 1e-4, the same files;
every file opened for writing by rank 0 alone; RedCore's β, EMA and η
after every step bit-identical on the two ranks and within 1e-6 of one
process's; Self-MM's banks and centers bit-identical on the two ranks and
within 1e-4 of one process's; the serving artifact written once, by rank
0, and loading.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mesh_ranks  # noqa: E402
from test_torch_port_msa_cli import REDCORE, _redcore_yaml  # noqa: E402

from mmtpu_torch.parallel import MeshConfig, create_mesh  # noqa: E402
from mmtpu_torch.parallel.launch import launch  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TOL = 1e-4
SCHED_TOL = 1e-6
CMAM = "mmtpu_torch.cli.train_cmam"
MULTI = "mmtpu_torch.cli.train_multimodal"
# driver → (module, config or None for RedCore's, edits, experiment name)
DRIVERS = {
    "dual_cmam": (CMAM, "mosi/synthetic_dual_cmam.yaml",
                  [("dropout: 0.1", "dropout: 0.0"), ("num_samples: 96", "num_samples: 100")],
                  "Synthetic_MOSI_DualCMAM"),
    "mmin": (MULTI, "mosi/synthetic_mmin.yaml", [("num_samples: 96", "num_samples: 100")],
             "Synthetic_MOSI_MMIN"),
    "redcore": (MULTI, None, [], REDCORE),
    "self_mm": (MULTI, "mosi/synthetic_self_mm.yaml", [("num_samples: 64", "num_samples: 68")],
                "Synthetic_MOSI_SelfMM"),
}


def driver_config(root: Path, driver: str) -> Path:
    """The driver's config with its outputs under `root`."""
    _, src, edits, _ = DRIVERS[driver]
    text = (_redcore_yaml(root) if src is None else REPO / "configs" / src).read_text()
    for prefix in ('"./experiments_output', '"experiments_output'):
        text = text.replace(prefix, f'"{root}/experiments_output')
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    path = root / f"{driver}.yaml"
    path.write_text(text)
    return path


def argv(cfg: Path, run_id: int, dp: int, *extra) -> list:
    return ["--config", str(cfg), "--run_id", str(run_id), "--cpu", "--data-parallel",
            str(dp), *extra]


def metrics_values(metrics: Path) -> dict:
    """Every metrics JSON under `metrics`, flattened to {file/path: value}."""
    def walk(obj, prefix):
        if isinstance(obj, dict):
            for k, v in obj.items():
                yield from walk(v, f"{prefix}/{k}")
        elif isinstance(obj, list):
            for i, v in enumerate(obj):
                yield from walk(v, f"{prefix}[{i}]")
        else:
            yield prefix, obj

    out = {}
    for path in sorted(metrics.rglob("*.json")):
        out.update(walk(json.loads(path.read_text()), path.relative_to(metrics).as_posix()))
    assert "epoch_metrics.json[0]/epoch" in out, metrics
    return out


def assert_close_records(got: dict, want: dict, tol: float = TOL) -> None:
    assert list(got) == list(want)
    for key, y in want.items():
        x = got[key]
        if "time" in key:
            continue
        if isinstance(y, float):
            assert abs(x - y) <= tol * max(abs(y), 1.0), (key, x, y)
        else:
            assert x == y, (key, x, y)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each driver as two ranks (run 1, DualCMAM with --export-serving) and
    as one process (run 2), under `probes`."""
    out = {}
    mesh = create_mesh(MeshConfig(data_parallel=2), devices=[CPU] * 2)
    for driver, (module, *_rest) in DRIVERS.items():
        root = tmp_path_factory.mktemp(f"mesh_{driver}")
        cfg = driver_config(root, driver)
        extra = ("--export-serving", str(root / "cmam.mmx")) if driver == "dual_cmam" else ()
        assert launch(mesh, _mesh_ranks.probed_main,
                      (module, argv(cfg, 1, 2, *extra), str(root)), timeout=300) == 0
        assert _mesh_ranks.probed_main(module, argv(cfg, 2, 1), str(root)) == 0
        seen = {tag: torch.load(root / f"{tag}.pt", weights_only=False)
                for tag in ("rank0", "rank1", "single")}
        out[driver] = {"root": root, **seen}
    return out


def _metrics(run: dict, driver: str, run_id: int) -> Path:
    return run["root"] / "experiments_output" / DRIVERS[driver][3] / "metrics" / str(run_id)


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_two_ranks_match_one_process(runs, driver):
    run = runs[driver]
    two, one = metrics_values(_metrics(run, driver, 1)), metrics_values(_metrics(run, driver, 2))
    assert_close_records(two, one)
    files = {p.name for p in _metrics(run, driver, 1).rglob("*.json")}
    assert files == {p.name for p in _metrics(run, driver, 2).rglob("*.json")}
    assert "validation_metrics.json" in files or "test_metrics.json" in files


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_rank_0_alone_writes(runs, driver):
    run = runs[driver]
    assert run["rank1"]["writes"] == [], run["rank1"]["writes"][:5]
    written = run["rank0"]["writes"]
    assert any(w.endswith("epoch_metrics.json") for w in written)
    assert any(w.endswith("best.pth.tmp") for w in written)  # through torch.save


def test_redcore_schedule_is_one_on_every_rank_and_one_processes(runs):
    run = runs["redcore"]
    ranks, single = [run[f"rank{r}"]["sched"] for r in (0, 1)], run["single"]["sched"]
    assert len(ranks[0]) == len(single) == 6  # 3 steps an epoch, 2 epochs
    for a, b, want in zip(*ranks, single):
        for k, v in want.items():
            assert torch.equal(a[k], b[k]), k
            torch.testing.assert_close(a[k], v, rtol=SCHED_TOL, atol=SCHED_TOL)
    assert int(ranks[0][-1]["iter_count"]) == 6


def test_self_mm_banks_are_one_on_every_rank_and_one_processes(runs):
    run = runs["self_mm"]
    ranks, single = [run[f"rank{r}"]["banks"] for r in (0, 1)], run["single"]["banks"]
    assert set(ranks[0]) == set(single) and "labels/audio" in single
    for k, v in single.items():
        assert torch.equal(ranks[0][k], ranks[1][k]), k
        torch.testing.assert_close(ranks[0][k], v, rtol=TOL, atol=TOL)
    # the refinement of epoch 2 moved the unimodal labels off the fusion's
    assert not torch.equal(single["labels/audio"], single["labels/multimodal"])


def test_export_serving_on_the_mesh_writes_one_artifact(runs):
    from mmtpu_torch.serving import load_artifact

    run = runs["dual_cmam"]
    path = run["root"] / "cmam.mmx"
    assert run["rank1"]["writes"] == []
    assert [w for w in run["rank0"]["writes"] if w.endswith("cmam.mmx.tmp")]  # then renamed
    served = load_artifact(path, "cpu")
    assert served.meta["task_type"] == "cmam" and served.meta["input_keys"] == ["audio"]
    audio = np.random.default_rng(3).normal(size=(3, 50, 5)).astype(np.float32)
    got = served(audio=audio)
    assert got["rec_embd"].shape[0] == 3 and np.isfinite(got["logits"]).all()
