"""Data parallelism in the port (`mmtpu_torch/parallel/`) against one process
and against mmtpu's mesh on the CPU, with 2 and 4 gloo ranks
(`mmtpu_torch.parallel.launch`; the ranks run `tests/_mesh_ranks.py`):

- `resolve_mesh`'s cases with mmtpu's messages (the CUDA card count
  monkeypatched), `create_mesh`'s, `model_parallel > 1`;
- `shard_batch`'s slices and mmtpu's divisibility error;
- the global-batch BatchNorm at N = 2 and 4 against one process: outputs,
  running statistics, input and weight gradients at 1e-6, a full batch and
  a padded one whose last rank(s) hold no real row;
- three train steps at N = 2 against mmtpu's `make_train_step` on a 2-device
  mesh from the same weights (`from_jax_variables`) and global batches,
  mmtpu's `tests/test_parallel.py` recipes (the FcClassifier with Adam, the
  conv AVMNIST with BatchNorm and SGD, a padded tail): parameters at 1e-5,
  predictions equal, the ranks' parameters bit-identical;
- the `TrainLoop`, resident and streaming, at N = 2 against one process and
  against mmtpu's scan-on-mesh (`tests/test_device_loop.py`'s recipe):
  epoch losses at 1e-5, metrics identical; a train batch that does not
  divide over the ranks streams;
- C-MAM's loss units at N = 2 in float64 against one process on the
  global batch: `mmd_loss`, `moment_matching_loss`, the MI term (handed
  one global permutation) and the full `CMAMLoss` with every weight on
  (its permutation drawn by rank 0): the ranks' shares summed within 1e-6,
  the predictions' gradients within 1e-6 of their norm, a full batch and a
  padded one whose rank 1 holds no real row.
"""

import argparse
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _mesh_ranks  # noqa: E402
from test_device_loop import build_loop as jax_build_loop  # noqa: E402
from test_parallel import (  # noqa: E402
    build_avmnist_state_and_task,
    build_state_and_task,
    make_avmnist_batch,
    make_batch,
)

from mmtpu.parallel.mesh import DATA_AXIS  # noqa: E402
from mmtpu.parallel.mesh import MeshConfig as JaxMeshConfig  # noqa: E402
from mmtpu.parallel.mesh import create_mesh as jax_create_mesh  # noqa: E402
from mmtpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from mmtpu_torch.checkpoints import from_jax_variables  # noqa: E402
from mmtpu_torch.config.spec import specs_from_dicts  # noqa: E402
from mmtpu_torch.models import build_module  # noqa: E402
from mmtpu_torch.models.avmnist import AVMNIST  # noqa: E402
from mmtpu_torch.models.fc import FcEncoder  # noqa: E402
from mmtpu_torch.models.norm import BatchNorm, batch_mask  # noqa: E402
from mmtpu_torch.parallel import Mesh, MeshConfig, create_mesh, shard_batch  # noqa: E402
from mmtpu_torch.parallel.launch import launch  # noqa: E402

CPU = torch.device("cpu")
BN_TOL = 1e-6
LOSS_TOL = 1e-6
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6  # mmtpu's tests/test_parallel.py
LOOP_TOL = 1e-5
ENC_ARGS = dict(
    conv_block_one_one_args={"conv_one_in": 1, "conv_one_out": 8},
    conv_block_one_two_args={"conv_one_in": 8, "conv_one_out": 8},
    conv_block_two_one_args={"conv_one_in": 8, "conv_one_out": 16},
    conv_block_two_two_args={"conv_one_in": 16, "conv_one_out": 16},
)


def _mesh2():
    return jax_create_mesh(JaxMeshConfig(data_parallel=2, model_parallel=1),
                           devices=jax.devices()[:2])


def _run_ranks(work: Path, n: int, names) -> list:
    mesh = create_mesh(MeshConfig(data_parallel=n), devices=[CPU] * n)
    assert launch(mesh, _mesh_ranks.run_cases, (str(work), list(names)), timeout=120) == 0
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(n)]


# -- the inputs, and mmtpu's side --------------------------------------------------------


def _bn_inputs(work: Path) -> dict:
    g = np.random.default_rng(0)
    data = {"x": g.normal(size=(16, 3, 4, 5)).astype(np.float32) * 2 + 1,
            "g": g.normal(size=(16, 3, 4, 5)).astype(np.float32),
            "weight": (1 + 0.1 * g.normal(size=3)).astype(np.float32),
            "bias": (0.1 * g.normal(size=3)).astype(np.float32),
            # 6 real rows: at N = 2 rank 1, at N = 4 ranks 2 and 3 hold none
            "mask": (np.arange(16) < 6).astype(np.float32)}
    np.savez(work / "bn.npz", **data)
    return data


def _jax_steps(work: Path) -> dict:
    """mmtpu's three steps on a 2-device mesh for each recipe; the port's
    inputs to `steps.pt`."""
    cases, want = {}, {}
    rng = jax.random.PRNGKey(7)
    mesh = _mesh2()
    padded = make_avmnist_batch(16)
    for k in ("audio", "image", "labels"):
        padded[k][4:] = 0  # 4 real rows: rank 1 holds none
    padded["sample_mask"] = (np.arange(16) < 4).astype(np.float32)
    full = {**make_avmnist_batch(16), "sample_mask": np.ones(16, np.float32)}
    recipes = {
        "fc": (build_state_and_task, [make_batch()] * 3, "fcclassifier",
               {"input_dim": 16, "layers": [32], "output_dim": 4, "dropout": 0.0},
               {"name": "Adam", "default_kwargs": {"lr": 0.01}}, ["x"]),
        "avmnist": (build_avmnist_state_and_task, [full, full, padded], "avmnist",
                    {"audio_encoder": {"__module_spec__": "mnist_audio", "hidden_dim": 32,
                                       **ENC_ARGS},
                     "image_encoder": {"__module_spec__": "mnist_image", "hidden_dim": 32,
                                       **ENC_ARGS},
                     "hidden_dim": 32, "dropout": 0.0, "fusion_fn": "concat"},
                    {"name": "SGD", "default_kwargs": {"lr": 1e-2}}, ["audio", "image"]),
    }
    for name, (build, batches, module, kwargs, opt, keys) in recipes.items():
        state, task = build()
        target = build_module(module, **specs_from_dicts(kwargs))
        sd = from_jax_variables(jax.tree_util.tree_map(np.asarray, state.params),
                                jax.tree_util.tree_map(np.asarray, state.batch_stats) or None,
                                target=target)
        cases[name] = {"name": module, "kwargs": kwargs, "state_dict": sd, "optimizer": opt,
                       "input_keys": keys, "batches": batches}
        step = jax_make_train_step(task, mesh=mesh, donate=False)
        losses, preds = [], []
        with mesh:
            for k, b in enumerate(batches):
                sharded = {key: jax.device_put(v, NamedSharding(
                    mesh, P(DATA_AXIS, *([None] * (np.ndim(v) - 1))))) for key, v in b.items()}
                state, out = step(state, sharded, jax.random.fold_in(rng, k))
                losses.append(float(out["loss"]))
                preds.append(np.asarray(out["preds"]))
        want[name] = {"losses": losses, "preds": preds, "state": from_jax_variables(
            jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, state.batch_stats) or None, target=target)}
    torch.save(cases, work / "steps.pt")
    return want


def _loss_inputs(work: Path) -> dict:
    g = torch.Generator().manual_seed(5)
    data = {"p": torch.randn(16, 6, generator=g, dtype=torch.float64),
            "t": torch.randn(16, 6, generator=g, dtype=torch.float64),
            "orig": torch.randn(16, 5, generator=g, dtype=torch.float64),
            "A": 0.3 * torch.randn(5, 6, generator=g, dtype=torch.float64),
            "Bc": 0.3 * torch.randn(6, 5, generator=g, dtype=torch.float64),
            "C": torch.randn(6, 3, generator=g, dtype=torch.float64),
            "labels": torch.randint(0, 3, (16,), generator=g),
            "perm": torch.randperm(16, generator=g),
            # 5 real rows: at N = 2 rank 1 holds none
            "mask": (torch.arange(16) < 5).to(torch.float64)}
    torch.save(data, work / "loss.pt")
    return data


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """Two ranks: the BatchNorm, the train steps, the loop and C-MAM's loss
    units; mmtpu's steps and scan-on-mesh loop; the port's loop in one
    process."""
    work = tmp_path_factory.mktemp("mesh2")
    bn = _bn_inputs(work)
    loss = _loss_inputs(work)
    steps = _jax_steps(work)
    jloop = jax_build_loop("on", mesh=_mesh2())
    assert jloop._scan
    params = jax.tree_util.tree_map(np.asarray, jloop.state.params)
    target = AVMNIST(FcEncoder(3008, [16], dropout=0.0), FcEncoder(784, [16], dropout=0.0),
                     hidden_dim=16, dropout=0.0)
    sd = from_jax_variables(params, target=target)
    torch.save(sd, work / "loop.pt")
    ranks = _run_ranks(work, 2, ["bn", "steps", "loop", "loss"])
    jloop.run()
    single = _mesh_ranks.loop("on", sd)
    single.run()
    return {"bn": bn, "steps": steps, "jloop": jloop, "single": single, "ranks": ranks,
            "loss": loss}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh4")
    return {"bn": _bn_inputs(work), "ranks": _run_ranks(work, 4, ["bn"])}


# -- resolve_mesh, create_mesh, shard_batch ---------------------------------------------


def _resolve(dp_flag=None, dp_config=None, devices=1, device="cpu", monkeypatch=None,
             batch=None):
    from mmtpu_torch.cli import common

    cfg = argparse.Namespace(experiment=argparse.Namespace(data_parallel=dp_config))
    if batch is not None:
        cfg.data = argparse.Namespace(datasets={"train": argparse.Namespace(batch_size=batch)})
    if monkeypatch is not None:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: devices)
    return common.resolve_mesh(cfg, argparse.Namespace(data_parallel=dp_flag),
                               torch.device(device))


def test_resolve_mesh_cases_follow_mmtpu(monkeypatch):
    for dp in (None, 0, 1, -1):
        assert _resolve(dp) is None and _resolve(None, dp) is None
    with pytest.raises(ValueError, match=r"data_parallel=-3: use -1 \(all devices\)"):
        _resolve(-3)
    # on the CPU each rank is a process: no card count limits N
    mesh = _resolve(4)
    assert (mesh.world_size, mesh.backend, mesh.launched) == (4, "gloo", False)
    assert mesh.devices == [CPU] * 4
    # on the GPU, mmtpu's rules over the visible cards
    assert _resolve(-1, devices=1, device="cuda", monkeypatch=monkeypatch) is None
    mesh = _resolve(-1, devices=4, device="cuda", monkeypatch=monkeypatch)
    assert mesh.devices == [torch.device("cuda", i) for i in range(4)]
    assert mesh.backend == "nccl"
    assert _resolve(None, 2, devices=4, device="cuda", monkeypatch=monkeypatch).world_size == 2
    with pytest.raises(ValueError, match="data_parallel=2 but only 1 devices visible"):
        _resolve(2, devices=1, device="cuda", monkeypatch=monkeypatch)
    with pytest.raises(ValueError, match="data_parallel=8 but only 4 devices visible"):
        _resolve(8, devices=4, device="cuda", monkeypatch=monkeypatch)
    with pytest.raises(ValueError, match="dataset 'train' batch_size=30 not divisible by "
                                         "data_parallel=4"):
        _resolve(4, batch=30)


def test_create_mesh_rules():
    from mmtpu_torch.parallel.mesh import ROADMAP_MODEL_AXIS

    with pytest.raises(NotImplementedError, match="model_parallel=2.*" + ROADMAP_MODEL_AXIS):
        create_mesh(MeshConfig(data_parallel=2, model_parallel=2), devices=[CPU] * 2)
    with pytest.raises(ValueError, match=r"mesh 3x1 != 2 devices"):
        create_mesh(MeshConfig(data_parallel=3), devices=[CPU] * 2)
    # ranks that share a card talk over gloo; NCCL needs a card per rank
    shared = [torch.device("cuda", 0)] * 2
    assert create_mesh(MeshConfig(2), devices=shared).backend == "gloo"
    with pytest.raises(ValueError, match="NCCL backend needs one CUDA device per rank"):
        create_mesh(MeshConfig(2), devices=shared, backend="nccl")
    assert create_mesh(devices=[torch.device("cuda", i) for i in range(2)]).backend == "nccl"


def test_shard_batch_slices_and_error():
    batch = {"x": np.arange(24).reshape(12, 2), "labels": np.arange(12), "scale": np.float32(3)}
    for rank in range(3):
        mesh = Mesh(devices=[CPU] * 3, backend="gloo", rank=rank)
        got = shard_batch(batch, mesh)
        np.testing.assert_array_equal(got["x"], batch["x"][4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(got["labels"], np.arange(4 * rank, 4 * rank + 4))
        assert got["scale"] == 3
    with pytest.raises(ValueError, match=r"batch dim 12 not divisible by data_parallel=5 — "
                                         r"pick a batch_size that is a multiple"):
        shard_batch(batch, Mesh(devices=[CPU] * 5, backend="gloo", rank=0))


# -- BatchNorm over the global batch ----------------------------------------------------


def _bn_one_process(data: dict, variant: str) -> dict:
    bn = BatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(data["weight"]))
        bn.bias.copy_(torch.from_numpy(data["bias"]))
    x = torch.from_numpy(data["x"]).requires_grad_()
    mask = torch.from_numpy(data["mask"]) if variant == "padded" else None
    with batch_mask(mask):
        y = bn(x)
    (y * torch.from_numpy(data["g"])).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("variant", ["full", "padded"])
def test_global_batchnorm_matches_one_process(two, four, n, variant):
    run = two if n == 2 else four
    want = _bn_one_process(run["bn"], variant)
    ranks = [r["bn"][variant] for r in run["ranks"]]
    for key in ("y", "x_grad"):  # the ranks' rows, in order
        got = torch.cat([r[key] for r in ranks])
        np.testing.assert_allclose(got.numpy(), want[key].numpy(), rtol=BN_TOL, atol=BN_TOL,
                                   err_msg=key)
    for key in ("weight_grad", "bias_grad", "running_mean", "running_var"):
        for r in ranks:  # the same on every rank
            np.testing.assert_allclose(r[key].numpy(), want[key].numpy(), rtol=BN_TOL,
                                       atol=BN_TOL, err_msg=key)
            assert torch.equal(r[key], ranks[0][key]), key
    if variant == "padded":  # the last rank holds no real row, and its outputs are finite
        assert not run["bn"]["mask"][-16 // n:].any() and torch.isfinite(ranks[-1]["y"]).all()


# -- the train step against mmtpu's mesh step ---------------------------------------------


@pytest.mark.parametrize("recipe", ["fc", "avmnist"])
def test_three_steps_match_mmtpu_mesh_step(two, recipe):
    want = two["steps"][recipe]
    ranks = [r["steps"][recipe] for r in two["ranks"]]
    for k, (got, ref) in enumerate(zip(ranks[0]["losses"], want["losses"])):
        assert got == pytest.approx(ref, rel=STEP_RTOL), k
    for got, ref in zip(ranks[0]["preds"], want["preds"]):
        np.testing.assert_array_equal(got, ref)
    for key, ref in want["state"].items():
        got = ranks[0]["state"][key]
        if key.endswith("num_batches_tracked"):
            assert int(got) == 3, key
            continue
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=STEP_RTOL, atol=STEP_ATOL,
                                   err_msg=key)
    # every rank applied the same summed gradient: bit-identical parameters
    for key, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][key]), key


# -- the loop ---------------------------------------------------------------------------


def _metrics(entry: dict) -> dict:
    return {split: {k: v for k, v in body.items() if k not in ("loss", "timing")}
            for split, body in entry.items() if split != "epoch"}


def test_loop_on_mesh_matches_one_process_and_mmtpu_scan_on_mesh(two):
    rank0 = two["ranks"][0]["loop"]
    assert rank0["on_resident"] == ["train", "validation"] and rank0["off_resident"] == []
    runs = {"mmtpu scan on mesh": two["jloop"].epoch_metrics,
            "port resident on mesh": rank0["on"], "port streaming on mesh": rank0["off"],
            "port resident, one process": two["single"].epoch_metrics}
    ref = runs.pop("mmtpu scan on mesh")
    assert len(ref) == 2
    for name, entries in runs.items():
        assert len(entries) == 2, name
        for a, b in zip(ref, entries):
            for split in ("train", "validation"):
                assert b[split]["loss"] == pytest.approx(a[split]["loss"], rel=LOOP_TOL), \
                    (name, split)
            assert _metrics(b) == _metrics(a), name
    for mode in ("on", "off"):  # the ranks end with the same weights
        for key, v in rank0[f"{mode}_state"].items():
            assert torch.equal(v, two["ranks"][1]["loop"][f"{mode}_state"][key]), (mode, key)


def test_indivisible_train_batch_streams_on_mesh(two):
    """mmtpu's `test_scan_on_mesh_skips_indivisible_batch`: a train batch of
    31 does not divide over 2 ranks, so train streams; validation stays."""
    assert two["ranks"][0]["loop"]["indivisible_resident"] == ["validation"]


@pytest.mark.parametrize("variant", ["full", "padded"])
@pytest.mark.parametrize("unit", _mesh_ranks.LOSS_UNITS)
def test_cmam_loss_units_match_one_process_on_the_global_batch(two, unit, variant):
    want, want_grad = _mesh_ranks.loss_unit(two["loss"], unit, variant, slice(None))
    shares = [r["loss"][(unit, variant)] for r in two["ranks"]]
    got = sum(v for v, _ in shares)
    got_grad = torch.cat([g for _, g in shares])
    assert abs(float(got - want)) <= LOSS_TOL * max(abs(float(want)), 1.0), (got, want)
    err = float(torch.linalg.vector_norm(got_grad - want_grad))
    assert err <= LOSS_TOL * float(torch.linalg.vector_norm(want_grad)), err
    if variant == "padded" and unit != "cmam":  # rank 1's rows are padding
        assert float(torch.linalg.vector_norm(shares[1][1])) == 0.0
