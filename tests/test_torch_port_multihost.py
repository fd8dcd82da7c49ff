"""A mesh of separately started processes in the port
(`mmtpu_torch/parallel/launch.py` `launch_process`, `parallel/multihost.py`)
against mmtpu's multi-process leg (`scripts/multihost_worker.py`,
`__graft_entry__.py:348`) on the CPU, and `put_global` / `batch_sharding`
against mmtpu's.

One module fixture starts, side by side with `subprocess`, the two runs of
`multihost.run`: two workers of two gloo ranks each, started on their own
and meeting at a TCP store on a free local port, and the baseline of one
worker holding all four ranks, a (2, 2) mesh both. Both start from mmtpu's
`_compact_setup` weights (dropout 0, carried across by `from_jax_variables`)
while this process runs mmtpu's single-device steps:

- the two runs agree bit for bit (loss, replicated-parameter checksum,
  resident-epoch loss, accuracy; the gathered states and logits too);
- the Adam step's loss within 1e-5 relative of mmtpu's, the SGD-stepped
  parameters within mmtpu's own rtol 2e-5 / atol 2e-6
  (`__graft_entry__.py:294`), the eval predictions and `accuracy_AI` equal;
- the resident epoch's first loss on the pure data-parallel mesh of the
  same processes within rtol 2e-5 of mmtpu's scan epoch from the same
  weights;
- the eval forward calls the head's kernel wrapper twice per rank; global
  rank 0 alone writes the checkpoint.

A rank that raises in process 1 ends both processes non-zero within the
timeout, while the other ranks wait in a collective.
"""

import dataclasses
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from __graft_entry__ import _compact_setup  # noqa: E402

from mmtpu.config.optim import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from mmtpu.data.avmnist import SyntheticAVMNIST as JaxSyntheticAVMNIST  # noqa: E402
from mmtpu.models import build_module as jax_build_module  # noqa: E402
from mmtpu.parallel.mesh import DATA_AXIS as JAX_DATA_AXIS  # noqa: E402
from mmtpu.parallel.mesh import MODEL_AXIS as JAX_MODEL_AXIS  # noqa: E402
from mmtpu.parallel.mesh import MeshConfig as JaxMeshConfig  # noqa: E402
from mmtpu.parallel.mesh import batch_sharding as jax_batch_sharding  # noqa: E402
from mmtpu.parallel.mesh import create_mesh as jax_create_mesh  # noqa: E402
from mmtpu.parallel.mesh import put_global as jax_put_global  # noqa: E402
from mmtpu.train import device_loop as jax_dl  # noqa: E402
from mmtpu.train.losses import LossFunctionGroup as JaxLossFunctionGroup  # noqa: E402
from mmtpu.train.optim import build_optimizer as jax_build_optimizer  # noqa: E402
from mmtpu.train.state import TrainState as JaxTrainState  # noqa: E402
from mmtpu.train.step import ClassificationTask as JaxClassificationTask  # noqa: E402
from mmtpu.train.step import make_eval_step as jax_make_eval_step  # noqa: E402
from mmtpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from mmtpu_torch.checkpoints import from_jax_variables  # noqa: E402
from mmtpu_torch.config.spec import specs_from_dicts  # noqa: E402
from mmtpu_torch.models import build_module  # noqa: E402
from mmtpu_torch.parallel import multihost  # noqa: E402
from mmtpu_torch.parallel.launch import GRACE_S, launch_process  # noqa: E402
from mmtpu_torch.parallel.mesh import (  # noqa: E402
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshConfig,
    NamedSharding,
    batch_sharding,
    create_mesh,
    put_global,
)

from _torch_threads import passive_children  # noqa: E402,F401 — its ranks wait passively

PROCS, LOCAL = 2, 2
WORLD = PROCS * LOCAL
B = 2 * WORLD
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-6  # mmtpu's __graft_entry__.py:294
SCAN_RTOL = 2e-5  # mmtpu's multihost_dryrun.py
TIMEOUT_S = 240.0
FAIL_TIMEOUT_S = 30.0  # the failing run's collective timeout
TESTS = str(Path(__file__).resolve().parent)


def _command(job: str):
    return [sys.executable, "-c",
            f"import sys; sys.path.insert(0, {TESTS!r}); import _mesh_ranks; "
            f"sys.exit(_mesh_ranks.multihost_main(sys.argv[1:], {job!r}))"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mmtpu(weights_file: Path) -> dict:
    """mmtpu on one device from `_compact_setup`'s weights (dropout 0): the
    Adam step's loss, the SGD-stepped parameters, the eval step on them;
    mmtpu's scan epoch (`multihost_worker._scan_epoch_loss`, one device) and
    its weights. The weights go to `weights_file` first, in the port's
    layout, for the workers."""
    model, variables, batch, _ = _compact_setup(B)
    model = model.clone(dropout=0.0)
    kwargs = {**multihost.COMPACT_KWARGS, "dropout": 0.0}
    port = build_module("avmnist", **specs_from_dicts(kwargs))
    compact_sd = from_jax_variables(_np(variables["params"]), _np(variables["batch_stats"]),
                                    target=port)
    scan_model = jax_build_module(
        "avmnist",
        audio_encoder=jax_build_module("fcencoder", input_dim=3008, layers=[16], dropout=0.0),
        image_encoder=jax_build_module("fcencoder", input_dim=784, layers=[16], dropout=0.0),
        hidden_dim=16, dropout=0.0, fusion_fn="concat")
    rng = jax.random.PRNGKey(0)
    sv = jax.device_get(scan_model.init({"params": rng}, jnp.zeros((2, 32, 94, 1)),
                                        jnp.zeros((2, 28, 28, 1)), train=False))
    scan_sd = from_jax_variables(_np(sv["params"]), _np(sv.get("batch_stats")) or None,
                                 target=multihost._scan_model(None))
    torch.save({"compact": {"kwargs": kwargs, "state_dict": compact_sd}, "scan": scan_sd},
               weights_file)

    task = JaxClassificationTask(model=model, loss_group=JaxLossFunctionGroup.from_dict(
        {"ce": {"loss_name": "cross_entropy", "weight": 1.0}}), input_keys=("audio", "image"))
    step = jax_make_train_step(task, donate=False)
    out = {"batch": batch}
    for name, opt in (("adam", multihost.ADAM), ("sgd", multihost.SGD)):
        tx, _ = jax_build_optimizer(JaxOptimizerConfig(**opt), variables["params"])
        st = JaxTrainState.create(apply_fn=model.apply, params=variables["params"],
                                  batch_stats=variables["batch_stats"], tx=tx)
        st, res = step(st, jax.device_put(batch), rng)
        out[name] = {"loss": float(res["loss"]),
                     "state": from_jax_variables(_np(st.params), _np(st.batch_stats),
                                                 target=port)}
    eval_batch = dict(batch, pattern_id=np.zeros(B, np.int32))
    ev = jax_make_eval_step(task)(st, jax.device_put(eval_batch))
    out["preds"] = np.asarray(ev["preds"])
    out["accuracy_AI"] = float(np.mean(out["preds"] == batch["labels"]))

    ds = JaxSyntheticAVMNIST(split="train", num_samples=8 * WORLD, selected_patterns=["ai"],
                             seed=0)
    scan_task = JaxClassificationTask(model=scan_model, loss_group=JaxLossFunctionGroup.from_dict(
        {"ce": {"loss_name": "cross_entropy", "weight": 1.0}}), input_keys=("audio", "image"))
    tx, _ = jax_build_optimizer(JaxOptimizerConfig(**multihost.SCAN_ADAM), sv["params"])
    state = JaxTrainState.create(apply_fn=scan_model.apply, params=sv["params"],
                                 batch_stats=sv.get("batch_stats", {}), tx=tx)
    data = jax_dl.DeviceResidentData.upload(ds)
    fn = jax_dl.make_scan_train_epoch(scan_task, data)
    schedule = jax_dl.put_schedule(jax_dl.build_schedule(ds, 2 * WORLD, 0, False, 0, "train"))
    _, outs = fn(state, schedule, rng)
    out["scan_loss"] = float(np.asarray(outs["loss"]).ravel()[0])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("multihost")
    weights = work / "weights.pt"
    extra = ("--cpu", "--weights", str(weights), "--out", str(work),
             "--timeout", str(TIMEOUT_S))
    with ThreadPoolExecutor(1) as pool:
        # the weights are written before mmtpu's steps compile; the workers
        # start as soon as they are there and run beside mmtpu's steps
        want = {}

        def mmtpu_then_signal():
            want.update(_mmtpu(weights))

        written = pool.submit(mmtpu_then_signal)
        while not weights.exists() and not written.done():
            time.sleep(0.05)
        if written.done():
            written.result()
        msg = multihost.run(TIMEOUT_S, PROCS, LOCAL, extra, _command("multihost_audited"))
        written.result()
    procs = {p: torch.load(work / f"procs{p}.pt", weights_only=False) for p in (1, PROCS)}
    audits = {p: [json.loads((work / f"audit_procs{p}_rank{r}.json").read_text())
                  for r in range(WORLD)] for p in (1, PROCS)}
    return {"work": work, "msg": msg, "procs": procs, "audits": audits, "want": want}


def _assert_state(got: dict, want: dict) -> None:
    assert sorted(k for k in got if not k.endswith("num_batches_tracked")) == sorted(
        k for k in want if not k.endswith("num_batches_tracked"))
    for key, ref in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].numpy(), ref.numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=key)


def test_two_processes_equal_one_process_bit_for_bit(runs):
    assert runs["msg"].startswith("dryrun_multihost OK")
    one, two = runs["procs"][1], runs["procs"][PROCS]
    assert (one["world"], two["world"]) == (WORLD, WORLD)
    for key in ("loss", "repl_checksum", "scan_loss", "acc_AI", "sgd_loss"):
        assert two[key] == one[key], key
    for key in ("adam_state", "sgd_state"):
        assert sorted(two[key]) == sorted(one[key])
        for k in one[key]:
            assert torch.equal(two[key][k], one[key][k]), (key, k)
    np.testing.assert_array_equal(two["logits"], one["logits"])
    np.testing.assert_array_equal(two["preds"], one["preds"])


@pytest.mark.parametrize("procs", [1, PROCS])
def test_step_and_eval_match_mmtpu(runs, procs):
    got, want = runs["procs"][procs], runs["want"]
    assert abs(got["loss"] - want["adam"]["loss"]) <= LOSS_RTOL * abs(want["adam"]["loss"])
    assert abs(got["sgd_loss"] - want["sgd"]["loss"]) <= LOSS_RTOL * abs(want["sgd"]["loss"])
    _assert_state(got["sgd_state"], want["sgd"]["state"])
    np.testing.assert_array_equal(got["preds"], want["preds"])
    assert got["acc_AI"] == pytest.approx(want["accuracy_AI"], abs=0)


@pytest.mark.parametrize("procs", [1, PROCS])
def test_resident_epoch_on_the_processes_matches_mmtpus_scan(runs, procs):
    got, want = runs["procs"][procs]["scan_loss"], runs["want"]["scan_loss"]
    assert abs(got - want) <= SCAN_RTOL * abs(want)


@pytest.mark.parametrize("procs", [1, PROCS])
def test_kernel_wrapper_twice_per_rank_and_rank_0_alone_writes(runs, procs):
    audits = runs["audits"][procs]
    assert [a["fused_mlp_calls"] for a in audits] == [2] * WORLD
    ckpt = runs["work"] / f"ckpt_procs{procs}"
    assert [Path(p).name for p in audits[0]["saved"]] == [
        "epoch_1.pth.tmp", "best.pth.tmp", f"procs{procs}.pt"]
    assert all(not a["saved"] for a in audits[1:])
    tree = torch.load(ckpt / "best.pth", weights_only=True)
    for k, v in runs["procs"][procs]["sgd_state"].items():
        assert torch.equal(tree["model"][k], v), k
    # on the CPU the wrapper takes the plain chain: no device launch
    assert runs["procs"][procs]["eval_launches"] == [0] * WORLD


def test_a_rank_failing_in_process_1_ends_both_processes(tmp_path):
    t0 = time.monotonic()
    workers = multihost.start_workers(PROCS, LOCAL, ("--cpu", "--timeout", str(FAIL_TIMEOUT_S)),
                                      _command("multihost_failing"))
    outs = multihost.wait_workers(workers, 4 * FAIL_TIMEOUT_S)
    elapsed = time.monotonic() - t0
    assert [rc for rc, _, _ in outs] != [0, 0] and all(rc != 0 for rc, _, _ in outs), outs
    assert "rank 2 fails on purpose" in outs[1][2]
    assert elapsed < FAIL_TIMEOUT_S + GRACE_S, elapsed


def _mmtpu_shards(x: np.ndarray, spec, dp: int, mp: int, callback: bool):
    """mmtpu's per-device blocks of `x` on a (dp, mp) mesh of this process's
    first dp·mp CPU devices, in device (rank) order, and the indices its
    callback was asked for."""
    from jax.sharding import NamedSharding as JaxNamedSharding, PartitionSpec as P

    mesh = jax_create_mesh(JaxMeshConfig(dp, mp), devices=jax.devices()[:dp * mp])
    if spec == "batch":
        sh = jax_batch_sharding(mesh, x.ndim)
    else:
        sh = JaxNamedSharding(mesh, P(*[{DATA_AXIS: JAX_DATA_AXIS, MODEL_AXIS: JAX_MODEL_AXIS,
                                         None: None}[a] for a in spec]))
    asked = []
    if callback:
        arr = jax.make_array_from_callback(x.shape, sh, lambda idx: asked.append(idx) or x[idx])
    else:
        arr = jax_put_global(x, sh)
    order = list(mesh.devices.ravel())
    blocks = sorted(arr.addressable_shards, key=lambda s: order.index(s.device))
    return [np.asarray(s.data) for s in blocks], [s.index for s in blocks], asked


def _norm(index, shape):
    """A block's index as (start, stop, step) per dimension."""
    index = tuple(index) + (slice(None),) * (len(shape) - len(index))
    return [s.indices(n) for s, n in zip(index, shape)]


@pytest.mark.parametrize("dp,mp,spec", [
    (4, 1, "batch"), (2, 2, "batch"), (2, 2, (None, MODEL_AXIS)), (2, 2, (MODEL_AXIS,)),
    (2, 2, (DATA_AXIS, MODEL_AXIS)), (2, 2, ())])
@pytest.mark.parametrize("callback", [False, True])
def test_put_global_and_batch_sharding_match_mmtpu(dp, mp, spec, callback):
    x = np.random.default_rng(3).normal(size=(8, 6, 2)).astype(np.float32)
    blocks, indices, _ = _mmtpu_shards(x, spec, dp, mp, callback)
    mesh = create_mesh(MeshConfig(dp, mp), devices=[torch.device("cpu")] * (dp * mp))
    for rank in range(dp * mp):
        rmesh = dataclasses.replace(mesh, rank=rank)
        sh = batch_sharding(rmesh, x.ndim) if spec == "batch" else NamedSharding(rmesh, spec)
        if callback:
            asked = []
            got = put_global(lambda idx: asked.append(idx) or x[idx], sh, x.shape)
            assert [_norm(i, x.shape) for i in asked] == [_norm(indices[rank], x.shape)]
        else:
            got = put_global(x, sh)
        assert got.device == torch.device("cpu")
        np.testing.assert_array_equal(got.numpy(), blocks[rank])


def test_batch_sharding_names_mmtpus_axes_and_refuses_an_indivisible_batch():
    mesh = create_mesh(MeshConfig(2, 2), devices=[torch.device("cpu")] * 4)
    assert batch_sharding(mesh, 3).spec == (DATA_AXIS, None, None)
    assert (DATA_AXIS, MODEL_AXIS) == (JAX_DATA_AXIS, JAX_MODEL_AXIS)
    rmesh = dataclasses.replace(mesh, rank=1)
    with pytest.raises(ValueError, match="not divisible by data_parallel=2"):
        put_global(np.zeros((5, 2)), batch_sharding(rmesh))
    with pytest.raises(ValueError, match="needs the global shape"):
        put_global(lambda idx: None, batch_sharding(rmesh))


def test_launch_process_refuses_ranks_that_do_not_share_out():
    mesh = create_mesh(MeshConfig(2, 2), devices=[torch.device("cpu")] * 4)
    with pytest.raises(ValueError, match="share the ranks equally"):
        launch_process(mesh, print, (), num_processes=3, process_id=0)
    with pytest.raises(ValueError, match="host:port"):
        launch_process(mesh, print, (), coordinator="nowhere", num_processes=2)
    assert isinstance(mesh, Mesh) and not mesh.launched
