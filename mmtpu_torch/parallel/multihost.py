"""A mesh of separately started processes (counterpart of mmtpu's
`scripts/multihost_worker.py` and `scripts/multihost_dryrun.py`).

One worker is one process of the mesh, started on its own (two shells, or
two hosts):

    python -m mmtpu_torch.parallel.multihost --coordinator H:P \\
        --num-processes P --process-id p --local-ranks L [--cpu]

The P processes start L ranks each (`launch.launch_process`) and meet at the
TCP store process 0 hosts at the coordinator address. With
`--num-processes 1` the worker is the single-process baseline. The ranks
run mmtpu's multi-process job:

- the compact AVMNIST of mmtpu's `_compact_setup` (ConvBlock 16/32 encoders,
  hidden 64 and 128, head 128, dropout 0.5), on a (world / 2, 2) mesh with
  its head tensor-parallel (`shard_module` with mmtpu's rule, each shard
  its `put_global` slice), on the same numpy-seeded global batch of
  B = 2 · world rows;
- one Adam step (lr 5e-4, weight decay 1e-4): the global loss and the sum
  of |w| over the replicated parameters after it (mmtpu's checksum);
- one SGD step (lr 1e-2) from the same weights: the gathered parameters,
  and a checkpoint of them (`--out`), which global rank 0 alone writes;
- the eval step on that state and the recorder's `accuracy_AI` on the same
  mesh, where the head's eval forward runs `fused_mlp` on the shard pair
  and on the tail (two launches per eval step per rank on the card);
- the device-resident epoch on the same processes as a pure data-parallel
  mesh (world, 1): mmtpu's FcEncoder AVMNIST, Adam 1e-3, its first loss.

Global rank 0 prints `MULTIHOST procs=P loss=… repl_checksum=… scan_loss=…
acc_AI=…` and, with `--out DIR`, writes `DIR/procs{P}.pt` (everything the
comparison reads). `--weights FILE` (a torch file: `{"compact": {"kwargs",
"state_dict"}, "scan": state_dict}`) starts from given weights, mmtpu's in
the tests; the default is the port's seeded initialisation.

`run(timeout)` starts the baseline (one process, every rank) and the P
processes on free local ports, compares them and returns `dryrun_multihost
OK: …` as mmtpu's does. The two runs have the same world, the same rows
per rank and the same collectives, so they agree bit for bit.
"""

from __future__ import annotations

import argparse
import re
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

SEED = 0
ADAM = {"name": "Adam", "default_kwargs": {"lr": 5e-4, "weight_decay": 1e-4}}
SGD = {"name": "SGD", "default_kwargs": {"lr": 1e-2}}
SCAN_ADAM = {"name": "Adam", "default_kwargs": {"lr": 1e-3}}
CONV_ARGS = {
    "conv_block_one_one_args": {"conv_one_in": 1, "conv_one_out": 16},
    "conv_block_one_two_args": {"conv_one_in": 16, "conv_one_out": 16},
    "conv_block_two_one_args": {"conv_one_in": 16, "conv_one_out": 32},
    "conv_block_two_two_args": {"conv_one_in": 32, "conv_one_out": 32},
}
COMPACT_KWARGS = {  # mmtpu's __graft_entry__._compact_setup
    "audio_encoder": {"__module_spec__": "mnist_audio", "hidden_dim": 64, **CONV_ARGS},
    "image_encoder": {"__module_spec__": "mnist_image", "hidden_dim": 128, **CONV_ARGS},
    "hidden_dim": 128, "dropout": 0.5, "fusion_fn": "concat"}
DEFAULT_PROCESSES, DEFAULT_LOCAL_RANKS = 2, 2
RTOL = 0.0  # the two runs share every rank's arithmetic: bit for bit
LINE = re.compile(r"MULTIHOST procs=(\d+) loss=(\S+) repl_checksum=(\S+) scan_loss=(\S+) "
                  r"acc_AI=(\S+)")


def compact_batch(n: int) -> dict:
    """mmtpu's `_compact_setup` batch of `n` rows, NHWC as mmtpu's."""
    return {"audio": np.random.default_rng(0).normal(size=(n, 32, 94, 1)).astype(np.float32),
            "image": np.random.default_rng(1).normal(size=(n, 28, 28, 1)).astype(np.float32),
            "labels": np.random.default_rng(2).integers(0, 10, n)}


def _compact_model(weights: Optional[dict]):
    from mmtpu_torch.config.spec import specs_from_dicts
    from mmtpu_torch.models import build_module

    spec = (weights or {}).get("compact", {})
    torch.manual_seed(SEED)  # every rank builds the same whole model
    model = build_module("avmnist", **specs_from_dicts(spec.get("kwargs", COMPACT_KWARGS)))
    if "state_dict" in spec:
        model.load_state_dict(spec["state_dict"], strict=True)
    return model


def _scan_model(weights: Optional[dict]):
    from mmtpu_torch.models.avmnist import AVMNIST
    from mmtpu_torch.models.fc import FcEncoder

    torch.manual_seed(SEED)
    model = AVMNIST(FcEncoder(3008, [16], dropout=0.0), FcEncoder(784, [16], dropout=0.0),
                    hidden_dim=16, dropout=0.0)
    if weights and "scan" in weights:
        model.load_state_dict(weights["scan"], strict=True)
    return model


def _task(model):
    from mmtpu_torch.train.losses import LossFunctionGroup
    from mmtpu_torch.train.step import ClassificationTask

    return ClassificationTask(model=model, loss_group=LossFunctionGroup.from_dict(
        {"ce": {"loss_name": "cross_entropy", "weight": 1.0}}), input_keys=("audio", "image"))


def _sharded_state(weights, optimizer: dict, mesh, device):
    from mmtpu_torch.config.optim import OptimizerConfig
    from mmtpu_torch.models.avmnist import AVMNIST
    from mmtpu_torch.parallel.tensor import shard_module
    from mmtpu_torch.train.optim import build_optimizer
    from mmtpu_torch.train.state import TrainState

    model = shard_module(_compact_model(weights), mesh, AVMNIST.TENSOR_PARALLEL_RULE)
    model.to(device)
    opt, _ = build_optimizer(OptimizerConfig(**optimizer), model)
    return TrainState(model=model, optimizer=opt, mesh=mesh), _task(model)


def _global_loss(mesh, loss: float) -> float:
    return float(sum(mesh.gather(loss)))


def _global_rows(mesh, t: torch.Tensor) -> np.ndarray:
    return np.concatenate(mesh.gather(t.detach().cpu().numpy()))


def resident_first_loss(mesh, weights, device) -> float:
    """mmtpu's `_scan_epoch_loss` on the ranks of `mesh` as a pure
    data-parallel mesh: the first loss of one device-resident epoch."""
    from mmtpu_torch.config.optim import OptimizerConfig
    from mmtpu_torch.data.avmnist import SyntheticAVMNIST
    from mmtpu_torch.parallel.mesh import data_mesh
    from mmtpu_torch.train import device_loop as dl
    from mmtpu_torch.train.optim import build_optimizer
    from mmtpu_torch.train.state import TrainState

    dmesh = data_mesh(mesh)
    n = dmesh.world_size
    ds = SyntheticAVMNIST(split="train", num_samples=8 * n, selected_patterns=["ai"], seed=0)
    model = _scan_model(weights).to(device)
    opt, _ = build_optimizer(OptimizerConfig(**SCAN_ADAM), model)
    state = TrainState(model=model, optimizer=opt, mesh=dmesh)
    data = dl.DeviceResidentData.upload(ds, device)
    schedule = dl.shard_schedule(dl.build_schedule(ds, 2 * n, 0, False, 0, "train"), dmesh)
    out = dl.run_train_epoch(_task(model), state, data, schedule, device)
    return _global_loss(dmesh, float(out["loss"][0]))


def rank_job(job: dict) -> int:
    """The worker's job in one rank of the launched (world / 2, 2) mesh;
    global rank 0 prints the line and writes `procs{P}.pt`."""
    from mmtpu_torch.checkpoints.manager import CheckpointManager
    from mmtpu_torch.config.metrics import MetricConfig, MetricDef
    from mmtpu_torch.ops import fused_mlp
    from mmtpu_torch.parallel.mesh import get_default_mesh
    from mmtpu_torch.parallel.tensor import gather_state_dict, shard_dims
    from mmtpu_torch.train.recorder import MetricRecorder
    from mmtpu_torch.train.step import make_eval_step, make_train_step

    mesh = get_default_mesh()
    device = mesh.device
    weights = torch.load(job["weights"], weights_only=False) if job.get("weights") else None
    batch = compact_batch(2 * mesh.world_size)
    rec = {"procs": job["procs"], "world": mesh.world_size}

    state, task = _sharded_state(weights, ADAM, mesh, device)
    rec["loss"] = _global_loss(mesh, float(make_train_step(task, state, device)(batch)["loss"]))
    dims = shard_dims(state.model)
    rec["repl_checksum"] = sum(float(p.detach().abs().sum().cpu())
                               for n, p in state.model.named_parameters() if n not in dims)
    rec["adam_state"] = gather_state_dict(state.model)

    state, task = _sharded_state(weights, SGD, mesh, device)
    rec["sgd_loss"] = _global_loss(mesh, float(make_train_step(task, state, device)(batch)["loss"]))
    rec["sgd_state"] = gather_state_dict(state.model)
    if job.get("out"):
        CheckpointManager(Path(job["out"]) / f"ckpt_procs{job['procs']}").save_checkpoint(
            state, 1, rec["sgd_loss"])

    eval_batch = dict(batch, pattern_id=np.zeros(len(batch["labels"]), np.int32))
    before = fused_mlp.launches
    out = make_eval_step(task, device, mesh)(eval_batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = fused_mlp.launches - before
    preds, labels, pids = (_global_rows(mesh, out[k]) for k in ("preds", "labels", "pattern_id"))
    recorder = MetricRecorder(MetricConfig(
        metrics={"accuracy": MetricDef(function="sklearn.metrics.accuracy_score")},
        groups={"classification": ["accuracy"]}))
    recorder.update_group_ids("classification", *(torch.from_numpy(a) for a in
                                                  (preds, labels, pids)), ["ai"], None)
    rec["acc_AI"] = float(recorder.calculate_all_groups()["classification"]["accuracy_AI"])
    rec["preds"], rec["logits"] = preds, _global_rows(mesh, out["logits"])
    rec["eval_launches"] = _world_gather(mesh, launches)

    rec["scan_loss"] = resident_first_loss(mesh, weights, device)
    if mesh.is_writer:
        print(f"MULTIHOST procs={job['procs']} loss={rec['loss']!r} "
              f"repl_checksum={rec['repl_checksum']!r} scan_loss={rec['scan_loss']!r} "
              f"acc_AI={rec['acc_AI']!r} fused_mlp_launches_per_rank={rec['eval_launches']}",
              flush=True)
        if job.get("out"):
            torch.save(rec, Path(job["out"]) / f"procs{job['procs']}.pt")
    return 0


def _world_gather(mesh, obj) -> list:
    """Every rank's `obj`, in global rank order, over the world's gloo
    group."""
    import torch.distributed as dist

    out: List = [None] * mesh.world_size
    dist.all_gather_object(out, obj, group=mesh.world_group)
    return out


def local_devices(args) -> List[torch.device]:
    if args.cpu:
        return [torch.device("cpu")] * args.local_ranks
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run the ranks on the CPU")
    return [torch.device("cuda", i) for i in range(args.local_ranks)]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="One process of a multi-process mmtpu_torch mesh")
    ap.add_argument("--coordinator", default="127.0.0.1:29500",
                    help="host:port of the TCP store process 0 hosts")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-ranks", type=int, default=4, help="ranks this process starts")
    ap.add_argument("--cpu", action="store_true",
                    help="the ranks on the CPU, over gloo (else rank i on cuda:i, NCCL)")
    ap.add_argument("--weights", default=None, help="torch file of starting weights")
    ap.add_argument("--out", default=None, help="directory for procs{P}.pt and a checkpoint")
    ap.add_argument("--timeout", type=float, default=600.0)
    return ap


def main(argv: Optional[Sequence[str]] = None, job: Callable[[dict], int] = rank_job) -> int:
    """One worker: `launch_process` of `job` in this process's ranks."""
    from mmtpu_torch.parallel.launch import launch_process, process_mesh
    from mmtpu_torch.parallel.mesh import MeshConfig

    args = parser().parse_args(argv)
    world = args.num_processes * args.local_ranks
    mp = 2 if world % 2 == 0 else 1
    mesh = process_mesh(MeshConfig(world // mp, mp), args.num_processes, local_devices(args))
    return launch_process(mesh, job, ({"procs": args.num_processes, "weights": args.weights,
                                       "out": args.out},),
                          coordinator=args.coordinator, num_processes=args.num_processes,
                          process_id=args.process_id, timeout=args.timeout)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _parse(text: str, procs: int) -> tuple:
    m = next((m for m in LINE.finditer(text) if int(m.group(1)) == procs), None)
    if m is None:
        raise RuntimeError(f"worker output unparsable:\n{text[-2000:]}")
    return tuple(float(v) for v in m.groups()[1:])


def start_workers(num_processes: int, local_ranks: int, extra: Sequence[str] = (),
                  command: Optional[Sequence[str]] = None, env: Optional[dict] = None
                  ) -> List[subprocess.Popen]:
    """`num_processes` workers, each started on its own with `subprocess`,
    meeting at a free local port."""
    command = list(command or [sys.executable, "-m", "mmtpu_torch.parallel.multihost"])
    coordinator = f"127.0.0.1:{free_port()}"
    return [subprocess.Popen(
        command + ["--coordinator", coordinator, "--num-processes", str(num_processes),
                   "--process-id", str(p), "--local-ranks", str(local_ranks), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for p in range(num_processes)]


def wait_workers(procs: List[subprocess.Popen], timeout: float) -> List[tuple]:
    """(exit code, stdout, stderr) of each worker; every worker is ended at
    the deadline."""
    deadline = time.monotonic() + timeout
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    return outs


def run(timeout: float = 600.0, num_processes: int = DEFAULT_PROCESSES,
        local_ranks: int = DEFAULT_LOCAL_RANKS, extra: Sequence[str] = ("--cpu",),
        command: Optional[Sequence[str]] = None, env: Optional[dict] = None) -> str:
    """The baseline (one process, every rank) and `num_processes`
    separately started processes, side by side; their loss, checksum,
    resident-epoch loss and accuracy compared (bit for bit). Returns
    `dryrun_multihost OK: …`; raises on a failed worker or a difference."""
    world = num_processes * local_ranks
    runs = {1: start_workers(1, world, extra, command, env),
            num_processes: start_workers(num_processes, local_ranks, extra, command, env)}
    results = {}
    for procs, workers in runs.items():
        outs = wait_workers(workers, timeout)
        for rc, _, err in outs:
            if rc != 0:
                raise RuntimeError(f"a worker of the {procs}-process run failed (rc={rc}):\n"
                                   f"{err[-3000:]}")
        results[procs] = _parse(outs[0][1], procs)
    one, many = results[1], results[num_processes]
    names = ("loss", "replicated-param checksum", "resident-epoch loss", "accuracy_AI")
    for name, a, b in zip(names, many, one):
        if abs(a - b) > RTOL * abs(b):
            raise AssertionError(f"multihost {name} {a!r} != single-process {b!r}")
    return (f"dryrun_multihost OK: {num_processes} procs x {local_ranks} ranks == 1 proc x "
            f"{world} ranks (loss {many[0]!r} vs {one[0]!r}, repl-param checksum "
            f"{many[1]!r} vs {one[1]!r}, resident-epoch loss {many[2]!r} vs {one[2]!r}, "
            f"acc_AI {many[3]!r} vs {one[3]!r}, bit for bit)")


if __name__ == "__main__":
    sys.exit(main())
