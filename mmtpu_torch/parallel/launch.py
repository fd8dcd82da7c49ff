"""Start the ranks of a mesh (the process side of `parallel/mesh.py`).

    rc = launch(mesh, fn, args)              # fn(*args) in every rank
    rc = run_cli(mesh, "mmtpu_torch.cli.train_multimodal", argv)
    rc = launch_process(mesh, fn, args, coordinator="host:port",
                        num_processes=P, process_id=p)   # in each of P processes

One process per rank, started with `torch.multiprocessing`'s spawn context,
so a rank imports only the module of `fn` (the CLIs' ranks: the CLI module)
and never the caller's. Under `launch` the ranks meet through a file in a
fresh temporary directory (no fixed port: several launches may run at
once). Under `launch_process` (mmtpu's `jax.distributed.initialize` at a
coordinator address) P separately started processes, on one host or on
several, each start their L = world / P ranks, global ranks p·L + i, and
the ranks meet at a TCP store at the coordinator address, which process 0
hosts. Each rank
binds its device (`torch.cuda.set_device`, or on the CPU an equal share of
the cores), joins the process group with `timeout` (which also bounds every
collective), opens the gloo group for host objects and, on a (dp, mp)
mesh, every data and model group (`_groups`), sets the default mesh and
runs `fn`. Ranks other than 0 print nothing to standard output: rank 0
writes the console lines, as it writes the run's files.

The parent joins the ranks and returns 0, or the first non-zero exit code:
a rank that raises prints its traceback and exits 1, and the parent then
ends the others after `GRACE_S`, so one failed rank (or collective) fails
the run within the timeout instead of leaving the others waiting. Across
processes the parents share that through the store: a parent whose rank
failed sets `FAILED_KEY`, every parent polls it (and takes a store it can
no longer reach as a failure), gives its ranks `GRACE_S` and ends them, so
every process ends non-zero within `timeout + GRACE_S`. Process 0 keeps the
store up until every process has said it is done.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import os
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch

from mmtpu_torch.parallel.mesh import Mesh, get_default_mesh, set_default_mesh

TIMEOUT_S = 600.0  # process-group set-up and every collective
GRACE_S = 5.0  # after one rank fails, how long the others get to end on their own
POLL_S = 0.2  # how often a parent of `launch_process` reads the store
FAILED_KEY = "mmtpu_torch/failed"  # set by a parent whose rank failed: the global rank
DONE_KEY = "mmtpu_torch/done/{}"  # set by process p's parent once its ranks are joined


def launch(mesh: Mesh, fn: Callable[..., Any], args: Sequence[Any] = (),
           timeout: float = TIMEOUT_S) -> int:
    """Run `fn(*args)` in one process per rank of `mesh` (not yet launched)
    and join them; 0 or the first non-zero exit code. `fn` and `args` must
    pickle by reference (module-level functions)."""
    if mesh.launched:
        raise ValueError("launch() takes a mesh to launch, not a rank's mesh")
    with tempfile.TemporaryDirectory(prefix="mmtpu_torch_rendezvous_") as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        return _run_ranks(mesh, range(mesh.world_size), init, timeout, fn, args)


def _run_ranks(mesh: Mesh, ranks: Sequence[int], init, timeout: float,
               fn: Callable[..., Any], args: Sequence[Any], store=None) -> int:
    """Start `ranks` of `mesh`, one spawned process each, and join them
    (`_join`); none is left running."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(mesh, r, init, timeout, fn, tuple(args)),
                         name=f"mmtpu_torch-rank{r}") for r in ranks]
    for p in procs:
        p.start()
    try:
        return _join(procs, store, list(ranks))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()


def _join(procs, store=None, ranks: Sequence[int] = ()) -> int:
    """Wait for every rank; on the first failure give the rest GRACE_S,
    then end them. The first non-zero exit code, or 0. With `store` (the
    ranks of one process of `launch_process`, global ranks `ranks`) a
    failure here is published under FAILED_KEY, and one published by
    another process (or a store that is gone) counts as a failure here."""
    from multiprocessing.connection import wait

    first = 0
    deadline: Optional[float] = None
    pending = list(procs)
    while pending:
        left = None if deadline is None else max(0.0, deadline - time.monotonic())
        if store is not None:
            left = POLL_S if left is None else min(left, POLL_S)
        wait([p.sentinel for p in pending], timeout=left)
        for p in [p for p in pending if not p.is_alive()]:
            p.join()
            pending.remove(p)
            if p.exitcode and not first:
                first = p.exitcode if p.exitcode > 0 else 1
                deadline = time.monotonic() + GRACE_S
                if store is not None:
                    _publish_failure(store, ranks[procs.index(p)])
        if store is not None and not first and pending and _failed_elsewhere(store):
            first, deadline = 1, time.monotonic() + GRACE_S
        if deadline is not None and time.monotonic() >= deadline:
            for p in pending:
                p.terminate()
                p.join()
            pending = []
    return first


def _publish_failure(store, rank: int) -> None:
    try:
        store.set(FAILED_KEY, str(rank))
    except Exception:  # noqa: BLE001 — the store's host is gone: the others see that
        pass


def _failed_elsewhere(store) -> bool:
    """A rank of another process failed, or the store is unreachable."""
    try:
        return store.check([FAILED_KEY])
    except Exception:  # noqa: BLE001
        return True


def _parse_coordinator(coordinator: str):
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r} is not host:port")
    return host, int(port)


def launch_process(mesh: Mesh, fn: Callable[..., Any], args: Sequence[Any] = (),
                   coordinator: str = "127.0.0.1:29500", num_processes: int = 1,
                   process_id: int = 0, timeout: float = TIMEOUT_S) -> int:
    """This process's share of a mesh that `num_processes` separately
    started processes run together (mmtpu's `jax.distributed.initialize`):
    `fn(*args)` in its L = world / P ranks, global ranks p·L + i, on
    `mesh.devices[p·L + i]` (`process_mesh` lays those out). Every process
    calls it with the same mesh, `fn`, `args`, coordinator and count.
    Process 0 hosts the TCP store at `coordinator`; the others connect to
    it within `timeout`. 0, or non-zero when any rank of any process failed
    (every process then ends within `timeout + GRACE_S`)."""
    import torch.distributed as dist

    if mesh.launched:
        raise ValueError("launch_process() takes a mesh to launch, not a rank's mesh")
    world = mesh.world_size
    if num_processes < 1 or world % num_processes or not 0 <= process_id < num_processes:
        raise ValueError(f"{world} ranks over {num_processes} processes, process "
                         f"{process_id}: the processes must share the ranks equally")
    host, port = _parse_coordinator(coordinator)
    local = world // num_processes
    ranks = [process_id * local + i for i in range(local)]
    td = datetime.timedelta(seconds=timeout)
    store = dist.TCPStore(host, port, world_size=None, is_master=process_id == 0,
                          timeout=td, wait_for_workers=False)
    rc = _run_ranks(mesh, ranks, ("tcp", host, port), timeout, fn, args, store)
    try:
        store.set(DONE_KEY.format(process_id), str(rc))
        if process_id == 0:
            # the others' ranks may still be leaving the process group
            store.wait([DONE_KEY.format(q) for q in range(1, num_processes)], td)
            if not rc and store.check([FAILED_KEY]):
                rc = 1
    except Exception:  # noqa: BLE001 — a peer that never reports is a failed run
        rc = rc or 1
    return rc


def process_mesh(config, num_processes: int, local_devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of `num_processes` processes that each hold `local_devices`
    (default: every visible CUDA device): global rank p·L + i on the
    process's `local_devices[i]`, laid out (dp, mp) row-major as
    `create_mesh` lays out one process's devices, NCCL when each process's
    devices are distinct CUDA devices, gloo otherwise."""
    from mmtpu_torch.parallel.mesh import create_mesh

    if local_devices is None:
        local_devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return create_mesh(config, devices=list(local_devices) * num_processes,
                       processes=num_processes)


def _rank_main(mesh: Mesh, rank: int, init, timeout: float, fn: Callable[..., Any],
               args: tuple) -> None:
    import torch.distributed as dist

    code = 1
    try:
        if rank > 0:
            sys.stdout = open(os.devnull, "w")
        device = mesh.devices[rank]
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.world_size))
        td = datetime.timedelta(seconds=timeout)
        if isinstance(init, tuple):  # launch_process: the store process 0 hosts
            _, host, port = init
            store = dist.TCPStore(host, port, world_size=None, is_master=False, timeout=td)
            dist.init_process_group(mesh.backend, store=store, rank=rank,
                                    world_size=mesh.world_size, timeout=td)
        else:
            dist.init_process_group(mesh.backend, init_method=init, rank=rank,
                                    world_size=mesh.world_size, timeout=td)
        set_default_mesh(dataclasses.replace(mesh, rank=rank, **_groups(mesh, rank, td)))
        rc = fn(*args)
        code = rc if isinstance(rc, int) else 0
        if code == 0:
            get_default_mesh().barrier()
            dist.destroy_process_group()
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    except BaseException:  # noqa: BLE001 — the rank's failure is its exit code
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # a failed rank leaves without tearing the group down: its peers may be
    # inside a collective, and the parent ends them
    os._exit(code)


def _groups(mesh: Mesh, rank: int, td: datetime.timedelta) -> dict:
    """This rank's process groups. Without a model axis the data group is
    the world, and the host and barrier groups are it too over gloo (a gloo
    group beside it over NCCL). On a (dp, mp) mesh every rank creates every
    data group (the ranks with one m), then every model group (the ranks
    with one d), then their gloo twins over NCCL, in the same order:
    `new_group` is collective over the world, and ranks that created them
    in other orders would wait on each other for ever."""
    import torch.distributed as dist

    gloo = mesh.backend == "gloo"
    mp, dp = mesh.model_size, mesh.data_size
    if mp == 1:
        host = dist.group.WORLD if gloo else dist.new_group(backend="gloo", timeout=td)
        return {"group": dist.group.WORLD, "host_group": host, "world_group": host}
    data_ranks = [[d * mp + m for d in range(dp)] for m in range(mp)]
    model_ranks = [[d * mp + m for m in range(mp)] for d in range(dp)]
    data = [dist.new_group(r, timeout=td) for r in data_ranks]
    model = [dist.new_group(r, timeout=td) for r in model_ranks]
    hosts = data if gloo else [dist.new_group(r, backend="gloo", timeout=td)
                               for r in data_ranks]
    world = dist.group.WORLD if gloo else dist.new_group(backend="gloo", timeout=td)
    d, m = divmod(rank, mp)
    return {"group": data[m], "host_group": hosts[m], "model_group": model[d],
            "world_group": world}


def _run_main(module: str, argv: Sequence[str]) -> int:
    return importlib.import_module(module).main(list(argv))


def run_cli(mesh: Mesh, module: str, argv: Sequence[str],
            timeout: float = TIMEOUT_S) -> int:
    """A CLI's `main(argv)` in every rank of `mesh`: each rank parses the
    same command line, finds its mesh through `cli.common.rank_mesh` and
    runs the driver on its rows."""
    return launch(mesh, _run_main, (module, list(argv)), timeout=timeout)
