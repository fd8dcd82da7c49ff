"""Start the ranks of a mesh (the process side of `parallel/mesh.py`).

    rc = launch(mesh, fn, args)              # fn(*args) in every rank
    rc = run_cli(mesh, "mmtpu_torch.cli.train_multimodal", argv)

One process per rank, started with `torch.multiprocessing`'s spawn context,
so a rank imports only the module of `fn` (the CLIs' ranks: the CLI module)
and never the caller's. The ranks meet through a file in a fresh temporary
directory (no fixed port: several launches may run at once). Each rank
binds its device (`torch.cuda.set_device`, or on the CPU an equal share of
the cores), joins the process group with `timeout` (which also bounds every
collective), opens the gloo group for host objects, sets the default mesh
and runs `fn`. Ranks other than 0 print nothing to standard output: rank 0
writes the console lines, as it writes the run's files.

The parent joins the ranks and returns 0, or the first non-zero exit code:
a rank that raises prints its traceback and exits 1, and the parent then
ends the others after `GRACE_S`, so one failed rank (or collective) fails
the run within the timeout instead of leaving the others waiting.
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

from mmtpu_torch.parallel.mesh import Mesh, set_default_mesh

TIMEOUT_S = 600.0  # process-group set-up and every collective
GRACE_S = 5.0  # after one rank fails, how long the others get to end on their own


def launch(mesh: Mesh, fn: Callable[..., Any], args: Sequence[Any] = (),
           timeout: float = TIMEOUT_S) -> int:
    """Run `fn(*args)` in one process per rank of `mesh` (not yet launched)
    and join them; 0 or the first non-zero exit code. `fn` and `args` must
    pickle by reference (module-level functions)."""
    if mesh.launched:
        raise ValueError("launch() takes a mesh to launch, not a rank's mesh")
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mmtpu_torch_rendezvous_") as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(target=_rank_main, args=(mesh, r, init, timeout, fn, tuple(args)),
                             name=f"mmtpu_torch-rank{r}")
                 for r in range(mesh.world_size)]
        for p in procs:
            p.start()
        try:
            return _join(procs)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()


def _join(procs) -> int:
    """Wait for every rank; on the first failure give the rest GRACE_S,
    then end them. The first non-zero exit code, or 0."""
    from multiprocessing.connection import wait

    first = 0
    deadline: Optional[float] = None
    pending = list(procs)
    while pending:
        left = None if deadline is None else max(0.0, deadline - time.monotonic())
        wait([p.sentinel for p in pending], timeout=left)
        for p in [p for p in pending if not p.is_alive()]:
            p.join()
            pending.remove(p)
            if p.exitcode and not first:
                first = p.exitcode if p.exitcode > 0 else 1
                deadline = time.monotonic() + GRACE_S
        if deadline is not None and time.monotonic() >= deadline:
            for p in pending:
                p.terminate()
                p.join()
            pending = []
    return first


def _rank_main(mesh: Mesh, rank: int, init: str, timeout: float, fn: Callable[..., Any],
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
        dist.init_process_group(mesh.backend, init_method=init, rank=rank,
                                world_size=mesh.world_size, timeout=td)
        host = (dist.group.WORLD if mesh.backend == "gloo"
                else dist.new_group(backend="gloo", timeout=td))
        set_default_mesh(dataclasses.replace(mesh, rank=rank, group=dist.group.WORLD,
                                             host_group=host))
        rc = fn(*args)
        code = rc if isinstance(rc, int) else 0
        if code == 0:
            dist.barrier(group=host)
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


def _run_main(module: str, argv: Sequence[str]) -> int:
    return importlib.import_module(module).main(list(argv))


def run_cli(mesh: Mesh, module: str, argv: Sequence[str],
            timeout: float = TIMEOUT_S) -> int:
    """A CLI's `main(argv)` in every rank of `mesh`: each rank parses the
    same command line, finds its mesh through `cli.common.rank_mesh` and
    runs the driver on its rows."""
    return launch(mesh, _run_main, (module, list(argv)), timeout=timeout)
