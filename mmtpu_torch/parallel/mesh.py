"""Data parallelism over several devices (counterpart of `mmtpu/parallel/mesh.py`).

mmtpu shards every batch over the `data` axis of a device mesh, keeps the
parameters replicated, and lets XLA insert the gradient all-reduce. The
port runs one process per rank (`parallel/launch.py`), rank r on
`devices[r]`, NCCL between CUDA devices and gloo on the CPU (or between
ranks that share a card). The arithmetic is mmtpu's, the single-device
run's:

- every rank cuts the same global batch and keeps its contiguous rows
  [r·B/N, (r+1)·B/N) (`shard_batch`, mmtpu's `put_global` contract);
- the parameters and buffers start from rank 0's (`replicate`);
- the loss is the global masked mean: a rank's loss is its masked sum over
  the GLOBAL count (`train/losses.py`), so a rank without a real row adds
  zero, and the sum of the ranks' gradients is the gradient of the global
  loss (`Mesh.all_reduce_grads`, one flattened bucket per step);
- BatchNorm in training takes its statistics over the global batch's real
  rows (`models/norm.py`, through `Mesh.all_reduce`, which carries
  gradients back);
- a term that is not a sum over rows (C-MAM's MMD, moments and MI
  negatives) is computed by every rank alike on the global batch's rows
  (`Mesh.all_gather`, differentiable) and counted as 1/N of it on each
  (`train/losses.py`'s `replicated_share`); a host-drawn tensor (C-MAM's
  permutation) is rank 0's (`Mesh.broadcast_`);
- the outputs the recorder reads are gathered in global-batch order over a
  second, gloo group for host objects (`Mesh.gather`), so every rank
  computes the same metrics and takes the same decisions.

A step publishes its mesh to BatchNorm and the losses for the duration of
the step with `with mesh:` (as mmtpu's steps run under `with mesh:`).

Outside a rank there is no default mesh: `get_default_mesh()` is None
(mmtpu's builds one over every device). The CLIs read it once, at their
entry (`cli/common.py`'s `rank_mesh`), and hand it on. `model_parallel > 1` (mmtpu's
`model` axis, which only its tests and the graft entry reach) is not
ported and raises.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

ROADMAP_MODEL_AXIS = "ROADMAP.md §1 item 6, the model axis"

_local = threading.local()


@dataclasses.dataclass
class MeshConfig:
    """Shape of the mesh. data_parallel=-1 → every device given."""

    data_parallel: int = -1
    model_parallel: int = 1


@dataclasses.dataclass(eq=False)
class Mesh:
    """N data-parallel ranks: `devices[r]` is rank r's device. Until the
    launcher starts the ranks (`parallel/launch.py`), `rank` and the groups
    are None; in a rank they hold its index, the process group of the
    collectives (`group`, the backend's) and the gloo group for host
    objects (`host_group`)."""

    devices: List[torch.device]
    backend: str
    rank: Optional[int] = None
    group: Any = None
    host_group: Any = None

    @property
    def world_size(self) -> int:
        return len(self.devices)

    @property
    def launched(self) -> bool:
        return self.rank is not None

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes the run's files and console lines."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of `n` rows."""
        _check_divisible(n, self.world_size)
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    # -- the active mesh of a step ------------------------------------------------

    def __enter__(self) -> "Mesh":
        _local.__dict__.setdefault("stack", []).append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _local.stack.pop()
        return False

    # -- collectives --------------------------------------------------------------

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks, differentiable: its backward sums the
        ranks' gradients (BatchNorm's global statistics)."""
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(t, group=self.group)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the ranks, outside autograd."""
        import torch.distributed as dist

        dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_grads(self, params: Iterable[torch.nn.Parameter]) -> int:
        """Sum every gradient over the ranks, one flattened bucket per dtype;
        returns the bytes reduced."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        nbytes = 0
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            self.all_reduce_(flat)
            nbytes += flat.numel() * flat.element_size()
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        return nbytes

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's (b, ...) rows as the (N·b, ...) global tensor, in
        rank order, on every rank: this rank's rows written into its slot
        of a zero buffer, then the buffer summed over the ranks (gloo's
        `all_gather` takes CPU tensors only; a sum runs on every backend).
        Differentiable when `t` needs a gradient: each rank's rows get the
        sum over the ranks of their gradients."""
        b = t.shape[0]
        rest = tuple(t.shape[1:])
        buf = torch.cat([t.new_zeros((self.rank * b,) + rest), t,
                         t.new_zeros(((self.world_size - self.rank - 1) * b,) + rest)])
        if torch.is_grad_enabled() and t.requires_grad:
            return self.all_reduce(buf)
        return self.all_reduce_(buf)

    def broadcast_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Overwrite `tensors` with rank 0's, in place."""
        import torch.distributed as dist

        for t in tensors:
            dist.broadcast(t, src=0, group=self.group)

    def gather(self, obj: Any) -> List[Any]:
        """Every rank's `obj` (host objects: numpy arrays, numbers), in rank
        order, on every rank, over the gloo group."""
        import torch.distributed as dist

        out: List[Any] = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.host_group)


def _check_divisible(n: int, dp: int) -> None:
    if n % dp:
        raise ValueError(
            f"batch dim {n} not divisible by data_parallel={dp}"
            " — pick a batch_size that is a multiple of the data-axis"
            " size (or lower --data-parallel)"
        )


def active_mesh() -> Optional[Mesh]:
    """The mesh the running step published with `with mesh:` on this
    thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def create_mesh(config: Optional[MeshConfig] = None,
                devices: Optional[Sequence[torch.device]] = None,
                backend: Optional[str] = None) -> Mesh:
    """The mesh to launch (mmtpu's `create_mesh`): `devices` default to
    every visible CUDA device; `backend` to NCCL for distinct CUDA devices,
    gloo otherwise. A device may appear more than once (ranks that share a
    card), over gloo only."""
    config = config or MeshConfig()
    if config.model_parallel > 1:
        raise NotImplementedError(
            f"model_parallel={config.model_parallel}: the model axis is not ported to "
            f"mmtpu_torch ({ROADMAP_MODEL_AXIS})")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    dp = config.data_parallel if config.data_parallel > 0 else len(devices)
    if dp != len(devices) or not devices:
        raise ValueError(f"mesh {dp}x1 != {len(devices)} devices")
    distinct = len(set(devices)) == len(devices)
    cuda = all(d.type == "cuda" for d in devices)
    backend = backend or ("nccl" if cuda and distinct else "gloo")
    if backend == "nccl" and not (cuda and distinct):
        raise ValueError("the NCCL backend needs one CUDA device per rank; "
                         f"got {[str(d) for d in devices]} (use gloo)")
    return Mesh(devices=devices, backend=backend)


_default_mesh: Optional[Mesh] = None  # set once per rank process by the launcher


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh() -> Optional[Mesh]:
    """This process's mesh when it is one of a launched mesh's ranks."""
    return _default_mesh


def global_rows(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Under the active mesh, `t`'s rows of every rank, the global batch's
    (`Mesh.all_gather`); `t` itself (None too) otherwise."""
    mesh = active_mesh()
    return t if mesh is None or t is None else mesh.all_gather(t)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a host batch: every array's leading dim must be
    divisible by the data-axis size (mmtpu's error otherwise); scalars are
    kept whole."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = v if v.ndim == 0 else v[mesh.rows(v.shape[0])]
    return out


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of `module` set to rank 0's (mmtpu's
    replicated sharding)."""
    with torch.no_grad():
        mesh.broadcast_(list(module.parameters()) + list(module.buffers()))
    return module
