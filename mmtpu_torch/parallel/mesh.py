"""Data parallelism over several devices (counterpart of `mmtpu/parallel/mesh.py`).

mmtpu shards every batch over the `data` axis of a device mesh, keeps the
parameters replicated, and lets XLA insert the gradient all-reduce. The
port runs one process per rank (`parallel/launch.py`), rank r on
`devices[r]`, NCCL between CUDA devices and gloo on the CPU (or between
ranks that share a card). The arithmetic is mmtpu's, the single-device
run's:

- every rank cuts the same global batch and keeps its contiguous rows
  [r·B/N, (r+1)·B/N) (`shard_batch`): mmtpu's `put_global` contract, which
  `put_global(x, NamedSharding(mesh, spec))` gives for any global value
  (or a callback over the global index), each dimension on DATA_AXIS, on
  MODEL_AXIS or whole, as mmtpu's `P(...)` names them;
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
entry (`cli/common.py`'s `rank_mesh`), and hand it on.

The model axis (mmtpu's `model`, `MeshConfig.model_parallel > 1`): the
mesh is (dp, mp), rank r = d·mp + m, mmtpu's row-major `reshape(dp, mp)`.
Rank r holds a data group, the dp ranks with its m, and a model group,
the mp ranks with its d. Everything above is over the DATA group: `rows`,
the collectives, `broadcast_` (from the group's first rank, d = 0),
`gather`, and `data_size`, the divisor of `replicated_share`; the ranks of
a model group see the same rows and compute the same values. The model
group carries the tensor-parallel head's sums (`parallel/tensor.py`).
`world_size` (dp·mp) is the launcher's count. mmtpu's CLIs always build
`model_parallel=1`, so a model axis is a library surface here too: the
CLIs, the resident epoch, the fused eval, the stacked engine and the
monitor raise on one (`parallel/tensor.py`'s `refuse_model_axis`).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_local = threading.local()

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass
class MeshConfig:
    """Shape of the mesh, (data_parallel, model_parallel).
    data_parallel=-1 → every device given, over model_parallel."""

    data_parallel: int = -1
    model_parallel: int = 1


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (dp, mp) mesh of dp·mp ranks: `devices[r]` is rank r's device,
    `model_size` is mp. Until the launcher starts the ranks
    (`parallel/launch.py`), `rank` and the groups are None; in a rank they
    hold its index, the data group of the collectives (`group`, the
    backend's), the gloo group for host objects over the same ranks
    (`host_group`), the model group (`model_group`, the backend's; None
    when mp = 1) and a gloo group over every rank (`world_group`, the
    barrier's)."""

    devices: List[torch.device]
    backend: str
    model_size: int = 1
    rank: Optional[int] = None
    group: Any = None
    host_group: Any = None
    model_group: Any = None
    world_group: Any = None

    @property
    def world_size(self) -> int:
        """Every rank of the mesh, dp·mp: the launcher's count."""
        return len(self.devices)

    @property
    def data_size(self) -> int:
        """The data axis's size, dp: the ranks a global batch is cut over."""
        return len(self.devices) // self.model_size

    @property
    def data_rank(self) -> int:
        """This rank's place on the data axis, d."""
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        """This rank's place on the model axis, m."""
        return self.rank % self.model_size

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
        _check_divisible(n, self.data_size)
        per = n // self.data_size
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    # -- the active mesh of a step ------------------------------------------------

    def __enter__(self) -> "Mesh":
        _local.__dict__.setdefault("stack", []).append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _local.stack.pop()
        return False

    # -- collectives --------------------------------------------------------------

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the data group, differentiable: its backward sums
        the ranks' gradients (BatchNorm's global statistics)."""
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(t, group=self.group)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the data group, outside autograd."""
        import torch.distributed as dist

        dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_grads(self, params: Iterable[torch.nn.Parameter]) -> int:
        """Sum every gradient over the data group, one flattened bucket per
        dtype; returns the bytes reduced."""
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
        """Every data rank's (b, ...) rows as the (dp·b, ...) global tensor,
        in rank order, on every rank: this rank's rows written into its slot
        of a zero buffer, then the buffer summed over the data group (gloo's
        `all_gather` takes CPU tensors only; a sum runs on every backend).
        Differentiable when `t` needs a gradient: each rank's rows get the
        sum over the ranks of their gradients."""
        b = t.shape[0]
        rest = tuple(t.shape[1:])
        buf = torch.cat([t.new_zeros((self.data_rank * b,) + rest), t,
                         t.new_zeros(((self.data_size - self.data_rank - 1) * b,) + rest)])
        if torch.is_grad_enabled() and t.requires_grad:
            return self.all_reduce(buf)
        return self.all_reduce_(buf)

    def broadcast_(self, tensors: Iterable[torch.Tensor]) -> None:
        """Overwrite `tensors` with the data group's first rank's (d = 0;
        rank 0 without a model axis), in place."""
        import torch.distributed as dist

        for t in tensors:
            dist.broadcast(t, src=self.model_rank, group=self.group)

    def gather(self, obj: Any) -> List[Any]:
        """Every data rank's `obj` (host objects: numpy arrays, numbers), in
        rank order, on every rank, over the data group's gloo group."""
        import torch.distributed as dist

        out: List[Any] = [None] * self.data_size
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def barrier(self) -> None:
        """Every rank of the mesh meets (rank 0 has written a file the
        others read)."""
        import torch.distributed as dist

        dist.barrier(group=self.world_group)

    # -- the model axis -----------------------------------------------------------

    def model_all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the model group, outside autograd."""
        import torch.distributed as dist

        dist.all_reduce(t, group=self.model_group)
        return t

    def model_gather(self, obj: Any) -> List[Any]:
        """Every model rank's `obj` (a dict of CPU tensors: a state's
        shards), in model-rank order, on every rank of the model group."""
        import torch.distributed as dist

        out: List[Any] = [None] * self.model_size
        dist.all_gather_object(out, obj, group=self.model_group)
        return out


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
                backend: Optional[str] = None, processes: int = 1) -> Mesh:
    """The mesh to launch (mmtpu's `create_mesh`): `devices` default to
    every visible CUDA device, laid out as (dp, mp) row-major, and dp·mp
    must be their count (data_parallel=-1 → count // mp); `backend` to NCCL
    for distinct CUDA devices, gloo otherwise. A device may appear more
    than once (ranks that share a card), over gloo only. A mesh of
    `processes` separately started processes (`launch.process_mesh`) lists
    each process's devices in turn: the NCCL rule holds within each."""
    config = config or MeshConfig()
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    mp = max(1, config.model_parallel)
    dp = config.data_parallel if config.data_parallel > 0 else n // mp
    if dp * mp != n or not devices:
        raise ValueError(f"mesh {dp}x{mp} != {n} devices")
    if processes < 1 or n % processes:
        raise ValueError(f"{n} devices do not divide over {processes} processes")
    local = n // processes
    distinct = all(len(set(devices[i:i + local])) == local for i in range(0, n, local))
    cuda = all(d.type == "cuda" for d in devices)
    backend = backend or ("nccl" if cuda and distinct else "gloo")
    if backend == "nccl" and not (cuda and distinct):
        raise ValueError("the NCCL backend needs one CUDA device per rank; "
                         f"got {[str(d) for d in devices]} (use gloo)")
    return Mesh(devices=devices, backend=backend, model_size=mp)


_default_mesh: Optional[Mesh] = None  # set once per rank process by the launcher


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh() -> Optional[Mesh]:
    """This process's mesh when it is one of a launched mesh's ranks."""
    return _default_mesh


def data_mesh(mesh: Mesh) -> Mesh:
    """A launched (dp, mp) mesh's ranks as a pure data-parallel mesh
    (dp·mp, 1) of the same processes: every rank its own rows, the world
    its data group (mmtpu's second `create_mesh` over the same devices)."""
    import torch.distributed as dist

    if mesh.model_size == 1:
        return mesh
    return dataclasses.replace(mesh, model_size=1, group=dist.group.WORLD,
                               host_group=mesh.world_group, model_group=None)


def global_rows(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Under the active mesh, `t`'s rows of every rank, the global batch's
    (`Mesh.all_gather`); `t` itself (None too) otherwise."""
    mesh = active_mesh()
    return t if mesh is None or t is None else mesh.all_gather(t)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How a global value lies on a launched mesh, mmtpu's
    `NamedSharding(mesh, P(...))`: per leading dimension the axis it is cut
    over, DATA_AXIS (the data group's ranks hold contiguous equal row
    blocks), MODEL_AXIS (the model group's ranks hold contiguous equal
    slices) or None (whole on every rank); dimensions past `spec` are
    whole. `spec=()` is replicated."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def index(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's index into a global value of `shape`."""
        if len(self.spec) > len(shape):
            raise ValueError(f"sharding {self.spec} has more dimensions than {tuple(shape)}")
        out = []
        for n, axis in zip(shape, self.spec):
            if axis == DATA_AXIS:
                out.append(self.mesh.rows(n))
            elif axis == MODEL_AXIS:
                size = self.mesh.model_size
                if n % size:
                    raise ValueError(f"dimension of {n} does not divide over "
                                     f"model_parallel={size}")
                out.append(slice(self.mesh.model_rank * (n // size),
                                 (self.mesh.model_rank + 1) * (n // size)))
            elif axis is None:
                out.append(slice(None))
            else:
                raise ValueError(f"no mesh axis {axis!r} ({DATA_AXIS!r}, {MODEL_AXIS!r})")
        return tuple(out) + (slice(None),) * (len(shape) - len(self.spec))


def batch_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Dimension 0 (the batch) over the data axis, the rest whole."""
    return NamedSharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def put_global(x: Union[Any, Callable[[Tuple[slice, ...]], Any]], sharding: NamedSharding,
               shape: Optional[Sequence[int]] = None,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """This rank's shard of a global value, on its device (`device`, by
    default the rank's): mmtpu's `put_global`. `x` is the whole value (an
    array or a tensor, as every process holds it), or, as
    `jax.make_array_from_callback` takes it, a function of the global index
    that returns that index's block of a value of `shape`: then no process
    builds more than its own ranks' blocks."""
    if callable(x):
        if shape is None:
            raise ValueError("put_global(callback, ...) needs the global shape")
        block = x(sharding.index(tuple(shape)))
    else:
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        block = x[sharding.index(tuple(x.shape))]
    block = block if isinstance(block, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(block))
    return block.contiguous().to(device or sharding.mesh.device)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a host batch, on the host: `put_global`'s block
    under `batch_sharding` before its copy to the device (the step copies
    it). Every array's leading dim must be divisible by the data axis's
    size (mmtpu's error otherwise); scalars are kept whole (replicated)."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = v if v.ndim == 0 else v[batch_sharding(mesh, v.ndim).index(v.shape)]
    return out


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of `module` set to its data group's first
    rank's, rank 0's without a model axis (mmtpu's replicated sharding; a
    model shard keeps its model rank's slice). Where every process holds the
    same whole value, `put_global(value, NamedSharding(mesh))` gives each
    rank its copy without a collective; this broadcast also makes ranks
    that drew different values agree."""
    with torch.no_grad():
        mesh.broadcast_(list(module.parameters()) + list(module.buffers()))
    return module
