"""Fused ReLU-MLP chain: relu(x·W1ᵀ + b1) ... ·Wnᵀ + bn in ONE CUDA kernel.

Counterpart of `mmtpu/ops/fused_mlp.py`; the kernel
(`csrc/fused_mlp.cu`) replaces the TPU kernel
`mmtpu/ops/fused_mlp.py::_pallas_forward`. It computes the same function:
all layers in one launch, weights and activations in shared memory, fp32
accumulation, output in `x.dtype`. What bounds it on the H100 and what its
design does about that is noted at the top of the CUDA source.

Layouts: weights are given as nn.Linear stores them, (out, in), and the
kernel reads them as they lie (mmtpu's `fused_mlp` takes (in, out)).

Dispatch, by where `x` lies (through the operator `mmtpu::fused_mlp` of
`ops/library.py` when no gradient is needed):
- CPU tensor → `fused_mlp_reference`, the plain PyTorch chain;
- CUDA tensor → the kernel, or an error. There is no fallback: a CUDA input
  the kernel does not take (dtype, layout, an architecture other than
  sm_90, a width too wide for shared memory) raises. A chain whose weights
  do not fit shared memory together, a width that is no multiple of 4, or a
  weight that starts off a 16-byte boundary are all taken by the same kernel
  (streamed, or copied with plain loads instead of `cp.async.bulk`).

A launch costs the host little beside the launch itself: the device's
properties are read once, the plan is cached by (batch, dims, SMs), and the
tables handed over by pointer are preallocated.

Only the forward is a kernel, as in mmtpu. Its backward (`_FusedMLP`) is
the plain recompute of mmtpu's `_bwd`, so differentiating through the
kernel gives the right gradient.

Member axis (mmtpu's stacked eval: Pallas's batching rule adds a grid
axis): under `torch.func.vmap` the K members' chains run in ONE launch
whose grid covers tiles × members (`_launch_members`, x (K, B, in),
weights (K, out, in), biases (K, out), a member stride of 0 for a tensor
all members share); `fused_mlp_members_reference` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Sequence, Tuple

import torch

from mmtpu_torch.ops import _build

MAX_LAYERS = 8
ROW_TILES = (1, 2, 4, 8)  # batch rows per tile the kernel is built for
HEADER_BYTES = 64  # MMTPU_MLP_HEADER_BYTES in csrc/fused_mlp.cu: the mbarriers
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on sm_90 (227 KB)


def fused_mlp_reference(x, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]):
    """The plain chain: h = h·Wᵀ + b, ReLU between layers, not after the last."""
    h = x
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = torch.addmm(b, h, w.t())
        if i < len(weights) - 1:
            h = torch.relu(h)
    return h


def weight_stride(k: int) -> int:
    """Floats between a layer's weight rows in shared memory: k rounded up to
    a multiple of 4, so that every row starts on a 16-byte boundary
    (`weight_stride` in csrc/fused_mlp.cu). Where k is a multiple of 4 the
    matrix lies there as in device memory, and one bulk copy brings it."""
    return -(-k // 4) * 4


def bulk_copy_ok(weight: torch.Tensor) -> bool:
    """Whether the kernel may bring this (out, in) matrix, or a run of its
    rows, with `cp.async.bulk`: every row must start on a 16-byte boundary
    and be a multiple of 16 bytes long. Other layers are copied with plain
    loads."""
    return weight.data_ptr() % 16 == 0 and (weight.shape[1] * weight.element_size()) % 16 == 0


def bias_floats(dims: Sequence[int]) -> int:
    """Floats the biases of all layers take in shared memory."""
    return -(-sum(dims[1:]) // 4) * 4


class ChainPlan(NamedTuple):
    """How one launch is laid out (see the top of csrc/fused_mlp.cu)."""

    rows: int        # batch rows per tile
    grid: int        # blocks; each walks over tiles
    act_stride: int  # floats between rows of an activation buffer
    resident: bool   # every layer's weights stay in shared memory together
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def chain_plan(batch: int, dims: Tuple[int, ...], num_sms: int) -> ChainPlan:
    """The layout of a launch; computed once per (batch, dims, num_sms) and kept.

    Rows per tile: the smallest of ROW_TILES that gives at most one tile per
    two SMs, so a small batch spreads over the card, yet not over more blocks
    than pay for themselves: every block brings all the weights from L2, and
    at B = 128 on 132 SMs 64 blocks of two rows were measured faster than 128
    of one or 32 of four (`fused_mlp_sweep`). With the largest tile the grid
    is one block per tile up to one per SM; beyond 8·SMs rows the blocks walk
    over several tiles. Shared memory: the header, the biases, two
    activation buffers of rows × the widest input, and the weights region.
    When every layer's matrix fits there together the chain is resident; else
    the region takes what is left and the layers are streamed through it in
    runs of whole columns, and rows are halved until one weight row of the
    widest layer fits beside the activations. Raises when even one batch
    row leaves no room for that."""
    act_stride = -(-max(dims[:-1]) // 4) * 4
    rows = next(
        (r for r in ROW_TILES if -(-batch // r) <= max(num_sms // 2, 1)), ROW_TILES[-1]
    )
    grid = min(-(-batch // rows), max(num_sms, 1))

    def fixed(r: int) -> int:
        return HEADER_BYTES + 4 * bias_floats(dims) + 2 * r * act_stride * 4

    resident = 4 * sum(n * weight_stride(k) for k, n in zip(dims[:-1], dims[1:]))
    if fixed(rows) + resident <= SMEM_LIMIT:
        return ChainPlan(rows, grid, act_stride, True, fixed(rows) + resident)
    one_row = 4 * max(weight_stride(k) for k in dims[:-1])
    while rows > 1 and fixed(rows) + one_row > SMEM_LIMIT:
        rows //= 2
    if fixed(rows) + one_row > SMEM_LIMIT:
        raise ValueError(
            f"fused_mlp: width {max(dims[:-1])} does not fit shared memory (one batch "
            f"row's activations, the biases and one weight row need {fixed(1) + one_row} B of "
            f"{SMEM_LIMIT} B)"
        )
    grid = min(-(-batch // rows), max(num_sms, 1))
    return ChainPlan(rows, grid, act_stride, False, SMEM_LIMIT)


def _check(x, weights, biases) -> Tuple[int, ...]:
    n = len(weights)
    if not (1 <= n <= MAX_LAYERS) or n != len(biases):
        raise ValueError(
            f"fused_mlp: need 1..{MAX_LAYERS} layers and one bias per weight, "
            f"got {n} weights and {len(biases)} biases"
        )
    if x.dim() != 2:
        raise ValueError(f"fused_mlp: x must be (B, D0), got {tuple(x.shape)}")
    dims = [x.shape[1]]
    for i in range(n):
        w, b = weights[i], biases[i]
        if w.dim() != 2 or w.shape[1] != dims[-1]:
            raise ValueError(
                f"fused_mlp: layer {i} weight {tuple(w.shape)} is not (out, {dims[-1]})"
            )
        if b.shape != (w.shape[0],):
            raise ValueError(f"fused_mlp: layer {i} bias {tuple(b.shape)} != ({w.shape[0]},)")
        dims.append(w.shape[0])
    dev, f32 = x.device, torch.float32
    for t in (x, *weights, *biases):
        if t.device != dev:
            raise ValueError("fused_mlp: all tensors must be on one device")
        if t.dtype is not f32:
            raise TypeError(f"fused_mlp: the CUDA kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fused_mlp: the CUDA kernel takes contiguous tensors")
    return tuple(dims)


_launch_lock = threading.Lock()
_kernel = None
# what a launch hands over by pointer, written anew under _launch_lock
_c_dims = (ctypes.c_int * (MAX_LAYERS + 1))()
_c_w = (ctypes.c_void_p * MAX_LAYERS)()
_c_b = (ctypes.c_void_p * MAX_LAYERS)()
_c_w_ms = (ctypes.c_longlong * MAX_LAYERS)()
_c_b_ms = (ctypes.c_longlong * MAX_LAYERS)()


def _kernel_fn():
    """The C entry point, built and bound on first use."""
    global _kernel
    if _kernel is None:
        fn = _build.load("fused_mlp").mmtpu_fused_mlp_forward
        fn.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 3
        )
        fn.restype = ctypes.c_int
        _kernel = fn
    return _kernel


def _member_stride(t: torch.Tensor, members: int) -> int:
    """Floats between two members of `t` (K, ...): 0 when they share one
    tensor (an expanded one, or K = 1)."""
    if t.shape[0] != members:
        raise ValueError(f"fused_mlp: {members} members, got a tensor of {tuple(t.shape)}")
    return 0 if members == 1 else t.stride(0)


_NO_STRIDES = (0,) * MAX_LAYERS


def _run(x, weights, biases, members: int = 1, x_ms: int = 0,
         w_ms=_NO_STRIDES, b_ms=_NO_STRIDES) -> torch.Tensor:
    """One launch over `members` chains. x, weights and biases are member
    0's (B, d0), (out, in) and (out,); member m's lie m·stride floats after
    them. Returns (members, B, dn), or (B, dn) for one member."""
    dims = _check(x, weights, biases)
    index, num_sms = _build.sm90_device(x.device, "fused_mlp")
    batch, n = x.shape[0], len(weights)
    shape = (members, batch, dims[-1]) if members > 1 else (batch, dims[-1])
    out = torch.empty(shape, device=x.device, dtype=x.dtype)
    if batch == 0:
        return out
    # each member's chain gets its share of the SMs
    plan = chain_plan(batch, dims, max(num_sms // members, 1))
    fn = _kernel or _kernel_fn()
    with _launch_lock, _build.on_device(index):
        bulk_mask = 0
        for i in range(n):
            _c_dims[i] = dims[i]
            _c_w[i] = weights[i].data_ptr()
            _c_b[i] = biases[i].data_ptr()
            _c_w_ms[i] = w_ms[i]
            _c_b_ms[i] = b_ms[i]
            bulk_mask |= (bulk_copy_ok(weights[i]) and w_ms[i] % 4 == 0) << i
        _c_dims[n] = dims[n]
        rc = fn(x.data_ptr(), out.data_ptr(), batch, n, _c_dims, _c_w, _c_b,
                plan.rows, plan.grid, plan.act_stride, bulk_mask, plan.resident,
                plan.smem_bytes, members, x_ms, batch * dims[-1], _c_w_ms, _c_b_ms,
                _build.current_stream(index))
        if rc == 0:
            fused_mlp.launches += 1
    if rc != 0:
        raise RuntimeError(
            f"fused_mlp: kernel launch failed with CUDA error {rc} "
            f"(members {members}, batch {batch}, dims {dims}, {plan}, bulk mask {bulk_mask:#x})"
        )
    return out


def _launch(x, weights, biases) -> torch.Tensor:
    """One launch of one chain: x (B, d0) → (B, dn)."""
    return _run(x, weights, biases)


def _launch_members(x, weights, biases) -> torch.Tensor:
    """One launch of K chains, the member axis leading every tensor: x
    (K, B, d0), weights (K, out, in), biases (K, out) → (K, B, dn). A
    member axis of stride 0 (an expanded tensor) shares that tensor; each
    member must be contiguous."""
    k = x.shape[0]
    out = _run(x[0], [w[0] for w in weights], [b[0] for b in biases], k,
               _member_stride(x, k), [_member_stride(w, k) for w in weights],
               [_member_stride(b, k) for b in biases])
    return out if k > 1 else out[None]


def fused_mlp_members(x, weights, biases) -> torch.Tensor:
    """K chains with the member axis leading: the kernel's member launch on
    CUDA, the plain batched chain on the CPU."""
    if x.device.type == "cuda":
        return _launch_members(x, weights, biases)
    return fused_mlp_members_reference(x, weights, biases)


def fused_mlp_members_reference(x, weights, biases):
    """The plain chain with a leading member axis: x (K, B, d0), weights
    (K, out, in), biases (K, out); member k's chain on its own slices."""
    h = x
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = torch.baddbmm(b.unsqueeze(1), h, w.transpose(1, 2))
        if i < len(weights) - 1:
            h = torch.relu(h)
    return h


def fold_members(members: int, in_dims, tensors):
    """Each tensor with its vmapped axis moved to the front, (K, ...): an
    axis of None (a tensor shared by every member) expands without a copy;
    a batched one is made contiguous."""
    out = []
    for t, d in zip(tensors, in_dims):
        if d is None:
            out.append(t.expand(members, *t.shape))
        else:
            out.append(t.movedim(d, 0).contiguous())
    return out


def recompute_grads(x, weights, biases, g):
    """(dx, dWs, dbs) of the chain for output cotangent g, recomputing the
    activations in plain PyTorch (mmtpu's `_bwd`, with (out, in) weights).
    The chain runs on the last two axes, so every tensor may carry a leading
    member axis: x (K, B, d0), weights (K, out, in), biases (K, out)."""
    n = len(weights)
    acts = [x]
    h = x
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = h @ w.transpose(-1, -2) + b.unsqueeze(-2)
        if i < n - 1:
            h = torch.relu(h)
        acts.append(h)
    dx = g
    dws, dbs = [None] * n, [None] * n
    for i in reversed(range(n)):
        if i < n - 1:  # through the ReLU (not after the last layer)
            dx = dx * (acts[i + 1] > 0)
        dws[i] = dx.transpose(-1, -2) @ acts[i]
        dbs[i] = dx.sum(dim=-2)
        dx = dx @ weights[i]
    return dx, dws, dbs


class _FusedMLP(torch.autograd.Function):
    """Kernel forward (the plain chain on the CPU); backward is the plain
    recompute (`recompute_grads`). An x of three axes carries a leading
    member axis (x (K, B, d0), weights (K, out, in), biases (K, out)): K
    chains in ONE member-axis launch, which is what `torch.func.vmap` folds
    the members into."""

    @staticmethod
    def forward(x, n_layers: int, *params):
        weights, biases = params[:n_layers], params[n_layers:]
        if x.dim() == 3:
            return fused_mlp_members(x, weights, biases)
        if x.device.type == "cuda":
            return _launch(x, weights, biases)
        return fused_mlp_reference(x, weights, biases)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, n_layers, *params = inputs
        ctx.n_layers = n_layers
        ctx.save_for_backward(x, *params)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        n = ctx.n_layers
        dx, dws, dbs = recompute_grads(x, params[:n], params[n:], g)
        return (dx, None, *dws, *dbs)

    @staticmethod
    def vmap(info, in_dims, x, n_layers: int, *params):
        x_dim, _, *p_dims = in_dims
        folded = fold_members(info.batch_size, [x_dim, *p_dims], [x, *params])
        return _FusedMLP.apply(folded[0], n_layers, *folded[1:]), 0


def fused_mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
              biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """ReLU-MLP chain; weights (out, in) and biases (out,) per layer.

    A call that needs no gradient goes through the operator
    `mmtpu::fused_mlp` (`ops/library.py`) on either device, so a traced
    graph holds it: on CUDA it launches the kernel (counted in
    `fused_mlp.launches`) or raises, on the CPU it is the plain chain. An
    eager call on CUDA launches the same kernel without the dispatcher
    (`_build.direct_launch`). A call that needs a gradient takes the plain
    chain on the CPU and `_FusedMLP` (the kernel, then the plain recompute)
    on CUDA. Under a `torch.func` transform (`vmap` over stacked members,
    `grad`) every call takes the operator or `_FusedMLP`, on either device,
    whose vmap rules fold the members into one member-axis launch (the
    plain batched chain on the CPU)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mlp: no kernel for device {x.device}")
    transformed = _build.transformed(x, *weights, *biases)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *weights, *biases)
    ):
        if x.device.type == "cpu" and not transformed:
            return fused_mlp_reference(x, weights, biases)
        return _FusedMLP.apply(x, len(weights), *weights, *biases)
    if _build.direct_launch(x.device) and not transformed:
        return _launch(x, weights, biases)
    return torch.ops.mmtpu.fused_mlp(x, list(weights), list(biases))


fused_mlp.launches = 0
