"""Fused ReLU-MLP chain: relu(x·W1ᵀ + b1) ... ·Wnᵀ + bn in ONE CUDA kernel.

Counterpart of `mmtpu/ops/fused_mlp.py`; the kernel
(`csrc/fused_mlp.cu`) replaces the TPU kernel
`mmtpu/ops/fused_mlp.py::_pallas_forward`. It computes the same function:
all layers in one launch, activations kept in shared memory, fp32
accumulation, output in `x.dtype`. What bounds it on the H100 and what its
design does about that is noted at the top of the CUDA source.

Layouts: weights are given as nn.Linear stores them, (out, in), and the
kernel reads them as they lie (mmtpu's `fused_mlp` takes (in, out)).

Dispatch, by where `x` lies:
- CPU tensor → `fused_mlp_reference`, the plain PyTorch chain;
- CUDA tensor → the kernel, or an error. There is no fallback: a CUDA input
  the kernel does not take (dtype, layout, an architecture other than
  sm_90, a width too wide for shared memory) raises.

Only the forward is a kernel, as in mmtpu. Its backward (`_FusedMLP`) is
the plain recompute of mmtpu's `_bwd`, so differentiating through the
kernel gives the right gradient.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import torch

MAX_LAYERS = 8
ROWS_PER_THREAD = 4  # MMTPU_MLP_ROWS_PER_THREAD in csrc/fused_mlp.cu
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on sm_90 (227 KB)


def fused_mlp_reference(x, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]):
    """The plain chain: h = h·Wᵀ + b, ReLU between layers, not after the last."""
    h = x
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = torch.addmm(b, h, w.t())
        if i < len(weights) - 1:
            h = torch.relu(h)
    return h


def tile_rows(batch: int, dims: Sequence[int], num_sms: int) -> Tuple[int, int]:
    """(block_rows, shared-memory bytes) for one launch.

    Rows per block are chosen so the grid has about one block per SM (small
    tiles for small batches, so every SM gets work), a multiple of
    ROWS_PER_THREAD, and capped so both activation buffers,
    2 · block_rows · max_dim · 4 B, fit the 227 KB a block may use."""
    max_dim = max(dims[:-1])
    bytes_per_row = 2 * max_dim * 4
    cap = (SMEM_LIMIT // bytes_per_row) // ROWS_PER_THREAD * ROWS_PER_THREAD
    if cap < ROWS_PER_THREAD:
        raise ValueError(
            f"fused_mlp: width {max_dim} does not fit shared memory "
            f"({ROWS_PER_THREAD} rows need {ROWS_PER_THREAD * bytes_per_row} B "
            f"of {SMEM_LIMIT} B)"
        )
    want = -(-batch // max(num_sms, 1))
    rows = -(-want // ROWS_PER_THREAD) * ROWS_PER_THREAD
    rows = min(max(rows, ROWS_PER_THREAD), cap)
    return rows, rows * bytes_per_row


def _check(x, weights, biases) -> list:
    if not (1 <= len(weights) <= MAX_LAYERS) or len(weights) != len(biases):
        raise ValueError(
            f"fused_mlp: need 1..{MAX_LAYERS} layers and one bias per weight, "
            f"got {len(weights)} weights and {len(biases)} biases"
        )
    if x.dim() != 2:
        raise ValueError(f"fused_mlp: x must be (B, D0), got {tuple(x.shape)}")
    dims = [x.shape[1]]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.dim() != 2 or w.shape[1] != dims[-1]:
            raise ValueError(
                f"fused_mlp: layer {i} weight {tuple(w.shape)} is not (out, {dims[-1]})"
            )
        if tuple(b.shape) != (w.shape[0],):
            raise ValueError(f"fused_mlp: layer {i} bias {tuple(b.shape)} != ({w.shape[0]},)")
        dims.append(w.shape[0])
    for t in (x, *weights, *biases):
        if t.device != x.device:
            raise ValueError("fused_mlp: all tensors must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_mlp: the CUDA kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fused_mlp: the CUDA kernel takes contiguous tensors")
    return dims


_launch_lock = threading.Lock()
_kernel = None


def _kernel_fn():
    """The C entry point, built and bound on first use."""
    global _kernel
    if _kernel is None:
        from mmtpu_torch.ops import _build

        fn = _build.load("fused_mlp").mmtpu_fused_mlp_forward
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _kernel = fn
    return _kernel


def _launch(x, weights, biases) -> torch.Tensor:
    dims = _check(x, weights, biases)
    props = torch.cuda.get_device_properties(x.device)
    if (props.major, props.minor) != (9, 0):
        raise RuntimeError(
            f"fused_mlp: the kernel is built for sm_90a, device is "
            f"sm_{props.major}{props.minor} ({props.name})"
        )
    batch = x.shape[0]
    out = torch.empty((batch, dims[-1]), device=x.device, dtype=x.dtype)
    if batch == 0:
        return out
    block_rows, smem = tile_rows(batch, dims, props.multi_processor_count)
    fn = _kernel_fn()
    n = len(weights)
    c_dims = (ctypes.c_int * (n + 1))(*dims)
    c_w = (ctypes.c_void_p * n)(*[w.data_ptr() for w in weights])
    c_b = (ctypes.c_void_p * n)(*[b.data_ptr() for b in biases])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), batch, n, c_dims, c_w, c_b,
                block_rows, smem, stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_mlp: kernel launch failed with CUDA error {rc} "
            f"(batch {batch}, dims {dims}, block_rows {block_rows}, smem {smem} B)"
        )
    with _launch_lock:
        fused_mlp.launches += 1
    return out


def recompute_grads(x, weights, biases, g):
    """(dx, dWs, dbs) of the chain for output cotangent g, recomputing the
    activations in plain PyTorch (mmtpu's `_bwd`, with (out, in) weights)."""
    n = len(weights)
    acts = [x]
    h = x
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = torch.addmm(b, h, w.t())
        if i < n - 1:
            h = torch.relu(h)
        acts.append(h)
    dx = g
    dws, dbs = [None] * n, [None] * n
    for i in reversed(range(n)):
        if i < n - 1:  # through the ReLU (not after the last layer)
            dx = dx * (acts[i + 1] > 0)
        dws[i] = dx.t() @ acts[i]
        dbs[i] = dx.sum(dim=0)
        dx = dx @ weights[i]
    return dx, dws, dbs


class _FusedMLP(torch.autograd.Function):
    """Kernel forward; backward is the plain recompute (`recompute_grads`)."""

    @staticmethod
    def forward(ctx, x, n_layers: int, *params):
        weights, biases = params[:n_layers], params[n_layers:]
        ctx.n_layers = n_layers
        ctx.save_for_backward(x, *params)
        return _launch(x, weights, biases)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        n = ctx.n_layers
        dx, dws, dbs = recompute_grads(x, params[:n], params[n:], g)
        return (dx, None, *dws, *dbs)


def fused_mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
              biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """ReLU-MLP chain; weights (out, in) and biases (out,) per layer.

    CPU tensors take the plain chain; CUDA tensors launch the kernel (and
    count the launch in `fused_mlp.launches`) or raise."""
    if x.device.type == "cpu":
        return fused_mlp_reference(x, weights, biases)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *weights, *biases)
    ):
        return _FusedMLP.apply(x, len(weights), *weights, *biases)
    return _launch(x, weights, biases)


fused_mlp.launches = 0
