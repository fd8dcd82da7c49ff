"""Full-sequence LSTM recurrence: G independent LSTMs, each over its whole
sequence, in ONE CUDA kernel with h and c kept on chip.

Counterpart of `mmtpu/ops/lstm.py`; the kernel (`csrc/lstm.cu`) replaces the
TPU kernel `mmtpu/ops/lstm.py::_pallas_lstm`. It computes the same function
per group — `pre = xw[:, t] + h·wh`, gates `[i, f, g, o]` = σ, σ, tanh, σ,
`c' = f·c + i·g`, `h' = o·tanh(c')`, rows with `t ≥ len` keep h and c — and
takes a leading group dimension, so that `lstm_sequence` is its G = 1 call
and `lstm_sequence_stacked` its G ≥ 1 call. (mmtpu runs the stacked form as
a plain XLA scan and chooses between kernel and scan by shape; both rules
answer the TPU. Here every CUDA call launches the one kernel.) What bounds
it on the H100 and what its design does about that is noted at the top of
the CUDA source.

The input projection `x·Wi + b` is the caller's (`nn.Linear`), as in mmtpu.

Groups are passed without stacking: `xw` and `wh` may each be one tensor
with a leading G, or a sequence of G per-group tensors, whose base pointers
go to the kernel as they are — the two encoders' projections are never
copied into one buffer.

Dispatch, by where `xw` lies:
- CPU tensors → `lstm_stacked_reference`, the plain PyTorch scan;
- CUDA tensors → the kernel, or an error. There is no fallback: a CUDA input
  the kernel does not take raises (dtype other than float32, a
  non-contiguous tensor, tensors on different devices, an architecture other
  than sm_90, more than MAX_GROUPS groups, or a hidden size whose state for
  one batch row, about 12·H bytes, exceeds the 227 KB of shared memory a
  block may use).

Only the forward is a kernel, as in mmtpu. Its backward (`_LSTM`) recomputes
through the plain scan (`lstm_recompute_grads`, mmtpu's `_bwd`), so
differentiating through the kernel gives the plain scan's gradient.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

MAX_GROUPS = 8  # MMTPU_LSTM_MAX_GROUPS in csrc/lstm.cu
MAX_THREADS = 1024
KREG_THREADS = 512  # most threads of a block that holds rows of wh in registers
ROW_TILES = (1, 2, 4, 8)  # batch rows per block the kernel is built for
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on sm_90 (227 KB)

Grouped = Union[torch.Tensor, Sequence[torch.Tensor]]


def _groups(t: Grouped) -> list:
    """Per-group views of a (G, ...) tensor, or the given sequence."""
    return list(t.unbind(0)) if isinstance(t, torch.Tensor) else list(t)


def lstm_stacked_reference(xw: Grouped, wh: Grouped, h0, c0, lengths=None):
    """The plain scan over G groups (mirror of mmtpu's `_xla_lstm` and
    `lstm_sequence_stacked`): returns (outputs (G, B, T, H), (h, c))."""
    xw = xw if isinstance(xw, torch.Tensor) else torch.stack(list(xw))
    wh = wh if isinstance(wh, torch.Tensor) else torch.stack(list(wh))
    G, B, T, H4 = xw.shape
    H = H4 // 4
    h, c = h0, c0
    outs = []
    for t in range(T):
        pre = torch.baddbmm(xw[:, :, t], h, wh)
        i = torch.sigmoid(pre[..., :H])
        f = torch.sigmoid(pre[..., H:2 * H])
        g = torch.tanh(pre[..., 2 * H:3 * H])
        o = torch.sigmoid(pre[..., 3 * H:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        if lengths is not None:
            keep = (t < lengths).unsqueeze(-1)
            h_new = torch.where(keep, h_new, h)
            c_new = torch.where(keep, c_new, c)
        h, c = h_new, c_new
        outs.append(h)
    out = torch.stack(outs, dim=2) if outs else xw.new_empty((G, B, 0, H))
    return out, (h, c)


def lstm_reference(xw, wh, h0, c0, lengths=None):
    """The plain scan for one LSTM: xw (B, T, 4H), wh (H, 4H), h0/c0 (B, H),
    lengths (B,) or None → (outputs (B, T, H), (h, c))."""
    out, (h, c) = lstm_stacked_reference(
        xw[None], wh[None], h0[None], c0[None],
        None if lengths is None else lengths[None],
    )
    return out[0], (h[0], c[0])


class LaunchPlan(NamedTuple):
    """How one launch is laid out (see the top of csrc/lstm.cu)."""

    rows: int      # batch rows per block
    kreg: int      # rows of wh held in each thread's registers (0, 32 or 64)
    stage_k: int   # the next rows of wh, staged in shared memory
    h_stride: int  # floats between rows of h in shared memory
    threads: int   # threads per block

    def smem_bytes(self, hidden: int) -> int:
        return smem_bytes(self.rows, hidden, self.h_stride, self.stage_k)


def smem_bytes(rows: int, hidden: int, h_stride: int, stage_k: int) -> int:
    """Shared memory of one block: h twice (rows·h_stride each), c (rows·H),
    `stage_k` staged rows of wh (4H each), lengths (rows ints)."""
    return 4 * (2 * rows * h_stride + rows * hidden + 4 * stage_k * hidden + rows)


def launch_plan(groups: int, batch: int, hidden: int, num_sms: int) -> LaunchPlan:
    """The layout of a launch over (groups, batch) rows of hidden size H.

    Threads: one per gate column, up to MAX_THREADS (a loop over columns
    beyond). Register rows of wh: 32 or 64 when a thread owns one column and
    the block has at most KREG_THREADS threads (H ≤ 128), else none. Rows per
    block: the smallest tile that gives at most one block per SM, so a small
    batch spreads over many SMs and each block's serial step stays short;
    halved while the block's state does not fit. As many of the remaining
    rows of wh as fit beside the state are staged in shared memory (all of
    them up to H = 128); the rest is read through L1/L2 every step."""
    threads = min(-(-4 * hidden // 32) * 32, MAX_THREADS)
    kreg = 0
    if 4 * hidden <= threads <= KREG_THREADS:
        kreg = 32 if hidden <= 32 else 64
    h_stride = max(-(-hidden // 4) * 4, kreg)
    rows = next(
        (r for r in ROW_TILES if groups * -(-batch // r) <= num_sms), ROW_TILES[-1]
    )
    while rows > 1 and smem_bytes(rows, hidden, h_stride, 0) > SMEM_LIMIT:
        rows //= 2
    state = smem_bytes(rows, hidden, h_stride, 0)
    if state > SMEM_LIMIT:
        raise ValueError(
            f"lstm: hidden size {hidden} does not fit shared memory (one batch "
            f"row needs {state} B of {SMEM_LIMIT} B)"
        )
    stage_k = min(max(hidden - kreg, 0), (SMEM_LIMIT - state) // (16 * hidden))
    return LaunchPlan(rows, kreg, stage_k, h_stride, threads)


def _check(xws, whs, h0, c0, lengths) -> Tuple[int, int, int, int]:
    """Shapes, dtypes, devices and layouts the kernel takes → (G, B, T, H)."""
    G = len(xws)
    if not 1 <= G <= MAX_GROUPS or len(whs) != G:
        raise ValueError(
            f"lstm: need 1..{MAX_GROUPS} groups and one wh per xw, got "
            f"{G} xw and {len(whs)} wh"
        )
    if xws[0].dim() != 3 or xws[0].shape[2] % 4:
        raise ValueError(f"lstm: xw must be (B, T, 4H) per group, got {tuple(xws[0].shape)}")
    B, T, H4 = xws[0].shape
    H = H4 // 4
    for g, (xw, wh) in enumerate(zip(xws, whs)):
        if tuple(xw.shape) != (B, T, H4):
            raise ValueError(f"lstm: group {g} xw {tuple(xw.shape)} != {(B, T, H4)}")
        if tuple(wh.shape) != (H, H4):
            raise ValueError(f"lstm: group {g} wh {tuple(wh.shape)} != {(H, H4)}")
    for name, s in (("h0", h0), ("c0", c0)):
        if tuple(s.shape) != (G, B, H):
            raise ValueError(f"lstm: {name} {tuple(s.shape)} != {(G, B, H)}")
    dev = xws[0].device
    for t in (*xws, *whs, h0, c0):
        if t.device != dev:
            raise ValueError("lstm: all tensors must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"lstm: the CUDA kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("lstm: the CUDA kernel takes contiguous tensors")
    if lengths is not None:
        if tuple(lengths.shape) != (G, B):
            raise ValueError(f"lstm: lengths {tuple(lengths.shape)} != {(G, B)}")
        if lengths.dtype != torch.int32:
            raise TypeError(f"lstm: lengths must be int32, got {lengths.dtype}")
        if lengths.device != dev or not lengths.is_contiguous():
            raise ValueError("lstm: lengths must be contiguous and on the inputs' device")
    return G, B, T, H


_launch_lock = threading.Lock()
_kernel = None


def _kernel_fn():
    """The C entry point, built and bound on first use."""
    global _kernel
    if _kernel is None:
        from mmtpu_torch.ops import _build

        fn = _build.load("lstm").mmtpu_lstm_forward
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel = fn
    return _kernel


def _launch(xws, whs, h0, c0, lengths):
    """One kernel launch over all groups → (out (G, B, T, H), hT, cT)."""
    G, B, T, H = _check(xws, whs, h0, c0, lengths)
    dev = h0.device
    props = torch.cuda.get_device_properties(dev)
    if (props.major, props.minor) != (9, 0):
        raise RuntimeError(
            f"lstm: the kernel is built for sm_90a, device is "
            f"sm_{props.major}{props.minor} ({props.name})"
        )
    out = torch.empty((G, B, T, H), device=dev, dtype=torch.float32)
    if B == 0 or T == 0:  # nothing to advance: the state is the initial one
        return out, h0.clone(), c0.clone()
    hT = torch.empty_like(h0)
    cT = torch.empty_like(c0)
    plan = launch_plan(G, B, H, props.multi_processor_count)
    fn = _kernel_fn()
    c_xw = (ctypes.c_void_p * G)(*[t.data_ptr() for t in xws])
    c_wh = (ctypes.c_void_p * G)(*[t.data_ptr() for t in whs])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(c_xw, c_wh, h0.data_ptr(), c0.data_ptr(),
                None if lengths is None else lengths.data_ptr(),
                out.data_ptr(), hT.data_ptr(), cT.data_ptr(),
                G, B, T, H, *plan, stream)
    if rc != 0:
        raise RuntimeError(
            f"lstm: kernel launch failed with CUDA error {rc} (G={G}, B={B}, T={T}, "
            f"H={H}, {plan}, smem {plan.smem_bytes(H)} B)"
        )
    with _launch_lock:
        lstm_sequence_stacked.launches += 1
    return out, hT, cT


def lstm_recompute_grads(xw, wh, h0, c0, lengths, g_out, g_h, g_c):
    """(dxw, dwh, dh0, dc0) of one LSTM for the cotangents of (outputs, h, c),
    differentiating the plain scan on the saved inputs (mmtpu's `_bwd`)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (xw, wh, h0, c0)]
        out, (h, c) = lstm_reference(*ins, lengths)
        grads = torch.autograd.grad(
            (out, h, c), ins, (g_out, g_h, g_c), allow_unused=True
        )
    return tuple(torch.zeros_like(t) if g is None else g for g, t in zip(grads, ins))


class _LSTM(torch.autograd.Function):
    """Kernel forward; backward is the plain recompute, group by group."""

    @staticmethod
    def forward(ctx, groups: int, lengths, h0, c0, *xw_wh):
        ctx.groups = groups
        ctx.lengths = lengths
        ctx.save_for_backward(h0, c0, *xw_wh)
        return _launch(xw_wh[:groups], xw_wh[groups:], h0, c0, lengths)

    @staticmethod
    def backward(ctx, g_out, g_h, g_c):
        h0, c0, *xw_wh = ctx.saved_tensors
        G = ctx.groups
        per_group = [
            lstm_recompute_grads(
                xw_wh[g], xw_wh[G + g], h0[g], c0[g],
                None if ctx.lengths is None else ctx.lengths[g],
                g_out[g], g_h[g], g_c[g],
            )
            for g in range(G)
        ]
        dxw, dwh, dh0, dc0 = zip(*per_group)
        return (None, None, torch.stack(dh0), torch.stack(dc0), *dxw, *dwh)


def lstm_sequence_stacked(
    xw: Grouped, wh: Grouped, h0: torch.Tensor, c0: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
):
    """G independent LSTMs advanced together.

    xw: (G, B, T, 4H) pre-projected inputs, or G tensors (B, T, 4H); wh:
    (G, H, 4H), or G tensors (H, 4H); h0/c0: (G, B, H); lengths: optional
    (G, B) int32. Returns (outputs (G, B, T, H), (h, c)).

    CPU tensors take the plain scan; CUDA tensors launch the kernel once for
    all groups (counted in `lstm_sequence_stacked.launches`) or raise."""
    if h0.device.type == "cpu":
        return lstm_stacked_reference(xw, wh, h0, c0, lengths)
    if h0.device.type != "cuda":
        raise ValueError(f"lstm: no kernel for device {h0.device}")
    xws, whs = _groups(xw), _groups(wh)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*xws, *whs, h0, c0)):
        out, h, c = _LSTM.apply(len(xws), lengths, h0, c0, *xws, *whs)
    else:
        out, h, c = _launch(xws, whs, h0, c0, lengths)
    return out, (h, c)


lstm_sequence_stacked.launches = 0


def lstm_sequence(
    xw: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
):
    """One LSTM: xw (B, T, 4H) pre-projected inputs, wh (H, 4H), h0/c0 (B, H),
    lengths optional (B,) int32. Returns (outputs (B, T, H), (h, c)).

    The G = 1 call of `lstm_sequence_stacked` (views, no copy): the same
    kernel, counted in the same `launches`."""
    out, (h, c) = lstm_sequence_stacked(
        [xw], [wh], h0[None], c0[None], None if lengths is None else lengths[None]
    )
    return out[0], (h[0], c[0])
