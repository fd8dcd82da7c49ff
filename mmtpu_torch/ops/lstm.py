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

`h0` and `c0` may be None for a zero state: the kernel then reads no state
at all, and the caller allocates and zero-fills none.

Dispatch, by where `xw` lies (through the operator `mmtpu::lstm` of
`ops/library.py` when no gradient is needed):
- CPU tensors → `lstm_stacked_reference`, the plain PyTorch scan;
- CUDA tensors → the kernel, or an error. There is no fallback: a CUDA input
  the kernel does not take raises (dtype other than float32, a
  non-contiguous tensor, tensors on different devices, an architecture other
  than sm_90, or a hidden size whose state for one batch row, about 12·H
  bytes, exceeds the 227 KB of shared memory a block may use). A call of
  more than MAX_GROUPS groups (the pointer tables are kernel parameters)
  launches once per MAX_GROUPS groups, each launch counted.

Member axis (mmtpu's stacked engine vmaps the recurrence over members):
under `torch.func.vmap` the K members fold into the group axis, one call
of K·G groups, member k's group g at k·G + g; its `xw` and `wh` are the
contiguous slices of the batched tensors, handed over by pointer without a
copy (`fold_groups`).

A launch costs the host little beside the launch itself: the device's
properties are read once, the plan is cached by (G, B, H, SMs), the pointer
tables are preallocated, and the device is switched only when it is not the
current one.

Only the forward is a kernel, as in mmtpu. Its backward (`_LSTM`) recomputes
through the plain scan (`lstm_recompute_stacked_grads`, mmtpu's `_bwd` for
all groups at once), so differentiating through the kernel gives the plain
scan's gradient.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from mmtpu_torch.ops import _build

MAX_GROUPS = 64  # groups of one launch: MMTPU_LSTM_MAX_GROUPS in csrc/lstm.cu
MAX_THREADS = 1024
KREG_THREADS = 512  # most threads of a block that holds rows of wh in registers
ROW_TILES = (1, 2, 4, 8)  # batch rows per block the kernel is built for
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on sm_90 (227 KB)

Grouped = Union[torch.Tensor, Sequence[torch.Tensor]]


def _groups(t: Grouped) -> list:
    """Per-group views of a (G, ...) tensor, or the given sequence."""
    return list(t.unbind(0)) if isinstance(t, torch.Tensor) else list(t)


def lstm_stacked_reference(xw: Grouped, wh: Grouped, h0=None, c0=None, lengths=None):
    """The plain scan over G groups (mirror of mmtpu's `_xla_lstm` and
    `lstm_sequence_stacked`): returns (outputs (G, B, T, H), (h, c)). A state
    given as None is zeros."""
    xw = xw if isinstance(xw, torch.Tensor) else torch.stack(list(xw))
    wh = wh if isinstance(wh, torch.Tensor) else torch.stack(list(wh))
    G, B, T, H4 = xw.shape
    H = H4 // 4
    h = xw.new_zeros((G, B, H)) if h0 is None else h0
    c = xw.new_zeros((G, B, H)) if c0 is None else c0
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


def _lead(t):
    """`t` with a leading group axis of one; None stays None."""
    return None if t is None else t[None]


def lstm_reference(xw, wh, h0=None, c0=None, lengths=None):
    """The plain scan for one LSTM: xw (B, T, 4H), wh (H, 4H), h0/c0 (B, H) or
    None for zeros, lengths (B,) or None → (outputs (B, T, H), (h, c))."""
    out, (h, c) = lstm_stacked_reference(
        xw[None], wh[None], _lead(h0), _lead(c0), _lead(lengths)
    )
    return out[0], (h[0], c[0])


class LaunchPlan(NamedTuple):
    """How one launch is laid out (see the top of csrc/lstm.cu)."""

    rows: int      # batch rows per block
    kreg: int      # rows of wh held in the quads' registers (0, 32 or 64)
    stage_k: int   # the next rows of wh, staged in shared memory
    h_stride: int  # floats between rows of h in shared memory
    threads: int   # threads per block

    def smem_bytes(self, hidden: int) -> int:
        return smem_bytes(self.rows, hidden, self.h_stride, self.stage_k)


def smem_bytes(rows: int, hidden: int, h_stride: int, stage_k: int) -> int:
    """Shared memory of one block: h twice (rows·h_stride each), c (rows·H),
    `stage_k` staged rows of wh (4H each), lengths (rows ints)."""
    return 4 * (2 * rows * h_stride + rows * hidden + 4 * stage_k * hidden + rows)


@functools.lru_cache(maxsize=256)
def launch_plan(groups: int, batch: int, hidden: int, num_sms: int) -> LaunchPlan:
    """The layout of a launch over (groups, batch) rows of hidden size H;
    computed once per (groups, batch, hidden, num_sms) and kept.

    Threads: four per hidden unit (a quad), up to MAX_THREADS (a loop over
    columns beyond); at 32 < H ≤ 64 with one or two rows per block a quad
    serves two units, so half as many. Register rows of wh: the first 32 or
    64, split over the quad's four lanes, when every unit has its quad and
    the block has at most KREG_THREADS threads (H ≤ 128), else none. Rows
    per block: the smallest tile that gives at most one block per SM, so a
    small batch spreads over many SMs and each block's serial step stays
    short; halved while the block's state does not fit. As many of the
    remaining rows of wh as fit beside the state are staged in shared memory
    (all of them up to H = 128); the rest is read through L1/L2 every step."""
    threads = min(-(-4 * hidden // 32) * 32, MAX_THREADS)
    kreg = 0
    if 4 * hidden <= threads <= KREG_THREADS:
        kreg = 32 if hidden <= 32 else 64
    h_stride = max(-(-hidden // 4) * 4, kreg)
    rows = next(
        (r for r in ROW_TILES if groups * -(-batch // r) <= num_sms), ROW_TILES[-1]
    )
    if 32 < hidden <= 64 and rows <= 2:  # two units per quad: half the warps
        threads = -(-4 * -(-hidden // 2) // 32) * 32
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


def _check(xws, whs, h0, c0, lengths, max_groups: Optional[int] = MAX_GROUPS
           ) -> Tuple[int, int, int, int]:
    """Shapes, dtypes, devices and layouts the kernel takes → (G, B, T, H).
    `h0` and `c0` may each be None (zeros). `max_groups`: the most groups of
    one launch, None for a call that launches as often as it must."""
    G = len(xws)
    if not 1 <= G <= (max_groups or G) or len(whs) != G:
        raise ValueError(
            f"lstm: need 1..{MAX_GROUPS} groups and one wh per xw, got "
            f"{G} xw and {len(whs)} wh"
        )
    first = xws[0]
    if first.dim() != 3 or first.shape[2] % 4:
        raise ValueError(f"lstm: xw must be (B, T, 4H) per group, got {tuple(first.shape)}")
    B, T, H4 = xw_shape = first.shape
    H = H4 // 4
    wh_shape, state_shape = (H, H4), (G, B, H)
    dev, f32 = first.device, torch.float32
    for g in range(G):
        xw, wh = xws[g], whs[g]
        if xw.shape != xw_shape:
            raise ValueError(f"lstm: group {g} xw {tuple(xw.shape)} != {(B, T, H4)}")
        if wh.shape != wh_shape:
            raise ValueError(f"lstm: group {g} wh {tuple(wh.shape)} != {wh_shape}")
    for name, t in (("h0", h0), ("c0", c0)):
        if t is not None and t.shape != state_shape:
            raise ValueError(f"lstm: {name} {tuple(t.shape)} != {state_shape}")
    for t in (*xws, *whs, h0, c0):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError("lstm: all tensors must be on one device")
        if t.dtype is not f32:
            raise TypeError(f"lstm: the CUDA kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("lstm: the CUDA kernel takes contiguous tensors")
    if lengths is not None:
        if lengths.shape != (G, B):
            raise ValueError(f"lstm: lengths {tuple(lengths.shape)} != {(G, B)}")
        if lengths.dtype is not torch.int32:
            raise TypeError(f"lstm: lengths must be int32, got {lengths.dtype}")
        if lengths.device != dev or not lengths.is_contiguous():
            raise ValueError("lstm: lengths must be contiguous and on the inputs' device")
    return G, B, T, H


_launch_lock = threading.Lock()
_kernel = None
# the two pointer tables a launch hands over, written anew under _launch_lock
_c_xw = (ctypes.c_void_p * MAX_GROUPS)()
_c_wh = (ctypes.c_void_p * MAX_GROUPS)()


def _kernel_fn():
    """The C entry point, built and bound on first use."""
    global _kernel
    if _kernel is None:
        fn = _build.load("lstm").mmtpu_lstm_forward
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel = fn
    return _kernel


def _at(t: Optional[torch.Tensor], offset: int):
    """The address `offset` 4-byte elements into `t`; None stays None."""
    return None if t is None else t.data_ptr() + 4 * offset


def _launch(xws, whs, h0, c0, lengths):
    """The kernel over all groups → (out (G, B, T, H), hT, cT): one launch,
    or one per MAX_GROUPS groups beyond that."""
    G, B, T, H = _check(xws, whs, h0, c0, lengths, max_groups=None)
    dev = xws[0].device
    index, num_sms = _build.sm90_device(dev, "lstm")
    out = torch.empty((G, B, T, H), device=dev, dtype=torch.float32)
    hT = torch.empty((G, B, H), device=dev, dtype=torch.float32)
    cT = torch.empty((G, B, H), device=dev, dtype=torch.float32)
    if B == 0 or T == 0:  # nothing to advance: the state is the initial one
        for dst, src in ((hT, h0), (cT, c0)):
            if src is None:
                dst.zero_()
            else:
                dst.copy_(src)
        return out, hT, cT
    fn = _kernel or _kernel_fn()
    for g0 in range(0, G, MAX_GROUPS):
        n = min(MAX_GROUPS, G - g0)
        plan = launch_plan(n, B, H, num_sms)
        state = g0 * B * H
        with _launch_lock, _build.on_device(index):
            for g in range(n):
                _c_xw[g] = xws[g0 + g].data_ptr()
                _c_wh[g] = whs[g0 + g].data_ptr()
            rc = fn(_c_xw, _c_wh, _at(h0, state), _at(c0, state), _at(lengths, g0 * B),
                    _at(out, state * T), _at(hT, state), _at(cT, state),
                    n, B, T, H, *plan, _build.current_stream(index))
            if rc == 0:
                lstm_sequence_stacked.launches += 1
        if rc != 0:
            raise RuntimeError(
                f"lstm: kernel launch failed with CUDA error {rc} (G={n} of {G}, B={B}, "
                f"T={T}, H={H}, {plan}, smem {plan.smem_bytes(H)} B)"
            )
    return out, hT, cT


def lstm_recompute_grads(xw, wh, h0, c0, lengths, g_out, g_h, g_c):
    """(dxw, dwh, dh0, dc0) of one LSTM for the cotangents of (outputs, h, c),
    differentiating the plain scan on the saved inputs (mmtpu's `_bwd`)."""
    grads = lstm_recompute_stacked_grads(
        xw[None], wh[None], _lead(h0), _lead(c0), _lead(lengths),
        g_out[None], g_h[None], g_c[None])
    return tuple(g[0] for g in grads)


def lstm_recompute_stacked_grads(xw, wh, h0, c0, lengths, g_out, g_h, g_c):
    """`lstm_recompute_grads` of G groups at once: xw (G, B, T, 4H), wh
    (G, H, 4H), the states (G, B, H) or None (zeros, whose gradients are
    returned all the same), lengths (G, B) or None; one `torch.func.vjp`
    through the plain stacked scan, so it also runs inside a transform."""
    G, B, H = xw.shape[0], xw.shape[1], wh.shape[1]
    h0 = xw.new_zeros((G, B, H)) if h0 is None else h0
    c0 = xw.new_zeros((G, B, H)) if c0 is None else c0

    def scan(xw, wh, h0, c0):
        out, (h, c) = lstm_stacked_reference(xw, wh, h0, c0, lengths)
        return out, h, c

    _, pullback = torch.func.vjp(scan, xw, wh, h0, c0)
    return pullback((g_out, g_h, g_c))


def fold_groups(members: int, groups: int, in_dims, xws, whs, h0, c0, lengths):
    """K members' G groups as one call of K·G groups, member k's group g at
    k·G + g. `in_dims` are vmap's: per xw, per wh, then h0, c0, lengths
    (None: shared by every member). Member slices of a batched xw or wh are
    views of its contiguous (K, ...) layout; a shared one is the same
    tensor K times. States and lengths become (K·G, ...)."""
    xw_dims, wh_dims = in_dims[:groups], in_dims[groups:2 * groups]
    h_dim, c_dim, l_dim = in_dims[2 * groups:]

    def per_member(t, d):
        return [t] * members if d is None else t.movedim(d, 0).contiguous().unbind(0)

    def lead(t, d):  # (K·G, ...) from (G, ...) per member
        if t is None:
            return None
        t = t.expand(members, *t.shape) if d is None else t.movedim(d, 0)
        return t.reshape(members * groups, *t.shape[2:])

    xs = [per_member(t, d) for t, d in zip(xws, xw_dims)]
    ws = [per_member(t, d) for t, d in zip(whs, wh_dims)]
    return ([xs[g][k] for k in range(members) for g in range(groups)],
            [ws[g][k] for k in range(members) for g in range(groups)],
            lead(h0, h_dim), lead(c0, c_dim), lead(lengths, l_dim))


def _unfold(members: int, t: torch.Tensor) -> torch.Tensor:
    """(K·G, ...) → (K, G, ...)."""
    return t.reshape(members, t.shape[0] // members, *t.shape[1:])


class _LSTM(torch.autograd.Function):
    """Kernel forward (the plain scan on the CPU); backward is the plain
    recompute of all groups at once. Under `torch.func.vmap` the members
    fold into the group axis (`fold_groups`): one call of K·G groups."""

    @staticmethod
    def forward(groups: int, lengths, h0, c0, *xw_wh):
        xws, whs = list(xw_wh[:groups]), list(xw_wh[groups:])
        if xws[0].device.type == "cuda":
            return _launch(xws, whs, h0, c0, lengths)
        out, (h, c) = lstm_stacked_reference(xws, whs, h0, c0, lengths)
        # with T = 0 the final state is the initial one: no output may alias an input
        return out, (h.clone() if h is h0 else h), (c.clone() if c is c0 else c)

    @staticmethod
    def setup_context(ctx, inputs, output):
        groups, lengths, h0, c0, *xw_wh = inputs
        ctx.groups = groups
        ctx.save_for_backward(lengths, h0, c0, *xw_wh)

    @staticmethod
    def backward(ctx, g_out, g_h, g_c):
        lengths, h0, c0, *xw_wh = ctx.saved_tensors
        G = ctx.groups
        dxw, dwh, dh0, dc0 = lstm_recompute_stacked_grads(
            torch.stack(xw_wh[:G]), torch.stack(xw_wh[G:]), h0, c0, lengths,
            g_out, g_h, g_c)
        return (None, None, None if h0 is None else dh0, None if c0 is None else dc0,
                *dxw.unbind(0), *dwh.unbind(0))

    @staticmethod
    def vmap(info, in_dims, groups: int, lengths, h0, c0, *xw_wh):
        K = info.batch_size
        _, l_dim, h_dim, c_dim, *t_dims = in_dims
        xws, whs, h0, c0, lengths = fold_groups(
            K, groups, [*t_dims, h_dim, c_dim, l_dim], xw_wh[:groups], xw_wh[groups:],
            h0, c0, lengths)
        out, h, c = _LSTM.apply(K * groups, lengths, h0, c0, *xws, *whs)
        return (_unfold(K, out), _unfold(K, h), _unfold(K, c)), (0, 0, 0)


def lstm_sequence_stacked(
    xw: Grouped, wh: Grouped, h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None, lengths: Optional[torch.Tensor] = None,
):
    """G independent LSTMs advanced together.

    xw: (G, B, T, 4H) pre-projected inputs, or G tensors (B, T, 4H); wh:
    (G, H, 4H), or G tensors (H, 4H); h0/c0: (G, B, H), or None for a zero
    state (nothing is allocated for it); lengths: optional (G, B) int32.
    Returns (outputs (G, B, T, H), (h, c)).

    A call that needs no gradient goes through the operator `mmtpu::lstm`
    (`ops/library.py`) on either device, so a traced graph holds it: on
    CUDA it launches the kernel once for all groups (counted in
    `lstm_sequence_stacked.launches`) or raises, on the CPU it is the plain
    scan. An eager call on CUDA launches the same kernel without the
    dispatcher (`_build.direct_launch`). A call that needs a gradient takes
    the plain scan on the CPU and `_LSTM` on CUDA. Under a `torch.func`
    transform every call takes the operator or `_LSTM`, on either device,
    whose vmap rules fold the members into the group axis."""
    xws, whs = _groups(xw), _groups(wh)
    device = xws[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm: no kernel for device {device}")
    transformed = _build.transformed(*xws, *whs, h0, c0, lengths)
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (*xws, *whs, h0, c0)
    ):
        if device.type == "cpu" and not transformed:
            return lstm_stacked_reference(xw, wh, h0, c0, lengths)
        out, h, c = _LSTM.apply(len(xws), lengths, h0, c0, *xws, *whs)
    elif _build.direct_launch(device) and not transformed:
        out, h, c = _launch(xws, whs, h0, c0, lengths)
    else:
        out, h, c = torch.ops.mmtpu.lstm(xws, whs, h0, c0, lengths)
    return out, (h, c)


lstm_sequence_stacked.launches = 0


def lstm_sequence(
    xw: torch.Tensor, wh: torch.Tensor, h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None, lengths: Optional[torch.Tensor] = None,
):
    """One LSTM: xw (B, T, 4H) pre-projected inputs, wh (H, 4H), h0/c0 (B, H)
    or None for a zero state, lengths optional (B,) int32. Returns (outputs
    (B, T, H), (h, c)).

    The G = 1 call of `lstm_sequence_stacked` (views, no copy): the same
    kernel, counted in the same `launches`."""
    out, (h, c) = lstm_sequence_stacked([xw], [wh], _lead(h0), _lead(c0), _lead(lengths))
    return out[0], (h[0], c[0])
