"""Full-sequence LSTM recurrence: G independent LSTMs, each over its whole
sequence, in ONE CUDA kernel with h and c kept on chip.

Counterpart of `mmtpu/ops/lstm.py`; the kernel (`csrc/lstm.cu`) replaces the
TPU kernel `mmtpu/ops/lstm.py::_pallas_lstm`. It computes the same function
per group — `pre = xw[:, t] + h·wh`, gates `[i, f, g, o]` = σ, σ, tanh, σ,
`c' = f·c + i·g`, `h' = o·tanh(c')`, rows with `t ≥ len` keep h and c — and
takes a leading group dimension, so that `lstm_sequence` is its G = 1 call
and `lstm_sequence_stacked` its G ≥ 1 call. (mmtpu runs the stacked form as
a plain XLA scan and chooses between kernel and scan by shape; both rules
answer the TPU. Here every CUDA call launches one kernel.)

Three designs, chosen by shape (`wide_plan`), one launch per call each:
- `narrow` (`csrc/lstm.cu`, H ≤ NARROW_MAX_HIDDEN): blocks split the batch
  and each holds all of wh in registers and shared memory;
- `cluster` (`csrc/lstm_wide.cu`): wh split by hidden units across the S ≤ 16
  blocks of a thread-block cluster, resident in shared memory for all T
  steps, h exchanged through distributed shared memory;
- `grid` (`csrc/lstm_wide.cu`): where no cluster holds wh (H = 1024), one
  cooperative launch whose blocks own unit slices and stream h and their
  slice of wh through shared memory each step, one grid barrier per step.
What bounds each on the H100 and what its design does about that is noted
at the top of its CUDA source.

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
- CUDA tensors → the planned design's kernel, or an error. There is no
  fallback, to another design or to the scan: a CUDA input the kernel does
  not take raises (dtype other than float32, a non-contiguous tensor,
  tensors on different devices, an architecture other than sm_90), and so
  does a launch the design's kernel refuses. A call of
  more than MAX_GROUPS groups (the pointer tables are kernel parameters)
  launches once per MAX_GROUPS groups, each launch counted.

Member axis (mmtpu's stacked engine vmaps the recurrence over members):
under `torch.func.vmap` the K members fold into the group axis, one call
of K·G groups, member k's group g at k·G + g; its `xw` and `wh` are the
contiguous slices of the batched tensors, handed over by pointer without a
copy (`fold_groups`).

A launch costs the host little beside the launch itself: the device's
properties and its cluster occupancy are read once, the plan is cached by
(G, B, H, SMs, occupancy), the pointer tables are preallocated, and the
device is switched only when it is not the current one. The grid design
allocates its scratch (the double-buffered h and the transposed wh, which
the kernel's prologue writes) with one `torch.empty`.

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

# the wide designs (csrc/lstm_wide.cu). The crossover: larger H takes a wide
# design; on an H100 the narrow design was faster at H = 64 and 100, the
# cluster design at H = 128, 130 and 256 (chip_smoke.py phase 2, PERF.md §6)
NARROW_MAX_HIDDEN = 100
WIDE_MAX_THREADS = 512
# (rows per thread, k-slices) the wide kernels are built for
WIDE_VARIANTS = ((4, 1), (4, 2), (4, 4), (8, 1), (8, 2), (8, 4), (8, 8))
CLUSTER_SIZES = (16, 8, 4, 2)  # 16 needs the non-portable cluster size
GRID_CHUNK = 64  # k per chunk the grid design streams: MMTPU_GRID_CHUNK
GRID_STAGES = 3  # MMTPU_GRID_STAGES
GRID_UNITS = (8, 16, 32)  # unit slots of a grid design's block
# the planner's step model, in SM cycles, fitted to phase 2's times on an
# H100 (PERF.md §6): 80 fp32 FMAs per cycle and SM (of 128), one 128-byte
# wavefront of shared memory per cycle, of which half overlaps the FMAs; the
# fixed part of a step (cluster: barrier, exchange and gates; grid: the grid
# barrier, the first chunks' latency and the update); a grid chunk's
# barrier; the L2's rate shared by all SMs (about 5 TB/s at 1.75 GHz)
FMA_PER_CYCLE = 80
STEP_CYCLES = {"cluster": 3000, "grid": 12000}
# the cluster step's fixed part grows with the block's warps and with the
# peers each h value is written to
WARP_STEP_CYCLES = 100
PEER_STEP_CYCLES = 60
CHUNK_CYCLES = 300
L2_BYTES_PER_CYCLE = 2800

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


def wide_max_threads(design: str, rpt: int, ks: int) -> int:
    """The thread limit a wide variant is compiled for (csrc/lstm_wide.cu
    `max_threads`): 256 where a cluster design's lane keeps the state of four
    rows or more in registers for all T steps, or where a grid design's
    lane holds eight rows' operands; else WIDE_MAX_THREADS."""
    if (design == "cluster" and rpt // ks >= 4) or (design == "grid" and rpt == 8):
        return 256
    return WIDE_MAX_THREADS


def unit_split(hidden: int, slices: int) -> list:
    """The hidden units [u0, u1) of each of `slices` blocks, as the wide
    kernels compute them: u0 = s·H // slices, ragged by at most one unit."""
    return [(s * hidden // slices, (s + 1) * hidden // slices) for s in range(slices)]


def lane_order(k_rel: int, unit: int, units: int, ks: int) -> int:
    """Where the float4 of wh (the four gates of unit slot `unit`, row k0 +
    k_rel) lies in a lane-ordered block of wh in shared memory: lane q of
    the k-split takes k_rel = 4(q + ks·j) + i, stored at k-step 4j + i, slot
    unit·ks + q (csrc/lstm_wide.cu `lane_order`)."""
    c4 = k_rel // 4
    q, j = c4 % ks, c4 // ks
    return (4 * j + k_rel % 4) * (units * ks) + unit * ks + q


class WidePlan(NamedTuple):
    """How one launch is laid out, by design (see the CUDA sources)."""

    design: str     # "narrow", "cluster" or "grid"
    cluster: int    # S: blocks of a cluster (1 outside the cluster design)
    rows: int       # Bt: batch rows of a block's tile (narrow: rows per block)
    rpt: int        # rows per thread of the wide designs (0 for narrow)
    ks: int         # k-slices of the wide designs (0 for narrow)
    units: int      # unit slots of a block (narrow: H)
    slices: int     # unit slices of one group (S for cluster, 1 for narrow)
    threads: int
    smem: int       # bytes of dynamic shared memory of a block
    blocks: int     # blocks launched
    h_pad: int      # H padded to the k-split (cluster) or the chunk (grid)
    h_stride: int   # floats between rows of h in shared memory (cluster, narrow)
    narrow: Optional[LaunchPlan] = None

    def unit_slices(self, hidden: int) -> list:
        return unit_split(hidden, self.slices)

    def tiles(self, batch: int) -> list:
        """The batch rows [r0, r1) of each tile."""
        return [(r, min(batch, r + self.rows)) for r in range(0, batch, self.rows)]


def _row_groups(rpt: int, batch: int):
    """Row groups per block: the tile (rpt·n rows) stops at the first that
    covers the batch."""
    n = 1
    while True:
        yield n
        if rpt * n >= batch:
            return
        n *= 2


def _product_cycles(rows: int, rpt: int, ks: int, units: int, h_pad: int,
                    threads: int) -> float:
    """SM cycles of one block's product over h_pad k: its FMAs over the fp32
    lanes plus half its shared-memory wavefronts (a warp's float4 loads of
    wh: its distinct slots; of h: its k-slices times the row groups it
    spans), stretched where fewer than eight warps hide the latency."""
    warps = threads / 32
    lanes_rg = units * ks  # lanes of one row group
    rgs_per_warp = max(1, 32 // lanes_rg)
    w_wf = max(1, min(32, lanes_rg) * 16 // 128)
    h_wf = max(1, ks * rgs_per_warp * 16 // 128)
    smem = warps * (h_pad / ks * w_wf + rpt * h_pad / (4 * ks) * h_wf)
    fma = rows * h_pad * 4 * units / FMA_PER_CYCLE
    return (fma + smem / 2) * max(1.0, 8 * 32 / threads)


def _cluster_plans(G, B, H, max_active_clusters):
    for S, active in max_active_clusters:
        if S > H or active < 1:
            continue
        u_max = -(-H // S)
        for rpt, ks in WIDE_VARIANTS:
            nj = -(-H // (4 * ks))
            h_pad = 4 * ks * nj
            h_stride = h_pad + 4
            for nrg in _row_groups(rpt, B):
                rows = rpt * nrg
                units = u_max
                while nrg * units * ks % 32:
                    units += 1
                threads = nrg * units * ks
                smem = h_pad * units * 16 + 8 * rows * h_stride
                clusters = G * -(-B // rows)
                if threads > wide_max_threads("cluster", rpt, ks) or smem > SMEM_LIMIT:
                    continue
                # clusters beyond those resident at once run in further waves
                cycles = -(-clusters // active) * (
                    _product_cycles(rows, rpt, ks, units, h_pad, threads)
                    + STEP_CYCLES["cluster"] + WARP_STEP_CYCLES * threads // 32
                    + PEER_STEP_CYCLES * S)
                yield (cycles, clusters * S, threads), WidePlan(
                    "cluster", S, rows, rpt, ks, units, S, threads, smem, clusters * S,
                    h_pad, h_stride)


def _grid_plans(G, B, H, sms):
    h_pad = -(-H // GRID_CHUNK) * GRID_CHUNK
    for units in GRID_UNITS:
        slices = -(-H // units)
        for rpt, ks in WIDE_VARIANTS:
            if GRID_CHUNK % (4 * ks):
                continue
            for nrg in _row_groups(rpt, B):
                rows = rpt * nrg
                threads = nrg * units * ks
                smem = GRID_STAGES * (GRID_CHUNK * units * 16 + rows * (GRID_CHUNK + 4) * 4)
                if threads % 32 or threads > wide_max_threads("grid", rpt, ks) \
                        or smem > SMEM_LIMIT:
                    continue
                items = G * -(-B // rows) * slices
                blocks = min(items, sms)
                l2_bytes = items * (rows * h_pad * 4 + h_pad * units * 16)
                per_item = (_product_cycles(rows, rpt, ks, units, h_pad, threads)
                            + h_pad // GRID_CHUNK * CHUNK_CYCLES)
                cycles = max(-(-items // blocks) * per_item,
                             l2_bytes / L2_BYTES_PER_CYCLE) + STEP_CYCLES["grid"]
                yield (cycles, blocks, threads), WidePlan(
                    "grid", 1, rows, rpt, ks, units, slices, threads, smem, blocks, h_pad, 0)


@functools.lru_cache(maxsize=256)
def wide_plan(groups: int, batch: int, hidden: int, sms: int,
              max_active_clusters: Tuple[Tuple[int, int], ...],
              design: Optional[str] = None) -> WidePlan:
    """The design and layout of a launch over (groups, batch) rows of hidden
    size H; computed once per argument tuple and kept.

    `max_active_clusters`: (S, clusters) pairs, how many clusters of S blocks
    the device holds at once when each block takes a whole SM
    (`cudaOccupancyMaxActiveClusters`; 16-block clusters need 16 SMs of one
    GPC). `design` forces one (the crossover's measurement); None chooses:
    `narrow` (`launch_plan`) at H ≤ NARROW_MAX_HIDDEN; above it the cluster
    design wherever one of its layouts fits shared memory (its slice of wh
    and two buffers of its tile's h), since on the H100 it beat the grid
    design at every shape both took (PERF.md §6), else the grid design,
    which takes any shape (its blocks walk the work items). Within a design
    the layout with the fewest modelled cycles per step wins; clusters
    beyond those resident at once run in further waves, each as long as the
    first, which the model counts. Raises where the forced design has no
    layout."""
    if design is None:
        design = "narrow" if hidden <= NARROW_MAX_HIDDEN else "wide"
    if design == "narrow":
        lp = launch_plan(groups, batch, hidden, sms)
        return WidePlan("narrow", 1, lp.rows, 0, 0, hidden, 1, lp.threads,
                        lp.smem_bytes(hidden), groups * -(-batch // lp.rows), hidden,
                        lp.h_stride, lp)
    plans = []
    if design in ("wide", "cluster"):
        plans = list(_cluster_plans(groups, batch, hidden, max_active_clusters))
    if design == "grid" or (design == "wide" and not plans):
        plans = list(_grid_plans(groups, batch, hidden, sms))
    if not plans:
        raise ValueError(f"lstm: no {design} layout for G={groups}, B={batch}, H={hidden}")
    return min(plans, key=lambda kp: kp[0])[1]


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
_wide = None  # (cluster entry, grid entry, occupancy query) of csrc/lstm_wide.cu
_occupancy: dict = {}  # device index → max_active_clusters for wide_plan
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


def _wide_fns():
    """The wide designs' C entry points, built and bound on first use."""
    global _wide
    if _wide is None:
        lib = _build.load("lstm_wide")
        cluster, grid, occ = (lib.mmtpu_lstm_cluster_forward, lib.mmtpu_lstm_grid_forward,
                              lib.mmtpu_lstm_wide_occupancy)
        cluster.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        grid.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        occ.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        for fn in (cluster, grid, occ):
            fn.restype = ctypes.c_int
        _wide = cluster, grid, occ
    return _wide


def max_active_clusters(index: int) -> Tuple[Tuple[int, int], ...]:
    """(S, clusters) for each cluster size: how many clusters of S blocks of
    the cluster kernel device `index` holds at once when each block takes a
    whole SM (all the shared memory a block may use). Queried once per device."""
    got = _occupancy.get(index)
    if got is None:
        occ = _wide_fns()[2]
        n = ctypes.c_int(0)
        pairs = []
        with _build.on_device(index):
            for S in CLUSTER_SIZES:
                rc = occ(0, 8, 8, S, 256, SMEM_LIMIT, ctypes.byref(n))
                if rc != 0:
                    raise RuntimeError(f"lstm: cluster occupancy query failed with CUDA "
                                       f"error {rc} (S={S})")
                pairs.append((S, n.value))
        got = _occupancy[index] = tuple(pairs)
    return got


def _at(t: Optional[torch.Tensor], offset: int):
    """The address `offset` 4-byte elements into `t`; None stays None."""
    return None if t is None else t.data_ptr() + 4 * offset


def _launch(xws, whs, h0, c0, lengths, design: Optional[str] = None):
    """The kernel over all groups → (out (G, B, T, H), hT, cT): one launch,
    or one per MAX_GROUPS groups beyond that, of the design `wide_plan`
    chooses; `design` forces one (the crossover's measurement)."""
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
    wide = design not in (None, "narrow") or (design is None and H > NARROW_MAX_HIDDEN)
    occupancy = max_active_clusters(index) if wide else ()
    for g0 in range(0, G, MAX_GROUPS):
        n = min(MAX_GROUPS, G - g0)
        plan = wide_plan(n, B, H, num_sms, occupancy, design)
        state = g0 * B * H
        scratch = None
        if plan.design == "grid":  # h twice (2, n, B, Hp), then wh transposed (n, Hp, H, 4)
            scratch = torch.empty(2 * n * B * plan.h_pad + 4 * n * plan.h_pad * H,
                                  device=dev, dtype=torch.float32)
        with _launch_lock, _build.on_device(index):
            for g in range(n):
                _c_xw[g] = xws[g0 + g].data_ptr()
                _c_wh[g] = whs[g0 + g].data_ptr()
            args = (_c_xw, _c_wh, _at(h0, state), _at(c0, state), _at(lengths, g0 * B),
                    _at(out, state * T), _at(hT, state), _at(cT, state))
            stream = _build.current_stream(index)
            if plan.design == "narrow":
                rc = (_kernel or _kernel_fn())(*args, n, B, T, H, *plan.narrow, stream)
            elif plan.design == "cluster":
                rc = _wide_fns()[0](*args, n, B, T, H, plan.cluster, plan.rows, plan.rpt,
                                    plan.ks, plan.units, plan.h_pad, plan.h_stride,
                                    plan.threads, plan.smem, stream)
            else:
                rc = _wide_fns()[1](*args, _at(scratch, 0),
                                    _at(scratch, 2 * n * B * plan.h_pad), n, B, T, H,
                                    plan.slices, plan.rows, plan.rpt, plan.ks, plan.units,
                                    plan.h_pad, plan.blocks, plan.threads, plan.smem, stream)
            if rc == 0:
                lstm_sequence_stacked.launches += 1
                lstm_sequence_stacked.design_launches[plan.design] += 1
        if rc != 0:
            raise RuntimeError(
                f"lstm: {plan.design} kernel launch failed with CUDA error {rc} (G={n} of "
                f"{G}, B={B}, T={T}, H={H}, {plan})"
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
    `lstm_sequence_stacked.launches`, and by design in its
    `design_launches`) or raises, on the CPU it is the plain
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
# the same launches by design (`wide_plan`)
lstm_sequence_stacked.design_launches = {"narrow": 0, "cluster": 0, "grid": 0}


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
