"""Port LSTM recurrence (mmtpu_torch.ops.lstm) against mmtpu's.

On the CPU the port's wrappers take the plain PyTorch scan and mmtpu's take
`_xla_lstm` (how mmtpu's own tests run the recurrence off the TPU); both get
the same numpy inputs. The kernel itself runs only on the card: the `cuda`
tests compare it with the plain scan there and skip here. The card's machine
has no JAX, so this module imports JAX and mmtpu only inside the tests that
compare with them; on the card run

    python -m pytest tests/test_torch_port_lstm.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from mmtpu_torch.ops import lstm as lstm_ops
from mmtpu_torch.ops.lstm import (
    CLUSTER_SIZES,
    GRID_CHUNK,
    GRID_STAGES,
    KREG_THREADS,
    MAX_GROUPS,
    NARROW_MAX_HIDDEN,
    ROW_TILES,
    SMEM_LIMIT,
    WidePlan,
    _check,
    lane_order,
    launch_plan,
    lstm_recompute_grads,
    lstm_reference,
    lstm_sequence,
    lstm_sequence_stacked,
    lstm_stacked_reference,
    smem_bytes,
    unit_split,
    wide_max_threads,
    wide_plan,
)
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

TOL = 1e-5  # fp32 values; XLA and PyTorch sum h·wh in different orders
GRAD_TOL = 1e-4  # gradients pass through T dependent steps twice

# (B, T, H, with lengths, non-zero h0/c0)
CASES = [
    (4, 6, 8, False, False),
    (5, 7, 24, True, True),
    (3, 12, 16, True, False),
    (2, 9, 32, False, True),
]


def _inputs(groups, B, T, H, with_len, with_state, seed=0):
    """numpy inputs with a leading group axis; lengths in [0, T]."""
    g = np.random.default_rng(seed)
    xw = g.normal(size=(groups, B, T, 4 * H)).astype(np.float32)
    wh = (g.normal(size=(groups, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    if with_state:
        h0 = (0.5 * g.normal(size=(groups, B, H))).astype(np.float32)
        c0 = (0.5 * g.normal(size=(groups, B, H))).astype(np.float32)
    else:
        h0 = np.zeros((groups, B, H), np.float32)
        c0 = np.zeros((groups, B, H), np.float32)
    lengths = g.integers(0, T + 1, size=(groups, B)).astype(np.int32) if with_len else None
    return xw, wh, h0, c0, lengths


def _t(arrays, device="cpu"):
    return [None if a is None else torch.from_numpy(a).to(device) for a in arrays]


def _single(arrays):
    """Group 0 of grouped inputs: what one `lstm_sequence` call takes."""
    return [None if a is None else a[0] for a in arrays]


def _ids(case):
    B, T, H, with_len, with_state = case
    return f"B{B}-T{T}-H{H}{'-len' if with_len else ''}{'-state' if with_state else ''}"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the lstm CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_cpu_matches_jax_lstm_sequence(case):
    import jax.numpy as jnp

    from mmtpu.ops.lstm import _xla_lstm
    from mmtpu.ops.lstm import lstm_sequence as jax_lstm_sequence

    B, T, H, with_len, with_state = case
    xw, wh, h0, c0, lengths = _single(_inputs(1, B, T, H, with_len, with_state))
    before = lstm_sequence_stacked.launches
    for fn in (lstm_sequence, lstm_reference):
        out, (h, c) = fn(*_t((xw, wh, h0, c0, lengths)))
        j = [jnp.asarray(a) for a in (xw, wh, h0, c0)]
        jl = None if lengths is None else jnp.asarray(lengths)
        for want_out, (want_h, want_c) in (jax_lstm_sequence(*j, jl), _xla_lstm(*j, jl)):
            np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=TOL, atol=TOL)
            np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=TOL, atol=TOL)
            np.testing.assert_allclose(c.numpy(), np.asarray(want_c), rtol=TOL, atol=TOL)
        assert out.shape == (B, T, H) and h.shape == c.shape == (B, H)
    assert lstm_sequence_stacked.launches == before, "the CPU path must not count a launch"


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("as_lists", [False, True], ids=["tensor", "lists"])
def test_cpu_matches_jax_lstm_sequence_stacked(case, as_lists):
    import jax.numpy as jnp

    from mmtpu.ops.lstm import lstm_sequence_stacked as jax_stacked

    B, T, H, with_len, with_state = case
    arrays = _inputs(2, B, T, H, with_len, with_state, seed=1)
    xw, wh, h0, c0, lengths = _t(arrays)
    if as_lists:  # per-group tensors, as the two encoders hand them over
        xw, wh = list(xw), list(wh)
    out, (h, c) = lstm_sequence_stacked(xw, wh, h0, c0, lengths)
    want_out, (want_h, want_c) = jax_stacked(
        *[None if a is None else jnp.asarray(a) for a in arrays]
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(want_c), rtol=TOL, atol=TOL)
    assert out.shape == (2, B, T, H)
    # each group equals its own single call
    for g in range(2):
        single, (sh, _) = lstm_reference(*(None if a is None else a[g] for a in _t(arrays)))
        torch.testing.assert_close(out[g], single, rtol=TOL, atol=TOL)
        torch.testing.assert_close(h[g], sh, rtol=TOL, atol=TOL)


def test_length_freeze_semantics():
    """len = 0 keeps h0/c0; a frozen row repeats its last h in the outputs."""
    xw, wh, h0, c0, _ = _t(_single(_inputs(1, 3, 5, 4, False, True, seed=2)))
    lengths = torch.tensor([0, 2, 5], dtype=torch.int32)
    out, (h, c) = lstm_sequence(xw, wh, h0, c0, lengths)
    full, (fh, fc) = lstm_sequence(xw, wh, h0, c0)
    assert torch.equal(h[0], h0[0]) and torch.equal(c[0], c0[0])
    assert torch.equal(out[0], h0[0].expand(5, 4))
    assert torch.equal(out[1, :2], full[1, :2])
    assert torch.equal(out[1, 2:], out[1, 1].expand(3, 4)) and torch.equal(h[1], out[1, 1])
    assert torch.equal(out[2], full[2]) and torch.equal(h[2], fh[2]) and torch.equal(c[2], fc[2])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_recompute_grads_match_jax_vjp(case):
    import jax
    import jax.numpy as jnp

    from mmtpu.ops.lstm import _xla_lstm

    B, T, H, with_len, with_state = case
    xw, wh, h0, c0, lengths = _single(_inputs(1, B, T, H, with_len, with_state, seed=3))
    g = np.random.default_rng(4)
    cots = [g.normal(size=s).astype(np.float32) for s in ((B, T, H), (B, H), (B, H))]
    got = lstm_recompute_grads(*_t((xw, wh, h0, c0, lengths)), *_t(cots))

    jl = None if lengths is None else jnp.asarray(lengths)
    _, vjp = jax.vjp(lambda a, b, c, d: _xla_lstm(a, b, c, d, jl),
                     *[jnp.asarray(a) for a in (xw, wh, h0, c0)])
    want = vjp((jnp.asarray(cots[0]), (jnp.asarray(cots[1]), jnp.asarray(cots[2]))))
    for name, a, b in zip(("dxw", "dwh", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("groups,batch,hidden,sms,want", [
    # want: (rows, register rows of wh, rows staged in shared memory, h stride, threads)
    (2, 32, 64, 132, (1, 64, 0, 64, 128)),      # the UttFusion call: 64 one-row blocks,
                                                #   two units per quad
    (1, 200, 48, 132, (2, 64, 0, 64, 96)),      # 24 quads for 48 units
    (1, 128, 32, 132, (1, 32, 0, 32, 128)),
    (1, 1024, 64, 132, (8, 64, 0, 64, 256)),    # 128 eight-row blocks
    (2, 1024, 64, 132, (8, 64, 0, 64, 256)),    # more blocks than SMs: the largest tile
    (1, 5, 24, 132, (1, 32, 0, 32, 96)),        # h padded to the register rows
    (1, 32, 128, 132, (1, 64, 64, 128, 512)),   # wh is 256 KB: half in registers, half staged
    (1, 4, 200, 132, (1, 0, 71, 200, 800)),     # over 512 threads: no register rows
    (1, 8, 300, 132, (1, 0, 47, 300, 1024)),    # 1200 gate columns on 1024 threads
])
def test_launch_plan(groups, batch, hidden, sms, want):
    plan = launch_plan(groups, batch, hidden, sms)
    assert tuple(plan) == want
    assert plan.rows in ROW_TILES and plan.threads % 32 == 0 and plan.h_stride % 4 == 0
    assert plan.h_stride >= max(hidden, plan.kreg)
    if plan.kreg:  # a quad per unit, or per two units with at most two rows
        units_per_quad = 2 if 32 < hidden <= 64 and plan.rows <= 2 else 1
        assert 4 * hidden <= units_per_quad * plan.threads <= units_per_quad * KREG_THREADS
    on_chip = plan.kreg + plan.stage_k
    assert on_chip <= max(hidden, plan.kreg) and plan.smem_bytes(hidden) <= SMEM_LIMIT
    assert on_chip >= hidden or smem_bytes(
        plan.rows, hidden, plan.h_stride, plan.stage_k + 1) > SMEM_LIMIT


def test_launch_plan_is_cached_by_groups_batch_hidden_and_sms():
    plan = launch_plan(2, 32, 64, 132)
    assert launch_plan(2, 32, 64, 132) is plan
    assert launch_plan(2, 32, 64, 16).rows == 4 != plan.rows     # fewer SMs: larger tiles
    assert launch_plan(2, 1024, 64, 132).rows == 8 != plan.rows  # a larger batch too
    assert launch_plan(2, 32, 32, 132).kreg == 32 != plan.kreg


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("none", ["h0", "c0", "both"])
def test_cpu_none_state_is_zero_state(case, none):
    """h0=None / c0=None against mmtpu's lstm_sequence on explicit zeros,
    through both public functions."""
    import jax.numpy as jnp

    from mmtpu.ops.lstm import lstm_sequence as jax_lstm_sequence

    B, T, H, with_len, with_state = case
    xw, wh, h0, c0, lengths = _single(_inputs(1, B, T, H, with_len, with_state, seed=8))
    if none in ("h0", "both"):
        h0 = None
    if none in ("c0", "both"):
        c0 = None
    zeros = np.zeros((B, H), np.float32)
    want_out, (want_h, want_c) = jax_lstm_sequence(
        *[jnp.asarray(zeros if a is None else a) for a in (xw, wh, h0, c0)],
        None if lengths is None else jnp.asarray(lengths),
    )
    txw, twh, th0, tc0, tl = _t((xw, wh, h0, c0, lengths))
    lead = lambda t: None if t is None else t[None]  # noqa: E731
    results = [
        lstm_sequence(txw, twh, th0, tc0, tl),
        lstm_sequence_stacked([txw], [twh], lead(th0), lead(tc0), lead(tl)),
    ]
    for i, (out, (h, c)) in enumerate(results):
        if i:
            out, h, c = out[0], h[0], c[0]
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(want_c), rtol=TOL, atol=TOL)


def test_recompute_grads_with_none_state():
    """A state given as None has zero-state gradients for xw and wh."""
    xw, wh, h0, c0, lengths = _t(_single(_inputs(1, 3, 5, 8, True, False, seed=9)))
    g = np.random.default_rng(10)
    cots = _t([g.normal(size=s).astype(np.float32) for s in ((3, 5, 8), (3, 8), (3, 8))])
    want = lstm_recompute_grads(xw, wh, h0, c0, lengths, *cots)
    got = lstm_recompute_grads(xw, wh, None, None, lengths, *cots)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_launch_plan_raises_when_one_row_does_not_fit():
    with pytest.raises(ValueError, match="does not fit shared memory"):
        launch_plan(1, 4, 20_000, 132)


def test_check_rejects_what_the_kernel_does_not_take():
    xw, wh, h0, c0, lengths = _t(_inputs(2, 3, 4, 8, True, False))
    groups = lambda t: list(t.unbind(0))  # noqa: E731
    assert _check(groups(xw), groups(wh), h0, c0, lengths) == (2, 3, 4, 8)
    assert _check(groups(xw), groups(wh), None, None, None) == (2, 3, 4, 8)
    with pytest.raises(ValueError, match="c0"):
        _check(groups(xw), groups(wh), None, c0[:, :2], lengths)
    with pytest.raises(TypeError, match="float32"):
        _check(groups(xw.double()), groups(wh), h0, c0, lengths)
    with pytest.raises(TypeError, match="int32"):
        _check(groups(xw), groups(wh), h0, c0, lengths.long())
    with pytest.raises(ValueError, match="contiguous"):
        _check(groups(xw), [w.t().contiguous().t() for w in wh], h0, c0, lengths)
    with pytest.raises(ValueError, match="wh"):
        _check(groups(xw), [w[:, :-4] for w in wh], h0, c0, lengths)
    with pytest.raises(ValueError, match="h0"):
        _check(groups(xw), groups(wh), h0[:1], c0, lengths)
    with pytest.raises(ValueError, match="groups"):
        _check(groups(xw) * MAX_GROUPS, groups(wh) * MAX_GROUPS,
               h0.repeat(MAX_GROUPS, 1, 1), c0.repeat(MAX_GROUPS, 1, 1), None)


def test_non_cuda_non_cpu_device_raises():
    xw, wh, h0, c0, _ = _t(_single(_inputs(1, 2, 3, 4, False, False)))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        lstm_sequence(xw.to("meta"), wh.to("meta"), h0.to("meta"), c0.to("meta"))


# cudaOccupancyMaxActiveClusters on an H100 80GB HBM3 with a block per SM
# (chip_smoke.py phase 2, PERF.md §6): 16-block clusters need 16 SMs of a GPC
H100_CLUSTERS = ((16, 7), (8, 15), (4, 30), (2, 66))

WIDE_PLAN_CASES = [
    # (G, B, H, design wide_plan must choose)
    (1, 128, 256, "cluster"),   # VariationalLSTMEncoder
    (2, 128, 342, "cluster"),   # SeqEncoder video: 16-block clusters in waves
    (2, 128, 1024, "grid"),     # SeqEncoder text: 16 MiB of wh per group
    (2, 16, 300, "cluster"),    # GCNet fusion
    (2, 128, 130, "cluster"),   # SeqEncoder audio
    (2, 1024, 128, "cluster"),  # IEMOCAP's fused eval step
    (64, 3, 300, "cluster"),    # the member fold at a wide H
    (64, 16, 1024, "grid"),
    (2, 37, 1024, "grid"),
    (2, 32, 64, "narrow"),      # the UttFusion main path
    (2, 16, 100, "narrow"),     # GCNet base
]


@pytest.mark.parametrize("groups,batch,hidden,design", WIDE_PLAN_CASES,
                         ids=lambda v: str(v))
def test_wide_plan(groups, batch, hidden, design):
    """Every hidden unit in exactly one block's slice and every batch row in
    exactly one tile; the layout fits a block's shared memory, threads and
    registers; clusters of at most 16; the narrow design at H <= the
    crossover, as `launch_plan` lays it out."""
    plan = wide_plan(groups, batch, hidden, 132, H100_CLUSTERS)
    assert plan.design == design
    assert (hidden <= NARROW_MAX_HIDDEN) == (design == "narrow")
    assert plan.smem <= SMEM_LIMIT and plan.threads % 32 == 0
    if design == "narrow":
        assert plan.narrow == launch_plan(groups, batch, hidden, 132)
        assert plan.smem == plan.narrow.smem_bytes(hidden)
        return
    assert plan.threads == plan.rows // plan.rpt * plan.units * plan.ks
    assert plan.threads <= wide_max_threads(design, plan.rpt, plan.ks)
    assert plan.rpt % plan.ks == 0 and (plan.rpt, plan.ks) in lstm_ops.WIDE_VARIANTS
    slices = plan.unit_slices(hidden)
    assert slices == unit_split(hidden, plan.slices) and len(slices) == plan.slices
    covered = np.concatenate([np.arange(u0, u1) for u0, u1 in slices])
    assert np.array_equal(covered, np.arange(hidden))  # each unit once, in order
    assert max(u1 - u0 for u0, u1 in slices) <= plan.units
    assert max(u1 - u0 for u0, u1 in slices) - min(u1 - u0 for u0, u1 in slices) <= 1
    rows = np.concatenate([np.arange(r0, r1) for r0, r1 in plan.tiles(batch)])
    assert np.array_equal(rows, np.arange(batch))  # each row once
    assert plan.h_pad >= hidden
    if design == "cluster":
        assert plan.cluster in CLUSTER_SIZES and plan.slices == plan.cluster <= 16
        assert plan.h_pad % (4 * plan.ks) == 0 and plan.h_stride >= plan.h_pad
        assert plan.smem == plan.h_pad * plan.units * 16 + 8 * plan.rows * plan.h_stride
        assert plan.blocks == groups * len(plan.tiles(batch)) * plan.cluster
    else:
        assert plan.cluster == 1 and plan.h_pad % GRID_CHUNK == 0
        assert GRID_CHUNK % (4 * plan.ks) == 0
        assert plan.smem == GRID_STAGES * (GRID_CHUNK * plan.units * 16
                                           + plan.rows * (GRID_CHUNK + 4) * 4)
        items = groups * len(plan.tiles(batch)) * plan.slices
        assert plan.blocks == min(items, 132)  # at most one block per SM: all resident


def test_wide_plan_is_cached_and_follows_the_occupancy():
    plan = wide_plan(2, 128, 342, 132, H100_CLUSTERS)
    assert wide_plan(2, 128, 342, 132, H100_CLUSTERS) is plan
    assert plan.cluster == 16  # only 16-block clusters hold 1.78 MiB of wh
    # with all 16-block clusters resident at once the tiles grow no smaller
    roomy = wide_plan(2, 128, 342, 132, ((16, 8), (8, 16), (4, 33), (2, 66)))
    assert roomy is not plan and roomy.design == "cluster"
    # a device that holds no 16-block cluster leaves 342 to the grid design
    assert wide_plan(2, 128, 342, 132, ((8, 15), (4, 30), (2, 66))).design == "grid"
    assert wide_plan(2, 128, 342, 132, H100_CLUSTERS, "grid").design == "grid"


def test_wide_plan_forced_designs():
    """A forced design takes the shape or raises: no silent change of design."""
    assert wide_plan(2, 128, 128, 132, H100_CLUSTERS, "narrow").design == "narrow"
    assert wide_plan(2, 128, 64, 132, H100_CLUSTERS, "cluster").design == "cluster"
    assert wide_plan(2, 128, 64, 132, H100_CLUSTERS, "grid").design == "grid"
    with pytest.raises(ValueError, match="no cluster layout"):
        wide_plan(2, 128, 1024, 132, H100_CLUSTERS, "cluster")
    with pytest.raises(ValueError, match="does not fit shared memory"):
        wide_plan(1, 1, 20_000, 132, H100_CLUSTERS, "narrow")


@pytest.mark.parametrize("units,ks,nk", [(16, 1, 64), (22, 4, 352), (20, 8, 320), (40, 4, 32)])
def test_lane_order_is_a_permutation(units, ks, nk):
    """Lane order places each (k, unit slot) of a block of wh in its own
    float4, and lane q of the k-split reads k = 4(q + ks·j) + i at k-step
    4j + i, slot unit·ks + q."""
    kk, uu = np.meshgrid(np.arange(nk), np.arange(units), indexing="ij")
    idx = lane_order(kk, uu, units, ks)
    assert np.array_equal(np.sort(idx.ravel()), np.arange(nk * units))
    q = (kk // 4) % ks
    assert np.array_equal(idx % (units * ks), uu * ks + q)
    assert np.array_equal(idx // (units * ks), 4 * (kk // (4 * ks)) + kk % 4)


def _pack_slice(wh, u0, u1, units, ks, k0, nk):
    """Rows [k0, k0 + nk) of the four gate columns of units [u0, u1) of wh
    (H, 4H), as the wide kernels hold them in shared memory: a float4 per
    (k, unit slot) in lane order, zeros beyond H and beyond the slice."""
    H = wh.shape[0]
    buf = np.zeros((nk * units, 4))
    kk, uu = np.meshgrid(np.arange(nk), np.arange(units), indexing="ij")
    live = (k0 + kk < H) & (uu < u1 - u0)
    idx = lane_order(kk, uu, units, ks)[live]
    for gate in range(4):
        buf[idx, gate] = wh[(k0 + kk)[live], gate * H + u0 + uu[live]]
    return buf


def _unpack_slice(buf, units, ks, nk):
    """What a block's lanes read back: (nk, unit slots, 4 gates)."""
    kk, uu = np.meshgrid(np.arange(nk), np.arange(units), indexing="ij")
    return buf[lane_order(kk, uu, units, ks)]


def _emulate_wide(xw, wh, h0, c0, lengths, plan):
    """The plan's blocks on the CPU in float64: each (group, tile, unit
    slice) multiplies its tile's h with its slice of wh, packed as the kernel
    packs it (in one block for the cluster design, in chunks of GRID_CHUNK k
    for the grid design) and unpacked per block, then updates its units."""
    G, B, T, H4 = xw.shape
    H = H4 // 4
    chunk = plan.h_pad if plan.design == "cluster" else GRID_CHUNK
    blocks = {}
    for g in range(G):
        for s, (u0, u1) in enumerate(plan.unit_slices(H)):
            w = np.concatenate([
                _unpack_slice(_pack_slice(wh[g], u0, u1, plan.units, plan.ks, k0, chunk),
                              plan.units, plan.ks, chunk)
                for k0 in range(0, plan.h_pad, chunk)])
            assert not w[H:].any() and not w[:, u1 - u0:].any()
            blocks[g, s] = w[:H, :u1 - u0]  # (H, U, 4)
    h, c = h0.astype(np.float64), c0.astype(np.float64)
    out = np.zeros((G, B, T, H))
    sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
    for t in range(T):
        pre = np.zeros((G, B, 4, H))
        for (g, s), w in blocks.items():
            u0, u1 = plan.unit_slices(H)[s]
            for r0, r1 in plan.tiles(B):
                pre[g, r0:r1, :, u0:u1] = np.einsum("rk,kug->rgu", h[g, r0:r1], w)
        pre += xw[:, :, t].reshape(G, B, 4, H)
        i, f, gg, o = sig(pre[:, :, 0]), sig(pre[:, :, 1]), np.tanh(pre[:, :, 2]), sig(pre[:, :, 3])
        c_new = f * c + i * gg
        h_new = o * np.tanh(c_new)
        if lengths is not None:
            keep = (t < lengths)[..., None]
            h_new, c_new = np.where(keep, h_new, h), np.where(keep, c_new, c)
        h, c = h_new, c_new
        out[:, :, t] = h
    return out, h, c


def _forced_plan(G, B, H, **want):
    """The first layout of the planner's candidates (in its order) with these fields."""
    plans = (lstm_ops._cluster_plans(G, B, H, H100_CLUSTERS) if want.get("design") != "grid"
             else lstm_ops._grid_plans(G, B, H, 132))
    return next(p for _, p in sorted(plans, key=lambda kp: kp[0])
                if all(getattr(p, k) == v for k, v in want.items() if k != "design"))


@pytest.mark.parametrize("G,B,T,H,want", [
    (2, 5, 6, 300, dict(cluster=16)),           # 300 = 12 × 19 + 4 × 18 over 16 blocks
    (1, 9, 5, 342, dict(cluster=16, ks=8)),     # 342 = 6 × 22 + 10 × 21, tiles of 8 and 1 rows
    (2, 6, 4, 342, dict(cluster=16, ks=2)),
    (1, 7, 4, 300, dict(design="grid", ks=1)),  # 300 over 19 slices of at most 16, chunks of 64 k
    (1, 5, 3, 200, dict(design="grid", ks=4)),
], ids=["cluster-300-S16", "cluster-342-S16-ks8", "cluster-342-S16-ks2", "grid-300-ks1",
        "grid-200-ks4"])
def test_packed_slices_match_jax_lstm(G, B, T, H, want):
    """The wide designs' layout of wh (unit slices, ragged where S does not
    divide H; the four gate columns of each unit; lane order; chunks) fed
    through a plain per-slice scan gives mmtpu's `_xla_lstm`: where a
    gate-column or lane-order slip would hide."""
    import jax.numpy as jnp

    from mmtpu.ops.lstm import _xla_lstm

    plan = _forced_plan(G, B, H, **want)
    assert isinstance(plan, WidePlan)
    xw, wh, h0, c0, lengths = _inputs(G, B, T, H, True, True, seed=21)
    out, h, c = _emulate_wide(xw, wh, h0, c0, lengths, plan)
    for g in range(G):
        want_out, (want_h, want_c) = _xla_lstm(*(jnp.asarray(a[g]) for a in (xw, wh, h0, c0)),
                                               jnp.asarray(lengths[g]))
        np.testing.assert_allclose(out[g], np.asarray(want_out), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(h[g], np.asarray(want_h), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(c[g], np.asarray(want_c), rtol=TOL, atol=TOL)


def test_ops_package_lists_both_kernels():
    from mmtpu_torch.ops import KERNELS, _build

    assert KERNELS == ("fused_mlp", "lstm", "lstm_wide")
    for name in KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert lstm_ops.lstm_sequence_stacked.launches == lstm_sequence_stacked.launches


# --- on the card -----------------------------------------------------------

CARD_CASES = [
    # (G, B, T, H, with lengths, non-zero state, tolerance)
    (1, 32, 50, 64, False, False, 1e-5),
    (2, 32, 50, 64, False, False, 1e-5),
    (1, 128, 50, 32, False, False, 1e-5),
    (1, 32, 400, 64, True, False, 1e-4),
    (1, 5, 7, 24, False, True, 1e-5),
    (1, 32, 50, 128, False, False, 1e-5),
    (2, 300, 20, 64, True, True, 1e-5),   # eight-row tiles with a ragged tail
    (1, 3, 10, 300, True, True, 1e-5),    # more gate columns than threads
    (1, 6, 12, 200, True, True, 1e-5),    # 800 threads: no rows of wh in registers
    (1, 70, 9, 20, True, True, 1e-5),     # H below the register rows, ragged last warp
    (8, 1, 13, 32, True, True, 1e-5),     # eight groups of one row
    (8, 5, 6, 24, False, True, 1e-5),
    (1, 128, 50, 32, True, True, 1e-5),   # one quad per unit, four warps
    (2, 70, 30, 64, True, True, 1e-5),    # two-row tiles: lanes 0 and 1 of a quad update
    (1, 300, 12, 32, True, True, 1e-5),   # four-row tiles with a ragged tail
    (1, 300, 12, 128, True, True, 1e-5),  # register rows and staged rows together
    (2, 5, 9, 200, False, True, 1e-5),
    (1, 1, 25, 300, True, False, 1e-5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "G{}-B{}-T{}-H{}".format(*c[:4]))
def test_kernel_matches_plain_on_card(cuda_device, case):
    G, B, T, H, with_len, with_state, tol = case
    xw, wh, h0, c0, lengths = _t(_inputs(G, B, T, H, with_len, with_state, seed=5),
                                 device=cuda_device)
    before = lstm_sequence_stacked.launches
    out, (h, c) = lstm_sequence_stacked(list(xw), list(wh), h0, c0, lengths)
    torch.cuda.synchronize()
    assert lstm_sequence_stacked.launches == before + 1
    want, (wh_, wc_) = lstm_stacked_reference(xw, wh, h0, c0, lengths)
    torch.testing.assert_close(out, want, rtol=0, atol=tol)
    torch.testing.assert_close(h, wh_, rtol=0, atol=tol)
    torch.testing.assert_close(c, wc_, rtol=0, atol=tol)
    if G == 1:
        single, (sh, sc) = lstm_sequence(xw[0], wh[0], h0[0], c0[0],
                                         None if lengths is None else lengths[0])
        assert lstm_sequence_stacked.launches == before + 2
        assert torch.equal(single, out[0]) and torch.equal(sh, h[0]) and torch.equal(sc, c[0])


@pytest.mark.cuda
@pytest.mark.parametrize("lens", ["zero", "full", "mixed"])
def test_kernel_length_edges_on_card(cuda_device, lens):
    """Rows of length 0 keep the initial state for all T; rows of length T
    never freeze."""
    G, B, T, H = 2, 9, 11, 64
    xw, wh, h0, c0, lengths = _t(_inputs(G, B, T, H, True, True, seed=11), device=cuda_device)
    if lens == "zero":
        lengths.zero_()
    elif lens == "full":
        lengths.fill_(T)
    else:
        lengths[:, 0::3], lengths[:, 1::3] = 0, T
    out, (h, c) = lstm_sequence_stacked(xw, wh, h0, c0, lengths)
    want, (want_h, want_c) = lstm_stacked_reference(xw, wh, h0, c0, lengths)
    for a, b in ((out, want), (h, want_h), (c, want_c)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    if lens == "zero":
        assert torch.equal(h, h0) and torch.equal(c, c0)


@pytest.mark.cuda
@pytest.mark.parametrize("none", ["h0", "c0", "both"])
def test_kernel_none_state_on_card(cuda_device, none):
    """A null state pointer reads as zeros in the kernel."""
    xw, wh, h0, c0, lengths = _t(_inputs(2, 32, 50, 64, True, True, seed=12), device=cuda_device)
    h0 = None if none in ("h0", "both") else h0
    c0 = None if none in ("c0", "both") else c0
    out, (h, c) = lstm_sequence_stacked(list(xw), list(wh), h0, c0, lengths)
    want, (want_h, want_c) = lstm_stacked_reference(xw, wh, h0, c0, lengths)
    for a, b in ((out, want), (h, want_h), (c, want_c)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_kernel_backward_on_card(cuda_device):
    arrays = _inputs(2, 9, 11, 24, True, True, seed=6)
    cots = [torch.from_numpy(np.random.default_rng(7).normal(size=s).astype(np.float32))
            .to(cuda_device) for s in ((2, 9, 11, 24), (2, 9, 24), (2, 9, 24))]

    def grads(fn):
        xw, wh, h0, c0, lengths = _t(arrays, device=cuda_device)
        leaves = [t.requires_grad_() for t in (xw, wh, h0, c0)]
        out, (h, c) = fn(*leaves, lengths)
        return torch.autograd.grad((out, h, c), leaves, cots)

    for a, b in zip(grads(lstm_sequence_stacked), grads(lstm_stacked_reference)):
        torch.testing.assert_close(a, b, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    xw, wh, h0, c0, _ = _t(_inputs(1, 4, 5, 8, False, False), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        lstm_sequence_stacked(xw.half(), wh.half(), h0.half(), c0.half())
    with pytest.raises(ValueError, match="one device"):
        lstm_sequence_stacked(xw, wh.cpu(), h0, c0)


WIDE_CARD_CASES = [
    # (G, B, T, H, tolerance): lengths (0 and T among them) and a non-zero state
    (1, 128, 64, 256, 1e-5),   # VariationalLSTMEncoder: cluster
    (2, 128, 64, 342, 1e-5),   # SeqEncoder video: 16-block clusters, 342 over 16 blocks
    (2, 128, 64, 1024, 1e-5),  # SeqEncoder text: grid
    (2, 16, 110, 300, 1e-5),   # GCNet fusion: 300 over 8 blocks
    (2, 50, 30, 342, 1e-5),    # a batch no tile divides
    (2, 37, 20, 1024, 1e-5),   # the grid design on a ragged batch
    (64, 3, 20, 300, 1e-5),    # the member fold at a wide H
    (3, 70, 9, 130, 1e-5),     # just above the crossover
    (1, 16, 400, 256, 1e-4),   # 400 dependent steps
]


def _wide_on_card(case, device, design=None, lens="mixed"):
    G, B, T, H, tol = case
    xw, wh, h0, c0, lengths = _t(_inputs(G, B, T, H, True, True, seed=13), device=device)
    if lens == "mixed" and B >= 2:
        lengths[:, 0], lengths[:, -1] = 0, T
    elif lens == "zero":
        lengths.zero_()
    elif lens == "full":
        lengths.fill_(T)
    before = dict(lstm_sequence_stacked.design_launches)
    with torch.no_grad():
        out, h, c = lstm_ops._launch(list(xw), list(wh), h0, c0, lengths, design)
    torch.cuda.synchronize()
    launched = {d: n - before[d] for d, n in lstm_sequence_stacked.design_launches.items()}
    want, (want_h, want_c) = lstm_stacked_reference(xw, wh, h0, c0, lengths)
    for a, b in ((out, want), (h, want_h), (c, want_c)):
        torch.testing.assert_close(a, b, rtol=0, atol=tol)
    return launched, (h, c), (h0, c0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE_CARD_CASES, ids=lambda c: "G{}-B{}-T{}-H{}".format(*c[:4]))
def test_wide_kernel_matches_plain_on_card(cuda_device, case):
    """The design `wide_plan` chooses, launched once, within its tolerance of
    the plain scan."""
    G, B, T, H, _ = case
    index, sms = _build_sm90(cuda_device)
    plan = wide_plan(G, B, H, sms, lstm_ops.max_active_clusters(index))
    launched, _, _ = _wide_on_card(case, cuda_device)
    assert launched == {d: int(d == plan.design) for d in launched}


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["narrow", "cluster", "grid"])
@pytest.mark.parametrize("case", [(2, 128, 64, 128, 1e-5), (2, 9, 11, 200, 1e-5),
                                  (1, 33, 7, 64, 1e-5)],
                         ids=lambda c: "G{}-B{}-T{}-H{}".format(*c[:4]))
def test_each_design_matches_plain_on_card(cuda_device, case, design):
    """Every design forced at shapes the planner gives another one."""
    launched, _, _ = _wide_on_card(case, cuda_device, design)
    assert launched == {d: int(d == design) for d in launched}


@pytest.mark.cuda
@pytest.mark.parametrize("lens", ["zero", "full"])
@pytest.mark.parametrize("case", [(2, 16, 110, 300, 1e-5), (2, 37, 20, 1024, 1e-5)],
                         ids=["cluster", "grid"])
def test_wide_kernel_length_edges_on_card(cuda_device, case, lens):
    """Rows of length 0 keep the initial state for all T; rows of length T
    never freeze."""
    _, (h, c), (h0, c0) = _wide_on_card(case, cuda_device, lens=lens)
    if lens == "zero":
        assert torch.equal(h, h0) and torch.equal(c, c0)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [300, 1024], ids=["cluster", "grid"])
def test_wide_kernel_none_state_and_backward_on_card(cuda_device, H):
    """A null state reads as zeros; the gradient through a wide design's
    forward is the plain scan's."""
    arrays = _inputs(2, 9, 5, H, True, True, seed=14)
    xw, wh, _, _, lengths = _t(arrays, device=cuda_device)
    out, (h, c) = lstm_sequence_stacked(list(xw), list(wh), None, None, lengths)
    want, (want_h, want_c) = lstm_stacked_reference(xw, wh, None, None, lengths)
    for a, b in ((out, want), (h, want_h), (c, want_c)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    cots = [torch.from_numpy(np.random.default_rng(15).normal(size=s).astype(np.float32))
            .to(cuda_device) for s in ((2, 9, 5, H), (2, 9, H), (2, 9, H))]

    def grads(fn):
        xw, wh, h0, c0, lengths = _t(arrays, device=cuda_device)
        leaves = [t.requires_grad_() for t in (xw, wh, h0, c0)]
        out, (h, c) = fn(*leaves, lengths)
        return torch.autograd.grad((out, h, c), leaves, cots)

    for a, b in zip(grads(lstm_sequence_stacked), grads(lstm_stacked_reference)):
        torch.testing.assert_close(a, b, rtol=GRAD_TOL, atol=GRAD_TOL)


def _build_sm90(device):
    from mmtpu_torch.ops import _build

    return _build.sm90_device(device, "lstm")


# the registry-only consumers of `bidirectional_lstm`: (factory, inputs, launches)
def _gcnet(base):
    from mmtpu_torch.models.gcnet import GraphModel

    B, T = 3, 8
    lengths = np.array([8, 5, 2], np.int32)
    g = np.random.default_rng(3)
    args = [g.normal(size=(B, T, 9)).astype(np.float32), g.integers(0, 2, (B, T)),
            (np.arange(T)[None] < lengths[:, None]).astype(np.float32), lengths]
    model = GraphModel(base, adim=3, tdim=4, vdim=2, D_e=5, graph_hidden_size=4, n_speakers=2,
                       window_past=2, window_future=1, n_classes=4, dropout=0.0)
    return model, args


def _lstm_classifier():
    from mmtpu_torch.models.lstm import LSTMClassifier

    lengths = np.array([7, 3, 1, 5], np.int32)
    g = np.random.default_rng(4)
    mask = (np.arange(7)[None, :, None] < lengths[:, None, None]) * np.ones((1, 1, 6), np.float32)
    return LSTMClassifier(6, 5, 4, 3, dropout_rate=0.0), [
        g.normal(size=(4, 7, 6)).astype(np.float32), mask]


BIDIRECTIONAL_CONSUMERS = {
    "gcnet_lstm_base": (lambda: _gcnet("LSTM"), 6),  # 2 base + 2 fusion layers × 2 graph nets
    "gcnet_gru_base": (lambda: _gcnet("GRU"), 4),   # the fusion layers only
    "lstm_classifier": (_lstm_classifier, 2),        # EFModelAL's lexical branch
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BIDIRECTIONAL_CONSUMERS))
def test_bidirectional_layers_launch_once_each_on_card(cuda_device, name):
    """One G = 2 launch per bidirectional LSTM layer of a forward on the
    card, and the forward within 1e-5 of the same module on the CPU."""
    make, launches = BIDIRECTIONAL_CONSUMERS[name]
    torch.manual_seed(0)
    model, arrays = make()
    model.eval()
    args = [torch.from_numpy(np.asarray(a)) for a in arrays]
    with torch.no_grad():
        want = model(*args)[0]
        on_card = model.to(cuda_device)
        before = lstm_sequence_stacked.launches
        got = on_card(*[a.to(cuda_device) for a in args])[0]
        torch.cuda.synchronize()
    assert lstm_sequence_stacked.launches == before + launches
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
