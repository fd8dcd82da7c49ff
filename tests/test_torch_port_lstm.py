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
    KREG_THREADS,
    MAX_GROUPS,
    ROW_TILES,
    SMEM_LIMIT,
    _check,
    launch_plan,
    lstm_recompute_grads,
    lstm_reference,
    lstm_sequence,
    lstm_sequence_stacked,
    lstm_stacked_reference,
    smem_bytes,
)

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


def test_ops_package_lists_both_kernels():
    from mmtpu_torch.ops import KERNELS, _build

    assert KERNELS == ("fused_mlp", "lstm")
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
