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
    (2, 32, 64, 132, (1, 64, 0, 64, 256)),      # the UttFusion call: 64 one-row blocks
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
    if plan.kreg:  # one column per thread
        assert 4 * hidden <= plan.threads <= KREG_THREADS
    on_chip = plan.kreg + plan.stage_k
    assert on_chip <= max(hidden, plan.kreg) and plan.smem_bytes(hidden) <= SMEM_LIMIT
    assert on_chip >= hidden or smem_bytes(
        plan.rows, hidden, plan.h_stride, plan.stage_k + 1) > SMEM_LIMIT


def test_launch_plan_raises_when_one_row_does_not_fit():
    with pytest.raises(ValueError, match="does not fit shared memory"):
        launch_plan(1, 4, 20_000, 132)


def test_check_rejects_what_the_kernel_does_not_take():
    xw, wh, h0, c0, lengths = _t(_inputs(2, 3, 4, 8, True, False))
    groups = lambda t: list(t.unbind(0))  # noqa: E731
    assert _check(groups(xw), groups(wh), h0, c0, lengths) == (2, 3, 4, 8)
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
