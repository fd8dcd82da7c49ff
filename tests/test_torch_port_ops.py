"""Port fused-MLP (mmtpu_torch.ops.fused_mlp) against mmtpu's fused_mlp.

On the CPU the port's wrapper takes its plain PyTorch chain and mmtpu's
takes its XLA path; both get the same numpy weights. The kernel itself runs
only on the card: the `cuda` tests compare it with the plain chain there
and skip here. The card's machine has no JAX, so this module imports JAX
and mmtpu only inside the tests that compare with them; on the card run

    python -m pytest tests/test_torch_port_ops.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from mmtpu_torch.ops.fused_mlp import (
    HEADER_BYTES,
    ROW_TILES,
    SMEM_LIMIT,
    _check,
    bias_floats,
    bulk_copy_ok,
    chain_plan,
    fused_mlp,
    fused_mlp_reference,
    recompute_grads,
    weight_stride,
)
from _torch_threads import few_threads  # noqa: E402,F401 — in-process comparisons only

TOL = 1e-5  # fp32; XLA and PyTorch sum in different orders
DIMS = [[192, 128, 64, 10], [32, 16, 8]]


def _layers(dims, seed=0):
    """numpy weights in mmtpu's (in, out) layout, biases (out,)."""
    g = np.random.default_rng(seed)
    ws = [(g.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [(0.1 * g.normal(size=(o,))).astype(np.float32) for o in dims[1:]]
    return ws, bs


def _torch_layers(ws, bs, device="cpu"):
    """(out, in) weights, as nn.Linear holds them."""
    return ([torch.from_numpy(w.T.copy()).to(device) for w in ws],
            [torch.from_numpy(b).to(device) for b in bs])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused_mlp CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("batch", [1, 37, 128])
def test_cpu_matches_jax_fused_mlp(dims, batch):
    import jax.numpy as jnp

    from mmtpu.ops.fused_mlp import _xla_mlp
    from mmtpu.ops.fused_mlp import fused_mlp as jax_fused_mlp

    ws, bs = _layers(dims)
    x = np.random.default_rng(1).normal(size=(batch, dims[0])).astype(np.float32)
    before = fused_mlp.launches
    tw, tb = _torch_layers(ws, bs)
    got = fused_mlp(torch.from_numpy(x), tw, tb).numpy()
    assert fused_mlp.launches == before, "the CPU path must not count a launch"
    want = np.asarray(jax_fused_mlp(jnp.asarray(x), tuple(ws), tuple(bs)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    xla = np.asarray(_xla_mlp(jnp.asarray(x), ws, bs))
    np.testing.assert_allclose(got, xla, rtol=TOL, atol=TOL)
    assert got.dtype == np.float32 and got.shape == (batch, dims[-1])


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
def test_recompute_grads_match_jax_bwd_and_autograd(dims):
    """The kernel's backward (recompute_grads) against mmtpu's `_bwd` and
    against autograd through the plain chain."""
    import jax.numpy as jnp

    from mmtpu.ops.fused_mlp import _bwd

    ws, bs = _layers(dims, seed=2)
    g = np.random.default_rng(3)
    x = g.normal(size=(9, dims[0])).astype(np.float32)
    cot = g.normal(size=(9, dims[-1])).astype(np.float32)
    tw, tb = _torch_layers(ws, bs)
    dx, dws, dbs = recompute_grads(torch.from_numpy(x), tw, tb, torch.from_numpy(cot))

    jdx, jdws, jdbs = _bwd((jnp.asarray(x), tuple(ws), tuple(bs)), jnp.asarray(cot))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=TOL, atol=TOL)
    for dw, jdw in zip(dws, jdws):  # (out, in) vs mmtpu's (in, out)
        np.testing.assert_allclose(dw.numpy(), np.asarray(jdw).T, rtol=TOL, atol=TOL)
    for db, jdb in zip(dbs, jdbs):
        np.testing.assert_allclose(db.numpy(), np.asarray(jdb), rtol=TOL, atol=TOL)

    xt = torch.from_numpy(x).requires_grad_()
    aw = [w.clone().requires_grad_() for w in tw]
    ab = [b.clone().requires_grad_() for b in tb]
    fused_mlp_reference(xt, aw, ab).backward(torch.from_numpy(cot))
    np.testing.assert_allclose(dx.numpy(), xt.grad.numpy(), rtol=TOL, atol=TOL)
    for dw, w in zip(dws, aw):
        np.testing.assert_allclose(dw.numpy(), w.grad.numpy(), rtol=TOL, atol=TOL)


HEAD = (192, 128, 64, 10)


def _resident_bytes(dims):
    return 4 * sum(n * weight_stride(k) for k, n in zip(dims[:-1], dims[1:]))


@pytest.mark.parametrize("batch,sms", [(1, 132), (128, 132), (1024, 132), (5000, 132), (64, 1)])
def test_tile_rows_fits_shared_memory(batch, sms):
    """The head's plan: resident weights, both activation buffers, biases and
    header inside the limit, at most one block per SM."""
    plan = chain_plan(batch, HEAD, sms)
    assert plan.rows in ROW_TILES and plan.resident and plan.act_stride == 192
    assert bias_floats(HEAD) == 204  # 128 + 64 + 10, to the next multiple of 4
    assert plan.smem_bytes == (HEADER_BYTES + 4 * 204 + 2 * plan.rows * 192 * 4
                               + _resident_bytes(HEAD))
    assert _resident_bytes(HEAD) == 4 * 33_408  # multiples of 4: stored as they lie
    assert plan.smem_bytes <= SMEM_LIMIT
    tiles = -(-batch // plan.rows)
    assert plan.grid == min(tiles, sms)
    # at most a tile per two SMs, unless even the largest tile leaves more
    half = max(sms // 2, 1)
    assert tiles <= half or plan.rows == ROW_TILES[-1]
    # and no larger a tile than that needs: a small batch spreads over the card
    assert plan.rows == ROW_TILES[0] or -(-batch // (plan.rows // 2)) > half


def test_tile_rows_raises_when_a_tile_does_not_fit():
    with pytest.raises(ValueError, match="does not fit shared memory"):
        chain_plan(8, (30_000, 10), 132)


@pytest.mark.parametrize("dims,batch,want_rows", [
    ((2048, 2048, 10), 1024, 8),   # 16.8 MB of weights: streamed, 8 rows still fit
    ((8000, 10), 8, 1),            # one weight row is 32 KB: streamed in runs of 5 columns
    ((10_000, 300, 7), 1024, 2),   # rows halved until one weight row fits beside them
])
def test_chain_plan_streams_what_is_too_wide_for_residency(dims, batch, want_rows):
    plan = chain_plan(batch, dims, 132)
    assert not plan.resident and plan.smem_bytes == SMEM_LIMIT and plan.rows == want_rows
    region = (SMEM_LIMIT - HEADER_BYTES - 4 * bias_floats(dims)
              - 2 * plan.rows * plan.act_stride * 4)
    assert region >= 4 * max(weight_stride(k) for k in dims[:-1])
    assert region < _resident_bytes(dims)
    assert plan.act_stride % 4 == 0 and plan.act_stride >= max(dims[:-1])


def test_chain_plan_is_cached_by_batch_dims_and_sms():
    plan = chain_plan(128, HEAD, 132)
    assert chain_plan(128, HEAD, 132) is plan
    assert plan.rows == 2 and plan.grid == 64
    assert chain_plan(1024, HEAD, 132) != plan          # another batch: another tile
    assert chain_plan(128, HEAD, 64).grid != plan.grid  # fewer SMs: fewer blocks
    assert chain_plan(128, (192, 128, 64, 12), 132).smem_bytes != plan.smem_bytes


@pytest.mark.parametrize("k,want", [(192, 192), (128, 128), (64, 64), (100, 100), (300, 300),
                                    (7, 8), (16, 16), (17, 20)])
def test_weight_stride_keeps_rows_on_16_byte_boundaries(k, want):
    s = weight_stride(k)
    assert s == want and s >= k and s % 4 == 0 and s - k < 4


@pytest.mark.parametrize("dims,want", [
    ([192, 128, 64, 10], [True, True, True]),
    ([100, 300, 7], [True, True]),       # rows of 400 and 1200 bytes
    ([30, 17, 5], [False, False]),       # rows of 120 and 68 bytes
], ids=["192x128x64x10", "100x300x7", "30x17x5"])
def test_bulk_copy_rule(dims, want):
    ws, _ = _torch_layers(*_layers(dims))
    assert [bulk_copy_ok(w) for w in ws] == want


def test_bulk_copy_rule_refuses_a_misaligned_view():
    """A contiguous (out, in) view that starts 4 bytes into its buffer."""
    buf = torch.zeros(128 * 192 + 1)
    assert buf.data_ptr() % 16 == 0
    view = buf[1:].view(128, 192)
    assert view.is_contiguous() and not bulk_copy_ok(view)
    assert bulk_copy_ok(buf[4:4 + 127 * 192].view(127, 192))


def test_check_rejects_what_the_kernel_does_not_take():
    ws, bs = _torch_layers(*_layers([6, 5, 3]))
    x = torch.zeros(4, 6)
    assert _check(x, ws, bs) == (6, 5, 3)
    with pytest.raises(TypeError, match="float32"):
        _check(x.double(), [w.double() for w in ws], [b.double() for b in bs])
    with pytest.raises(ValueError, match="contiguous"):
        _check(torch.zeros(6, 4).t(), ws, bs)
    with pytest.raises(ValueError, match="not \\(out, 6\\)"):
        _check(x, [ws[1], ws[0]], bs)
    with pytest.raises(ValueError, match="layers"):
        _check(x, ws * 5, bs * 5)


def test_non_cuda_non_cpu_device_raises():
    ws, bs = _torch_layers(*_layers([6, 3]))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_mlp(torch.zeros(2, 6, device="meta"), ws, bs)


def _card_case(cuda_device, dims, batch, seed=4):
    ws, bs = _torch_layers(*_layers(dims), device=cuda_device)
    x = torch.from_numpy(
        np.random.default_rng(seed).normal(size=(batch, dims[0])).astype(np.float32)
    ).to(cuda_device)
    return x, ws, bs


def _assert_kernel_matches_plain(x, ws, bs):
    before = fused_mlp.launches
    got = fused_mlp(x, ws, bs)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    torch.testing.assert_close(got, fused_mlp_reference(x, ws, bs), rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", DIMS + [[100, 300, 7]], ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("batch", [1, 37, 128, 1024, 5000])
def test_kernel_matches_plain_on_card(cuda_device, dims, batch):
    _assert_kernel_matches_plain(*_card_case(cuda_device, dims, batch))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [
    [192, 10],                                   # one layer
    [24, 40, 56, 72, 88, 72, 56, 40, 5],         # eight layers
    [30, 17, 5],                                 # widths no multiple of 4: plain copies
    [33, 50, 21, 3],
    [2048, 2048, 10],                            # too wide for resident weights: streamed
    [8000, 10],                                  # runs of fewer columns than a task
], ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("batch", [5, 300])
def test_kernel_shapes_the_design_makes_special(cuda_device, dims, batch):
    _assert_kernel_matches_plain(*_card_case(cuda_device, dims, batch, seed=5))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [37, 1024])
def test_kernel_takes_a_misaligned_weight_view(cuda_device, batch):
    """Layer 1's matrix starts 4 bytes into its buffer: no bulk copy for it,
    the same kernel copies it with plain loads."""
    x, ws, bs = _card_case(cuda_device, [192, 128, 64, 10], batch, seed=6)
    buf = torch.empty(ws[0].numel() + 1, device=cuda_device)
    buf[1:].copy_(ws[0].reshape(-1))
    ws[0] = buf[1:].view_as(ws[0])
    assert ws[0].is_contiguous() and not bulk_copy_ok(ws[0]) and bulk_copy_ok(ws[1])
    _assert_kernel_matches_plain(x, ws, bs)


@pytest.mark.cuda
def test_kernel_backward_on_card(cuda_device):
    ws, bs = _torch_layers(*_layers([192, 128, 64, 10]), device=cuda_device)
    x = torch.randn(37, 192, device=cuda_device, requires_grad=True)
    fused_mlp(x, ws, bs).sum().backward()
    xr = x.detach().clone().requires_grad_()
    fused_mlp_reference(xr, ws, bs).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=TOL, atol=TOL)
