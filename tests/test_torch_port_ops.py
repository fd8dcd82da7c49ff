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
    ROWS_PER_THREAD,
    SMEM_LIMIT,
    _check,
    fused_mlp,
    fused_mlp_reference,
    recompute_grads,
    tile_rows,
)

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


@pytest.mark.parametrize("batch,sms", [(1, 132), (128, 132), (1024, 132), (5000, 132), (64, 1)])
def test_tile_rows_fits_shared_memory(batch, sms):
    rows, smem = tile_rows(batch, [192, 128, 64, 10], sms)
    assert rows % ROWS_PER_THREAD == 0 and rows >= ROWS_PER_THREAD
    assert smem == 2 * rows * 192 * 4 <= SMEM_LIMIT
    cap = SMEM_LIMIT // (2 * 192 * 4) // ROWS_PER_THREAD * ROWS_PER_THREAD
    # at most one block per SM, unless the shared-memory cap forces more
    assert -(-batch // rows) <= sms or rows == cap


def test_tile_rows_raises_when_a_tile_does_not_fit():
    with pytest.raises(ValueError, match="does not fit shared memory"):
        tile_rows(8, [8000, 10], 132)


def test_check_rejects_what_the_kernel_does_not_take():
    ws, bs = _torch_layers(*_layers([6, 5, 3]))
    x = torch.zeros(4, 6)
    assert _check(x, ws, bs) == [6, 5, 3]
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


@pytest.mark.cuda
@pytest.mark.parametrize("dims", DIMS + [[100, 300, 7]], ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("batch", [1, 37, 128, 1024])
def test_kernel_matches_plain_on_card(cuda_device, dims, batch):
    ws, bs = _torch_layers(*_layers(dims), device=cuda_device)
    x = torch.from_numpy(
        np.random.default_rng(4).normal(size=(batch, dims[0])).astype(np.float32)
    ).to(cuda_device)
    before = fused_mlp.launches
    got = fused_mlp(x, ws, bs)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    torch.testing.assert_close(got, fused_mlp_reference(x, ws, bs), rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_kernel_backward_on_card(cuda_device):
    ws, bs = _torch_layers(*_layers([192, 128, 64, 10]), device=cuda_device)
    x = torch.randn(37, 192, device=cuda_device, requires_grad=True)
    fused_mlp(x, ws, bs).sum().backward()
    xr = x.detach().clone().requires_grad_()
    fused_mlp_reference(xr, ws, bs).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=TOL, atol=TOL)
