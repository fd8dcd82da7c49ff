"""The port's training path on the card against the same code on the CPU:
the pad-aware BatchNorm in train mode, and one train step of a small
AVMNIST (padded tail, missing modalities, dropout 0, TF32 off). These need
an NVIDIA GPU and skip without one. The module imports neither JAX nor
mmtpu, so on the card's machine run

    python -m pytest tests/test_torch_port_train_card.py -m cuda --noconftest

Tolerances: BatchNorm 1e-5 (fp32, the card sums in another order); the
train step's loss 1e-4 relative and each gradient within 1e-3 of its norm.
(`chip_smoke.py` checks the full-width model, whose float32 gradients miss
a float64 step by more than that on either device, against that float64
step.)"""

import numpy as np
import pytest
import torch

from mmtpu_torch.models import AVMNIST, ResNetEncoder
from mmtpu_torch.models.norm import BatchNorm, batch_mask


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: compares the card's training path with the CPU's")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run_bn(x, mask, cot, device, state):
    bn = BatchNorm(x.shape[1]).to(device)
    bn.load_state_dict(state)
    bn.train()
    xt = x.clone().to(device).requires_grad_()
    with batch_mask(None if mask is None else mask.to(device)):
        y = bn(xt)
    (y * cot.to(device)).sum().backward()
    return y.detach().cpu(), xt.grad.cpu(), bn.running_mean.cpu(), bn.running_var.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [2, 4])
@pytest.mark.parametrize("padded", [True, False])
def test_masked_batchnorm_on_card_matches_cpu(cuda_device, rank, padded):
    g = torch.Generator().manual_seed(rank * 10 + padded)
    shape = (12, 6) if rank == 2 else (12, 6, 5, 4)
    x = torch.randn(shape, generator=g) * 2 + 0.5
    mask = None
    if padded:
        mask = torch.ones(12)
        mask[9:] = 0
        x[9:] = 0
    cot = torch.randn(shape, generator=g)
    state = BatchNorm(6).state_dict()
    state["weight"] = 1 + 0.1 * torch.randn(6, generator=g)
    state["bias"] = 0.1 * torch.randn(6, generator=g)
    state["running_var"] = 0.5 + torch.rand(6, generator=g)
    got = _run_bn(x, mask, cot, cuda_device, state)
    want = _run_bn(x, mask, cot, torch.device("cpu"), state)
    for a, b, what in zip(got, want, ("output", "input gradient", "mean", "var")):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=what)


def _batch(B=16, padded_from=12, seed=3):
    g = np.random.default_rng(seed)
    labels = g.integers(0, 10, size=B).astype(np.int64)
    batch = {
        "audio": (g.normal(size=(B, 32, 94)) + 0.3 * labels[:, None, None]).astype(np.float32),
        "image": (g.normal(size=(B, 28, 28, 1)) + 0.3 * labels[:, None, None, None]
                  ).astype(np.float32),
        "audio_mask": np.ones(B, np.float32), "image_mask": np.ones(B, np.float32),
        "labels": labels, "pattern_id": np.zeros(B, np.int32),
        "sample_mask": np.ones(B, np.float32),
    }
    batch["audio_mask"][1::4] = 0.0
    batch["image_mask"][2::4] = 0.0
    for k in ("audio", "image", "labels", "audio_mask", "image_mask", "sample_mask"):
        batch[k][padded_from:] = 0
    return batch


def _step_on(device, batch):
    from mmtpu_torch.cli import common
    from mmtpu_torch.config.training import TrainingConfig
    from mmtpu_torch.train import losses
    from mmtpu_torch.train.step import ClassificationTask, make_train_step

    model = AVMNIST(ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=16),
                    ResNetEncoder(layers=(1, 1, 1, 1), hidden_dim=24), hidden_dim=32,
                    dropout=0.0)
    model = common.init_model(model, 7, device)
    training = TrainingConfig.from_dict({
        "epochs": 1, "num_modalities": 2,
        "optimizer": {"name": "Adam", "default_kwargs": {"lr": 5e-4, "weight_decay": 1e-4}},
        "loss_functions": {"ce": {"loss_name": "cross_entropy"}}})
    state = common.make_state(model, training)
    task = ClassificationTask(model=model, loss_group=losses.LossFunctionGroup.from_dict(
        {"ce": {"loss_name": "cross_entropy"}}), input_keys=["audio", "image"])
    out = make_train_step(task, state, device)(batch)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    stats = {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}
    return float(out["loss"]), grads, stats


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    batch = _batch()
    loss, grads, stats = _step_on(cuda_device, batch)
    want_loss, want_grads, want_stats = _step_on(torch.device("cpu"), batch)
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    for n, w in want_grads.items():
        err = (grads[n] - w).abs().max().item()
        assert err <= 1e-3 * max(w.norm().item(), 1e-12), (n, err)
    for k, w in want_stats.items():
        torch.testing.assert_close(stats[k], w, rtol=1e-4, atol=1e-5, msg=k)
