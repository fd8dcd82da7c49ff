"""The port's variational encoders (`mmtpu_torch/models/variational.py`)
against mmtpu's from the same variables, on the CPU.

Every class through `from_jax_variables`: forwards in eval and train mode at
1e-5 and gradients at 1e-4 of each parameter's norm (`_recurrent_parity`),
with the lengths below T, at T and past it, and without lengths; ε and the
dropouts neutralised in both packages for the train-mode parity. The `lstm`
launches per forward are counted through the kernel's plain version: one
G = 1 launch for `VariationalLSTMEncoder` (at 2 × hidden) and for
`VariationalLSTMEncoder2` in every mode. The registry's names build the
same classes in both packages.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mmtpu.models import variational as jax_var
from mmtpu.models.registry import build_module as jax_build
from mmtpu_torch.models import build_module
from mmtpu_torch.models import variational as var
from mmtpu_torch.models.rng import use_generator

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _recurrent_parity import check, neutralise  # noqa: E402

B, T, I, H = 6, 7, 5, 4
LENGTHS = {"none": None,
           "short": np.array([3, 7, 1, 5, 7, 2], np.int32),   # ≤ T and = T
           "long": np.array([9, 7, 12, 4, 30, 1], np.int32)}  # past T


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture
def neutral():
    mp = pytest.MonkeyPatch()
    neutralise(mp, jax_var)
    yield
    mp.undo()


@pytest.mark.parametrize("lengths", list(LENGTHS))
@pytest.mark.parametrize("embd", ["last", "maxpool", "attention"])
def test_variational_lstm_encoder(neutral, embd, lengths):
    """(z, mu, log_var) of an LSTM at 2 × hidden: one G = 1 launch."""
    kw = {} if LENGTHS[lengths] is None else {"lengths": LENGTHS[lengths]}
    check(jax_var.VariationalLSTMEncoder(I, H, embd), var.VariationalLSTMEncoder(I, H, embd),
          [_x(B, T, I)], kw, launches=[1])


@pytest.mark.parametrize("lengths", list(LENGTHS))
@pytest.mark.parametrize("embd", ["attention", "last", "maxpool"])
def test_variational_lstm_encoder2(neutral, embd, lengths):
    """The relu-attention pooling over `lstm_sequence` with lengths (-inf
    past each row's length), and the LSTMEncoder modes: one launch."""
    kw = {} if LENGTHS[lengths] is None else {"lengths": LENGTHS[lengths]}
    check(jax_var.VariationalLSTMEncoder2(I, H, embd),
          var.VariationalLSTMEncoder2(I, H, embd), [_x(B, T, I)], kw, launches=[1])


def test_variational_textcnn(neutral):
    check(jax_var.VariationalTextCNN(I, embd_size=H, out_channels=3, dropout=0.0),
          var.VariationalTextCNN(I, embd_size=H, out_channels=3, dropout=0.0),
          [_x(B, T, I)], launches=[])


def test_linear_vxe(neutral):
    """Train mode normalises by the batch's statistics (the pad-aware
    BatchNorm), eval mode by the running ones."""
    check(jax_var.LinearVXE(8, 6, 3), var.LinearVXE(8, 6, 3), [_x(B, 8)], launches=[])


def test_split_and_sample():
    """The (B, 2, width) view; ε from the run's generator in training and 0
    in eval mode."""
    embd = torch.arange(12.0).reshape(2, 6)
    mu, log_var = var.split_mu_logvar(embd, 3)
    assert mu.tolist() == [[0, 1, 2], [6, 7, 8]] and log_var.tolist() == [[3, 4, 5],
                                                                           [9, 10, 11]]
    model = var.VariationalLSTMEncoder(I, H).train()
    with pytest.raises(RuntimeError, match="torch.Generator"):
        model(torch.from_numpy(_x(B, T, I)))
    use_generator(model, torch.Generator().manual_seed(3))
    x = torch.from_numpy(_x(B, T, I))
    z, mu, log_var = model(x)
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(z, mu + eps * torch.exp(0.5 * log_var))
    z, mu, _ = model.eval()(x)
    assert torch.equal(z, mu)
    with pytest.raises(ValueError, match="embd_method"):
        var.VariationalLSTMEncoder2(I, H, "mean")


REGISTRY = {
    "lstmencodervar": {"input_size": I, "hidden_size": H},
    "lstm_encoder_var": {"input_size": I, "hidden_size": H, "embd_method": "maxpool"},
    "lstmencoder2var": {"input_size": I, "hidden_size": H},
    "textcnnvar": {"input_size": I, "embd_size": H},
    "textcnn_var": {"input_size": I, "embd_size": H, "dropout": 0.1},
    "linearvxe": {"input_dim": 8, "output_dim": 6, "feature_dim": 3},
    "linear_vxe": {"input_dim": 8, "output_dim": 6, "feature_dim": 3},
}


@pytest.mark.parametrize("name", list(REGISTRY))
def test_registry_names_build_mmtpus_classes(name):
    assert type(build_module(name, **REGISTRY[name])).__name__ == type(
        jax_build(name, **REGISTRY[name])).__name__
