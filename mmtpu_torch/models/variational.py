"""Variational encoder variants (counterpart of mmtpu/models/variational.py).

All of them follow the VAE-encoder recipe: the encoder's embedding width is
doubled, split into (mu, log_var) through the `(B, 2, width)` view, and a
latent z = mu + ε · exp(0.5 · log_var) is drawn by reparameterisation. ε
comes from the run's `torch.Generator` (`GeneratorNormal`, `models/rng.py`,
as RedCore's VAE sample does) in training and is 0 in eval mode, so the
sample collapses to the mean.

- `VariationalLSTMEncoder`: the port's `LSTMEncoder` at 2 × hidden as the
  submodule `rnn` (on a CUDA tensor one `lstm` launch of H = 2 × hidden);
  returns (z, mu, log_var).
- `VariationalLSTMEncoder2`: a plain (non-variational) LSTM encoder whose
  attention pooling is relu(W·h) where LSTMEncoder's is tanh. 'last' and
  'maxpool' go through `LSTMEncoder` (`rnn`); 'attention' projects with
  `wi`, runs `lstm_sequence` with the lengths (h and c freeze past each
  row's length) and masks the scores to -inf past it. Returns the pooled
  embedding only.
- `VariationalTextCNN`: the port's `TextCNN` at 2 × embd_size as `cnn`;
  returns (z, mu, log_var).
- `LinearVXE`: in → in/2 (ReLU, the pad-aware BatchNorm `enc_bn`) →
  2 × feature, the latent, feature → out/2 (ReLU) → out; returns
  (reconstruction, mu, log_var).

mmtpu records two quirks of the reference here, and the port keeps mmtpu's
behaviour for both: the reference's variational LSTM encoder applies a
Linear(H, H) attention to 2H-wide outputs (a shape crash), where the
attention here is sized by its input as flax's Dense is; and the
reference's LSTMEncoder2 builds `nn.relu()` (an AttributeError for its own
default 'attention'), where the relu attention works here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mmtpu_torch.models.lstm import LSTMEncoder
from mmtpu_torch.models.norm import BatchNorm
from mmtpu_torch.models.rng import GeneratorNormal
from mmtpu_torch.models.textcnn import TextCNN
from mmtpu_torch.ops.lstm import lstm_sequence


def reparameterize(noise: GeneratorNormal, mu: torch.Tensor,
                   log_var: torch.Tensor) -> torch.Tensor:
    """z = mu + ε · exp(0.5 · log_var); ε from `noise` (0 in eval mode)."""
    return mu + noise(mu) * torch.exp(0.5 * log_var)


def split_mu_logvar(embd: torch.Tensor, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 2·width) → the (B, 2, width) view → (mu, log_var)."""
    x = embd.reshape(-1, 2, width)
    return x[:, 0, :], x[:, 1, :]


class VariationalLSTMEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, embd_method: str = "last") -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.rnn = LSTMEncoder(input_size, 2 * hidden_size, embd_method=embd_method)
        self.sample = GeneratorNormal()

    def get_embedding_size(self) -> int:
        return self.hidden_size

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        mu, log_var = split_mu_logvar(self.rnn(x, lengths), self.hidden_size)
        return reparameterize(self.sample, mu, log_var), mu, log_var


class VariationalLSTMEncoder2(nn.Module):
    def __init__(self, input_size: int, hidden_size: int,
                 embd_method: str = "attention") -> None:
        super().__init__()
        if embd_method not in ("last", "attention", "maxpool"):
            raise ValueError(f"embd_method {embd_method!r} not in ('last', 'attention', "
                             "'maxpool')")
        self.hidden_size = hidden_size
        self.embd_method = embd_method
        if embd_method != "attention":
            self.rnn = LSTMEncoder(input_size, hidden_size, embd_method=embd_method)
            return
        self.wi = nn.Linear(input_size, 4 * hidden_size)
        self.wh = nn.Parameter(torch.empty(hidden_size, 4 * hidden_size))
        nn.init.orthogonal_(self.wh)
        self.attention_layer = nn.Linear(hidden_size, hidden_size)
        self.attention_vector_weight = nn.Parameter(torch.empty(hidden_size, 1))
        nn.init.normal_(self.attention_vector_weight, std=hidden_size ** -0.5)

    def get_embedding_size(self) -> int:
        return self.hidden_size

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.embd_method != "attention":
            return self.rnn(x, lengths)
        outputs, _ = lstm_sequence(
            self.wi(x), self.wh,
            lengths=None if lengths is None else lengths.to(torch.int32))
        hidden = torch.relu(self.attention_layer(outputs))
        scores = (hidden @ self.attention_vector_weight)[..., 0]  # (B, seq)
        if lengths is not None:
            steps = torch.arange(outputs.shape[1], device=outputs.device)
            scores = scores.masked_fill(
                steps[None, :] >= lengths.to(outputs.device)[:, None], float("-inf"))
        weights = torch.softmax(scores, dim=-1)[..., None]
        return (outputs * weights).sum(dim=1)


class VariationalTextCNN(nn.Module):
    def __init__(self, input_size: int, embd_size: int = 128, in_channels: int = 1,
                 out_channels: int = 128, kernel_heights: Sequence[int] = (3, 4, 5),
                 dropout: float = 0.5) -> None:
        super().__init__()
        self.embd_size = embd_size
        self.cnn = TextCNN(input_size, embd_size=2 * embd_size, in_channels=in_channels,
                           out_channels=out_channels, kernel_heights=kernel_heights,
                           dropout=dropout)
        self.sample = GeneratorNormal()

    def get_embedding_size(self) -> int:
        return self.embd_size

    def forward(self, x: torch.Tensor):
        mu, log_var = split_mu_logvar(self.cnn(x), self.embd_size)
        return reparameterize(self.sample, mu, log_var), mu, log_var


class LinearVXE(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, feature_dim: int) -> None:
        super().__init__()
        self.feature_dim = feature_dim
        self.enc1 = nn.Linear(input_dim, input_dim // 2)
        self.enc_bn = BatchNorm(input_dim // 2)
        self.enc2 = nn.Linear(input_dim // 2, 2 * feature_dim)
        self.dec1 = nn.Linear(feature_dim, output_dim // 2)
        self.dec2 = nn.Linear(output_dim // 2, output_dim)
        self.sample = GeneratorNormal()

    def forward(self, x: torch.Tensor):
        h = self.enc2(self.enc_bn(torch.relu(self.enc1(x))))
        mu, log_var = split_mu_logvar(h, self.feature_dim)
        z = reparameterize(self.sample, mu, log_var)
        return self.dec2(torch.relu(self.dec1(z))), mu, log_var
