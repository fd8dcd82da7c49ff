"""Kinetics-Sounds audio/video fusion (counterpart of
mmtpu/models/kinetics_sounds.py).

- `KineticsSoundsAudioEncoder`: three ConvBlocks (`models/conv.py`), each
  followed by a torch-semantics average pool ((2, 2), (4, 4), (4, 8) by
  default); the map flattened in mmtpu's NHWC order, cropped or zero-padded
  to `fc_one_input_size`; ReLU, dropout, `fc_one`, ReLU, dropout, `fc_two`.
  Takes (B, H, W) or NHWC input, as mmtpu's.
- `KineticsSoundsVideoEncoder`: the 400-d features through `fc_one`, ReLU,
  dropout, `fc_two`, ReLU.
- `KineticsSounds`: concat(audio, video) → `fc_one` → ReLU → dropout →
  `fc_two` → ReLU → `fc_out` (26 classes). A plain head: no kernel runs on
  this model, as none does in mmtpu. An absent modality becomes a zero
  embedding of its encoder's `get_embedding_size()`; `is_embd_A` /
  `is_embd_V` take an input as the modality's embedding (the C-MAM path).

flax's Dense takes its input width from the input; `nn.Linear` is given it:
`fc_one_input_size` in the encoders, the sum of the two embedding sizes in
the fusion. The dropouts draw from the run's generator (`models/rng.py`).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from mmtpu_torch.models.conv import avg_pool
from mmtpu_torch.models.rng import GeneratorDropout

NUM_CLASSES = 26


class KineticsSoundsAudioEncoder(nn.Module):
    def __init__(self, conv_block_one: nn.Module, conv_block_two: nn.Module,
                 conv_block_three: nn.Module, kernel_size_one: Any = (2, 2),
                 kernel_size_two: Any = (4, 4), kernel_size_three: Any = (4, 8),
                 dropout_one: float = 0.554, dropout_two: float = 0.336,
                 fc_one_input_size: int = 512, fc_one_output_size: int = 64,
                 fc_two_output_size: int = 64) -> None:
        super().__init__()
        self.conv_block_one = conv_block_one
        self.conv_block_two = conv_block_two
        self.conv_block_three = conv_block_three
        self.pools = (kernel_size_one, kernel_size_two, kernel_size_three)
        self.fc_one_input_size = fc_one_input_size
        self.fc_two_output_size = fc_two_output_size
        self.dropout_one = GeneratorDropout(dropout_one)
        self.fc_one = nn.Linear(fc_one_input_size, fc_one_output_size)
        self.dropout_two = GeneratorDropout(dropout_two)
        self.fc_two = nn.Linear(fc_one_output_size, fc_two_output_size)

    def get_embedding_size(self) -> int:
        return self.fc_two_output_size

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        if audio.dim() == 3:  # (B, H, W)
            x = audio.unsqueeze(1)
        else:  # NHWC
            x = audio.permute(0, 3, 1, 2).contiguous()
        for block, pool in zip((self.conv_block_one, self.conv_block_two,
                                self.conv_block_three), self.pools):
            x = avg_pool(block(x), pool)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # mmtpu's NHWC flatten
        n = self.fc_one_input_size
        if x.shape[1] > n:
            x = x[:, :n]
        elif x.shape[1] < n:
            x = nn.functional.pad(x, (0, n - x.shape[1]))
        x = self.fc_one(self.dropout_one(torch.relu(x)))
        return self.fc_two(self.dropout_two(torch.relu(x)))


class KineticsSoundsVideoEncoder(nn.Module):
    def __init__(self, fc_one_input_size: int = 400, hidden_dim_one: int = 256,
                 hidden_dim_two: int = 128, dropout: float = 0.56) -> None:
        super().__init__()
        self.hidden_dim_two = hidden_dim_two
        self.fc_one = nn.Linear(fc_one_input_size, hidden_dim_one)
        self.dropout = GeneratorDropout(dropout)
        self.fc_two = nn.Linear(hidden_dim_one, hidden_dim_two)

    def get_embedding_size(self) -> int:
        return self.hidden_dim_two

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        x = self.dropout(torch.relu(self.fc_one(video)))
        return torch.relu(self.fc_two(x))


class KineticsSounds(nn.Module):
    def __init__(self, audio_encoder: nn.Module, video_encoder: nn.Module,
                 hidden_dim_one: int, hidden_dim_two: int, dropout: float = 0.38) -> None:
        super().__init__()
        self.audio_encoder = audio_encoder
        self.video_encoder = video_encoder
        fused = audio_encoder.get_embedding_size() + video_encoder.get_embedding_size()
        self.fc_one = nn.Linear(fused, hidden_dim_one)
        self.dropout = GeneratorDropout(dropout)
        self.fc_two = nn.Linear(hidden_dim_one, hidden_dim_two)
        self.fc_out = nn.Linear(hidden_dim_two, NUM_CLASSES)

    def forward(self, A: Optional[torch.Tensor] = None, V: Optional[torch.Tensor] = None,
                *, is_embd_A: bool = False, is_embd_V: bool = False) -> torch.Tensor:
        if A is None and V is None:
            raise ValueError("KineticsSounds needs A or V")
        if is_embd_A and is_embd_V:
            raise ValueError("KineticsSounds: at most one input may be an embedding")
        # the reference substitutes a zero embedding for an absent modality:
        # meaningful with is_embd_X (the C-MAM path); otherwise the encoder
        # sees the embedding-shaped zeros and fails, as in mmtpu
        if A is None:
            A = V.new_zeros((V.shape[0], self.audio_encoder.get_embedding_size()))
        if V is None:
            V = A.new_zeros((A.shape[0], self.video_encoder.get_embedding_size()))
        audio = A if is_embd_A else self.audio_encoder(A)
        video = V if is_embd_V else self.video_encoder(V)
        x = self.dropout(torch.relu(self.fc_one(torch.cat([audio, video], dim=1))))
        return self.fc_out(torch.relu(self.fc_two(x)))

    def encode(self, A: torch.Tensor, V: torch.Tensor):
        """Per-modality embeddings (audio, video), in the module's current mode."""
        return self.audio_encoder(A), self.video_encoder(V)
