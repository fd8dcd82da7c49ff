"""AVMNIST late-fusion model (counterpart of `AVMNIST` and
`MonomodalEncoder`, mmtpu/models/avmnist.py).

concat(audio_embd, image_embd) → Linear(hidden) → ReLU → Dropout →
Linear(hidden/2) → ReLU → Linear(10). The head keeps the reference's key
names (`fc_fusion`, `fc_intermediate`, `fc_out`). In eval mode on a CUDA
tensor the whole head runs as ONE kernel (`mmtpu_torch.ops.fused_mlp`),
as mmtpu runs it as one Pallas kernel on the TPU; in train mode, or on the
CPU, it runs the plain chain. `encode` gives the two embeddings (the
`embeddings` split's export). (mmtpu's embedding inputs and `fused_head`
switch serve the C-MAM path, which is not ported yet.)
"""

from __future__ import annotations

import torch
from torch import nn

from mmtpu_torch.ops import fused_mlp

NUM_CLASSES = 10


class AVMNIST(nn.Module):
    """Late-fusion audio+image classifier."""

    def __init__(
        self,
        audio_encoder: nn.Module,
        image_encoder: nn.Module,
        hidden_dim: int,
        dropout: float = 0.0,
        fusion_fn: str = "concat",
    ) -> None:
        super().__init__()
        if fusion_fn.lower() != "concat":
            raise ValueError(f"Unknown fusion function: {fusion_fn}")
        self.audio_encoder = audio_encoder
        self.image_encoder = image_encoder
        fused_dim = audio_encoder.hidden_dim + image_encoder.hidden_dim
        self.fc_fusion = nn.Linear(fused_dim, hidden_dim)
        self.dropout = nn.Dropout(dropout)
        self.fc_intermediate = nn.Linear(hidden_dim, hidden_dim // 2)
        self.fc_out = nn.Linear(hidden_dim // 2, NUM_CLASSES)

    def forward(self, A: torch.Tensor, I: torch.Tensor) -> torch.Tensor:  # noqa: E741
        fused = torch.cat([self.audio_encoder(A), self.image_encoder(I)], dim=1)
        if not self.training and fused.is_cuda:
            layers = (self.fc_fusion, self.fc_intermediate, self.fc_out)
            return fused_mlp(
                fused.contiguous(),
                [layer.weight for layer in layers],
                [layer.bias for layer in layers],
            )
        x = self.dropout(torch.relu(self.fc_fusion(fused)))
        x = torch.relu(self.fc_intermediate(x))
        return self.fc_out(x)

    def encode(self, A: torch.Tensor, I: torch.Tensor):  # noqa: E741
        """Per-modality embeddings (audio, image), in the module's current
        mode (mmtpu's `encode`, the reference's `get_embeddings`)."""
        return self.audio_encoder(A), self.image_encoder(I)


class MonomodalEncoder(nn.Module):
    """Encoder + linear head for monomodal pretraining. `output_dim` is
    accepted for config compatibility; the head's input is the encoder's
    hidden_dim, as in mmtpu."""

    def __init__(self, encoder: nn.Module, output_dim: int, num_classes: int) -> None:
        super().__init__()
        self.encoder = encoder
        self.head = nn.Linear(encoder.hidden_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.encoder(x))
