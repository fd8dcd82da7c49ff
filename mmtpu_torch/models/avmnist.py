"""AVMNIST encoders and late-fusion model (counterpart of `MNISTAudio`,
`MNISTImage`, `AVMNIST` and `MonomodalEncoder`, mmtpu/models/avmnist.py).

`MNISTAudio` / `MNISTImage`: ConvBlock → pool → ConvBlock → pool → flatten
→ Linear(hidden_dim), held as the reference's `nn.Sequential` named `net`
(slots 0-5), so a reference state dict loads under its own keys
(`net.0.conv_one.weight` … `net.5.bias`). The flatten is NCHW, as the
reference's; mmtpu flattens NHWC, so `from_jax_variables` permutes mmtpu's
`fc` kernel once (`flatten_chw`). flax's Dense infers the fc layer's input
width from the input; `nn.Linear` needs it when built, so it is taken from
the dataset's geometry, the AVMNIST reader's `AUDIO_SHAPE` (32, 94) →
64·5·15 = 4800 and `IMAGE_SHAPE` (28, 28) → 64·7·7 = 3136, carried through
the convolutions and pools. An input of another height or width fails at
`net.5`.

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

from typing import Any, Sequence, Tuple

import torch
from torch import nn

from mmtpu_torch.data.avmnist import AUDIO_SHAPE, IMAGE_SHAPE
from mmtpu_torch.models.conv import ConvBlock, _as_args, _pair
from mmtpu_torch.ops import fused_mlp

NUM_CLASSES = 10


class _MNISTEncoder(nn.Module):
    """Two ConvBlocks, each followed by a max pool, flatten, Linear. Takes
    (B, H, W) or NHWC input, as mmtpu's; `input_shape` is the dataset's
    (H, W), which sizes the Linear."""

    def __init__(self, block_args: Sequence[Any], hidden_dim: int, batch_norm: bool,
                 pools: Tuple[Any, Any], input_shape: Sequence[int]) -> None:
        super().__init__()
        args = [_as_args(a) for a in block_args]
        self.hidden_dim = hidden_dim
        blocks = (ConvBlock(args[0], args[1], batch_norm=batch_norm),
                  ConvBlock(args[2], args[3], batch_norm=batch_norm))
        # torch's MaxPool2d with stride = window, floor mode: mmtpu's max_pool
        pools = [_pair(p) for p in pools]
        h, w = (int(n) for n in input_shape)
        for block, pool in zip(blocks, pools):
            h, w = block.out_size(h, w)
            h, w = h // pool[0], w // pool[1]
        self.flatten_chw = (args[3].conv_one_out, h, w)
        self.net = nn.Sequential(blocks[0], nn.MaxPool2d(pools[0], pools[0]),
                                 blocks[1], nn.MaxPool2d(pools[1], pools[1]), nn.Flatten(),
                                 nn.Linear(args[3].conv_one_out * h * w, hidden_dim))

    def get_embedding_size(self) -> int:
        return self.hidden_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:  # (B, H, W)
            x = x.unsqueeze(1)
        elif x.shape[-1] == 1:  # NHWC, one channel: the same memory as NCHW
            x = x.reshape(x.shape[0], 1, x.shape[1], x.shape[2])
        else:
            x = x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
        return self.net(x)


class MNISTAudio(_MNISTEncoder):
    def __init__(self, conv_block_one_one_args, conv_block_one_two_args,
                 conv_block_two_one_args, conv_block_two_two_args, hidden_dim: int,
                 conv_batch_norm: bool = True, max_pool_one_kernel_size=(2, 2),
                 max_pool_two_kernel_size=(3, 3)):
        super().__init__((conv_block_one_one_args, conv_block_one_two_args,
                          conv_block_two_one_args, conv_block_two_two_args), hidden_dim,
                         conv_batch_norm, (max_pool_one_kernel_size, max_pool_two_kernel_size),
                         AUDIO_SHAPE)


class MNISTImage(_MNISTEncoder):
    def __init__(self, conv_block_one_one_args, conv_block_one_two_args,
                 conv_block_two_one_args, conv_block_two_two_args, hidden_dim: int,
                 conv_batch_norm: bool = True, max_pool_kernel_size=(2, 2)):
        super().__init__((conv_block_one_one_args, conv_block_one_two_args,
                          conv_block_two_one_args, conv_block_two_two_args), hidden_dim,
                         conv_batch_norm, (max_pool_kernel_size, max_pool_kernel_size),
                         IMAGE_SHAPE)


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
