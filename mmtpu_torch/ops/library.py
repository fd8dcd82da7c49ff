"""Both kernels as `torch.library` operators, so that a traced graph
(`torch.export`, the serving artifact of `serving/export.py`) holds the
kernel itself and not the plain PyTorch it would otherwise be traced into:

- `mmtpu::fused_mlp(Tensor x, Tensor[] weights, Tensor[] biases) -> Tensor`
- `mmtpu::lstm(Tensor[] xw, Tensor[] wh, Tensor? h0, Tensor? c0,
  Tensor? lengths) -> (Tensor, Tensor, Tensor)`

Each has two implementations and no other: on CUDA the kernel's `_launch`
(which counts the launch, as the wrappers' direct calls do), on the CPU the
plain version. A tensor on any other device finds no implementation and
raises. The fake implementations give the output shapes from the inputs',
so a symbolic batch passes through them.

The wrappers `fused_mlp` and `lstm_sequence_stacked` call these operators
for every call that needs no gradient; a call that needs one keeps its
`torch.autograd.Function` (kernel forward, plain recompute backward).

Under `torch.func.vmap` (the stacked engine's members) each operator's vmap
rule folds the member axis into the kernel: `fused_mlp` into one
member-axis launch, `lstm` into its group axis (K members × G groups). On
the CPU the same rules run the plain versions, so the folding is the same
code on either device.
"""

from __future__ import annotations

import importlib
from typing import List, Optional, Tuple

import torch

# the modules (the package's names `fused_mlp` and `lstm` are the wrappers)
_mlp = importlib.import_module("mmtpu_torch.ops.fused_mlp")
_lstm = importlib.import_module("mmtpu_torch.ops.lstm")


@torch.library.custom_op("mmtpu::fused_mlp", mutates_args=(), device_types="cuda")
def fused_mlp_op(x: torch.Tensor, weights: List[torch.Tensor],
                 biases: List[torch.Tensor]) -> torch.Tensor:
    return _mlp._launch(x, weights, biases)


@fused_mlp_op.register_kernel("cpu")
def _fused_mlp_cpu(x, weights, biases):
    return _mlp.fused_mlp_reference(x, weights, biases)


@fused_mlp_op.register_fake
def _fused_mlp_fake(x, weights, biases):
    return x.new_empty((x.shape[0], weights[-1].shape[0]))


@fused_mlp_op.register_vmap
def _fused_mlp_vmap(info, in_dims, x, weights, biases):
    """K members' chains in ONE member-axis launch (the plain batched chain
    on the CPU)."""
    x_dim, w_dims, b_dims = in_dims
    n = len(weights)
    folded = _mlp.fold_members(info.batch_size, [x_dim, *w_dims, *b_dims],
                               [x, *weights, *biases])
    return _mlp.fused_mlp_members(folded[0], folded[1:1 + n], folded[1 + n:]), 0


@torch.library.custom_op("mmtpu::lstm", mutates_args=(), device_types="cuda")
def lstm_op(xw: List[torch.Tensor], wh: List[torch.Tensor], h0: Optional[torch.Tensor],
            c0: Optional[torch.Tensor], lengths: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _lstm._launch(xw, wh, h0, c0, lengths)


@lstm_op.register_kernel("cpu")
def _lstm_cpu(xw, wh, h0, c0, lengths):
    out, (h, c) = _lstm.lstm_stacked_reference(xw, wh, h0, c0, lengths)
    # with T = 0 the final state is the initial one: an operator's outputs
    # may not alias its inputs
    return out, (h.clone() if h is h0 else h), (c.clone() if c is c0 else c)


@lstm_op.register_vmap
def _lstm_vmap(info, in_dims, xw, wh, h0, c0, lengths):
    """K members' G groups as ONE call of K·G groups (one launch per
    `MAX_GROUPS` on CUDA, the plain scan on the CPU)."""
    K, G = info.batch_size, len(xw)
    xw_dims, wh_dims, h_dim, c_dim, l_dim = in_dims
    xws, whs, h0, c0, lengths = _lstm.fold_groups(
        K, G, [*xw_dims, *wh_dims, h_dim, c_dim, l_dim], xw, wh, h0, c0, lengths)
    out, h, c = torch.ops.mmtpu.lstm(xws, whs, h0, c0, lengths)
    return (_lstm._unfold(K, out), _lstm._unfold(K, h), _lstm._unfold(K, c)), (0, 0, 0)


@lstm_op.register_fake
def _lstm_fake(xw, wh, h0, c0, lengths):
    first = xw[0]
    G, (B, T, H4) = len(xw), first.shape
    H = H4 // 4
    return (first.new_empty((G, B, T, H)), first.new_empty((G, B, H)),
            first.new_empty((G, B, H)))
