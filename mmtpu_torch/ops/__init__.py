"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (counterpart of `mmtpu/ops`).

| kernel | replaces (TPU) | source |
|---|---|---|
| `fused_mlp` | `mmtpu/ops/fused_mlp.py::_pallas_forward` | `csrc/fused_mlp.cu` |
| `lstm` (`lstm_sequence`, `lstm_sequence_stacked`) | `mmtpu/ops/lstm.py::_pallas_lstm` | `csrc/lstm.cu` |

Every function of mmtpu that reaches `pl.pallas_call` has its counterpart here.
"""

from mmtpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference
from mmtpu_torch.ops.lstm import (
    lstm_reference,
    lstm_sequence,
    lstm_sequence_stacked,
    lstm_stacked_reference,
)

KERNELS = ("fused_mlp", "lstm")

__all__ = [
    "fused_mlp",
    "fused_mlp_reference",
    "lstm_reference",
    "lstm_sequence",
    "lstm_sequence_stacked",
    "lstm_stacked_reference",
    "KERNELS",
]
