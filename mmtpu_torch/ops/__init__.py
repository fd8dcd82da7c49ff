"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (counterpart of `mmtpu/ops`).

| kernel | replaces (TPU) | source |
|---|---|---|
| `fused_mlp` | `mmtpu/ops/fused_mlp.py::_pallas_forward` | `csrc/fused_mlp.cu` |
| `lstm` (`lstm_sequence`, `lstm_sequence_stacked`) | `mmtpu/ops/lstm.py::_pallas_lstm` | `csrc/lstm.cu` (H ≤ 100), `csrc/lstm_wide.cu` (H > 100: the cluster and grid designs) |

Every function of mmtpu that reaches `pl.pallas_call` has its counterpart here.
Both are also `torch.library` operators (`library.py`: `mmtpu::fused_mlp`,
`mmtpu::lstm`), which a traced serving graph holds.
"""

from mmtpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference
from mmtpu_torch.ops.lstm import (
    lstm_reference,
    lstm_sequence,
    lstm_sequence_stacked,
    lstm_stacked_reference,
)
from mmtpu_torch.ops import library  # registers mmtpu::fused_mlp and mmtpu::lstm

KERNELS = ("fused_mlp", "lstm", "lstm_wide")  # the sources under csrc/

__all__ = [
    "fused_mlp",
    "fused_mlp_reference",
    "lstm_reference",
    "lstm_sequence",
    "lstm_sequence_stacked",
    "lstm_stacked_reference",
    "KERNELS",
]
