"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (counterpart of `mmtpu/ops`).

| kernel | replaces (TPU) | source |
|---|---|---|
| `fused_mlp` | `mmtpu/ops/fused_mlp.py::_pallas_forward` | `csrc/fused_mlp.cu` |

The full-sequence LSTM (`mmtpu/ops/lstm.py::_pallas_lstm`) is not ported yet.
"""

from mmtpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference

KERNELS = ("fused_mlp",)

__all__ = ["fused_mlp", "fused_mlp_reference", "KERNELS"]
