"""Checkpoints of the port: `.pth` state_dicts under the reference's key
names, the carry of mmtpu variables into them, and the readers of the
reference's `.pth` and mmtpu's `.ckpt` files."""

from mmtpu_torch.checkpoints.interop import (
    from_jax_variables,
    mmtpu_module_path,
    mmtpu_param_path,
    save_pth,
)
from mmtpu_torch.checkpoints.manager import (
    adapt_lstm_layout,
    load_encoder_checkpoint,
    resolve_checkpoint_path,
)
from mmtpu_torch.checkpoints.torch_interop import LoadReport

__all__ = [
    "LoadReport",
    "adapt_lstm_layout",
    "from_jax_variables",
    "load_encoder_checkpoint",
    "mmtpu_module_path",
    "mmtpu_param_path",
    "resolve_checkpoint_path",
    "save_pth",
]
