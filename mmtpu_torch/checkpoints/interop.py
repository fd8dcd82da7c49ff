"""Weights across the two packages, and the port's `.pth` checkpoints.

`from_jax_variables` is mmtpu's torch-interop name mapping
(mmtpu/checkpoints/torch_interop.py: `_NAME_RULES`, `_flax_to_torch_key`,
`_convert`) run in reverse: mmtpu's variables, as numpy arrays, become a
port `state_dict` under the reference's torch key names:

- flax path `layer{S}_{I}` → `layer{S}.{I}`; `downsample_conv` /
  `downsample_bn` → `downsample.0` / `downsample.1`; `/` → `.`;
- conv kernel HWIO → weight OIHW; Dense kernel (in, out) → Linear weight
  (out, in); BatchNorm `scale`/`bias` → `weight`/`bias`;
  batch_stats `mean`/`var` → `running_mean`/`running_var`
  (and `num_batches_tracked` = 0, which flax does not keep);
- the raw leaves of a fused `LSTMEncoder`, `wh` (H, 4H) and
  `attention_vector_weight` (H, 1), keep their name and layout. The port
  stores an LSTM under mmtpu's fused names — `wi.weight`, `wi.bias`, `wh`,
  gate order [i, f, g, o], one bias — and not under the reference's
  `rnn.weight_ih_l0 …` keys, which hold two biases and transposed,
  [i, f, g, o]-by-rows matrices.

Unlike mmtpu's reader, which keeps a leaf's initial value when it finds no
source for it, this conversion raises on any leaf it cannot map and — given
the target — on any target tensor left unfilled or misshapen.

The port writes plain `state_dict` `.pth` files (`save_pth`, and the
encoder handoff) and training checkpoints holding one under "model";
`load_pth` reads both. For the ResNet
and AVMNIST families their keys are the layout mmtpu's
`load_torch_checkpoint` reads; an LSTMEncoder's are mmtpu's fused names
(above), which that reader does not take.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

_NAME_RULES = (
    ("downsample_conv", "downsample.0"),
    ("downsample_bn", "downsample.1"),
)
_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_RAW_LEAVES = {"wh": 2, "attention_vector_weight": 2}  # name → rank, kept as they are
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _torch_prefix(flax_path: str) -> str:
    path = re.sub(r"layer(\d+)_(\d+)", r"layer\1.\2", flax_path)
    for ours, theirs in _NAME_RULES:
        path = path.replace(ours, theirs)
    return path.replace("/", ".")


def _key(flax_path: str, name: str) -> str:
    prefix = _torch_prefix(flax_path)
    return f"{prefix}.{name}" if prefix else name


def mmtpu_param_path(name: str, param: torch.Tensor) -> str:
    """The `/`-joined path mmtpu gives the parameter that the port calls
    `name` (`audio_encoder.layer1.0.conv1.weight` →
    `audio_encoder/layer1_0/conv1/kernel`): the inverse of the mapping
    above, so optimizer group regexes written against mmtpu's paths select
    the same parameters in both packages."""
    prefix, _, leaf = name.rpartition(".")
    for ours, theirs in _NAME_RULES:
        prefix = prefix.replace(theirs, ours)
    prefix = re.sub(r"layer(\d+)\.(\d+)", r"layer\1_\2", prefix).replace(".", "/")
    if leaf not in _RAW_LEAVES:
        leaf = {"bias": "bias", "weight": "kernel" if param.dim() > 1 else "scale"}[leaf]
    return f"{prefix}/{leaf}" if prefix else leaf


def _leaves(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix.rstrip("/"), k, v


def from_jax_variables(
    params: Mapping[str, Any],
    batch_stats: Optional[Mapping[str, Any]] = None,
    target: Union[nn.Module, Mapping[str, torch.Tensor], None] = None,
) -> "OrderedDict[str, torch.Tensor]":
    """mmtpu variables (nested dicts of numpy arrays) → port state_dict.

    Raises on a leaf with no torch counterpart, on two leaves mapping to
    one key, and, when `target` (a module or its state_dict) is given, on
    target keys left unfilled, extra keys, or shape mismatches."""
    state: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def put(key: str, value: np.ndarray) -> None:
        if key in state:
            raise ValueError(f"two mmtpu leaves map to torch key {key!r}")
        state[key] = torch.from_numpy(np.ascontiguousarray(value))

    for path, leaf, value in _leaves(params):
        value = np.asarray(value, np.float32)
        if leaf in _RAW_LEAVES:
            if value.ndim != _RAW_LEAVES[leaf]:
                raise ValueError(f"mmtpu param {path}/{leaf} has rank {value.ndim}")
            put(_key(path, leaf), value)
            continue
        if leaf not in _PARAM_LEAVES:
            raise ValueError(f"mmtpu param {path}/{leaf} has no torch counterpart")
        if leaf == "kernel":
            if value.ndim == 4:  # conv HWIO → OIHW
                value = value.transpose(3, 2, 0, 1)
            elif value.ndim == 2:  # Dense (in, out) → Linear (out, in)
                value = value.T
            else:
                raise ValueError(f"mmtpu kernel {path} has rank {value.ndim}")
        put(_key(path, _PARAM_LEAVES[leaf]), value)

    for path, leaf, value in _leaves(batch_stats or {}):
        if leaf not in _STAT_LEAVES:
            raise ValueError(f"mmtpu batch_stats {path}/{leaf} has no torch counterpart")
        put(_key(path, _STAT_LEAVES[leaf]), np.asarray(value, np.float32))
        if leaf == "mean":
            state[_key(path, "num_batches_tracked")] = torch.tensor(0, dtype=torch.long)

    if target is not None:
        want = target.state_dict() if isinstance(target, nn.Module) else target
        unfilled = sorted(set(want) - set(state))
        extra = sorted(set(state) - set(want))
        if unfilled or extra:
            raise ValueError(
                f"from_jax_variables: unfilled target keys {unfilled}, "
                f"keys with no target {extra}"
            )
        for k, v in want.items():
            if tuple(v.shape) != tuple(state[k].shape):
                raise ValueError(
                    f"from_jax_variables: {k} is {tuple(state[k].shape)}, "
                    f"target wants {tuple(v.shape)}"
                )
    return state


def save_pth(model: nn.Module, path: Union[str, Path]) -> Path:
    """Write the model's state_dict (CPU tensors) to `path` atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = OrderedDict((k, v.detach().cpu()) for k, v in model.state_dict().items())
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(state, tmp)
    tmp.replace(path)
    return path


def load_pth(model: nn.Module, path: Union[str, Path]) -> nn.Module:
    """Load a `.pth` into `model` (strict). Takes both layouts the port
    writes: a plain state_dict, and a training checkpoint that holds it
    under "model" (`best.pth`, `epoch_N.pth`, `last.pth`, see
    `checkpoints/manager.py`). `weights_only=True`: tensors and plain
    containers only, never arbitrary objects."""
    state: Dict[str, Any] = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(state.get("model"), Mapping):
        state = state["model"]
    model.load_state_dict(state, strict=True)
    return model
