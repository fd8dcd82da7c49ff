"""Weights across the two packages, and the port's `.pth` checkpoints.

`from_jax_variables` is mmtpu's torch-interop name mapping
(mmtpu/checkpoints/torch_interop.py: `_NAME_RULES`, `_flax_to_torch_key`,
`_convert`) run in reverse: mmtpu's variables, as numpy arrays, become a
port `state_dict` under the reference's torch key names:

- flax path `layer{S}_{I}` → `layer{S}.{I}`; `downsample_conv` /
  `downsample_bn` → `downsample.0` / `downsample.1`; the MNIST encoders'
  `block_one` / `block_two` → `net.0` / `net.2`, a ConvBlock's `conv_1`,
  `conv_2`, `bn_1`, `bn_2` → `conv_one`, `conv_two`, `batch_norm_one`,
  `batch_norm_two`, and the `fc` beside a `block_one` → `net.5`; `/` → `.`;
- conv kernel HWIO → weight OIHW; Dense kernel (in, out) → Linear weight
  (out, in); BatchNorm and LayerNorm `scale`/`bias` → `weight`/`bias`; an
  Embed table `embedding` → `weight` as it is (BERT's
  `text_encoder/bert/...` tree, whose flax path names — `encoder/layer/{i}`,
  `attention/self`, `LayerNorm` — are the port's `BertModel` names);
- the DenseGeneral projections of flax's multi-head attention (the
  Transformer's `attn/{query,key,value,out}`) → Linear layers over the
  flattened heads: `query`/`key`/`value` kernels (d, heads, head_dim) →
  weight (heads·head_dim, d) and their (heads, head_dim) biases flattened;
  the `out` kernel (heads, head_dim, d) → weight (d, heads·head_dim);
  batch_stats `mean`/`var` → `running_mean`/`running_var`
  (and `num_batches_tracked` = 0, which flax does not keep);
- an MNIST encoder's `fc` reads a flattened conv map: mmtpu flattens it
  NHWC, the port (as the reference) NCHW, so its kernel's input axis is
  permuted once from (H·W·C) to (C·H·W) order. The geometry is the target
  module's `flatten_chw`; without a module target, mmtpu's allowlist of
  known flattens ((64, 7, 7) image, (64, 5, 15) audio) where C·H·W equals
  the kernel's input width, and an error where none does;
- a C-MAM's per-modality encoder `input_encoders_{mod}` → the
  `ModuleDict` entry `input_encoders.{mod}`, its association network `assoc`
  (built from a mapping of kwargs) or `association_network` (given as a
  module or spec: flax names a module by its attribute) → `assoc`; a
  DualCMAM's `input_encoder` (or `input_encoder_{mod}`, from a one-entry
  mapping) → `encoder`, its `decoder_{one,two}_fc_{0,1}` unchanged;
- the raw leaves of a fused `LSTMEncoder`, `wh` (H, 4H) and
  `attention_vector_weight` (H, 1), keep their name and layout. The port
  stores an LSTM under mmtpu's fused names — `wi.weight`, `wi.bias`, `wh`,
  gate order [i, f, g, o], one bias; the reference's `rnn.weight_ih_l0 …`
  keys (two biases, transposed matrices) are mapped onto them by the `.pth`
  reader, `checkpoints/torch_interop.py`;
- an `LSTMEncoder(backend='rnn')` keeps flax's per-gate cell,
  `OptimizedLSTMCell_0/{ii,if,ig,io}/kernel` and `…/{hi,hf,hg,ho}/{kernel,
  bias}`, which the Dense rule above carries to
  `OptimizedLSTMCell_0.{gate}.weight` / `.bias` (`if` is a key of a
  `ModuleDict`, never an attribute); Self-MM's AuViSubNet keeps flax's
  cells `OptimizedLSTMCell_{n}` the same way (flax binds the cell an
  `nn.RNN` is given to the RNN's parent, numbered in creation order), and
  `linear_1`;
- the domain encoders (`DIVEncoder`, `SeqEncoder`) keep flax's cells too,
  `OptimizedLSTMCell_{n}` and `GRUCell_{n}` (`ir`, `iz`, `in` with bias,
  `hr`, `hz` without, `hn` with), by the same rule; SeqEncoder's 1-D
  convolutions `proj_{a,t,v}` (kernel (K, I, O)) → Conv1d weight (O, I, K);
  MulT's `proj_{a,t,v}/conv` (with bias) the same way; GCNet's raw
  `DenseRGCNConv` leaves `w_rel` (R, F, H) and `w_root` (F, H) keep their
  name and layout, and its stacks' cells (`base_rnn`, `grufusion`) and an
  LSTMClassifier's are flax's `OptimizedLSTMCell_{n}` / `GRUCell_{n}`;
  a LanguageEmbeddingLayer's `embed` table and `bert_model/bert/...` tree
  map as BERT's do; the variational encoders' `rnn`, `cnn`, `wi`, `wh`,
  `attention_*`, `enc*`/`dec*` and `enc_bn` by the rules above;
- a MaxOut's `units` kernel (in, units·out) → Linear weight (units·out,
  in): the port reshapes the output (…, units, out) as flax does;
- Kinetics-Sounds (`audio_encoder/conv_block_{one,two,three}`, `fc_one`,
  `fc_two`, `video_encoder`, `fc_out`) and a MonomodalEncoder's `head`
  beside any encoder map by the rules above: the port's KS audio encoder
  flattens NHWC as mmtpu's does, so its `fc_one` is carried unpermuted.

Unlike mmtpu's readers, which keep a leaf's initial value when they find no
source for it, this conversion raises on any leaf it cannot map and — given
the target — on any target tensor left unfilled or misshapen.

The port writes plain `state_dict` `.pth` files (`save_pth`, and the
encoder handoff) and training checkpoints holding one under "model".
Their keys are the reference's layout for the
ResNet, MNIST and AVMNIST families, and mmtpu's fused names for an
LSTMEncoder. `checkpoints/manager.py`'s `load_encoder_checkpoint` reads
them (strictly), the reference's `.pth` and mmtpu's `.ckpt`.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

_NAME_RULES = (
    ("downsample_conv", "downsample.0"),
    ("downsample_bn", "downsample.1"),
)
# the children of an MNIST encoder (a subtree with `block_one` and `fc`) and of
# a ConvBlock (a subtree with `conv_1` and `conv_2`): mmtpu's names → the reference's
_MNIST_CHILDREN = {"block_one": "net.0", "block_two": "net.2", "fc": "net.5"}
_BLOCK_CHILDREN = {"conv_1": "conv_one", "conv_2": "conv_two",
                   "bn_1": "batch_norm_one", "bn_2": "batch_norm_two"}
# mmtpu's known MNIST conv flattens (C, H, W): image 64×7×7, audio 64×5×15
MNIST_FLATTENS = ((64, 7, 7), (64, 5, 15))
_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}
# name → rank, kept as they are: a fused LSTM's, and GCNet's DenseRGCNConv
_RAW_LEAVES = {"wh": 2, "attention_vector_weight": 2, "w_rel": 3, "w_root": 2}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
# the 1-D convolutions (rank-3 kernels): SeqEncoder's `proj_[atv]`, MulT's `proj_[atv]/conv`
_CONV1D = re.compile(r"(.*/)?proj_[atv](/conv)?")


def _child_name(tree: Mapping[str, Any], key: str) -> str:
    if "block_one" in tree and "fc" in tree and key in _MNIST_CHILDREN:
        return _MNIST_CHILDREN[key]
    if "conv_1" in tree and "conv_2" in tree and key in _BLOCK_CHILDREN:
        return _BLOCK_CHILDREN[key]
    name = re.sub(r"layer(\d+)_(\d+)", r"layer\1.\2", key)
    name = re.sub(r"^input_encoders_(\w+)$", r"input_encoders.\1", name)
    if "decoder_one_fc_0" in tree and re.fullmatch(r"input_encoder(_\w+)?", key):
        return "encoder"
    if key == "association_network" and any(k.startswith("input_encoders_") for k in tree):
        return "assoc"
    for ours, theirs in _NAME_RULES:
        name = name.replace(ours, theirs)
    return name


def _module_names(tree: Mapping[str, Any], flax_path: str = "", torch_path: str = ""
                  ) -> Dict[str, str]:
    """flax module path → torch module path, for every subtree of `tree`."""
    out = {flax_path: torch_path}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            name = _child_name(tree, k)
            out.update(_module_names(v, f"{flax_path}/{k}" if flax_path else k,
                                     f"{torch_path}.{name}" if torch_path else name))
    return out


def _merged(a: Mapping[str, Any], b: Mapping[str, Any]) -> Dict[str, Any]:
    """The union of two trees' structure (params and batch_stats)."""
    out = dict(a)
    for k, v in b.items():
        out[k] = _merged(out[k], v) if isinstance(v, Mapping) and isinstance(
            out.get(k), Mapping) else out.get(k, v)
    return out


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


_INVERSE = tuple((re.compile(rf"(^|\.){re.escape(theirs)}(?=\.|$)"), ours)
                 for ours, theirs in sorted({**_MNIST_CHILDREN, **_BLOCK_CHILDREN}.items(),
                                            key=lambda kv: -len(kv[1])))


def mmtpu_module_path(name: str) -> str:
    """The `/`-joined path mmtpu gives the module that the port calls
    `name` (`audio_encoder.layer1.0.downsample.1` →
    `audio_encoder/layer1_0/downsample_bn`; the root "" stays "")."""
    for ours, theirs in _NAME_RULES:
        name = name.replace(theirs, ours)
    for rx, ours in _INVERSE:
        name = rx.sub(rf"\g<1>{ours}", name)
    name = re.sub(r"layer(\d+)\.(\d+)", r"layer\1_\2", name)
    return re.sub(r"(^|\.)input_encoders\.(\w+?)(?=\.|$)", r"\1input_encoders_\2",
                  name).replace(".", "/")


def mmtpu_param_path(name: str, param: torch.Tensor) -> str:
    """The `/`-joined path mmtpu gives the parameter that the port calls
    `name` (`audio_encoder.layer1.0.conv1.weight` →
    `audio_encoder/layer1_0/conv1/kernel`): the inverse of the mapping
    above, so optimizer group regexes written against mmtpu's paths select
    the same parameters in both packages."""
    module, _, leaf = name.rpartition(".")
    prefix = mmtpu_module_path(module)
    if prefix.endswith("_embeddings") and leaf == "weight":  # BERT's nn.Embed tables
        leaf = "embedding"
    elif leaf not in _RAW_LEAVES:
        leaf = {"bias": "bias", "weight": "kernel" if param.dim() > 1 else "scale"}[leaf]
    return f"{prefix}/{leaf}" if prefix else leaf


def _leaves(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix.rstrip("/"), k, v


def _flatten_geometries(target) -> Dict[str, Tuple[int, int, int]]:
    """Torch key prefix of each MNIST encoder's Linear → its (C, H, W)."""
    if not isinstance(target, nn.Module):
        return {}
    out = {}
    for name, module in target.named_modules():
        chw = getattr(module, "flatten_chw", None)
        if chw is not None:
            out[_key(name, _MNIST_CHILDREN["fc"])] = tuple(chw)
    return out


def nhwc_to_nchw_flatten(w: np.ndarray, chw: Tuple[int, int, int]) -> np.ndarray:
    """(out, H·W·C) Linear weight of an NHWC flatten → (out, C·H·W)."""
    c, h, wd = chw
    return w.reshape(w.shape[0], h, wd, c).transpose(0, 3, 1, 2).reshape(w.shape[0], -1)


def from_jax_variables(
    params: Mapping[str, Any],
    batch_stats: Optional[Mapping[str, Any]] = None,
    target: Union[nn.Module, Mapping[str, torch.Tensor], None] = None,
    require_all: bool = True,
) -> "OrderedDict[str, torch.Tensor]":
    """mmtpu variables (nested dicts of numpy arrays) → port state_dict.

    Raises on a leaf with no torch counterpart, on two leaves mapping to
    one key, and, when `target` (a module or its state_dict) is given, on
    extra keys, shape mismatches, and (unless `require_all` is False)
    target keys left unfilled."""
    state: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    names = _module_names(_merged(params, batch_stats or {}))
    geometry = _flatten_geometries(target)

    def put(key: str, value: np.ndarray) -> None:
        if key in state:
            raise ValueError(f"two mmtpu leaves map to torch key {key!r}")
        state[key] = torch.from_numpy(np.ascontiguousarray(value))

    for path, leaf, value in _leaves(params):
        value = np.asarray(value, np.float32)
        if leaf in _RAW_LEAVES:
            if value.ndim != _RAW_LEAVES[leaf]:
                raise ValueError(f"mmtpu param {path}/{leaf} has rank {value.ndim}")
            put(_key(names[path], leaf), value)
            continue
        if leaf not in _PARAM_LEAVES:
            raise ValueError(f"mmtpu param {path}/{leaf} has no torch counterpart")
        if leaf == "kernel":
            if value.ndim == 4:  # conv HWIO → OIHW
                value = value.transpose(3, 2, 0, 1)
            elif value.ndim == 2:  # Dense (in, out) → Linear (out, in)
                value = value.T
            elif value.ndim == 3 and _CONV1D.fullmatch(path):
                value = value.transpose(2, 1, 0)  # 1-D conv (K, I, O) → (O, I, K)
            elif value.ndim == 3 and path.rsplit("/", 1)[-1] == "out":  # (heads, hd, d)
                value = value.reshape(-1, value.shape[-1]).T
            elif value.ndim == 3:  # attention query/key/value (d, heads, hd)
                value = value.reshape(value.shape[0], -1).T
            else:
                raise ValueError(f"mmtpu kernel {path} has rank {value.ndim}")
        elif leaf == "bias" and value.ndim == 2:  # attention (heads, hd)
            value = value.reshape(-1)
        prefix = names[path]
        if leaf == "kernel" and prefix.rsplit(".", 2)[-2:] == ["net", "5"]:
            value = nhwc_to_nchw_flatten(value, _geometry(prefix, value, geometry))
        put(_key(prefix, _PARAM_LEAVES[leaf]), value)

    for path, leaf, value in _leaves(batch_stats or {}):
        if leaf not in _STAT_LEAVES:
            raise ValueError(f"mmtpu batch_stats {path}/{leaf} has no torch counterpart")
        put(_key(names[path], _STAT_LEAVES[leaf]), np.asarray(value, np.float32))
        if leaf == "mean":
            state[_key(names[path], "num_batches_tracked")] = torch.tensor(0, dtype=torch.long)

    if target is not None:
        want = target.state_dict() if isinstance(target, nn.Module) else target
        unfilled = sorted(set(want) - set(state)) if require_all else []
        extra = sorted(set(state) - set(want))
        if unfilled or extra:
            raise ValueError(
                f"from_jax_variables: unfilled target keys {unfilled}, "
                f"keys with no target {extra}"
            )
        for k, v in want.items():
            if k in state and tuple(v.shape) != tuple(state[k].shape):
                raise ValueError(
                    f"from_jax_variables: {k} is {tuple(state[k].shape)}, "
                    f"target wants {tuple(v.shape)}"
                )
    return state


def _geometry(prefix: str, w: np.ndarray, known: Dict[str, Tuple[int, int, int]]):
    """(C, H, W) of the flatten before the Linear at `prefix`: the target's,
    else the one known flatten whose C·H·W is the kernel's input width."""
    if prefix in known:
        chw = known[prefix]
    else:
        fits = [g for g in MNIST_FLATTENS if int(np.prod(g)) == w.shape[1]]
        if len(fits) != 1:
            raise ValueError(f"{prefix}: no known conv flatten of width {w.shape[1]}; "
                             "pass the target module (its `flatten_chw`)")
        chw = fits[0]
    if int(np.prod(chw)) != w.shape[1]:
        raise ValueError(f"{prefix}: flatten {chw} does not give input width {w.shape[1]}")
    return chw


def save_pth(model: nn.Module, path: Union[str, Path]) -> Path:
    """Write the model's state_dict (CPU tensors) to `path` atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = OrderedDict((k, v.detach().cpu()) for k, v in model.state_dict().items())
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(state, tmp)
    tmp.replace(path)
    return path
