"""The reader of the reference's PyTorch `.pth` files (counterpart of
`mmtpu/checkpoints/torch_interop.py`).

The reference and the port are both PyTorch, and the port keeps the
reference's key names for the ResNet, MNIST and AVMNIST families, so a key
the two share loads as it is: no OIHW/HWIO transpose and no flatten
permutation (the reference flattens NCHW, as the port's MNIST encoders do).
What `fill_from_state` still maps is mmtpu's set, carried to the port's
layout:

- `nn.LSTM` weights into the port's fused `LSTMEncoder`: `wi.weight` (4H, I)
  ← `rnn.weight_ih_l0`, `wh` (H, 4H) ← `rnn.weight_hh_l0` transposed, and
  the one bias `wi.bias` ← `rnn.bias_ih_l0 + rnn.bias_hh_l0`; both use gate
  order [i, f, g, o];
- `attention_layer` ← the reference's `attention_layer.0`
  (`Sequential(Linear, Tanh)`);
- a tensor left unmatched ← the one unused source tensor of its shape, if
  exactly one (logged: verify the layer is the intended one); several
  candidates among bidirectional or multi-layer LSTM weights (`_reverse`,
  `_l1`) raise, since keeping the initial value would make a "pretrained"
  model train from scratch;
- otherwise the tensor keeps its initial value, with a warning, as mmtpu
  keeps the leaf's: the same config then trains the same model in both
  packages. The report lists those tensors (`LoadReport.kept`). A missing
  `num_batches_tracked`, which flax does not have, is kept silently.

`read_object` reads the file (mmtpu's `_load_state_dict`):
`torch.load(weights_only=True)` first; a file that needs full unpickling
is refused unless `trusted` (full unpickling runs arbitrary code), and
then falls back to a stub-module unpickler for the reference's own classes
(`config.*`, `models.*`, `modalities`, …), with `WindowsPath` read as
`PurePosixPath`. `as_state_dict` unwraps `model_state_dict` and
`state_dict`, strips a `module.` prefix, and takes the parameters and
persistent buffers of a whole pickled module (mmtpu's reader walks only
dicts and finds no tensors in one; ROADMAP §3). The port's own files do not
come here: `checkpoints/manager.py` loads them strictly.

A reference LeNet `.pth` is read as the port's LeNet layout: the port's
LeNet flattens NHWC (as mmtpu's), and a state dict does not say which
package wrote it, so its `fc1` is not permuted (mmtpu permutes a (16, 5, 5)
flatten).
"""

from __future__ import annotations

import dataclasses
import logging
import re
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn

logger = logging.getLogger(__name__)

STUB_ROOTS = ("config", "models", "experiment_utils", "data", "modalities", "federated",
              "metrics")
_NAME_RULES = (("attention_layer.", "attention_layer.0."),)
_WI = re.compile(r"^(.*?)wi\.(weight|bias)$")
_AMBIGUOUS = ("_reverse", "_l1")


@dataclasses.dataclass
class LoadReport:
    """What a load did: the file, its format, the target tensors filled by
    the unique-shape fallback (target key → source key), and those that
    kept their initial value."""

    path: str
    format: str
    fallback: Dict[str, str] = dataclasses.field(default_factory=dict)
    kept: List[str] = dataclasses.field(default_factory=list)


class _Stub(dict):
    """Inert placeholder for the reference's classes. A dict subclass, so
    dict-based reference types (its LossFunctionGroup) reconstruct."""

    def __init__(self, *a, **k):
        super().__init__()

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)

    def append(self, *a):  # list-like reconstruction
        pass


def _load_with_stub_modules(path: Path):
    import pathlib
    import sys
    import types

    class StubModule(types.ModuleType):
        def __getattr__(self, name):
            if name.startswith("__"):
                raise AttributeError(name)
            # Modality instances appear as dict keys in the reference's pickles
            if name in ("Modality", "add_modality"):
                from mmtpu_torch import modalities

                return getattr(modalities, name)
            return type(name, (_Stub,), {"__module__": self.__name__})

    installed = []
    windows_path = pathlib.WindowsPath
    pathlib.WindowsPath = pathlib.PurePosixPath  # files saved on Windows
    try:
        while True:
            try:
                return torch.load(str(path), map_location="cpu", weights_only=False)
            except ModuleNotFoundError as e:
                name = str(e).split("'")[1]
                if name.split(".")[0] not in STUB_ROOTS or name in sys.modules:
                    raise
                parts = name.split(".")
                for i in range(1, len(parts) + 1):
                    prefix = ".".join(parts[:i])
                    if prefix not in sys.modules:
                        sys.modules[prefix] = StubModule(prefix)
                        installed.append(prefix)
    finally:
        pathlib.WindowsPath = windows_path
        for name in installed:
            sys.modules.pop(name, None)


def _module_tensors(obj: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Parameters and persistent buffers of a pickled module (a real
    `nn.Module` or a stub of a reference class), by state-dict key."""
    d = getattr(obj, "__dict__", {})
    out = {}
    for k, v in (d.get("_parameters") or {}).items():
        if v is not None:
            out[prefix + k] = v
    skip = d.get("_non_persistent_buffers_set") or set()
    for k, v in (d.get("_buffers") or {}).items():
        if v is not None and k not in skip:
            out[prefix + k] = v
    for k, m in (d.get("_modules") or {}).items():
        if m is not None:
            out.update(_module_tensors(m, f"{prefix}{k}."))
    return out


def read_object(path: Union[str, Path], trusted: bool = True) -> Tuple[Any, bool]:
    """The unpickled contents of a torch file (see the module docstring),
    and whether they loaded with `weights_only`."""
    try:
        return torch.load(str(path), map_location="cpu", weights_only=True), True
    except Exception:
        if not trusted:
            raise ValueError(
                f"{path} is not a plain-tensor checkpoint and trusted=False. Full "
                "unpickling of arbitrary classes is arbitrary code execution; pass "
                "trusted=True only for files you trust.") from None
    logger.warning(f"torch-interop: {path} needs full (unsafe) unpickling; treating it as "
                   "trusted because it was named in the experiment config")
    try:
        return torch.load(str(path), map_location="cpu", weights_only=False), False
    except ModuleNotFoundError:
        return _load_with_stub_modules(Path(path)), False


def as_state_dict(obj: Any) -> Dict[str, torch.Tensor]:
    """The tensors of an unpickled checkpoint by key: `model_state_dict` and
    `state_dict` unwrapped, a whole module's parameters and buffers, the
    `module.` prefix stripped."""
    for key in ("model_state_dict", "state_dict"):
        if isinstance(obj, Mapping) and key in obj and not isinstance(obj[key], torch.Tensor):
            obj = obj[key]
            break
    if not isinstance(obj, Mapping) or "_modules" in getattr(obj, "__dict__", {}):
        obj = _module_tensors(obj)
    return {k.removeprefix("module."): v.detach().cpu() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def _lstm_lookup(state: Mapping[str, torch.Tensor], key: str
                 ) -> Optional[Tuple[torch.Tensor, List[str]]]:
    """nn.LSTM layer-0 weights for a fused LSTMEncoder tensor: (value,
    source keys consumed), or None."""
    if key == "wh" or key.endswith(".wh"):
        src = f"{key[:-2]}rnn.weight_hh_l0"
        if src in state:
            return state[src].t().contiguous(), [src]
        return None
    m = _WI.match(key)
    if m is None or (m.group(1) and not m.group(1).endswith(".")):
        return None
    enc = m.group(1)
    if m.group(2) == "weight":
        src = f"{enc}rnn.weight_ih_l0"
        return (state[src], [src]) if src in state else None
    ih, hh = f"{enc}rnn.bias_ih_l0", f"{enc}rnn.bias_hh_l0"
    if ih in state and hh in state:
        return state[ih] + state[hh], [ih, hh]
    return None


def fill_from_state(target: nn.Module, state: Mapping[str, torch.Tensor],
                    report: LoadReport) -> nn.Module:
    """Fill `target` from a reference state dict (see the module docstring);
    records the fallbacks and the kept tensors in `report`."""
    want = target.state_dict()
    out: Dict[str, torch.Tensor] = {}
    used: set = set()
    unresolved = []
    for key, ref in want.items():
        hit = _lstm_lookup(state, key)
        if hit is None:
            candidates = [key] + [key.replace(a, b, 1) for a, b in _NAME_RULES if a in key]
            src = next((c for c in candidates if c in state), None)
            hit = (state[src], [src]) if src is not None else None
        if hit is None:
            unresolved.append(key)
            continue
        value, consumed = hit
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"torch-interop: {consumed[0]} is {tuple(value.shape)}, "
                             f"{key} wants {tuple(ref.shape)}")
        out[key] = value
        used.update(consumed)
    for key in unresolved:
        if key.endswith("num_batches_tracked"):
            continue
        ref = want[key]
        matches = [k for k, v in state.items()
                   if k not in used and tuple(v.shape) == tuple(ref.shape)]
        if len(matches) == 1:
            out[key] = state[matches[0]]
            used.add(matches[0])
            report.fallback[key] = matches[0]
            logger.info(f"torch-interop: shape-based fallback mapped torch key {matches[0]!r} "
                        f"-> {key} shape {tuple(ref.shape)} (verify the layer is "
                        "semantically the intended one)")
            continue
        if len(matches) > 1 and any(a in k for k in matches for a in _AMBIGUOUS):
            raise ValueError(
                "torch-interop: cannot disambiguate multi-layer/bidirectional LSTM weights "
                f"for {key} shape {tuple(ref.shape)}: candidates {matches}. Convert this "
                "checkpoint explicitly (the automatic mapping covers unidirectional "
                "layer-0 LSTMs only).")
        report.kept.append(key)
        logger.warning(f"torch-interop: no unique source for {key} shape {tuple(ref.shape)} "
                       f"({len(matches)} candidates: {matches}); keeping initialized value")
    unused = sorted(k for k in state if k not in used)
    if unused:
        logger.warning(f"torch-interop: {len(unused)} tensors of the file fill nothing: "
                       f"{unused}")
    with torch.no_grad():  # state_dict() tensors share the module's storage
        for key, value in out.items():
            want[key].copy_(value)
    return target

