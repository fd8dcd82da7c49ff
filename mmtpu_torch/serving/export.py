"""Inference export of the port: `torch.export` artifacts and in-process
predictors (counterpart of mmtpu/serving/export.py).

The artifact is one file:

    MMTPU-TORCH-SERVE-1\\n | uint64 meta-length (little-endian) | meta JSON | blob

where `blob` is what `torch.export.save` writes for the traced eval
forward, the trained weights inside it, and `meta` records the input
signature, the output names and the task's flags needed to call it blind:
mmtpu's keys, with `torch_version` and `device` (where the model was) in
place of `jax_version` and `platforms`. The batch dimension is symbolic
(`torch.export.Dim`), so one export answers at any batch size. The graph is
traced on the CPU and its weights are stored there; `load_artifact` moves
the program to the device it is given, so one file serves on the card and
on the CPU.

The kernels stay in the artifact: every call of `fused_mlp` or
`lstm_sequence_stacked` that needs no gradient goes through the operators
`mmtpu::fused_mlp` / `mmtpu::lstm` (`ops/library.py`), and a traced graph
holds those nodes. On the card they launch the hand-written kernels (counted
as any other launch), on the CPU they run their plain versions. mmtpu traces
its export through plain XLA instead (`mmtpu.ops.xla_only`).

mmtpu's own artifact (`MMTPU-SERVE-1\\n`, StableHLO) cannot be read here:
`load_artifact` refuses it with a `ValueError` that says so.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import struct
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mmtpu_torch.train.step import ClassificationTask

MAGIC = b"MMTPU-TORCH-SERVE-1\n"
FORMAT = "mmtpu-torch-serve-1"
JAX_MAGIC = b"MMTPU-SERVE-1\n"  # mmtpu's StableHLO artifact


def _classify(task: ClassificationTask, *inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The eval forward over positional inputs in `task.input_keys` order."""
    logits = task.apply(dict(zip(task.input_keys, inputs)), train=False)
    return {"logits": logits, "preds": task.predictions(logits),
            "probs": task.probabilities(logits)}


def make_serving_fn(task: ClassificationTask, device: torch.device) -> Callable[..., Dict[str, torch.Tensor]]:
    """Inference closure: positional modality tensors (in `task.input_keys`
    order) → {"logits", "preds", "probs"}: softmax probabilities, or the
    per-label sigmoids of a multilabel task. Eval-mode forward (dropout off,
    BN running statistics); a zeroed input is exactly what the training-time
    mask multiply produces for a missing modality."""

    @torch.inference_mode()
    def fn(*inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        return _classify(task, *(x.to(device) for x in inputs))

    return fn


def _resolve_inputs(input_keys: Sequence[str], args, kwargs):
    """Positional-XOR-keyword input resolution shared by Predictor and
    ServedModel."""
    inputs = list(args)
    if kwargs:
        if inputs:
            raise TypeError("pass inputs positionally OR by keyword")
        try:
            inputs = [kwargs[k] for k in input_keys]
        except KeyError as e:
            raise KeyError(f"missing input {e}; expected {tuple(input_keys)}") from None
    return [torch.as_tensor(np.asarray(x)) for x in inputs]


@dataclasses.dataclass
class Predictor:
    """In-process predictor with host-side (numpy) outputs.

    predict(audio=..., image=...) or predict(audio=..., video=..., text=...)
    → dict of numpy arrays. Keyword names are the task's input_keys;
    positional calls follow the same order."""

    task: ClassificationTask
    device: torch.device

    def __post_init__(self) -> None:
        self.task.model.to(self.device).eval()
        self._fn = make_serving_fn(self.task, self.device)

    @property
    def input_keys(self) -> Sequence[str]:
        return tuple(str(k) for k in self.task.input_keys)

    def __call__(self, *args, **kwargs) -> Dict[str, np.ndarray]:
        out = self._fn(*_resolve_inputs(self.input_keys, args, kwargs))
        return {k: v.cpu().numpy() for k, v in out.items()}


class _Serving(nn.Module):
    """The module `torch.export` traces: a serving closure over positional
    inputs, holding the modules it reads, so that their weights are the
    program's parameters and buffers."""

    def __init__(self, fn: Callable[..., Dict[str, torch.Tensor]],
                 modules: Mapping[str, nn.Module]) -> None:
        super().__init__()
        self.held = nn.ModuleDict(dict(modules))
        self._fn = fn

    def forward(self, *inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._fn(*inputs)


def _example_inputs(input_keys, example_batch):
    """The example tensors on the CPU, their dynamic shapes (a symbolic
    batch) and the meta's shapes and dtypes (`"b"` for the batch)."""
    batch = torch.export.Dim("b", min=1)
    tensors, dynamic, shapes, dtypes = [], [], [], []
    for key in input_keys:
        arr = np.ascontiguousarray(np.asarray(example_batch[key]))
        tensors.append(torch.from_numpy(arr))
        dynamic.append({0: batch})
        shapes.append(["b", *arr.shape[1:]])
        dtypes.append(str(arr.dtype))
    return tuple(tensors), tuple(dynamic), shapes, dtypes


def _cpu_copy(task):
    """A copy of `task` whose modules are on the CPU in eval mode; the
    caller's task is left as it was. The run's generators are shared, not
    copied: the eval forward draws from none."""
    modules = [v for v in vars(task).values() if isinstance(v, nn.Module)]
    memo = {id(m.generator): m.generator for mod in modules for m in mod.modules()
            if getattr(m, "generator", None) is not None}
    held = copy.deepcopy(task, memo)
    for value in vars(held).values():
        if isinstance(value, nn.Module):
            value.cpu().eval()
    return held


def _export_fn(
    task,
    make_fn: Callable[[Any], Callable[..., Dict[str, torch.Tensor]]],
    modules: Mapping[str, str],
    input_keys: Sequence[str],
    example_batch: Mapping[str, Any],
    path: str | Path,
    meta: Dict[str, Any],
) -> Path:
    """Shared artifact writer: trace `make_fn` over a CPU copy of `task`
    with no gradient (so the kernels' operators are what the graph holds)
    and write MAGIC|meta|blob atomically. `modules` names the program's
    modules and the task attributes that hold them. The trace runs on the
    CPU: traced on the card, CUDA's operator choices guard the batch
    (2 ≤ b ≤ 65535 for the AVMNIST model), while the CPU's graph holds the
    same operators with no such guard, so one file answers at any batch on
    either device; its weights are stored on the CPU."""
    device = next(getattr(task, next(iter(modules.values()))).parameters()).device
    held = _cpu_copy(task)
    args, dynamic, shapes, dtypes = _example_inputs(input_keys, example_batch)
    serving = _Serving(make_fn(held), {name: getattr(held, attr)
                                       for name, attr in modules.items()})
    with torch.no_grad():
        program = torch.export.export(serving, args, dynamic_shapes=(dynamic,), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    meta = {
        "format": FORMAT,
        "input_keys": [str(k) for k in input_keys],
        "input_shapes": shapes,
        "input_dtypes": dtypes,
        "device": str(device),
        "symbolic_batch": True,
        "torch_version": torch.__version__,
        **meta,
    }
    meta_bytes = json.dumps(meta).encode()

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(meta_bytes)))
        f.write(meta_bytes)
        f.write(buf.getvalue())
    tmp.replace(path)
    return path


def export_task(
    task: ClassificationTask,
    example_batch: Mapping[str, Any],
    path: str | Path,
    *,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> Path:
    """Export a trained classification task to a serving artifact.

    example_batch supplies per-input shapes/dtypes (only trailing dims are
    kept: the batch is symbolic). The caller's task is left as it was.
    Returns the written path."""
    meta = {
        "task_type": "classification",
        "outputs": ["logits", "preds", "probs"],
        "multilabel": bool(task.multilabel),
        "binary_threshold": float(task.binary_threshold),
        "model": type(task.model).__name__,
        **(extra_meta or {}),
    }
    return _export_fn(task, lambda held: lambda *inputs: _classify(held, *inputs),
                      {"model": "model"}, task.input_keys, example_batch, path, meta)


def make_cmam_serving_fn(task) -> Callable[..., Dict[str, torch.Tensor]]:
    """Missing-modality inference closure for a trained C-MAM.

    Positional inputs = the AVAILABLE modalities (`task.input_modalities`
    order). The missing target modality's embedding is imputed by the C-MAM
    and classification runs through the frozen base model with the
    reconstruction substituted (`CMAMTask.teacher_classify`). A DualCMAM
    task (one input, two reconstructed targets) gives `rec_embd` and
    `rec_embd_two`. Predictions and probabilities follow the base model:
    sigmoid and threshold for a multilabel base, argmax and softmax
    otherwise. Both networks run in eval mode."""
    from mmtpu_torch.train.cmam_step import DualCMAMTask

    dual = isinstance(task, DualCMAMTask)

    def fn(*inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        batch = dict(zip(task.input_modalities, inputs))
        task.cmam_model.eval()
        if dual:
            rec_one, rec_two = task.cmam_model(batch[task.input_modalities[0]])
            logits = task.teacher_classify(batch, {task.target_modality: rec_one,
                                                   task.target_modality_two: rec_two})
            rec = {"rec_embd": rec_one, "rec_embd_two": rec_two}
        else:
            rec_embd = task.cmam_model({m: batch[m] for m in task.input_modalities})
            logits = task.teacher_classify(batch, {task.target_modality: rec_embd})
            rec = {"rec_embd": rec_embd}
        probs = torch.sigmoid(logits) if task.multilabel else torch.softmax(logits, dim=-1)
        return {"logits": logits, "preds": task.predictions(logits), "probs": probs, **rec}

    return fn


def export_cmam(
    task,
    example_batch: Mapping[str, Any],
    path: str | Path,
    *,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> Path:
    """Export a trained C-MAM + frozen base as ONE missing-modality serving
    artifact: available modalities in → imputed embedding + class scores
    out. Both networks' weights are in the blob."""
    from mmtpu_torch.train.cmam_step import DualCMAMTask

    targets = [str(task.target_modality)]
    if isinstance(task, DualCMAMTask):
        targets.append(str(task.target_modality_two))
    meta = {
        "task_type": "cmam",
        "outputs": ["logits", "preds", "probs", "rec_embd"],
        "imputes": targets,
        "base_model": str(task.base_model_type),
        "model": type(task.cmam_model).__name__,
        "multilabel": bool(task.multilabel),
        "binary_threshold": float(task.binary_threshold),
        **(extra_meta or {}),
    }
    return _export_fn(task, make_cmam_serving_fn,
                      {"cmam": "cmam_model", "base": "base_model"},
                      task.input_modalities, example_batch, path, meta)


@dataclasses.dataclass
class ServedModel:
    """A loaded artifact: callable like `Predictor` (numpy outputs), plus its
    meta and the program on `device`."""

    meta: Dict[str, Any]
    program: Any  # torch.export.ExportedProgram
    device: torch.device

    def __post_init__(self) -> None:
        self._module = self.program.module()

    @property
    def input_keys(self) -> Sequence[str]:
        return tuple(self.meta["input_keys"])

    def __call__(self, *args, **kwargs) -> Dict[str, np.ndarray]:
        inputs = _resolve_inputs(self.input_keys, args, kwargs)
        with torch.inference_mode():
            out = self._module(*(x.to(self.device) for x in inputs))
        return {k: v.cpu().numpy() for k, v in out.items()}


def _read_artifact(path: str | Path):
    """(meta, blob) of an artifact file; raises ValueError for anything
    else, naming mmtpu's StableHLO artifact when it is one."""
    raw = Path(path).read_bytes()
    if raw.startswith(JAX_MAGIC):
        raise ValueError(
            f"{path}: this is mmtpu's StableHLO serving artifact (jax.export, "
            f"{JAX_MAGIC!r}); mmtpu_torch cannot read it. Export the run with the "
            "port (predict --export, train_cmam --export-serving)")
    if not raw.startswith(MAGIC):
        raise ValueError(f"{path}: not an mmtpu_torch serving artifact")
    off = len(MAGIC)
    (meta_len,) = struct.unpack_from("<Q", raw, off)
    off += 8
    meta = json.loads(raw[off:off + meta_len].decode())
    return meta, raw[off + meta_len:]


def load_artifact(path: str | Path, device: str | torch.device = "cuda") -> ServedModel:
    """Load a serving artifact written by `export_task` or `export_cmam`
    onto `device` (the card unless the caller asks for the CPU)."""
    import mmtpu_torch.ops  # noqa: F401  the artifact's operators
    from torch.export.passes import move_to_device_pass

    meta, blob = _read_artifact(path)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_artifact: no CUDA device; pass device='cpu' to serve "
                           "on the CPU")
    program = move_to_device_pass(torch.export.load(io.BytesIO(blob)), device)
    return ServedModel(meta=meta, program=program, device=device)
