"""Checkpoint save/restore of a training run (counterpart of
`mmtpu/checkpoints/manager.py`, with `.pth` files in place of `.ckpt`).

- `epoch_{N}.pth` + `epoch_{N}.json` on every new best, mirrored to
  `best.pth` + `best.json`; each holds {"model", "optimizer", "step"} (the
  model's state_dict under "model", where `load_encoder_checkpoint` and
  `cli.predict` find it);
- `last.pth`: the rolling resume point, written every epoch — the same
  tree plus the loop's meta (JSON, under "resume_meta") and the torch RNG
  states, in ONE file written atomically (a kill never pairs epoch-N
  weights with epoch-(N-1) loop state); `resume.json` mirrors the meta;
- `encoder_{mod}_best.pth`: the monomodal → multimodal handoff, the bare
  encoder state_dict (parameters and BatchNorm statistics).

On a mesh with a model axis the tree is the whole model's (`TrainState`
joins the shards over the model group), so a file written by a (2, 2)
mesh loads into one process; every rank builds it and rank 0 writes it. A
sharded state that loads a file takes its shards.

Configs name their handoff files as mmtpu writes them, `*.ckpt`;
`resolve_checkpoint_path` takes a missing `.ckpt` name to its `.pth`
sibling, and any other missing name to its `.ckpt` sibling (mmtpu's rule).
Writes are synchronous.

Reading (`load_encoder_checkpoint`, mmtpu's `load_encoder_checkpoint` and
`load_model_variables` in one): three formats, told apart by their bytes.
Anything that decodes as msgpack is an mmtpu `.ckpt` (`checkpoints/
msgpack.py`): its `params` and `batch_stats` go through `adapt_lstm_layout`
and `from_jax_variables`, so an `LSTMEncoder` saved with one backend loads
into the other. A zip archive or a pickle is a torch file: the port's own
(a training checkpoint's "model", or a plain-tensor state dict whose keys
are the target's) loads with `load_state_dict(strict=True)`, as mmtpu loads
its own `.ckpt`; any other is a reference `.pth`, read leniently by
`checkpoints/torch_interop.py`. The exact path is tried first, then its
sibling; where both exist, mmtpu's encoder loader would take the `.ckpt`.
"""

from __future__ import annotations

import json
import logging
import os
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from mmtpu_torch.checkpoints.torch_interop import LoadReport
from mmtpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)


def _save_atomic(obj: Any, path: Path) -> None:
    """torch.save to a temporary name, then rename over `path`."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _write_text_atomic(path: Path, text: str) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def _load(path: Path) -> Dict[str, Any]:
    # tensors and plain containers only: never arbitrary objects
    return torch.load(str(path), map_location="cpu", weights_only=True)


def resolve_checkpoint_path(path) -> Path:
    """The exact path if it exists, else its sibling: a `.ckpt` name's
    `.pth` (the port's files), any other name's `.ckpt` (mmtpu's, as
    mmtpu's `resolve_checkpoint_path`). Raises FileNotFoundError when
    neither exists."""
    p = Path(path)
    sibling = p.with_suffix(".pth" if p.suffix == ".ckpt" else ".ckpt")
    for candidate in (p, sibling):
        if candidate.exists():
            return candidate
    raise FileNotFoundError(f"checkpoint not found: {p} (nor {sibling.name})")


_GATES = ("i", "f", "g", "o")  # flax OptimizedLSTMCell's gate order, also the fused layout's


def _is_cell(node: Any) -> bool:
    return isinstance(node, dict) and all(f"i{g}" in node and f"h{g}" in node for g in _GATES)


def _find_cell_path(node: Any, path=()):
    """Path of the first per-gate OptimizedLSTMCell param dict under node."""
    if _is_cell(node):
        return path
    if isinstance(node, dict):
        for k, v in node.items():
            found = _find_cell_path(v, path + (k,))
            if found is not None:
                return found
    return None


def _fuse_cell(cell: Dict[str, Any]):
    """Per-gate {i*, h*} Dense params → fused (wi Dense, wh matrix): the
    bias of each gate sits on its h-side Dense."""
    wi_k = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]) for g in _GATES], axis=-1)
    wi_b = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES], axis=-1)
    wh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]) for g in _GATES], axis=-1)
    return {"kernel": wi_k, "bias": wi_b}, wh


def _unfuse_cell(wi: Dict[str, Any], wh: Any) -> Dict[str, Any]:
    wh = np.asarray(wh)
    H = wh.shape[-1] // 4
    cell: Dict[str, Any] = {}
    for n, g in enumerate(_GATES):
        sl = slice(n * H, (n + 1) * H)
        cell[f"i{g}"] = {"kernel": np.asarray(wi["kernel"])[..., sl]}
        cell[f"h{g}"] = {"kernel": wh[..., sl], "bias": np.asarray(wi["bias"])[..., sl]}
    return cell


def adapt_lstm_layout(state: Any, target: Any) -> Any:
    """Bridge LSTMEncoder's two parameter layouts in an mmtpu tree (own copy
    of mmtpu's): per-gate OptimizedLSTMCell params (`backend='rnn'`,
    possibly nested under an RNN scope) into a fused `wi`/`wh` target and
    back. Exact: both layouts compute the same recurrence, gate order
    [i, f, g, o]. `target` is the destination's tree of mmtpu paths."""
    if not (isinstance(state, dict) and isinstance(target, dict)):
        return state
    out = dict(state)
    if "wi" in target and "wh" in target and not ("wi" in out and "wh" in out):
        cp = _find_cell_path(out)
        if cp:
            cell = out
            for k in cp:
                cell = cell[k]
            out.pop(cp[0])  # the chain (e.g. rnn/cell/...) holds only the cell
            out["wi"], out["wh"] = _fuse_cell(cell)
    if "wi" in out and "wh" in out and not ("wi" in target and "wh" in target):
        tp = _find_cell_path(target)
        if tp:
            node: Dict[str, Any] = _unfuse_cell(out.pop("wi"), out.pop("wh"))
            for k in reversed(tp):
                node = {k: node}
            out.update(node)
    return {k: (adapt_lstm_layout(v, target[k])
                if isinstance(v, dict) and isinstance(target.get(k), dict) else v)
            for k, v in out.items()}


def mmtpu_tree(model: nn.Module) -> Dict[str, Any]:
    """The model's parameters as mmtpu's nested tree of paths (the leaves
    are the port's names): the target `adapt_lstm_layout` reads."""
    from mmtpu_torch.checkpoints.interop import mmtpu_param_path

    tree: Dict[str, Any] = {}
    for name, param in model.named_parameters():
        *parents, leaf = mmtpu_param_path(name, param).split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = name
    return tree


def _read(path: Path, trusted: bool):
    """("mmtpu", tree, False) for a msgpack file, else ("torch", object,
    whether it loaded with weights_only)."""
    from mmtpu_torch.checkpoints import msgpack
    from mmtpu_torch.checkpoints.torch_interop import read_object

    if not zipfile.is_zipfile(path):
        try:
            return "mmtpu", msgpack.read_ckpt(path), False
        except msgpack.MsgpackError:
            pass  # a legacy (non-zip) torch file
    return ("torch", *read_object(path, trusted=trusted))


def _own_state(obj: Any, target: nn.Module) -> Optional[Mapping[str, Any]]:
    """The port's own state dict in a plain-tensor torch file: a training
    checkpoint's "model", or a dict whose keys are the target's (the
    encoder handoff); None for anything else."""
    if not isinstance(obj, Mapping):
        return None
    if "model" in obj and "optimizer" in obj:
        return obj["model"]
    return obj if set(obj) == set(target.state_dict()) else None


def _fill_from_mmtpu(target: nn.Module, tree: Dict[str, Any], report: LoadReport) -> None:
    """mmtpu's `params` (LSTM layouts adapted) and, where the file has them,
    `batch_stats` into `target`. Every parameter must be in the file; a
    BatchNorm statistic it lacks keeps its value (reported), as mmtpu
    keeps the target's batch_stats then."""
    from mmtpu_torch.checkpoints.interop import from_jax_variables

    if "params" not in tree:
        raise ValueError(f"{report.path}: an mmtpu checkpoint without 'params' "
                         f"(keys {sorted(tree)})")
    params = adapt_lstm_layout(tree["params"], mmtpu_tree(target))
    state = from_jax_variables(params, tree.get("batch_stats") or {}, target=target,
                               require_all=False)
    names = dict(target.named_parameters())
    missing = sorted(k for k in names if k not in state)
    if missing:
        raise ValueError(f"{report.path}: mmtpu checkpoint has no value for {missing}")
    want = target.state_dict()
    report.kept = [k for k in want if k not in state and not k.endswith("num_batches_tracked")]
    with torch.no_grad():
        for key, value in state.items():
            want[key].copy_(value)


def load_encoder_checkpoint(path: Union[str, Path], target: nn.Module,
                            trusted: bool = True) -> LoadReport:
    """Fill `target` (an encoder, or a whole model for predict and serve)
    in place from the port's `.pth`, a reference `.pth` or an mmtpu
    `.ckpt` (see the module docstring): the exact path, then its sibling
    (`resolve_checkpoint_path`). The port's own file must fit the target
    exactly (RuntimeError otherwise). Returns what it did;
    FileNotFoundError when neither file exists."""
    from mmtpu_torch.checkpoints.torch_interop import as_state_dict, fill_from_state

    resolved = resolve_checkpoint_path(path)
    kind, obj, plain = _read(resolved, trusted)
    report = LoadReport(str(resolved), kind)
    own = _own_state(obj, target) if plain else None
    if kind == "mmtpu":
        _fill_from_mmtpu(target, obj, report)
    elif own is not None:
        target.load_state_dict(own, strict=True)
    else:
        fill_from_state(target, as_state_dict(obj), report)
    return report


def writes_checkpoints(mesh) -> bool:
    """Whether this process writes checkpoints: one device, or the mesh's
    global rank 0 (over every process of `launch_process`). The one place
    that decides it: every rank calls the manager's writers."""
    return mesh is None or mesh.is_writer


def _tree(state: TrainState) -> Optional[Dict[str, Any]]:
    """`state`'s tree where this process writes it (`writes_checkpoints`),
    else None. On a model axis every rank takes part in building it (the
    shards are gathered over the model group) and rank 0 alone writes it;
    the other ranks of a data-parallel mesh build nothing."""
    mesh = state.mesh
    if not writes_checkpoints(mesh):
        if mesh.model_size > 1:
            state.state_dict()
        return None
    return state.state_dict()


def rng_state(state: Optional[TrainState] = None) -> Dict[str, Any]:
    """This process's RNG states: torch's CPU and CUDA generators (dropout)
    and, given a state with one, the run's generator."""
    out = {"cpu": torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        out["cuda"] = torch.cuda.get_rng_state_all()
    if state is not None and state.generator is not None:
        out["generator"] = state.generator.get_state()
    return out


def _host_tree(tree: Any) -> Any:
    """mmtpu's host copy of a tree (a jax tree map): every mapping's keys
    sorted, every leaf but a string an array."""
    if isinstance(tree, Mapping):
        return {k: _host_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    if isinstance(tree, (str, bytes)):
        return tree
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def save_pytree(path: Path, tree: Dict[str, Any]) -> None:
    """A tree of arrays as mmtpu's `.ckpt` bytes (flax's msgpack,
    `checkpoints/msgpack.py`), written atomically."""
    from mmtpu_torch.checkpoints.msgpack import to_bytes

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(to_bytes(_host_tree(tree)))
    os.replace(tmp, path)


def load_pytree(path: Path, target: Optional[Any] = None) -> Any:
    """A msgpack tree (mmtpu's `.ckpt`), restored onto `target`'s structure
    when one is given."""
    from mmtpu_torch.checkpoints.msgpack import from_state_dict, msgpack_restore

    tree = msgpack_restore(Path(path).read_bytes())
    return tree if target is None else from_state_dict(target, tree)


class CheckpointManager:
    def __init__(self, model_dir, save_metric: str = "loss", mode: str = "min") -> None:
        self.model_dir = Path(model_dir)
        self.model_dir.mkdir(parents=True, exist_ok=True)
        self.save_metric = save_metric
        self.mode = mode
        # the best metric saved so far, for standalone callers and as
        # mmtpu keeps it; the caller decides what is saved
        self.best_value: Optional[float] = None
        self.best_epoch: Optional[int] = None

    def is_better(self, value: float) -> bool:
        if self.best_value is None:
            return True
        return value < self.best_value if self.mode == "min" else value > self.best_value

    def wait(self) -> None:
        """mmtpu's join of its queued writes: the port writes every file
        before the call that writes it returns, so nothing is pending."""

    def save_checkpoint(self, state: TrainState, epoch: int,
                        metric_value: Optional[float] = None) -> Path:
        """Write epoch_{N}.pth and mirror it to best.pth. The caller decides
        improvement (the loop saves on a new best only), as in mmtpu; on a
        mesh every rank calls it and rank 0 alone writes."""
        path = self.model_dir / f"epoch_{epoch}.pth"
        meta = json.dumps({"epoch": epoch, "metric": self.save_metric, "value": metric_value})
        if metric_value is not None and self.is_better(metric_value):
            self.best_value, self.best_epoch = metric_value, epoch
        tree = _tree(state)
        if tree is None:
            return path
        _save_atomic(tree, path)
        _write_text_atomic(self.model_dir / f"epoch_{epoch}.json", meta)
        _save_atomic(tree, self.model_dir / "best.pth")
        _write_text_atomic(self.model_dir / "best.json", meta)
        logger.info(f"checkpoint saved: {path}")
        return path

    def save_encoder(self, encoder: torch.nn.Module, modality: str, mesh=None) -> Path:
        """The handoff: the encoder's state_dict, statistics included; on a
        mesh every rank calls it and rank 0 alone writes."""
        path = self.model_dir / f"encoder_{modality}_best.pth"
        if not writes_checkpoints(mesh):
            return path
        _save_atomic({k: v.detach().cpu() for k, v in encoder.state_dict().items()}, path)
        return path

    def save_rolling(self, state: TrainState, epoch: int,
                     meta: Optional[Dict[str, Any]] = None,
                     rng: Optional[List[Dict[str, Any]]] = None) -> Path:
        """Overwrite last.pth (+ resume.json) — the mid-run resume point.
        `rng`: every data-parallel rank's `rng_state`, in rank order (one
        process: its own RNG states)."""
        payload = json.dumps({"epoch": epoch, **(meta or {})})
        tree = _tree(state)
        if tree is None:
            return self.model_dir / "last.pth"
        tree["resume_meta"] = payload
        tree["rng"] = rng_state() if rng is None else {"ranks": rng}
        path = self.model_dir / "last.pth"
        _save_atomic(tree, path)
        _write_text_atomic(self.model_dir / "resume.json", payload)
        return path

    def load_resume_meta(self) -> Optional[Dict[str, Any]]:
        rolling = self.model_dir / "last.pth"
        if not rolling.exists():
            return None
        return json.loads(_load(rolling)["resume_meta"])

    def load_checkpoint(self, state: TrainState, which: str = "best",
                        rank: Optional[int] = None) -> TrainState:
        """Restore `best`, `last` or `epoch_{N}` into `state` (model,
        optimizer, step); `last` also restores the RNG states, a
        data-parallel `rank`'s own where the file holds every rank's."""
        tree = _load(self.model_dir / f"{which}.pth")
        state.load_state_dict(tree)
        rng = tree.get("rng")
        if rng is not None and "ranks" in rng:
            if rank is None or rank >= len(rng["ranks"]):
                raise ValueError(f"{which}.pth holds the RNG states of {len(rng['ranks'])} "
                                 f"data-parallel ranks; resume it on as many (rank {rank})")
            rng = rng["ranks"][rank]
        if rng is not None:
            torch.set_rng_state(rng["cpu"])
            if "cuda" in rng and torch.cuda.is_available():
                torch.cuda.set_rng_state_all(rng["cuda"])
            if "generator" in rng and state.generator is not None:
                state.generator.set_state(rng["generator"])
        return state
