"""Checkpoint save/restore of a training run (counterpart of
`mmtpu/checkpoints/manager.py`, with `.pth` files in place of `.ckpt`).

- `epoch_{N}.pth` + `epoch_{N}.json` on every new best, mirrored to
  `best.pth` + `best.json`; each holds {"model", "optimizer", "step"} (the
  model's state_dict under "model", where `load_pth` and `cli.predict`
  find it);
- `last.pth`: the rolling resume point, written every epoch — the same
  tree plus the loop's meta (JSON, under "resume_meta") and the torch RNG
  states, in ONE file written atomically (a kill never pairs epoch-N
  weights with epoch-(N-1) loop state); `resume.json` mirrors the meta;
- `encoder_{mod}_best.pth`: the monomodal → multimodal handoff, the bare
  encoder state_dict (parameters and BatchNorm statistics).

Configs name their handoff files as mmtpu writes them, `*.ckpt`;
`resolve_checkpoint_path` takes a `.ckpt` name to its `.pth` sibling (mmtpu
does the reverse). Writes are synchronous.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, Optional

import torch

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
    """The exact path if it exists, else its `.pth` sibling; raises
    FileNotFoundError when neither exists."""
    p = Path(path)
    if p.exists():
        return p
    if p.with_suffix(".pth").exists():
        return p.with_suffix(".pth")
    raise FileNotFoundError(f"checkpoint not found: {p} (nor {p.with_suffix('.pth').name})")


class CheckpointManager:
    def __init__(self, model_dir, save_metric: str = "loss") -> None:
        self.model_dir = Path(model_dir)
        self.model_dir.mkdir(parents=True, exist_ok=True)
        self.save_metric = save_metric

    def save_checkpoint(self, state: TrainState, epoch: int,
                        metric_value: Optional[float] = None) -> Path:
        """Write epoch_{N}.pth and mirror it to best.pth. The caller decides
        improvement (the loop saves on a new best only), as in mmtpu."""
        path = self.model_dir / f"epoch_{epoch}.pth"
        meta = json.dumps({"epoch": epoch, "metric": self.save_metric, "value": metric_value})
        tree = state.state_dict()
        _save_atomic(tree, path)
        _write_text_atomic(self.model_dir / f"epoch_{epoch}.json", meta)
        _save_atomic(tree, self.model_dir / "best.pth")
        _write_text_atomic(self.model_dir / "best.json", meta)
        logger.info(f"checkpoint saved: {path}")
        return path

    def save_encoder(self, encoder: torch.nn.Module, modality: str) -> Path:
        """The handoff: the encoder's state_dict, statistics included."""
        path = self.model_dir / f"encoder_{modality}_best.pth"
        _save_atomic({k: v.detach().cpu() for k, v in encoder.state_dict().items()}, path)
        return path

    def save_rolling(self, state: TrainState, epoch: int,
                     meta: Optional[Dict[str, Any]] = None) -> Path:
        """Overwrite last.pth (+ resume.json) — the mid-run resume point."""
        payload = json.dumps({"epoch": epoch, **(meta or {})})
        tree = state.state_dict()
        tree["resume_meta"] = payload
        tree["rng"] = {"cpu": torch.get_rng_state()}
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            tree["rng"]["cuda"] = torch.cuda.get_rng_state_all()
        path = self.model_dir / "last.pth"
        _save_atomic(tree, path)
        _write_text_atomic(self.model_dir / "resume.json", payload)
        return path

    def load_resume_meta(self) -> Optional[Dict[str, Any]]:
        rolling = self.model_dir / "last.pth"
        if not rolling.exists():
            return None
        return json.loads(_load(rolling)["resume_meta"])

    def load_checkpoint(self, state: TrainState, which: str = "best") -> TrainState:
        """Restore `best`, `last` or `epoch_{N}` into `state` (model,
        optimizer, step); `last` also restores the RNG states."""
        tree = _load(self.model_dir / f"{which}.pth")
        state.load_state_dict(tree)
        rng = tree.get("rng")
        if rng is not None:
            torch.set_rng_state(rng["cpu"])
            if "cuda" in rng and torch.cuda.is_available():
                torch.cuda.set_rng_state_all(rng["cuda"])
        return state
