"""Training state (counterpart of `mmtpu/train/state.py`): the model, which
holds its parameters and BatchNorm statistics, its optimizer, the step
count, and the global-norm clip the step applies."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    clip: Optional[float] = None

    def state_dict(self) -> Dict[str, Any]:
        """Model, optimizer and step as CPU tensors and plain containers,
        the layout of the port's training checkpoints."""
        model = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
        return {"model": model, "optimizer": _to_cpu(self.optimizer.state_dict()),
                "step": int(self.step)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state.get("step", 0))


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj
