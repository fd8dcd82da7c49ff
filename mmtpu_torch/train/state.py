"""Training state (counterpart of `mmtpu/train/state.py`): the model, which
holds its parameters and BatchNorm statistics, its optimizer, the step
count, the global-norm clip the step applies, and, for a model that draws
its dropout from an explicit `torch.Generator` (C-MAM), that generator,
whose state checkpoints carry as mmtpu's carry its PRNG key; in a
data-parallel rank, the mesh its steps sum their gradients over."""

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
    generator: Optional[torch.Generator] = None
    mesh: Optional[Any] = None  # parallel.mesh.Mesh: the step's gradients are summed over it

    def state_dict(self) -> Dict[str, Any]:
        """Model, optimizer and step as CPU tensors and plain containers,
        the layout of the port's training checkpoints (and the generator's
        state, where there is one)."""
        model = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
        out = {"model": model, "optimizer": _to_cpu(self.optimizer.state_dict()),
               "step": int(self.step)}
        if self.generator is not None:
            out["generator"] = self.generator.get_state()
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state.get("step", 0))
        if self.generator is not None and "generator" in state:
            self.generator.set_state(state["generator"])


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj
