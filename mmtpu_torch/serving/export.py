"""In-process predictor of the port (counterpart of `make_serving_fn`,
`_resolve_inputs` and `Predictor`, mmtpu/serving/export.py).

Artifact export (mmtpu's `jax.export` files) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from mmtpu_torch.train.step import ClassificationTask


def make_serving_fn(task: ClassificationTask, device: torch.device) -> Callable[..., Dict[str, torch.Tensor]]:
    """Inference closure: positional modality tensors (in `task.input_keys`
    order) → {"logits", "preds", "probs"}: softmax probabilities, or the
    per-label sigmoids of a multilabel task. Eval-mode forward (dropout off,
    BN running statistics); a zeroed input is exactly what the training-time
    mask multiply produces for a missing modality."""

    @torch.inference_mode()
    def fn(*inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        batch = {k: x.to(device) for k, x in zip(task.input_keys, inputs)}
        logits = task.apply(batch, train=False)
        return {
            "logits": logits,
            "preds": task.predictions(logits),
            "probs": task.probabilities(logits),
        }

    return fn


def _resolve_inputs(input_keys: Sequence[str], args, kwargs):
    """Positional-XOR-keyword input resolution."""
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
