"""C-MAM training: the frozen-teacher step (counterpart of
mmtpu/train/cmam_step.py).

Per batch: the target modality's embedding from the frozen base model's
encoder (eval mode, no gradient); the C-MAM's reconstruction of it from the
input modalities (train mode, the sample mask published to BatchNorm when
the batch has padded rows); the reconstruction pushed back through the
frozen base model in place of the target modality, whose logits the
classification term and the predictions read; the composite `CMAMLoss`;
backward, the optional global-norm clip and the optimizer, which holds the
C-MAM's parameters only. Gradients flow through the frozen base model with
respect to the reconstruction, so an AVMNIST base runs its plain head
(`fused_head=False`, as mmtpu forces its XLA head there): the C-MAM paths
launch no `fused_mlp`.

The base model holds its own weights: the task puts it in eval mode and
stops its parameters' gradients once (mmtpu captures them as constants
under `stop_gradient`), and nothing on this path switches it back.
Sequence encoders run over all T with no lengths, as in mmtpu.

`DualCMAMTask`: one input modality, two reconstructed targets, the two
CMAMLoss dicts summed. As in mmtpu and the reference, both calls receive
the same classification logits, so that term counts twice.

The steps take numpy batches and return device tensors, as
`train/step.py`'s do. In a data-parallel rank (`state.mesh`, or the eval
step's `mesh`) a step takes its rows of the global batch (the teacher
encodes those rows) and runs under `with mesh:`: the loss is this rank's
share of the global batch's (`train/cmam_loss.py`), and the `terms` it
returns are the global batch's, the shares summed over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mmtpu_torch.models.norm import batch_mask
from mmtpu_torch.train.cmam_loss import CMAMLoss
from mmtpu_torch.train.state import TrainState
from mmtpu_torch.train.step import apply_gradients, apply_missing_mask, on_mesh, rows_on_device

# base model_type → modality → its forward argument. The keys are every
# spelling the configs use for a C-MAM base: resolver names and class names.
_TRIMODAL = {"audio": "A", "video": "V", "text": "T"}
FORWARD_KWARGS: Dict[str, Dict[str, str]] = {
    "avmnist": {"audio": "A", "image": "I"},
    "utt-fusion": _TRIMODAL,
    "utt_fusion": _TRIMODAL,
    "uttfusionmodel": _TRIMODAL,
    "mmimdb": {"image": "I", "text": "T"},
}
_NETS = {"audio": "netA", "video": "netV", "text": "netT"}  # UttFusion's encoders


@dataclasses.dataclass
class CMAMTask:
    cmam_model: nn.Module
    base_model: nn.Module  # the frozen teacher
    base_model_type: str
    input_modalities: Sequence[str]
    target_modality: str
    loss: CMAMLoss
    labels_key: str = "labels"
    cls_from_rec: bool = True
    # predictions follow the BASE model's logits transform: sigmoid and a
    # threshold for a multilabel (MM-IMDb) base, argmax otherwise
    multilabel: bool = False
    binary_threshold: float = 0.5

    def __post_init__(self) -> None:
        self.base_model.eval()
        self.base_model.requires_grad_(False)

    def predictions(self, logits: torch.Tensor) -> torch.Tensor:
        if self.multilabel:
            return (torch.sigmoid(logits) > self.binary_threshold).to(torch.int32)
        return logits.argmax(dim=-1)

    @staticmethod
    def masked(batch: Mapping[str, torch.Tensor], mod: str) -> torch.Tensor:
        """The modality with its pattern's missing mask applied."""
        return apply_missing_mask(batch[mod], batch.get(f"{mod}_mask"))

    def teacher_embedding(self, batch, modality: Optional[str] = None) -> torch.Tensor:
        """The frozen base model's embedding of `modality` (default: the
        target): its `{mod}_encoder`, or UttFusion's netA/netV/netT."""
        mod = modality or self.target_modality
        encoder = getattr(self.base_model, f"{mod}_encoder", None)
        if encoder is None:
            encoder = getattr(self.base_model, _NETS[mod])
        with torch.no_grad():
            return encoder(self.masked(batch, mod))

    def teacher_classify(self, batch, reconstructed: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The frozen base model's logits with each reconstructed embedding
        in place of its modality; the other modalities from the batch."""
        kwargs: Dict[str, Any] = {}
        for mod, letter in FORWARD_KWARGS[self.base_model_type.lower()].items():
            if mod in reconstructed:
                kwargs[letter] = reconstructed[mod]
                kwargs[f"is_embd_{letter}"] = True
            elif mod in batch:
                kwargs[letter] = self.masked(batch, mod)
        if self.base_model_type.lower() == "avmnist":
            kwargs["fused_head"] = False
        return self.base_model(**kwargs)


@dataclasses.dataclass
class DualCMAMTask(CMAMTask):
    target_modality_two: str = "text"


def _outputs(task: CMAMTask, batch, loss, cls_logits, **extra) -> Dict[str, torch.Tensor]:
    out = {"loss": loss, **extra, "labels": batch.get(task.labels_key)}
    if cls_logits is not None:
        out["preds"] = task.predictions(cls_logits.detach())
    for key in ("pattern_id", "sample_mask"):
        if key in batch:
            out[key] = batch[key]
    return out


def _global_terms(terms: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The terms detached; under `mesh`, the ranks' shares summed (one
    all-reduce), the global batch's values."""
    terms = {k: v.detach() for k, v in terms.items()}
    if mesh is None or not terms:
        return terms
    summed = mesh.all_reduce_(torch.stack(list(terms.values())))
    return dict(zip(terms, summed.unbind()))


def _cmam_forward(task: CMAMTask, batch, model: nn.Module, train: bool, padded: bool):
    """Target, reconstruction, logits and loss terms of one CMAM batch."""
    sample_mask = batch.get("sample_mask")
    target = task.teacher_embedding(batch)
    model.train(train)
    with batch_mask(sample_mask if padded else None):
        rec = model({m: task.masked(batch, m) for m in task.input_modalities})
    cls_logits = (task.teacher_classify(batch, {task.target_modality: rec})
                  if task.cls_from_rec else None)
    terms = task.loss(rec, target, cls_logits=cls_logits,
                      cls_labels=batch.get(task.labels_key) if task.cls_from_rec else None,
                      sample_mask=sample_mask)
    return target, rec, cls_logits, terms


def make_cmam_train_step(task: CMAMTask, state: TrainState,
                         device: torch.device) -> Callable:
    """(numpy batch) → dict of tensors on `device`: loss, terms, rec_embd,
    target_embd, labels, preds, and pattern_id / sample_mask."""

    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch, padded = rows_on_device(batch, state.mesh, device)
        with on_mesh(state.mesh):
            target, rec, cls_logits, terms = _cmam_forward(task, batch, state.model, True,
                                                           padded)
        apply_gradients(state, terms["total_loss"])
        return _outputs(task, batch, terms["total_loss"].detach(), cls_logits,
                        terms=_global_terms(terms, state.mesh), rec_embd=rec.detach(),
                        target_embd=target)

    return step


def make_cmam_eval_step(task: CMAMTask, device: torch.device, mesh=None) -> Callable:
    @torch.inference_mode()
    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch, _ = rows_on_device(batch, mesh, device)
        with on_mesh(mesh):
            target, rec, cls_logits, terms = _cmam_forward(task, batch, task.cmam_model,
                                                           False, False)
        return _outputs(task, batch, terms["total_loss"], cls_logits,
                        terms=_global_terms(terms, mesh), rec_embd=rec, target_embd=target)

    return step


def _dual_forward(task: DualCMAMTask, batch, model: nn.Module, train: bool, padded: bool):
    """Both targets, both reconstructions, the logits with both substituted,
    and the summed loss with the two term dicts under `rec_{term}_{one,two}`."""
    sample_mask = batch.get("sample_mask")
    tgt_one = task.teacher_embedding(batch, task.target_modality)
    tgt_two = task.teacher_embedding(batch, task.target_modality_two)
    model.train(train)
    with batch_mask(sample_mask if padded else None):
        rec_one, rec_two = model(task.masked(batch, task.input_modalities[0]))
    cls_logits = (task.teacher_classify(batch, {task.target_modality: rec_one,
                                                task.target_modality_two: rec_two})
                  if task.cls_from_rec else None)
    labels = batch.get(task.labels_key) if task.cls_from_rec else None
    # the reference's quirk, kept: both calls get the same logits, so the
    # classification term counts at twice cls_weight
    terms_one = task.loss(rec_one, tgt_one, cls_logits=cls_logits, cls_labels=labels,
                          sample_mask=sample_mask)
    terms_two = task.loss(rec_two, tgt_two, cls_logits=cls_logits, cls_labels=labels,
                          sample_mask=sample_mask)
    total = terms_one["total_loss"] + terms_two["total_loss"]
    terms = {f"rec_{k}_{which}": v for which, t in (("one", terms_one), ("two", terms_two))
             for k, v in t.items() if k != "total_loss"}
    return {"loss": total, "terms": terms, "rec_embd": rec_one, "rec_embd_two": rec_two,
            "target_embd": tgt_one, "target_embd_two": tgt_two}, cls_logits


def make_dual_cmam_train_step(task: DualCMAMTask, state: TrainState,
                              device: torch.device) -> Callable:
    """As `make_cmam_train_step`, with rec_embd_two and target_embd_two."""

    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch, padded = rows_on_device(batch, state.mesh, device)
        with on_mesh(state.mesh):
            res, cls_logits = _dual_forward(task, batch, state.model, True, padded)
        apply_gradients(state, res["loss"])
        res = {k: _global_terms(v, state.mesh) if k == "terms" else v.detach()
               for k, v in res.items()}
        return _outputs(task, batch, res.pop("loss"), cls_logits, **res)

    return step


def make_dual_cmam_eval_step(task: DualCMAMTask, device: torch.device,
                             mesh=None) -> Callable:
    """As mmtpu's, its outputs carry no loss terms."""

    @torch.inference_mode()
    def step(batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch, _ = rows_on_device(batch, mesh, device)
        with on_mesh(mesh):
            res, cls_logits = _dual_forward(task, batch, task.cmam_model, False, False)
        res.pop("terms")
        return _outputs(task, batch, res.pop("loss"), cls_logits, **res)

    return step
