"""Loss criteria and LossFunctionGroup (counterpart of `mmtpu/train/losses.py`).

Call contract as in mmtpu: ``loss_functions(logits, labels,
sample_mask=...)["total_loss"]``. Every criterion reduces with the same
masked mean as mmtpu, ``sum(w·m·l) / sum(w·m)``: per-sample losses with
extra axes are first averaged over them, `sample_mask` zeroes padded tail
rows, and class weights (cross entropy) weight the rows. The registry has
mmtpu's names; `cmam` resolves to the composite C-MAM loss
(`train/cmam_loss.py`), which returns its terms with 'total_loss'.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from mmtpu_torch.parallel.mesh import active_mesh


def _as_float(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def _masked_reduce(per_sample, sample_mask=None, weights=None):
    """Weighted/masked batch mean: sum(w·m·l) / sum(w·m). Per-sample losses
    with extra dims are averaged over their non-batch axes first. Under a
    data-parallel mesh (`with mesh:`) the denominator is the GLOBAL batch's,
    summed over the ranks: each rank returns its share of the global mean,
    zero for a rank without a real row, and the shares sum to it."""
    if per_sample.dim() > 1:  # flatten(1) also takes a rank's empty slice
        per_sample = per_sample.flatten(1).mean(dim=1)
    eff = weights
    if sample_mask is not None:
        eff = sample_mask if eff is None else eff * sample_mask
    if active_mesh() is None:
        if eff is None:
            return per_sample.mean()
        return (per_sample * eff).sum() / torch.clamp(eff.sum(), min=1e-8)
    if eff is None:
        eff = torch.ones_like(per_sample)
    count = global_count(eff).to(per_sample.dtype)
    return (per_sample * eff).sum() / torch.clamp(count, min=1e-8)


def global_count(weights: torch.Tensor) -> torch.Tensor:
    """The sum of `weights` (a count of rows), detached: over the global
    batch under a data-parallel mesh (summed over the ranks), over the
    rows given otherwise. A share's denominator."""
    count = weights.detach().sum()
    mesh = active_mesh()
    return count if mesh is None else mesh.all_reduce_(count)


def replicated_share(value):
    """This rank's share of a value that every rank computes alike from the
    global batch (a term over the gathered rows, `parallel.mesh.global_rows`,
    or a constant): 1/N of it under a mesh, so that the ranks' shares sum
    to it as `_masked_reduce`'s do; the value itself otherwise."""
    mesh = active_mesh()
    return value if mesh is None else value / mesh.world_size


def cross_entropy(logits, targets, weight=None, label_smoothing: float = 0.0,
                  sample_mask=None):
    """Softmax CE over integer class targets (torch CrossEntropyLoss). Class
    weights weight whole rows, as mmtpu does, also with label smoothing."""
    targets = targets.long()
    losses = F.cross_entropy(_as_float(logits), targets, reduction="none",
                             label_smoothing=float(label_smoothing))
    w = None
    if weight is not None:
        w = torch.as_tensor(weight, dtype=losses.dtype, device=losses.device)[targets]
    return _masked_reduce(losses, sample_mask, w)


def nll(log_probs, targets, sample_mask=None):
    per = -log_probs.gather(-1, targets.long()[:, None])[:, 0]
    return _masked_reduce(per, sample_mask)


def mse(preds, targets, sample_mask=None):
    return _masked_reduce((_as_float(preds) - _as_float(targets)).square(), sample_mask)


def l1(preds, targets, sample_mask=None):
    return _masked_reduce((_as_float(preds) - _as_float(targets)).abs(), sample_mask)


def smooth_l1(preds, targets, beta: float = 1.0, sample_mask=None):
    d = (_as_float(preds) - _as_float(targets)).abs()
    return _masked_reduce(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta),
                          sample_mask)


def huber(preds, targets, delta: float = 1.0, sample_mask=None):
    d = (_as_float(preds) - _as_float(targets)).abs()
    return _masked_reduce(torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta)),
                          sample_mask)


def bce(probs, targets, sample_mask=None):
    p = _as_float(probs).clamp(1e-7, 1.0 - 1e-7)
    t = _as_float(targets)
    return _masked_reduce(-(t * p.log() + (1.0 - t) * (1.0 - p).log()), sample_mask)


def bce_with_logits(logits, targets, pos_weight=None, sample_mask=None):
    """torch semantics: pos_weight scales only the positive log term."""
    logits = _as_float(logits)
    t = _as_float(targets)
    pw = None if pos_weight is None else torch.as_tensor(
        pos_weight, dtype=logits.dtype, device=logits.device)
    losses = F.binary_cross_entropy_with_logits(logits, t, pos_weight=pw, reduction="none")
    return _masked_reduce(losses, sample_mask)


def kl_div(log_preds, targets, sample_mask=None):
    """Elementwise KL, averaged over every element (torch KLDivLoss's 'mean')."""
    t = _as_float(targets)
    per = t * (torch.where(t > 0, t.clamp(min=1e-38).log(), torch.zeros_like(t)) - log_preds)
    return _masked_reduce(per, sample_mask)


def cosine_embedding(x1, x2, target, margin: float = 0.0, sample_mask=None):
    sim = (x1 * x2).sum(-1) / (x1.norm(dim=-1) * x2.norm(dim=-1) + 1e-8)
    per = torch.where(target > 0, 1.0 - sim, torch.clamp(sim - margin, min=0.0))
    return _masked_reduce(per, sample_mask)


def identity_loss(x, *_args, **_kwargs):
    return x


_CRITERIA: Dict[str, Callable[..., Callable]] = {}


def _register(name: str, fn: Callable, **bound_defaults: Any) -> None:
    def factory(**kwargs):
        merged = {**bound_defaults, **kwargs}

        def criterion(preds, targets, **call_kwargs):
            return fn(preds, targets, **merged, **call_kwargs)

        criterion.__name__ = name
        return criterion

    _CRITERIA[name] = factory


_register("cross_entropy", cross_entropy)
_register("nll", nll)
_register("mse", mse)
_register("bce", bce)
_register("bce_with_logits", bce_with_logits)
_register("l1", l1)
_register("smooth_l1", smooth_l1)
_register("kl_div", kl_div)
_register("huber", huber)
# registered but not callable through the (preds, targets) term contract,
# as in mmtpu and the reference: it needs a third `target` argument
_register("cosine", cosine_embedding)
_register("cycle", mse)
_register("na", identity_loss)


def resolve_criterion(name: str) -> Callable[..., Callable]:
    key = name.lower()
    if key == "cmam":
        from mmtpu_torch.train.cmam_loss import CMAMLoss

        return CMAMLoss
    if key not in _CRITERIA:
        raise ValueError(
            f"Unknown criterion: {name}. Available: {sorted(_CRITERIA)} + ['cmam']"
        )
    return _CRITERIA[key]


class WeightedLossTerm:
    """loss_fn + scalar weight → dict with at least 'total_loss'."""

    def __init__(self, loss_fn: Callable, weight: float = 1.0, name: str = "") -> None:
        self.loss_fn = loss_fn
        self.weight = float(weight)
        self.name = name

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "WeightedLossTerm":
        loss_kwargs = data.get("loss_kwargs", data.get("loss_args", {})) or {}
        factory = resolve_criterion(data["loss_name"])
        return cls(loss_fn=factory(**loss_kwargs), weight=data.get("weight", 1.0),
                   name=data["loss_name"])

    def __call__(self, inputs, targets, **kwargs) -> Dict[str, Any]:
        value = self.loss_fn(inputs, targets, **kwargs)
        if isinstance(value, dict):
            return {k: v * self.weight for k, v in value.items()}
        return {"total_loss": value * self.weight}

    def __repr__(self) -> str:  # noqa: D105
        return f"WeightedLossTerm({self.name or self.loss_fn}, weight={self.weight})"


class LossFunctionGroup(Dict[str, WeightedLossTerm]):
    """Dict of named weighted terms; calling sums the terms' dicts.
    Keeps the config mapping it was built from for `to_dict`."""

    spec: Dict[str, Dict[str, Any]] = {}

    @classmethod
    def from_dict(cls, data: Dict[str, Dict[str, Any]]) -> "LossFunctionGroup":
        if isinstance(data, cls):
            return data
        group = cls({key: WeightedLossTerm.from_dict(value) for key, value in data.items()})
        group.spec = dict(data)
        return group

    def __call__(self, inputs, targets, **kwargs) -> Dict[str, Any]:
        losses: Dict[str, Any] = {}
        for term in self.values():
            for k, v in term(inputs, targets, **kwargs).items():
                losses[k] = losses.get(k, 0.0) + v
        if not losses:
            losses["total_loss"] = torch.zeros(())
        return losses

    def to_dict(self) -> Dict[str, Any]:
        return self.spec
