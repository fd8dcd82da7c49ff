"""Optimizer factory and host-side LR scheduling (counterpart of
`mmtpu/train/optim.py`).

`build_optimizer` makes one torch parameter group per mmtpu group: the
config's `parameter_groups` and the extra (regex, kwargs) groups from
`encoder_optimizer` / `modality_specific_params`, each regex matched
against the mmtpu path of every parameter (`mmtpu_param_path`), the first
match winning and a parameter matched by two patterns an error; the rest
fall to the default group. Each group remembers its `base_lr`; the
`LRController`'s scale is ONE global multiplier (`set_lr_scale`:
lr = base_lr × scale in every group), as mmtpu injects it into optax.

Torch semantics, as mmtpu builds them in optax: "adam" with weight_decay is
L2 added to the gradient (coupled: `torch.optim.Adam(weight_decay=...)`,
not AdamW); "adamw" is decoupled; "sgd" takes momentum and nesterov. The
other optimizers mmtpu knows raise until they are ported: optax places
their `eps` differently from torch, so each needs its own parity test.
"""

from __future__ import annotations

import bisect
import logging
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from mmtpu_torch.checkpoints.interop import mmtpu_param_path
from mmtpu_torch.config.optim import OptimizerConfig

logger = logging.getLogger(__name__)

NOT_PORTED = ("rmsprop", "adagrad", "adadelta", "adamax", "asgd", "lbfgs", "sparse_adam")


def param_paths(model: nn.Module) -> Dict[str, str]:
    """Port parameter name → its mmtpu path."""
    return {n: mmtpu_param_path(n, p) for n, p in model.named_parameters()}


def param_labels(model: nn.Module, patterns: Sequence[str]) -> Dict[str, str]:
    """Port parameter name → `group_{i}` of the first pattern that matches
    its mmtpu path, else `default` (mmtpu's `_label_tree`). Raises on a
    parameter matched by two different patterns."""
    regexes = [re.compile(p) for p in patterns]
    labels = {}
    for name, path in param_paths(model).items():
        hits = [i for i, rx in enumerate(regexes) if rx.search(path)]
        if len({patterns[i] for i in hits}) > 1:
            raise ValueError(f"Parameter {path!r} matched by groups "
                             f"{patterns[hits[0]]!r} and {patterns[hits[1]]!r}")
        labels[name] = f"group_{hits[0]}" if hits else "default"
    return labels


def _group_options(name: str, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """A config group's kwargs → torch param-group options. YAML 1.1 reads
    dot-less scientific notation ('5e-5') as a string, so every number is
    coerced with float(), as mmtpu does."""
    kw = dict(kwargs)
    out: Dict[str, Any] = {"lr": float(kw.pop("lr", 1e-3)),
                           "weight_decay": float(kw.pop("weight_decay", 0.0))}
    if name in ("adam", "adamw"):
        out["betas"] = tuple(float(b) for b in kw.pop("betas", (0.9, 0.999)))
        out["eps"] = float(kw.pop("eps", 1e-8))
    elif name == "sgd":
        out["momentum"] = float(kw.pop("momentum", 0.0))
        # optax's trace with nesterov and no momentum is plain SGD
        out["nesterov"] = bool(kw.pop("nesterov", False)) and out["momentum"] > 0
    return out


def build_optimizer(
    config: OptimizerConfig,
    model: nn.Module,
    extra_groups: Optional[Sequence[Tuple[str, Dict[str, Any]]]] = None,
) -> Tuple[torch.optim.Optimizer, Dict[str, Dict[str, Any]]]:
    """Returns (optimizer, report): report maps each group's name to its
    effective kwargs, as mmtpu's does."""
    name = config.name.lower()
    if name in NOT_PORTED:
        raise NotImplementedError(f"optimizer {config.name!r} is not ported to mmtpu_torch "
                                  "yet (ported: adam, adamw, sgd)")
    if name not in ("adam", "adamw", "sgd"):
        raise ValueError(f"Unknown optimizer: {config.name}")
    groups: List[Tuple[str, Dict[str, Any]]] = [
        (g.pattern, g.effective_kwargs(config.default_kwargs)) for g in config.parameter_groups
    ]
    for pattern, overrides in extra_groups or ():
        groups.append((pattern, {**config.default_kwargs, **overrides}))

    named = dict(model.named_parameters())
    labels = param_labels(model, [p for p, _ in groups])
    specs = [(f"group_{i}", f"group_{i}:{p}", kw) for i, (p, kw) in enumerate(groups)]
    specs.append(("default", "default", dict(config.default_kwargs)))
    param_groups, report = [], {}
    for label, title, kwargs in specs:
        params = [p for n, p in named.items() if labels[n] == label]
        report[title] = kwargs
        if params:
            opts = _group_options(name, kwargs)
            param_groups.append({"params": params, "label": label,
                                 "base_lr": opts["lr"], **opts})
    # one fused kernel for all tensors on the card; the CPU takes the default
    fused = {"fused": True} if next(iter(named.values())).is_cuda and name != "sgd" else {}
    cls = {"adam": torch.optim.Adam, "adamw": torch.optim.AdamW, "sgd": torch.optim.SGD}[name]
    return cls(param_groups, **fused), report


def set_lr_scale(optimizer: torch.optim.Optimizer, scale: float) -> None:
    """Every group's lr = its base lr × the one global scale."""
    for group in optimizer.param_groups:
        group["lr"] = group["base_lr"] * float(scale)


class LRController:
    """Computes a multiplicative lr scale per epoch; step() returns it
    (own copy of mmtpu's, stepped after each epoch as the reference's
    scheduler.step())."""

    def __init__(self, kind: Optional[str], args: Dict[str, Any], base_lr: float):
        self.kind = (kind or "").lower() or None
        self.args = dict(args or {})
        self.base_lr = base_lr
        self.epoch = 0
        # plateau state
        self._best: Optional[float] = None
        self._num_bad = 0
        self._cooldown = 0
        self._scale = 1.0

    def step(self, metric: Optional[float] = None) -> float:
        # _scale always holds the last-applied scale, so the resume point
        # records what the optimizer is running at
        scale = self._compute(metric)
        self._scale = float(scale)
        return scale

    def _compute(self, metric: Optional[float] = None) -> float:
        if self.kind is None:
            return 1.0
        k = self.kind
        if k == "plateau":
            return self._plateau_step(metric)
        # torch schedulers are stepped AFTER an epoch and their factor
        # applies to the NEXT one (last_epoch advances first)
        self.epoch += 1
        e = self.epoch
        if k == "step":
            size = int(self.args.get("step_size", 30))
            gamma = float(self.args.get("gamma", 0.1))
            return gamma ** (e // size)
        if k == "multistep":
            milestones = sorted(self.args.get("milestones", []))
            gamma = float(self.args.get("gamma", 0.1))
            return gamma ** bisect.bisect_right(milestones, e)
        if k == "exponential":
            gamma = float(self.args.get("gamma", 0.9))
            return gamma**e
        if k == "cosine":
            t_max = int(self.args.get("T_max", 50))
            eta_min = float(self.args.get("eta_min", 0.0))
            lr = eta_min + (self.base_lr - eta_min) * (1 + math.cos(math.pi * e / t_max)) / 2
            return lr / self.base_lr
        if k == "cosine_warmup":
            t0 = int(self.args.get("T_0", 10))
            t_mult = int(self.args.get("T_mult", 1))
            eta_min = float(self.args.get("eta_min", 0.0))
            t_cur, t_i = e, t0
            while t_cur >= t_i:
                t_cur -= t_i
                t_i *= t_mult
            lr = eta_min + (self.base_lr - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2
            return lr / self.base_lr
        if k == "lambda":
            # the multiplier is an eval()'d config expression of `epoch`, a
            # bare expression or a "lambda epoch: ..." string; builtins are
            # an allowlist of the arithmetic the shipped configs use
            expr = str(self.args.get("lr_lambda", "1.0"))
            scope = {key: v for key, v in self.args.items() if key != "lr_lambda"}
            scope["epoch"] = e
            scope["math"] = math
            scope["__builtins__"] = {
                "max": max, "min": min, "abs": abs, "float": float,
                "int": int, "round": round, "pow": pow,
            }
            value = eval(expr, scope)  # noqa: S307
            if callable(value):
                value = value(e)
            return float(value)
        if k in ("cyclic", "onecycle"):
            max_lr = float(self.args.get("max_lr", self.base_lr))
            total = int(self.args.get("total_steps", self.args.get("step_size_up", 10) * 2))
            pos = (e % total) / max(total - 1, 1)
            tri = 1.0 - abs(2.0 * pos - 1.0)
            lr = self.base_lr + (max_lr - self.base_lr) * tri
            return lr / self.base_lr
        raise ValueError(f"Unknown scheduler: {self.kind}")

    def _plateau_step(self, metric: Optional[float]) -> float:
        """mmtpu's plateau rule: one global scale, floored at
        min_lr / base_lr of the default group (not torch's per-group
        ReduceLROnPlateau)."""
        if metric is None:
            return self._scale
        mode = self.args.get("mode", "min")
        factor = float(self.args.get("factor", 0.1))
        patience = int(self.args.get("patience", 10))
        threshold = float(self.args.get("threshold", 1e-4))
        cooldown = int(self.args.get("cooldown", 0))
        min_lr = float(self.args.get("min_lr", 0.0))

        better = (
            self._best is None
            or (mode == "min" and metric < self._best * (1 - threshold))
            or (mode == "max" and metric > self._best * (1 + threshold))
        )
        if better:
            self._best = metric
            self._num_bad = 0
        elif self._cooldown > 0:
            self._cooldown -= 1
            self._num_bad = 0
        else:
            self._num_bad += 1
            if self._num_bad > patience:
                new_scale = max(self._scale * factor, min_lr / self.base_lr)
                if new_scale < self._scale:
                    logger.info(f"plateau: lr {self.base_lr * self._scale:.2e} → "
                                f"{self.base_lr * new_scale:.2e}")
                self._scale = new_scale
                self._cooldown = cooldown
                self._num_bad = 0
        return self._scale
