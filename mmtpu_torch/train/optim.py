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

Every optimizer computes the update of mmtpu's optax chain for its group
(`mmtpu/train/optim.py::_group_tx`), and reads only the config kwargs that
chain reads (the others are ignored, as there):
- "adam": coupled L2 (`torch.optim.Adam(weight_decay=...)`, not AdamW);
  "adamw" decoupled; "sgd" momentum and nesterov; "adadelta" coupled L2
  then `scale_by_adadelta(rho, eps)`, torch's Adadelta (its default lr is
  mmtpu's 1e-3, not torch's 1.0); "asgd" coupled L2 and plain −lr, nothing
  averaged, so torch's SGD without momentum. These take torch's own
  optimizers, whose arithmetic is optax's (Adam fused on the card);
- "rmsprop", "adagrad", "adamax", "sparse_adam": `OptaxTransform`,
  coupled L2 then optax's `scale_by_rms(alpha, eps)` (eps inside the root,
  ν from 0) with `trace(momentum)`, `scale_by_rss()` (accumulator from 0.1,
  eps 1e-7 inside the root), `scale_by_adamax(b1, b2)` (eps 1e-8 whatever
  the config says) or `optax.adam(lr)` (sparse_adam: b1 0.9, b2 0.999, eps
  1e-8, the config's weight decay, betas and eps ignored), then −lr. Torch
  has none of the first three. Its Adam takes the bias corrections in
  float64 on the CPU, where optax takes them in float32: 6.8e-6 relative
  apart at step 1 with b2 0.999, so sparse_adam, held to optax at 1e-6,
  takes them here in float32; "adam" keeps torch's fused Adam for the
  card's main path;
- "lbfgs": `optax.lbfgs(lr)` builds in mmtpu, but its line search needs the
  loss as a function, which mmtpu's train step does not pass, so its first
  update raises; the port's `LBFGS` builds and raises at its first step.
The global-norm `clip` runs before any of them (`train/step.py`).
"""

from __future__ import annotations

import bisect
import logging
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mmtpu_torch.checkpoints.interop import mmtpu_param_path
from mmtpu_torch.config.optim import OptimizerConfig

logger = logging.getLogger(__name__)

TORCH_OPTIMIZERS = {"adam": torch.optim.Adam, "adamw": torch.optim.AdamW,
                    "sgd": torch.optim.SGD, "adadelta": torch.optim.Adadelta,
                    "asgd": torch.optim.SGD}


def _bias_correction(decay: float, count: int) -> float:
    """1 − decay^count in float32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** int(count))


class OptaxTransform(torch.optim.Optimizer):
    """One of optax's gradient transformations as a torch optimizer: per
    parameter, g ← g + weight_decay·p (optax's `add_decayed_weights`, only
    where the group has weight decay), u ← the `kind`'s transformation of g,
    p ← p − lr·u. State lives on the parameter's device; the step count is
    a Python int."""

    DEFAULTS = {
        "rmsprop": {"alpha": 0.99, "eps": 1e-8, "momentum": 0.0},
        "adagrad": {},
        "adamax": {"betas": (0.9, 0.999)},
        "sparse_adam": {"betas": (0.9, 0.999), "eps": 1e-8},
    }

    def __init__(self, params, kind: str, lr: float = 1e-3, weight_decay: float = 0.0) -> None:
        if kind not in self.DEFAULTS:
            raise ValueError(f"OptaxTransform kind {kind!r} not in {sorted(self.DEFAULTS)}")
        self.kind = kind
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay,
                                  **self.DEFAULTS[kind]})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                p.add_(self._update(g, self.state[p], group), alpha=-group["lr"])
        return loss

    def _update(self, g: torch.Tensor, state: Dict[str, Any], group: Dict[str, Any]):
        kind = self.kind
        if kind == "rmsprop":
            nu = state.setdefault("nu", torch.zeros_like(g))
            nu.mul_(group["alpha"]).add_((1 - group["alpha"]) * g.square())
            u = g * torch.rsqrt(nu + group["eps"])
            if group["momentum"]:
                trace = state.setdefault("trace", torch.zeros_like(g))
                u = trace.mul_(group["momentum"]).add_(u)
            return u
        if kind == "adagrad":
            acc = state.setdefault("sum_of_squares", torch.full_like(g, 0.1))
            acc.add_(g.square())
            return torch.where(acc > 0, torch.rsqrt(acc + 1e-7), 0.0) * g
        # adamax (optax's scale_by_adamax, eps 1e-8) and sparse_adam (scale_by_adam)
        b1, b2 = group["betas"]
        count = state["count"] = state.get("count", 0) + 1
        mu = state.setdefault("mu", torch.zeros_like(g))
        nu = state.setdefault("nu", torch.zeros_like(g))
        mu.mul_(b1).add_((1 - b1) * g)
        mu_hat = mu / _bias_correction(b1, count)
        if kind == "adamax":
            torch.maximum(g.abs() + 1e-8, b2 * nu, out=nu)
            return mu_hat / nu
        nu.mul_(b2).add_((1 - b2) * g.square())
        return mu_hat / (torch.sqrt(nu / _bias_correction(b2, count)) + group["eps"])


class LBFGS(torch.optim.Optimizer):
    """mmtpu's `lbfgs` (`optax.lbfgs(lr)`): it builds, and its first step
    raises, as mmtpu's first update does."""

    def __init__(self, params, lr: float = 1e-3, weight_decay: float = 0.0) -> None:
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay})

    def step(self, closure=None):
        raise NotImplementedError(
            "optimizer 'lbfgs' cannot take a step: mmtpu builds it as optax.lbfgs(lr), whose "
            "zoom line search needs the loss as a value function (value, grad, value_fn), "
            "which mmtpu's train step does not pass, so its first update raises there too; "
            "use another optimizer")


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
    elif name == "sparse_adam":  # optax.adam(lr): its defaults, no weight decay
        out.update(weight_decay=0.0, betas=(0.9, 0.999), eps=1e-8)
    elif name == "rmsprop":
        out.update(alpha=float(kw.pop("alpha", 0.99)), eps=float(kw.pop("eps", 1e-8)),
                   momentum=float(kw.pop("momentum", 0.0)))
    elif name == "adadelta":
        out.update(rho=float(kw.pop("rho", 0.9)), eps=float(kw.pop("eps", 1e-6)))
    elif name == "adamax":
        out["betas"] = tuple(float(b) for b in kw.pop("betas", (0.9, 0.999)))
    return out


def build_optimizer(
    config: OptimizerConfig,
    model: nn.Module,
    extra_groups: Optional[Sequence[Tuple[str, Dict[str, Any]]]] = None,
) -> Tuple[torch.optim.Optimizer, Dict[str, Dict[str, Any]]]:
    """Returns (optimizer, report): report maps each group's name to its
    effective kwargs, as mmtpu's does."""
    name = config.name.lower()
    if name not in TORCH_OPTIMIZERS and name not in OptaxTransform.DEFAULTS and name != "lbfgs":
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
    if name in OptaxTransform.DEFAULTS:
        return OptaxTransform(param_groups, name), report
    if name == "lbfgs":
        return LBFGS(param_groups), report
    cls = TORCH_OPTIMIZERS[name]
    options: Dict[str, Any] = {}
    if next(iter(named.values())).is_cuda:
        if cls in (torch.optim.Adam, torch.optim.AdamW):
            options["fused"] = True  # one kernel for all tensors; the CPU takes the default
        elif cls is torch.optim.Adadelta:
            options["capturable"] = True  # its step count on the card, not the host
    return cls(param_groups, **options), report


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
