"""Stacked runs: K independent members (CV folds or repeat runs) trained as
ONE program (counterpart of `mmtpu/train/stacked.py`).

mmtpu vmaps its train and eval steps over a leading member axis. Here the
same is built with `torch.func`: the members' parameters and buffers are
stacked (`stack_module_state`), the model runs through `functional_call`,
and the train step is `vmap` over `grad_and_value`, the eval step `vmap`
over the eval forward. Each member keeps its own parameters, BatchNorm
statistics, optimizer state, batch stream and loss; the kernels fold the
member axis into one launch (`ops/library.py`).

The optimizer is mmtpu's optax chain with a member axis (`StackedOptimizer`):
the parameter groups and coupled L2 of `train/optim.py`, state stacked per
member, Adam's step count PER MEMBER (folds of unequal length advance
different counts; `torch.optim` keeps one count per parameter tensor, which
cannot hold this), the global-norm clip per member, and the LR scale a
per-member vector (mmtpu's plateau scheduler sets it member by member).

Dead steps: when a member's sample mask is all zero (its loader is
exhausted and `StackedLoaderGroup` re-feeds its last batch), the member
keeps its parameters, BatchNorm statistics and optimizer state, so
members of unequal length match their separate runs.

Dropout: the members draw from torch's global generator under
`vmap(randomness="different")`, one mask per member, which are not the
masks their separate runs draw (ROADMAP §3).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, stack_module_state, vmap

from mmtpu_torch.models.norm import batch_mask
from mmtpu_torch.train.optim import LBFGS, OptaxTransform
from mmtpu_torch.train.state import TrainState
from mmtpu_torch.train.step import has_padded_rows, output_logits, to_device


def stack_batches(batches: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """K members' host batches: every key gains a leading K axis."""
    return {key: np.stack([np.asarray(b[key]) for b in batches]) for key in batches[0]}


class StackedLoaderGroup:
    """K loaders in lockstep, yielding stacked host batches. A member whose
    loader is exhausted re-feeds its last batch with a zero sample_mask, so
    every step has the shapes (K, B, ...) and finished members add nothing
    to loss or metrics."""

    def __init__(self, loaders: Sequence[Any]) -> None:
        self.loaders = list(loaders)
        self.k = len(loaders)

    def __len__(self) -> int:
        return max(len(ld) for ld in self.loaders)

    def __iter__(self):
        iters = [iter(ld) for ld in self.loaders]
        lasts: List[Any] = [None] * self.k
        for _ in range(len(self)):
            group = []
            for i, it in enumerate(iters):
                try:
                    b = next(it)
                    lasts[i] = b
                except StopIteration:
                    if lasts[i] is None:
                        raise ValueError(
                            f"stacked run {i} produced zero batches — its split is empty "
                            "(too few samples for this fold?); stacking needs every run to "
                            "yield at least one batch")
                    b = dict(lasts[i])
                    b["sample_mask"] = np.zeros_like(np.asarray(b.get(
                        "sample_mask", np.ones(np.asarray(b["labels"]).shape[0], np.float32))))
                group.append(b)
            for b in group:
                if "sample_mask" not in b:
                    b["sample_mask"] = np.ones(np.asarray(b["labels"]).shape[0], np.float32)
            yield stack_batches(group)


def _kind(optimizer: torch.optim.Optimizer) -> str:
    if isinstance(optimizer, OptaxTransform):
        return optimizer.kind
    if isinstance(optimizer, LBFGS):
        return "lbfgs"
    for cls, kind in ((torch.optim.AdamW, "adamw"), (torch.optim.Adam, "adam"),
                      (torch.optim.SGD, "sgd"), (torch.optim.Adadelta, "adadelta")):
        if isinstance(optimizer, cls):
            return kind
    raise ValueError(f"no stacked form of {type(optimizer).__name__}")


def _lead(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (K,) vector shaped to broadcast over (K, ...) `like`."""
    return v.reshape(-1, *([1] * (like.dim() - 1)))


class StackedOptimizer:
    """The update of `train/optim.py`'s optimizer for each member, on
    (K, ...) tensors: the same kind, the same parameter groups and options
    (read from member 0's torch optimizer), coupled L2 where the kind has
    it. State is per member, the step count a (K,) vector, the lr
    base_lr × `lr_scale[k]`. `step` leaves a dead member's parameters and
    state as they were."""

    STATE = {"adam": ("exp_avg", "exp_avg_sq"), "adamw": ("exp_avg", "exp_avg_sq"),
             "sparse_adam": ("mu", "nu"), "adamax": ("mu", "nu"), "sgd": ("momentum_buffer",),
             "rmsprop": ("nu", "trace"), "adagrad": ("sum_of_squares",),
             "adadelta": ("square_avg", "acc_delta")}

    def __init__(self, optimizer: torch.optim.Optimizer, names: Dict[int, str],
                 params: Dict[str, torch.Tensor], members: int) -> None:
        self.kind = _kind(optimizer)
        self._torch = optimizer
        self.groups = []  # (parameter names, options)
        for group in optimizer.param_groups:
            opts = {k: v for k, v in group.items() if k != "params"}
            self.groups.append(([names[id(p)] for p in group["params"]], opts))
        dev = next(iter(params.values())).device
        self.count = torch.zeros(members, dtype=torch.int64, device=dev)
        self.lr_scale = torch.ones(members, dtype=torch.float32, device=dev)
        fill = {"sum_of_squares": 0.1}
        self.state = {n: {key: torch.full_like(p, fill.get(key, 0.0))
                          for key in self.STATE.get(self.kind, ())}
                      for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             live: torch.Tensor) -> None:
        """One update of every live member, in place."""
        if self.kind == "lbfgs":
            self._torch.step()  # raises, as a sequential run's first step does
        self.count += live.to(self.count.dtype)
        count = self.count.double()
        for names, opts in self.groups:
            lr = self.lr_scale.double() * opts["base_lr"]
            for n in names:
                p, st = params[n], self.state[n]
                keep = _lead(live, p)
                new_p, new_st = self._update(p, grads[n], st, opts, lr, count)
                p.copy_(torch.where(keep, new_p, p))
                for k, v in new_st.items():
                    st[k].copy_(torch.where(keep, v, st[k]))

    def _update(self, p, g, st, opts, lr, count):
        """Member-wise update, out of place → (new parameters, new state).
        `lr` and `count` are (K,) float64, as torch takes its scalars."""
        kind, wd = self.kind, opts.get("weight_decay", 0.0)

        def per(v):  # a (K,) float64 vector as float32 broadcast over p
            return _lead(v.float(), p)

        if kind == "adamw":
            p = p * per(1 - lr * wd)
        elif wd:
            g = g + wd * p
        if kind in ("adam", "adamw"):  # torch's Adam, its scalars in float64
            b1, b2 = opts["betas"]
            mu = st["exp_avg"].lerp(g, 1 - b1)
            nu = torch.addcmul(st["exp_avg_sq"] * b2, g, g, value=1 - b2)
            denom = nu.sqrt() / per((1 - b2 ** count).sqrt()) + opts["eps"]
            return (p - per(lr / (1 - b1 ** count)) * (mu / denom),
                    {"exp_avg": mu, "exp_avg_sq": nu})
        if kind == "sgd":
            if not opts.get("momentum"):
                return p - per(lr) * g, {}
            buf = st["momentum_buffer"] * opts["momentum"] + g
            u = g + opts["momentum"] * buf if opts.get("nesterov") else buf
            return p - per(lr) * u, {"momentum_buffer": buf}
        if kind == "adadelta":
            rho, eps = opts["rho"], opts["eps"]
            sq = torch.addcmul(st["square_avg"] * rho, g, g, value=1 - rho)
            delta = (st["acc_delta"] + eps).sqrt() / (sq + eps).sqrt() * g
            acc = torch.addcmul(st["acc_delta"] * rho, delta, delta, value=1 - rho)
            return p - per(lr) * delta, {"square_avg": sq, "acc_delta": acc}
        if kind == "rmsprop":
            nu = st["nu"] * opts["alpha"] + (1 - opts["alpha"]) * g.square()
            u = g * torch.rsqrt(nu + opts["eps"])
            new = {"nu": nu}
            if opts["momentum"]:
                u = new["trace"] = st["trace"] * opts["momentum"] + u
            return p - per(lr) * u, new
        if kind == "adagrad":
            acc = st["sum_of_squares"] + g.square()
            return (p - per(lr) * (torch.where(acc > 0, torch.rsqrt(acc + 1e-7), 0.0) * g),
                    {"sum_of_squares": acc})
        # adamax and sparse_adam: optax's, bias corrections in float32
        b1, b2 = opts["betas"]
        count32 = count.float()
        mu = st["mu"] * b1 + (1 - b1) * g
        mu_hat = mu / _lead(1 - torch.tensor(b1, dtype=torch.float32) ** count32, p)
        if kind == "adamax":
            nu = torch.maximum(g.abs() + 1e-8, b2 * st["nu"])
            return p - per(lr) * (mu_hat / nu), {"mu": mu, "nu": nu}
        nu = st["nu"] * b2 + (1 - b2) * g.square()
        bc2 = _lead(1 - torch.tensor(b2, dtype=torch.float32) ** count32, p)
        return p - per(lr) * (mu_hat / (torch.sqrt(nu / bc2) + opts["eps"])), {"mu": mu, "nu": nu}

    def write_member(self, k: int, optimizer: torch.optim.Optimizer,
                     params: Dict[str, torch.nn.Parameter]) -> None:
        """Member k's state into its own torch optimizer, in that
        optimizer's layout (what its checkpoints hold)."""
        count = int(self.count[k])
        for names, opts in self.groups:
            for n in names:
                p = params[n]
                st = {key: v[k].clone() for key, v in self.state[n].items()}
                if self.kind in ("adam", "adamw", "adadelta"):
                    st["step"] = torch.tensor(float(count), device=p.device)
                elif self.kind in ("sparse_adam", "adamax"):
                    st["count"] = count
                elif self.kind == "sgd" and not opts.get("momentum"):
                    st = {"momentum_buffer": None}
                elif self.kind == "rmsprop" and not opts["momentum"]:
                    del st["trace"]
                optimizer.state[p] = st


def clip_per_member(grads: Dict[str, torch.Tensor], max_norm: float) -> None:
    """`clip_by_global_norm` for each member: member k's gradients scaled by
    max_norm / norm_k where its global norm is at least max_norm."""
    norms = torch.stack([g.flatten(1).norm(dim=1) for g in grads.values()]).norm(dim=0)
    factor = torch.where(norms < max_norm, torch.ones_like(norms), max_norm / norms)
    for g in grads.values():
        g.mul_(_lead(factor, g))


class StackedModel:
    """K members' models, optimizers and clip as one stacked program; the
    members' own `TrainState`s receive their slices on `member_state`."""

    def __init__(self, task, states: Sequence[TrainState]) -> None:
        self.task = task
        self.states = list(states)
        self.k = len(states)
        models = [s.model for s in states]
        params, buffers = stack_module_state(models)
        self.params = {n: p.detach() for n, p in params.items()}
        self.buffers = buffers
        # the template functional_call runs; a generator a module draws from
        # is shared, not copied
        gens = {id(m.generator): m.generator for m in models[0].modules()
                if getattr(m, "generator", None) is not None}
        self.base = copy.deepcopy(models[0], memo=gens).to("meta")
        names = {id(p): n for n, p in models[0].named_parameters()}
        self.optimizer = StackedOptimizer(states[0].optimizer, names, self.params, self.k)
        self.clip = states[0].clip

    def _forward(self, params, buffers, batch, train: bool, bn_mask):
        self.base.train(train)
        with batch_mask(bn_mask):
            return functional_call(self.base, (params, buffers), tuple(self.task.inputs(batch)))

    def train_step(self, host_batch: Dict[str, np.ndarray], device: torch.device
                   ) -> Dict[str, torch.Tensor]:
        """One step of every member on its slice of the stacked host batch;
        outputs (K, ...) on the device: loss, preds, labels, pattern_id,
        sample_mask."""
        padded = has_padded_rows(host_batch)
        batch = to_device(host_batch, device)
        task = self.task

        def member_loss(params, buffers, batch):
            mask = batch["sample_mask"]
            out = self._forward(params, buffers, batch, True, mask if padded else None)
            loss = task.loss(out, batch, sample_mask=mask)
            return loss, output_logits(out)

        buffers = {n: b.clone() for n, b in self.buffers.items()}
        grads, (loss, logits) = vmap(grad_and_value(member_loss, has_aux=True),
                                     randomness="different")(self.params, buffers, batch)
        live = (batch["sample_mask"] > 0).any(dim=1)
        if self.clip:
            clip_per_member(grads, self.clip)
        self.optimizer.step(self.params, grads, live)
        with torch.no_grad():
            for n, b in self.buffers.items():
                b.copy_(torch.where(_lead(live, b), buffers[n], b))
        return self._outputs(batch, loss.detach(), logits.detach())

    @torch.no_grad()
    def eval_step(self, host_batch: Dict[str, np.ndarray], device: torch.device
                  ) -> Dict[str, torch.Tensor]:
        padded = has_padded_rows(host_batch)
        batch = to_device(host_batch, device)
        task = self.task

        def member_eval(params, buffers, batch):
            mask = batch["sample_mask"]
            out = self._forward(params, buffers, batch, False, mask if padded else None)
            return task.loss(out, batch, sample_mask=mask), output_logits(out)

        loss, logits = vmap(member_eval)(self.params, self.buffers, batch)
        return self._outputs(batch, loss, logits)

    def _outputs(self, batch, loss, logits) -> Dict[str, torch.Tensor]:
        out = {"loss": loss, "preds": self.task.predictions(logits),
               "labels": batch["labels"], "sample_mask": batch["sample_mask"]}
        if "pattern_id" in batch:
            out["pattern_id"] = batch["pattern_id"]
        return out

    def member_state(self, k: int) -> TrainState:
        """Member k's `TrainState` with its current parameters, buffers,
        optimizer state and step count."""
        st = self.states[k]
        with torch.no_grad():
            named = dict(st.model.named_parameters())
            for n, p in named.items():
                p.copy_(self.params[n][k])
            for n, b in st.model.named_buffers():
                b.copy_(self.buffers[n][k])
        self.optimizer.write_member(k, st.optimizer, named)
        st.step = int(self.optimizer.count[k])
        return st

    def restack(self) -> None:
        """Parameters and buffers from the members' own models again (after
        each has restored its best checkpoint)."""
        params, buffers = stack_module_state([s.model for s in self.states])
        self.params = {n: p.detach() for n, p in params.items()}
        self.buffers = buffers
