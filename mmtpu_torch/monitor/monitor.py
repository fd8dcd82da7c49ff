"""Experiment monitoring: gradient, activation and weight statistics into
`<monitor_path>/monitor_data.h5` (counterpart of `mmtpu/monitor/monitor.py`).

What is recorded, and when, is mmtpu's:

- gradients: per parameter, of the raw gradient (after the data-parallel
  all-reduce, before the clip), on every `gradient_interval`-th step;
- activations: the output of every module of one extra eval-mode forward
  under `no_grad`, on every `activation_interval`-th step, through forward
  hooks;
- weights: per parameter every epoch, with the spectral norm, effective
  rank, condition number (and symmetry for a square matrix) of every 2-D
  parameter, and the weights' L2 norms as one `convergence` record.

Each record is the `STAT_COLUMNS` vector of one tensor, computed on the
tensor's device in float32 (`leaf_stats`, mmtpu's `_leaf_stats`); one
capture crosses to the host as one stacked (L, 17) copy. The step counter
advances after the batch, so step 0 is captured. Layers are named by
mmtpu's flax paths: a parameter `audio_encoder.layer1.0.conv1.weight` is
`audio_encoder/layer1_0/conv1/kernel` (`checkpoints.interop.
mmtpu_param_path`), and the n-th output of a module in one forward is
`<mmtpu module path>/__call__/<n>` (`mmtpu_module_path`), followed by the
index or key of each tensor in a tuple or dict output. The port's modules
that flax does not have (containers, and modules without parameters:
ReLU, Dropout, pooling) record nothing; a model's `MMTPU_PARAM_MODULES`
names the children whose flax counterparts return their `(kernel, bias)`
instead of an output (AVMNIST's head), which are recorded as mmtpu records
them. BatchNorm and Dropout layers are left out by default, and an
exclusion wins over an inclusion.

Every statistic is invariant to a permutation of the tensor's elements, so
the port's layouts (OIHW convolutions, (out, in) Linear weights, NCHW
activations) give mmtpu's values; the singular values, and with them the
spectral measures, are invariant to the transposes between the layouts.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mmtpu_torch.checkpoints.interop import mmtpu_module_path, mmtpu_param_path
from mmtpu_torch.config.monitor import MonitorConfig
from mmtpu_torch.monitor.storage import MonitorStorage

DEFAULT_EXCLUDE = (r"[Bb]atch[Nn]orm", r"bn_?\d*", r"[Dd]ropout")

STAT_COLUMNS = (
    "l2", "mean", "std", "min", "max",
    "l1", "median", "p5", "p25", "p75", "p95",
    "zero_fraction", "positive_fraction", "negative_fraction",
    "skewness", "kurtosis", "saturation_fraction",
)
_PERCENTILES = (5.0, 25.0, 50.0, 75.0, 95.0)
_CONTAINERS = (nn.Sequential, nn.ModuleList, nn.ModuleDict)


def leaf_stats(t: torch.Tensor) -> torch.Tensor:
    """The (17,) float32 `STAT_COLUMNS` vector of `t` on its device:
    population std, numpy's linear-interpolated percentiles (from a sort,
    so any size works: `torch.quantile` stops at 2^24 elements), the
    fractions `|x| < 1e-7`, `x > 0`, `x < 0`, `|x| > 0.99`, and the
    standardised third and (excess) fourth moments. Nothing crosses from
    the host to the device (every constant is a Python scalar), so a
    capture's reductions queue without waiting on the card."""
    x = t.detach().reshape(-1).to(torch.float32)
    n = x.numel()
    std, mean = torch.std_mean(x, correction=0)
    z = (x - mean) / torch.clamp(std, min=1e-12)
    z2 = z * z
    # numpy's vectorised sort is an order of magnitude faster than torch's on the CPU
    ordered = (torch.from_numpy(np.sort(x.numpy())) if x.device.type == "cpu"
               else torch.sort(x).values)
    percentiles = []
    for p in _PERCENTILES:
        pos = p / 100.0 * (n - 1)
        lo, w = math.floor(pos), pos - math.floor(pos)
        percentiles.append(ordered[lo] * (1.0 - w) + ordered[math.ceil(pos)] * w)
    p5, p25, p50, p75, p95 = percentiles
    a = x.abs()
    # the counts times float32(1/n): XLA's rewrite of jnp.mean's division
    counts = torch.stack([a < 1e-7, x > 0, x < 0, a > 0.99]).sum(dim=1).to(torch.float32)
    zero, positive, negative, saturated = counts * float(np.float32(1.0 / n))
    return torch.stack([
        # sqrt of a sum, not vector_norm: the CPU's float32 vector_norm
        # drifts by 1e-3 over 2^24 elements, where sum's cascade does not
        x.square().sum().sqrt(), mean, std, ordered[0], ordered[-1],
        a.sum(), p50, p5, p25, p75, p95, zero, positive, negative,
        (z2 * z).mean(), (z2 * z2).mean() - 3.0, saturated,
    ])


def to_host(stats: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """name → (17,) device vectors as numpy rows, in one (L, 17) copy."""
    if not stats:
        return {}
    rows = torch.stack(list(stats.values())).cpu().numpy()
    return dict(zip(stats, rows))


def named_stats(named: Iterable[Tuple[str, torch.Tensor]], keep=None) -> Dict[str, torch.Tensor]:
    """name → `leaf_stats` for every named tensor `keep(name)` admits
    (mmtpu's `tree_stats`)."""
    return {name: leaf_stats(t) for name, t in named if keep is None or keep(name)}


def mmtpu_parameters(model: nn.Module) -> List[Tuple[str, torch.nn.Parameter]]:
    """(mmtpu path, parameter) for every parameter of `model`."""
    return [(mmtpu_param_path(name, p), p) for name, p in model.named_parameters()]


def _output_leaves(out: Any, prefix: str):
    """(suffix, tensor) of a module output, flattened as jax flattens a
    pytree: tuple and list items by index, dict items by sorted key."""
    if isinstance(out, torch.Tensor):
        yield prefix, out
    elif isinstance(out, (tuple, list)):
        for i, v in enumerate(out):
            yield from _output_leaves(v, f"{prefix}/{i}")
    elif isinstance(out, dict):
        for k in sorted(out):
            yield from _output_leaves(out[k], f"{prefix}/{k}")


def _call_name(path: str, n: int) -> str:
    return f"{path}/__call__/{n}" if path else f"__call__/{n}"


def capture_activations(model: nn.Module, inputs: Sequence[torch.Tensor],
                        keep=None) -> Dict[str, torch.Tensor]:
    """One eval-mode forward of `model` on `inputs` under `no_grad`, with
    every module's output reduced to `leaf_stats` by a forward hook as it
    is produced (nothing is kept), named as mmtpu names its
    `capture_intermediates`. The model's train/eval mode is restored."""
    stats: Dict[str, torch.Tensor] = {}
    calls: Dict[str, int] = {}

    def record(name: str, t: torch.Tensor) -> None:
        if keep is None or keep(name):
            stats[name] = leaf_stats(t)

    def hook_for(path: str, param_children: Sequence[Tuple[str, nn.Module]]):
        def hook(module, args, output):
            n = calls.get(path, 0)
            calls[path] = n + 1
            for child_path, child in param_children:
                # flax's `(kernel, bias)` module, called once per forward of its parent
                base = _call_name(child_path, n)
                record(f"{base}/0", child.weight)
                record(f"{base}/1", child.bias)
            for suffix, t in _output_leaves(output, _call_name(path, n)):
                record(suffix, t)
        return hook

    param_modules = set()
    handles = []
    for name, module in model.named_modules():  # a parent comes before its children
        children = [(mmtpu_module_path(f"{name}.{c}" if name else c), getattr(module, c))
                    for c in getattr(module, "MMTPU_PARAM_MODULES", ())]
        param_modules.update(id(child) for _, child in children)
        if isinstance(module, _CONTAINERS) or id(module) in param_modules:
            continue
        if not children and next(module.parameters(), None) is None:
            continue  # no flax counterpart: ReLU, Dropout, pooling
        handles.append(module.register_forward_hook(
            hook_for(mmtpu_module_path(name), children)))
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(*inputs)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return stats


def spectral_measures(w: np.ndarray) -> Dict[str, float]:
    """Singular-value measures of a 2-D weight (the reference's
    `compute_weight_stats`), on the host in numpy as mmtpu computes them.
    They do not change under the transpose between a flax kernel and the
    port's weight (nor symmetry, |W − Wᵀ|)."""
    sv = np.linalg.svd(w, compute_uv=False)
    tol = sv.max() * max(w.shape) * np.finfo(np.float32).eps
    out = {
        "spectral_norm": float(sv[0]),
        "effective_rank": float(np.sum(sv > tol)),
        "condition_number": float(sv[0] / max(sv[-1], np.finfo(np.float32).tiny)),
    }
    if w.shape[0] == w.shape[1]:
        out["symmetry"] = float(np.mean(np.abs(w - w.T)))
    return out


class ExperimentMonitor:
    """mmtpu's monitor over a torch model. `writes=False` (a data-parallel
    rank other than 0) keeps the cadence and records nothing; `storage`
    replaces the HDF5 file (`storage.MemoryStorage` on a machine without
    h5py)."""

    STAT_COLUMNS = STAT_COLUMNS

    def __init__(self, config: MonitorConfig, output_path: str, resume: bool = False,
                 writes: bool = True, storage=None) -> None:
        self.config = config
        if storage is None and writes:
            storage = MonitorStorage(
                f"{output_path}/monitor_data.h5", buffer_size=config.buffer_size,
                compression=config.compression, compression_opts=config.compression_opts,
                # --resume appends to the previous run's records
                mode="a" if resume else "w")
        self.storage = storage
        self.epoch = 0
        self.global_step = 0
        self._exclude = [re.compile(p) for p in (config.exclude_layers or DEFAULT_EXCLUDE)]
        self._include = [re.compile(p) for p in (config.include_layers or [])]

    @property
    def writes(self) -> bool:
        return self.storage is not None

    def _keep(self, name: str) -> bool:
        # the reference's precedence: an exclusion wins over an inclusion
        if any(p.search(name) for p in self._exclude):
            return False
        if self._include:
            return any(p.search(name) for p in self._include)
        return True

    # -- lifecycle --------------------------------------------------------------

    def start_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def step(self) -> None:
        """Advance the step counter after a batch, and flush every
        `flush_interval` steps."""
        self.global_step += 1
        fi = int(self.config.flush_interval or 0)
        if self.writes and fi > 0 and self.global_step % fi == 0:
            self.storage.flush()

    def end_epoch(self, model: nn.Module) -> None:
        if self.config.enable_weight_tracking:
            self.record_weights(model)
        if self.writes:
            self.storage.flush()

    def close(self) -> None:
        if self.writes:
            self.storage.close()

    @property
    def want_gradients(self) -> bool:
        return (self.config.enable_gradient_tracking
                and self.global_step % max(self.config.gradient_interval, 1) == 0)

    @property
    def want_activations(self) -> bool:
        return (self.config.enable_activation_tracking
                and self.global_step % max(self.config.activation_interval, 1) == 0)

    # -- capture ------------------------------------------------------------------

    def _append_rows(self, group: str, prefix: str, stats: Dict[str, torch.Tensor]) -> None:
        for name, row in to_host(stats).items():
            self.storage.append(group, f"{prefix}/{name}", row,
                                {"columns": ",".join(self.STAT_COLUMNS)})

    def record_gradients(self, model: nn.Module) -> None:
        """The statistics of every parameter's `.grad` as it stands (the
        train step calls this between the all-reduce and the clip)."""
        if not self.writes:
            return
        stats = named_stats(((name, p.grad if p.grad is not None else torch.zeros_like(p))
                             for name, p in mmtpu_parameters(model)), self._keep)
        self._append_rows("gradients", f"epoch_{self.epoch}/step_{self.global_step}", stats)

    def record_activations(self, model: nn.Module, inputs: Sequence[torch.Tensor]) -> None:
        """One eval forward of `model` on `inputs` (the step's masked
        inputs, as mmtpu passes them), every module's output recorded."""
        if not self.writes:
            return
        stats = capture_activations(model, inputs, self._keep)
        self._append_rows("activations", f"epoch_{self.epoch}/step_{self.global_step}", stats)

    def record_weights(self, model: nn.Module) -> None:
        if not self.writes:
            return
        params = [(name, p) for name, p in mmtpu_parameters(model) if self._keep(name)]
        host = to_host(named_stats(params))
        for name, p in params:
            self.storage.append("weights", f"epoch_{self.epoch}/{name}", host[name],
                                {"columns": ",".join(self.STAT_COLUMNS)})
            if p.dim() != 2 or min(p.shape) <= 1:
                continue
            spectral = spectral_measures(p.detach().float().cpu().numpy())
            self.storage.append("weights", f"epoch_{self.epoch}/{name}__spectral",
                                np.asarray(list(spectral.values()), np.float32),
                                {"columns": ",".join(spectral)})
        if self.config.enable_layer_convergence:
            names = sorted(host)
            self.storage.append("convergence", f"epoch_{self.epoch}/weight_l2",
                                np.asarray([host[k][0] for k in names]),
                                {"layers": ";".join(names)})
