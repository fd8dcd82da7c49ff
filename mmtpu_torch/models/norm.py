"""Pad-aware BatchNorm (counterpart of `mmtpu/models/norm.py`).

Fixed-shape batches zero-pad their tail rows when a split is not a batch
multiple. The loss masks those rows; BatchNorm must too, or the zeros bias
the batch statistics and the running averages. The train step publishes
the batch's (B,) sample mask for the duration of the forward
(`batch_mask`), and every `BatchNorm` below reads it:

- train mode: mean and variance over the real rows only, the variance the
  biased one (as flax's `nn.BatchNorm`); every row is normalised with
  those statistics; running update ``new = 0.9·old + 0.1·batch_stat``;
- eval mode: the running statistics through `F.batch_norm` (cuDNN on the
  card), exactly as `nn.BatchNorm2d`/`1d` did, so served outputs do not
  change.

With no mask published, or one whose length is not the input's leading
dimension, the statistics are taken over every row. The step publishes a
mask only when the batch has padded rows, so a full batch takes
`F.batch_norm`'s fused training kernels. The state-dict keys are those of
`nn.BatchNorm*` (`weight`, `bias`, `running_mean`, `running_var`,
`num_batches_tracked`), so `.pth` files and `from_jax_variables` are
unchanged.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, Optional

import torch
from torch import nn
from torch.nn import functional as F

EPS = 1e-5
MOMENTUM = 0.1  # weight of the batch statistic: 1 - flax momentum 0.9

_local = threading.local()


@contextmanager
def batch_mask(mask: Optional[torch.Tensor]) -> Iterator[None]:
    """Publish the current batch's (B,) sample mask (1 = real row) to every
    BatchNorm run inside the `with` body, on this thread. None is allowed."""
    stack = _local.__dict__.setdefault("stack", [])
    stack.append(mask)
    try:
        yield
    finally:
        stack.pop()


def current_mask() -> Optional[torch.Tensor]:
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over the channel axis 1 of (B, C) or (B, C, H, W) inputs,
    with batch statistics over the published mask's real rows."""

    def __init__(self, num_features: int, eps: float = EPS,
                 momentum: float = MOMENTUM) -> None:
        super().__init__(num_features, eps=eps, momentum=momentum)

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"BatchNorm expects (B, C) or (B, C, H, W), got {tuple(x.shape)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        dims = [0] + list(range(2, x.dim()))
        mask = current_mask()
        if mask is None or mask.dim() != 1 or mask.shape[0] != x.shape[0]:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x, dims, correction=0)
        else:
            # written out: F.batch_norm(training=False) with computed
            # statistics would treat them as constants in the backward
            shape = [1, -1] + [1] * (x.dim() - 2)
            m = (mask > 0).to(x.dtype).reshape([-1] + [1] * (x.dim() - 1))
            count = torch.clamp(m.sum() * (x[0, 0].numel()), min=1.0)
            mean = (x * m).sum(dims) / count
            centred = x - mean.reshape(shape)
            var = (centred.square() * m).sum(dims) / count
            y = centred * torch.rsqrt(var.reshape(shape) + self.eps)
            y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
            mean, var = mean.detach(), var.detach()
        with torch.no_grad():
            if torch._C._functorch.is_functorch_wrapped_tensor(self.running_mean):
                # stacked members (vmap): lerp_ has no batching rule, the
                # out-of-place lerp has, and copy_ writes it through
                self.running_mean.copy_(torch.lerp(self.running_mean, mean, self.momentum))
                self.running_var.copy_(torch.lerp(self.running_var, var, self.momentum))
            else:
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return y
