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
`F.batch_norm`'s fused training kernels. Under a data-parallel mesh (the
step runs `with mesh:`, `parallel/mesh.py`) the train-mode statistics are
always the written-out ones, over the real rows of the GLOBAL batch, full
or padded: the counts, sums and centred sums of squares are summed over the
ranks, so every rank normalises with, and keeps, the single-device run's
statistics. The state-dict keys are those of
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

from mmtpu_torch.parallel.mesh import active_mesh

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

    def _masked(self, x: torch.Tensor, mask: Optional[torch.Tensor], dims,
                mesh) -> tuple:
        """The statistics over the real rows (every row without a mask),
        over the whole global batch under a mesh: the counts and sums, then
        the centred sums of squares, summed over the ranks by a reduction
        whose backward sums the ranks' gradients. Written out:
        F.batch_norm(training=False) with computed statistics would treat
        them as constants in the backward."""
        shape = [1, -1] + [1] * (x.dim() - 2)
        if mask is None:
            m = torch.ones([x.shape[0]] + [1] * (x.dim() - 1), dtype=x.dtype, device=x.device)
        else:
            m = (mask > 0).to(x.dtype).reshape([-1] + [1] * (x.dim() - 1))
        per_row = x.numel() // max(x.shape[0] * x.shape[1], 1)
        sums = torch.cat([(x * m).sum(dims), (m.sum() * per_row).reshape(1)])
        if mesh is not None:
            sums = mesh.all_reduce(sums)
        count = torch.clamp(sums[-1], min=1.0)
        mean = sums[:-1] / count
        centred = x - mean.reshape(shape)
        squares = (centred.square() * m).sum(dims)
        if mesh is not None:
            squares = mesh.all_reduce(squares)
        var = squares / count
        y = centred * torch.rsqrt(var.reshape(shape) + self.eps)
        y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y, mean.detach(), var.detach()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        dims = [0] + list(range(2, x.dim()))
        mask = current_mask()
        if mask is None or mask.dim() != 1 or mask.shape[0] != x.shape[0]:
            mask = None
        mesh = active_mesh()
        if mesh is None and mask is None:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x, dims, correction=0)
        else:
            y, mean, var = self._masked(x, mask, dims, mesh)
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
