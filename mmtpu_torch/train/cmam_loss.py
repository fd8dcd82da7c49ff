"""The composite reconstruction loss of C-MAM training (counterpart of
mmtpu/train/cmam_loss.py).

Cosine (1 − the masked mean of the rows' cosine similarity, eps in the
denominator), MAE and MSE always; then, each when its weight is positive,
a Gaussian-kernel MMD, moment matching, a cyclic term through a given
`forward_func`, a MINE-style mutual-information term through a given critic,
and a downstream classification term (`ce`, `bce` or `mse` on the logits the
frozen base model gives the reconstruction). Returns the dict of terms plus
'total_loss'; `sample_mask` keeps padded tail rows out of every term.

mmtpu draws the MI term's negative permutation from a JAX PRNG key; here it
comes from an explicit `torch.Generator` (or is handed in as `perm`), never
from torch's global generator. `rec_weight` and `maximize_cosine` are
accepted and unused, as in mmtpu and the reference.

Under a data-parallel mesh (`with mesh:`, `parallel/mesh.py`) every term
is this rank's share of the global batch's value, and the shares sum to
it: the row means through `_masked_reduce`'s global denominators; the MMD
and the moments computed by every rank alike on the gathered rows
(`global_rows`) and counted 1/N on each (`replicated_share`), as is the
cosine's constant 1; the MI term's negatives pair this rank's originals
with the gathered predictions under a permutation of the GLOBAL batch,
drawn on rank 0 from its generator and broadcast, their log-mean taken of
the global sum and count. mmtpu computes all of them on its global arrays.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from mmtpu_torch.parallel.mesh import active_mesh, global_rows
from mmtpu_torch.train import losses as L


def _cdist_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared pairwise euclidean distances, (n, m)."""
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1, keepdim=True).T
    return torch.clamp(x2 + y2 - 2.0 * (x @ y.T), min=0.0)


def gaussian_kernel(x: torch.Tensor, y: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    return torch.exp(-_cdist_sq(x, y) / (2.0 * sigma ** 2))


def _pair_mean(k: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel-matrix mean over real-row pairs (w is a (B,) 0/1 mask)."""
    if w is None:
        return k.mean()
    ww = w[:, None] * w[None, :]
    return (k * ww).sum() / torch.clamp(ww.sum(), min=1e-8)


def mmd_loss(x: torch.Tensor, y: torch.Tensor, sigma: float = 1.0,
             sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Gaussian-kernel MMD over the (global) batch's real-row pairs."""
    x, y, sample_mask = global_rows(x), global_rows(y), global_rows(sample_mask)
    return L.replicated_share(_pair_mean(gaussian_kernel(x, x, sigma), sample_mask)
                              + _pair_mean(gaussian_kernel(y, y, sigma), sample_mask)
                              - 2.0 * _pair_mean(gaussian_kernel(x, y, sigma), sample_mask))


def _masked_mean0(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    if w is None:
        return x.mean(0)
    ws = w.reshape((-1,) + (1,) * (x.dim() - 1))
    return (x * ws).sum(0) / torch.clamp(w.sum(), min=1e-8)


def moment_matching_loss(x: torch.Tensor, y: torch.Tensor, num_moments: int = 2,
                         sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The squared differences of the (global) batch's first moments."""
    x, y, sample_mask = global_rows(x), global_rows(y), global_rows(sample_mask)
    loss = 0.0
    for i in range(1, num_moments + 1):
        xm = _masked_mean0(x ** i, sample_mask)
        ym = _masked_mean0(y ** i, sample_mask)
        loss = loss + ((xm - ym) ** 2).mean()
    return L.replicated_share(loss)


def global_permutation(n: int, generator: Optional[torch.Generator],
                       device: torch.device) -> torch.Tensor:
    """A permutation of the (global) batch's `n` rows from `generator`;
    under a mesh, rank 0's draw, broadcast (the other ranks draw nothing)."""
    mesh = active_mesh()
    if mesh is not None and mesh.rank != 0:
        perm = torch.empty(n, dtype=torch.long, device=device)
    else:
        if generator is None:
            raise ValueError("MI term requires an explicit torch.Generator")
        perm = torch.randperm(n, generator=generator, device=generator.device).to(device)
    if mesh is not None:
        mesh.broadcast_([perm])
    return perm


_CLS_LOSSES = {"ce": L.cross_entropy, "bce": L.bce_with_logits, "mse": L.mse}


class CMAMLoss:
    """Callable composite loss; the signature is mmtpu's, with `generator`
    (or `perm`) where mmtpu takes `rng`."""

    def __init__(
        self,
        x_dims: Union[int, Sequence[int]] = 0,
        z_dim: int = 0,
        cosine_weight: float = 1.0,
        mae_weight: float = 1.0,
        mse_weight: float = 1.0,
        rec_weight: float = 1.0,
        cls_weight: float = 0.005,
        mmd_weight: float = 0.0,
        moment_weight: float = 0.0,
        cyclic_weight: float = 0.0,
        mi_weight: float = 0.0,
        num_moments: int = 2,
        mmd_sigma: float = 1.0,
        maximize_cosine: bool = True,
        epsilon: float = 1e-8,
        cls_loss_type: str = "ce",
        num_classes: Optional[int] = None,
    ) -> None:
        self.cosine_weight = cosine_weight
        self.mae_weight = mae_weight
        self.mse_weight = mse_weight
        self.rec_weight = rec_weight  # unused, as in mmtpu and the reference
        self.cls_weight = cls_weight
        self.mmd_weight = mmd_weight
        self.moment_weight = moment_weight
        self.cyclic_weight = cyclic_weight
        self.mi_weight = mi_weight
        self.num_moments = num_moments
        self.mmd_sigma = mmd_sigma
        self.maximize_cosine = maximize_cosine  # unused, as in mmtpu and the reference
        self.epsilon = epsilon
        self.cls_loss_type = cls_loss_type.lower()
        self.x_dims = x_dims
        self.z_dim = z_dim
        if self.cls_loss_type not in _CLS_LOSSES:
            raise ValueError(f"Unsupported cls_loss_type: {cls_loss_type}")
        self._cls_loss = _CLS_LOSSES[self.cls_loss_type]

    def __call__(
        self,
        predictions: torch.Tensor,
        targets: torch.Tensor,
        originals: Optional[List[torch.Tensor]] = None,
        reconstructed: Optional[torch.Tensor] = None,
        forward_func: Optional[Callable] = None,
        cls_logits: Optional[torch.Tensor] = None,
        cls_labels: Optional[torch.Tensor] = None,
        mi_critic: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
        sample_mask: Optional[torch.Tensor] = None,
        perm: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        p = L._as_float(predictions)
        t = L._as_float(targets)
        sm = sample_mask

        sim = (p * t).sum(1) / (torch.linalg.vector_norm(p, dim=1)
                                * torch.linalg.vector_norm(t, dim=1) + self.epsilon)
        cosine = (L.replicated_share(1.0) - L._masked_reduce(sim, sm)) * self.cosine_weight
        mae = L.l1(p, t, sample_mask=sm) * self.mae_weight
        mse = L.mse(p, t, sample_mask=sm) * self.mse_weight
        total = cosine + mae + mse
        out: Dict[str, Any] = {"cosine": cosine, "mae": mae, "mse": mse}

        if self.mmd_weight > 0:
            mmd = mmd_loss(p, t, self.mmd_sigma, sample_mask=sm)
            total = total + self.mmd_weight * mmd
            out["mmd"] = mmd

        if self.moment_weight > 0:
            mm = moment_matching_loss(p, t, self.num_moments, sample_mask=sm)
            total = total + self.moment_weight * mm
            out["moment_loss"] = mm

        if (self.cyclic_weight > 0 and originals is not None and reconstructed is not None
                and forward_func is not None):
            cyc = L.mse(forward_func(reconstructed), originals, sample_mask=sm)
            total = total + self.cyclic_weight * cyc
            out["cyclic_loss"] = cyc

        if self.mi_weight > 0 and originals is not None and mi_critic is not None:
            mi = self._mi(p, originals, mi_critic, generator, sm, perm)
            total = total + self.mi_weight * mi
            out["mi_loss"] = mi

        if self.cls_weight > 0 and cls_logits is not None and cls_labels is not None:
            cls = self._cls_loss(cls_logits, cls_labels, sample_mask=sm)
            total = total + self.cls_weight * cls
            out["cls_loss"] = cls

        out["total_loss"] = total
        return out

    def _mi(self, p, originals, mi_critic, generator, sm, perm) -> torch.Tensor:
        """The MI term: the positives' masked mean, and the negatives
        (originals[i] against the predictions' row perm[i] of the global
        batch, both rows real for the pair to count) log-averaged over the
        global sum and count; on a mesh, this rank's share of it."""
        mesh = active_mesh()
        gathered = global_rows(p)
        if perm is None:
            perm = global_permutation(gathered.shape[0], generator, p.device)
        perm = perm.to(p.device)
        if mesh is not None:
            perm = perm[mesh.rows(gathered.shape[0])]
        w = torch.ones(p.shape[0], dtype=p.dtype, device=p.device) if sm is None \
            else sm.reshape(-1)
        wn = w * global_rows(w)[perm]
        pos = mi_critic(originals, p)
        neg = mi_critic(originals, gathered[perm])
        neg_sum = (torch.exp(neg.reshape(-1)) * wn).sum()
        if mesh is not None:
            neg_sum = mesh.all_reduce(neg_sum)
        log_mean = torch.log(neg_sum / torch.clamp(L.global_count(wn), min=1e-8) + self.epsilon)
        return -L._masked_reduce(pos.reshape(-1), w) + L.replicated_share(log_mean)
