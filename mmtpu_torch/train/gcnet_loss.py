"""GCNet's masked losses (counterpart of mmtpu/train/gcnet_loss.py).

Batch-major padded tensors; `umask` marks the valid utterances.
"""

from __future__ import annotations

import torch


def masked_recon_loss(recon: torch.Tensor, target: torch.Tensor, present_mask: torch.Tensor,
                      umask: torch.Tensor, adim: int, tdim: int, vdim: int) -> torch.Tensor:
    """Squared error on the MISSING modalities only: recon/target (B, T,
    adim + tdim + vdim), present_mask (B, T, 3), 1 = present (the weight
    is 1 − present); each modality's sum over its dim, the total over
    sum(umask)."""
    um = umask[..., None].to(recon.dtype)
    se = (recon * um - target * um) ** 2
    splits = ((0, adim, 0, adim), (adim, adim + tdim, 1, tdim),
              (adim + tdim, adim + tdim + vdim, 2, vdim))
    total = 0.0
    for lo, hi, m, dim in splits:
        w = (1.0 - present_mask[..., m]).to(recon.dtype)[..., None]
        total = total + (se[..., lo:hi] * w).sum() / dim
    return total / umask.sum()


def masked_ce_loss(logits: torch.Tensor, target: torch.Tensor,
                   umask: torch.Tensor) -> torch.Tensor:
    """Cross entropy with the log-probs multiplied by umask (padded rows
    zeroed) and padded targets collapsed to class 0, over sum(umask).
    logits (B, T, C) or (N, C); target and umask (B, T) or (N,)."""
    logp = torch.log_softmax(logits, dim=-1).reshape(-1, logits.shape[-1])
    um = umask.reshape(-1, 1).to(logits.dtype)
    tgt = (target.reshape(-1) * umask.reshape(-1)).to(torch.long)
    picked = torch.gather(logp * um, 1, tgt[:, None])[:, 0]
    return -picked.sum() / umask.sum()


def masked_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                    umask: torch.Tensor) -> torch.Tensor:
    """Masked squared error for MOSI / MOSEI regression, over sum(umask)."""
    p = pred.reshape(-1) * umask.reshape(-1)
    t = target.reshape(-1) * umask.reshape(-1)
    return ((p - t) ** 2).sum() / umask.sum()
