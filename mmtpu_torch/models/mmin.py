"""MMIN, the missing-modality imputation network (counterpart of
mmtpu/models/mmin.py).

Its own encoders netA / netV / netT over the *masked* inputs (the audio and
video LSTMs in one `lstm` launch when `can_stack_pair` holds), a
`ResidualAE` reconstructing the fusion embedding, the cycle AE over that
reconstruction (`netAE_cycle`: a second `ResidualAE` of netAE's layers,
blocks and width with dropout 0 and no BatchNorm, or netAE itself with
`share_weight`), and the classifier netC over the AE's latent. Returns
mmtpu's nine outputs under mmtpu's keys.

The frozen UttFusion teacher (`pretrained_model`) is not part of the model:
the registry leaves it a spec, the MSA runner builds and restores it, and
the train step runs it over the complement inputs (`train/mmin_step.py`).
It is kept here as that spec only, so it is in no `parameters()`,
`state_dict()` or optimizer of MMIN.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from mmtpu_torch.models.autoencoder import ResidualAE
from mmtpu_torch.models.lstm import can_stack_pair, encode_pair_stacked


class MMIN(nn.Module):
    def __init__(self, netA: nn.Module, netV: nn.Module, netT: nn.Module, netAE: ResidualAE,
                 netC: nn.Module, clip: Optional[float] = None, share_weight: bool = False,
                 pretrained_model: Any = None) -> None:
        super().__init__()
        if isinstance(pretrained_model, nn.Module):
            raise TypeError("MMIN's pretrained_model is the teacher's spec; the MSA runner "
                            "builds the frozen teacher outside the model")
        self.netA = netA
        self.netV = netV
        self.netT = netT
        self.netAE = netAE
        self.netC = netC
        self.clip = clip
        self.share_weight = share_weight
        self.pretrained_model = pretrained_model
        if not share_weight:
            self.netAE_cycle = ResidualAE(netAE.layers, netAE.n_blocks, netAE.input_dim,
                                          dropout=0.0, use_bn=False)

    def forward(self, A: torch.Tensor, V: torch.Tensor, T: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        if can_stack_pair(self.netA, self.netV, A, V):
            a, v = encode_pair_stacked(self.netA, self.netV, A, V)
        else:
            a, v = self.netA(A), self.netV(V)
        t = self.netT(T)
        fusion = torch.cat([a, v, t], dim=-1)
        recon_fusion, latent = self.netAE(fusion)
        cycle_ae = self.netAE if self.share_weight else self.netAE_cycle
        recon_cycle, latent_cycle = cycle_ae(recon_fusion)
        return {
            "audio": a,
            "video": v,
            "text": t,
            "fusion": fusion,
            "recon_fusion": recon_fusion,
            "recon_cycle": recon_cycle,
            "latent": latent,
            "latent_cycle": latent_cycle,
            "logits": self.netC(latent),
        }
