"""RedCore: VAE-transformer encoders, cross-modal generators and adaptive
modality weighting (counterpart of mmtpu/models/redcore.py).

Per modality a VAE `Transformer` gives (z, μ, logσ²); the `ResidualXE`
generators netVT_A, netAT_V and netAV_T impute each modality's feature from
the other two; a present modality keeps its own feature, a missing one
takes the generated one, each gated by **its own** missing index (mmtpu's
fix of the reference, whose audio index aliases the video one); the fused
classifier netC and the aux classifiers netC_A / netC_V / netC_T read the
gated features. netAE and the cycle AE (`netAE_cycle`, or netAE with
`share_weight`) run for the outputs' schema: no loss term reads them, in
the reference or in mmtpu, so they train with zero gradient.

The schedule fields (`loss_beta`, `interval_i`, `eta`, `eta_ext`,
`lambda_one`) are read by the runner from the config, as mmtpu's are.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from mmtpu_torch.models.autoencoder import ResidualAE


class RedCore(nn.Module):
    def __init__(self, netA: nn.Module, netV: nn.Module, netT: nn.Module, netAE: ResidualAE,
                 netC: nn.Module, netAT_V: nn.Module, netAV_T: nn.Module, netVT_A: nn.Module,
                 netC_A: nn.Module, netC_V: nn.Module, netC_T: nn.Module,
                 share_weight: bool = False, loss_beta: float = 0.95, interval_i: int = 2,
                 eta: float = 0.001, eta_ext: float = 1.5, clip: float = 1.0,
                 feature_dim: int = 32, lambda_one: float = 0.0008) -> None:
        super().__init__()
        self.netA, self.netV, self.netT = netA, netV, netT
        self.netAE = netAE
        self.netC = netC
        self.netAT_V, self.netAV_T, self.netVT_A = netAT_V, netAV_T, netVT_A
        self.netC_A, self.netC_V, self.netC_T = netC_A, netC_V, netC_T
        self.share_weight = share_weight
        self.loss_beta, self.interval_i = loss_beta, interval_i
        self.eta, self.eta_ext, self.lambda_one = eta, eta_ext, lambda_one
        self.clip, self.feature_dim = clip, feature_dim
        if not share_weight:
            self.netAE_cycle = ResidualAE(netAE.layers, netAE.n_blocks, netAE.input_dim,
                                          dropout=0.0, use_bn=False)

    def forward(self, A: torch.Tensor, V: torch.Tensor, T: torch.Tensor,
                A_missing_index: torch.Tensor, V_missing_index: torch.Tensor,
                T_missing_index: torch.Tensor) -> Dict[str, torch.Tensor]:
        f_A, mu_A, lv_A = self.netA(A)
        f_V, mu_V, lv_V = self.netV(V)
        f_T, mu_T, lv_T = self.netT(T)

        fusion = torch.cat([f_A, f_V, f_T], dim=-1)
        recon_fusion, latent = self.netAE(fusion)
        cycle_ae = self.netAE if self.share_weight else self.netAE_cycle
        recon_cycle, latent_cycle = cycle_ae(recon_fusion)

        gen_A, _ = self.netVT_A(torch.cat([f_V, f_T], dim=-1))
        gen_V, _ = self.netAT_V(torch.cat([f_A, f_T], dim=-1))
        gen_T, _ = self.netAV_T(torch.cat([f_A, f_V], dim=-1))

        def gate(index, own, generated):
            i = index.reshape(-1, 1).to(own.dtype)
            return i * own + (1.0 - i) * generated

        f_A_r = gate(A_missing_index, f_A, gen_A)
        f_V_r = gate(V_missing_index, f_V, gen_V)
        f_T_r = gate(T_missing_index, f_T, gen_T)
        fusion_r = torch.cat([f_A_r, f_V_r, f_T_r], dim=-1)
        return {
            "logits": self.netC(fusion_r),
            "logits_A": self.netC_A(f_A_r),
            "logits_V": self.netC_V(f_V_r),
            "logits_T": self.netC_T(f_T_r),
            "fusion": fusion,
            "recon_fusion": recon_fusion,
            "recon_cycle": recon_cycle,
            "latent": latent,
            "latent_cycle": latent_cycle,
            "feature_A_miss": f_A, "gen_A": gen_A, "fmu_A": mu_A, "flog_var_A": lv_A,
            "feature_V_miss": f_V, "gen_V": gen_V, "fmu_V": mu_V, "flog_var_V": lv_V,
            "feature_T_miss": f_T, "gen_T": gen_T, "fmu_T": mu_T, "flog_var_T": lv_T,
        }
