"""Self-MM's feature, label and center banks (counterpart of
mmtpu/train/managers.py).

`ManagerState` holds, per modality, the (N, D) feature bank, the (N,)
label bank and the (D,) positive and negative centers, as plain tensors on
the run's device, updated in place by the train step:

- `update_labels` and `update_features` write a batch's rows as masked
  DELTA adds (`index_add_`), never as stored values: padded tail rows
  alias sample 0, and the order in which duplicate indices are written is
  unspecified, so a padded row adds a delta of exactly 0;
- on a data-parallel mesh the train step hands them the GLOBAL batch's
  rows, gathered from every rank in global order (mmtpu scatters its
  global batch): every rank applies the same adds in the same order, so
  the banks and centers are the same on every rank, and one process's;
- `update_centers` takes masked means over the whole feature bank with the
  reference's quirk: every modality's centers are keyed by the TEXT labels
  (the reference's loop over [multimodal, audio, video, text] overwrites
  every modality's centers on each pass, so the last pass wins).

`FeatureManager`, `CenterManager` and `LabelManager` are the YAML tags'
stand-ins: mappings carrying the modality widths that size the banks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

MULTIMODAL = "multimodal"
CENTER_ORDER = (MULTIMODAL, "audio", "video", "text")


@dataclasses.dataclass
class ManagerState:
    features: Dict[str, torch.Tensor]     # modality → (N, D)
    labels: Dict[str, torch.Tensor]       # modality → (N,)
    centers_pos: Dict[str, torch.Tensor]  # modality → (D,)
    centers_neg: Dict[str, torch.Tensor]  # modality → (D,)

    @classmethod
    def create(cls, num_samples: int, modality_dims: Dict[str, int],
               device: Optional[torch.device] = None) -> "ManagerState":
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return cls(
            features={m: zeros(num_samples, d) for m, d in modality_dims.items()},
            labels={m: zeros(num_samples) for m in modality_dims},
            centers_pos={m: zeros(d) for m, d in modality_dims.items()},
            centers_neg={m: zeros(d) for m, d in modality_dims.items()},
        )

    # -- label bank ---------------------------------------------------------

    def init_labels(self, indexes: torch.Tensor, labels: torch.Tensor) -> "ManagerState":
        for bank in self.labels.values():
            bank[indexes.long()] = labels.to(bank)
        return self

    def get_labels(self, modality: str, indexes: torch.Tensor) -> torch.Tensor:
        return self.labels[modality][indexes.long()]

    def update_labels(self, modality: str, indexes: torch.Tensor, new_labels: torch.Tensor,
                      sample_mask: Optional[torch.Tensor] = None) -> "ManagerState":
        bank = self.labels[modality]
        idx = indexes.long()
        delta = new_labels - bank[idx]
        if sample_mask is not None:
            delta = torch.where(sample_mask > 0, delta, torch.zeros_like(delta))
        bank.index_add_(0, idx, delta)
        return self

    # -- feature bank ---------------------------------------------------------

    def update_features(self, features: Dict[str, torch.Tensor], indexes: torch.Tensor,
                        sample_mask: Optional[torch.Tensor] = None) -> "ManagerState":
        idx = indexes.long()
        for m, f in features.items():
            bank = self.features[m]
            delta = f.detach() - bank[idx]
            if sample_mask is not None:
                delta = torch.where(sample_mask[:, None] > 0, delta, torch.zeros_like(delta))
            bank.index_add_(0, idx, delta)
        return self

    # -- centers -----------------------------------------------------------------

    def update_centers(self, exclude_zero: bool = True) -> "ManagerState":
        order = [m for m in CENTER_ORDER if m in self.labels] or list(self.labels)
        labels = self.labels[order[-1]]
        pos_mask = ((labels > 0) if exclude_zero else (labels >= 0)).to(torch.float32)
        neg_mask = (labels < 0).to(torch.float32)
        pos_cnt, neg_cnt = pos_mask.sum(), neg_mask.sum()
        for m, feats in self.features.items():
            pos_mean = (feats * pos_mask[:, None]).sum(dim=0) / torch.clamp(pos_cnt, min=1)
            neg_mean = (feats * neg_mask[:, None]).sum(dim=0) / torch.clamp(neg_cnt, min=1)
            self.centers_pos[m] = torch.where(pos_cnt > 0, pos_mean, self.centers_pos[m])
            self.centers_neg[m] = torch.where(neg_cnt > 0, neg_mean, self.centers_neg[m])
        return self


# The YAML tags' stand-ins (!FeatureManager, !CenterManager, !LabelManager):
# the reference builds live manager objects at parse time; here the tags
# carry the modality widths that size ManagerState.
class FeatureManager(dict):
    def __init__(self, modality_dims=None, device=None, **kwargs):
        super().__init__(modality_dims=modality_dims or kwargs)


class CenterManager(dict):
    def __init__(self, modality_dims=None, device=None, exclude_zero=True, **kwargs):
        super().__init__(modality_dims=modality_dims or kwargs, exclude_zero=exclude_zero)


class LabelManager(dict):
    def __init__(self, modality_dims=None, device=None, **kwargs):
        super().__init__(modality_dims=modality_dims or kwargs)
