"""MM-IMDb genre classification (counterpart of mmtpu/models/mmimdb.py).

- `MMIMDbModalityEncoder`: pad-aware BatchNorm `bn` (`models/norm.py`), then
  the Linear `fc`;
- `MLPGenreClassifier`: (BatchNorm → MaxOut without bias → dropout 0.5) ×2
  → BatchNorm → `fc_out` (23 logits); the dropouts draw from the run's
  generator;
- `MMIMDb`: the image and text encoders (or embeddings given as they are,
  `is_embd_I` / `is_embd_T`), the GMU or a `MultimodalPooling` built from
  the `multimodal_pooling` mapping (`fusion_module`, its output the
  classifier's input width), then the classifier. Multilabel: the task
  thresholds sigmoid(logits) at `binary_threshold`
  (`train/step.py::ClassificationTask(multilabel=True)`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from mmtpu_torch.models.fusion import MaxOut, MultimodalPooling
from mmtpu_torch.models.norm import BatchNorm
from mmtpu_torch.models.rng import GeneratorDropout


class MMIMDbModalityEncoder(nn.Module):
    def __init__(self, input_dim: int, output_dim: int) -> None:
        super().__init__()
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.bn = BatchNorm(input_dim)
        self.fc = nn.Linear(input_dim, output_dim)

    def get_embedding_size(self) -> int:
        return self.output_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.bn(x))


class MLPGenreClassifier(nn.Module):
    def __init__(self, input_size: int, output_size: int, hidden_size: int) -> None:
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.bn0 = BatchNorm(input_size)
        self.maxout0 = MaxOut(input_size, hidden_size, use_bias=False)
        self.dropout0 = GeneratorDropout(0.5)
        self.bn1 = BatchNorm(hidden_size)
        self.maxout1 = MaxOut(hidden_size, hidden_size, use_bias=False)
        self.dropout1 = GeneratorDropout(0.5)
        self.bn2 = BatchNorm(hidden_size)
        self.fc_out = nn.Linear(hidden_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dropout0(self.maxout0(self.bn0(x)))
        x = self.dropout1(self.maxout1(self.bn1(x)))
        return self.fc_out(self.bn2(x))


class MMIMDb(nn.Module):
    def __init__(self, image_encoder: nn.Module, text_encoder: nn.Module,
                 classifier: nn.Module, gated_bimodal_network: Optional[nn.Module] = None,
                 multimodal_pooling: Optional[Dict[str, Any]] = None,
                 binary_threshold: float = 0.5) -> None:
        super().__init__()
        self.image_encoder = image_encoder
        self.text_encoder = text_encoder
        self.classifier = classifier
        self.binary_threshold = binary_threshold
        if multimodal_pooling is not None:
            self.fusion_module = MultimodalPooling(
                input_dim_a=image_encoder.output_dim, input_dim_b=text_encoder.output_dim,
                output_dim=classifier.input_size,
                pooling_type=multimodal_pooling.get("pooling_type", "gated"),
                hidden_dim=multimodal_pooling.get("hidden_dim") or 0,
                dropout=multimodal_pooling.get("dropout", 0.0))
        elif gated_bimodal_network is not None:
            self.gated_bimodal_network = gated_bimodal_network
        else:
            raise ValueError(
                "Either gated_bimodal_network or multimodal_pooling must be provided")

    def forward(self, I: Optional[torch.Tensor] = None, T: Optional[torch.Tensor] = None, *,  # noqa: E741
                is_embd_I: bool = False, is_embd_T: bool = False) -> torch.Tensor:
        if I is None and T is None:
            raise ValueError("MMIMDb needs an image or a text input")
        if is_embd_I and is_embd_T:
            raise ValueError("MMIMDb: at most one input may be an embedding")
        image = I if is_embd_I else self.image_encoder(I)
        text = T if is_embd_T else self.text_encoder(T)
        fusion = (self.fusion_module if hasattr(self, "fusion_module")
                  else self.gated_bimodal_network)
        return self.classifier(fusion(image, text))

    def encode(self, I: torch.Tensor, T: torch.Tensor):  # noqa: E741
        return self.image_encoder(I), self.text_encoder(T)
