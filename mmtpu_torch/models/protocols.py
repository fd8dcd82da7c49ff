"""Structural protocol for trainable multimodal models (counterpart of
mmtpu/models/protocols.py).

The protocol covers the model-owned surface: the forward call and the
per-modality embeddings (`encode`). `get_encoder` is the reference's
encoder lookup: a `{modality}_encoder` attribute, or UttFusion's
`netA` / `netV` / `netT`.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable


@runtime_checkable
class MultimodalModelProtocol(Protocol):
    def __call__(self, *inputs: Any) -> Any:  # noqa: D102
        ...

    def encode(self, *inputs: Any) -> Any:
        """Per-modality embeddings (reference get_embeddings)."""
        ...


def get_encoder(model: Any, modality: str) -> Any:
    """`{modality}_encoder` attribute, else the netA/netV/netT naming."""
    attr = f"{modality}_encoder"
    if hasattr(model, attr):
        return getattr(model, attr)
    net = {"audio": "netA", "video": "netV", "text": "netT"}.get(str(modality))
    if net and hasattr(model, net):
        return getattr(model, net)
    raise ValueError(f"Unknown modality: {modality}")
