"""Parameter serialization for transport (counterpart of
`mmtpu/federated/federated_utils.py`).

A nested mapping of arrays (numpy arrays or tensors, with lists, tuples
and scalars where flax allows them) becomes a base64 string of flax's
msgpack bytes, `flax.serialization.to_bytes` byte for byte
(`checkpoints/msgpack.py`), and back: each package decodes the other's
string."""

from __future__ import annotations

import base64
from typing import Any

from mmtpu_torch.checkpoints.msgpack import from_state_dict, msgpack_restore, to_bytes


def serialize_params(params: Any) -> str:
    """Parameter tree → base64 string."""
    return base64.b64encode(to_bytes(params)).decode("ascii")


def deserialize_params(encoded: str, target: Any) -> Any:
    """base64 string → parameter tree with the structure of `target` (a
    tensor leaf of `target` comes back as a tensor on its device, any other
    leaf as the decoded value)."""
    return from_state_dict(target, msgpack_restore(base64.b64decode(encoded)))
