"""The federated parameter codec (counterpart of `mmtpu/federated`)."""

from mmtpu_torch.federated.federated_utils import deserialize_params, serialize_params

__all__ = ["serialize_params", "deserialize_params"]
