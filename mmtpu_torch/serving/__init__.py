"""Serving of the port: in-process predictor, `torch.export` artifacts and
the online micro-batcher."""

from mmtpu_torch.serving.batcher import MicroBatcher
from mmtpu_torch.serving.export import (
    Predictor,
    ServedModel,
    export_cmam,
    export_task,
    load_artifact,
    make_cmam_serving_fn,
    make_serving_fn,
)

__all__ = [
    "MicroBatcher",
    "Predictor",
    "ServedModel",
    "export_cmam",
    "export_task",
    "load_artifact",
    "make_cmam_serving_fn",
    "make_serving_fn",
]
