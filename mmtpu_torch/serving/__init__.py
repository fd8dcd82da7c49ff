"""Serving of the port: in-process predictor and online micro-batcher."""

from mmtpu_torch.serving.batcher import MicroBatcher
from mmtpu_torch.serving.export import Predictor, make_serving_fn

__all__ = ["MicroBatcher", "Predictor", "make_serving_fn"]
