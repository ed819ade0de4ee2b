"""Continuous-batching serving engines: GRU text and MobileViT images."""

from ggml_experiments_tpu_torch.serving.engine import DecodeEngine, EngineStats, Request
from ggml_experiments_tpu_torch.serving.vision import VisionEngine, VisionRequest, VisionStats

__all__ = ["DecodeEngine", "EngineStats", "Request", "VisionEngine", "VisionRequest",
           "VisionStats"]
