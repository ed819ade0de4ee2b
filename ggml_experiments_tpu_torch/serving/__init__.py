"""Continuous-batching serving engine."""

from ggml_experiments_tpu_torch.serving.engine import DecodeEngine, EngineStats, Request

__all__ = ["DecodeEngine", "EngineStats", "Request"]
