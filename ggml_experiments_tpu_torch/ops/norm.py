"""Layer norm and inference batch norm folded into a per-channel affine."""

from __future__ import annotations

import dataclasses

import torch

from ggml_experiments_tpu_torch.pytree import register_params


def layer_norm(x: torch.Tensor, gamma, beta, *, eps: float = 1e-5, dim: int = -1):
    """Statistics in f32 (mean, then the mean of squared deviations); the
    result is cast back to ``x.dtype``, so bf16 activations stay bf16."""
    x32 = x.float()
    mean = x32.mean(dim=dim, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=dim, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


@dataclasses.dataclass
class FoldedBN:
    """Per-channel affine equivalent to inference BatchNorm. A dataclass so
    that checkpoints name its leaves ``bn/scale`` and ``bn/bias``."""

    scale: torch.Tensor  # gamma / sqrt(var + eps)
    bias: torch.Tensor   # beta - mean * scale


register_params(FoldedBN)


def fold_batchnorm(gamma, beta, moving_mean, moving_variance, *, eps: float = 1e-5) -> FoldedBN:
    scale = gamma * torch.rsqrt(moving_variance + eps)
    return FoldedBN(scale=scale, bias=beta - moving_mean * scale)


def apply_folded_bn(x: torch.Tensor, bn: FoldedBN) -> torch.Tensor:
    """x: (..., C), channels last."""
    return x * bn.scale + bn.bias
