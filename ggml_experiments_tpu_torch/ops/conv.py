"""2-D convolutions on NHWC activations and HWIO kernels, with folded
inference BatchNorm and an activation.

The layouts are the JAX package's (the TF export order of ``weight.ggml``).
Inside, a convolution is ``torch.nn.functional.conv2d`` on the channels_last
view of the NHWC tensor. Padding is symmetric, ``(k-1)//2 * dilation`` on each
side (HF's ZeroPadding2D then VALID, which is not TF "SAME" at stride 2).

``compute_dtype=bfloat16`` rounds input and kernel to bf16 and stores the
result in bf16; BN and the activation then run in bf16 as well, as the JAX
package does. ``float32`` runs in full f32: cuDNN's TF32 mode, on by default
in PyTorch, is switched off around each f32 convolution on the GPU
(:func:`_full_f32`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ggml_experiments_tpu_torch.device import resolve_dtype
from ggml_experiments_tpu_torch.ops.activations import get_activation
from ggml_experiments_tpu_torch.ops.norm import FoldedBN


def static_field(default):
    """A dataclass field that configures the module: kept out of checkpoint
    key paths (``compare=False``) and carried over from the template when a
    checkpoint is loaded into it (``formats.checkpoint._rebuild``)."""
    return dataclasses.field(default=default, compare=False, metadata={"static": True})


@contextlib.contextmanager
def _full_f32(x: torch.Tensor, cd: torch.dtype):
    """f32 convolutions on the GPU run without TF32 (cuDNN's default is TF32,
    which keeps about three decimal digits)."""
    if x.device.type != "cuda" or cd != torch.float32:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def conv2d(x: torch.Tensor, kernel: torch.Tensor, *, stride: int = 1, dilation: int = 1,
           groups: int = 1, padding: Optional[int] = None,
           compute_dtype=torch.float32) -> torch.Tensor:
    """x: (B, H, W, Cin), kernel: (KH, KW, Cin//groups, Cout) -> (B, H', W', Cout)
    at the compute dtype."""
    cd = resolve_dtype(compute_dtype)
    kh = kernel.shape[0]
    if padding is None:
        padding = (kh - 1) // 2 * dilation
    w = kernel.to(cd).permute(3, 2, 0, 1).contiguous()      # OIHW
    with _full_f32(x, cd):
        y = F.conv2d(x.to(cd).permute(0, 3, 1, 2), w, stride=stride, padding=padding,
                     dilation=dilation, groups=groups)
    # channels_last, so that the NHWC view is contiguous for what follows (some
    # convolutions, the depthwise ones among them, return NCHW)
    return y.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def depthwise_conv2d(x, kernel, *, stride: int = 1, dilation: int = 1, padding=None,
                     compute_dtype=torch.float32):
    """kernel: (KH, KW, 1, C), a grouped convolution with groups == C."""
    return conv2d(x, kernel, stride=stride, dilation=dilation, groups=x.shape[-1],
                  padding=padding, compute_dtype=compute_dtype)


@dataclasses.dataclass
class ConvBNAct:
    """Convolution (+ folded BN) (+ activation), BN folded at load."""

    kernel: torch.Tensor  # (KH, KW, Cin//groups, Cout)
    bn: Optional[FoldedBN] = None
    activation: str = static_field("silu")
    stride: int = static_field(1)
    depthwise: bool = static_field(False)
    dilation: int = static_field(1)

    def __call__(self, x: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
        conv = depthwise_conv2d if self.depthwise else conv2d
        y = conv(x, self.kernel, stride=self.stride, dilation=self.dilation,
                 compute_dtype=compute_dtype)
        if self.bn is not None:
            y = y * self.bn.scale.to(y.dtype) + self.bn.bias.to(y.dtype)
        return get_activation(self.activation)(y)
