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

``ConvBNAct.store`` picks the dtype the output activation is stored in below
the compute dtype (``f8_e5m2``, ``f8_e4m3``, ``bfloat16``; :func:`apply_store`),
on the bf16 path only: the conv stages of batched inference are bound by the
bytes of their boundary activations, and the consumer widens them back to
the compute dtype. :class:`SpaceToDepthStem` is the stride-2 3x3 stem
rewritten as space-to-depth (3 -> 12 channels) and a stride-1 2x2
convolution.
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
from ggml_experiments_tpu_torch.pytree import register_params


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


# activation storage dtypes (distinct from the compute dtype): f8_e5m2 is bf16
# with its mantissa cut to 2 bits (bf16's exponent range, so no scaling)
STORE_DTYPES = {
    "none": None,
    "bfloat16": torch.bfloat16,
    "f8_e5m2": torch.float8_e5m2,
    "f8_e4m3": torch.float8_e4m3fn,
}


# past this magnitude a value rounds beyond e4m3fn's largest finite value
# (448): the format has no infinity, and the JAX package's cast gives NaN
# there, where torch's would saturate
_E4M3_OVERFLOW = 464.0


def apply_store(y: torch.Tensor, store: str) -> torch.Tensor:
    """``y`` stored at the storage dtype, rounded to nearest even (an e4m3
    overflow is NaN). f32 activations are left alone: the f32 path is the
    numerics oracle, and storage policies apply to the bf16 path only."""
    dt = STORE_DTYPES[store]
    if dt is None or y.dtype in (dt, torch.float32):
        return y
    if dt == torch.float8_e4m3fn:
        y = y.masked_fill(y.abs() > _E4M3_OVERFLOW, float("nan"))
    return y.to(dt)


def _bn_act_store(y: torch.Tensor, bn: Optional[FoldedBN], activation: str,
                  store: str) -> torch.Tensor:
    if bn is not None:
        y = y * bn.scale.to(y.dtype) + bn.bias.to(y.dtype)
    return apply_store(get_activation(activation)(y), store)


@dataclasses.dataclass
class ConvBNAct:
    """Convolution (+ folded BN) (+ activation), BN folded at load; the output
    stored at ``store`` (:data:`STORE_DTYPES`)."""

    kernel: torch.Tensor  # (KH, KW, Cin//groups, Cout)
    bn: Optional[FoldedBN] = None
    activation: str = static_field("silu")
    stride: int = static_field(1)
    depthwise: bool = static_field(False)
    dilation: int = static_field(1)
    store: str = static_field("none")

    def __call__(self, x: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
        conv = depthwise_conv2d if self.depthwise else conv2d
        y = conv(x, self.kernel, stride=self.stride, dilation=self.dilation,
                 compute_dtype=compute_dtype)
        return _bn_act_store(y, self.bn, self.activation, self.store)


register_params(ConvBNAct)


@dataclasses.dataclass
class SpaceToDepthStem:
    """The stride-2 3x3 stem as space-to-depth + a stride-1 2x2 convolution:
    2x2 pixel blocks folded into channels (3 -> 12) and the kernel rescattered,
    the same arithmetic up to summation order. Built from a standard stem by
    :func:`space_to_depth_stem`. (B, H, W, 3) -> (B, H/2, W/2, OC)."""

    kernel: torch.Tensor  # (2, 2, 4*Cin, OC), rescattered from (3, 3, Cin, OC)
    bn: Optional[FoldedBN] = None
    activation: str = static_field("silu")
    store: str = static_field("none")

    def __call__(self, x: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
        cd = resolve_dtype(compute_dtype)
        b, h, w, c = x.shape
        x2 = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        x2 = x2.reshape(b, h // 2, w // 2, 4 * c)
        # the original symmetric pad of 1 maps to one row/column at the top/left
        x2 = F.pad(x2.to(cd), (0, 0, 1, 0, 1, 0))
        y = conv2d(x2, self.kernel, padding=0, compute_dtype=cd)
        return _bn_act_store(y, self.bn, self.activation, self.store)


register_params(SpaceToDepthStem)


def space_to_depth_stem(stem: ConvBNAct) -> SpaceToDepthStem:
    """A stride-2 3x3 dense ``ConvBNAct`` in the space-to-depth form."""
    k = stem.kernel
    kh, kw, cin, oc = k.shape
    if (kh, kw) != (3, 3) or stem.stride != 2 or stem.depthwise:
        raise ValueError("space_to_depth_stem expects a stride-2 3x3 dense conv")
    # K2[p, q, (a*2+b)*Cin + c, o] = K[2p+a-1, 2q+b-1, c, o] (zero out of range):
    # output pixel (i, j) reads input rows 2i-1..2i+1, which are space-to-depth
    # block i-1 (offset a=1) and block i (a=0, 1)
    k2 = torch.zeros((2, 2, 4 * cin, oc), dtype=k.dtype, device=k.device)
    for p in range(2):
        for q in range(2):
            for a in range(2):
                for bq in range(2):
                    di, dj = 2 * p + a - 1, 2 * q + bq - 1
                    if 0 <= di < 3 and 0 <= dj < 3:
                        ch = (a * 2 + bq) * cin
                        k2[p, q, ch:ch + cin] = k[di, dj]
    return SpaceToDepthStem(kernel=k2, bn=stem.bn, activation=stem.activation,
                            store=stem.store)
