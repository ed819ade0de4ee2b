"""MobileNetV2 inverted residual in one pass: ``csrc/inverted_residual.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``ops/fused_inverted_residual.py``
``fused_inverted_residual`` of the JAX package (body ``_ir_kernel``): expand
1x1 -> depthwise 3x3 -> reduce 1x1 with the 4x-expanded activation kept out
of device memory. BN is folded into the weights (:func:`folded_conv_weights`),
so this route differs from the unfused chain, which applies BN in bf16 after
each convolution. The arithmetic, as the TPU body has it:

* ``ex = x . Wexp`` summed in f32 on bf16 operands; ``SiLU(ex + bexp) -> cd``;
  a zero ring around the image (zeros after the SiLU);
* depthwise over the rounded expanded values in f32 with f32 taps: for each
  column tap dj the three row taps di summed in order, then the three column
  sums in order; ``SiLU(acc + bdw) -> cd``;
* ``out = y . Wred + bred`` in f32, ``+ x`` with the residual, ``-> cd``.

On a CPU tensor :func:`fused_inverted_residual` runs
:func:`fused_ir_plain`; on a CUDA tensor it launches the kernel (bf16,
stride 1) or raises. The plain version also takes stride 2.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ggml_experiments_tpu_torch.device import resolve_dtype
from ggml_experiments_tpu_torch.ops.activations import silu
from ggml_experiments_tpu_torch.ops.fused_transformer_layer import _bt

# launches of the CUDA kernel; only the kernel wrapper adds to it
LAUNCHES = {"fused_inverted_residual": 0}


def fused_ir_plain(x, wexp, bexp, kdw, bdw, wred, bred, *, stride: int = 1,
                   use_residual: bool = False) -> torch.Tensor:
    """The kernel's arithmetic. x (B, H, W, C) in the compute dtype, wexp
    (C, E) and wred (E, Cout) in it too; kdw (3, 3, E) and the biases f32."""
    cd = x.dtype
    b, h, w, c = x.shape
    e = wexp.shape[1]
    cout = wred.shape[1]
    ho, wo = h // stride, w // stride
    ex = torch.matmul(x.reshape(-1, c).float(), wexp.float())
    xe = F.pad(silu(ex + bexp).to(cd).reshape(b, h, w, e), (0, 0, 1, 1, 1, 1)).float()
    k = kdw.float()
    if stride == 1:
        acc = torch.zeros((b, h, w, e), dtype=torch.float32, device=x.device)
        for dj in range(3):
            t = torch.zeros((b, h, w + 2, e), dtype=torch.float32, device=x.device)
            for di in range(3):
                t = t + xe[:, di:di + h] * k[di, dj]
            acc = acc + t[:, :, dj:dj + w]
    else:
        acc = torch.zeros((b, ho, wo, e), dtype=torch.float32, device=x.device)
        for di in range(3):
            for dj in range(3):
                acc = acc + xe[:, di:di + h:stride, dj:dj + w:stride] * k[di, dj]
    y = silu(acc + bdw).to(cd)
    out = torch.matmul(y.reshape(-1, e).float(), wred.float()) + bred
    if use_residual:
        out = out + x.reshape(-1, c).float()
    return out.to(cd).reshape(b, ho, wo, cout)


def _lib():
    from ggml_experiments_tpu_torch import _build

    lib = _build.load("inverted_residual")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gxt_inverted_residual.restype = i
    lib.gxt_inverted_residual.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.gxt_inverted_residual_smem.restype = ctypes.c_longlong
    lib.gxt_inverted_residual_smem.argtypes = [i, i]
    return lib


def fused_ir_cuda(x, wexp, bexp, kdw, bdw, wred, bred, *, use_residual: bool = False):
    """Launch the kernel: x a bf16 (B, H, W, C) CUDA tensor, stride 1."""
    from ggml_experiments_tpu_torch import _build

    dev = x.device
    if dev.type != "cuda" or x.dim() != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"fused_ir_cuda: x must be a bf16 (B, H, W, C) CUDA tensor, got "
                         f"{x.dtype}{tuple(x.shape)} on {dev}")
    b, h, w, c = x.shape
    e, cout = wexp.shape[1], wred.shape[1]
    if wexp.shape[0] != c or wred.shape[0] != e or (use_residual and c != cout) or e % 2:
        raise ValueError(f"fused_ir_cuda: weights {tuple(wexp.shape)}, {tuple(wred.shape)} do "
                         f"not meet x of width {c} (the kernel takes an even E)")
    lib = _lib()
    need = lib.gxt_inverted_residual_smem(c, e)
    limit = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin",
                    232448)
    if need > limit:
        raise ValueError(f"fused_ir_cuda: C={c}, E={e} needs {need} bytes of shared memory, "
                         f"the device allows {limit}")
    x = x.contiguous()
    ops = [_bt(wexp), bexp.float().contiguous(), kdw.float().reshape(9, e).contiguous(),
           bdw.float().contiguous(), _bt(wred), bred.float().contiguous()]
    out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        code = lib.gxt_inverted_residual(x.data_ptr(), *(t.data_ptr() for t in ops),
                                         out.data_ptr(), b, h, w, c, e, cout,
                                         int(use_residual),
                                         torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, f"fused_inverted_residual (B, H, W, C, E) = ({b}, {h}, {w}, {c}, {e})")
    LAUNCHES["fused_inverted_residual"] += 1
    return out


def fused_inverted_residual(x, wexp, bexp, kdw, bdw, wred, bred, *, stride: int = 1,
                            use_residual: bool = False,
                            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x (B, H, W, C); wexp (C, E), bexp (E,), kdw (3, 3, E), bdw (E,), wred
    (E, Cout), bred (Cout,), BN folded -> (B, H/stride, W/stride, Cout) in the
    compute dtype."""
    cd = resolve_dtype(compute_dtype)
    x = x.to(cd)
    if x.device.type == "cpu":
        return fused_ir_plain(x, wexp.to(cd), bexp.float(), kdw, bdw.float(), wred.to(cd),
                              bred.float(), stride=stride, use_residual=use_residual)
    if stride != 1 or cd != torch.bfloat16:
        raise ValueError(f"fused_inverted_residual: the CUDA kernel runs bf16 at stride 1, got "
                         f"{cd} at stride {stride}")
    return fused_ir_cuda(x, wexp, bexp, kdw, bdw, wred, bred, use_residual=use_residual)


def folded_conv_weights(conv):
    """(kernel, bias) of a ``ConvBNAct`` with its folded BN absorbed: the scale
    into the kernel's output channels, the bias kept apart."""
    k = conv.kernel
    if conv.bn is not None:
        return k * conv.bn.scale, conv.bn.bias
    return k, torch.zeros(k.shape[-1], dtype=torch.float32, device=k.device)


def inverted_residual_fused(params, x: torch.Tensor, *,
                            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Run an ``InvertedResidualParams`` through :func:`fused_inverted_residual`."""
    wexp, bexp = folded_conv_weights(params.expand_1x1)
    kdw, bdw = folded_conv_weights(params.conv_3x3)
    wred, bred = folded_conv_weights(params.reduce_1x1)
    e = wexp.shape[-1]
    return fused_inverted_residual(
        x, wexp.reshape(wexp.shape[-2], e), bexp, kdw.reshape(3, 3, e), bdw,
        wred.reshape(e, wred.shape[-1]), bred, stride=params.conv_3x3.stride,
        use_residual=params.use_residual, compute_dtype=compute_dtype)
