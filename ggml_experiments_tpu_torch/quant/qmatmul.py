"""``x @ dequantize(qt)`` for q8_0 weights: the hand-written CUDA kernel
(``csrc/qmatmul_q8_0.cu``) and its plain PyTorch version.

Routing follows the JAX package (``quant/pallas_kernels.py`` ``qmatmul``):
weights with ``K*N <= XLA_FALLBACK_MAX_ELEMS`` are dequantized and handed to
``torch.matmul``, as the JAX package leaves them to XLA; larger ones take the
kernel. At the reference GRU that sends the recurrent kernel (1024 x 3072) to
the kernel and the input kernel (256 x 3072) and dense head (1024 x 66) to the
matmul.

``compute_dtype=bfloat16`` rounds both operands to bf16, multiplies and sums
in f32, and stores the result as bf16 (the TPU kernel's ``_dot`` and its
output cast).
"""

from __future__ import annotations

import ctypes

import torch

from ggml_experiments_tpu_torch.device import resolve_dtype
from ggml_experiments_tpu_torch.quant.qtensor import QTensor, dequantize

XLA_FALLBACK_MAX_ELEMS = 1 << 20

# launches of the CUDA kernel; only the kernel wrapper adds to it
LAUNCHES = {"qmatmul_q8_0": 0}


def _dense(qt: QTensor, dtype: torch.dtype) -> torch.Tensor:
    """The dequantized plane at ``dtype``, built once per QTensor (the JAX
    package gets the same effect from XLA hoisting the dequant)."""
    w = qt.dense.get(dtype)
    if w is None:
        w = dequantize(qt).to(dtype)
        qt.dense[dtype] = w
    return w


def qmatmul_reference(x: torch.Tensor, qt: QTensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the kernel: dequantize, round both operands to the
    compute dtype, multiply in f32; result at the compute dtype. Like the
    kernel, it dequantizes on every call."""
    cd = resolve_dtype(compute_dtype)
    w = dequantize(qt).to(cd).float()
    out = torch.matmul(x.float().to(cd).float(), w)
    return out.to(cd)


def qmatmul_q8_0_cuda(x: torch.Tensor, qt: QTensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Launch the CUDA kernel. ``x`` (M, K) on the GPU; returns f32 (M, N)."""
    from ggml_experiments_tpu_torch import _build

    cd = resolve_dtype(compute_dtype)
    if x.device.type != "cuda" or qt.codes.device != x.device:
        raise ValueError("qmatmul_q8_0_cuda needs x and the weight on one CUDA device")
    if qt.qtype != "q8_0" or qt.codes.dtype != torch.int8 or qt.scales.dtype != torch.float32:
        raise ValueError("qmatmul_q8_0_cuda takes q8_0 int8 codes with f32 scales")
    if x.dim() != 2 or x.shape[1] != qt.k:
        raise ValueError(f"x must be (M, {qt.k}), got {tuple(x.shape)}")
    if not (qt.codes.is_contiguous() and qt.scales.is_contiguous()):
        raise ValueError("codes and scales must be contiguous")
    x = x.float().contiguous()
    m = x.shape[0]
    out = torch.empty((m, qt.n), dtype=torch.float32, device=x.device)
    lib = _build.load("qmatmul_q8_0")
    fn = lib.gxt_qmatmul_q8_0
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    code = fn(x.data_ptr(), qt.codes.data_ptr(), qt.scales.data_ptr(), out.data_ptr(),
              m, qt.k, qt.n, qt.np_, int(cd == torch.bfloat16),
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "qmatmul_q8_0")
    LAUNCHES["qmatmul_q8_0"] += 1
    return out


def qmatmul(x: torch.Tensor, qt: QTensor, *, compute_dtype=torch.float32) -> torch.Tensor:
    """``x (..., K) @ dequantize(qt) -> (..., N)`` at the compute dtype."""
    cd = resolve_dtype(compute_dtype)
    k, n = qt.shape
    if x.shape[-1] != k:
        raise ValueError(f"x last dim {x.shape[-1]} != weight K {k}")
    if k * n <= XLA_FALLBACK_MAX_ELEMS:
        return torch.matmul(x.to(cd), _dense(qt, cd))
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if x2.device.type == "cpu":
        out = qmatmul_reference(x2, qt, cd)
    else:
        out = qmatmul_q8_0_cuda(x2, qt, cd).to(cd)
    return out.reshape(*batch_shape, n)
