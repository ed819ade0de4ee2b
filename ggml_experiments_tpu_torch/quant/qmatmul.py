"""``x @ dequantize(qt)`` for block-quantized weights: the hand-written CUDA
kernels (``csrc/qmatmul.cu``, one entry per format) and their plain PyTorch
version.

Routing follows the JAX package (``quant/pallas_kernels.py`` ``qmatmul``):
weights with ``K*N <= XLA_FALLBACK_MAX_ELEMS`` are dequantized and handed to
``torch.matmul``, as the JAX package leaves them to XLA, and so are q4_k
weights whose padded K is not whole 256-row super-blocks; the others take
the kernel, which reads the packed planes and decodes them on chip. At the
reference GRU that sends the recurrent kernel (1024 x 3072) to the kernel and
the input kernel (256 x 3072) and dense head (1024 x 66) to the matmul.

``compute_dtype=bfloat16`` rounds both operands to bf16, multiplies and sums
in f32, and stores the result as bf16 (the TPU kernel's ``_dot`` and its
output cast).
"""

from __future__ import annotations

import ctypes

import torch

from ggml_experiments_tpu_torch.device import resolve_dtype
from ggml_experiments_tpu_torch.quant.qtensor import PLANE_NAMES, QTYPES, QTensor, dequantize

XLA_FALLBACK_MAX_ELEMS = 1 << 20

# launches of each format's CUDA kernel; only the kernel wrapper adds to it
LAUNCHES = {f"qmatmul_{q}": 0 for q in QTYPES}


def _dense(qt: QTensor, dtype: torch.dtype) -> torch.Tensor:
    """The dequantized plane at ``dtype``, built once per QTensor (the JAX
    package gets the same effect from XLA hoisting the dequant)."""
    w = qt.dense.get(dtype)
    if w is None:
        w = dequantize(qt).to(dtype)
        qt.dense[dtype] = w
    return w


def qmatmul_reference(x: torch.Tensor, qt: QTensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the kernels, for every format: dequantize, round both
    operands to the compute dtype, multiply in f32; result at the compute
    dtype. Like the kernels, it dequantizes on every call."""
    cd = resolve_dtype(compute_dtype)
    w = dequantize(qt).to(cd).float()
    out = torch.matmul(x.float().to(cd).float(), w)
    return out.to(cd)


def qmatmul_cuda(x: torch.Tensor, qt: QTensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Launch the format's CUDA kernel. ``x`` (M, K) on the GPU; returns f32
    (M, N)."""
    from ggml_experiments_tpu_torch import _build

    cd = resolve_dtype(compute_dtype)
    if x.device.type != "cuda" or qt.codes.device != x.device:
        raise ValueError("qmatmul_cuda needs x and the weight on one CUDA device")
    qt.check_planes()
    planes = {name: getattr(qt, name) for name in PLANE_NAMES}
    if any(t is not None and (t.device != x.device or not t.is_contiguous())
           for t in planes.values()):
        raise ValueError("qmatmul_cuda: every plane must be contiguous on x's device")
    ns = qt.supers.shape[0] // 2 if qt.qtype == "q4_k" else 0
    if x.dim() != 2 or x.shape[1] != qt.k:
        raise ValueError(f"x must be (M, {qt.k}), got {tuple(x.shape)}")
    x = x.float().contiguous()
    m = x.shape[0]
    out = torch.empty((m, qt.n), dtype=torch.float32, device=x.device)
    name = f"qmatmul_{qt.qtype}"
    lib = _build.load("qmatmul")
    fn = getattr(lib, f"gxt_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

    def ptr(t):
        return None if t is None else t.data_ptr()

    code = fn(x.data_ptr(), ptr(planes["codes"]), ptr(planes["scales"]), ptr(planes["mins"]),
              ptr(planes["hibits"]), ptr(planes["supers"]), out.data_ptr(),
              m, qt.k, qt.n, qt.np_, ns, int(cd == torch.bfloat16),
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, name)
    LAUNCHES[name] += 1
    return out


def qmatmul(x: torch.Tensor, qt: QTensor, *, compute_dtype=torch.float32) -> torch.Tensor:
    """``x (..., K) @ dequantize(qt) -> (..., N)`` at the compute dtype."""
    cd = resolve_dtype(compute_dtype)
    k, n = qt.shape
    if x.shape[-1] != k:
        raise ValueError(f"x last dim {x.shape[-1]} != weight K {k}")
    if k * n <= XLA_FALLBACK_MAX_ELEMS or (qt.qtype == "q4_k" and qt.kp % 256 != 0):
        return torch.matmul(x.to(cd), _dense(qt, cd))
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if x2.device.type == "cpu":
        out = qmatmul_reference(x2, qt, cd)
    else:
        out = qmatmul_cuda(x2, qt, cd).to(cd)
    return out.reshape(*batch_shape, n)
