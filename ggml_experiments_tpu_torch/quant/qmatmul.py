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

from ggml_experiments_tpu_torch.device import current_stream_handle, resolve_dtype
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


# the kernel's tile: BN output columns, BM rows (64 or 128, at BM * 2
# threads); blocks of each size that fit one SM (shared memory and threads)
TILE_N = 64
RESIDENT_PER_SM = {64: 4, 128: 2}
MAX_SPLIT = 8       # split-K ranks form one portable thread-block cluster


def launch_config(m: int, k: int, n: int, qtype: str, sms: int = 132):
    """``(bm, ksplit, blocks_per_split)`` of a kernel launch for x (m, k) at
    a weight of n columns: the tile height, how many cluster ranks split K
    and how many 32-row quantization blocks each rank walks (whole 256-row
    super-blocks for q4_k). K is split until the grid holds two waves of
    the blocks an SM keeps resident (fewer idle SMs at the tail; at the main
    path's M=64 the 48 column tiles alone would fill a third of the card);
    the grid is ``(ceil(n / 64), ceil(m / bm), ksplit)`` and no rank is left
    empty."""
    if m <= 0 or k <= 0 or n <= 0:
        raise ValueError(f"qmatmul launch of an empty product ({m}, {k}) x ({k}, {n})")
    nblk = -(-k // 32)
    bm = 64 if m <= 64 else 128
    tiles = -(-n // TILE_N) * -(-m // bm)
    chunk = 8 if qtype == "q4_k" else 1
    nchunks = -(-nblk // chunk)
    ksplit = max(1, min(MAX_SPLIT, nchunks, -(-2 * RESIDENT_PER_SM[bm] * sms // tiles)))
    per = -(-nchunks // ksplit)
    return bm, -(-nchunks // per), per * chunk


# the bf16 route stages x as bf16 (half the bytes that every column tile
# re-reads) when x arrives in bf16, or from this M on, where the conversion
# pass costs less than the f32 tiles' traffic; K must then be a multiple of 8
X_BF16_MIN_M = 256

_SMS: dict = {}
_FNS: dict = {}


class _LaunchArgs(ctypes.Structure):
    """``QmmArgs`` of ``csrc/qmatmul.cu``: what stays fixed between calls on
    one weight at one M."""
    _fields_ = ([(name, ctypes.c_void_p) for name in PLANE_NAMES]
                + [(name, ctypes.c_int) for name in ("k", "n", "ldc", "ns", "bf16", "x_bf16",
                                                     "bm", "ksplit", "bps")])


def _kernel_fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        from ggml_experiments_tpu_torch import _build

        lib = _build.load("qmatmul")
        fn = getattr(lib, f"gxt_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        _FNS[name] = fn = (lib, fn)
    return fn


def _launch_cache(qt: QTensor, dev: torch.device) -> dict:
    """The launch arguments built so far for ``qt`` on ``dev``, by (M,
    route, configuration). The planes (format, shapes, device, contiguity,
    16-byte alignment) are checked once per set of plane tensors; the cache
    lives in ``qt.dense``."""
    planes = tuple(getattr(qt, name) for name in PLANE_NAMES)
    hit = qt.dense.get("launch")
    if hit is not None and hit[1] == (qt.shape, dev) and all(
            a is b for a, b in zip(hit[0], planes)):
        return hit[2]
    qt.check_planes()
    if any(t is not None and (t.device != dev or not t.is_contiguous() or t.data_ptr() % 16)
           for t in planes):
        raise ValueError("qmatmul_cuda: every plane must be contiguous and 16-byte aligned on "
                         "x's device")
    cache: dict = {}
    qt.dense["launch"] = (planes, (qt.shape, dev), cache)
    return cache


def _launch_args(qt: QTensor, dev: torch.device, cache: dict, key) -> ctypes.Structure:
    m, bf16, x_bf16, config = key
    if config is None:
        sms = _SMS.get(dev.index)
        if sms is None:
            sms = _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
        config = launch_config(m, qt.k, qt.n, qt.qtype, sms)
    args = _LaunchArgs(*(None if t is None else t.data_ptr()
                         for t in (getattr(qt, name) for name in PLANE_NAMES)),
                       qt.k, qt.n, qt.np_, qt.supers.shape[0] // 2 if qt.qtype == "q4_k" else 0,
                       int(bf16), int(x_bf16), *config)
    cache[key] = args
    return args


def qmatmul_cuda(x: torch.Tensor, qt: QTensor, compute_dtype=torch.float32,
                 config=None) -> torch.Tensor:
    """Launch the format's CUDA kernel. ``x`` (M, K) on the GPU; returns f32
    (M, N). ``config`` overrides :func:`launch_config` (bm, ksplit,
    blocks_per_split)."""
    from ggml_experiments_tpu_torch import _build

    cd = resolve_dtype(compute_dtype)
    dev = x.device
    if dev.type != "cuda" or qt.codes.device != dev:
        raise ValueError("qmatmul_cuda needs x and the weight on one CUDA device")
    if x.dim() != 2 or x.shape[1] != qt.k:
        raise ValueError(f"x must be (M, {qt.k}), got {tuple(x.shape)}")
    cache = _launch_cache(qt, dev)
    m, k = x.shape
    bf16 = cd == torch.bfloat16
    x_bf16 = bf16 and k % 8 == 0 and (x.dtype == torch.bfloat16 or m >= X_BF16_MIN_M)
    x = (x.to(torch.bfloat16) if x_bf16 else x.float()).contiguous()
    out = torch.empty((m, qt.n), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    key = (m, bf16, x_bf16, config)
    args = cache.get(key)
    if args is None:
        args = _launch_args(qt, dev, cache, key)
    name = f"qmatmul_{qt.qtype}"
    lib, fn = _kernel_fn(name)
    code = fn(x.data_ptr(), out.data_ptr(), m, ctypes.addressof(args), current_stream_handle(dev))
    _build.check(lib, code, name)
    LAUNCHES[name] += 1
    return out


def qmatmul(x: torch.Tensor, qt: QTensor, *, compute_dtype=torch.float32,
            gate_shape=None) -> torch.Tensor:
    """``x (..., K) @ dequantize(qt) -> (..., N)`` at the compute dtype.
    ``gate_shape`` is the (K, N) the kernel-or-matmul gate is decided on
    (default ``qt.shape``): a column shard of a sharded weight passes the
    whole weight's, as the JAX package's partitioned kernel decides on the
    global shape."""
    cd = resolve_dtype(compute_dtype)
    k, n = qt.shape
    if x.shape[-1] != k:
        raise ValueError(f"x last dim {x.shape[-1]} != weight K {k}")
    gk, gn = qt.shape if gate_shape is None else gate_shape
    if gk * gn <= XLA_FALLBACK_MAX_ELEMS or (qt.qtype == "q4_k" and qt.kp % 256 != 0):
        return torch.matmul(x.to(cd), _dense(qt, cd))
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if x2.device.type == "cpu":
        out = qmatmul_reference(x2, qt, cd)
    else:
        out = qmatmul_cuda(x2, qt, cd).to(cd)
    return out.reshape(*batch_shape, n)
