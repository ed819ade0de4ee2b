"""Fused multi-head attention: ``csrc/flash_attention.cu`` and its plain
PyTorch version.

Replaces the TPU kernel ``ops/flash_attention.py`` ``_flash_core_call`` of
the JAX package. It takes q, k, v in the projections' (..., L, C) layout and
returns the context in the same layout; heads are channel slices of width
C / H. The arithmetic follows the TPU body:

* ``q * scale`` in q's dtype (at bf16 the scale is itself rounded to bf16
  first, and the product is rounded);
* per head, ``s = q . k_h^T`` summed in f32 and rounded to the compute dtype;
  ``p = exp(s - rowmax)`` in the compute dtype; ``denom`` the f32 sum of p;
  ``ctx = p . v_h`` in f32; ``out = ctx * (1 / denom)``, rounded to the
  compute dtype.

The kernel stages a head's k and v whole in shared memory up to
``WHOLE_ROW_KEYS`` keys (L <= 256: MobileViT-small up to 256 px) and
streams them through it in chunks of that many keys past it (layer_3's L =
1024 at 512 px), computing the same bits either way. The plain version
takes the row max first; the kernel does too at bf16 (streaming the keys
twice), while at f32 it keeps a running max and rescales (online softmax),
which differs only by f32 rounding. On a CPU tensor :func:`flash_mha` runs
:func:`flash_mha_plain`; on a CUDA tensor it launches the kernel or raises.
The kernel takes head widths up to 64 and any L.

Under ``torch.export`` (or ``torch.compile``) the kernel is reached through
the custom op ``gxt::flash_mha`` (:func:`flash_mha_op`), whose CUDA
implementation launches it and whose CPU implementation is the plain
version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ggml_experiments_tpu_torch.device import current_stream_handle, resolve_dtype

# launches of the CUDA kernel, and of those the ones that streamed the keys;
# only the kernel wrapper adds to them
LAUNCHES = {"flash_mha": 0, "flash_mha_streamed": 0}
WHOLE_ROW_KEYS = 256   # keys a launch stages at once (csrc kWholeKeys)


def streams_keys(l: int) -> bool:
    """Whether a launch over sequences of ``l`` tokens streams k and v
    through shared memory in chunks (csrc ``plan``): past WHOLE_ROW_KEYS
    keys, L rounded up to 8."""
    return -(-l // 8) * 8 > WHOLE_ROW_KEYS


@functools.lru_cache(maxsize=None)
def head_scale(dh: int, dtype: torch.dtype) -> float:
    """``1/sqrt(dh)`` as the TPU body applies it: rounded to q's dtype."""
    return float(torch.tensor(1.0 / math.sqrt(dh), dtype=dtype))


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """The kernel's arithmetic on (bp, L, C) operands already in the compute
    dtype; returns (bp, L, C) in that dtype."""
    cd = q.dtype
    bp, l, c = q.shape
    dh = c // num_heads
    qf = q * torch.tensor(head_scale(dh, cd), dtype=cd)
    qh, kh, vh = (t.reshape(bp, l, num_heads, dh).float() for t in (qf, k, v))
    s = torch.einsum("blhd,bmhd->bhlm", qh, kh).to(cd)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.float().sum(dim=-1)                                   # (bp, H, L)
    ctx = torch.einsum("bhlm,bmhd->blhd", p.float(), vh)
    out = ctx * (1.0 / denom).permute(0, 2, 1)[..., None]
    return out.reshape(bp, l, c).to(cd)


_LIB = []
_FITS = set()      # (device, L, C, H) whose shared memory was checked against the limit


def _lib():
    if not _LIB:
        from ggml_experiments_tpu_torch import _build

        lib = _build.load("flash_attention")
        lib.gxt_flash_mha.restype = ctypes.c_int
        lib.gxt_flash_mha.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.gxt_flash_mha_smem.restype = ctypes.c_longlong
        lib.gxt_flash_mha_smem.argtypes = [ctypes.c_int] * 3
        _LIB.append(lib)
    return _LIB[0]


def flash_smem_bytes(l: int, c: int, h: int) -> int:
    """Bytes of shared memory of a launch at (L, C, H) (csrc ``plan``): k
    and v of the block's pairs (8 // ceil(L / 16) pairs where a pair's rows
    fit 8 warps, else one) as f32 rows of dh rounded up to 4 x an odd number
    of floats, whole up to WHOLE_ROW_KEYS keys, else a chunk of that many,
    and 8 floats of slack; -1 where the kernel does not take the heads
    (width past 64)."""
    if l <= 0 or h <= 0 or c % h or c // h > 64:
        return -1
    dh = c // h
    s = -(-dh // 4) * 4
    s = s if (s // 4) % 2 else s + 4
    lp, tiles = -(-l // 8) * 8, -(-l // 16)
    pairs = 8 // tiles if tiles <= 8 else 1
    return (pairs * 2 * min(lp, WHOLE_ROW_KEYS) * s + 8) * 4


def flash_takes(l: int, c: int, h: int, limit: int = 232448) -> bool:
    """Whether the kernel takes (L, C, H): heads of width up to 64 whose k
    and v fit ``limit`` bytes of shared memory (what :func:`flash_mha_cuda`
    checks before a launch)."""
    return 0 < flash_smem_bytes(l, c, h) <= limit


def _check_fits(lib, dev: torch.device, l: int, c: int, h: int) -> None:
    key = (dev.index, l, c, h)
    if key in _FITS:
        return
    need = lib.gxt_flash_mha_smem(l, c, h)
    if need != flash_smem_bytes(l, c, h):
        raise RuntimeError(f"flash_mha_cuda: the kernel reckons {need} bytes of shared memory "
                           f"at (L, C, H) = ({l}, {c}, {h}), the wrapper "
                           f"{flash_smem_bytes(l, c, h)}")
    limit = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin",
                    232448)
    if need < 0 or need > limit:
        raise ValueError(f"flash_mha_cuda: (L, C, H) = ({l}, {c}, {h}) is past the "
                         f"kernel (head width <= 64, {need} bytes of shared memory against "
                         f"{limit})")
    _FITS.add(key)


def flash_mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int) -> torch.Tensor:
    """Launch the kernel on contiguous (bp, L, C) CUDA operands of one dtype
    (float32 or bfloat16)."""
    from ggml_experiments_tpu_torch import _build

    dev = q.device
    cd = q.dtype
    if dev.type != "cuda" or q.dim() != 3 or cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_mha_cuda: q must be a (bp, L, C) f32/bf16 CUDA tensor, got "
                         f"{cd}{tuple(q.shape)} on {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.dtype != cd or t.shape != q.shape or not t.is_contiguous():
            raise ValueError(f"flash_mha_cuda: {name} must be a contiguous {cd} tensor of "
                             f"{tuple(q.shape)} on {dev}")
    bp, l, c = q.shape
    if c % num_heads:
        raise ValueError(f"C={c} not divisible by num_heads={num_heads}")
    lib = _lib()
    _check_fits(lib, dev, l, c, num_heads)
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bp, l, c, num_heads,
            head_scale(c // num_heads, cd), int(cd == torch.bfloat16),
            current_stream_handle(dev))
    if dev.index == torch.cuda.current_device():
        code = lib.gxt_flash_mha(*args)
    else:
        with torch.cuda.device(dev):
            code = lib.gxt_flash_mha(*args)
    _build.check(lib, code, f"flash_mha (bp, L, C, H) = ({bp}, {l}, {c}, {num_heads})")
    LAUNCHES["flash_mha"] += 1
    if streams_keys(l):
        LAUNCHES["flash_mha_streamed"] += 1
    return out


@torch.library.custom_op("gxt::flash_mha", mutates_args=())
def flash_mha_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 num_heads: int) -> torch.Tensor:
    """What a traced program calls: (bp, L, C) operands in the compute dtype.
    This body is the CPU implementation: the plain version."""
    return flash_mha_plain(q, k, v, num_heads)


@flash_mha_op.register_kernel("cuda")
def _flash_mha_op_cuda(q, k, v, num_heads):
    return flash_mha_cuda(q, k, v, num_heads)


@flash_mha_op.register_fake
def _flash_mha_op_fake(q, k, v, num_heads):
    return torch.empty_like(q)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, *,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Dense (non-causal, unmasked) MHA over the last two dims of (..., L, C)
    operands; the context comes back in that layout at the compute dtype."""
    *lead, l, c = q.shape
    if c % num_heads:
        raise ValueError(f"C={c} not divisible by num_heads={num_heads}")
    cd = resolve_dtype(compute_dtype)
    q3, k3, v3 = (t.reshape(-1, l, c).to(cd).contiguous() for t in (q, k, v))
    if torch.compiler.is_compiling():
        out = flash_mha_op(q3, k3, v3, num_heads)
    elif q3.device.type == "cpu":
        out = flash_mha_plain(q3, k3, v3, num_heads)
    else:
        out = flash_mha_cuda(q3, k3, v3, num_heads)
    return out.reshape(*lead, l, c)
