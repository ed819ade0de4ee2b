"""Fused multi-head attention over whole rows: ``csrc/flash_attention.cu``
and its plain PyTorch version.

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

Whole rows fit (L <= 256 on the model), so there is no online softmax. On a
CPU tensor :func:`flash_mha` runs :func:`flash_mha_plain`; on a CUDA tensor it
launches the kernel or raises. The kernel takes head widths up to 64.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ggml_experiments_tpu_torch.device import resolve_dtype

# launches of the CUDA kernel; only the kernel wrapper adds to it
LAUNCHES = {"flash_mha": 0}


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


def _lib():
    from ggml_experiments_tpu_torch import _build

    lib = _build.load("flash_attention")
    lib.gxt_flash_mha.restype = ctypes.c_int
    lib.gxt_flash_mha.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.gxt_flash_mha_smem.restype = ctypes.c_longlong
    lib.gxt_flash_mha_smem.argtypes = [ctypes.c_int] * 3
    return lib


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
    need = lib.gxt_flash_mha_smem(l, c, num_heads)
    limit = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin",
                    232448)
    if need < 0 or need > limit:
        raise ValueError(f"flash_mha_cuda: (L, C, H) = ({l}, {c}, {num_heads}) is past the "
                         f"kernel (head width <= 64, {need} bytes of shared memory against "
                         f"{limit})")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        code = lib.gxt_flash_mha(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 bp, l, c, num_heads, head_scale(c // num_heads, cd),
                                 int(cd == torch.bfloat16),
                                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, f"flash_mha (bp, L, C, H) = ({bp}, {l}, {c}, {num_heads})")
    LAUNCHES["flash_mha"] += 1
    return out


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, *,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Dense (non-causal, unmasked) MHA over the last two dims of (..., L, C)
    operands; the context comes back in that layout at the compute dtype."""
    *lead, l, c = q.shape
    if c % num_heads:
        raise ValueError(f"C={c} not divisible by num_heads={num_heads}")
    cd = resolve_dtype(compute_dtype)
    q3, k3, v3 = (t.reshape(-1, l, c).to(cd).contiguous() for t in (q, k, v))
    if q3.device.type == "cpu":
        out = flash_mha_plain(q3, k3, v3, num_heads)
    else:
        out = flash_mha_cuda(q3, k3, v3, num_heads)
    return out.reshape(*lead, l, c)
