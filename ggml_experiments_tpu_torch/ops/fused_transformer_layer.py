"""A whole pre-LN ViT encoder layer in one launch: ``csrc/transformer_layer.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``ops/fused_transformer_layer.py``
``_fused_layer_call`` of the JAX package (body ``_layer_kernel``). Per
sequence of L tokens, with C channels, H heads of width C / H and an FFN of
width F, in this order (f32 sums everywhere; "-> cd" rounds to the compute
dtype, bf16 on the model's path):

 1. ``xf = x`` in f32, or ``xf = x . Win`` with ``input_proj`` (kept in f32,
    never rounded);
 2. ``a = LN(xf) -> cd``;
 3. ``q = ((a . Wq + bq) * scale) -> cd`` (scale applied in f32 before the
    rounding), ``k = (a . Wk + bk) -> cd``, ``v = (a . Wv + bv) -> cd``;
 4. per head: ``s = q . k_h^T -> cd``, ``p = exp(s - rowmax)`` in cd, ``denom``
    the f32 sum of p, ``ctx_h = (p . v_h) * (1 / denom)``;
 5. ``ctx -> cd``;
 6. ``x1 = xf + ctx . Wo + bo`` in f32;
 7. ``y = LN(x1) -> cd``;
 8. ``h1 = SiLU(y . Wi + bi) -> cd``;
 9. ``o = x1 + h1 . Wo2 + bo2``;
10. with ``final_ln``, ``o = LN(o)`` with the block's eps;
11. with ``output_proj``, ``o = (o -> cd) . Wout * bn_scale + bn_bias``, then
    SiLU if the projection's activation is "silu";
12. ``o -> cd``.

LN statistics are f32 (mean, then mean squared deviation). Quantized
weights are dequantized outside the kernel, as the JAX package does. On a CPU
tensor :func:`fused_transformer_layer` runs :func:`fused_transformer_layer_plain`; on a
CUDA tensor it launches the kernel (bf16 only) or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from ggml_experiments_tpu_torch.device import resolve_dtype
from ggml_experiments_tpu_torch.ops.activations import silu
from ggml_experiments_tpu_torch.ops.norm import layer_norm
from ggml_experiments_tpu_torch.quant.qtensor import QTensor, dequantize

# launches of the CUDA kernel; only the kernel wrapper adds to it
LAUNCHES = {"fused_transformer_layer": 0}


@dataclasses.dataclass
class LayerOperands:
    """The kernel's operands for one layer at one compute dtype: weights as
    (K, N) matrices in cd, vectors in f32, flags."""

    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    wi: torch.Tensor
    wo2: torch.Tensor
    ln1: tuple
    bq: torch.Tensor
    bk: torch.Tensor
    bv: torch.Tensor
    bo: torch.Tensor
    ln2: tuple
    bi: torch.Tensor
    bo2: torch.Tensor
    num_heads: int
    eps: float
    final_ln: Optional[tuple] = None     # (gamma, beta) f32
    final_eps: float = 1e-5
    win: Optional[torch.Tensor] = None   # (Cin, C)
    wout: Optional[torch.Tensor] = None  # (C, Cout)
    out_affine: Optional[tuple] = None   # (scale, bias) f32, (Cout,) each
    out_act: bool = False
    # the kernel's operand layout, built at the first launch
    cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)


def _as_float(w, dtype):
    if isinstance(w, QTensor):
        w = dequantize(w)
    return w.to(dtype)


def layer_operands(p, c: int, cd: torch.dtype, *, final_ln=None, final_ln_eps=None,
                   input_proj=None, output_proj=None) -> LayerOperands:
    """Gather a ``TransformerLayerParams`` (duck-typed) and the block-level
    options into kernel operands."""
    att = p.attention
    dev = att.bq.device if att.bq is not None else p.ln_before_gamma.device
    f = p.intermediate_kernel.shape[-1]

    def vec(b, width=c):
        return (torch.zeros(width, dtype=torch.float32, device=dev) if b is None
                else b.float())

    ops = LayerOperands(
        wq=_as_float(att.wq, cd), wk=_as_float(att.wk, cd), wv=_as_float(att.wv, cd),
        wo=_as_float(att.wo, cd), wi=_as_float(p.intermediate_kernel, cd),
        wo2=_as_float(p.output_kernel, cd),
        ln1=(vec(p.ln_before_gamma), vec(p.ln_before_beta)),
        bq=vec(att.bq), bk=vec(att.bk), bv=vec(att.bv), bo=vec(att.bo),
        ln2=(vec(p.ln_after_gamma), vec(p.ln_after_beta)),
        bi=vec(p.intermediate_bias, f), bo2=vec(p.output_bias),
        num_heads=att.num_heads, eps=float(p.eps),
    )
    if final_ln is not None:
        ops.final_ln = (vec(final_ln[0]), vec(final_ln[1]))
        ops.final_eps = float(p.eps if final_ln_eps is None else final_ln_eps)
    if input_proj is not None:
        ops.win = input_proj.to(cd)
    if output_proj is not None:
        wout, bn_scale, bn_bias, act = output_proj
        ops.out_act = act == "silu"
        if not ops.out_act and act not in (None, "none"):
            raise ValueError(f"unsupported output_proj activation {act!r}")
        ops.wout = wout.to(cd)
        cout = wout.shape[-1]
        ops.out_affine = (vec(bn_scale, cout), vec(bn_bias, cout))
    return ops


def fused_transformer_layer_plain(x3: torch.Tensor, ops: LayerOperands) -> torch.Tensor:
    """The kernel's arithmetic on x3 (bp, L, Cin) in the compute dtype;
    returns (bp, L, Cout) in that dtype."""
    cd = x3.dtype
    bp, l, cin = x3.shape
    h = ops.num_heads
    c = ops.wq.shape[0]
    dh = c // h

    def dot(a, w):
        return torch.matmul(a.float(), w.float())

    x2 = x3.reshape(bp * l, cin)
    xf = dot(x2, ops.win) if ops.win is not None else x2.float()
    a = layer_norm(xf, *ops.ln1, eps=ops.eps).to(cd)
    q = ((dot(a, ops.wq) + ops.bq) * (1.0 / math.sqrt(dh))).to(cd)
    k = (dot(a, ops.wk) + ops.bk).to(cd)
    v = (dot(a, ops.wv) + ops.bv).to(cd)
    qh, kh, vh = (t.reshape(bp, l, h, dh).float() for t in (q, k, v))
    s = torch.einsum("blhd,bmhd->bhlm", qh, kh).to(cd)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.float().sum(dim=-1)
    ctx = torch.einsum("bhlm,bmhd->blhd", p.float(), vh)
    ctx = (ctx * (1.0 / denom).permute(0, 2, 1)[..., None]).reshape(bp * l, c).to(cd)
    x1 = xf + dot(ctx, ops.wo) + ops.bo
    y = layer_norm(x1, *ops.ln2, eps=ops.eps).to(cd)
    h1 = dot(y, ops.wi) + ops.bi
    h1 = silu(h1).to(cd)
    o = x1 + dot(h1, ops.wo2) + ops.bo2
    if ops.final_ln is not None:
        o = layer_norm(o, *ops.final_ln, eps=ops.final_eps)
    if ops.wout is not None:
        o = dot(o.to(cd), ops.wout) * ops.out_affine[0] + ops.out_affine[1]
        if ops.out_act:
            o = silu(o)
    return o.to(cd).reshape(bp, l, -1)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _bt(w: torch.Tensor) -> torch.Tensor:
    """(K, N) weight -> (N, K16) bf16, transposed and zero-padded on K: the B
    operand layout of the tensor-core kernels (``csrc/mma_common.cuh``)."""
    k, n = w.shape
    out = torch.zeros((n, _pad16(k)), dtype=torch.bfloat16, device=w.device)
    out[:, :k] = w.t()
    return out


class _Args(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "out", "wq", "wk", "wv", "wo", "wi", "wo2", "win", "wout",
        "ln1g", "ln1b", "bq", "bk", "bv", "bo", "ln2g", "ln2b", "bi", "bo2",
        "ln3g", "ln3b", "osc", "obi")] + [(name, ctypes.c_int) for name in (
        "bp", "L", "Cin", "C", "F", "Cout", "H", "final_ln", "in_proj", "out_proj",
        "out_act", "warps")] + [(name, ctypes.c_float) for name in (
        "eps", "final_eps", "scale")]


def _lib():
    from ggml_experiments_tpu_torch import _build

    lib = _build.load("transformer_layer")
    lib.gxt_transformer_layer.restype = ctypes.c_int
    lib.gxt_transformer_layer.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.gxt_transformer_layer_plan.restype = ctypes.c_int
    lib.gxt_transformer_layer_plan.argtypes = [ctypes.POINTER(_Args), ctypes.c_int]
    return lib


def fused_layer_cuda(x3: torch.Tensor, ops: LayerOperands) -> torch.Tensor:
    """Launch the kernel on a contiguous bf16 (bp, L, Cin) CUDA tensor with L a
    multiple of 8."""
    from ggml_experiments_tpu_torch import _build

    dev = x3.device
    if dev.type != "cuda" or x3.dim() != 3 or x3.dtype != torch.bfloat16:
        raise ValueError(f"fused_layer_cuda: x must be a bf16 (bp, L, Cin) CUDA tensor, got "
                         f"{x3.dtype}{tuple(x3.shape)} on {dev}")
    bp, l, cin = x3.shape
    c = ops.wq.shape[0]
    f = ops.wi.shape[1]
    h = ops.num_heads
    cout = ops.wout.shape[1] if ops.wout is not None else c
    if l % 8 or c % h or (c // h) % 2:
        raise ValueError(f"fused_layer_cuda: the kernel takes L a multiple of 8 and an even "
                         f"head width, got L={l}, C={c}, H={h}")
    if (ops.win is None and cin != c) or (ops.win is not None and ops.win.shape != (cin, c)):
        raise ValueError(f"fused_layer_cuda: x width {cin} does not meet the weights (C={c})")
    x3 = x3.contiguous()
    out = torch.empty((bp, l, cout), dtype=torch.bfloat16, device=dev)
    keep = ops.cache.get(dev)
    if keep is None:
        # transposed bf16 weights and f32 vectors on the device, in _Args order
        fl = ops.final_ln or (None, None)
        oa = ops.out_affine or (None, None)

        def prep(t, transpose=False):
            if t is None:
                return None
            return (_bt(t) if transpose else t).to(dev).contiguous()

        keep = [prep(w, True) for w in (ops.wq, ops.wk, ops.wv, ops.wo, ops.wi, ops.wo2,
                                        ops.win, ops.wout)]
        keep += [prep(v) for v in (ops.ln1[0], ops.ln1[1], ops.bq, ops.bk, ops.bv, ops.bo,
                                   ops.ln2[0], ops.ln2[1], ops.bi, ops.bo2, fl[0], fl[1],
                                   oa[0], oa[1])]
        ops.cache[dev] = keep
    a = _Args(x=x3.data_ptr(), out=out.data_ptr(),
              bp=bp, L=l, Cin=cin, C=c, F=f, Cout=cout, H=h,
              final_ln=int(ops.final_ln is not None), in_proj=int(ops.win is not None),
              out_proj=int(ops.wout is not None), out_act=int(ops.out_act), warps=0,
              eps=ops.eps, final_eps=ops.final_eps, scale=1.0 / math.sqrt(c // h))
    for (name, _), t in zip(_Args._fields_[2:], keep):
        setattr(a, name, None if t is None else t.data_ptr())
    lib = _lib()
    limit = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin",
                    232448)
    if lib.gxt_transformer_layer_plan(ctypes.byref(a), limit) <= 0:
        raise ValueError(f"fused_layer_cuda: (L, Cin, C, F, Cout) = ({l}, {cin}, {c}, {f}, "
                         f"{cout}) does not fit one block's {limit} bytes of shared memory")
    with torch.cuda.device(dev):
        code = lib.gxt_transformer_layer(ctypes.byref(a),
                                         torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, f"fused_transformer_layer (bp, L, C) = ({bp}, {l}, {c})")
    LAUNCHES["fused_transformer_layer"] += 1
    return out


def fused_transformer_layer(p, x: torch.Tensor, *, compute_dtype=torch.bfloat16,
                            final_ln=None, final_ln_eps: Optional[float] = None,
                            input_proj: Optional[torch.Tensor] = None,
                            output_proj=None) -> torch.Tensor:
    """One pre-LN ViT encoder layer (``TransformerLayerParams``, duck-typed)
    on x (..., L, C), or (..., L, Cin) with ``input_proj`` (Cin, C).
    ``final_ln=(gamma, beta)`` adds the block's post-stack LN with
    ``final_ln_eps`` (default the layer's eps); ``output_proj=(kernel (C,
    Cout), bn_scale, bn_bias, act)`` the block's conv_projection, after it."""
    *lead, l, cin = x.shape
    cd = resolve_dtype(compute_dtype)
    h = p.attention.num_heads
    c = input_proj.shape[1] if input_proj is not None else cin
    if c % h:
        raise ValueError(f"C={c} not divisible by num_heads={h}")
    ops = layer_operands(p, c, cd, final_ln=final_ln, final_ln_eps=final_ln_eps,
                         input_proj=input_proj, output_proj=output_proj)
    x3 = x.reshape(-1, l, cin).to(cd)
    if x3.device.type == "cpu":
        out = fused_transformer_layer_plain(x3, ops)
    else:
        if cd != torch.bfloat16:
            raise ValueError("fused_transformer_layer: the CUDA kernel runs bf16 only")
        out = fused_layer_cuda(x3, ops)
    return out.reshape(*lead, l, out.shape[-1])
