"""A whole pre-LN ViT encoder layer: ``csrc/transformer_layer.cu`` (three
kernels) and its plain PyTorch versions.

Replaces the TPU kernel ``ops/fused_transformer_layer.py``
``_fused_layer_call`` of the JAX package (body ``_layer_kernel``). Per
sequence of L tokens, with C channels, H heads of width dh = C / H and an FFN
of width F, in this order (f32 sums everywhere; "-> cd" rounds to the compute
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
weights are dequantized outside the kernel, as the JAX package does.

On the card the layer is three launches, each with its plain version here:
``ln_qkv`` (steps 1-3; q, k and v as one (T, 3 H dhp) array, T = bp L rows,
heads padded to dhp = dh rounded up to 16 with zero columns),
``attention`` (steps 4-5; ctx (T, C)) and ``proj_ffn`` (steps 1 again and
6-12). Chained, the three plain versions give
:func:`fused_transformer_layer_plain`'s bits. Past C = 288 the row-tile
kernels run wide (:func:`row_tile_layout`): C's columns in groups, each
C-wide f32 row (xf, x1, o) through an f32 scratch in device memory, the FFN
once a group of output columns (counters ``transformer_ln_qkv_wide``,
``transformer_proj_ffn_wide``); the same arithmetic. The bf16 attention
holds a head's q, k and v whole in shared memory up to 256 keys (a row's
scores in registers) and past that keeps four query tiles resident and
streams the keys twice through a ring (:func:`attention_plan`): the same
arithmetic, any L.

At f32 every "-> cd" is a no-op, and the layer runs on the three kernels of
``csrc/transformer_layer_f32.cu`` in the same split, with the same (T, 3 H
dhp) q/k/v array in f32: ln_qkv and proj_ffn on 64-row warpgroup tiles,
each product as 3xTF32 on tf32 ``wgmma``, the weights split once a layer
into K-major tf32 hi / lo tiles streamed in the order the kernels consume
them (:func:`f32_tiles`, :func:`_prepare_f32`, kept in
``LayerOperands.cache``); the attention a block per head of whole
sequences up to 256 keys, the scores of whole rows on tf32 ``wgmma`` in
registers and the softmax after the true row max, and past 256 keys (up to
4096) a block per two query tiles walking the keys in windows of 256 with
a running max (:func:`f32_attention_streams`). The same three plain
pieces are their plain versions. A layer they do not take (a head past 64,
C past 240 or not a multiple of 4, L past 4096, a block's shared memory
past the device's: :func:`f32_layer_takes`) is refused with
its shape; there is no wide route at f32, and the model keeps such a
layer on its unfused chain.

On a CPU tensor :func:`fused_transformer_layer` runs
:func:`fused_transformer_layer_plain`; on a CUDA tensor it launches the
kernels of its dtype (bf16 or f32) or raises. Under ``torch.export`` the f32
layer is the custom op ``gxt::transformer_layer_f32``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional

import torch

from ggml_experiments_tpu_torch.device import resolve_dtype
from ggml_experiments_tpu_torch.ops.activations import silu
from ggml_experiments_tpu_torch.ops.norm import layer_norm
from ggml_experiments_tpu_torch.quant.qtensor import QTensor, dequantize

# launches: the bf16 layer (three row-tile kernels a call) and each kernel,
# then each f32 kernel, then of the attention's launches (bf16, f32) those
# that streamed the keys, then of the bf16 ln_qkv and proj_ffn launches those
# that ran wide (C past 288); only the kernel wrappers add to them
LAUNCHES = {"fused_transformer_layer": 0, "transformer_ln_qkv": 0, "transformer_attention": 0,
            "transformer_proj_ffn": 0, "transformer_ln_qkv_f32": 0,
            "transformer_attention_f32": 0, "transformer_proj_ffn_f32": 0,
            "transformer_attention_streamed": 0, "transformer_attention_f32_streamed": 0,
            "transformer_ln_qkv_wide": 0, "transformer_proj_ffn_wide": 0}


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


def head_pad(dh: int) -> int:
    """dhp: a head's width in the q/k/v array, dh rounded up to 16."""
    return -(-dh // 16) * 16


def _dims(ops: LayerOperands):
    c = ops.wq.shape[0]
    h = ops.num_heads
    return c, h, c // h, head_pad(c // h)


def ln_qkv_plain(x2: torch.Tensor, ops: LayerOperands) -> torch.Tensor:
    """Steps 1-3 on x2 (T, Cin) in the compute dtype: (T, 3 H dhp) in that
    dtype, [q | k | v] with each head's dh columns followed by zeros."""
    cd = x2.dtype
    c, h, dh, dhp = _dims(ops)

    def dot(a, w):
        return torch.matmul(a.float(), w.float())

    xf = dot(x2, ops.win) if ops.win is not None else x2.float()
    a = layer_norm(xf, *ops.ln1, eps=ops.eps).to(cd)
    q = ((dot(a, ops.wq) + ops.bq) * (1.0 / math.sqrt(dh))).to(cd)
    k = (dot(a, ops.wk) + ops.bk).to(cd)
    v = (dot(a, ops.wv) + ops.bv).to(cd)
    qkv = torch.zeros((x2.shape[0], 3, h, dhp), dtype=cd, device=x2.device)
    for i, t in enumerate((q, k, v)):
        qkv[:, i, :, :dh] = t.reshape(-1, h, dh)
    return qkv.reshape(x2.shape[0], 3 * h * dhp)


def attention_plain(qkv: torch.Tensor, l: int, ops: LayerOperands) -> torch.Tensor:
    """Steps 4-5 on :func:`ln_qkv_plain`'s array of bp sequences of l
    tokens: ctx (T, C) in its dtype."""
    cd = qkv.dtype
    c, h, dh, dhp = _dims(ops)
    bp = qkv.shape[0] // l
    t = qkv.reshape(bp, l, 3, h, dhp)[..., :dh]
    qh, kh, vh = (t[:, :, i].contiguous().float() for i in range(3))
    s = torch.einsum("blhd,bmhd->bhlm", qh, kh).to(cd)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.float().sum(dim=-1)
    ctx = torch.einsum("bhlm,bmhd->blhd", p.float(), vh)
    return (ctx * (1.0 / denom).permute(0, 2, 1)[..., None]).reshape(bp * l, c).to(cd)


def proj_ffn_plain(x2: torch.Tensor, ctx: torch.Tensor, ops: LayerOperands) -> torch.Tensor:
    """Steps 1 and 6-12 on x2 (T, Cin) and ctx (T, C) in the compute dtype:
    (T, Cout) in that dtype."""
    cd = x2.dtype

    def dot(a, w):
        return torch.matmul(a.float(), w.float())

    xf = dot(x2, ops.win) if ops.win is not None else x2.float()
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
    return o.to(cd)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

# The layout of the row-tile kernels' weight streams is decided here, once,
# and handed to the kernels (``_Args`` nw, ks, pipe), which check that they
# can consume it: weight tiles of nw = C rounded up to _CHUNK rows (the
# kernels' wgmma width, csrc kChunk), or past C = 288 groups of nw rows (the
# wide kernels: :func:`row_tile_layout`), K in chunks of 16 ks columns
# (:func:`k_steps`), and the FFN's order (:func:`ffn_pipelined`).
_CHUNK = 48
_MAX_NCH = 6          # chunks of a C-wide sum in registers (csrc kMaxNch): C <= 288
_MIN_WIDE_NCH = 4     # a wide layer's groups of columns: 4-6 chunks (csrc kMinWideNch)
_BOX = 8192           # a 64 x 64 bf16 tile (csrc kBox)
_MAX_STAGES = 6       # weight-ring buffers, at most (csrc kMaxStages)


def swizzle_tiles(t: torch.Tensor) -> torch.Tensor:
    """(..., rows, n): rows of 128 bytes (64 bf16 or 32 f32) -> the same tiles
    in the 128-byte swizzle that TMA writes and ``wgmma`` reads: row r's
    16-byte group j moves to j ^ (r % 8). Its own inverse."""
    rows, n = t.shape[-2:]
    idx = torch.arange(8, device=t.device)[None, :] ^ (torch.arange(rows, device=t.device) % 8)[:, None]
    g = t.reshape(*t.shape[:-1], 8, n // 8)
    return torch.gather(g, -2, idx[..., None].expand(g.shape)).reshape(t.shape)


def k_tiles(wt: torch.Tensor, rows: int, kw: int = 64) -> torch.Tensor:
    """A product's B operand wt (N, K), K-major, as swizzled (rows, 64) tiles,
    one per kw-wide chunk of K (kw 48 or 64, the rest of a row zero):
    (ceil(K / kw), rows, 64) bf16, zero-padded."""
    n, k = wt.shape
    kc = -(-k // kw)
    out = torch.zeros((rows, kc, 64), dtype=torch.bfloat16, device=wt.device)
    full = torch.zeros((rows, kc * kw), dtype=torch.bfloat16, device=wt.device)
    full[:n, :k] = wt
    out[:, :, :kw] = full.reshape(rows, kc, kw)
    return swizzle_tiles(out.permute(1, 0, 2))


def ffn_pipelined(c: int) -> bool:
    """Whether proj_ffn overlaps an FFN chunk's SiLU with the next chunk's
    product: where C <= 144 leaves the registers for two chunks' sums. The
    order of its weight stream follows (the kernel's ``pipe``)."""
    return -(-c // _CHUNK) <= 3


def k_steps(c: int, cin: int, in_proj: bool) -> int:
    """16-deep steps in a K chunk of the row-tile kernels (3 or 4): the one
    that pads C (and Cin with the input projection) the least, 4 on a tie."""
    def pad(kw):
        return -(-c // kw) * kw + (-(-cin // kw) * kw if in_proj else 0)

    return 3 if pad(48) < pad(64) else 4


def row_tile_smem(kind: str, nw: int, ks: int, c: int, cin: int, in_proj: bool, nwg: int,
                  stages: int) -> int:
    """Dynamic shared memory of a launch of ``ln_qkv`` (kind "a") or
    ``proj_ffn`` ("c") (csrc ``smem_fixed`` plus the ring): per consumer
    warpgroup the A tile of max(Cin, C) columns (ln_qkv: x's tile, then
    LN(xf)'s) and its staging tile, or x's (with the input projection),
    ctx's and one h1 chunk's tiles (proj_ffn); ``stages`` weight tiles of
    ``nw`` rows; the barriers and the base's alignment."""
    kw = 16 * ks
    kc_in, kc = -(-cin // kw), -(-c // kw)
    sb = max(nw, 64) * 128
    if kind == "a":
        boxes = kc_in if in_proj and kc_in > kc else kc
        stage = -(-(64 * (nw + 8) * 2) // 1024) * 1024
        fixed = 1024 + nwg * (boxes * _BOX + stage) + (2 * _MAX_STAGES + 2) * 8
    else:
        boxes = (kc_in if in_proj else 0) + kc + 1
        fixed = 1024 + nwg * boxes * _BOX + (2 * _MAX_STAGES + 4) * 8
    return fixed + stages * sb


def row_tile_fits(nw: int, ks: int, c: int, cin: int, in_proj: bool, nwg: int, pipe: bool,
                  limit: int = None) -> bool:
    """Whether both row-tile kernels fit ``limit`` bytes at ``nwg`` consumer
    warpgroups on the least ring each runs (2; kc + 2 for the overlapped
    FFN)."""
    limit = limit or _H100_SMEM
    kc = -(-c // (16 * ks))
    return (row_tile_smem("a", nw, ks, c, cin, in_proj, nwg, 2) <= limit
            and row_tile_smem("c", nw, ks, c, cin, in_proj, nwg, kc + 2 if pipe else 2) <= limit)


@functools.lru_cache(maxsize=256)
def row_tile_layout(c: int, cin: int, in_proj: bool, limit: int = None):
    """(nw, ks, pipe) of the row-tile kernels' weight streams at these
    widths, None where no layout fits one block at one consumer warpgroup.
    Up to C = 288 (_MAX_NCH chunks) nw is C rounded up to _CHUNK: the
    C-wide sums in registers. Past it the kernels run wide: C's columns in
    groups of nw = 4-6 chunks (the fewest groups whose layout fits ``limit``;
    their columns cover C's K chunks), each C-wide f32 row through a scratch
    in device memory."""
    ks = k_steps(c, cin, in_proj)
    kc = -(-c // (16 * ks))
    n48 = -(-c // _CHUNK)
    cands = [n48] if n48 <= _MAX_NCH else []
    ngc = 2
    while -(-n48 // ngc) >= _MIN_WIDE_NCH:
        nch = -(-n48 // ngc)
        covers = -(-c // (nch * _CHUNK)) * nch * _CHUNK >= kc * 16 * ks
        if nch <= _MAX_NCH and covers and nch not in cands:
            cands.append(nch)
        ngc += 1
    for nch in cands:
        nw = nch * _CHUNK
        pipe = nw >= c and ffn_pipelined(c)
        if row_tile_fits(nw, ks, c, cin, in_proj, 1, pipe, limit):
            return nw, ks, pipe
    return None


def _stream(tiles, sb: int) -> torch.Tensor:
    """Tiles in the order a kernel consumes them, each in an sb-byte slot."""
    flat = [t.reshape(-1) for group in tiles for t in group]
    out = torch.zeros((len(flat), sb // 2), dtype=torch.bfloat16, device=flat[0].device)
    for i, t in enumerate(flat):
        out[i, :t.numel()] = t
    return out


@dataclasses.dataclass
class _Prepared:
    """One layer's operands in the row-tile kernels' layout on one device."""

    wa: torch.Tensor          # ln_qkv's weight stream
    wc: torch.Tensor          # proj_ffn's
    nw: int                   # rows of a weight tile (row_tile_layout)
    ks: int                   # k_steps of the K chunks
    pipe: bool                # ffn_pipelined: proj_ffn's stream order
    ngc: int                  # groups of C's columns: 1, or wide 2 or more
    vectors: dict             # f32 vectors by _Args field
    nf: int
    cout: int
    stages: tuple             # (ln_qkv, proj_ffn) ring depths of the last default plan
    # planned launch arguments by (T, L, Cin, ring depths asked for)
    args: dict = dataclasses.field(default_factory=dict)


def _layout(ops: LayerOperands, dev):
    c = ops.wq.shape[0]
    cin = ops.win.shape[0] if ops.win is not None else c
    return row_tile_layout(c, cin, ops.win is not None,
                           _smem_limit(dev) if dev.type == "cuda" else _H100_SMEM)


def _prepare(ops: LayerOperands, dev) -> _Prepared:
    c, h, dh, dhp = _dims(ops)
    f = ops.wi.shape[1]
    layout = _layout(ops, dev)
    if layout is None:
        raise ValueError(f"fused_transformer_layer: {_too_wide(ops)}")
    nw, ks, pipe = layout
    sb = max(nw, 64) * 128
    nf = -(-f // 64)
    cout = ops.wout.shape[1] if ops.wout is not None else c
    kw = 16 * ks
    groups = range(0, c, nw)   # C's columns: one group, or wide several

    def bt(w):   # (K, N) weight -> the B operand (N, K) in bf16 on dev
        return w.to(device=dev, dtype=torch.bfloat16).t()

    wqkv = torch.zeros((3, h, dhp, c), dtype=torch.bfloat16, device=dev)
    bqkv = torch.zeros((3, h, dhp), dtype=torch.float32, device=dev)
    for i, (w, b) in enumerate(((ops.wq, ops.bq), (ops.wk, ops.bk), (ops.wv, ops.bv))):
        wqkv[i, :, :dh] = bt(w).reshape(h, dh, c)
        bqkv[i, :, :dh] = b.to(dev).reshape(h, dh)
    wqkv = wqkv.reshape(-1, c)
    win = ([k_tiles(bt(ops.win)[n0:n0 + nw], nw, kw) for n0 in groups] if ops.win is not None
           else [])
    wa = win + [k_tiles(wqkv[n0:n0 + nw], nw, kw) for n0 in range(0, wqkv.shape[0], nw)]
    wi, wo, wo2 = bt(ops.wi), bt(ops.wo), bt(ops.wo2)
    # by groups: Win^T's rows then Wo^T's (x1's group)
    wc = [t for i, n0 in enumerate(groups)
          for t in win[i:i + 1] + [k_tiles(wo[n0:n0 + nw], nw, kw)]]
    wi_t = [k_tiles(wi[f0:f0 + 64], 64, kw) for f0 in range(0, nf * 64, 64)]
    if len(groups) > 1:   # wide: per group of output columns, every chunk's Wi then Wo2
        wc += [t for n0 in groups for f in range(nf)
               for t in (wi_t[f], k_tiles(wo2[n0:n0 + nw, 64 * f:64 * f + 64], nw))]
    elif pipe:   # Wi(0), then Wi(f + 1) before Wo2(f)
        wo2_t = [k_tiles(wo2[:, f0:f0 + 64], nw) for f0 in range(0, nf * 64, 64)]
        wc += [wi_t[0]] + [t for f in range(nf) for t in (wi_t[f + 1:f + 2] + [wo2_t[f]])]
    else:
        wc += [t for f in range(nf)
               for t in (wi_t[f], k_tiles(wo2[:, 64 * f:64 * f + 64], nw))]
    if ops.wout is not None:
        wout = bt(ops.wout)
        wc += [k_tiles(wout[n0:n0 + nw], nw, kw) for n0 in range(0, cout, nw)]
    bi = torch.zeros(nf * 64, dtype=torch.float32, device=dev)
    bi[:f] = ops.bi.to(dev)
    fl = ops.final_ln or (None, None)
    vectors = dict(ln1g=ops.ln1[0], ln1b=ops.ln1[1], bqkv=bqkv, bo=ops.bo, ln2g=ops.ln2[0],
                   ln2b=ops.ln2[1], bi=bi, bo2=ops.bo2, ln3g=fl[0], ln3b=fl[1])
    vectors = {k: None if v is None else _f32(v, dev) for k, v in vectors.items()}
    return _Prepared(wa=_stream(wa, sb), wc=_stream(wc, sb), nw=nw, ks=ks, pipe=pipe,
                     ngc=len(groups), vectors=vectors, nf=nf, cout=cout, stages=(0, 0))


def _f32(v: torch.Tensor, dev) -> torch.Tensor:
    return v.to(device=dev, dtype=torch.float32).contiguous()


class _Args(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "qkv", "ctx", "out", "wa", "wc", "scr", "ln1g", "ln1b", "bqkv", "bo", "ln2g", "ln2b",
        "bi", "bo2", "ln3g", "ln3b", "osc", "obi")] + [(name, ctypes.c_int) for name in (
        "T", "L", "Cin", "ldx", "C", "H", "dh", "dhp", "ldc", "nf", "Cout", "in_proj",
        "final_ln", "out_proj", "out_act", "stages_a", "stages_c", "ks", "ldo", "nwg", "nw",
        "pipe", "attn", "qsplit", "fsplit")] + [(name, ctypes.c_float) for name in (
        "eps", "final_eps", "scale")]


# the bf16 attention's plans (csrc kResident, kStreamed): a head's q, k and v
# whole in a block's shared memory, or 4 query tiles resident and the keys
# streamed twice through a ring
ATTENTION_PLANS = {"resident": 1, "streamed": 2}
RESIDENT_MAX_KEYS = 256   # the resident plan's longest sequence (csrc kMaxQTiles 64-row tiles)


def attention_plan(l: int) -> str:
    """The bf16 attention's plan at sequences of ``l`` tokens (csrc
    ``gxt_layer_plan``): resident up to RESIDENT_MAX_KEYS, streamed past
    it."""
    return "resident" if l <= RESIDENT_MAX_KEYS else "streamed"


_LIB = []   # the loaded library, bound (a timing tool may put a variant in its place)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of the kernels' C functions on ``lib``."""
    for fn in ("gxt_layer_ln_qkv", "gxt_layer_attention", "gxt_layer_proj_ffn",
               "gxt_layer_forward"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.gxt_layer_plan.restype = ctypes.c_int
    lib.gxt_layer_plan.argtypes = [ctypes.POINTER(_Args), ctypes.c_int]
    return lib


def _lib():
    if not _LIB:
        from ggml_experiments_tpu_torch import _build

        _LIB.append(bind(_build.load("transformer_layer")))
    return _LIB[0]


def row_tile_warpgroups(t: int, sms: int) -> int:
    """Consumer warpgroups (64 rows each) a block of the row-tile kernels:
    two, unless T rows in 128-row tiles would leave multiprocessors idle."""
    return 2 if -(-t // 128) >= sms else 1


def _smem_limit(dev) -> int:
    return getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin", 232448)


def _check(ops: LayerOperands, x: torch.Tensor, l: int, cin: int) -> None:
    """Raise unless the layer's kernels take x (T rows, bf16, CUDA), whose
    input has cin columns: L a multiple of 8, an even head width up to 64."""
    c, h, dh, dhp = _dims(ops)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError(f"fused_transformer_layer: the kernels take 2-D bf16 CUDA tensors, "
                         f"got {x.dtype}{tuple(x.shape)} on {x.device}")
    if l % 8 or c % h or dh % 2 or dh > 64 or x.shape[0] % l:
        raise ValueError(f"fused_transformer_layer: the kernels take L a multiple of 8 and an "
                         f"even head width up to 64, got L={l}, C={c}, H={h} ({x.shape[0]} "
                         f"rows)")
    if (ops.win is None and cin != c) or (ops.win is not None and ops.win.shape != (cin, c)):
        raise ValueError(f"fused_transformer_layer: x width {cin} does not meet the weights "
                         f"(C={c})")


def _too_wide(ops: LayerOperands) -> str:
    c = ops.wq.shape[0]
    cin = ops.win.shape[0] if ops.win is not None else c
    return (f"(C, Cin) = ({c}, {cin}){' with the input projection' if ops.win is not None else ''}"
            f": no layout of the row-tile kernels fits one block's shared memory at one "
            f"consumer warpgroup (a 64-row tile of C columns, x's tile of Cin beside it with the "
            f"input projection, and a ring of weight tiles; the wide groups take C past 288)")


def _launch_args(ops: LayerOperands, x: torch.Tensor, l: int, cin: int, plan=None,
                 attn=None):
    """(prepared operands, _Args) for a launch of the row-tile kernels on x,
    or None where they do not take the layer (:func:`row_tile_layout`; the
    attention's plan). ``plan`` = (ln_qkv, proj_ffn) ring depths forces
    them, ``attn`` ("resident" or "streamed") the attention's plan (tests,
    sweeps); None takes the plan's: the least ring each kernel runs, the
    attention of :func:`attention_plan`. Two consumer warpgroups a block
    where T's 128-row tiles fill the multiprocessors and the layout fits
    them, else one."""
    _check(ops, x, l, cin)
    dev, t = x.device, x.shape[0]
    prep = ops.cache.get(dev)
    a = prep.args.get((t, l, cin, plan, attn)) if prep is not None else None
    if a is None:
        if prep is None:
            if _layout(ops, dev) is None:
                return None
            prep = ops.cache[dev] = _prepare(ops, dev)
        c, h, dh, dhp = _dims(ops)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nwg = row_tile_warpgroups(t, sms)
        if nwg == 2 and not row_tile_fits(prep.nw, prep.ks, c, cin, ops.win is not None, 2,
                                          prep.pipe, _smem_limit(dev)):
            nwg = 1
        a = _Args(T=t, L=l, Cin=cin, ldx=cin, C=c, H=h, dh=dh, dhp=dhp, ldc=c, nf=prep.nf,
                  nwg=nwg, Cout=prep.cout, in_proj=int(ops.win is not None),
                  final_ln=int(ops.final_ln is not None), out_proj=int(ops.wout is not None),
                  out_act=int(ops.out_act), stages_a=(plan or (0, 0))[0],
                  stages_c=(plan or (0, 0))[1], ks=prep.ks, nw=prep.nw, pipe=int(prep.pipe),
                  attn=ATTENTION_PLANS[attn] if attn else 0,
                  qsplit=row_tile_split(t, nwg, -(-3 * h * dhp // prep.nw), prep.ngc, sms),
                  fsplit=(1 if ops.final_ln is not None or ops.wout is not None else
                          row_tile_split(t, nwg, prep.ngc, prep.ngc, sms)), eps=ops.eps,
                  final_eps=ops.final_eps, scale=1.0 / math.sqrt(dh),
                  wa=prep.wa.data_ptr(), wc=prep.wc.data_ptr())
        for k, v in prep.vectors.items():
            setattr(a, k, None if v is None else v.data_ptr())
        if _lib().gxt_layer_plan(ctypes.byref(a), _smem_limit(dev)) <= 0:
            return None
        if plan is None:
            prep.stages = (a.stages_a, a.stages_c)
        prep.args[(t, l, cin, plan, attn)] = a
    a = _Args.from_buffer_copy(a)
    if ops.out_affine is not None:   # a call's own BN vectors (the model makes them anew)
        a.keep = tuple(_f32(v, dev) for v in ops.out_affine)   # alive until the launch
        a.osc, a.obi = (v.data_ptr() for v in a.keep)
    return prep, a


def _row_tile_args(ops, x, l, cin, plan, what, attn=None):
    got = _launch_args(ops, x, l, cin, plan, attn)
    if got is None:
        c = ops.wq.shape[0]
        why = (_too_wide(ops) if _layout(ops, x.device) is None else
               f"the resident attention takes L up to {RESIDENT_MAX_KEYS}, the streamed L from "
               f"64; the rings within one block's {_smem_limit(x.device)} bytes of shared memory")
        raise ValueError(
            f"{what}: (L, Cin, C, F) = ({l}, {cin}, {c}, {ops.wi.shape[1]}) with ring depths "
            f"{plan} and attention plan {attn} is not a layer the row-tile kernels take: {why}")
    return got


def row_tile_split(t: int, nwg: int, groups: int, ngc: int, sms: int) -> int:
    """Blocks a row tile of a wide kernel (ngc > 1 groups of C) deals its
    ``groups`` of output columns to (ln_qkv's [q | k | v] groups; proj_ffn's
    FFN groups where neither the final LN nor the out-projection needs the
    whole row): as many as the groups allow and the T / (64 nwg) row tiles
    leave room for in one wave of one block a multiprocessor; 1 for one
    group of C (the kernels of the model widths). On an NVIDIA H100 80GB
    HBM3 at 700 W (tools/torch_kernel_bench.py --only layer_wide; PERF.md
    §6, row 6) a second wave made ln_qkv slower than one block a tile, and
    one wave beat one block a tile by 8-40% at every checked shape."""
    if ngc == 1:
        return 1
    return max(1, min(groups, sms // -(-t // (64 * nwg))))


def _scratch(prep: _Prepared, a) -> Optional[torch.Tensor]:
    """The wide kernels' f32 scratch, one copy for each block of a row tile
    (qsplit, fsplit: every row tile's 64 rows, ngc nw columns), its pointer
    set in ``a``; None (a null pointer) for one group."""
    if prep.ngc == 1:
        a.scr = None
        return None
    rows = -(-a.T // (64 * a.nwg)) * 64 * a.nwg
    scr = torch.empty((max(a.qsplit, a.fsplit), rows, prep.ngc * prep.nw), dtype=torch.float32,
                      device=prep.wa.device)
    a.scr = scr.data_ptr()
    return scr


def _run(lib, fn: str, a, dev, what) -> None:
    """Call the C function ``fn`` of ``lib`` on dev's current stream;
    ``what()`` names the launch if it fails."""
    from ggml_experiments_tpu_torch import _build

    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index is None or dev.index == torch.cuda.current_device():
        code = getattr(lib, fn)(ctypes.byref(a), stream)
    else:
        with torch.cuda.device(dev):
            code = getattr(lib, fn)(ctypes.byref(a), stream)
    if code:
        _build.check(lib, code, what())


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """t (rows, cols) bf16 readable by a 2-D tensor map: unit column stride, a
    row stride of a multiple of 8 elements, 16-byte aligned; else a copy."""
    if t.stride(1) == 1 and t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0:
        return t
    out = torch.zeros((t.shape[0], -(-t.shape[1] // 8) * 8), dtype=t.dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out[:, :t.shape[1]]


def ln_qkv_cuda(x2: torch.Tensor, ops: LayerOperands, l: int, *, _plan=None) -> torch.Tensor:
    """Kernel A on x2 (T, Cin) bf16 or f32 CUDA (T a multiple of l): the (T,
    3 H dhp) array of :func:`ln_qkv_plain` in x2's dtype. ``_plan`` forces
    the ring depths (bf16) or the consumer warpgroups, 1 or 2 (f32)."""
    if x2.dtype == torch.float32:
        return _ln_qkv_f32(x2, ops, l, _plan)
    c, h, dh, dhp = _dims(ops)
    x2 = _tma_ready(x2) if ops.win is not None else x2.contiguous()
    prep, a = _row_tile_args(ops, x2, l, x2.shape[1], _plan, "transformer ln_qkv")
    qkv = torch.empty((x2.shape[0], 3 * h * dhp), dtype=torch.bfloat16, device=x2.device)
    a.x, a.ldx, a.qkv = x2.data_ptr(), x2.stride(0), qkv.data_ptr()
    scr = _scratch(prep, a)   # noqa: F841 (alive until the launch)
    _run(_lib(), "gxt_layer_ln_qkv", a, x2.device,
         lambda: f"transformer ln_qkv (T, Cin, C) = ({x2.shape[0]}, {x2.shape[1]}, {c})")
    LAUNCHES["transformer_ln_qkv"] += 1
    if prep.ngc > 1:
        LAUNCHES["transformer_ln_qkv_wide"] += 1
    return qkv


def attention_cuda(qkv: torch.Tensor, l: int, ops: LayerOperands, *, _plan=None) -> torch.Tensor:
    """Kernel B on :func:`ln_qkv_cuda`'s array: ctx (T, C) in its dtype
    (bf16 rows padded to a multiple of 8 elements: a view). ``_plan``
    forces the bf16 plan ("resident" or "streamed") or the f32 block's
    consumer warpgroups, 1 or 2."""
    if qkv.dtype == torch.float32:
        return _attention_f32(qkv, l, ops, _plan)
    if _plan is not None and _plan not in ATTENTION_PLANS:
        raise ValueError(f"transformer attention: the bf16 plans are {sorted(ATTENTION_PLANS)}, "
                         f"got {_plan!r}")
    c, h, dh, dhp = _dims(ops)
    if qkv.dim() != 2 or qkv.shape[1] != 3 * h * dhp or not qkv.is_contiguous():
        raise ValueError(f"transformer attention: qkv must be a contiguous (T, {3 * h * dhp}) "
                         f"array, got {tuple(qkv.shape)}")
    prep, a = _row_tile_args(ops, qkv, l, c if ops.win is None else ops.win.shape[0], None,
                             "transformer attention", _plan)
    ldc = -(-c // 8) * 8
    ctx = torch.empty((qkv.shape[0], ldc), dtype=torch.bfloat16, device=qkv.device)
    a.qkv, a.ctx, a.ldc = qkv.data_ptr(), ctx.data_ptr(), ldc
    _run(_lib(), "gxt_layer_attention", a, qkv.device,
         lambda: f"transformer attention (T, L, C, H) = ({qkv.shape[0]}, {l}, {c}, {h})")
    LAUNCHES["transformer_attention"] += 1
    if a.attn == ATTENTION_PLANS["streamed"]:
        LAUNCHES["transformer_attention_streamed"] += 1
    return ctx[:, :c]


def proj_ffn_cuda(x2: torch.Tensor, ctx: torch.Tensor, ops: LayerOperands, l: int, *,
                  _plan=None) -> torch.Tensor:
    """Kernel C on x2 (T, Cin) and ctx (T, C) bf16 or f32 CUDA: (T, Cout) in
    their dtype. ``_plan`` forces the ring depths (bf16) or the consumer
    warpgroups, 1 or 2 (f32)."""
    if x2.dtype == torch.float32:
        return _proj_ffn_f32(x2, ctx, ops, l, _plan)
    c = ops.wq.shape[0]
    x2 = _tma_ready(x2) if ops.win is not None else x2.contiguous()
    ctx = _tma_ready(ctx)
    prep, a = _row_tile_args(ops, x2, l, x2.shape[1], _plan, "transformer proj_ffn")
    ldo = -(-prep.cout // 8) * 8
    out = torch.empty((x2.shape[0], ldo), dtype=torch.bfloat16, device=x2.device)
    a.x, a.ldx, a.ctx, a.ldc, a.out, a.ldo = (x2.data_ptr(), x2.stride(0), ctx.data_ptr(),
                                              ctx.stride(0), out.data_ptr(), ldo)
    scr = _scratch(prep, a)   # noqa: F841 (alive until the launch)
    _run(_lib(), "gxt_layer_proj_ffn", a, x2.device,
         lambda: f"transformer proj_ffn (T, Cin, C, Cout) = ({x2.shape[0]}, {x2.shape[1]}, "
                 f"{c}, {prep.cout})")
    LAUNCHES["transformer_proj_ffn"] += 1
    if prep.ngc > 1:
        LAUNCHES["transformer_proj_ffn_wide"] += 1
    return out[:, :prep.cout]


def fused_layer_cuda(x3: torch.Tensor, ops: LayerOperands, *, _plan=None) -> torch.Tensor:
    """The layer on a bf16 (bp, L, Cin) CUDA tensor with L a multiple of 8:
    the three row-tile kernels launched by one C call (:func:`ln_qkv_cuda`,
    :func:`attention_cuda`, :func:`proj_ffn_cuda` launch one each; past C =
    288 the wide ones), (bp, L, Cout) bf16; a layer they do not take raises
    with the reason. ``_plan`` forces the row-tile kernels' ring depths
    (tests, sweeps). An f32 tensor runs the three f32 kernels
    (:func:`fused_layer_f32_cuda`; ``_plan`` then forces the consumer
    warpgroups, 1 or 2)."""
    if x3.dtype == torch.float32:
        return fused_layer_f32_cuda(x3, ops, _plan)
    if x3.device.type != "cuda" or x3.dim() != 3 or x3.dtype != torch.bfloat16:
        raise ValueError(f"fused_layer_cuda: x must be a bf16 or f32 (bp, L, Cin) CUDA tensor, "
                         f"got {x3.dtype}{tuple(x3.shape)} on {x3.device}")
    bp, l, cin = x3.shape
    x2 = x3.reshape(bp * l, cin)
    x2 = _tma_ready(x2) if ops.win is not None else x2.contiguous()
    prep, a = _row_tile_args(ops, x2, l, cin, _plan, "fused_layer_cuda")
    c, h, dh, dhp = _dims(ops)
    t, dev = bp * l, x2.device
    ldc, ldo = -(-c // 8) * 8, -(-prep.cout // 8) * 8
    # q/k/v and ctx in one scratch allocation (ctx 16-byte aligned after q/k/v)
    nq = t * 3 * h * dhp
    scratch = torch.empty(nq + t * ldc, dtype=torch.bfloat16, device=dev)
    out = torch.empty((t, ldo), dtype=torch.bfloat16, device=dev)
    a.x, a.ldx, a.qkv, a.ctx, a.ldc, a.out, a.ldo = (
        x2.data_ptr(), x2.stride(0), scratch.data_ptr(), scratch.data_ptr() + 2 * nq, ldc,
        out.data_ptr(), ldo)
    scr = _scratch(prep, a)   # noqa: F841 (alive until the launch)
    _run(_lib(), "gxt_layer_forward", a, dev,
         lambda: f"fused_transformer_layer (bp, L, Cin, C) = ({bp}, {l}, {cin}, {c})")
    for k in ("fused_transformer_layer", "transformer_ln_qkv", "transformer_attention",
              "transformer_proj_ffn") + (("transformer_ln_qkv_wide", "transformer_proj_ffn_wide")
                                         if prep.ngc > 1 else ()):
        LAUNCHES[k] += 1
    if a.attn == ATTENTION_PLANS["streamed"]:
        LAUNCHES["transformer_attention_streamed"] += 1
    return out[:, :prep.cout].reshape(bp, l, -1)


# ---------------------------------------------------------------------------
# the f32 form (csrc/transformer_layer_f32.cu): the row-tile split and the
# q/k/v array of the bf16 form at f32, every product as 3xTF32 on tf32 wgmma
# ---------------------------------------------------------------------------

_H100_SMEM = 232448     # a block's shared memory on an H100, where no card is visible
_F32_MAX_C = 240        # C-wide sums in registers (csrc kMaxNC units of 48 columns)
_F32_KC = 32            # K of a weight tile: one 128-byte row (csrc kKC)
_F32_QW = 144           # q/k/v columns of a product (csrc kQW)
_F32_FW = 96            # FFN columns of a chunk (csrc kFW)
_F32_BOX = 8192         # a warpgroup tile's 32-column box of 64 rows (csrc kBox)
_F32_MAX_STAGES = 6     # ring buffers, at most (csrc kMaxStages)
_F32_STAGES = 4         # ring buffers the plan takes where they fit
_F32_MAX_KEYS = 256     # the attention's window: a row's scores in registers (csrc kMaxKeys)
_F32_MAX_L = 4096       # the longest sequence the gate takes (csrc: any)


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """v f32 rounded to tf32 as ``cvt.rna.tf32.f32`` does (to nearest, ties
    away from zero; the low 13 mantissa bits zero), as f32."""
    b = v.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(w: torch.Tensor):
    """(hi, lo) with w = hi + lo to about 2^-22 relative, each exact in tf32:
    the kernels' 3xTF32 operands (``split_tf32`` of ``csrc/mma_common.cuh``)."""
    w = w.float()
    hi = _tf32_rna(w)
    return hi, _tf32_rna(w - hi)


def f32_chunks(c: int):
    """(nch, w): the f32 row-tile kernels' C-wide products, nch chunks of w
    output columns over C padded to 48 ceil(C / 48) (csrc ``nchunks``,
    ``chunk_w``): C = 144 as 2 x 72, 192 as 2 x 96, 240 as 3 x 80."""
    nc = -(-c // 48)
    nch = -(-nc // 2)
    return nch, 48 * nc // nch


def f32_tiles(wt: torch.Tensor, rows: int, n_pad: Optional[int] = None) -> torch.Tensor:
    """A product's B^T (N, K) as the f32 kernels' weight tiles: (ceil(N /
    rows), ceil(K / 32), 2, rows, 32) f32, for each chunk of ``rows`` output
    columns and each 32-wide chunk of K (chunks of N outer) the tf32 hi plane
    then the lo plane (:func:`tf32_split`), K-major, each 128-byte row in the
    swizzle that wgmma reads (:func:`swizzle_tiles`); zero past N (or
    ``n_pad``) and K."""
    n, k = wt.shape
    nr = -(-(n_pad or n) // rows) * rows
    kp = -(-k // _F32_KC) * _F32_KC
    full = torch.zeros((nr, kp), dtype=torch.float32, device=wt.device)
    full[:n, :k] = wt.float()
    planes = torch.stack(tf32_split(full))                       # (2, nr, kp)
    t = planes.reshape(2, nr // rows, rows, kp // _F32_KC, _F32_KC).permute(1, 3, 0, 2, 4)
    return swizzle_tiles(t.contiguous())


def _f32_dims(cin: int, c: int, f: int, cout: int, in_proj: bool, out_proj: bool) -> dict:
    """The kernels' sizes (csrc ``dims``): products, K chunks, the
    warpgroups' tiles in 32-column boxes, ring buffer and stream bytes."""
    nch, w = f32_chunks(c)
    nkin, nkc = -(-cin // _F32_KC), -(-c // _F32_KC)
    nq, nf, noc = -(-3 * c // _F32_QW), -(-f // _F32_FW), -(-cout // w)
    xin = nkin if in_proj else 0
    d = dict(nch=nch, w=w, cp=48 * -(-c // 48), nkin=nkin, nkc=nkc, nq=nq, nf=nf, noc=noc,
             nba=max(xin, nkc),
             nbx=max(xin, _F32_FW // _F32_KC), nbc=nkc, sba=max(w, _F32_QW) * 256,
             sbc=max(w, _F32_FW) * 256)
    d["ta"] = (nch * nkin if in_proj else 0) + nq * nkc
    d["tc"] = ((nch * nkin if in_proj else 0) + nch * nkc
               + nf * (nkc + nch * _F32_FW // _F32_KC) + (noc * nkc if out_proj else 0))
    return d


def _f32_fixed(d: dict, kind: int, nwg: int) -> int:
    """Shared memory of a row-tile block besides its ring (csrc
    ``fixed_ln_qkv``, ``fixed_proj_ffn``): the base's 1024-byte alignment,
    the warpgroups' tiles, the vectors staged in shared memory (LN's gamma
    and beta, the biases, ln_qkv's column table, the BN scale and bias),
    the barriers."""
    if kind == 0:
        return (1024 + nwg * d["nba"] * _F32_BOX + 4 * (2 * d["cp"] + 2 * d["nq"] * _F32_QW)
                + 8 * (2 * _F32_MAX_STAGES + 2))
    return (1024 + nwg * (d["nbx"] + d["nbc"]) * _F32_BOX
            + 4 * (6 * d["cp"] + d["nf"] * _F32_FW + 2 * d["noc"] * d["w"])
            + 8 * (2 * _F32_MAX_STAGES + 4))


def f32_attention_streams(l: int) -> bool:
    """Whether the f32 attention walks the keys in windows with a running
    max (csrc ``attn_plan``'s ``stream``): past _F32_MAX_KEYS keys."""
    return l > _F32_MAX_KEYS


def f32_attention_block(l: int, dh: int):
    """(rows, keys, k-steps, query tiles) of an f32 attention block (csrc
    ``attn_plan``): 64 // L sequences packed into one 64-row tile where L <
    64, else one sequence; up to _F32_MAX_KEYS its rows are its keys,
    rounded up to 64, 128 or 256 for the scores' width; past it the keys
    come in windows of 256 (128 past a padded head of 48); ceil(dh / 8)
    k-steps of q.k^T."""
    rows = max(1, 64 // l) * l
    ks = -(-dh // 8)
    if f32_attention_streams(l):
        keys = _F32_MAX_KEYS if ks <= 6 else _F32_MAX_KEYS // 2
    else:
        keys = next(n for n in (64, 128, _F32_MAX_KEYS) if rows <= n)
    return rows, keys, ks, -(-rows // 64)


def f32_attention_smem(l: int, dh: int, nwg: int) -> int:
    """Bytes of shared memory of an f32 attention block on ``nwg`` consumer
    warpgroups (csrc ``attn_smem``): the 1024-byte alignment, k (ks k-steps
    of the keys, 32 bytes a key), v's staging then k's lo (dhp / 8 k-steps),
    v^T's raw and lo planes, each warpgroup's 64-row q tile, three
    barriers."""
    _, keys, ks, _ = f32_attention_block(l, dh)
    return 1024 + 32 * keys * ks + 12 * keys * head_pad(dh) + 2048 * nwg * ks + 24


def f32_attention_warpgroups(l: int, dh: int, nwg: Optional[int] = None) -> Optional[int]:
    """The f32 attention block's consumer warpgroups: two where it has two
    64-row query tiles or more, else one; ``nwg`` forces 1 or 2 (tests,
    sweeps). None where the block does not take them (more warpgroups than
    tiles)."""
    _, _, _, nt = f32_attention_block(l, dh)
    w = nwg or min(2, nt)
    return w if w in (1, 2) and w <= nt else None


def layer_f32_smem(l: int, cin: int, c: int, h: int, f: int, in_proj: bool,
                   plan=((1, 2), 1, (1, 2)), cout: Optional[int] = None):
    """Bytes of shared memory a block of each f32 kernel takes, (ln_qkv,
    attention, proj_ffn), as ``gxt_layer_f32_smem`` reckons them at ``plan``
    = ((consumer warpgroups, ring buffers) of ln_qkv, the attention's
    consumer warpgroups, (consumer warpgroups, ring buffers) of proj_ffn):
    the row tiles' f32 tiles of 64 rows, staged vectors (``cout``, default
    C, sizes the BN's) and ring of weight tiles; the attention's
    :func:`f32_attention_smem`."""
    d = _f32_dims(cin, c, f, cout or c, in_proj, False)
    (nwg_a, s_a), nwg_b, (nwg_c, s_c) = plan
    ln_qkv = _f32_fixed(d, 0, nwg_a) + s_a * d["sba"]
    attention = f32_attention_smem(l, c // h, nwg_b)
    proj_ffn = _f32_fixed(d, 2, nwg_c) + s_c * d["sbc"]
    return ln_qkv, attention, proj_ffn


def f32_layer_plan(t: int, l: int, cin: int, c: int, h: int, f: int, *, in_proj: bool,
                   limit: int, sms: int, nwg: Optional[int] = None,
                   cout: Optional[int] = None, nwg_b: Optional[int] = None):
    """((consumer warpgroups, ring buffers) of ln_qkv, the attention's
    consumer warpgroups, (consumer warpgroups, ring buffers) of proj_ffn)
    for T rows: the row tiles on two warpgroups where T / 128 tiles fill the
    ``sms`` multiprocessors (:func:`row_tile_warpgroups`) and two fit
    ``limit`` bytes, else one, with up to _F32_STAGES buffers, at least 2;
    the attention on :func:`f32_attention_warpgroups`. ``nwg`` forces the
    row tiles' warpgroups, ``nwg_b`` the attention's (tests, sweeps). None
    where a kernel does not fit."""
    want = nwg or row_tile_warpgroups(t, sms)
    d = _f32_dims(cin, c, f, cout or c, in_proj, False)
    plan = []
    for kind, sb in ((0, d["sba"]), (2, d["sbc"])):
        for w in (want,) if nwg or want == 1 else (2, 1):
            stages = min(_F32_STAGES, (limit - _f32_fixed(d, kind, w)) // sb)
            if stages >= 2:
                plan.append((w, stages))
                break
        else:
            return None
    wb = f32_attention_warpgroups(l, c // h, nwg_b)
    if wb is None or f32_attention_smem(l, c // h, wb) > limit:
        return None
    return plan[0], wb, plan[1]


def bf16_layer_takes(cin: int, c: int, h: int, *, in_proj: bool,
                     limit: Optional[int] = None) -> bool:
    """Whether the bf16 kernels take a layer of these widths (what
    :func:`_check` and :func:`row_tile_layout` ask before a launch): C heads
    of an even width up to 64, and a layout of the row-tile kernels that
    fits one block at one consumer warpgroup (C up to ~1280; Cin beside C
    with the input projection). Any L that is a multiple of 8."""
    if h <= 0 or c % h or (c // h) % 2 or c // h > 64:
        return False
    return row_tile_layout(c, cin if in_proj else c, in_proj, limit) is not None


def f32_layer_takes(l: int, cin: int, c: int, h: int, f: int, *, in_proj: bool,
                    limit: Optional[int] = None) -> bool:
    """Whether the f32 kernels take a layer of these widths: C heads of dh
    <= 64, C up to 240 (the row tiles' sums in registers) and a multiple of
    4 (TMA rows of 16 bytes), as Cin with the input projection; L up to
    4096 (past 256 the attention walks the keys in windows); each kernel's
    block within ``limit`` bytes of shared memory (default: the card's, or
    an H100's where no card is visible) with one warpgroup and two ring
    buffers (the BN vectors reckoned for a Cout up to 2C)."""
    if (l <= 0 or l > _F32_MAX_L or h <= 0 or c % h or c // h > 64 or c > _F32_MAX_C
            or c % 4):
        return False
    if in_proj and cin % 4:
        return False
    if limit is None:
        limit = _smem_limit(torch.device("cuda")) if torch.cuda.is_available() else _H100_SMEM
    return max(layer_f32_smem(l, cin, c, h, f, in_proj, cout=2 * c)) <= limit


class _F32Args(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "qkv", "ctx", "out", "wa", "wc", "ln1g", "ln1b", "bqkv", "bo", "ln2g", "ln2b",
        "bi", "bo2", "ln3g", "ln3b", "osc", "obi")] + [
        (name, ctypes.c_int) for name in (
            "T", "L", "Cin", "ldx", "C", "H", "dh", "dhp", "ldc", "F", "Cout", "ldo", "in_proj",
            "final_ln", "out_proj", "out_act", "nwg_a", "nwg_c", "stages_a", "stages_c",
            "nwg_b")] + [
        (name, ctypes.c_float) for name in ("eps", "final_eps", "scale")]


_F32_LIB = []


def bind_f32(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of the f32 kernels' C functions on ``lib``."""
    for fn in ("gxt_layer_ln_qkv_f32", "gxt_layer_attention_f32", "gxt_layer_proj_ffn_f32",
               "gxt_layer_forward_f32"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.POINTER(_F32Args), ctypes.c_void_p]
    lib.gxt_layer_f32_smem.restype = ctypes.c_longlong
    lib.gxt_layer_f32_smem.argtypes = [ctypes.POINTER(_F32Args), ctypes.c_int]
    return lib


def _f32_lib():
    if not _F32_LIB:
        from ggml_experiments_tpu_torch import _build

        _F32_LIB.append(bind_f32(_build.load("transformer_layer_f32")))
    return _F32_LIB[0]


@dataclasses.dataclass
class _PreparedF32:
    """One layer's operands in the f32 kernels' layout on one device."""

    wa: torch.Tensor          # ln_qkv's weight stream
    wc: torch.Tensor          # proj_ffn's
    vectors: dict             # f32 vectors by _F32Args field
    cout: int
    args: dict = dataclasses.field(default_factory=dict)   # launch arguments by (T, L, Cin, plan)


def _f32_stream(tiles, sb: int) -> torch.Tensor:
    """Weight tiles in the order a kernel consumes them, each in an sb-byte
    slot (f32)."""
    flat = [t.reshape(-1, t.shape[-3] * t.shape[-2] * t.shape[-1]) for t in tiles]
    out = torch.zeros((sum(t.shape[0] for t in flat), sb // 4), dtype=torch.float32,
                      device=flat[0].device)
    i = 0
    for t in flat:
        out[i:i + t.shape[0], :t.shape[1]] = t
        i += t.shape[0]
    return out


def _prepare_f32(ops: LayerOperands, dev) -> _PreparedF32:
    """The weights split once into the kernels' tf32 tiles, in the order the
    kernels consume them: ln_qkv's stream ``wa`` (Win^T by chunks of w
    columns, then the 3C real columns of [Wq | Wk | Wv]^T by 144), proj_ffn's
    ``wc`` (Win^T, Wo^T by w; per FFN chunk of 96, Wi^T's rows, then Wo2^T's
    by w; Wout^T by w); the vectors f32 (bqkv the 3C real biases, bi zero to
    whole FFN chunks)."""
    c, h, dh, dhp = _dims(ops)
    f = ops.wi.shape[1]
    cout = ops.wout.shape[1] if ops.wout is not None else c
    nch, w = f32_chunks(c)
    nf = -(-f // _F32_FW)

    def bt(m):   # (K, N) weight -> B^T (N, K) f32 on dev
        return m.to(device=dev, dtype=torch.float32).t()

    wi = torch.zeros((c, nf * _F32_FW), dtype=torch.float32, device=dev)
    wi[:, :f] = ops.wi.to(device=dev, dtype=torch.float32)
    wo2 = torch.zeros((nf * _F32_FW, c), dtype=torch.float32, device=dev)
    wo2[:f] = ops.wo2.to(device=dev, dtype=torch.float32)
    win = [f32_tiles(bt(ops.win), w, nch * w)] if ops.win is not None else []
    wqkv = torch.cat([bt(m) for m in (ops.wq, ops.wk, ops.wv)])
    wa = win + [f32_tiles(wqkv, _F32_QW)]
    wc = win + [f32_tiles(bt(ops.wo), w, nch * w)]
    for f0 in range(0, nf * _F32_FW, _F32_FW):
        wc += [f32_tiles(wi[:, f0:f0 + _F32_FW].t(), _F32_FW),
               f32_tiles(wo2[f0:f0 + _F32_FW].t(), w, nch * w)]
    if ops.wout is not None:
        wc.append(f32_tiles(bt(ops.wout), w))
    bqkv = torch.cat([b.to(device=dev, dtype=torch.float32) for b in (ops.bq, ops.bk, ops.bv)])
    bi = torch.zeros(nf * _F32_FW, dtype=torch.float32, device=dev)
    bi[:f] = ops.bi.to(dev)
    fl = ops.final_ln or (None, None)
    vectors = dict(ln1g=ops.ln1[0], ln1b=ops.ln1[1], bqkv=bqkv, bo=ops.bo, ln2g=ops.ln2[0],
                   ln2b=ops.ln2[1], bi=bi, bo2=ops.bo2, ln3g=fl[0], ln3b=fl[1])
    vectors = {k: None if v is None else _f32(v, dev) for k, v in vectors.items()}
    return _PreparedF32(wa=_f32_stream(wa, max(w, _F32_QW) * 256),
                        wc=_f32_stream(wc, max(w, _F32_FW) * 256), vectors=vectors, cout=cout)


def _f32_args(ops: LayerOperands, x: torch.Tensor, l: int, cin: int, what: str, nwg=None,
              nwg_b=None):
    """(prepared operands, _F32Args) for a launch of the f32 kernels on x (T
    rows): raises, naming the shape, where they do not take the layer (the
    shape is checked before the device). ``nwg`` forces the row tiles'
    consumer warpgroups, ``nwg_b`` the attention's (1 or 2; tests,
    sweeps)."""
    c, h, dh, dhp = _dims(ops)
    f = ops.wi.shape[1]
    in_proj = ops.win is not None
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"{what}: the f32 kernels take 2-D f32 tensors, got "
                         f"{x.dtype}{tuple(x.shape)}")
    if (ops.win is None and cin != c) or (ops.win is not None and ops.win.shape != (cin, c)):
        raise ValueError(f"{what}: x width {cin} does not meet the weights (C={c})")
    limit = _smem_limit(x.device) if x.device.type == "cuda" else _H100_SMEM
    if c % h or x.shape[0] % l or not f32_layer_takes(l, cin, c, h, f, in_proj=in_proj,
                                                     limit=limit):
        raise ValueError(
            f"{what}: (T, L, Cin, C, H, F) = ({x.shape[0]}, {l}, {cin}, {c}, {h}, {f}) is not a "
            f"layer the f32 kernels take (T a multiple of L, L up to {_F32_MAX_L}, a head "
            f"width up to 64, C up to {_F32_MAX_C} and C and Cin multiples of 4, each kernel's "
            f"block within {limit} bytes of shared memory: "
            f"{layer_f32_smem(l, cin, c, h, f, in_proj)})")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the f32 kernels take CUDA tensors, got one on {x.device}")
    if nwg not in (None, 1, 2):
        raise ValueError(f"{what}: the row tiles take 1 or 2 consumer warpgroups, got {nwg}")
    if nwg_b is not None and f32_attention_warpgroups(l, dh, nwg_b) is None:
        raise ValueError(f"{what}: the attention at L={l} takes 1 consumer warpgroup, or 2 "
                         f"where a block has two 64-row query tiles or more, got {nwg_b}")
    dev, t = x.device, x.shape[0]
    key = ("f32", dev)
    prep = ops.cache.get(key)
    if prep is None:
        prep = ops.cache[key] = _prepare_f32(ops, dev)
    a = prep.args.get((t, l, cin, nwg, nwg_b))
    if a is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = f32_layer_plan(t, l, cin, c, h, f, in_proj=in_proj, limit=limit, sms=sms,
                              nwg=nwg, cout=prep.cout, nwg_b=nwg_b)
        if plan is None:
            raise ValueError(f"{what}: (T, L, Cin, C) = ({t}, {l}, {cin}, {c}) with {nwg} "
                             f"consumer warpgroups does not fit one block's {limit} bytes of "
                             f"shared memory")
        (nwg_a, s_a), wb, (nwg_c, s_c) = plan
        a = _F32Args(T=t, L=l, Cin=cin, ldx=cin, C=c, H=h, dh=dh, dhp=dhp, ldc=c, F=f,
                     Cout=prep.cout, ldo=prep.cout, in_proj=int(in_proj),
                     final_ln=int(ops.final_ln is not None), out_proj=int(ops.wout is not None),
                     out_act=int(ops.out_act), nwg_a=nwg_a, nwg_c=nwg_c, stages_a=s_a,
                     stages_c=s_c, nwg_b=wb, eps=ops.eps, final_eps=ops.final_eps,
                     scale=1.0 / math.sqrt(dh), wa=prep.wa.data_ptr(), wc=prep.wc.data_ptr())
        for k, v in prep.vectors.items():
            setattr(a, k, None if v is None else v.data_ptr())
        lib = _f32_lib()
        want = layer_f32_smem(l, cin, c, h, f, in_proj, plan, prep.cout) + (
            4 * prep.wa.numel(), 4 * prep.wc.numel())
        got = tuple(lib.gxt_layer_f32_smem(ctypes.byref(a), kind) for kind in range(5))
        if got != want:
            raise RuntimeError(f"{what}: the kernels' shared memory and streams {got} differ "
                               f"from the wrapper's reckoning {want}")
        prep.args[(t, l, cin, nwg, nwg_b)] = a
    a = _F32Args.from_buffer_copy(a)
    if ops.out_affine is not None:   # a call's own BN vectors (the model makes them anew)
        a.keep = tuple(_f32(v, dev) for v in ops.out_affine)   # alive until the launch
        a.osc, a.obi = (v.data_ptr() for v in a.keep)
    return prep, a


def _contiguous16(t: torch.Tensor) -> torch.Tensor:
    """t contiguous with a 16-byte aligned start (TMA and cp.async read it),
    else a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ln_qkv_f32(x2: torch.Tensor, ops: LayerOperands, l: int, nwg=None) -> torch.Tensor:
    c, h, dh, dhp = _dims(ops)
    x2 = _contiguous16(x2)
    prep, a = _f32_args(ops, x2, l, x2.shape[1], "transformer ln_qkv f32", nwg)
    qkv = torch.empty((x2.shape[0], 3 * h * dhp), dtype=torch.float32, device=x2.device)
    a.x, a.qkv = x2.data_ptr(), qkv.data_ptr()
    _run(_f32_lib(), "gxt_layer_ln_qkv_f32", a, x2.device,
         lambda: f"transformer ln_qkv f32 (T, Cin, C) = ({x2.shape[0]}, {x2.shape[1]}, {c})")
    LAUNCHES["transformer_ln_qkv_f32"] += 1
    return qkv


def _attention_f32(qkv: torch.Tensor, l: int, ops: LayerOperands, nwg=None) -> torch.Tensor:
    c, h, dh, dhp = _dims(ops)
    if qkv.dim() != 2 or qkv.shape[1] != 3 * h * dhp:
        raise ValueError(f"transformer attention f32: qkv must be a (T, {3 * h * dhp}) array, "
                         f"got {tuple(qkv.shape)}")
    qkv = _contiguous16(qkv)
    prep, a = _f32_args(ops, qkv, l, c if ops.win is None else ops.win.shape[0],
                        "transformer attention f32", nwg_b=nwg)
    ctx = torch.empty((qkv.shape[0], c), dtype=torch.float32, device=qkv.device)
    a.qkv, a.ctx = qkv.data_ptr(), ctx.data_ptr()
    _run(_f32_lib(), "gxt_layer_attention_f32", a, qkv.device,
         lambda: f"transformer attention f32 (T, L, C, H) = ({qkv.shape[0]}, {l}, {c}, {h})")
    LAUNCHES["transformer_attention_f32"] += 1
    if f32_attention_streams(l):
        LAUNCHES["transformer_attention_f32_streamed"] += 1
    return ctx


def _proj_ffn_f32(x2: torch.Tensor, ctx: torch.Tensor, ops: LayerOperands, l: int,
                  nwg=None) -> torch.Tensor:
    c = ops.wq.shape[0]
    x2 = _contiguous16(x2)
    if ctx.shape != (x2.shape[0], c) or ctx.dtype != torch.float32:
        raise ValueError(f"transformer proj_ffn f32: ctx must be an f32 ({x2.shape[0]}, {c}) "
                         f"array, got {ctx.dtype}{tuple(ctx.shape)}")
    ctx = _contiguous16(ctx)
    prep, a = _f32_args(ops, x2, l, x2.shape[1], "transformer proj_ffn f32", nwg)
    out = torch.empty((x2.shape[0], prep.cout), dtype=torch.float32, device=x2.device)
    a.x, a.ctx, a.out = x2.data_ptr(), ctx.data_ptr(), out.data_ptr()
    _run(_f32_lib(), "gxt_layer_proj_ffn_f32", a, x2.device,
         lambda: f"transformer proj_ffn f32 (T, Cin, C, Cout) = ({x2.shape[0]}, {x2.shape[1]}, "
                 f"{c}, {prep.cout})")
    LAUNCHES["transformer_proj_ffn_f32"] += 1
    return out


def fused_layer_f32_cuda(x3: torch.Tensor, ops: LayerOperands, nwg=None) -> torch.Tensor:
    """The layer on an f32 (bp, L, Cin) CUDA tensor: the three f32 kernels
    launched by one C call (each counted); (bp, L, Cout) f32. Raises, naming
    the shape, where they do not take the layer. ``nwg`` forces the row
    tiles' consumer warpgroups (tests, sweeps)."""
    if x3.dim() != 3:
        raise ValueError(f"fused_layer_f32_cuda: x must be (bp, L, Cin), got {tuple(x3.shape)}")
    bp, l, cin = x3.shape
    x2 = _contiguous16(x3.reshape(bp * l, cin))
    prep, a = _f32_args(ops, x2, l, cin, "fused_transformer_layer f32", nwg)
    c, h, dh, dhp = _dims(ops)
    t, dev = bp * l, x2.device
    # q/k/v and ctx in one scratch allocation (ctx after q/k/v, 16-byte aligned)
    nq = t * 3 * h * dhp
    scratch = torch.empty(nq + t * c, dtype=torch.float32, device=dev)
    out = torch.empty((t, prep.cout), dtype=torch.float32, device=dev)
    a.x, a.qkv, a.ctx, a.out = (x2.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + 4 * nq,
                                out.data_ptr())
    _run(_f32_lib(), "gxt_layer_forward_f32", a, dev,
         lambda: f"fused_transformer_layer f32 (bp, L, Cin, C) = ({bp}, {l}, {cin}, {c})")
    for k in ("transformer_ln_qkv_f32", "transformer_attention_f32", "transformer_proj_ffn_f32"):
        LAUNCHES[k] += 1
    if f32_attention_streams(l):
        LAUNCHES["transformer_attention_f32_streamed"] += 1
    return out.reshape(bp, l, -1)


def _cached_operands(p, c, cd, final_ln, final_ln_eps, input_proj, output_proj):
    """The layer's LayerOperands for the CUDA path, kept on its params ``p``
    (one entry a compute dtype): gathered at its first call, they live as
    long as the model, and a
    forward prepares each layer's kernel layout once (``LayerOperands.cache``).
    The layer's own weights are read then; a caller that changes them builds
    new params, as loading does. The block's options come as fresh views of
    the block's weights every call: the entry is gathered anew when they are
    other tensors (another storage, shape or stride), and holds them while
    it lives. The conv_projection's BN vectors are taken from each call (a
    block without BN makes them anew)."""
    wout = output_proj[0] if output_proj is not None else None
    block = (input_proj, *(final_ln or (None, None)), wout)
    key = (cd, c, final_ln_eps, output_proj[3] if output_proj is not None else None,
           tuple(None if t is None else (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in block))
    attr = "_gxt_fused_operands_f32" if cd == torch.float32 else "_gxt_fused_operands"
    hit = getattr(p, attr, None)
    if hit is None or hit[0] != key:
        hit = (key, layer_operands(p, c, cd, final_ln=final_ln, final_ln_eps=final_ln_eps,
                                   input_proj=input_proj, output_proj=output_proj), block)
        object.__setattr__(p, attr, hit)
    ops = hit[1]
    if output_proj is not None:   # as layer_operands gathers them
        vec = [torch.zeros(wout.shape[-1], device=wout.device) if v is None else v.float()
               for v in output_proj[1:3]]
        ops = dataclasses.replace(ops, out_affine=tuple(vec))
    return ops


_LAYER_WEIGHTS = ("intermediate_kernel", "intermediate_bias", "output_kernel", "output_bias")
_ATTENTION_WEIGHTS = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")


def _gathered(p):
    """``p`` with every weight that is a rank's shard (neither a tensor nor a
    QTensor: ``parallel.sharding.Placed``) gathered whole, as the JAX
    partition rule replicates the layer's weights; None when ``p`` holds no
    shard. The copy is the call's own: nothing of it is kept on ``p``."""
    def shard(w):
        return w is not None and not isinstance(w, (torch.Tensor, QTensor))

    att = p.attention
    if not any(shard(getattr(att, n)) for n in _ATTENTION_WEIGHTS) and not any(
            shard(getattr(p, n)) for n in _LAYER_WEIGHTS):
        return None

    def whole(obj, names):
        return {n: getattr(obj, n).gather() for n in names if shard(getattr(obj, n))}

    return dataclasses.replace(
        p, attention=dataclasses.replace(att, **whole(att, _ATTENTION_WEIGHTS)),
        **whole(p, _LAYER_WEIGHTS))


def _op_operands(x3, weights, vectors, num_heads, eps, final_eps, win, ln3g, ln3b, wout, osc,
                 obi, out_act) -> LayerOperands:
    """The custom op's arguments as LayerOperands (kept by their tensors'
    identities and versions, so that a replayed program prepares each
    layer's kernel layout once)."""
    wq, wk, wv, wo, wi, wo2 = weights
    ln1g, ln1b, bq, bk, bv, bo, ln2g, ln2b, bi, bo2 = vectors
    tensors = [*weights, *vectors, win, ln3g, ln3b, wout]
    key = (num_heads, eps, final_eps, out_act, tuple(
        None if t is None else (t.data_ptr(), tuple(t.shape), t.device, t._version)
        for t in tensors))
    hit = _OP_OPERANDS.get(key)
    if hit is None:
        hit = LayerOperands(wq=wq, wk=wk, wv=wv, wo=wo, wi=wi, wo2=wo2, ln1=(ln1g, ln1b), bq=bq,
                            bk=bk, bv=bv, bo=bo, ln2=(ln2g, ln2b), bi=bi, bo2=bo2,
                            num_heads=num_heads, eps=eps, final_eps=final_eps, win=win,
                            wout=wout, out_act=out_act,
                            final_ln=None if ln3g is None else (ln3g, ln3b))
        if len(_OP_OPERANDS) >= 64:
            _OP_OPERANDS.pop(next(iter(_OP_OPERANDS)))
        _OP_OPERANDS[key] = hit
        hit.cache["tensors"] = tensors   # held while the entry lives
    if wout is None:
        return hit
    return dataclasses.replace(hit, out_affine=(osc, obi))


_OP_OPERANDS: dict = {}


@torch.library.custom_op("gxt::transformer_layer_f32", mutates_args=())
def transformer_layer_f32_op(x: torch.Tensor, weights: List[torch.Tensor],
                             vectors: List[torch.Tensor], num_heads: int, eps: float,
                             final_eps: float, win: Optional[torch.Tensor],
                             ln3g: Optional[torch.Tensor], ln3b: Optional[torch.Tensor],
                             wout: Optional[torch.Tensor], osc: Optional[torch.Tensor],
                             obi: Optional[torch.Tensor], out_act: bool) -> torch.Tensor:
    """What a traced f32 program calls: x (bp, L, Cin); weights (wq, wk, wv,
    wo, wi, wo2) as (K, N) f32; vectors (ln1 gamma, beta, bq, bk, bv, bo, ln2
    gamma, beta, bi, bo2) f32; the block's options or None. This body is the
    CPU implementation: the plain version."""
    return fused_transformer_layer_plain(x, _op_operands(
        x, weights, vectors, num_heads, eps, final_eps, win, ln3g, ln3b, wout, osc, obi, out_act))


@transformer_layer_f32_op.register_kernel("cuda")
def _transformer_layer_f32_op_cuda(x, weights, vectors, num_heads, eps, final_eps, win, ln3g,
                                   ln3b, wout, osc, obi, out_act):
    return fused_layer_f32_cuda(x, _op_operands(
        x, weights, vectors, num_heads, eps, final_eps, win, ln3g, ln3b, wout, osc, obi, out_act))


@transformer_layer_f32_op.register_fake
def _transformer_layer_f32_op_fake(x, weights, vectors, num_heads, eps, final_eps, win, ln3g,
                                   ln3b, wout, osc, obi, out_act):
    cout = wout.shape[1] if wout is not None else weights[0].shape[0]
    return x.new_empty((x.shape[0], x.shape[1], cout))


def _op_call(x3: torch.Tensor, ops: LayerOperands) -> torch.Tensor:
    fl = ops.final_ln or (None, None)
    oa = ops.out_affine or (None, None)
    return transformer_layer_f32_op(
        x3, [ops.wq, ops.wk, ops.wv, ops.wo, ops.wi, ops.wo2],
        [ops.ln1[0], ops.ln1[1], ops.bq, ops.bk, ops.bv, ops.bo, ops.ln2[0], ops.ln2[1], ops.bi,
         ops.bo2], ops.num_heads, ops.eps, ops.final_eps, ops.win, fl[0], fl[1], ops.wout,
        oa[0], oa[1], ops.out_act)


def fused_transformer_layer(p, x: torch.Tensor, *, compute_dtype=torch.bfloat16,
                            final_ln=None, final_ln_eps: Optional[float] = None,
                            input_proj: Optional[torch.Tensor] = None,
                            output_proj=None) -> torch.Tensor:
    """One pre-LN ViT encoder layer (``TransformerLayerParams``, duck-typed)
    on x (..., L, C), or (..., L, Cin) with ``input_proj`` (Cin, C).
    ``final_ln=(gamma, beta)`` adds the block's post-stack LN with
    ``final_ln_eps`` (default the layer's eps); ``output_proj=(kernel (C,
    Cout), bn_scale, bn_bias, act)`` the block's conv_projection, after it.
    A layer placed on a mesh (``parallel.sharding.mobilevit_param_specs``)
    has its shards gathered once a call, and its operands are not kept.
    Under ``torch.export`` an f32 layer is the custom op
    ``gxt::transformer_layer_f32`` (:func:`transformer_layer_f32_op`)."""
    *lead, l, cin = x.shape
    cd = resolve_dtype(compute_dtype)
    h = p.attention.num_heads
    c = input_proj.shape[1] if input_proj is not None else cin
    if c % h:
        raise ValueError(f"C={c} not divisible by num_heads={h}")
    x3 = x.reshape(-1, l, cin).to(cd)
    cpu = x3.device.type == "cpu"
    whole = _gathered(p)
    compiling = torch.compiler.is_compiling() and cd == torch.float32
    if cpu or compiling or whole is not None:
        ops = layer_operands(p if whole is None else whole, c, cd, final_ln=final_ln,
                             final_ln_eps=final_ln_eps, input_proj=input_proj,
                             output_proj=output_proj)
    else:
        ops = _cached_operands(p, c, cd, final_ln, final_ln_eps, input_proj, output_proj)
    if compiling:
        out = _op_call(x3, ops)
    else:
        out = fused_transformer_layer_plain(x3, ops) if cpu else fused_layer_cuda(x3, ops)
    return out.reshape(*lead, l, out.shape[-1])
