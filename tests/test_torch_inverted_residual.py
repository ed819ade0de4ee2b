"""Port: the strip kernel of the fused inverted residual
(``csrc/inverted_residual.cu``) as far as the CPU can check it: its plans
(``ir_plan``, ``ir_smem_bytes``), the layouts of its operands
(``ir_operands``), the operands a block keeps (``block_operands``), and a
plain-torch walk of its schedule (strips of S columns, bands of R rows, a
ring of R + 2 expanded rows with zeros after the SiLU outside the image, y's
rows in the kernel's order) that must give ``fused_ir_plain``'s bits. Then
the tile kernels of ``csrc/ir_hopper.cuh`` (f32 at stride 1, bf16 and f32
at stride 2): their tiles (``ir_tc_tile``, ``ir_tc_plan``), shared memory,
the weights' K-major planes split once (``ir_f32_operands``,
``ir_s2_operands``), and a plain-torch walk of their schedule from those
planes, held to ``fused_ir_plain``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from ggml_experiments_tpu_torch.models.mobilevit import InvertedResidualParams
from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir
from ggml_experiments_tpu_torch.ops.activations import silu
from ggml_experiments_tpu_torch.ops.conv import ConvBNAct
from ggml_experiments_tpu_torch.ops.fused_transformer_layer import swizzle_tiles, tf32_split
from ggml_experiments_tpu_torch.ops.norm import FoldedBN

BF = torch.bfloat16

# (C, E, Cout) of MobileViT-small's stride-1 blocks (layer_2 runs fused; the
# layer_1 one is the bench's second cell) and of the card tests' strip shapes
MODEL_WIDTHS = [(64, 256, 64), (16, 64, 32)]
CARD_WIDTHS = [(8, 32, 16), (24, 96, 24), (8, 32, 8), (8, 64, 8), (16, 64, 16), (32, 128, 72),
               (16, 256, 32), (64, 256, 64), (16, 64, 32)]


def _weights(rng, c, e, cout):
    def t(*s, scale=0.3):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))

    return t(c, e), t(e), t(3, 3, e), t(e), t(e, cout), t(cout)


def _bands(b, h, w, plan):
    """The output bands the kernel stores, in a block's order: (image, x0,
    y0) of each S x R box, clipped to the image by the TMA store."""
    nsx, nb = math.ceil(w / plan.s), math.ceil(h / fir.BAND)
    for strip in range(b * nsx):
        for r in range(1, nb + 1):
            yield strip // nsx, (strip % nsx) * plan.s, (r - 1) * fir.BAND


@pytest.mark.parametrize("c,e,cout", sorted(set(MODEL_WIDTHS + CARD_WIDTHS)))
def test_ir_plans_fit_a_block_and_cover_every_output_once(c, e, cout):
    plans = fir.ir_plans(c, e, cout)
    assert fir.ir_plan(128, 64, 64, c, e, cout) in plans
    assert len(plans) == len(fir.PLAN_STRIPS) * len(fir.PLAN_STAGES)
    for plan in plans:
        assert fir.ir_smem_bytes(plan, c, e, cout) <= fir.SMEM_LIMIT
        for b, h, w in ((2, 64, 64), (1, 9, 17), (2, 5, 33), (1, 1, 1), (1, 2, 2)):
            seen = torch.zeros((b, h, w), dtype=torch.int32)
            for img, x0, y0 in _bands(b, h, w, plan):
                seen[img, y0:y0 + fir.BAND, x0:x0 + plan.s] += 1
            assert bool((seen == 1).all()), (plan, b, h, w)


def test_ir_plan_takes_the_main_paths_cut_and_the_tile_kernel_the_rest():
    assert fir.ir_plan(128, 64, 64, 64, 256, 64) == fir.IRPlan(32, 3)
    assert fir.ir_plan(1, 9, 9, 24, 96, 24) == fir.IRPlan(16, 3)
    # a 2-stage x ring where 3 stages do not fit beside a wide Wred
    assert fir.ir_plan(128, 64, 64, 64, 128, 384) == fir.IRPlan(32, 2)
    # C or Cout not a multiple of 8 (TMA strides), C past 64 (Wexp's fragments
    # in registers), E past 256 (16 warps of 16 channels), rings past a
    # block: no plan, the tile kernel
    for widths in ((12, 48, 12), (64, 96, 20), (128, 256, 128), (64, 384, 64), (8, 33, 8)):
        assert fir.ir_plans(*widths) == () and fir.ir_plan(1, 8, 8, *widths) is None
    assert fir.ir_plans(64, 256, 64, limit=110_000) == ()


def _slot(y, r):
    return (y + 2 * (r + 2)) % (r + 2)


def _y_row(i, q, k, s):
    return i * s + 8 * (k >> 1) + 2 * q + (k & 1)


def strip_schedule(x, wexp, bexp, kdw, bdw, wred, bred, plan, use_residual):
    """``csrc/inverted_residual.cu``'s walk in plain torch: each strip of
    plan.s columns runs down its image in steps of BAND = r rows; step it
    expands only band it's new rows into a ring of r + 2 slots (zeros after
    the SiLU outside the image) and runs band it - 1's depthwise from the
    ring in the TPU body's order, writing y's rows in the kernel's order,
    which the reduce maps back to pixels. The expand and reduce products are
    those of ``fused_ir_plain`` (the kernel's sum within one product is the
    tensor cores' own)."""
    b, h, w, c = x.shape
    e = wexp.shape[1]
    s, r = plan.s, fir.BAND
    ex = silu(torch.matmul(x.reshape(-1, c).float(), wexp.float()) + bexp).to(BF)
    ex = ex.reshape(b, h, w, e)
    k = kdw.float()
    y = torch.full((b, h, w, e), float("nan"), dtype=BF)
    nsx, nb = math.ceil(w / s), math.ceil(h / r)
    qi, ki = torch.meshgrid(torch.arange(4), torch.arange(s // 4), indexing="ij")
    for strip in range(b * nsx):
        img, x0 = strip // nsx, (strip % nsx) * s
        ring = torch.full((r + 2, s + 2, e), float("nan"), dtype=BF)
        for it in range(nb + 1):
            for i in range(r):
                yy = (it - 1) * r + 1 + i
                row = torch.zeros((s + 2, e), dtype=BF)
                lo, hi = max(0, 1 - x0), min(s + 2, w + 1 - x0)
                if 0 <= yy < h and lo < hi:
                    row[lo:hi] = ex[img, yy, x0 - 1 + lo:x0 - 1 + hi]
                ring[_slot(yy, r)] = row
            if it < 1:
                continue
            y0 = (it - 1) * r
            win = torch.stack([ring[_slot(y0 - 1 + ii, r)] for ii in range(r + 2)]).float()
            acc = torch.zeros((r, s, e))
            for dj in range(3):
                t = torch.zeros((r, s + 2, e))
                for di in range(3):
                    t = t + win[di:di + r] * k[di, dj]
                acc = acc + t[:, dj:dj + s]
            band = silu(acc + bdw).to(BF)                    # (r, s, e): output pixels
            tile = torch.empty((r * s, e), dtype=BF)         # y's rows as the kernel orders them
            for i in range(r):
                rows = _y_row(i, qi, ki, s).reshape(-1)
                tile[rows] = band[i, (qi * (s // 4) + ki).reshape(-1)]
            for row in range(r * s):                         # the reduce epilogue's mapping
                i, rr = divmod(row, s)
                jj = ((rr & 7) >> 1) * (s // 4) + 2 * (rr >> 3) + (rr & 1)
                if y0 + i < h and x0 + jj < w:
                    y[img, y0 + i, x0 + jj] = tile[row]
    out = torch.matmul(y.reshape(-1, e).float(), wred.float()) + bred
    if use_residual:
        out = out + x.reshape(-1, c).float()
    return out.to(BF).reshape(b, h, w, wred.shape[1])


@pytest.mark.parametrize("plan", [fir.IRPlan(s, 2) for s in fir.PLAN_STRIPS])
@pytest.mark.parametrize("b,h,w,resid", [(2, 7, 37, True), (1, 3, 17, False), (1, 1, 5, True),
                                         (1, 11, 2, False), (1, 2, 16, True), (2, 4, 1, False)])
def test_strip_schedule_gives_the_plain_versions_bits(plan, b, h, w, resid):
    """Odd H and W, W not a multiple of S, H < R + 2, H = R, W = 1: the zero
    ring, ragged strips and ragged bands."""
    c, e = 8, 24
    rng = np.random.default_rng(h * w + plan.s + fir.BAND)
    args = _weights(rng, c, e, c if resid else 16)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(BF)
    pargs = (args[0].to(BF), *args[1:4], args[4].to(BF), args[5])
    want = fir.fused_ir_plain(x, *pargs, use_residual=resid)
    got = strip_schedule(x, *pargs, plan, resid)
    assert torch.equal(got, want)


def _unswizzle(tiles):
    """(n, rows, 64) tiles in the 128-byte swizzle -> the plain rows (the
    swizzle XORs each 16-byte group with the row: it is its own inverse)."""
    return swizzle_tiles(tiles)


@pytest.mark.parametrize("c,e,cout", [(64, 256, 64), (16, 64, 32), (24, 96, 24), (32, 128, 72)])
def test_ir_operands_lay_each_weight_where_the_kernel_reads_it(c, e, cout):
    wexp, bexp, kdw, bdw, wred, bred = _weights(np.random.default_rng(c + e), c, e, cout)
    ops = fir.ir_operands(wexp, bexp, kdw, bdw, wred, bred)
    ep, cn = -(-e // 64) * 64, -(-cout // 64) * 64
    assert isinstance(ops, fir.IROperands)
    assert ops.wexp.shape == (1, ep, 64) and ops.wred.shape == (ep // 64, cn, 64)
    # row n of chunk j holds the weights of output channel n for inputs 64j ..
    we = _unswizzle(ops.wexp).permute(1, 0, 2).reshape(ep, -1)
    wr = _unswizzle(ops.wred).permute(1, 0, 2).reshape(cn, -1)
    assert torch.equal(we[:e, :c], wexp.t().to(BF)) and not we[e:].any() and not we[:, c:].any()
    assert torch.equal(wr[:cout, :e], wred.t().to(BF)) and not wr[cout:].any()
    assert not wr[:, e:].any()
    for got, want, n in ((ops.bexp, bexp, ep), (ops.bdw, bdw, ep), (ops.bred, bred, cn)):
        assert got.shape == (n,) and torch.equal(got[:want.numel()], want)
        assert not got[want.numel():].any()
    assert torch.equal(ops.kdw.reshape(9, ep)[:, :e], kdw.reshape(9, e))
    # the widths the strip kernel does not take get the wide kernel's K-major
    # planes (csrc/inverted_residual_wide.cu): one bf16 plane, E and K padded to 64
    wide = fir.ir_operands(*_weights(np.random.default_rng(1), 12, 48, 12))
    assert isinstance(wide, fir.IRTCOperands) and wide.dtype == BF
    assert wide.tile == (8, 16) and wide.ncp == 64
    assert wide.wexp.shape == (1, 1, 1, 64, 64) and wide.kdw.shape == (9 * 64,)


def _block(rng, c=16, e=64, cout=16):
    def conv(kh, cin, co, dw=False, act="silu"):
        k = torch.from_numpy((rng.standard_normal((kh, kh, cin, co)) * 0.3).astype(np.float32))
        bn = FoldedBN(torch.from_numpy(rng.uniform(0.5, 1.5, co).astype(np.float32)),
                      torch.from_numpy((rng.standard_normal(co) * 0.1).astype(np.float32)))
        return ConvBNAct(kernel=k, bn=bn, activation=act, depthwise=dw)

    return InvertedResidualParams(expand_1x1=conv(1, c, e), conv_3x3=conv(3, 1, e, dw=True),
                                  reduce_1x1=conv(1, e, cout, act="none"), use_residual=True,
                                  fused=True)


def test_block_operands_are_made_once_and_again_after_a_weight_changes():
    blk = _block(np.random.default_rng(4))
    ops = fir.block_operands(blk)
    assert fir.block_operands(blk) is ops
    # another tensor for a weight
    blk.expand_1x1.kernel = blk.expand_1x1.kernel * 2
    again = fir.block_operands(blk)
    assert again is not ops and fir.block_operands(blk) is again
    folded = fir.ir_operands(*fir._folded(blk))
    assert torch.equal(again.wexp, folded.wexp)
    # a BN vector written in place
    blk.reduce_1x1.bn.bias.add_(1.0)
    third = fir.block_operands(blk)
    assert third is not again and torch.equal(third.bred[:16], again.bred[:16] + 1.0)
    # a copy of the block (dataclasses.replace) starts without them
    assert fir.block_operands(dataclasses.replace(blk)) is not third


# ---- the tile kernels of csrc/ir_hopper.cuh ------------------------------------------

F32 = torch.float32
# (stride, C, E, Cout) of MobileViT-small's fused blocks at f32 and at stride 2
TC_MODEL_WIDTHS = [(1, 64, 256, 64), (1, 16, 64, 32), (2, 32, 128, 64), (2, 64, 256, 96),
                   (2, 96, 384, 128), (2, 128, 512, 160)]


@pytest.fixture
def two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _planes(ops):
    """The operands' planes as the kernel reads them, unswizzled: Wexp^T
    (parts, Ep, Kp) and Wred^T (parts, nc, Ep), nc the passes' output
    channels (passes x ncp)."""
    nch, parts, slabs, kw = ops.wexp.shape[:4]
    wx = swizzle_tiles(ops.wexp).permute(1, 0, 3, 2, 4).reshape(parts, nch * kw, slabs * kw)
    ncp = ops.wred.shape[2]
    passes = ops.wred.shape[0] // nch
    wr = swizzle_tiles(ops.wred).reshape(passes, nch, parts, ncp, kw).permute(2, 0, 3, 1, 4)
    return wx, wr.reshape(parts, passes * ncp, nch * kw)


@pytest.mark.parametrize("cd", [F32, BF])
@pytest.mark.parametrize("c,e,cout", [(24, 100, 40), (64, 256, 64), (12, 64, 160), (130, 70, 33)])
def test_tile_operands_split_the_weights_once_k_major(cd, c, e, cout):
    """Each chunk's Wexp^T rows (K = C in slabs of one 128-byte row) and
    Wred^T rows (K = the chunk), swizzled: at f32 the tf32 hi plane (its low
    13 mantissa bits zero) and the lo plane, hi + lo the weight to 2^-21;
    at bf16 one plane, the weight rounded; zeros in every pad."""
    wexp, bexp, kdw, bdw, wred, bred = args = _weights(np.random.default_rng(c + e), c, e, cout)
    ops = (fir.ir_s2_operands(*args, compute_dtype=cd) if cout > fir.F32_MAX_COUT or cd == BF
           else fir.ir_f32_operands(*args))
    kw = 32 if cd == F32 else 64
    ep, kp, nc = -(-e // kw) * kw, -(-c // kw) * kw, -(-cout // 64) * 64
    parts = 2 if cd == F32 else 1
    assert ops.dtype == cd and ops.wexp.dtype == ops.wred.dtype == cd
    assert ops.wexp.shape == (ep // kw, parts, kp // kw, kw, kw)
    assert ops.wred.shape == (ep // kw, parts, nc, kw)
    wx, wr = _planes(ops)
    assert not wx[:, e:].float().any() and not wx[:, :, c:].float().any()
    assert not wr[:, cout:].float().any() and not wr[:, :, e:].float().any()
    if cd == F32:
        for plane in (wx[0], wr[0]):
            assert not (plane.view(torch.int32) & 0x1FFF).any()
        for got, want in ((wx[0] + wx[1], wexp.t()), (wr[0] + wr[1], wred.t())):
            n, k = want.shape
            assert float((got[:n, :k] - want).abs().max()) <= 2 ** -21 * float(want.abs().max())
        assert torch.equal(wx[0][:e, :c] + wx[1][:e, :c], tf32_split(wexp.t())[0]
                           + tf32_split(wexp.t())[1])
    else:
        assert torch.equal(wx[0][:e, :c], wexp.t().to(BF))
        assert torch.equal(wr[0][:cout, :e], wred.t().to(BF))
    for got, want, n in ((ops.bexp, bexp, ep), (ops.bdw, bdw, ep), (ops.bred, bred, nc)):
        assert got.shape == (n,) and torch.equal(got[:want.numel()], want)
        assert not got[want.numel():].any()
    assert torch.equal(ops.kdw.reshape(9, ep)[:, :e], kdw.reshape(9, e))
    assert not ops.kdw.reshape(9, ep)[:, e:].any()


def test_tile_kernels_shared_memory_fits_at_the_model_widths():
    """Every fused block of MobileViT-small gets a tile whose shared memory
    fits a block (f32 stride 1 and both dtypes at stride 2); the widths the
    kernels do not take read -1, and a halo past the block (C = 512 at f32)
    reads its bytes past the limit."""
    for stride, c, e, cout in TC_MODEL_WIDTHS:
        dts = (F32,) if stride == 1 else (F32, BF)
        for cd in dts:
            f32 = cd == F32
            tile = fir.ir_tc_tile(f32, stride, c, cout)
            need = (fir.ir_f32_smem_bytes(c, e, cout) if stride == 1
                    else fir.ir_s2_smem_bytes(c, e, cout, cd))
            assert need == fir._tc_smem(f32, stride, tile, c, cout) <= fir.SMEM_LIMIT
    assert fir.ir_tc_tile(True, 1, 64, 64) == (8, 16)
    assert fir.ir_tc_tile(True, 2, 32, 64) == (8, 8)
    assert fir.ir_tc_tile(False, 2, 128, 160) == (8, 8)
    assert fir.ir_tc_tile(True, 2, 128, 160) == (2, 8)   # the f32 halo of C = 128
    assert fir.ir_f32_smem_bytes(16, 64, fir.F32_MAX_COUT + 1) == -1
    assert fir.ir_f32_smem_bytes(0, 64, 32) == -1
    assert fir.ir_s2_smem_bytes(16, 64, fir.S2_MAX_COUT + 1) == -1
    assert fir.ir_s2_smem_bytes(512, 64, 32, F32) > fir.SMEM_LIMIT


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("h,w", [(64, 64), (18, 34), (2, 2), (10, 6), (30, 14)])
def test_tile_plan_covers_every_output_once_and_expands_as_planned(stride, h, w):
    """Ragged H and W: each output pixel in one tile; each input pixel
    expanded by every tile whose halo holds it, once inside a tile and
    twice (four times at a corner) on the seams the halos share: 2 rows
    (columns) of overlap at stride 1, 1 at stride 2."""
    for tile in fir.IR_TC_TILES[stride]:
        th, tw = tile
        hh, hw = fir._halo(stride, th), fir._halo(stride, tw)
        out = torch.zeros((h // stride, w // stride), dtype=torch.int32)
        exp = torch.zeros((h + 2, w + 2), dtype=torch.int32)   # a ring of one pixel
        plan = fir.ir_tc_plan(h, w, stride, tile)
        for (oy, ox), (iy, ix) in plan:
            out[oy:oy + th, ox:ox + tw] += 1
            exp[iy + 1:iy + 1 + hh, ix + 1:ix + 1 + hw] += 1
        assert bool((out == 1).all()), (tile, h, w)
        inner = exp[1:h + 1, 1:w + 1]
        ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")

        def seams(pos, t, n):
            # tiles of t outputs whose halos hold input index pos, per dimension
            first = [stride * t * i - 1 for i in range(-(-(n // stride) // t))]
            span = (t - 1) * stride + 3
            return sum(((pos >= f) & (pos < f + span)).int() for f in first)

        assert torch.equal(inner, seams(ys, th, h) * seams(xs, tw, w)), (tile, h, w)
        assert int(inner.max()) <= 4 and int(inner.min()) >= 1
        if h % (stride * th) == 0 and w % (stride * tw) == 0:
            assert len(plan) * hh * hw == int(exp.sum())


def tc_schedule(x, ops, stride, tile, use_residual=False):
    """csrc/ir_hopper.cuh's walk in plain torch, from the operands' planes:
    for each tile of ``ir_tc_plan``, its halo of x (zero outside the image),
    then each chunk of expanded channels: the expand from Wexp^T's planes
    (at f32: x's tf32 parts, lo.hi + hi.lo + hi.hi), SiLU(+ bexp) and zeros
    outside the image, the depthwise in the TPU body's order for the stride,
    SiLU(+ bdw), the reduce out^T += Wred^T . y^T (at f32 from y's tf32
    parts), each chunk's sum added to the tile's; + bred (+ x)."""
    f32 = ops.dtype == F32
    b, h, w, c = x.shape
    th, tw = tile
    hh, hw = fir._halo(stride, th), fir._halo(stride, tw)
    wx, wr = _planes(ops)
    kp, nc, kw = wx.shape[2], wr.shape[1], (32 if f32 else 64)
    nch = wx.shape[1] // kw
    k = ops.kdw.reshape(3, 3, -1)
    xp = torch.zeros((b, h + 2 * hh, w + 2 * hw, kp), dtype=x.dtype)
    xp[:, hh:hh + h, hw:hw + w, :c] = x
    inside = torch.zeros((h + 2 * hh, w + 2 * hw), dtype=torch.bool)
    inside[hh:hh + h, hw:hw + w] = True
    ho, wo = h // stride, w // stride
    out = torch.zeros((b, ho, wo, ops.cout))

    def prod(a_parts, b_parts):   # (M, K) . (N, K)^T at f32: lo.hi + hi.lo + hi.hi
        if not f32:
            return a_parts[0].float() @ b_parts[0].float().t()
        return (a_parts[1] @ b_parts[0].t() + a_parts[0] @ b_parts[1].t()
                + a_parts[0] @ b_parts[0].t())

    for img in range(b):
        for (oy, ox), (iy, ix) in fir.ir_tc_plan(h, w, stride, tile):
            rows = xp[img, hh + iy:hh + iy + hh, hw + ix:hw + ix + hw].reshape(-1, kp)
            mask = inside[hh + iy:hh + iy + hh, hw + ix:hw + ix + hw].reshape(-1, 1)
            xparts = tf32_split(rows) if f32 else (rows,)
            acc = torch.zeros((nc, th * tw))
            for j in range(nch):
                cols = slice(j * kw, (j + 1) * kw)
                ex = prod(xparts, [p[cols] for p in wx])
                xe = torch.where(mask, silu(ex + ops.bexp[cols]), torch.zeros(()))
                xe = xe.to(ops.dtype).float().reshape(hh, hw, kw)
                kk = k[:, :, cols]
                if stride == 1:
                    s = torch.zeros((th, tw, kw))
                    for dj in range(3):
                        col = torch.zeros((th, tw, kw))
                        for di in range(3):
                            col = col + xe[di:di + th, dj:dj + tw] * kk[di, dj]
                        s = s + col
                else:
                    s = torch.zeros((th, tw, kw))
                    for di in range(3):
                        for dj in range(3):
                            s = s + xe[di:di + 2 * th - 1:2, dj:dj + 2 * tw - 1:2] * kk[di, dj]
                y = silu(s + ops.bdw[cols]).to(ops.dtype).reshape(th * tw, kw)
                yparts = tf32_split(y) if f32 else (y,)
                acc = acc + prod([p[:, cols] for p in wr], yparts)
            tile_out = acc.t()[:, :ops.cout] + ops.bred[:ops.cout]
            tile_out = tile_out.reshape(th, tw, ops.cout)
            hi_, wi_ = min(th, ho - oy), min(tw, wo - ox)
            t = tile_out[:hi_, :wi_]
            if use_residual:
                t = t + x[img, oy:oy + hi_, ox:ox + wi_].float()
            out[img, oy:oy + hi_, ox:ox + wi_] = t
    return out.to(ops.dtype)


@pytest.mark.parametrize("stride,cd,b,h,w,c,e,cout,resid", [
    (1, F32, 2, 9, 17, 24, 40, 24, True), (1, F32, 1, 7, 13, 12, 48, 100, False),
    (1, F32, 1, 16, 16, 64, 96, 64, True), (2, F32, 1, 10, 18, 12, 72, 40, False),
    (2, F32, 2, 6, 34, 8, 100, 130, False), (2, BF, 1, 10, 18, 12, 72, 40, False),
    (2, BF, 1, 18, 20, 24, 136, 200, False)])
def test_tile_schedule_matches_the_plain_version(two_threads, stride, cd, b, h, w, c, e, cout,
                                                 resid):
    """The walk on every tile the stride has, from the operands' planes: at
    f32 within IR_F32_REL (1e-5) of the plain version's largest value, at
    bf16 within chip_smoke.py's limits for kernel 8 (2^-6 of the largest,
    the mean within 0.01 of the plain version's own distance between
    rounding to bf16 and not)."""
    rng = np.random.default_rng(b * h * w + c + e)
    args = _weights(rng, c, e, cout)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(cd)
    ops = (fir.ir_f32_operands(*args) if stride == 1
           else fir.ir_s2_operands(*args, compute_dtype=cd))
    pargs = (args[0].to(cd), *args[1:4], args[4].to(cd), args[5])
    want = fir.fused_ir_plain(x, *pargs, stride=stride, use_residual=resid).float()
    scale = float(want.abs().max())
    for tile in fir.IR_TC_TILES[stride]:
        got = tc_schedule(x, ops, stride, tile, resid).float()
        err = (got - want).abs()
        if cd == F32:
            assert float(err.max()) <= 1e-5 * scale, tile
        else:
            gap = float((fir.fused_ir_plain(x.float(), *args, stride=stride) - want).abs().mean())
            assert float(err.max()) <= 2 ** -6 * scale and float(err.mean()) <= 0.01 * gap, tile


# ---- csrc/inverted_residual_wide.cu: bf16 stride 1 past the strip kernel ------------------

# ir_wide_plan: (C, Cout) -> (tile, ncp, wsl): the widest tile whose shared
# memory fits; Cout past two m64 tiles on 8 x 16 or four elsewhere in passes,
# the tile whose passes expand the fewest halo pixels an output; C's halo on
# narrower tiles as it grows; past 768 the 4 x 8 tile with Wexp^T's chunks in
# pieces of wsl slabs of 64 input channels, none past 1536
WIDE_PLANS = [((64, 64), ((8, 16), 64, 1)), ((96, 96), ((8, 16), 128, 2)),
              ((20, 24), ((8, 16), 64, 1)), ((72, 72), ((8, 16), 128, 2)),
              ((64, 264), ((8, 8), 192, 1)), ((64, 128), ((8, 16), 128, 1)),
              ((64, 256), ((8, 8), 256, 1)), ((320, 64), ((8, 16), 64, 5)),
              ((328, 64), ((8, 8), 64, 6)), ((584, 64), ((4, 8), 64, 10)),
              ((700, 64), ((4, 8), 64, 11)), ((768, 64), ((4, 8), 64, 12)),
              ((776, 64), ((4, 8), 64, 12)), ((840, 840), ((4, 8), 64, 11)),
              ((1100, 72), ((4, 8), 64, 7)), ((1536, 64), ((4, 8), 64, 1)),
              ((1544, 64), None)]


@pytest.mark.parametrize("widths,plan", WIDE_PLANS)
def test_wide_plan_picks_the_tile_and_the_passes(widths, plan):
    c, cout = widths
    assert fir.ir_wide_plan(c, cout) == plan
    if plan is None:
        assert fir.ir_wide_smem_bytes((4, 8), c, 64, 1) > fir.SMEM_LIMIT
        return
    tile, ncp, wsl = plan
    slabs = -(-c // 64)
    need = fir.ir_wide_smem_bytes(tile, c, ncp, wsl)
    assert need == fir._tc_smem(False, 1, tile, -(-c // 8) * 8, ncp, wsl) <= fir.SMEM_LIMIT
    assert ncp // 64 <= fir.WIDE_MAX_NCT[tile]
    if wsl < slabs:
        # pieces only where no tile takes a chunk whole, on 4 x 8, the most
        # slabs that fit
        assert tile == fir.WIDE_PIECES_TILE and ncp == 64
        assert all(fir.ir_wide_smem_bytes(t, c, 64) > fir.SMEM_LIMIT for t in fir.WIDE_MAX_NCT)
        assert fir.ir_wide_smem_bytes(tile, c, 64, wsl + 1) > fir.SMEM_LIMIT
        return
    assert wsl == slabs
    # one pass more than the plan's on the same tile would expand more, and a
    # wider pass does not fit the tile's registers or its shared memory
    wider = ncp + 64
    assert (wider // 64 > fir.WIDE_MAX_NCT[tile] or -(-cout // wider) == -(-cout // ncp)
            or fir.ir_wide_smem_bytes(tile, c, wider) > fir.SMEM_LIMIT)


def test_wide_plan_takes_every_c_to_1536():
    """Every C up to 1536 gets a plan (E does not enter: chunks of 64), at any
    Cout; past it the operands raise with the reason before any launch."""
    for c in range(1, 1537, 7):
        for cout in (8, 100, 300):
            assert fir.ir_wide_plan(c, cout) is not None, (c, cout)
    with pytest.raises(ValueError, match="narrowest tile"):
        fir.ir_wide_operands(*_weights(np.random.default_rng(0), 1544, 64, 16))


def _earlier_tile_kernel_smem(c: int, e: int) -> int:
    """Shared memory of the 8 x 8 mma.sync tile kernel that ran these widths
    before the Hopper design: x's 10 x 10 halo in 112 rows of C, the 100
    expanded rows of E, the 64 depthwise rows of E (bf16; K padded to 16,
    rows padded so that fragment reads fall in distinct banks)."""
    def ld_bank(n):
        w = ((n + 1) // 2 + 3) & ~3
        return 2 * (w + 4 if (w // 4) % 2 == 0 else w)

    cp, ep = -(-c // 16) * 16, -(-e // 16) * 16
    return 2 * (112 * ld_bank(cp) + 100 * (ep + 8) + 64 * ld_bank(ep))


def test_wide_plan_takes_every_width_the_earlier_tile_kernel_took():
    """Every (C, E) whose shared memory the earlier tile kernel fitted in a
    block (C up to about 990 at a small E) has a plan here, at any Cout."""
    took = 0
    for c in range(8, 1100, 13):
        for e in (8, 24, 64, 160, 256, 384, 1024):
            if _earlier_tile_kernel_smem(c, e) <= fir.SMEM_LIMIT:
                took += 1
                for cout in (8, 100, 300):
                    assert fir.ir_wide_plan(c, cout) is not None, (c, e, cout)
    assert took > 100 and _earlier_tile_kernel_smem(970, 8) <= fir.SMEM_LIMIT


@pytest.mark.parametrize("c,e,cout", [(64, 384, 264), (20, 80, 24), (72, 288, 72)])
def test_wide_operands_cut_wred_into_passes(c, e, cout):
    """Wred^T's rows by passes of ncp output channels (passes outer, then
    chunks of 64 expanded channels), bred likewise; zeros past Cout."""
    wexp, bexp, kdw, bdw, wred, bred = args = _weights(np.random.default_rng(c + e), c, e, cout)
    ops = fir.ir_operands(*args)
    tile, ncp, wsl = fir.ir_wide_plan(c, cout)
    passes, ep = -(-cout // ncp), -(-e // 64) * 64
    assert isinstance(ops, fir.IRTCOperands) and (ops.tile, ops.ncp, ops.wsl) == (tile, ncp, wsl)
    assert ops.wred.shape == (passes * ep // 64, 1, ncp, 64)
    assert ops.bred.shape == (passes * ncp,) and torch.equal(ops.bred[:cout], bred)
    assert not ops.bred[cout:].any()
    wx, wr = _planes(ops)
    assert torch.equal(wr[0][:cout, :e], wred.t().to(BF)) and not wr[0][cout:].float().any()
    assert torch.equal(wx[0][:e, :c], wexp.t().to(BF)) and not wx[0][:, c:].float().any()
    # pass p's planes start at p x chunks rows of the array: the kernel's offset
    raw = swizzle_tiles(ops.wred)
    for p in range(passes):
        rows = slice(p * ncp, min(cout, (p + 1) * ncp))
        got = raw[p * ep // 64:(p + 1) * ep // 64, 0].permute(1, 0, 2).reshape(ncp, ep)
        assert torch.equal(got[:rows.stop - rows.start, :e], wred.t()[rows].to(BF))


def test_wide_route_pads_x_to_whole_16_byte_rows():
    """C not a multiple of 8 reaches the kernel with zero channels to the
    next multiple (TMA's 16-byte strides); a multiple of 8 goes as it is."""
    x = torch.randn((2, 3, 5, 20)).to(BF)
    xk = fir._tc_x(x, False)
    assert xk.shape == (2, 3, 5, 24) and torch.equal(xk[..., :20], x) and not xk[..., 20:].any()
    y = torch.randn((1, 2, 2, 72)).to(BF)
    assert fir._tc_x(y, False) is y


@pytest.mark.parametrize("b,h,w,c,e,cout,resid", [(1, 9, 17, 72, 288, 72, True),
                                                  (2, 7, 10, 20, 80, 24, False),
                                                  (1, 8, 12, 64, 384, 264, False)])
def test_wide_schedule_matches_the_plain_version(two_threads, b, h, w, c, e, cout, resid):
    """csrc/inverted_residual_wide.cu's walk (tc_schedule at bf16, stride 1,
    from the wide operands' planes, every pass's rows) on each stride-1 tile:
    within chip_smoke.py's limits for kernel 8 of the plain version."""
    rng = np.random.default_rng(b * h * w + c + e)
    args = _weights(rng, c, e, cout)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(BF)
    ops = fir.ir_wide_operands(*args)
    pargs = (args[0].to(BF), *args[1:4], args[4].to(BF), args[5])
    want = fir.fused_ir_plain(x, *pargs, use_residual=resid).float()
    scale = float(want.abs().max())
    gap = float((fir.fused_ir_plain(x.float(), *args, use_residual=resid) - want).abs().mean())
    for tile in fir.IR_TC_TILES[1]:
        err = (tc_schedule(x, ops, 1, tile, resid).float() - want).abs()
        assert float(err.max()) <= 2 ** -6 * scale and float(err.mean()) <= 0.01 * gap, tile
