"""Port: the strip kernel of the fused inverted residual
(``csrc/inverted_residual.cu``) as far as the CPU can check it: its plans
(``ir_plan``, ``ir_smem_bytes``), the layouts of its operands
(``ir_operands``), the operands a block keeps (``block_operands``), and a
plain-torch walk of its schedule (strips of S columns, bands of R rows, a
ring of R + 2 expanded rows with zeros after the SiLU outside the image, y's
rows in the kernel's order) that must give ``fused_ir_plain``'s bits.
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
from ggml_experiments_tpu_torch.ops.fused_transformer_layer import swizzle_tiles
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
    assert ops.strip and ops.wexp.shape == (1, ep, 64) and ops.wred.shape == (ep // 64, cn, 64)
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
    # the tile kernel's shapes keep its (N, K16) layouts
    tile = fir.ir_operands(*_weights(np.random.default_rng(1), 12, 48, 12))
    assert not tile.strip and tile.wexp.shape == (48, 16) and tile.kdw.shape == (9 * 48,)


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
