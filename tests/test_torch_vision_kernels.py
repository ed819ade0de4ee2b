"""Port: the plain versions of the three vision kernels against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs.

Tolerances are the JAX package's own for these kernels
(tests/test_flash_attention.py, tests/test_fused_transformer_layer.py,
tests/test_fused_inverted_residual.py). On the CPU the wrappers run the
plain versions and leave the launch counters alone.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_experiments_tpu.models.mobilevit import InvertedResidualParams as JIR
from ggml_experiments_tpu.models.mobilevit import TransformerLayerParams as JLayer
from ggml_experiments_tpu.ops.attention import AttentionParams as JAtt
from ggml_experiments_tpu.ops.conv import ConvBNAct as JConv
from ggml_experiments_tpu.ops.flash_attention import flash_mha as jflash
from ggml_experiments_tpu.ops.fused_inverted_residual import inverted_residual_fused as jir_fused
from ggml_experiments_tpu.ops.fused_transformer_layer import fused_transformer_layer as jlayer
from ggml_experiments_tpu.ops.norm import FoldedBN as JBN
from ggml_experiments_tpu_torch.models.mobilevit import (
    InvertedResidualParams,
    TransformerLayerParams,
)
from ggml_experiments_tpu_torch.ops import flash_attention as fa
from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir
from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl
from ggml_experiments_tpu_torch.ops.attention import AttentionParams
from ggml_experiments_tpu_torch.ops.conv import ConvBNAct
from ggml_experiments_tpu_torch.ops.activations import silu
from ggml_experiments_tpu_torch.ops.norm import FoldedBN, layer_norm


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(autouse=True)
def _no_launches():
    before = (dict(fa.LAUNCHES), dict(ftl.LAUNCHES), dict(fir.LAUNCHES))
    yield
    assert (fa.LAUNCHES, ftl.LAUNCHES, fir.LAUNCHES) == before


@pytest.mark.parametrize("b,l,c,h", [(2, 256, 144, 4), (4, 64, 192, 4), (8, 16, 240, 4),
                                     (3, 32, 64, 2), (1, 8, 16, 4)])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_flash_plain_matches_the_jax_kernel(b, l, c, h, cd):
    rng = np.random.default_rng(l + c)
    q, k, v = (rng.standard_normal((b, l, c)).astype(np.float32) for _ in range(3))
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h,
                             compute_dtype=jnp.dtype(cd), interpret=True).astype(jnp.float32))
    got = fa.flash_mha(T(q), T(k), T(v), h, compute_dtype=cd)
    assert got.dtype == getattr(torch, cd)
    tol = 2e-5 if cd == "float32" else 0.05
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def _layer_arrays(c, h, f, rng):
    def w(*s):
        return (rng.standard_normal(s) * 0.2).astype(np.float32)

    return dict(att=dict(wq=w(c, c), bq=w(c), wk=w(c, c), bk=w(c), wv=w(c, c), bv=w(c),
                         wo=w(c, c), bo=w(c)),
                ln_before_gamma=w(c) + 1.0, ln_before_beta=w(c), ln_after_gamma=w(c) + 1.0,
                ln_after_beta=w(c), intermediate_kernel=w(c, f), intermediate_bias=w(f),
                output_kernel=w(f, c), output_bias=w(c))


def _layers(arrs, h):
    rest = {k: v for k, v in arrs.items() if k != "att"}
    jl = JLayer(attention=JAtt(**{k: jnp.asarray(v) for k, v in arrs["att"].items()},
                               num_heads=h), **{k: jnp.asarray(v) for k, v in rest.items()})
    tl = TransformerLayerParams(
        attention=AttentionParams(**{k: T(v) for k, v in arrs["att"].items()}, num_heads=h),
        **{k: T(v) for k, v in rest.items()})
    return jl, tl


@pytest.mark.parametrize("in_proj", [False, True])
@pytest.mark.parametrize("final_ln", [False, True])
@pytest.mark.parametrize("out_proj", [None, "silu", "none"])
def test_fused_layer_plain_matches_the_jax_kernel_every_flag(in_proj, final_ln, out_proj):
    rng = np.random.default_rng(7)
    c, h, f, l, cin, cout = 48, 4, 96, 16, 24, 40
    jl, tl = _layers(_layer_arrays(c, h, f, rng), h)
    x = rng.standard_normal((3, l, cin if in_proj else c)).astype(np.float32)
    jkw, tkw = {}, {}
    if in_proj:
        win = (rng.standard_normal((cin, c)) * 0.2).astype(np.float32)
        jkw["input_proj"], tkw["input_proj"] = jnp.asarray(win), T(win)
    if final_ln:
        g3, b3 = rng.standard_normal(c).astype(np.float32) + 1, rng.standard_normal(c)
        jkw["final_ln"], tkw["final_ln"] = (jnp.asarray(g3), jnp.asarray(b3)), (T(g3), T(b3))
        jkw["final_ln_eps"] = tkw["final_ln_eps"] = 1e-6
    if out_proj:
        wo, sc, bi = ((rng.standard_normal((c, cout)) * 0.2).astype(np.float32),
                      rng.uniform(0.5, 1.5, cout).astype(np.float32),
                      rng.standard_normal(cout).astype(np.float32))
        jkw["output_proj"] = (jnp.asarray(wo), jnp.asarray(sc), jnp.asarray(bi), out_proj)
        tkw["output_proj"] = (T(wo), T(sc), T(bi), out_proj)
    want = np.asarray(jax.jit(lambda xb: jlayer(jl, xb, compute_dtype=jnp.bfloat16,
                                                interpret=True, **jkw))(
        jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = ftl.fused_transformer_layer(tl, T(x), compute_dtype=torch.bfloat16, **tkw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.08 * scale, rtol=0.08)


@pytest.mark.parametrize("b,l,c,h,f", [(1, 256, 144, 4, 288), (2, 64, 192, 4, 384),
                                       (4, 16, 240, 4, 480), (2, 16, 320, 5, 640)])
def test_fused_layer_plain_matches_the_jax_kernel_at_the_stage_widths(b, l, c, h, f):
    rng = np.random.default_rng(c)
    jl, tl = _layers(_layer_arrays(c, h, f, rng), h)
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    want = np.asarray(jax.jit(lambda xb: jlayer(jl, xb, compute_dtype=jnp.bfloat16,
                                                interpret=True))(
        jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = ftl.fused_transformer_layer(tl, T(x), compute_dtype=torch.bfloat16).float().numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=0.08 * scale, rtol=0.08)


def _layer_case(c, h, f, cin, cout, in_proj, final_ln, out_proj, seed):
    """LayerOperands at bf16 for the per-kernel plain versions, and x."""
    rng = np.random.default_rng(seed)
    _, tl = _layers(_layer_arrays(c, h, f, rng), h)
    kw = {}
    if in_proj:
        kw["input_proj"] = T((rng.standard_normal((cin, c)) * 0.2).astype(np.float32))
    if final_ln:
        kw["final_ln"] = (T(rng.standard_normal(c) + 1), T(rng.standard_normal(c)))
        kw["final_ln_eps"] = 1e-6
    if out_proj:
        kw["output_proj"] = (T((rng.standard_normal((c, cout)) * 0.2).astype(np.float32)),
                             T(rng.uniform(0.5, 1.5, cout)), T(rng.standard_normal(cout)),
                             out_proj)
    return ftl.layer_operands(tl, c, torch.bfloat16, **kw)


# every flag at L=24 (a ragged 64-row tile) and dh=12; the three stage widths
# (dh = 36, 48, 60) with their first and last layers' flags
LAYER_CASES = [(3, 24, 48, 4, 96, ip, fl, op) for ip in (False, True) for fl in (False, True)
               for op in (None, "silu", "none")] + [
    (1, 256, 144, 4, 288, True, False, None), (1, 256, 144, 4, 288, False, True, "silu"),
    (2, 64, 192, 4, 384, True, False, None), (2, 64, 192, 4, 384, False, True, "silu"),
    (4, 16, 240, 4, 480, True, False, None), (4, 16, 240, 4, 480, False, False, None)]


def _layer_input(bp, l, c, h, f, in_proj, final_ln, out_proj):
    cin = 2 * c // 3 if in_proj else c
    ops = _layer_case(c, h, f, cin, c // 2 + 8, in_proj, final_ln, out_proj, seed=l + c)
    x = torch.from_numpy(np.random.default_rng(c).standard_normal((bp * l, cin))
                         .astype(np.float32)).to(torch.bfloat16)
    return ops, x


@pytest.mark.parametrize("bp,l,c,h,f,in_proj,final_ln,out_proj", LAYER_CASES)
def test_the_three_plain_pieces_chain_to_the_layer_plain(bp, l, c, h, f, in_proj, final_ln,
                                                         out_proj):
    ops, x = _layer_input(bp, l, c, h, f, in_proj, final_ln, out_proj)
    qkv = ftl.ln_qkv_plain(x, ops)
    dhp = ftl.head_pad(c // h)
    assert qkv.dtype == torch.bfloat16 and qkv.shape == (bp * l, 3 * h * dhp)
    assert not qkv.reshape(bp * l, 3, h, dhp)[..., c // h:].any()
    ctx = ftl.attention_plain(qkv, l, ops)
    assert ctx.dtype == torch.bfloat16 and ctx.shape == (bp * l, c)
    got = ftl.proj_ffn_plain(x, ctx, ops)
    want = ftl.fused_transformer_layer_plain(x.reshape(bp, l, -1), ops)
    assert torch.equal(got.reshape(want.shape), want)


def _emulate_layer(x, ops, l):
    """The kernels' products in the order ``csrc/transformer_layer.cu`` takes
    the weight tiles from the two streams (each tile un-swizzled, f32 sums),
    for holding the streams' order and layout to the plain versions."""
    c, h, dh, dhp = ftl._dims(ops)
    prep = ftl._prepare(ops, torch.device("cpu"))
    nw = prep.nw

    def taker(stream):
        tiles = iter(stream)

        def product(a, rows, kw=16 * prep.ks):
            k = a.shape[1]
            ap = torch.zeros((a.shape[0], -(-k // kw) * kw))
            ap[:, :k] = a.float()
            out = 0.0
            for k0 in range(0, ap.shape[1], kw):
                tile = ftl.swizzle_tiles(next(tiles)[:rows * 64].reshape(1, rows, 64))[0]
                assert not tile[:, kw:].any()
                out = out + ap[:, k0:k0 + kw] @ tile[:, :kw].float().t()
            return out
        return product, tiles

    def ln(v, g, b, eps):
        return layer_norm(v, g, b, eps=eps)

    groups = range(0, c, nw)   # C's columns: one group, or wide several
    product, tiles = taker(prep.wa)
    xf = (torch.cat([product(x, nw) for _ in groups], 1)[:, :c] if ops.win is not None
          else x.float())
    a = ln(xf, *ops.ln1, ops.eps).to(torch.bfloat16)
    qkv = torch.cat([product(a, nw) for _ in range(0, 3 * h * dhp, nw)], 1)[:, :3 * h * dhp]
    qkv = qkv + prep.vectors["bqkv"].reshape(-1)
    qkv[:, :h * dhp] *= 1.0 / math.sqrt(dh)
    assert next(tiles, None) is None
    qkv = qkv.to(torch.bfloat16)
    ctx = ftl.attention_plain(qkv, l, ops)
    product, tiles = taker(prep.wc)
    # by groups: x's product (with the input projection), then ctx's
    parts = [((product(x, nw),) if ops.win is not None else ()) + (product(ctx, nw),)
             for _ in groups]
    xf = torch.cat([p[0] for p in parts], 1)[:, :c] if ops.win is not None else x.float()
    x1 = xf + torch.cat([p[-1] for p in parts], 1)[:, :c] + ops.bo
    y = ln(x1, *ops.ln2, ops.eps).to(torch.bfloat16)
    o = x1
    if prep.ngc > 1:   # wide: each group of output columns walks every chunk of F again
        pad = torch.zeros((x1.shape[0], prep.ngc * nw))
        pad[:, :c] = x1
        for n0 in groups:
            for f0 in range(0, prep.nf * 64, 64):
                h1 = silu(product(y, 64) + prep.vectors["bi"][f0:f0 + 64]).to(torch.bfloat16)
                pad[:, n0:n0 + nw] = pad[:, n0:n0 + nw] + product(h1, nw, 64)
        o = pad[:, :c]
    hs = []   # the pipelined stream takes chunk f + 1's Wi tiles before chunk f's Wo2 tile
    for f0 in range(0, prep.nf * 64 if prep.ngc == 1 else 0, 64):
        if not hs:
            hs.append(product(y, 64))
        if prep.pipe and f0 + 64 < prep.nf * 64:
            hs.append(product(y, 64))
        h1 = silu(hs.pop(0) + prep.vectors["bi"][f0:f0 + 64]).to(torch.bfloat16)
        o = o + product(h1, nw, 64)[:, :c]
    o = o + ops.bo2
    if ops.final_ln is not None:
        o = ln(o, *ops.final_ln, ops.final_eps)
    if ops.wout is not None:
        cout = ops.wout.shape[1]
        ob = o.to(torch.bfloat16)
        o = torch.cat([product(ob, nw) for _ in range(0, cout, nw)], 1)[:, :cout]
        o = o * ops.out_affine[0] + ops.out_affine[1]
        if ops.out_act:
            o = silu(o)
    assert next(tiles, None) is None
    return qkv, o.to(torch.bfloat16)


# past C = 288, the wide row tiles: every flag and none (C = 320, 384; packed
# and whole 64-row tiles)
WIDE_LAYER_CASES = [(2, 16, 320, 5, 640, True, True, "silu"),
                    (1, 48, 384, 6, 768, False, False, None),
                    (1, 64, 320, 5, 640, False, True, None)]


@pytest.mark.parametrize("bp,l,c,h,f,in_proj,final_ln,out_proj",
                         [LAYER_CASES[i] for i in (0, 5, 7, 11, 12, 13, 15, 16)]
                         + WIDE_LAYER_CASES)
def test_the_kernels_weight_streams_hold_each_product_in_order(bp, l, c, h, f, in_proj,
                                                               final_ln, out_proj):
    ops, x = _layer_input(bp, l, c, h, f, in_proj, final_ln, out_proj)
    qkv, out = _emulate_layer(x, ops, l)
    want_qkv = ftl.ln_qkv_plain(x, ops)
    want = ftl.proj_ffn_plain(x, ftl.attention_plain(want_qkv, l, ops), ops)
    for got, ref in ((qkv, want_qkv), (out, want)):
        d = (got.float() - ref.float()).abs()
        scale = float(ref.float().abs().max())
        assert float(d.max()) <= 0.05 * scale and float(d.mean()) <= 2e-3 * scale


def test_the_cuda_path_keeps_a_layers_operands_on_its_params():
    """The CUDA path gathers a layer's operands once and keeps them on the
    layer's params; the block's options come as fresh views every call, a
    different input projection gathers them anew, and the conv_projection's
    BN vectors are each call's own."""
    rng = np.random.default_rng(11)
    c, h, f, cin, cout = 48, 4, 96, 32, 24
    _, tl = _layers(_layer_arrays(c, h, f, rng), h)
    win, wout = T(rng.standard_normal((cin * c,)) * 0.2), T(rng.standard_normal((c * cout,)))
    fl = (T(rng.standard_normal(c) + 1.0), T(rng.standard_normal(c)))

    def ops_for(w, scale):
        return ftl._cached_operands(tl, c, torch.bfloat16, fl, 1e-6, w.reshape(cin, c),
                                    (wout.reshape(c, cout), scale, torch.zeros(cout), "silu"))

    first = ops_for(win, torch.ones(cout))
    again = ops_for(win, torch.full((cout,), 2.0))
    assert again.wq is first.wq and again.cache is first.cache
    assert torch.equal(again.out_affine[0], torch.full((cout,), 2.0))
    assert torch.equal(first.out_affine[0], torch.ones(cout))
    other = ops_for(win.clone(), torch.ones(cout))
    assert other.wq is not first.wq and torch.equal(other.win, win.reshape(cin, c).bfloat16())


@pytest.mark.parametrize("c,cin,in_proj,nw", [(320, 160, True, 192), (384, 192, True, 192),
                                              (640, 320, True, 240), (640, 640, True, 192),
                                              (320, 320, False, 192), (640, 640, False, 240)])
def test_row_tiles_take_c_past_288_in_groups(c, cin, in_proj, nw):
    """C past 288 (x1 past registers) gets a wide layout: the fewest groups
    of 4-6 chunks of 48 columns whose kernels fit a block at one consumer
    warpgroup (C = 640 beside an x tile of 640 takes four groups of 192),
    covering C's K chunks, the FFN not overlapped."""
    layout = ftl.row_tile_layout(c, cin, in_proj)
    assert layout is not None
    got, ks, pipe = layout
    assert (got, pipe) == (nw, False) and ks == ftl.k_steps(c, cin, in_proj)
    ngc = -(-c // nw)
    assert ngc >= 2 and ngc * nw >= -(-c // (16 * ks)) * 16 * ks
    assert ftl.row_tile_fits(nw, ks, c, cin, in_proj, 1, False)
    # one group of C rounded up to 48 would hold x1 past kMaxNch chunks
    assert -(-c // 48) > 6


def test_row_tiles_keep_the_model_widths_layouts():
    """MobileViT-small's layers keep one group (nw = C rounded up to 48),
    their K steps and their FFN order, and fit two consumer warpgroups: no
    layer of the model changes route; a C past what one block holds gets
    none."""
    for c, cin in ((144, 96), (192, 128), (240, 160)):
        for in_proj, width in ((True, cin), (False, c)):
            layout = ftl.row_tile_layout(c, width, in_proj)
            assert layout == (-(-c // 48) * 48, ftl.k_steps(c, width, in_proj),
                              ftl.ffn_pipelined(c))
            assert ftl.row_tile_fits(*layout[:2], c, width, in_proj, 2, layout[2])
    assert ftl.row_tile_layout(1344, 1344, False) is None
    assert ftl.row_tile_layout(288, 1000, True) is None


def test_wide_row_tiles_deal_their_groups_over_idle_multiprocessors():
    """Past C = 288 a row tile's groups of output columns go to as many
    blocks as the groups allow and the multiprocessors its row tiles leave
    idle hold in one wave (each block its own scratch copy); one group of C
    keeps one block a tile."""
    assert ftl.row_tile_split(2048, 1, 5, 2, 132) == 4        # 32 row tiles: 128 blocks, not 160
    assert ftl.row_tile_split(768, 1, 6, 2, 132) == 6         # 12 row tiles, 6 qkv groups
    assert ftl.row_tile_split(2048, 1, 2, 2, 132) == 2        # the FFN's 2 groups
    assert ftl.row_tile_split(8192, 1, 5, 2, 132) == 1        # 128 row tiles: one wave already
    assert ftl.row_tile_split(4000, 1, 5, 2, 132) == 2        # 63 row tiles
    assert ftl.row_tile_split(1 << 20, 2, 5, 2, 132) == 1     # the card already full
    assert ftl.row_tile_split(2048, 1, 3, 1, 132) == 1        # C = 240: the model's widths


def test_k_steps_pad_the_model_widths_least():
    assert [ftl.k_steps(c, cin, True) for c, cin in ((144, 96), (192, 128), (240, 160))] == [
        3, 4, 3]
    assert [ftl.k_steps(c, c, False) for c in (144, 192, 240, 64, 24)] == [3, 4, 3, 4, 3]


def test_row_tiles_take_one_warpgroup_where_two_would_idle_multiprocessors():
    assert [ftl.row_tile_warpgroups(512 * l, 132) for l in (256, 64, 16)] == [2, 2, 1]
    assert ftl.row_tile_warpgroups(128 * 132, 132) == 2
    assert ftl.row_tile_warpgroups(128 * 131, 132) == 1


def test_swizzle_tiles_places_each_group_as_tma_does():
    w = torch.arange(24 * 64, dtype=torch.float32).reshape(24, 64).to(torch.bfloat16)
    sw = ftl.swizzle_tiles(w)
    for n, k in ((0, 0), (5, 19), (13, 63), (23, 40)):
        assert sw[n, ((k // 8) ^ (n % 8)) * 8 + k % 8] == w[n, k]
    assert torch.equal(ftl.swizzle_tiles(sw), w)


def test_fused_layer_refuses_heads_that_do_not_divide():
    rng = np.random.default_rng(5)
    _, tl = _layers(_layer_arrays(50, 4, 100, rng), 4)
    with pytest.raises(ValueError):
        ftl.fused_transformer_layer(tl, torch.zeros((2, 8, 50)))


def _ir_blocks(rng, c, e, cout, stride, resid):
    def conv(kh, kw, cin, co, dw=False, act="silu", s=1):
        k = (rng.standard_normal((kh, kw, cin, co)) * 0.2).astype(np.float32)
        sc = rng.uniform(0.5, 1.5, co).astype(np.float32)
        bi = (rng.standard_normal(co) * 0.1).astype(np.float32)
        kw_ = dict(activation=act, stride=s, depthwise=dw)
        return (JConv(kernel=jnp.asarray(k), bn=JBN(jnp.asarray(sc), jnp.asarray(bi)), **kw_),
                ConvBNAct(kernel=T(k), bn=FoldedBN(T(sc), T(bi)), **kw_))

    ex, dw, red = conv(1, 1, c, e), conv(3, 3, 1, e, dw=True, s=stride), \
        conv(1, 1, e, cout, act="none")
    jb = JIR(expand_1x1=ex[0], conv_3x3=dw[0], reduce_1x1=red[0], use_residual=resid)
    tb = InvertedResidualParams(expand_1x1=ex[1], conv_3x3=dw[1], reduce_1x1=red[1],
                                use_residual=resid)
    return jb, tb


# MobileViT-small's four downsampling blocks (layer_2[0], layers 3-5), at
# stride 2 with small planes: the widths csrc/inverted_residual_s2.cu runs
S2_DOWNSAMPLERS = [(2, False, 32, 128, 64, 16), (2, False, 64, 256, 96, 8),
                   (2, False, 96, 384, 128, 8), (2, False, 128, 512, 160, 8)]


# stride 1 past the strip kernel (csrc/inverted_residual_wide.cu): C past 64
# and E past 256, C and Cout not multiples of 8, Cout past 256 (two passes)
IR_WIDE = [(1, True, 72, 288, 72, 8), (1, False, 20, 80, 24, 8), (1, False, 64, 384, 264, 8)]


@pytest.mark.parametrize("stride,resid,c,e,cout,hw", [
    (1, True, 8, 32, 8, 8), (1, False, 8, 32, 16, 8), (2, False, 8, 32, 16, 8),
    (1, True, 16, 64, 16, 12), *S2_DOWNSAMPLERS, *IR_WIDE])
def test_fused_inverted_residual_plain_matches_the_jax_kernel(stride, resid, c, e, cout, hw):
    rng = np.random.default_rng(e + hw)
    jb, tb = _ir_blocks(rng, c, e, cout, stride, resid)
    x = rng.standard_normal((2, hw, hw, c)).astype(np.float32)
    want = np.asarray(jax.jit(lambda xx: jir_fused(jb, xx, compute_dtype=jnp.bfloat16))(
        jnp.asarray(x)), np.float32)
    got = fir.inverted_residual_fused(tb, T(x), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel < 0.03, rel
    # the folded weights are the JAX package's
    from ggml_experiments_tpu.ops.fused_inverted_residual import folded_conv_weights as jfold

    for jc, tc in ((jb.expand_1x1, tb.expand_1x1), (jb.conv_3x3, tb.conv_3x3)):
        for a, b in zip(jfold(jc), fir.folded_conv_weights(tc)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


def test_fused_ir_gate_follows_the_jax_dispatch():
    """fused=True sends a bf16 stride-1 block with E >= 128 to the kernel's
    plain version; f32 and narrower blocks take the unfused chain."""
    rng = np.random.default_rng(3)
    _, wide = _ir_blocks(rng, 32, 128, 32, 1, True)
    _, narrow = _ir_blocks(rng, 8, 32, 8, 1, True)
    calls = []
    real = fir.fused_ir_plain
    fir.fused_ir_plain = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        x = T(rng.standard_normal((1, 8, 8, 32)))
        dataclasses.replace(wide, fused=True)(x, compute_dtype=torch.bfloat16)
        dataclasses.replace(wide, fused=True)(x, compute_dtype=torch.float32)
        dataclasses.replace(narrow, fused=True)(x[..., :8], compute_dtype=torch.bfloat16)
    finally:
        fir.fused_ir_plain = real
    assert len(calls) == 1


@pytest.mark.parametrize("stride,resid,c,e,cout,hw", [
    (1, True, 8, 32, 8, 8), (1, False, 16, 64, 32, 10), (2, False, 8, 32, 16, 8),
    (2, False, 16, 48, 24, 12), *S2_DOWNSAMPLERS])
def test_fused_inverted_residual_plain_matches_the_jax_kernel_at_f32(stride, resid, c, e, cout,
                                                                      hw):
    """The f32 form (no rounding below f32 anywhere): the port's plain
    version, which the f32 CUDA kernel is held to on the card, against the
    JAX kernel at compute_dtype=float32 in interpret mode, within 1e-5 of
    the largest output (the residual at stride 1 only: a stride-2 block
    changes the spatial shape, and neither package takes the two together)."""
    from ggml_experiments_tpu.ops.fused_inverted_residual import (
        fused_inverted_residual as jfir,
    )

    rng = np.random.default_rng(e + hw + stride)
    wexp, bexp, kdw, bdw, wred, bred = (
        (rng.standard_normal(s) * 0.2).astype(np.float32)
        for s in ((c, e), (e,), (3, 3, e), (e,), (e, cout), (cout,)))
    x = rng.standard_normal((2, hw, hw, c)).astype(np.float32)
    args = (wexp, bexp, kdw, bdw, wred, bred)
    want = np.asarray(jfir(jnp.asarray(x), *map(jnp.asarray, args), stride=stride,
                           use_residual=resid, compute_dtype=jnp.float32, interpret=True))
    got = fir.fused_inverted_residual(T(x), *map(T, args), stride=stride, use_residual=resid,
                                      compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_stride_2_route_is_the_cards_only():
    """A stride-2 block with E >= 64 takes the fused route on a CUDA device at
    bf16 and f32 with even H and W; on the CPU (the JAX model's route) and
    with odd H or W it keeps the unfused chain, and a residual is never
    fused at stride 2."""
    rng = np.random.default_rng(11)
    _, blk = _ir_blocks(rng, 32, 128, 64, 2, False)
    blk = dataclasses.replace(blk, fused=True)
    cuda = torch.device("cuda")
    for cd in (torch.bfloat16, torch.float32):
        assert blk.fused_route(cd, cuda, (16, 16)) and blk.fused_route(cd, "cuda")
        assert not blk.fused_route(cd, "cpu", (16, 16)) and not blk.fused_route(cd)
        assert not blk.fused_route(cd, cuda, (15, 16)) and not blk.fused_route(cd, cuda, (16, 9))
    assert not dataclasses.replace(blk, use_residual=True).fused_route(torch.bfloat16, cuda)
    assert not dataclasses.replace(blk, fused=False).fused_route(torch.bfloat16, cuda)
    _, narrow = _ir_blocks(rng, 8, 32, 16, 2, False)
    assert not dataclasses.replace(narrow, fused=True).fused_route(torch.bfloat16, cuda)
    calls = []
    real = fir.fused_ir_plain
    fir.fused_ir_plain = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        y = blk(T(rng.standard_normal((2, 16, 16, 32))), compute_dtype=torch.bfloat16)
    finally:
        fir.fused_ir_plain = real
    assert not calls and y.shape == (2, 8, 8, 64)


# (stride, compute dtype, Cout, the widest C its tile kernel takes): past it
# neither the f32 stride-1 nor the stride-2 kernel fits x's halo and a chunk
# of Wexp^T in a block's shared memory
IR_TC_WIDEST = [(1, torch.float32, 128, 224), (2, torch.float32, 64, 192),
                (2, torch.float32, 256, 128), (2, torch.bfloat16, 256, 576)]


@pytest.mark.parametrize("stride,cd,cout,widest", IR_TC_WIDEST)
def test_route_turns_away_widths_no_tile_fits(stride, cd, cout, widest):
    """On a CUDA device a block runs the f32 stride-1 or the stride-2 kernel
    at the widest C (in steps of 32) whose tile fits a block; one 32
    channels wider keeps the unfused chain, decided before any launch (the
    wrapper would refuse it for its shared memory)."""
    rng = np.random.default_rng(13)
    cuda = torch.device("cuda")
    for c, fused in ((widest, True), (widest + 32, False)):
        _, blk = _ir_blocks(rng, c, 64, cout, stride, False)
        blk = dataclasses.replace(blk, fused=True)
        assert blk.fused_route(cd, cuda, (16, 16)) == fused, c
        assert fir.ir_tc_takes(stride, c, 64, cout, cd) == fused
        f32 = cd == torch.float32
        need = (fir.ir_f32_smem_bytes(c, 64, cout) if stride == 1
                else fir.ir_s2_smem_bytes(c, 64, cout, cd))
        assert (need <= fir.SMEM_LIMIT) == fused
        assert need == fir._tc_smem(f32, stride, fir.ir_tc_tile(f32, stride, c, cout), c, cout)
    assert not fir.ir_tc_takes(1, 16, 64, fir.F32_MAX_COUT + 1, torch.float32)
    assert not fir.ir_tc_takes(2, 16, 64, fir.S2_MAX_COUT + 1, cd)


# the bf16 routes past their kernels' plans: each asks the plan from the
# shape before any launch, and where none fits takes the unfused chain on a
# CUDA device; the CPU keeps the JAX model's route (the plain versions take
# any shape)


@pytest.mark.parametrize("c,e,fused", [(1536, 64, True), (1600, 64, False), (64, 256, True),
                                       (64, 255, True), (1600, 255, False)])
def test_bf16_block_route_asks_the_strip_and_wide_plans(c, e, fused):
    """A bf16 stride-1 block runs fused on a CUDA device where the strip
    kernel has a plan or the wide kernel a tile (C up to 1536; an odd E, which
    the strip kernel does not take, rides the wide kernel's E padded to 64),
    else the unfused chain."""
    rng = np.random.default_rng(14)
    _, blk = _ir_blocks(rng, c, e, 64, 1, False)
    blk = dataclasses.replace(blk, fused=True)
    assert blk.fused_route(torch.bfloat16, torch.device("cuda"), (16, 16)) == fused
    assert fir.ir_bf16_takes(c, e, 64) == fused
    assert fused == (bool(fir.ir_plans(c, e, 64)) or fir.ir_wide_plan(c, 64) is not None)
    assert blk.fused_route(torch.bfloat16, torch.device("cpu"), (16, 16))
    if not fused:
        with pytest.raises(ValueError, match="shared memory"):
            fir.ir_wide_operands(*fir._folded(blk))


@pytest.mark.parametrize("c,h,cin,fused", [(144, 4, None, True), (160, 2, None, False),
                                           (1152, 18, None, True), (1280, 20, None, False),
                                           (288, 6, 288, True), (288, 6, 600, False)])
def test_bf16_layer_route_asks_the_row_tiles_and_head_rules(c, h, cin, fused):
    """A bf16 layer runs fused on a CUDA device where its heads are of an
    even width up to 64 and a row-tile layout fits a block (C up to ~1248;
    an input projection's Cin beside C), else the unfused chain."""
    rng = np.random.default_rng(15)
    _, layer = _layers(_layer_arrays(c, h, 2 * c, rng), h)
    layer = dataclasses.replace(layer, fused=True)
    assert layer.fused_route(torch.bfloat16, torch.device("cuda"), 16, cin) == fused
    assert ftl.bf16_layer_takes(c if cin is None else cin, c, h, in_proj=cin is not None) == fused
    assert layer.fused_route(torch.bfloat16, torch.device("cpu"), 16, cin)


def test_flash_route_asks_the_kernels_shared_memory():
    """Flash attention on a CUDA device takes heads up to 64 wide (its
    shared memory reckoning is -1 past them); the CPU's plain version takes
    heads of 80 too, and agrees with the unfused chain there."""
    from ggml_experiments_tpu_torch.ops.attention import flash_route, multi_head_attention

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert flash_route(64, 144, 4, cuda) and fa.flash_takes(64, 144, 4)
    assert not flash_route(64, 160, 2, cuda) and fa.flash_smem_bytes(64, 160, 2) == -1
    assert flash_route(64, 160, 2, cpu)
    rng = np.random.default_rng(16)
    _, layer = _layers(_layer_arrays(160, 2, 320, rng), 2)
    x = T(rng.standard_normal((2, 16, 160)))
    att = layer.attention
    got = multi_head_attention(dataclasses.replace(att, flash=True), x)
    want = multi_head_attention(att, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


def _s2_args(rng, c, e, cout):
    return tuple(T(rng.standard_normal(s) * 0.2)
                 for s in ((c, e), (e,), (3, 3, e), (e,), (e, cout), (cout,)))


@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_stride_2_wrapper_refuses_what_its_kernel_does_not_take(cd):
    """fused_ir_s2_cuda checks shapes before the device, so its refusals read
    the same here: odd H or W, a residual, widths that do not meet x, another
    dtype, and (being a kernel) a CPU tensor; Cout past S2_MAX_COUT and
    compute dtypes other than bf16 and f32 are refused when the operands are made,
    and a residual at stride 2 by fused_inverted_residual on any device."""
    rng = np.random.default_rng(12)
    args = _s2_args(rng, 16, 64, 32)
    ops = fir.ir_s2_operands(*args, compute_dtype=cd)
    assert ops.wexp.dtype == cd and ops.wred.dtype == cd and ops.bred.numel() == 64
    x = torch.zeros((2, 8, 8, 16), dtype=cd)
    for bad, match in ((torch.zeros((2, 7, 8, 16), dtype=cd), "even H and W"),
                       (torch.zeros((2, 8, 9, 16), dtype=cd), "even H and W"),
                       (torch.zeros((2, 8, 8, 24), dtype=cd), "do not meet"),
                       (x.to(torch.float16), "must be a"), (x[0], "must be a"),
                       (x, "CUDA tensor")):
        with pytest.raises(ValueError, match=match):
            fir.fused_ir_s2_cuda(bad, ops)
    with pytest.raises(ValueError, match="no residual"):
        fir.fused_ir_s2_cuda(x, ops, use_residual=True)
    with pytest.raises(ValueError, match="Cout up to 256"):
        fir.ir_s2_operands(*_s2_args(rng, 16, 64, fir.S2_MAX_COUT + 8), compute_dtype=cd)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fir.ir_s2_operands(*args, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="no residual"):
        fir.fused_inverted_residual(x, *args, stride=2, use_residual=True, compute_dtype=cd)
    # the kernel's reckoning of shared memory: the widest f32 halo past one
    # block's 227 KB is refused on the card (C = 512), the downsamplers fit
    assert fir.ir_s2_smem_bytes(512, 64, 32, torch.float32) > fir.SMEM_LIMIT
    assert fir.ir_s2_smem_bytes(16, 64, fir.S2_MAX_COUT + 1) == -1
    for _, _, c, e, cout, _ in S2_DOWNSAMPLERS:
        for dt in (torch.bfloat16, torch.float32):
            assert 0 < fir.ir_s2_smem_bytes(c, e, cout, dt) <= fir.SMEM_LIMIT


def test_stride_2_operands_hold_the_weights_in_the_kernels_layout():
    """ir_s2_operands: per chunk of expanded channels (32 at f32, 64 at
    bf16), Wexp^T's rows (K = C in 128-byte slabs) and Wred^T's rows (Cout
    rounded up to 64), each 128-byte row in the 128-byte swizzle; at f32 the
    tf32 hi and lo planes, at bf16 one plane; E padded with zeros, the
    vectors f32."""
    rng = np.random.default_rng(13)
    wexp, bexp, kdw, bdw, wred, bred = args = _s2_args(rng, 24, 100, 40)
    o32 = fir.ir_s2_operands(*args, compute_dtype=torch.float32)
    assert o32.wexp.shape == (4, 2, 1, 32, 32) and o32.wred.shape == (4, 2, 64, 32)
    wx = ftl.swizzle_tiles(o32.wexp)     # the swizzle is its own inverse
    wr = ftl.swizzle_tiles(o32.wred)
    # chunk j, part p, row n: Wexp^T's row 32 j + n; Wred^T's row n at K 32 j ..
    we = (wx[:, 0] + wx[:, 1]).reshape(128, 32)
    wrr = (wr[:, 0] + wr[:, 1]).permute(1, 0, 2).reshape(64, 128)
    assert float((we[:100, :24] - wexp.t()).abs().max()) <= 2 ** -21 * float(wexp.abs().max())
    assert float((wrr[:40, :100] - wred.t()).abs().max()) <= 2 ** -21 * float(wred.abs().max())
    assert not we[100:].any() and not we[:, 24:].any() and not wrr[40:].any()
    assert not wrr[:, 100:].any()
    assert torch.equal(o32.kdw.reshape(9, 128)[:, :100], kdw.reshape(9, 100))
    o16 = fir.ir_s2_operands(*args, compute_dtype=torch.bfloat16)
    assert o16.wexp.shape == (2, 1, 1, 64, 64) and o16.wred.shape == (2, 1, 64, 64)
    we16 = ftl.swizzle_tiles(o16.wexp).reshape(128, 64)
    wr16 = ftl.swizzle_tiles(o16.wred)[:, 0].permute(1, 0, 2).reshape(64, 128)
    assert torch.equal(we16[:100, :24], wexp.t().to(torch.bfloat16))
    assert torch.equal(wr16[:40, :100], wred.t().to(torch.bfloat16))
    assert not we16[:, 24:].float().any() and not wr16[40:].float().any()
    assert all(v.dtype == torch.float32 for v in (o16.bexp, o16.kdw, o16.bdw, o16.bred))
    bred16, bexp16, bdw16 = (v.reshape(-1) for v in (o16.bred, o16.bexp, o16.bdw))
    assert torch.equal(bred16[:40], bred) and not bred16[40:].any()
    assert torch.equal(bexp16[:100], bexp) and torch.equal(bdw16[:100], bdw)
