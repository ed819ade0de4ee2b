"""Port: the plain versions of the three vision kernels against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs.

Tolerances are the JAX package's own for these kernels
(tests/test_flash_attention.py, tests/test_fused_transformer_layer.py,
tests/test_fused_inverted_residual.py). On the CPU the wrappers run the
plain versions and leave the launch counters alone.
"""

import dataclasses

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
from ggml_experiments_tpu_torch.ops.norm import FoldedBN


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
                                       (4, 16, 240, 4, 480)])
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


@pytest.mark.parametrize("stride,resid,c,e,cout,hw", [
    (1, True, 8, 32, 8, 8), (1, False, 8, 32, 16, 8), (2, False, 8, 32, 16, 8),
    (1, True, 16, 64, 16, 12)])
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
