"""Port: attention over sequences longer than a block's shared memory holds.

MobileViT-small at 512 px gives layer_3 sequences of L = 1024 tokens (C =
144, 4 heads of dh = 36). On the card three kernels stream a head's keys
through shared memory there: the bf16 fused layer's attention (keys walked
twice in 64-key chunks), the f32 fused layer's (windows of 256 keys with a
running max) and flash attention (chunks of 256 keys; twice at bf16, a
running max at f32). Here each one's streamed arithmetic is emulated chunk
by chunk in PyTorch and held to its plain version at L = 640 and 1024, each
plain version is held to the JAX package's Pallas kernel in interpret mode
at L = 1024, and the tiny MobileViT runs at 448 px (layer_3 at L = 784, past
the resident kernels of earlier commits) against the JAX forward. On the CPU the wrappers
run the plain versions and leave the launch counters alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_experiments_tpu.models import mobilevit as jmv
from ggml_experiments_tpu.models.mobilevit import TransformerLayerParams as JLayer
from ggml_experiments_tpu.ops.attention import AttentionParams as JAtt
from ggml_experiments_tpu.ops.flash_attention import flash_mha as jflash
from ggml_experiments_tpu.ops.fused_transformer_layer import fused_transformer_layer as jlayer
from ggml_experiments_tpu_torch.models import mobilevit as tmv
from ggml_experiments_tpu_torch.ops import flash_attention as fa
from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl
from ggml_experiments_tpu_torch.ops.attention import AttentionParams

BF16, F32 = torch.bfloat16, torch.float32
C, H, F = 144, 4, 288          # layer_3's widths: dh = 36
LAYER_F32_REL = 1e-5           # the f32 layer's kernels against their plain versions
FLASH_F32_REL = 1e-5           # flash at f32 against its plain version


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(autouse=True)
def _two_threads_no_launches():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    before = (dict(ftl.LAUNCHES), dict(fa.LAUNCHES))
    yield
    torch.set_num_threads(prev)
    assert (ftl.LAUNCHES, fa.LAUNCHES) == before


def _arrays(c, h, f, rng):
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
    tl = tmv.TransformerLayerParams(
        attention=AttentionParams(**{k: T(v) for k, v in arrs["att"].items()}, num_heads=h),
        **{k: T(v) for k, v in rest.items()}, fused=True)
    return jl, tl


def _qkv(l, bp, cd, seed):
    """ln_qkv_plain's (T, 3 H dhp) array for bp sequences of l tokens, and
    the layer's operands at cd."""
    rng = np.random.default_rng(seed)
    _, tl = _layers(_arrays(C, H, F, rng), H)
    ops = ftl.layer_operands(tl, C, cd)
    x = T(rng.standard_normal((bp * l, C))).to(cd)
    return ftl.ln_qkv_plain(x, ops), ops


def _heads(qkv, l):
    """q, k, v of the array as (bp, H, l, dh) f32."""
    dh, dhp = C // H, ftl.head_pad(C // H)
    t = qkv.reshape(-1, l, 3, H, dhp)[..., :dh]
    return [t[:, :, i].permute(0, 2, 1, 3).float() for i in range(3)]


def _ctx(p, vh, den):
    """ctx (T, C) from p (bp, H, l, l) and its f32 row sums as the plain
    version forms it."""
    ctx = torch.einsum("bhlm,bhmd->blhd", p.float(), vh)
    return (ctx * (1.0 / den).permute(0, 2, 1)[..., None]).reshape(-1, C)


def _bf16_streamed(qh, kh, vh, l, chunk):
    """The bf16 streamed walk (csrc ``layer_attention_stream_kernel``, and
    flash at bf16 past 256 keys): the first pass takes each chunk's scores
    rounded to bf16 and folds them into the row max; the second forms each
    chunk's p = exp(s - max) in bf16 (the difference rounded, then the exp)
    after that TRUE max, adds its f32 sums and P.v into the totals chunk
    after chunk. Returns (max, p, ctx in the chunks' order of sums)."""
    m = torch.full(qh.shape[:-1], -float("inf"), dtype=BF16)
    for c0 in range(0, l, chunk):
        s = torch.einsum("bhld,bhmd->bhlm", qh, kh[:, :, c0:c0 + chunk]).to(BF16)
        m = torch.maximum(m, s.amax(-1))
    ps, den = [], torch.zeros(qh.shape[:-1])
    acc = torch.zeros(qh.shape)
    for c0 in range(0, l, chunk):
        s = torch.einsum("bhld,bhmd->bhlm", qh, kh[:, :, c0:c0 + chunk]).to(BF16)
        p = torch.exp(s - m[..., None])
        ps.append(p)
        den = den + p.float().sum(-1)
        acc = acc + p.float() @ vh[:, :, c0:c0 + chunk]
    ctx = (acc * (1.0 / den)[..., None]).permute(0, 2, 1, 3).reshape(-1, C)
    return m, torch.cat(ps, -1), ctx


def _bf16_held(got_m, got_p, got_ctx, qh, kh, vh, want):
    """The streamed max and p bit-equal to the plain version's (which
    computes them over whole rows), so that ctx formed from them with the
    plain version's sums is want's bits; summed in the chunks' order, ctx
    differs before its bf16 rounding by f32 rounding only (2^-20 of the
    largest value), which moves the rounding of under 1% of the values."""
    s = torch.einsum("bhld,bhmd->bhlm", qh, kh).to(BF16)
    assert torch.equal(got_m, s.amax(-1))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    assert torch.equal(got_p, p)
    ctx = _ctx(got_p, vh, got_p.float().sum(-1))
    assert torch.equal(ctx.to(BF16), want)
    assert float((got_ctx - ctx).abs().max()) <= 2.0 ** -20 * float(ctx.abs().max())
    assert float((got_ctx.to(BF16) == want).float().mean()) >= 0.99


@pytest.mark.parametrize("l", [640, 1024])
def test_the_bf16_layer_attentions_streamed_walk_is_its_plain_versions(l):
    """The streamed bf16 attention's 64-key chunks, walked twice, against
    attention_plain (the card's kernel keeps this arithmetic on wgmma)."""
    qkv, ops = _qkv(l, 2, BF16, seed=l)
    qh, kh, vh = _heads(qkv, l)
    m, p, ctx = _bf16_streamed(qh, kh, vh, l, 64)
    _bf16_held(m, p, ctx, qh, kh, vh, ftl.attention_plain(qkv, l, ops))


def _split_rz(a):
    """split_tf32_rz: hi a's top 11 significant bits, lo the rest as the
    tensor cores read it (its top 11 bits)."""
    hi = (a.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    lo = ((a - hi).contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def _x3(a, b):
    """a . b as 3xTF32 (lo.hi + hi.lo + hi.hi, each exact in f64), then f32."""
    ah, al = (x.double() for x in _split_rz(a))
    bh, bl = (x.double() for x in _split_rz(b))
    return (al @ bh + ah @ bl + ah @ bh).float()


def _f32_streamed(qh, kh, vh, l, window):
    """The f32 streamed attention (csrc ``layer_attention_f32_stream_kernel``)
    window by window: the window's scores as 3xTF32, keys past L at -inf,
    the running max, the sums so far scaled by 2^(old max log2(e) - new max
    log2(e)), p = 2^(s log2(e) - max log2(e)) (one f32 fma), its sums, and
    the window's P.v (3xTF32 one 8-key k-step at a time, a fresh f32 sum)
    added to the rescaled total."""
    log2e = torch.tensor(1.4426950408889634, dtype=F32)
    m = torch.full(qh.shape[:-1] + (1,), -float("inf"))
    den, acc = torch.zeros(qh.shape[:-1] + (1,)), torch.zeros(qh.shape)
    for w0 in range(0, l, window):
        kw, vw = kh[:, :, w0:w0 + window], vh[:, :, w0:w0 + window]
        s = _x3(qh, kw.transpose(-1, -2))
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        ml2 = mn * log2e
        r = torch.exp2(m * log2e - ml2)
        den, acc, m = den * r, acc * r, mn
        p = torch.exp2((s.double() * log2e.double() - ml2.double()).float())
        part = torch.zeros(qh.shape)
        for j in range(0, s.shape[-1], 8):
            den = den + p[..., j:j + 8].sum(-1, keepdim=True)
            part = part + _x3(p[..., j:j + 8], vw[:, :, j:j + 8])
        acc = acc + part
    return (acc * (1.0 / den)).permute(0, 2, 1, 3).reshape(-1, C)


@pytest.mark.parametrize("l", [640, 1024])
def test_the_f32_layer_attentions_windows_meet_its_plain_version(l):
    """The f32 attention's windows of 256 keys with a running max against
    attention_plain, within LAYER_F32_REL of the largest value (the card's
    check of the kernel)."""
    assert ftl.f32_attention_streams(l)
    rows, keys, ks, nt = ftl.f32_attention_block(l, C // H)
    assert (rows, keys, ks, nt) == (l, 256, 5, l // 64)
    qkv, ops = _qkv(l, 2, F32, seed=l + 1)
    got = _f32_streamed(*_heads(qkv, l), l, keys)
    want = ftl.attention_plain(qkv, l, ops)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= LAYER_F32_REL * float(want.abs().max())


def _flash_inputs(l, bp, seed):
    rng = np.random.default_rng(seed)
    return [T(rng.standard_normal((bp, l, C))) for _ in range(3)]


def _flash_heads(q, k, v, cd):
    """flash's operands per head: q scaled in its dtype, as (bp, H, l, dh)."""
    bp, l, _ = q.shape
    dh = C // H
    q = q.to(cd) * torch.tensor(fa.head_scale(dh, cd), dtype=cd)
    return [t.to(cd).reshape(bp, l, H, dh).permute(0, 2, 1, 3).float() for t in (q, k, v)]


@pytest.mark.parametrize("l", [640, 1024])
def test_flash_attentions_streamed_chunks_meet_its_plain_version(l):
    """flash past 256 keys stages k and v in chunks of 256 keys, which end
    on its 32-key steps: at f32 the running max over 32-key steps with the
    sums rescaled (within 1e-5 of the largest, the card's check), at bf16
    the keys walked twice (max and p bit-equal, as the layer's)."""
    assert fa.streams_keys(l) and fa.WHOLE_ROW_KEYS % 32 == 0
    q, k, v = _flash_inputs(l, 2, seed=l)
    qh, kh, vh = _flash_heads(q, k, v, F32)
    m = torch.full(qh.shape[:-1] + (1,), -float("inf"))
    den, acc = torch.zeros(qh.shape[:-1] + (1,)), torch.zeros(qh.shape)
    for c0 in range(0, l, fa.WHOLE_ROW_KEYS):        # the staged chunks
        for j0 in range(c0, min(l, c0 + fa.WHOLE_ROW_KEYS), 32):   # the key loop's steps
            s = qh @ kh[:, :, j0:j0 + 32].transpose(-1, -2)
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            r = torch.exp(m - mn)
            p = torch.exp(s - mn)
            den, acc, m = den * r + p.sum(-1, keepdim=True), acc * r + p @ vh[:, :, j0:j0 + 32], mn
    got = (acc / den).permute(0, 2, 1, 3).reshape(2, l, C)
    want = fa.flash_mha_plain(q, k, v, H)
    assert float((got - want).abs().max()) <= FLASH_F32_REL * float(want.abs().max())
    q16, k16, v16 = (t.to(BF16) for t in (q, k, v))
    qh, kh, vh = _flash_heads(q16, k16, v16, BF16)
    m, p, ctx = _bf16_streamed(qh, kh, vh, l, fa.WHOLE_ROW_KEYS)
    _bf16_held(m, p, ctx, qh, kh, vh, fa.flash_mha_plain(q16, k16, v16, H).reshape(-1, C))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_the_layer_plain_matches_the_jax_kernel_at_1024_keys(cd):
    """The fused layer's plain version (the card's kernels' reference) on
    one sequence of 1024 tokens at layer_3's widths against the JAX
    package's Pallas layer in interpret mode: 2e-5 of the largest at f32,
    the bf16 tests' 0.08 at bf16."""
    rng = np.random.default_rng(1024)
    jl, tl = _layers(_arrays(C, H, F, rng), H)
    x = rng.standard_normal((1, 1024, C)).astype(np.float32)
    jcd = jnp.dtype(cd)
    want = np.asarray(jax.jit(lambda xb: jlayer(jl, xb, compute_dtype=jcd, interpret=True))(
        jnp.asarray(x, jcd)).astype(jnp.float32))
    got = ftl.fused_transformer_layer(tl, T(x), compute_dtype=getattr(torch, cd))
    assert got.shape == want.shape
    tol = 2e-5 if cd == "float32" else 0.08
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * scale,
                               rtol=0 if cd == "float32" else tol)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_flash_plain_matches_the_jax_kernel_at_1024_keys(cd):
    """flash_mha_plain against the JAX package's flash kernel in interpret
    mode at L = 1024, C = 144, 4 heads, with the JAX tests' tolerances."""
    q, k, v = (t.numpy() for t in _flash_inputs(1024, 1, seed=5))
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H,
                             compute_dtype=jnp.dtype(cd), interpret=True).astype(jnp.float32))
    got = fa.flash_mha(T(q), T(k), T(v), H, compute_dtype=cd)
    tol = 2e-5 if cd == "float32" else 0.05
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


TINY = tmv.MobileViTConfig(image_size=448, neck_hidden_sizes=(8, 16, 24, 32, 40, 48, 96),
                           hidden_sizes=(24, 32, 40))


def test_the_tiny_model_past_576_keys_matches_jax():
    """The tiny MobileViT at 448 px: layer_3's 56 x 56 map gives sequences of
    784 tokens, past the 576 the bf16 attention held whole before the
    streamed plan (the card takes it past 256, ``attention_plan``). bf16
    with the fused layer on (the JAX model's route, its plain version here)
    against the JAX forward with the same flag."""
    assert ftl.attention_plan(784) == "streamed" and ftl.attention_plan(256) == "resident"
    named = tmv.random_named_tensors(TINY, seed=3, classifier=True)
    jp = jmv.from_named_tensors(named, jmv.MobileViTConfig(**dataclasses.asdict(TINY)),
                                fused_layer=True)
    img = np.random.default_rng(4).uniform(0, 1, (1, 448, 448, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jmv.extract_features(p, x, compute_dtype=jnp.bfloat16))(
        jp, jnp.asarray(img)))
    tp = tmv.from_named_tensors(named, TINY, device="cpu", fused_layer=True)
    calls = []
    real = ftl.fused_transformer_layer_plain
    ftl.fused_transformer_layer_plain = lambda x3, ops: calls.append(x3.shape[1]) or real(x3, ops)
    try:
        got = tmv.extract_features(tp, T(img), compute_dtype=BF16).numpy()
    finally:
        ftl.fused_transformer_layer_plain = real
    assert calls[:2] == [784, 784] and got.shape == want.shape == (1, 14, 14, 96)
    np.testing.assert_allclose(got, want, atol=0.1 * np.abs(want).max(), rtol=0.1)


def test_the_attention_bound_counts_the_work_of_each_walk():
    """At B = 128 images of 512 px (bp = 512 sequences of 1024 tokens, C =
    144, 4 heads): q.k^T and P.v 154.6 GFLOP each, 2.15 G exponentials; the
    bf16 forms walk the keys twice (q.k^T again), the f32 forms once at
    3xTF32's rate."""
    from ggml_experiments_tpu_torch.utils.observability import H100, attention_bound

    bf16_ms, by16, parts16 = attention_bound(512, 1024, C, H, "bfloat16", passes=2)
    f32_ms, by32, parts32 = attention_bound(512, 1024, C, H, "float32")
    qk = 2 * 512 * H * 1024 ** 2 * (C // H)
    assert qk == 154_618_822_656
    assert parts16["tensor"] == pytest.approx(3 * qk / H100.peak_ops["bfloat16"] * 1e3)
    assert parts32["tensor"] == pytest.approx(2 * qk / H100.peak_ops["tf32x3"] * 1e3)
    assert parts16["mufu"] == parts32["mufu"] == pytest.approx(
        512 * H * 1024 ** 2 / H100.mufu_exp_per_s * 1e3)
    assert parts16["bytes"] == pytest.approx(4 * 512 * 1024 * C * 2 / H100.hbm_bytes_per_s * 1e3)
    assert (by16, by32) == ("operations", "operations")
    assert bf16_ms == parts16["mufu"] and f32_ms == parts32["tensor"]
