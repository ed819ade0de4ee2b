"""Port: the f32 form of the fused transformer layer on the CPU.

The port's ``fused_transformer_layer`` at f32 (its plain version, which the
three f32 CUDA kernels of ``csrc/transformer_layer_f32.cu`` are held to on
the card) against the JAX package's Pallas kernel at
``compute_dtype=float32`` in interpret mode, on the same numpy inputs: within
2e-5 of the largest value (flash attention's f32 tolerance: f32 sums in other
orders). Then the f32 operand layout the kernels read, the shared-memory
reckoning, the model's route (a CUDA device only) and the wrappers'
refusals, which check shapes before the device so that they run here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_experiments_tpu.models.mobilevit import TransformerLayerParams as JLayer
from ggml_experiments_tpu.ops.attention import AttentionParams as JAtt
from ggml_experiments_tpu.ops.fused_transformer_layer import fused_transformer_layer as jlayer
from ggml_experiments_tpu_torch.models import mobilevit as tmv
from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl
from ggml_experiments_tpu_torch.ops.attention import AttentionParams

F32 = torch.float32
TOL = 2e-5


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(autouse=True)
def _two_threads_no_launches():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    before = dict(ftl.LAUNCHES)
    yield
    torch.set_num_threads(prev)
    assert ftl.LAUNCHES == before


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


def _options(rng, c, cin, cout, in_proj, final_ln, out_proj):
    """The block's options for both packages: (jax kwargs, port kwargs)."""
    jkw, tkw = {}, {}
    if in_proj:
        win = (rng.standard_normal((cin, c)) * 0.2).astype(np.float32)
        jkw["input_proj"], tkw["input_proj"] = jnp.asarray(win), T(win)
    if final_ln:
        g3 = rng.standard_normal(c).astype(np.float32) + 1
        b3 = rng.standard_normal(c).astype(np.float32)
        jkw["final_ln"], tkw["final_ln"] = (jnp.asarray(g3), jnp.asarray(b3)), (T(g3), T(b3))
        jkw["final_ln_eps"] = tkw["final_ln_eps"] = 1e-6
    if out_proj:
        wo = (rng.standard_normal((c, cout)) * 0.2).astype(np.float32)
        sc = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        bi = rng.standard_normal(cout).astype(np.float32)
        jkw["output_proj"] = (jnp.asarray(wo), jnp.asarray(sc), jnp.asarray(bi), out_proj)
        tkw["output_proj"] = (T(wo), T(sc), T(bi), out_proj)
    return jkw, tkw


def _against_jax(b, l, c, h, f, cin, cout, in_proj, final_ln, out_proj, seed):
    rng = np.random.default_rng(seed)
    jl, tl = _layers(_arrays(c, h, f, rng), h)
    jkw, tkw = _options(rng, c, cin, cout, in_proj, final_ln, out_proj)
    x = rng.standard_normal((b, l, cin if in_proj else c)).astype(np.float32)
    want = np.asarray(jax.jit(lambda xb: jlayer(jl, xb, compute_dtype=jnp.float32,
                                                interpret=True, **jkw))(jnp.asarray(x)))
    got = ftl.fused_transformer_layer(tl, T(x), compute_dtype=F32, **tkw)
    assert got.dtype == F32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("in_proj", [False, True])
@pytest.mark.parametrize("final_ln", [False, True])
@pytest.mark.parametrize("out_proj", [None, "silu", "none"])
def test_f32_layer_matches_the_jax_kernel_every_flag(in_proj, final_ln, out_proj):
    _against_jax(3, 16, 48, 4, 96, 24, 40, in_proj, final_ln, out_proj, seed=7)


# the three stage widths (dh = 36, 48, 60), one sequence or a few, with the
# first layer's and the last layer's flags
@pytest.mark.parametrize("b,l,c,h,f,cin,cout,flags", [
    (1, 256, 144, 4, 288, 96, 96, (True, False, None)),
    (2, 64, 192, 4, 384, 128, 128, (False, True, "silu")),
    (4, 16, 240, 4, 480, 160, 160, (True, True, "silu"))])
def test_f32_layer_matches_the_jax_kernel_at_the_stage_widths(b, l, c, h, f, cin, cout, flags):
    _against_jax(b, l, c, h, f, cin, cout, *flags, seed=c)


def _ops(c, h, f, cin, cout, in_proj, final_ln, out_proj, seed):
    rng = np.random.default_rng(seed)
    _, tl = _layers(_arrays(c, h, f, rng), h)
    _, tkw = _options(rng, c, cin, cout, in_proj, final_ln, out_proj)
    return tl, tkw, ftl.layer_operands(tl, c, F32, **tkw)


PIECE_CASES = [(3, 24, 48, 4, 96, ip, fl, op) for ip in (False, True) for fl in (False, True)
               for op in (None, "silu")] + [
    (1, 256, 144, 4, 288, True, False, None), (2, 64, 192, 4, 384, False, True, "silu"),
    (4, 16, 240, 4, 480, True, True, "none")]


@pytest.mark.parametrize("bp,l,c,h,f,in_proj,final_ln,out_proj", PIECE_CASES)
def test_the_three_plain_pieces_chain_to_the_layer_plain_at_f32(bp, l, c, h, f, in_proj,
                                                                 final_ln, out_proj):
    cin = 2 * c // 3 if in_proj else c
    _, _, ops = _ops(c, h, f, cin, c // 2 + 8, in_proj, final_ln, out_proj, seed=l + c)
    x = T(np.random.default_rng(c).standard_normal((bp * l, cin)))
    qkv = ftl.ln_qkv_plain(x, ops)
    dh, dhp = c // h, ftl.head_pad(c // h)
    assert qkv.dtype == F32 and qkv.shape == (bp * l, 3 * h * dhp)
    assert not qkv.reshape(bp * l, 3, h, dhp)[..., dh:].any()
    ctx = ftl.attention_plain(qkv, l, ops)
    assert ctx.dtype == F32 and ctx.shape == (bp * l, c)
    got = ftl.proj_ffn_plain(x, ctx, ops)
    want = ftl.fused_transformer_layer_plain(x.reshape(bp, l, -1), ops)
    assert torch.equal(got.reshape(want.shape), want)


def test_tf32_split_is_exact_in_tf32_and_sums_to_f32():
    w = T(np.random.default_rng(3).standard_normal(4096) * 10.0 ** np.arange(-4, 4).repeat(512))
    hi, lo = ftl.tf32_split(w)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rel = (hi.double() + lo.double() - w.double()).abs() / w.double().abs()
    assert float(rel.max()) <= 2.0 ** -21
    # to nearest, ties away from zero, as cvt.rna.tf32.f32
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)], dtype=F32)
    assert ftl.tf32_split(tie)[0].tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


class _Stream:
    """A kernel's weight stream read back tile by tile, in the order the
    kernel takes the tiles: each slot's tf32 hi and lo planes (rows, 32),
    unswizzled (the swizzle is its own inverse), in f64."""

    def __init__(self, stream):
        self.slots, self.i = stream, 0

    def take(self, rows):
        t = ftl.swizzle_tiles(self.slots[self.i, :2 * rows * 32].reshape(2, rows, 32))
        self.i += 1
        for part in t:
            assert not (part.contiguous().view(torch.int32) & 0x1FFF).any()   # exact in tf32
        return t[0].double(), t[1].double()


def _pad(a, k):
    return torch.nn.functional.pad(a, (0, k - a.shape[1]))


def _split_rz(a):
    """The kernels' split of A (``split_tf32_rz``): hi a's top 11
    significant bits, lo the exact rest, read by the tensor cores to its
    top 11 bits."""
    hi = (a.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    lo = ((a - hi).contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def _product(a, st, rows, nk):
    """A kernel product: a fresh sum over nk 32-wide K chunks of the next
    stream tiles, 3xTF32 (lo.hi + hi.lo + hi.hi) in f64."""
    ah, al = (t.double() for t in _split_rz(_pad(a, 32 * nk)))
    acc = 0.0
    for kc in range(nk):
        bh, bl = st.take(rows)
        ks = slice(32 * kc, 32 * kc + 32)
        acc = acc + al[:, ks] @ bh.t() + ah[:, ks] @ bl.t() + ah[:, ks] @ bh.t()
    return acc


def _chunked(a, st, rows, nch, nk, n):
    return torch.cat([_product(a, st, rows, nk) for _ in range(nch)], 1)[:, :n].float()


@pytest.mark.parametrize("bp,l,c,h,f,in_proj,final_ln,out_proj", PIECE_CASES[4:])
def test_the_f32_operands_hold_each_product_in_the_kernels_order(bp, l, c, h, f, in_proj,
                                                                 final_ln, out_proj):
    """The kernels' weight streams read back in the order the kernels take
    their tiles (chunks of w, 144 or 96 output columns by 32-wide K chunks,
    tf32 hi and lo planes, swizzled) give back each weight, and the two row
    kernels' arithmetic on them (each chunk's 3xTF32 sum fresh, then added
    in f32 where the plain version adds) meets ln_qkv_plain and
    proj_ffn_plain; every tile is taken."""
    cin, cout = (2 * c // 3 if in_proj else c), c // 2 + 8
    _, _, ops = _ops(c, h, f, cin, cout, in_proj, final_ln, out_proj, seed=l + c)
    prep = ftl._prepare_f32(ops, torch.device("cpu"))
    nch, w = ftl.f32_chunks(c)
    nkin, nkc, nq, nf = -(-cin // 32), -(-c // 32), -(-3 * c // 144), -(-f // 96)
    cout = ops.wout.shape[1] if ops.wout is not None else c
    assert prep.cout == cout
    assert torch.equal(prep.vectors["bqkv"], torch.cat([ops.bq, ops.bk, ops.bv]))
    assert torch.equal(prep.vectors["bi"][:f], ops.bi) and not prep.vectors["bi"][f:].any()

    def weight(st, rows, nch_, nk, n, k):   # B^T's tiles back as the (K, N) weight
        tiles = [[st.take(rows) for _ in range(nk)] for _ in range(nch_)]
        wt = torch.cat([torch.cat([hi + lo for hi, lo in row], 1) for row in tiles])
        assert not wt[n:].any() and not wt[:, k:].any()
        return wt[:n, :k].t()

    def close(got, want, tol):
        assert float((got - want.double()).abs().max()) <= tol * float(want.abs().max())

    st = _Stream(prep.wa)
    if in_proj:
        close(weight(st, w, nch, nkin, c, cin), ops.win, 1e-6)
    close(weight(st, 144, nq, nkc, 3 * c, c), torch.cat([ops.wq, ops.wk, ops.wv], 1), 1e-6)
    assert st.i == prep.wa.shape[0]
    st = _Stream(prep.wc)
    if in_proj:
        weight(st, w, nch, nkin, c, cin)
    close(weight(st, w, nch, nkc, c, c), ops.wo, 1e-6)
    order = [t for fi in range(nf) for t in (("wi", fi), ("wo2", fi))]   # the FFN's tiles
    for kind, fi in order:
        f0 = 96 * fi
        n = min(96, f - f0)
        if kind == "wi":
            close(weight(st, 96, 1, nkc, n, c), ops.wi[:, f0:f0 + n], 1e-6)
        else:
            close(weight(st, w, nch, 3, c, n), ops.wo2[f0:f0 + n], 1e-6)
    if out_proj:
        close(weight(st, w, -(-cout // w), nkc, cout, c), ops.wout, 1e-6)
    assert st.i == prep.wc.shape[0]

    x = T(np.random.default_rng(c).standard_normal((bp * l, cin)))
    ln = ftl.layer_norm
    st = _Stream(prep.wa)
    xf = _chunked(x, st, w, nch, nkin, c) if in_proj else x
    a = ln(xf, *ops.ln1, eps=ops.eps)
    real = _chunked(a, st, 144, nq, nkc, 3 * c) + prep.vectors["bqkv"]
    real[:, :c] *= 1.0 / np.sqrt(c // h)
    qkv = ftl.ln_qkv_plain(x, ops)
    dh, dhp = c // h, ftl.head_pad(c // h)
    got = torch.zeros((bp * l, 3, h, dhp))
    got[..., :dh] = real.reshape(-1, 3, h, dh)
    close(got.reshape(qkv.shape), qkv, 1e-5)

    ctx = T(np.random.default_rng(c + 1).standard_normal((bp * l, c)))
    st = _Stream(prep.wc)
    xf = _chunked(x, st, w, nch, nkin, c) if in_proj else x
    x1 = xf + _chunked(ctx, st, w, nch, nkc, c) + ops.bo
    y = ln(x1, *ops.ln2, eps=ops.eps)
    h = {}
    for kind, fi in order:
        if kind == "wi":
            h[fi] = ftl.silu(_product(_pad(y, 32 * nkc), st, 96, nkc).float()
                             + prep.vectors["bi"][96 * fi:96 * fi + 96])
        else:
            x1 = x1 + _chunked(h.pop(fi), st, w, nch, 3, c)
    o = x1 + ops.bo2
    if final_ln:
        o = ln(o, *ops.final_ln, eps=ops.final_eps)
    if out_proj:
        o = _chunked(o, st, w, -(-cout // w), nkc, cout) * ops.out_affine[0] + ops.out_affine[1]
        if ops.out_act:
            o = ftl.silu(o)
    close(o, ftl.proj_ffn_plain(x, ctx, ops), 1e-5)
    assert st.i == prep.wc.shape[0]


def _attention_emulated(qkv, l, ops):
    """The f32 attention kernel's arithmetic (``layer_attention_f32_kernel``)
    in PyTorch: a block per head of a window of ``rows`` tokens (64 // L
    sequences packed where L < 64), its scores over the window's keys
    rounded up to 64, 128 or 256 (the array's next rows past the window,
    zeros past T, as TMA reads them), q zero past dh; q, k, v and p split
    as the kernel splits them (k and v are their own hi planes: the tensor
    cores read an f32 word's top 11 significant bits), each k-step's three
    products lo.hi + hi.lo + hi.hi; keys outside a row's sequence at -inf,
    the true row max, p = 2^(s log2(e) - max log2(e)) (one f32 fma, then
    exp2; below 2^-126 zero); the sum of p as a row's four
    lanes add it (each lane its keys 8j + 2q, 8j + 2q + 1 in key order, then
    two shuffles); P.v one 8-key k-step at a time in key order, each step's
    sum added to the f32 accumulator (the chain of NK / 8 k-steps); ctx =
    acc * (1 / sum)."""
    c, h, dh, dhp = ftl._dims(ops)
    t = qkv.shape[0]
    rows, nk, ks, _ = ftl.f32_attention_block(l, dh)
    nb = -(-t // rows)
    arr = torch.zeros((nb * rows + nk, 3, h, dhp))
    arr[:t] = qkv.reshape(t, 3, h, dhp)
    win = arr[torch.arange(nb)[:, None] * rows + torch.arange(nk)]      # (nb, nk, 3, h, dhp)
    q = win[:, :, 0, :, :8 * ks].clone()
    q[..., dh:] = 0.0
    qh, ql = (x.double() for x in _split_rz(q))
    kh, kl = (x.double() for x in _split_rz(win[:, :, 1, :, :8 * ks]))

    def dot(a, b):   # (nb, i, h, d) . (nb, j, h, d) -> (nb, h, i, j)
        return torch.einsum("bihd,bjhd->bhij", a, b)

    s = (dot(ql, kh) + dot(qh, kl) + dot(qh, kh)).float()
    i = torch.arange(nk)
    lo = i // l * l
    R = (t - torch.arange(nb) * rows).clamp(max=rows)
    hi = torch.minimum(lo[None] + l, R[:, None])                       # (nb, nk) by row
    keep = (i[None, None] >= lo[None, :, None]) & (i[None, None] < hi[:, :, None])
    s = torch.where(keep[:, None], s, torch.tensor(-float("inf")))
    m = s.amax(-1, keepdim=True)
    m = torch.where(m == -float("inf"), torch.zeros(()), m)
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    ml2 = m * log2e
    p = torch.exp2((s.double() * log2e.double() - ml2.double()).float())
    p = torch.where(p < 2.0 ** -126, torch.zeros(()), p)
    lanes = (p[..., 0::2] + p[..., 1::2]).reshape(*p.shape[:-1], nk // 8, 4)
    d = torch.zeros(lanes.shape[:-2] + (4,))
    for j in range(nk // 8):
        d = d + lanes[..., j, :]
    den = (d[..., 0] + d[..., 1]) + (d[..., 2] + d[..., 3])
    ph, pl = (x.double() for x in _split_rz(p))
    vh, vl = (x.double().transpose(1, 2) for x in _split_rz(win[:, :, 2]))   # (nb, h, nk, dhp)
    acc = torch.zeros(p.shape[:-1] + (dhp,))
    for j in range(nk // 8):
        k8 = slice(8 * j, 8 * j + 8)
        step = pl[..., k8] @ vh[:, :, k8] + ph[..., k8] @ vl[:, :, k8] + ph[..., k8] @ vh[:, :, k8]
        acc = (acc.double() + step).float()
    ctx = acc * (1.0 / den)[..., None]                                  # (nb, h, nk, dhp)
    return ctx[:, :, :rows].transpose(1, 2).reshape(nb * rows, h, dhp)[:t, :, :dh].reshape(t, c)


# the three model shapes (dh = 36, 48, 60; 256 keys, one 64-row tile, four
# sequences packed into a tile), a packed L = 16 tile with a ragged T = 48,
# two sequences of 24 in a tile, and a window of two tiles (L = 72, dh = 8)
ATTN_CASES = [(2, 256, 144, 4, 288), (3, 64, 192, 4, 384), (8, 16, 240, 4, 480),
              (3, 16, 240, 4, 480), (3, 24, 64, 2, 128), (2, 72, 40, 5, 88)]


@pytest.mark.parametrize("bp,l,c,h,f", ATTN_CASES)
def test_the_f32_attention_kernels_arithmetic_meets_its_plain_version(bp, l, c, h, f):
    """The attention kernel's arithmetic emulated (whole-row scores, the
    true max, the splits, P.v's chain in the kernel's order) on ln_qkv_plain's
    array meets attention_plain within 1e-5 of the largest value (the card
    tests' and chip_smoke's LAYER_F32_REL)."""
    _, _, ops = _ops(c, h, f, c, c, False, False, None, seed=l + c)
    x = T(np.random.default_rng(l).standard_normal((bp * l, c)))
    qkv = ftl.ln_qkv_plain(x, ops)
    want = ftl.attention_plain(qkv, l, ops)
    got = _attention_emulated(qkv, l, ops)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("b,l,c,h,f,cin,cout,flags", [
    (1, 256, 144, 4, 288, 96, 96, (True, False, None)),
    (2, 64, 192, 4, 384, 128, 128, (False, True, "silu")),
    (3, 16, 240, 4, 480, 160, 160, (True, True, "silu"))])
def test_the_f32_attention_kernels_arithmetic_holds_the_layer_to_the_jax_kernel(
        b, l, c, h, f, cin, cout, flags):
    """ln_qkv_plain, the attention kernel's emulated arithmetic and
    proj_ffn_plain chained meet the JAX package's Pallas layer at f32 in
    interpret mode within the file's TOL (at L = 16 a tile of three
    sequences: T = 48)."""
    rng = np.random.default_rng(c + 1)
    jl, tl = _layers(_arrays(c, h, f, rng), h)
    jkw, tkw = _options(rng, c, cin, cout, *flags)
    x = rng.standard_normal((b, l, cin if flags[0] else c)).astype(np.float32)
    want = np.asarray(jax.jit(lambda xb: jlayer(jl, xb, compute_dtype=jnp.float32,
                                                interpret=True, **jkw))(jnp.asarray(x)))
    ops = ftl.layer_operands(tl, c, F32, **tkw)
    x2 = T(x).reshape(b * l, -1)
    got = ftl.proj_ffn_plain(x2, _attention_emulated(ftl.ln_qkv_plain(x2, ops), l, ops), ops)
    got = got.reshape(want.shape).numpy()
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)


def test_the_smem_reckoning_takes_the_model_widths():
    """Each f32 kernel's block at the model's widths fits an H100's 227 KB
    with the plan the wrapper takes at B = 128 (the row tiles on two
    consumer warpgroups at T = 131072 and 32768, one at 8192; ring buffers
    as many as fit, up to 4, at least 2; two warpgroups forced where both
    kernels' blocks fit, not at C = 240; the attention on two warpgroups
    where its block has four 64-row tiles, L = 256, one where it has one);
    C-wide products in 2 x 72, 2 x 96 and 3 x 80 columns; a head past 64, C
    past 240, L past 4096 or k and v of 256 keys past shared memory are not
    taken."""
    plans = {(144, False): ((2, 3), 2, (2, 3)), (144, True): ((2, 3), 2, (2, 3)),
             (192, False): ((2, 3), 1, (2, 3)), (192, True): ((2, 3), 1, (2, 2)),
             (240, False): ((1, 4), 1, (1, 4)), (240, True): ((1, 4), 1, (1, 4))}
    for l, c, cin, f, t, chunks in ((256, 144, 96, 288, 131072, (2, 72)),
                                    (64, 192, 128, 384, 32768, (2, 96)),
                                    (16, 240, 160, 480, 8192, (3, 80))):
        assert ftl.f32_chunks(c) == chunks
        for in_proj in (False, True):
            width = cin if in_proj else c
            for cout in (c, cin):
                plan = ftl.f32_layer_plan(t, l, width, c, 4, f, in_proj=in_proj, limit=232448,
                                          sms=132, cout=cout)
                assert plan == plans[(c, in_proj)]
                assert max(ftl.layer_f32_smem(l, width, c, 4, f, in_proj, plan, cout)) <= 232448
                two = ftl.f32_layer_plan(t, l, width, c, 4, f, in_proj=in_proj, limit=232448,
                                         sms=132, nwg=2, cout=cout)
                assert two == (None if c == 240 else plan)
            assert ftl.f32_layer_takes(l, width, c, 4, f, in_proj=in_proj, limit=232448)
    # ln_qkv: 1024 + boxes of 8 KB + LN's gamma and beta (C padded to 48
    # units) + the q/k/v biases and column table + barriers + ring buffers
    # of 144 x 256 bytes; proj_ffn: x's (or h1's) boxes and ctx's + six
    # C-wide vectors, bi, the BN's scale and bias + barriers + buffers of
    # max(w, 96) x 256; attention: 1024 + k (32 bytes a key and k-step) +
    # v's staging (then k's lo), v^T's raw and lo planes (4 bytes a key and
    # padded column each) + a 64-row q tile a warpgroup + three barriers
    assert ftl.layer_f32_smem(16, 240, 240, 4, 480, False, ((1, 4), 1, (1, 4)), 160) == (
        1024 + 8 * 8192 + 4 * (2 * 240 + 2 * 5 * 144) + 8 * 14 + 4 * 36864,
        1024 + 32 * 64 * 8 + 3 * 4 * 64 * 64 + 64 * 32 * 8 + 24,
        1024 + (3 + 8) * 8192 + 4 * (6 * 240 + 5 * 96 + 2 * 2 * 80) + 8 * 16 + 4 * 24576)
    assert ftl.layer_f32_smem(256, 96, 144, 4, 288, True, ((2, 3), 2, (2, 3)))[1] == (
        1024 + 32 * 256 * 5 + 3 * 4 * 256 * 48 + 2 * 64 * 32 * 5 + 24)
    assert ftl.f32_attention_block(256, 36) == (256, 256, 5, 4)
    assert ftl.f32_attention_block(16, 60) == (64, 64, 8, 1)
    assert ftl.f32_attention_block(24, 64) == (48, 64, 8, 1)
    assert ftl.f32_attention_block(72, 8) == (72, 128, 1, 2)
    assert [ftl.f32_attention_warpgroups(l, 36, w) for l in (256, 64, 16)
            for w in (None, 1, 2)] == [2, 1, 2, 1, 1, None, 1, 1, None]
    assert not ftl.f32_layer_takes(4160, 144, 144, 4, 288, in_proj=False, limit=232448)
    assert not ftl.f32_layer_takes(256, 256, 256, 4, 512, in_proj=False, limit=232448)
    assert not ftl.f32_layer_takes(16, 160, 160, 2, 320, in_proj=False, limit=232448)
    assert not ftl.f32_layer_takes(256, 64, 64, 1, 128, in_proj=False, limit=232448)
    assert not ftl.f32_layer_takes(16, 288, 288, 4, 576, in_proj=False, limit=232448)
    assert ftl.f32_layer_plan(128, 16, 48, 48, 4, 96, in_proj=False, limit=232448, sms=132) == (
        (1, 4), 1, (1, 4))


@pytest.mark.parametrize("c,cin,in_proj,takes", [
    (240, 160, True, True), (248, 248, False, False), (288, 288, False, False),
    (384, 256, True, False), (44, 44, False, True), (42, 42, False, False),
    (48, 22, True, False), (48, 24, True, True)])
def test_the_f32_gate_turns_away_what_the_row_tiles_do_not_take(c, cin, in_proj, takes):
    """The row tiles keep C-wide sums in registers (C up to 240) and read x
    (with the input projection) and ctx by TMA (C and Cin multiples of 4):
    ``f32_layer_takes`` and the model's route say so from the shape before
    any launch, so that such a layer keeps the unfused chain with flash
    attention on the card; the wrappers refuse it."""
    h = 4 if c % 4 == 0 else 2
    assert ftl.f32_layer_takes(16, cin, c, h, 2 * c, in_proj=in_proj, limit=232448) == takes
    layer = _route_layer(c=c, h=h, f=2 * c)
    assert layer.fused_route(F32, torch.device("cuda"), 16, cin=cin if in_proj else None) == takes
    if not takes:
        _, _, ops = _ops(c, h, 2 * c, cin, c, in_proj, False, None, seed=2)
        with pytest.raises(ValueError, match="not a layer the f32 kernels take"):
            ftl.fused_layer_cuda(torch.zeros((1, 16, cin)), ops)


@pytest.mark.parametrize("l,takes", [(1024, True), (4096, True), (4104, False)])
def test_the_f32_gate_turns_away_sequences_past_256_keys(l, takes):
    """The attention keeps the scores of a row's keys in registers, 256 at
    most; past them it walks the keys in windows of 256 with a running max,
    up to the 4096 keys the gate takes (layer_3 at 512 px is 1024):
    ``f32_layer_takes`` and the model's route say so from the shape before
    any launch, so a longer layer keeps the unfused chain with flash
    attention on the card; the wrappers refuse it."""
    assert ftl.f32_attention_streams(l)
    assert ftl.f32_layer_takes(l, 48, 48, 4, 96, in_proj=False, limit=232448) == takes
    assert _route_layer().fused_route(F32, torch.device("cuda"), l) == takes
    if not takes:
        _, _, ops = _ops(48, 4, 96, 48, 48, False, False, None, seed=2)
        with pytest.raises(ValueError, match="L up to 4096"):
            ftl.fused_layer_cuda(torch.zeros((1, l, 48)), ops)


def _route_layer(c=48, h=4, f=96, fused=True):
    _, tl = _layers(_arrays(c, h, f, np.random.default_rng(5)), h)
    return dataclasses.replace(tl, fused=fused)


def test_the_f32_route_is_the_cards_only():
    """f32 takes the fused layer on a CUDA device only, where the kernels take
    the shape; bf16 keeps the JAX model's route everywhere; L must be a
    multiple of 8."""
    tl = _route_layer()
    cuda = torch.device("cuda")
    assert tl.fused_route(F32, cuda, 16) and tl.fused_route(F32, "cuda", 16, cin=24)
    assert not tl.fused_route(F32, "cpu", 16) and not tl.fused_route(F32, None, 16)
    assert not tl.fused_route(F32, cuda, 20) and not tl.fused_route(torch.bfloat16, "cpu", 12)
    assert tl.fused_route(torch.bfloat16, "cpu", 16) and tl.fused_route(torch.bfloat16, cuda, 16)
    assert not _route_layer(fused=False).fused_route(F32, cuda, 16)
    assert not _route_layer(c=160, h=2, f=320).fused_route(F32, cuda, 16)   # dh = 80
    assert not tl.fused_route(F32, cuda, 4104)    # past the 4096 keys the gate takes


@pytest.mark.parametrize("cd", [F32, "float32", torch.bfloat16])
def test_the_measurements_switch_turns_only_the_f32_route_off(cd):
    """``utils/observability.f32_layer_route_off`` (the route on against off
    in chip_smoke.py and tools/torch_gate_sweep.py) turns the f32 route off,
    by dtype or by name, keeps bf16's, and puts the route back after."""
    from ggml_experiments_tpu_torch.utils.observability import f32_layer_route_off

    tl, cuda = _route_layer(), torch.device("cuda")
    on = tl.fused_route(cd, cuda, 16)
    assert on
    with f32_layer_route_off():
        assert tl.fused_route(cd, cuda, 16) == (cd == torch.bfloat16)
    assert tl.fused_route(cd, cuda, 16) == on


def test_the_cpu_model_keeps_the_unfused_f32_chain(monkeypatch):
    """On the CPU an f32 layer with ``fused`` set runs the JAX model's
    unfused chain, never the fused layer's plain version; bf16 takes it."""
    tl = _route_layer()
    calls = []
    real = ftl.fused_transformer_layer_plain
    monkeypatch.setattr(ftl, "fused_transformer_layer_plain",
                        lambda *a, **k: calls.append(a[0].dtype) or real(*a, **k))
    x = T(np.random.default_rng(1).standard_normal((2, 16, 48)))
    tl(x, compute_dtype=F32)
    assert calls == []
    tl(x, compute_dtype=torch.bfloat16)
    assert calls == [torch.bfloat16]


def test_the_f32_route_folds_the_block_and_meets_the_unfused_forward(monkeypatch):
    """With the card's f32 route (forced here: on the CPU the plain version
    stands in for the kernels), layer_3's block of the tiny model folds its
    conv_1x1, final LN and conv_projection into its first and last layers;
    the features lie within 2e-5 of the unfused f32 forward's largest."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_golden_mobilevit import TINY

    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors

    gold = os.path.join(os.path.dirname(__file__), "goldens")
    cfg = tmv.MobileViTConfig(image_size=TINY.image_size,
                              neck_hidden_sizes=TINY.neck_hidden_sizes,
                              hidden_sizes=TINY.hidden_sizes)
    tp = tmv.from_named_tensors(read_named_tensors(os.path.join(gold, "mobilevit_tiny.ggml")),
                                cfg, device="cpu", fused_layer=True)
    img = torch.from_numpy(np.load(os.path.join(gold, "mobilevit_tiny.npz"))["image"][None])
    want = tmv.extract_features(tp, img)
    seen = []
    real = ftl.fused_transformer_layer_plain
    monkeypatch.setattr(ftl, "fused_transformer_layer_plain",
                        lambda x3, ops: seen.append((ops.win is not None, ops.wout is not None))
                        or real(x3, ops))
    route = tmv.TransformerLayerParams.fused_route
    monkeypatch.setattr(tmv.TransformerLayerParams, "fused_route",
                        lambda self, cd, device=None, l=None, cin=None:
                        route(self, cd, "cuda", l, cin))
    got = tmv.extract_features(tp, img)
    n = len(tp.layer_3.transformer)
    assert seen == [(True, n == 1)] + [(False, False)] * (n - 2) + [(False, True)] * (n > 1)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


@pytest.mark.parametrize("what,shape,c,h,f,match", [
    ("head", (1, 16, 160), 160, 2, 320, "f32 kernels take"),               # dh = 80
    ("smem", (1, 256, 64), 64, 1, 128, "bytes of shared memory"),          # k, v past 227 KB
    ("rows", (20, 64), 64, 2, 128, "T a multiple of L"),
    ("width", (1, 16, 40), 64, 2, 128, "does not meet the weights"),
    ("dtype", (1, 16, 64), 64, 2, 128, "bf16 or f32"),
    ("device", (1, 16, 64), 64, 2, 128, "CUDA tensors")])
def test_the_f32_wrappers_refuse_what_their_kernels_do_not_take(what, shape, c, h, f, match):
    _, _, ops = _ops(c, h, f, c, c, False, False, None, seed=1)
    x = torch.zeros(shape, dtype=torch.float16 if what == "dtype" else F32)
    with pytest.raises(ValueError, match=match):
        if what == "rows":
            ftl.ln_qkv_cuda(x, ops, 16)
        else:
            ftl.fused_layer_cuda(x, ops)


def test_fused_transformer_layer_refuses_other_dtypes():
    tl = _route_layer()
    with pytest.raises(ValueError, match="float32 or bfloat16, got torch.float16"):
        ftl.fused_transformer_layer(tl, torch.zeros((2, 16, 48)), compute_dtype=torch.float16)


def test_the_f32_kernel_symbols_are_their_launch_counters():
    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.utils.trace_report import kernel_name

    anon = "(anonymous namespace)::"
    symbols = {
        f"void {anon}layer_ln_qkv_f32_kernel<3>({anon}RowF32Params)": "transformer_ln_qkv_f32",
        f"void {anon}layer_attention_f32_kernel<256, 5>({anon}AttnF32Params)":
            "transformer_attention_f32",
        f"void {anon}layer_proj_ffn_f32_kernel<5>({anon}RowF32Params)": "transformer_proj_ffn_f32",
        f"void {anon}layer_ln_qkv_kernel<3, 2>({anon}QkvParams)": "transformer_ln_qkv"}
    for sym, name in symbols.items():
        assert kernel_name(sym) == name, sym
    assert set(symbols.values()) <= set(port.kernel_launches())


def test_the_attention_split_toggles_each_find_one_line_of_the_kernel():
    """``tools/torch_kernel_bench.py --only attention_f32 --split-step``
    switches parts of the f32 attention off by replacing source lines: each
    line it looks for is in ``csrc/transformer_layer_f32.cu`` once."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_bench", os.path.join(root, "tools", "torch_kernel_bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    with open(os.path.join(root, "ggml_experiments_tpu_torch", "csrc",
                           "transformer_layer_f32.cu")) as f:
        src = f.read()
    for macro, old, _ in bench.ATTN_F32_SPLIT_TOGGLES:
        assert src.count(old) == 1, macro
    assert {m for m, _, _ in bench.ATTN_F32_SPLIT_TOGGLES} == set(
        bench.ATTN_F32_SPLIT_VARIANTS[1:])


def test_the_layer_bound_is_its_kernels_work():
    """The three kernels' operations sum to the layer's (x.Win counted once,
    in ln_qkv); at f32 a B=128 forward's nine layers are bound by their
    products at 3xTF32's rate: about 232 GFLOP, 1.4 ms on an H100."""
    from ggml_experiments_tpu_torch.utils.observability import H100, transformer_layer_bound

    total_ms, total_ops = 0.0, 0.0
    for l, c, f, cin, n in ((256, 144, 288, 96, 2), (64, 192, 384, 128, 4),
                            (16, 240, 480, 160, 3)):
        for first, last in [(True, False)] + [(False, False)] * (n - 2) + [(False, True)]:
            b = transformer_layer_bound(512, l, cin if first else c, c, f, cin if last else c,
                                        "float32", in_proj=first, out_proj=last)
            assert b["layer"][1] == sum(b[k][1] for k in ("ln_qkv", "attention", "proj_ffn"))
            total_ops += b["layer"][1]
            ms, by = H100.bound_ms(*b["layer"], "tf32x3")
            assert by == "operations"
            total_ms += ms
    assert 225e9 < total_ops < 245e9 and 1.35 < total_ms < 1.5
