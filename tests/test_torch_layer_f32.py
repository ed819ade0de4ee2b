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


def _b_operand(op, k, n):
    """The (K, N) weight back from the kernels' B operand (Np, K8, 4, 4): each
    fragment's hi + lo at k = 8 kk + t (words 0, 2) and 8 kk + t + 4 (1, 3)."""
    k8 = op.shape[1]
    w = torch.zeros((k8 * 8, op.shape[0]), dtype=torch.float64)
    for t in range(4):
        for half in range(2):
            w[torch.arange(k8) * 8 + t + 4 * half] = (op[:, :, t, half].double()
                                                      + op[:, :, t, 2 + half].double()).t()
    return w[:k, :n]


@pytest.mark.parametrize("bp,l,c,h,f,in_proj,final_ln,out_proj", PIECE_CASES[4:])
def test_the_f32_operands_hold_each_product_in_the_kernels_order(bp, l, c, h, f, in_proj,
                                                                 final_ln, out_proj):
    """Each weight's tf32 pairs give back the weight (the q/k/v one with each
    head's columns at its padded place, zero between), and the three plain
    pieces computed from those operands as the kernels do (3xTF32 products
    in f64: hi.hi + hi.lo + lo.hi) meet the plain layer."""
    cin, cout = (2 * c // 3 if in_proj else c), c // 2 + 8
    _, _, ops = _ops(c, h, f, cin, cout, in_proj, final_ln, out_proj, seed=l + c)
    prep = ftl._prepare_f32(ops, torch.device("cpu"))
    dh, dhp = c // h, ftl.head_pad(c // h)
    wq = _b_operand(prep.weights["wqkv"], c, 3 * h * dhp).reshape(c, 3, h, dhp)
    for i, w in enumerate((ops.wq, ops.wk, ops.wv)):
        assert float((wq[:, i, :, :dh].reshape(c, c) - w.double()).abs().max()) <= 1e-6
        assert not wq[:, i, :, dh:].any()
        assert torch.equal(prep.vectors["bqkv"].reshape(3, h, dhp)[i, :, :dh].reshape(c),
                           (ops.bq, ops.bk, ops.bv)[i])
    for name, w in (("wo", ops.wo), ("wi", ops.wi), ("wo2", ops.wo2), ("win", ops.win),
                    ("wout", ops.wout)):
        op = prep.weights[name]
        if w is None:
            assert op is None
            continue
        assert op.shape == (-(-w.shape[1] // 32) * 32, -(-w.shape[0] // 8), 4, 4)
        assert float((_b_operand(op, *w.shape) - w.double()).abs().max()) <= 1e-6 * float(
            w.abs().max())
    assert prep.cout == (cout if out_proj else c)

    def dot(a, op, k, n):   # the kernels' 3xTF32 product
        ah, al = ftl.tf32_split(a)
        k8 = op.shape[1]
        bh = torch.zeros((k8 * 8, op.shape[0]), dtype=torch.float64)
        bl = torch.zeros_like(bh)
        for t in range(4):
            for half in range(2):
                bh[torch.arange(k8) * 8 + t + 4 * half] = op[:, :, t, half].double().t()
                bl[torch.arange(k8) * 8 + t + 4 * half] = op[:, :, t, 2 + half].double().t()
        ah, al = ah.double(), al.double()
        return (ah @ bh[:k] + ah @ bl[:k] + al @ bh[:k])[:, :n].float()

    x = T(np.random.default_rng(c).standard_normal((bp * l, cin)))
    ln = ftl.layer_norm
    xf = dot(x, prep.weights["win"], cin, c) if in_proj else x
    a = ln(xf, *ops.ln1, eps=ops.eps)
    qkv = dot(a, prep.weights["wqkv"], c, 3 * h * dhp) + prep.vectors["bqkv"].reshape(-1)
    qkv[:, :h * dhp] *= 1.0 / np.sqrt(dh)
    want = ftl.ln_qkv_plain(x, ops)
    assert float((qkv - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_the_smem_reckoning_takes_the_model_widths():
    """Each f32 kernel's block at the model's widths fits an H100's 227 KB;
    a head past 64 or k and v past shared memory are not taken."""
    for l, c, cin, f in ((256, 144, 96, 288), (64, 192, 128, 384), (16, 240, 160, 480)):
        for in_proj in (False, True):
            sizes = ftl.layer_f32_smem(l, cin if in_proj else c, c, 4, f, in_proj)
            assert max(sizes) <= 232448
            assert ftl.f32_layer_takes(l, cin if in_proj else c, c, 4, f, in_proj=in_proj,
                                       limit=232448)
    assert ftl.layer_f32_smem(16, 240, 240, 4, 480, False) == (
        32 * 4 * 2 * 244, 8 * 2 * 16 * 68 * 4, 32 * 4 * (2 * 244 + 484))
    assert ftl.layer_f32_smem(256, 96, 144, 4, 288, True)[1] == 2 * 256 * 44 * 4
    assert not ftl.f32_layer_takes(16, 160, 160, 2, 320, in_proj=False, limit=232448)
    assert not ftl.f32_layer_takes(1024, 64, 64, 1, 128, in_proj=False, limit=232448)


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
    assert not tl.fused_route(F32, cuda, 2048)    # k and v past shared memory


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
    ("smem", (1, 1024, 64), 64, 1, 128, "bytes of shared memory"),         # k, v past 227 KB
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
        f"void {anon}layer_ln_qkv_f32_kernel<4>(LayerF32Args)": "transformer_ln_qkv_f32",
        f"void {anon}layer_attention_f32_kernel<5>(LayerF32Args, {anon}AttnPlan)":
            "transformer_attention_f32",
        f"void {anon}layer_proj_ffn_f32_kernel<2>(LayerF32Args)": "transformer_proj_ffn_f32",
        f"void {anon}layer_ln_qkv_kernel<3, 2>({anon}QkvParams)": "transformer_ln_qkv"}
    for sym, name in symbols.items():
        assert kernel_name(sym) == name, sym
    assert set(symbols.values()) <= set(port.kernel_launches())


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
