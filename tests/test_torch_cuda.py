"""Port: the CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them (the
kernels have no CPU mode). On the card:

    python -m pytest tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from ggml_experiments_tpu_torch import quant
from ggml_experiments_tpu_torch.convert import params_from_numpy
from ggml_experiments_tpu_torch.ops import fused_gru_decode as tf
from ggml_experiments_tpu_torch.quant.qmatmul import LAUNCHES as qmm_launches
from ggml_experiments_tpu_torch.quant.qmatmul import qmatmul_cuda
from ggml_experiments_tpu_torch.serving import DecodeEngine, engine as tengine

pytestmark = pytest.mark.cuda

V, E, U = 66, 48, 96


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make_params(dev, qtype, head_qtype=None):
    """A small random GRU; the dense head may take another format than the
    cell (a mixed-format model rides the fused kernels' dense route)."""
    rng = np.random.default_rng(5)
    a = {"embeddings": rng.normal(0, 0.5, (V, E)),
         "kernel": rng.normal(0, 1 / np.sqrt(E), (E, 3 * U)),
         "recurrent_kernel": rng.normal(0, 1 / np.sqrt(U), (U, 3 * U)),
         "bias": rng.normal(0, 0.1, (2, 3 * U)),
         "dense_kernel": rng.normal(0, 3 / np.sqrt(U), (U, V)),
         "dense_bias": rng.normal(0, 0.1, (V,))}
    p = params_from_numpy({k: x.astype(np.float32) for k, x in a.items()}, qtype=qtype,
                          device=dev)
    if head_qtype:
        p.dense_kernel = quant.quantize(a["dense_kernel"].astype(np.float32), head_qtype,
                                        device=dev)
    return p


@pytest.fixture(scope="module")
def params(dev):
    return make_params(dev, "q8_0")


# the fused kernels' other weight routes: q4_0 decoded in the kernel; q5_1 and
# the q4_k cell + q8_0 head of the calibrated checkpoint as dense f32 planes
ROUTES = [("q4_0", None, "q4_0"), ("q5_1", None, "dense"), ("q4_k", "q8_0", "dense")]


@pytest.fixture(scope="module", params=ROUTES, ids=lambda r: f"{r[0]}+{r[1] or r[0]}")
def route_params(request, dev):
    qtype, head, mode = request.param
    p = make_params(dev, qtype, head)
    assert tf._prep_weights(p).mode == mode
    return p


@pytest.mark.parametrize("m,k,n", [(1, 1024, 1025), (5, 1030, 1100), (300, 1024, 3072)])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qtype", quant.QTYPES)
def test_qmatmul_kernel_matches_plain(dev, m, k, n, cd, qtype):
    rng = np.random.default_rng(m)
    # a positive offset gives the asymmetric formats real mins to add
    qt = quant.quantize((rng.normal(0, 0.1, (k, n)) + 0.05).astype(np.float32), qtype,
                        device=dev)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dev)
    before = qmm_launches[f"qmatmul_{qtype}"]
    got = qmatmul_cuda(x, qt, cd)
    assert qmm_launches[f"qmatmul_{qtype}"] == before + 1
    # the plain product before its output cast: the kernel returns f32
    want = torch.matmul(x.to(cd).float(), quant.dequantize(qt).to(cd).float())
    torch.cuda.synchronize()
    # the same f32 products (bf16 operands multiply exactly in f32), summed
    # in another order
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("cd,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_fused_decode_teacher_forced_matches_plain(dev, params, cd, tol):
    b, t = 300, 24
    ids = torch.randint(0, V, (b, t), dtype=torch.int32, device=dev)
    plen = torch.full((b,), t, dtype=torch.int32, device=dev)
    toks, h = tf.fused_gru_decode(params, ids, plen, t, compute_dtype=cd, return_state=True)
    z = torch.zeros(b, dtype=torch.int32, device=dev)
    ptoks, ph, _, _ = tf.gru_loop_reference(tf._prep_weights(params), ids, plen, plen, z, z,
                                            torch.zeros(b, U, device=dev), t, cd)
    torch.cuda.synchronize()
    assert torch.equal(toks, ptoks)
    assert float((h - ph).abs().max()) <= tol


def test_sampled_tick_matches_plain_until_near_ties(dev, params):
    n, inner = 64, 16
    st = tengine.init_state(params, n, 8)
    st = dataclasses.replace(
        st, prompt=torch.randint(0, V, (n, 8), dtype=torch.int32, device=dev),
        plen=torch.randint(1, 9, (n,), dtype=torch.int32, device=dev),
        total=torch.full((n,), 30, dtype=torch.int32, device=dev),
        temp=torch.linspace(0, 1.2, n, device=dev))
    kw = dict(seed=9, top_k=10, top_p=0.9)
    s_k, t_k = tf.fused_slot_tick(params, st, inner, compute_dtype=torch.float32,
                                  enable_sampling=True, **kw)
    t_p, _, _, pos_p, gaps = tf.gru_loop_reference(
        tf._prep_weights(params), st.prompt, st.plen, st.total, st.prev, st.pos, st.h, inner,
        torch.float32, temp=st.temp, margins=True, **kw)
    assert t_k.dtype == torch.uint8 and torch.equal(s_k.pos, pos_p)
    diff = t_k.int() != t_p
    for r in torch.nonzero(diff.any(1)).flatten().tolist():
        j = int(torch.nonzero(diff[r])[0])
        assert j > 0 and float(gaps[r, j - 1]) < 1e-3   # forks only at near-ties


def test_engine_fused_tick_equals_offline_decode(dev, params):
    rng = np.random.default_rng(2)
    work = [(rng.integers(0, V, int(rng.integers(1, 12))), int(rng.integers(0, 40)))
            for _ in range(40)]
    eng = DecodeEngine(params, n_slots=16, max_prompt=16, inner_steps=8,
                       compute_dtype=torch.bfloat16, use_fused_tick=True)
    tf.LAUNCHES["fused_slot_tick"] = 0
    reqs = [eng.submit(p, nt) for p, nt in work]
    eng.run_until_idle(timeout_s=120)
    assert tf.LAUNCHES["fused_slot_tick"] > 0
    ids = np.zeros((len(work), 16), np.int32)
    for i, (p, _) in enumerate(work):
        ids[i, :p.size] = p
    lens = np.array([p.size for p, _ in work], np.int32)
    offline = tf.fused_gru_decode(params, ids, lens, 16 + 40, compute_dtype=torch.bfloat16).cpu()
    for i, (r, (p, nt)) in enumerate(zip(reqs, work)):
        np.testing.assert_array_equal(r.result(timeout=1), offline[i, :p.size + nt].numpy())


@pytest.mark.parametrize("cd,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_fused_routes_teacher_forced_match_plain(dev, route_params, cd, tol):
    """Decode and one tick through the q4_0 and dense weight routes."""
    b, t = 200, 24
    ids = torch.randint(0, V, (b, t), dtype=torch.int32, device=dev)
    plen = torch.full((b,), t, dtype=torch.int32, device=dev)
    w = tf._prep_weights(route_params)
    z = torch.zeros(b, dtype=torch.int32, device=dev)
    h0 = torch.zeros(b, U, device=dev)
    toks, h = tf.fused_gru_decode(route_params, ids, plen, t, compute_dtype=cd,
                                  return_state=True)
    ptoks, ph, _, _ = tf.gru_loop_reference(w, ids, plen, plen, z, z, h0, t, cd)
    st = dataclasses.replace(tengine.init_state(route_params, b, t), prompt=ids, plen=plen,
                             total=plen)
    s_k, t_k = tf.fused_slot_tick(route_params, st, t, compute_dtype=cd)
    torch.cuda.synchronize()
    assert torch.equal(toks, ptoks) and torch.equal(t_k.int(), ptoks)
    assert float((h - ph).abs().max()) <= tol
    assert float((s_k.h - ph).abs().max()) <= tol


def test_tick_feeds_zero_past_the_prompt_buffer(dev, params):
    """A slot whose plen exceeds its prompt buffer feeds token 0 there, in
    the kernel as in the plain version."""
    n, p, inner = 40, 4, 10
    st = tengine.init_state(params, n, p)
    st = dataclasses.replace(
        st, prompt=torch.randint(1, V, (n, p), dtype=torch.int32, device=dev),
        plen=torch.full((n,), 7, dtype=torch.int32, device=dev),
        total=torch.full((n,), 9, dtype=torch.int32, device=dev))
    s_k, t_k = tf.fused_slot_tick(params, st, inner, compute_dtype=torch.float32)
    t_p, h_p, prev_p, pos_p = tf.gru_loop_reference(
        tf._prep_weights(params), st.prompt, st.plen, st.total, st.prev, st.pos, st.h, inner,
        torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(t_k.int()[:, :7], t_p[:, :7]) and not bool(t_p[:, 4:7].any())
    assert torch.equal(s_k.pos, pos_p)
    assert float((s_k.h - h_p).abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# the fused training pair (csrc/gru_train.cu)
# ---------------------------------------------------------------------------

def train_operands(dev, t, b, u, seed=0):
    """bf16 operands of the training scan and a cotangent, on the card."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    bf = torch.bfloat16
    mxs = (torch.randn((t, b, 3 * u), generator=g) * 0.8).to(bf).to(dev)
    h0 = (torch.randn((b, u), generator=g) * 0.3).to(bf).to(dev)
    wr = (torch.randn((u, 3 * u), generator=g) / np.sqrt(u)).to(bf).to(dev)
    brec = (torch.randn((3 * u,), generator=g) * 0.2).to(dev)
    dys = (torch.randn((t, b, u), generator=g) * 0.1).to(bf).to(dev)
    return mxs, h0, wr, brec, dys


def rel_max(got, want):
    return float((got.float() - want.float()).abs().max()) / (float(want.float().abs().max())
                                                              + 1e-12)


# B below one 16-row tile, ragged, and several tiles per warp; U with a ragged
# last 32-wide K step and a ragged last 16-row tile of the weight gradient
TRAIN_SHAPES = [(5, 6, 96), (7, 70, 104), (4, 300, 96), (3, 64, 1024)]


@pytest.mark.parametrize("t,b,u", TRAIN_SHAPES)
def test_train_forward_kernel_matches_plain(dev, t, b, u):
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    mxs, h0, wr, brec, _ = train_operands(dev, t, b, u)
    before = ft.LAUNCHES["fused_gru_train_fwd"]
    ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
    torch.cuda.synchronize()
    assert ft.LAUNCHES["fused_gru_train_fwd"] == before + 1
    pys, pmhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
    # the same roundings; the sums run in another order, so a value may land
    # on the neighbouring bf16 number and feed the later steps
    assert float((ys.float() - pys.float()).abs().max()) <= 2e-2
    assert float((mhs.float() - pmhs.float()).abs().max()) <= 4e-2
    assert float((ys.float() - pys.float()).abs().mean()) <= 2e-4


@pytest.mark.parametrize("t,b,u", TRAIN_SHAPES)
def test_train_backward_kernel_matches_plain_and_repeats_bit_equal(dev, t, b, u):
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    mxs, h0, wr, brec, dys = train_operands(dev, t, b, u)
    ys, mhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
    before = ft.LAUNCHES["fused_gru_train_bwd"]
    got = ft.gru_train_bwd_cuda(mxs, mhs, ys, dys, h0, wr)
    again = ft.gru_train_bwd_cuda(mxs, mhs, ys, dys, h0, wr)
    torch.cuda.synchronize()
    assert ft.LAUNCHES["fused_gru_train_bwd"] == before + 2
    want = ft.gru_train_bwd_plain(mxs, mhs, ys, dys, h0, wr)
    for name, g, w in zip(("dmxs", "dwr", "dbrec", "dh0"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        # same inputs, same roundings, other summation orders; a bf16 dmh on
        # a rounding boundary may land one step off and feed the carry
        assert rel_max(g, w) <= 1e-2, (name, rel_max(g, w))
    for name, g, a in zip(("dmxs", "dwr", "dbrec", "dh0"), got, again):
        assert torch.equal(g, a), f"{name}: two launches on the same inputs differ"


def test_train_scan_autograd_runs_the_kernels(dev):
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    mxs, h0, wr, brec, dys = train_operands(dev, 6, 40, 96)
    args = [mxs.clone().requires_grad_(), h0.clone().requires_grad_(),
            wr.float().requires_grad_(), brec.clone().requires_grad_()]
    launches, plain = dict(ft.LAUNCHES), dict(ft.PLAIN_CALLS)
    ys = ft.fused_gru_scan(*args)
    (ys.float() * dys.float()).sum().backward()
    torch.cuda.synchronize()
    assert ft.LAUNCHES == {k: v + 1 for k, v in launches.items()} and ft.PLAIN_CALLS == plain
    pargs = [a.detach().clone().requires_grad_() for a in args]
    pys = ft.fused_gru_scan_plain(*pargs)
    (pys.float() * dys.float()).sum().backward()
    assert float((ys.detach().float() - pys.detach().float()).abs().max()) <= 2e-2
    for a, p in zip(args, pargs):
        assert a.grad.dtype == a.dtype and rel_max(a.grad, p.grad) <= 1e-2


def test_train_kernels_name_the_shape_they_refuse(dev):
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    mxs, h0, wr, brec, dys = train_operands(dev, 2, 4, 100)     # U not a multiple of 8
    with pytest.raises(ValueError, match=r"\(2, 4, 100\)"):
        ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
    mxs, h0, wr, brec, dys = train_operands(dev, 1, 3000, 1024)  # staging past shared memory
    ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
    with pytest.raises(ValueError, match=r"\(1, 3000, 1024\)"):
        ft.gru_train_bwd_cuda(mxs, mhs, ys, dys, h0, wr)
    with pytest.raises(ValueError, match="contiguous"):
        ft.gru_train_fwd_cuda(mxs.float(), h0, wr, brec)
    # the largest batch whose staging fits 227 KB of shared memory at U=1024
    mxs, h0, wr, brec, dys = train_operands(dev, 2, 1760, 1024)
    ys, mhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
    got = ft.gru_train_bwd_cuda(mxs, mhs, ys, dys, h0, wr)
    want = ft.gru_train_bwd_plain(mxs, mhs, ys, dys, h0, wr)
    torch.cuda.synchronize()
    assert all(rel_max(g, w) <= 1e-2 for g, w in zip(got, want))
    mxs, h0, wr, brec, dys = train_operands(dev, 1, 1761, 1024)
    ys, mhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
    with pytest.raises(ValueError, match=r"\(1, 1761, 1024\)"):
        ft.gru_train_bwd_cuda(mxs, mhs, ys, dys, h0, wr)


# ---- the vision kernels: flash attention, the fused layer, the fused inverted residual

from ggml_experiments_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir  # noqa: E402
from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl  # noqa: E402


def _bf16_close(got, want, max_frac, mean_frac):
    """bf16 outputs: the two sides round at the same places but sum in other
    orders, so a value may land one bf16 step away and carry the difference
    on; max and mean error against the output's scale."""
    d = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    assert float(d.max()) <= max_frac * scale and float(d.mean()) <= mean_frac * scale, (
        float(d.max()), float(d.mean()), scale)


@pytest.mark.parametrize("bp,l,c,h", [(6, 32, 48, 4), (5, 256, 144, 4), (7, 64, 192, 4),
                                      (9, 16, 240, 4), (3, 24, 64, 2)])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_flash_mha_kernel_matches_plain(dev, bp, l, c, h, cd):
    g = torch.Generator(device=dev).manual_seed(l + c)
    q, k, v = (torch.randn((bp, l, c), generator=g, device=dev).to(cd) for _ in range(3))
    before = fa.LAUNCHES["flash_mha"]
    got = fa.flash_mha(q, k, v, h, compute_dtype=cd)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_mha"] == before + 1 and got.dtype == cd
    want = fa.flash_mha_plain(q, k, v, h)
    if cd == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    else:
        _bf16_close(got, want, 2 ** -6, 1e-3)


def _layer_ops(dev, c, h, f, cin, cout, final_ln, out_proj, seed):
    rng = np.random.default_rng(seed)

    def t(*s, bf=False, off=0.0):
        a = torch.from_numpy((rng.standard_normal(s) * 0.2 + off).astype(np.float32)).to(dev)
        return a.to(torch.bfloat16) if bf else a

    ops = ftl.LayerOperands(
        wq=t(c, c, bf=True), wk=t(c, c, bf=True), wv=t(c, c, bf=True), wo=t(c, c, bf=True),
        wi=t(c, f, bf=True), wo2=t(f, c, bf=True), ln1=(t(c, off=1.0), t(c)), bq=t(c),
        bk=t(c), bv=t(c), bo=t(c), ln2=(t(c, off=1.0), t(c)), bi=t(f), bo2=t(c),
        num_heads=h, eps=1e-5)
    if cin != c:
        ops.win = t(cin, c, bf=True)
    if final_ln:
        ops.final_ln, ops.final_eps = (t(c, off=1.0), t(c)), 1e-6
    if out_proj:
        ops.wout, ops.out_affine, ops.out_act = t(c, cout, bf=True), (t(cout, off=1.0),
                                                                     t(cout)), True
    return ops


@pytest.mark.parametrize("in_proj", [False, True])
@pytest.mark.parametrize("final_ln", [False, True])
@pytest.mark.parametrize("out_proj", [False, True])
@pytest.mark.parametrize("bp,l,c,h,f", [(3, 16, 48, 4, 96), (2, 24, 64, 2, 128)])
def test_fused_layer_kernel_matches_plain_every_flag(dev, in_proj, final_ln, out_proj, bp, l,
                                                     c, h, f):
    cin, cout = (c // 2 if in_proj else c), c // 2 + 8
    ops = _layer_ops(dev, c, h, f, cin, cout, final_ln, out_proj, seed=l + c)
    x = torch.randn((bp, l, cin), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    before = ftl.LAUNCHES["fused_transformer_layer"]
    got = ftl.fused_layer_cuda(x, ops)
    torch.cuda.synchronize()
    assert ftl.LAUNCHES["fused_transformer_layer"] == before + 1
    _bf16_close(got, ftl.fused_transformer_layer_plain(x, ops), 0.05, 2e-3)


@pytest.mark.parametrize("bp,l,c,h,f,cin", [(4, 256, 144, 4, 288, 96), (6, 64, 192, 4, 384, 192),
                                            (8, 16, 240, 4, 480, 240)])
def test_fused_layer_kernel_matches_plain_at_the_model_widths(dev, bp, l, c, h, f, cin):
    ops = _layer_ops(dev, c, h, f, cin, cin, True, cin != c, seed=c)
    x = torch.randn((bp, l, cin), generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev).to(torch.bfloat16)
    got = ftl.fused_layer_cuda(x, ops)
    torch.cuda.synchronize()
    _bf16_close(got, ftl.fused_transformer_layer_plain(x, ops), 0.05, 2e-3)


@pytest.mark.parametrize("b,hh,ww,c,e,cout,resid", [(2, 64, 64, 64, 256, 64, True),
                                                   (3, 12, 10, 8, 32, 16, False),
                                                   (1, 9, 17, 24, 96, 24, True)])
def test_fused_inverted_residual_kernel_matches_plain(dev, b, hh, ww, c, e, cout, resid):
    rng = np.random.default_rng(e)

    def t(*s, scale=0.2):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(dev)

    args = (t(c, e), t(e), t(3, 3, e), t(e), t(e, cout), t(cout))
    x = t(b, hh, ww, c, scale=1.0).to(torch.bfloat16)
    before = fir.LAUNCHES["fused_inverted_residual"]
    got = fir.fused_inverted_residual(x, *args, use_residual=resid)
    torch.cuda.synchronize()
    assert fir.LAUNCHES["fused_inverted_residual"] == before + 1
    want = fir.fused_ir_plain(x, args[0].to(torch.bfloat16), args[1], args[2], args[3],
                              args[4].to(torch.bfloat16), args[5], use_residual=resid)
    _bf16_close(got, want, 2 ** -6, 1e-4)


def test_vision_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((2, 8, 8, 8), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((8, 32), device=dev)
    with pytest.raises(ValueError, match="stride"):
        fir.fused_inverted_residual(x, w, w[0], torch.zeros(3, 3, 32, device=dev), w[0],
                                    w.t(), w[:, 0], stride=2)
    q = torch.zeros((2, 16, 72), device=dev)
    with pytest.raises(ValueError, match="head width"):
        fa.flash_mha(q, q, q, 1, compute_dtype=torch.float32)
