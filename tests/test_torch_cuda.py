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


_QT_CACHE = {}


def qweight(dev, qtype, k, n):
    """A seeded (k, n) weight under ``qtype``, quantized once per module; a
    positive offset gives the asymmetric formats real mins to add."""
    key = (qtype, k, n)
    if key not in _QT_CACHE:
        rng = np.random.default_rng(k + n)
        _QT_CACHE[key] = quant.quantize((rng.normal(0, 0.1, (k, n)) + 0.05).astype(np.float32),
                                        qtype, device=dev)
    return _QT_CACHE[key]


def xrand(dev, m, k):
    """A seeded f32 (m, k) activation on the card."""
    return torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32)).to(dev)


def qmatmul_plain_f32(x, qt, cd):
    """The plain product before its output cast: bf16 operands (whose
    products are exact in f32) or f32 ones, f32 sums; the kernel returns f32."""
    return torch.matmul(x.to(cd).float(), quant.dequantize(qt).to(cd).float())


# M of one row, the main path's 64, one past a 64-row tile, several 128-row
# tiles and the reference's 1024; ragged N (1025, 1100) and K (1030)
QMM_SHAPES = [(1, 1024, 1025), (5, 1030, 1100), (64, 1024, 3072), (65, 1030, 1100),
              (300, 1024, 3072), (1024, 1024, 3072), (64, 1030, 1025)]


@pytest.mark.parametrize("m,k,n", QMM_SHAPES)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qtype", quant.QTYPES)
def test_qmatmul_kernel_matches_plain(dev, m, k, n, cd, qtype):
    qt = qweight(dev, qtype, k, n)
    x = xrand(dev, m, k)
    before = qmm_launches[f"qmatmul_{qtype}"]
    got = qmatmul_cuda(x, qt, cd)
    assert qmm_launches[f"qmatmul_{qtype}"] == before + 1
    want = qmatmul_plain_f32(x, qt, cd)
    torch.cuda.synchronize()
    # the same f32 products (bf16 operands multiply exactly in f32; f32 ones
    # as 3xTF32), summed in another order
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# every tile height with and without a split of K, and splits the default
# configuration does not pick: (M, bm, ksplit, blocks per split) at K = 1024
QMM_CONFIGS = [(64, 128, 1, 32), (64, 64, 1, 32), (64, 64, 3, 11), (300, 128, 2, 16),
               (300, 64, 8, 4), (1024, 128, 4, 8), (5, 64, 5, 7)]


@pytest.mark.parametrize("m,bm,ksplit,bps", QMM_CONFIGS)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qtype", ["q8_0", "q5_1", "q4_k"])
def test_qmatmul_kernel_every_launch_config(dev, m, bm, ksplit, bps, cd, qtype):
    qt = qweight(dev, qtype, 1024, 1100)
    x = xrand(dev, m, 1024)
    got = qmatmul_cuda(x, qt, cd, config=(bm, ksplit, bps))
    want = qmatmul_plain_f32(x, qt, cd)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("m", [64, 1024])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qtype", quant.QTYPES)
def test_qmatmul_kernel_repeats_bit_equal(dev, m, cd, qtype):
    """Split-K partial tiles are summed in a fixed order: two launches on the
    same inputs give the same bits."""
    qt = qweight(dev, qtype, 1024, 3072)
    x = xrand(dev, m, 1024)
    a, b = qmatmul_cuda(x, qt, cd), qmatmul_cuda(x, qt, cd)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("m", [5, 64, 300])
@pytest.mark.parametrize("qtype", quant.QTYPES)
def test_qmatmul_kernel_takes_bf16_x(dev, m, qtype):
    """At bf16, x that arrives in bf16 is staged as it is (no widening pass)."""
    qt = qweight(dev, qtype, 1024, 1100)
    x = xrand(dev, m, 1024).to(torch.bfloat16)
    got = qmatmul_cuda(x, qt, torch.bfloat16)
    want = qmatmul_plain_f32(x, qt, torch.bfloat16)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_qmatmul_kernel_refuses_a_bad_config(dev):
    qt = qweight(dev, "q8_0", 1024, 1100)
    x = torch.zeros((64, 1024), device=dev)
    for config in ((64, 9, 4), (64, 2, 8), (96, 1, 32), (64, 1, 31)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            qmatmul_cuda(x, qt, config=config)


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


# ---- every plan of the persistent kernel, forced through config=: the
# slot-owned loop (bf16) and the unit-owned one (bf16 and f32), at batches of
# one slot, ragged tiles and several waves; U=96 leaves a ragged 64-unit pass
# and a ragged 64-wide K chunk

BF16_PLANS = [("unit",), ("slot", 3), ("slot", 4)]
PLAN_CASES = [(p, torch.bfloat16) for p in BF16_PLANS] + [(("unit",), torch.float32)]
PLAN_BATCHES = [1, 31, 129, 512, 2048, 4100]


def _plan_id(case):
    plan, cd = case
    return "-".join(str(x) for x in plan) + f"-{str(cd)[6:]}"


def _slot_inputs(dev, b, t, p, seed, plen=None, total=None, temp=None):
    g = torch.Generator(device="cpu").manual_seed(seed)
    prompt = torch.randint(0, V, (b, p), generator=g, dtype=torch.int32).to(dev)
    plen = torch.full((b,), t, dtype=torch.int32, device=dev) if plen is None else plen
    total = plen.clone() if total is None else total
    z = torch.zeros(b, dtype=torch.int32, device=dev)
    return prompt, plen, total, z, z.clone(), torch.zeros(b, U, device=dev)


def _run_twice(entry, w, args, steps, cd, **kw):
    """Two launches on the same inputs: they must give the same bits."""
    got = tf.gru_loop_cuda(entry, w, *args, steps, cd, **kw)
    again = tf.gru_loop_cuda(entry, w, *args, steps, cd, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    return got


@pytest.mark.parametrize("b", PLAN_BATCHES)
@pytest.mark.parametrize("case", PLAN_CASES, ids=_plan_id)
def test_every_plan_teacher_forced_matches_plain(dev, params, case, b):
    plan, cd = case
    t = 10
    w = tf._prep_weights(params)
    args = _slot_inputs(dev, b, t, t, seed=b)
    toks, h, prev, pos = _run_twice("fused_gru_decode", w, args, t, cd, config=plan)
    assert tf.LAST_PLAN["fused_gru_decode"] == tf.DecodePlan(*plan)
    ptoks, ph, pprev, ppos = tf.gru_loop_reference(w, *args, t, cd)
    assert torch.equal(toks, ptoks) and torch.equal(pos, ppos)
    assert float((h - ph).abs().max()) <= (1e-5 if cd == torch.float32 else 2e-2)


@pytest.mark.parametrize("b", PLAN_BATCHES)
@pytest.mark.parametrize("case", PLAN_CASES, ids=_plan_id)
def test_every_plan_sampled_tick_matches_plain_until_near_ties(dev, params, case, b):
    plan, cd = case
    inner = 12
    w = tf._prep_weights(params)
    g = torch.Generator(device="cpu").manual_seed(b)
    plen = torch.randint(1, 9, (b,), generator=g, dtype=torch.int32).to(dev)
    total = torch.randint(4, 30, (b,), generator=g, dtype=torch.int32).to(dev)
    args = _slot_inputs(dev, b, inner, 8, seed=b + 1, plen=plen, total=total)
    temp = torch.linspace(0, 1.2, b, device=dev)
    kw = dict(temp=temp, seed=9, top_k=10, top_p=0.9)
    toks, h, prev, pos = _run_twice("fused_slot_tick", w, args, inner, cd, config=plan,
                                    toks_u8=True, **kw)
    t_p, _, _, pos_p, gaps = tf.gru_loop_reference(w, *args, inner, cd, margins=True, **kw)
    assert toks.dtype == torch.uint8 and torch.equal(pos, pos_p)
    tol = 1e-3 if cd == torch.float32 else 0.1
    diff = toks.int() != t_p
    for r in torch.nonzero(diff.any(1)).flatten().tolist():
        j = int(torch.nonzero(diff[r])[0])
        assert j > 0 and float(gaps[r, j - 1]) < tol   # forks only at near-ties


@pytest.mark.parametrize("key_tile", [0, 64])
@pytest.mark.parametrize("case", PLAN_CASES, ids=_plan_id)
def test_block_keyed_sampled_tick_matches_plain(dev, params, case, key_tile):
    """The sampled tick keyed as a shard whose column 0 is global slot 256
    (one block, or blocks of 64 columns) against its plain version with the
    same keys, two launches bit-equal; the keys reach the noise (the stream
    differs from the unkeyed one's)."""
    plan, cd = case
    b, inner = 256, 12
    w = tf._prep_weights(params)
    g = torch.Generator(device="cpu").manual_seed(7)
    plen = torch.randint(1, 9, (b,), generator=g, dtype=torch.int32).to(dev)
    args = _slot_inputs(dev, b, inner, 8, seed=8, plen=plen,
                        total=torch.full((b,), 30, dtype=torch.int32, device=dev))
    kw = dict(temp=torch.full((b,), 0.9, device=dev), seed=9, top_k=10, top_p=0.9)
    keys = dict(slot_base=256, key_tile=key_tile)
    toks, h, prev, pos = _run_twice("fused_slot_tick", w, args, inner, cd, config=plan,
                                    toks_u8=True, **kw, **keys)
    t_p, _, _, pos_p, gaps = tf.gru_loop_reference(w, *args, inner, cd, margins=True, **kw,
                                                   **keys)
    assert torch.equal(pos, pos_p)
    tol = 1e-3 if cd == torch.float32 else 0.1
    diff = toks.int() != t_p
    for r in torch.nonzero(diff.any(1)).flatten().tolist():
        j = int(torch.nonzero(diff[r])[0])
        assert j > 0 and float(gaps[r, j - 1]) < tol   # forks only at near-ties
    unkeyed = tf.gru_loop_cuda("fused_slot_tick", w, *args, inner, cd, config=plan,
                               toks_u8=True, **kw)[0]
    assert (unkeyed != toks).float().mean() > 0.5


@pytest.mark.parametrize("case", PLAN_CASES, ids=_plan_id)
def test_greedy_tick_ignores_the_keys(dev, params, case):
    """Greedy slots draw no noise: a tick keyed as any shard gives the bits
    of the unkeyed tick (the parent's keying)."""
    plan, cd = case
    b, inner = 256, 12
    w = tf._prep_weights(params)
    args = _slot_inputs(dev, b, inner, 8, seed=3,
                        total=torch.full((b,), 30, dtype=torch.int32, device=dev))
    kw = dict(temp=torch.zeros((b,), device=dev), seed=9, top_k=10, top_p=0.9)
    want = tf.gru_loop_cuda("fused_slot_tick", w, *args, inner, cd, config=plan, **kw)
    got = tf.gru_loop_cuda("fused_slot_tick", w, *args, inner, cd, config=plan, **kw,
                           slot_base=384, key_tile=64)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("b", PLAN_BATCHES)
@pytest.mark.parametrize("case", PLAN_CASES, ids=_plan_id)
def test_every_plan_on_each_weight_route(dev, route_params, case, b):
    plan, cd = case
    t = 12
    w = tf._prep_weights(route_params)
    args = _slot_inputs(dev, b, t, t, seed=3)
    toks, h, _, pos = _run_twice("fused_slot_tick", w, args, t, cd, config=plan)
    ptoks, ph, _, ppos = tf.gru_loop_reference(w, *args, t, cd)
    assert torch.equal(toks, ptoks) and torch.equal(pos, ppos)
    assert float((h - ph).abs().max()) <= (1e-5 if cd == torch.float32 else 2e-2)


@pytest.mark.parametrize("case", PLAN_CASES, ids=_plan_id)
def test_every_plan_feeds_zero_past_the_prompt_buffer(dev, params, case):
    plan, cd = case
    n, p, inner = 40, 4, 10
    w = tf._prep_weights(params)
    args = _slot_inputs(dev, n, inner, p, seed=4,
                        plen=torch.full((n,), 7, dtype=torch.int32, device=dev),
                        total=torch.full((n,), 9, dtype=torch.int32, device=dev))
    toks, h, _, pos = _run_twice("fused_slot_tick", w, args, inner, cd, config=plan)
    t_p, h_p, _, pos_p = tf.gru_loop_reference(w, *args, inner, cd)
    assert torch.equal(toks[:, :7], t_p[:, :7]) and not bool(t_p[:, 4:7].any())
    assert torch.equal(pos, pos_p)
    if cd == torch.float32:
        assert float((h - h_p).abs().max()) <= 1e-5


def test_plans_the_kernel_does_not_take_are_refused(dev, params):
    w = tf._prep_weights(params)
    args = _slot_inputs(dev, 8, 4, 4, seed=5)
    for plan, cd in ((("slot", 3), torch.float32), (("slot", 6), torch.bfloat16),
                     (("unit", 3), torch.bfloat16), (("slot",), torch.bfloat16),
                     (("diag",), torch.float32)):
        with pytest.raises(ValueError, match="no plan"):
            tf.gru_loop_cuda("fused_gru_decode", w, *args, 4, cd, config=plan)


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
    before = dict(ft.LAUNCHES)
    got = ft.gru_train_bwd_cuda(mxs, mhs, ys, dys, h0, wr)
    again = ft.gru_train_bwd_cuda(mxs, mhs, ys, dys, h0, wr)
    torch.cuda.synchronize()
    assert ft.LAUNCHES["fused_gru_train_bwd"] == before["fused_gru_train_bwd"] + 2
    assert ft.LAUNCHES["fused_gru_train_dwr"] == before["fused_gru_train_dwr"] + 2
    want = ft.gru_train_bwd_plain(mxs, mhs, ys, dys, h0, wr)
    for name, g, w in zip(("dmxs", "dwr", "dbrec", "dh0"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        # same inputs, same roundings, other summation orders; a bf16 dmh on
        # a rounding boundary may land one step off and feed the carry
        assert rel_max(g, w) <= 1e-2, (name, rel_max(g, w))
    for name, g, a in zip(("dmxs", "dwr", "dbrec", "dh0"), got, again):
        assert torch.equal(g, a), f"{name}: two launches on the same inputs differ"


@pytest.mark.parametrize("t,b,u", TRAIN_SHAPES + [(2, 200, 1024)])
def test_train_dwr_kernel_matches_plain(dev, t, b, u):
    """The dWr GEMM on the recurrence's stored operands: the same bf16
    products, f32 sums in another order over K = T*B terms."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    mxs, h0, wr, brec, dys = train_operands(dev, t, b, u)
    ys, mhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
    dmxs, plane, _, _ = ft.gru_train_bwd_rec_plain(mxs, mhs, ys, dys, h0, wr)
    got = ft.gru_train_dwr_cuda(h0, ys, dmxs, plane)
    again = ft.gru_train_dwr_cuda(h0, ys, dmxs, plane)
    torch.cuda.synchronize()
    want = ft.gru_train_dwr_plain(h0, ys, dmxs, plane)
    assert torch.equal(got, again)
    assert rel_max(got, want) <= 1e-5, rel_max(got, want)


@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("b", [1, 64, 1024, 1761, 3000])
def test_train_every_plan_matches_plain_and_repeats_bit_equal(dev, t, b):
    """Each plan the kernels take at U = 1024, forced: forward and backward
    against the plain versions at the limits above, two launches bit-equal."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    u = 1024
    mxs, h0, wr, brec, dys = train_operands(dev, t, b, u)
    pys, pmhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
    want = ft.gru_train_bwd_plain(mxs, pmhs, pys, dys, h0, wr)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = ft.train_plans(b, u, sms)
    assert ft.train_plan(b, u, sms) in plans and len(plans) >= 3
    for plan in plans:
        ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=plan)
        ys2, mhs2 = ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=plan)
        assert ft.LAST_PLAN["fused_gru_train_fwd"] == plan
        got = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr, config=plan)
        again = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr, config=plan)
        torch.cuda.synchronize()
        assert torch.equal(ys, ys2) and torch.equal(mhs, mhs2), plan
        assert float((ys.float() - pys.float()).abs().max()) <= 2e-2, plan
        assert float((mhs.float() - pmhs.float()).abs().max()) <= 4e-2, plan
        assert float((ys.float() - pys.float()).abs().mean()) <= 2e-4, plan
        for name, g, a, w in zip(("dmxs", "dwr", "dbrec", "dh0"), got, again, want):
            assert torch.equal(g, a), (plan, name)
            assert rel_max(g, w) <= 1e-2, (plan, name, rel_max(g, w))


def test_train_scan_autograd_runs_the_kernels(dev):
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    mxs, h0, wr, brec, dys = train_operands(dev, 6, 40, 96)
    args = [mxs.clone().requires_grad_(), h0.clone().requires_grad_(),
            wr.float().requires_grad_(), brec.clone().requires_grad_()]
    launches, plain = dict(ft.LAUNCHES), dict(ft.PLAIN_CALLS)
    ys = ft.fused_gru_scan(*args)
    (ys.float() * dys.float()).sum().backward()
    torch.cuda.synchronize()
    # one forward, one backward recurrence and one dWr launch
    assert ft.LAUNCHES == {k: v + 1 for k, v in launches.items()} and ft.PLAIN_CALLS == plain
    assert set(ft.LAUNCHES) == {"fused_gru_train_fwd", "fused_gru_train_bwd",
                                "fused_gru_train_dwr"}
    pargs = [a.detach().clone().requires_grad_() for a in args]
    pys = ft.fused_gru_scan_plain(*pargs)
    (pys.float() * dys.float()).sum().backward()
    assert float((ys.detach().float() - pys.detach().float()).abs().max()) <= 2e-2
    for a, p in zip(args, pargs):
        assert a.grad.dtype == a.dtype and rel_max(a.grad, p.grad) <= 1e-2


def test_train_kernels_name_the_shape_they_refuse(dev):
    """U off the 8-unit grid and a plan the kernels do not take are refused,
    naming the shape; B = 3000 runs in one launch of each kernel and matches
    the plain version with two runs bit-equal."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    mxs, h0, wr, brec, dys = train_operands(dev, 2, 4, 100)     # U not a multiple of 8
    with pytest.raises(ValueError, match=r"\(2, 4, 100\)"):
        ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
    with pytest.raises(ValueError, match=r"\(2, 4, 100\)"):
        ft.gru_train_bwd_cuda(mxs, mxs, h0[None].expand(2, 4, 100).contiguous(),
                              h0[None].expand(2, 4, 100).contiguous(), h0, wr)
    with pytest.raises(ValueError, match="contiguous"):
        ft.gru_train_fwd_cuda(mxs.float(), h0, wr, brec)
    mxs, h0, wr, brec, dys = train_operands(dev, 1, 64, 1024)
    with pytest.raises(ValueError, match=r"\(1, 64, 1024\)"):
        ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=(32, 2))    # an empty row tile
    mxs, h0, wr, brec, dys = train_operands(dev, 1, 3000, 1024)
    ys, mhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
    before = dict(ft.LAUNCHES)
    got = ft.gru_train_bwd_cuda(mxs, mhs, ys, dys, h0, wr)
    assert ft.LAUNCHES["fused_gru_train_bwd"] == before["fused_gru_train_bwd"] + 1
    assert ft.LAUNCHES["fused_gru_train_dwr"] == before["fused_gru_train_dwr"] + 1
    again = ft.gru_train_bwd_cuda(mxs, mhs, ys, dys, h0, wr)
    want = ft.gru_train_bwd_plain(mxs, mhs, ys, dys, h0, wr)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert all(rel_max(g, w) <= 1e-2 for g, w in zip(got, want))


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
    again = fa.flash_mha(q, k, v, h, compute_dtype=cd)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_mha"] == before + 2 and got.dtype == cd
    assert torch.equal(got, again), "two launches on the same inputs differ"
    want = fa.flash_mha_plain(q, k, v, h)
    if cd == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    else:
        _bf16_close(got, want, 2 ** -6, 1e-3)


# head widths that are not a multiple of 4 (element-wise staging), a ragged
# L over several blocks a pair, a single key
@pytest.mark.parametrize("bp,l,c,h", [(2, 20, 30, 2), (4, 300, 120, 2), (3, 1, 64, 4),
                                      (2, 130, 28, 4)])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_flash_mha_kernel_odd_shapes(dev, bp, l, c, h, cd):
    g = torch.Generator(device=dev).manual_seed(l * c)
    q, k, v = (torch.randn((bp, l, c), generator=g, device=dev).to(cd) for _ in range(3))
    got = fa.flash_mha(q, k, v, h, compute_dtype=cd)
    torch.cuda.synchronize()
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
    before = dict(ftl.LAUNCHES)
    got = ftl.fused_layer_cuda(x, ops)
    torch.cuda.synchronize()
    assert {k: ftl.LAUNCHES[k] - before[k] for k in before} == {
        "fused_transformer_layer": 1, "transformer_ln_qkv": 1, "transformer_attention": 1,
        "transformer_proj_ffn": 1, "transformer_sequence": 0}
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


def _layer_kernels_check(dev, bp, l, c, h, f, cin, cout, final_ln, out_proj, seed):
    """Each of the layer's three kernels against its plain version on the plain
    version's inputs, launched twice (bit-equal), with the counters."""
    ops = _layer_ops(dev, c, h, f, cin, cout, final_ln, out_proj, seed=seed)
    x2 = torch.randn((bp * l, cin), generator=torch.Generator(device=dev).manual_seed(3),
                     device=dev).to(torch.bfloat16)
    before = dict(ftl.LAUNCHES)
    qkv, qkv2 = (ftl.ln_qkv_cuda(x2, ops, l) for _ in range(2))
    want_qkv = ftl.ln_qkv_plain(x2, ops)
    ctx, ctx2 = (ftl.attention_cuda(want_qkv, l, ops) for _ in range(2))
    want_ctx = ftl.attention_plain(want_qkv, l, ops)
    out, out2 = (ftl.proj_ffn_cuda(x2, want_ctx, ops, l) for _ in range(2))
    torch.cuda.synchronize()
    after = dict(ftl.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        "fused_transformer_layer": 0, "transformer_ln_qkv": 2, "transformer_attention": 2,
        "transformer_proj_ffn": 2, "transformer_sequence": 0}
    assert torch.equal(qkv, qkv2) and torch.equal(ctx, ctx2) and torch.equal(out, out2), (
        "two launches on the same inputs differ")
    dh = c // h
    assert not qkv.reshape(bp * l, 3, h, -1)[..., dh:].any(), "a head's padding is not zero"
    _bf16_close(qkv, want_qkv, 0.05, 2e-3)
    _bf16_close(ctx, want_ctx, 0.05, 2e-3)
    _bf16_close(out, ftl.proj_ffn_plain(x2, want_ctx, ops), 0.05, 2e-3)


# every flag; dh = 12 and 32; L = 24 (two sequences a packed tile), 16, 72 (a
# ragged second tile), 320 (past the scores held in registers: keys walked twice)
@pytest.mark.parametrize("in_proj", [False, True])
@pytest.mark.parametrize("final_ln", [False, True])
@pytest.mark.parametrize("out_proj", [False, True])
@pytest.mark.parametrize("bp,l,c,h,f", [(3, 16, 48, 4, 96), (2, 24, 64, 2, 128),
                                        (5, 24, 24, 2, 48), (2, 72, 96, 3, 192),
                                        (2, 320, 64, 2, 128)])
def test_layer_kernels_match_their_plain_versions_every_flag(dev, in_proj, final_ln, out_proj,
                                                             bp, l, c, h, f):
    _layer_kernels_check(dev, bp, l, c, h, f, c // 2 if in_proj else c, c // 2 + 8, final_ln,
                         out_proj, seed=l + c)


# the model's widths (dh = 36, 48, 60) with the first layer's and the last
# layer's flags; 72 sequences of 256 fill an H100's multiprocessors with
# 128-row tiles (two consumer warpgroups a block), the others take 64 rows
@pytest.mark.parametrize("bp,l,c,h,f,cin,cout", [(4, 256, 144, 4, 288, 96, 96),
                                                 (6, 64, 192, 4, 384, 128, 128),
                                                 (8, 16, 240, 4, 480, 160, 160),
                                                 (72, 256, 144, 4, 288, 96, 96)])
@pytest.mark.parametrize("last", [False, True])
def test_layer_kernels_match_their_plain_versions_at_the_model_widths(dev, bp, l, c, h, f, cin,
                                                                      cout, last):
    _layer_kernels_check(dev, bp, l, c, h, f, c if last else cin, cout, last, last, seed=c)


# an output projection wider than C: out-projection groups before the last
# go out from registers, the last through shared memory; an odd Cout pads
# the output rows
def test_layer_kernels_take_an_output_wider_than_c(dev):
    _layer_kernels_check(dev, 3, 16, 48, 4, 96, 48, 101, True, True, seed=9)


def test_layer_kernel_ring_depths_give_the_same_bits(dev):
    ops = _layer_ops(dev, 144, 4, 288, 96, 96, True, True, seed=5)
    x = torch.randn((3, 256, 96), generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev).to(torch.bfloat16)
    # at C=144 proj_ffn overlaps FFN chunks and holds kc + 1 = 4 tiles: 5 buffers at least
    outs = [ftl.fused_layer_cuda(x, ops, _plan=s) for s in (None, (2, 5), (3, 6), (6, 5))]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    # the default plan: the least each ring runs (ln_qkv 2, the overlapped FFN kc + 2)
    ftl.fused_layer_cuda(x, ops)
    assert ops.cache[x.device].stages == (2, 5)
    for bad in ((1, 5), (4, 4)):
        with pytest.raises(ValueError, match="ring depths"):
            ftl.fused_layer_cuda(x, ops, _plan=bad)


def test_layer_kernels_refuse_what_they_do_not_take(dev):
    # C = 320 is past the row-tile kernels (x1 in registers): their wrappers
    # refuse it, the layer runs on the per-sequence kernel
    ops = _layer_ops(dev, 320, 5, 640, 320, 320, False, False, seed=1)
    with pytest.raises(ValueError, match="C up to 288"):
        ftl.ln_qkv_cuda(torch.zeros((16, 320), dtype=torch.bfloat16, device=dev), ops, 16)
    ops = _layer_ops(dev, 128, 1, 256, 128, 128, False, False, seed=1)
    with pytest.raises(ValueError, match="head width up to 64"):
        ftl.fused_layer_cuda(torch.zeros((1, 16, 128), dtype=torch.bfloat16, device=dev), ops)
    ops = _layer_ops(dev, 64, 2, 128, 64, 64, False, False, seed=1)
    with pytest.raises(ValueError, match="multiple of 8"):
        ftl.fused_layer_cuda(torch.zeros((1, 20, 64), dtype=torch.bfloat16, device=dev), ops)
    # a sequence whose k and v outgrow shared memory even on the per-sequence kernel
    with pytest.raises(ValueError, match="shared memory"):
        ftl.fused_layer_cuda(torch.zeros((1, 1024, 64), dtype=torch.bfloat16, device=dev), ops)


# what the row-tile kernels do not take goes to the per-sequence kernel: C past
# 288, L past 576; no flag and every flag
@pytest.mark.parametrize("flags", [(False, False, False), (True, True, True)])
@pytest.mark.parametrize("bp,l,c,h,f", [(3, 16, 320, 5, 640), (2, 48, 384, 6, 768),
                                        (2, 640, 64, 2, 128)])
def test_fused_layer_takes_what_the_row_tile_kernels_do_not(dev, flags, bp, l, c, h, f):
    in_proj, final_ln, out_proj = flags
    cin, cout = (c // 2 if in_proj else c), c // 2 + 8
    ops = _layer_ops(dev, c, h, f, cin, cout, final_ln, out_proj, seed=l + c)
    x = torch.randn((bp, l, cin), generator=torch.Generator(device=dev).manual_seed(6),
                    device=dev).to(torch.bfloat16)
    before = dict(ftl.LAUNCHES)
    got, again = ftl.fused_layer_cuda(x, ops), ftl.fused_layer_cuda(x, ops)
    torch.cuda.synchronize()
    after = dict(ftl.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        "fused_transformer_layer": 2, "transformer_ln_qkv": 0, "transformer_attention": 0,
        "transformer_proj_ffn": 0, "transformer_sequence": 2}
    assert torch.equal(got, again), "two launches on the same inputs differ"
    _bf16_close(got, ftl.fused_transformer_layer_plain(x, ops), 0.05, 2e-3)


# the per-sequence kernel on shapes the row-tile kernels also take, every flag
@pytest.mark.parametrize("in_proj", [False, True])
@pytest.mark.parametrize("final_ln", [False, True])
@pytest.mark.parametrize("out_proj", [False, True])
@pytest.mark.parametrize("bp,l,c,h,f", [(3, 16, 48, 4, 96), (2, 24, 60, 5, 120)])
def test_sequence_kernel_matches_plain_every_flag(dev, in_proj, final_ln, out_proj, bp, l, c,
                                                  h, f):
    cin, cout = (c // 2 if in_proj else c), c // 2 + 8
    ops = _layer_ops(dev, c, h, f, cin, cout, final_ln, out_proj, seed=l + c)
    x = torch.randn((bp, l, cin), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    got = ftl.sequence_layer_cuda(x, ops)
    torch.cuda.synchronize()
    _bf16_close(got, ftl.fused_transformer_layer_plain(x, ops), 0.05, 2e-3)


def _ir_inputs(dev, b, hh, ww, c, e, cout):
    rng = np.random.default_rng(e)

    def t(*s, scale=0.2):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(dev)

    args = (t(c, e), t(e), t(3, 3, e), t(e), t(e, cout), t(cout))
    return t(b, hh, ww, c, scale=1.0).to(torch.bfloat16), args


# the strip kernel at the main path's shape (small B), ragged strips (W not a
# multiple of 32 or 16), ragged bands (odd H), B = 1, H or W of 1 and 2, C =
# 8 / 16 / 24, Cout past or short of 64; then shapes that the strip kernel
# does not take (C not a multiple of 8, E > 256), which run on the tile kernel
IR_SHAPES = [(2, 64, 64, 64, 256, 64, True), (3, 12, 10, 8, 32, 16, False),
             (1, 9, 17, 24, 96, 24, True), (1, 1, 1, 8, 32, 8, True), (1, 2, 2, 8, 64, 8, True),
             (2, 1, 40, 16, 64, 16, True), (1, 37, 2, 24, 96, 24, False),
             (2, 5, 33, 64, 256, 64, True), (1, 7, 65, 32, 128, 72, False),
             (2, 3, 47, 16, 256, 32, False), (1, 9, 17, 12, 48, 12, True),
             (2, 10, 11, 64, 384, 64, True)]


@pytest.mark.parametrize("b,hh,ww,c,e,cout,resid", IR_SHAPES)
def test_fused_inverted_residual_kernel_matches_plain(dev, b, hh, ww, c, e, cout, resid):
    x, args = _ir_inputs(dev, b, hh, ww, c, e, cout)
    before = dict(fir.LAUNCHES)
    got = fir.fused_inverted_residual(x, *args, use_residual=resid)
    torch.cuda.synchronize()
    tile = not fir.ir_plans(c, e, cout)
    assert fir.LAUNCHES["fused_inverted_residual"] == before["fused_inverted_residual"] + 1
    assert fir.LAUNCHES["inverted_residual_tile"] == before["inverted_residual_tile"] + tile
    want = fir.fused_ir_plain(x, args[0].to(torch.bfloat16), args[1], args[2], args[3],
                              args[4].to(torch.bfloat16), args[5], use_residual=resid)
    _bf16_close(got, want, 2 ** -6, 1e-4)


@pytest.mark.parametrize("b,hh,ww,c,e,cout,resid", [(2, 21, 45, 64, 256, 64, True),
                                                   (1, 7, 33, 16, 64, 32, False),
                                                   (1, 5, 9, 24, 96, 24, True)])
def test_inverted_residual_plans_give_the_same_bits(dev, b, hh, ww, c, e, cout, resid):
    """Every plan the strip kernel takes gives the default plan's bits, and
    two launches of one plan are bit-equal."""
    x, args = _ir_inputs(dev, b, hh, ww, c, e, cout)
    ops = fir.ir_operands(*args)
    want = fir.fused_ir_cuda(x, ops, use_residual=resid)
    again = fir.fused_ir_cuda(x, ops, use_residual=resid)
    torch.cuda.synchronize()
    assert torch.equal(want, again)
    plans = fir.ir_plans(c, e, cout)
    assert len(plans) >= 4
    for plan in plans:
        got = fir.fused_ir_cuda(x, ops, use_residual=resid, _plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), plan


def test_inverted_residual_tile_route_takes_no_plan(dev):
    x, args = _ir_inputs(dev, 1, 9, 17, 12, 48, 12)
    with pytest.raises(ValueError, match="takes no plan"):
        fir.fused_ir_cuda(x, fir.ir_operands(*args), _plan=fir.IRPlan(32, 2))
    x, args = _ir_inputs(dev, 1, 9, 17, 64, 256, 64)
    with pytest.raises(ValueError, match="does not take"):
        fir.fused_ir_cuda(x, fir.ir_operands(*args), _plan=fir.IRPlan(64, 3))


def test_inverted_residual_refuses_f32_and_stride_2_on_the_card(dev):
    """The JAX function takes f32 and stride 2; the CUDA path takes neither
    and says so (ROADMAP.md Queue C; the model routes neither)."""
    x, args = _ir_inputs(dev, 1, 8, 8, 8, 32, 8)
    for kw in (dict(compute_dtype=torch.float32), dict(stride=2)):
        with pytest.raises(ValueError, match="bf16 at stride 1"):
            fir.fused_inverted_residual(x, *args, use_residual=True, **kw)


def test_inverted_residual_block_keeps_its_operands_on_the_card(dev):
    from ggml_experiments_tpu_torch.models.mobilevit import InvertedResidualParams
    from ggml_experiments_tpu_torch.ops.conv import ConvBNAct
    from ggml_experiments_tpu_torch.ops.norm import FoldedBN

    rng = np.random.default_rng(2)

    def t(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.2).to(dev)

    def conv(kh, cin, co, dw=False, act="silu"):
        return ConvBNAct(kernel=t(kh, kh, cin, co), bn=FoldedBN(t(co) + 1.0, t(co)),
                         activation=act, depthwise=dw)

    blk = InvertedResidualParams(expand_1x1=conv(1, 32, 128), conv_3x3=conv(3, 1, 128, dw=True),
                                 reduce_1x1=conv(1, 128, 32, act="none"), use_residual=True,
                                 fused=True)
    x = torch.randn((2, 16, 16, 32), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev).to(torch.bfloat16)
    got = blk(x, compute_dtype=torch.bfloat16)
    ops = fir.block_operands(blk)
    again = blk(x, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fir.block_operands(blk) is ops and torch.equal(got, again)
    want = fir.fused_inverted_residual(x, *fir._folded(blk), use_residual=True)
    assert torch.equal(got, want)


def test_vision_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((2, 8, 8, 8), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((8, 32), device=dev)
    with pytest.raises(ValueError, match="stride"):
        fir.fused_inverted_residual(x, w, w[0], torch.zeros(3, 3, 32, device=dev), w[0],
                                    w.t(), w[:, 0], stride=2)
    q = torch.zeros((2, 16, 72), device=dev)
    with pytest.raises(ValueError, match="head width"):
        fa.flash_mha(q, q, q, 1, compute_dtype=torch.float32)


# ---- calibration and the MobileViT load options on the card ------------------------------


@pytest.mark.parametrize("k,n", [(256, 384), (300, 130)])
def test_gptq_on_the_card_is_bit_equal_to_the_cpu(dev, k, n):
    """The recursion in f64 on the card from the same H and W: the CPU's
    planes, bit for bit (U is factored on the host on both)."""
    from ggml_experiments_tpu_torch.quant import gptq

    rng = np.random.default_rng(k)
    x = rng.standard_normal((2048, k // 4)) @ rng.standard_normal((k, k // 4)).T
    h = x.T @ x / x.shape[0]
    w = rng.standard_normal((k, n)) * 0.1
    for fn in (gptq.gptq_quantize_q4_k, gptq.gptq_quantize_q8_0):
        got, want = fn(w, h, device=dev), fn(w, h, device="cpu")
        assert got.codes.device.type == "cuda"
        for name in ("codes", "scales", "mins", "supers"):
            a, b = getattr(got, name), getattr(want, name)
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a.cpu(), b), (fn.__name__, name)


def _tiny_vit(dev, **kw):
    from ggml_experiments_tpu_torch.models import mobilevit as tmv

    cfg = tmv.MobileViTConfig(image_size=64, hidden_sizes=(16, 24, 32),
                              neck_hidden_sizes=(8, 16, 16, 24, 32, 40, 64),
                              num_transformer_layers=(1, 1, 1))
    named = tmv.random_named_tensors(cfg, seed=3)
    return tmv.from_named_tensors(named, cfg, device=dev, **kw), \
        tmv.from_named_tensors(named, cfg, device="cpu", **kw)


@pytest.mark.parametrize("store,dtype", [("f8_e5m2", torch.float8_e5m2),
                                         ("f8_e4m3", torch.float8_e4m3fn),
                                         ("bfloat16", torch.bfloat16)])
def test_act_storage_dtypes_at_the_stamped_boundaries_on_the_card(dev, store, dtype):
    """The stamped boundaries hold the storage dtype on the card, the cast
    gives the CPU's bits on the same bf16 values, and the f32 route is
    untouched."""
    from ggml_experiments_tpu_torch.models.mobilevit import extract_features
    from ggml_experiments_tpu_torch.ops.conv import apply_store

    # the unfused inverted residuals: the fused kernel's output stays bf16
    p, _ = _tiny_vit(dev, act_storage=store, act_storage_scope="all", fused_ir=False)
    base, _ = _tiny_vit(dev, fused_ir=False)
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator(device=dev).manual_seed(1),
                   device=dev)
    bf = torch.bfloat16
    y = p.conv_stem(x, compute_dtype=bf)
    assert y.dtype == dtype and p.layer_5.fusion(p.layer_5.fusion.kernel.new_zeros(
        (1, 2, 2, 2 * p.layer_5.fusion.kernel.shape[-1])), compute_dtype=bf).dtype == dtype
    assert p.layer_2[1](p.layer_2[0](p.layer_1[0](y, compute_dtype=bf), compute_dtype=bf),
                        compute_dtype=bf).dtype == dtype
    v = (torch.randn(4096, device=dev) * 300).to(bf)   # past e4m3's range too
    got, want = apply_store(v, store).float().cpu(), apply_store(v.cpu(), store).float()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))
    assert torch.equal(extract_features(p, x), extract_features(base, x))
    assert extract_features(p, x, compute_dtype=bf).isfinite().all()


def test_space_to_depth_stem_equals_the_standard_stem_on_the_card(dev):
    p, p_cpu = _tiny_vit(dev, stem_space_to_depth=True)
    s, _ = _tiny_vit(dev)
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator(device=dev).manual_seed(2),
                   device=dev)
    torch.testing.assert_close(p.conv_stem(x), s.conv_stem(x), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(p.conv_stem(x).cpu(), p_cpu.conv_stem(x.cpu()), rtol=1e-5,
                               atol=1e-5)
    b = p.conv_stem(x, compute_dtype=torch.bfloat16).float()
    torch.testing.assert_close(b, s.conv_stem(x).float(), rtol=0.02,
                               atol=0.02 * float(b.abs().max()))
