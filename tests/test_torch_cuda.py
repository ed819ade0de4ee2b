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


def make_params(dev, qtype, head_qtype=None, v=V, e=E, u=U):
    """A small random GRU; the dense head may take another format than the
    cell (a mixed-format model rides the fused kernels' dense route)."""
    rng = np.random.default_rng(5)
    a = {"embeddings": rng.normal(0, 0.5, (v, e)),
         "kernel": rng.normal(0, 1 / np.sqrt(e), (e, 3 * u)),
         "recurrent_kernel": rng.normal(0, 1 / np.sqrt(u), (u, 3 * u)),
         "bias": rng.normal(0, 0.1, (2, 3 * u)),
         "dense_kernel": rng.normal(0, 3 / np.sqrt(u), (u, v)),
         "dense_bias": rng.normal(0, 0.1, (v,))}
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


def _slot_inputs(dev, b, t, p, seed, plen=None, total=None, temp=None, v=V, u=U):
    g = torch.Generator(device="cpu").manual_seed(seed)
    prompt = torch.randint(0, v, (b, p), generator=g, dtype=torch.int32).to(dev)
    plen = torch.full((b,), t, dtype=torch.int32, device=dev) if plen is None else plen
    total = plen.clone() if total is None else total
    z = torch.zeros(b, dtype=torch.int32, device=dev)
    return prompt, plen, total, z, z.clone(), torch.zeros(b, u, device=dev)


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


# ---- vocabularies past 256 and units off 32: every plan and every token
# rule of the persistent kernel against its plain version. Past V = 96 a
# slot-owned block's logits go through the device scratch, past 128 a
# unit-owned block's (the kernels' wide instances), and past 256 the slot's
# warp walks its row in memory; U off 32 runs padded to Ku with its padded
# units at 0

WIDE_VOCABS = [100, 257, 5000]
# greedy; then sampled: temperature alone, top-k, top-p, both
TOKEN_RULES = [None, {}, {"top_k": 20}, {"top_p": 0.9}, {"top_k": 20, "top_p": 0.9}]


def _rule_id(rule):
    return "greedy" if rule is None else "-".join(f"{k}{v}" for k, v in rule.items()) or "temp"


@pytest.fixture(scope="module", params=WIDE_VOCABS, ids=lambda v: f"V{v}")
def wide_vocab(request, dev):
    return request.param, make_params(dev, "q8_0", v=request.param)


def _forks_at_near_ties(toks, t_p, gaps, tol):
    """Tokens equal to the plain version's up to a fork, which comes only
    after a step whose choice had a margin under ``tol``."""
    diff = toks.int() != t_p
    for r in torch.nonzero(diff.any(1)).flatten().tolist():
        j = int(torch.nonzero(diff[r])[0])
        assert j > 0 and float(gaps[r, j - 1]) < tol, (r, j)


def _free_run(dev, w, case, rule, b, inner, v, u, seed, **keys):
    """A tick of B free-running slots (ragged prompts and totals) under
    ``case`` and ``rule``, launched twice (bit-equal), held to the plain
    version: cursors equal, tokens forking only at near ties."""
    plan, cd = case
    g = torch.Generator(device="cpu").manual_seed(seed)
    plen = torch.randint(1, 9, (b,), generator=g, dtype=torch.int32).to(dev)
    total = torch.randint(4, 30, (b,), generator=g, dtype=torch.int32).to(dev)
    args = _slot_inputs(dev, b, inner, 8, seed=seed + 1, plen=plen, total=total, v=v, u=u)
    kw = {} if rule is None else dict(temp=torch.linspace(0, 1.2, b, device=dev), seed=9,
                                      **rule)
    toks, h, _, pos = _run_twice("fused_slot_tick", w, args, inner, cd, config=plan, **kw, **keys)
    assert tf.LAST_PLAN["fused_slot_tick"] == tf.DecodePlan(*plan)
    assert toks.dtype == torch.int32 and h.shape == (b, u)
    t_p, _, _, pos_p, gaps = tf.gru_loop_reference(w, *args, inner, cd, margins=True, **kw,
                                                   **keys)
    assert torch.equal(pos, pos_p)
    _forks_at_near_ties(toks, t_p, gaps, 1e-3 if cd == torch.float32 else 0.1)
    return toks


@pytest.mark.parametrize("rule", TOKEN_RULES, ids=_rule_id)
@pytest.mark.parametrize("case", PLAN_CASES, ids=_plan_id)
def test_wide_vocab_every_plan_and_token_rule_matches_plain(dev, wide_vocab, case, rule):
    v, params = wide_vocab
    _free_run(dev, tf._prep_weights(params), case, rule, 129, 10, v, U, seed=v)


@pytest.mark.parametrize("case", PLAN_CASES, ids=_plan_id)
def test_wide_vocab_every_plan_teacher_forced_matches_plain(dev, wide_vocab, case):
    """Decode through each plan with the prompt fed throughout: the state
    within the dtype's limit, the last prediction equal but at a near tie."""
    v, params = wide_vocab
    plan, cd = case
    b, t = 200, 12
    w = tf._prep_weights(params)
    args = _slot_inputs(dev, b, t, t, seed=4, v=v)
    toks, h, prev, pos = _run_twice("fused_gru_decode", w, args, t, cd, config=plan)
    ptoks, ph, pprev, ppos, gaps = tf.gru_loop_reference(w, *args, t, cd, margins=True)
    assert torch.equal(toks, ptoks) and torch.equal(pos, ppos)
    assert float((h - ph).abs().max()) <= (1e-5 if cd == torch.float32 else 2e-2)
    tol = 1e-3 if cd == torch.float32 else 0.1
    assert bool(((prev == pprev) | (gaps[:, -1] < tol)).all())


@pytest.mark.parametrize("case", PLAN_CASES, ids=_plan_id)
def test_wide_vocab_block_keyed_sampled_tick_matches_plain(dev, wide_vocab, case):
    """The noise over a vocabulary past 256 keyed as a shard from global slot
    256 in blocks of 64 columns: the plain version's, and not the unkeyed."""
    v, params = wide_vocab
    w = tf._prep_weights(params)
    rule = {"top_k": 20, "top_p": 0.9}
    keyed = _free_run(dev, w, case, rule, 256, 10, v, U, seed=5, slot_base=256, key_tile=64)
    plain = _free_run(dev, w, case, rule, 256, 10, v, U, seed=5)
    assert (keyed != plain).float().mean() > 0.3


def test_wide_vocab_default_plans_and_entry_points(dev, wide_vocab):
    """decode() and the engine's tick at a wide vocabulary take the kernel
    on the plan decode_plan gives (int32 tokens past V = 255), and decode()
    agrees with the plain version."""
    v, params = wide_vocab
    from ggml_experiments_tpu_torch.models import gru_textgen as tg

    ids = torch.randint(0, v, (96, 6), generator=torch.Generator().manual_seed(1),
                        dtype=torch.int32).to(dev)
    lens = torch.full((96,), 6, dtype=torch.int32, device=dev)
    assert tg.decode_route(params, 96, 64) == "fused"
    before = dict(tf.LAUNCHES)
    got = tg.decode(params, ids, lens, 64, compute_dtype=torch.float32)
    assert tf.LAUNCHES["fused_gru_decode"] == before["fused_gru_decode"] + 1
    z = torch.zeros(96, dtype=torch.int32, device=dev)
    want, _, _, _, gaps = tf.gru_loop_reference(
        tf._prep_weights(params), torch.nn.functional.pad(ids, (0, 58)), lens,
        torch.full((96,), 64, dtype=torch.int32, device=dev), z, z, torch.zeros(96, U, device=dev),
        64, torch.float32, margins=True)
    _forks_at_near_ties(got, want, gaps, 1e-3)
    st = tengine.init_state(params, 32, 8)
    st = dataclasses.replace(st, prompt=ids[:32, :6].contiguous(),
                             plen=torch.full((32,), 6, dtype=torch.int32, device=dev),
                             total=torch.full((32,), 40, dtype=torch.int32, device=dev))
    _, toks = tf.fused_slot_tick(params, st, 16, compute_dtype=torch.bfloat16)
    assert toks.dtype == (torch.uint8 if v <= 255 else torch.int32)
    assert tf.LAUNCHES["fused_slot_tick"] == before["fused_slot_tick"] + 1


# units off 32 (the TPU kernel pads them as this one does) on each weight
# route, and U = 1000 at the reference's E: decode and the tick on every plan
ODD_UNITS = [(40, 300, "q8_0"), (40, 300, "q4_0"), (40, 300, "q5_1"), (1000, 66, "q8_0"),
             (1000, 66, "q4_0")]


@pytest.fixture(scope="module", params=ODD_UNITS, ids=lambda c: f"U{c[0]}-V{c[1]}-{c[2]}")
def odd_units(request, dev):
    u, v, qt = request.param
    p = make_params(dev, qt, v=v, u=u)
    w = tf._prep_weights(p)
    assert w.u == u and w.ku == -(-u // 32) * 32 and w.uc.shape[-1] == 3 * w.ku
    return u, v, p


@pytest.mark.parametrize("case", PLAN_CASES, ids=_plan_id)
def test_units_off_32_every_plan_matches_plain(dev, odd_units, case):
    u, v, params = odd_units
    plan, cd = case
    b, t = 129, 12
    w = tf._prep_weights(params)
    args = _slot_inputs(dev, b, t, t, seed=6, v=v, u=u)
    toks, h, _, pos = _run_twice("fused_gru_decode", w, args, t, cd, config=plan)
    ptoks, ph, _, ppos = tf.gru_loop_reference(w, *args, t, cd)
    assert h.shape == (b, u) and torch.equal(toks, ptoks) and torch.equal(pos, ppos)
    assert float((h - ph).abs().max()) <= (1e-5 if cd == torch.float32 else 2e-2)
    _free_run(dev, w, case, {"top_k": 20, "top_p": 0.9}, b, 10, v, u, seed=7)


def test_units_past_every_plan_take_the_scan_path(dev):
    """U = 2048: 256 unit groups on 132 multiprocessors, and 64 slots' h
    past a block's shared memory. decode() and the engine keep the scan
    path (no launch), the explicit fused tick is refused at construction
    with the reason, and the kernel's wrapper still raises."""
    from ggml_experiments_tpu_torch.models import gru_textgen as tg

    params = make_params(dev, "q8_0", u=2048)
    assert not tf.loop_takes(64, 2048, V, torch.bfloat16, *tf.device_limits(dev))
    assert tg.decode_route(params, 64, 64) == "scan"
    ids = torch.randint(0, V, (64, 4), generator=torch.Generator().manual_seed(2),
                        dtype=torch.int32).to(dev)
    lens = torch.full((64,), 4, dtype=torch.int32, device=dev)
    before = dict(tf.LAUNCHES)
    got = tg.decode(params, ids, lens, 64)
    assert tf.LAUNCHES == before
    assert torch.equal(got, tg.generate(params, ids, lens, 64, compute_dtype=torch.bfloat16))
    eng = DecodeEngine(params, n_slots=16, inner_steps=16, compute_dtype=torch.bfloat16)
    assert not eng.use_fused_tick
    with pytest.raises(ValueError, match="no plan"):
        DecodeEngine(params, n_slots=16, inner_steps=16, compute_dtype=torch.bfloat16,
                     use_fused_tick=True)
    with pytest.raises(ValueError, match="no plan"):
        tf.fused_gru_decode(params, ids, lens, 8)
    assert tf.LAUNCHES == before


# ---------------------------------------------------------------------------
# the fused training pair (csrc/gru_train.cu)
# ---------------------------------------------------------------------------

def train_operands(dev, t, b, u, seed=0, cd=torch.bfloat16):
    """Operands of the training scan in ``cd`` (``brec`` f32) and a
    cotangent, on the card."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    bf = cd
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
TRAIN_BF16 = ("fused_gru_train_fwd", "fused_gru_train_bwd", "fused_gru_train_dwr")
TRAIN_F32 = tuple(f"{k}_f32" for k in TRAIN_BF16)


def bumped(before, keys):
    """The launch counters after one launch of each of ``keys``."""
    return {k: v + (k in keys) for k, v in before.items()}


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
    assert ft.LAUNCHES == bumped(launches, TRAIN_BF16) and ft.PLAIN_CALLS == plain
    assert set(ft.LAUNCHES) == set(TRAIN_BF16) | set(TRAIN_F32)
    pargs = [a.detach().clone().requires_grad_() for a in args]
    pys = ft.fused_gru_scan_plain(*pargs)
    (pys.float() * dys.float()).sum().backward()
    assert float((ys.detach().float() - pys.detach().float()).abs().max()) <= 2e-2
    for a, p in zip(args, pargs):
        assert a.grad.dtype == a.dtype and rel_max(a.grad, p.grad) <= 1e-2


def test_train_batch_local_pair_at_a_rank_batch_matches_plain(dev):
    """The fused pair's sharded half on one rank of a (2, 1) mesh: B = 512
    rows of a 1024-row batch at U = 1024, through ``fused_gru_scan`` with the
    recurrent kernel as a column shard that the scan gathers (here a
    one-rank stand-in whose gather hands back the whole weight): one launch
    of each kernel on the rank's plan, the gradients against the plain
    versions, two runs bit-equal."""
    import types

    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    mxs, h0, wr, brec, dys = train_operands(dev, 8, 512, 1024)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert ft.train_plan(512, 1024, sms) != ft.train_plan(1024, 1024, sms)

    def run(scan, shard):
        w = wr.float().requires_grad_()
        args = [mxs.clone().requires_grad_(), h0, w, brec.clone().requires_grad_()]
        wr_arg = types.SimpleNamespace(gather=lambda: w, local=w) if shard else w
        ys = scan(args[0], h0, wr_arg, args[3])
        (ys.float() * dys.float()).sum().backward()
        torch.cuda.synchronize()
        return ys.detach(), [args[0].grad, w.grad, args[3].grad]

    launches = dict(ft.LAUNCHES)
    ys, grads = run(ft.fused_gru_scan, True)
    assert ft.LAUNCHES == bumped(launches, TRAIN_BF16)
    assert ft.LAST_PLAN["fused_gru_train_fwd"] == ft.train_plan(512, 1024, sms)
    ys2, grads2 = run(ft.fused_gru_scan, True)
    assert torch.equal(ys, ys2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    pys, pgrads = run(ft.fused_gru_scan_plain, False)
    assert float((ys.float() - pys.float()).abs().max()) <= 2e-2
    for name, g, w in zip(("dmxs", "dwr", "dbrec"), grads, pgrads):
        assert rel_max(g, w) <= 1e-2, (name, rel_max(g, w))


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


# ---- the f32 form of the training pair (csrc/gru_train_f32.cu): 3xTF32
# products against the plain versions' f32 products (TF32 off) and the same
# gate arithmetic in other routines: f32 accuracy, errors of a few ulps that
# the recurrence carries on; 1e-5 of the largest value forward, 1e-4 for the
# gradients (the carry compounds over the steps)
F32_FWD_REL, F32_GRAD_REL = 1e-5, 1e-4


def f32_pair_check(dev, t, b, u, config=None, bwd_config=None):
    """The f32 forward and backward (recurrence, then dWr) against their
    plain versions on the same inputs, each launched twice and bit-equal;
    ``config`` forces the forward's plan, ``bwd_config`` the backward's."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    mxs, h0, wr, brec, dys = train_operands(dev, t, b, u, cd=torch.float32)
    before = dict(ft.LAUNCHES)
    ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=config)
    ys2, mhs2 = ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=config)
    pys, pmhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
    got = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr, config=bwd_config)
    again = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr, config=bwd_config)
    torch.cuda.synchronize()
    assert ft.LAUNCHES == {k: v + 2 * (k in TRAIN_F32) for k, v in before.items()}
    if config is not None:
        assert ft.LAST_PLAN["fused_gru_train_fwd_f32"] == ft.FwdPlan(*config)
    if bwd_config is not None:
        assert ft.LAST_PLAN["fused_gru_train_bwd_f32"] == ft.BwdPlan(*bwd_config)
    assert ys.dtype == mhs.dtype == torch.float32
    assert torch.equal(ys, ys2) and torch.equal(mhs, mhs2)
    assert rel_max(ys, pys) <= F32_FWD_REL and rel_max(mhs, pmhs) <= F32_FWD_REL, (
        rel_max(ys, pys), rel_max(mhs, pmhs))
    want = ft.gru_train_bwd_plain(mxs, pmhs, pys, dys, h0, wr)
    for name, g, a, w in zip(("dmxs", "dwr", "dbrec", "dh0"), got, again, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32, name
        assert torch.equal(g, a), f"{name}: two launches on the same inputs differ"
        assert rel_max(g, w) <= F32_GRAD_REL, (name, rel_max(g, w))


@pytest.mark.parametrize("t,b,u", TRAIN_SHAPES)
def test_train_f32_pair_matches_plain_and_repeats_bit_equal(dev, t, b, u):
    f32_pair_check(dev, t, b, u)


@pytest.mark.parametrize("b", [1, 64, 1024, 1761])
def test_train_f32_every_plan_matches_plain(dev, b):
    """Each plan the f32 kernels take at U = 1024, forced: the forward's
    (rows, units, R), and the backward recurrence's own."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    f32 = torch.float32
    plans = ft.train_plans(b, 1024, sms, dtype=f32)
    assert ft.train_plan(b, 1024, sms, dtype=f32) in plans and len(plans) >= 2
    for plan in plans:
        f32_pair_check(dev, 3, b, 1024, config=tuple(plan))
    bwd = ft.train_plans(b, 1024, sms, dtype=f32, part="bwd")
    assert ft.train_plan(b, 1024, sms, dtype=f32, part="bwd") in bwd and len(bwd) >= 2
    for plan in bwd:
        f32_bwd_check(dev, 3, b, 1024, tuple(plan))


def f32_bwd_check(dev, t, b, u, config):
    """The f32 backward recurrence on a forced plan against its plain
    version, launched twice and bit-equal."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    mxs, h0, wr, brec, dys = train_operands(dev, t, b, u, cd=torch.float32)
    ys, mhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
    got = ft.gru_train_bwd_rec_cuda(mxs, mhs, ys, dys, h0, wr, config=config)
    again = ft.gru_train_bwd_rec_cuda(mxs, mhs, ys, dys, h0, wr, config=config)
    torch.cuda.synchronize()
    assert ft.LAST_PLAN["fused_gru_train_bwd_f32"] == ft.BwdPlan(*config)
    want = ft.gru_train_bwd_rec_plain(mxs, mhs, ys, dys, h0, wr)
    for name, g, a, w in zip(("dmxs", "plane", "dbrec", "dh0"), got, again, want):
        assert torch.equal(g, a), f"{name}: two launches on the same inputs differ ({config})"
        assert rel_max(g, w) <= F32_GRAD_REL, (name, config, rel_max(g, w))


@pytest.mark.parametrize("b", [1, 65, 1000])
def test_train_f32_ragged_batches_match_plain(dev, b):
    """Batches off the backward's 64- and 128-row chunks and dWr's 32-row
    stages, on the default plans."""
    f32_pair_check(dev, 3, b, 1024)


@pytest.mark.parametrize("u", [96, 200])
def test_train_f32_narrow_and_seam_widths_match_plain(dev, u):
    """U = 96 lies below one 64-unit group; at U = 200 the dmx / plane seam
    at column 2U = 400 falls inside a 32-wide K stage of the carry product
    and inside a 128-wide dWr tile, and the forward's K = 200 ends inside
    its last stage. The default plans, then every forward and backward cut
    that takes the width, each launched twice and bit-equal."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    f32_pair_check(dev, 4, 130, u)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for rows, units in {(p.rows, p.units) for p in
                        ft.train_plans(130, u, sms, dtype=torch.float32)}:
        f32_fwd_check(dev, 4, 130, u, (rows, units, 1))
    for rows, units in {(p.rows, p.units) for p in
                        ft.train_plans(130, u, sms, dtype=torch.float32, part="bwd")}:
        f32_bwd_check(dev, 4, 130, u, (rows, units, 1))


def f32_fwd_check(dev, t, b, u, config):
    """The f32 forward on a forced plan against its plain version, launched
    twice and bit-equal."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    mxs, h0, wr, brec, _ = train_operands(dev, t, b, u, cd=torch.float32)
    ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=config)
    ys2, mhs2 = ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=config)
    torch.cuda.synchronize()
    assert ft.LAST_PLAN["fused_gru_train_fwd_f32"] == ft.FwdPlan(*config)
    assert torch.equal(ys, ys2) and torch.equal(mhs, mhs2), config
    pys, pmhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
    assert rel_max(ys, pys) <= F32_FWD_REL and rel_max(mhs, pmhs) <= F32_FWD_REL, (
        config, rel_max(ys, pys), rel_max(mhs, pmhs))


def test_train_f32_every_forward_cut_repeats_bit_equal(dev):
    """Each of the forward's cuts at (T, B, U) = (3, 300, 256), forced with
    one and with two row tiles."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    for rows, units in ft.F32_FWD_CUTS:
        for r in (1, 2):
            f32_fwd_check(dev, 3, 300, 256, (rows, units, r))


def test_train_f32_every_backward_cut_repeats_bit_equal(dev):
    """Each of the backward's cuts at (T, B, U) = (3, 300, 256), forced
    with one and with two row tiles."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    for rows, units in ft.F32_BWD_CUTS:
        for r in (1, 2):
            f32_bwd_check(dev, 3, 300, 256, (rows, units, r))


@pytest.mark.parametrize("t,b,u", TRAIN_SHAPES + [(2, 200, 1024), (3, 130, 200)])
def test_train_f32_dwr_kernel_matches_plain(dev, t, b, u):
    """The f32 dWr GEMM alone on equal operands: 3xTF32 products, f32 sums
    in another order over K = T*B terms, in the K partitions the wrapper
    picks (U = 200 puts the dmx / plane seam inside a tile)."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    mxs, h0, wr, brec, dys = train_operands(dev, t, b, u, cd=torch.float32)
    ys, mhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
    dmxs, plane, _, _ = ft.gru_train_bwd_rec_plain(mxs, mhs, ys, dys, h0, wr)
    got = ft.gru_train_dwr_cuda(h0, ys, dmxs, plane)
    again = ft.gru_train_dwr_cuda(h0, ys, dmxs, plane)
    torch.cuda.synchronize()
    want = ft.gru_train_dwr_plain(h0, ys, dmxs, plane)
    assert torch.equal(got, again)
    assert rel_max(got, want) <= 1e-5, rel_max(got, want)


def test_train_f32_route_on_a_cuda_parameter(dev):
    """At f32 on the card the time-major sequence takes the f32 pair by
    default (one launch of each f32 kernel, no plain-version run), and its
    states and gradients match ``fused=False`` (the plain loop under
    autograd); bf16 still takes the bf16 pair, the CPU neither."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft
    from ggml_experiments_tpu_torch.ops import gru as tgru

    rng = np.random.default_rng(3)
    t, b, e, u = 6, 40, 24, 96
    arrs = {"kernel": rng.normal(0, 0.3, (e, 3 * u)),
            "recurrent_kernel": rng.normal(0, 1 / np.sqrt(u), (u, 3 * u)),
            "bias": rng.normal(0, 0.2, (2, 3 * u))}
    xs = torch.tensor(rng.normal(0, 1, (t, b, e)), dtype=torch.float32, device=dev)
    wts = torch.tensor(rng.normal(0, 1, (t, b, u)), dtype=torch.float32, device=dev)

    def run(fused):
        cell = tgru.GRUCellParams(**{k: torch.tensor(v, dtype=torch.float32, device=dev,
                                                     requires_grad=True)
                                     for k, v in arrs.items()})
        ys, _ = tgru.gru_sequence_time_major(cell, xs, torch.zeros(b, u, device=dev),
                                             compute_dtype=torch.float32, fused=fused)
        (ys * wts).sum().backward()
        torch.cuda.synchronize()
        return cell, ys.detach(), [getattr(cell, k).grad for k in arrs]

    launches, plain = dict(ft.LAUNCHES), dict(ft.PLAIN_CALLS)
    cell, ys, grads = run(None)
    assert tgru.fused_train_route(cell, torch.float32, dev)
    assert tgru.fused_train_route(cell, torch.bfloat16, dev)
    assert not tgru.fused_train_route(cell, torch.float32, "cpu", fused=True)
    assert ft.LAUNCHES == bumped(launches, TRAIN_F32) and ft.PLAIN_CALLS == plain
    launches = dict(ft.LAUNCHES)
    _, pys, pgrads = run(False)
    assert ft.LAUNCHES == launches
    assert rel_max(ys, pys) <= F32_FWD_REL
    for name, g, w in zip(arrs, grads, pgrads):
        assert rel_max(g, w) <= F32_GRAD_REL, (name, rel_max(g, w))


# ---- the vision kernels: flash attention, the fused layer, the fused inverted residual

from ggml_experiments_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir  # noqa: E402
from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl  # noqa: E402


# the f32 layer kernels' counters, untouched by a bf16 layer; the wide bf16
# launches' (C past 288), untouched by a narrower layer
F32_NONE = {"transformer_ln_qkv_f32": 0, "transformer_attention_f32": 0,
            "transformer_proj_ffn_f32": 0, "transformer_attention_f32_streamed": 0}
WIDE_NONE = {"transformer_ln_qkv_wide": 0, "transformer_proj_ffn_wide": 0}


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
        "transformer_proj_ffn": 1, "transformer_attention_streamed": 0, **WIDE_NONE,
        **F32_NONE}
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
    version's inputs, launched twice (bit-equal), with the counters (past C
    = 288 ln_qkv and proj_ffn run wide)."""
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
        "transformer_proj_ffn": 2,
        "transformer_attention_streamed": 2 * (ftl.attention_plan(l) == "streamed"),
        "transformer_ln_qkv_wide": 2 * (c > 288), "transformer_proj_ffn_wide": 2 * (c > 288),
        **F32_NONE}
    assert torch.equal(qkv, qkv2) and torch.equal(ctx, ctx2) and torch.equal(out, out2), (
        "two launches on the same inputs differ")
    dh = c // h
    assert not qkv.reshape(bp * l, 3, h, -1)[..., dh:].any(), "a head's padding is not zero"
    _bf16_close(qkv, want_qkv, 0.05, 2e-3)
    _bf16_close(ctx, want_ctx, 0.05, 2e-3)
    _bf16_close(out, ftl.proj_ffn_plain(x2, want_ctx, ops), 0.05, 2e-3)


# every flag; dh = 12 and 32; L = 24 (two sequences a packed tile), 16, 72 (a
# ragged second tile), 320 (past the scores held in registers: the streamed plan)
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
    # C = 1344 is past a block's shared memory even in groups (a 64-row tile
    # of C columns beside the weight ring): the wrappers refuse it with the
    # reason, before any launch
    ops = _layer_ops(dev, 1344, 21, 64, 1344, 1344, False, False, seed=1)
    with pytest.raises(ValueError, match="no layout of the row-tile kernels"):
        ftl.ln_qkv_cuda(torch.zeros((16, 1344), dtype=torch.bfloat16, device=dev), ops, 16)
    ops = _layer_ops(dev, 128, 1, 256, 128, 128, False, False, seed=1)
    with pytest.raises(ValueError, match="head width up to 64"):
        ftl.fused_layer_cuda(torch.zeros((1, 16, 128), dtype=torch.bfloat16, device=dev), ops)
    ops = _layer_ops(dev, 64, 2, 128, 64, 64, False, False, seed=1)
    with pytest.raises(ValueError, match="multiple of 8"):
        ftl.fused_layer_cuda(torch.zeros((1, 20, 64), dtype=torch.bfloat16, device=dev), ops)
    # an input projection whose x tile does not fit beside the A tile and the ring
    ops = _layer_ops(dev, 288, 6, 64, 1000, 288, False, False, seed=1)
    with pytest.raises(ValueError, match="no layout of the row-tile kernels"):
        ftl.fused_layer_cuda(torch.zeros((1, 16, 1000), dtype=torch.bfloat16, device=dev), ops)


# C past 288 runs on the wide row tiles (packed tiles, a ragged tile, a whole
# one; C = 640 beside an x tile of 320 in three groups); no flag and every flag
@pytest.mark.parametrize("flags", [(False, False, False), (True, True, True)])
@pytest.mark.parametrize("bp,l,c,h,f", [(3, 16, 320, 5, 640), (2, 48, 384, 6, 768),
                                        (2, 64, 320, 5, 640), (2, 16, 640, 10, 1280)])
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
        "fused_transformer_layer": 2, "transformer_ln_qkv": 2, "transformer_attention": 2,
        "transformer_proj_ffn": 2, "transformer_attention_streamed": 0,
        "transformer_ln_qkv_wide": 2, "transformer_proj_ffn_wide": 2, **F32_NONE}
    assert torch.equal(got, again), "two launches on the same inputs differ"
    _bf16_close(got, ftl.fused_transformer_layer_plain(x, ops), 0.05, 2e-3)


# the wide row tiles, each kernel on its plain version's inputs, every flag;
# C = 336 (groups of 192, the last part padding), dh = 48 and 56; L = 24 (a
# packed tile), 72 (a ragged second tile), 320 (the streamed attention)
@pytest.mark.parametrize("in_proj", [False, True])
@pytest.mark.parametrize("final_ln", [False, True])
@pytest.mark.parametrize("out_proj", [False, True])
@pytest.mark.parametrize("bp,l,c,h,f", [(3, 24, 336, 7, 672), (2, 72, 384, 8, 256),
                                        (1, 320, 336, 6, 336)])
def test_wide_layer_kernels_match_plain_every_flag(dev, in_proj, final_ln, out_proj, bp, l, c,
                                                    h, f):
    _layer_kernels_check(dev, bp, l, c, h, f, c // 2 if in_proj else c, c // 2 + 8, final_ln,
                         out_proj, seed=l + c)


# ---- the f32 form of the layer (csrc/transformer_layer_f32.cu) ----------------------------

F32_LAYER = ("transformer_ln_qkv_f32", "transformer_attention_f32", "transformer_proj_ffn_f32")


def _f32_close(got, want):
    """3xTF32 products (f32-accurate), f32 sums in other orders: 1e-5 of the
    largest value."""
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= 1e-5 * scale, (err, scale)


def _f32_layer_check(dev, bp, l, c, h, f, cin, cout, final_ln, out_proj, seed, nwg=None):
    """The three f32 kernels, each on its plain version's inputs and launched
    twice (bit-equal), then the whole layer, with the counters; ``nwg``
    forces the row tiles' consumer warpgroups."""
    ops = _layer_ops(dev, c, h, f, cin, cout, final_ln, out_proj, seed=seed)
    ops = dataclasses.replace(ops, **{k: getattr(ops, k).float() for k in (
        "wq", "wk", "wv", "wo", "wi", "wo2")}, win=None if ops.win is None else ops.win.float(),
        wout=None if ops.wout is None else ops.wout.float(), cache={})
    x = torch.randn((bp, l, cin), generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)
    x2 = x.reshape(bp * l, cin)
    before = dict(ftl.LAUNCHES)
    qkv, qkv2 = (ftl.ln_qkv_cuda(x2, ops, l, _plan=nwg) for _ in range(2))
    want_qkv = ftl.ln_qkv_plain(x2, ops)
    ctx, ctx2 = (ftl.attention_cuda(want_qkv, l, ops) for _ in range(2))
    want_ctx = ftl.attention_plain(want_qkv, l, ops)
    out, out2 = (ftl.proj_ffn_cuda(x2, want_ctx, ops, l, _plan=nwg) for _ in range(2))
    layer = ftl.fused_layer_cuda(x, ops, _plan=nwg)
    torch.cuda.synchronize()
    after = dict(ftl.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        "fused_transformer_layer": 0, "transformer_ln_qkv": 0, "transformer_attention": 0,
        "transformer_proj_ffn": 0, "transformer_attention_streamed": 0, **WIDE_NONE,
        "transformer_attention_f32_streamed": 0, **{k: 3 for k in F32_LAYER}}
    assert torch.equal(qkv, qkv2) and torch.equal(ctx, ctx2) and torch.equal(out, out2), (
        "two launches on the same inputs differ")
    assert not qkv.reshape(bp * l, 3, h, -1)[..., c // h:].any(), "a head's padding is not zero"
    _f32_close(qkv, want_qkv)
    _f32_close(ctx, want_ctx)
    _f32_close(out, ftl.proj_ffn_plain(x2, want_ctx, ops))
    _f32_close(layer, ftl.fused_transformer_layer_plain(x, ops))
    return ops


# every flag; dh = 12, 32 and 8; L = 16, 24 and 72 (a 16-row tile past a
# sequence's end), a width not a multiple of 32
@pytest.mark.parametrize("in_proj", [False, True])
@pytest.mark.parametrize("final_ln", [False, True])
@pytest.mark.parametrize("out_proj", [False, True])
@pytest.mark.parametrize("bp,l,c,h,f", [(3, 16, 48, 4, 96), (2, 24, 64, 2, 128),
                                        (2, 72, 40, 5, 88)])
def test_f32_layer_kernels_match_their_plain_versions_every_flag(dev, in_proj, final_ln,
                                                                 out_proj, bp, l, c, h, f):
    _f32_layer_check(dev, bp, l, c, h, f, c // 2 if in_proj else c, c // 2 + 8, final_ln,
                     out_proj, seed=l + c)


# the model's widths (dh = 36, 48, 60) with the first and the last layer's
# flags, on the plan's warpgroups and on one and two forced; ragged row tiles
# (5 x 72 rows; 3 x 16 = 48 rows, short of one 64-row tile). Two warpgroups
# do not fit proj_ffn's block at C = 240: the layer is refused.
@pytest.mark.parametrize("bp,l,c,h,f,cin", [(4, 256, 144, 4, 288, 96), (6, 64, 192, 4, 384, 128),
                                            (8, 16, 240, 4, 480, 160), (5, 72, 144, 4, 288, 96),
                                            (3, 16, 144, 4, 288, 96), (3, 16, 240, 4, 480, 160)])
@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("nwg", [None, 1, 2])
def test_f32_layer_kernels_match_their_plain_versions_at_the_model_widths(dev, bp, l, c, h, f,
                                                                          cin, last, nwg):
    if nwg == 2 and c == 240:
        width = c if last else cin
        ops = _layer_ops(dev, c, h, f, width, cin, last, last, seed=c)
        ops = dataclasses.replace(ops, **{k: None if getattr(ops, k) is None else
                                          getattr(ops, k).float() for k in (
            "wq", "wk", "wv", "wo", "wi", "wo2", "win", "wout")}, cache={})
        with pytest.raises(ValueError, match="2 consumer warpgroups does not fit"):
            ftl.fused_layer_cuda(torch.zeros((bp, l, width), device=dev), ops, _plan=2)
        return
    _f32_layer_check(dev, bp, l, c, h, f, c if last else cin, cin, last, last, seed=c, nwg=nwg)


# the f32 attention alone (a block per head of whole sequences, the scores of
# whole rows on tf32 wgmma): the model shapes at an even and an odd bp, a
# packed L = 16 tile with a ragged T = 48, two sequences of 24 a tile, a
# window of two tiles (L = 72, dh = 8), on each warpgroup count (two take a
# block of two tiles or more; one tile refuses them)
@pytest.mark.parametrize("bp,l,c,h,f", [(4, 256, 144, 4, 288), (5, 256, 144, 4, 288),
                                        (6, 64, 192, 4, 384), (7, 64, 192, 4, 384),
                                        (8, 16, 240, 4, 480), (3, 16, 240, 4, 480),
                                        (3, 24, 64, 2, 128), (3, 72, 40, 5, 88)])
@pytest.mark.parametrize("nwg", [None, 1, 2])
def test_f32_attention_matches_its_plain_version_on_each_plan(dev, bp, l, c, h, f, nwg):
    ops = _layer_ops(dev, c, h, f, c, c, False, False, seed=l + c)
    ops = dataclasses.replace(ops, **{k: getattr(ops, k).float() for k in (
        "wq", "wk", "wv", "wo", "wi", "wo2")}, cache={})
    x2 = torch.randn((bp * l, c), generator=torch.Generator(device=dev).manual_seed(bp + l),
                     device=dev)
    qkv = ftl.ln_qkv_plain(x2, ops)
    if ftl.f32_attention_warpgroups(l, c // h, nwg) is None:
        with pytest.raises(ValueError, match="takes 1 consumer warpgroup"):
            ftl.attention_cuda(qkv, l, ops, _plan=nwg)
        return
    before = ftl.LAUNCHES["transformer_attention_f32"]
    got, again = (ftl.attention_cuda(qkv, l, ops, _plan=nwg) for _ in range(2))
    torch.cuda.synchronize()
    assert ftl.LAUNCHES["transformer_attention_f32"] == before + 2
    assert torch.equal(got, again), "two launches on the same inputs differ"
    _f32_close(got, ftl.attention_plain(qkv, l, ops))


def test_f32_layer_kernels_refuse_what_they_do_not_take(dev):
    ops = _layer_ops(dev, 160, 2, 320, 160, 160, False, False, seed=1)
    ops = dataclasses.replace(ops, wq=ops.wq.float(), wi=ops.wi.float(), cache={})
    with pytest.raises(ValueError, match=r"\(T, L, Cin, C, H, F\) = \(16, 16, 160, 160, 2, 320\)"):
        ftl.fused_layer_cuda(torch.zeros((1, 16, 160), device=dev), ops)
    ops = _layer_ops(dev, 64, 1, 128, 64, 64, False, False, seed=1)
    ops = dataclasses.replace(ops, wq=ops.wq.float(), wi=ops.wi.float(), cache={})
    with pytest.raises(ValueError, match="shared memory"):   # k, v of 256 keys at dh = 64
        ftl.fused_layer_cuda(torch.zeros((1, 256, 64), device=dev), ops)
    with pytest.raises(ValueError, match="T a multiple of L"):
        ftl.ln_qkv_cuda(torch.zeros((20, 64), device=dev), ops, 16)
    with pytest.raises(ValueError, match="1 or 2 consumer warpgroups"):
        ftl.fused_layer_cuda(torch.zeros((1, 16, 64), device=dev), ops, _plan=3)
    ops = _layer_ops(dev, 288, 4, 576, 288, 288, False, False, seed=1)   # C past 240
    ops = dataclasses.replace(ops, wq=ops.wq.float(), wi=ops.wi.float(), cache={})
    with pytest.raises(ValueError, match=r"\(T, L, Cin, C, H, F\) = \(16, 16, 288, 288, 4, 576\)"):
        ftl.proj_ffn_cuda(torch.zeros((16, 288), device=dev), torch.zeros((16, 288), device=dev),
                          ops, 16)


def test_f32_layer_too_wide_for_the_row_tiles_runs_unfused_on_the_card(dev):
    """A layer of C = 288 (past the row tiles' 240) at f32 on the card keeps
    the unfused chain with flash attention: the route says no before any
    launch, no f32 layer kernel runs, and the result meets the fused
    layer's plain version within 1e-5 of the largest value."""
    from ggml_experiments_tpu_torch.models import mobilevit as tmv
    from ggml_experiments_tpu_torch.ops.attention import AttentionParams

    rng = np.random.default_rng(9)

    def t(*s, off=0.0):
        return torch.from_numpy((rng.standard_normal(s) * 0.1 + off).astype(np.float32)).to(dev)

    c, h, f = 288, 6, 576   # heads of 48: flash takes them
    layer = tmv.TransformerLayerParams(
        attention=AttentionParams(wq=t(c, c), bq=t(c), wk=t(c, c), bk=t(c), wv=t(c, c), bv=t(c),
                                  wo=t(c, c), bo=t(c), num_heads=h, flash=True),
        ln_before_gamma=t(c, off=1.0), ln_before_beta=t(c), ln_after_gamma=t(c, off=1.0),
        ln_after_beta=t(c), intermediate_kernel=t(c, f), intermediate_bias=t(f),
        output_kernel=t(f, c), output_bias=t(c), fused=True)
    x = t(4, 16, c)
    assert not layer.fused_route(torch.float32, x.device, 16)
    before, flash_before = dict(ftl.LAUNCHES), fa.LAUNCHES["flash_mha"]
    got = layer(x, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    assert {k: ftl.LAUNCHES[k] - before[k] for k in F32_LAYER} == {k: 0 for k in F32_LAYER}
    assert fa.LAUNCHES["flash_mha"] == flash_before + 1
    _f32_close(got, ftl.fused_transformer_layer_plain(x, ftl.layer_operands(layer, c,
                                                                            torch.float32)))


def test_f32_layer_route_on_the_card(dev, monkeypatch):
    """A fused layer at f32 on the card launches the f32 kernels (no flash,
    no plain version), the same bits as the kernels called directly; off the
    route (``fused_route`` patched) it runs the unfused chain with flash
    attention, within 1e-5 of the largest value."""
    from ggml_experiments_tpu_torch.models import mobilevit as tmv
    from ggml_experiments_tpu_torch.ops.attention import AttentionParams

    rng = np.random.default_rng(3)

    def t(*s, off=0.0):
        return torch.from_numpy((rng.standard_normal(s) * 0.2 + off).astype(np.float32)).to(dev)

    c, h, f = 48, 4, 96
    layer = tmv.TransformerLayerParams(
        attention=AttentionParams(wq=t(c, c), bq=t(c), wk=t(c, c), bk=t(c), wv=t(c, c), bv=t(c),
                                  wo=t(c, c), bo=t(c), num_heads=h, flash=True),
        ln_before_gamma=t(c, off=1.0), ln_before_beta=t(c), ln_after_gamma=t(c, off=1.0),
        ln_after_beta=t(c), intermediate_kernel=t(c, f), intermediate_bias=t(f),
        output_kernel=t(f, c), output_bias=t(c), fused=True)
    x = t(4, 16, c)
    assert layer.fused_route(torch.float32, x.device, 16)
    before = dict(ftl.LAUNCHES)
    flash_before = fa.LAUNCHES["flash_mha"]
    got = layer(x, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    assert {k: ftl.LAUNCHES[k] - before[k] for k in F32_LAYER} == {k: 1 for k in F32_LAYER}
    assert fa.LAUNCHES["flash_mha"] == flash_before
    ops = ftl.layer_operands(layer, c, torch.float32)
    assert torch.equal(got, ftl.fused_layer_cuda(x, ops))
    monkeypatch.setattr(tmv.TransformerLayerParams, "fused_route", lambda *a, **k: False)
    unfused = layer(x, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_mha"] == flash_before + 1
    _f32_close(got, unfused)


def _ir_inputs(dev, b, hh, ww, c, e, cout):
    rng = np.random.default_rng(e)

    def t(*s, scale=0.2):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(dev)

    args = (t(c, e), t(e), t(3, 3, e), t(e), t(e, cout), t(cout))
    return t(b, hh, ww, c, scale=1.0).to(torch.bfloat16), args


# the strip kernel at the main path's shape (small B), ragged strips (W not a
# multiple of 32 or 16), ragged bands (odd H), B = 1, H or W of 1 and 2, C =
# 8 / 16 / 24, Cout past or short of 64; then shapes that the strip kernel
# does not take (C or Cout not a multiple of 8, C > 64, E > 256, Cout past
# 256 in two passes), which run on csrc/inverted_residual_wide.cu
IR_SHAPES = [(2, 64, 64, 64, 256, 64, True), (3, 12, 10, 8, 32, 16, False),
             (1, 9, 17, 24, 96, 24, True), (1, 1, 1, 8, 32, 8, True), (1, 2, 2, 8, 64, 8, True),
             (2, 1, 40, 16, 64, 16, True), (1, 37, 2, 24, 96, 24, False),
             (2, 5, 33, 64, 256, 64, True), (1, 7, 65, 32, 128, 72, False),
             (2, 3, 47, 16, 256, 32, False), (1, 9, 17, 12, 48, 12, True),
             (2, 10, 11, 64, 384, 64, True), (1, 9, 17, 20, 80, 24, False),
             (2, 7, 33, 72, 288, 72, True), (1, 8, 12, 64, 384, 264, False)]


@pytest.mark.parametrize("b,hh,ww,c,e,cout,resid", IR_SHAPES)
def test_fused_inverted_residual_kernel_matches_plain(dev, b, hh, ww, c, e, cout, resid):
    x, args = _ir_inputs(dev, b, hh, ww, c, e, cout)
    before = dict(fir.LAUNCHES)
    got = fir.fused_inverted_residual(x, *args, use_residual=resid)
    torch.cuda.synchronize()
    # the wide kernel: one launch a pass over its output channels
    wide = 0 if fir.ir_plans(c, e, cout) else -(-cout // fir.ir_wide_plan(c, cout)[1])
    assert fir.LAUNCHES["fused_inverted_residual"] == (before["fused_inverted_residual"]
                                                       + max(wide, 1))
    assert fir.LAUNCHES["inverted_residual_wide"] == before["inverted_residual_wide"] + wide
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


def test_inverted_residual_wide_route_takes_no_plan(dev):
    x, args = _ir_inputs(dev, 1, 9, 17, 12, 48, 12)
    with pytest.raises(ValueError, match="takes no plan"):
        fir.fused_ir_cuda(x, fir.ir_operands(*args), _plan=fir.IRPlan(32, 2))
    x, args = _ir_inputs(dev, 1, 9, 17, 64, 256, 64)
    with pytest.raises(ValueError, match="does not take"):
        fir.fused_ir_cuda(x, fir.ir_operands(*args), _plan=fir.IRPlan(64, 3))


# the stride-2 kernel at MobileViT-small's four downsampling blocks (small B,
# the model's planes), then ragged tiles (Ho not a multiple of 4, Wo not of
# 8), C not a multiple of 8 or 16, E not a multiple of 64, Cout up to 256
# and not a multiple of 32, a 2 x 2 input
IR_S2_SHAPES = [(2, 128, 128, 32, 128, 64), (2, 64, 64, 64, 256, 96),
                (2, 32, 32, 96, 384, 128), (2, 16, 16, 128, 512, 160),
                (1, 10, 18, 24, 96, 40), (2, 6, 34, 8, 200, 256), (3, 2, 2, 12, 64, 8),
                (1, 20, 12, 130, 70, 33), (1, 12, 10, 16, 512, 160)]


@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hh,ww,c,e,cout", IR_S2_SHAPES)
def test_inverted_residual_stride_2_kernel_matches_plain(dev, b, hh, ww, c, e, cout, cd):
    """Stride 2 launches csrc/inverted_residual_s2.cu at bf16 and f32: f32
    within 1e-5 of the plain version's largest value (TF32 off); bf16 within
    2^-6 of it, the mean error within 0.01 of the plain version's own
    distance between rounding to bf16 and not (chip_smoke.py's limits for
    kernel 8); two launches bit-equal, the counters, and the shared memory
    reckoned as the kernel reckons it."""
    x, args = _ir_inputs(dev, b, hh, ww, c, e, cout)
    x = x.float().to(cd)
    name = "inverted_residual_s2_f32" if cd == torch.float32 else "inverted_residual_s2"
    before = dict(fir.LAUNCHES)
    got = fir.fused_inverted_residual(x, *args, stride=2, compute_dtype=cd)
    again = fir.fused_inverted_residual(x, *args, stride=2, compute_dtype=cd)
    torch.cuda.synchronize()
    assert fir.LAUNCHES[name] == before[name] + 2
    assert fir.LAUNCHES["fused_inverted_residual"] == before["fused_inverted_residual"] + 2
    assert got.dtype == cd and got.shape == (b, hh // 2, ww // 2, cout)
    assert torch.equal(got, again)
    plain = (args[0].to(cd), args[1], args[2], args[3], args[4].to(cd), args[5])
    want = fir.fused_ir_plain(x, *plain, stride=2).float()
    scale = float(want.abs().max())
    err = (got.float() - want).abs()
    if cd == torch.float32:
        assert float(err.max()) <= 1e-5 * scale
    else:
        gap = float((fir.fused_ir_plain(x.float(), *args, stride=2) - want).abs().mean())
        assert float(err.max()) <= 2 ** -6 * scale and float(err.mean()) <= 0.01 * gap
    lib = fir._lib("inverted_residual_s2")
    assert lib.gxt_ir_s2_smem(int(cd == torch.float32), c, e, cout) == \
        fir.ir_s2_smem_bytes(c, e, cout, cd)


def test_inverted_residual_stride_2_refuses_what_it_does_not_take(dev):
    """The stride-2 kernel raises on odd H or W, a residual, Cout past 256, a
    C whose f32 halo does not fit the block's shared memory, and f16; it
    never falls back."""
    x, args = _ir_inputs(dev, 1, 8, 8, 8, 32, 8)
    for cd in (torch.bfloat16, torch.float32):
        xc = x.float().to(cd)
        with pytest.raises(ValueError, match="even H and W"):
            fir.fused_inverted_residual(xc[:, :7], *args, stride=2, compute_dtype=cd)
        with pytest.raises(ValueError, match="even H and W"):
            fir.fused_inverted_residual(xc[:, :, :5], *args, stride=2, compute_dtype=cd)
        with pytest.raises(ValueError, match="no residual"):
            fir.fused_inverted_residual(xc, *args, stride=2, use_residual=True, compute_dtype=cd)
        with pytest.raises(ValueError, match="no residual"):
            fir.fused_ir_s2_cuda(xc, fir.ir_s2_operands(*args, compute_dtype=cd),
                                 use_residual=True)
    wide, wargs = _ir_inputs(dev, 1, 8, 8, 8, 32, fir.S2_MAX_COUT + 8)
    with pytest.raises(ValueError, match="Cout up to 256"):
        fir.fused_inverted_residual(wide, *wargs, stride=2)
    big, bargs = _ir_inputs(dev, 1, 8, 8, 512, 64, 32)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fir.fused_inverted_residual(big.float(), *bargs, stride=2, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fir.fused_inverted_residual(x, *args, stride=2, compute_dtype=torch.float16)


def test_inverted_residual_stride_2_block_routes_to_its_kernel_on_the_card(dev):
    """A stride-2 block with E >= 64 runs csrc/inverted_residual_s2.cu on the
    card at bf16 and f32, its operands kept on the block (one set a dtype);
    at odd H the block takes the unfused chain."""
    from ggml_experiments_tpu_torch.models.mobilevit import InvertedResidualParams
    from ggml_experiments_tpu_torch.ops.conv import ConvBNAct
    from ggml_experiments_tpu_torch.ops.norm import FoldedBN

    rng = np.random.default_rng(6)

    def t(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.2).to(dev)

    def conv(kh, cin, co, dw=False, act="silu", stride=1):
        return ConvBNAct(kernel=t(kh, kh, cin, co), bn=FoldedBN(t(co) + 1.0, t(co)),
                         activation=act, depthwise=dw, stride=stride)

    blk = InvertedResidualParams(expand_1x1=conv(1, 32, 128),
                                 conv_3x3=conv(3, 1, 128, dw=True, stride=2),
                                 reduce_1x1=conv(1, 128, 64, act="none"), fused=True)
    x = torch.randn((2, 24, 20, 32), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    for cd, name in ((torch.bfloat16, "inverted_residual_s2"),
                     (torch.float32, "inverted_residual_s2_f32")):
        before = fir.LAUNCHES[name]
        got = blk(x, compute_dtype=cd)
        ops = fir.block_operands(blk, cd)
        again = blk(x, compute_dtype=cd)
        torch.cuda.synchronize()
        assert fir.LAUNCHES[name] == before + 2 and got.shape == (2, 12, 10, 64)
        assert isinstance(ops, fir.IRTCOperands) and ops.dtype == cd
        assert fir.block_operands(blk, cd) is ops and torch.equal(got, again)
        want = fir.fused_inverted_residual(x, *fir._folded(blk), stride=2, compute_dtype=cd)
        assert torch.equal(got, want)
    before = fir.LAUNCHES["fused_inverted_residual"]
    odd = blk(x[:, :23], compute_dtype=torch.bfloat16)
    assert fir.LAUNCHES["fused_inverted_residual"] == before and odd.shape == (2, 12, 10, 64)


# the f32 kernel at layer_2's shape (small B), ragged tiles, every reduce
# width (Cout 8 .. 128), C not a multiple of 8, E past one chunk and not a
# multiple of 64
IR_F32_SHAPES = [(2, 64, 64, 64, 256, 64, True), (1, 16, 16, 16, 64, 32, False),
                 (2, 9, 17, 24, 96, 24, True), (1, 7, 13, 12, 48, 100, False),
                 (3, 5, 33, 8, 200, 8, True), (1, 1, 1, 8, 32, 128, False)]


@pytest.mark.parametrize("b,hh,ww,c,e,cout,resid", IR_F32_SHAPES)
def test_inverted_residual_f32_kernel_matches_plain(dev, b, hh, ww, c, e, cout, resid):
    """f32 at stride 1 launches csrc/inverted_residual_f32.cu: within 1e-5 of
    the plain version's largest value (TF32 off), two launches bit-equal,
    its shared memory reckoned as the kernel reckons it."""
    x, args = _ir_inputs(dev, b, hh, ww, c, e, cout)
    x = x.float()
    before = dict(fir.LAUNCHES)
    got = fir.fused_inverted_residual(x, *args, use_residual=resid, compute_dtype=torch.float32)
    again = fir.fused_inverted_residual(x, *args, use_residual=resid,
                                        compute_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fir.LAUNCHES["inverted_residual_f32"] == before["inverted_residual_f32"] + 2
    assert fir.LAUNCHES["fused_inverted_residual"] == before["fused_inverted_residual"] + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    want = fir.fused_ir_plain(x, *args, use_residual=resid)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    lib = fir._lib("inverted_residual_f32")
    assert lib.gxt_ir_f32_smem(c, e, cout) == fir.ir_f32_smem_bytes(c, e, cout)


# every tile of csrc/ir_hopper.cuh, reached through C (the kernels pick the
# widest tile whose shared memory fits), at small ragged shapes: (stride,
# dtype, B, H, W, C, E, Cout, residual, the tile)
IR_TILE_CASES = [(1, torch.float32, 2, 9, 17, 16, 96, 16, True, (8, 16)),
                 (1, torch.bfloat16, 2, 9, 17, 72, 288, 72, True, (8, 16)),
                 (1, torch.bfloat16, 1, 13, 35, 328, 64, 100, False, (8, 8)),
                 (1, torch.bfloat16, 1, 7, 13, 584, 48, 24, False, (4, 8)),
                 (1, torch.bfloat16, 1, 7, 13, 840, 96, 840, True, (4, 8)),
                 (1, torch.bfloat16, 1, 5, 11, 1100, 24, 72, False, (4, 8)),
                 (1, torch.bfloat16, 1, 8, 12, 64, 384, 264, False, (8, 8)),
                 (1, torch.float32, 1, 13, 35, 96, 64, 100, False, (8, 8)),
                 (1, torch.float32, 1, 7, 13, 192, 48, 24, False, (4, 8)),
                 (2, torch.float32, 1, 12, 10, 16, 512, 160, False, (8, 8)),
                 (2, torch.float32, 2, 18, 34, 64, 200, 96, False, (4, 8)),
                 (2, torch.float32, 1, 12, 10, 128, 64, 160, False, (2, 8)),
                 (2, torch.bfloat16, 1, 12, 10, 16, 512, 160, False, (8, 8)),
                 (2, torch.bfloat16, 2, 18, 34, 128, 200, 96, False, (8, 8)),
                 (2, torch.bfloat16, 1, 12, 10, 256, 64, 96, False, (4, 8)),
                 (2, torch.bfloat16, 1, 10, 14, 512, 64, 96, False, (2, 8))]


@pytest.mark.parametrize("stride,cd,b,hh,ww,c,e,cout,resid,tile", IR_TILE_CASES)
def test_inverted_residual_hopper_tiles_match_plain_on_every_tile(dev, stride, cd, b, hh, ww, c,
                                                                  e, cout, resid, tile):
    """Each output tile of the f32 stride-1, the bf16 stride-1 (wide) and the
    stride-2 kernels, as the kernel (or ir_wide_plan) picks it from C (past
    C = 768 the wide kernel's Wexp^T in pieces of slabs: two at C = 840,
    three at 1100): f32 within 1e-5 of the plain version's largest value,
    bf16 within chip_smoke.py's limits for kernel 8; two launches bit-equal;
    the launch's shared memory as the kernel reckons it."""
    wide = stride == 1 and cd == torch.bfloat16
    assert (fir.ir_wide_plan(c, cout)[0] if wide
            else fir.ir_tc_tile(cd == torch.float32, stride, c, cout)) == tile
    x, args = _ir_inputs(dev, b, hh, ww, c, e, cout)
    x = x.float().to(cd)
    pargs = (args[0].to(cd), args[1], args[2], args[3], args[4].to(cd), args[5])
    want = fir.fused_ir_plain(x, *pargs, stride=stride, use_residual=resid).float()
    scale = float(want.abs().max())
    if wide:
        ops = fir.ir_wide_operands(*args)
        got, again = (fir.fused_ir_wide_cuda(x, ops, use_residual=resid) for _ in range(2))
        lib = fir._lib("inverted_residual_wide")
        assert lib.gxt_ir_wide_smem(fir.IR_TC_TILES[1].index(tile), -(-c // 8) * 8, ops.ncp,
                                    ops.wsl) == fir.ir_wide_smem_bytes(tile, c, ops.ncp, ops.wsl)
    elif stride == 1:
        ops = fir.ir_f32_operands(*args)
        got, again = (fir.fused_ir_f32_cuda(x, ops, use_residual=resid) for _ in range(2))
        lib = fir._lib("inverted_residual_f32")
        assert lib.gxt_ir_f32_smem(c, e, cout) == fir.ir_f32_smem_bytes(c, e, cout)
    else:
        ops = fir.ir_s2_operands(*args, compute_dtype=cd)
        got, again = (fir.fused_ir_s2_cuda(x, ops) for _ in range(2))
        lib = fir._lib("inverted_residual_s2")
        assert lib.gxt_ir_s2_smem(int(cd == torch.float32), c, e, cout) == \
            fir.ir_s2_smem_bytes(c, e, cout, cd)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err = (got.float() - want).abs()
    if cd == torch.float32:
        assert float(err.max()) <= 1e-5 * scale
    else:
        gap = float((fir.fused_ir_plain(x.float(), *args, stride=stride, use_residual=resid)
                     - want).abs().mean())
        assert float(err.max()) <= 2 ** -6 * scale and float(err.mean()) <= 0.01 * gap


# f32 blocks wider than the tile kernels take (the parent design's widest:
# C = 408 at stride 1, 280 at stride 2): (stride, C, E, Cout)
IR_TC_TOO_WIDE = [(1, 408, 64, 128), (2, 280, 64, 64)]


@pytest.mark.parametrize("stride,c,e,cout", IR_TC_TOO_WIDE)
def test_inverted_residual_too_wide_for_a_tile_runs_unfused_on_the_card(dev, stride, c, e, cout):
    """An f32 block whose C no tile of the f32 stride-1 or the stride-2
    kernel fits keeps the unfused chain on the card, launches no kernel of
    the inverted residual, and agrees with the CPU's chain within 1e-4 of
    its largest value; the wrapper refuses it for its shared memory."""
    from ggml_experiments_tpu_torch.models.mobilevit import InvertedResidualParams
    from ggml_experiments_tpu_torch.ops.conv import ConvBNAct
    from ggml_experiments_tpu_torch.ops.norm import FoldedBN

    rng = np.random.default_rng(c)
    shapes = ((1, 1, c, e), (e,), (e,), (3, 3, 1, e), (e,), (e,), (1, 1, e, cout), (cout,),
              (cout,))
    arrays = [rng.standard_normal(s).astype(np.float32) * 0.2 for s in shapes]

    def block(d):
        a = [torch.from_numpy(v).to(d) for v in arrays]

        def conv(k, scale, bias, **kw):
            return ConvBNAct(kernel=k, bn=FoldedBN(scale + 1.0, bias), **kw)

        return InvertedResidualParams(
            expand_1x1=conv(*a[0:3], activation="silu"),
            conv_3x3=conv(*a[3:6], activation="silu", depthwise=True, stride=stride),
            reduce_1x1=conv(*a[6:9], activation="none"), fused=True)

    cpu, blk = block("cpu"), block(dev)
    assert not blk.fused_route(torch.float32, dev, (12, 10))
    x = torch.from_numpy(rng.standard_normal((2, 12, 10, c)).astype(np.float32))
    before = dict(fir.LAUNCHES)
    got = blk(x.to(dev), compute_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fir.LAUNCHES == before
    want = cpu(x, compute_dtype=torch.float32)
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())
    args = fir._folded(blk)
    if stride == 1:
        ops, launch = fir.ir_f32_operands(*args), fir.fused_ir_f32_cuda
    else:
        ops, launch = fir.ir_s2_operands(*args, compute_dtype=torch.float32), fir.fused_ir_s2_cuda
    with pytest.raises(ValueError, match="bytes of shared memory"):
        launch(x.to(dev), ops)


def test_f32_silu_departs_from_the_plain_version_only_below_minus_86_6(dev):
    """The f32 kernels' SiLU (mma_common.cuh silu_rn) against z * (1 / (1 +
    exp(-z))) over a sweep of z, read through the f32 stride-1 kernel with
    Wexp = 0 (so the expand's value is bexp = z), the depthwise's centre tap
    s a power of two and Wred = I: out = SiLU(s SiLU(z)), every step exact
    but the SiLUs (s = 2^64 below z = -70 keeps y's tf32 lo part out of the
    subnormals, which the tensor cores flush). Within 2^-19 of its value
    (the two exponentials' ulps), but where 1 + exp(-z) >= 2^125 (z <
    -86.64), whose reciprocal it takes as 0: there the kernel gives 0 and
    the plain version about -1e-36 s, and below z = -88.72 both give 0."""
    def silu(v):
        return v * (1.0 / (1.0 + torch.exp(-v)))

    z = torch.cat([torch.linspace(-100.0, 40.0, 384), torch.linspace(-88.7, -86.5, 128)])
    for zc in z.split(128):
        n = zc.numel()
        tap = torch.where(zc < -70.0, 2.0 ** 64, 1.0)
        kdw = torch.zeros((3, 3, n))
        kdw[1, 1] = tap
        args = (torch.zeros((16, n)), zc, kdw, torch.zeros(n), torch.eye(n), torch.zeros(n))
        ops = fir.ir_f32_operands(*(a.to(dev) for a in args))
        got = fir.fused_ir_f32_cuda(torch.randn((1, 4, 4, 16), device=dev), ops).cpu()
        want = silu(tap * silu(zc)).expand_as(got)
        zz = zc.expand_as(got)
        gone = (got == 0) & (want != 0)
        assert bool((zz[gone] < -86.64).all())
        assert bool(gone[(zz < -86.65) & (zz > -88.6)].all())
        bad = ~gone & ((got - want).abs() > 2 ** -19 * want.abs())
        assert not bool(bad.any()), (zz[bad][:4], got[bad][:4], want[bad][:4])


def test_f32_layer_silu_departs_from_the_plain_version_only_below_minus_86_6(dev):
    """The f32 layer's SiLU (the FFN's and the out-projection's,
    mma_common.cuh silu_rn) read through proj_ffn's out-projection with
    Wout = 0 and BN scale 1, so that output column j is SiLU(z_j) of its BN
    bias: within 2^-19 of z * (1 / (1 + exp(-z))), but where 1 + exp(-z) >=
    2^125 (z < -86.64), whose reciprocal it takes as 0: there the kernel
    gives 0 and the plain version about -1e-36, and below z = -88.72 both
    give 0."""
    def silu(v):
        return v * (1.0 / (1.0 + torch.exp(-v)))

    z = torch.cat([torch.linspace(-100.0, 40.0, 384), torch.linspace(-88.7, -86.5, 128)])
    ops = _layer_ops(dev, 48, 4, 96, 48, z.numel(), False, True, seed=3)
    ops = dataclasses.replace(ops, **{k: getattr(ops, k).float() for k in (
        "wq", "wk", "wv", "wo", "wi", "wo2")}, wout=torch.zeros((48, z.numel()), device=dev),
        out_affine=(torch.ones(z.numel(), device=dev), z.to(dev)), out_act=True, cache={})
    g = torch.Generator(device=dev).manual_seed(4)
    x2, ctx = (torch.randn((48, 48), generator=g, device=dev) for _ in range(2))
    got = ftl.proj_ffn_cuda(x2, ctx, ops, 16).cpu()
    want = silu(z).expand_as(got)
    zz = z.expand_as(got)
    gone = (got == 0) & (want != 0)
    assert bool((zz[gone] < -86.64).all())
    assert bool(gone[(zz < -86.65) & (zz > -88.6)].all())
    bad = ~gone & ((got - want).abs() > 2 ** -19 * want.abs())
    assert not bool(bad.any()), (zz[bad][:4], got[bad][:4], want[bad][:4])


# ---- 3xTF32 operands below 2^-115 (ROADMAP: the port's accepted divergences) --------------
#
# Every 3xTF32 product splits an f32 operand into a tf32 hi part and the
# rest; below about 2^-115 the rest is an f32 subnormal, which the tensor
# cores were seen to flush in one kernel (an inverted residual's reduce).
# Each case below scales one operand's entries (or rows, or columns) to
# about 2^-118 (above 2^-126, where the hi part would go too), with biases
# zero there, so that the outputs they alone feed are themselves tiny;
# those outputs stay within 2^-14 of their own largest value of the plain
# version (f32 throughout, TF32 off: on an H100 they read 3e-7 to 4.2e-6,
# no lost lo part shows), and every other output within the kernel's
# usual tolerance of the others' largest.

TINY_CASES = ("ln_qkv_f32", "attention_f32", "proj_ffn_f32", "train_fwd_f32", "train_bwd_f32",
              "train_dwr_f32", "flash_f32", "qmatmul_f32", "ir_f32", "ir_s2_f32")


def _tiny_layer(dev):
    ops = _layer_ops(dev, 48, 4, 96, 48, 40, False, True, seed=11)
    return dataclasses.replace(ops, **{k: getattr(ops, k).float().clone() for k in (
        "wq", "wk", "wv", "wo", "wi", "wo2", "wout")}, bq=ops.bq.clone(), out_act=False,
        out_affine=tuple(v.clone() for v in ops.out_affine), cache={})


def _tiny_case(name, dev):
    """(outputs, plain outputs, masks of the outputs the tiny entries alone
    feed, the kernel's usual tolerance) of one 3xTF32 kernel."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    f32 = torch.float32
    g = torch.Generator(device=dev).manual_seed(21)

    def rnd(*s):
        return torch.randn(s, generator=g, device=dev)

    def cols(shape, n):
        m = torch.zeros(shape, dtype=torch.bool, device=dev)
        m[..., :n] = True
        return m

    if name in ("ln_qkv_f32", "attention_f32", "proj_ffn_f32"):
        ops, l = _tiny_layer(dev), 16
        x2 = rnd(3 * l, 48)
        if name == "ln_qkv_f32":    # q's first 5 columns: Wq's columns tiny, bq 0
            ops.wq[:, :5] *= 2.0 ** -116
            ops.bq[:5] = 0.0
            got, want = ftl.ln_qkv_cuda(x2, ops, l), ftl.ln_qkv_plain(x2, ops)
            return [got], [want], [cols(got.shape, 5)], 1e-5
        qkv = ftl.ln_qkv_plain(x2, ops)
        if name == "attention_f32":   # v's first 5 columns of head 0 tiny
            v0 = 2 * 4 * ftl.head_pad(12)
            qkv[:, v0:v0 + 5] *= 2.0 ** -118
            got, want = ftl.attention_cuda(qkv, l, ops), ftl.attention_plain(qkv, l, ops)
            return [got], [want], [cols(got.shape, 5)], 1e-5
        ctx = ftl.attention_plain(qkv, l, ops)   # Wout's first 5 columns tiny, BN 1 and 0
        ops.wout[:, :5] *= 2.0 ** -116
        ops.out_affine[0][:5], ops.out_affine[1][:5] = 1.0, 0.0
        got, want = ftl.proj_ffn_cuda(x2, ctx, ops, l), ftl.proj_ffn_plain(x2, ctx, ops)
        return [got], [want], [cols(got.shape, 5)], 1e-5
    if name.startswith("train"):
        mxs, h0, wr, brec, dys = train_operands(dev, 3, 64, 96, cd=f32)
        if name == "train_fwd_f32":   # mh's first 8 columns: Wr's columns tiny, b_rec 0
            wr[:, :8] *= 2.0 ** -115
            brec[:8] = 0.0
            got = ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
            want = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
            return [got[1], got[0]], [want[1], want[0]], [cols(got[1].shape, 8),
                                                          cols(got[0].shape, 0)], 1e-5
        ys, mhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
        if name == "train_bwd_f32":   # the first 8 batch rows' cotangents tiny
            dys[:, :8] *= 2.0 ** -115
            got = ft.gru_train_bwd_rec_cuda(mxs, mhs, ys, dys, h0, wr)
            want = ft.gru_train_bwd_rec_plain(mxs, mhs, ys, dys, h0, wr)
            rows = [torch.zeros(t.shape, dtype=torch.bool, device=dev) for t in want]
            for m, t in zip(rows, want):
                if t.dim() == 3:
                    m[:, :8] = True
                elif t.dim() == 2:
                    m[:8] = True
            return list(got), list(want), rows, 1e-4
        dmxs, plane, _, _ = ft.gru_train_bwd_rec_plain(mxs, mhs, ys, dys, h0, wr)
        dmxs[..., :8] *= 2.0 ** -114   # dWr's first 8 columns
        got = ft.gru_train_dwr_cuda(h0, ys, dmxs, plane)
        return [got], [ft.gru_train_dwr_plain(h0, ys, dmxs, plane)], [cols(got.shape, 8)], 1e-5
    if name == "flash_f32":           # v's first 6 columns tiny
        q, k, v = (rnd(3, 32, 48) for _ in range(3))
        v[..., :6] *= 2.0 ** -118
        got = fa.flash_mha(q, k, v, 4, compute_dtype=f32)
        return [got], [fa.flash_mha_plain(q, k, v, 4)], [cols(got.shape, 6)], 1e-5
    if name == "qmatmul_f32":         # x's first 8 rows tiny
        qt = qweight(dev, "q8_0", 256, 192)
        x = xrand(dev, 64, 256)
        x[:8] *= 2.0 ** -118
        got = qmatmul_cuda(x, qt, f32)
        m = torch.zeros(got.shape, dtype=torch.bool, device=dev)
        m[:8] = True
        return [got], [qmatmul_plain_f32(x, qt, f32)], [m], 1e-5
    # the inverted residual: Wred's first 4 columns tiny, their biases 0
    x, args = _ir_inputs(dev, 1, 16, 16, 16, 64, 32)
    x, args = x.float(), [a.clone() for a in args]
    args[4][:, :4] *= 2.0 ** -116
    args[5][:4] = 0.0
    stride = 2 if name == "ir_s2_f32" else 1
    got = fir.fused_inverted_residual(x, *args, stride=stride, compute_dtype=f32)
    want = fir.fused_ir_plain(x, *args, stride=stride)
    return [got], [want], [cols(got.shape, 4)], 1e-5


@pytest.mark.parametrize("name", TINY_CASES)
def test_3xtf32_kernels_hold_an_operand_below_2_to_the_minus_115(dev, name):
    """Pinned for every 3xTF32 kernel of the port: the outputs
    that an operand below 2^-115 alone feeds depart from the plain version
    by at most 2^-14 of their own largest value (which the usual
    tolerance, relative to the whole output's largest, cannot see); no
    other output moves past the kernel's usual tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    outs, wants, masks, tol = _tiny_case(name, dev)
    torch.cuda.synchronize()
    for got, want, mask in zip(outs, wants, masks):
        assert got.shape == want.shape and bool(torch.isfinite(got).all()), name
        d = (got - want).abs()
        if (~mask).any():
            rest = float(want[~mask].abs().max())
            assert float(d[~mask].max()) <= tol * rest, (name, float(d[~mask].max()), rest)
        if mask.any():
            tiny = float(want[mask].abs().max())
            dep = float(d[mask].max())
            assert 0.0 < tiny < 2.0 ** -100, (name, tiny)
            assert dep <= 2.0 ** -14 * tiny, (name, dep / tiny)
            print(f"{name}: the tiny outputs' departure {dep / tiny:.3g} of their largest "
                  f"({tiny:.3g})")


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


def test_inverted_residual_block_routes_f32_to_its_kernel_on_the_card(dev):
    """At f32 a stride-1 block with E >= 64 runs csrc/inverted_residual_f32.cu
    on the card, with its operands kept on the block; the CPU's f32 route is
    the unfused chain."""
    from ggml_experiments_tpu_torch.models.mobilevit import InvertedResidualParams
    from ggml_experiments_tpu_torch.ops.conv import ConvBNAct
    from ggml_experiments_tpu_torch.ops.norm import FoldedBN

    rng = np.random.default_rng(4)

    def t(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.2).to(dev)

    def conv(kh, cin, co, dw=False, act="silu"):
        return ConvBNAct(kernel=t(kh, kh, cin, co), bn=FoldedBN(t(co) + 1.0, t(co)),
                         activation=act, depthwise=dw)

    blk = InvertedResidualParams(expand_1x1=conv(1, 16, 64), conv_3x3=conv(3, 1, 64, dw=True),
                                 reduce_1x1=conv(1, 64, 32, act="none"), fused=True)
    x = torch.randn((2, 24, 20, 16), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    before = fir.LAUNCHES["inverted_residual_f32"]
    got = blk(x, compute_dtype=torch.float32)
    ops = fir.block_operands(blk, torch.float32)
    again = blk(x, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fir.LAUNCHES["inverted_residual_f32"] == before + 2
    assert fir.block_operands(blk, torch.float32) is ops and torch.equal(got, again)
    want = fir.fused_inverted_residual(x, *fir._folded(blk), compute_dtype=torch.float32)
    assert torch.equal(got, want)
    assert not blk.fused_route(torch.float32, "cpu")


def test_vision_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((2, 8, 8, 8), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((8, 32), device=dev)
    with pytest.raises(ValueError, match="stride 1 or 2"):
        fir.fused_inverted_residual(x, w, w[0], torch.zeros(3, 3, 32, device=dev), w[0],
                                    w.t(), w[:, 0], stride=3)
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


def test_differentiable_collectives_on_the_card_in_a_one_rank_group(dev):
    """In a one-rank gloo group on CUDA tensors: the gather's backward hands
    the rank its own slice (here the whole gradient, unsummed), the input
    gradient sum and the ordered all-reduce are the identity, and a train
    step's loss and gradients on a (1, 1) mesh equal one process's bit for
    bit (``loss_and_grads``). The group is left at the end, so that the
    engine tests see a process outside any group."""
    import socket

    from ggml_experiments_tpu_torch.parallel import DATA_AXIS, make_mesh, multihost
    from ggml_experiments_tpu_torch.training import gru_trainer as tr

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    multihost.initialize("cpu:gloo,cuda:gloo", f"tcp://localhost:{port}", 1, 0,
                         device="cuda:0", timeout_s=120)
    try:
        x = torch.randn((4, 6), device=dev, requires_grad=True)
        g = torch.randn((4, 6), device=dev)
        y = multihost.all_gather(x, None, dim=1)
        (y * g).sum().backward()
        assert torch.equal(y, x) and torch.equal(x.grad, g)
        x.grad = None
        (multihost.sum_grad(x) * g).sum().backward()
        assert torch.equal(x.grad, g)
        assert torch.equal(multihost.all_reduce_sum(g), g)
        mesh = make_mesh((1, 1))
        assert mesh.group(DATA_AXIS) is not None
        p = make_params(dev, None)
        for _, t in tr.param_leaves(p):
            t.requires_grad_(True)
        rng = np.random.default_rng(3)
        ids = torch.from_numpy(rng.integers(0, V, (64, 12))).to(dev)
        want = tr.loss_and_grads(p, ids, ids.roll(-1, 1), None, compute_dtype=torch.bfloat16)
        got = tr.loss_and_grads(p, ids, ids.roll(-1, 1), mesh, compute_dtype=torch.bfloat16)
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    finally:
        multihost.shutdown()


# ---- AOT artifacts on the card --------------------------------------------------------------


def test_exported_q8_0_gru_artifact_runs_the_qmatmul_kernel(dev, tmp_path):
    """A q8_0 decode artifact exported on the card replays through the
    gxt::qmatmul op: tokens equal to eager generate on params an eager call
    has used (their launch caches filled), one kernel launch a step (the
    recurrent kernel, U = 1024, is past the matmul gate)."""
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.serving import aot

    rng = np.random.default_rng(6)
    u = 1024
    a = {"embeddings": rng.normal(0, 0.5, (V, E)), "kernel": rng.normal(0, 0.1, (E, 3 * u)),
         "recurrent_kernel": rng.normal(0, 0.03, (u, 3 * u)),
         "bias": rng.normal(0, 0.1, (2, 3 * u)), "dense_kernel": rng.normal(0, 0.1, (u, V)),
         "dense_bias": rng.normal(0, 0.1, (V,))}
    p = params_from_numpy({k: x.astype(np.float32) for k, x in a.items()}, qtype="q8_0",
                          device=dev)
    path = str(tmp_path / "decode.gxa")
    aot.export_gru_decode(p, batch=4, prompt_len=6, total_steps=12, path=path, qtype="q8_0")
    _, ep = aot.load_artifact(path)
    prompt = torch.randint(0, V, (4, 6), dtype=torch.int32, device=dev)
    lengths = torch.full((4,), 3, dtype=torch.int32, device=dev)
    want = gru_textgen.generate(p, prompt, lengths, 12)
    assert "launch" in p.cell.recurrent_kernel.dense
    before = qmm_launches["qmatmul_q8_0"]
    got = aot.call_artifact(ep, p, prompt, lengths)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert qmm_launches["qmatmul_q8_0"] == before + 12


# ---- sequences past a block's shared memory (layer_3 at 512 px: L = 1024) ----------------


@pytest.mark.parametrize("l", [640, 1024])
def test_bf16_attention_streams_long_sequences(dev, l):
    """Past 256 keys the bf16 attention keeps four query tiles resident and
    streams the keys twice: two launches bit-equal, the streamed counter
    bumped, within the layer's bf16 bounds of attention_plain; at 256 the
    streamed plan forced gives the resident plan's bits."""
    ops = _layer_ops(dev, 144, 4, 288, 144, 144, False, False, seed=l)
    x2 = torch.randn((4 * l, 144), generator=torch.Generator(device=dev).manual_seed(l),
                     device=dev).to(torch.bfloat16)
    qkv = ftl.ln_qkv_plain(x2, ops)
    assert ftl.attention_plan(l) == "streamed"
    before = dict(ftl.LAUNCHES)
    got, again = (ftl.attention_cuda(qkv, l, ops) for _ in range(2))
    torch.cuda.synchronize()
    assert ftl.LAUNCHES["transformer_attention_streamed"] == (
        before["transformer_attention_streamed"] + 2)
    assert torch.equal(got, again), "two launches on the same inputs differ"
    _bf16_close(got, ftl.attention_plain(qkv, l, ops), 0.05, 2e-3)
    q256 = qkv[:4 * 256]
    assert torch.equal(ftl.attention_cuda(q256, 256, ops, _plan="streamed"),
                       ftl.attention_cuda(q256, 256, ops, _plan="resident"))
    with pytest.raises(ValueError, match="attention plan streamed"):
        ftl.attention_cuda(qkv[:48], 16, ops, _plan="streamed")


@pytest.mark.parametrize("l", [640, 1024, 4096])
def test_f32_attention_walks_long_sequences_in_windows(dev, l):
    """Past 256 keys the f32 attention walks windows of 256 keys with a
    running max: within 1e-5 of the largest value of attention_plain, two
    launches bit-equal, the streamed counter bumped."""
    ops = _layer_ops(dev, 144, 4, 288, 144, 144, False, False, seed=l)
    ops = dataclasses.replace(ops, **{k: getattr(ops, k).float() for k in (
        "wq", "wk", "wv", "wo", "wi", "wo2")}, cache={})
    x2 = torch.randn((4 * l, 144), generator=torch.Generator(device=dev).manual_seed(l),
                     device=dev)
    qkv = ftl.ln_qkv_plain(x2, ops)
    before = ftl.LAUNCHES["transformer_attention_f32_streamed"]
    got, again = (ftl.attention_cuda(qkv, l, ops) for _ in range(2))
    torch.cuda.synchronize()
    assert ftl.LAUNCHES["transformer_attention_f32_streamed"] == before + 2
    assert torch.equal(got, again), "two launches on the same inputs differ"
    _f32_close(got, ftl.attention_plain(qkv, l, ops))
    _f32_close(ftl.fused_layer_cuda(x2.reshape(4, l, 144), ops),
               ftl.fused_transformer_layer_plain(x2.reshape(4, l, 144), ops))


@pytest.mark.parametrize("l", [640, 1024])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_flash_mha_streams_long_sequences(dev, l, cd):
    g = torch.Generator(device=dev).manual_seed(l)
    q, k, v = (torch.randn((4, l, 144), generator=g, device=dev).to(cd) for _ in range(3))
    before = dict(fa.LAUNCHES)
    got, again = fa.flash_mha(q, k, v, 4, compute_dtype=cd), fa.flash_mha(q, k, v, 4,
                                                                           compute_dtype=cd)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_mha_streamed"] == before["flash_mha_streamed"] + 2
    assert torch.equal(got, again), "two launches on the same inputs differ"
    want = fa.flash_mha_plain(q, k, v, 4)
    if cd == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    else:
        _bf16_close(got, want, 2 ** -6, 1e-3)


@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_mobilevit_at_512_px_runs_the_streamed_kernels(dev, cd):
    """The full MobileViT-small checkpoint at 512 px on the default routes:
    layer_3's two layers (L = 1024) launch the streamed attention, the
    other layers the resident one; the features finite, (B, 16, 16, 640)."""
    import os

    from ggml_experiments_tpu_torch.models import mobilevit as tmv

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = tmv.load_mobilevit(os.path.join(root, "checkpoints", "mobilevit_synth_full.ggml"),
                           device=dev)
    x = torch.rand((2, 512, 512, 3), generator=torch.Generator(device=dev).manual_seed(5),
                   device=dev)
    before = dict(ftl.LAUNCHES)
    feats = tmv.extract_features(p, x, compute_dtype=cd)
    torch.cuda.synchronize()
    d = {k: ftl.LAUNCHES[k] - before[k] for k in before}
    assert feats.shape == (2, 16, 16, 640) and bool(torch.isfinite(feats.float()).all())
    if cd == torch.bfloat16:
        assert d["transformer_attention"] == 9 and d["transformer_attention_streamed"] == 2
    else:
        assert d["transformer_attention_f32"] == 9
        assert d["transformer_attention_f32_streamed"] == 2


# ---- bf16 widths past every plan: the routes ask the plans before any launch

def _vision_twins(dev, build):
    """The same params on the card and on the CPU (``build(t)`` with ``t``
    making a tensor on one device from the seeded numpy arrays)."""
    out = []
    for d in (dev, torch.device("cpu")):
        rng = np.random.default_rng(17)

        def t(*s, off=0.0, d=d, rng=rng):
            return torch.from_numpy((rng.standard_normal(s) * 0.1 + off).astype(np.float32)).to(d)

        out.append(build(t))
    return out


def test_bf16_shapes_past_the_plans_run_unfused_on_the_card(dev):
    """A bf16 stride-1 block at C = 1600 (past the wide kernel), layers at C =
    1280 (past the row tiles) and at heads of 80, flash attention at heads
    of 80: on the card the routes say no before any launch, no kernel of
    theirs launches (but flash attention in the C = 1280 layer's unfused
    chain, whose heads are 64 wide), and the unfused chain meets the CPU's
    output (the JAX model's route there, the fused plain versions) within
    bf16's limits."""
    from ggml_experiments_tpu_torch.models import mobilevit as tmv
    from ggml_experiments_tpu_torch.ops.attention import AttentionParams, multi_head_attention
    from ggml_experiments_tpu_torch.ops.conv import ConvBNAct
    from ggml_experiments_tpu_torch.ops.norm import FoldedBN

    def block(t):
        def conv(kh, cin, co, dw=False, act="silu"):
            return ConvBNAct(kernel=t(kh, kh, cin, co), bn=FoldedBN(t(co, off=1.0), t(co)),
                             activation=act, depthwise=dw)

        return tmv.InvertedResidualParams(expand_1x1=conv(1, 1600, 64),
                                          conv_3x3=conv(3, 1, 64, dw=True),
                                          reduce_1x1=conv(1, 64, 64, act="none"), fused=True)

    def layer(c, h):
        def build(t):
            return tmv.TransformerLayerParams(
                attention=AttentionParams(wq=t(c, c), bq=t(c), wk=t(c, c), bk=t(c), wv=t(c, c),
                                          bv=t(c), wo=t(c, c), bo=t(c), num_heads=h, flash=True),
                ln_before_gamma=t(c, off=1.0), ln_before_beta=t(c), ln_after_gamma=t(c, off=1.0),
                ln_after_beta=t(c), intermediate_kernel=t(c, 2 * c), intermediate_bias=t(2 * c),
                output_kernel=t(2 * c, c), output_bias=t(c), fused=True)
        return build

    bf = torch.bfloat16
    before = (dict(fir.LAUNCHES), dict(ftl.LAUNCHES), dict(fa.LAUNCHES))
    card, cpu = _vision_twins(dev, block)
    x = torch.randn((2, 12, 10, 1600), generator=torch.Generator().manual_seed(1))
    assert not card.fused_route(bf, dev, (12, 10)) and cpu.fused_route(bf, x.device, (12, 10))
    got = card(x.to(dev), compute_dtype=bf)
    _bf16_close(got.cpu(), cpu(x, compute_dtype=bf), 0.05, 5e-3)
    for c, h in ((1280, 20), (160, 2)):
        card, cpu = _vision_twins(dev, layer(c, h))
        x = torch.randn((3, 16, c), generator=torch.Generator().manual_seed(c))
        assert not card.fused_route(bf, dev, 16) and cpu.fused_route(bf, x.device, 16)
        got = card(x.to(dev), compute_dtype=bf)
        _bf16_close(got.cpu(), cpu(x, compute_dtype=bf), 0.05, 5e-3)
        if c == 160:   # flash at heads of 80: the einsum chain on the card
            got = multi_head_attention(card.attention, x.to(dev), compute_dtype=bf)
            want = multi_head_attention(cpu.attention, x, compute_dtype=bf)
            _bf16_close(got.cpu(), want, 0.05, 5e-3)
    torch.cuda.synchronize()
    # the unfused C = 1280 layer's heads of 64 are flash attention's
    assert (fir.LAUNCHES, ftl.LAUNCHES) == before[:2]
    assert fa.LAUNCHES == dict(before[2], flash_mha=before[2]["flash_mha"] + 1)


def test_bf16_block_of_odd_expansion_runs_the_wide_kernel(dev):
    """An odd E (the strip kernel takes even E only) rides the wide kernel,
    its E padded to 64 with zero channels: the route keeps it fused and the
    launch meets the plain version."""
    x, args = _ir_inputs(dev, 2, 9, 17, 64, 255, 64)
    assert not fir.ir_plans(64, 255, 64) and fir.ir_bf16_takes(64, 255, 64)
    before = fir.LAUNCHES["inverted_residual_wide"]
    got = fir.fused_inverted_residual(x, *args, use_residual=True)
    torch.cuda.synchronize()
    assert fir.LAUNCHES["inverted_residual_wide"] == before + 1
    want = fir.fused_ir_plain(x, args[0].to(torch.bfloat16), args[1], args[2], args[3],
                              args[4].to(torch.bfloat16), args[5], use_residual=True)
    _bf16_close(got, want, 2 ** -6, 1e-4)
