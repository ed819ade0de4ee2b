"""Port: the persistent fused decode and the serving tick against the JAX package.

The JAX kernels run under the Pallas interpreter on the CPU (as the JAX
package's own tests run them); the port runs the plain PyTorch versions of
its CUDA kernels. Both packages get the same quantized planes, so the only
differences left are summation orders: f32 tokens must agree exactly and
states within 1e-5. That holds for each weight route of the fused kernels:
q8_0 and q4_0 decoded in the kernel's setup, and the dense planes of any
other or mixed format.
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_experiments_tpu import quant as jquant
from ggml_experiments_tpu.models import gru_textgen as jg
from ggml_experiments_tpu.ops.gru import GRUCellParams as JCell
from ggml_experiments_tpu.serving import engine as jengine
from ggml_experiments_tpu_torch.convert import params_from_numpy
from ggml_experiments_tpu_torch.models import gru_textgen as tg
from ggml_experiments_tpu_torch.ops import fused_gru_decode as tf
from ggml_experiments_tpu_torch.serving import engine as tengine

# the JAX ops package re-exports a function under the module's name
jf = importlib.import_module("ggml_experiments_tpu.ops.fused_gru_decode")

V, E, U = 66, 16, 64


def jax_planes(jq):
    out = {"shape": jq.shape, "qtype": jq.qtype}
    for name in ("codes", "scales", "mins", "hibits", "supers"):
        if getattr(jq, name) is not None:
            out[name] = np.asarray(getattr(jq, name))
    return out


def make_twins(seed=3, e=E, u=U, qtype="q8_0", head_qtype=None):
    """The same random GRU as JAX params and as port params (the planes are
    handed over from the JAX QTensors); the head may take another format."""
    rng = np.random.default_rng(seed)
    a = {
        "embeddings": rng.normal(0, 0.5, (V, e)),
        "kernel": rng.normal(0, 1 / np.sqrt(e), (e, 3 * u)),
        "recurrent_kernel": rng.normal(0, 1 / np.sqrt(u), (u, 3 * u)),
        "bias": rng.normal(0, 0.1, (2, 3 * u)),
        "dense_kernel": rng.normal(0, 3 / np.sqrt(u), (u, V)),
        "dense_bias": rng.normal(0, 0.1, (V,)),
    }
    a = {k: x.astype(np.float32) for k, x in a.items()}
    q = {k: jquant.quantize(a[k], qtype) for k in ("kernel", "recurrent_kernel")}
    q["dense_kernel"] = jquant.quantize(a["dense_kernel"], head_qtype or qtype)
    jp = jg.GRUTextGenParams(
        embeddings=jnp.asarray(a["embeddings"]),
        cell=JCell(kernel=q["kernel"], recurrent_kernel=q["recurrent_kernel"],
                   bias=jnp.asarray(a["bias"])),
        dense_kernel=q["dense_kernel"],
        dense_bias=jnp.asarray(a["dense_bias"]),
    )
    tp = params_from_numpy({**a, **{k: jax_planes(qt) for k, qt in q.items()}}, device="cpu")
    return jp, tp


# (cell qtype, head qtype, weight route of both packages' fused kernels)
ROUTES = [("q4_0", None, "q4_0"), ("q5_1", None, "dense"), ("q4_1", None, "dense"),
          ("q5_0", None, "dense"), ("q4_k", "q8_0", "dense"), ("q4_0", "q8_0", "dense")]


@pytest.fixture(scope="module", params=ROUTES, ids=lambda r: f"{r[0]}+{r[1] or r[0]}")
def route_twins(request):
    qtype, head, mode = request.param
    jp, tp = make_twins(qtype=qtype, head_qtype=head)
    assert jf._check_quantized(jp) == tf._check_quantized(tp) == mode
    assert tf._prep_weights(tp).mode == mode
    return jp, tp


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The step loops here run thousands of small products; beside other
    test workers, a full-width thread pool per product only oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def twins():
    return make_twins()


def ragged_prompts(rng, b, width):
    ids = np.zeros((b, width), np.int32)
    lens = rng.integers(1, width + 1, b).astype(np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(0, V, n)
    return ids, lens


def jax_decode_with_state(jp, ids, lens, steps):
    """The JAX persistent decode, returning its final state too."""
    ops, (v, e, u, g, vp) = jf._prep_weights(jp, "q8_0")
    b, p = ids.shape
    bp, tp_ = -(-b // 128) * 128, -(-steps // 8) * 8
    prompt = jnp.zeros((tp_, bp), jnp.int32).at[:p, :b].set(jnp.asarray(ids).T)
    plen = jnp.zeros((8, bp), jnp.int32).at[0, :b].set(jnp.asarray(lens))
    toks, h = jf._fused_decode_jit(*ops, prompt, plen, units=u, total_steps=steps,
                                   compute_dtype_name="float32", qtype="q8_0", batch_tile=0)
    return np.asarray(toks)[:steps, :b].T, np.asarray(h)[:b, :u]


def test_fused_decode_plain_matches_jax_ragged(twins):
    jp, tp = twins
    ids, lens = ragged_prompts(np.random.default_rng(1), 5, 9)
    want_toks, want_h = jax_decode_with_state(jp, ids, lens, 40)
    got_toks, got_h = tf.fused_gru_decode(tp, ids, lens, 40, compute_dtype=torch.float32,
                                          return_state=True)
    assert got_toks.dtype == torch.int32 and got_toks.shape == (5, 40)
    np.testing.assert_array_equal(got_toks.numpy(), want_toks)
    np.testing.assert_allclose(got_h.numpy(), want_h, atol=1e-5, rtol=1e-5)
    # and the offline scan decode of the port agrees with its fused path
    np.testing.assert_array_equal(tg.generate(tp, ids, lens, 40).numpy(), want_toks)


def test_fused_decode_routes_match_jax(route_twins):
    """q4_0 decoded in the kernel and the dense planes: token-exact at f32
    against the JAX kernel, and equal to the port's scan decode."""
    jp, tp = route_twins
    ids, lens = ragged_prompts(np.random.default_rng(1), 5, 9)
    want = np.asarray(jf.fused_gru_decode(jp, jnp.asarray(ids), jnp.asarray(lens), 32,
                                          compute_dtype=jnp.float32))
    got, h = tf.fused_gru_decode(tp, ids, lens, 32, compute_dtype=torch.float32,
                                 return_state=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tg.generate(tp, ids, lens, 32).numpy(), want)
    assert h.shape == (5, U) and bool(torch.isfinite(h).all())
    assert "fused_weights" in tp.cache and tf._prep_weights(tp) is tp.cache["fused_weights"]


def test_fused_decode_prompt_longer_than_steps_and_plen_past_width(twins):
    jp, tp = twins
    ids = np.tile(np.arange(1, 13, dtype=np.int32), (2, 1))     # (2, 12)
    lens = np.array([12, 3], np.int32)
    got = tf.fused_gru_decode(tp, ids, lens, 8, compute_dtype=torch.float32)
    want = np.asarray(jf.fused_gru_decode(jp, jnp.asarray(ids), jnp.asarray(lens), 8,
                                          compute_dtype=jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_decode_bf16_close_to_f32(twins):
    _, tp = twins
    ids, lens = ragged_prompts(np.random.default_rng(2), 4, 6)
    a = tf.fused_gru_decode(tp, ids, lens, 24, compute_dtype=torch.bfloat16)
    b = tf.fused_gru_decode(tp, ids, lens, 24, compute_dtype=torch.float32)
    # bf16 rounding of h may fork a sequence at a near-tie; most tokens agree
    assert (a == b).float().mean() > 0.8


def slot_states(seed, n_slots=8, max_prompt=8, temps=None):
    """Mid-request engine states for both packages: mixed prompt lengths,
    totals ending inside and at tick boundaries, idle slots."""
    rng = np.random.default_rng(seed)
    plen = np.array([1, 3, 8, 2, 5, 4, 0, 0], np.int32)[:n_slots]
    total = np.array([40, 25, 33, 10, 16, 32, 0, 0], np.int32)[:n_slots]
    prompt = np.zeros((n_slots, max_prompt), np.int32)
    for i in range(n_slots):
        prompt[i, :plen[i]] = rng.integers(1, V, plen[i])
    temp = np.zeros(n_slots, np.float32) if temps is None else np.asarray(temps, np.float32)
    return plen, total, prompt, temp


def run_ticks(jp, tp, ticks, inner, sampling=False, temps=None, n_slots=8, atol=1e-5, **kw):
    plen, total, prompt, temp = slot_states(0, n_slots=n_slots, temps=temps)
    n = len(plen)
    js = dataclasses.replace(jengine.init_state(jp, n, prompt.shape[1]),
                             prompt=jnp.asarray(prompt), plen=jnp.asarray(plen),
                             total=jnp.asarray(total), temp=jnp.asarray(temp))
    ts = dataclasses.replace(tengine.init_state(tp, n, prompt.shape[1]),
                             prompt=torch.from_numpy(prompt), plen=torch.from_numpy(plen),
                             total=torch.from_numpy(total), temp=torch.from_numpy(temp))
    for tick in range(ticks):
        js, jt = jf.fused_slot_tick(jp, js, inner, compute_dtype=jnp.float32,
                                    enable_sampling=sampling, seed=7 + tick, **kw)
        ts, tt = tf.fused_slot_tick(tp, ts, inner, compute_dtype=torch.float32,
                                    enable_sampling=sampling, seed=7 + tick, **kw)
        assert tt.dtype == torch.uint8 and tt.shape == (n, inner)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=f"tick {tick}")
        np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
        np.testing.assert_array_equal(ts.prev.numpy(), np.asarray(js.prev))
        np.testing.assert_allclose(ts.h.numpy(), np.asarray(js.h), atol=atol, rtol=1e-5)


def test_slot_tick_greedy_matches_jax_across_ticks(twins):
    run_ticks(*twins, ticks=3, inner=16)


def test_slot_tick_routes_match_jax(route_twins):
    """The tick through the q4_0 and dense routes: tokens, cursors and state
    against the JAX tick, greedy and sampled."""
    run_ticks(*route_twins, ticks=2, inner=16)
    temps = [0.0, 0.9, 0.7, 1.0, 1.3, 0.9, 0.5, 0.0]
    run_ticks(*route_twins, ticks=1, inner=16, sampling=True, temps=temps, top_k=8)


Q4KM = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "gru_synth_q4km.gxt")


def test_calibrated_checkpoint_decode_and_tick_match_jax():
    """The committed q4_k_m GRU (q4_k cell + q8_0 head, full width) rides the
    dense route in both packages: a few slots, a few steps, token-exact."""
    from ggml_experiments_tpu.formats.gru_bin import load_gru_any as jload
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any as tload

    jp, tp = jload(Q4KM), tload(Q4KM, device="cpu")
    assert jf._check_quantized(jp) == tf._check_quantized(tp) == "dense"
    ids, lens = ragged_prompts(np.random.default_rng(6), 3, 6)
    want = np.asarray(jf.fused_gru_decode(jp, jnp.asarray(ids), jnp.asarray(lens), 12,
                                          compute_dtype=jnp.float32))
    got = tf.fused_gru_decode(tp, ids, lens, 12, compute_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    run_ticks(jp, tp, ticks=1, inner=8, n_slots=4, atol=1e-4)


@pytest.mark.parametrize("route", [("q8_0", None), ("q5_1", None)], ids=["q8_0", "dense"])
def test_tick_feeds_zero_past_the_prompt_buffer(route):
    """A slot whose plen exceeds its prompt buffer's width P feeds token 0
    while P <= pos < plen, as the JAX tick's masked reduction finds no row."""
    jp, tp = make_twins(qtype=route[0], head_qtype=route[1])
    rng = np.random.default_rng(8)
    n, p = 4, 4
    prompt = rng.integers(1, V, (n, p)).astype(np.int32)
    plen = np.array([7, 4, 6, 2], np.int32)              # slots 0 and 2 overrun the buffer
    total = np.array([12, 12, 9, 12], np.int32)
    js = dataclasses.replace(jengine.init_state(jp, n, p), prompt=jnp.asarray(prompt),
                             plen=jnp.asarray(plen), total=jnp.asarray(total))
    ts = dataclasses.replace(tengine.init_state(tp, n, p), prompt=torch.from_numpy(prompt),
                             plen=torch.from_numpy(plen), total=torch.from_numpy(total))
    js, jt = jf.fused_slot_tick(jp, js, 10, compute_dtype=jnp.float32)
    ts, tt = tf.fused_slot_tick(tp, ts, 10, compute_dtype=torch.float32)
    assert tt[0, 4:7].tolist() == [0, 0, 0] and tt[2, 4:6].tolist() == [0, 0]
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.prev.numpy(), np.asarray(js.prev))
    np.testing.assert_allclose(ts.h.numpy(), np.asarray(js.h), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"top_k": 5}, {"top_p": 0.8}, {"top_k": 8, "top_p": 0.9}])
def test_slot_tick_sampled_matches_jax_token_exact(twins, kw):
    """The hash lattice is the shared noise: sampled ticks agree token for
    token (temp 0 slots stay greedy), across two consecutive ticks."""
    temps = [0.0, 0.9, 0.7, 1.0, 1.3, 0.9, 0.5, 0.0]
    run_ticks(*twins, ticks=2, inner=16, sampling=True, temps=temps, **kw)


@pytest.mark.parametrize("seed,j,slot0", [(0, 0, 0), (7, 3, 0), (0x7FFFFFFF, 127, 0),
                                          (123456, 9, 384)])
def test_hash_lattice_matches_jax(seed, j, slot0):
    want = np.asarray(jf._hash_bits_u32(jnp.int32(seed), jnp.int32(j), (128, 256),
                                        slot0=jnp.int32(slot0))).view(np.uint32)
    got = tf.block_keyed_bits(seed, j, 128, 256, slot0).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got.T, want)


def test_topk_one_is_greedy(twins):
    _, tp = twins
    plen, total, prompt, _ = slot_states(0)
    st = dataclasses.replace(tengine.init_state(tp, 8, 8), prompt=torch.from_numpy(prompt),
                             plen=torch.from_numpy(plen), total=torch.from_numpy(total),
                             temp=torch.full((8,), 1.5))
    _, sampled = tf.fused_slot_tick(tp, st, 16, compute_dtype=torch.float32,
                                    enable_sampling=True, seed=3, top_k=1)
    _, greedy = tf.fused_slot_tick(tp, st, 16, compute_dtype=torch.float32)
    np.testing.assert_array_equal(sampled.numpy(), greedy.numpy())


def test_margins_flag_near_ties(twins):
    _, tp = twins
    w = tf._prep_weights(tp)
    ids, lens = ragged_prompts(np.random.default_rng(4), 3, 5)
    z = torch.zeros(3, dtype=torch.int32)
    t = torch.full((3,), 12, dtype=torch.int32)
    prompt = torch.nn.functional.pad(torch.from_numpy(ids), (0, 7))
    toks, _, _, _, gaps = tf.gru_loop_reference(w, prompt, torch.from_numpy(lens), t, z, z,
                                                torch.zeros(3, U), 12, torch.float32,
                                                margins=True)
    assert gaps.shape == (3, 12) and bool((gaps >= 0).all())
    np.testing.assert_array_equal(toks.numpy(), tf.fused_gru_decode(
        tp, ids, lens, 12, compute_dtype=torch.float32).numpy())


def test_fused_requires_q8_0(twins):
    """Float weights are refused by the fused kernels and the engine's gate;
    an unknown weight route raises."""
    _, tp = twins
    fp = dataclasses.replace(tp, dense_kernel=torch.zeros(U, V), cache={})
    assert not tf.is_fusable_params(fp)
    with pytest.raises(ValueError, match="q8_0"):
        tf.fused_gru_decode(fp, np.ones((1, 2), np.int32), np.array([2]), 4)
    with pytest.raises(ValueError, match="block-quantized"):
        tengine.DecodeEngine(fp, n_slots=2, use_fused_tick=True)
    bad = dataclasses.replace(tf._prep_weights(tp), mode="q3_k")
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="weight mode"):
        tf.gru_loop_reference(bad, torch.zeros((1, 2), dtype=torch.int32), z, z, z, z,
                              torch.zeros(1, U), 2)


def test_tick_validates_filters(twins):
    _, tp = twins
    st = tengine.init_state(tp, 2, 4)
    with pytest.raises(ValueError, match="top_k"):
        tf.fused_slot_tick(tp, st, 4, top_k=0)
    with pytest.raises(ValueError, match="top_p"):
        tf.fused_slot_tick(tp, st, 4, top_p=1.5)


def test_cuda_wrapper_refuses_cpu_tensors(twins):
    _, tp = twins
    w = tf._prep_weights(tp)
    z = torch.zeros(2, dtype=torch.int32)
    before = dict(tf.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tf.gru_loop_cuda("fused_gru_decode", w, torch.zeros((2, 4), dtype=torch.int32), z, z,
                         z, z, torch.zeros(2, U), 4)
    assert tf.LAUNCHES == before


# ---- the launch plan of the CUDA kernel (decode_plan), at the model's widths

@pytest.mark.parametrize("b0", range(1, 16385, 4096))
@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_decode_plan_covers_every_batch_and_fits(cd, b0):
    """Every B from 1 to 16,384 gets a plan the kernel takes, whose shared
    memory fits the H100's 232,448 bytes and whose blocks' slot ranges
    cover each slot exactly once, in order."""
    u, v = 1024, 66
    for b in range(b0, b0 + 4096):
        plan = tf.decode_plan(b, u, v, cd)
        tf.check_plan(plan, u, v, cd == torch.bfloat16)
        assert tf.plan_smem_bytes(plan, u, v, cd == torch.bfloat16) <= 232448
        tiles = tf.plan_slot_tiles(plan, b, u, cd == torch.bfloat16)
        assert tiles[0][0] == 0 and tiles[-1][1] == b
        assert all(e0 == s1 for (_, e0), (s1, _) in zip(tiles, tiles[1:]))
        assert all(e > s for s, e in tiles)
        assert len(tiles) <= tf.plan_grid(plan, b, u, cd == torch.bfloat16)


def test_decode_plan_chooses_by_batch():
    P = tf.DecodePlan
    bf16, f32 = torch.bfloat16, torch.float32
    # the offline decode's B=8192: one wave of 128 slot-owned blocks of 64
    assert tf.decode_plan(8192, 1024, 66, bf16) == P("slot", 4)
    assert tf.decode_plan(tf.SLOT_MIN_BATCH, 1024, 66, bf16).decomp == "slot"
    # a width where four 24 KB ring buffers no longer fit beside h: three
    assert tf.decode_plan(8192, 1056, 66, bf16) == P("slot", 3)
    # the serving tick's 512 slots stay unit-owned, two blocks a unit group
    assert tf.decode_plan(512, 1024, 66, bf16) == P("unit")
    # the q4_0 route's decode at B=2048 too: on an H100 that takes 184 us a
    # step there, slot-owned 258 (the sweep in PERF.md)
    assert tf.decode_plan(2048, 1024, 66, bf16) == P("unit")
    assert tf.decode_plan(512, 1024, 66, f32) == P("unit")
    assert tf.decode_plan(tf.SLOT_MIN_BATCH - 1, 1024, 66, bf16).decomp == "unit"
    assert tf.decode_plan(8192, 1024, 66, f32).decomp == "unit"
    # logits too wide for a ring buffer go through the device scratch: the
    # ring keeps its depth, at any vocabulary
    assert tf.decode_plan(8192, 1024, 256, bf16) == P("slot", 4)
    assert tf.decode_plan(8192, 1024, 5000, bf16) == P("slot", 4)
    assert tf.plan_slot_tiles(P("slot", 3), 130, 1024, True) == [(0, 64), (64, 128), (128, 130)]
    # f32 keeps one block a unit group (its plane slice is f32), bf16 two
    assert tf.plan_slot_tiles(P("unit"), 512, 1024, False)[:2] == [(0, 4), (4, 8)]
    assert tf.plan_slot_tiles(P("unit"), 512, 1024, True)[:2] == [(0, 2), (2, 4)]
    assert tf.plan_grid(P("unit"), 512, 1024, True) == 256
    assert tf.plan_grid(P("slot", 4), 8192, 1024, True) == 128


@pytest.mark.parametrize("plan,bf16,u,v,match", [
    (("slot", 3), False, 1024, 66, "no plan"),          # slot-owned is bf16 only
    (("slot", 4), False, 1024, 66, "no plan"),
    (("slot", 6), True, 1024, 66, "no plan"),           # not compiled
    (("slot", 2), True, 1024, 66, "no plan"),
    (("slot",), True, 1024, 66, "no plan"),             # a slot-owned ring has stages
    (("unit", 3), True, 1024, 66, "no plan"),           # the unit-owned ring is fixed
    (("unit", 4), False, 1024, 66, "no plan"),
    (("unit",), True, 2048, 66, "no plan"),             # 256 unit groups on 132 SMs
    (("unit",), False, 2048, 66, "no plan"),
    (("diag",), True, 1024, 66, "no plan"),
    (("diag", 4), True, 1024, 66, "no plan"),
    (("slot", 4), True, 1056, 66, "shared memory"),     # four buffers beside a wider h
    (("slot", 3), True, 4096, 66, "shared memory"),
    (("slot", 4), True, 2048, 5000, "shared memory"),   # 64 slots' h at U = 2048
])
def test_check_plan_refuses(plan, bf16, u, v, match):
    with pytest.raises(ValueError, match=match):
        tf.check_plan(tf.DecodePlan(*plan), u, v, bf16)


def test_jax_reference_runs_interpreted():
    from ggml_experiments_tpu.quant.pallas_kernels import _default_interpret

    assert jax.default_backend() == "cpu" and _default_interpret()
