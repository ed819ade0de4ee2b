"""Port: the persistent GRU kernels at vocabularies past 256 and units off 32.

The JAX kernels pad V to 128 and U to 32 and take any vocabulary and any
width; the port's plain versions must give their tokens at those shapes,
and the routes must ask the CUDA kernel's plans before they send it work.
Seeded numpy params go through JAX's ``fused_gru_decode`` / ``fused_slot_tick``
under the Pallas interpreter and through the port's plain versions, as in
``tests/test_torch_fused_decode.py``: f32 tokens agree exactly and states
within 1e-5; bf16 within its contract (forks only at near ties).
"""

import dataclasses
import importlib

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

# (V, E, U): a vocabulary past 256 with units off 32, and a wider one
SHAPES = [(300, 16, 40), (700, 16, 64)]
# (cell qtype, weight route of both packages' fused kernels)
ROUTES = [("q8_0", "q8_0"), ("q4_0", "q4_0"), ("q5_1", "dense")]
H100 = (132, 232448, 233472)   # multiprocessors, a block's and a multiprocessor's shared memory


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The step loops here run thousands of small products; beside other
    test workers, a full-width thread pool per product only oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_planes(jq):
    out = {"shape": jq.shape, "qtype": jq.qtype}
    for name in ("codes", "scales", "mins", "hibits", "supers"):
        if getattr(jq, name) is not None:
            out[name] = np.asarray(getattr(jq, name))
    return out


def make_twins(v, e, u, qtype="q8_0", seed=3):
    """The same random GRU as JAX params and as port params (the planes are
    handed over from the JAX QTensors)."""
    rng = np.random.default_rng(seed)
    a = {
        "embeddings": rng.normal(0, 0.5, (v, e)),
        "kernel": rng.normal(0, 1 / np.sqrt(e), (e, 3 * u)),
        "recurrent_kernel": rng.normal(0, 1 / np.sqrt(u), (u, 3 * u)),
        "bias": rng.normal(0, 0.1, (2, 3 * u)),
        "dense_kernel": rng.normal(0, 3 / np.sqrt(u), (u, v)),
        "dense_bias": rng.normal(0, 0.1, (v,)),
    }
    a = {k: x.astype(np.float32) for k, x in a.items()}
    q = {k: jquant.quantize(a[k], qtype) for k in ("kernel", "recurrent_kernel", "dense_kernel")}
    jp = jg.GRUTextGenParams(
        embeddings=jnp.asarray(a["embeddings"]),
        cell=JCell(kernel=q["kernel"], recurrent_kernel=q["recurrent_kernel"],
                   bias=jnp.asarray(a["bias"])),
        dense_kernel=q["dense_kernel"],
        dense_bias=jnp.asarray(a["dense_bias"]),
    )
    tp = params_from_numpy({**a, **{k: jax_planes(qt) for k, qt in q.items()}}, device="cpu")
    return jp, tp


_TWINS = {}


def twins(shape, qtype):
    key = (shape, qtype)
    if key not in _TWINS:
        _TWINS[key] = make_twins(*shape, qtype=qtype)
    return _TWINS[key]


def ragged_prompts(rng, b, width, v):
    ids = np.zeros((b, width), np.int32)
    lens = rng.integers(1, width + 1, b).astype(np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(0, v, n)
    return ids, lens


def jax_decode_with_state(jp, mode, ids, lens, steps, cd="float32"):
    """The JAX persistent decode on its weight route, with its final state."""
    p = jf._densify(jp) if mode == "dense" else jp
    ops, (v, e, u, g, vp) = jf._prep_weights(p, mode)
    b, w = ids.shape
    bp, tp_ = -(-b // 128) * 128, -(-steps // 8) * 8
    prompt = jnp.zeros((tp_, bp), jnp.int32).at[:w, :b].set(jnp.asarray(ids).T)
    plen = jnp.zeros((8, bp), jnp.int32).at[0, :b].set(jnp.asarray(lens))
    toks, h = jf._fused_decode_jit(*ops, prompt, plen, units=u, total_steps=steps,
                                   compute_dtype_name=cd, qtype=mode, batch_tile=0)
    return np.asarray(toks)[:steps, :b].T, np.asarray(h)[:b, :u]


def _id(x):
    return "-".join(map(str, x)) if isinstance(x, tuple) else str(x)


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: r[0])
@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_decode_matches_jax_past_256_and_off_32(shape, route):
    """Greedy f32 decode, ragged prompts: tokens equal to the JAX kernel's,
    the state within 1e-5, int32 tokens, h at U columns."""
    v, e, u = shape
    jp, tp = twins(shape, route[0])
    assert jf._check_quantized(jp) == tf._check_quantized(tp) == route[1]
    ids, lens = ragged_prompts(np.random.default_rng(1), 5, 6, v)
    want_toks, want_h = jax_decode_with_state(jp, route[1], ids, lens, 20)
    got, h = tf.fused_gru_decode(tp, ids, lens, 20, compute_dtype=torch.float32,
                                 return_state=True)
    assert got.dtype == torch.int32 and h.shape == (5, u)
    np.testing.assert_array_equal(got.numpy(), want_toks)
    np.testing.assert_allclose(h.numpy(), want_h, atol=1e-5, rtol=1e-5)


def slot_states(v, n_slots=8, max_prompt=8, temps=None, seed=0):
    """Mid-request engine states: mixed prompt lengths, totals ending inside
    and at tick boundaries, idle slots."""
    rng = np.random.default_rng(seed)
    plen = np.array([1, 3, 8, 2, 5, 4, 0, 0], np.int32)[:n_slots]
    total = np.array([40, 25, 33, 10, 16, 32, 0, 0], np.int32)[:n_slots]
    prompt = np.zeros((n_slots, max_prompt), np.int32)
    for i in range(n_slots):
        prompt[i, :plen[i]] = rng.integers(1, v, plen[i])
    temp = np.zeros(n_slots, np.float32) if temps is None else np.asarray(temps, np.float32)
    return plen, total, prompt, temp


def run_ticks(jp, tp, v, ticks, inner, sampling=False, temps=None, **kw):
    """Ticks of both packages from the same state at f32: tokens (int32 past
    V = 255), cursors and state against the JAX tick."""
    plen, total, prompt, temp = slot_states(v, temps=temps)
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
        assert tt.dtype == (torch.uint8 if v <= 255 else torch.int32) and tt.shape == (n, inner)
        assert np.asarray(jt).dtype == (np.uint8 if v <= 255 else np.int32)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=f"tick {tick}")
        np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
        np.testing.assert_array_equal(ts.prev.numpy(), np.asarray(js.prev))
        np.testing.assert_allclose(ts.h.numpy(), np.asarray(js.h), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: r[0])
@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_greedy_tick_matches_jax_past_256_and_off_32(shape, route):
    jp, tp = twins(shape, route[0])
    run_ticks(jp, tp, shape[0], ticks=2, inner=10)


TEMPS = [0.0, 0.9, 0.7, 1.0, 1.3, 0.9, 0.5, 0.0]


@pytest.mark.parametrize("kw", [{}, {"top_k": 20}, {"top_p": 0.9}, {"top_k": 20, "top_p": 0.8}],
                         ids=lambda k: "-".join(f"{a}{b}" for a, b in k.items()) or "temp")
@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_sampled_tick_matches_jax_token_exact(shape, kw):
    """Temperature, top-k and top-p over a vocabulary past 256: the hash
    lattice keyed on the true vocabulary index gives both packages the same
    noise, so the f32 ticks agree token for token."""
    jp, tp = twins(shape, "q8_0")
    run_ticks(jp, tp, shape[0], ticks=1, inner=12, sampling=True, temps=TEMPS, **kw)


@pytest.mark.parametrize("route", [ROUTES[0], ROUTES[2]], ids=lambda r: r[0])
def test_sampled_tick_on_each_route_matches_jax(route):
    jp, tp = twins(SHAPES[0], route[0])
    run_ticks(jp, tp, SHAPES[0][0], ticks=1, inner=12, sampling=True, temps=TEMPS, top_k=8,
              top_p=0.9)


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_bf16_decode_forks_from_jax_only_at_near_ties(shape):
    """bf16 at the padded width: teacher-forced the state is within 2e-2 of
    the JAX kernel's; free-running the tokens agree until a step whose
    margin (the port's plain version's) is under 0.1, as on the card."""
    v, e, u = shape
    jp, tp = twins(shape, "q8_0")
    rng = np.random.default_rng(5)
    ids = rng.integers(0, v, (4, 16)).astype(np.int32)
    full = np.full(4, 16, np.int32)
    _, want_h = jax_decode_with_state(jp, "q8_0", ids, full, 16, cd="bfloat16")
    _, h = tf.fused_gru_decode(tp, ids, full, 16, compute_dtype=torch.bfloat16,
                               return_state=True)
    assert float(np.abs(h.numpy() - want_h).max()) <= 2e-2
    ids, lens = ragged_prompts(rng, 4, 5, v)
    want, _ = jax_decode_with_state(jp, "q8_0", ids, lens, 24, cd="bfloat16")
    z = torch.zeros(4, dtype=torch.int32)
    got, _, _, _, gaps = tf.gru_loop_reference(
        tf._prep_weights(tp), torch.nn.functional.pad(torch.from_numpy(ids), (0, 19)),
        torch.from_numpy(lens), torch.full((4,), 24, dtype=torch.int32), z, z,
        torch.zeros(4, u), 24, torch.bfloat16, margins=True)
    diff = got.numpy() != want
    for r in np.nonzero(diff.any(1))[0]:
        j = int(np.nonzero(diff[r])[0][0])
        assert j > 0 and float(gaps[r, j - 1]) < 0.1, (r, j)


@pytest.mark.parametrize("v", [255, 256])
def test_tick_tokens_uint8_up_to_255_int32_past(v):
    """The tick's tokens are uint8 for V <= 255 and int32 from 256, in both
    packages, and equal."""
    jp, tp = make_twins(v, 16, 32, seed=4)
    run_ticks(jp, tp, v, ticks=1, inner=8)


# ---- the U padding: what the kernel's operands hold

@pytest.mark.parametrize("route", ROUTES, ids=lambda r: r[0])
def test_units_padded_to_32_with_zero_gates(route):
    """U = 40 runs as Ku = 64: each gate's block of the planes and the
    biases is spread to Ku columns, the padded columns and K rows are zero
    (q4_0: nibbles 8 and scales 0), the plain version's planes decode them
    to 0, and h comes back at U columns with its padded units never used."""
    jp, tp = twins(SHAPES[0], route[0])
    w = tf._prep_weights(tp)
    u, ku = 40, 64
    assert (w.u, w.ku, w.mode) == (u, ku, route[1])
    assert w.uc.shape[-1] == w.wc.shape[-1] == w.bias.shape[-1] == 3 * ku
    pad_cols = torch.cat([torch.arange(c * ku + u, (c + 1) * ku) for c in range(3)])
    _, uq, dq = tf._planes(w, torch.float32)
    assert uq.shape == (ku, 3 * ku) and dq.shape == (ku, 300)
    assert not bool(uq[:, pad_cols].any()) and not bool(uq[u:].any()) and not bool(dq[u:].any())
    assert not bool(w.bias[:, pad_cols].any())
    ref = tp.cell.recurrent_kernel
    from ggml_experiments_tpu_torch.quant.qtensor import dequantize

    want = dequantize(ref).float()
    for c in range(3):
        torch.testing.assert_close(uq[:u, c * ku:c * ku + u], want[:, c * u:(c + 1) * u],
                                   rtol=0, atol=0)
    if route[1] == "q4_0":
        assert bool((w.uc[:, pad_cols] == 0x88).all()) and not bool(w.us[:, pad_cols].any())
    tf._check_layout("fused_gru_decode", w)


# ---- the routes ask the kernel's plan, from the shape alone

@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("u", [32, 40, 1000, 1024, 1056, 1088, 2048])
@pytest.mark.parametrize("v", [66, 128, 129, 257, 5000])
def test_loop_takes_agrees_with_check_plan(u, v, cd):
    """loop_takes says yes exactly where a plan of the kernel passes
    check_plan at (U, V) (every plan tried: it does not depend on B); the
    plan decode_plan then gives passes it, within the block's and, for two
    bf16 unit-owned blocks, the multiprocessor's shared memory."""
    bf16 = cd == torch.bfloat16
    plans = [tf.DecodePlan("unit")] + ([tf.DecodePlan("slot", s) for s in (3, 4)] if bf16 else [])

    def fits(plan):
        try:
            tf.check_plan(plan, u, v, bf16, *H100)
            return True
        except ValueError:
            return False

    for b in (64, 512, 8192):
        takes = tf.loop_takes(b, u, v, cd, *H100)
        assert takes == any(fits(p) for p in plans), b
        plan = tf.decode_plan(b, u, v, cd, *H100)
        if takes:
            assert fits(plan) and tf.plan_smem_bytes(plan, u, v, bf16) <= H100[1]
            if plan.decomp == "unit" and bf16:
                assert 2 * (tf.plan_smem_bytes(plan, u, v, bf16) + 1024) <= H100[2]
        else:
            assert tf.loop_refusal(b, u, v, cd, *H100)
    # at any V: unit-owned up to U = 1056 (132 unit groups), bf16 slot-owned
    # up to 1216 (64 slots' h beside three ring buffers); 2048 on neither
    assert tf.loop_takes(512, u, v, cd, *H100) == (u <= 1056 or (bf16 and u <= 1216))


def test_plan_smem_past_the_shared_memory_vocabularies():
    """Past V = 96 a slot-owned block's logits leave its ring (device
    scratch, its shared memory then independent of V); past 128 a
    unit-owned block keeps no table slice nor logits; the f32 head comes in
    chunks of 256 vocabulary columns past 256."""
    P = tf.DecodePlan
    slot = [tf.plan_smem_bytes(P("slot", 4), 1024, v, True) for v in (66, 97, 257, 5000)]
    assert len(set(slot)) == 1
    assert [tf.logits_scratch_rows(P("slot", 4), 8192, v) for v in (96, 97)] == [0, 8192]
    assert [tf.logits_scratch_rows(P("unit"), 512, v) for v in (128, 129)] == [0, 512]
    unit = [tf.plan_smem_bytes(P("unit"), 1024, v, True) for v in (129, 257, 5000)]
    assert len(set(unit)) == 1 and unit[0] < tf.plan_smem_bytes(P("unit"), 1024, 128, True)
    f32 = [tf.plan_smem_bytes(P("unit"), 1024, v, False) for v in (257, 5000)]
    assert f32[0] == f32[1] and tf.f32_head_chunk(5000) == 256 and tf.f32_head_chunk(200) == 200
    # U = 40 is reckoned at Ku = 64
    assert tf.plan_smem_bytes(P("unit"), 40, 300, True) == tf.plan_smem_bytes(P("unit"), 64, 300,
                                                                             True)
    assert tf.plan_grid(P("unit"), 512, 1000, True) == 256


@pytest.fixture()
def h100(monkeypatch):
    """A CUDA device by name, reckoned as an H100 (no card needed)."""
    monkeypatch.setattr(tf, "device_limits", lambda dev: H100)
    return torch.device("cuda")


def test_routes_keep_the_scan_path_where_no_plan_fits(h100):
    """U = 2048: decode() and the engine on a CUDA device take the scan path
    (their defaults), an explicit fused tick is refused at construction
    with the kernel's reason, and the CPU keeps the fused plain version."""
    rng = np.random.default_rng(2)
    u, v = 2048, 66
    a = {"embeddings": rng.normal(0, 0.5, (v, 16)), "kernel": rng.normal(0, 0.2, (16, 3 * u)),
         "recurrent_kernel": rng.normal(0, 0.02, (u, 3 * u)), "bias": np.zeros((2, 3 * u)),
         "dense_kernel": rng.normal(0, 0.05, (u, v)), "dense_bias": np.zeros(v)}
    tp = params_from_numpy({k: x.astype(np.float32) for k, x in a.items()}, qtype="q8_0",
                           device="cpu")
    assert "no plan" in tf.kernel_refusal(tp, 64, torch.bfloat16, h100)
    assert tf.kernel_refusal(tp, 64, torch.bfloat16) == ""
    assert tg.decode_route(tp, 64, 64, device=h100) == "scan"
    assert tg.decode_route(tp, 64, 64) == "fused"
    assert not tengine.fused_tick_route(tp, 16, 16, torch.bfloat16, device=h100)
    with pytest.raises(ValueError, match="no plan"):
        tengine.fused_tick_route(tp, 16, 16, torch.bfloat16, True, device=h100)
    assert tengine.fused_tick_route(tp, 16, 16, torch.bfloat16, True)
    assert not tengine.fused_tick_route(tp, 16, 16, torch.bfloat16)


@pytest.mark.parametrize("shape", SHAPES + [(5000, 256, 1000)], ids=_id)
def test_routes_take_the_kernel_where_a_plan_fits(h100, shape):
    """V past 256 and U off 32 (the reference's E and a 5,000-character
    vocabulary at U = 1000 too): decode() and the engine on a CUDA device
    keep the persistent kernel, as the JAX package keeps its own."""
    v, e, u = shape
    rng = np.random.default_rng(3)
    a = {"embeddings": rng.normal(0, 0.5, (v, e)), "kernel": rng.normal(0, 0.2, (e, 3 * u)),
         "recurrent_kernel": rng.normal(0, 0.02, (u, 3 * u)), "bias": np.zeros((2, 3 * u)),
         "dense_kernel": rng.normal(0, 0.05, (u, v)), "dense_bias": np.zeros(v)}
    tp = params_from_numpy({k: x.astype(np.float32) for k, x in a.items()}, qtype="q8_0",
                           device="cpu")
    for cd in (torch.bfloat16, torch.float32):
        assert tf.kernel_refusal(tp, 128, cd, h100) == ""
        assert tg.decode_route(tp, 128, 64, compute_dtype=cd, device=h100) == "fused"
        assert tengine.fused_tick_route(tp, 512, 128, cd, device=h100)
        assert tengine.fused_tick_route(tp, 16, 16, cd, True, device=h100)
