"""Port: the GRU ops, sampling, tokenizer and text generation against the JAX package."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_experiments_tpu.formats.gru_bin import load_gru_any as jload
from ggml_experiments_tpu.models import gru_textgen as jg
from ggml_experiments_tpu.ops import gru as jgru
from ggml_experiments_tpu.ops import sampling as jsampling
from ggml_experiments_tpu.utils import tokenizer as jtok
from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any
from ggml_experiments_tpu_torch.models import gru_textgen as tg
from ggml_experiments_tpu_torch.ops import gru as tgru
from ggml_experiments_tpu_torch.ops import linear as tlinear
from ggml_experiments_tpu_torch.ops import sampling as tsampling
from ggml_experiments_tpu_torch.utils import tokenizer as ttok

# the JAX ops package re-exports a function under the module's name
jlinear = importlib.import_module("ggml_experiments_tpu.ops.linear")

SYNTH = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "gru_synth.bin")
Q4KM = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "gru_synth_q4km.gxt")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The step loops here run thousands of small products; beside other
    test workers, a full-width thread pool per product only oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=[None, "q8_0", "q4_0", "q5_1", "q4km"])
def synth(request):
    """The trained checkpoint as float, round-to-nearest quantized, and as the
    committed calibrated q4_k_m file (q4_k cell, q8_0 head)."""
    if request.param == "q4km":
        return jload(Q4KM), load_gru_any(Q4KM, device="cpu")
    return (jload(SYNTH, qtype=request.param),
            load_gru_any(SYNTH, qtype=request.param, device="cpu"))


def prompts(seed, b, width):
    rng = np.random.default_rng(seed)
    tok = ttok.CharTokenizer()
    text = "ROMEO:\nBut soft, what light through yonder window breaks?"
    ids, lens = [], []
    for _ in range(b):
        n = int(rng.integers(1, width + 1))
        at = int(rng.integers(0, len(text) - n))
        ids.append(text[at:at + n])
    return tok.encode_batch(ids, pad_to=width)


def test_generate_greedy_f32_token_exact_full_width(synth):
    """The committed trained checkpoint at full width (V=66, E=256, U=1024)."""
    jp, tp = synth
    ids, lens = prompts(0, 3, 12)
    want = np.asarray(jg.generate(jp, jnp.asarray(ids), jnp.asarray(lens), 32))
    got = tg.generate(tp, ids, lens, 32)
    assert got.dtype == torch.int32 and got.shape == (3, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    # the fed prefix is the prompt
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(got[i, :n].numpy(), ids[i, :n])


def test_generate_bf16_close_to_f32(synth):
    _, tp = synth
    ids, lens = prompts(1, 2, 8)
    a = tg.generate(tp, ids, lens, 24, compute_dtype=torch.bfloat16)
    b = tg.generate(tp, ids, lens, 24)
    assert (a == b).float().mean() > 0.8


@pytest.mark.parametrize("kw", [{"top_k": 3}, {"top_p": 0.6}, {"top_k": 5, "top_p": 0.8}])
def test_sampled_generate_stays_in_filtered_support(synth, kw):
    """Sampling is distribution-level only (the two packages' generators
    differ): every sampled token lies in the top-k / nucleus set computed
    by the JAX package's filters on the port's own logits."""
    _, tp = synth
    ids, lens = prompts(2, 4, 6)
    gen = torch.Generator().manual_seed(5)
    toks = tg.generate(tp, ids, lens, 20, temperature=0.9, generator=gen, **kw)
    h = tg.init_state(tp, 4)
    violations = 0
    for j in range(19):
        logits, h = tg.step(tp, toks[:, j], h)
        x = jnp.asarray(logits.numpy()) / 0.9
        if "top_k" in kw:
            x = jsampling.apply_top_k(x, kw["top_k"])
        if "top_p" in kw:
            x = jsampling.apply_top_p(x, kw["top_p"])
        allowed = np.asarray(x) > jsampling.NEG * 0.5
        for b in range(4):
            if j + 1 >= lens[b]:
                violations += not allowed[b, int(toks[b, j + 1])]
    assert violations == 0


def test_sampling_filters_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (6, 66)).astype(np.float32)
    logits[0, :4] = logits[0, 10]                  # ties at the boundary
    for k in (1, 5, 66, 80):
        np.testing.assert_array_equal(
            tsampling.apply_top_k(torch.from_numpy(logits), k).numpy(),
            np.asarray(jsampling.apply_top_k(jnp.asarray(logits), k)))
    for p in (0.1, 0.5, 0.9, 1.0):
        np.testing.assert_array_equal(
            tsampling.apply_top_p(torch.from_numpy(logits), p).numpy(),
            np.asarray(jsampling.apply_top_p(jnp.asarray(logits), p)))
    greedy = tsampling.sample(torch.from_numpy(logits), temperature=0.0)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))
    with pytest.raises(ValueError):
        tsampling.apply_top_k(torch.from_numpy(logits), 0)
    with pytest.raises(ValueError):
        tsampling.apply_top_p(torch.from_numpy(logits), 0.0)


def test_sample_draws_from_the_distribution():
    logits = torch.log(torch.tensor([[0.7, 0.2, 0.1, 0.0]]).expand(4000, 4))
    gen = torch.Generator().manual_seed(0)
    draws = tsampling.sample(logits, gen, temperature=1.0)
    freq = np.bincount(draws.numpy(), minlength=4) / 4000
    np.testing.assert_allclose(freq, [0.7, 0.2, 0.1, 0.0], atol=0.03)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_cell_and_linear_match_jax(dtype):
    rng = np.random.default_rng(4)
    e, u, b = 24, 40, 5
    kern = rng.normal(0, 0.3, (e, 3 * u)).astype(np.float32)
    rec = rng.normal(0, 0.2, (u, 3 * u)).astype(np.float32)
    bias = rng.normal(0, 0.1, (2, 3 * u)).astype(np.float32)
    x = rng.normal(0, 1, (b, e)).astype(np.float32)
    h = rng.normal(0, 0.5, (b, u)).astype(np.float32)
    jp = jgru.GRUCellParams(jnp.asarray(kern), jnp.asarray(rec), jnp.asarray(bias))
    tp = tgru.GRUCellParams(torch.from_numpy(kern), torch.from_numpy(rec), torch.from_numpy(bias))
    jcd, tcd = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jgru.gru_cell(jp, jnp.asarray(x), jnp.asarray(h), compute_dtype=jcd),
                      np.float32)
    got = tgru.gru_cell(tp, torch.from_numpy(x), torch.from_numpy(h), compute_dtype=tcd)
    tol = 1e-5 if dtype == "float32" else 2e-2   # bf16: 8-bit mantissa products/results
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    assert tp.units == u
    yl = tlinear.linear(torch.from_numpy(h), torch.from_numpy(rec), torch.from_numpy(bias[1]),
                        compute_dtype=tcd)
    jl = jlinear.linear(jnp.asarray(h), jnp.asarray(rec), jnp.asarray(bias[1]),
                        compute_dtype=jcd)
    assert str(yl.dtype).endswith(dtype)            # bias added at the result dtype
    np.testing.assert_allclose(yl.float().numpy(), np.asarray(jl, np.float32), atol=tol * 5,
                               rtol=tol)
    ids = np.array([3, 0, 7], np.int32)
    np.testing.assert_array_equal(
        tlinear.embedding_lookup(torch.from_numpy(kern), torch.from_numpy(ids)).numpy(),
        np.asarray(jlinear.embedding_lookup(jnp.asarray(kern), jnp.asarray(ids))))


def test_tokenizer_matches_jax():
    assert ttok.SHAKESPEARE_VOCAB == jtok.SHAKESPEARE_VOCAB
    t, j = ttok.CharTokenizer(), jtok.CharTokenizer()
    text = "Hark! what light~ through yonder window?\n"
    assert t.encode(text) == j.encode(text)
    assert t.decode(t.encode(text)) == j.decode(j.encode(text))
    for a, b in zip(t.encode_batch(["ab", "hello"], pad_to=4), j.encode_batch(["ab", "hello"],
                                                                                pad_to=4)):
        np.testing.assert_array_equal(a, b)
    corpus = "zebra apple\tquartz"
    assert ttok.CharTokenizer.from_corpus(corpus).vocab == jtok.CharTokenizer.from_corpus(
        corpus).vocab


def test_decode_routes_and_calibration_file(synth, monkeypatch, tmp_path):
    _, tp = synth
    calls = []
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as tf

    monkeypatch.setattr(tf, "fused_gru_decode", lambda *a, **k: calls.append(k) or "fused")
    monkeypatch.setattr(tg, "generate", lambda *a, **k: calls.append(k) or "scan")
    path = tmp_path / "dispatch.json"
    monkeypatch.setenv("GXT_TORCH_DECODE_DISPATCH", str(path))
    assert tg.dispatch_thresholds(reload=True)["min_b"] == 2048
    ids = np.zeros((4, 3), np.int32)
    lens = np.full(4, 3, np.int32)
    assert tg.decode(tp, ids, lens, 300) == "scan"
    path.write_text('{"min_b": 2, "min_t": 8}')
    thr = tg.dispatch_thresholds(reload=True)
    assert (thr["min_b"], thr["min_t"], thr["source"]) == (2, 8, str(path))
    want = "fused" if tf.is_fusable_params(tp) else "scan"
    assert tg.decode(tp, ids, lens, 16) == want
    assert tg.decode(tp, ids, lens, 16, temperature=0.5) == "scan"
    assert all(k.get("compute_dtype") == torch.bfloat16 for k in calls)
    path.write_text("not json")
    assert tg.dispatch_thresholds(reload=True)["source"].startswith("default")
    tg.dispatch_thresholds(reload=True)
    monkeypatch.delenv("GXT_TORCH_DECODE_DISPATCH")
    tg.dispatch_thresholds(reload=True)


def test_step_matches_jax_step(synth):
    jp, tp = synth
    ids = np.array([5, 20, 40], np.int32)
    jl, jh = jg.step(jp, jnp.asarray(ids), jg.init_state(jp, 3))
    tl, th = tg.step(tp, torch.from_numpy(ids), tg.init_state(tp, 3))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)
    assert jax.default_backend() == "cpu"
