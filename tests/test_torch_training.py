"""Port: the GRU trainer against the JAX package's, on the CPU.

Parameters never come from the two packages' random streams (they differ):
the JAX parameters are carried across as numpy arrays. Tolerances:

* f32 loss and gradients: the same formulas, sums in other orders over at
  most a few hundred terms: 1e-5 of the largest entry.
* k Adam steps at f32: Adam divides by sqrt(nu) + 1e-8, so where a gradient
  entry is nearly zero a last-bit difference of it is amplified; after 5 steps
  at lr 1e-3 the parameters agree to 2e-5 absolute (a step moves an entry by
  up to 1e-3).
* bf16: the two CPU loops round at the same places; the loss agrees with the
  f32 loss to 3%, as the JAX tests hold it.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ggml_experiments_tpu.models import gru_textgen as jg
from ggml_experiments_tpu.ops import gru as jgru
from ggml_experiments_tpu.training import data as jdata
from ggml_experiments_tpu.training import gru_trainer as jtr
from ggml_experiments_tpu.utils.tokenizer import CharTokenizer as JTok
from ggml_experiments_tpu_torch import cli
from ggml_experiments_tpu_torch.convert import adam_state_from_numpy, params_from_numpy
from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
from ggml_experiments_tpu_torch.models import gru_textgen as tg
from ggml_experiments_tpu_torch.ops import gru as tgru
from ggml_experiments_tpu_torch.ops.linear import embedding_lookup
from ggml_experiments_tpu_torch.training import data as tdata
from ggml_experiments_tpu_torch.training import gru_trainer as ttr
from ggml_experiments_tpu_torch.training.prefetch import prefetch_to_device
from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer as TTok

SMALL = jg.GRUConfig(vocab_size=66, embed_dim=16, units=32)
TINY = jg.GRUConfig(vocab_size=66, embed_dim=8, units=16)
DATA = tdata.DataConfig(seq_length=24, batch_size=8)
NAMES = ("embeddings", "kernel", "recurrent_kernel", "bias", "dense_kernel", "dense_bias")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_arrays(p) -> dict:
    return {"embeddings": np.asarray(p.embeddings), "kernel": np.asarray(p.cell.kernel),
            "recurrent_kernel": np.asarray(p.cell.recurrent_kernel),
            "bias": np.asarray(p.cell.bias), "dense_kernel": np.asarray(p.dense_kernel),
            "dense_bias": np.asarray(p.dense_bias)}


def torch_arrays(p) -> dict:
    return {k: v.detach().numpy() for k, v in zip(NAMES, (
        p.embeddings, p.cell.kernel, p.cell.recurrent_kernel, p.cell.bias, p.dense_kernel,
        p.dense_bias))}


def twins(cfg=SMALL, seed=0):
    """The same random parameters in both packages."""
    jp = jg.init_params(cfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax_arrays(jp), device="cpu", requires_grad=True)


def jcopy(p):
    return jax.tree_util.tree_map(lambda a: jnp.array(np.array(a)), p)


def examples():
    return tdata.make_examples(tdata.synthetic_corpus(8000), TTok(), DATA)


def random_stream(n, seed=3, shape=(4, 10)):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = rng.integers(0, 66, shape).astype(np.int32)
        out.append((b, np.roll(b, -1, axis=1)))
    return out


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,epochs,drop", [(0, 1, True), (5, 3, True), (2, 2, False)])
def test_batches_equal_the_jax_stream(seed, epochs, drop):
    assert tdata.synthetic_corpus(3000, seed=seed) == jdata.synthetic_corpus(3000, seed=seed)
    text = tdata.synthetic_corpus(8000)
    tcfg = tdata.DataConfig(seq_length=24, batch_size=8, drop_remainder=drop)
    jcfg = jdata.DataConfig(seq_length=24, batch_size=8, drop_remainder=drop)
    tex = tdata.make_examples(text, TTok(), tcfg)
    jex = jdata.make_examples(text, JTok(), jcfg)
    got = list(tdata.batches(tex, tcfg, seed=seed, epochs=epochs))
    want = list(jdata.batches(jex, jcfg, seed=seed, epochs=epochs))
    assert len(got) == len(want) > 0
    for (gi, gt), (wi, wt) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(got[0][0][:, 1:], got[0][1][:, :-1])   # shifted targets
    if drop:
        assert all(i.shape == (8, 24) for i, _ in got)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((7, 11, 66)) * 3).astype(np.float32)
    targets = rng.integers(0, 66, (7, 11)).astype(np.int32)
    want = float(jtr.sparse_softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(ttr.sparse_softmax_cross_entropy(torch.tensor(logits), torch.tensor(targets)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # bf16 logits are promoted: the log-sum-exp runs in f32
    got16 = ttr.sparse_softmax_cross_entropy(torch.tensor(logits).bfloat16(),
                                             torch.tensor(targets))
    assert got16.dtype == torch.float32
    np.testing.assert_allclose(float(got16), want, rtol=2e-2)


def test_one_hot_embedding_equals_gather_with_the_same_gradient():
    rng = np.random.default_rng(1)
    table = torch.tensor(rng.standard_normal((66, 8)).astype(np.float32), requires_grad=True)
    ids = torch.tensor(rng.integers(0, 66, (5, 7)).astype(np.int32))
    w = torch.tensor(rng.standard_normal((5, 7, 8)).astype(np.float32))
    a = embedding_lookup(table, ids)
    b = embedding_lookup(table, ids, one_hot_grad=True)
    assert torch.equal(a, b)
    ga, = torch.autograd.grad((a * w).sum(), table)
    gb, = torch.autograd.grad((b * w).sum(), table)
    np.testing.assert_allclose(gb.numpy(), ga.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax_at_f32(remat):
    jp, tp = twins()
    inp, tgt = next(iter(tdata.batches(examples(), DATA, seed=1)))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtr.loss_fn(p, jnp.asarray(inp), jnp.asarray(tgt), remat=remat))(jp)
    loss = ttr.loss_fn(tp, inp, tgt, remat=remat)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    grads = torch.autograd.grad(loss, [t for _, t in ttr.param_leaves(tp)])
    want = jax_arrays(jgrads)
    for name, g in zip(NAMES, grads):
        assert g.dtype == torch.float32 and g.shape == want[name].shape
        assert rel_err(g.numpy(), want[name]) < 1e-5, name


def test_bf16_loss_matches_jax_and_f32():
    jp, tp = twins()
    inp, tgt = next(iter(tdata.batches(examples(), DATA, seed=1)))
    l32 = float(ttr.loss_fn(tp, inp, tgt))
    l16 = float(ttr.loss_fn(tp, inp, tgt, compute_dtype=torch.bfloat16))
    j16 = float(jtr.loss_fn(jp, jnp.asarray(inp), jnp.asarray(tgt), compute_dtype=jnp.bfloat16))
    np.testing.assert_allclose(l16, l32, rtol=0.03)
    np.testing.assert_allclose(l16, j16, rtol=5e-3)   # bf16 flips through 24 steps


def test_time_major_forward_is_the_batch_major_forward():
    _, tp = twins()
    ids = np.random.default_rng(0).integers(0, 66, (3, 9)).astype(np.int32)
    with torch.no_grad():
        lb, hb = tg.forward_sequence(tp, ids)
        lt, ht = tg.forward_sequence(tp, ids.T, time_major=True)
    np.testing.assert_allclose(lt.swapaxes(0, 1).numpy(), lb.numpy(), atol=1e-6)
    np.testing.assert_allclose(ht.numpy(), hb.numpy(), atol=1e-6)


def test_fused_time_major_sequence_matches_jax_with_gradients():
    """The slice's kernel path, both packages forced onto their fused pair:
    JAX in interpret mode, the port through the kernels' plain versions.
    States to one bf16 step compounded (2e-2 absolute), gradients of the cell
    parameters to 2e-2 of the largest entry."""
    rng = np.random.default_rng(7)
    e, u, t, b = 8, 16, 6, 4
    arrs = {"kernel": rng.standard_normal((e, 3 * u)) * 0.3,
            "recurrent_kernel": rng.standard_normal((u, 3 * u)) * 0.3,
            "bias": rng.standard_normal((2, 3 * u)) * 0.3}
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    xs = rng.standard_normal((t, b, e)).astype(np.float32)
    wts = rng.standard_normal((t, b, u)).astype(np.float32)

    jcell = jgru.GRUCellParams(**{k: jnp.asarray(v) for k, v in arrs.items()})

    def jloss(cell):
        ys, _ = jgru.gru_sequence_time_major(cell, jnp.asarray(xs), jnp.zeros((b, u)),
                                             compute_dtype=jnp.bfloat16, fused=True)
        return jnp.sum(ys.astype(jnp.float32) * wts), ys

    (_, jys), jgrads = jax.value_and_grad(jloss, has_aux=True)(jcell)

    tcell = tgru.GRUCellParams(**{k: torch.tensor(v, requires_grad=True)
                                  for k, v in arrs.items()})
    ys, h_last = tgru.gru_sequence_time_major(tcell, torch.tensor(xs), torch.zeros(b, u),
                                              compute_dtype=torch.bfloat16, fused=True)
    assert ys.dtype == torch.bfloat16 and torch.equal(h_last, ys[-1])
    (ys.float() * torch.tensor(wts)).sum().backward()
    np.testing.assert_allclose(ys.detach().float().numpy(),
                               np.asarray(jys.astype(jnp.float32)), atol=2e-2, rtol=0)
    for name in arrs:
        got = getattr(tcell, name).grad.numpy()
        assert rel_err(got, np.asarray(getattr(jgrads, name))) < 2e-2, name
    # on the CPU the default route is the plain loop, as in the JAX package off the TPU
    assert not tgru.fused_train_route(tcell, torch.bfloat16, "cpu")


@pytest.mark.parametrize("cd,device,fused,want", [
    (torch.float32, "cuda", None, True),        # the f32 kernels, on the card only
    (torch.float32, "cuda", False, False),      # fused=False: the plain loop
    (torch.float32, "cpu", None, False),        # the JAX route on the CPU
    (torch.float32, "cpu", True, False),        # ... even when asked: JAX routes only bf16
    (torch.bfloat16, "cuda", None, True),       # bf16 unchanged
    (torch.bfloat16, "cpu", None, False),
    (torch.bfloat16, "cpu", True, True),        # the kernels' plain versions
    (torch.float32, "cuda", True, True),
], ids=["f32-cuda", "f32-cuda-off", "f32-cpu", "f32-cpu-asked", "bf16-cuda", "bf16-cpu",
        "bf16-cpu-asked", "f32-cuda-asked"])
def test_fused_train_route_by_device_and_dtype(cd, device, fused, want):
    """The one predicate of the time-major route, asked with a device type
    and a compute dtype (the parameters stay on the CPU)."""
    cell = tgru.GRUCellParams(kernel=torch.zeros(8, 96), recurrent_kernel=torch.zeros(32, 96),
                              bias=torch.zeros(2, 96))
    assert tgru.fused_train_route(cell, cd, device, fused) is want
    # a width neither kernel pair takes stays on the plain loop by default
    odd = tgru.GRUCellParams(kernel=torch.zeros(8, 300), recurrent_kernel=torch.zeros(100, 300),
                             bias=torch.zeros(2, 300))
    assert not tgru.fused_train_route(odd, cd, device)


def test_f32_time_major_on_the_cpu_runs_the_plain_loop_even_when_fused_is_asked():
    """At f32 on the CPU ``fused=True`` runs the plain loop under autograd
    (no plain-version run of the kernels), bit-equal to ``fused=False``, as
    the JAX package does."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    rng = np.random.default_rng(4)
    e, u, t, b = 8, 16, 5, 3
    arrs = {"kernel": rng.standard_normal((e, 3 * u)) * 0.3,
            "recurrent_kernel": rng.standard_normal((u, 3 * u)) * 0.3,
            "bias": rng.standard_normal((2, 3 * u)) * 0.3}
    xs = torch.tensor(rng.standard_normal((t, b, e)), dtype=torch.float32)
    out = []
    for fused in (True, False):
        cell = tgru.GRUCellParams(**{k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
                                     for k, v in arrs.items()})
        plain = dict(ft.PLAIN_CALLS)
        ys, _ = tgru.gru_sequence_time_major(cell, xs, torch.zeros(b, u), fused=fused)
        ys.square().sum().backward()
        assert ft.PLAIN_CALLS == plain
        out.append([ys.detach()] + [getattr(cell, k).grad for k in arrs])
    assert all(torch.equal(x, y) for x, y in zip(*out))


# ---------------------------------------------------------------------------
# the optimizer and the loop
# ---------------------------------------------------------------------------

def test_adam_steps_match_the_jax_trainer_at_f32():
    jp, tp = twins()
    stream = list(tdata.batches(examples(), DATA, seed=2))[:5]
    want, jhist = jtr.train(jcopy(jp), list(stream), jtr.TrainConfig(log_every=1))
    got, hist = ttr.train(tp, list(stream), ttr.TrainConfig(log_every=1), device="cpu")
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == list(range(5))
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist], rtol=1e-5)
    ga, wa = torch_arrays(got), jax_arrays(want)
    for name in NAMES:
        assert ga[name].dtype == np.float32
        np.testing.assert_allclose(ga[name], wa[name], atol=2e-5, rtol=0, err_msg=name)
    # the caller's parameters were copied, not updated
    np.testing.assert_array_equal(torch_arrays(tp)["kernel"], jax_arrays(jp)["kernel"])


def test_training_continues_from_an_optax_state():
    """Three optax steps in JAX, the parameters and the Adam state carried
    across, then two more steps in each package."""
    jp, _ = twins(TINY)
    stream = random_stream(5)
    opt = optax.adam(1e-3)
    step = jtr.make_train_step(opt)
    jparams, jstate = jcopy(jp), opt.init(jp)
    for inp, tgt in stream[:3]:
        jparams, jstate, _ = step(jparams, jstate, jnp.asarray(inp), jnp.asarray(tgt))
    tparams = params_from_numpy(jax_arrays(jparams), device="cpu", requires_grad=True)
    tstate = adam_state_from_numpy(np.asarray(jstate[0].count), jax_arrays(jstate[0].mu),
                                   jax_arrays(jstate[0].nu), device="cpu")
    assert int(tstate[0].count) == 3
    tstep = ttr.make_train_step(1e-3)
    for inp, tgt in stream[3:]:
        jparams, jstate, jloss = step(jparams, jstate, jnp.asarray(inp), jnp.asarray(tgt))
        tparams, tstate, tloss = tstep(tparams, tstate, torch.tensor(inp), torch.tensor(tgt))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert int(tstate[0].count) == int(jstate[0].count) == 5
    for name in NAMES:
        np.testing.assert_allclose(torch_arrays(tparams)[name], jax_arrays(jparams)[name],
                                   atol=2e-5, rtol=0, err_msg=name)
        np.testing.assert_allclose(torch_arrays(tstate[0].nu)[name],
                                   jax_arrays(jstate[0].nu)[name], rtol=1e-3, atol=1e-9)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_training_reduces_loss_and_keeps_the_best_checkpoint(cd, tmp_path):
    from ggml_experiments_tpu_torch.formats.checkpoint import load_into

    _, tp = twins()
    ckpt = str(tmp_path / "best.gxt")
    stream = list(tdata.batches(examples(), DATA, epochs=6))
    params, hist = ttr.train(tp, stream, ttr.TrainConfig(
        learning_rate=5e-3, log_every=10, checkpoint_path=ckpt, compute_dtype=cd), device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.8, (hist[0], hist[-1])
    assert all(t.dtype == torch.float32 for _, t in ttr.param_leaves(params))
    restored = load_into(ckpt, tg.init_params(SMALL, torch.Generator().manual_seed(1)),
                         device="cpu")
    logits, _ = tg.forward_sequence(restored, stream[0][0])
    assert torch.isfinite(logits).all()
    # the trained parameters generate
    ids, lens = TTok().encode_batch(["the "])
    text = TTok().decode(tg.generate(params, ids, lens, 40)[0].tolist())
    assert text.startswith("the ") and len(text) == 40


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_exact_resume_matches_uninterrupted(cd, tmp_path):
    _, init = twins(TINY)
    stream = random_stream(6)
    want, _ = ttr.train(init, list(stream), ttr.TrainConfig(log_every=1, compute_dtype=cd),
                        device="cpu")
    # interrupted: 4 steps (0..3), state saved every 2 steps -> last at 2
    ck = str(tmp_path / "resume.gxt")
    tc = ttr.TrainConfig(log_every=1, resume_path=ck, save_every=2, compute_dtype=cd)
    ttr.train(init, list(stream)[:4], tc, device="cpu")
    got, hist = ttr.train(init, list(stream), tc, device="cpu")
    assert hist[0]["step"] == 3   # resumed, not restarted
    for name in NAMES:
        np.testing.assert_array_equal(torch_arrays(got)[name], torch_arrays(want)[name])
    # a finished run resumes to nothing
    _, hist = ttr.train(init, list(stream)[:5], tc, device="cpu")
    assert hist == []


def test_resume_reads_a_file_the_jax_trainer_wrote(tmp_path):
    """The resume file's key paths are the JAX trainer's: its file continues
    in the port, and ends where the JAX run ends, to the Adam tolerance."""
    from ggml_experiments_tpu_torch.formats.checkpoint import read_header

    jp, tp = twins(TINY)
    stream = random_stream(6)
    want, _ = jtr.train(jcopy(jp), list(stream), jtr.TrainConfig(log_every=1))
    ck = str(tmp_path / "resume.gxt")
    jtr.train(jcopy(jp), list(stream)[:4],
              jtr.TrainConfig(log_every=1, resume_path=ck, save_every=2))
    got, hist = ttr.train(tp, list(stream), ttr.TrainConfig(
        log_every=1, resume_path=ck, save_every=2), device="cpu")
    assert hist[0]["step"] == 3
    for name in NAMES:
        np.testing.assert_allclose(torch_arrays(got)[name], jax_arrays(want)[name],
                                   atol=2e-5, rtol=0, err_msg=name)
    # and the port rewrote the file with the same keys, dtypes and shapes
    jck = str(tmp_path / "jresume.gxt")
    jtr.train(jcopy(jp), list(stream), jtr.TrainConfig(log_every=1, resume_path=jck,
                                                      save_every=2))

    def layout(path):
        return [(e["name"], e["dtype"], e["shape"]) for e in read_header(path)["tensors"]]

    assert layout(ck) == layout(jck)
    assert {"step", "best", "opt_state/0/count", "opt_state/0/mu/cell/kernel",
            "params/dense_bias"} <= {n for n, _, _ in layout(ck)}


def test_resume_rejects_mismatched_checkpoint(tmp_path):
    stream = random_stream(1)
    ck = str(tmp_path / "resume.gxt")
    tc = ttr.TrainConfig(log_every=1, resume_path=ck, save_every=1)
    ttr.train(twins(TINY)[1], stream, tc, device="cpu")
    big = twins(jg.GRUConfig(vocab_size=66, embed_dim=8, units=32))[1]
    with pytest.raises(ValueError, match=r"does not match this model: cell/kernel is "
                                         r"\(8, 48\), expected \(8, 96\)"):
        ttr.train(big, stream, tc, device="cpu")


def test_train_raises_without_a_gpu_unless_the_cpu_is_asked_for(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.train(twins(TINY)[1], random_stream(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.train_from_text(tdata.synthetic_corpus(500))
    corpus = tmp_path / "c.txt"
    corpus.write_text(tdata.synthetic_corpus(2000))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train-gru", "--corpus", str(corpus), "--epochs", "1"])
    with pytest.raises(TypeError, match="float parameters"):
        ttr.train(load_gru_params(os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                                               "gru_synth.bin"), qtype="q8_0", device="cpu"),
                  random_stream(1), device="cpu")


def test_validation_ppl_during_training():
    _, history, _ = ttr.train_from_text(
        tdata.synthetic_corpus(6000, seed=0),
        model_config=tg.GRUConfig(vocab_size=66, embed_dim=8, units=16),
        train_config=ttr.TrainConfig(epochs=8, log_every=5, eval_every=5),
        data_config=tdata.DataConfig(seq_length=20, batch_size=8),
        eval_text=tdata.synthetic_corpus(1500, seed=1), device="cpu")
    val = [h["val_ppl"] for h in history if "val_ppl" in h]
    assert len(val) >= 2
    assert all(np.isfinite(v) and v > 1.0 for v in val)
    assert val[-1] < val[0], val


# ---------------------------------------------------------------------------
# init, prefetch, CLI
# ---------------------------------------------------------------------------

def test_init_params_distributions():
    cfg = tg.GRUConfig(vocab_size=66, embed_dim=16, units=32)
    p = tg.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    q = tg.init_params(cfg, torch.Generator().manual_seed(0))
    r = tg.init_params(cfg, torch.Generator().manual_seed(1))
    jp = jg.init_params(cfg, jax.random.PRNGKey(0))
    for (name, a), (_, b), (_, c) in zip(ttr.param_leaves(p), ttr.param_leaves(q),
                                         ttr.param_leaves(r)):
        assert a.dtype == torch.float32 and torch.equal(a, b), name
        assert a.shape == jax_arrays(jp)[name.split("/")[-1]].shape
        if "bias" not in name:
            assert not torch.equal(a, c), name
    assert float(p.embeddings.abs().max()) <= 0.05 and float(p.embeddings.std()) > 0.02
    for w in (p.cell.kernel, p.dense_kernel):
        limit = (6.0 / sum(w.shape)) ** 0.5
        assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.9 * limit
        # uniform: variance limit^2 / 3, as the JAX initializer's
        np.testing.assert_allclose(float(w.var()), limit ** 2 / 3, rtol=0.15)
    wr = p.cell.recurrent_kernel
    np.testing.assert_allclose((wr @ wr.t()).numpy(), np.eye(32), atol=1e-5)
    jwr = np.asarray(jp.cell.recurrent_kernel)
    np.testing.assert_allclose(jwr @ jwr.T, np.eye(32), atol=1e-5)
    assert not p.cell.bias.any() and not p.dense_bias.any()


def test_prefetch_keeps_order_and_reraises():
    items = [(np.full((2, 2), i, np.float32), np.int32(i)) for i in range(7)]
    out = list(prefetch_to_device(iter(items), depth=3, device="cpu"))
    assert len(out) == 7
    for i, (a, b) in enumerate(out):
        assert isinstance(a, torch.Tensor) and float(a[0, 0]) == i and int(b) == i

    def boom():
        yield items[0]
        raise RuntimeError("producer failed")

    it = prefetch_to_device(boom(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="producer failed"):
        for _ in it:
            pass


def test_prefetch_producer_stops_when_the_consumer_leaves():
    before = set(threading.enumerate())
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield np.int32(i)
            i += 1

    it = prefetch_to_device(endless(), depth=2, device="cpu")
    assert int(next(it)) == 0
    producers = set(threading.enumerate()) - before
    assert len(producers) == 1
    it.close()
    for t in producers:
        t.join(timeout=5)
        assert not t.is_alive()
    assert len(pulled) < 10


def test_cli_train_gru_on_cpu_writes_a_gru_bin_that_generate_reads(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(tdata.synthetic_corpus(4000))
    heldout = tmp_path / "heldout.txt"
    heldout.write_text(tdata.synthetic_corpus(1200, seed=1))
    out, best, resume = (str(tmp_path / n) for n in ("gru.bin", "best.gxt", "resume.gxt"))
    base = ["train-gru", "--corpus", str(corpus), "--epochs", "2", "--seq-length", "20",
            "--batch-size", "8", "--embed-dim", "8", "--units", "16", "--log-every", "5",
            "--device", "cpu"]
    args = base + ["--eval-corpus", str(heldout), "--eval-every", "10", "--checkpoint", best,
                   "--resume", resume, "--save-every", "5", "--output", out]
    assert cli.main(args) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("exported weights to")
    summary = json.loads(lines[-1])
    assert set(summary) == {"final_loss", "steps", "final_val_ppl"}
    assert np.isfinite(summary["final_loss"]) and summary["steps"] == 45
    assert os.path.exists(best) and os.path.exists(resume)
    # bf16 takes the same command
    assert cli.main(base + ["--compute", "bfloat16"]) == 0
    bf = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert bf["steps"] == 45 and abs(bf["final_loss"] - summary["final_loss"]) < 0.1
    # the exported file is a gru.bin: generate reads it
    assert cli.main(["generate", "--weights", out, "--prompt", "the ", "--steps", "30",
                     "--device", "cpu"]) == 0
    text = capsys.readouterr().out.splitlines()[0]
    assert text.startswith("the ") and len(text) == 30
    p = load_gru_params(out, device="cpu")
    assert p.cell.recurrent_kernel.shape == (16, 48) and p.embeddings.shape == (66, 8)
    # resumed from its last save (step 45, the last of the stream): a no-op
    assert cli.main(args) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {"resumed_complete": True}


def test_cli_train_gru_f32_on_cpu_launches_nothing_and_matches_the_jax_trainer(tmp_path,
                                                                               capsys):
    """``train-gru --device cpu`` at its default f32 launches no kernel and
    runs no plain version of the fused pair (the plain loop, as in the JAX
    package), and the trainer under it takes the JAX trainer's steps."""
    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    port.reset_kernel_launches()
    plain = dict(ft.PLAIN_CALLS)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(tdata.synthetic_corpus(1000))
    assert cli.main(["train-gru", "--corpus", str(corpus), "--epochs", "1", "--seq-length", "10",
                     "--batch-size", "4", "--embed-dim", "8", "--units", "16",
                     "--log-every", "1", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert np.isfinite(summary["final_loss"]) and summary["steps"] > 0
    assert not any(port.kernel_launches().values()) and ft.PLAIN_CALLS == plain
    jp, tp = twins(TINY)
    stream = random_stream(3)
    got, hist = ttr.train(tp, list(stream), ttr.TrainConfig(log_every=1), device="cpu")
    want, jhist = jtr.train(jcopy(jp), list(stream), jtr.TrainConfig(log_every=1))
    assert not any(port.kernel_launches().values()) and ft.PLAIN_CALLS == plain
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist], rtol=1e-5)
    ga, wa = torch_arrays(got), jax_arrays(want)
    for name in NAMES:
        np.testing.assert_allclose(ga[name], wa[name], atol=2e-5, rtol=0, err_msg=name)
