"""Port: the continuous-batching engine on the CPU.

Per-request tokens of the port's engine (through either tick) must equal the
port's offline decode and the JAX engine's tokens on the same prompts and
weights.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_experiments_tpu import quant as jquant
from ggml_experiments_tpu.models import gru_textgen as jg
from ggml_experiments_tpu.ops.gru import GRUCellParams as JCell
from ggml_experiments_tpu.serving import DecodeEngine as JEngine
from ggml_experiments_tpu_torch.convert import params_from_numpy
from ggml_experiments_tpu_torch.models import gru_textgen as tg
from ggml_experiments_tpu_torch.serving import DecodeEngine, engine as tengine

V, E, U = 66, 16, 32


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
    rng = np.random.default_rng(11)
    a = {
        "embeddings": rng.normal(0, 0.5, (V, E)),
        "kernel": rng.normal(0, 1 / np.sqrt(E), (E, 3 * U)),
        "recurrent_kernel": rng.normal(0, 1 / np.sqrt(U), (U, 3 * U)),
        "bias": rng.normal(0, 0.1, (2, 3 * U)),
        "dense_kernel": rng.normal(0, 3 / np.sqrt(U), (U, V)),
        "dense_bias": rng.normal(0, 0.1, (V,)),
    }
    a = {k: x.astype(np.float32) for k, x in a.items()}
    q = {k: jquant.quantize(a[k], "q8_0") for k in ("kernel", "recurrent_kernel", "dense_kernel")}
    jp = jg.GRUTextGenParams(
        embeddings=jnp.asarray(a["embeddings"]),
        cell=JCell(kernel=q["kernel"], recurrent_kernel=q["recurrent_kernel"],
                   bias=jnp.asarray(a["bias"])),
        dense_kernel=q["dense_kernel"], dense_bias=jnp.asarray(a["dense_bias"]))
    tp = params_from_numpy(a, qtype="q8_0", device="cpu")
    return jp, tp


def offline(tp, prompt, total):
    return tg.generate(tp, np.asarray([prompt], np.int32), np.array([len(prompt)]),
                       total)[0].numpy()


def workload(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, int(rng.integers(1, 10))).tolist(), int(rng.integers(0, 30)))
            for _ in range(n)]


@pytest.mark.parametrize("fused", [False, True])
def test_more_requests_than_slots_match_offline_and_jax(twins, fused):
    jp, tp = twins
    work = workload(0, 12)
    eng = DecodeEngine(tp, n_slots=3, max_prompt=16, inner_steps=8, use_fused_tick=fused)
    assert eng.use_fused_tick is fused
    reqs = [eng.submit(p, n) for p, n in work]
    eng.run_until_idle(timeout_s=120)
    jeng = JEngine(jp, n_slots=3, max_prompt=16, inner_steps=8)
    jreqs = [jeng.submit(p, n) for p, n in work]
    jeng.run_until_idle(timeout_s=300)
    for (p, n), r, jr in zip(work, reqs, jreqs):
        got = r.result(timeout=1)
        assert got.shape == (len(p) + n,)
        np.testing.assert_array_equal(got, offline(tp, p, len(p) + n))
        np.testing.assert_array_equal(got, jr.result(timeout=1))
    assert eng.stats.requests_completed == len(work)
    assert eng.stats.tokens_generated == sum(len(p) + n for p, n in work)
    assert set(eng.stats.breakdown()) >= {"wall_s", "refill_s", "readback_wait_s"}


def test_fetch_async_and_background_thread(twins):
    _, tp = twins
    work = workload(1, 6)
    eng = DecodeEngine(tp, n_slots=2, max_prompt=16, inner_steps=4, fetch_async=True,
                       fetch_depth=3)
    streamed = []
    lock = threading.Lock()

    def on_token(t):
        with lock:
            streamed.append(t)

    eng.start()
    try:
        reqs = [eng.submit(p, n, on_token=on_token) for p, n in work]
        outs = [r.result(timeout=60) for r in reqs]
    finally:
        eng.stop()
    assert eng.error is None
    for (p, n), got in zip(work, outs):
        np.testing.assert_array_equal(got, offline(tp, p, len(p) + n))
    assert len(streamed) == sum(len(p) + n for p, n in work)


def test_zero_new_tokens_and_cancel(twins):
    _, tp = twins
    eng = DecodeEngine(tp, n_slots=1, max_prompt=8, inner_steps=4)
    zero = eng.submit([5, 9, 13], 0)
    long = eng.submit([1, 2], 40)
    queued = eng.submit([3], 10)
    queued.cancel()
    eng._tick()                    # serves `zero` in the only slot
    eng._tick()                    # evicts it, installs `long`, skips `queued`
    assert eng.active_requests() == [long]
    long.cancel()
    eng.run_until_idle(timeout_s=60)
    np.testing.assert_array_equal(zero.result(timeout=1), [5, 9, 13])
    assert long.canceled and len(long.result(timeout=1)) < 42
    assert queued.result(timeout=1).size == 0
    assert eng.stats.requests_canceled >= 1
    after = eng.submit([7, 7], 5)  # the freed slot serves the next request
    eng.run_until_idle(timeout_s=60)
    np.testing.assert_array_equal(after.result(timeout=1), offline(tp, [7, 7], 7))


def test_submit_validation(twins):
    _, tp = twins
    eng = DecodeEngine(tp, n_slots=2, max_prompt=4, inner_steps=4)
    with pytest.raises(ValueError):
        eng.submit([], 3)
    with pytest.raises(ValueError):
        eng.submit([1] * 5, 3)
    with pytest.raises(ValueError):
        eng.submit([V], 3)
    with pytest.raises(ValueError):
        eng.submit([1], -1)
    with pytest.raises(ValueError, match="sampling"):
        eng.submit([1], 3, temperature=0.5)


def key(req_or_pair):
    """A request's identity across a restore: its prompt and token budget
    (restored queued requests are renumbered, so ids do not carry over)."""
    if isinstance(req_or_pair, tuple):
        p, n = req_or_pair
        return tuple(int(t) for t in p), int(n)
    return tuple(int(t) for t in req_or_pair.prompt_ids), int(req_or_pair.max_new_tokens)


def drive_interrupted(make, restore, work, ticks, path):
    """Serve ``work`` on a fresh engine for ``ticks`` ticks, snapshot it and
    finish on an engine restored from the file. Returns both engines and
    every request's tokens by :func:`key`."""
    assert len({key(w) for w in work}) == len(work)
    eng = make()
    reqs = [eng.submit(p, n) for p, n in work]
    for _ in range(ticks):
        eng._tick()
    eng.snapshot(path)
    results = {key(r): r.result(timeout=1) for r in reqs if r._done.is_set()}
    eng2 = restore(path)
    partial = [r for r in eng2.restored_requests
               if 0 < len(r._tokens) < r.prompt_ids.size + r.max_new_tokens]
    queued = [r for r in eng2.restored_requests if not r._tokens]
    assert partial and queued            # interrupted mid-request, with a backlog
    eng2.run_until_idle(timeout_s=300)
    for r in eng2.restored_requests:
        if len(r._tokens) >= r.prompt_ids.size + r.max_new_tokens and not r._done.is_set():
            # the JAX engine's restore never marks done a request that had
            # finished but still held its slot (ROADMAP Queue C); the port's does
            assert type(eng2) is JEngine
            got = np.asarray(r._tokens, np.int32)
        else:
            got = r.result(timeout=1)
        if key(r) in results:            # had finished but still held its slot
            np.testing.assert_array_equal(got, results[key(r)])
        results[key(r)] = got
    return eng, eng2, results


def assert_all_equal_offline(tp, work, results):
    """No token lost or repeated: every request's tokens, across the
    interruption, are the offline decode's."""
    assert set(results) == {key(w) for w in work}
    for p, n in work:
        np.testing.assert_array_equal(results[key((p, n))], offline(tp, p, len(p) + n))


@pytest.mark.parametrize("fused", [False, True])
def test_snapshot_restore_resumes_without_losing_or_repeating_tokens(twins, fused, tmp_path):
    _, tp = twins
    work = workload(4, 9)
    kw = dict(inner_steps=4, use_fused_tick=fused)
    eng, eng2, results = drive_interrupted(
        lambda: DecodeEngine(tp, n_slots=3, max_prompt=16, **kw),
        lambda p: DecodeEngine.restore(p, tp, **kw), work, 3, str(tmp_path / "engine.gxt"))
    assert (eng2.n_slots, eng2.max_prompt, eng2.use_fused_tick) == (3, 16, fused)
    assert_all_equal_offline(tp, work, results)
    # the snapshot re-queued what it drained: the interrupted engine carries on
    assert eng.pending_count() > 0
    eng.run_until_idle(timeout_s=300)
    assert eng.stats.requests_completed == len(work)
    later = eng2.submit([9, 9], 3)       # ids go on past the restored ones
    assert later.id > max(r.id for r in eng2.restored_requests)


def test_restore_rejects_files_that_are_no_snapshot(twins, tmp_path):
    from ggml_experiments_tpu_torch.formats import checkpoint

    _, tp = twins
    path = str(tmp_path / "params.gxt")
    checkpoint.save(path, tp)
    with pytest.raises(KeyError, match="engine snapshot"):
        DecodeEngine.restore(path, tp)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshots_cross_between_the_packages(twins, writer, tmp_path):
    """A snapshot written by either engine restores in the other, which then
    finishes every request with the offline decode's tokens."""
    from ggml_experiments_tpu_torch.formats import checkpoint

    jp, tp = twins
    work = workload(5, 7)
    path = str(tmp_path / f"{writer}.gxt")
    kw = dict(inner_steps=4)
    make_t = lambda: DecodeEngine(tp, n_slots=2, max_prompt=16, **kw)       # noqa: E731
    make_j = lambda: JEngine(jp, n_slots=2, max_prompt=16, **kw)            # noqa: E731
    if writer == "port":
        _, _, results = drive_interrupted(make_t, lambda p: JEngine.restore(p, jp, **kw),
                                          work, 3, path)
    else:
        _, _, results = drive_interrupted(make_j, lambda p: DecodeEngine.restore(p, tp, **kw),
                                          work, 3, path)
    assert_all_equal_offline(tp, work, results)
    # the layout both packages write: groups in sorted order, requests by
    # slot or queue index with sorted fields, the slot state by field
    names = [e["name"] for e in checkpoint.read_header(path)["tensors"]]
    groups = [n.split("/")[0] for n in names]
    assert groups == sorted(groups) and set(groups) == {"inflight", "pending", "state"}
    assert names[-7:] == [f"state/{f}" for f in ("h", "prev", "pos", "total", "plen", "prompt",
                                                  "temp")]
    slot = names[0].split("/")[1]
    assert names[:5] == [f"inflight/{slot}/{f}" for f in ("id", "max_new", "prompt", "temp",
                                                          "tokens")]


@pytest.mark.parametrize("fused", [False, True])
def test_sampling_engine_respects_top_k(twins, fused):
    """Sampled requests stay in the top-k set of their own context; top_k=1
    at any temperature is greedy."""
    _, tp = twins
    work = workload(2, 4)
    eng = DecodeEngine(tp, n_slots=2, max_prompt=16, inner_steps=8, temperature=1.3,
                       top_k=1, use_fused_tick=fused, seed=3)
    reqs = [eng.submit(p, n) for p, n in work]
    eng.run_until_idle(timeout_s=60)
    for (p, n), r in zip(work, reqs):
        np.testing.assert_array_equal(r.result(timeout=1), offline(tp, p, len(p) + n))
    eng = DecodeEngine(tp, n_slots=4, max_prompt=16, inner_steps=8, temperature=1.0,
                       top_k=3, use_fused_tick=fused, seed=4)
    prompt = [5, 9, 13]
    reqs = [eng.submit(prompt, 12) for _ in range(4)]
    eng.run_until_idle(timeout_s=60)
    for r in reqs:
        toks = r.result(timeout=1)
        h = tg.init_state(tp, 1)
        for j in range(len(toks) - 1):
            logits, h = tg.step(tp, torch.tensor([int(toks[j])]), h)
            if j + 1 >= len(prompt):
                top3 = torch.topk(logits[0], 3).values[-1]
                assert logits[0, int(toks[j + 1])] >= top3


def test_reset_slots_installs_only_masked(twins):
    _, tp = twins
    st = tengine.init_state(tp, 3, 4)
    st = dataclasses.replace(st, h=torch.ones(3, U), pos=torch.tensor([2, 2, 2], dtype=torch.int32))
    mask = np.array([False, True, False])
    out = tengine._reset_slots(st, mask, np.ones((3, 4), np.int32), np.full(3, 2, np.int32),
                               np.full(3, 6, np.int32), np.zeros(3, np.float32))
    assert out.pos.tolist() == [2, 0, 2] and out.total.tolist() == [0, 6, 0]
    assert float(out.h[1].abs().sum()) == 0.0 and float(out.h[0].sum()) == U
