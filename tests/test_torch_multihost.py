"""Port: multi-process sessions over gloo on the CPU, against the JAX package's
single-process offline decode and forward.

The counterparts of the JAX package's ``tests/test_multihost.py`` at its tiny
GRU (V=66, E=16, U=32, ``init_params(PRNGKey(7))``), and of
``tests/test_parallel.py``'s sharded forward and decode. The test process
writes the JAX parameters as numpy arrays and spawns this file as N worker
processes (``python tests/test_torch_multihost.py <scenario> <port> <rank>
<world> <dir>``); every worker joins one gloo group, runs the scenario on the
CPU (the plain versions of the kernels) and prints one ``RESULT`` JSON line;
the JAX oracles run here, in the test process. One two-process session runs
every two-rank scenario (each test reads its part), so that the file spends
its time on the work and not on starting processes.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, E, U = 66, 16, 32
TIMEOUT_S = 240
# the JAX tests' requests, then fillers that carry the slot-sharded sessions'
# requests past the first shard (256 slots: rank 1 owns slots 128-255)
SPECS = [([5, 9, 13], 20), ([2], 15), ([11, 3], 18)]
RECOVER_SPECS = [([5, 9, 13], 30), ([2], 26), ([11, 3], 28)]
FUSED_SLOTS = 256


def fillers(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, int(rng.integers(1, 7))).tolist(), int(rng.integers(8, 21)))
            for _ in range(n)]


GREEDY = SPECS + fillers(137, 5)          # 140 requests: slots 0-139
SAMPLED_PAIR = [2, 4]
# slot 0 a greedy anchor, slot 1 and slot 129 (the same column of the other
# shard) and slot 130 the same sampled prompt; greedy fillers between
SAMPLED = ([(SPECS[0][0], SPECS[0][1], 0.0), (SAMPLED_PAIR, 15, 1.0)]
           + [(p, n, 0.0) for p, n in fillers(127, 6)]
           + [(SAMPLED_PAIR, 15, 1.0), (SAMPLED_PAIR, 15, 1.0)])
SAMPLED_SLOTS = (1, 129, 130)


# ---------------------------------------------------------------------------
# the worker (this file run as a script)
# ---------------------------------------------------------------------------

def _port_params(work, qtype=None):
    from ggml_experiments_tpu_torch.convert import params_from_numpy

    with np.load(os.path.join(work, "gru.npz")) as f:
        arrays = dict(f)
    return params_from_numpy(arrays, qtype=qtype, device="cpu")


def _serve(eng, specs, primary):
    """Drive ``eng`` until idle; the primary submits ``specs`` (prompt, new,
    temperature) in order. Returns the primary's tokens by request index."""
    handles = []
    if primary:
        handles = [eng.submit(p, n, temperature=t) for p, n, t in specs]
    eng.run_until_idle(timeout_s=TIMEOUT_S)
    return {str(i): [int(t) for t in h.result(timeout=5)] for i, h in enumerate(handles)}


def _session(eng, specs, primary):
    tokens = _serve(eng, specs, primary)
    return {"tokens": tokens, "device_steps": eng.stats.device_steps,
            "fused": eng.use_fused_tick, "slot_axis": eng._fused_slot_axis,
            "state_digest": eng.state_digest(), "held": sum(
                r is not None for r in eng._slot_req.values())}


def _run_two(work, rank):
    import torch

    from ggml_experiments_tpu_torch.models.mobilevit import (
        MobileViTConfig,
        extract_features,
        extract_features_data_parallel,
        from_named_tensors,
        random_named_tensors,
    )
    from ggml_experiments_tpu_torch.parallel import gru_param_specs, make_mesh, multihost, place
    from ggml_experiments_tpu_torch.serving import DecodeEngine

    primary = multihost.is_primary()
    f32 = torch.float32
    out = {}
    q8 = _port_params(work, "q8_0")
    # a (2, 1) mesh replicates every leaf: the params stay fusable QTensors
    # that carry the mesh, whose data axis the fused tick's slots split over
    dp = place(q8, gru_param_specs(q8), make_mesh((2, 1), device_type="cpu"))
    kw = dict(n_slots=FUSED_SLOTS, max_prompt=16, inner_steps=8, compute_dtype=f32,
              use_fused_tick=True)
    out["fused"] = _session(DecodeEngine(dp, **kw), [(p, n, 0.0) for p, n in GREEDY], primary)
    out["sampled"] = _session(DecodeEngine(dp, enable_sampling=True, seed=11, **kw), SAMPLED,
                              primary)
    tp = make_mesh((1, 2), device_type="cpu")
    for name, params in (("tp_float", _port_params(work)), ("tp_q8_0", q8)):
        placed = place(params, gru_param_specs(params), tp)
        out[name] = _session(DecodeEngine(placed, n_slots=2, max_prompt=16, inner_steps=4),
                             [(p, n, 0.0) for p, n in SPECS], primary)
        out[name]["local_gate_cols"] = int(placed.cell.recurrent_kernel.local.shape[1])
    # data-parallel MobileViT (JAX tests/multihost_worker.py run_vision)
    cfg = MobileViTConfig(image_size=64, hidden_sizes=(16, 24, 32),
                          neck_hidden_sizes=(8, 16, 16, 24, 32, 40, 64),
                          num_transformer_layers=(1, 1, 1))
    vit = from_named_tensors(random_named_tensors(cfg, seed=3), cfg, device="cpu",
                             flash_attn=False, fused_layer=True)
    imgs = torch.from_numpy(np.random.default_rng(9).standard_normal((8, 64, 64, 3))
                            .astype(np.float32))
    feats = extract_features_data_parallel(vit, imgs, compute_dtype=torch.bfloat16)
    one = extract_features(vit, imgs, compute_dtype=torch.bfloat16)
    out["vision"] = {"features": feats.numpy().ravel().tolist(), "shape": list(feats.shape),
                     "single_process_max_diff": float((feats - one).abs().max())}
    local = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * rank
    out["gathered"] = multihost.global_from_host_data(local).tolist()
    out["slice"] = [multihost.host_local_batch_slice(8).start,
                    multihost.host_local_batch_slice(8).stop]
    return out


def _run_four(work, rank):
    import torch

    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.parallel import gru_param_specs, make_mesh, multihost, place
    from ggml_experiments_tpu_torch.serving import DecodeEngine

    params = _port_params(work)
    mesh = make_mesh((2, 2), device_type="cpu")
    placed = place(params, gru_param_specs(params), mesh)
    ids = np.random.default_rng(1).integers(0, V, (8, 12))
    logits, h = gru_textgen.forward_sequence(placed, torch.from_numpy(ids))
    prompt = np.tile(np.arange(5, dtype=np.int32), (8, 1))
    toks = gru_textgen.generate(placed, prompt, np.full((8,), 5, np.int32), 30)
    out = {"logits": logits.numpy().ravel().tolist(), "h": h.numpy().ravel().tolist(),
           "generate": toks.tolist(), "mesh_coords": list(mesh.coords)}
    out["serve"] = _session(DecodeEngine(placed, n_slots=2, max_prompt=16, inner_steps=4),
                            [(p, n, 0.0) for p, n in SPECS], multihost.is_primary())
    return out


def _run_recover(work, rank):
    """A two-process session snapshots mid-decode, then rank 1 dies with no
    shutdown; rank 0's next tick must fail or stall, never complete."""
    import threading

    import torch

    from ggml_experiments_tpu_torch.parallel import gru_param_specs, make_mesh, multihost, place
    from ggml_experiments_tpu_torch.serving import DecodeEngine

    snap = os.path.join(work, "recover.gxt")
    q8 = _port_params(work, "q8_0")
    dp = place(q8, gru_param_specs(q8), make_mesh((2, 1), device_type="cpu"))
    eng = DecodeEngine(dp, n_slots=2, max_prompt=16, inner_steps=8,
                       compute_dtype=torch.float32, use_fused_tick=True)
    if multihost.is_primary():
        for p, n in RECOVER_SPECS:
            eng.submit(p, n)
    for _ in range(2):
        eng._tick()
    if multihost.is_primary():
        eng.snapshot(snap)
    out = {"rank": rank, "snapshot_written": os.path.exists(snap),
           "slot_axis": eng._fused_slot_axis}
    multihost.sync_hosts()
    if rank == 1:
        os._exit(17)
    status = {"done": False, "error": None}

    def tick():
        try:
            eng._tick()
        except Exception as ex:  # noqa: BLE001 - the peer's death, whatever its form
            status["error"] = f"{type(ex).__name__}: {ex}"[:200]
        status["done"] = True

    t = threading.Thread(target=tick, daemon=True)
    t.start()
    t.join(timeout=25)
    out["peer_death"] = ("error" if status["error"] else
                         "wedged" if not status["done"] else "tick_succeeded")
    out["peer_death_detail"] = status["error"]
    print("RESULT " + json.dumps(out), flush=True)
    os._exit(0)   # the group is unusable now


def worker(argv):
    scenario, port, rank, world, work = argv[0], int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from ggml_experiments_tpu_torch.parallel import multihost

    multihost.initialize("gloo", f"tcp://127.0.0.1:{port}", world, rank, device="cpu",
                         timeout_s=20 if scenario == "recover" else TIMEOUT_S)
    run = {"two": _run_two, "four": _run_four, "recover": _run_recover}[scenario]
    out = dict(run(work, rank), rank=rank)
    multihost.sync_hosts()
    print("RESULT " + json.dumps(out), flush=True)
    multihost.shutdown()
    return 0


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(scenario, world, work):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, str(port),
                               str(r), str(world), str(work)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=REPO)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _results(outs):
    res = []
    for rc, out, err in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert rc == 0 and lines, f"worker failed (rc {rc}):\n{out}\n{err[-4000:]}"
        res.append(json.loads(lines[-1][len("RESULT "):]))
    return sorted(res, key=lambda r: r["rank"])


def _jax_arrays():
    import jax

    from ggml_experiments_tpu.models import gru_textgen as jg

    p = jg.init_params(jg.GRUConfig(vocab_size=V, embed_dim=E, units=U), jax.random.PRNGKey(7))
    return {"embeddings": p.embeddings, "kernel": p.cell.kernel,
            "recurrent_kernel": p.cell.recurrent_kernel, "bias": p.cell.bias,
            "dense_kernel": p.dense_kernel, "dense_bias": p.dense_bias}


def _jax_params(qtype=None):
    import jax.numpy as jnp

    from ggml_experiments_tpu.models import gru_textgen as jg
    from ggml_experiments_tpu.ops.gru import GRUCellParams
    from ggml_experiments_tpu.quant import quantize

    a = {k: np.asarray(v) for k, v in _jax_arrays().items()}

    def w(name):
        return quantize(a[name], qtype) if qtype else jnp.asarray(a[name])

    return jg.GRUTextGenParams(
        embeddings=jnp.asarray(a["embeddings"]),
        cell=GRUCellParams(kernel=w("kernel"), recurrent_kernel=w("recurrent_kernel"),
                           bias=jnp.asarray(a["bias"])),
        dense_kernel=w("dense_kernel"), dense_bias=jnp.asarray(a["dense_bias"]))


def _oracle(specs, qtype=None):
    """JAX's single-process offline decode of every (prompt, new) request:
    one batched greedy generate, each row cut to its request's length."""
    import jax.numpy as jnp

    from ggml_experiments_tpu.models import gru_textgen as jg

    width = max(len(p) for p, *_ in specs)
    ids = np.zeros((len(specs), width), np.int32)
    for i, (p, *_) in enumerate(specs):
        ids[i, :len(p)] = p
    lens = np.asarray([len(p) for p, *_ in specs], np.int32)
    total = max(len(p) + n for p, n, *_ in specs)
    toks = np.asarray(jg.generate(_jax_params(qtype), jnp.asarray(ids), jnp.asarray(lens),
                                  total))
    return [toks[i, :len(p) + n].tolist() for i, (p, n, *_) in enumerate(specs)]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    np.savez(d / "gru.npz", **{k: np.asarray(v) for k, v in _jax_arrays().items()})
    return d


@pytest.fixture(scope="module")
def two(work):
    return _results(_spawn("two", 2, work))


@pytest.fixture(scope="module")
def four(work):
    return _results(_spawn("four", 4, work))


def _check_lockstep(r0, r1):
    assert r0["device_steps"] == r1["device_steps"] > 0
    assert r0["state_digest"] == r1["state_digest"]
    assert r0["tokens"] and r1["tokens"] == {} and r1["held"] == 0


def test_two_process_fused_tick_serving(two):
    """Slot-sharded fused tick over 'data' (each rank ticks 128 of 256
    slots): the primary's tokens equal JAX's offline q8_0 f32 decode, the
    follower holds no request, and the ranks' state digests agree."""
    r0, r1 = two[0]["fused"], two[1]["fused"]
    assert r0["fused"] and r1["fused"] and r0["slot_axis"] == r1["slot_axis"] == "data"
    _check_lockstep(r0, r1)
    want = _oracle(GREEDY, "q8_0")
    assert len(GREEDY) > FUSED_SLOTS // 2       # requests reached the second shard
    for i, w in enumerate(want):
        assert r0["tokens"][str(i)] == w, f"request {i} {GREEDY[i]}"


def test_two_process_sampled_fused_tick_serving(two):
    """Sampled requests on the sharded fused tick: greedy requests stay
    token-exact, the same sampled prompt draws distinct streams in two shards
    at the same column (the block keying) and at two columns of one shard,
    and the state digests agree."""
    r0, r1 = two[0]["sampled"], two[1]["sampled"]
    assert r0["fused"] and r0["slot_axis"] == "data"
    _check_lockstep(r0, r1)
    greedy = [i for i, (_, _, t) in enumerate(SAMPLED) if t == 0.0]
    want = _oracle([SAMPLED[i] for i in greedy], "q8_0")
    for i, w in zip(greedy, want):
        assert r0["tokens"][str(i)] == w, f"request {i}"
    streams = [r0["tokens"][str(i)] for i in SAMPLED_SLOTS]
    for s in streams:
        assert len(s) == len(SAMPLED_PAIR) + 15 and all(0 <= t < V for t in s)
        assert s[:2] == SAMPLED_PAIR
    assert len({tuple(s) for s in streams}) == 3, "identical sampled prompts drew one stream"


@pytest.mark.parametrize("name,qtype", [("tp_float", None), ("tp_q8_0", "q8_0")])
def test_two_process_tp_scan_serving(two, name, qtype):
    """The scan tick on a (1, 2) mesh: gate kernels column-parallel (half the
    3U columns a rank), the head row-parallel; the primary's tokens equal
    JAX's offline decode."""
    r0, r1 = two[0][name], two[1][name]
    # q8_0 shards its lane-padded planes: 128 columns hold the 3U = 96
    assert not r0["fused"] and r0["local_gate_cols"] == (128 if qtype else 3 * U) // 2
    _check_lockstep(r0, r1)
    for i, w in enumerate(_oracle(SPECS, qtype)):
        assert r0["tokens"][str(i)] == w


def test_two_process_vision_forward(two):
    """Data-parallel MobileViT at bf16, 4 images a rank (JAX
    test_two_process_vision_forward): the ranks' gathered features agree bit
    for bit, equal the single-process forward and lie within the port's bf16
    tolerance of JAX's single-process forward (their sum within JAX's 2%)."""
    import jax.numpy as jnp

    from ggml_experiments_tpu.models.mobilevit import (
        MobileViTConfig,
        extract_features,
        from_named_tensors,
        random_named_tensors,
    )

    r0, r1 = two[0]["vision"], two[1]["vision"]
    assert r0["features"] == r1["features"] and r0["shape"] == [8, 2, 2, 64]
    assert r0["single_process_max_diff"] == 0.0
    cfg = MobileViTConfig(image_size=64, hidden_sizes=(16, 24, 32),
                          neck_hidden_sizes=(8, 16, 16, 24, 32, 40, 64),
                          num_transformer_layers=(1, 1, 1))
    params = from_named_tensors(random_named_tensors(cfg, seed=3), cfg, flash_attn=False,
                                fused_layer=True)
    imgs = np.random.default_rng(9).standard_normal((8, 64, 64, 3)).astype(np.float32)
    want = np.asarray(extract_features(params, jnp.asarray(imgs), compute_dtype=jnp.bfloat16),
                      np.float32)
    got = np.asarray(r0["features"], np.float32).reshape(want.shape)
    # the port's bf16 tolerance against JAX (tests/test_torch_mobilevit.py)
    np.testing.assert_allclose(got, want, atol=0.1 * np.abs(want).max(), rtol=0.1)
    np.testing.assert_allclose(np.abs(got).sum(), np.abs(want).sum(), rtol=2e-2)


def test_two_process_host_data(two):
    for r in two:
        assert r["gathered"] == [[0, 1], [2, 3], [4, 5], [10, 11], [12, 13], [14, 15]]
    assert [r["slice"] for r in two] == [[0, 4], [4, 8]]


def test_four_process_sharded_forward_decode_and_serving(four):
    """A (2, 2) mesh of four processes: the DP + TP forward and decode equal
    JAX's single-device ones (JAX test_sharded_forward_matches_single_device
    and test_sharded_decode_matches_single_device), and a serving session
    over it reproduces the offline decode (JAX
    test_four_process_serving_session)."""
    import jax.numpy as jnp

    from ggml_experiments_tpu.models import gru_textgen as jg

    assert sorted(tuple(r["mesh_coords"]) for r in four) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    jp = _jax_params()
    ids = np.random.default_rng(1).integers(0, V, (8, 12))
    logits, h = jg.forward_sequence(jp, jnp.asarray(ids))
    prompt = np.tile(np.arange(5, dtype=np.int32), (8, 1))
    want_gen = np.asarray(jg.generate(jp, jnp.asarray(prompt), jnp.full((8,), 5, jnp.int32), 30))
    for r in four:
        np.testing.assert_allclose(np.asarray(r["logits"]).reshape(8, 12, V), np.asarray(logits),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(r["h"]).reshape(8, U), np.asarray(h), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(np.asarray(r["generate"]), want_gen)
    serve = [r["serve"] for r in four]
    assert len({s["device_steps"] for s in serve}) == 1 and serve[0]["device_steps"] > 0
    assert len({s["state_digest"] for s in serve}) == 1
    assert serve[0]["tokens"] and all(s["tokens"] == {} for s in serve[1:])
    for i, w in enumerate(_oracle(SPECS)):
        assert serve[0]["tokens"][str(i)] == w


def test_host_death_snapshot_recovery(work):
    """Two processes snapshot mid-decode; rank 1 dies abruptly; rank 0's next
    tick errors or wedges (it never completes without its peer); the
    snapshot restores in this process and finishes every request equal to
    JAX's offline decode (JAX test_host_death_snapshot_recovery)."""
    import torch

    from ggml_experiments_tpu_torch.serving import DecodeEngine

    outs = _spawn("recover", 2, work)
    assert outs[1][0] == 17, f"rank 1 did not die as scripted:\n{outs[1][2][-2000:]}"
    (r0,) = _results(outs[:1])
    assert r0["snapshot_written"] and r0["slot_axis"] == "data"
    assert r0["peer_death"] in ("error", "wedged"), r0
    eng = DecodeEngine.restore(os.path.join(work, "recover.gxt"), _port_params(work, "q8_0"),
                               inner_steps=8, compute_dtype=torch.float32, use_fused_tick=True)
    assert len(eng.restored_requests) == len(RECOVER_SPECS)
    assert any(0 < len(r._tokens) for r in eng.restored_requests)
    eng.run_until_idle(timeout_s=60)
    got = {tuple(r.prompt_ids.tolist()): r.result(timeout=5).tolist()
           for r in eng.restored_requests}
    for (p, n), w in zip(RECOVER_SPECS, _oracle(RECOVER_SPECS, "q8_0")):
        assert got[tuple(p)] == w, f"request {p} diverged"


def test_single_process_degenerates():
    """Nothing names a group: initialize is a no-op and every helper is the
    identity (JAX test_single_process_degenerates, test_global_array_from_host_data)."""
    import torch

    from ggml_experiments_tpu_torch.parallel import multihost

    assert multihost.initialize(device="cpu") == torch.device("cpu")
    assert multihost.process_count() == 1 and multihost.is_primary()
    assert multihost.host_local_batch_slice(32) == slice(0, 32)
    multihost.sync_hosts()
    data = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    got = multihost.global_from_host_data(data)
    assert got.shape == (16, 3) and np.array_equal(got.numpy(), data)
    arrays = (np.arange(3), np.ones((2, 2), bool))
    out = multihost.broadcast_one_to_all(arrays)
    assert all(np.array_equal(a, b) for a, b in zip(out, arrays))


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1:]))
