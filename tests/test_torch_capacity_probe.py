"""CPU smoke of tools/torch_capacity_probe.py, the port's copy of
tools/capacity_probe.py (tests/test_capacity_probe.py's three tests): the
params and the steady-state slot load are deterministic, the weight bytes
per qtype are the JAX tool's on the same draws, the scan and fused workers
run end to end (the kernels' plain versions here), and the sweep finds the
largest slot count a probe takes."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import capacity_probe as jcp  # noqa: E402
import torch_capacity_probe as cp  # noqa: E402


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_params_and_state_deterministic():
    p1, p2 = cp.make_params("q8_0", "cpu"), cp.make_params("q8_0", "cpu")
    assert torch.equal(p1.embeddings, p2.embeddings)
    assert torch.equal(p1.cell.recurrent_kernel.codes, p2.cell.recurrent_kernel.codes)
    jp, _ = jcp._make_params("q8_0")
    np.testing.assert_array_equal(p1.embeddings.numpy(), np.asarray(jp.embeddings))
    st = cp.full_state(p1, 256)
    assert st.h.shape == (256, cp.U) and st.prompt.shape == (256, 16)
    # every slot active and nowhere near finishing: pos < total by a margin
    # larger than any probe's INNER * reps
    assert int(st.pos.max()) + cp.INNER * cp.REPS * 10 < int(st.total.min())
    assert bool((st.plen <= st.pos).all())  # past the prompt
    assert all(t.dtype == torch.int32 for t in (st.prev, st.pos, st.total, st.plen, st.prompt))


@pytest.mark.parametrize("qtype", ["q8_0", "q5_1", "q4_0"])
def test_weight_bytes_equal_the_jax_tools(qtype):
    assert cp.weight_bytes(qtype) == jcp.weight_bytes(qtype)


def test_weight_bytes_order():
    q8, q5, q4 = (cp.weight_bytes(q) for q in ("q8_0", "q5_1", "q4_0"))
    assert q4 < q5 < q8
    assert q4 < 0.62 * q8   # nibble-packed codes: about half the q8_0 bytes


@pytest.mark.parametrize("kind", ["scan", "fused"])
def test_worker_roundtrip(kind, capsys, monkeypatch):
    monkeypatch.setattr(cp, "INNER", 4)
    monkeypatch.setattr(cp, "REPS", 2)
    assert cp.single(kind, "q8_0", 16, "cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["tokens_per_s"] > 0 and out["device"] == "cpu"


def test_sweep_finds_the_largest_slot_count():
    """The walk and the bisection, with a probe that takes up to 3000 slots."""
    calls = []

    def run(b):
        calls.append(b)
        return {"ok": b <= 3000}

    best, first_fail, results = cp.largest_slots(run, 2048, 512, 8192)
    assert best == 2944 and first_fail == 3008 and set(results) == set(calls)
    assert calls[:3] == [2048, 2560, 3072] and all(b % cp.LANES == 0 for b in calls)
    # a start that fails walks down; one that never fails stops at the cap
    assert cp.largest_slots(lambda b: {"ok": b <= 700}, 2048, 512, 8192)[:2] == (640, 704)
    assert cp.largest_slots(lambda b: {"ok": True}, 512, 512, 1024)[:2] == (1024, None)
