"""Port: the timing protocol (utils/benchmarking.py), the ``bench`` command,
and the decode dispatch calibration (``tools/torch_recalibrate_decode.py``'s
threshold rule and the file ``dispatch_thresholds()`` reads), on the CPU."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from ggml_experiments_tpu_torch import cli
from ggml_experiments_tpu_torch.models import gru_textgen as tg
from ggml_experiments_tpu_torch.utils import benchmarking as bm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_gate_sweep as tgs  # noqa: E402
import torch_recalibrate_decode as trd  # noqa: E402


@pytest.fixture(autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class Clock:
    """A call whose length is set by the round it falls in (one call a
    round, after one warm-up call): ``time.perf_counter`` advances by
    ``times[i]`` on the i-th call."""

    def __init__(self, monkeypatch, times):
        self.now, self.times, self.i = 0.0, list(times), 0
        monkeypatch.setattr(bm.time, "perf_counter", lambda: self.now)

    def __call__(self):
        self.now += self.times[min(self.i, len(self.times) - 1)]
        self.i += 1


def test_timeit_stats_median_and_spread(monkeypatch):
    fn = Clock(monkeypatch, [9.0, 0.010, 0.012, 0.011, 0.013, 0.010])
    st = bm.timeit_stats(fn, reps=1, rounds=5, warmup=1, device="cpu")
    assert st.rounds_run == 5 and st.device_median is None
    assert st.median == pytest.approx(0.011) and st.headline == st.median
    assert st.best == pytest.approx(0.010) and st.worst == pytest.approx(0.013)
    assert st.spread == pytest.approx(1.3) and st.stable
    assert st.asdict() == {"best_ms": 10.0, "median_ms": 11.0, "spread": 1.3, "rounds": 5}


def test_timeit_stats_adds_rounds_on_drift(monkeypatch):
    """A spread over drift_spread runs up to max_extra_rounds more rounds;
    one that settles stops adding."""
    fn = Clock(monkeypatch, [1.0, 0.010, 0.040] + [0.010] * 20)
    st = bm.timeit_stats(fn, reps=1, rounds=2, warmup=1, device="cpu")
    assert st.rounds_run == 2 + bm.PROTOCOL["max_extra_rounds"] and not st.stable
    assert st.median == pytest.approx(0.010)


def test_reps_follow_the_round_length(monkeypatch):
    """reps=None: reps_per_round calls a round where they fit in round_s,
    fewer (at least one) for longer calls."""
    for call_s, want in ((0.001, bm.PROTOCOL["reps_per_round"]), (0.1, 2), (5.0, 1)):
        fn = Clock(monkeypatch, [call_s])
        st = bm.timeit_stats(fn, rounds=3, warmup=1, device="cpu")
        assert fn.i == 1 + 3 * want and st.median == pytest.approx(call_s)


def test_bench_gru_prints_protocol_stamped_json(capsys):
    assert cli.main(["bench", "--model", "gru", "--batch", "4", "--steps", "8", "--device",
                     "cpu", "--compute", "bfloat16"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["model"] == "gru" and out["device"] == "cpu" and out["tokens_per_s"] > 0
    assert out["protocol"] == bm.PROTOCOL and out["qtype"] == "q8_0"
    assert out["compute"] == "bfloat16" and out["route"] == "scan"
    assert out["ms_per_call"] == pytest.approx(out["timing"]["median_ms"], rel=1e-3)
    assert out["tokens_per_s"] == pytest.approx(4 * 8 / out["ms_per_call"] * 1e3, rel=1e-3)


def test_bench_mobilevit_on_the_tiny_checkpoint(capsys):
    assert cli.main(["bench", "--model", "mobilevit", "--weights",
                     os.path.join(REPO, "checkpoints", "mobilevit_synth.ggml"),
                     "--image-size", "64", "--batch", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["model"] == "mobilevit" and out["images_per_s"] > 0
    assert out["protocol"]["rev"] == bm.PROTOCOL["rev"] and out["image_size"] == 64
    assert out["images_per_s"] == pytest.approx(2 / out["ms_per_call"] * 1e3, rel=1e-3)


def evidence(speedups):
    """Made-up sweep evidence over trd.GRID_B x trd.GRID_T: speedups(b, t)."""
    return {f"B{b}_T{t}": {"fused_speedup": speedups(b, t)}
            for b in trd.GRID_B for t in trd.GRID_T}


@pytest.mark.parametrize("speedups, want", [
    (lambda b, t: 2.0, (64, 64)),                                     # fused wins everywhere
    (lambda b, t: 2.0 if b >= 1024 and t >= 256 else 0.5, (1024, 256)),
    (lambda b, t: 2.0 if b >= 256 or t >= 512 else 0.5, (64, 512)),  # the first B, then T
    # a win at B=512 that a loss above it outvotes
    (lambda b, t: 2.0 if b == 512 or b >= 4096 else 1.0, (4096, 64)),
    (lambda b, t: 1.1, (trd.NEVER, trd.NEVER)),                       # never by the margin
    (lambda b, t: 0.3, (trd.NEVER, trd.NEVER)),                       # never at all
])
def test_pick_thresholds(speedups, want):
    assert trd.pick_thresholds(evidence(speedups), trd.GRID_B, trd.GRID_T, 1.15) == want


@pytest.mark.parametrize("speedups, want", [
    (lambda s, i: 3.0, (16, 16, None)),                                # bf16 on the H100
    (lambda s, i: 0.9 if s == 1024 and i >= 64 else 1.7, (16, 16, 512)),   # f32 there
    (lambda s, i: 2.0 if s >= 128 and i >= 32 else 1.0, (128, 32, None)),
    (lambda s, i: 2.0 if s <= 64 else 1.0, (16, 16, 64)),
    (lambda s, i: 0.5, (trd.NEVER, trd.NEVER, None)),
])
def test_pick_gate(speedups, want):
    """The gate with an upper bound, on the engine sweep's grid."""
    ev = {f"S{s}_I{i}": {"fused_speedup": speedups(s, i)}
          for s in tgs.ENGINE_SLOTS for i in tgs.ENGINE_INNER}
    assert trd.pick_gate(ev, tgs.ENGINE_SLOTS, tgs.ENGINE_INNER, 1.15, key="S{}_I{}") == want


def test_the_written_file_routes_decode(tmp_path, monkeypatch):
    """The tool's record, written where ``dispatch_thresholds()`` looks,
    routes ``decode()`` at its edges; without it the committed thresholds
    hold."""
    from ggml_experiments_tpu_torch.convert import params_from_numpy

    rng = np.random.default_rng(0)
    shapes = {"embeddings": (66, 8), "kernel": (8, 96), "recurrent_kernel": (32, 96),
              "dense_kernel": (32, 66)}
    params = params_from_numpy({k: rng.standard_normal(s) for k, s in shapes.items()},
                               qtype="q8_0", device="cpu")
    path = str(tmp_path / "calibration" / "decode_dispatch.json")
    monkeypatch.setenv("GXT_TORCH_DECODE_DISPATCH", path)
    try:
        thr = tg.dispatch_thresholds(reload=True)
        assert (thr["min_b"], thr["min_t"]) == (tg.DECODE_FUSED_MIN_B, tg.DECODE_FUSED_MIN_T)
        ev = evidence(lambda b, t: 2.0 if b >= 256 and t >= 128 else 0.9)
        min_b, min_t = trd.pick_thresholds(ev, trd.GRID_B, trd.GRID_T, 1.15)
        trd.write_calibration(path, {"min_b": min_b, "min_t": min_t, "evidence": ev,
                                     "protocol_rev": bm.PROTOCOL["rev"]})
        thr = tg.dispatch_thresholds(reload=True)
        assert (thr["min_b"], thr["min_t"], thr["source"]) == (256, 128, path)
        assert tg.decode_route(params, 256, 128) == "fused"
        assert tg.decode_route(params, 255, 128) == "scan"
        assert tg.decode_route(params, 256, 127) == "scan"
        assert tg.decode_route(params, 256, 128, temperature=0.7) == "scan"
        # f32: the committed upper bound on B
        cap = tg.DECODE_FUSED_MAX_B_F32
        assert tg.decode_route(params, cap, 128, compute_dtype=torch.float32) == "fused"
        assert tg.decode_route(params, 2 * cap, 128, compute_dtype="float32") == "scan"
        assert tg.decode_route(params, 2 * cap, 128) == "fused"
    finally:
        monkeypatch.delenv("GXT_TORCH_DECODE_DISPATCH")
        tg.dispatch_thresholds(reload=True)
