#!/usr/bin/env python3
"""Where the serving engine's end-to-end time goes, on one NVIDIA GPU,
through the port only (the port's copy of ``tools/serving_breakdown.py``).

For each (n_slots, fetch_depth), with the readback on the engine's loop and
then on its reader thread (``fetch_async``), a ``DecodeEngine`` serves a
full submit -> drain session on the full-width q8_0 GRU (V=66, E=256,
U=1024, weights from seed 0) and reports ``EngineStats.breakdown()``:
refill, dispatch, readback wait, distribute and the rest of its wall clock,
and the readback link rate. Beside it, the same tick the engine runs (the
fused tick ``csrc/gru_persistent.cu`` where the engine's gate takes it,
else the scan) is timed back to back with no per-tick readback, its device
time from CUDA events, so that end-to-end tokens/s reads as a fraction of
the device's tick rate. Every request carries an 8-token prompt and
``--req-tokens`` new tokens (292: ``bench.py``'s serving scenario); a warm
session runs first. One JSON line on stdout ends the run; progress goes to
stderr. Times follow ``utils/benchmarking.PROTOCOL``.

    python3 tools/torch_serving_breakdown.py [--slots 1024,2048] [--depths 8,16]
        [--inner 128] [--temperature 0] [--req-tokens 292] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from torch_capacity_probe import full_state, make_params  # noqa: E402

REQ_TOKENS = 292   # bench.py's serving scenario


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_tick_rate(params, n_slots, inner, fused, temperature):
    """Tokens/s of the bare tick, back to back (no per-tick readback): the
    device time per tick from CUDA events on the card (the wall clock on
    the CPU)."""
    import torch

    from ggml_experiments_tpu_torch.ops.fused_gru_decode import fused_slot_tick
    from ggml_experiments_tpu_torch.serving.engine import _slot_scan
    from ggml_experiments_tpu_torch.utils.benchmarking import timeit_stats

    state = full_state(params, n_slots)
    sampled = temperature > 0
    if sampled:
        state.temp.fill_(temperature)

    def run():
        nonlocal state
        if fused:
            state, toks = fused_slot_tick(params, state, inner, compute_dtype=torch.bfloat16,
                                          enable_sampling=sampled)
        else:
            state, toks, _ = _slot_scan(params, state, 0, inner, compute_dtype=torch.bfloat16,
                                        enable_sampling=sampled)
        return toks

    st = timeit_stats(run, reps=16, device=params.device)
    tick_s = st.device_median if st.device_median is not None else st.headline
    return {"tick": "fused" if fused else "scan", "tick_ms": round(tick_s * 1e3, 3),
            "wall_tick_ms": round(st.headline * 1e3, 3),
            "step_us": round(tick_s / inner * 1e6, 2),
            "tokens_per_s": round(n_slots * inner / tick_s, 0), "spread": round(st.spread, 3),
            "timer": "cuda events" if st.device_median is not None else "perf_counter"}


def e2e_session(params, n_slots, inner, fetch_depth, fetch_async, temperature, req_tokens,
                warm_tokens):
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.serving import DecodeEngine
    from ggml_experiments_tpu_torch.serving.engine import EngineStats

    rng = np.random.default_rng(2)
    eng = DecodeEngine(params, n_slots=n_slots, max_prompt=16, inner_steps=inner,
                       compute_dtype=torch.bfloat16, fetch_depth=fetch_depth,
                       fetch_async=fetch_async, temperature=temperature, seed=3)
    for _ in range(max(64, n_slots // 8)):      # warm: the build, plans and caches
        eng.submit(rng.integers(0, 66, 8).astype(np.int32), warm_tokens)
    eng.run_until_idle(timeout_s=2400)
    eng.stats = EngineStats()                   # fresh accumulators for the timed run
    reqs = [eng.submit(rng.integers(0, 66, 8).astype(np.int32), req_tokens)
            for _ in range(n_slots * 2)]
    t0 = time.perf_counter()
    eng.run_until_idle(timeout_s=2400)
    wall = time.perf_counter() - t0
    if eng.error is not None or not all(r._done.is_set() for r in reqs):
        raise RuntimeError(f"the engine left requests unfinished ({eng.error!r})")
    return eng.use_fused_tick, {
        "tokens": eng.stats.tokens_generated, "wall_s": round(wall, 3),
        "tokens_per_s": round(eng.stats.tokens_generated / wall, 0),
        "ticks": eng.stats.device_steps, "fetch_depth_final": eng.fetch_depth,
        "breakdown": eng.stats.breakdown()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", default="1024,2048")
    ap.add_argument("--depths", default="8,16")
    ap.add_argument("--inner", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampled requests (the sampled tick)")
    ap.add_argument("--req-tokens", type=int, default=REQ_TOKENS)
    ap.add_argument("--warm-tokens", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_serving_breakdown: no CUDA device (pass --device cpu for the plain "
              "versions)", file=sys.stderr)
        return 2
    params = make_params("q8_0", args.device)
    report = {"device": (torch.cuda.get_device_name(0) if args.device == "cuda"
                         else args.device),
              "inner_steps": args.inner, "req_tokens": args.req_tokens,
              "temperature": args.temperature, "configs": []}
    for n_slots in [int(s) for s in args.slots.split(",")]:
        dev_rate = {}
        for depth in [int(d) for d in args.depths.split(",")]:
            for fetch_async in (False, True):
                fused, e2e = e2e_session(params, n_slots, args.inner, depth, fetch_async,
                                         args.temperature, args.req_tokens, args.warm_tokens)
                if fused not in dev_rate:
                    dev_rate[fused] = device_tick_rate(params, n_slots, args.inner, fused,
                                                       args.temperature)
                    log(f"device tick B={n_slots}: {dev_rate[fused]}")
                dev = dev_rate[fused]
                frac = e2e["tokens_per_s"] / dev["tokens_per_s"]
                report["configs"].append({"n_slots": n_slots, "fetch_depth": depth,
                                          "fetch_async": fetch_async, "device": dev, "e2e": e2e,
                                          "e2e_fraction_of_device": round(frac, 3)})
                log(f"B={n_slots} depth={depth} async={fetch_async}: e2e "
                    f"{e2e['tokens_per_s']:,.0f} tok/s = {frac:.1%} of the device tick; "
                    f"breakdown {e2e['breakdown']}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
