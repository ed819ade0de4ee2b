#!/usr/bin/env python3
"""The capacity of the fused serving tick per weight format, on one NVIDIA
GPU, through the port only (the port's copy of ``tools/capacity_probe.py``).

Weight compression buys capacity (bytes per model replica, slots per tick)
more than speed. This tool measures it on the full-width GRU (V=66, E=256,
U=1024, weights from seed 0, the JAX tool's draws):

* **weight bytes**: the device bytes of one model replica per qtype (the
  padded planes of each block-quantized kernel and the float tensors);
* **fused tick** (``ops/fused_gru_decode.fused_slot_tick`` ->
  ``csrc/gru_persistent.cu``): the largest slot count the tick launches,
  walked from ``--start`` in steps of 512 slots up to ``--max-slots`` and
  bisected down to 64 slots (the kernel's slot lanes) at the first failure.
  On the card the limit is what the persistent kernel's plans take
  (``decode_plan``) and what fits the device, not a TPU's VMEM: a count it
  does not take raises in the worker, which reports it. Tokens/s at each
  qtype's largest count;
* **scan tick** (``serving/engine._slot_scan``): aggregate tokens/s at
  large slot counts, where weights stream from device memory each step;
* **routing**: the scan and the fused tick side by side at
  ``--routing-slots``.

Every (kind, qtype, slots) probe runs in a subprocess (``--single``), so that
a failed launch cannot poison the parent's CUDA context; progress goes to
stderr, and the summary is one JSON line on stdout (``--out`` also writes it
after every probe). Times follow ``utils/benchmarking.PROTOCOL``.

    python3 tools/torch_capacity_probe.py [--qtypes q8_0,q4_0] [--start 2048]
        [--max-slots 8192] [--scan-slots 4096,16384]
        [--routing-slots 512,1024,2048] [--device cpu] [--out FILE]
    python3 tools/torch_capacity_probe.py --single fused q8_0 2048 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

INNER = 128          # the engine's inner steps at the serving shape
REPS = 24            # ticks a timed round
LANES = 64           # the bisection's quantum: the persistent kernel's slot lanes
STEP = 512           # the walk's step
SCAN_QTYPES = ("q8_0", "q4_0", "q5_1")
WEIGHT_QTYPES = ("q8_0", "q5_1", "q4_0")
V, E, U = 66, 256, 1024


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_arrays():
    """The full-width GRU's float arrays, drawn as the JAX tool draws them
    (seed 0, N(0, 0.05), in field order; a zero dense bias)."""
    import numpy as np

    rng = np.random.default_rng(0)

    def w(*s):
        return (rng.standard_normal(s) * 0.05).astype(np.float32)

    return {"embeddings": w(V, E), "kernel": w(E, 3 * U), "recurrent_kernel": w(U, 3 * U),
            "bias": w(2, 3 * U), "dense_kernel": w(U, V),
            "dense_bias": np.zeros((V,), np.float32)}


def make_params(qtype, device="cuda"):
    from ggml_experiments_tpu_torch.convert import params_from_numpy

    return params_from_numpy(make_arrays(), qtype=qtype, device=device)


def full_state(params, n_slots):
    """Every slot active mid-decode and far from its end: the steady-state
    serving load."""
    import dataclasses

    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.serving.engine import init_state

    rng = np.random.default_rng(1)
    st = init_state(params, n_slots, max_prompt=16)
    dev = params.device

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    return dataclasses.replace(
        st, prev=i32(rng.integers(0, V, n_slots)), pos=i32(np.full(n_slots, 16)),
        total=i32(np.full(n_slots, 10_000_000)), plen=i32(np.full(n_slots, 8)),
        prompt=i32(rng.integers(0, V, (n_slots, 16))))


def weight_bytes(qtype, device="cpu"):
    """Device bytes of one replica: each QTensor's padded planes, each float
    tensor."""
    p = make_params(qtype, device)
    leaves = (p.embeddings, p.cell.kernel, p.cell.recurrent_kernel, p.cell.bias,
              p.dense_kernel, p.dense_bias)
    return sum(t.nbytes if hasattr(t, "planes") else t.numel() * t.element_size()
               for t in leaves)


def single(kind, qtype, n_slots, device="cuda"):
    """Worker: one (tick kind, qtype, slots) config; prints one JSON line."""
    import torch

    from ggml_experiments_tpu_torch.device import resolve_device
    from ggml_experiments_tpu_torch.utils.benchmarking import timeit_stats

    dev = resolve_device(device)
    params = make_params(qtype, dev)
    state = full_state(params, n_slots)
    if kind == "fused":
        from ggml_experiments_tpu_torch.ops.fused_gru_decode import fused_slot_tick

        def tick(st):
            return fused_slot_tick(params, st, INNER, compute_dtype=torch.bfloat16)
    else:
        from ggml_experiments_tpu_torch.serving.engine import _slot_scan

        def tick(st):
            st2, toks, _valid = _slot_scan(params, st, 0, INNER, compute_dtype=torch.bfloat16)
            return st2, toks

    try:
        state, toks = tick(state)     # the build, the plan and the first launch
        if dev.type == "cuda":
            torch.cuda.synchronize()
    except Exception as ex:
        print(json.dumps({"ok": False, "error": f"{type(ex).__name__}: {ex}"[:400]}))
        return 0

    def run():
        nonlocal state
        state, out = tick(state)
        return out

    st = timeit_stats(run, reps=REPS, device=dev)
    out = {"ok": True, "device": str(dev), "step_us": round(st.headline / INNER * 1e6, 2),
           "tokens_per_s": round(n_slots * INNER / st.headline, 0),
           "best_ms": round(st.best * 1e3, 3), "median_ms": round(st.median * 1e3, 3),
           "spread": round(st.spread, 3)}
    if st.device_median is not None:
        out["device_median_ms"] = round(st.device_median * 1e3, 3)
    print(json.dumps(out))
    return 0


def probe(kind, qtype, n_slots, device, timeout=1800):
    """One (kind, qtype, slots) config in a subprocess; ``wall_s`` records the
    worker's whole time (start, build load, first launch, timing)."""
    r = None
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--single", kind, qtype,
                            str(n_slots), "--device", device],
                           capture_output=True, text=True, timeout=timeout)
        out = json.loads(r.stdout.strip().splitlines()[-1])
    except subprocess.TimeoutExpired:
        out = {"ok": False, "error": f"worker timeout > {timeout}s"}
    except Exception:
        stderr = r.stderr if r is not None else "worker failed to launch"
        out = {"ok": False, "error": (stderr or "no output")[-400:]}
    out["wall_s"] = round(time.perf_counter() - t0, 1)
    log(f"  {kind} {qtype} B={n_slots}: {out}")
    return out


def largest_slots(run, start, step, max_slots):
    """Walk ``run(B)`` (-> result with "ok") from ``start`` in ``step`` slots up
    to ``max_slots``; at the first failure bisect down to LANES slots (below
    ``start`` if it failed). Returns (largest ok B or None, first failing B
    or None, {B: result})."""
    results = {}
    lo, hi_fail = None, None
    b = start
    while b <= max_slots:
        results[b] = run(b)
        if not results[b]["ok"]:
            hi_fail = b
            break
        lo = b
        b += step
    if lo is None:
        b = start - step
        while b >= LANES:
            results[b] = run(b)
            if results[b]["ok"]:
                lo = b
                break
            hi_fail = b
            b -= step
    if hi_fail is not None and lo is not None:
        while hi_fail - lo > LANES:
            mid = (lo + hi_fail) // 2 // LANES * LANES
            if mid in results or mid <= lo:
                break
            results[mid] = run(mid)
            if results[mid]["ok"]:
                lo = mid
            else:
                hi_fail = mid
    return lo, hi_fail, results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--single", nargs=3, metavar=("KIND", "QTYPE", "SLOTS"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--qtypes", default="q8_0,q4_0")
    ap.add_argument("--start", type=int, default=2048)
    ap.add_argument("--max-slots", type=int, default=8192)
    ap.add_argument("--scan-slots", default="4096,16384")
    ap.add_argument("--routing-slots", default="512,1024,2048")
    ap.add_argument("--out", default=None, help="also write the summary here, after every probe")
    args = ap.parse_args()
    if args.single:
        kind, qtype, n = args.single
        return single(kind, qtype, int(n), args.device)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_capacity_probe: no CUDA device (pass --device cpu for the plain versions)",
              file=sys.stderr)
        return 2
    summary = {"device": (torch.cuda.get_device_name(0) if args.device == "cuda"
                          else args.device),
               "inner_steps": INNER, "fused": {}, "scan": {}, "routing": {},
               "weight_bytes": {}}

    def save():
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(summary, f)

    def split(text):
        return [t for t in text.split(",") if t]

    for qt in WEIGHT_QTYPES:
        summary["weight_bytes"][qt] = weight_bytes(qt)
    summary["weight_bytes"]["f32"] = 4 * (V * E + E * 3 * U + U * 3 * U + 2 * 3 * U + U * V + V)
    save()
    for qt in split(args.qtypes):
        best, first_fail, results = largest_slots(
            lambda b: probe("fused", qt, b, args.device), args.start, STEP, args.max_slots)
        summary["fused"][qt] = {"max_slots": best, "at_max": results.get(best),
                                "first_fail": first_fail,
                                "sweep": {str(k): v for k, v in sorted(results.items())}}
        save()
    for qt in SCAN_QTYPES if split(args.scan_slots) else ():
        summary["scan"][qt] = {b: probe("scan", qt, int(b), args.device)
                               for b in split(args.scan_slots)}
        save()
    for b in split(args.routing_slots):
        summary["routing"][b] = {kind: probe(kind, "q8_0", int(b), args.device)
                                 for kind in ("scan", "fused")}
        save()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
