#!/usr/bin/env python3
"""Measure the port's fused-vs-scan decode crossover on one NVIDIA GPU and
write the routing thresholds that ``models.gru_textgen.decode()`` reads.

The port's counterpart of ``tools/recalibrate_decode.py``. It times
``generate`` (the scan: a loop of PyTorch ops, the recurrent product through
the qmatmul kernel) and ``fused_gru_decode`` (the persistent kernel) at full
width (V=66, E=256, U=1024, q8_0 weights from seed 0, bf16, or f32 with
``--compute float32``) over the grid B x T below, scan then fused in each
cell, under the port's timing protocol
(``utils/benchmarking.PROTOCOL``: the wall clock of whole calls closed by a
synchronize, since the scan is host-bound). The thresholds are the smallest
(B, T) at and above which fused beats scan by ``--margin`` in every cell
(:func:`pick_thresholds`), and where that holds only below some B, that B
as an upper bound (:func:`pick_gate`: f32); where it never does, an
unreachable boundary sends every decode to the scan. The file written
(``gru_textgen.dispatch_calibration_path()``, or ``--output``; bf16 only,
``decode()``'s default dtype) holds the thresholds, the evidence, the card
and the protocol; ``decode()`` reads its ``min_b`` and ``min_t`` in place
of the committed defaults.

Run from the root of a checkout:

    python3 tools/torch_recalibrate_decode.py [--margin 1.15] [--dry-run] [--out FILE]
        [--compute bfloat16|float32]

``--dry-run`` measures and prints without writing the calibration file;
``--out`` also writes the whole record (with the evidence) to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

# the sweep grid: candidate routing boundaries, smallest first
GRID_B = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
GRID_T = (64, 128, 256, 512)
NEVER = 1 << 30     # a boundary no call reaches: every decode takes the scan


def pick_thresholds(evidence: dict, grid_a, grid_b, margin: float, key: str = "B{}_T{}"):
    """The smallest (a, b) of the grid such that every cell at and above it
    (a' >= a and b' >= b) has ``fused_speedup >= margin``: the first such a,
    then its first b. ``(NEVER, NEVER)`` where no cell qualifies."""
    def wins(a, b):
        return all(evidence[key.format(aa, bb)]["fused_speedup"] >= margin
                   for aa in grid_a if aa >= a for bb in grid_b if bb >= b)

    for a in grid_a:
        for b in grid_b:
            if wins(a, b):
                return a, b
    return NEVER, NEVER


def pick_gate(evidence: dict, grid_a, grid_b, margin: float, key: str = "B{}_T{}"):
    """(min_a, min_b, max_a): :func:`pick_thresholds`' corner over the rows
    of ``grid_a`` up to max_a, the most rows in which one exists (max_a None:
    every row). Where the fused path loses at the largest a (f32, whose
    kernels multiply on the CUDA cores), the gate gets an upper bound instead
    of no corner at all; where no rows have a corner, (NEVER, NEVER, None)."""
    for k in range(len(grid_a), 0, -1):
        lo = pick_thresholds(evidence, grid_a[:k], grid_b, margin, key)
        if lo[0] != NEVER:
            return (*lo, None if k == len(grid_a) else grid_a[k - 1])
    return NEVER, NEVER, None


def write_calibration(path: str, record: dict) -> None:
    """Write ``record`` (``min_b``, ``min_t`` and the evidence) where
    ``dispatch_thresholds()`` reads it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def smi_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def make_params(dev, qtype: str = "q8_0", seed: int = 0):
    """The full-width GRU (V=66, E=256, U=1024) with weights from ``seed``."""
    import numpy as np

    from ggml_experiments_tpu_torch.convert import params_from_numpy

    rng = np.random.default_rng(seed)
    v, e, u = 66, 256, 1024
    shapes = {"embeddings": (v, e), "kernel": (e, 3 * u), "recurrent_kernel": (u, 3 * u),
              "bias": (2, 3 * u), "dense_kernel": (u, v), "dense_bias": (v,)}
    arrays = {k: (rng.standard_normal(s) * 0.08).astype(np.float32) for k, s in shapes.items()}
    return params_from_numpy(arrays, qtype=qtype, device=dev)


def decode_inputs(b: int, dev, seed: int = 0, v: int = 66):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + b)
    prompt = torch.as_tensor(rng.integers(0, v, (b, 8)), device=dev)
    return prompt, torch.full((b,), 8, dtype=torch.int64, device=dev)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--margin", type=float, default=1.15,
                    help="fused must beat scan by this ratio of medians to route")
    ap.add_argument("--dry-run", action="store_true",
                    help="measure and print; do not write the calibration file")
    ap.add_argument("--output", default=None,
                    help="calibration file (default: gru_textgen.dispatch_calibration_path())")
    ap.add_argument("--out", default=None, help="also write the whole record here")
    ap.add_argument("--compute", choices=["bfloat16", "float32"], default="bfloat16",
                    help="both paths' compute dtype (decode()'s default is bfloat16)")
    args = ap.parse_args()
    if args.compute != "bfloat16" and not args.dry_run:
        ap.error("the calibration file holds decode()'s bf16 gate (its default dtype); "
                 "measure another dtype with --dry-run")

    import torch

    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.ops.fused_gru_decode import fused_gru_decode
    from ggml_experiments_tpu_torch.utils.benchmarking import PROTOCOL, timeit_stats

    if not torch.cuda.is_available():
        print("torch_recalibrate_decode: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = smi_line()
    params = make_params(dev)
    cd = getattr(torch, args.compute)
    evidence = {}
    for b in GRID_B:
        prompt, lengths = decode_inputs(b, dev)
        for t in GRID_T:
            st_scan = timeit_stats(lambda: gru_textgen.generate(
                params, prompt, lengths, t, compute_dtype=cd))
            st_fused = timeit_stats(lambda: fused_gru_decode(
                params, prompt, lengths, t, compute_dtype=cd))
            cell = {"scan": st_scan.asdict(), "fused": st_fused.asdict(),
                    "fused_speedup": round(st_scan.headline / st_fused.headline, 4)}
            evidence[f"B{b}_T{t}"] = cell
            print(json.dumps({"cell": f"B{b}_T{t}", **cell}), flush=True)
    min_b, min_t, max_b = pick_gate(evidence, GRID_B, GRID_T, args.margin)
    record = {"min_b": min_b, "min_t": min_t, "max_b": max_b, "margin": args.margin,
              "measured_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
              "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "protocol_rev": PROTOCOL["rev"], "protocol": PROTOCOL, "compute": args.compute,
              "grid": {"B": GRID_B, "T": GRID_T}, "evidence": evidence}
    print(json.dumps({"min_b": min_b, "min_t": min_t, "max_b": max_b, "compute": args.compute,
                      "nvidia_smi": smi}), flush=True)
    if args.out:
        write_calibration(args.out, record)
    if not args.dry_run:
        path = args.output or gru_textgen.dispatch_calibration_path()
        write_calibration(path, record)
        print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
