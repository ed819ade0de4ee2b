#!/usr/bin/env python3
"""Time the port's scan and fused decode at one (B, T) on one NVIDIA GPU,
interleaved round by round (scan, fused, scan, fused, ...) so that a
disturbance of the card or the host lands on both, and print every round.

The port's counterpart of ``tools/diag_decode_dispatch.py``: the same
full-width q8_0 GRU as ``tools/torch_recalibrate_decode.py``, bf16, each
round the wall clock of ``--reps`` calls closed by a synchronize with the
CUDA-event span beside it (``utils/benchmarking.time_round``).

Run from the root of a checkout:

    python3 tools/torch_diag_decode_dispatch.py [--batch 1024] [--steps 256]
        [--rounds 6] [--reps 10]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch

    from torch_recalibrate_decode import decode_inputs, make_params, smi_line

    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.ops.fused_gru_decode import fused_gru_decode
    from ggml_experiments_tpu_torch.utils.benchmarking import time_round

    if not torch.cuda.is_available():
        print("torch_diag_decode_dispatch: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    b, t = args.batch, args.steps
    params = make_params(dev)
    prompt, lengths = decode_inputs(b, dev)
    paths = {
        "scan": lambda: gru_textgen.generate(params, prompt, lengths, t,
                                             compute_dtype=torch.bfloat16),
        "fused": lambda: fused_gru_decode(params, prompt, lengths, t,
                                          compute_dtype=torch.bfloat16),
    }
    for fn in paths.values():    # build, set up and warm both
        time_round(fn, 2, True)
    rounds = {k: [] for k in paths}
    for r in range(args.rounds):
        for name, fn in paths.items():
            wall, dev_s = time_round(fn, args.reps, True)
            rounds[name].append((wall, dev_s))
            print(f"B={b} T={t} round {r} {name:5s}: {wall * 1e3:9.3f} ms/call wall, "
                  f"{dev_s * 1e3:9.3f} device span ({b * t / wall / 1e6:7.3f} M tok/s)",
                  flush=True)
    summary = {}
    for name, rs in rounds.items():
        walls = [w for w, _ in rs]
        summary[name] = {
            "best_ms": round(min(walls) * 1e3, 4),
            "median_ms": round(statistics.median(walls) * 1e3, 4),
            "worst_ms": round(max(walls) * 1e3, 4),
            "spread": round(max(walls) / min(walls), 4),
            "device_median_ms": round(statistics.median(d for _, d in rs) * 1e3, 4),
            "median_mtok_s": round(b * t / statistics.median(walls) / 1e6, 4),
        }
    print(json.dumps({"batch": b, "steps": t, "reps": args.reps, "rounds": args.rounds,
                      "nvidia_smi": smi_line(), "results": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
