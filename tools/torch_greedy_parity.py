#!/usr/bin/env python3
"""Greedy work of the port on the card, written to a file; two files compared
bit for bit.

    cd <checkout> && python3 /path/to/tools/torch_greedy_parity.py --out a.npz
    python3 tools/torch_greedy_parity.py --compare a.npz b.npz

The package is imported from the working directory, so running the first
command from the roots of two checkouts (say a change and its parent) on one
card, then the second, shows whether the change left the bits of greedy work
as they were. The work: ``decode()`` routed to the persistent kernel on
``checkpoints/gru_shakespeare.bin`` (q8_0, and q5_1 for the dense weight
route) under each plan ``decode_plan`` picks (bf16 at B=4096 slot-owned and
B=512 unit-owned, f32 at B=256), and greedy serving ticks of 512 slots x 128
inner steps at bf16 and f32, from one seeded input; tokens and final states.
Run it for any change to ``csrc/gru_persistent.cu`` or its wrappers that
must leave greedy work as it was (the card tests hold the kernel against
its plain version, not against the parent's bits).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.append(os.getcwd())   # the checkout run from

CKPT = os.path.join("checkpoints", "gru_shakespeare.bin")


def run(out: str) -> None:
    import torch

    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.serving.engine import init_state

    if not torch.cuda.is_available():
        raise SystemExit("torch_greedy_parity: no CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    res = {}
    for qtype in ("q8_0", "q5_1"):
        params = load_gru_params(CKPT, qtype=qtype, device=dev)
        for b, t, cd in ((4096, 64, torch.bfloat16), (512, 64, torch.bfloat16),
                         (256, 64, torch.float32)):
            ids = rng.integers(0, 66, (b, 32)).astype(np.int32)
            lens = rng.integers(1, 33, b).astype(np.int32)
            toks, h = fused.fused_gru_decode(params, ids, lens, t, compute_dtype=cd,
                                             return_state=True)
            key = f"decode_{qtype}_{b}_{str(cd)[6:]}"
            res[key + "_toks"], res[key + "_h"] = toks.cpu().numpy(), h.cpu().numpy()
        for cd in (torch.bfloat16, torch.float32):
            st = init_state(params, 512, 64)
            st.prompt = torch.from_numpy(rng.integers(0, 66, (512, 64)).astype(np.int32)).to(dev)
            st.plen = torch.from_numpy(rng.integers(1, 65, 512).astype(np.int32)).to(dev)
            st.total = st.plen + torch.from_numpy(rng.integers(0, 200, 512).astype(np.int32)).to(
                dev)
            s2, toks = fused.fused_slot_tick(params, st, 128, compute_dtype=cd)
            key = f"tick_{qtype}_{str(cd)[6:]}"
            for name in ("h", "prev", "pos"):
                res[f"{key}_{name}"] = getattr(s2, name).cpu().numpy()
            res[key + "_toks"] = toks.cpu().numpy()
    torch.cuda.synchronize()
    np.savez(out, **res)
    print(f"{len(res)} arrays from {os.getcwd()} on {torch.cuda.get_device_name(0)} -> {out}")


def compare(a: str, b: str) -> int:
    with np.load(a) as fa, np.load(b) as fb:
        keys = sorted(fa.files)
        if keys != sorted(fb.files):
            print(f"the files hold other arrays: {sorted(set(keys) ^ set(fb.files))}")
            return 1
        differ = [k for k in keys if not np.array_equal(fa[k], fb[k])]
    print(f"{len(keys) - len(differ)} of {len(keys)} arrays bit-equal"
          + (f"; differ: {differ}" if differ else ""))
    return 1 if differ else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not args.out:
        ap.error("--out or --compare")
    run(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
