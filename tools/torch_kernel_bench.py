#!/usr/bin/env python3
"""Time the port's qmatmul and flash attention kernels on one NVIDIA GPU,
beside the one PyTorch call that computes the same function.

Run from the root of a checkout:

    python3 tools/torch_kernel_bench.py [--sweep] [--out FILE]

Run from another checkout's root (``cd other && python3
/path/to/tools/torch_kernel_bench.py``) it times that checkout's kernels
instead, so two versions can be compared on one card in one run. qmatmul
runs on the recurrent kernel of ``checkpoints/gru_shakespeare.bin`` (1024 x
3072) quantized to every format, at M = 64 and 1024, f32 and bf16; flash
attention at MobileViT's three stages for B = 128 (bp, L, C, H) = (512,
256, 144, 4), (512, 64, 192, 4), (512, 16, 240, 4). Three times per cell:
``call`` is CUDA events around one wrapper call from an idle card (as
chip_smoke.py measures, the wrapper's host work included), ``stream`` the
mean of 20 calls issued back to back (the card's time where the host keeps
ahead), ``graph`` the mean of 20 calls replayed from a CUDA graph (the
card's time alone). ``--sweep`` also times the qmatmul kernel at other
launch configurations (bm, ksplit, blocks per split), where the checkout's
wrapper takes one.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.append(os.getcwd())   # the checkout run from, unless PYTHONPATH names one

CKPT = os.path.join("checkpoints", "gru_shakespeare.bin")
QTYPES = ("q8_0", "q4_0", "q4_1", "q5_0", "q5_1", "q4_k")
FLASH_SHAPES = ((512, 256, 144, 4), (512, 64, 192, 4), (512, 16, 240, 4))


def call_ms(fn, n=20, warmup=3):
    """Median ms of one call between CUDA events, the card idle before it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def stream_ms(fn, n=20, reps=5):
    """Median over ``reps`` of the mean ms of ``n`` calls issued back to back."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / n)
    return statistics.median(out)


def graph_ms(fn, n=20, reps=5):
    """Mean ms of one call inside a CUDA graph of ``n`` calls: the card's own
    time, with no host work between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / n)
    return statistics.median(out)


def both(fn):
    res = {"call": call_ms(fn), "stream": stream_ms(fn)}
    try:
        res["graph"] = graph_ms(fn)
    except RuntimeError as ex:    # a version whose launches cannot be captured
        res["graph"] = None
        res["graph_error"] = str(ex)[:200]
    return res


def qmatmul_cells(sweep):
    import importlib

    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.quant.qtensor import dequantize, quantize

    # the quant package re-exports a function under the module's name
    qmm = importlib.import_module("ggml_experiments_tpu_torch.quant.qmatmul")

    dev = torch.device("cuda")
    w = load_gru_params(CKPT, device="cpu").cell.recurrent_kernel.numpy()
    takes_config = "config" in inspect.signature(qmm.qmatmul_cuda).parameters
    rows = []
    for qtype in QTYPES:
        qt = quantize(w, qtype, device=dev)
        for m in (64, 1024):
            x = torch.randn((m, qt.k), generator=torch.Generator(device=dev).manual_seed(m),
                            device=dev)
            for cd in (torch.float32, torch.bfloat16):
                row = {"qtype": qtype, "m": m, "dtype": str(cd).split(".")[1]}
                row["kernel"] = both(lambda: qmm.qmatmul_cuda(x, qt, cd))
                wd, xc = dequantize(qt).to(cd), x.to(cd)
                row["library"] = both(lambda: torch.matmul(xc, wd))
                if sweep and takes_config:
                    nblk = -(-qt.k // 32)
                    cands = [(bm, ks) for bm in (64, 128) for ks in (1, 2, 3, 4, 6, 8)]
                    row["sweep"] = {}
                    for bm, ks in cands:
                        bps = -(-nblk // ks)
                        if qtype == "q4_k":
                            bps = -(-bps // 8) * 8
                        if (ks - 1) * bps >= nblk:
                            continue
                        cfg = (bm, ks, bps)
                        row["sweep"][str(cfg)] = both(
                            lambda: qmm.qmatmul_cuda(x, qt, cd, config=cfg))
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def flash_cells():
    import torch.nn.functional as F

    from ggml_experiments_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for bp, l, c, h in FLASH_SHAPES:
        qkv = [torch.randn((bp, l, c), generator=g, device=dev) for _ in range(3)]
        q16 = [t.to(torch.bfloat16) for t in qkv]
        heads = [t.reshape(bp, l, h, c // h).transpose(1, 2).contiguous() for t in qkv]
        row = {"bp": bp, "l": l, "c": c, "h": h,
               "f32": both(lambda: fa.flash_mha_cuda(*qkv, h)),
               "bf16": both(lambda: fa.flash_mha_cuda(*q16, h)),
               "sdpa_f32": both(lambda: F.scaled_dot_product_attention(*heads))}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    import ggml_experiments_tpu_torch as port

    print(f"{smi} | package {os.path.dirname(port.__file__)}", flush=True)
    res = {"device": smi, "qmatmul": qmatmul_cells(args.sweep), "flash": flash_cells()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
