#!/usr/bin/env python3
"""Time the port's qmatmul, flash attention, persistent GRU, GRU training,
transformer layer and inverted residual kernels on one NVIDIA GPU, beside
the PyTorch call (or, for the inverted residual, the chain of calls) that
computes the same function where there is one.

Run from the root of a checkout:

    python3 tools/torch_kernel_bench.py [--sweep] [--split-step] [--only qmatmul,flash,gru,train,train_f32,layer,ir,attention_f32,forward,ir_wide,layer_wide] [--vocab 66,257,5000] [--units 1024,1000] [--out FILE]

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

The persistent GRU kernel (``gru``) runs on the same checkpoint at q8_0
(and q4_0 for its decode cell): the offline decode at B=8192, T=512 and
at B=2048, T=256 (q4_0), and one serving tick of 512 slots x 128 steps,
greedy and sampled (temperature 0.8, top-k 20, top-p 0.9), bf16, each from
prompts of 1-16 tokens; then the f32 route: the decode at B=1024, T=256 (as
chip_smoke.py's phase 4 holds it) and the greedy and sampled tick. One
launch is long next to its host work, so these cells take ``call`` (3
calls) and ``graph`` (3 launches replayed from a CUDA graph) alone, beside
the operations bound 2 (3U^2 + UV) a slot-step at the bf16 peak.
``--vocab`` / ``--units`` run these cells at each (V, U): the checkpoint at
(66, 1024), seeded random weights of the reference's E = 256 elsewhere; a
checkout whose kernel refuses a shape records the refusal.
``--sweep`` times every plan the checkout's wrapper takes (``config=``) at
B = 512, 1024, 2048, 3072, 4096, 8192 for 64 steps, which is where
``decode_plan``'s crossover comes from.
``--split-step`` builds copies of ``csrc/gru_persistent.cu`` with one part of
the step switched off (the unit-owned loop's phase A, its logits phase, or
both; the slot-owned loop's wgmma) into ``build/split_step`` and times each
beside the unchanged source: what a part costs is the difference.

The training pair (``train``) runs on seeded random operands at U=1024,
bf16, (B, T) = (1024, 100), (64, 100) and (2048, 100): the forward and the
backward wrapper (``call``, as chip_smoke.py measures them); beside them
``torch.nn.GRU(256, 1024)`` on cuDNN, whose cell is the same reset-after GRU
(gates in another order), forward and ``torch.autograd.grad`` of its output
(it also computes the input projection, E=256, which flatters it slightly;
fp16 where the build refuses bf16, with the same bytes and tensor-core
rate), the kernels cuDNN ran, and ``torch.matmul`` of one step's recurrent
product times T (the library's floor for the recurrence, information only).
``--sweep`` times every plan the checkout's ``train_plans`` offers at B =
64, 256, 1024, 2048, 4096, T=100, which is where ``train_plan``'s defaults
come from; ``--split-step`` builds copies of ``csrc/gru_train.cu`` with the
products, the forward's epilogue or the row-tile barrier off and times
them beside the unchanged source at B=1024 and 64.

Its f32 form (``train_f32``, where the checkout has one) runs at (B, T) =
(1024, 100) and (64, 100) on seeded random f32 operands: the forward, the
backward recurrence and dWr, ``torch.matmul`` f32 of dWr's whole product
and cuDNN's f32 GRU (TF32 off for both), dWr's distance to its plain
version and to the f64 sum, and the 3xTF32 bound; ``--sweep`` times the
forward on every forward plan the checkout's ``train_plans(...,
dtype=float32)`` offers and the recurrence on every backward plan it takes
(each forced through ``config=``, whatever form the checkout's plans have).

The fused transformer layer (``layer``) runs at the 9 launch shapes of a
MobileViT-small forward at B=128 on seeded random weights: the layer as one
call (its three kernels where the checkout splits it), each kernel alone,
and ``nn.TransformerEncoderLayer`` in bf16 as the library's yardstick;
then ``extract_features`` at B=128, bf16, on ``mobilevit_synth_full.ggml``
(``call``). Its f32 form (``layer_f32``, where the checkout has one) at the
same shapes: the layer and each kernel beside the 3xTF32 bound,
``nn.TransformerEncoderLayer`` f32 (TF32 off) and
``scaled_dot_product_attention`` f32, then ``extract_features`` f32 at
B=128 with the f32 route on and off. ``--sweep`` times each ring depth of the row-tile kernels;
``--split-step`` builds copies of ``csrc/transformer_layer.cu`` with the
products, the global stores or the weight stream off and times each kernel
of a middle layer of each stage beside the unchanged source. ``--only
attention_f32 --split-step`` builds copies of
``csrc/transformer_layer_f32.cu`` whose attention has one part off or
changed (two of q.k^T's or of P.v's three products a k-step, the
transposing pass, the ctx stores, expf for the exponent, the warpgroups in
step, the key mask on every score) and times each at the three stages
(CUDA graphs) beside the unchanged source, which runs first and last.

The inverted residual (``ir``) runs at B=128 on seeded random weights at
the main path's shape (64 x 64, 64 -> 256 -> 64, residual) and a
layer_1-like one (128 x 128, 16 -> 64 -> 32): the kernel on operands made
once (``call``, ``stream``, ``graph``, and the wrapper's host time a call),
its error against the plain version, the plain version's time, the cuDNN
chain (three ``F.conv2d`` in channels_last bf16, BN folded, two
``F.silu``, ``+ x``) as the library's yardstick and the bound; then
``extract_features`` at B=128 on ``mobilevit_synth_full.ggml`` at f32, bf16
and bf16 with ``fused_ir`` (``call``). ``--sweep`` times every plan the
strip kernel takes; ``--split-step`` builds copies of
``csrc/inverted_residual.cu`` with the expand, the depthwise, the reduce,
the output stores or the SiLUs off, the reduce in narrower items, or
silu_fast, the correctly rounded SiLU or uncontracted taps, and times each
(with its error) beside the unchanged source.

``--only forward`` times ``extract_features`` alone at B=128 on the full
checkpoint's default routes, bf16 and f32, at 256 and 512 px.

``--only ir_wide`` times the bf16 stride-1 inverted residual at the widths
the strip kernel does not take (IR_WIDE_CELLS: E = 384, C = 96, a ragged C
= 20, Cout = 264) and ``--only layer_wide`` the bf16 layer past C = 288
(LAYER_WIDE_CELLS, every flag on and none), each on seeded random weights: the
kernel (``call``, ``stream``, ``graph``) beside its error against the plain
version, the plain version's time, the library's yardstick (the cuDNN
chain; ``nn.TransformerEncoderLayer(C, H, F, SiLU, norm_first)`` in bf16
with the input and output projections as ``F.linear``) and the bound, and
for the layer each of its kernels alone and the wide kernels' groups on
one block a row tile against the split the wrapper picks. They run on any
checkout whose wrappers take these widths: a parent's kernels beside the
change's.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.append(os.getcwd())   # the checkout run from, unless PYTHONPATH names one


def _load_observability():
    """This tool's own checkout's ``utils/observability`` (the H100's peaks,
    the inverted residual's bound and cuDNN chain), loaded by path, so that
    a run from another checkout's root bounds its kernels by the same
    figures and times the same library chain."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "ggml_experiments_tpu_torch", "utils", "observability.py")
    spec = importlib.util.spec_from_file_location("_gxt_observability", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


_OBS = _load_observability()
H100 = _OBS.H100
inverted_residual_bound = _OBS.inverted_residual_bound
cudnn_inverted_residual = _OBS.cudnn_inverted_residual
transformer_layer_bound = _OBS.transformer_layer_bound

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


def host_us(fn, n=300, reps=5):
    """Host microseconds of one call: n calls issued without waiting for
    the card, over n; the least and the median of ``reps`` such runs (the
    host is shared: the least is the cleanest). Where n calls launch more
    than the card's queue holds (a wrapper with many small launches a call),
    the host waits for the card and this reads the card's time instead."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return {"min": min(runs), "median": statistics.median(runs)}


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


def _gru_inputs(b, t, seed=0, v=66, u=1024):
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed)
    prompt = torch.randint(0, v, (b, 16), generator=g, dtype=torch.int32).to(dev)
    plen = torch.randint(1, 17, (b,), generator=g, dtype=torch.int32).to(dev)
    total = torch.full((b,), t, dtype=torch.int32, device=dev)
    z = torch.zeros(b, dtype=torch.int32, device=dev)
    return prompt, plen, total, z, z.clone(), torch.zeros((b, u), device=dev)


def random_gru(v, u, qtype, e=256, seed=0):
    """A GRU of the reference's E at vocabulary V and U units, random
    weights made from ``seed`` (the checkpoint's scales), on the card."""
    import numpy as np
    from ggml_experiments_tpu_torch.convert import params_from_numpy

    rng = np.random.default_rng(seed)
    a = {"embeddings": rng.normal(0, 0.5, (v, e)), "kernel": rng.normal(0, e ** -0.5, (e, 3 * u)),
         "recurrent_kernel": rng.normal(0, u ** -0.5, (u, 3 * u)),
         "bias": rng.normal(0, 0.1, (2, 3 * u)), "dense_kernel": rng.normal(0, 3 * u ** -0.5, (u, v)),
         "dense_bias": rng.normal(0, 0.1, (v,))}
    return params_from_numpy({k: x.astype(np.float32) for k, x in a.items()}, qtype=qtype,
                             device="cuda")


def gru_bound_ms(b, t, u, v):
    """The persistent loop's operations bound: 2 (3U^2 + U V) a slot-step at
    the bf16 tensor-core peak (the f32 route's CUDA-core FMAs would be
    slower; the bf16 figure is the card's least time for the same work)."""
    return 2.0 * (3 * u * u + u * v) * b * t / (H100.bf16_tflops * 1e12) * 1e3


def gru_cells(sweep, vocabs=(66,), units=(1024,)):
    """The decode and tick cells at each (V, U): the checkpoint at (66, 1024),
    seeded random weights of E = 256 elsewhere. Each is timed from a CUDA
    graph of 3 launches (the card's time alone) and as one call."""
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fd

    bf16, f32 = torch.bfloat16, torch.float32
    takes_config = "config" in inspect.signature(fd.gru_loop_cuda).parameters
    rows = []
    sampled = dict(seed=7, top_k=20, top_p=0.9)
    cells = [("decode", "q8_0", 8192, 512, bf16, {}), ("decode", "q4_0", 2048, 256, bf16, {}),
             ("tick", "q8_0", 512, 128, bf16, {}),
             ("tick_sampled", "q8_0", 512, 128, bf16, sampled),
             ("decode", "q8_0", 1024, 256, f32, {}), ("tick", "q8_0", 512, 128, f32, {}),
             ("tick_sampled", "q8_0", 512, 128, f32, sampled)]
    for v in vocabs:
        for u in units:
            weights = {}
            for q in ("q8_0", "q4_0"):
                p = (load_gru_params(CKPT, qtype=q, device="cuda") if (v, u) == (66, 1024)
                     else random_gru(v, u, q))
                weights[q] = fd._prep_weights(p)
            for name, qtype, b, t, cd, kw in cells:
                w, args = weights[qtype], _gru_inputs(b, t, v=v, u=u)
                if kw:
                    kw = dict(kw, temp=torch.full((b,), 0.8, device="cuda"))
                entry = "fused_gru_decode" if name == "decode" else "fused_slot_tick"
                row = {"cell": name, "qtype": qtype, "v": v, "u": u, "b": b, "t": t,
                       "dtype": str(cd)[6:], "bound_ms": gru_bound_ms(b, t, u, v)}

                def fn():
                    fd.gru_loop_cuda(entry, w, *args, t, cd, **kw)
                try:
                    row["call"] = call_ms(fn, n=3, warmup=1)
                except (ValueError, RuntimeError) as ex:   # a checkout that does not take (V, U)
                    row["error"] = str(ex)[:200]
                    rows.append(row)
                    print(json.dumps(row), flush=True)
                    continue
                try:
                    row["graph"] = graph_ms(fn, n=3, reps=3)
                except RuntimeError as ex:
                    row["graph"], row["graph_error"] = None, str(ex)[:200]
                row["us_per_step"] = (row["graph"] or row["call"]) * 1e3 / t
                row["plan"] = str(getattr(fd, "LAST_PLAN", {}).get(entry))
                rows.append(row)
                print(json.dumps(row), flush=True)
    if sweep and takes_config:
        w = weights["q8_0"]
        plans = [fd.DecodePlan("unit")] + [fd.DecodePlan("slot", st) for st in fd.SLOT_STAGES]
        for b in (512, 1024, 2048, 3072, 4096, 8192):
            args = _gru_inputs(b, 64, seed=b)
            row = {"cell": "sweep", "b": b, "t": 64, "default": str(fd.decode_plan(b, 1024, 66)),
                   "us_per_step": {}}
            for plan in plans:
                try:
                    fd.check_plan(plan, 1024, 66, True)
                except ValueError:
                    continue
                ms = call_ms(lambda: fd.gru_loop_cuda("fused_slot_tick", w, *args, 64, bf16,
                                                      config=plan), n=3, warmup=1)
                row["us_per_step"][str(plan)] = ms * 1e3 / 64
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


TRAIN_CELLS = ((1024, 100), (64, 100), (2048, 100))     # (B, T) at U=1024, bf16
TRAIN_SWEEP_B = (64, 256, 1024, 2048, 4096)


def _train_operands(b, t, u=1024, seed=0):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    mxs = (torch.randn((t, b, 3 * u), generator=g, device=dev) * 0.8).to(bf)
    h0 = (torch.randn((b, u), generator=g, device=dev) * 0.3).to(bf)
    wr = (torch.randn((u, 3 * u), generator=g, device=dev) / u ** 0.5).to(bf)
    brec = torch.randn((3 * u,), generator=g, device=dev) * 0.2
    dys = (torch.randn((t, b, u), generator=g, device=dev) * 0.01).to(bf)
    return mxs, h0, wr, brec, dys


def _device_kernels(fn, top=4):
    """Names of the kernels one call of ``fn`` runs, by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(getattr(e, "self_device_time_total", 0.0), e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return [k[:80] for _, k in sorted(rows, reverse=True)[:top]]


def cudnn_gru(b, t, e=256, u=1024, dtypes=(torch.bfloat16, torch.float16)):
    """``torch.nn.GRU(e, u)`` forward and backward at (B, T) in the first of
    ``dtypes`` the build takes (bf16 or fp16; f32 with TF32 off)."""
    dev = torch.device("cuda")
    err = None
    for dt in dtypes:
        try:
            gru = torch.nn.GRU(e, u).to(dev, dt)
            gru.flatten_parameters()
            g = torch.Generator(device=dev).manual_seed(b)
            x = torch.randn((t, b, e), generator=g, device=dev).to(dt).requires_grad_()
            h0 = (torch.randn((1, b, u), generator=g, device=dev) * 0.3).to(dt).requires_grad_()
            dy = (torch.randn((t, b, u), generator=g, device=dev) * 0.01).to(dt)
            leaves = [x, h0, *gru.parameters()]
            fwd = call_ms(lambda: gru(x, h0), n=5, warmup=1)
            out, _ = gru(x, h0)
            bwd = call_ms(lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True), n=5,
                          warmup=1)
            return {"cudnn_dtype": str(dt)[6:], "cudnn_fwd": fwd, "cudnn_bwd": bwd,
                    "cudnn_version": torch.backends.cudnn.version(),
                    "cudnn_fwd_kernels": _device_kernels(lambda: gru(x, h0)),
                    "cudnn_bwd_kernels": _device_kernels(
                        lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True))}
        except RuntimeError as ex:
            err = f"{str(dt)[6:]}: {str(ex)[:200]}"
    return {"cudnn_error": err}


def train_cells(sweep):
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    takes_config = "config" in inspect.signature(ft.gru_train_fwd_cuda).parameters
    rows = []
    for b, t in TRAIN_CELLS:
        mxs, h0, wr, brec, dys = _train_operands(b, t)
        ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
        row = {"cell": "train", "b": b, "t": t, "u": 1024,
               "plan": str(ft.train_plan(b, 1024)) if hasattr(ft, "train_plan") else None,
               "fwd": call_ms(lambda: ft.gru_train_fwd_cuda(mxs, h0, wr, brec), n=5, warmup=1),
               "bwd": call_ms(lambda: ft.gru_train_bwd_cuda(mxs, mhs, ys, dys, h0, wr), n=5,
                              warmup=1)}
        if hasattr(ft, "gru_train_dwr_cuda"):     # the backward's two kernels apart
            dmxs, plane, _, _ = ft.gru_train_bwd_rec_cuda(mxs, mhs, ys, dys, h0, wr)
            row["bwd_rec"] = call_ms(
                lambda: ft.gru_train_bwd_rec_cuda(mxs, mhs, ys, dys, h0, wr), n=5, warmup=1)
            row["dwr"] = call_ms(lambda: ft.gru_train_dwr_cuda(h0, ys, dmxs, plane), n=5,
                                 warmup=1)
            del dmxs, plane
        row.update(cudnn_gru(b, t))
        row["matmul_step_x_t"] = call_ms(lambda: torch.matmul(h0, wr)) * t
        rows.append(row)
        print(json.dumps(row), flush=True)
        del mxs, h0, wr, brec, dys, ys, mhs
    if sweep and takes_config:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for b in TRAIN_SWEEP_B:
            t = 100
            mxs, h0, wr, brec, dys = _train_operands(b, t, seed=b)
            ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
            row = {"cell": "train_sweep", "b": b, "t": t,
                   "default": str(ft.train_plan(b, 1024, sms)), "fwd": {}, "bwd": {}}
            for plan in ft.train_plans(b, 1024, sms):
                row["fwd"][str(plan)] = call_ms(
                    lambda: ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=plan), n=3, warmup=1)
                row["bwd"][str(plan)] = call_ms(
                    lambda: ft.gru_train_bwd_cuda(mxs, mhs, ys, dys, h0, wr, config=plan), n=3,
                    warmup=1)
            rows.append(row)
            print(json.dumps(row), flush=True)
            del mxs, h0, wr, brec, dys, ys, mhs
    return rows


TRAIN_F32_CELLS = ((1024, 100), (64, 100))     # (B, T) at U=1024, f32


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()) / float(b.double().abs().max())


def train_f32_cells(sweep):
    """The f32 train pair at (B, T) = (1024, 100), (64, 100), U=1024, on
    seeded random f32 operands: the forward, the backward recurrence and dWr
    (``call``), ``torch.matmul`` f32 of dWr's product on the same operands
    and cuDNN's f32 GRU (TF32 off for both), dWr's distance to its plain
    version and to the f64 sum (and the plain version's), the 3xTF32 bound;
    with ``sweep``, the forward on every forward plan the checkout's
    ``train_plans(..., dtype=float32)`` offers and the recurrence on every
    backward plan it takes (its own backward cuts where it has them, else
    the forward's plans), each forced through ``config=``."""
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    params = inspect.signature(ft.train_plans).parameters
    if "dtype" not in params or not hasattr(ft, "gru_train_dwr_cuda"):
        return [{"cell": "train_f32", "skipped": "the checkout has no f32 train pair"}]
    own_bwd = "part" in params
    f32, u = torch.float32, 1024
    dev = torch.device("cuda")
    tf32_conv = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for b, t in TRAIN_F32_CELLS:
        g = torch.Generator(device=dev).manual_seed(b)
        mxs = torch.randn((t, b, 3 * u), generator=g, device=dev) * 0.8
        h0 = torch.randn((b, u), generator=g, device=dev) * 0.3
        wr = torch.randn((u, 3 * u), generator=g, device=dev) / u ** 0.5
        brec = torch.randn((3 * u,), generator=g, device=dev) * 0.2
        dys = torch.randn((t, b, u), generator=g, device=dev) * 0.01
        ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
        dmxs, plane, _, _ = ft.gru_train_bwd_rec_cuda(mxs, mhs, ys, dys, h0, wr)
        hp = torch.cat([h0[None], ys[:-1]]).reshape(t * b, u)
        dmh = torch.cat([dmxs[..., :2 * u], plane], dim=2).reshape(t * b, 3 * u)
        got = ft.gru_train_dwr_cuda(h0, ys, dmxs, plane)
        want = ft.gru_train_dwr_plain(h0, ys, dmxs, plane)
        exact = ft.gru_train_dwr_plain(h0.double(), ys.double(), dmxs.double(), plane.double())
        ops = 2 * t * b * u * 3 * u
        row = {"cell": "train_f32", "b": b, "t": t, "u": u,
               "fwd_plan": str(ft.train_plan(b, u, sms, dtype=f32)),
               "bwd_plan": str(ft.train_plan(b, u, sms, dtype=f32, part="bwd") if own_bwd
                               else ft.train_plan(b, u, sms, dtype=f32)),
               "dwr_partitions": ft.dwr_partitions(t, b, u, sms)
               if hasattr(ft, "dwr_partitions") else 1,
               "fwd": call_ms(lambda: ft.gru_train_fwd_cuda(mxs, h0, wr, brec), n=5, warmup=1),
               "bwd_rec": call_ms(lambda: ft.gru_train_bwd_rec_cuda(mxs, mhs, ys, dys, h0, wr),
                                  n=5, warmup=1),
               "dwr": call_ms(lambda: ft.gru_train_dwr_cuda(h0, ys, dmxs, plane), n=5,
                              warmup=1),
               "matmul_f32": call_ms(lambda: torch.matmul(hp.t(), dmh), n=5, warmup=1),
               "bound_ms": H100.bound_ms(0, ops, "tf32x3")[0],
               "dwr_rel_plain": _rel(got, want), "dwr_rel_f64": _rel(got, exact),
               "plain_rel_f64": _rel(want, exact)}
        del got, want, exact, hp, dmh
        row.update({f"f32_{k}": v for k, v in cudnn_gru(b, t, dtypes=(f32,)).items()})
        if sweep:
            row["fwd_sweep"] = {str(tuple(p)): call_ms(
                lambda: ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=tuple(p)), n=3, warmup=1)
                for p in ft.train_plans(b, u, sms, dtype=f32)}
            plans = (ft.train_plans(b, u, sms, dtype=f32, part="bwd") if own_bwd
                     else ft.train_plans(b, u, sms, dtype=f32))
            row["bwd_rec_sweep"] = {str(tuple(p)): call_ms(
                lambda: ft.gru_train_bwd_rec_cuda(mxs, mhs, ys, dys, h0, wr, config=tuple(p)),
                n=3, warmup=1) for p in plans}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del mxs, h0, wr, brec, dys, ys, mhs, dmxs, plane
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = tf32_conv
    return rows


# (variant, the source text switched off) for --split-step; each toggle is a
# macro the copy defines to 1
SPLIT_STEP_TOGGLES = (
    ("SKIP_A", "      phase_a_bf16(a, ", "      if (!SKIP_A) phase_a_bf16(a, "),
    ("SKIP_B", "      phase_b_bf16(a, ", "      if (!SKIP_B) phase_b_bf16(a, "),
    ("SKIP_MMA", "        for (int ks = 0; ks < 4; ++ks)\n",
     "        for (int ks = 0; ks < (SKIP_MMA ? 0 : 4); ++ks)\n"),
)
SPLIT_STEP_CELLS = (
    ("unit", 512, 128, ("unit",), ("", "SKIP_A", "SKIP_B", "SKIP_A SKIP_B")),
    ("slot", 8192, 64, ("slot", 4), ("", "SKIP_MMA")),
)


# the training kernels' parts for --split-step
TRAIN_SPLIT_TOGGLES = (
    ("SKIP_MMA", "              wgmma<N>(d, desc_k(", "              if (!SKIP_MMA) wgmma<N>(d, desc_k("),
    ("SKIP_MMA", "              wgmma<UB>(d, desc_k(", "              if (!SKIP_MMA) wgmma<UB>(d, desc_k("),
    ("SKIP_EPI", "        if (!active) continue;\n#pragma unroll\n        for (int hf = 0; hf < 2; ++hf) {\n"
                 "          const int row = rb + 8 * hf;\n          if (row >= row_end) continue;\n"
                 "          uint32_t mhv",
     "        if (!active || SKIP_EPI) continue;\n#pragma unroll\n        for (int hf = 0; hf < 2; ++hf) {\n"
     "          const int row = rb + 8 * hf;\n          if (row >= row_end) continue;\n"
     "          uint32_t mhv"),
    ("SKIP_BAR", "    if (t > 0 && tid == 0) tile_wait(", "    if (!SKIP_BAR && t > 0 && tid == 0) tile_wait("),
    ("SKIP_BAR", "      tile_wait(a.ctr + r, (unsigned)(NG * (T - t)));",
     "      if (!SKIP_BAR) tile_wait(a.ctr + r, (unsigned)(NG * (T - t)));"),
)
TRAIN_SPLIT_CELLS = ((1024, (32, 4)), (64, (8, 1)))
TRAIN_SPLIT_VARIANTS = ("", "SKIP_MMA", "SKIP_EPI", "SKIP_BAR")


def _toggled_libs(name, toggles, variants):
    """Build copies of ``csrc/<name>.cu`` into ``build/split_step``, one per
    variant (a space-separated set of toggle macros defined to 1), all
    started together; returns the loaded libraries by variant."""
    import ctypes

    from ggml_experiments_tpu_torch import _build

    src = open(os.path.join(_build.CSRC, f"{name}.cu")).read()
    for macro, old, new in toggles:
        if src.count(old) != 1:
            raise RuntimeError(f"--split-step: csrc/{name}.cu no longer has one {old!r}")
        src = src.replace(old, new)
        src = f"#ifndef {macro}\n#define {macro} 0\n#endif\n" + src
    out_dir = os.path.join(_build.build_dir(), "split_step")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")] + ["-I", _build.CSRC]
    jobs = {}
    for v in variants:
        lib = os.path.join(out_dir, f"lib_{name}_{v.replace(' ', '_') or 'base'}.so")
        cmd = [_build._nvcc(), *flags, *(f"-D{m}=1" for m in v.split()), "-o", lib, path]
        jobs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True), lib)
    libs = {}
    for v, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {v or 'base'} copy:\n{log}")
        libs[v] = ctypes.CDLL(lib)
        libs[v].gxt_error_string.restype = ctypes.c_char_p
        libs[v].gxt_error_string.argtypes = [ctypes.c_int]
    return libs


def split_step_cells():
    from ggml_experiments_tpu_torch import _build
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fd

    libs = _toggled_libs("gru_persistent", SPLIT_STEP_TOGGLES,
                         sorted({v for cell in SPLIT_STEP_CELLS for v in cell[4]}))
    w = fd._prep_weights(load_gru_params(CKPT, qtype="q8_0", device="cuda"))
    rows = []
    try:
        for kind, b, t, plan, names in SPLIT_STEP_CELLS:
            args = _gru_inputs(b, t)
            row = {"cell": f"split_step_{kind}", "b": b, "t": t, "plan": plan, "us_per_step": {}}
            for v in names:
                _build._LIBS["gru_persistent"] = libs[v]
                ms = call_ms(lambda: fd.gru_loop_cuda("fused_slot_tick", w, *args, t,
                                                      torch.bfloat16, config=plan), n=3, warmup=1)
                row["us_per_step"][v or "all on"] = ms * 1e3 / t
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        _build._LIBS.pop("gru_persistent", None)
    return rows


def train_split_cells():
    """The training forward and backward recurrence with one part off (the
    products, the forward's epilogue, the row-tile barrier), T=100, beside
    the unchanged source, in turns: what a part costs is the difference."""
    from ggml_experiments_tpu_torch import _build
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft

    libs = _toggled_libs("gru_train", TRAIN_SPLIT_TOGGLES, TRAIN_SPLIT_VARIANTS)
    rows = []
    try:
        for b, plan in TRAIN_SPLIT_CELLS:
            mxs, h0, wr, brec, dys = _train_operands(b, 100)
            ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=plan)
            row = {"cell": "split_step_train", "b": b, "t": 100, "plan": plan, "fwd": {},
                   "bwd_rec": {}}
            for v in TRAIN_SPLIT_VARIANTS + ("",):
                _build._LIBS["gru_train"] = libs[v]
                key = v or "all on"
                row["fwd"].setdefault(key, []).append(call_ms(
                    lambda: ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=plan), n=5, warmup=1))
                row["bwd_rec"].setdefault(key, []).append(call_ms(
                    lambda: ft.gru_train_bwd_rec_cuda(mxs, mhs, ys, dys, h0, wr, config=plan),
                    n=5, warmup=1))
            rows.append(row)
            print(json.dumps(row), flush=True)
            del mxs, h0, wr, brec, dys, ys, mhs
    finally:
        _build._LIBS.pop("gru_train", None)
    return rows


# MobileViT-small's transformer stages at B=128 (bp = 512 sequences): (L,
# Cin, C, H, F, layers); a stage's first layer carries the input projection
# (conv_1x1), its last the final LN and conv_projection (Cout = Cin, BN, SiLU)
LAYER_STAGES = ((256, 96, 144, 4, 288, 2), (64, 128, 192, 4, 384, 4), (16, 160, 240, 4, 480, 3))
LAYER_BP = 512


def _layer_ops(ftl, dev, c, h, f, cin, last, seed, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)

    def t(*s, bf=False, off=0.0):
        a = torch.randn(s, generator=g, device=dev) * 0.2 + off
        return a.to(dtype) if bf else a

    ops = ftl.LayerOperands(
        wq=t(c, c, bf=True), wk=t(c, c, bf=True), wv=t(c, c, bf=True), wo=t(c, c, bf=True),
        wi=t(c, f, bf=True), wo2=t(f, c, bf=True), ln1=(t(c, off=1.0), t(c)), bq=t(c),
        bk=t(c), bv=t(c), bo=t(c), ln2=(t(c, off=1.0), t(c)), bi=t(f), bo2=t(c),
        num_heads=h, eps=1e-5)
    if cin != c:
        ops.win = t(cin, c, bf=True)
    if last:
        ops.final_ln, ops.final_eps = (t(c, off=1.0), t(c)), 1e-5
        ops.wout, ops.out_affine, ops.out_act = t(c, cin, bf=True), (t(cin, off=1.0),
                                                                    t(cin)), True
    return ops


def layer_cells(sweep):
    """The fused transformer layer at each of the 9 launch shapes of a
    MobileViT-small forward at B=128: the layer (``call``, ``stream``,
    ``graph``), each of its kernels alone where the checkout splits it, and
    ``nn.TransformerEncoderLayer(C, H, F, SiLU, norm_first)`` in bf16 and
    eval mode as the library's yardstick: it has no input or output
    projection, so at a stage's first and last layer it does less work.
    ``--sweep`` times each ring depth of the two row-tile kernels."""
    import torch.nn.functional as F

    from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl

    dev = torch.device("cuda")
    split = hasattr(ftl, "ln_qkv_cuda")
    rows = []
    for l, cin, c, h, f, n in LAYER_STAGES:
        lib = torch.nn.TransformerEncoderLayer(c, h, f, dropout=0.0, activation=F.silu,
                                               norm_first=True, batch_first=True,
                                               device=dev, dtype=torch.bfloat16).eval()
        xc = torch.randn((LAYER_BP, l, c), generator=torch.Generator(device=dev).manual_seed(l),
                         device=dev).to(torch.bfloat16)
        with torch.no_grad():
            lib_t = both(lambda: lib(xc))
        for i in range(n):
            first, last = i == 0, i == n - 1
            width = cin if first else c
            ops = _layer_ops(ftl, dev, c, h, f, width, last, seed=100 * l + i)
            x = torch.randn((LAYER_BP, l, width), generator=torch.Generator(device=dev)
                            .manual_seed(i), device=dev).to(torch.bfloat16)
            cout = cin if last else c
            flops = LAYER_BP * (4 * l * l * c + 8 * l * c * c + 4 * l * c * f
                                + (2 * l * width * c if first else 0)
                                + (2 * l * c * cout if last else 0))
            nbytes = LAYER_BP * l * (width + cout) * 2 + 2 * (4 * c * c + 2 * c * f + (
                width * c if first else 0) + (c * cout if last else 0))
            row = {"L": l, "Cin": width, "C": c, "H": h, "F": f, "Cout": cout, "layer": i,
                   "input_proj": first, "final_ln_out_proj": last,
                   "bound_ms": max(flops / H100.peak_ops["bfloat16"],
                                   nbytes / H100.hbm_bytes_per_s) * 1e3,
                   "bound_by": "operations" if flops / H100.peak_ops["bfloat16"]
                   > nbytes / H100.hbm_bytes_per_s else "bytes",
                   "kernel": both(lambda: ftl.fused_layer_cuda(x, ops)),
                   "library": lib_t}
            if split:
                x2 = x.reshape(-1, width)
                qkv = ftl.ln_qkv_cuda(x2, ops, l)
                ctx = ftl.attention_cuda(qkv, l, ops)
                row["ln_qkv"] = both(lambda: ftl.ln_qkv_cuda(x2, ops, l))
                row["attention"] = both(lambda: ftl.attention_cuda(qkv, l, ops))
                row["proj_ffn"] = both(lambda: ftl.proj_ffn_cuda(x2, ctx, ops, l))
                row["stages"] = list(ops.cache[x.device].stages)
                if sweep:
                    row["sweep"] = {}
                    for s in range(2, 7):
                        for name, fn in (("ln_qkv", lambda: ftl.ln_qkv_cuda(x2, ops, l,
                                                                            _plan=(s, 0))),
                                         ("proj_ffn", lambda: ftl.proj_ffn_cuda(
                                             x2, ctx, ops, l, _plan=(0, s)))):
                            try:
                                row["sweep"][f"{name} stages={s}"] = stream_ms(fn)
                            except ValueError:
                                pass
            rows.append(row)
            print(json.dumps(row), flush=True)
        del lib
    # end to end: extract_features at B=128, 256 px, bf16 on the full checkpoint
    from ggml_experiments_tpu_torch.models.mobilevit import extract_features, load_mobilevit

    params = load_mobilevit(os.path.join("checkpoints", "mobilevit_synth_full.ggml"), device=dev)
    images = torch.rand((128, 256, 256, 3), generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    row = {"extract_features_b128_bf16": call_ms(
        lambda: extract_features(params, images, compute_dtype=torch.bfloat16), n=10)}
    rows.append(row)
    print(json.dumps(row), flush=True)
    return rows


def layer_f32_cells():
    """The f32 form of the layer (``csrc/transformer_layer_f32.cu``) at the
    same 9 launch shapes on seeded random f32 weights: the layer and each of
    its three kernels (``call``, ``stream``, ``graph``) beside the bound at
    3xTF32 (``utils/observability.transformer_layer_bound``),
    ``nn.TransformerEncoderLayer`` at f32 with TF32 off (no projections) and
    ``scaled_dot_product_attention`` f32 on the attention's q, k and v as
    the library columns (the route through the model is timed by
    ``tools/torch_gate_sweep.py --only layer_f32``). Skipped where the
    checkout has no f32 form."""
    import torch.nn.functional as F

    from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl

    if not hasattr(ftl, "fused_layer_f32_cuda"):
        return [{"skipped": "the checkout's layer runs bf16 only"}]
    dev, f32 = torch.device("cuda"), torch.float32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rows = []
    for l, cin, c, h, f, n in LAYER_STAGES:
        lib = torch.nn.TransformerEncoderLayer(c, h, f, dropout=0.0, activation=F.silu,
                                               norm_first=True, batch_first=True,
                                               device=dev, dtype=f32).eval()
        xc = torch.randn((LAYER_BP, l, c), generator=torch.Generator(device=dev).manual_seed(l),
                         device=dev)
        with torch.no_grad():
            lib_t = both(lambda: lib(xc))
        del lib, xc
        for i in range(n):
            first, last = i == 0, i == n - 1
            width = cin if first else c
            cout = cin if last else c
            ops = _layer_ops(ftl, dev, c, h, f, width, last, seed=100 * l + i, dtype=f32)
            x = torch.randn((LAYER_BP, l, width), generator=torch.Generator(device=dev)
                            .manual_seed(i), device=dev)
            x2 = x.reshape(-1, width)
            qkv = ftl.ln_qkv_cuda(x2, ops, l)
            ctx = ftl.attention_cuda(qkv, l, ops)
            dh, dhp = c // h, ftl.head_pad(c // h)
            heads = [qkv.reshape(LAYER_BP, l, 3, h, dhp)[:, :, j, :, :dh].transpose(1, 2)
                     .contiguous() for j in range(3)]
            bounds = _OBS.transformer_layer_bound(LAYER_BP, l, width, c, f, cout, "float32",
                                                  in_proj=first, out_proj=last)
            row = {"dtype": "float32", "L": l, "Cin": width, "C": c, "H": h, "F": f,
                   "Cout": cout, "layer": i, "input_proj": first, "final_ln_out_proj": last,
                   "bound_ms": {k: H100.bound_ms(*v, "tf32x3") for k, v in bounds.items()},
                   "kernel": both(lambda: ftl.fused_layer_cuda(x, ops)),
                   "ln_qkv": both(lambda: ftl.ln_qkv_cuda(x2, ops, l)),
                   "attention": both(lambda: ftl.attention_cuda(qkv, l, ops)),
                   "proj_ffn": both(lambda: ftl.proj_ffn_cuda(x2, ctx, ops, l)),
                   "library": lib_t,
                   "sdpa": both(lambda: F.scaled_dot_product_attention(*heads, scale=1.0))}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del x, x2, qkv, ctx, heads, ops
    return rows


# copies of csrc/transformer_layer.cu with one part off (--split-step with
# layer): the products, the global stores of q/k/v, ctx and the output (the
# compiler then also drops the arithmetic that feeds only them), the weight
# stream (the ring's phases complete with no copy); and one that issues the
# next weight tile's products before the last tile's are done and releases
# each tile one step late (LAYER_TILE_OVERLAP, wgmma.wait_group 1)
LAYER_SPLIT_TOGGLES = (
    ("LAYER_NO_MMA", "void wgmma_n48(float (&d)[24], uint64_t da, uint64_t db, int scale_d) {",
     "void wgmma_n48(float (&d)[24], uint64_t da, uint64_t db, int scale_d) {\n  if (LAYER_NO_MMA) return;"),
    ("LAYER_NO_MMA", "void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {",
     "void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {\n  if (LAYER_NO_MMA) return;"),
    ("LAYER_NO_MMA", "                                              int scale_d) {\n  asm volatile(",
     "                                              int scale_d) {\n  if (LAYER_NO_MMA) return;\n  asm volatile("),
    ("LAYER_NO_STORE", "    if (r < rows)\n      *reinterpret_cast<uint4*>(dst",
     "    if (r < rows && !LAYER_NO_STORE)\n      *reinterpret_cast<uint4*>(dst"),
    ("LAYER_NO_STORE", "      if (ok && tok < p.T)\n        *reinterpret_cast<uint32_t*>(p.ctx",
     "      if (ok && tok < p.T && !LAYER_NO_STORE)\n        *reinterpret_cast<uint32_t*>(p.ctx"),
    ("LAYER_TILE_OVERLAP", "    wg_commit();\n    wg_wait<0>();\n#pragma unroll\n    for (int ch = 0; ch < NCH; ++ch) wg_pin(acc[ch]);\n    ring_release(r, it, lane);\n  }\n}",
     "    wg_commit();\n    if (!LAYER_TILE_OVERLAP) {\n      wg_wait<0>();\n      for (int ch = 0; ch < NCH; ++ch) wg_pin(acc[ch]);\n      ring_release(r, it, lane);\n    } else if (kc > 0) {\n      asm volatile(\"wgmma.wait_group.sync.aligned 1;\\n\" ::: \"memory\");\n      ring_release(r, it - 1, lane);\n    }\n  }\n  if (!LAYER_TILE_OVERLAP) return;\n  wg_wait<0>();\n  for (int ch = 0; ch < NCH; ++ch) wg_pin(acc[ch]);\n  ring_release(r, it - 1, lane);\n}"),
    ("LAYER_NO_STREAM", "  mbar_expect(r.full + s, bytes);\n  bulk_load(r.buf + (size_t)s * r.sb, stream + (size_t)i * r.sb, bytes, r.full + s);",
     "  if (LAYER_NO_STREAM) {\n    mbar_arrive(r.full + s);\n    return;\n  }\n  mbar_expect(r.full + s, bytes);\n  bulk_load(r.buf + (size_t)s * r.sb, stream + (size_t)i * r.sb, bytes, r.full + s);"),
)
LAYER_SPLIT_VARIANTS = ("", "LAYER_NO_MMA", "LAYER_NO_STORE", "LAYER_NO_STREAM",
                        "LAYER_TILE_OVERLAP")


def layer_split_cells():
    """Each of the layer's kernels at a middle layer of each stage (B=128)
    with one part off, beside the unchanged source: what a part costs is the
    difference."""
    from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl

    libs = _toggled_libs("transformer_layer", LAYER_SPLIT_TOGGLES, LAYER_SPLIT_VARIANTS)
    dev = torch.device("cuda")
    rows = []
    saved = list(ftl._LIB)
    try:
        for l, cin, c, h, f, n in LAYER_STAGES:
            ops = _layer_ops(ftl, dev, c, h, f, c, False, seed=l)
            x2 = torch.randn((LAYER_BP * l, c), generator=torch.Generator(device=dev)
                             .manual_seed(l), device=dev).to(torch.bfloat16)
            qkv = ftl.ln_qkv_cuda(x2, ops, l)
            ctx = ftl.attention_cuda(qkv, l, ops)
            row = {"cell": "split_step_layer", "L": l, "C": c}
            for v in LAYER_SPLIT_VARIANTS:
                ftl._LIB[:] = [ftl.bind(libs[v])]
                key = v or "all on"
                row.setdefault("ln_qkv", {})[key] = stream_ms(lambda: ftl.ln_qkv_cuda(x2, ops, l))
                row.setdefault("attention", {})[key] = stream_ms(
                    lambda: ftl.attention_cuda(qkv, l, ops))
                row.setdefault("proj_ffn", {})[key] = stream_ms(
                    lambda: ftl.proj_ffn_cuda(x2, ctx, ops, l))
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        ftl._LIB[:] = saved
    return rows


# copies of csrc/transformer_layer_f32.cu's attention with one part off or
# changed (--split-step with attention_f32): q.k^T, or P.v, on one of its
# three products a k-step (its cost is then 2/3 of the difference); the
# transposing pass and k's lo off; the ctx stores off (the compiler then also
# drops the row sums); the exponent as expf(s - max); the two warpgroups in
# step (no offset of the second's first q.k^T); the key mask on every score
ATTN_F32_SPLIT_TOGGLES = (
    ("ATT_S_ONE", "        wgmma_tf32_rs<NK>(s, ah[f], desc_k32(kl), 1);\n"
                  "        wgmma_tf32_rs<NK>(s, ah[f], desc_k32(kh), 1);\n",
     "        if (!ATT_S_ONE) {\n          wgmma_tf32_rs<NK>(s, ah[f], desc_k32(kl), 1);\n"
     "          wgmma_tf32_rs<NK>(s, ah[f], desc_k32(kh), 1);\n        }\n"),
    ("ATT_PV_ONE", "    wgmma_tf32_rs<DN>(acc, ph[f], desc_k32(vl), 1);\n"
                   "    wgmma_tf32_rs<DN>(acc, ph[f], desc_k32(vh), 1);\n",
     "    if (!ATT_PV_ONE) {\n      wgmma_tf32_rs<DN>(acc, ph[f], desc_k32(vl), 1);\n"
     "      wgmma_tf32_rs<DN>(acc, ph[f], desc_k32(vh), 1);\n    }\n"),
    ("ATT_NO_PREP", "for (int i = warp; i < DN / 2; i += 4 * nwg) {",
     "for (int i = warp; i < (ATT_NO_PREP ? 0 : DN / 2); i += 4 * nwg) {"),
    ("ATT_NO_PREP", "for (int i = tid; i < KS * NK * 2; i += nthreads) {",
     "for (int i = tid; i < (ATT_NO_PREP ? 0 : KS * NK * 2); i += nthreads) {"),
    ("ATT_NO_STORE", "        if (r >= R) continue;\n        float* dst",
     "        if (r >= R || ATT_NO_STORE) continue;\n        float* dst"),
    ("ATT_EXPF", "s[4 * j + i] = exp_shift(s[4 * j + i], ml2[i >> 1]);",
     "s[4 * j + i] = ATT_EXPF ? expf(__fsub_rn(s[4 * j + i], m[i >> 1]))\n"
     "                                             : exp_shift(s[4 * j + i], ml2[i >> 1]);"),
    ("ATT_LOCKSTEP", "if (t == 1 && nwg == 2) asm", "if (t == 1 && nwg == 2 && !ATT_LOCKSTEP) asm"),
    ("ATT_LOCKSTEP", "if (t == 0 && nwg == 2) asm", "if (t == 0 && nwg == 2 && !ATT_LOCKSTEP) asm"),
    ("ATT_MASK_ALWAYS", "        if (lo > 0 || hi < NK) {",
     "        if (lo > 0 || hi < NK || ATT_MASK_ALWAYS) {"),
)
ATTN_F32_SPLIT_VARIANTS = ("", "ATT_S_ONE", "ATT_PV_ONE", "ATT_NO_PREP", "ATT_NO_STORE",
                           "ATT_EXPF", "ATT_LOCKSTEP", "ATT_MASK_ALWAYS")


def attention_f32_split_cells():
    """The f32 attention at each stage's shape (B=128, CUDA graphs) with one
    part off or changed, beside the unchanged source, in turns: what a part
    costs is the difference."""
    from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl

    libs = _toggled_libs("transformer_layer_f32", ATTN_F32_SPLIT_TOGGLES,
                         ATTN_F32_SPLIT_VARIANTS)
    dev = torch.device("cuda")
    rows = []
    saved = list(ftl._F32_LIB)
    try:
        for l, cin, c, h, f, n in LAYER_STAGES:
            ops = _layer_ops(ftl, dev, c, h, f, c, False, seed=l, dtype=torch.float32)
            x2 = torch.randn((LAYER_BP * l, c), generator=torch.Generator(device=dev)
                             .manual_seed(l), device=dev)
            qkv = ftl.ln_qkv_plain(x2, ops)
            row = {"cell": "split_step_attention_f32", "L": l, "C": c, "attention": {}}
            for v in ATTN_F32_SPLIT_VARIANTS + ("",):
                ftl._F32_LIB[:] = [ftl.bind_f32(libs[v])]
                row["attention"].setdefault(v or "all on", []).append(
                    graph_ms(lambda: ftl.attention_cuda(qkv, l, ops)))
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        ftl._F32_LIB[:] = saved
    return rows


# the inverted residual at B=128: MobileViT-small's layer_2 blocks 1-2 (the
# main path, with the residual) and a layer_1-like block (128 x 128, 16 ->
# 32, E=64, no residual; the model runs that one unfused, E < 128)
IR_CELLS = ((128, 64, 64, 64, 256, 64, True), (128, 128, 128, 16, 64, 32, False))


def ir_inputs(b, h, w, c, e, cout, seed=0, dtype=torch.bfloat16):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def t(*s, scale=0.2, off=0.0):
        return torch.randn(s, generator=g, device=dev) * scale + off

    args = (t(c, e), t(e), t(3, 3, e), t(e), t(e, cout), t(cout))
    return t(b, h, w, c, scale=1.0).to(dtype), args


def ir_error(got, want, want32):
    """max and mean |kernel - plain| and the mean over the plain version's
    own f32-vs-bf16 distance (chip_smoke.py holds it at 2^-6 of the largest
    output and 0.01 of that distance)."""
    d = (got.float() - want.float()).abs()
    gap = float((want32.float() - want.float()).abs().mean())
    return {"max_abs_err": float(d.max()), "scale": float(want.float().abs().max()),
            "mean_abs_err": float(d.mean()), "mean_over_gap": float(d.mean()) / gap}


def ir_cells(sweep):
    """The inverted residual at IR_CELLS: the kernel (``call``, ``stream``,
    ``graph``) on operands made once, its error against the plain version,
    the plain version's time, the cuDNN chain as the library's yardstick and
    the bound; ``--sweep`` times every plan the strip kernel takes."""
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir

    rows = []
    new = hasattr(fir, "ir_operands")
    for b, h, w, c, e, cout, resid in IR_CELLS:
        x, args = ir_inputs(b, h, w, c, e, cout)
        bf = torch.bfloat16
        pargs = (args[0].to(bf), *args[1:4], args[4].to(bf), args[5])
        if new:
            ops = fir.ir_operands(*args)
            fn = lambda: fir.fused_ir_cuda(x, ops, use_residual=resid)  # noqa: E731
        else:
            fn = lambda: fir.fused_ir_cuda(x, *args, use_residual=resid)  # noqa: E731
        got = fn()
        want = fir.fused_ir_plain(x, *pargs, use_residual=resid)
        want32 = fir.fused_ir_plain(x.float(), *args, use_residual=resid)
        _, by, bounds = inverted_residual_bound(b, h, w, c, e, cout)
        row = {"cell": "ir", "shape": [b, h, w, c, e, cout], "residual": resid,
               "plan": str(fir.ir_plan(b, h, w, c, e, cout)) if new else "8x8 tiles",
               "kernel": both(fn), "host_us": host_us(fn), **ir_error(got, want, want32),
               "plain_call": call_ms(lambda: fir.fused_ir_plain(x, *pargs, use_residual=resid),
                                     n=3, warmup=1),
               "cudnn_chain": both(cudnn_inverted_residual(x, args, resid)),
               "bound_ms": bounds[by], "bound_by": by, "bounds_ms": bounds}
        del want, want32, got
        if sweep and new:
            row["sweep"] = {}
            for plan in fir.ir_plans(c, e, cout):
                row["sweep"][f"s={plan.s} k={plan.k}"] = stream_ms(
                    lambda: fir.fused_ir_cuda(x, ops, use_residual=resid, _plan=plan))
        rows.append(row)
        print(json.dumps(row), flush=True)
    # end to end: extract_features at B=128, 256 px, on the full checkpoint at
    # f32, bf16, and bf16 with the inverted residual fused (layer_2's blocks)
    from ggml_experiments_tpu_torch.models.mobilevit import extract_features, load_mobilevit

    dev = torch.device("cuda")
    images = torch.rand((128, 256, 256, 3), generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    row = {"cell": "ir_extract_features_b128"}
    for name, fused, cd in (("f32", False, torch.float32), ("bf16", False, torch.bfloat16),
                            ("bf16+fused_ir", True, torch.bfloat16)):
        params = load_mobilevit(os.path.join("checkpoints", "mobilevit_synth_full.ggml"),
                                device=dev, fused_ir=fused)
        row[name] = call_ms(lambda: extract_features(params, images, compute_dtype=cd), n=10)
        del params
    rows.append(row)
    print(json.dumps(row), flush=True)
    return rows


# the bf16 stride-1 inverted residual past the strip kernel's widths: (B, H,
# W, C, E, Cout, residual)
IR_WIDE_CELLS = ((128, 64, 64, 64, 384, 64, True), (128, 32, 32, 96, 384, 96, True),
                 (128, 64, 64, 20, 80, 24, False), (128, 32, 32, 64, 384, 264, False))


def ir_wide_cells():
    """The inverted residual at IR_WIDE_CELLS through ``fused_ir_cuda`` on
    the checkout's operands for these widths (``ir_operands``): the kernel,
    its error, the plain version, the cuDNN chain and the bound."""
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir

    rows = []
    for b, h, w, c, e, cout, resid in IR_WIDE_CELLS:
        x, args = ir_inputs(b, h, w, c, e, cout, seed=c + e)
        bf = torch.bfloat16
        pargs = (args[0].to(bf), *args[1:4], args[4].to(bf), args[5])
        ops = fir.ir_operands(*args)
        fn = lambda: fir.fused_ir_cuda(x, ops, use_residual=resid)  # noqa: E731
        got, again = fn(), fn()
        want = fir.fused_ir_plain(x, *pargs, use_residual=resid)
        want32 = fir.fused_ir_plain(x.float(), *args, use_residual=resid)
        _, by, bounds = inverted_residual_bound(b, h, w, c, e, cout)
        row = {"cell": "ir_wide", "shape": [b, h, w, c, e, cout], "residual": resid,
               "route": type(ops).__name__,
               "plan": [getattr(ops, k, None) for k in ("tile", "ncp", "wsl")],
               "bit_equal": bool(torch.equal(got, again)), "kernel": both(fn),
               **ir_error(got, want, want32),
               "plain_call": call_ms(lambda: fir.fused_ir_plain(x, *pargs, use_residual=resid),
                                     n=3, warmup=1),
               "cudnn_chain": both(cudnn_inverted_residual(x, args, resid)),
               "bound_ms": bounds[by], "bound_by": by, "bounds_ms": bounds}
        del want, want32, got, again
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


# the bf16 layer past C = 288: (bp, L, C, H, F); each in two forms: "last"
# (every flag: Cin = C / 2 with the input projection, Cout = C / 2 + 8, the
# final LN and the output projection with SiLU) and "middle" (no flag: the
# form where the FFN's groups may be dealt to blocks)
LAYER_WIDE_CELLS = ((128, 16, 320, 5, 640), (16, 48, 384, 6, 768))


def _wide_layer_ops(ftl, dev, c, h, f, last, seed):
    bf = torch.bfloat16
    cin, cout = (c // 2, c // 2 + 8) if last else (c, c)
    g = torch.Generator(device=dev).manual_seed(seed)

    def t(*s, off=0.0):
        return torch.randn(s, generator=g, device=dev) * 0.2 + off

    ops = ftl.LayerOperands(
        wq=t(c, c).to(bf), wk=t(c, c).to(bf), wv=t(c, c).to(bf), wo=t(c, c).to(bf),
        wi=t(c, f).to(bf), wo2=t(f, c).to(bf), ln1=(t(c, off=1.0), t(c)), bq=t(c), bk=t(c),
        bv=t(c), bo=t(c), ln2=(t(c, off=1.0), t(c)), bi=t(f), bo2=t(c), num_heads=h, eps=1e-5,
        **(dict(final_ln=(t(c, off=1.0), t(c)), win=t(cin, c).to(bf), wout=t(c, cout).to(bf),
                out_affine=(t(cout, off=1.0), t(cout)), out_act=True) if last else {}))
    return ops, cin, cout, g


def layer_wide_cells():
    """The layer at LAYER_WIDE_CELLS in its last and middle forms: the layer
    (``fused_layer_cuda``), each of its kernels, the plain version, the
    library's yardstick and the bound. On a checkout with the wide row tiles
    (``row_tile_split``) also the layer with every wide kernel's groups on
    one block a row tile (qsplit = fsplit = 1) against the split the
    wrapper picks, in turns (picked, one, one, picked): the outputs must be
    bit-equal. A parent's checkout, whose row tiles stop at C = 288, times
    the layer alone (its per-sequence kernel)."""
    import torch.nn.functional as F

    from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl

    dev = torch.device("cuda")
    bf = torch.bfloat16
    wide = hasattr(ftl, "row_tile_split")
    rows = []
    for bp, l, c, h, f in LAYER_WIDE_CELLS:
        for last in (True, False):
            ops, cin, cout, g = _wide_layer_ops(ftl, dev, c, h, f, last, c + l)
            x = torch.randn((bp, l, cin), generator=g, device=dev).to(bf)
            fn = lambda: ftl.fused_layer_cuda(x, ops)  # noqa: E731
            got, again = fn(), fn()
            want = ftl.fused_transformer_layer_plain(x, ops)
            want32 = ftl.fused_transformer_layer_plain(x.float(), ops)
            lib = torch.nn.TransformerEncoderLayer(c, h, f, dropout=0.0, activation=F.silu,
                                                   norm_first=True, batch_first=True,
                                                   device=dev, dtype=bf).eval()
            nbytes, flops = transformer_layer_bound(bp, l, cin, c, f, cout, "bfloat16",
                                                    in_proj=last, out_proj=last)["layer"]
            with torch.no_grad():
                if last:
                    win_t, wout_t = ops.win.t().contiguous(), ops.wout.t().contiguous()
                    library = both(lambda: F.linear(lib(F.linear(x, win_t)), wout_t))
                else:
                    library = both(lambda: lib(x))
            row = {"cell": "layer_wide", "form": "last" if last else "middle",
                   "shape": [bp, l, cin, c, h, f, cout],
                   "bit_equal": bool(torch.equal(got, again)), "kernel": both(fn),
                   **ir_error(got, want, want32),
                   "plain_call": call_ms(lambda: ftl.fused_transformer_layer_plain(x, ops), n=3,
                                         warmup=1),
                   "library": library,
                   "bound_ms": max(nbytes / H100.hbm_bytes_per_s,
                                   flops / H100.peak_ops["bfloat16"]) * 1e3,
                   "bound_by": "bytes" if nbytes / H100.hbm_bytes_per_s
                   > flops / H100.peak_ops["bfloat16"] else "operations"}
            del want, want32, again, lib
            if wide:
                x2 = x.reshape(-1, cin)
                qkv = ftl.ln_qkv_cuda(x2, ops, l)
                ctx = ftl.attention_cuda(qkv, l, ops)
                row["ln_qkv"] = both(lambda: ftl.ln_qkv_cuda(x2, ops, l))
                row["attention"] = both(lambda: ftl.attention_cuda(qkv, l, ops))
                row["proj_ffn"] = both(lambda: ftl.proj_ffn_cuda(x2, ctx, ops, l))
                _, a = ftl._launch_args(ops, x2, l, cin)
                row["split"] = {"qsplit": a.qsplit, "fsplit": a.fsplit}
                picked = ftl.row_tile_split
                turns = []
                for one in (False, True, True, False):
                    ops.cache.clear()   # the launch arguments planned anew
                    ftl.row_tile_split = (lambda *_: 1) if one else picked
                    try:
                        out = fn()
                        turns.append({"one_block": one, "bit_equal": bool(torch.equal(out, got)),
                                      "graph": graph_ms(fn),
                                      "ln_qkv": graph_ms(lambda: ftl.ln_qkv_cuda(x2, ops, l)),
                                      "proj_ffn": graph_ms(
                                          lambda: ftl.proj_ffn_cuda(x2, ctx, ops, l))})
                    finally:
                        ftl.row_tile_split = picked
                ops.cache.clear()
                row["split_turns"] = turns
            del got
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def forward_cells():
    """``extract_features`` at B=128 on ``mobilevit_synth_full.ggml`` on the
    checkout's default routes, bf16 and f32, at 256 and at 512 px (layer_3
    at L = 1024; a checkout that refuses it records why)."""
    from ggml_experiments_tpu_torch.models.mobilevit import extract_features, load_mobilevit

    dev = torch.device("cuda")
    params = load_mobilevit(os.path.join("checkpoints", "mobilevit_synth_full.ggml"), device=dev)
    rows = []
    for size in (256, 512):
        images = torch.rand((128, size, size, 3),
                            generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        row = {"cell": f"forward_b128_{size}px"}
        for name, cd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            try:
                row[name] = call_ms(lambda: extract_features(params, images, compute_dtype=cd),
                                    n=10)
            except (ValueError, RuntimeError) as ex:
                row[name] = f"refused: {str(ex)[:160]}"
        rows.append(row)
        print(json.dumps(row), flush=True)
        del images
        torch.cuda.empty_cache()
    return rows


# copies of csrc/inverted_residual.cu (--split-step with ir): one part off
# (the expand's products and SiLU, the depthwise, the reduce, the TMA stores
# of the output, the SiLUs), the expand and the depthwise one after the other
# instead of interleaved, the reduce in 16- or 32-column items (four
# warpgroups or two at the main shape) instead of 64, or the arithmetic of the SiLUs and the
# depthwise's taps changed (silu_fast, whose range checks cost instructions;
# the plain version's correctly rounded SiLU; no multiply-add contracted),
# timed and held against the plain version beside the unchanged source
IR_SPLIT_TOGGLES = (
    ("IR_NO_EXPAND", "      expand<S>(p, xs, ring,", "      if (!IR_NO_EXPAND) expand<S>(p, xs, ring,"),
    ("IR_NO_DW", "      if (r > 0) depthwise<S>(", "      if (r > 0 && !IR_NO_DW) depthwise<S>("),
    ("IR_REDUCE_N16", "constexpr int kReduceN = 64;", "constexpr int kReduceN = IR_REDUCE_N16 ? 16 : IR_REDUCE_N32 ? 32 : 64;"),
    ("IR_REDUCE_N32", "// the SiLU of the expand and of the depthwise",   # (in IR_REDUCE_N16's)
     "// the SiLU of the expand and of the depthwise"),
    ("IR_NO_REDUCE", "        for (int item = wg; item < items; item += nwg) {",
     "        for (int item = wg; item < (IR_NO_REDUCE ? 0 : items); item += nwg) {"),
    ("IR_NO_STORE", "  for (int nc = 0; nc < p.g.nnc; ++nc)\n    tma_store4(",
     "  for (int nc = 0; nc < (IR_NO_STORE ? 0 : p.g.nnc); ++nc)\n    tma_store4("),
    ("IR_NO_ACT", "__device__ __forceinline__ float act(float z) {\n  float e, r;",
     "__device__ __forceinline__ float act(float z) {\n  if (IR_NO_ACT) return z;\n"
     "  if (IR_EXACT_SILU) return silu(z);\n  if (IR_SILU_FAST) return silu_fast(z);\n"
     "  float e, r;"),
    ("IR_SILU_FAST", "// z / (1 + 2^(-z log2 e)) on the MUFU's", "// z / (1 + 2^(-z log2 e)) on the MUFU's"),
    ("IR_EXACT_SILU", "// flushed: five instructions, where silu_fast",   # (in IR_NO_ACT's)
     "// flushed: five instructions, where silu_fast"),
    ("IR_NO_FMA", "float tap(float t, float v, float k) { return fmaf(v, k, t); }",
     "float tap(float t, float v, float k) { return IR_NO_FMA ? addf(t, mulf(v, k)) : fmaf(v, k, t); }"),
)
IR_SPLIT_VARIANTS = ("", "IR_NO_EXPAND", "IR_NO_DW", "IR_NO_REDUCE", "IR_REDUCE_N16",
                     "IR_REDUCE_N32", "IR_NO_STORE", "IR_NO_ACT", "IR_SILU_FAST", "IR_EXACT_SILU",
                     "IR_NO_FMA", "IR_EXACT_SILU IR_NO_FMA")
IR_ARITH_VARIANTS = ("", "IR_SILU_FAST", "IR_EXACT_SILU", "IR_NO_FMA", "IR_EXACT_SILU IR_NO_FMA")


def ir_split_cells():
    """The inverted residual at each IR_CELLS shape with one part off or the
    arithmetic changed, beside the unchanged source (run twice, first and
    last): what a part costs is the difference; the arithmetic variants'
    errors against the plain version say whether they hold chip_smoke.py's
    limits."""
    from ggml_experiments_tpu_torch import _build
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir

    libs = _toggled_libs("inverted_residual", IR_SPLIT_TOGGLES, IR_SPLIT_VARIANTS)
    rows = []
    try:
        for b, h, w, c, e, cout, resid in IR_CELLS:
            x, args = ir_inputs(b, h, w, c, e, cout)
            bf = torch.bfloat16
            pargs = (args[0].to(bf), *args[1:4], args[4].to(bf), args[5])
            want = fir.fused_ir_plain(x, *pargs, use_residual=resid)
            want32 = fir.fused_ir_plain(x.float(), *args, use_residual=resid)
            ops = fir.ir_operands(*args)
            row = {"cell": "split_step_ir", "shape": [b, h, w, c, e, cout],
                   "plan": str(fir.ir_plan(b, h, w, c, e, cout)), "stream_ms": {}, "error": {}}
            for v in IR_SPLIT_VARIANTS + ("",):
                _build._LIBS["inverted_residual"] = libs[v]
                key = v or "all on"
                fn = lambda: fir.fused_ir_cuda(x, ops, use_residual=resid)  # noqa: E731
                row["stream_ms"].setdefault(key, []).append(stream_ms(fn))
                if v in IR_ARITH_VARIANTS:
                    row["error"][key] = ir_error(fn(), want, want32)
            rows.append(row)
            print(json.dumps(row), flush=True)
            del want, want32
    finally:
        _build._LIBS.pop("inverted_residual", None)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--split-step", action="store_true",
                    help="time copies of the persistent (gru), training (train), layer "
                         "(layer) and inverted residual (ir) kernels with parts of the step "
                         "off")
    ap.add_argument("--only", default="qmatmul,flash,gru,train,train_f32,layer,ir",
                    help="comma-separated kernels to time (qmatmul, flash, gru, train, "
                         "train_f32, layer, ir, ir_wide, layer_wide; forward: "
                         "extract_features alone)")
    ap.add_argument("--vocab", default="66",
                    help="comma-separated vocabularies of the gru cells (66: the checkpoint's)")
    ap.add_argument("--units", default="1024",
                    help="comma-separated units of the gru cells (1024: the checkpoint's)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    vocabs = [int(x) for x in args.vocab.split(",")]
    units = [int(x) for x in args.units.split(",")]
    if not torch.cuda.is_available():
        print("torch_kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    import ggml_experiments_tpu_torch as port

    print(f"{smi} | package {os.path.dirname(port.__file__)}", flush=True)
    only = set(args.only.split(","))
    res = {"device": smi}
    cells = (("qmatmul", "qmatmul", lambda: qmatmul_cells(args.sweep)),
             ("flash", "flash", flash_cells),
             ("gru", "gru", lambda: gru_cells(args.sweep, vocabs, units)),
             ("train", "train", lambda: train_cells(args.sweep)),
             ("train_f32", "train_f32", lambda: train_f32_cells(args.sweep)),
             ("layer", "layer", lambda: layer_cells(args.sweep)),
             ("layer", "layer_f32", layer_f32_cells),
             ("gru", "split_step", split_step_cells),
             ("train", "split_step_train", train_split_cells),
             ("ir", "ir", lambda: ir_cells(args.sweep)),
             ("layer", "split_step_layer", layer_split_cells),
             ("ir", "split_step_ir", ir_split_cells),
             ("attention_f32", "split_step_attention_f32", attention_f32_split_cells),
             ("forward", "forward", forward_cells),
             ("ir_wide", "ir_wide", ir_wide_cells),
             ("layer_wide", "layer_wide", layer_wide_cells))
    for kernel, key, fn in cells:
        if kernel not in only or (key.startswith("split_step") and not args.split_step):
            continue
        res[key] = fn()
        if args.out:   # after every section, so that a later failure keeps the rest
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
