#!/usr/bin/env python3
"""Measure where the port's other routing gates should sit on one NVIDIA GPU:
the serving engine's fused tick, the fused inverted residual, and qmatmul's
hand-off to ``torch.matmul``. The decode gate has its own tool,
``tools/torch_recalibrate_decode.py``, whose rule (``pick_gate``) this one
reuses for the engine.

Run from the root of a checkout (the package measured is the working
directory's: ``cd parent && python3 /path/to/tools/torch_gate_sweep.py``
times another checkout's kernels with this file's cells):

    python3 tools/torch_gate_sweep.py [--only engine,ir,ir_f32,ir_s2,layer_f32,qmatmul]
        [--margin 1.15] [--out FILE]

Every time is the port's timing protocol (``utils/benchmarking.PROTOCOL``:
the wall clock of whole calls closed by a synchronize, the CUDA-event span
beside it).

* ``engine``: a ``DecodeEngine`` on the full-width q8_0 GRU (seed 0), bf16
  and f32, serving 2 x n_slots greedy requests (prompts of 1-16 tokens, 128 new
  tokens each) to the end, on the scan tick and on the fused tick, at every
  n_slots x inner of ENGINE_SLOTS x ENGINE_INNER; tokens/s is the requests'
  new tokens over the call. The gate is the smallest (n_slots, inner) at and
  above which the fused tick wins by the margin, up to the largest n_slots
  that keeps such a corner (``torch_recalibrate_decode.pick_gate``).
* ``ir``: the fused inverted residual (``csrc/inverted_residual.cu``) per
  call against the cuDNN chain (three ``F.conv2d`` in channels_last bf16,
  BN folded, two SiLUs, ``+ x``) at the two stride-1 block shapes of
  MobileViT-small, layer_1 (128 x 128, 16 -> 64 -> 32) and layer_2 (64 x 64,
  64 -> 256 -> 64, residual), at B = 8, 32, 128 (the VisionEngine's ladder);
  then ``extract_features`` on ``checkpoints/mobilevit_synth_full.ggml`` at
  the same B, bf16, with ``fused_ir`` off, and on with the E threshold at
  each of the stride-1 blocks' expanded widths (256: layer_2's blocks; 64:
  layer_1's too).
* ``ir_f32``: the f32 kernel (``csrc/inverted_residual_f32.cu``) per call
  against the cuDNN f32 chain (TF32 off, as the port's f32 convolutions
  run) at the same shapes and B; then ``extract_features`` at f32 on the
  model's route (its stride-1 blocks on the f32 kernel) and with the
  stride-1 blocks unfused (``fused_route`` patched for the measurement),
  in turns.
* ``ir_s2``: the stride-2 kernel (``csrc/inverted_residual_s2.cu``) per call
  against the cuDNN stride-2 chain (three ``F.conv2d``, the depthwise at
  stride 2, BN folded, two SiLUs; TF32 off at f32) at MobileViT-small's four
  downsampling blocks (IR_S2_BLOCKS) and B = 8, 32, 128, bf16 and f32, with
  the bound (``utils/observability.inverted_residual_bound``); then
  ``extract_features`` at the same B and dtypes with the stride-2 route off, on at all four downsamplers (the
  default), and on without layer_5's (E = 512) or layers 4-5's (E >= 384)
  (``fused_route`` patched for the measurement), in turns there and back,
  three times; the speedups from each route's best turn, the median of its
  turns beside them; then each route's CUDA-graph replay (the card's time
  alone, IR_S2_GRAPH_CALLS forwards a graph), in turns there and back. The
  per-call cells of ``ir_f32`` and ``ir_s2`` also give the kernel's and the
  chain's CUDA-graph times.
* ``layer_f32``: ``extract_features`` at f32 on
  ``checkpoints/mobilevit_synth_full.ggml`` at B = 8, 32, 128 with the f32
  fused layer's route (``csrc/transformer_layer_f32.cu``, the default on a
  CUDA device) on and off (the unfused chain with flash attention:
  ``fused_route`` patched for the measurement), in turns there and back,
  three times; the speedup from each route's best turn, the median of its
  turns beside it. Its result set the route.
* ``qmatmul``: the q8_0 kernel (forced past its gate) against
  ``torch.matmul`` on the dequantized plane, f32 and bf16, at MobileViT's
  transformer products for B = 128 (M = B x H x W tokens of each stage: q, k,
  v and the out-projection C x C, the FFN's C x 2C and 2C x C), all under
  the gate (K x N <= 2^20), which stays where the JAX package puts it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ENGINE_SLOTS = (16, 64, 128, 256, 512, 1024)
ENGINE_INNER = (16, 32, 64, 128)
ENGINE_NEW_TOKENS = 128
IR_BATCHES = (8, 32, 128)
# (H, W, C, E, Cout, residual) of MobileViT-small's stride-1 inverted residuals
IR_BLOCKS = {"layer_1": (128, 128, 16, 64, 32, False), "layer_2": (64, 64, 64, 256, 64, True)}
# (tokens of a B=128 forward, C) of the three transformer stages
QMM_STAGES = ((128 * 32 * 32, 144), (128 * 16 * 16, 192), (128 * 8 * 8, 240))
# (H, W, C, E, Cout) of MobileViT-small's stride-2 inverted residuals (the
# downsamplers: layer_2's first block, the downsampling block of layers 3-5)
IR_S2_BLOCKS = {"layer_2": (128, 128, 32, 128, 64), "layer_3": (64, 64, 64, 256, 96),
                "layer_4": (32, 32, 96, 384, 128), "layer_5": (16, 16, 128, 512, 160)}
# extract_features' turns through the stride-2 routes: at B = 8 a forward
# waits on the host, and one turn there and back spread 1.76x
IR_S2_ROUND_TRIPS = 3
IR_S2_GRAPH_CALLS = 3    # forwards in a CUDA graph (each keeps its activations)
LAYER_F32_ROUND_TRIPS = 3
VIT_CKPT = os.path.join("checkpoints", "mobilevit_synth_full.ggml")
# the expanded widths of the stride-1 blocks: the E thresholds that differ
IR_MIN_EXPAND_CANDIDATES = (256, 64)


def emit(rows, row):
    rows.append(row)
    print(json.dumps(row), flush=True)


def engine_cells(rows, margin, compute):
    import numpy as np
    import torch

    from torch_recalibrate_decode import make_params, pick_gate

    from ggml_experiments_tpu_torch.serving import DecodeEngine
    from ggml_experiments_tpu_torch.utils.benchmarking import timeit_stats

    params = make_params(torch.device("cuda"))
    evidence = {}
    for n_slots in ENGINE_SLOTS:
        rng = np.random.default_rng(n_slots)
        prompts = [rng.integers(0, 66, int(rng.integers(1, 17))) for _ in range(2 * n_slots)]
        new_tokens = len(prompts) * ENGINE_NEW_TOKENS
        for inner in ENGINE_INNER:
            cell = {}
            for tick in ("scan", "fused"):
                eng = DecodeEngine(params, n_slots=n_slots, max_prompt=16, inner_steps=inner,
                                   compute_dtype=compute, use_fused_tick=tick == "fused")

                def serve():
                    reqs = [eng.submit(p, ENGINE_NEW_TOKENS) for p in prompts]
                    eng.run_until_idle(timeout_s=600)
                    if not all(r._done.is_set() for r in reqs):
                        raise RuntimeError("the engine left requests unfinished")

                st = timeit_stats(serve)
                cell[tick] = {**st.asdict(), "tokens_per_s": round(new_tokens / st.headline, 1)}
            cell["fused_speedup"] = round(cell["scan"]["median_ms"] / cell["fused"]["median_ms"],
                                          4)
            evidence[f"S{n_slots}_I{inner}"] = cell
            emit(rows, {"cell": "engine", "compute": compute, "n_slots": n_slots,
                        "inner": inner, **cell})
    min_slots, min_inner, max_slots = pick_gate(evidence, ENGINE_SLOTS, ENGINE_INNER, margin,
                                                key="S{}_I{}")
    emit(rows, {"cell": "engine_gate", "compute": compute, "min_slots": min_slots,
                "min_inner": min_inner, "max_slots": max_slots, "margin": margin})


def ir_cells(rows):
    import torch

    from torch_kernel_bench import (
        cudnn_inverted_residual,
        graph_ms,
        inverted_residual_bound,
        ir_inputs,
    )

    from ggml_experiments_tpu_torch.models import mobilevit
    from ggml_experiments_tpu_torch.models.mobilevit import extract_features, load_mobilevit
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir
    from ggml_experiments_tpu_torch.utils.benchmarking import timeit_stats

    for name, (h, w, c, e, cout, resid) in IR_BLOCKS.items():
        for b in IR_BATCHES:
            x, args = ir_inputs(b, h, w, c, e, cout)
            ops = fir.ir_operands(*args)
            kernel = timeit_stats(lambda: fir.fused_ir_cuda(x, ops, use_residual=resid))
            chain = timeit_stats(cudnn_inverted_residual(x, args, resid))
            _, by, bounds = inverted_residual_bound(b, h, w, c, e, cout)
            emit(rows, {"cell": "ir", "block": name, "shape": [b, h, w, c, e, cout],
                        "residual": resid, "plan": str(fir.ir_plan(b, h, w, c, e, cout)),
                        "kernel": kernel.asdict(), "cudnn_chain": chain.asdict(),
                        "kernel_speedup": round(chain.headline / kernel.headline, 4),
                        "bound_ms": bounds[by], "bound_by": by})
            del x, ops
    dev = torch.device("cuda")
    off = load_mobilevit(VIT_CKPT, device=dev, fused_ir=False)
    on = load_mobilevit(VIT_CKPT, device=dev, fused_ir=True)
    # the route of each stride-1 block is read at each call, from the gate's
    # threshold: every candidate is one of the model's expanded widths
    routes = {"off": (off, None), **{f"on_e{e}": (on, e) for e in IR_MIN_EXPAND_CANDIDATES}}
    saved = mobilevit.IR_FUSED_MIN_EXPAND
    try:
        for b in IR_BATCHES:
            images = torch.rand((b, 256, 256, 3), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(b))
            cell = {}
            for name in [*routes, *reversed(routes)]:     # in turns, there and back
                params, min_e = routes[name]
                mobilevit.IR_FUSED_MIN_EXPAND = saved if min_e is None else min_e
                st = timeit_stats(lambda: extract_features(params, images,
                                                           compute_dtype=torch.bfloat16))
                cell.setdefault(name, []).append(st.asdict())
            best = {name: min(s["median_ms"] for s in runs) for name, runs in cell.items()}
            emit(rows, {"cell": "ir_extract_features", "batch": b, **cell,
                        "speedup_over_off": {k: round(best["off"] / v, 4)
                                             for k, v in best.items() if k != "off"}})
            del images
    finally:
        mobilevit.IR_FUSED_MIN_EXPAND = saved


def ir_f32_cells(rows):
    import torch

    from torch_kernel_bench import cudnn_inverted_residual, graph_ms, ir_inputs

    from ggml_experiments_tpu_torch.models import mobilevit
    from ggml_experiments_tpu_torch.models.mobilevit import extract_features, load_mobilevit
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir
    from ggml_experiments_tpu_torch.utils.benchmarking import timeit_stats

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for name, (h, w, c, e, cout, resid) in IR_BLOCKS.items():
        for b in IR_BATCHES:
            x, args = ir_inputs(b, h, w, c, e, cout, dtype=torch.float32)
            ops = fir.ir_f32_operands(*args)
            call = lambda: fir.fused_ir_f32_cuda(x, ops, use_residual=resid)  # noqa: E731
            kernel = timeit_stats(call)
            chain = timeit_stats(cudnn_inverted_residual(x, args, resid))
            emit(rows, {"cell": "ir_f32", "block": name, "shape": [b, h, w, c, e, cout],
                        "residual": resid, "kernel": kernel.asdict(),
                        "cudnn_chain": chain.asdict(),
                        "kernel_speedup": round(chain.headline / kernel.headline, 4),
                        "kernel_graph_ms": round(graph_ms(call), 4),
                        "cudnn_chain_graph_ms": round(graph_ms(
                            cudnn_inverted_residual(x, args, resid)), 4)})
            del x, ops
    dev = torch.device("cuda")
    params = load_mobilevit(VIT_CKPT, device=dev, fused_ir=True)
    cls = mobilevit.InvertedResidualParams
    route = cls.fused_route

    def stride_1_off(self, compute_dtype, device=None, hw=None):
        """The model's route with its stride-1 blocks unfused."""
        return self.conv_3x3.stride != 1 and route(self, compute_dtype, device, hw)

    try:
        for b in IR_BATCHES:
            images = torch.rand((b, 256, 256, 3), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(b))
            cell = {}
            for name in ("unfused", "f32_kernel", "f32_kernel", "unfused"):   # in turns
                cls.fused_route = route if name == "f32_kernel" else stride_1_off
                st = timeit_stats(lambda: extract_features(params, images))
                cell.setdefault(name, []).append(st.asdict())
            best = {name: min(s["median_ms"] for s in runs) for name, runs in cell.items()}
            emit(rows, {"cell": "ir_f32_extract_features", "batch": b, **cell,
                        "speedup_over_unfused": round(best["unfused"] / best["f32_kernel"], 4)})
            del images
    finally:
        cls.fused_route = route


def ir_s2_cells(rows):
    import torch

    from torch_kernel_bench import (
        cudnn_inverted_residual,
        graph_ms,
        inverted_residual_bound,
        ir_inputs,
    )

    from ggml_experiments_tpu_torch.models import mobilevit
    from ggml_experiments_tpu_torch.models.mobilevit import extract_features, load_mobilevit
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir
    from ggml_experiments_tpu_torch.utils.benchmarking import timeit_stats

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dtypes = (torch.bfloat16, torch.float32)
    for cd in dtypes:
        for name, (h, w, c, e, cout) in IR_S2_BLOCKS.items():
            for b in IR_BATCHES:
                x, args = ir_inputs(b, h, w, c, e, cout, dtype=cd)
                ops = fir.ir_s2_operands(*args, compute_dtype=cd)
                call = lambda: fir.fused_ir_s2_cuda(x, ops)  # noqa: E731
                kernel = timeit_stats(call)
                chain = timeit_stats(cudnn_inverted_residual(x, args, False, stride=2))
                _, by, bounds = inverted_residual_bound(b, h, w, c, e, cout, str(cd)[6:],
                                                        stride=2)
                emit(rows, {"cell": "ir_s2", "block": name, "compute": str(cd)[6:],
                            "shape": [b, h, w, c, e, cout], "kernel": kernel.asdict(),
                            "cudnn_chain": chain.asdict(),
                            "kernel_speedup": round(chain.headline / kernel.headline, 4),
                            "kernel_graph_ms": round(graph_ms(call), 4),
                            "cudnn_chain_graph_ms": round(graph_ms(cudnn_inverted_residual(
                                x, args, False, stride=2)), 4),
                            "bound_ms": bounds[by], "bound_by": by})
                del x, ops
    dev = torch.device("cuda")
    params = load_mobilevit(VIT_CKPT, device=dev)
    cls = mobilevit.InvertedResidualParams
    route = cls.fused_route

    def s2_up_to(max_e):
        """The model's route with its stride-2 blocks of E > max_e unfused."""
        def fused_route(self, compute_dtype, device=None, hw=None):
            if self.conv_3x3.stride == 2 and self.expand_1x1.kernel.shape[-1] > max_e:
                return False
            return route(self, compute_dtype, device, hw)
        return fused_route

    # the stride-2 route off, on at every downsampler (the default), and on
    # with the widest ones unfused: layer_5's (E = 512), layers 4-5's (>= 384)
    routes = {"off": s2_up_to(0), "on": route, "no_layer_5": s2_up_to(384),
              "no_layers_4_5": s2_up_to(256)}
    try:
        for cd in dtypes:
            for b in IR_BATCHES:
                images = torch.rand((b, 256, 256, 3), device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(b))
                cell = {}
                # in turns, there and back, IR_S2_ROUND_TRIPS times
                for name in [*routes, *reversed(routes)] * IR_S2_ROUND_TRIPS:
                    cls.fused_route = routes[name]
                    st = timeit_stats(lambda: extract_features(params, images, compute_dtype=cd))
                    cell.setdefault(name, []).append(st.asdict())
                best = {name: min(s["median_ms"] for s in runs) for name, runs in cell.items()}
                mid = {name: statistics.median(s["median_ms"] for s in runs)
                       for name, runs in cell.items()}
                # the card's time alone: a CUDA graph of IR_S2_GRAPH_CALLS forwards a
                # route, in turns there and back (where a host's jitter hid the
                # winner of the turns above)
                graph = {}
                for name in [*routes, *reversed(routes)]:
                    cls.fused_route = routes[name]
                    graph.setdefault(name, []).append(round(graph_ms(
                        lambda: extract_features(params, images, compute_dtype=cd),
                        n=IR_S2_GRAPH_CALLS), 4))
                torch.cuda.empty_cache()
                emit(rows, {"cell": "ir_s2_extract_features", "compute": str(cd)[6:],
                            "batch": b, **cell,
                            "speedup_over_off": {k: round(best["off"] / v, 4)
                                                 for k, v in best.items() if k != "off"},
                            "median_of_turns_ms": mid, "graph_ms": graph,
                            "graph_speedup_over_off": {
                                k: round(min(graph["off"]) / min(v), 4)
                                for k, v in graph.items() if k != "off"}})
                del images
    finally:
        cls.fused_route = route


def layer_f32_cells(rows):
    import torch

    from ggml_experiments_tpu_torch.models.mobilevit import extract_features, load_mobilevit
    from ggml_experiments_tpu_torch.utils.benchmarking import timeit_stats
    from ggml_experiments_tpu_torch.utils.observability import f32_layer_route_off

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    params = load_mobilevit(VIT_CKPT, device=dev)
    for b in IR_BATCHES:
        images = torch.rand((b, 256, 256, 3), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(b))
        cell = {}
        for _ in range(LAYER_F32_ROUND_TRIPS):
            for name in ("off", "on", "on", "off"):     # in turns, there and back
                with (f32_layer_route_off() if name == "off"
                      else contextlib.nullcontext()):
                    st = timeit_stats(lambda: extract_features(params, images))
                cell.setdefault(name, []).append(st.asdict())
        best = {k: min(s["median_ms"] for s in v) for k, v in cell.items()}
        med = {k: statistics.median(s["median_ms"] for s in v) for k, v in cell.items()}
        emit(rows, {"cell": "layer_f32_extract_features", "batch": b, **cell,
                    "speedup_best_turns": round(best["off"] / best["on"], 4),
                    "speedup_median_turns": round(med["off"] / med["on"], 4)})
        del images


def qmatmul_cells(rows):
    import torch

    from ggml_experiments_tpu_torch.quant.qmatmul import (
        XLA_FALLBACK_MAX_ELEMS,
        _dense,
        qmatmul_cuda,
    )
    from ggml_experiments_tpu_torch.quant.qtensor import quantize
    from ggml_experiments_tpu_torch.utils.benchmarking import timeit_stats

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, c in QMM_STAGES:
        for k, n in ((c, c), (c, 2 * c), (2 * c, c)):
            qt = quantize((torch.randn(k, n, generator=gen, device=dev) * 0.05).cpu().numpy(),
                          "q8_0", device=dev)
            x = torch.randn(m, k, generator=gen, device=dev)
            for cd in (torch.float32, torch.bfloat16):
                xc = x.to(cd)
                w = _dense(qt, cd)
                kernel = timeit_stats(lambda: qmatmul_cuda(xc, qt, cd))
                lib = timeit_stats(lambda: torch.matmul(xc, w))
                emit(rows, {"cell": "qmatmul_under_gate", "m": m, "k": k, "n": n,
                            "compute": str(cd).replace("torch.", ""),
                            "under_gate": k * n <= XLA_FALLBACK_MAX_ELEMS,
                            "kernel": kernel.asdict(), "torch_matmul": lib.asdict(),
                            "kernel_over_matmul": round(kernel.headline / lib.headline, 4)})
            del x, qt


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="engine,ir,qmatmul")
    ap.add_argument("--margin", type=float, default=1.15)
    ap.add_argument("--out", default=None, help="write every row here as JSON")
    args = ap.parse_args()

    import torch

    from torch_recalibrate_decode import smi_line

    # torch_recalibrate_decode puts its own checkout first on the path; the
    # package measured is the working directory's
    sys.path.insert(0, os.getcwd())
    if not torch.cuda.is_available():
        print("torch_gate_sweep: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    emit(rows, {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi_line()})
    only = set(args.only.split(","))
    if "qmatmul" in only:
        qmatmul_cells(rows)
    if "ir" in only:
        ir_cells(rows)
    if "ir_f32" in only:
        ir_f32_cells(rows)
    if "ir_s2" in only:
        ir_s2_cells(rows)
    if "layer_f32" in only:
        layer_f32_cells(rows)
    if "engine" in only:
        for compute in ("bfloat16", "float32"):
            engine_cells(rows, args.margin, compute)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
