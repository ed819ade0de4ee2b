"""Observability: structured metrics, a profiler hook, roofline accounting.

JSONL metrics streams for the north-star numbers (tokens/s, images/s), a
``torch.profiler`` wrapper that writes a Chrome trace (read back by
:mod:`~ggml_experiments_tpu_torch.utils.trace_report`), and per-kernel
roofline accounting against the card's published peaks, so that a
"speed-of-light" share is a number with its bound beside it.

:data:`H100` is the one source of the NVIDIA H100 SXM's peaks that the
port's measurement scripts (``chip_smoke.py``, ``tools/torch_kernel_bench.py``)
read, with the bounds and library columns that they share
(:func:`inverted_residual_bound`, :func:`cudnn_inverted_residual`,
:func:`transformer_layer_bound`):
NVIDIA's data sheet (dense rates, 700 W), and the MUFU's 16
exponentials a clock per multiprocessor (CUDA C++ Programming Guide,
arithmetic instruction throughput, compute capability 9.0) at 132
multiprocessors and the 1.98 GHz boost clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, Optional, TextIO, Tuple


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak numbers for roofline accounting."""

    name: str
    bf16_tflops: float       # dense tensor-core bf16
    f32_tflops: float        # f32 FMA on the CUDA cores
    tf32x3_tflops: float     # f32 products as three tf32 tensor-core products
    hbm_gbps: float
    mufu_exp_per_s: float    # exp2 results a second on the MUFU units

    @property
    def hbm_bytes_per_s(self) -> float:
        return self.hbm_gbps * 1e9

    @property
    def peak_ops(self) -> Dict[str, float]:
        """Operations a second by the type they run in: ``float32`` (CUDA
        cores), ``bfloat16`` (tensor cores), ``tf32x3`` (f32 products as
        3xTF32 on the tensor cores)."""
        return {"float32": self.f32_tflops * 1e12, "bfloat16": self.bf16_tflops * 1e12,
                "tf32x3": self.tf32x3_tflops * 1e12}

    def bound_ms(self, nbytes: float, ops: float, kind: str) -> Tuple[float, str]:
        """Least time (ms) for the work and what bounds it: the bytes over
        the memory rate against the operations over the peak of ``kind``."""
        t_bytes = nbytes / self.hbm_bytes_per_s * 1e3
        t_ops = ops / self.peak_ops[kind] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


H100 = ChipSpec(name="h100_sxm", bf16_tflops=989.0, f32_tflops=67.0,
                tf32x3_tflops=495.0 / 3, hbm_gbps=3350.0,
                mufu_exp_per_s=16 * 132 * 1.98e9)


@dataclasses.dataclass
class RooflineReport:
    flops: float
    bytes: float
    seconds: float
    chip: ChipSpec

    @property
    def intensity(self) -> float:
        return self.flops / max(self.bytes, 1)

    @property
    def achieved_tflops(self) -> float:
        return self.flops / self.seconds / 1e12

    @property
    def achieved_gbps(self) -> float:
        return self.bytes / self.seconds / 1e9

    def bound(self, compute_peak_tflops: Optional[float] = None) -> str:
        peak = compute_peak_tflops or self.chip.bf16_tflops
        t_compute = self.flops / (peak * 1e12)
        t_memory = self.bytes / (self.chip.hbm_gbps * 1e9)
        return "compute" if t_compute >= t_memory else "memory"

    def speed_of_light_fraction(self, compute_peak_tflops: Optional[float] = None) -> float:
        """Achieved / max-achievable given the kernel's arithmetic intensity."""
        peak = compute_peak_tflops or self.chip.bf16_tflops
        t_ideal = max(
            self.flops / (peak * 1e12), self.bytes / (self.chip.hbm_gbps * 1e9)
        )
        return t_ideal / self.seconds

    def as_dict(self) -> Dict:
        return {
            "achieved_tflops": round(self.achieved_tflops, 2),
            "achieved_gbps": round(self.achieved_gbps, 1),
            "intensity_flops_per_byte": round(self.intensity, 2),
            "bound": self.bound(),
            "speed_of_light_fraction": round(self.speed_of_light_fraction(), 3),
        }


def qmatmul_roofline(
    m: int, k: int, n: int, seconds: float, *, qtype: str = "q8_0", chip: ChipSpec = H100
) -> RooflineReport:
    """Roofline for one fused dequant+matmul: weights move compressed."""
    from ggml_experiments_tpu_torch.quant.qtensor import QTYPE_BITS

    wbytes = k * n * QTYPE_BITS[qtype] / 8 + (k // 32) * n * 4
    if qtype in ("q4_1", "q5_1"):
        wbytes += (k // 32) * n * 4  # per-block min plane
    bytes_ = m * k * 4 + wbytes + m * n * 4
    return RooflineReport(flops=2.0 * m * k * n, bytes=bytes_, seconds=seconds, chip=chip)


def gru_decode_roofline(
    batch: int, embed: int, units: int, vocab: int, seconds_per_step: float,
    *, qtype: str = "q8_0", chip: ChipSpec = H100,
) -> RooflineReport:
    """Per-step roofline of projected decode (recurrent matmul + vocab head;
    the input projection is a table gather)."""
    from ggml_experiments_tpu_torch.quant.qtensor import QTYPE_BITS

    flops = 2.0 * batch * (units * 3 * units + units * vocab)
    wbytes = (units * 3 * units + units * vocab) * QTYPE_BITS[qtype] / 8
    bytes_ = wbytes + batch * units * 4 * 2
    return RooflineReport(flops=flops, bytes=bytes_, seconds=seconds_per_step, chip=chip)


def gru_training_roofline(
    batch: int, seq: int, embed: int, units: int, vocab: int, seconds_per_step: float,
    *, chip: ChipSpec = H100,
) -> RooflineReport:
    """Per-train-step roofline (fwd + ~2x bwd matmul FLOPs, Adam update).

    Bytes: f32 params read + grad/moment/param writes (5 passes over ~P
    params) plus the scan's activations: a coarse floor; the step is
    compute-bound at any realistic batch, so the FLOP term dominates.
    """
    p = embed * 3 * units + units * 3 * units + units * vocab + vocab * embed
    flops = 3 * 2.0 * batch * seq * (embed * 3 * units + units * 3 * units + units * vocab)
    bytes_ = 5 * p * 4 + batch * seq * units * 4 * 2
    return RooflineReport(flops=flops, bytes=bytes_, seconds=seconds_per_step, chip=chip)


def inverted_residual_bound(
    b: int, h: int, w: int, c: int, e: int, cout: int, dtype: str = "bfloat16",
    stride: int = 1, *, chip: ChipSpec = H100,
) -> Tuple[float, str, Dict[str, float]]:
    """Least time (ms) of one fused inverted residual on ``chip``, what
    bounds it, and each part, for a (b, h, w, c) input and a (b, h / stride,
    w / stride, cout) output: the bytes (x and the output once, the weights,
    at the dtype's width) at the HBM rate; the expand at h x w and the reduce
    at the output's pixels on the bf16 tensor rate (f32: three tf32 products
    each, ``tf32x3``); the depthwise's 18 operations an output element at
    the f32 CUDA-core rate; one MUFU exponential a SiLU (one an expanded
    element at the input's pixels and one at the output's)."""
    px, po = b * h * w, b * (h // stride) * (w // stride)
    elt, products = (2, "bfloat16") if dtype == "bfloat16" else (4, "tf32x3")
    parts = {"bytes": (px * c * elt + po * cout * elt + (c * e + e * cout) * elt
                       + (11 * e + cout) * 4) / chip.hbm_bytes_per_s,
             "tensor": 2 * (px * c * e + po * e * cout) / chip.peak_ops[products],
             "depthwise": po * 18 * e / chip.peak_ops["float32"],
             "mufu": (px + po) * e / chip.mufu_exp_per_s}
    parts = {k: v * 1e3 for k, v in parts.items()}
    by = max(parts, key=parts.get)
    return parts[by], by, parts


def attention_bound(
    bp: int, l: int, c: int, h: int, dtype: str = "bfloat16", *, passes: int = 1,
    chip: ChipSpec = H100,
) -> Tuple[float, str, Dict[str, float]]:
    """Least time (ms) of one attention launch over bp sequences of l
    tokens (c channels, h heads of dh = c / h) on ``chip``, what bounds it
    ("bytes" or "operations"), and each part: the bytes (q, k and v read
    once at the heads' width, ctx written once, at the dtype's width) at the
    HBM rate; the products, 2 bp h l^2 dh operations each for q.k^T and
    P.v, q.k^T ``passes`` times (2 where the keys are walked twice: the
    bf16 forms), on the tensor rate (f32: three tf32 products each,
    ``tf32x3``); bp h l^2 exponentials on the MUFU."""
    elt, products = (2, "bfloat16") if dtype == "bfloat16" else (4, "tf32x3")
    qk = 2 * bp * h * l * l * (c // h)
    parts = {"bytes": 4 * bp * l * c * elt / chip.hbm_bytes_per_s,
             "tensor": (passes + 1) * qk / chip.peak_ops[products],
             "mufu": bp * h * l * l / chip.mufu_exp_per_s}
    parts = {k: v * 1e3 for k, v in parts.items()}
    by = max(parts, key=parts.get)
    return parts[by], "bytes" if by == "bytes" else "operations", parts


def transformer_layer_bound(
    bp: int, l: int, cin: int, c: int, f: int, cout: int, dtype: str = "bfloat16",
    *, in_proj: bool = False, out_proj: bool = False,
) -> Dict[str, Tuple[float, float]]:
    """(bytes, operations) of one fused transformer layer on bp sequences of
    l tokens, whole and by kernel (``layer``, ``ln_qkv``, ``attention``,
    ``proj_ffn``), counted as the layer needs them: x (cin wide) read once
    and the output (cout wide) written once at the dtype's width, the
    weights once; q, k and v at the heads' width (the kernels' array pads
    each head with zero columns), x.Win once (in ln_qkv); the
    products 2 (K N) a token, the attention's 4 l^2 c a sequence. Use
    ``chip.bound_ms(nbytes, ops, kind)`` with ``kind`` ``bfloat16`` or, at
    f32, ``tf32x3`` (the products as three tf32 products each)."""
    elt = 2 if dtype == "bfloat16" else 4
    t = bp * l
    w = {"win": cin * c if in_proj else 0, "qkv": 3 * c * c, "wo": c * c, "ffn": 2 * c * f,
         "wout": c * cout if out_proj else 0}
    w = {k: v * elt for k, v in w.items()}
    qkv = t * 3 * c * elt
    ln_qkv = (t * cin * elt + qkv + w["win"] + w["qkv"],
              2 * t * (3 * c * c + (cin * c if in_proj else 0)))
    attention = (qkv + t * c * elt, 4 * t * l * c)
    proj_ffn = (t * (cin + c + cout) * elt + w["win"] + w["wo"] + w["ffn"] + w["wout"],
                2 * t * (c * c + 2 * c * f + (c * cout if out_proj else 0)))
    layer = (t * (cin + cout) * elt + sum(w.values()),
             bp * (4 * l * l * c + 8 * l * c * c + 4 * l * c * f + (2 * l * cin * c if in_proj
                                                                   else 0)
                   + (2 * l * c * cout if out_proj else 0)))
    return {"layer": layer, "ln_qkv": ln_qkv, "attention": attention, "proj_ffn": proj_ffn}


def cudnn_inverted_residual(x, args, residual: bool = True, stride: int = 1):
    """The inverted residual as cuDNN computes it, the library column beside
    the port's kernels (timed by the measurement scripts, never called by the
    port): three ``F.conv2d`` in channels_last at x's dtype (bf16, or f32
    with cuDNN's TF32 as the caller set it) with BN folded into the weights
    and biases (``args`` = the folded wexp, bexp, kdw, bdw, wred, bred),
    ``F.silu`` after the first two (the depthwise at ``stride``, padding 1),
    ``+ x`` with the residual: a chain of five or six calls, not one.
    Returns the chain as a function of no arguments."""
    import torch
    import torch.nn.functional as F

    wexp, bexp, kdw, bdw, wred, bred = args
    dt, cl = x.dtype, torch.channels_last
    w1 = wexp.t()[:, :, None, None].to(dt).contiguous(memory_format=cl)
    w2 = kdw.permute(2, 0, 1)[:, None].to(dt).contiguous(memory_format=cl)
    w3 = wred.t()[:, :, None, None].to(dt).contiguous(memory_format=cl)
    b1, b2, b3 = bexp.to(dt), bdw.to(dt), bred.to(dt)
    xc = x.permute(0, 3, 1, 2)      # NHWC storage seen as channels_last NCHW

    def chain():
        y = F.silu(F.conv2d(xc, w1, b1))
        y = F.silu(F.conv2d(y, w2, b2, stride=stride, padding=1, groups=w2.shape[0]))
        y = F.conv2d(y, w3, b3)
        return y + xc if residual else y

    return chain


@contextlib.contextmanager
def f32_layer_route_off():
    """MobileViT's f32 layers on the unfused chain with flash attention (the
    route before the f32 fused layer), bf16 unchanged, for a measurement by
    the scripts that time the route on against off (never used by the
    port)."""
    import torch

    from ggml_experiments_tpu_torch.device import resolve_dtype
    from ggml_experiments_tpu_torch.models import mobilevit

    cls = mobilevit.TransformerLayerParams
    route = cls.fused_route
    cls.fused_route = lambda self, cd, device=None, l=None, cin=None: (
        resolve_dtype(cd) != torch.float32 and route(self, cd, device, l, cin))
    try:
        yield
    finally:
        cls.fused_route = route


@contextlib.contextmanager
def f32_train_route_off():
    """The GRU's f32 time loop on the plain loop under autograd (the route
    before the f32 train kernels), bf16 unchanged, for a measurement by the
    scripts that hold the f32 route against it (never used by the port)."""
    import torch

    from ggml_experiments_tpu_torch.device import resolve_dtype
    from ggml_experiments_tpu_torch.ops import gru

    route = gru.fused_train_route
    gru.fused_train_route = lambda p, cd, device, fused=None: (
        resolve_dtype(cd) != torch.float32 and route(p, cd, device, fused))
    try:
        yield
    finally:
        gru.fused_train_route = route


class MetricsLogger:
    """Append-only JSONL metrics stream (stdout-safe: defaults to a file)."""

    def __init__(self, path_or_file="metrics.jsonl"):
        self._file: Optional[TextIO] = None
        if hasattr(path_or_file, "write"):
            self._file = path_or_file
        else:
            self._path = path_or_file
        self._t0 = time.time()

    def log(self, event: str, **fields) -> None:
        rec = {"t": round(time.time() - self._t0, 4), "event": event, **fields}
        line = json.dumps(rec)
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()
        else:
            with open(self._path, "a") as f:
                f.write(line + "\n")


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str] = None):
    """``torch.profiler`` over the block (CPU activity, and CUDA's where a
    card is present; CUPTI records every kernel launched in the process);
    on exit the Chrome trace is written to ``logdir/trace.json`` (``logdir``
    default: a new temporary directory). Yields ``logdir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or tempfile.mkdtemp(prefix="gxt_trace_")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
