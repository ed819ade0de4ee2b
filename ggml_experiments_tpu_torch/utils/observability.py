"""Observability: structured metrics, a profiler hook, roofline accounting.

JSONL metrics streams for the north-star numbers (tokens/s, images/s), a
``torch.profiler`` wrapper that writes a Chrome trace (read back by
:mod:`~ggml_experiments_tpu_torch.utils.trace_report`), and per-kernel
roofline accounting against the card's published peaks, so that a
"speed-of-light" share is a number with its bound beside it.

:data:`H100` is the one source of the NVIDIA H100 SXM's peaks that the
port's measurement scripts (``chip_smoke.py``, ``tools/torch_kernel_bench.py``)
read: NVIDIA's data sheet (dense rates, 700 W), and the MUFU's 16
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
