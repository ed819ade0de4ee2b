"""Per-kernel device-time reports from ``torch.profiler`` Chrome traces.

Where the time goes below a whole call: :func:`parse_trace` reads the trace
that :func:`~ggml_experiments_tpu_torch.utils.observability.profiler_trace`
writes and sums the device stream's events (kernels, copies, fills) by name
into a top-op table, e.g.::

    with profiler_trace(logdir) as d:
        for _ in range(reps):
            out = fn(*args)
        torch.cuda.synchronize()
    rows = parse_trace(d, reps=reps)

CUPTI records the port's hand-written kernels under their C++ symbols
(``void (anonymous namespace)::slot_loop_kernel<4>(...)``): :func:`kernel_name`
maps each to the key of its launch counter (``fused_gru_decode``,
``qmatmul_q8_0``, ...), the names ``PERF.md``'s kernel table uses; other
kernels (cuDNN, cuBLAS, PyTorch's own) keep their symbols. A trace with no
device events (a CPU run) is summed over its operator events instead, so
the report still says which operators took the time.

Used by ``tools/torch_trace_report.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
import re
from typing import Dict, List, Optional

# C++ symbol patterns of the port's kernels -> their launch counters' names
# (the qmatmul decoders by the template arguments their aliases expand to)
KERNEL_PATTERNS = (
    (r"qmatmul_kernel<[^>]*DecQ8_0", "qmatmul_q8_0"),
    (r"qmatmul_kernel<[^>]*DecNibble<false, false, -8>", "qmatmul_q4_0"),
    (r"qmatmul_kernel<[^>]*DecNibble<true, false, 0>", "qmatmul_q4_1"),
    (r"qmatmul_kernel<[^>]*DecNibble<false, true, -16>", "qmatmul_q5_0"),
    (r"qmatmul_kernel<[^>]*DecNibble<true, true, 0>", "qmatmul_q5_1"),
    (r"qmatmul_kernel<[^>]*DecQ4_K", "qmatmul_q4_k"),
    # the persistent decode's setup and loop kernels (the serving tick runs
    # the same kernels)
    (r"\b(setup_kernel|slot_loop_kernel|unit_loop_kernel)\b", "fused_gru_decode"),
    (r"\bgru_train_fwd_kernel\b", "fused_gru_train_fwd"),
    (r"\bgru_train_bwd_kernel\b", "fused_gru_train_bwd"),
    (r"\bgru_train_dwr_kernel\b", "fused_gru_train_dwr"),
    (r"\bgru_train_fwd_f32_kernel\b", "fused_gru_train_fwd_f32"),
    (r"\bgru_train_bwd_f32_kernel\b", "fused_gru_train_bwd_f32"),
    (r"\bgru_train_dwr_f32_kernel\b", "fused_gru_train_dwr_f32"),
    (r"\bgru_train_dwr_f32_reduce\b", "fused_gru_train_dwr_f32"),
    (r"\bflash_mha_kernel\b", "flash_mha"),
    (r"\blayer_ln_qkv_kernel\b", "transformer_ln_qkv"),
    (r"\blayer_attention_(stream_)?kernel\b", "transformer_attention"),
    (r"\blayer_proj_ffn_kernel\b", "transformer_proj_ffn"),
    (r"\blayer_ln_qkv_f32_kernel\b", "transformer_ln_qkv_f32"),
    (r"\blayer_attention_f32_(stream_)?kernel\b", "transformer_attention_f32"),
    (r"\blayer_proj_ffn_f32_kernel\b", "transformer_proj_ffn_f32"),
    (r"\bir_strip_kernel\b", "fused_inverted_residual"),
    # the tile kernels of csrc/ir_hopper.cuh, whatever their template
    # arguments (<T,> rows, columns, m64 tiles of Cout)
    (r"\bir_wide_kernel\b", "inverted_residual_wide"),
    (r"\bir_f32_kernel\b", "inverted_residual_f32"),
    (r"\bir_s2_kernel<float\b", "inverted_residual_s2_f32"),
    (r"\bir_s2_kernel<", "inverted_residual_s2"),
)
_COMPILED = tuple((re.compile(p), name) for p, name in KERNEL_PATTERNS)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass(frozen=True)
class OpTime:
    name: str
    total_us: float     # summed over all occurrences in the trace
    count: int
    per_call_us: float  # total / reps (one "call" = one traced iteration)


def kernel_name(symbol: str) -> str:
    """The port's name for a kernel symbol, or the symbol itself."""
    for pat, name in _COMPILED:
        if pat.search(symbol):
            return name
    return symbol


def _newest_trace_file(logdir: str) -> str:
    pats = sorted(glob.glob(os.path.join(logdir, "*.json")) +
                  glob.glob(os.path.join(logdir, "*.json.gz")), key=os.path.getmtime)
    if not pats:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {logdir!r}: was "
                                "observability.profiler_trace used?")
    return pats[-1]


def parse_trace(logdir: str, *, reps: int = 1) -> List[OpTime]:
    """Aggregate the device-stream complete events of the newest trace in
    ``logdir`` by kernel name (:func:`kernel_name`); with no device event,
    the operator events. ``reps`` divides the totals into per-iteration
    numbers. Trace in a process that has not run the profiler before:
    with PyTorch 2.11 (CUDA 12.8) on an H100, a profile taken after earlier
    ones in the same process read some kernels' events twice or not at
    all."""
    path = _newest_trace_file(logdir)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    picked = [e for e in spans if e.get("cat") in DEVICE_CATS]
    if not picked:
        picked = [e for e in spans if e.get("cat") == "cpu_op"]
    total: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for e in picked:
        name = kernel_name(e.get("name", ""))
        total[name] = total.get(name, 0.0) + float(e.get("dur", 0))
        count[name] = count.get(name, 0) + 1
    rows = [OpTime(name=n, total_us=t, count=count[n], per_call_us=t / max(reps, 1))
            for n, t in total.items()]
    rows.sort(key=lambda r: -r.total_us)
    return rows


def format_report(rows: List[OpTime], *, top: int = 25, min_us: float = 0.0) -> str:
    """Render a fixed-width top-op table (dominant entry first)."""
    shown = [r for r in rows[:top] if r.per_call_us >= min_us]
    grand = sum(r.total_us for r in rows)
    lines = [f"{'us/call':>10}  {'%':>5}  {'count':>5}  op"]
    for r in shown:
        pct = 100.0 * r.total_us / grand if grand else 0.0
        lines.append(f"{r.per_call_us:10.1f}  {pct:5.1f}  {r.count:5d}  {r.name[:90]}")
    rest = rows[top:]
    if rest:
        rest_us = sum(r.total_us for r in rest)
        rest_per_call = sum(r.per_call_us for r in rest)
        lines.append(f"{rest_per_call:10.1f}  "
                     f"{100.0 * rest_us / grand if grand else 0.0:5.1f}  "
                     f"{sum(r.count for r in rest):5d}  (+{len(rest)} more ops)")
    return "\n".join(lines)


def trace_and_report(fn, *args, reps: int = 4, logdir: Optional[str] = None,
                     **kw) -> List[OpTime]:
    """Warm ``fn`` up (kernel builds outside the trace), trace ``reps``
    calls, and return the aggregated per-kernel rows."""
    import torch

    from ggml_experiments_tpu_torch.utils.observability import profiler_trace

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    fn(*args, **kw)
    sync()
    with profiler_trace(logdir) as d:
        for _ in range(reps):
            fn(*args, **kw)
        sync()
    return parse_trace(d, reps=reps)
