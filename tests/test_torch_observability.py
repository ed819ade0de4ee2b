"""Port: utils/observability (rooflines against the H100's peaks, the metrics
stream, the profiler hook) and utils/trace_report (the Chrome trace parsed
into per-kernel rows named by the port's launch counters), with
tools/torch_trace_report.py on the CPU. The counterparts of the JAX
package's observability tests."""

import io
import json
import os
import subprocess
import sys

import pytest
import torch

import ggml_experiments_tpu_torch as port
from ggml_experiments_tpu_torch.utils.observability import (
    H100,
    MetricsLogger,
    cudnn_inverted_residual,
    gru_decode_roofline,
    gru_training_roofline,
    inverted_residual_bound,
    profiler_trace,
    qmatmul_roofline,
)
from ggml_experiments_tpu_torch.utils.trace_report import (
    format_report,
    kernel_name,
    parse_trace,
    trace_and_report,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_h100_peaks_are_the_data_sheets():
    assert H100.hbm_bytes_per_s == 3.35e12
    assert H100.peak_ops == {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
    assert H100.mufu_exp_per_s == 16 * 132 * 1.98e9
    assert H100.bound_ms(3.35e9, 1.0, "bfloat16") == (1.0, "bytes")
    assert H100.bound_ms(1.0, 989e9, "bfloat16") == (1.0, "operations")


def test_qmatmul_roofline_math():
    # memory-bound regime: decode-like m=1
    r = qmatmul_roofline(1, 1024, 3072, seconds=1e-5)
    assert r.chip is H100 and r.bound() == "memory"
    assert 0 < r.speed_of_light_fraction() < 1.5
    # compute-bound regime: big m
    assert qmatmul_roofline(8192, 1024, 3072, seconds=1e-3).bound() == "compute"
    # q4_1 / q5_1 move a min plane besides the scales
    assert qmatmul_roofline(1, 1024, 3072, 1.0, qtype="q5_1").bytes > \
        qmatmul_roofline(1, 1024, 3072, 1.0, qtype="q5_0").bytes


def test_gru_rooflines():
    r = gru_decode_roofline(1024, 256, 1024, 66, seconds_per_step=80e-6)
    assert r.chip is H100
    d = r.as_dict()
    assert d["bound"] in ("compute", "memory") and d["achieved_tflops"] > 0
    t = gru_training_roofline(1024, 100, 256, 1024, 66, seconds_per_step=0.02)
    assert t.bound() == "compute" and t.as_dict()["speed_of_light_fraction"] > 0


@pytest.mark.parametrize("dtype,stride,want_ms,want_by", [
    # layer_2's stride-1 blocks at B=128 (§6 row 8 of PERF.md)
    ("bfloat16", 1, 0.0642, "mufu"), ("float32", 1, 0.2082, "tensor"),
    # layer_2[0]'s and layer_5's downsamplers at B=128
    ("bfloat16", 2, 0.0802, "mufu"), ("float32", 2, 0.1562, "tensor")])
def test_inverted_residual_bound(dtype, stride, want_ms, want_by):
    shape = (128, 64, 64, 64, 256, 64) if stride == 1 else (128, 128, 128, 32, 128, 64)
    ms, by, parts = inverted_residual_bound(*shape, dtype, stride=stride)
    assert by == want_by and ms == parts[by] == max(parts.values())
    assert round(ms, 4) == want_ms
    # stride 2 quarters the output's pixels: the SiLUs fall from 2 to 1.25
    # an expanded element of the input
    b, h, w, c, e, cout = shape
    assert parts["mufu"] == pytest.approx(
        b * (h * w + (h // stride) * (w // stride)) * e / H100.mufu_exp_per_s * 1e3)
    small = inverted_residual_bound(128, 16, 16, 128, 512, 160, "bfloat16", stride=2)
    assert small[1] == "tensor" and round(small[0], 4) == 0.0057


@pytest.mark.parametrize("stride,residual", [(1, True), (1, False), (2, False)])
def test_cudnn_chain_is_the_plain_block(stride, residual):
    from ggml_experiments_tpu_torch.ops.fused_inverted_residual import fused_ir_plain

    g = torch.Generator().manual_seed(stride)
    c, e, cout = 8, 32, 8 if residual else 12
    args = (torch.randn(c, e, generator=g) * 0.2, torch.randn(e, generator=g) * 0.2,
            torch.randn(3, 3, e, generator=g) * 0.2, torch.randn(e, generator=g) * 0.2,
            torch.randn(e, cout, generator=g) * 0.2, torch.randn(cout, generator=g) * 0.2)
    x = torch.randn(2, 8, 10, c, generator=g)
    got = cudnn_inverted_residual(x, args, residual=residual, stride=stride)()
    want = fused_ir_plain(x, *args, stride=stride, use_residual=residual)
    # the chain's NCHW view of NHWC storage, at the input's dtype
    assert got.shape == (2, cout, 8 // stride, 10 // stride)
    torch.testing.assert_close(got.permute(0, 2, 3, 1), want, atol=1e-5, rtol=1e-5)


def test_metrics_logger_stream(tmp_path):
    buf = io.StringIO()
    m = MetricsLogger(buf)
    m.log("decode", tokens_per_s=123.0, batch=8)
    rec = json.loads(buf.getvalue())
    assert rec["event"] == "decode" and rec["tokens_per_s"] == 123.0 and "t" in rec
    path = tmp_path / "m.jsonl"
    f = MetricsLogger(str(path))
    f.log("a", x=1)
    f.log("b", x=2)
    assert [json.loads(line)["event"] for line in path.read_text().splitlines()] == ["a", "b"]


def test_kernel_names_are_the_launch_counters():
    """Every C++ symbol of the port's kernels maps onto a launch counter."""
    anon = "(anonymous namespace)::"
    symbols = {
        f"void {anon}qmatmul_kernel<{anon}DecQ8_0, false, float, 64>(float const*)": "qmatmul_q8_0",
        f"void {anon}qmatmul_kernel<{anon}DecNibble<false, false, -8>, true, float, 128>()":
            "qmatmul_q4_0",
        f"void {anon}qmatmul_kernel<{anon}DecNibble<true, false, 0>, true, bf16, 64>()":
            "qmatmul_q4_1",
        f"void {anon}qmatmul_kernel<{anon}DecNibble<false, true, -16>, false, float, 64>()":
            "qmatmul_q5_0",
        f"void {anon}qmatmul_kernel<{anon}DecNibble<true, true, 0>, false, float, 64>()":
            "qmatmul_q5_1",
        f"void {anon}qmatmul_kernel<{anon}DecQ4_K, false, float, 64>()": "qmatmul_q4_k",
        f"void {anon}slot_loop_kernel<4>({anon}Args)": "fused_gru_decode",
        f"void {anon}unit_loop_kernel<true>({anon}Args, {anon}Geom)": "fused_gru_decode",
        f"void {anon}setup_kernel({anon}Args)": "fused_gru_decode",
        f"void {anon}gru_train_fwd_kernel<32>({anon}FwdArgs)": "fused_gru_train_fwd",
        f"void {anon}gru_train_bwd_kernel<16>({anon}BwdArgs)": "fused_gru_train_bwd",
        f"void {anon}gru_train_dwr_kernel({anon}DwrArgs)": "fused_gru_train_dwr",
        f"void {anon}flash_mha_kernel<float, 48>({anon}Args)": "flash_mha",
        f"void {anon}layer_ln_qkv_kernel<3, 2, false>({anon}QkvParams)": "transformer_ln_qkv",
        f"void {anon}layer_attention_kernel<64>({anon}AttnParams)": "transformer_attention",
        f"void {anon}layer_proj_ffn_kernel<3, 2, false>({anon}FfnParams)": "transformer_proj_ffn",
        f"void {anon}layer_proj_ffn_kernel<5, 4, true>({anon}FfnParams)": "transformer_proj_ffn",
        f"void {anon}ir_strip_kernel<32>({anon}Params)": "fused_inverted_residual",
        f"void {anon}ir_wide_kernel<8, 16, 2>(gxt::irh::Params)": "inverted_residual_wide",
        f"void {anon}ir_f32_kernel<8, 16, 1>(gxt::irh::Params)": "inverted_residual_f32",
        f"void {anon}ir_f32_kernel<4, 8, 2>(gxt::irh::Params)": "inverted_residual_f32",
        f"void {anon}ir_s2_kernel<__nv_bfloat16, 8, 8, 2>(gxt::irh::Params)":
            "inverted_residual_s2",
        f"void {anon}ir_s2_kernel<float, 8, 8, 1>(gxt::irh::Params)":
            "inverted_residual_s2_f32",
        f"void {anon}ir_s2_kernel<float, 4, 8, 3>(gxt::irh::Params)":
            "inverted_residual_s2_f32",
    }
    for sym, name in symbols.items():
        assert kernel_name(sym) == name, sym
    assert set(symbols.values()) <= set(port.kernel_launches())
    lib = "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_32x6_nn_align4>(Params)"
    assert kernel_name(lib) == lib
    assert kernel_name("void at::native::elementwise_kernel<128, 4>()").startswith("void at::")


def _fixture_trace(path):
    """A Chrome trace as torch.profiler writes it: host operators, runtime
    calls and the device work they launched (two launches of the persistent
    loop, one qmatmul kernel, one library GEMM, a copy)."""
    anon = "(anonymous namespace)::"
    loop = f"void {anon}slot_loop_kernel<4>({anon}Args)"
    qmm = f"void {anon}qmatmul_kernel<{anon}DecQ8_0, false, float, 64>(float const*)"
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 0,
           "dur": 900}]
    for i, (cat, name, ts, dur) in enumerate([
            ("kernel", loop, 10, 300), ("kernel", loop, 400, 500), ("kernel", qmm, 950, 40),
            ("kernel", "ampere_sgemm_64x64_nn", 1000, 60),
            ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1100, 20)]):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
                   "tid": 1, "ts": ts - 5, "dur": 4, "args": {"correlation": 100 + i}})
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts,
                   "dur": dur, "args": {"correlation": 100 + i}})
    ev.append({"ph": "i", "cat": "instant", "name": "marker", "pid": 0, "tid": 7, "ts": 3})
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_trace_report_parses_device_events(tmp_path):
    _fixture_trace(tmp_path / "trace.json")
    rows = parse_trace(str(tmp_path), reps=2)
    assert [r.name for r in rows] == ["fused_gru_decode", "ampere_sgemm_64x64_nn",
                                      "qmatmul_q8_0", "Memcpy HtoD (Pageable -> Device)"]
    top = rows[0]
    assert top.count == 2 and top.total_us == 800 and top.per_call_us == 400
    assert rows[2].count == 1 and rows[3].total_us == 20
    text = format_report(rows, top=2)
    assert "fused_gru_decode" in text and "(+2 more ops)" in text
    with pytest.raises(FileNotFoundError):
        parse_trace(str(tmp_path / "empty"))


def test_trace_and_report_on_the_cpu(tmp_path):
    """No device stream on the CPU: the rows are the operators."""
    a = torch.randn(64, 64)
    rows = trace_and_report(lambda x: torch.tanh(x @ x).sum(), a, reps=3,
                            logdir=str(tmp_path))
    assert os.path.exists(tmp_path / "trace.json")
    names = {r.name for r in rows}
    assert "aten::tanh" in names and "aten::mm" in names
    assert next(r for r in rows if r.name == "aten::tanh").count == 3
    with profiler_trace() as d:
        torch.ones(3).sum()
    assert os.path.exists(os.path.join(d, "trace.json"))


def test_trace_report_tool_on_the_cpu():
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "torch_trace_report.py"),
                          "--model", "gru", "--batch", "2", "--steps", "3", "--reps", "1",
                          "--top", "5", "--device", "cpu"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].split() == ["us/call", "%", "count", "op"] and len(lines) >= 3
