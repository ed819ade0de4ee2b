"""Port: import hygiene, the device rule, the kernel build's failure modes and the CLI."""

import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import ggml_experiments_tpu_torch as port
from ggml_experiments_tpu_torch import _build, cli
from ggml_experiments_tpu_torch.convert import params_from_numpy
from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
from ggml_experiments_tpu_torch.quant import quantize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ggml_experiments_tpu_torch")
SYNTH = os.path.join(REPO, "checkpoints", "gru_synth.bin")


def test_package_imports_with_jax_unimportable():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['optax'] = None\n"
        "import ggml_experiments_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "assert {p.__name__ + '.serving.http', p.__name__ + '.utils.benchmarking',\n"
        "        p.__name__ + '.parallel.mesh', p.__name__ + '.parallel.multihost',\n"
        "        p.__name__ + '.parallel.sharding'} <= set(names)\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k in ('jax', 'optax', 'ggml_experiments_tpu')\n"
        "               or k.startswith(('jax.', 'optax.', 'ggml_experiments_tpu.'))\n"
        "               for k in sys.modules if sys.modules[k])\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 52


# a rank's shard as the ops see it: anything with gather() (parallel.sharding.Placed)
SHARD_CALLS = (
    "import torch, types\n"
    "from ggml_experiments_tpu_torch.ops.fused_gru_train import fused_gru_scan\n"
    "from ggml_experiments_tpu_torch.ops.linear import linear\n"
    "wr = torch.randn(8, 24, requires_grad=True)\n"
    "shard = types.SimpleNamespace(gather=lambda: wr, local=wr)\n"
    "ys = fused_gru_scan(torch.randn(3, 2, 24), torch.zeros(2, 8), shard, torch.zeros(24))\n"
    "ys.float().sum().backward()\n"
    "assert wr.grad is not None\n"
    "linear(torch.randn(2, 8), wr, types.SimpleNamespace(gather=lambda: torch.zeros(24)))\n"
)


# the native runtime at the bottom; utils (observability, trace_report)
# under the kernels' ops; serving/aot under the loaders and the trainer
BELOW_ALL = ("ops", "quant", "parallel", "models", "serving", "formats", "utils", "training")


@pytest.mark.parametrize("layer,above,calls", [
    ("ops", ("parallel", "models", "serving"), ""),
    ("quant", ("parallel", "models", "serving"), ""),
    ("parallel", ("models", "serving"), ""),
    ("ops", ("parallel", "models", "serving"), SHARD_CALLS),
    ("runtime", BELOW_ALL, ""),
    ("utils", tuple(x for x in BELOW_ALL if x != "utils"), ""),
    ("serving", ("formats", "training"), ""),
], ids=["ops-above0", "quant-above1", "parallel-above2", "ops-on-shards", "runtime-above3",
        "utils-above4", "serving-above5"])
def test_a_layer_imports_nothing_above_it(layer, above, calls):
    """Importing every module of a layer loads no module of a layer above
    it (the kernels' ops under the placement rules under the models); the
    ops take a rank's shard (the fused train scan's recurrent kernel, a
    bias) through its ``gather()`` without importing ``parallel/``."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"import ggml_experiments_tpu_torch.{layer} as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        + calls +
        f"bad = sorted(k for k in sys.modules if k.split('.')[1:2] and k.split('.')[0] == "
        f"'ggml_experiments_tpu_torch' and k.split('.')[1] in {above!r})\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_mentions_jax_or_the_jax_package():
    """No source of the port imports jax, optax or the JAX package: the
    package, ``chip_smoke.py`` and the port's tools and examples
    (``tools/torch_*.py``, ``examples/torch_*.py``)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for sub in ("tools", "examples"):
        files += sorted(os.path.join(REPO, sub, n) for n in os.listdir(os.path.join(REPO, sub))
                        if n.startswith("torch_") and n.endswith(".py"))
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cpp"))]
    hits = []
    for path in files:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                # "ggml_experiments_tpu." never matches the port's own name
                if (re.match(r"\s*(import|from) (jax|optax)\b", line)
                        or "ggml_experiments_tpu." in line):
                    hits.append(f"{path}:{n}: {line.strip()}")
    assert len(files) > 15 and not hits, hits
    assert {os.path.basename(f) for f in files} >= {
        "torch_convert_hf_mobilevit.py", "torch_verify_reference_golden.py",
        "torch_train_mobilevit_cls.py", "torch_generate_text.py", "torch_serve_continuous.py",
        "torch_train_and_export.py", "torch_extract_features.py", "torch_multichip.py"}


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    """No device given and no GPU: raise, never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_gru_params(SYNTH)
    with pytest.raises(RuntimeError, match="CUDA"):
        quantize(np.ones((32, 32), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"embeddings": np.ones((2, 2)), "kernel": np.ones((2, 3)),
                           "recurrent_kernel": np.ones((1, 3)), "dense_kernel": np.ones((1, 2))})
    with pytest.raises(RuntimeError, match="CUDA"):
        load_gru_params(SYNTH, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["generate", "--weights", SYNTH, "--prompt", "a", "--steps", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["aot-export", "--weights", SYNTH, "--output", str(tmp_path / "d.gxa")])
    assert not os.path.exists(tmp_path / "d.gxa")


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("GXT_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False if p.endswith("nvcc") else os.path.lexists(p))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("qmatmul")
    with pytest.raises(KeyError):
        _build.load("no_such_kernel")


def test_launch_counters_reset():
    from ggml_experiments_tpu_torch.quant.qmatmul import LAUNCHES

    port.reset_kernel_launches()
    LAUNCHES["qmatmul_q8_0"] += 3
    LAUNCHES["qmatmul_q4_k"] += 1
    assert port.kernel_launches() == {
        "qmatmul_q8_0": 3, "qmatmul_q4_0": 0, "qmatmul_q4_1": 0, "qmatmul_q5_0": 0,
        "qmatmul_q5_1": 0, "qmatmul_q4_k": 1, "fused_gru_decode": 0, "fused_slot_tick": 0,
        "fused_gru_train_fwd": 0, "fused_gru_train_bwd": 0, "fused_gru_train_dwr": 0,
        "fused_gru_train_fwd_f32": 0, "fused_gru_train_bwd_f32": 0,
        "fused_gru_train_dwr_f32": 0, "flash_mha": 0, "flash_mha_streamed": 0,
        "fused_transformer_layer": 0, "transformer_ln_qkv": 0,
        "transformer_attention": 0, "transformer_proj_ffn": 0,
        "transformer_ln_qkv_f32": 0, "transformer_attention_f32": 0,
        "transformer_proj_ffn_f32": 0, "transformer_attention_streamed": 0,
        "transformer_attention_f32_streamed": 0, "transformer_ln_qkv_wide": 0,
        "transformer_proj_ffn_wide": 0, "fused_inverted_residual": 0,
        "inverted_residual_wide": 0, "inverted_residual_f32": 0,
        "inverted_residual_s2": 0, "inverted_residual_s2_f32": 0}
    port.reset_kernel_launches()
    assert set(port.kernel_launches().values()) == {0}


def test_cli_generate_and_serve_on_cpu(monkeypatch, capsys):
    assert cli.main(["generate", "--weights", SYNTH, "--prompt", "ROMEO:", "--prompt", "Be",
                     "--steps", "24", "--device", "cpu", "--qtype", "q8_0"]) == 0
    out = capsys.readouterr()
    lines = out.out.splitlines()
    assert lines[0].startswith("ROMEO:") and len(lines[0]) >= 6 and "tokens/s" in out.err
    monkeypatch.setattr(sys, "stdin", io.StringIO("ROMEO:\nBe\n\n"))
    assert cli.main(["serve", "--weights", SYNTH, "--device", "cpu", "--qtype", "q8_0",
                     "--slots", "2", "--inner-steps", "4", "--steps", "10"]) == 0
    out = capsys.readouterr()
    assert out.out.count("--------") == 2 and "2 requests" in out.err


Q4KM = os.path.join(REPO, "checkpoints", "gru_synth_q4km.gxt")
HELDOUT = os.path.join(REPO, "checkpoints", "corpus_heldout.txt")


def test_cli_generate_from_the_calibrated_checkpoint_on_cpu(capsys):
    assert cli.main(["generate", "--weights", Q4KM, "--prompt", "the king", "--steps", "20",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("the king") and len(out[0]) == 20


@pytest.mark.parametrize("qtype", ["q8_0", "q5_1", "q4_0"])
def test_cli_quantize_then_eval_on_cpu(qtype, tmp_path, capsys):
    """quantize writes a .gxt that generate and eval take; its JSON line and
    the file are the JAX command's."""
    import json

    from ggml_experiments_tpu import cli as jcli

    out = str(tmp_path / "q.gxt")
    assert cli.main(["quantize", "--input", SYNTH, "--output", out, "--qtype", qtype,
                     "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out)
    jout = str(tmp_path / "j.gxt")
    assert jcli.main(["quantize", "--input", SYNTH, "--output", jout, "--qtype", qtype]) == 0
    jline = json.loads(capsys.readouterr().out)
    assert line == {**jline, "output": out} and line["compression_vs_input"] > 3
    with open(out, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()
    assert cli.main(["eval", "--weights", out, "--qtype", qtype, "--corpus", HELDOUT,
                     "--batch", "2", "--length", "24", "--seed", "3", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    # an already quantized file has no fp32 twin: both sides are the same weights
    assert rep["qtype"] == qtype and rep["max_abs"] == 0.0 and rep["top1_agreement"] == 1.0


def test_cli_eval_matches_the_jax_command(capsys):
    import json

    from ggml_experiments_tpu import cli as jcli

    args = ["eval", "--weights", SYNTH, "--qtype", "q4_1", "--batch", "2", "--length", "16",
            "--seed", "1"]
    for corpus in ([], ["--corpus", HELDOUT]):
        assert cli.main(args + corpus + ["--device", "cpu"]) == 0
        got = json.loads(capsys.readouterr().out)
        assert jcli.main(args + corpus) == 0
        want = json.loads(capsys.readouterr().out)
        assert got.keys() == want.keys() and got["qtype"] == "q4_1"
        for k in ("mean_abs", "rel_rmse", "top1_agreement", "ppl_a", "ppl_b"):
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-5), k


VIT_TINY = os.path.join(REPO, "checkpoints", "mobilevit_synth.ggml")


def test_cli_names_what_is_not_ported():
    """Every command of the JAX CLI that the port has is whole: no source of
    the port raises NotImplementedError, and no command's help calls it not
    ported (``serve-vision`` was the last, until HTTP serving landed)."""
    for root, _, names in os.walk(PKG):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(root, n)) as f:
                    assert "NotImplementedError" not in f.read(), n
    sub = next(a for a in cli.build_parser()._actions if a.dest == "cmd")
    assert {"serve", "serve-vision", "bench"} <= set(sub.choices)
    for name, p in sub.choices.items():
        assert "not ported" not in p.format_help(), name


def test_cli_usage_errors_return_2(tmp_path, capsys):
    """The JAX commands' usage errors, rc 2 and no file: q4_k_m without
    calibration data (either input), eval of a quantized-only MobileViT
    .gxt. One more where the port differs on purpose: the JAX command runs
    GPTQ q4_k on a weight.ggml under any --calibrate and stamps the asked
    qtype on it (ADVICE.md, cli.py:250); the port refuses every qtype but
    q4_k_m there (ROADMAP.md, Queue C)."""
    import json

    from ggml_experiments_tpu import cli as jcli
    from ggml_experiments_tpu.formats import checkpoint as jckpt

    out = str(tmp_path / "x.gxt")
    for inp in (SYNTH, VIT_TINY):
        assert cli.main(["quantize", "--input", inp, "--output", out, "--qtype", "q4_k_m",
                         "--device", "cpu"]) == 2
        assert "needs --calibrate" in capsys.readouterr().err
    for qtype in ([], ["--qtype", "q5_1"], ["--qtype", "q4_k"]):
        assert cli.main(["quantize", "--input", VIT_TINY, "--output", out, "--calibrate",
                         "task", "--device", "cpu"] + qtype) == 2
        assert "pass --qtype q4_k_m" in capsys.readouterr().err
    assert not os.path.exists(out)
    # the JAX command's defect the port does not copy
    jout = str(tmp_path / "jax.gxt")
    assert jcli.main(["quantize", "--input", VIT_TINY, "--output", jout, "--calibrate", "task",
                      "--calibrate-seqs", "2", "--qtype", "q5_1", "--compile-cache", "off"]) == 0
    assert json.loads(capsys.readouterr().out)["qtype"] == "q5_1"
    assert jckpt.read_meta(jout)["qtype"] == "q5_1"
    assert jckpt.load_arrays(jout)["layer_3/transformer/0/attention/wq"].qtype == "q4_k"
    # eval of a quantized-only MobileViT .gxt has no f32 twin
    q4km = os.path.join(REPO, "checkpoints", "mobilevit_synth_full_q4km.gxt")
    assert cli.main(["eval", "--weights", q4km, "--device", "cpu"]) == 2
    assert "no fp32 twin" in capsys.readouterr().err
    assert jcli.main(["eval", "--weights", q4km, "--compile-cache", "off"]) == 2


def test_no_unported_error_names_a_finished_item():
    """No message names a finished item of an earlier layout: the formats,
    the .gxt container, HTTP serving (item 4), GRU training, MobileViT
    (item 6), calibration (Queue A #11), multi-device serving (Queue A #1),
    training on a mesh (Queue A #1b) or the stride-2 fused inverted residual
    (Queue C #1), and no docstring calls multi-process serving not ported."""
    hits = []
    for root, _, names in os.walk(PKG):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(root, n)) as f:
                    text = f.read()
                hits += re.findall(r"item [12456]\b|Queue A #1[12]\b|Queue A #1(?![0-9])"
                                   r"|Queue C #1(?![0-9])", text)
                hits += re.findall(r"[Nn]ot ported[\s\S]{0,40}multi-process serving", text)
    assert not hits
