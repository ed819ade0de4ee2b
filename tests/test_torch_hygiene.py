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
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k in ('jax', 'optax', 'ggml_experiments_tpu')\n"
        "               or k.startswith(('jax.', 'optax.', 'ggml_experiments_tpu.'))\n"
        "               for k in sys.modules if sys.modules[k])\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 29


def test_no_source_mentions_jax_or_the_jax_package():
    """No source of the port imports jax, optax or the JAX package."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith((".py", ".cu", ".cuh"))]
    hits = []
    for path in files:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                # "ggml_experiments_tpu." never matches the port's own name
                if (re.match(r"\s*(import|from) (jax|optax)\b", line)
                        or "ggml_experiments_tpu." in line):
                    hits.append(f"{path}:{n}: {line.strip()}")
    assert len(files) > 15 and not hits, hits


def test_entry_points_raise_without_a_gpu(monkeypatch):
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
        "fused_gru_train_fwd": 0, "fused_gru_train_bwd": 0}
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


def test_cli_names_what_is_not_ported(tmp_path):
    out = str(tmp_path / "x.gxt")
    with pytest.raises(NotImplementedError, match="Queue A #11"):
        cli.main(["quantize", "--input", SYNTH, "--output", out, "--qtype", "q4_k_m",
                  "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Queue A #11"):
        cli.main(["quantize", "--input", SYNTH, "--output", out, "--calibrate", HELDOUT,
                  "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 6"):
        cli.main(["quantize", "--input", "weight.ggml", "--output", out, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 6"):
        cli.main(["eval", "--weights", "weight.ggml", "--device", "cpu"])
    assert not os.path.exists(out)


def test_no_unported_error_names_a_finished_item():
    """The NotImplementedErrors left name MobileViT, multi-process serving or
    calibration, never the formats, the .gxt container or GRU training."""
    hits = []
    for root, _, names in os.walk(PKG):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(root, n)) as f:
                    text = f.read()
                hits += re.findall(r"item ([125])\b", text)
    assert not hits
