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
        "import ggml_experiments_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'ggml_experiments_tpu.'))\n"
        "               or k == 'ggml_experiments_tpu' for k in sys.modules if sys.modules[k])\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 15


def test_no_source_mentions_jax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith((".py", ".cu", ".cuh"))]
    hits = []
    for path in files:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                # "ggml_experiments_tpu." never matches the port's own name
                if re.match(r"\s*(import|from) jax\b", line) or "ggml_experiments_tpu." in line:
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
        _build.load("qmatmul_q8_0")
    with pytest.raises(KeyError):
        _build.load("no_such_kernel")


def test_launch_counters_reset():
    from ggml_experiments_tpu_torch.quant.qmatmul import LAUNCHES

    port.reset_kernel_launches()
    LAUNCHES["qmatmul_q8_0"] += 3
    assert port.kernel_launches() == {"qmatmul_q8_0": 3, "fused_gru_decode": 0,
                                      "fused_slot_tick": 0}
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
