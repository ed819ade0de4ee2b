"""Port: the five examples and the classifier trainer against the JAX
package's, on the CPU.

Each ``examples/torch_*.py`` runs beside its JAX original on the same tiny
model: a GRU (E = U = 32, ``init_params(PRNGKey(0))``) written to a
``gru.bin`` in ``tmp_path``, or the committed tiny MobileViT files. Their
printed output is compared verbatim where the run is f32 or token-exact; a
bf16 greedy text may fork from the JAX one only where the plain decode's
top-2 logit gap is below 0.1 (the near-tie rule of ``chip_smoke.py``), and
bf16 features follow ``tests/test_torch_mobilevit.py``'s route rule.
``torch_train_and_export`` and ``torch_multichip`` get the JAX init carried
across (``convert.params_from_numpy``); the multichip copy also runs as two
gloo processes. ``tools/torch_train_mobilevit_cls.py``'s report is held to
JAX's ``classify`` per qtype on 120 held-out images.
"""

import functools
import importlib.util
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params  # noqa: E402
from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused  # noqa: E402
from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer  # noqa: E402
from tools import torch_train_mobilevit_cls as cls_tool  # noqa: E402

TINY_VIT = os.path.join(REPO, "tests", "goldens", "mobilevit_tiny.ggml")
BF16_NEAR_TIE = 0.1     # chip_smoke's NEAR_TIE["bfloat16"]
TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _example(name):
    """An example file loaded as a module of its own (JAX ``name``, or the
    port's ``torch_name``)."""
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_gru_arrays(key=0, embed=32, units=32):
    import jax

    from ggml_experiments_tpu.models import gru_textgen as jg

    p = jg.init_params(jg.GRUConfig(embed_dim=embed, units=units), jax.random.PRNGKey(key))
    return p, {"embeddings": np.asarray(p.embeddings), "kernel": np.asarray(p.cell.kernel),
               "recurrent_kernel": np.asarray(p.cell.recurrent_kernel),
               "bias": np.asarray(p.cell.bias), "dense_kernel": np.asarray(p.dense_kernel),
               "dense_bias": np.asarray(p.dense_bias)}


@pytest.fixture(scope="module")
def tiny_gru(tmp_path_factory):
    from ggml_experiments_tpu.formats.gru_bin import save_gru_params

    path = str(tmp_path_factory.mktemp("gru") / "gru.bin")
    save_gru_params(path, _jax_gru_arrays()[0])
    return path


def _forks_at_near_ties(weights, got_texts, want_texts):
    """Each of ``got_texts`` equals its ``want_texts`` text but for a fork
    where the plain bf16 decode, teacher-forced on the wanted text, chose
    between two logits closer than BF16_NEAR_TIE."""
    tok = CharTokenizer()
    w = fused._prep_weights(load_gru_params(weights, qtype="q8_0", device="cpu"))
    for got, want in zip(got_texts, want_texts):
        assert len(got) == len(want)
        if got == want:
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        ids = torch.tensor([tok.encode(want)], dtype=torch.int32)
        n = torch.tensor([ids.shape[1]], dtype=torch.int32)
        z = torch.zeros(1, dtype=torch.int32)
        *_, gaps = fused.gru_loop_reference(w, ids, n, n, z, z, torch.zeros(1, w.u), ids.shape[1],
                                            torch.bfloat16, margins=True)
        assert j > 0 and float(gaps[0, j - 1]) < BF16_NEAR_TIE, (j, got, want)


def _texts(out):
    """The texts of an example's output: the blocks before each separator."""
    return out.split("\n--------\n")[:-1]


def test_generate_text_matches_the_jax_example(tiny_gru, capsys):
    _example("generate_text").main(tiny_gru, "ROMEO: ", "JULIET: ", "First Citizen:\n")
    want = capsys.readouterr().out
    _example("torch_generate_text").main(tiny_gru, "ROMEO: ", "JULIET: ", "First Citizen:\n",
                                         device="cpu")
    got = capsys.readouterr().out
    assert got.count("--------\n") == 3 and len(got) == len(want)
    assert len(_texts(got)[0]) == 200
    _forks_at_near_ties(tiny_gru, _texts(got), _texts(want))


def test_serve_continuous_matches_the_jax_example(tiny_gru, capsys):
    jex, tex = _example("serve_continuous"), _example("torch_serve_continuous")
    jex.main(tiny_gru)
    want = capsys.readouterr().out
    tex.main(tiny_gru, device="cpu")
    got = capsys.readouterr().out
    assert len(_texts(got)) == len(tex.PROMPTS) == 4
    for text, p in zip(_texts(got), tex.PROMPTS):
        assert text.startswith(p) and len(text) == len(p) + tex.MAX_NEW_TOKENS
    _forks_at_near_ties(tiny_gru, _texts(got), _texts(want))
    # "4 requests, N tokens, R tokens/s device throughput": counts equal
    assert got.splitlines()[-1].split(",")[:2] == want.splitlines()[-1].split(",")[:2]
    # the engine's texts are the offline generate's (the example's other copy)
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any

    params = load_gru_any(tiny_gru, qtype="q8_0", device="cpu")
    offline = _example("torch_generate_text").generate_texts(
        params, tex.PROMPTS, max(len(p) for p in tex.PROMPTS) + tex.MAX_NEW_TOKENS)
    assert [o[:len(t)] for o, t in zip(offline, _texts(got))] == _texts(got)


def test_train_and_export_matches_the_jax_example(tmp_path, capsys, monkeypatch):
    """Both examples on the JAX init of a tiny GRU (E = 16, U = 32) and
    128 windows of a synthetic corpus, 2 epochs (4 steps of 64): the final
    loss within 1e-5 relative, the exported gru.bin within the JAX trainer
    test's 2e-5, the best checkpoint written."""
    from ggml_experiments_tpu.models.gru_textgen import GRUConfig as JGRUConfig
    from ggml_experiments_tpu.training import train_from_text as jtrain_from_text
    from ggml_experiments_tpu.training.data import synthetic_corpus

    from ggml_experiments_tpu_torch.convert import params_from_numpy
    from ggml_experiments_tpu_torch.formats.gru_bin import read_tensors
    from ggml_experiments_tpu_torch.models import gru_textgen as tg

    corpus = tmp_path / "corpus.txt"
    corpus.write_text(synthetic_corpus(128 * 101))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jex = _example("train_and_export")
    monkeypatch.setattr(jex, "train_from_text", functools.partial(
        jtrain_from_text, model_config=JGRUConfig(embed_dim=16, units=32)))
    jex.main(str(corpus), str(jdir / "gru.bin"), "2")
    want = capsys.readouterr().out.strip()
    _, arrays = _jax_gru_arrays(key=0, embed=16, units=32)
    monkeypatch.setattr(tg, "init_params",
                        lambda *a, device=None, **k: params_from_numpy(arrays, device=device))
    _example("torch_train_and_export").main(str(corpus), str(tdir / "gru.bin"), "2",
                                            device="cpu")
    got = capsys.readouterr().out.strip()
    assert got.replace(str(tdir), "D").split(" ", 3)[3] == \
        want.replace(str(jdir), "D").split(" ", 3)[3]
    assert math.isclose(float(got.split()[2].rstrip(";")), float(want.split()[2].rstrip(";")),
                        rel_tol=1e-5, abs_tol=1e-4)
    for a, b in zip(read_tensors(str(tdir / "gru.bin")), read_tensors(str(jdir / "gru.bin"))):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)
    assert (tdir / "gru.bin.best.gxt").exists() and (jdir / "gru.bin.best.gxt").exists()


def test_extract_features_matches_the_jax_example(capsys):
    """q8_0 dense kernels, bf16 forward of the 256 px synthetic image on the
    tiny MobileViT: the shape line verbatim, the printed channels within
    the bf16 route rule (0.1 of the largest, 0.1 relative)."""
    import jax

    jex = _example("extract_features")
    # the JAX example's forward compiled once (its op-by-op dispatch at 256 px
    # takes half a minute on the CPU)
    jex.extract_features = jax.jit(jex.extract_features, static_argnames=("compute_dtype",))
    jex.main(TINY_VIT)
    want = capsys.readouterr().out.splitlines()
    _example("torch_extract_features").main(TINY_VIT, device="cpu")
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] == "feature shape: (1, 8, 8, 96)"

    def values(line):
        return np.array([float(v) for v in line.replace("first 5:", "").replace("last 5:", "")
                         .replace("[", " ").replace("]", " ").split()])

    g, w = values(got[1]), values(want[1])
    assert g.shape == w.shape == (10,)
    np.testing.assert_allclose(g, w, atol=0.1 * np.abs(w).max(), rtol=0.1)


@pytest.fixture(scope="module")
def multichip_jax():
    """The JAX example's model (E = 64, U = 128, ``PRNGKey(0)``) and the loss
    of its first Adam step on its batch, on one device."""
    import jax
    import jax.numpy as jnp
    import optax

    from ggml_experiments_tpu.training.gru_trainer import make_train_step

    p, arrays = _jax_gru_arrays(key=0, embed=64, units=128)
    rng = np.random.default_rng(0)
    inputs = jnp.asarray(rng.integers(0, 66, (8, 32)), jnp.int32)
    targets = jnp.asarray(rng.integers(0, 66, (8, 32)), jnp.int32)
    opt = optax.adam(1e-3)
    _, _, loss = make_train_step(opt)(p, opt.init(p), inputs, targets)
    return arrays, float(loss)


def test_multichip_step_matches_the_jax_step(multichip_jax, capsys):
    from ggml_experiments_tpu_torch.convert import params_from_numpy
    from ggml_experiments_tpu_torch.parallel import P, make_mesh

    arrays, want = multichip_jax
    tex = _example("torch_multichip")
    spec, loss, toks = tex.train_and_decode(params_from_numpy(arrays, device="cpu"),
                                            make_mesh(device_type="cpu"), 8, torch.device("cpu"))
    assert math.isclose(loss, want, rel_tol=1e-5)
    assert tuple(toks.shape) == (8, 32) and spec == P(None, "model")
    tex.main(device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["1 devices, mesh {'data': 1, 'model': 1}",
                       "cell.kernel sharding: P(None, 'model')"]
    assert np.isfinite(float(out[2].split(": ")[1])) and out[3] == "sharded decode: (8, 32)"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_multichip_example_on_two_gloo_processes(capsys):
    """``torch_multichip.py --device cpu`` as two ranks of one gloo group: a
    (1, 2) mesh, the gate kernels column-sharded; both ranks print the same
    loss, within 1e-5 of one process's step on the same init."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "examples", "torch_multichip.py"), "--device",
             "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            cwd=REPO))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out.splitlines())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tex = _example("torch_multichip")
    _, one, _ = tex.train_and_decode(tex.init("cpu"), tex.make_mesh(device_type="cpu"), 8,
                                     torch.device("cpu"))
    for out in outs:
        assert out[:2] == ["2 devices, mesh {'data': 1, 'model': 2}",
                           "cell.kernel sharding: P(None, 'model')"]
        assert out[3] == "sharded decode: (8, 32)"
        assert math.isclose(float(out[2].split(": ")[1]), one, rel_tol=1e-5)
    assert outs[0][2] == outs[1][2]


def test_classifier_report_matches_jax_classify_per_qtype():
    """The tool's report on 120 of the tiny checkpoint's held-out images:
    each format's logits within 1e-4 of the largest of JAX's ``classify``
    on the same file, top-1 and agreement from the same argmax."""
    import jax
    import jax.numpy as jnp

    from ggml_experiments_tpu.models.mobilevit import classify, load_mobilevit
    from ggml_experiments_tpu.training.image_task import TINY_CLS_CONFIG

    s = cls_tool.setting(False)
    x, y = cls_tool.heldout(s, 120)
    rep, logits = cls_tool.report(cls_tool.COMMITTED[False], s, x, y, device="cpu")
    fn = jax.jit(classify)
    jpreds = {}
    for qt in cls_tool.QTYPES:
        jp = load_mobilevit(cls_tool.COMMITTED[False], config=TINY_CLS_CONFIG, qtype=qt)
        want = np.asarray(fn(jp, jnp.asarray(x)))
        key = qt or "f32"
        np.testing.assert_allclose(logits[key], want, atol=1e-4 * np.abs(want).max(), rtol=0)
        jpreds[key] = want.argmax(-1)
        assert np.array_equal(logits[key].argmax(-1), jpreds[key]), key
        assert rep[f"top1_{key}"] == float((jpreds[key] == y).mean())
    for qt in cls_tool.QTYPES[1:]:
        assert rep[f"agreement_{qt}"] == float((jpreds[qt] == jpreds["f32"]).mean())
    assert (logits["bf16"].argmax(-1) == jpreds["f32"]).mean() >= 0.95
    # tests/test_trained_classifier.py's margins on the same slice
    assert 0.85 <= rep["top1_f32"] <= 0.985
    assert rep["agreement_q8_0"] >= 0.99 and rep["dtop1_q8_0"] <= 0.009
    assert rep["agreement_q4_0"] >= 0.85 and rep["dtop1_q4_0"] <= 0.10
    assert rep["rel_logit_rmse_q8_0"] < min(0.02, rep["rel_logit_rmse_q4_0"])
    for key in ("f8_e5m2", "f8_e5m2_stem12", "f8_e5m2_stem"):
        assert rep[f"agreement_{key}_vs_bf16"] >= 0.9


def test_classifier_tool_writes_outside_checkpoints(tmp_path, capsys):
    """The default output is under the git-ignored build/, a path under
    checkpoints/ is refused, and a short tiny training writes its file and
    leaves checkpoints/ byte for byte as it was."""
    ckpt_dir = os.path.join(REPO, "checkpoints")
    for full in (False, True):
        out = os.path.realpath(cls_tool.DEFAULT_OUT[full])
        assert out.startswith(os.path.join(os.path.realpath(REPO), "build") + os.sep)
        assert not out.startswith(os.path.realpath(ckpt_dir) + os.sep)
    before = {n: open(os.path.join(ckpt_dir, n), "rb").read() for n in sorted(os.listdir(ckpt_dir))}
    s = dict(cls_tool.setting(False), n_train=60, steps=3, batch=20)
    with pytest.raises(ValueError, match="checkpoints"):
        cls_tool.train(s, os.path.join(ckpt_dir, "x.ggml"), device="cpu")
    out = str(tmp_path / "cls.ggml")
    loss = cls_tool.train(s, out, device="cpu", log=lambda m: None)
    assert np.isfinite(loss) and os.path.getsize(out) > 0
    rep, _ = cls_tool.report(out, s, *cls_tool.heldout(s, 20), loss=loss, device="cpu")
    assert rep["final_loss"] == loss and set(rep) >= {"top1_f32", "dtop1_q4_0", "top1_bf16"}
    after = {n: open(os.path.join(ckpt_dir, n), "rb").read() for n in sorted(os.listdir(ckpt_dir))}
    assert after == before
    capsys.readouterr()


def test_examples_and_tools_raise_without_a_gpu(monkeypatch, tiny_gru, tmp_path):
    """No GPU and no device given: every copy raises instead of running on
    the CPU."""
    from tools import torch_convert_hf_mobilevit as conv
    from tools import torch_verify_reference_golden as golden

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: _example("torch_generate_text").main(tiny_gru),
        lambda: _example("torch_serve_continuous").main(tiny_gru),
        lambda: _example("torch_train_and_export").main(
            os.path.join(REPO, "checkpoints", "shakespeare_train.txt"), str(tmp_path / "g.bin"), "1"),
        lambda: _example("torch_extract_features").main(TINY_VIT),
        lambda: _example("torch_multichip").main(),
        lambda: cls_tool.main(["--eval-only"]),
        lambda: conv.main([str(tmp_path), str(tmp_path / "w.ggml")]),
        lambda: golden.main(["--model", str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_an_example_runs_as_a_command_from_the_repo_root(tiny_gru):
    out = subprocess.run([sys.executable, "examples/torch_generate_text.py", "--device", "cpu",
                          tiny_gru, "ROMEO: "], cwd=REPO, capture_output=True, text=True,
                         timeout=TIMEOUT_S, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ROMEO: ") and out.stdout.endswith("--------\n")
