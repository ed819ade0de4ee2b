"""Port: calibration (``quant/calibration.py``) against the JAX package's.

The statistics of the same sequences and images within rtol 1e-5 of the JAX
collectors' (the f32 forwards sum in other orders; the Grams are float64
sums of them), the vision taps in the same order. The recipes then run on
those statistics: GPTQ is a chaotic recursion (a code that flips at a
near-tie feeds a different error into every later row), so the planes are
compared by counting differing codes against a bound, and the contract
metrics of the two packages' models are held to each other. Files written by
either package load in the other with every leaf equal.
"""

import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_experiments_tpu.formats import checkpoint as jckpt
from ggml_experiments_tpu.formats.gru_bin import load_gru_any as jload_gru
from ggml_experiments_tpu.models import mobilevit as jmv
from ggml_experiments_tpu.quant import calibration as jcal
from ggml_experiments_tpu.quant.qtensor import QTensor as JQTensor
from ggml_experiments_tpu.quant.qtensor import unpack_nibbles as junpack
from ggml_experiments_tpu_torch import cli, evaluation
from ggml_experiments_tpu_torch.formats import checkpoint as tckpt
from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any, load_gru_params
from ggml_experiments_tpu_torch.models import mobilevit as tmv
from ggml_experiments_tpu_torch.quant import calibration
from ggml_experiments_tpu_torch.quant.qtensor import QTensor, unpack_nibbles
from ggml_experiments_tpu_torch.training import data as tdata
from ggml_experiments_tpu_torch.training import image_task as timg
from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = os.path.join(REPO, "checkpoints")
GRU = os.path.join(CKPTS, "gru_synth.bin")
TRAIN = os.path.join(CKPTS, "corpus_train.txt")
HELDOUT = os.path.join(CKPTS, "corpus_heldout.txt")
VIT = os.path.join(CKPTS, "mobilevit_synth.ggml")
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _examples(path, n, seed):
    ex = tdata.make_examples(tdata.load_corpus(path), CharTokenizer(),
                             tdata.DataConfig(seq_length=100))
    return ex[np.random.default_rng(seed).permutation(len(ex))[:n]]


def _close(got, want, rtol=1e-5):
    """Within rtol of each entry, and of the matrix's largest entry for the
    entries near zero (off-diagonal Gram entries sum terms of both signs)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _codes(qt):
    """Unpacked codes of a port or JAX QTensor as int numpy (K, N)."""
    if isinstance(qt, QTensor):
        c = qt.codes if qt.qtype == "q8_0" else unpack_nibbles(qt.codes, torch.int32)
        return c[: qt.shape[0], : qt.shape[1]].numpy().astype(np.int32)
    c = np.asarray(qt.codes) if qt.qtype == "q8_0" else np.asarray(junpack(qt.codes))
    return c[: qt.shape[0], : qt.shape[1]].astype(np.int32)


def _vit_cfg():
    return jmv.MobileViTConfig(**dataclasses.asdict(timg.TINY_CLS_CONFIG))


# ---- GRU ------------------------------------------------------------------------------


def test_gru_moments_and_hessians_match_jax():
    seqs = _examples(TRAIN, 6, 0)[:, :41]
    tp, jp = load_gru_params(GRU, device=CPU), jload_gru(GRU)
    for name, tfn, jfn in (("moments", calibration.collect_gru_moments,
                            jcal.collect_gru_moments),
                           ("hessians", calibration.collect_gru_hessians,
                            jcal.collect_gru_hessians)):
        got, want = tfn(tp, seqs), jfn(jp, seqs)
        assert got.keys() == want.keys() == {"kernel", "recurrent_kernel", "dense_kernel"}
        for key in want:
            assert got[key].dtype == torch.float64 and tuple(got[key].shape) == want[key].shape
            _close(got[key].numpy(), want[key])


@pytest.fixture(scope="module")
def gru_q4km(tmp_path_factory):
    """The q4_k_m recipe on gru_synth.bin by both packages' ``quantize`` (8
    calibration sequences of corpus_train.txt, the commands' selection)."""
    from ggml_experiments_tpu import cli as jcli

    d = tmp_path_factory.mktemp("gru_q4km")
    args = ["quantize", "--input", GRU, "--qtype", "q4_k_m", "--calibrate", TRAIN,
            "--calibrate-seqs", "8"]
    out, jout = str(d / "port.gxt"), str(d / "jax.gxt")
    lines = []
    for fn, extra in ((cli.main, ["--output", out, "--device", CPU]),
                      (jcli.main, ["--output", jout, "--compile-cache", "off"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert fn(args + extra) == 0
        lines.append(json.loads(buf.getvalue()))
    return out, jout, lines


def test_gru_q4km_command_matches_jax(gru_q4km):
    out, jout, (line, jline) = gru_q4km
    assert line == {**jline, "output": out}
    assert line["calibrated"] and line["bits_per_weight"] < 5.0
    assert tckpt.read_meta(out) == jckpt.read_meta(jout) == {
        "kind": "gru", "qtype": "q4_k_m", "calibrated": True}
    tp, jp = load_gru_any(out, device=CPU), jload_gru(jout)
    # the forwards sum in other orders, so H differs in its last digits and
    # GPTQ carries a flipped near-tie on through the rows; the input kernel's
    # H is exact (embedding rows), its codes equal
    bounds = {"kernel": 0.0, "recurrent_kernel": 0.02, "dense_kernel": 0.002}
    for name, bound in bounds.items():
        g = getattr(tp.cell, name) if name != "dense_kernel" else tp.dense_kernel
        w = getattr(jp.cell, name) if name != "dense_kernel" else jp.dense_kernel
        assert g.qtype == w.qtype == ("q8_0" if name == "dense_kernel" else "q4_k")
        frac = float((_codes(g) != _codes(w)).mean())
        assert frac <= bound, (name, frac)


def test_gru_q4km_contract_metrics_match_jax(gru_q4km):
    """Each package's file against the float model on held-out text, in the
    port's evaluation: agreement and Δppl within one disagreeing position
    and 2e-4 of each other."""
    out, jout, _ = gru_q4km
    seqs = _examples(HELDOUT, 8, 0)
    ref = load_gru_params(GRU, device=CPU)
    reps = [evaluation.eval_gru_delta(ref, load_gru_any(f, device=CPU), seqs)
            for f in (out, jout)]
    n = seqs.shape[0] * (seqs.shape[1] - 1)
    assert abs(reps[0].top1_agreement - reps[1].top1_agreement) <= 1.0 / n + 1e-9, reps
    dppl = [abs(r.ppl_a - r.ppl_b) / r.ppl_b for r in reps]
    assert abs(dppl[0] - dppl[1]) < 2e-4, dppl
    assert reps[0].top1_agreement >= 0.99 and dppl[0] < 0.005, reps[0]


def test_gru_q4km_files_load_in_both_packages(gru_q4km):
    out, jout, _ = gru_q4km
    for path in (out, jout):
        tp, jp = load_gru_any(path, device=CPU), jload_gru(path)
        for name in ("kernel", "recurrent_kernel"):
            np.testing.assert_array_equal(_codes(getattr(tp.cell, name)),
                                          _codes(getattr(jp.cell, name)))
        np.testing.assert_array_equal(_codes(tp.dense_kernel), _codes(jp.dense_kernel))
        np.testing.assert_array_equal(tp.cell.recurrent_kernel.scales.numpy()[:32, :3072],
                                      np.asarray(jp.cell.recurrent_kernel.scales)[:32, :3072])


# ---- MobileViT ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vit_models():
    from ggml_experiments_tpu.formats.ggml_named import read_named_tensors as jread

    named = jread(VIT)
    tp = tmv.from_named_tensors(named, timg.TINY_CLS_CONFIG, flash_attn=False,
                                fused_layer=False, device=CPU)
    jp = jmv.from_named_tensors(named, _vit_cfg(), flash_attn=False, fused_layer=False)
    return named, tp, jp


def test_mobilevit_grams_match_jax(vit_models):
    _, tp, jp = vit_models
    x, _ = timg.make_dataset(12, seed=4242, image_size=64)
    got = calibration.collect_mobilevit_grams(tp, x, batch=8)
    want = jcal.collect_mobilevit_grams(jp, x, batch=8)
    assert list(got) == list(want) == [n for n, _, _ in calibration._vision_quantizable(tp)]
    assert len(got) == 9 * 6 + 1
    for name in want:
        assert got[name].dtype == torch.float64
        _close(got[name].numpy(), want[name])


def test_mobilevit_gram_taps_and_gptq():
    """The JAX contract on a random net: one PSD (K, K) Gram per quantizable
    weight, q4_k transformer kernels and a q8_0 head that stay close to the
    float model; a fused forward or quantized params trip the tap check."""
    cfg = tmv.MobileViTConfig(image_size=64, hidden_sizes=(32, 48, 64),
                              num_transformer_layers=(1, 1, 1),
                              neck_hidden_sizes=(8, 16, 24, 32, 48, 64, 96), num_labels=10)
    named = tmv.random_named_tensors(cfg, seed=0, classifier=True)
    pf = tmv.from_named_tensors(named, cfg, flash_attn=False, fused_layer=False, device=CPU)
    x = np.random.default_rng(0).random((8, 64, 64, 3)).astype(np.float32)
    grams = calibration.collect_mobilevit_grams(pf, x, batch=4)
    assert len(grams) == 3 * 6 + 1
    for name, h in grams.items():
        h = h.numpy()
        assert h.shape[0] == h.shape[1]
        tol = 1e-6 * max(1.0, float(np.trace(h)) / h.shape[0])
        assert np.linalg.eigvalsh(h).min() > -tol, name
    pq = tmv.from_named_tensors(named, cfg, flash_attn=False, fused_layer=False, device=CPU)
    pq = calibration.gptq_mobilevit_params(pq, grams)
    assert pq.layer_3.transformer[0].attention.wq.qtype == "q4_k"
    assert pq.classifier_kernel.qtype == "q8_0"
    la = tmv.classify(pf, torch.from_numpy(x)).numpy()
    lb = tmv.classify(pq, torch.from_numpy(x)).numpy()
    rel = np.sqrt(np.mean((lb - la) ** 2)) / np.sqrt(np.mean(la ** 2))
    assert rel < 0.05, rel
    with pytest.raises(AssertionError, match="tap count"):
        calibration.collect_mobilevit_grams(pq, x[:2])
    fused = tmv.from_named_tensors(named, cfg, fused_layer=True, device=CPU)
    with pytest.raises(AssertionError, match="tap count"):
        calibration.collect_mobilevit_grams(fused, x[:2], compute_dtype=torch.bfloat16)


def _logits(params, images):
    return np.concatenate([tmv.classify(params, torch.from_numpy(images[i:i + 60])).numpy()
                           for i in range(0, len(images), 60)])


def _jlogits(params, images):
    fn = jax.jit(jmv.classify)
    return np.concatenate([np.asarray(fn(params, jnp.asarray(images[i:i + 60])))
                           for i in range(0, len(images), 60)])


def test_gptq_mobilevit_contract_matches_jax(vit_models):
    """JAX's tiny vision contract (tests/test_trained_classifier.py:116-158) on
    the port's recipe: agreement >= 0.99, rel logit RMSE < 0.01 and <= 1.5x
    q8_0's, on 120 held-out images; the JAX recipe on the same Grams'
    inputs lands within one flip and 20% of the port's RMSE, its codes
    mostly the port's."""
    named, tp, jp = vit_models
    images, _ = timg.make_dataset(120, seed=timg.HELDOUT_SEED, image_size=64)
    cal_x, _ = timg.make_dataset(48, seed=4242, image_size=64)
    pq = tmv.from_named_tensors(named, timg.TINY_CLS_CONFIG, flash_attn=False,
                                fused_layer=False, device=CPU)
    pq = calibration.gptq_mobilevit_params(
        pq, calibration.collect_mobilevit_grams(tp, cal_x, batch=16))
    jq = jmv.from_named_tensors(named, _vit_cfg(), flash_attn=False, fused_layer=False)
    jq = jcal.gptq_mobilevit_params(jq, jcal.collect_mobilevit_grams(jp, cal_x, batch=16))

    la = _logits(tp, images)
    rel = {}
    agree = {}
    for name, lb in (("port", _logits(pq, images)), ("jax", _jlogits(jq, images))):
        agree[name] = float((la.argmax(-1) == lb.argmax(-1)).mean())
        rel[name] = float(np.sqrt(np.mean((lb - la) ** 2)) / np.sqrt(np.mean(la ** 2)))
    q8 = tmv.from_named_tensors(named, timg.TINY_CLS_CONFIG, qtype="q8_0", flash_attn=False,
                                fused_layer=False, device=CPU)
    l8 = _logits(q8, images)
    rel8 = float(np.sqrt(np.mean((l8 - la) ** 2)) / np.sqrt(np.mean(la ** 2)))
    assert agree["port"] >= 0.99 and rel["port"] < 0.01, (agree, rel)
    assert rel["port"] <= 1.5 * rel8, (rel, rel8)
    assert abs(agree["port"] - agree["jax"]) <= 1 / 120 + 1e-9, agree
    assert abs(rel["port"] - rel["jax"]) <= 0.2 * rel["jax"], rel
    differ = total = 0
    for (name, holder, field), (_, jholder, jfield) in zip(
            calibration._vision_quantizable(pq), jcal._vision_quantizable(jq)):
        g, w = getattr(holder, field), getattr(jholder, jfield)
        assert isinstance(g, QTensor) and isinstance(w, JQTensor) and g.qtype == w.qtype, name
        differ += int((_codes(g) != _codes(w)).sum())
        total += g.shape[0] * g.shape[1]
    assert differ <= 0.05 * total, (differ, total)


def _leaves_equal(port_params, jax_params):
    got = dict(tckpt._flatten(port_params))
    want = jax.tree_util.tree_flatten_with_path(
        jax_params, is_leaf=lambda x: isinstance(x, JQTensor))[0]
    want = {jckpt._keystr(kp): leaf for kp, leaf in want}
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, JQTensor):
            assert isinstance(g, QTensor) and (g.qtype, g.shape) == (w.qtype, w.shape), k
            for name in ("codes", "scales", "mins", "hibits", "supers"):
                gp, wp = getattr(g, name), getattr(w, name)
                assert (gp is None) == (wp is None), (k, name)
                if gp is not None:
                    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp), err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)


def test_vision_q4km_files_load_in_both_packages(tmp_path, capsys):
    """``quantize --qtype q4_k_m --calibrate task:7`` of the tiny checkpoint in
    each package: the same JSON line and meta, and each file loads in both
    packages' load_mobilevit with every leaf equal."""
    from ggml_experiments_tpu import cli as jcli

    args = ["quantize", "--input", VIT, "--qtype", "q4_k_m", "--calibrate", "task:7",
            "--calibrate-seqs", "12"]
    out, jout = str(tmp_path / "port.gxt"), str(tmp_path / "jax.gxt")
    assert cli.main(args + ["--output", out, "--device", CPU]) == 0
    line = json.loads(capsys.readouterr().out)
    assert jcli.main(args + ["--output", jout, "--compile-cache", "off"]) == 0
    assert line == {**json.loads(capsys.readouterr().out), "output": out}
    meta = tckpt.read_meta(out)
    assert meta == jckpt.read_meta(jout)
    assert (meta["kind"], meta["qtype"], meta["calibrated"], meta["classifier"]) == (
        "mobilevit", "q4_k_m", True, True)
    for path in (out, jout):
        tp = tmv.load_mobilevit(path, device=CPU)
        assert tp.layer_3.transformer[0].attention.wq.qtype == "q4_k"
        assert tp.classifier_kernel.qtype == "q8_0"
        _leaves_equal(tp, jmv.load_mobilevit(path, flash_attn=False, fused_layer=False))
