"""Port: the quantization-delta evaluation against the JAX package's, and the
trained-model contracts on the committed checkpoint and held-out corpus.

The held-out batch is the one the JAX package's own contract test draws (16
sequences of 100 tokens, seed 0): at 1600 positions one disagreeing argmax
still meets the 99.9% contract. Both packages read the same sequences.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_experiments_tpu import evaluation as jeval
from ggml_experiments_tpu.formats.gru_bin import load_gru_any as jload
from ggml_experiments_tpu.models import gru_textgen as jg
from ggml_experiments_tpu.training import data as jdata
from ggml_experiments_tpu.utils.tokenizer import CharTokenizer as JTok
from ggml_experiments_tpu_torch import evaluation as teval
from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any as tload
from ggml_experiments_tpu_torch.models import gru_textgen as tg
from ggml_experiments_tpu_torch.training import data as tdata
from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer as TTok

CKPTS = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
SYNTH = os.path.join(CKPTS, "gru_synth.bin")
Q4KM = os.path.join(CKPTS, "gru_synth_q4km.gxt")
HELDOUT = os.path.join(CKPTS, "corpus_heldout.txt")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The step loops here run thousands of small products; beside other
    test workers, a full-width thread pool per product only oversubscribes
    the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def heldout_seqs():
    ex = tdata.make_examples(tdata.load_corpus(HELDOUT), TTok(), tdata.DataConfig(seq_length=100))
    want = jdata.make_examples(jdata.load_corpus(HELDOUT), JTok(), jdata.DataConfig(seq_length=100))
    np.testing.assert_array_equal(ex, want)
    assert ex.dtype == np.int32 and ex.shape[1] == 101
    return ex[np.random.default_rng(0).permutation(len(ex))[:16]]


@pytest.fixture(scope="module")
def refs():
    return jload(SYNTH), tload(SYNTH, device="cpu")


def test_data_config_defaults_match_jax():
    t, j = tdata.DataConfig(), jdata.DataConfig()
    assert (t.seq_length, t.batch_size, t.shuffle_buffer, t.drop_remainder) == (
        j.seq_length, j.batch_size, j.shuffle_buffer, j.drop_remainder)
    ex = tdata.make_examples("abcdefghij" * 3, TTok(), tdata.DataConfig(seq_length=6))
    assert ex.shape == (4, 7)


def quantized_twins(qtype):
    """The trained checkpoint under ``qtype`` in both packages; "q4km" is the
    committed calibrated file (q4_k cell, q8_0 head), which carries q4_k at
    full width without its minutes-long host-side grid search."""
    if qtype == "q4km":
        return jload(Q4KM), tload(Q4KM, device="cpu")
    return jload(SYNTH, qtype=qtype), tload(SYNTH, qtype=qtype, device="cpu")


@pytest.mark.parametrize("qtype", [None, "q8_0", "q4_0", "q5_1", "q4km"])
def test_forward_sequence_logits_match_jax(refs, heldout_seqs, qtype):
    """Teacher-forced logits at full width, f32: sums in two orders over 1024
    terms through up to 32 recurrent steps, so 1e-4 absolute."""
    jp, tp = refs if qtype is None else quantized_twins(qtype)
    ids = heldout_seqs[:3, :32]
    jl, jh = jg.forward_sequence(jp, jnp.asarray(ids))
    tl, th = tg.forward_sequence(tp, ids)
    assert tl.shape == (3, 32, 66) and tl.dtype == torch.float32 and th.shape == (3, 1024)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)
    # a given initial state continues the sequence
    tl2, th2 = tg.forward_sequence(tp, ids[:, 16:], tg.forward_sequence(tp, ids[:, :16])[1])
    np.testing.assert_allclose(tl2.numpy(), tl[:, 16:].numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(th2.numpy(), th.numpy(), atol=1e-6, rtol=1e-5)


def test_forward_sequence_bf16_and_time_major(refs):
    _, tp = refs
    ids = np.array([[5, 9, 13, 2]], np.int32)
    lb, _ = tg.forward_sequence(tp, ids, compute_dtype=torch.bfloat16)
    lf, _ = tg.forward_sequence(tp, ids)
    assert lb.dtype == torch.bfloat16
    np.testing.assert_allclose(lb.float().numpy(), lf.numpy(), atol=0.25, rtol=0.05)
    empty, h = tg.forward_sequence(tp, np.zeros((2, 0), np.int32))
    assert empty.shape == (2, 0, 66) and not h.any()
    # time-major: the same logits, transposed (the training layout)
    lt, ht = tg.forward_sequence(tp, ids.T, time_major=True)
    assert lt.shape == (4, 1, 66)
    np.testing.assert_allclose(lt.swapaxes(0, 1).numpy(), lf.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ht.numpy(), tg.forward_sequence(tp, ids)[1].numpy(), atol=1e-6)


def test_compare_logits_and_perplexity_match_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(0, 2, (3, 7, 66)).astype(np.float32)
    b = (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
    tgt = rng.integers(0, 66, (3, 7))
    t = teval.compare_logits(torch.from_numpy(a), b, targets=tgt).as_dict()
    j = jeval.compare_logits(a, b, targets=tgt).as_dict()
    assert t.keys() == j.keys()
    for k in t:
        assert t[k] == pytest.approx(j[k], rel=1e-6, abs=1e-7), k
    assert teval.perplexity(a, tgt) == pytest.approx(jeval.perplexity(a, tgt), rel=1e-6)
    assert set(teval.compare_logits(a, b).as_dict()) == {"max_abs", "mean_abs", "rel_rmse",
                                                         "top1_agreement"}
    with pytest.raises(ValueError, match="shape mismatch"):
        teval.compare_logits(a, b[:, :3])


@pytest.mark.parametrize("qtype", ["q8_0", "q4_0", "q4_1", "q5_0", "q5_1", "q4km"])
def test_eval_gru_delta_matches_jax_report(refs, heldout_seqs, qtype):
    """The port's report equals the JAX package's within 1e-5 on every
    averaged number, and the trained-model contracts hold for the port: q8_0 agrees with fp32
    on >= 99.9% of next-token argmaxes with matched perplexity; the 4- and
    5-bit formats stay usable models."""
    jref, tref = refs
    jq, tq = quantized_twins(qtype)
    t = teval.eval_gru_delta(tref, tq, heldout_seqs)
    j = jeval.eval_gru_delta(jref, jq, heldout_seqs)
    for k, v in j.as_dict().items():
        # max_abs is one logit difference, so it carries the logits' own
        # summation-order tolerance (1e-4); the averaged numbers hold 1e-5
        tol = 1e-4 if k == "max_abs" else 1e-5
        assert t.as_dict()[k] == pytest.approx(v, rel=1e-5, abs=tol), (k, t, j)
    assert t.ppl_b < 6.0, f"held-out ppl {t.ppl_b}: model not converged (uniform = 66)"
    floor = {"q8_0": 0.999, "q4_0": 0.95, "q4_1": 0.98, "q5_0": 0.98, "q5_1": 0.99,
             "q4km": 0.99}[qtype]
    assert t.top1_agreement >= floor, t
    ppl_tol = 0.01 if qtype == "q8_0" else 0.15
    assert abs(t.ppl_a - t.ppl_b) / t.ppl_b < ppl_tol, t


# ---- MobileViT: eval_mobilevit_delta and the weight.ggml commands --------------------

VIT = os.path.join(CKPTS, "mobilevit_synth.ggml")


def _vit_twins(qtype):
    import dataclasses

    from ggml_experiments_tpu.models import mobilevit as jmv
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
    from ggml_experiments_tpu_torch.models import mobilevit as tmv
    from ggml_experiments_tpu_torch.training.image_task import TINY_CLS_CONFIG

    named = read_named_tensors(VIT)
    jcfg = jmv.MobileViTConfig(**dataclasses.asdict(TINY_CLS_CONFIG))
    return (jmv.from_named_tensors(named, jcfg, qtype=qtype, flash_attn=False,
                                   fused_layer=False),
            tmv.from_named_tensors(named, TINY_CLS_CONFIG, qtype=qtype, device="cpu"))


@pytest.mark.parametrize("head", [True, False])
def test_eval_mobilevit_delta_matches_jax(head):
    """Logits when both sides have a head, features otherwise: the report's
    numbers within the f32 forward's 1e-4 of the JAX package's."""
    (jref, tref), (jq, tq) = _vit_twins(None), _vit_twins("q4_0")
    if not head:
        for p in (jref, tref, jq, tq):
            p.classifier_kernel = p.classifier_bias = None
    imgs = np.random.default_rng(2).uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    t = teval.eval_mobilevit_delta(tref, tq, imgs).as_dict()
    j = jeval.eval_mobilevit_delta(jref, jq, jnp.asarray(imgs)).as_dict()
    assert t.keys() == j.keys() and ("top1_agreement" in t) == head
    for k in t:
        assert t[k] == pytest.approx(j[k], rel=1e-4, abs=1e-5), k


def test_cli_eval_of_a_weight_ggml_matches_the_jax_command(capsys):
    """The delta block on the synthetic image and the top-1 block on the
    task's held-out images (made at the base contrast, as the JAX command
    makes them)."""
    import json

    from ggml_experiments_tpu import cli as jcli
    from ggml_experiments_tpu_torch import cli

    args = ["eval", "--weights", VIT, "--image-size", "64", "--qtype", "q4_k", "--batch", "2"]
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jcli.main(args + ["--compile-cache", "off"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert list(got) == list(want) == ["qtype", "max_abs", "mean_abs", "rel_rmse",
                                       "top1_agreement", "top1_f32", "top1_q", "dtop1"]
    for k in ("max_abs", "mean_abs", "rel_rmse"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    for k in ("qtype", "top1_agreement", "top1_f32", "top1_q", "dtop1"):
        assert got[k] == want[k], k
    assert got["top1_f32"] > 0.8


@pytest.mark.parametrize("qtype", ["q8_0", "q4_k"])
def test_cli_quantize_of_a_weight_ggml(qtype, tmp_path, capsys):
    """Round to nearest: the JAX command's JSON line and leaves. The port's
    file also carries the MobileViT meta (kind, qtype, config, head), so
    both packages' load_mobilevit and the vision commands take it; the JAX
    command writes none, and its file loads in neither package's
    load_mobilevit (ROADMAP.md, Queue C)."""
    import json

    from ggml_experiments_tpu import cli as jcli
    from ggml_experiments_tpu.formats import checkpoint as jckpt
    from ggml_experiments_tpu.models import mobilevit as jmv
    from ggml_experiments_tpu_torch import cli
    from ggml_experiments_tpu_torch.models import mobilevit as tmv

    out, jout = str(tmp_path / "port.gxt"), str(tmp_path / "jax.gxt")
    args = ["quantize", "--input", VIT, "--qtype", qtype]
    assert cli.main(args + ["--output", out, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert jcli.main(args + ["--output", jout, "--compile-cache", "off"]) == 0
    assert line == {**json.loads(capsys.readouterr().out), "output": out}
    meta = jckpt.read_meta(out)
    assert (meta["kind"], meta["qtype"], meta["calibrated"], meta["classifier"]) == (
        "mobilevit", qtype, False, True)
    assert jckpt.read_meta(jout) == {}
    # the same tensors as the JAX command's file, key by key (the folded BN
    # vectors within the loader's 1e-6: the two rsqrt differ in the last bit)
    got, want = jckpt.load_arrays(out), jckpt.load_arrays(jout)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if hasattr(w, "codes"):
            assert (g.qtype, g.shape) == (w.qtype, w.shape), k
            np.testing.assert_array_equal(np.asarray(g.codes), np.asarray(w.codes), err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=0,
                                       err_msg=k)
    jp = jmv.load_mobilevit(out, flash_attn=False, fused_layer=False)
    tp = tmv.load_mobilevit(out, device="cpu")
    assert tp.layer_3.transformer[0].attention.wq.qtype == qtype == jp.classifier_kernel.qtype
    with pytest.raises(ValueError, match="not a MobileViT"):
        tmv.load_mobilevit(jout, device="cpu")
    assert cli.main(["classify", "--weights", out, "--top-k", "2", "--device", "cpu"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 2
