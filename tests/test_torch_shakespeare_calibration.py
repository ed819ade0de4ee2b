"""Port: the real-English quantization contract on the Shakespeare GRU.

``checkpoints/gru_shakespeare.bin`` (full width: E=256, U=1024) on the
held-out Shakespeare windows. The ordering of the JAX package's contract
(tests/test_shakespeare_model.py:62-86) is the portable one: q8_0 agrees
with f32 at least as often as the GPTQ q4_k_m recipe, which beats
round-to-nearest q4_k and holds 0.95; q8_0 holds 0.985. The port runs the
whole recipe, 128 calibration windows of the train split chosen by
``default_rng(7)``, on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from ggml_experiments_tpu_torch import evaluation
from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
from ggml_experiments_tpu_torch.quant import calibration
from ggml_experiments_tpu_torch.training.data import DataConfig, load_corpus, make_examples
from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

CKPTS = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
CKPT = os.path.join(CKPTS, "gru_shakespeare.bin")
HELD = os.path.join(CKPTS, "shakespeare_heldout.txt")
TRAIN = os.path.join(CKPTS, "shakespeare_train.txt")
CPU = "cpu"


@pytest.fixture(autouse=True)
def _two_threads():
    """Beside other test workers, a full-width thread pool per product only
    oversubscribes the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _windows(path):
    return make_examples(load_corpus(path), CharTokenizer(), DataConfig(seq_length=100))


def test_real_text_quant_ordering_with_gptq_q4_k_m():
    held = _windows(HELD)
    ref = load_gru_params(CKPT, device=CPU)
    rep8 = evaluation.eval_gru_delta(ref, load_gru_params(CKPT, qtype="q8_0", device=CPU), held)
    rep4 = evaluation.eval_gru_delta(ref, load_gru_params(CKPT, qtype="q4_k", device=CPU), held)
    train = _windows(TRAIN)
    cal = train[np.random.default_rng(7).permutation(len(train))[:128]]
    pm = calibration.gptq_gru_params(ref, cal)
    assert (pm.cell.kernel.qtype, pm.cell.recurrent_kernel.qtype, pm.dense_kernel.qtype) == (
        "q4_k", "q4_k", "q8_0")
    repm = evaluation.eval_gru_delta(ref, pm, held)
    assert rep8.top1_agreement >= 0.985, rep8
    assert repm.top1_agreement >= 0.95, repm
    # calibration closes a real share of the round-to-nearest gap
    assert repm.top1_agreement > rep4.top1_agreement, (repm, rep4)
    assert rep8.top1_agreement >= repm.top1_agreement, (rep8, repm)
    # and Δppl orders the same way
    dppl = {k: abs(r.ppl_a - r.ppl_b) / r.ppl_b for k, r in
            (("q8_0", rep8), ("q4_k_m", repm), ("q4_k", rep4))}
    assert dppl["q8_0"] <= dppl["q4_k_m"] < dppl["q4_k"], dppl
