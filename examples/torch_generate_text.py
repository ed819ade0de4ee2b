#!/usr/bin/env python3
"""Text generation end to end on the port: the reference's rnn_text_gen
flow, batched (the port's copy of ``examples/generate_text.py``).

Load gru.bin quantized to q8_0 (the fused dequantize-and-multiply kernel,
``csrc/qmatmul.cu``, on the card) -> encode the prompts -> a 200-step greedy
bf16 decode -> print each text.

    python3 examples/torch_generate_text.py path/to/gru.bin "ROMEO: " "JULIET: "
    python3 examples/torch_generate_text.py --device cpu path/to/gru.bin "ROMEO: "

It runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch

from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any
from ggml_experiments_tpu_torch.models import gru_textgen
from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

STEPS = 200


def generate_texts(params, prompts, steps: int = STEPS) -> list:
    """Each prompt's text after a ``steps``-step greedy bf16 decode (the
    serving fast path; prompt included)."""
    tok = CharTokenizer()
    ids, lengths = tok.encode_batch(list(prompts))
    with torch.no_grad():
        out = gru_textgen.generate(params, ids, lengths, steps, compute_dtype=torch.bfloat16)
    return [tok.decode(int(t) for t in row) for row in out.cpu().tolist()]


def main(weights: str, *prompts: str, device=None):
    prompts = list(prompts) or ["ROMEO: "]
    params = load_gru_any(weights, qtype="q8_0", device=device)   # fused dequant+matmul path
    for text in generate_texts(params, prompts):
        print(text)
        print("--------")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("weights")
    ap.add_argument("prompts", nargs="*")
    ap.add_argument("--device", default=None, help="default cuda; 'cpu' without a GPU")
    a = ap.parse_args()
    main(a.weights, *a.prompts, device=a.device)
