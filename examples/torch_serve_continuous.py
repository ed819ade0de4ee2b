#!/usr/bin/env python3
"""Continuous-batching text-generation service on the port (the port's copy
of ``examples/serve_continuous.py``).

A fixed pool of decode slots on the device; requests stream in from any
thread and share the card without restarting the batch. On the card 32
slots x 16 inner steps at bf16 run the persistent kernel's fused tick
(``csrc/gru_persistent.cu``).

    python3 examples/torch_serve_continuous.py path/to/gru.bin
    python3 examples/torch_serve_continuous.py --device cpu path/to/gru.bin

It runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch

from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any
from ggml_experiments_tpu_torch.serving import DecodeEngine
from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

PROMPTS = ("ROMEO: ", "KING HENRY ", "First Citizen:\n", "QUEEN: ")
N_SLOTS, MAX_PROMPT, INNER_STEPS = 32, 64, 16
MAX_NEW_TOKENS = 120


def serve(params):
    """(each of PROMPTS' texts, the engine's stats) from an engine of N_SLOTS
    slots x INNER_STEPS inner steps at bf16, the requests submitted together."""
    tok = CharTokenizer()
    engine = DecodeEngine(params, n_slots=N_SLOTS, max_prompt=MAX_PROMPT,
                          inner_steps=INNER_STEPS, compute_dtype=torch.bfloat16)
    engine.start()
    try:
        requests = [engine.submit(tok.encode(p), max_new_tokens=MAX_NEW_TOKENS)
                    for p in PROMPTS]
        texts = [tok.decode(req.result(timeout=300)) for req in requests]
        return texts, engine.stats
    finally:
        engine.stop()


def main(weights: str, device=None):
    params = load_gru_any(weights, qtype="q8_0", device=device)
    texts, s = serve(params)
    for text in texts:
        print(text)
        print("--------")
    print(f"{s.requests_completed} requests, {s.tokens_generated} tokens, "
          f"{s.tokens_per_s:,.0f} tokens/s device throughput")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("weights")
    ap.add_argument("--device", default=None, help="default cuda; 'cpu' without a GPU")
    a = ap.parse_args()
    main(a.weights, device=a.device)
