#!/usr/bin/env python3
"""Train the char GRU on the port and export reference-format weights (the
port's copy of ``examples/train_and_export.py``).

The reference's training script end to end: corpus -> seq-100 batches ->
Adam + sparse cross-entropy -> best-by-loss checkpoint -> a gru.bin that
the reference's C++ loader reads. On the card the f32 steps run the fused
train pair (``csrc/gru_train_f32.cu``).

    python3 examples/torch_train_and_export.py corpus.txt out/gru.bin [epochs]
    python3 examples/torch_train_and_export.py --device cpu corpus.txt out/gru.bin 1

It runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from ggml_experiments_tpu_torch.formats.gru_bin import save_gru_params
from ggml_experiments_tpu_torch.training import TrainConfig, train_from_text
from ggml_experiments_tpu_torch.training.data import load_corpus


def main(corpus: str, out_path: str, epochs: str = "20", device=None):
    text = load_corpus(corpus)
    params, history, _ = train_from_text(
        text,
        train_config=TrainConfig(epochs=int(epochs), checkpoint_path=out_path + ".best.gxt"),
        device=device,
    )
    save_gru_params(out_path, params)
    print(f"final loss {history[-1]['loss']:.4f}; wrote {out_path} "
          f"(+ best checkpoint {out_path}.best.gxt)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("corpus")
    ap.add_argument("out_path")
    ap.add_argument("epochs", nargs="?", default="20")
    ap.add_argument("--device", default=None, help="default cuda; 'cpu' without a GPU")
    a = ap.parse_args()
    main(a.corpus, a.out_path, a.epochs, device=a.device)
