#!/usr/bin/env python3
"""MobileViT feature extraction on the port: the reference's mobilevit
./main flow (the port's copy of ``examples/extract_features.py``).

    python3 examples/torch_extract_features.py path/to/weight.ggml [image.jpg]
    python3 examples/torch_extract_features.py --device cpu path/to/weight.ggml

Without an image it uses the reference's deterministic synthetic input, so
the printed vector is directly comparable. The transformer dense kernels are
quantized to q8_0 and the forward runs at bf16: on the card the fused
transformer layer (``csrc/transformer_layer.cu``) and the fused inverted
residual (``csrc/inverted_residual.cu``, ``csrc/inverted_residual_s2.cu``).
It runs on the GPU unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch

from ggml_experiments_tpu_torch.models.mobilevit import (
    MobileViTConfig,
    extract_features,
    load_mobilevit,
)
from ggml_experiments_tpu_torch.utils.image import load_and_preprocess, synthetic_test_image


def main(weights: str, image: str = None, device=None):
    config = MobileViTConfig()  # input resolution; the architecture is inferred
    params = load_mobilevit(weights, qtype="q8_0", device=device)
    img = load_and_preprocess(image) if image else synthetic_test_image(config.image_size)
    with torch.no_grad():
        feats = extract_features(params, torch.from_numpy(img)[None],
                                 compute_dtype=torch.bfloat16).cpu().numpy()
    print("feature shape:", feats.shape)
    vec = feats[0, 0, 0]
    print("first 5:", vec[:5], " last 5:", vec[-5:])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("weights")
    ap.add_argument("image", nargs="?", default=None)
    ap.add_argument("--device", default=None, help="default cuda; 'cpu' without a GPU")
    a = ap.parse_args()
    main(a.weights, a.image, device=a.device)
