#!/usr/bin/env python3
"""Convert a HuggingFace MobileViT checkpoint to the reference weight.ggml
format, through the port only (the port's copy of
``tools/convert_hf_mobilevit.py``, torch backend).

The ``transformers`` torch model's state_dict tensors are renamed and laid
out again as the TF variable paths and shapes that the format (and the
port's loader, ``models/mobilevit.from_named_tensors``) expects:

  torch conv weight (OC, IC, KH, KW)      -> TF (KH, KW, IC, OC)
  torch depthwise  (C, 1, KH, KW)         -> TF grouped (KH, KW, 1, C)
  torch linear weight (OUT, IN)           -> TF kernel (IN, OUT)
  module dots                             -> TF name path + ":0"

The file is written by ``formats/ggml_named.write_named_tensors``; it is
byte-equal to the JAX tool's for the same model.

    python3 tools/torch_convert_hf_mobilevit.py apple/mobilevit-small weight.ggml
    python3 tools/torch_convert_hf_mobilevit.py --classifier /path/to/hf_dir weight.ggml
    python3 tools/torch_convert_hf_mobilevit.py --device cpu /path/to/hf_dir weight.ggml

The model is loaded onto ``--device`` (default ``cuda``: without a GPU the
tool raises unless ``--device cpu`` is given) and its tensors are read back
from there. ``--backend tf`` (the TF MobileViT of ``transformers``) needs
TensorFlow, which the port does not use: the tool says so and returns 2.
``transformers`` is imported inside :func:`main`.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

TF_ROOT = {
    "MobileViTModel": "tf_mobile_vi_t_model",
    "MobileViTForImageClassification": "tf_mobile_vi_t_for_image_classification",
}


def torch_name_to_tf(name: str, root: str):
    """torch module path -> (root, TF path base, param kind).

    Dots become '/', except before a ModuleList index, which TF renders as
    'layer.N' (torch ``encoder.layer.2.transformer.layer.0`` -> TF
    ``encoder/layer.2/transformer/layer.0``).
    """
    n = name
    if n.endswith(".weight"):
        base, leaf = n[: -len(".weight")], "weight"
    elif n.endswith(".bias"):
        base, leaf = n[: -len(".bias")], "bias"
    elif n.endswith(".running_mean"):
        base, leaf = n[: -len(".running_mean")], "moving_mean"
    elif n.endswith(".running_var"):
        base, leaf = n[: -len(".running_var")], "moving_variance"
    else:
        base, leaf = n, ""
    parts = []
    for seg in base.split("."):
        if seg.isdigit() and parts:
            parts[-1] = f"{parts[-1]}.{seg}"
        else:
            parts.append(seg)
    return root, "/".join(parts), leaf


def convert_torch(model) -> list:
    """[(TF variable name, float32 array)] of a ``transformers`` MobileViT
    (``MobileViTModel`` or ``MobileViTForImageClassification``), in its
    state_dict's order."""
    root = TF_ROOT.get(type(model).__name__, "tf_mobile_vi_t_model")
    out = []
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        arr = t.detach().cpu().numpy().astype(np.float32)
        _, base, leaf = torch_name_to_tf(name, root)
        # a bare MobileViTModel's params are not nested under 'mobilevit.' in
        # torch, but TF nests the backbone either way
        if not base.startswith(("mobilevit", "classifier")):
            base = "mobilevit/" + base
        is_bn = "normalization" in base.split("/")[-1] or base.endswith("normalization")
        if leaf == "weight":
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)  # -> (KH, KW, IC/groups, OC)
                tf_leaf = "kernel"
            elif arr.ndim == 2:
                arr = arr.transpose(1, 0)        # torch (out, in) -> TF (in, out)
                tf_leaf = "kernel"
            else:                                # a batch or layer norm's scale
                tf_leaf = "gamma"
        elif leaf == "bias":
            tf_leaf = "beta" if (is_bn or "layernorm" in base) else "bias"
        else:
            tf_leaf = leaf
        out.append((f"{root}/{base}/{tf_leaf}:0", arr))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("model", help="HF model id or local path (e.g. apple/mobilevit-small)")
    ap.add_argument("output", help="output weight.ggml path")
    ap.add_argument("--backend", choices=["torch", "tf"], default="torch")
    ap.add_argument("--classifier", action="store_true",
                    help="export MobileViTForImageClassification (with head)")
    ap.add_argument("--device", default=None,
                    help="where the model is loaded (default cuda; 'cpu' to run without a GPU)")
    args = ap.parse_args(argv)

    if args.backend == "tf":
        print("--backend tf needs TensorFlow's MobileViT, which the port does not use; "
              "use the torch backend (the default)", file=sys.stderr)
        return 2
    from ggml_experiments_tpu_torch.device import resolve_device
    from ggml_experiments_tpu_torch.formats.ggml_named import write_named_tensors

    dev = resolve_device(args.device)
    from transformers import MobileViTForImageClassification, MobileViTModel

    cls = MobileViTForImageClassification if args.classifier else MobileViTModel
    model = cls.from_pretrained(args.model).to(dev)
    tensors = convert_torch(model)
    write_named_tensors(args.output, tensors)
    print(f"wrote {args.output}: {len(tensors)} tensors, "
          f"{os.path.getsize(args.output):,} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
