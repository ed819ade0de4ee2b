#!/usr/bin/env python3
"""One-command reproduction of the reference's published golden vector,
through the port only (the port's copy of ``tools/verify_reference_golden.py``).

The reference's one external correctness anchor is the feature printout of
its mobilevit README: apple/mobilevit-small on the deterministic synthetic
image yields features of shape (8, 8, 640) whose channel values at
(i0=0, i1=0) start with ``3.48242, 4.40234, ...`` and end with
``..., 2.98828, 3.67578``.

    python3 tools/torch_verify_reference_golden.py                 # download + verify
    python3 tools/torch_verify_reference_golden.py --model /path   # local checkpoint
    python3 tools/torch_verify_reference_golden.py --keep w.ggml   # also keep the export
    python3 tools/torch_verify_reference_golden.py --device cpu    # without a GPU

Pipeline: HF load (``transformers``' torch MobileViT) -> convert to the
reference weight.ggml format (``tools/torch_convert_hf_mobilevit.py``) ->
:func:`features_from_named`: load with the reference's f16-conv policy
(``conv_dtype='float16'``), the unfused layers (no flash attention, no fused
transformer layer, no fused inverted residual: the JAX tool's defaults, which
the port's CUDA defaults are not) -> synthetic 256 px image -> f32
``extract_features`` on ``--device`` (default ``cuda``; without a GPU the tool
raises unless ``--device cpu`` is given) -> the first and last 5 channels
against the README vector.

Exit 0 = anchor reproduced; 1 = mismatch; 2 = could not load the model
(no ``transformers``, the hub unreachable, no such directory).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

# the reference README's vector (printed by print_features_d2 at the f16-conv
# load policy): first and last 5 of the 640 channels at spatial (0, 0)
GOLDEN = {"first5": (3.48242, 4.40234, 4.73047, 1.98438, 3.5293),
          "last5": (4.39844, 4.08203, 2.45703, 2.98828, 3.67578),
          "shape": (8, 8, 640)}


def convert_checkpoint(model_path: str, *, keep: str | None = None) -> dict:
    """HF checkpoint -> weight.ggml (kept at ``keep``) -> its named tensors."""
    from transformers import MobileViTModel

    from ggml_experiments_tpu_torch.formats.ggml_named import (
        read_named_tensors,
        write_named_tensors,
    )
    from tools.torch_convert_hf_mobilevit import convert_torch

    model = MobileViTModel.from_pretrained(model_path).eval()
    tensors = convert_torch(model)
    del model
    with tempfile.TemporaryDirectory() as d:
        path = keep or os.path.join(d, "weight.ggml")
        write_named_tensors(path, tensors)
        print(f"converted -> {path} ({len(tensors)} tensors, "
              f"{os.path.getsize(path):,} bytes)")
        return read_named_tensors(path)


def features_from_named(named: dict, *, image_size: int = 256, device=None) -> np.ndarray:
    """Named tensors -> the synthetic image's f32 features (H/32, W/32, C)
    at the reference's load policy, computed on ``device``."""
    import torch

    from ggml_experiments_tpu_torch.models.mobilevit import (
        extract_features,
        from_named_tensors,
        infer_config,
    )
    from ggml_experiments_tpu_torch.utils.image import synthetic_test_image

    config = infer_config(named, image_size=image_size)
    params = from_named_tensors(named, config, conv_dtype="float16", flash_attn=False,
                                fused_layer=False, fused_ir=False, device=device)
    img = torch.from_numpy(synthetic_test_image(image_size))[None]
    with torch.no_grad():
        return extract_features(params, img).cpu().numpy()[0]


def verify(feats: np.ndarray, *, atol: float, golden: dict = GOLDEN) -> dict:
    want_first5 = np.array(golden["first5"], np.float64)
    want_last5 = np.array(golden["last5"], np.float64)
    got_first5 = feats[0, 0, :5].astype(np.float64)
    got_last5 = feats[0, 0, -5:].astype(np.float64)
    d_first = np.abs(got_first5 - want_first5)
    d_last = np.abs(got_last5 - want_last5)
    shape_ok = feats.shape == tuple(golden["shape"])
    return {
        "shape": list(feats.shape),
        "shape_ok": shape_ok,
        "got_first5": [round(float(v), 5) for v in got_first5],
        "got_last5": [round(float(v), 5) for v in got_last5],
        "want_first5": list(golden["first5"]),
        "want_last5": list(golden["last5"]),
        "max_abs_diff": float(max(d_first.max(), d_last.max())),
        "ok": bool(shape_ok and d_first.max() <= atol and d_last.max() <= atol),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="apple/mobilevit-small",
                    help="HF model id or local checkpoint dir")
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--keep", default=None,
                    help="also keep the converted weight.ggml at this path")
    ap.add_argument("--atol", type=float, default=0.05,
                    help="per-channel tolerance vs the README vector "
                         "(it is printed from an f16-conv ggml run; "
                         "~2 decimals are meaningful)")
    ap.add_argument("--golden", default=None,
                    help="JSON {'first5': [...], 'last5': [...], 'shape': "
                         "[...]} overriding the README vector (used by the "
                         "offline mock test)")
    ap.add_argument("--device", default=None,
                    help="where the features are computed (default cuda; 'cpu' "
                         "to run without a GPU)")
    args = ap.parse_args(argv)
    golden = json.loads(args.golden) if args.golden else GOLDEN

    from ggml_experiments_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    try:
        named = convert_checkpoint(args.model, keep=args.keep)
    except ImportError as ex:   # transformers is not installed
        print(f"could not load {args.model!r}: transformers cannot be imported ({ex})",
              file=sys.stderr)
        return 2
    except (OSError, ValueError) as ex:   # hub unreachable / model dir missing
        # (huggingface_hub raises HFValidationError (a ValueError) for a
        # nonexistent local path, OSError for a network or auth failure)
        print(f"could not load {args.model!r}: {ex}", file=sys.stderr)
        print("(the download path needs huggingface.co; pass --model <local-dir> "
              "to use a pre-downloaded checkpoint)", file=sys.stderr)
        return 2
    feats = features_from_named(named, image_size=args.image_size, device=dev)
    report = verify(feats, atol=args.atol, golden=golden)
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
