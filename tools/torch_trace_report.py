#!/usr/bin/env python3
"""Per-kernel device-time report of the port's two model forwards.

Where the time goes below the whole-call numbers: traces ``reps`` calls
with ``torch.profiler`` and prints the aggregated top-kernel table, the
port's hand-written kernels under their launch counters' names
(``utils/trace_report.kernel_name``) beside cuDNN's, cuBLAS's and PyTorch's
own kernels. Run from the root of a checkout, on the card:

    python3 tools/torch_trace_report.py --model mobilevit --batch 128
    python3 tools/torch_trace_report.py --model mobilevit --batch 128 --image-size 512
    python3 tools/torch_trace_report.py --model gru --batch 1024 --steps 256

MobileViT runs ``extract_features`` on random full-size weights at
``--compute`` (bf16 by default, with every kernel route the card takes);
the GRU runs ``decode`` (bf16: the persistent kernel from B = 64, T = 64 on
block-quantized weights) on random full-size weights. ``--device cpu``
runs the plain versions and reports PyTorch's CPU operators.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=["gru", "mobilevit"], default="mobilevit")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=256, help="decode steps (gru)")
    ap.add_argument("--qtype", default="q8_0", choices=["q8_0", "q4_0", "none"])
    ap.add_argument("--compute", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--image-size", type=int, default=256, help="mobilevit: a multiple of 64")
    ap.add_argument("--act-storage", default=None,
                    choices=["f8_e5m2", "f8_e4m3", "bfloat16"],
                    help="sub-bf16 conv activation storage (mobilevit only)")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--logdir", default=None, help="keep the raw trace here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.device import resolve_device
    from ggml_experiments_tpu_torch.utils.trace_report import format_report, trace_and_report

    dev = resolve_device(args.device)
    qtype = None if args.qtype == "none" else args.qtype
    rng = np.random.default_rng(0)
    if args.model == "mobilevit":
        from ggml_experiments_tpu_torch.models.mobilevit import (
            MobileViTConfig,
            extract_features,
            from_named_tensors,
            random_named_tensors,
        )
        from ggml_experiments_tpu_torch.utils.image import synthetic_test_image

        cfg = MobileViTConfig(image_size=args.image_size)
        params = from_named_tensors(random_named_tensors(cfg), cfg, qtype=qtype,
                                    act_storage=args.act_storage, device=dev)
        images = torch.from_numpy(
            np.stack([synthetic_test_image(cfg.image_size)] * args.batch)).to(dev)
        rows = trace_and_report(extract_features, params, images, reps=args.reps,
                                logdir=args.logdir, compute_dtype=args.compute)
    else:
        from ggml_experiments_tpu_torch.models import gru_textgen
        from ggml_experiments_tpu_torch.models.gru_textgen import GRUConfig
        from ggml_experiments_tpu_torch.ops.gru import GRUCellParams
        from ggml_experiments_tpu_torch.quant import quantize

        cfg = GRUConfig()
        v, e, u = cfg.vocab_size, cfg.embed_dim, cfg.units

        def mk(shape):
            return (rng.standard_normal(shape) * 0.05).astype(np.float32)

        def w(a):
            return quantize(a, qtype, device=dev) if qtype else torch.from_numpy(a).to(dev)

        params = gru_textgen.GRUTextGenParams(
            embeddings=torch.from_numpy(mk((v, e))).to(dev),
            cell=GRUCellParams(kernel=w(mk((e, 3 * u))), recurrent_kernel=w(mk((u, 3 * u))),
                               bias=torch.from_numpy(mk((2, 3 * u))).to(dev)),
            dense_kernel=w(mk((u, v))),
            dense_bias=torch.zeros((v,), dtype=torch.float32, device=dev),
        )
        prompt = torch.from_numpy(rng.integers(0, v, (args.batch, 8)).astype(np.int32)).to(dev)
        lengths = torch.full((args.batch,), 8, dtype=torch.int32, device=dev)
        rows = trace_and_report(gru_textgen.decode, params, prompt, lengths, args.steps,
                                reps=args.reps, logdir=args.logdir,
                                compute_dtype=args.compute)

    print(format_report(rows, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
