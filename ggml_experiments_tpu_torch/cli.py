"""Command-line drivers of the port.

  python -m ggml_experiments_tpu_torch generate --weights gru.bin [--prompt "..."]
  python -m ggml_experiments_tpu_torch serve    --weights gru.bin
  python -m ggml_experiments_tpu_torch quantize --input gru.bin --output gru.q8.gxt
  python -m ggml_experiments_tpu_torch eval     --weights gru.bin [--corpus text.txt]
  python -m ggml_experiments_tpu_torch train-gru --corpus text.txt [--compute bfloat16]

``generate`` with no --prompt reads one line from stdin; ``serve`` reads one
prompt per line and streams each continuation. ``--weights`` takes the
reference gru.bin or a native ``.gxt`` checkpoint. All run on ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _add_common(p):
    from ggml_experiments_tpu_torch.quant.qtensor import QTYPES

    p.add_argument("--qtype", choices=list(QTYPES), default=None,
                   help="block-quantize matmul weights on load")
    p.add_argument("--compute", choices=["float32", "bfloat16"], default="float32",
                   help="matmul operand precision (products are summed in f32)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")


def cmd_generate(args) -> int:
    import torch

    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

    params = load_gru_any(args.weights, qtype=args.qtype, device=args.device)
    tok = CharTokenizer()
    prompts = args.prompt
    if not prompts:
        print("type: ", flush=True)
        prompts = [sys.stdin.readline().rstrip("\n")[:50]]
    ids, lengths = tok.encode_batch(prompts)
    gen = torch.Generator(device=params.device).manual_seed(args.seed)
    t0 = time.time()
    out = gru_textgen.generate(
        params, ids, lengths, args.steps, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, generator=gen, compute_dtype=args.compute,
    ).cpu()
    dt = time.time() - t0
    for row in out.tolist():
        print(tok.decode(row))
        print("--------")
    print(f"[{len(prompts)}x{args.steps} tokens in {dt:.2f}s = "
          f"{len(prompts) * args.steps / dt:,.0f} tokens/s]", file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    """Interactive continuous-batching service: prompts on stdin, one per line."""
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any
    from ggml_experiments_tpu_torch.serving import DecodeEngine
    from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

    params = load_gru_any(args.weights, qtype=args.qtype, device=args.device)
    tok = CharTokenizer()
    engine = DecodeEngine(
        params, n_slots=args.slots, max_prompt=args.max_prompt,
        inner_steps=args.inner_steps, compute_dtype=args.compute,
        temperature=args.temperature, fetch_depth=args.fetch_depth,
        fetch_async=args.fetch_async,
    )
    engine.start()
    print(f"serving with {args.slots} slots; type a prompt per line "
          f"(empty line or EOF to quit)", file=sys.stderr)
    try:
        while True:
            line = sys.stdin.readline()
            if not line or not line.strip("\n"):
                break
            req = engine.submit(
                tok.encode(line.rstrip("\n")[: args.max_prompt]), args.steps,
                on_token=lambda t: print(tok.decode([t]), end="", flush=True),
            )
            req.result(timeout=600)  # tokens already streamed above
            print("\n--------")
        s = engine.stats
        print(f"[{s.requests_completed} requests, {s.tokens_generated} tokens, "
              f"{s.tokens_per_s:,.0f} tokens/s]", file=sys.stderr)
    finally:
        engine.stop()
    return 0


def cmd_quantize(args) -> int:
    """Offline fp32 -> block-quantized native checkpoint, round to nearest."""
    from ggml_experiments_tpu_torch.formats import checkpoint
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params

    qtype = args.qtype or "q8_0"
    if qtype == "q4_k_m" or args.calibrate:
        raise NotImplementedError(
            "the calibrated q4_k_m recipe (quantize --calibrate) is not ported yet "
            "(ROADMAP.md, Queue A #11: calibration)")
    if not args.input.endswith(".bin"):
        raise NotImplementedError(
            "quantize takes a GRU gru.bin; MobileViT weight.ggml inputs are not ported yet "
            "(ROADMAP.md, 'Port: still to port', item 6: MobileViT)")
    tree = load_gru_params(args.input, qtype=qtype, device=args.device)
    checkpoint.save(args.output, tree)
    ratio = os.path.getsize(args.input) / os.path.getsize(args.output)
    print(json.dumps({
        "input": args.input, "output": args.output, "qtype": qtype,
        "compression_vs_input": round(ratio, 2),
    }))
    return 0


def cmd_eval(args) -> int:
    """Quantization-delta report: quantized vs fp32 on the same GRU weights."""
    import numpy as np

    from ggml_experiments_tpu_torch import evaluation
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any

    qtype = args.qtype or "q8_0"
    rng = np.random.default_rng(args.seed)
    if not args.weights.endswith((".bin", ".gxt")):
        raise NotImplementedError(
            "eval takes GRU weights (gru.bin or .gxt); MobileViT weights are not ported yet "
            "(ROADMAP.md, 'Port: still to port', item 6: MobileViT)")
    ref = load_gru_any(args.weights, device=args.device)
    q = load_gru_any(args.weights, qtype=qtype, device=args.device)
    v = ref.embeddings.shape[0]
    if args.corpus:
        # held-out text: the deltas on real next-token distributions
        from ggml_experiments_tpu_torch.training.data import (
            DataConfig,
            load_corpus,
            make_examples,
        )
        from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

        ex = make_examples(load_corpus(args.corpus), CharTokenizer(),
                           DataConfig(seq_length=args.length))
        seqs = ex[rng.permutation(len(ex))[: args.batch]]
    else:
        seqs = rng.integers(0, v, (args.batch, args.length + 1)).astype(np.int32)
    rep = evaluation.eval_gru_delta(ref, q, seqs)
    print(json.dumps({"qtype": qtype, **rep.as_dict()}))
    return 0


def cmd_train_gru(args) -> int:
    """Train the char GRU on a text file; prints a JSON summary."""
    from ggml_experiments_tpu_torch.device import resolve_dtype
    from ggml_experiments_tpu_torch.formats.gru_bin import save_gru_params
    from ggml_experiments_tpu_torch.models.gru_textgen import GRUConfig
    from ggml_experiments_tpu_torch.training import TrainConfig, train_from_text
    from ggml_experiments_tpu_torch.training.data import DataConfig, load_corpus

    text = load_corpus(args.corpus)
    params, history, _ = train_from_text(
        text,
        model_config=GRUConfig(embed_dim=args.embed_dim, units=args.units),
        train_config=TrainConfig(
            epochs=args.epochs, checkpoint_path=args.checkpoint,
            log_every=args.log_every, eval_every=args.eval_every,
            compute_dtype=resolve_dtype(args.compute),
            resume_path=args.resume, save_every=args.save_every,
        ),
        data_config=DataConfig(seq_length=args.seq_length, batch_size=args.batch_size),
        seed=args.seed,
        device=args.device,
        eval_text=load_corpus(args.eval_corpus) if args.eval_corpus else None,
    )
    if args.output:
        save_gru_params(args.output, params)
        print(f"exported weights to {args.output} (reference gru.bin format)")
    if history:
        summary = {"final_loss": history[-1]["loss"], "steps": history[-1]["step"]}
        val = [h["val_ppl"] for h in history if "val_ppl" in h]
        if val:
            summary["final_val_ppl"] = val[-1]
    else:  # resumed past the end of the stream: a completed run is a no-op
        summary = {"resumed_complete": True}
    print(json.dumps(summary))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ggml_experiments_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="GRU text generation")
    g.add_argument("--weights", required=True, help="gru.bin or .gxt checkpoint")
    g.add_argument("--prompt", action="append", help="prompt (repeat for a batch)")
    g.add_argument("--steps", type=int, default=200, help="total decode steps")
    g.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    g.add_argument("--top-k", type=int, default=None, help="sample from k best")
    g.add_argument("--top-p", type=float, default=None, help="nucleus sampling mass")
    g.add_argument("--seed", type=int, default=0)
    _add_common(g)
    g.set_defaults(fn=cmd_generate)

    s = sub.add_parser("serve", help="interactive continuous-batching text service")
    s.add_argument("--weights", required=True, help="gru.bin or .gxt checkpoint")
    s.add_argument("--slots", type=int, default=16)
    s.add_argument("--max-prompt", type=int, default=64)
    s.add_argument("--inner-steps", type=int, default=16)
    s.add_argument("--steps", type=int, default=200, help="max new tokens per request")
    s.add_argument("--temperature", type=float, default=0.0)
    s.add_argument("--fetch-depth", type=int, default=2,
                   help="token readbacks allowed in flight behind the ticks")
    s.add_argument("--fetch-async", action=argparse.BooleanOptionalAction, default=False,
                   help="drain token readbacks on a parallel reader thread")
    _add_common(s)
    s.set_defaults(fn=cmd_serve)

    q = sub.add_parser("quantize",
                       help="offline fp32 -> block-quantized native checkpoint")
    q.add_argument("--input", required=True, help="gru.bin")
    q.add_argument("--output", required=True, help="output .gxt path")
    q.add_argument("--calibrate", default=None, metavar="CORPUS",
                   help="calibrated quantization (not ported yet)")
    _add_common(q)
    # the calibrated mixed recipe is a quantize-time option, not a QTensor format
    for a in q._actions:
        if a.dest == "qtype":
            a.choices = list(a.choices) + ["q4_k_m"]
    q.set_defaults(fn=cmd_quantize)

    e = sub.add_parser("eval", help="quantization-delta report (logits/top-1/ppl vs fp32)")
    e.add_argument("--weights", required=True, help="gru.bin or .gxt checkpoint")
    e.add_argument("--batch", type=int, default=8)
    e.add_argument("--length", type=int, default=64, help="sequence length")
    e.add_argument("--corpus", default=None,
                   help="held-out text (default: random token sequences)")
    e.add_argument("--seed", type=int, default=0)
    _add_common(e)
    e.set_defaults(fn=cmd_eval)

    t = sub.add_parser("train-gru", help="train the char GRU on a text file")
    t.add_argument("--corpus", required=True, help="text file (e.g. shakespeare.txt)")
    t.add_argument("--epochs", type=int, default=20)
    t.add_argument("--seq-length", type=int, default=100)
    t.add_argument("--batch-size", type=int, default=64)
    t.add_argument("--embed-dim", type=int, default=256)
    t.add_argument("--units", type=int, default=1024)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--log-every", type=int, default=50)
    t.add_argument("--checkpoint", default=None, help="best-by-loss .gxt path")
    t.add_argument("--resume", default=None,
                   help="full train-state .gxt (params+Adam+step): written every "
                        "--save-every steps, and an existing file resumes the "
                        "interrupted run bit-exactly")
    t.add_argument("--save-every", type=int, default=0,
                   help="steps between train-state saves (needs --resume)")
    t.add_argument("--output", default=None, help="export final weights as gru.bin")
    t.add_argument("--eval-corpus", default=None, help="held-out text for val ppl")
    t.add_argument("--eval-every", type=int, default=0,
                   help="validation ppl every N steps (needs --eval-corpus)")
    _add_common(t)
    t.set_defaults(fn=cmd_train_gru)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
