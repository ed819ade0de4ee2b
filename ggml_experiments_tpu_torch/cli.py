"""Command-line drivers of the port.

  python -m ggml_experiments_tpu_torch generate --weights gru.bin [--prompt "..."]
  python -m ggml_experiments_tpu_torch serve    --weights gru.bin

``generate`` with no --prompt reads one line from stdin; ``serve`` reads one
prompt per line and streams each continuation. Both run on ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import sys
import time


def _add_common(p):
    p.add_argument("--qtype", choices=["q8_0"], default=None,
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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ggml_experiments_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="GRU text generation")
    g.add_argument("--weights", required=True, help="gru.bin (reference format)")
    g.add_argument("--prompt", action="append", help="prompt (repeat for a batch)")
    g.add_argument("--steps", type=int, default=200, help="total decode steps")
    g.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    g.add_argument("--top-k", type=int, default=None, help="sample from k best")
    g.add_argument("--top-p", type=float, default=None, help="nucleus sampling mass")
    g.add_argument("--seed", type=int, default=0)
    _add_common(g)
    g.set_defaults(fn=cmd_generate)

    s = sub.add_parser("serve", help="interactive continuous-batching text service")
    s.add_argument("--weights", required=True, help="gru.bin (reference format)")
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
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
