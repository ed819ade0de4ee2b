"""Command-line drivers of the port.

  python -m ggml_experiments_tpu_torch generate --weights gru.bin [--prompt "..."]
  python -m ggml_experiments_tpu_torch serve    --weights gru.bin [--http PORT --host ADDR]
  python -m ggml_experiments_tpu_torch serve-vision --weights weight.ggml --http PORT
  python -m ggml_experiments_tpu_torch bench    --model gru|mobilevit [--weights ...]
  python -m ggml_experiments_tpu_torch quantize --input gru.bin --output gru.q8.gxt
  python -m ggml_experiments_tpu_torch quantize --input gru.bin --output gru.q4km.gxt \
      --qtype q4_k_m --calibrate corpus.txt
  python -m ggml_experiments_tpu_torch quantize --input weight.ggml --output vit.q4km.gxt \
      --qtype q4_k_m --calibrate task
  python -m ggml_experiments_tpu_torch eval     --weights gru.bin [--corpus text.txt]
  python -m ggml_experiments_tpu_torch eval     --weights weight.ggml --image-size 64
  python -m ggml_experiments_tpu_torch train-gru --corpus text.txt [--compute bfloat16]
  python -m ggml_experiments_tpu_torch features --weights weight.ggml [--image img.png]
  python -m ggml_experiments_tpu_torch classify --weights mobilevit.ggml [--image img.png]

``generate`` with no --prompt reads one line from stdin; ``serve`` reads one
prompt per line and streams each continuation, or with ``--http`` serves the
JSON API of ``serving/http.py`` until SIGINT or SIGTERM; ``serve-vision``
serves the image endpoints of the same front end over a ``VisionEngine``.
``bench`` prints one JSON line of throughput under the port's timing
protocol (``utils/benchmarking.py``). ``--weights`` takes the
reference gru.bin or a native ``.gxt`` checkpoint for the GRU commands, and a
``weight.ggml`` named-tensor file or a MobileViT ``.gxt`` for ``features`` and
``classify`` (without --image they run on the reference's synthetic image).
``quantize`` takes a gru.bin or a weight.ggml and writes a ``.gxt``; with
``--qtype q4_k_m --calibrate`` it runs the GPTQ recipe (``quant/calibration``)
on text (GRU) or images (MobileViT: a directory, or ``task[:seed]`` for the
repo's synthetic task). ``eval`` reports the quantized model's deltas
against f32 on the same weights. All run on ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions).
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
    if args.http is not None:
        from ggml_experiments_tpu_torch.serving.http import HttpFrontend

        front = HttpFrontend(engine, tok, host=args.host, port=args.http)
        front.start()
        print(f"serving HTTP on {args.host}:{front.port} ({args.slots} slots; "
              f"POST /v1/generate, GET /v1/health)", file=sys.stderr, flush=True)
        _serve_until_signal(front, engine)
        return 0
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


def _calibration_images(source: str, image_size: int, n: int):
    """Calibration images for vision quantization: a directory of image files,
    or 'task'[:seed] for the repo's synthetic task distribution (the right
    one for the committed trained checkpoints; its full-size contrast at 256
    px and above)."""
    import numpy as np

    if source.startswith("task"):
        from ggml_experiments_tpu_torch.training.image_task import FULL_AMP_FACTOR, make_dataset

        seed = int(source.split(":", 1)[1]) if ":" in source else 1234
        amp = FULL_AMP_FACTOR if image_size >= 256 else 1.0
        x, _ = make_dataset(n, seed=seed, image_size=image_size, amp_factor=amp)
        return x
    if os.path.isdir(source):
        from ggml_experiments_tpu_torch.utils.image import load_and_preprocess

        files = sorted(
            os.path.join(source, f) for f in os.listdir(source)
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".tga", ".gif"))
        )[:n]
        if not files:
            raise ValueError(f"no images found in {source}")
        return np.stack([load_and_preprocess(f, image_size) for f in files])
    raise ValueError(f"--calibrate {source!r}: not a directory or 'task[:seed]'")


def _quantize_calibrated(args, qtype: str):
    """(tree, meta, quantized weights) of the calibrated recipes."""
    import numpy as np

    from ggml_experiments_tpu_torch.quant import calibration

    if args.input.endswith(".bin"):
        from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
        from ggml_experiments_tpu_torch.training.data import (
            DataConfig,
            load_corpus,
            make_examples,
        )
        from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

        base = load_gru_params(args.input, device=args.device)
        ex = make_examples(load_corpus(args.calibrate), CharTokenizer(),
                           DataConfig(seq_length=100))
        sel = np.random.default_rng(0).permutation(len(ex))[: args.calibrate_seqs]
        if qtype == "q4_k_m":
            tree = calibration.gptq_gru_params(base, ex[sel])
        else:
            tree = calibration.calibrated_gru_params(base, ex[sel], qtype=qtype)
        meta = {"kind": "gru", "qtype": qtype, "calibrated": True}
        return tree, meta, [tree.cell.kernel, tree.cell.recurrent_kernel, tree.dense_kernel]
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
    from ggml_experiments_tpu_torch.models.mobilevit import from_named_tensors, infer_config

    named = read_named_tensors(args.input)
    cfg = infer_config(named)
    images = _calibration_images(args.calibrate, cfg.image_size, args.calibrate_seqs)
    # the Grams come off the unfused float forward (the taps live in
    # ops/linear); the saved tree is a plain params tree that load_mobilevit
    # loads under any route flags
    tree = from_named_tensors(named, cfg, flash_attn=False, fused_layer=False,
                              device=args.device)
    tree = calibration.gptq_mobilevit_params(
        tree, calibration.collect_mobilevit_grams(tree, images))
    return tree, _vision_meta(cfg, tree, qtype, True), [
        getattr(holder, field) for _, holder, field in calibration._vision_quantizable(tree)]


def _vision_meta(cfg, tree, qtype: str, calibrated: bool) -> dict:
    import dataclasses

    return {"kind": "mobilevit", "qtype": qtype, "calibrated": calibrated,
            "config": dataclasses.asdict(cfg), "classifier": tree.classifier_kernel is not None}


def cmd_quantize(args) -> int:
    """Offline fp32 -> block-quantized native checkpoint: round to nearest, or
    a calibrated recipe with ``--calibrate``."""
    from ggml_experiments_tpu_torch.formats import checkpoint

    qtype = args.qtype or "q8_0"
    gru = args.input.endswith(".bin")
    if qtype == "q4_k_m" or args.calibrate:
        # GPTQ-compensated q4_k on the bulk weights and GPTQ q8_0 on the
        # logits-producing head; the GRU calibrates on text, MobileViT on images
        if not args.calibrate:
            print("--qtype q4_k_m needs --calibrate (GRU: a text corpus; MobileViT: an image "
                  "directory or 'task' for the repo's synthetic task)", file=sys.stderr)
            return 2
        if not gru and qtype != "q4_k_m":
            # the one calibrated recipe for MobileViT is q4_k_m: any other
            # --qtype would name a format the file does not hold
            print(f"--calibrate with a MobileViT weight.ggml runs the GPTQ q4_k_m recipe; "
                  f"pass --qtype q4_k_m (got {qtype})", file=sys.stderr)
            return 2
        tree, meta, qts = _quantize_calibrated(args, qtype)
        checkpoint.save(args.output, tree, meta=meta)
        n_weights = sum(t.shape[0] * t.shape[1] for t in qts)
        bits_stored = 8.0 * sum(t.stored_nbytes for t in qts) / n_weights
        bits_hbm = 8.0 * sum(t.nbytes for t in qts) / n_weights
        ratio = os.path.getsize(args.input) / os.path.getsize(args.output)
        print(json.dumps({
            "input": args.input, "output": args.output, "qtype": qtype,
            "calibrated": True, "bits_per_weight": round(bits_stored, 3),
            "bits_per_weight_hbm": round(bits_hbm, 3),
            "compression_vs_input": round(ratio, 2),
        }))
        return 0
    if gru:
        from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params

        checkpoint.save(args.output, load_gru_params(args.input, qtype=qtype, device=args.device))
    else:
        from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
        from ggml_experiments_tpu_torch.models.mobilevit import from_named_tensors, infer_config

        named = read_named_tensors(args.input)
        cfg = infer_config(named)
        tree = from_named_tensors(named, cfg, qtype=qtype, device=args.device)
        # the meta makes the file loadable by load_mobilevit and the vision commands
        checkpoint.save(args.output, tree, meta=_vision_meta(cfg, tree, qtype, False))
    ratio = os.path.getsize(args.input) / os.path.getsize(args.output)
    print(json.dumps({
        "input": args.input, "output": args.output, "qtype": qtype,
        "compression_vs_input": round(ratio, 2),
    }))
    return 0


def _eval_mobilevit(args, qtype: str) -> dict:
    """The vision half of ``eval``: deltas on the synthetic image, and for a
    checkpoint with a head the top-1 block on the task's held-out images."""
    import numpy as np

    from ggml_experiments_tpu_torch import evaluation
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
    from ggml_experiments_tpu_torch.models.mobilevit import from_named_tensors, infer_config
    from ggml_experiments_tpu_torch.utils.image import synthetic_test_image

    tensors = read_named_tensors(args.weights)
    config = infer_config(tensors, image_size=args.image_size,
                          num_attention_heads=args.num_heads)
    ref = from_named_tensors(tensors, config, device=args.device)
    q = from_named_tensors(tensors, config, qtype=qtype, device=args.device)
    imgs = np.stack([synthetic_test_image(config.image_size)] * args.batch)
    out = {"qtype": qtype, **evaluation.eval_mobilevit_delta(ref, q, imgs).as_dict()}
    if ref.classifier_kernel is not None:
        # q-vs-f32 agreement on the task's held-out gratings, and accuracy
        # when the head is the task's (the label spaces match); the images
        # are made at the task's base contrast at every size, as the JAX
        # command makes them (ROADMAP.md, Queue C)
        from ggml_experiments_tpu_torch.training.image_task import (
            HELDOUT_SEED,
            NUM_CLASSES,
            make_dataset,
            top1,
        )

        test_x, test_y = make_dataset(max(args.batch, 64), seed=HELDOUT_SEED,
                                      image_size=config.image_size)
        pr, pq = top1(ref, test_x), top1(q, test_x)
        out["top1_agreement"] = float((pr == pq).mean())
        if config.num_labels == NUM_CLASSES:
            out["top1_f32"] = float((pr == test_y).mean())
            out["top1_q"] = float((pq == test_y).mean())
            out["dtop1"] = out["top1_f32"] - out["top1_q"]
    return out


def cmd_eval(args) -> int:
    """Quantization-delta report: quantized vs fp32 on the same weights (a GRU
    gru.bin / .gxt, or a MobileViT weight.ggml)."""
    import numpy as np

    from ggml_experiments_tpu_torch import evaluation
    from ggml_experiments_tpu_torch.formats import checkpoint
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any

    qtype = args.qtype or "q8_0"
    rng = np.random.default_rng(args.seed)
    if args.weights.endswith(".gxt") and checkpoint.read_meta(args.weights).get(
            "kind") == "mobilevit":
        print("eval compares quantized vs fp32 of the SAME weights; a quantized-only .gxt has "
              "no fp32 twin: run eval on the original weight.ggml instead", file=sys.stderr)
        return 2
    if not args.weights.endswith((".bin", ".gxt")):
        print(json.dumps(_eval_mobilevit(args, qtype)))
        return 0
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


def _load_vision(args):
    """(params, image (1, S, S, 3) float32) for ``features`` / ``classify``."""
    import torch

    from ggml_experiments_tpu_torch.formats import checkpoint
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
    from ggml_experiments_tpu_torch.models.mobilevit import (
        from_named_tensors,
        infer_config,
        load_mobilevit,
    )
    from ggml_experiments_tpu_torch.utils.image import load_and_preprocess, synthetic_test_image

    routes = dict(flash_attn=args.flash_attn, fused_layer=args.fused_layer,
                  act_storage=args.act_storage, act_storage_scope=args.act_storage_scope)
    if args.weights.endswith(".gxt"):
        # a self-describing params checkpoint (e.g. the calibrated q4_k_m one)
        params = load_mobilevit(args.weights, device=args.device, **routes)
        size = checkpoint.read_meta(args.weights).get("config", {}).get(
            "image_size", args.image_size)
    else:
        # the architecture comes off the weight shapes
        named = read_named_tensors(args.weights)
        config = infer_config(named, image_size=args.image_size,
                              num_attention_heads=args.num_heads)
        params = from_named_tensors(
            named, config, qtype=args.qtype, device=args.device,
            conv_dtype="float16" if getattr(args, "f16_convs", False) else None, **routes)
        size = config.image_size
    img = load_and_preprocess(args.image, size=size) if args.image else synthetic_test_image(size)
    return params, torch.from_numpy(img)[None]


def cmd_features(args) -> int:
    """MobileViT features of one image, printed as the reference prints them."""
    from ggml_experiments_tpu_torch.models.mobilevit import extract_features

    params, img = _load_vision(args)
    t0 = time.time()
    feats = extract_features(params, img, compute_dtype=args.compute).cpu().numpy()
    print(f"forward: {(time.time() - t0) * 1000:.1f} ms", file=sys.stderr)
    # the reference's printout: shape in ggml ne-order (W, H, C) and the
    # first/last 5 channels at (0, 0)
    _, h, w, c = feats.shape
    print(f"output feature shape: : Dims: ({w}, {h}, {c})")
    vec = feats[0, 0, 0]
    head = ", ".join(f"{v:g}" for v in vec[:5])
    tail = ", ".join(f"{v:g}" for v in vec[-5:])
    print("features of the test image: ")
    print(f"i0 = 0, i1 = 0\n{head}, ...{tail},")
    return 0


def cmd_classify(args) -> int:
    """Top-k classes of one image (the checkpoint needs a classifier head)."""
    import numpy as np

    from ggml_experiments_tpu_torch.models.mobilevit import classify

    params, img = _load_vision(args)
    logits = classify(params, img, compute_dtype=args.compute)[0].cpu().numpy()
    for i in np.argsort(logits)[::-1][: args.top_k]:
        print(f"class {int(i)}: logit {logits[i]:.4f}")
    return 0


def _serve_until_signal(front, *engines) -> None:
    """Block until SIGINT or SIGTERM, then stop the front end and the engines."""
    import signal
    import threading

    stop = threading.Event()
    handlers = {sig: signal.signal(sig, lambda *_: stop.set())
                for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        while not stop.wait(0.5):
            pass
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
        front.stop()
        for eng in engines:
            eng.stop()


def cmd_serve_vision(args) -> int:
    """Continuous-batching image service over HTTP: POST /v1/classify and
    /v1/features (serving/http.py) in front of a VisionEngine."""
    from ggml_experiments_tpu_torch.formats import checkpoint
    from ggml_experiments_tpu_torch.models.mobilevit import load_mobilevit
    from ggml_experiments_tpu_torch.serving.http import HttpFrontend
    from ggml_experiments_tpu_torch.serving.vision import VisionEngine

    if args.weights.endswith(".gxt"):
        # a self-describing checkpoint: its own quantization and image size
        params = load_mobilevit(args.weights, device=args.device)
        size = checkpoint.read_meta(args.weights).get("config", {}).get(
            "image_size", args.image_size)
    else:
        params = load_mobilevit(args.weights, qtype=args.qtype, device=args.device)
        size = args.image_size
    eng = VisionEngine(params, image_size=size,
                       batch_sizes=tuple(int(b) for b in args.batch_sizes.split(",")),
                       compute_dtype=args.compute)
    eng.start()
    front = HttpFrontend(None, vision=eng, host=args.host, port=args.http)
    front.start()
    print(f"vision service on {args.host}:{front.port} (POST /v1/classify, /v1/features; "
          f"GET /v1/vision/stats)", file=sys.stderr, flush=True)
    _serve_until_signal(front, eng)
    return 0


def cmd_bench(args) -> int:
    """Decode or feature-extraction throughput under the port's timing
    protocol (utils/benchmarking.PROTOCOL), as one JSON line. Without
    --weights the model is random at full size, made from --seed."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.device import resolve_device, resolve_dtype
    from ggml_experiments_tpu_torch.utils.benchmarking import PROTOCOL, timeit_stats

    dev = resolve_device(args.device)
    qtype = args.qtype or "q8_0"
    compute = resolve_dtype(args.compute)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "protocol": PROTOCOL, "qtype": qtype, "compute": args.compute}
    rng = np.random.default_rng(args.seed)
    if args.model == "gru":
        from ggml_experiments_tpu_torch.models import gru_textgen

        if args.weights:
            from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any

            params = load_gru_any(args.weights, qtype=qtype, device=dev)
        else:
            from ggml_experiments_tpu_torch.convert import params_from_numpy

            cfg = gru_textgen.GRUConfig()
            v, e, u = cfg.vocab_size, cfg.embed_dim, cfg.units
            shapes = {"embeddings": (v, e), "kernel": (e, 3 * u), "recurrent_kernel": (u, 3 * u),
                      "bias": (2, 3 * u), "dense_kernel": (u, v)}
            arrays = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
                      for k, s in shapes.items()}
            arrays["dense_bias"] = np.zeros(v, np.float32)
            params = params_from_numpy(arrays, qtype=qtype, device=dev)
        b, steps = args.batch, args.steps
        prompt = torch.as_tensor(rng.integers(0, params.vocab_size, (b, 8)), device=dev)
        lengths = torch.full((b,), 8, dtype=torch.int64, device=dev)
        st = timeit_stats(lambda: gru_textgen.decode(params, prompt, lengths, steps,
                                                     compute_dtype=compute), device=dev)
        out.update(model="gru", batch=b, steps=steps,
                   route=gru_textgen.decode_route(params, b, steps, compute_dtype=compute),
                   ms_per_call=round(st.headline * 1e3, 3),
                   tokens_per_s=round(b * steps / st.headline, 1), timing=st.asdict())
    else:
        from ggml_experiments_tpu_torch.models.mobilevit import (
            MobileViTConfig,
            extract_features,
            from_named_tensors,
            load_mobilevit,
            random_named_tensors,
        )
        from ggml_experiments_tpu_torch.utils.image import synthetic_test_image

        if args.weights:
            params = load_mobilevit(args.weights, qtype=qtype, device=dev)
        else:
            cfg = MobileViTConfig(image_size=args.image_size)
            params = from_named_tensors(random_named_tensors(cfg, seed=args.seed), cfg,
                                        qtype=qtype, device=dev)
        size = args.image_size
        imgs = torch.from_numpy(np.stack([synthetic_test_image(size)] * args.batch)).to(dev)
        st = timeit_stats(lambda: extract_features(params, imgs, compute_dtype=compute),
                          device=dev)
        out.update(model="mobilevit", batch=args.batch, image_size=size,
                   ms_per_call=round(st.headline * 1e3, 3),
                   # 3 decimals: a slow device's few images/s stay within 1e-3 of
                   # batch / ms_per_call
                   images_per_s=round(args.batch / st.headline, 3), timing=st.asdict())
    print(json.dumps(out))
    return 0


def _add_vision(p):
    p.add_argument("--weights", required=True, help="weight.ggml or a MobileViT .gxt")
    p.add_argument("--image", default=None, help="image path (default: the synthetic image)")
    p.add_argument("--image-size", type=int, default=256,
                   help="input resolution (not recoverable from the weights)")
    p.add_argument("--num-heads", type=int, default=4,
                   help="attention heads (not recoverable from the weight shapes)")
    p.add_argument("--flash-attn", action=argparse.BooleanOptionalAction, default=None,
                   help="attention through the flash kernel (default: on for a CUDA device)")
    p.add_argument("--fused-layer", action=argparse.BooleanOptionalAction, default=None,
                   help="whole transformer layers through the fused kernel at bf16 "
                        "(default: on for a CUDA device)")
    p.add_argument("--act-storage", choices=["f8_e5m2", "f8_e4m3", "bfloat16"], default=None,
                   help="store the conv-stage boundary activations of the bf16 path at this "
                        "dtype (fewer bytes, more feature noise; --compute bfloat16 only)")
    p.add_argument("--act-storage-scope", choices=["stem", "stem12", "early", "all"],
                   default="early", help="how deep --act-storage reaches")
    _add_common(p)


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
    s.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve a JSON HTTP API instead of the stdin loop (POST /v1/generate, "
                        "GET /v1/health|/v1/stats; 0 = an ephemeral port)")
    s.add_argument("--host", default="127.0.0.1", help="bind address for --http")
    _add_common(s)
    s.set_defaults(fn=cmd_serve)

    q = sub.add_parser("quantize",
                       help="offline fp32 -> block-quantized native checkpoint")
    q.add_argument("--input", required=True, help="gru.bin or weight.ggml")
    q.add_argument("--output", required=True, help="output .gxt path")
    q.add_argument("--calibrate", default=None, metavar="CORPUS",
                   help="calibration data: a text file (GRU: GPTQ with q4_k_m, calibrated "
                        "importance with another --qtype) or an image directory / "
                        "'task[:seed]' (MobileViT, q4_k_m only)")
    q.add_argument("--calibrate-seqs", type=int, default=384,
                   help="calibration sequences (GRU) or images (MobileViT)")
    _add_common(q)
    # the calibrated mixed recipe is a quantize-time option, not a QTensor format
    for a in q._actions:
        if a.dest == "qtype":
            a.choices = list(a.choices) + ["q4_k_m"]
    q.set_defaults(fn=cmd_quantize)

    e = sub.add_parser("eval", help="quantization-delta report (logits/top-1/ppl vs fp32)")
    e.add_argument("--weights", required=True, help="gru.bin, .gxt or weight.ggml")
    e.add_argument("--batch", type=int, default=8)
    e.add_argument("--length", type=int, default=64, help="sequence length (GRU)")
    e.add_argument("--corpus", default=None,
                   help="held-out text (GRU; default: random token sequences)")
    e.add_argument("--image-size", type=int, default=256,
                   help="input resolution (MobileViT)")
    e.add_argument("--num-heads", type=int, default=4, help="attention heads (MobileViT)")
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

    f = sub.add_parser("features", help="MobileViT feature extraction")
    f.add_argument("--f16-convs", action="store_true",
                   help="round convolution kernels through f16 (the reference's load policy)")
    _add_vision(f)
    f.set_defaults(fn=cmd_features)

    c = sub.add_parser("classify", help="MobileViT classification (needs classifier weights)")
    c.add_argument("--top-k", type=int, default=5)
    _add_vision(c)
    c.set_defaults(fn=cmd_classify)

    sv = sub.add_parser("serve-vision", help="continuous-batching image service over HTTP")
    sv.add_argument("--weights", required=True, help="weight.ggml or a MobileViT .gxt")
    sv.add_argument("--http", type=int, default=0, metavar="PORT", help="port (0 = ephemeral)")
    sv.add_argument("--host", default="127.0.0.1", help="bind address")
    sv.add_argument("--image-size", type=int, default=256,
                    help="input resolution (a .gxt's own meta wins)")
    sv.add_argument("--batch-sizes", default="8,32,128",
                    help="the collation ladder (comma-separated)")
    _add_common(sv)
    sv.set_defaults(fn=cmd_serve_vision)

    b = sub.add_parser("bench", help="throughput under the port's timing protocol (JSON)")
    b.add_argument("--model", choices=["gru", "mobilevit"], default="gru")
    b.add_argument("--weights", default=None,
                   help="gru.bin/.gxt or weight.ggml/.gxt (default: random full size)")
    b.add_argument("--batch", type=int, default=1024)
    b.add_argument("--steps", type=int, default=256, help="decode steps (gru)")
    b.add_argument("--image-size", type=int, default=256, help="input resolution (mobilevit)")
    b.add_argument("--seed", type=int, default=0)
    _add_common(b)
    b.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
