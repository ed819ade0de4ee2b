#!/usr/bin/env python3
"""Train the synthetic-task MobileViT classifier on the port and report its
quantization contract (the port's copy of ``tools/train_mobilevit_cls.py``).

Fine-tunes the whole MobileViT (``training/image_task.train_model``: the
gradients flow through ``from_named_tensors``, BN folding included) on the
deterministic grating dataset and writes the reference weight.ggml format
(``formats/ggml_named``), so the trained model loads through the standard
loader with any qtype. Then it prints a JSON report on the held-out images:
top-1 at f32 and under q8_0 / q4_0 / q4_1 / q5_0 / q5_1 with each format's
agreement, Δtop-1 and relative logit RMSE against f32; top-1 at bf16; and
the f8_e5m2 activation-storage scopes (early, stem12, stem) against bf16.

    python3 tools/torch_train_mobilevit_cls.py                 # tiny config
    python3 tools/torch_train_mobilevit_cls.py --full          # 256 px architecture
    python3 tools/torch_train_mobilevit_cls.py --eval-only [--full]   # the report alone
    python3 tools/torch_train_mobilevit_cls.py --out FILE --device cpu

It never writes under ``checkpoints/``: training writes ``--out``, by
default ``build/mobilevit_synth[_full].ggml`` (git-ignored). ``--eval-only``
reports on the committed ``checkpoints/mobilevit_synth[_full].ggml`` unless
``--out`` names another file. Everything runs on ``--device`` (default
``cuda``; without a GPU the tool raises unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = {False: os.path.join(REPO, "checkpoints", "mobilevit_synth.ggml"),
             True: os.path.join(REPO, "checkpoints", "mobilevit_synth_full.ggml")}
DEFAULT_OUT = {False: os.path.join(REPO, "build", "mobilevit_synth.ggml"),
               True: os.path.join(REPO, "build", "mobilevit_synth_full.ggml")}
QTYPES = (None, "q8_0", "q4_0", "q4_1", "q5_0", "q5_1")
STORE_SCOPES = (("f8_e5m2", "early"), ("f8_e5m2", "stem12"), ("f8_e5m2", "stem"))
EVAL_BATCH = 100


def setting(full: bool) -> dict:
    """The run's constants: architecture, sizes, steps, learning rate and
    the task's contrast."""
    from ggml_experiments_tpu_torch.models.mobilevit import MobileViTConfig
    from ggml_experiments_tpu_torch.training.image_task import (
        FULL_AMP_FACTOR,
        NUM_CLASSES,
        TINY_CLS_CONFIG,
    )

    if full:
        # the real 256 px / 144-192-240 / 2-4-3 architecture with a NUM_CLASSES
        # head; 256 px images are 16x the tiny pixels, so fewer but bigger
        # samples. lr: 1e-3 diverges at this depth (loss pinned at ln K), 3e-4
        # converges; 2000 steps land the task in the 85-95% band (900 leave it
        # undertrained). The full-size task runs at a lower contrast
        # (FULL_AMP_FACTOR): train, curriculum and eval all use it.
        return dict(config=MobileViTConfig(num_labels=NUM_CLASSES), n_train=1600, n_test=320,
                    steps=2000, batch=32, lr=3e-4, amp_factor=FULL_AMP_FACTOR)
    # n_train 6400: the task needs the larger sample to generalize
    return dict(config=TINY_CLS_CONFIG, n_train=6400, n_test=500, steps=1200, batch=100,
                lr=1e-3, amp_factor=1.0)


def heldout(s: dict, n: int | None = None):
    """The held-out images and labels of a setting (its first ``n``)."""
    from ggml_experiments_tpu_torch.training.image_task import HELDOUT_SEED, make_dataset

    return make_dataset(s["n_test"] if n is None else n, seed=HELDOUT_SEED,
                        image_size=s["config"].image_size, amp_factor=s["amp_factor"])


def train(s: dict, out: str, *, full: bool = False, device=None, log=print) -> float:
    """Train a setting's model from its seeded init and write it to ``out``
    (never a committed checkpoint); returns the final minibatch loss. The
    full setting first walks its contrast curriculum."""
    from ggml_experiments_tpu_torch.formats.ggml_named import write_named_tensors
    from ggml_experiments_tpu_torch.models.mobilevit import random_named_tensors
    from ggml_experiments_tpu_torch.training.image_task import (
        CLS_SEED,
        TRAIN_SEED,
        make_dataset,
        train_model,
    )

    ckpt_dir = os.path.realpath(os.path.join(REPO, "checkpoints"))
    out_dir = os.path.realpath(os.path.dirname(os.path.abspath(out)))
    if out_dir == ckpt_dir or out_dir.startswith(ckpt_dir + os.sep):
        raise ValueError(f"{out}: the tool does not write under checkpoints/")
    cfg, amp = s["config"], s["amp_factor"]
    kw = dict(config=cfg, batch=s["batch"], lr=s["lr"], device=device)
    named = random_named_tensors(cfg, seed=CLS_SEED, classifier=True)
    if full:
        # contrast curriculum: from-scratch SGD at 256 px stays at chance below
        # an absolute grating contrast of ~4x, and a trained model adapts down
        # a 2x contrast step; the boosts are absolute, divided by amp_factor
        boosts = [b / amp for b in (4.0, 2.0, 1.0) if b / amp > 1.0]
        nph = len(boosts) + 1
        for phase, boost in enumerate(boosts, 1):
            warm_x, warm_y = make_dataset(s["n_train"], seed=TRAIN_SEED,
                                          image_size=cfg.image_size, amp_boost=boost,
                                          amp_factor=amp)
            log(f"curriculum phase {phase}/{nph}: amp_boost={boost}")
            named, _ = train_model(named, warm_x, warm_y, steps=s["steps"] // 2, **kw)
        log(f"curriculum phase {nph}/{nph}: canonical contrast")
    train_x, train_y = make_dataset(s["n_train"], seed=TRAIN_SEED, image_size=cfg.image_size,
                                    amp_factor=amp)
    trained, loss = train_model(named, train_x, train_y, steps=s["steps"], **kw)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    write_named_tensors(out, sorted(trained.items()))
    log(f"wrote {out} ({os.path.getsize(out)} bytes), final loss {loss:.4f}")
    return loss


def logits_of(params, images: np.ndarray, compute_dtype=torch.float32) -> np.ndarray:
    """``classify`` logits of ``images`` in batches of EVAL_BATCH, on the
    params' device."""
    from ggml_experiments_tpu_torch.models.mobilevit import classify

    with torch.no_grad():
        return np.concatenate([
            classify(params, torch.from_numpy(np.ascontiguousarray(images[i:i + EVAL_BATCH])),
                     compute_dtype=compute_dtype).cpu().numpy()
            for i in range(0, len(images), EVAL_BATCH)])


def report(path: str, s: dict, test_x: np.ndarray, test_y: np.ndarray, *, full: bool = False,
           loss: float | None = None, device=None):
    """(the JSON report, each run's logits keyed as the report keys its
    top-1) of the model at ``path`` on the held-out images."""
    from ggml_experiments_tpu_torch.models.mobilevit import load_mobilevit
    from ggml_experiments_tpu_torch.training.image_task import FULL_TASK_REV, TASK_REV

    cfg = s["config"]
    rep = {"final_loss": loss, "task_rev": FULL_TASK_REV if full else TASK_REV,
           "amp_factor": s["amp_factor"]}
    logits, preds = {}, {}
    for qt in QTYPES:
        p = load_mobilevit(path, config=cfg, qtype=qt, device=device)
        key = qt or "f32"
        logits[key] = logits_of(p, test_x)
        preds[key] = logits[key].argmax(-1)
        rep[f"top1_{key}"] = float((preds[key] == test_y).mean())
        del p
    ref = logits["f32"]
    for qt in QTYPES[1:]:
        rep[f"agreement_{qt}"] = float((preds[qt] == preds["f32"]).mean())
        rep[f"dtop1_{qt}"] = rep["top1_f32"] - rep[f"top1_{qt}"]
        rep[f"rel_logit_rmse_{qt}"] = float(
            np.sqrt(np.mean((logits[qt] - ref) ** 2)) / (np.sqrt(np.mean(ref ** 2)) + 1e-12))
    # sub-bf16 activation storage: Δtop-1 against the bf16 forward it stands in for
    base = load_mobilevit(path, config=cfg, device=device)
    logits["bf16"] = logits_of(base, test_x, torch.bfloat16)
    pb = logits["bf16"].argmax(-1)
    rep["top1_bf16"] = float((pb == test_y).mean())
    del base
    # the scope ladder: narrower stamping trades memory savings for accuracy;
    # 'early' keeps the plain key names, narrower scopes get suffixed keys
    for store, scope in STORE_SCOPES:
        ps = load_mobilevit(path, config=cfg, act_storage=store, act_storage_scope=scope,
                            device=device)
        key = store if scope == "early" else f"{store}_{scope}"
        logits[key] = logits_of(ps, test_x, torch.bfloat16)
        pf = logits[key].argmax(-1)
        rep[f"top1_{key}"] = float((pf == test_y).mean())
        rep[f"dtop1_{key}_vs_bf16"] = rep["top1_bf16"] - rep[f"top1_{key}"]
        rep[f"agreement_{key}_vs_bf16"] = float((pf == pb).mean())
        del ps
    return rep, logits


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true", help="the full 256 px architecture")
    ap.add_argument("--eval-only", action="store_true",
                    help="no training: the report on --out, else the committed checkpoint")
    ap.add_argument("--out", default=None,
                    help="the trained model's path (default build/mobilevit_synth[_full].ggml)")
    ap.add_argument("--device", default=None, help="default cuda; 'cpu' without a GPU")
    args = ap.parse_args(argv)

    from ggml_experiments_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    s = setting(args.full)
    loss = None
    if args.eval_only:
        path = args.out or COMMITTED[args.full]
    else:
        path = args.out or DEFAULT_OUT[args.full]
        loss = train(s, path, full=args.full, device=dev,
                     log=lambda m: print(m, file=sys.stderr, flush=True))
    test_x, test_y = heldout(s)
    rep, _ = report(path, s, test_x, test_y, full=args.full, loss=loss, device=dev)
    print(json.dumps(rep, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
