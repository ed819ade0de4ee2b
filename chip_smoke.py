#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``ggml_experiments_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes the main path
gives it, then drives the main paths through the entry points a user calls,
at full width (the GRU at V=66, E=256, U=1024; MobileViT at the widths of
apple/mobilevit-small). Phases 2-5 run the committed trained
checkpoint ``checkpoints/gru_shakespeare.bin`` quantized to q8_0:

  1. device: name, power limit, kernel build seconds;
  2. ``qmatmul`` q8_0 kernel vs its plain version (M=1024 and the main
     path's M=64, f32 and bf16; two launches bit-equal), each cell's share
     of its bound and its speed against ``torch.matmul``;
  3. ``generate`` (scan path) at B=64, T=200, f32 and bf16;
  4. ``decode`` routed to the persistent kernel at B=8192, T=512, bf16, its
     tokens against the plain version's on the same inputs, two launches
     bit-equal, and the kernel teacher-forced against its plain version
     (there at bf16, and at f32 at B=1024, T=256); then each decomposition
     forced where ``decode_plan`` would not take it (slot-owned at B=512,
     unit-owned at B=4096, 64 steps), teacher-forced against the plain
     version, two launches bit-equal;
  5. ``DecodeEngine`` with the fused tick: ~1000 greedy requests, each equal
     to the offline decode; a sampling engine serving 100 requests; the tick
     kernel against its plain version on one identical tick input, and two
     launches of the greedy tick bit-equal;
  6. (printed last) one JSON line listing every kernel with its launches on
     its main-path run, its error against its plain version and its times,
     and for the persistent kernel's entries the plan that run took;
  7. the q4_0, q4_1, q5_0, q5_1 and q4_k ``qmatmul`` kernels on the same
     recurrent kernel (1024 x 3072) as phase 2, and ``generate`` at B=64,
     T=200 under each round-to-nearest format, its f32 tokens against the
     plain loop's;
  8. the calibrated ``checkpoints/gru_synth_q4km.gxt`` (q4_k cell, q8_0
     head) loaded onto the card: ``generate`` at B=64, T=200 (f32 tokens
     against the CPU run), ``decode`` at B=8192, T=512, bf16 through the
     persistent kernel's dense weight route with phase 4's checks, and an
     engine of 512 slots x 128 inner steps serving 300 greedy requests, plus
     phase 5's tick checks on that route;
  9. the persistent kernel's q4_0 weight route on ``gru_shakespeare.bin``:
     ``decode`` at B=2048, T=256, an engine and one 512 x 128 tick, with
     phase 4's and 5's checks;
 10. the ``quantize`` command writes a q5_1 ``.gxt`` that loads onto the
     card with every plane equal to the in-memory quantization; a running
     engine is snapshotted, restored, and finishes its requests equal to an
     uninterrupted engine and to the offline decode;
 11. the fused training pair (``csrc/gru_train.cu``) against its plain
     versions, bf16, with the recurrent kernel of ``gru_shakespeare.bin`` and
     the input projection of ``corpus_train.txt`` windows, at (B, T) = (1024, 100) and
     (64, 100) on the default ``train_plan``: forward ``ys`` / ``mhs``;
     backward (the recurrence, then the dWr GEMM) ``dmxs`` / ``dwr`` /
     ``dbrec`` / ``dh0`` from a seeded cotangent; the dWr kernel alone on
     equal operands; two launches on the same inputs bit-equal; each to
     ``torch.nn.GRU`` on cuDNN as the library's time; every other plan the
     kernels take there forced and held to the same checks; and the backward
     alone at (B, T) = (2048, 8) and (3000, 8), one launch of each kernel;
 12. training: ``train_from_text`` on ``checkpoints/corpus_train.txt``, bf16,
     B=1024, T=100, one epoch (7 steps): the loss is finite and falls, each
     step launches the forward, the backward recurrence and the dWr kernel
     once each and no plain version; the same run interrupted after 4 steps and resumed from its
     train-state file ends bit-equal; the trained weights go to a ``gru.bin``
     that ``generate`` reads back; then ``train-gru`` at its default batch of
     64 for one epoch of the corpus's first 60,000 characters, and at
     ``--batch-size 2048`` for one epoch of the whole corpus (3 steps, one
     launch of each kernel a step), whose exported weights must score a
     lower loss than the initial ones;
 13. the three vision kernels against their plain versions, at the shapes
     the main path gives them for B=128 images and on the full checkpoint's
     weights: the fused transformer layer (``csrc/transformer_layer.cu``) at
     (bp, L, C) = (512, 256, 144), (512, 64, 192), (512, 16, 240), each stage's
     first layer with its input projection, its middle layers and its last
     layer with the final LN and the conv_projection (BN, SiLU), whole and
     kernel by kernel (ln_qkv, attention, proj_ffn, each on its plain
     version's inputs, two launches bit-equal), beside
     ``nn.TransformerEncoderLayer`` and ``scaled_dot_product_attention``; flash
     attention (``csrc/flash_attention.cu``) at the same shapes in f32 and
     bf16 (two launches bit-equal), beside ``scaled_dot_product_attention``;
     the fused inverted
     residual (``csrc/inverted_residual.cu``) at (128, 64, 64, 64), E=256,
     with the residual, two launches bit-equal, beside the same block as
     three cuDNN convolutions (the library column), and its tile kernel
     (``csrc/inverted_residual_tile.cu``, the route of the shapes the strip
     kernel does not take) at E=384, two launches bit-equal; the fused
     layer's per-sequence kernel
     (``csrc/transformer_layer_seq.cu``, its route past the row-tile kernels)
     at C=320 and at L=640, every flag on;
 14. MobileViT through the entry points on
     ``checkpoints/mobilevit_synth_full.ggml`` (256 px, hidden 144/192/240,
     2/4/3 layers, 44 labels): ``classify`` of 320 held-out images of the
     full-size task (``make_dataset``, task rev 4) in batches of 128 at f32
     (flash, 9 launches a batch), bf16 (fused layer and each of its three
     kernels, 9 a batch) and bf16 with
     ``fused_ir`` (and the inverted residual, once a batch for each stride-1
     block its gate takes), top-1 against the
     labels and argmax agreement with f32; the card's f32 features of the
     first 32 images against the plain CPU run; the calibrated
     ``mobilevit_synth_full_q4km.gxt`` classifying the same images; the
     ``features`` command; ``extract_features`` at B=128 bf16 timed with CUDA
     events and one forward of each bf16 route split by ``torch.profiler``;
 15. the ``VisionEngine`` (ladder 8/32/128, u8 transport, bf16): 300 mixed
     classify/features requests in bursts, every 23rd canceled, each served
     result against the offline forward of the same image;
 16. GRU calibration: ``quantize --qtype q4_k_m --calibrate
     corpus_train.txt`` of ``checkpoints/gru_synth.bin`` on the card (384
     windows), its wall time split into the calibration forward with the
     Grams, the GPTQ recursion, the k-quant grid fits and the rest; its codes
     against the shipped ``gru_synth_q4km.gxt`` (made by the JAX package),
     counted; the shipped file's contract (agreement >= 0.995, relative
     delta-ppl < 0.001 on 16 held-out windows); ``eval --corpus`` timed; the
     Shakespeare ordering (q8_0 >= GPTQ q4_k_m > round-to-nearest q4_k,
     q4_k_m >= 0.95) with 128 calibration windows; phase 8's generate,
     decode and engine checks on the port-made file; GPTQ of the same H and
     W on the card and on the CPU, bit-equal;
 17. the MobileViT remainders: ``quantize --qtype q4_k_m --calibrate
     task:1234`` of ``mobilevit_synth_full.ggml`` on the card, timed by part,
     its codes against the shipped ``mobilevit_synth_full_q4km.gxt``;
     ``classify`` of phase 14's images with it at f32 (flash) and bf16 (the
     fused layer): argmax agreement with the float model on the same route
     >= 319/320 with any flip at a near-tie, relative logit RMSE < 0.005 at
     f32; ``eval --qtype q4_k`` and ``q8_0`` of the ``weight.ggml``;
     ``extract_features`` at B=128, bf16 + ``fused_ir``, without activation
     storage and under f8_e5m2 (scopes early, all) and bf16 storage, timed,
     their feature noise against f32 ('early' < 0.35, 'early' < 'all' <
     0.45) and top-1; the space-to-depth stem and bf16 convolution kernels
     against the standard load, the stem's device time under
     ``torch.profiler``; ``train_model`` on ``mobilevit_synth.ggml``
     (``TINY_CLS_CONFIG``, its head drawn anew) for 20 steps at batch 100,
     the loss falling, ms per step;
 18-20. HTTP text and vision serving, the dispatch gates and ``bench``;
 21. multi-device serving: after the build the script spawns itself as
     ranks (``--rank``). Two ranks share cuda:0 over gloo (NCCL refuses two
     ranks on one device), so the figures are overhead and not scaling:
     (a) a 512 x 128 engine whose fused tick is slot-sharded (256 slots a
     rank, noise keyed on the shard's first slot), greedy requests equal to
     the offline decode, the same sampled prompts at one column of each
     shard drawing distinct streams, state digests equal, each rank's shard
     tick against its plain version with the same keys; (b) the scan tick on
     a (1, 2) mesh, gate kernels column-parallel through the qmatmul kernel
     (1024 x 1536 a rank), the head row-parallel, against ``generate``
     under the near-tie rule; (c) the data-parallel MobileViT forward, 64
     images a rank at bf16 and f32, against one process's; (d) a snapshot,
     rank 1's death, rank 0's next tick failing or stalling, and the
     snapshot restored here, finishing equal to an uninterrupted engine;
     (e) one rank over NCCL through the same engine path.

Launch counts are zeroed just before each main-path run and read just after
it; comparison launches are not counted. Any failed check raises, so the
script exits non-zero before its last line, which is the JSON object
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
port's package beside it, it exits non-zero and prints no result.

Tolerances, and why:
  * qmatmul vs the plain product before its output cast, f32 and bf16, every
    format: the decoded weights are bit-equal, the products are exact in f32
    (bf16 operands) or f32-accurate (3xTF32), the sums are f32 in other
    orders, so 1e-5 relative. Split-K partial sums are added in a fixed
    order, so two launches on the same inputs are bit-equal.
  * Fused kernels, teacher-forced (no argmax feedback): at f32, 1e-4
    absolute on h after 256 steps (errors compound through the recurrence).
    At bf16, on the main path's shapes, h may also differ where the two
    sides' f32 sums round h to neighbouring bf16 values, and such flips
    spread through the recurrence: max error at most TF_BF16_H_MAX, mean
    error at most a set fraction of the mean distance between the plain
    version's f32 and bf16 runs, after the main path's steps and after 8
    (see the constants: set from H100 readings, so that a kernel that
    skipped the bf16 rounding fails).
  * The training pair against its plain versions: both round to bf16 at the
    same places, but sum in other orders and call other exp/tanh routines, so
    a value on a rounding boundary may land one bf16 step off and feed the
    following steps (forward) or the carry (backward). Forward: ``ys`` within
    TRAIN_YS_MAX and ``mhs`` within TRAIN_MHS_MAX (twice the H100 readings of
    0.045 and 0.125 after 100 steps of the trained recurrent kernel), and the
    mean ``ys`` error within the fractions the fused decode is held to
    (TF_BF16_MEAN_FRAC_*) of the plain version's own distance between rounding
    to bf16 and not rounding, over all steps and over the first 8. Backward,
    on equal inputs: each gradient's max |diff| over max |plain| within
    TRAIN_GRAD_REL (readings 0.002-0.006), and two launches bit-equal. The
    dWr GEMM alone against its plain version on equal operands: the same
    bf16 products, f32 sums over T*B terms in another order (the kernel runs
    of 16384 tensor-core additions added in f32, the plain version products
    of B terms added in f32): within TRAIN_DWR_REL of the largest entry;
    both sides' distance to the same sum in f64 is logged beside it.
  * The vision kernels at bf16: both sides round to bf16 at the same places
    but sum in other orders and call other exp routines, so a value on a
    rounding boundary may land one bf16 step off and carry on through the
    layer. Max error within VIT_BF16_MAX of the output's largest value, mean
    error within VIT_BF16_MEAN_FRAC of the plain version's own mean distance
    between rounding to bf16 and not rounding (H100 readings and the mutants
    that skip one rounding are in PERF.md). Flash attention at f32 (3xTF32
    products, online softmax): 1e-5 relative; two launches bit-equal. The card's f32 features against the CPU: VIT_CPU_FEATURE_REL
    relative (cuDNN's and the CPU's f32 convolutions sum in other orders over
    some fifty layers). A bf16 argmax may differ from the f32 run's, and the
    engine's from the offline forward's (other batch sizes, other cuDNN
    algorithms), only where the reference's top-2 logit gap is below
    VIT_NEAR_TIE.
  * A free-running greedy or sampled sequence may fork where the two best
    scores of a step lie closer than the summation-order error: the first
    divergence of every row must sit at such a near-tie of the plain
    version (score gap < 1e-3 at f32, < 0.1 at bf16, where h is rounded to
    8 mantissa bits before every product).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "checkpoints", "gru_shakespeare.bin")
CKPT_Q4KM = os.path.join(REPO, "checkpoints", "gru_synth_q4km.gxt")
CORPUS = os.path.join(REPO, "checkpoints", "shakespeare.txt")
CORPUS_TRAIN = os.path.join(REPO, "checkpoints", "corpus_train.txt")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
# exp2 results a second on the H100's MUFU units: 16 a clock per
# multiprocessor (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0), 132 multiprocessors, 1.98 GHz boost
MUFU_EXP_PER_S = 16 * 132 * 1.98e9
PEAK_OPS = {"float32": 67e12,  # f32 FMA on CUDA cores (the kernels' products)
            "bfloat16": 989e12,  # bf16 dense tensor-core peak
            # f32 products as 3xTF32 on the tensor cores (qmatmul and flash
            # attention at f32): three tf32 products for each, 495 / 3
            "tf32x3": 495e12 / 3}
NEAR_TIE = {"float32": 1e-3, "bfloat16": 0.1}
# the shapes the main paths are driven at
GENERATE_SHAPE = (64, 200)           # (B, T) of the scan path
DECODE_SHAPE = (8192, 512)           # decode() through the persistent kernel
DECODE_SHAPE_Q4_0 = (2048, 256)
TF_F32_SHAPE = (1024, 256)           # teacher-forced f32 decode
ENGINE_SHAPE = (512, 128)            # (slots, inner steps)
REQUESTS, REQUESTS_SAMPLED, REQUESTS_ROUTE = 1000, 100, 300
QMATMUL_MS = (1024, 64)              # M of the qmatmul checks; the last is the main path's
# teacher-forced bf16 h against the plain version (readings on an H100 at
# the shapes below: max 0.014-0.022 after 128-512 steps; mean error 0.51 of
# the plain f32-vs-bf16 mean there, 0.09-0.10 after 8 steps; the kernel run
# at f32 instead reads a ratio of 1.0)
TF_BF16_H_MAX = 0.05
TF_BF16_SHORT = 8
TF_BF16_MEAN_FRAC_LONG, TF_BF16_MEAN_FRAC_SHORT = 0.75, 0.25
# training: (B, T) of the kernel checks; the first is the main path's
TRAIN_SHAPES = ((1024, 100), (64, 100))
TRAIN_RESUME_AFTER = 4               # steps before the interruption
TRAIN_CLI_CHARS = 60000              # corpus prefix of the default-batch CLI run
TRAIN_LARGE_SHAPES = ((2048, 8), (3000, 8))   # backward past the parent kernel's one launch
TRAIN_BIG_BATCH = 2048               # train-gru's batch past the parent kernel's one launch
FORCED_PLANS = ((("slot", 4), 512), (("unit",), 4096))   # (plan, B), 64 steps
# the training pair against its plain versions (limits: see the docstring)
TRAIN_YS_MAX, TRAIN_MHS_MAX = 0.1, 0.25
TRAIN_GRAD_REL = {"dmxs": 2e-2, "dh0": 2e-2, "dwr": 1e-2, "dbrec": 1e-2}
TRAIN_DWR_REL = 1e-4   # the dWr GEMM against its plain version on equal operands
TRAIN_KERNELS = ("fused_gru_train_fwd", "fused_gru_train_bwd", "fused_gru_train_dwr")


# the vision path (phases 13-15): apple/mobilevit-small widths, trained head
VIT_CKPT = os.path.join(REPO, "checkpoints", "mobilevit_synth_full.ggml")
VIT_Q4KM = os.path.join(REPO, "checkpoints", "mobilevit_synth_full_q4km.gxt")
VIT_BATCH, VIT_IMAGES, VIT_CPU_IMAGES = 128, 320, 32
VIT_IR_SHAPE = (128, 64, 64, 64, 256, 64)     # (B, H, W, C, E, Cout) of layer_2's blocks
# a shape the strip kernel does not take (E past 256): the tile kernel's check
VIT_IR_TILE_SHAPE = (128, 64, 64, 64, 384, 64)
VIT_ENGINE_BURSTS = (5, 8, 30, 128, 3, 100, 17, 2, 7)   # 300 requests
VIT_CANCEL_EVERY = 23
# bf16 kernels against their plain versions on the main path's shapes: max
# error within a fraction of the output's largest value, mean error within a
# fraction of the plain version's own mean distance between rounding to bf16
# and not rounding (set from H100 readings so that a kernel that skips one
# bf16 rounding fails: see the docstring)
VIT_BF16_MAX = {"layer": 0.05, "flash": 2 ** -6, "ir": 2 ** -6}
VIT_BF16_MEAN_FRAC = {"layer": 0.15, "flash": 0.1, "ir": 0.01}
# (bp, L, C, H, F) of the per-sequence layer kernel's check in phase 13
SEQ_LAYER_SHAPES = ((128, 16, 320, 5, 640), (16, 640, 64, 2, 128))
VIT_F32_REL = 1e-5                 # flash at f32 against its plain version
VIT_CPU_FEATURE_REL = 1e-4         # card f32 features against the CPU plain run
VIT_NEAR_TIE = 0.1                 # bf16 logit gap under which an argmax may flip
VIT_ENGINE_FEATURE_MAX = 0.02      # engine vs offline features, x the largest feature
# calibration (phases 16, 17)
GRU_SYNTH = os.path.join(REPO, "checkpoints", "gru_synth.bin")
CORPUS_HELDOUT = os.path.join(REPO, "checkpoints", "corpus_heldout.txt")
SHAKE_TRAIN = os.path.join(REPO, "checkpoints", "shakespeare_train.txt")
SHAKE_HELD = os.path.join(REPO, "checkpoints", "shakespeare_heldout.txt")
VIT_TINY = os.path.join(REPO, "checkpoints", "mobilevit_synth.ggml")
GRU_HELDOUT_SEQS = 16          # the JAX contract test's held-out draw (seed 0)
SHAKE_CAL_SEQS = 128           # the JAX Shakespeare test's calibration draw (seed 7)
KM_GRU_AGREE, KM_GRU_DPPL = 0.995, 0.001       # the shipped q4_k_m GRU file's contract
KM_VIT_AGREE, KM_VIT_REL = 319 / 320, 0.005    # the shipped q4_k_m vision file's contract
STORE_RUNS = (("f8_e5m2", "early"), ("f8_e5m2", "all"), ("bfloat16", "early"))
STORE_REL = {"early": 0.35, "all": 0.45}       # the JAX act-storage contracts
TRAIN_VIT_STEPS, TRAIN_VIT_BATCH, TRAIN_VIT_IMAGES = 20, 100, 1000
# HTTP serving (phases 18-19)
HTTP_ENGINE_SHAPE = (512, 128)       # (slots, inner steps): the fused tick
HTTP_REQUESTS, HTTP_CLIENTS = 64, 8
HTTP_CANCELS, HTTP_CANCEL_NEW = 4, 1024    # streams canceled by DELETE, their length
HTTP_IMAGES = 128
# multi-device serving (phase 21): two ranks share the card over gloo
MD_BACKEND = "cpu:gloo,cuda:gloo"
MD_ENGINE_SHAPE = (512, 128)         # (slots, inner steps): 256 slots a rank
MD_SAMPLED_PAIRS, MD_BACKLOG = 20, 64  # sampled prompts repeated in both shards; queued
MD_TP_SHAPE, MD_TP_REQUESTS = (64, 16), 64
MD_VIT_IMAGES = 128
MD_DIE_SLOTS, MD_DIE_REQUESTS = 128, 300
MD_NCCL_REQUESTS = 64
MD_TIMEOUT_S = {"serve": 300, "die": 20, "nccl": 300}   # a collective's time limit
MD_DEATH_WAIT_S = 25                 # how long the survivor's tick may take
MD_SPAWN_TIMEOUT_S = 600
MD_RANK_ARGV = [sys.executable, os.path.abspath(__file__)]   # a rank: this script, --rank


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, n=20, warmup=3):
    """Median milliseconds of ``fn`` over ``n`` CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, ops, dtype):
    """Least time (ms) for the work: bytes over HBM rate vs ops over peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def first_divergence_near_ties(got, want, gaps, tol, what):
    """Rows of ``got``/``want`` (B, T) may fork only where the plain
    version's decision at the step before the first differing token had a
    score gap below ``tol``. Returns (token agreement, forked rows)."""
    import torch

    diff = got != want
    forked = torch.nonzero(diff.any(dim=1)).flatten().tolist()
    for r in forked:
        j = int(torch.nonzero(diff[r])[0])
        check(j > 0, f"{what}: row {r} differs at its first token")
        gap = float(gaps[r, j - 1])
        check(gap < tol, f"{what}: row {r} forks at step {j} where the plain "
                         f"version's score gap is {gap:.3g} >= {tol}")
    return float((~diff).float().mean()), len(forked)


def tf_h_check(kernel, plain, steps, what):
    """Teacher-forced runs (every step feeds the prompt) of ``kernel(cd, t)``
    -> (toks, h) against ``plain(cd, t)`` -> (toks, h, ...) at bf16, for the
    main path's ``steps`` and for TF_BF16_SHORT steps. The tokens are the
    prompt and must be equal. h must lie within TF_BF16_H_MAX, and its mean
    error within a fraction (TF_BF16_MEAN_FRAC_*) of the mean distance
    between the plain version's own f32 and bf16 runs, which is where a
    kernel that skipped the bf16 rounding lands. Returns {t: (max err, mean
    err, mean f32-vs-bf16 distance)}."""
    import torch

    out = {}
    for t, frac in ((steps, TF_BF16_MEAN_FRAC_LONG), (TF_BF16_SHORT, TF_BF16_MEAN_FRAC_SHORT)):
        toks_k, h_k = kernel(torch.bfloat16, t)
        toks_p, h_p = plain(torch.bfloat16, t)[:2]
        check(torch.equal(toks_k.int(), toks_p), f"{what} bf16 T={t}: tokens differ")
        d = (h_k - h_p).abs()
        err, mean = float(d.max()), float(d.mean())
        del h_k, d
        gap = float((plain(torch.float32, t)[1] - h_p).abs().mean())
        check(err <= TF_BF16_H_MAX and mean <= frac * gap,
              f"{what} bf16 T={t}: h max abs err {err:.3g} (limit {TF_BF16_H_MAX}), mean "
              f"{mean:.3g} (limit {frac} x {gap:.3g}, the plain version's f32-vs-bf16 mean)")
        out[t] = (err, mean, gap)
    return out


def tf_summary(res):
    return ", ".join(f"T={t}: h max abs err {e:.3g}, mean {m:.3g} (plain f32 vs bf16: "
                     f"{g:.3g})" for t, (e, m, g) in sorted(res.items(), reverse=True))


def corpus_prompts(tok, rng, n, lo, hi):
    """``n`` prompts of ``lo``..``hi`` characters cut from the corpus."""
    import numpy as np

    with open(CORPUS) as f:
        text = f.read()
    out = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi + 1))
        at = int(rng.integers(0, len(text) - ln))
        out.append(np.asarray(tok.encode(text[at:at + ln]), np.int32))
    return out


def pad_batch(prompts, width):
    import numpy as np

    ids = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :p.size] = p
    return ids, np.asarray([p.size for p in prompts], np.int32)


def cdname(cd):
    return str(cd).split(".")[1]


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def qmatmul_phase(tag, qt, dev):
    """One format's qmatmul kernel against the plain product before its
    output cast, at M=1024 and the main path's M=64, f32 and bf16, with its
    times, the plain version's, ``torch.matmul`` on the dequantized plane
    and the bound from the format's own plane bytes. Returns the readings by
    (M, dtype name)."""
    import torch

    from ggml_experiments_tpu_torch.quant.qmatmul import qmatmul_cuda, qmatmul_reference
    from ggml_experiments_tpu_torch.quant.qtensor import dequantize

    k, n = qt.shape
    out = {}
    for m in QMATMUL_MS:
        x = torch.randn((m, k), generator=torch.Generator(device=dev).manual_seed(m),
                        device=dev)
        for cd in (torch.float32, torch.bfloat16):
            cdn = cdname(cd)
            got = qmatmul_cuda(x, qt, cd)
            again = qmatmul_cuda(x, qt, cd)
            # the plain product before its output cast: bf16 operands (whose
            # products are exact in f32), f32 sums; the kernel returns f32
            want = torch.matmul(x.to(cd).float(), dequantize(qt).to(cd).float())
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            check(rel <= 1e-5, f"qmatmul {qt.qtype} M={m} {cdn}: max rel err {rel:.3g}")
            check(torch.equal(got, again), f"qmatmul {qt.qtype} M={m} {cdn}: two launches on "
                                           f"the same inputs differ")
            ms = cuda_ms(lambda: qmatmul_cuda(x, qt, cd))
            plain_ms = cuda_ms(lambda: qmatmul_reference(x, qt, cd))
            w = dequantize(qt).to(cd)
            xc = x.to(cd)
            lib_ms = cuda_ms(lambda: torch.matmul(xc, w))
            nbytes = x.numel() * 4 + qt.nbytes + m * n * 4
            # the f32 route's products run as 3xTF32 on the tensor cores
            b_ms, b_by = bound(nbytes, 2 * m * k * n, "tf32x3" if cd == torch.float32 else cdn)
            out[(m, cdn)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=b_ms, bound_by=b_by)
            log(f"[{tag}] {qt.qtype} M={m} K={k} N={n} {cdn}: max abs err {err:.3g} (rel "
                f"{rel:.3g}), two launches bit-equal | kernel {ms:.4f} ms = "
                f"{100 * b_ms / ms:.1f}% of bound, {lib_ms / ms:.2f}x torch.matmul's speed | "
                f"plain {plain_ms:.4f} ms | torch.matmul on the dequantized plane {lib_ms:.4f} "
                f"ms | bound {b_ms:.4f} ms ({b_by})")
    return out


def qmatmul_entry(readings, launches):
    """The kernels-line entry of one qmatmul format: the main path's shape is
    generate at B=64, f32 and bf16; the top-level times are f32's, the bf16
    cell's are under "bfloat16", the error the larger of the two."""
    m = QMATMUL_MS[-1]
    bf = readings[(m, "bfloat16")]
    return dict(readings[(m, "float32")], launches=launches,
                max_abs_err=max(readings[(m, c)]["max_abs_err"]
                                for c in ("float32", "bfloat16")),
                bfloat16={key: bf[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms")})


def decode_phase(tag, params, B, T, f32_shape, rng, tok):
    """``decode()`` routed to the persistent kernel at (B, T), bf16: launch
    count, time against the plain version and the bound, tokens against the
    plain version under the near-tie rule; then the kernel teacher-forced
    against its plain version, at bf16 on that shape and at f32 on
    ``f32_shape``. Returns the kernels-line entry."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused

    dev = params.device
    f32, bf16 = torch.float32, torch.bfloat16
    ids, lens = pad_batch(corpus_prompts(tok, rng, B, 8, 32), 32)
    port.reset_kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = gru_textgen.decode(params, ids, lens, T)             # routes to the kernel
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    launches = port.kernel_launches()
    plan = fused.LAST_PLAN.get("fused_gru_decode")
    check(launches["fused_gru_decode"] > 0, f"{tag}: decode took the scan path: {launches}")
    wf = fused._prep_weights(params)
    v, e, u = wf.v, wf.e, wf.u
    check(toks.shape == (B, T) and int(toks.max()) < v, f"{tag}: decode output shape/range")
    ids_t, lens_t = torch.from_numpy(ids).to(dev), torch.from_numpy(lens).to(dev)
    dec_ms = cuda_ms(lambda: fused.fused_gru_decode(params, ids_t, lens_t, T), n=3, warmup=1)
    # two launches on the same inputs give the same bits
    first = fused.fused_gru_decode(params, ids_t, lens_t, T, return_state=True)
    second = fused.fused_gru_decode(params, ids_t, lens_t, T, return_state=True)
    check(torch.equal(first[0], second[0]) and torch.equal(first[1], second[1]),
          f"{tag}: two decode launches on the same inputs differ")
    del first, second
    zb = torch.zeros(B, dtype=torch.int32, device=dev)
    tb = torch.full((B,), T, dtype=torch.int32, device=dev)
    prompt_pad = torch.nn.functional.pad(ids_t, (0, T - ids_t.shape[1]))
    h0 = torch.zeros(B, u, device=dev)
    dec_plain_ms = cuda_ms(lambda: fused.gru_loop_reference(
        wf, prompt_pad, lens_t, tb, zb, zb, h0, T, bf16), n=1, warmup=0)
    # the main path's tokens against the plain version on the same inputs
    toks_p, _, _, _, gaps = fused.gru_loop_reference(wf, prompt_pad, lens_t, tb, zb, zb, h0,
                                                     T, bf16, margins=True)
    agree, forked = first_divergence_near_ties(toks, toks_p, gaps, NEAR_TIE["bfloat16"],
                                               f"{tag}: decode() B={B} T={T} bf16")
    del toks_p, gaps
    weight_bytes = tensor_bytes(wf.emb, wf.wc, wf.ws, wf.uc, wf.us, wf.bias, wf.dc, wf.ds,
                                wf.dbias)
    ops = 2 * v * e * 3 * u + 2 * B * T * (3 * u * u + u * v)
    nbytes = weight_bytes + ids.nbytes + lens.nbytes + B * T * 4
    b_ms, b_by = bound(nbytes, ops, "bfloat16")
    log(f"[{tag}] decode() B={B} T={T} bf16, {wf.mode} weight route: {dec_s:.3f} s first call, "
        f"kernel {dec_ms:.2f} ms = {dec_ms * 1e3 / T:.1f} us/step = "
        f"{B * T / dec_ms * 1e3:,.0f} tok/s | plain {dec_plain_ms:.1f} ms | bound {b_ms:.2f} ms "
        f"({b_by}) | launches {launches['fused_gru_decode']} | plan {plan} | two launches "
        f"bit-equal | tokens vs the plain version: agreement {agree:.6f}, {forked} rows fork "
        f"(all at near-ties)")

    # teacher-forced at the main path's shape and dtype: no argmax feedback,
    # so h must agree; at bf16 it may differ only where the two sides' f32
    # sums round h to neighbouring bf16 values
    tf_ids = torch.from_numpy(rng.integers(0, v, (B, T)).astype(np.int32)).to(dev)

    def steps_len(t):
        return torch.full((B,), t, dtype=torch.int32, device=dev)

    dec_tf = tf_h_check(
        lambda cd, t: fused.fused_gru_decode(params, tf_ids[:, :t], steps_len(t), t,
                                             compute_dtype=cd, return_state=True),
        lambda cd, t: fused.gru_loop_reference(wf, tf_ids[:, :t], steps_len(t), steps_len(t),
                                               zb, zb, h0, t, cd),
        T, f"{tag}: teacher-forced decode B={B}")
    del tf_ids, h0

    # teacher-forced at f32 (the kernel's FMA path)
    Bt, Tt = f32_shape
    tf_ids = torch.from_numpy(rng.integers(0, v, (Bt, Tt)).astype(np.int32)).to(dev)
    tf_len = torch.full((Bt,), Tt, dtype=torch.int32, device=dev)
    zt = torch.zeros(Bt, dtype=torch.int32, device=dev)
    toks_k, h_k = fused.fused_gru_decode(params, tf_ids, tf_len, Tt, compute_dtype=f32,
                                         return_state=True)
    toks_p, h_p, _, _ = fused.gru_loop_reference(wf, tf_ids, tf_len, tf_len, zt, zt,
                                                 torch.zeros(Bt, u, device=dev), Tt, f32)
    h_err = float((h_k - h_p).abs().max())
    check(torch.equal(toks_k, toks_p), f"{tag}: teacher-forced decode tokens differ")
    check(h_err <= 1e-4, f"{tag}: teacher-forced decode h error {h_err:.3g} > 1e-4")
    log(f"[{tag}] teacher-forced B={B} bf16, tokens equal: {tf_summary(dec_tf)} | "
        f"teacher-forced B={Bt} T={Tt} f32: tokens equal, h max abs err {h_err:.3g}")
    return dict(launches=launches["fused_gru_decode"], max_abs_err=dec_tf[T][0], ms=dec_ms,
                plain_ms=dec_plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                plan=str(plan))


def forced_plan_phase(tag, params, rng):
    """Each decomposition of the persistent kernel forced through
    ``config=`` at a batch where ``decode_plan`` takes the other one
    (FORCED_PLANS), teacher-forced against the plain version at bf16 (as
    phase 4 holds the main path), two launches bit-equal."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused

    dev = params.device
    wf = fused._prep_weights(params)
    T = 64
    for plan, B in FORCED_PLANS:
        check(fused.decode_plan(B, wf.u, wf.v) != fused.DecodePlan(*plan),
              f"{tag}: {plan} is already the default at B={B}")
        ids = torch.from_numpy(rng.integers(0, wf.v, (B, T)).astype(np.int32)).to(dev)
        z = torch.zeros(B, dtype=torch.int32, device=dev)
        h0 = torch.zeros(B, wf.u, device=dev)

        def lens(t):
            return torch.full((B,), t, dtype=torch.int32, device=dev)

        def kernel(cd, t):
            toks, h, _, _ = fused.gru_loop_cuda("fused_gru_decode", wf, ids[:, :t], lens(t),
                                                lens(t), z, z, h0, t, cd, config=plan)
            return toks, h

        first, second = kernel(torch.bfloat16, T), kernel(torch.bfloat16, T)
        check(torch.equal(first[0], second[0]) and torch.equal(first[1], second[1]),
              f"{tag}: two launches of {plan} at B={B} differ")
        check(fused.LAST_PLAN["fused_gru_decode"] == fused.DecodePlan(*plan),
              f"{tag}: the launch took {fused.LAST_PLAN['fused_gru_decode']}, not {plan}")
        res = tf_h_check(kernel, lambda cd, t: fused.gru_loop_reference(
            wf, ids[:, :t], lens(t), lens(t), z, z, h0, t, cd), T,
            f"{tag}: forced {plan} B={B}")
        ms = cuda_ms(lambda: kernel(torch.bfloat16, T), n=3, warmup=1)
        log(f"[{tag}] forced plan {fused.DecodePlan(*plan)} at B={B} (default "
            f"{fused.decode_plan(B, wf.u, wf.v)}), teacher-forced bf16, tokens equal: "
            f"{tf_summary(res)} | two launches bit-equal | {ms:.2f} ms = "
            f"{ms * 1e3 / T:.1f} us/step")


def engine_phase(tag, params, n_requests, n_slots, inner, rng, tok):
    """A greedy engine on the fused tick serving ``n_requests``, each equal to
    the offline decode. Returns the tick launches of that run."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.serving import DecodeEngine

    prompts = corpus_prompts(tok, rng, n_requests, 1, 64)
    new_toks = [int(x) for x in rng.integers(16, 257, len(prompts))]
    eng = DecodeEngine(params, n_slots=n_slots, max_prompt=64, inner_steps=inner,
                       compute_dtype=torch.bfloat16, use_fused_tick=True)
    port.reset_kernel_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, nt) for p, nt in zip(prompts, new_toks)]
    eng.run_until_idle(timeout_s=600)
    torch.cuda.synchronize()
    eng_s = time.perf_counter() - t0
    launches = port.kernel_launches()
    plan = fused.LAST_PLAN.get("fused_slot_tick")
    check(launches["fused_slot_tick"] > 0, f"{tag}: engine took the scan tick: {launches}")
    ids, lens = pad_batch(prompts, 64)
    offline = fused.fused_gru_decode(params, ids, lens, 64 + 256,
                                     compute_dtype=torch.bfloat16).cpu()
    for i, (r, p, nt) in enumerate(zip(reqs, prompts, new_toks)):
        res = r.result(timeout=0)
        check(len(res) == p.size + nt, f"{tag}: request {i}: {len(res)} tokens, want "
                                       f"{p.size + nt}")
        check(np.array_equal(res, offline[i, :p.size + nt].numpy()),
              f"{tag}: request {i}: continuous batching differs from the offline decode")
    log(f"[{tag}] {len(reqs)} greedy requests, n_slots={n_slots} inner={inner} bf16, "
        f"{fused._prep_weights(params).mode} weight route: all equal to the offline decode | "
        f"{eng_s:.3f} s, {eng.stats.tokens_generated:,} tokens delivered ({sum(new_toks):,} "
        f"generated) = {eng.stats.tokens_per_s:,.0f} tokens/s | tick launches "
        f"{launches['fused_slot_tick']}, plan {plan} | breakdown "
        f"{json.dumps(eng.stats.breakdown())}")
    return launches["fused_slot_tick"], plan


def tick_phase(tag, params, n_slots, inner, main_run, rng, tok):
    """One identical tick input through the kernel and its plain version:
    sampled (temperature 0.8, top-k 20, top-p 0.9) at f32 and bf16 under the
    near-tie rule, teacher-forced at f32 and bf16, and the greedy bf16 tick's
    time. Returns the kernels-line entry."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.serving.engine import init_state

    dev = params.device
    f32, bf16 = torch.float32, torch.bfloat16
    wf = fused._prep_weights(params)
    v, e, u = wf.v, wf.e, wf.u
    st = init_state(params, n_slots, 64)
    tids, tlens = pad_batch(corpus_prompts(tok, rng, n_slots, 1, 64), 64)
    st.prompt = torch.from_numpy(tids).to(dev)
    st.plen = torch.from_numpy(tlens).to(dev)
    st.total = st.plen + inner
    st.temp = torch.full((n_slots,), 0.8, device=dev)
    tick_kw = dict(enable_sampling=True, seed=12345, top_k=20, top_p=0.9)
    res = {}
    for cd in (f32, bf16):
        cdn = cdname(cd)
        s_k, t_k = fused.fused_slot_tick(params, st, inner, compute_dtype=cd, **tick_kw)
        t_p, h_p, prev_p, pos_p, gaps = fused.gru_loop_reference(
            wf, st.prompt, st.plen, st.total, st.prev, st.pos, st.h, inner, cd,
            temp=st.temp, seed=12345, top_k=20, top_p=0.9, margins=True)
        check(torch.equal(s_k.pos, pos_p), f"{tag}: tick {cdn}: cursors differ")
        agree, forked = first_divergence_near_ties(t_k.int(), t_p, gaps, NEAR_TIE[cdn],
                                                   f"{tag}: sampled tick {cdn}")
        res[cdn] = (agree, forked)
    greedy_st = init_state(params, n_slots, 64)
    greedy_st.prompt, greedy_st.plen, greedy_st.total = st.prompt, st.plen, st.total
    tick_ms = cuda_ms(lambda: fused.fused_slot_tick(params, greedy_st, inner,
                                                    compute_dtype=bf16), n=10)
    # two launches on the same inputs give the same bits
    first = fused.fused_slot_tick(params, greedy_st, inner, compute_dtype=bf16)
    second = fused.fused_slot_tick(params, greedy_st, inner, compute_dtype=bf16)
    check(torch.equal(first[1], second[1]) and all(
        torch.equal(getattr(first[0], f), getattr(second[0], f)) for f in ("h", "prev", "pos")),
        f"{tag}: two tick launches on the same inputs differ")
    del first, second
    tick_plain_ms = cuda_ms(lambda: fused.gru_loop_reference(
        wf, greedy_st.prompt, greedy_st.plen, greedy_st.total, greedy_st.prev,
        greedy_st.pos, greedy_st.h, inner, bf16), n=1, warmup=1)
    # teacher-forced tick (the prompt covers the whole tick): h must agree
    tf_st = init_state(params, n_slots, inner)
    tf_st.prompt = torch.from_numpy(rng.integers(0, v, (n_slots, inner)).astype(np.int32)).to(dev)
    tf_st.plen = torch.full((n_slots,), inner, dtype=torch.int32, device=dev)
    tf_st.total = tf_st.plen.clone()
    s_k, t_k = fused.fused_slot_tick(params, tf_st, inner, compute_dtype=f32)
    t_p, h_p, *_ = fused.gru_loop_reference(wf, tf_st.prompt, tf_st.plen, tf_st.total,
                                            tf_st.prev, tf_st.pos, tf_st.h, inner, f32)
    tick_err = float((s_k.h - h_p).abs().max())
    check(torch.equal(t_k.int(), t_p) and tick_err <= 1e-4,
          f"{tag}: teacher-forced tick: tokens equal {torch.equal(t_k.int(), t_p)}, h err "
          f"{tick_err:.3g}")

    def tf_tick(cd, t):
        s, toks_t = fused.fused_slot_tick(params, tf_st, t, compute_dtype=cd)
        return toks_t, s.h

    tick_tf = tf_h_check(tf_tick, lambda cd, t: fused.gru_loop_reference(
        wf, tf_st.prompt, tf_st.plen, tf_st.total, tf_st.prev, tf_st.pos, tf_st.h, t, cd),
        inner, f"{tag}: teacher-forced tick B={n_slots}")
    weight_bytes = tensor_bytes(wf.emb, wf.wc, wf.ws, wf.uc, wf.us, wf.bias, wf.dc, wf.ds,
                                wf.dbias)
    ops = 2 * v * e * 3 * u + 2 * n_slots * inner * (3 * u * u + u * v)
    # in: prompt, plen/total/prev/pos, h; out: prev/pos, h, uint8 tokens
    nbytes = (weight_bytes + tids.nbytes + n_slots * (4 * 4 + 4 * u)
              + n_slots * (4 * 2 + 4 * u) + n_slots * inner)
    b_ms, b_by = bound(nbytes, ops, "bfloat16")
    log(f"[{tag}] one tick B={n_slots} inner={inner}, {wf.mode} weight route, sampled (0.8, "
        f"top-k 20, top-p 0.9): f32 token agreement {res['float32'][0]:.6f} "
        f"({res['float32'][1]} rows fork, at near-ties) | bf16 agreement "
        f"{res['bfloat16'][0]:.6f} ({res['bfloat16'][1]} rows fork, at near-ties) | "
        f"teacher-forced tick, tokens equal: bf16 {tf_summary(tick_tf)}; f32 T={inner}: h max "
        f"abs err {tick_err:.3g} | greedy bf16 tick kernel {tick_ms:.3f} ms, plain "
        f"{tick_plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by}), two launches bit-equal")
    launches, plan = main_run
    return dict(launches=launches, max_abs_err=tick_tf[inner][0], ms=tick_ms,
                plain_ms=tick_plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                plan=str(plan))


def calibrated_gru_phase(tag, name, params_km, km_cpu, ids, lens, rng, tok, n_slots, inner):
    """A calibrated q4_k_m GRU (q4_k cell, q8_0 head) on the card: ``generate``
    at GENERATE_SHAPE, f32 and bf16 (the f32 tokens against the CPU run under
    the near-tie rule), ``decode`` at DECODE_SHAPE through the persistent
    kernel's dense weight route, and an engine serving REQUESTS_ROUTE
    requests with the tick checks. Returns (generate's launches, the decode
    entry, the tick entry)."""
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused

    f32, bf16 = torch.float32, torch.bfloat16
    B, T = GENERATE_SHAPE
    route = fused._prep_weights(params_km).mode
    check((params_km.cell.recurrent_kernel.qtype, params_km.dense_kernel.qtype, route)
          == ("q4_k", "q8_0", "dense"), f"{tag}: {name} loaded as {route}")
    port.reset_kernel_launches()
    t0 = time.perf_counter()
    out32 = gru_textgen.generate(params_km, ids, lens, T, compute_dtype=f32)
    out16 = gru_textgen.generate(params_km, ids, lens, T, compute_dtype=bf16)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = port.kernel_launches()
    check(launches["qmatmul_q4_k"] > 0, f"{tag}: generate launched no qmatmul_q4_k: {launches}")
    check(all(o.shape == (B, T) and int(o.min()) >= 0 and int(o.max()) < 66
              for o in (out32, out16)), f"{tag}: generate output shape/range")
    ref32 = gru_textgen.generate(km_cpu, ids, lens, T, compute_dtype=f32)
    z = torch.zeros(B, dtype=torch.int32)
    tf = torch.full((B,), T, dtype=torch.int32)
    *_, gaps = fused.gru_loop_reference(fused._prep_weights(km_cpu), ref32, tf, tf, z, z,
                                        torch.zeros(B, 1024), T, f32, margins=True)
    agree, forked = first_divergence_near_ties(out32.cpu(), ref32, gaps, NEAR_TIE["float32"],
                                               f"{tag}: generate f32 cuda vs cpu")
    log(f"[{tag}] generate B={B} T={T} from {name} f32+bf16 in {gen_s:.2f} s | "
        f"qmatmul_q4_k launches {launches['qmatmul_q4_k']} | f32 tokens vs the CPU run: "
        f"agreement {agree:.6f}, {forked} rows fork (all at near-ties) | sample: "
        f"{tok.decode(out16[0].tolist())[:60]!r}")
    dec = decode_phase(tag, params_km, *DECODE_SHAPE, TF_F32_SHAPE, rng, tok)
    tick_run = engine_phase(tag, params_km, REQUESTS_ROUTE, n_slots, inner, rng, tok)
    return launches, dec, tick_phase(tag, params_km, n_slots, inner, tick_run, rng, tok)


def cudnn_gru_ms(B, T, u, dev):
    """The library yardstick of the training pair: ``torch.nn.GRU(256, u)``
    on cuDNN (the same reset-after cell, gates in another order; it also
    computes the input projection), forward and ``torch.autograd.grad`` of
    its output, bf16 (fp16 where cuDNN refuses bf16). (fwd ms, bwd ms, dtype)."""
    import torch

    err = None
    for dt in (torch.bfloat16, torch.float16):
        try:
            gru = torch.nn.GRU(256, u).to(dev, dt)
            gru.flatten_parameters()
            g = torch.Generator(device=dev).manual_seed(B)
            x = torch.randn((T, B, 256), generator=g, device=dev).to(dt).requires_grad_()
            h0 = (torch.randn((1, B, u), generator=g, device=dev) * 0.3).to(dt).requires_grad_()
            dy = (torch.randn((T, B, u), generator=g, device=dev) * 0.01).to(dt)
            leaves = [x, h0, *gru.parameters()]
            fwd = cuda_ms(lambda: gru(x, h0), n=5, warmup=1)
            out, _ = gru(x, h0)
            bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True), n=5,
                          warmup=1)
            return fwd, bwd, str(dt)[6:]
        except RuntimeError as ex:
            err = ex
    raise SmokeFailure(f"torch.nn.GRU on cuDNN refused bf16 and fp16: {err}")


def train_kernel_phase(tag, fparams, dev, tok):
    """The fused training kernels against their plain versions at
    TRAIN_SHAPES, bf16, U=1024: the trained recurrent kernel and bias, the
    input projection of corpus windows, a seeded h0 and cotangent; each plan
    the default does not take forced at those shapes; then the backward
    alone at TRAIN_LARGE_SHAPES, one launch of each kernel. Returns {(B, T):
    {"fwd": readings, "bwd": readings, "dwr": readings}}."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft
    from ggml_experiments_tpu_torch.ops.gru import input_projection
    from ggml_experiments_tpu_torch.training.data import DataConfig, load_corpus, make_examples

    bf16 = torch.bfloat16
    cell = fparams.cell
    u = cell.units
    wr = cell.recurrent_kernel.to(bf16).contiguous()
    brec = cell.bias[1].float().contiguous()
    text = load_corpus(CORPUS_TRAIN)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def operands(B, T):
        ex = make_examples(text, tok, DataConfig(seq_length=T))
        ids = ex[np.random.default_rng(B).permutation(len(ex))[:B], :T]
        check(ids.shape == (B, T), f"{tag}: the corpus gives {ids.shape} windows, want {(B, T)}")
        xs = fparams.embeddings[torch.from_numpy(ids.T.copy()).long().to(dev)]   # (T, B, E)
        mxs = input_projection(cell, xs, compute_dtype=bf16).contiguous()
        g = torch.Generator(device=dev).manual_seed(B)
        h0 = (torch.randn((B, u), generator=g, device=dev) * 0.3).to(bf16)
        dys = (torch.randn((T, B, u), generator=g, device=dev) * 0.01).to(bf16)
        return mxs, h0, dys

    def check_backward(what, got, again, want):
        rel = {}
        for name, a, a2, w in zip(("dmxs", "dwr", "dbrec", "dh0"), got, again, want):
            check(a.shape == w.shape and bool(torch.isfinite(a.float()).all()),
                  f"{tag}: {what}: {name} shape or values")
            check(torch.equal(a, a2), f"{tag}: {what}: two launches on the same inputs give "
                                      f"different {name}")
            rel[name] = float((a.float() - w.float()).abs().max()) / float(w.float().abs().max())
            check(rel[name] <= TRAIN_GRAD_REL[name],
                  f"{tag}: {what}: {name} max |diff| / max |plain| = {rel[name]:.3g} > "
                  f"{TRAIN_GRAD_REL[name]}")
        return rel

    out = {}
    for B, T in TRAIN_SHAPES:
        mxs, h0, dys = operands(B, T)
        plan = ft.train_plan(B, u, sms)
        ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
        torch.cuda.synchronize()
        check(ft.LAST_PLAN["fused_gru_train_fwd"] == plan, f"{tag}: forward B={B} ran "
                                                           f"{ft.LAST_PLAN} for {plan}")
        pys, pmhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
        # the yardstick of tf_h_check: the plain version's own distance
        # between rounding to bf16 and not rounding, on the same operands
        fys, _ = ft.gru_train_fwd_plain(mxs.float(), h0.float(), wr.float(), brec)
        d_f = (fys - pys.float()).abs()
        gap, s_gap = float(d_f.mean()), float(d_f[:TF_BF16_SHORT].mean())
        del d_f, fys

        def fwd_check(ys, mhs, what):
            d_ys = (ys.float() - pys.float()).abs()
            ys_max, ys_mean = float(d_ys.max()), float(d_ys.mean())
            s_mean = float(d_ys[:TF_BF16_SHORT].mean())
            d_mh = (mhs.float() - pmhs.float()).abs()
            mh_max, mh_mean = float(d_mh.max()), float(d_mh.mean())
            check(ys_max <= TRAIN_YS_MAX and mh_max <= TRAIN_MHS_MAX
                  and ys_mean <= TF_BF16_MEAN_FRAC_LONG * gap
                  and s_mean <= TF_BF16_MEAN_FRAC_SHORT * s_gap,
                  f"{tag}: {what}: ys max abs err {ys_max:.3g} (limit {TRAIN_YS_MAX}), mhs max "
                  f"{mh_max:.3g} (limit {TRAIN_MHS_MAX}), ys mean {ys_mean:.3g} (limit "
                  f"{TF_BF16_MEAN_FRAC_LONG} x {gap:.3g}), over the first {TF_BF16_SHORT} steps "
                  f"{s_mean:.3g} (limit {TF_BF16_MEAN_FRAC_SHORT} x {s_gap:.3g})")
            return ys_max, ys_mean, s_mean, mh_max, mh_mean

        ys_max, ys_mean, s_mean, mh_max, mh_mean = fwd_check(ys, mhs, f"forward B={B} T={T}")
        fwd_ms = cuda_ms(lambda: ft.gru_train_fwd_cuda(mxs, h0, wr, brec), n=5, warmup=1)
        fwd_plain_ms = cuda_ms(lambda: ft.gru_train_fwd_plain(mxs, h0, wr, brec), n=2, warmup=1)
        nbytes = tensor_bytes(mxs, h0, wr, brec, ys, mhs)
        fb_ms, fb_by = bound(nbytes, 2 * T * B * u * 3 * u, "bfloat16")
        lib_fwd, lib_bwd, lib_dt = cudnn_gru_ms(B, T, u, dev)
        log(f"[{tag}] forward B={B} T={T} U={u} bf16, plan {tuple(plan)}: ys max abs err "
            f"{ys_max:.3g}, mean {ys_mean:.3g} (plain f32 vs bf16: {gap:.3g}), first "
            f"{TF_BF16_SHORT} steps mean {s_mean:.3g} (plain f32 vs bf16: {s_gap:.3g}) | mhs max "
            f"{mh_max:.3g}, mean {mh_mean:.3g} | kernel {fwd_ms:.3f} ms = "
            f"{fwd_ms * 1e3 / T:.1f} us/step | plain {fwd_plain_ms:.2f} ms | bound "
            f"{fb_ms:.3f} ms ({fb_by}) | library: torch.nn.GRU(256, {u}) on cuDNN ({lib_dt}) "
            f"{lib_fwd:.3f} ms")

        # backward from the plain forward's residuals, so both sides get equal inputs
        before = dict(ft.LAUNCHES)
        got = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr)
        check(all(ft.LAUNCHES[k] - before[k] == 1 for k in ("fused_gru_train_bwd",
                                                            "fused_gru_train_dwr")),
              f"{tag}: backward B={B} launched {before} -> {ft.LAUNCHES}")
        again = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr)
        torch.cuda.synchronize()
        want = ft.gru_train_bwd_plain(mxs, pmhs, pys, dys, h0, wr)
        rel = check_backward(f"backward B={B} T={T}", got, again, want)
        dmx_abs = float((got[0].float() - want[0].float()).abs().max())
        del again
        # the two kernels of the backward apart, on the plain recurrence's operands
        dmxs, plane, _, _ = ft.gru_train_bwd_rec_plain(mxs, pmhs, pys, dys, h0, wr)
        dwr_k = ft.gru_train_dwr_cuda(h0, pys, dmxs, plane)
        dwr_p = ft.gru_train_dwr_plain(h0, pys, dmxs, plane)
        dwr_abs = float((dwr_k - dwr_p).abs().max())
        dwr_rel = dwr_abs / float(dwr_p.abs().max())
        # both sides against the same sum in f64: how far each f32 order strays
        dwr_64 = ft.gru_train_dwr_plain(h0.double(), pys.double(), dmxs.double(), plane.double())
        k64, p64 = (float((x.double() - dwr_64).abs().max()) / float(dwr_64.abs().max())
                    for x in (dwr_k, dwr_p))
        del dwr_64
        check(dwr_rel <= TRAIN_DWR_REL and torch.equal(
                  dwr_k, ft.gru_train_dwr_cuda(h0, pys, dmxs, plane)),
              f"{tag}: dWr B={B} T={T}: max |diff| / max |plain| = {dwr_rel:.3g} (limit "
              f"{TRAIN_DWR_REL}), or two launches differ")
        rec_ms = cuda_ms(lambda: ft.gru_train_bwd_rec_cuda(mxs, pmhs, pys, dys, h0, wr), n=5,
                         warmup=1)
        rec_plain_ms = cuda_ms(lambda: ft.gru_train_bwd_rec_plain(mxs, pmhs, pys, dys, h0, wr),
                               n=2, warmup=1)
        dwr_ms = cuda_ms(lambda: ft.gru_train_dwr_cuda(h0, pys, dmxs, plane), n=5, warmup=1)
        dwr_plain_ms = cuda_ms(lambda: ft.gru_train_dwr_plain(h0, pys, dmxs, plane), n=2,
                               warmup=1)
        bwd_ms = cuda_ms(lambda: ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr), n=5,
                         warmup=1)
        # the library's GEMM for dWr: [h0; ys[:-1]]^T . dmh in one bf16 call
        hp_all = torch.cat([h0[None], pys[:-1]]).reshape(T * B, u)
        dmh_all = torch.cat([dmxs[..., :2 * u], plane], dim=2).reshape(T * B, 3 * u)
        dwr_lib_ms = cuda_ms(lambda: torch.matmul(hp_all.t(), dmh_all), n=5, warmup=1)
        del hp_all, dmh_all
        ops = 2 * T * B * u * 3 * u
        rb_ms, rb_by = bound(tensor_bytes(mxs, pmhs, pys, dys, h0, wr, got[0], plane, got[2],
                                          got[3]), ops, "bfloat16")
        db_ms, db_by = bound(tensor_bytes(h0, pys, dmxs, plane, dwr_k), ops, "bfloat16")
        log(f"[{tag}] backward B={B} T={T} U={u} bf16, plan {tuple(plan)}: max |diff| / max "
            f"|plain|: " + ", ".join(f"{n} {rel[n]:.3g}" for n in rel)
            + f" | two launches bit-equal | recurrence + dWr {bwd_ms:.3f} ms | recurrence "
              f"{rec_ms:.3f} ms = {rec_ms * 1e3 / T:.1f} us/step, plain {rec_plain_ms:.2f} ms, "
              f"bound {rb_ms:.3f} ms ({rb_by}) | dWr {dwr_ms:.3f} ms (max |diff| / max |plain| "
              f"{dwr_rel:.3g} on equal operands; against the f64 sum: kernel {k64:.3g}, plain "
              f"{p64:.3g}; two launches bit-equal), plain "
              f"{dwr_plain_ms:.2f} ms, bound {db_ms:.3f} ms ({db_by}), torch.matmul "
              f"{dwr_lib_ms:.3f} ms | library: torch.nn.GRU backward on cuDNN ({lib_dt}) "
              f"{lib_bwd:.3f} ms")

        # every other plan, forced
        for other in ft.train_plans(B, u, sms):
            if other == plan:
                continue
            ys2, mhs2 = ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=other)
            ys3, _ = ft.gru_train_fwd_cuda(mxs, h0, wr, brec, config=other)
            g2 = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr, config=other)
            a2 = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr, config=other)
            torch.cuda.synchronize()
            check(torch.equal(ys2, ys3), f"{tag}: forward B={B}, plan {tuple(other)}: two "
                                         f"launches differ")
            o_max = fwd_check(ys2, mhs2, f"forward B={B} T={T}, plan {tuple(other)}")[0]
            o_rel = check_backward(f"backward B={B} T={T}, plan {tuple(other)}", g2, a2, want)
            log(f"[{tag}] plan {tuple(other)} forced at B={B} T={T}: forward ys max abs err "
                f"{o_max:.3g}, backward max rel " + ", ".join(f"{n} {v:.3g}"
                                                              for n, v in o_rel.items())
                + " | two launches bit-equal")
            del ys2, mhs2, ys3, g2, a2
        out[(B, T)] = {
            "fwd": dict(max_abs_err=ys_max, ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=fb_ms,
                        bound_by=fb_by, library_ms=lib_fwd, plan=tuple(plan)),
            "bwd": dict(max_abs_err=dmx_abs, ms=rec_ms, plain_ms=rec_plain_ms, bound_ms=rb_ms,
                        bound_by=rb_by, library_ms=lib_bwd, plan=tuple(plan)),
            "dwr": dict(max_abs_err=dwr_abs, ms=dwr_ms, plain_ms=dwr_plain_ms, bound_ms=db_ms,
                        bound_by=db_by, library_ms=dwr_lib_ms),
            "bwd_total_ms": bwd_ms}
        del got, want, ys, mhs, pys, pmhs, mxs, dys, dmxs, plane, dwr_k, dwr_p

    # the backward at batches the old kernel took only in row tiles: one
    # launch of each kernel on the default plan
    for B, T in TRAIN_LARGE_SHAPES:
        mxs, h0, dys = operands(B, T)
        pys, pmhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
        plan = ft.train_plan(B, u, sms)
        before = dict(ft.LAUNCHES)
        got = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr)
        check(all(ft.LAUNCHES[k] - before[k] == 1 for k in ("fused_gru_train_bwd",
                                                            "fused_gru_train_dwr"))
              and ft.LAST_PLAN["fused_gru_train_bwd"] == plan,
              f"{tag}: backward B={B} launched {before} -> {ft.LAUNCHES} on "
              f"{ft.LAST_PLAN.get('fused_gru_train_bwd')} for {plan}")
        again = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr)
        torch.cuda.synchronize()
        want = ft.gru_train_bwd_plain(mxs, pmhs, pys, dys, h0, wr)
        rel = check_backward(f"backward B={B} T={T}", got, again, want)
        ms = cuda_ms(lambda: ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr), n=3, warmup=1)
        log(f"[{tag}] backward B={B} T={T} U={u} bf16, plan {tuple(plan)} (one launch of each "
            f"kernel): max |diff| / max |plain|: " + ", ".join(f"{k} {v:.3g}"
                                                              for k, v in rel.items())
            + f" | two runs bit-equal | {ms:.3f} ms")
        del got, again, want, pys, pmhs, mxs, dys
    return out


def params_equal(a, b):
    import torch

    from ggml_experiments_tpu_torch.training.gru_trainer import param_leaves

    return all(torch.equal(x, y) for (_, x), (_, y) in zip(param_leaves(a), param_leaves(b)))


def profiled_step_shares(step, n):
    """``n`` calls of ``step()`` under ``torch.profiler``: device ms a step by
    kernel group, and the device's idle share of the window's wall clock.
    Returns None where the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    groups = {"backward kernel": 0.0, "dWr kernel": 0.0, "forward kernel": 0.0,
              "library products": 0.0, "other device work": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue    # an operator's row repeats its kernels' time
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3 / n
        if "gru_train_bwd_kernel" in e.key:
            groups["backward kernel"] += ms
        elif "gru_train_dwr_kernel" in e.key:
            groups["dWr kernel"] += ms
        elif "gru_train_fwd_kernel" in e.key:
            groups["forward kernel"] += ms
        elif any(w in e.key for w in ("gemm", "nvjet", "cutlass", "cublas")):
            groups["library products"] += ms
        else:
            groups["other device work"] += ms
    busy = sum(groups.values())
    if busy <= 0.0:
        return None
    return dict(groups, wall_ms=wall_ms, busy_ms=busy, idle_share=max(0.0, 1.0 - busy / wall_ms))


def train_phase(tag, dev, tok, kernel_ms):
    """The training main path at full width (see the module docstring, 12).
    ``kernel_ms`` is (forward, backward recurrence + dWr) kernel time at the
    main shape, for the step's breakdown. Returns the kernels' launches on the main run."""
    import contextlib
    import io

    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch import cli
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params, save_gru_params
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.models.gru_textgen import GRUConfig
    from ggml_experiments_tpu_torch.ops import fused_gru_train as ft
    from ggml_experiments_tpu_torch.training import TrainConfig, train, train_from_text
    from ggml_experiments_tpu_torch.training.data import (
        DataConfig,
        batches,
        load_corpus,
        make_examples,
    )
    from ggml_experiments_tpu_torch.training.gru_trainer import (
        adam_init,
        adam_update,
        loss_fn,
        make_train_step,
        param_leaves,
    )

    bf16 = torch.bfloat16
    B, T = TRAIN_SHAPES[0]
    text = load_corpus(CORPUS_TRAIN)
    data = DataConfig(seq_length=T, batch_size=B)
    tc = TrainConfig(epochs=1, log_every=1, compute_dtype=bf16)
    n_steps = len(make_examples(text, tok, data)) // B
    check(n_steps >= TRAIN_RESUME_AFTER + 2, f"{tag}: the corpus gives only {n_steps} batches")

    port.reset_kernel_launches()
    for k in ft.PLAIN_CALLS:
        ft.PLAIN_CALLS[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, history, _ = train_from_text(text, model_config=GRUConfig(), train_config=tc,
                                         data_config=data, seed=0)
    torch.cuda.synchronize()
    launches = port.kernel_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in history]
    check(params.device.type == "cuda" and params.cell.recurrent_kernel.shape == (1024, 3072),
          f"{tag}: trained params are not the full-width model on the card")
    check(len(history) == n_steps and all(np.isfinite(losses)),
          f"{tag}: {len(history)} steps logged of {n_steps}, losses {losses}")
    check(losses[-1] < losses[0] - 0.15, f"{tag}: the loss did not fall: {losses}")
    check(all(launches[k] == n_steps for k in TRAIN_KERNELS) and not any(ft.PLAIN_CALLS.values()),
          f"{tag}: {n_steps} steps launched {launches}, plain-version runs {ft.PLAIN_CALLS}")
    # steady-state step time: the history's clock stops after each step's loss
    # was read back; the first step also loads the kernels
    steps_s = np.diff([h["elapsed_s"] for h in history])
    step_ms = float(np.median(steps_s)) * 1e3
    # Adam alone, on a scratch copy of the model with seeded gradients
    scratch = gru_textgen.init_params(GRUConfig(), torch.Generator().manual_seed(1), device=dev)
    leaves = [t.requires_grad_(True) for _, t in param_leaves(scratch)]
    grads = [torch.randn_like(t) for t in leaves]
    adam = adam_init(scratch)[0]
    adam_ms = cuda_ms(lambda: adam_update(scratch, grads, adam, 1e-3), n=5, warmup=1)
    # three more steps on the scratch model under the profiler
    step_fn = make_train_step(1e-3, compute_dtype=bf16)
    inp, tgt = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in next(iter(batches(
        make_examples(text, tok, data), data, seed=0))))
    before = port.kernel_launches()
    prof = profiled_step_shares(lambda: step_fn(scratch, (adam,), inp, tgt), 3)
    after = port.kernel_launches()
    check(all(after[k] - before[k] == 3 for k in TRAIN_KERNELS),
          f"{tag}: the profiled steps launched {before} -> {after}")
    del grads, adam, scratch, inp, tgt
    rest_ms = step_ms - sum(kernel_ms) - adam_ms
    log(f"[{tag}] train_from_text corpus_train.txt bf16 B={B} T={T} E=256 U=1024: {n_steps} "
        f"steps, loss {losses[0]:.4f} -> {losses[-1]:.4f} | launches fwd "
        f"{launches['fused_gru_train_fwd']} bwd {launches['fused_gru_train_bwd']} dWr "
        f"{launches['fused_gru_train_dwr']}, plain-version runs 0 | {step_ms:.2f} ms/step "
        f"(median of {len(steps_s)}, loss read back each step) = "
        f"{B * T / step_ms * 1e3:,.0f} tokens/s | of a step: forward kernel {kernel_ms[0]:.2f} "
        f"ms, backward kernels {kernel_ms[1]:.2f} ms, Adam {adam_ms:.2f} ms, the rest (input "
        f"projection, vocab head, their gradients, loss, host) {rest_ms:.2f} ms | peak device "
        f"memory {peak_gb:.2f} GB")
    if prof is None:
        log(f"[{tag}] torch.profiler recorded no device time: the step is not split further")
    else:
        log(f"[{tag}] 3 steps under torch.profiler: {prof['wall_ms']:.2f} ms/step wall, device "
            f"busy {prof['busy_ms']:.2f} ms/step (idle share {prof['idle_share']:.3f}): "
            + ", ".join(f"{k} {prof[k]:.2f} ms" for k in ("backward kernel", "dWr kernel",
                                                          "forward kernel", "library products",
                                                          "other device work")))

    # the same run through train(), whole and interrupted + resumed
    def fresh():
        init = gru_textgen.init_params(GRUConfig(), torch.Generator().manual_seed(0), device=dev)
        return init, list(batches(make_examples(text, tok, data), data, seed=0, epochs=1))

    with tempfile.TemporaryDirectory() as tmp:
        init, stream = fresh()
        whole, _ = train(init, stream, tc)
        check(params_equal(whole, params), f"{tag}: train() and train_from_text() differ on the "
                                           f"same seed: the step is not reproducible")
        ck = os.path.join(tmp, "resume.gxt")
        tcr = TrainConfig(epochs=1, log_every=1, compute_dtype=bf16, resume_path=ck,
                          save_every=TRAIN_RESUME_AFTER - 1)
        train(init, stream[:TRAIN_RESUME_AFTER], tcr)
        size = os.path.getsize(ck)
        resumed, hist = train(init, stream, tcr)
        check(hist[0]["step"] == TRAIN_RESUME_AFTER, f"{tag}: resumed at step {hist[0]['step']}")
        check(params_equal(resumed, params), f"{tag}: the resumed run's parameters differ from "
                                             f"the uninterrupted run's")
        log(f"[{tag}] interrupted after {TRAIN_RESUME_AFTER} steps, resumed from its train-state "
            f"file ({size:,} bytes, saved after step {TRAIN_RESUME_AFTER - 1}) at step "
            f"{hist[0]['step']}: all {len(leaves)} parameter tensors bit-equal to the "
            f"uninterrupted run, and train() bit-equal to train_from_text()")
        del whole, resumed, init, stream

        # export and read back
        out = os.path.join(tmp, "gru.bin")
        save_gru_params(out, params)
        back = load_gru_params(out, qtype="q8_0", device=dev)
        ids, lens = tok.encode_batch(["ROMEO:", "the ", "What"])
        toks = gru_textgen.generate(back, ids, lens, 100)
        check(toks.shape == (3, 100) and int(toks.min()) >= 0 and int(toks.max()) < 66,
              f"{tag}: generate from the exported gru.bin: shape/range")
        log(f"[{tag}] exported gru.bin ({os.path.getsize(out):,} bytes) -> generate (q8_0) "
            f"after {n_steps} steps of training: {tok.decode(toks[0].tolist())[:60]!r}")
        del back

        # the command at its default batch size
        small = os.path.join(tmp, "corpus.txt")
        with open(small, "w") as f:
            f.write(text[:TRAIN_CLI_CHARS])
        cli_out = os.path.join(tmp, "cli_gru.bin")
        before = port.kernel_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["train-gru", "--corpus", small, "--epochs", "1", "--compute",
                           "bfloat16", "--log-every", "1", "--output", cli_out])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        after = port.kernel_launches()
        summary = json.loads(buf.getvalue().splitlines()[-1])
        cli_steps = (TRAIN_CLI_CHARS // 101) // 64
        check(rc == 0 and summary["steps"] == cli_steps - 1
              and np.isfinite(summary["final_loss"]) and os.path.exists(cli_out),
              f"{tag}: train-gru: rc {rc}, summary {summary}")
        check(all(after[k] - before[k] == cli_steps for k in TRAIN_KERNELS)
              and not any(ft.PLAIN_CALLS.values()),
              f"{tag}: train-gru launched {before} -> {after}")
        log(f"[{tag}] train-gru at its defaults (B=64, T=100, E=256, U=1024) bf16, "
            f"{cli_steps} steps on the corpus's first {TRAIN_CLI_CHARS:,} characters: "
            f"{json.dumps(summary)} in {cli_s:.2f} s | one forward, one backward and one dWr "
            f"launch a step, plan {tuple(ft.train_plan(64, 1024))}")

        # the command at a batch past one backward launch's shared memory
        big_out = os.path.join(tmp, "big_gru.bin")
        big = DataConfig(seq_length=T, batch_size=TRAIN_BIG_BATCH)
        big_steps = len(make_examples(text, tok, big)) // TRAIN_BIG_BATCH
        plan = ft.train_plan(TRAIN_BIG_BATCH, 1024)
        before = port.kernel_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["train-gru", "--corpus", CORPUS_TRAIN, "--epochs", "1", "--compute",
                           "bfloat16", "--batch-size", str(TRAIN_BIG_BATCH), "--log-every", "1",
                           "--output", big_out])
        torch.cuda.synchronize()
        big_s = time.perf_counter() - t0
        after = port.kernel_launches()
        summary = json.loads(buf.getvalue().splitlines()[-1])
        check(rc == 0 and summary["steps"] == big_steps - 1 and np.isfinite(summary["final_loss"])
              and os.path.exists(big_out), f"{tag}: train-gru B={TRAIN_BIG_BATCH}: rc {rc}, "
                                           f"summary {summary}")
        check(all(after[k] - before[k] == big_steps for k in TRAIN_KERNELS)
              and not any(ft.PLAIN_CALLS.values()),
              f"{tag}: train-gru B={TRAIN_BIG_BATCH} launched {before} -> {after}")
        # its loss falls: the exported weights against the initial ones (the
        # command's seed 0) on the corpus's first windows
        inp, tgt = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in next(iter(
            batches(make_examples(text, tok, DataConfig(seq_length=T, batch_size=256)),
                    DataConfig(seq_length=T, batch_size=256), seed=1))))
        init = gru_textgen.init_params(GRUConfig(), torch.Generator().manual_seed(0), device=dev)
        trained = load_gru_params(big_out, device=dev)
        with torch.no_grad():
            loss0, loss1 = (float(loss_fn(p, inp, tgt)) for p in (init, trained))
        check(loss1 < loss0, f"{tag}: train-gru B={TRAIN_BIG_BATCH}: loss {loss0:.4f} before, "
                             f"{loss1:.4f} after")
        log(f"[{tag}] train-gru --batch-size {TRAIN_BIG_BATCH} bf16, {big_steps} steps on "
            f"corpus_train.txt: {json.dumps(summary)} in {big_s:.2f} s | launches fwd "
            f"{after['fused_gru_train_fwd'] - before['fused_gru_train_fwd']}, bwd "
            f"{after['fused_gru_train_bwd'] - before['fused_gru_train_bwd']}, dWr "
            f"{after['fused_gru_train_dwr'] - before['fused_gru_train_dwr']} (one each a step, "
            f"plan {tuple(plan)}) | loss on 256 corpus windows: {loss0:.4f} initial -> {loss1:.4f} "
            f"exported")
        del init, trained
    return launches



LAYER_KERNELS = ("transformer_ln_qkv", "transformer_attention", "transformer_proj_ffn")


def ir_bound(b, h, w, c, e, cout):
    """Least time (ms) of the inverted residual on an H100 and what bounds
    it: the bytes (x and the output once, the weights) at HBM_BYTES_PER_S;
    the two 1x1 products at the bf16 tensor rate; the depthwise's 18
    operations an expanded element at the f32 CUDA-core rate; one MUFU
    exponential a SiLU (two SiLUs an expanded element) at MUFU_EXP_PER_S."""
    px = b * h * w
    parts = {"bytes": (px * (c + cout) * 2 + (c * e + e * cout) * 2 + (11 * e + cout) * 4)
             / HBM_BYTES_PER_S,
             "tensor": px * 2 * (c * e + e * cout) / PEAK_OPS["bfloat16"],
             "depthwise": px * 18 * e / PEAK_OPS["float32"],
             "mufu": px * 2 * e / MUFU_EXP_PER_S}
    parts = {k: v * 1e3 for k, v in parts.items()}
    by = max(parts, key=parts.get)
    return parts[by], by, parts


def cudnn_inverted_residual(x, args):
    """The block as cuDNN computes it, the library column of kernel 8 (timed
    only, never called by the port): three ``F.conv2d`` in channels_last
    bf16 with BN folded into weights and biases, ``F.silu`` after the first
    two, ``+ x``."""
    import torch
    import torch.nn.functional as F

    wexp, bexp, kdw, bdw, wred, bred = args
    bf, cl = torch.bfloat16, torch.channels_last
    w1 = wexp.t()[:, :, None, None].to(bf).contiguous(memory_format=cl)
    w2 = kdw.permute(2, 0, 1)[:, None].to(bf).contiguous(memory_format=cl)
    w3 = wred.t()[:, :, None, None].to(bf).contiguous(memory_format=cl)
    b1, b2, b3 = bexp.to(bf), bdw.to(bf), bred.to(bf)
    xc = x.permute(0, 3, 1, 2)      # NHWC storage seen as channels_last NCHW

    def chain():
        y = F.silu(F.conv2d(xc, w1, b1))
        y = F.silu(F.conv2d(y, w2, b2, padding=1, groups=w2.shape[0]))
        return F.conv2d(y, w3, b3) + xc

    return chain


def vision_kernel_phase(tag, params, dev):
    """Phase 13: each vision kernel against its plain version on the card at
    the shapes the main path gives it for B=128 images, with the kernel's,
    the plain version's and the library call's times and the bound. The
    fused layer is held whole and kernel by kernel (ln_qkv, attention,
    proj_ffn, each on its plain version's inputs, launched twice: bit-equal).
    Its library call is ``nn.TransformerEncoderLayer(C, H, F, SiLU,
    norm_first)`` in bf16 and eval mode, which has no input or output
    projection; the attention kernel's is ``scaled_dot_product_attention``
    (scale 1: q arrives scaled). Returns {name: kernels-line readings}: a
    forward's worth of launches summed (2 + 4 + 3 layers), errors the largest
    over the shapes."""
    import torch
    import torch.nn.functional as F

    from ggml_experiments_tpu_torch.ops import flash_attention as fa
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir
    from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl

    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(13)
    tot = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_t=[0.0, 0.0],
                   library_ms=None)
           for k in ("fused_transformer_layer", "flash_mha") + LAYER_KERNELS}
    for k in ("flash_mha", "fused_transformer_layer", "transformer_attention"):
        tot[k]["library_ms"] = 0.0

    def add(name, count, err, ms, plain_ms, nbytes, flops, lib_ms=None):
        t = tot[name]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        t["ms"] += count * ms
        t["plain_ms"] += count * plain_ms
        t["bound_t"][0] += count * nbytes / HBM_BYTES_PER_S * 1e3
        t["bound_t"][1] += count * flops / PEAK_OPS["bfloat16"] * 1e3
        if lib_ms is not None:
            t["library_ms"] += count * lib_ms

    def bf16_check(what, key, got, want, want32):
        d = (got.float() - want.float()).abs()
        err, mean = float(d.max()), float(d.mean())
        scale = float(want.float().abs().max())
        gap = float((want32.float() - want.float()).abs().mean())
        check(bool(torch.isfinite(got.float()).all()) and err <= VIT_BF16_MAX[key] * scale
              and mean <= VIT_BF16_MEAN_FRAC[key] * gap,
              f"{what}: max abs err {err:.3g} (limit {VIT_BF16_MAX[key]} x {scale:.3g}), mean "
              f"{mean:.3g} (limit {VIT_BF16_MEAN_FRAC[key]} x {gap:.3g}, the plain version's "
              f"f32-vs-bf16 mean)")
        return err, mean, gap, scale

    # (block, the side of its feature map at 256 px)
    for blk, side in ((params.layer_3, 32), (params.layer_4, 16), (params.layer_5, 8)):
        n = len(blk.transformer)
        cin = blk.conv_1x1.kernel.shape[-2]
        c = blk.conv_1x1.kernel.shape[-1]
        l = (side // blk.patch_size) ** 2
        bp = VIT_BATCH * blk.patch_size ** 2
        pk = blk.conv_projection.kernel
        # kernel 6: the first layer (input_proj), the middle ones, the last
        # (final LN + conv_projection with BN and SiLU), as the block runs them
        variants = [("first", 1, dict(input_proj=blk.conv_1x1.kernel.reshape(cin, c))),
                    ("middle", n - 2, {}),
                    ("last", 1, dict(final_ln=(blk.ln_gamma, blk.ln_beta), final_ln_eps=blk.eps,
                                     output_proj=(pk.reshape(c, -1), blk.conv_projection.bn.scale,
                                                  blk.conv_projection.bn.bias,
                                                  blk.conv_projection.activation)))]
        h = blk.transformer[0].attention.num_heads
        f = blk.transformer[0].intermediate_kernel.shape[-1]
        lib = torch.nn.TransformerEncoderLayer(c, h, f, dropout=0.0, activation=F.silu,
                                               norm_first=True, batch_first=True, device=dev,
                                               dtype=bf16).eval()
        xl = torch.randn((bp, l, c), generator=g, device=dev).to(bf16)
        with torch.no_grad():
            lib_ms = cuda_ms(lambda: lib(xl), n=10)
        del lib, xl
        for name, count, kw in variants:
            if count <= 0:
                continue
            i = {"first": 0, "middle": 1, "last": n - 1}[name]
            layer = blk.transformer[i]
            ops = ftl.layer_operands(layer, c, bf16, **kw)
            ops32 = ftl.layer_operands(layer, c, f32, **kw)
            width = cin if "input_proj" in kw else c
            x = torch.randn((bp, l, width), generator=g, device=dev).to(bf16)
            got = ftl.fused_layer_cuda(x, ops)
            torch.cuda.synchronize()
            want = ftl.fused_transformer_layer_plain(x, ops)
            err, mean, gap, scale = bf16_check(
                f"{tag}: fused layer {name} (bp, L, C) = ({bp}, {l}, {c})", "layer", got, want,
                ftl.fused_transformer_layer_plain(x.float(), ops32))
            del want
            ms = cuda_ms(lambda: ftl.fused_layer_cuda(x, ops), n=10)
            plain_ms = cuda_ms(lambda: ftl.fused_transformer_layer_plain(x, ops), n=2, warmup=1)
            cout = got.shape[-1]
            wbytes = {k: t.numel() * t.element_size() for k, t in (
                ("win", ops.win), ("qkv", ops.wq), ("wo", ops.wo), ("ffn", ops.wi),
                ("wout", ops.wout)) if t is not None}
            t_rows = bp * l
            flops = bp * (4 * l * l * c + 8 * l * c * c + 4 * l * c * f
                          + (2 * l * width * c if "input_proj" in kw else 0)
                          + (2 * l * c * cout if "output_proj" in kw else 0))
            nbytes = t_rows * (width + cout) * 2 + wbytes.get("win", 0) + 3 * wbytes["qkv"] + (
                wbytes["wo"] + 2 * wbytes["ffn"] + wbytes.get("wout", 0))
            b_ms, b_by = bound(nbytes, flops, "bfloat16")
            add("fused_transformer_layer", count, err, ms, plain_ms, nbytes, flops, lib_ms)
            log(f"[{tag}] fused layer {name} x{count}, (bp, L, Cin, C, Cout) = ({bp}, {l}, "
                f"{width}, {c}, {cout}) bf16: max abs err {err:.3g} (largest value {scale:.3g}), "
                f"mean {mean:.3g} (plain f32 vs "
                f"bf16: {gap:.3g}) | kernel {ms:.4f} ms | plain {plain_ms:.3f} ms | bound "
                f"{b_ms:.4f} ms ({b_by}) | nn.TransformerEncoderLayer (no projections) "
                f"{lib_ms:.4f} ms")
            del got, x

            # the three kernels, each on its plain version's inputs. Their bounds
            # count what the layer needs: q, k and v at the head width dh (the
            # kernels' array pads heads to dhp with zero columns), and x.Win once,
            # in ln_qkv (proj_ffn computes it again: the split's own cost)
            dh = c // h
            dhp = ftl.head_pad(dh)
            x2 = torch.randn((t_rows, width), generator=g, device=dev).to(bf16)
            want_qkv = ftl.ln_qkv_plain(x2, ops)
            want_ctx = ftl.attention_plain(want_qkv, l, ops)
            heads = [want_qkv.reshape(bp, l, 3, h, dhp)[:, :, j, :, :dh].transpose(1, 2)
                     .contiguous() for j in range(3)]
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*heads, scale=1.0), n=10)
            del heads
            qkv_bytes = t_rows * 3 * c * 2
            cases = (
                ("transformer_ln_qkv", lambda: ftl.ln_qkv_cuda(x2, ops, l),
                 lambda: ftl.ln_qkv_plain(x2, ops),
                 lambda: ftl.ln_qkv_plain(x2.float(), ops32),
                 t_rows * width * 2 + qkv_bytes + wbytes.get("win", 0) + 3 * wbytes["qkv"],
                 2 * t_rows * (3 * c * c + (width * c if "input_proj" in kw else 0)), None),
                ("transformer_attention", lambda: ftl.attention_cuda(want_qkv, l, ops),
                 lambda: ftl.attention_plain(want_qkv, l, ops),
                 lambda: ftl.attention_plain(want_qkv.float(), l, ops32),
                 qkv_bytes + t_rows * c * 2, 4 * t_rows * l * c, sdpa_ms),
                ("transformer_proj_ffn", lambda: ftl.proj_ffn_cuda(x2, want_ctx, ops, l),
                 lambda: ftl.proj_ffn_plain(x2, want_ctx, ops),
                 lambda: ftl.proj_ffn_plain(x2.float(), want_ctx.float(), ops32),
                 t_rows * (width + c + cout) * 2 + wbytes.get("win", 0) + wbytes["wo"]
                 + 2 * wbytes["ffn"] + wbytes.get("wout", 0),
                 2 * t_rows * (c * c + 2 * c * f + (c * cout if "output_proj" in kw else 0)),
                 None))
            parts = []
            for kname, kernel, plain, plain32, kbytes, kflops, klib in cases:
                kgot, again = kernel(), kernel()
                torch.cuda.synchronize()
                check(torch.equal(kgot, again), f"{tag}: {kname} {name} (bp, L, C) = ({bp}, {l}, "
                                                f"{c}): two launches on the same inputs differ")
                kerr, kmean, kgap, _ = bf16_check(
                    f"{tag}: {kname} {name} (bp, L, C) = ({bp}, {l}, {c})", "layer", kgot,
                    plain(), plain32())
                del kgot, again
                kms = cuda_ms(kernel, n=10)
                kplain = cuda_ms(plain, n=2, warmup=1)
                add(kname, count, kerr, kms, kplain, kbytes, kflops, klib)
                kb_ms, kb_by = bound(kbytes, kflops, "bfloat16")
                parts.append(f"{kname[12:]} {kms:.4f} ms (bound {kb_ms:.4f}, {kb_by}; err "
                             f"{kerr:.3g}, mean {kmean:.3g} of {kgap:.3g})")
            log(f"[{tag}]   its kernels on their plain versions' inputs, each launched twice "
                f"(bit-equal): " + " | ".join(parts) + f" | scaled_dot_product_attention "
                f"{sdpa_ms:.4f} ms")
            del x2, want_qkv, want_ctx
        # kernel 7 at the same (bp, L, C): f32 (the main path) and bf16
        qkv = [torch.randn((bp, l, c), generator=g, device=dev) for _ in range(3)]
        got = fa.flash_mha_cuda(*qkv, h)
        again = fa.flash_mha_cuda(*qkv, h)
        torch.cuda.synchronize()
        want = fa.flash_mha_plain(*qkv, h)
        rel = float((got - want).abs().max()) / float(want.abs().max())
        check(rel <= VIT_F32_REL, f"{tag}: flash f32 (bp, L, C) = ({bp}, {l}, {c}): max rel err "
                                  f"{rel:.3g} > {VIT_F32_REL}")
        q16 = [t.to(bf16) for t in qkv]
        g16 = fa.flash_mha_cuda(*q16, h)
        again16 = fa.flash_mha_cuda(*q16, h)
        torch.cuda.synchronize()
        check(torch.equal(got, again) and torch.equal(g16, again16),
              f"{tag}: flash (bp, L, C) = ({bp}, {l}, {c}): two launches on the same inputs "
              f"differ")
        del again, again16
        w16 = fa.flash_mha_plain(*q16, h)
        err16, mean16, gap16, _ = bf16_check(f"{tag}: flash bf16 (bp, L, C) = ({bp}, {l}, {c})",
                                          "flash", g16, w16,
                                          fa.flash_mha_plain(*(t.float() for t in q16), h))
        ms = cuda_ms(lambda: fa.flash_mha_cuda(*qkv, h), n=10)
        ms16 = cuda_ms(lambda: fa.flash_mha_cuda(*q16, h), n=10)
        plain_ms = cuda_ms(lambda: fa.flash_mha_plain(*qkv, h), n=2, warmup=1)
        heads = [t.reshape(bp, l, h, c // h).transpose(1, 2).contiguous() for t in qkv]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*heads), n=10)
        flops = 4 * bp * l * l * c
        nbytes = 4 * bp * l * c * 4
        # the f32 route's products run as 3xTF32 on the tensor cores
        b_ms, b_by = bound(nbytes, flops, "tf32x3")
        t = tot["flash_mha"]
        t["max_abs_err"] = max(t["max_abs_err"], float((got - want).abs().max()))
        t["ms"] += n * ms
        t["plain_ms"] += n * plain_ms
        t["library_ms"] += n * lib_ms
        t["bound_t"][0] += n * nbytes / HBM_BYTES_PER_S * 1e3
        t["bound_t"][1] += n * flops / PEAK_OPS["tf32x3"] * 1e3
        log(f"[{tag}] flash (bp, L, C, H) = ({bp}, {l}, {c}, {h}) x{n}: f32 max rel err "
            f"{rel:.3g}, two launches bit-equal (f32 and bf16), kernel {ms:.4f} ms = "
            f"{100 * b_ms / ms:.1f}% of bound, {lib_ms / ms:.2f}x "
            f"scaled_dot_product_attention's speed, plain {plain_ms:.3f} ms, "
            f"scaled_dot_product_attention {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) | bf16 "
            f"max abs err {err16:.3g}, mean {mean16:.3g} (plain f32 vs bf16: {gap16:.3g}), "
            f"kernel {ms16:.4f} ms")
        del got, want, qkv, q16, g16, w16, heads
    # the per-sequence kernel (csrc/transformer_layer_seq.cu), the fused layer's
    # route where the row-tile kernels do not take a layer (C past 288, L past
    # 576; no model of the repo has one): every flag on, two launches bit-equal
    for bp, l, c, h, f in SEQ_LAYER_SHAPES:
        def r(*shape, off=0.0):
            return torch.randn(shape, generator=g, device=dev) * 0.2 + off

        cin, cout = c // 2, c // 2 + 8
        ops = ftl.LayerOperands(
            wq=r(c, c).to(bf16), wk=r(c, c).to(bf16), wv=r(c, c).to(bf16), wo=r(c, c).to(bf16),
            wi=r(c, f).to(bf16), wo2=r(f, c).to(bf16), ln1=(r(c, off=1.0), r(c)), bq=r(c),
            bk=r(c), bv=r(c), bo=r(c), ln2=(r(c, off=1.0), r(c)), bi=r(f), bo2=r(c),
            num_heads=h, eps=1e-5, final_ln=(r(c, off=1.0), r(c)), win=r(cin, c).to(bf16),
            wout=r(c, cout).to(bf16), out_affine=(r(cout, off=1.0), r(cout)), out_act=True)
        x = torch.randn((bp, l, cin), generator=g, device=dev).to(bf16)
        before = ftl.LAUNCHES["transformer_sequence"]
        got, again = ftl.fused_layer_cuda(x, ops), ftl.fused_layer_cuda(x, ops)
        torch.cuda.synchronize()
        check(ftl.LAUNCHES["transformer_sequence"] == before + 2 and torch.equal(got, again),
              f"{tag}: per-sequence layer (bp, L, C) = ({bp}, {l}, {c}): not launched twice, "
              f"or two launches differ")
        err, mean, gap, scale = bf16_check(
            f"{tag}: per-sequence layer (bp, L, C) = ({bp}, {l}, {c})", "layer", got,
            ftl.fused_transformer_layer_plain(x, ops), ftl.fused_transformer_layer_plain(
                x.float(), ops))
        ms = cuda_ms(lambda: ftl.fused_layer_cuda(x, ops), n=5)
        log(f"[{tag}] per-sequence layer (bp, L, Cin, C, H, F, Cout) = ({bp}, {l}, {cin}, {c}, "
            f"{h}, {f}, {cout}), every flag: max abs err {err:.3g} (largest value "
            f"{scale:.3g}), mean {mean:.3g} (plain f32 vs bf16: {gap:.3g}), two launches "
            f"bit-equal | kernel {ms:.4f} ms")
        del got, again, x, ops
    for t in tot.values():
        t["bound_ms"] = max(t["bound_t"])
        t["bound_by"] = "bytes" if t["bound_t"][0] >= t["bound_t"][1] else "operations"
        del t["bound_t"]

    # kernel 8 at layer_2's shape, with the residual, on the model's folded
    # weights, made into the kernel's operands once (as the block keeps them)
    b, hh, ww, c, e, cout = VIT_IR_SHAPE
    blk = params.layer_2[1]
    wexp, bexp = fir.folded_conv_weights(blk.expand_1x1)
    kdw, bdw = fir.folded_conv_weights(blk.conv_3x3)
    wred, bred = fir.folded_conv_weights(blk.reduce_1x1)
    args = (wexp.reshape(c, e), bexp, kdw.reshape(3, 3, e), bdw, wred.reshape(e, cout), bred)
    ops = fir.ir_operands(*args)
    x = torch.randn((b, hh, ww, c), generator=g, device=dev).to(bf16)
    got = fir.fused_ir_cuda(x, ops, use_residual=True)
    again = fir.fused_ir_cuda(x, ops, use_residual=True)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{tag}: fused inverted residual: two launches differ")
    plain_args = (args[0].to(bf16), args[1], args[2], args[3], args[4].to(bf16), args[5])
    want = fir.fused_ir_plain(x, *plain_args, use_residual=True)
    err, mean, gap, _ = bf16_check(f"{tag}: fused inverted residual {VIT_IR_SHAPE}", "ir", got,
                                   want, fir.fused_ir_plain(x.float(), *args, use_residual=True))
    del got, again, want
    ms = cuda_ms(lambda: fir.fused_ir_cuda(x, ops, use_residual=True), n=20)
    plain_ms = cuda_ms(lambda: fir.fused_ir_plain(x, *plain_args, use_residual=True), n=3)
    lib_ms = cuda_ms(cudnn_inverted_residual(x, args), n=20)
    b_ms, b_by, parts = ir_bound(b, hh, ww, c, e, cout)
    log(f"[{tag}] fused inverted residual (B, H, W, C, E, Cout) = {VIT_IR_SHAPE} bf16, plan "
        f"{fir.ir_plan(b, hh, ww, c, e, cout)}: max abs err {err:.3g}, mean {mean:.3g} (plain f32 "
        f"vs bf16: {gap:.3g}), two launches bit-equal | kernel {ms:.4f} ms | plain "
        f"{plain_ms:.3f} ms | bound {b_ms:.4f} ms ({b_by}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts.items()) + f") | library: the cuDNN chain (three "
        f"F.conv2d, channels_last bf16, BN folded, two F.silu, + x; not one call) {lib_ms:.4f} ms")
    tot["fused_inverted_residual"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                          bound_by="bytes" if b_by == "bytes" else "operations",
                                          library_ms=lib_ms)
    del x
    # the tile kernel (csrc/inverted_residual_tile.cu), the route of the shapes
    # the strip kernel does not take (no block of the model has one), on
    # seeded random weights with the residual: two launches bit-equal
    b, hh, ww, c, e, cout = VIT_IR_TILE_SHAPE
    args = tuple(torch.randn(shape, generator=g, device=dev) * 0.2
                 for shape in ((c, e), (e,), (3, 3, e), (e,), (e, cout), (cout,)))
    ops = fir.ir_operands(*args)
    check(not ops.strip, f"{tag}: {VIT_IR_TILE_SHAPE} should run on the tile kernel")
    x = torch.randn((b, hh, ww, c), generator=g, device=dev).to(bf16)
    before = fir.LAUNCHES["inverted_residual_tile"]
    got = fir.fused_ir_cuda(x, ops, use_residual=True)
    again = fir.fused_ir_cuda(x, ops, use_residual=True)
    torch.cuda.synchronize()
    check(fir.LAUNCHES["inverted_residual_tile"] == before + 2 and torch.equal(got, again),
          f"{tag}: inverted residual tile kernel {VIT_IR_TILE_SHAPE}: not launched twice, or two "
          f"launches differ")
    plain_args = (args[0].to(bf16), args[1], args[2], args[3], args[4].to(bf16), args[5])
    err, mean, gap, scale = bf16_check(
        f"{tag}: inverted residual tile kernel {VIT_IR_TILE_SHAPE}", "ir", got,
        fir.fused_ir_plain(x, *plain_args, use_residual=True),
        fir.fused_ir_plain(x.float(), *args, use_residual=True))
    del got, again
    ms = cuda_ms(lambda: fir.fused_ir_cuda(x, ops, use_residual=True), n=5)
    log(f"[{tag}] inverted residual tile kernel (B, H, W, C, E, Cout) = {VIT_IR_TILE_SHAPE} bf16: "
        f"max abs err {err:.3g} (largest value {scale:.3g}), mean {mean:.3g} (plain f32 vs bf16: "
        f"{gap:.3g}), two launches bit-equal | kernel {ms:.4f} ms")
    return tot


def argmax_near_ties(what, got, want, tol):
    """Rows whose argmax differs must be near-ties of ``want`` (top-2 gap
    below ``tol``). Returns (agreement, flips)."""
    import torch

    diff = torch.nonzero(got.argmax(-1) != want.argmax(-1)).flatten().tolist()
    top2 = want.topk(2, dim=-1).values
    for r in diff:
        gap = float(top2[r, 0] - top2[r, 1])
        check(gap < tol, f"{what}: row {r} flips its argmax where the reference's top-2 gap is "
                         f"{gap:.3g} >= {tol}")
    return 1.0 - len(diff) / got.shape[0], len(diff)


def ir_blocks(params):
    """MobileViT's seven inverted residuals: layer_1's, layer_2's three and
    the downsampling block of layers 3-5."""
    return [*params.layer_1, *params.layer_2,
            *(getattr(params, f"layer_{k}").downsampling for k in (3, 4, 5))]


def vision_model_phase(tag, dev, images, labels):
    """Phase 14: MobileViT through the entry points on the full checkpoint
    (see the module docstring). Returns (main-path launches by kernel, the
    params, the classify logits by route)."""
    import contextlib
    import io

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch import cli
    from ggml_experiments_tpu_torch.models.mobilevit import (
        classify,
        extract_features,
        load_mobilevit,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    x_all = torch.from_numpy(images)
    nb = -(-len(images) // VIT_BATCH)
    p = load_mobilevit(VIT_CKPT, device=dev, fused_ir=False)
    p_ir = load_mobilevit(VIT_CKPT, device=dev, fused_ir=True)
    check(p.layer_3.transformer[0].attention.flash and p.layer_3.transformer[0].fused
          and not p.layer_2[1].fused and p_ir.layer_2[1].fused,
          f"{tag}: the default routes on the card are not flash + fused layer")
    n_ir = sum(blk.fused_route(bf16) for blk in ir_blocks(p_ir))

    def run(params, cd, name):
        port.reset_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = torch.cat([classify(params, x_all[i:i + VIT_BATCH].to(dev), compute_dtype=cd)
                         for i in range(0, len(images), VIT_BATCH)])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = port.kernel_launches()
        check(out.shape == (len(images), 44) and bool(torch.isfinite(out).all()),
              f"{tag}: classify {name}: shape {tuple(out.shape)} or values")
        return out.cpu(), launches, sec

    logits = {}
    layer = {"fused_transformer_layer": 9, **{k: 9 for k in LAYER_KERNELS}}
    runs = (("f32", p, f32, {"flash_mha": 9}), ("bf16", p, bf16, layer),
            ("bf16+fused_ir", p_ir, bf16, {**layer, "fused_inverted_residual": n_ir}))
    main_launches = {}
    for name, params, cd, per_batch in runs:
        out, launches, sec = run(params, cd, name)
        for k, v in per_batch.items():
            check(launches[k] == v * nb, f"{tag}: classify {name}: {launches[k]} {k} launches, "
                                         f"want {v} a batch x {nb}")
            main_launches.setdefault(k, launches[k])
        others = {k: v for k, v in launches.items() if v and k not in per_batch}
        check(not others, f"{tag}: classify {name} launched {others}")
        logits[name] = out
        top1 = float((out.argmax(-1).numpy() == labels).mean())
        msg = f"[{tag}] classify {name}, {len(images)} held-out images in {nb} batches of " \
              f"<= {VIT_BATCH} ({sec:.2f} s): top-1 {top1:.4f} | launches " + ", ".join(
                  f"{k} {launches[k]}" for k in per_batch)
        if name != "f32":
            agree, flips = argmax_near_ties(f"{tag}: {name} vs f32", out, logits["f32"],
                                            VIT_NEAR_TIE)
            msg += f" | argmax agreement with f32 {agree:.4f} ({flips} flips, at near-ties)"
        log(msg)

    # the card's f32 features against the plain CPU run
    n = VIT_CPU_IMAGES
    p_cpu = load_mobilevit(VIT_CKPT, device="cpu")
    t0 = time.perf_counter()
    want = extract_features(p_cpu, x_all[:n])
    cpu_s = time.perf_counter() - t0
    got = extract_features(p, x_all[:n].to(dev)).cpu()
    rel = float((got - want).abs().max()) / float(want.abs().max())
    check(rel <= VIT_CPU_FEATURE_REL, f"{tag}: f32 features on the card vs the CPU: max rel err "
                                      f"{rel:.3g} > {VIT_CPU_FEATURE_REL}")
    log(f"[{tag}] f32 features of the first {n} images, card vs the plain CPU run ({cpu_s:.1f} s): "
        f"max abs err {float((got - want).abs().max()):.3g}, relative to the largest "
        f"{rel:.3g} (limit {VIT_CPU_FEATURE_REL})")
    del p_cpu, want, got

    # the calibrated q4_k_m checkpoint
    p_km = load_mobilevit(VIT_Q4KM, device=dev)
    check(p_km.layer_3.transformer[0].attention.wq.qtype in ("q4_k", "q8_0")
          and p_km.classifier_kernel is not None, f"{tag}: q4_k_m checkpoint loaded wrongly")
    out, launches, sec = run(p_km, f32, "q4_k_m")
    agree = float((out.argmax(-1) == logits["f32"].argmax(-1)).float().mean())
    flips = int((out.argmax(-1) != logits["f32"].argmax(-1)).sum())
    top1 = float((out.argmax(-1).numpy() == labels).mean())
    log(f"[{tag}] mobilevit_synth_full_q4km.gxt on the card, classify f32: top-1 {top1:.4f}, "
        f"argmax agreement with the float model {agree:.4f} ({flips} differ) | flash launches "
        f"{launches['flash_mha']}")
    del p_km

    # the features command on the synthetic image
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["features", "--weights", VIT_CKPT, "--compute", "bfloat16"])
    lines = buf.getvalue().splitlines()
    check(rc == 0 and lines[0] == "output feature shape: : Dims: (8, 8, 640)" and len(lines) == 4,
          f"{tag}: features command printed {lines}")
    log(f"[{tag}] features --weights mobilevit_synth_full.ggml --compute bfloat16: {lines[0]} | "
        f"{lines[3][:70]}")

    # throughput of extract_features at B=128 on both bf16 routes
    xb = x_all[:VIT_BATCH].to(dev)
    rates = {}
    for name, params in (("bf16", p), ("bf16+fused_ir", p_ir)):
        ms = cuda_ms(lambda: extract_features(params, xb, compute_dtype=bf16), n=10)
        rates[name] = (ms, VIT_BATCH / ms * 1e3)
    log(f"[{tag}] extract_features B={VIT_BATCH} bf16: " + ", ".join(
        f"{k} {ms:.3f} ms = {r:,.0f} images/s" for k, (ms, r) in rates.items()))
    # one forward of each bf16 route under torch.profiler
    kernels = (("fused layer: ln_qkv", "layer_ln_qkv_kernel"),
               ("attention", "layer_attention_kernel"), ("proj_ffn", "layer_proj_ffn_kernel"),
               ("inverted residual", "ir_strip_kernel"))
    for name, params in (("bf16", p), ("bf16+fused_ir", p_ir)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            extract_features(params, xb, compute_dtype=bf16)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        groups = {k: 0.0 for k, _ in kernels}
        groups.update({"convolutions": 0.0, "other device work": 0.0})
        other = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            ms = getattr(e, "self_device_time_total", 0.0) / 1e3
            key = e.key.lower()
            part = next((k for k, w in kernels if w in key), None)
            if part:
                groups[part] += ms
            elif any(w in key for w in ("conv", "cudnn", "xmma", "implicit", "winograd", "nhwc",
                                        "fprop")):
                groups["convolutions"] += ms
            else:
                groups["other device work"] += ms
                other.append((ms, e.key[:60]))
        busy = sum(groups.values())
        log(f"[{tag}] one {name} forward under torch.profiler: " + (
            f"{wall_ms:.2f} ms wall, device busy {busy:.3f} ms (idle share "
            f"{max(0.0, 1 - busy / wall_ms):.3f}): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()) if busy > 0 else
            "torch.profiler recorded no device time"))
        log(f"[{tag}] the largest other device work ({name}): " + "; ".join(
            f"{k} {ms:.3f} ms" for ms, k in sorted(other, reverse=True)[:6]))
    return main_launches, p, logits


def vision_engine_phase(tag, params, images):
    """Phase 15: the VisionEngine over the ladder (8, 32, 128), u8 transport,
    bf16: mixed classify/features bursts, each result against the offline
    forward, some requests canceled."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.models.mobilevit import classify, extract_features
    from ggml_experiments_tpu_torch.serving import VisionEngine

    bf16 = torch.bfloat16
    dev = params.device
    u8 = np.clip(np.round(images * 255.0), 0, 255).astype(np.uint8)
    eng = VisionEngine(params, image_size=256, batch_sizes=(8, 32, 128), compute_dtype=bf16)
    eng.start()
    reqs, idx, kinds = [], [], []
    t0 = time.perf_counter()
    n = 0
    for bi, burst in enumerate(VIT_ENGINE_BURSTS):
        kind = "features" if bi % 3 == 2 else "classify"
        for _ in range(burst):
            j = n % len(u8)
            reqs.append(eng.submit(u8[j], kind))
            if n % VIT_CANCEL_EVERY == 0:
                reqs[-1].cancel()     # most likely still queued
            idx.append(j)
            kinds.append(kind)
            n += 1
        time.sleep(0.05)
    eng.run_until_idle(timeout=600)
    eng_s = time.perf_counter() - t0
    eng.stop()
    # the offline forward of every image, in batches of 128 at the same dtype
    xs = torch.from_numpy(u8)
    want = {}
    for kind, fn in (("classify", classify), ("features", extract_features)):
        want[kind] = torch.cat([fn(params, xs[i:i + VIT_BATCH].to(dev).float() / 255.0,
                                   compute_dtype=bf16).cpu()
                                for i in range(0, len(u8), VIT_BATCH)])
    canceled = set(range(0, len(reqs), VIT_CANCEL_EVERY))
    served = [i for i in range(len(reqs)) if i not in canceled]
    for i in canceled:
        try:
            reqs[i].result(timeout=0)
            check(False, f"{tag}: canceled request {i} resolved with a result")
        except RuntimeError as ex:
            check("canceled" in str(ex), f"{tag}: canceled request {i} raised {ex!r}")
    skipped = eng.stats.requests_canceled
    feat_err, scale = 0.0, 0.0
    got_cls, want_cls = [], []
    for i in served:
        res = torch.from_numpy(reqs[i].result(timeout=0))
        w = want[kinds[i]][idx[i]]
        if kinds[i] == "classify":
            got_cls.append(res)
            want_cls.append(w)
        else:
            feat_err = max(feat_err, float((res - w).abs().max()))
            scale = max(scale, float(w.abs().max()))
    check(feat_err <= VIT_ENGINE_FEATURE_MAX * scale,
          f"{tag}: engine features differ from the offline forward by {feat_err:.3g} (limit "
          f"{VIT_ENGINE_FEATURE_MAX} x {scale:.3g})")
    agree, flips = argmax_near_ties(f"{tag}: engine vs offline", torch.stack(got_cls),
                                    torch.stack(want_cls), VIT_NEAR_TIE)
    log(f"[{tag}] {len(reqs)} requests in bursts {VIT_ENGINE_BURSTS} ({len(canceled)} canceled, "
        f"{skipped} of them before or inside their batch, none resolved with a result), u8 "
        f"transport, bf16: {eng_s:.2f} s | features max abs err "
        f"vs the offline forward {feat_err:.3g} (largest {scale:.3g}) | classify argmax "
        f"agreement {agree:.4f} ({flips} flips, at near-ties) | breakdown "
        f"{json.dumps(eng.stats.breakdown())}")


class PartTimer:
    """Wall seconds spent inside module functions while active, by part. A
    wrapped call synchronizes the card before it returns, so the device work
    it queued counts in its part; nested parts count in both."""

    def __init__(self, targets):
        self.targets = targets          # {part: (module, function name)}
        self.seconds = {part: 0.0 for part in targets}
        self.saved = {}

    def __enter__(self):
        import torch

        for part, (mod, name) in self.targets.items():
            real = getattr(mod, name)
            self.saved[part] = (mod, name, real)

            def timed(*a, _real=real, _part=part, **k):
                t0 = time.perf_counter()
                out = _real(*a, **k)
                torch.cuda.synchronize()
                self.seconds[_part] += time.perf_counter() - t0
                return out

            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved.values():
            setattr(mod, name, real)


def run_command(argv):
    """(rc, stdout, wall seconds) of one CLI command, the card synchronized."""
    import contextlib
    import io

    import torch

    from ggml_experiments_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0


def codes_of(qt):
    """A QTensor's codes unpacked to (K, N) int32 on the CPU."""
    import torch

    from ggml_experiments_tpu_torch.quant.qtensor import unpack_nibbles

    c = qt.codes.to(torch.int32) if qt.qtype == "q8_0" else unpack_nibbles(qt.codes, torch.int32)
    return c[: qt.shape[0], : qt.shape[1]].cpu()


def code_diffs(a_leaves, b_leaves):
    """{key: (differing codes, codes)} over the QTensor leaves two flat
    checkpoints share."""
    out = {}
    for k, a in a_leaves.items():
        if hasattr(a, "codes"):
            b = b_leaves[k]
            check(a.qtype == b.qtype and a.shape == b.shape, f"{k}: {a.qtype} {a.shape} vs "
                                                             f"{b.qtype} {b.shape}")
            out[k] = (int((codes_of(a) != codes_of(b)).sum()), a.shape[0] * a.shape[1])
    return out


def quantize_parts(mod_calibration, collect):
    """The PartTimer targets of a calibrated ``quantize``: the calibration
    forward with its Grams, the GPTQ calls, the k-quant grid fits inside them."""
    from ggml_experiments_tpu_torch.quant import kquant

    return {"forward+H": (mod_calibration, collect),
            "gptq_q4_k": (mod_calibration, "gptq_quantize_q4_k"),
            "gptq_q8_0": (mod_calibration, "gptq_quantize_q8_0"),
            "fit": (kquant, "quantize_q4_k_blocks")}


def split_line(sec, total):
    """The wall time of ``quantize`` split by part: the fits run inside GPTQ."""
    gptq_s = sec["gptq_q4_k"] + sec["gptq_q8_0"]
    return (f"{total:.2f} s = forward + H {sec['forward+H']:.2f} + GPTQ recursion "
            f"{gptq_s - sec['fit']:.2f} + k-quant fit {sec['fit']:.2f} + load, save and the "
            f"rest {total - sec['forward+H'] - gptq_s:.2f}")


def gru_calibration_phase(tag, dev, rng, tok, n_slots, inner):
    """Phase 16: the GRU's q4_k_m recipe on the card (see the module
    docstring)."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch import evaluation
    from ggml_experiments_tpu_torch.formats import checkpoint
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any, load_gru_params
    from ggml_experiments_tpu_torch.quant import calibration, gptq
    from ggml_experiments_tpu_torch.training.data import DataConfig, load_corpus, make_examples

    def windows(path):
        return make_examples(load_corpus(path), tok, DataConfig(seq_length=100))

    # 1. the command on the card, timed by part, against the shipped file
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "gru_synth_q4km.gxt")
        with PartTimer(quantize_parts(calibration, "collect_gru_hessians")) as timer:
            rc, text, total = run_command(["quantize", "--input", GRU_SYNTH, "--output", out,
                                           "--qtype", "q4_k_m", "--calibrate", CORPUS_TRAIN,
                                           "--device", "cuda"])
        check(rc == 0, f"{tag}: quantize --qtype q4_k_m returned {rc}")
        line = json.loads(text)
        check(line["calibrated"] and line["bits_per_weight"] < 5.0
              and checkpoint.read_meta(out) == {"kind": "gru", "qtype": "q4_k_m",
                                                "calibrated": True}, f"{tag}: {line}")
        diffs = code_diffs(checkpoint.load_arrays(out, device="cpu"),
                           checkpoint.load_arrays(CKPT_Q4KM, device="cpu"))
        params_km = load_gru_any(out, device=dev)
        km_cpu = load_gru_any(out, device="cpu")
    log(f"[{tag}] quantize --qtype q4_k_m --calibrate corpus_train.txt of gru_synth.bin on the "
        f"card (384 windows): {split_line(timer.seconds, total)} | {json.dumps(line)}")
    log(f"[{tag}] codes differing from the shipped gru_synth_q4km.gxt (made by the JAX "
        f"package): " + ", ".join(f"{k} {d:,} of {n:,}" for k, (d, n) in diffs.items()))

    # the shipped file's contract, on the held-out draw of its test
    held = windows(CORPUS_HELDOUT)
    seqs = held[np.random.default_rng(0).permutation(len(held))[:GRU_HELDOUT_SEQS]]
    ref = load_gru_params(GRU_SYNTH, device=dev)
    reps = {}
    for name, p in (("port-made", params_km), ("shipped", load_gru_any(CKPT_Q4KM, device=dev))):
        port.reset_kernel_launches()
        r = evaluation.eval_gru_delta(ref, p, seqs)
        reps[name] = (r, abs(r.ppl_a - r.ppl_b) / r.ppl_b, port.kernel_launches())
    r, dppl, launches = reps["port-made"]
    check(r.top1_agreement >= KM_GRU_AGREE and dppl < KM_GRU_DPPL,
          f"{tag}: port-made q4_k_m agreement {r.top1_agreement:.5f}, relative dppl {dppl:.2e}")
    # the head (1024 x 66) and the input kernel are under qmatmul's dispatch
    # gate (K*N <= 2^20): torch.matmul on the dequantized plane, as in JAX
    check(launches["qmatmul_q4_k"] > 0, f"{tag}: eval launched {launches}")
    log(f"[{tag}] against the float model on {GRU_HELDOUT_SEQS} held-out windows (limits: "
        f"agreement >= {KM_GRU_AGREE}, relative dppl < {KM_GRU_DPPL}): " + "; ".join(
            f"{k} agreement {v[0].top1_agreement:.5f}, dppl {v[1]:.2e}, max abs "
            f"{v[0].max_abs:.4f}" for k, v in reps.items())
        + f" | qmatmul_q4_k launches {launches['qmatmul_q4_k']}")
    rc, text, eval_s = run_command(["eval", "--weights", GRU_SYNTH, "--qtype", "q8_0",
                                    "--corpus", CORPUS_HELDOUT, "--batch", "64", "--length",
                                    "100", "--device", "cuda"])
    check(rc == 0, f"{tag}: eval returned {rc}")
    log(f"[{tag}] eval --weights gru_synth.bin --qtype q8_0 --corpus corpus_heldout.txt "
        f"--batch 64 --length 100 on the card: {eval_s:.2f} s wall | {text.strip()}")

    # 2. the Shakespeare ordering: q8_0 >= GPTQ q4_k_m > RTN q4_k, q4_k_m >= 0.95
    sref = load_gru_params(CKPT, device=dev)
    train = windows(SHAKE_TRAIN)
    cal = train[np.random.default_rng(7).permutation(len(train))[:SHAKE_CAL_SEQS]]
    t0 = time.perf_counter()
    pm = calibration.gptq_gru_params(sref, cal)
    torch.cuda.synchronize()
    shake_s = time.perf_counter() - t0
    held = windows(SHAKE_HELD)
    agree = {}
    for name, p in (("q8_0", load_gru_params(CKPT, qtype="q8_0", device=dev)), ("q4_k_m", pm),
                    ("q4_k", load_gru_params(CKPT, qtype="q4_k", device=dev))):
        r = evaluation.eval_gru_delta(sref, p, held)
        agree[name] = (r.top1_agreement, abs(r.ppl_a - r.ppl_b) / r.ppl_b)
    a = {k: v[0] for k, v in agree.items()}
    check(a["q8_0"] >= a["q4_k_m"] > a["q4_k"] and a["q4_k_m"] >= 0.95,
          f"{tag}: Shakespeare ordering broken: {a}")
    log(f"[{tag}] gru_shakespeare.bin, GPTQ q4_k_m from {SHAKE_CAL_SEQS} train windows on the "
        f"card in {shake_s:.2f} s; agreement with f32 on {len(held)} held-out windows: "
        + ", ".join(f"{k} {v[0]:.5f} (dppl {v[1]:.2e})" for k, v in agree.items())
        + " (q8_0 >= q4_k_m > q4_k, q4_k_m >= 0.95: holds)")
    del sref, pm

    # 3. generate, decode and an engine from the port-made file: phase 8's checks
    ids, lens = pad_batch(corpus_prompts(tok, rng, GENERATE_SHAPE[0], 8, 40), 40)
    launches, dec, tick = calibrated_gru_phase(tag, "the port-made q4_k_m file", params_km,
                                               km_cpu, ids, lens, rng, tok, n_slots, inner)
    log(f"[{tag}] launches on the port-made file's paths: qmatmul_q4_k "
        f"{launches['qmatmul_q4_k']} (generate), fused_gru_decode {dec['launches']} ({dec['ms']:.2f} ms), fused_slot_tick "
        f"{tick['launches']} ({tick['ms']:.3f} ms)")
    del params_km, km_cpu

    # 4. GPTQ on the card and on the CPU from the same H and W: the same bits
    train = windows(CORPUS_TRAIN)
    hess = calibration.collect_gru_hessians(
        ref, train[np.random.default_rng(0).permutation(len(train))[:64]])
    for what, fn, w, h, kw in (
            ("input kernel q4_k", gptq.gptq_quantize_q4_k, ref.cell.kernel, hess["kernel"],
             dict(percdamp=1e-4)),
            ("head q8_0", gptq.gptq_quantize_q8_0, ref.dense_kernel, hess["dense_kernel"], {})):
        t0 = time.perf_counter()
        got = fn(w, h, device=dev, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = fn(w.cpu(), h.cpu(), device="cpu", **kw)
        t2 = time.perf_counter()
        for name in ("codes", "scales", "mins", "supers"):
            ga, wa = getattr(got, name), getattr(want, name)
            check((ga is None) == (wa is None) and (ga is None or torch.equal(ga.cpu(), wa)),
                  f"{tag}: {what}: the card's {name} differ from the CPU's")
        log(f"[{tag}] gptq {what} {tuple(w.shape)} from the same H and W: the card's planes "
            f"bit-equal to the CPU's | card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s")


def vision_remainders_phase(tag, dev, images, labels, logits):
    """Phase 17: the MobileViT remainders on the card (see the module
    docstring). ``logits``: phase 14's classify logits of the float model by
    route."""
    import contextlib
    import io

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.formats import checkpoint
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
    from ggml_experiments_tpu_torch.models.mobilevit import (
        classify,
        extract_features,
        load_mobilevit,
    )
    from ggml_experiments_tpu_torch.quant import calibration
    from ggml_experiments_tpu_torch.training import image_task

    f32, bf16 = torch.float32, torch.bfloat16
    x_all = torch.from_numpy(images)
    nb = -(-len(images) // VIT_BATCH)

    def run_classify(params, cd):
        port.reset_kernel_launches()
        out = torch.cat([classify(params, x_all[i:i + VIT_BATCH].to(dev), compute_dtype=cd)
                         for i in range(0, len(images), VIT_BATCH)]).cpu()
        torch.cuda.synchronize()
        check(out.shape == (len(images), 44) and bool(torch.isfinite(out).all()),
              f"{tag}: classify output shape/values")
        return out, port.kernel_launches()

    # 1. the command on the card, against the shipped file and the float model
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mobilevit_synth_full_q4km.gxt")
        with PartTimer(quantize_parts(calibration, "collect_mobilevit_grams")) as timer:
            rc, text, total = run_command(["quantize", "--input", VIT_CKPT, "--output", out,
                                           "--qtype", "q4_k_m", "--calibrate", "task:1234",
                                           "--device", "cuda"])
        check(rc == 0, f"{tag}: quantize --qtype q4_k_m returned {rc}")
        line = json.loads(text)
        meta = checkpoint.read_meta(out)
        check(line["calibrated"] and (meta["kind"], meta["qtype"], meta["classifier"])
              == ("mobilevit", "q4_k_m", True), f"{tag}: {line} {meta}")
        diffs = code_diffs(checkpoint.load_arrays(out, device="cpu"),
                           checkpoint.load_arrays(VIT_Q4KM, device="cpu"))
        p_km = load_mobilevit(out, device=dev)
    d = sum(v[0] for v in diffs.values())
    n = sum(v[1] for v in diffs.values())
    worst = max(diffs.items(), key=lambda kv: kv[1][0] / kv[1][1])
    log(f"[{tag}] quantize --qtype q4_k_m --calibrate task:1234 of mobilevit_synth_full.ggml "
        f"on the card (384 images): {split_line(timer.seconds, total)} | {json.dumps(line)}")
    log(f"[{tag}] codes differing from the shipped mobilevit_synth_full_q4km.gxt (made by the "
        f"JAX package): {d:,} of {n:,} over {len(diffs)} tensors; the most in {worst[0]} "
        f"({worst[1][0]:,} of {worst[1][1]:,})")
    check(p_km.layer_3.transformer[0].attention.flash and p_km.layer_3.transformer[0].fused,
          f"{tag}: the port-made file did not load on the default routes")
    # the default routes: flash at f32; the fused layer and the
    # fused inverted residual at bf16 (the float model's bf16 + fused_ir route)
    layer = {"fused_transformer_layer": 9, **{k: 9 for k in LAYER_KERNELS},
             "fused_inverted_residual": sum(blk.fused_route(bf16) for blk in ir_blocks(p_km))}
    for name, cd, per_batch, ref_route in (("f32", f32, {"flash_mha": 9}, "f32"),
                                           ("bf16", bf16, layer, "bf16+fused_ir")):
        got, launches = run_classify(p_km, cd)
        for k, v in per_batch.items():
            check(launches[k] == v * nb, f"{tag}: classify {name}: {launches[k]} {k} launches, "
                                         f"want {v} a batch x {nb}")
        # every MobileViT weight is under qmatmul's dispatch gate (K*N <= 2^20):
        # torch.matmul on the dequantized plane, as the JAX package leaves it to XLA
        others = {k: v for k, v in launches.items() if v and k not in per_batch}
        check(not others, f"{tag}: classify {name} launched {others}")
        want = logits[ref_route]
        agree, flips = argmax_near_ties(f"{tag}: q4_k_m {name} vs the float model", got, want,
                                        VIT_NEAR_TIE)
        rel = float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
        check(agree >= KM_VIT_AGREE, f"{tag}: classify {name}: agreement {agree:.4f}")
        if cd == f32:
            check(rel < KM_VIT_REL, f"{tag}: classify f32: relative logit RMSE {rel:.4g}")
        top1 = float((got.argmax(-1).numpy() == labels).mean())
        log(f"[{tag}] the port-made file, classify {name} of {len(images)} held-out images: "
            f"top-1 {top1:.4f}, argmax agreement with the float model's {ref_route} route "
            f"{agree:.4f} ({flips} flips, at near-ties), relative logit RMSE {rel:.5f}"
            f"{' (limit %g)' % KM_VIT_REL if cd == f32 else ''} | launches " + ", ".join(
                f"{k} {launches[k]}" for k in per_batch))
    del p_km

    # 2. eval of the weight.ggml on the card
    for qtype in ("q4_k", "q8_0"):
        port.reset_kernel_launches()
        rc, text, sec = run_command(["eval", "--weights", VIT_CKPT, "--qtype", qtype,
                                     "--device", "cuda"])
        launches = port.kernel_launches()
        check(rc == 0 and launches["flash_mha"] > 0,
              f"{tag}: eval --qtype {qtype}: rc {rc}, launches {launches}")
        log(f"[{tag}] eval --weights mobilevit_synth_full.ggml --qtype {qtype} on the card: "
            f"{sec:.2f} s wall | {text.strip()} | flash_mha launches {launches['flash_mha']}")

    # 3. activation storage on the bf16 + fused_ir route
    xb = x_all[:VIT_BATCH].to(dev)
    # parts 3-4 compare load options on the bf16 route without the fused
    # inverted residual, whose depthwise taps stay f32 whatever the storage
    p = load_mobilevit(VIT_CKPT, device=dev, fused_ir=False)
    with torch.no_grad():
        ref32 = extract_features(p, xb)
    base = load_mobilevit(VIT_CKPT, device=dev, fused_ir=True)
    rows = [("none", "-", base)] + [
        (store, scope, load_mobilevit(VIT_CKPT, device=dev, fused_ir=True, act_storage=store,
                                      act_storage_scope=scope))
        for store, scope in STORE_RUNS]
    rel = {}
    for store, scope, params in rows:
        out, launches = run_classify(params, bf16)
        n_ir = sum(blk.fused_route(bf16) for blk in ir_blocks(params))
        check(launches["fused_inverted_residual"] == n_ir * nb,
              f"{tag}: {store}/{scope}: {launches['fused_inverted_residual']} inverted residual "
              f"launches, want {n_ir} a batch x {nb}")
        with torch.no_grad():
            feats = extract_features(params, xb, compute_dtype=bf16)
        rel[(store, scope)] = float((feats - ref32).norm() / ref32.norm())
        ms = cuda_ms(lambda: extract_features(params, xb, compute_dtype=bf16), n=10)
        top1 = float((out.argmax(-1).numpy() == labels).mean())
        log(f"[{tag}] bf16 + fused_ir, act_storage {store} scope {scope}: extract_features "
            f"B={VIT_BATCH} {ms:.3f} ms = {VIT_BATCH / ms * 1e3:,.0f} images/s | feature "
            f"relative RMSE against f32 {rel[(store, scope)]:.4f} | top-1 on {len(images)} "
            f"images {top1:.4f} | fused_inverted_residual launches "
            f"{launches['fused_inverted_residual']}")
    e, a = rel[("f8_e5m2", "early")], rel[("f8_e5m2", "all")]
    check(e < STORE_REL["early"] and e < a < STORE_REL["all"],
          f"{tag}: f8_e5m2 feature noise early {e:.4f}, all {a:.4f}")
    del rows, base

    # 4. the space-to-depth stem and bf16 convolution kernels
    s2d = load_mobilevit(VIT_CKPT, device=dev, stem_space_to_depth=True, fused_ir=False)
    cb = load_mobilevit(VIT_CKPT, device=dev, conv_dtype="bfloat16", fused_ir=False)
    with torch.no_grad():
        r = float((extract_features(s2d, xb) - ref32).abs().max() / ref32.abs().max())
        check(r <= VIT_CPU_FEATURE_REL, f"{tag}: space-to-depth f32 features: max rel {r:.3g}")
        b16 = extract_features(p, xb, compute_dtype=bf16)
        rb = float((extract_features(s2d, xb, compute_dtype=bf16) - b16).norm() / b16.norm())
        rc32 = float((extract_features(cb, xb) - ref32).norm() / ref32.norm())
        rcb = float((extract_features(cb, xb, compute_dtype=bf16) - b16).norm() / b16.norm())
    check(rcb == 0.0, f"{tag}: bf16-stored kernels change the bf16 forward ({rcb:.3g})")
    log(f"[{tag}] stem_space_to_depth: f32 features max rel err {r:.3g} against the standard "
        f"stem (limit {VIT_CPU_FEATURE_REL}), bf16 relative RMSE {rb:.4f} | conv_dtype "
        f"bfloat16: f32 features relative RMSE {rc32:.4g}, bf16 features equal")
    stem_ms = {}
    for name, params in (("standard", p), ("space-to-depth", s2d)):
        for cd in (f32, bf16):
            xin = xb.to(cd)
            params.conv_stem(xin, compute_dtype=cd)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                params.conv_stem(xin, compute_dtype=cd)
                torch.cuda.synchronize()
            stem_ms[(name, cdname(cd))] = sum(
                getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA) / 1e3
    fwd_ms = {name: cuda_ms(lambda: extract_features(params, xb, compute_dtype=bf16), n=10)
              for name, params in (("standard", p), ("space-to-depth stem", s2d),
                                   ("bf16 conv kernels", cb))}
    log(f"[{tag}] the stem at B={VIT_BATCH} under torch.profiler (device ms): " + ", ".join(
        f"{k[0]} {k[1]} {v:.4f}" for k, v in stem_ms.items()) + f" | extract_features "
        f"B={VIT_BATCH} bf16: " + ", ".join(f"{k} {v:.3f} ms" for k, v in fwd_ms.items()))
    del s2d, cb, p

    # 5. training on the image task: the tiny checkpoint with its head drawn anew
    named = dict(read_named_tensors(VIT_TINY))
    head = next(k for k in named if k.endswith("classifier/kernel:0"))
    named[head] = (np.random.default_rng(0).standard_normal(named[head].shape) * 0.01
                   ).astype(np.float32)
    tx, ty = image_task.make_dataset(TRAIN_VIT_IMAGES, seed=image_task.TRAIN_SEED, image_size=64)
    image_task.train_model(named, tx, ty, steps=2, batch=TRAIN_VIT_BATCH, log_every=0,
                           device=dev)
    port.reset_kernel_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        trained, last = image_task.train_model(named, tx, ty, steps=TRAIN_VIT_STEPS,
                                               batch=TRAIN_VIT_BATCH, log_every=1, device=dev)
    sec = time.perf_counter() - t0
    launches = {k: v for k, v in port.kernel_launches().items() if v}
    losses = [float(ln.rsplit(" ", 1)[1]) for ln in buf.getvalue().splitlines()
              if ln.startswith("step ")]
    check(len(losses) == TRAIN_VIT_STEPS and np.isfinite(losses).all()
          and np.mean(losses[-5:]) < np.mean(losses[:5]), f"{tag}: train_model losses {losses}")
    log(f"[{tag}] train_model, mobilevit_synth.ggml (TINY_CLS_CONFIG, head drawn anew), "
        f"{TRAIN_VIT_STEPS} steps at batch {TRAIN_VIT_BATCH} on the card: "
        f"{sec / TRAIN_VIT_STEPS * 1e3:.2f} ms a step (each step's loss read back) | loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (first five {np.mean(losses[:5]):.4f}, last "
        f"five {np.mean(losses[-5:]):.4f}) | kernel launches {launches or 'none'} (the "
        f"plain path)")


# ---- phases 18-20: HTTP serving, the dispatch gates and ``bench`` -----------------


def http_call(port, method, path, payload=None, raw=None, headers=None, timeout=300):
    """(status, reply bytes) of one request to a front end on this machine."""
    import urllib.error
    import urllib.request

    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers=headers or {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as ex:
        return ex.code, ex.read()


def serve_subprocess(argv, pattern):
    """Start ``python -m ggml_experiments_tpu_torch ARGV`` and wait for the
    line that gives its port on stderr: (process, port)."""
    import re
    import select

    proc = subprocess.Popen([sys.executable, "-m", "ggml_experiments_tpu_torch", *argv],
                            stderr=subprocess.PIPE, cwd=REPO)
    buf = b""
    deadline = time.time() + 300
    while time.time() < deadline:
        ready, _, _ = select.select([proc.stderr], [], [], 0.2)
        if ready:
            chunk = os.read(proc.stderr.fileno(), 4096)
            buf += chunk
            m = re.search(pattern, buf)
            if m:
                return proc, int(m.group(1))
        if proc.poll() is not None:
            break
    proc.kill()
    proc.wait(timeout=30)
    raise SmokeFailure(f"{argv[0]} --http gave no port: rc {proc.returncode}, stderr "
                       f"{buf[-2000:]!r}")


def stop_subprocess(proc, what):
    """SIGINT, then the exit code must be 0."""
    import signal

    proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        raise SmokeFailure(f"{what} did not stop on SIGINT")
    check(rc == 0, f"{what} exited {rc} on SIGINT")


def http_text_phase(tag, dev, rng, tok):
    """Phase 18: HttpFrontend over a DecodeEngine of HTTP_ENGINE_SHAPE (the
    fused tick) on gru_shakespeare.bin q8_0, bf16: HTTP_REQUESTS requests
    from HTTP_CLIENTS client threads, half streamed, HTTP_CANCELS of the
    streamed ones canceled by DELETE after their first token; every reply
    equal to the offline fused decode (a canceled one: its prefix); then the
    ``serve --http 0`` command (its defaults: 16 slots x 16 inner steps, f32)
    answering 4 requests equal to ``generate`` (forks only at near-ties),
    stopped by SIGINT."""
    import concurrent.futures
    import http.client

    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.serving import DecodeEngine
    from ggml_experiments_tpu_torch.serving.http import HttpFrontend

    bf16 = torch.bfloat16
    params = load_gru_params(CKPT, qtype="q8_0", device=dev)
    n_slots, inner = HTTP_ENGINE_SHAPE
    eng = DecodeEngine(params, n_slots=n_slots, max_prompt=64, inner_steps=inner,
                       compute_dtype=bf16)
    check(eng.use_fused_tick, f"{tag}: the engine gate sends {n_slots} x {inner} to the scan")
    prompts = corpus_prompts(tok, rng, HTTP_REQUESTS, 1, 64)
    new_toks = [int(x) for x in rng.integers(16, 257, len(prompts))]
    stream = [i % 2 == 1 for i in range(len(prompts))]
    cancel = set(range(1, 2 * HTTP_CANCELS, 2))
    for i in cancel:
        new_toks[i] = HTTP_CANCEL_NEW      # long enough to be cut short
    offline = fused.fused_gru_decode(params, *pad_batch(prompts, 64), 64 + max(new_toks),
                                     compute_dtype=bf16).cpu().numpy()
    eng.start()
    front = HttpFrontend(eng, tok, port=0)
    front.start()

    def one(i):
        text = tok.decode(prompts[i].tolist())
        payload = {"prompt": text, "max_new_tokens": new_toks[i], "stream": stream[i]}
        if not stream[i]:
            code, body = http_call(front.port, "POST", "/v1/generate", payload)
            check(code == 200, f"{tag}: request {i}: HTTP {code} {body[:200]!r}")
            reply = json.loads(body)
            return reply["tokens"], reply["canceled"]
        conn = http.client.HTTPConnection("127.0.0.1", front.port, timeout=300)
        conn.request("POST", "/v1/generate", json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        check(resp.status == 200, f"{tag}: stream {i}: HTTP {resp.status}")
        rid = json.loads(resp.readline())["id"]
        toks, final = [], None
        while final is None:
            line = json.loads(resp.readline())
            if "token" in line:
                toks.append(line["token"])
                if i in cancel and len(toks) == 1:
                    code, _ = http_call(front.port, "DELETE", f"/v1/requests/{rid}")
                    check(code == 200, f"{tag}: DELETE of request {rid}: HTTP {code}")
            else:
                final = line
        resp.read()     # the closing chunk
        conn.close()
        check(final["done"] and final["generated"] == len(toks),
              f"{tag}: stream {i}: final chunk {final}")
        return toks, final["canceled"]

    port.reset_kernel_launches()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(HTTP_CLIENTS) as pool:
        replies = list(pool.map(one, range(len(prompts))))
    wall = time.perf_counter() - t0
    launches = port.kernel_launches()
    code, health = http_call(front.port, "GET", "/v1/health")
    health = json.loads(health)
    code2, stats = http_call(front.port, "GET", "/v1/stats")
    stats = json.loads(stats)
    front.stop()
    eng.stop()
    check(code == code2 == 200 and health["status"] == "ok" and health["slots"] == n_slots,
          f"{tag}: /v1/health {code} {health}")
    check(launches["fused_slot_tick"] > 0, f"{tag}: the tick kernel was not launched: {launches}")
    cut, generated = 0, 0
    for i, (toks, canceled) in enumerate(replies):
        total = prompts[i].size + new_toks[i]
        want = offline[i, :total].tolist()
        generated += max(0, len(toks) - prompts[i].size)
        if i in cancel:
            check(canceled and toks == want[:len(toks)],
                  f"{tag}: canceled request {i}: not a prefix of the offline decode")
            cut += len(toks) < total
        else:
            check(not canceled and toks == want,
                  f"{tag}: request {i} ({'streamed' if stream[i] else 'whole'}) differs from "
                  f"the offline decode")
    check(cut > 0, f"{tag}: no DELETE landed before its request finished")
    check(stats["requests_completed"] + stats["requests_canceled"] >= len(prompts) - len(cancel)
          and stats["tokens_generated"] > 0, f"{tag}: /v1/stats {stats}")
    log(f"[{tag}] HttpFrontend over a {n_slots} x {inner} engine (fused tick, q8_0 bf16): "
        f"{len(prompts)} requests from {HTTP_CLIENTS} clients ({sum(stream)} streamed, "
        f"{len(cancel)} canceled by DELETE, {cut} of them cut short) in {wall:.3f} s = "
        f"{len(prompts) / wall:.1f} requests/s, {generated:,} new tokens = "
        f"{generated / wall:,.0f} tokens/s; every reply equal to the offline decode | tick "
        f"launches {launches['fused_slot_tick']} | /v1/stats {json.dumps(stats)}")

    # the command, at its defaults: 16 slots x 16 inner steps (the scan tick), f32
    proc, port_no = serve_subprocess(["serve", "--weights", CKPT, "--qtype", "q8_0",
                                      "--http", "0"], rb"serving HTTP on 127\.0\.0\.1:(\d+)")
    try:
        sub = corpus_prompts(tok, rng, 4, 8, 40)
        t0 = time.perf_counter()
        got = []
        for p in sub:
            code, body = http_call(port_no, "POST", "/v1/generate",
                                   {"prompt": tok.decode(p.tolist()), "max_new_tokens": 64})
            check(code == 200, f"{tag}: serve --http: HTTP {code} {body[:200]!r}")
            got.append(json.loads(body)["tokens"])
        sub_s = time.perf_counter() - t0
    finally:
        stop_subprocess(proc, "serve --http")
    ids, lens = pad_batch(sub, 40)
    want = gru_textgen.generate(params, ids, lens, 40 + 64, compute_dtype=torch.float32).cpu()
    rows = [np.asarray(g[:p.size + 64]) for g, p in zip(got, sub)]
    for i, (row, p) in enumerate(zip(rows, sub)):
        check(row.size == p.size + 64, f"{tag}: serve --http reply {i}: {row.size} tokens")
    width = min(r.size for r in rows)
    got_t = torch.from_numpy(np.stack([r[:width] for r in rows]))
    z = torch.zeros(len(sub), dtype=torch.int32, device=dev)
    tf = torch.full((len(sub),), width, dtype=torch.int32, device=dev)
    *_, gaps = fused.gru_loop_reference(fused._prep_weights(params), want[:, :width].to(dev),
                                        tf, tf, z, z, torch.zeros(len(sub), 1024, device=dev),
                                        width, torch.float32, margins=True)
    agree, forked = first_divergence_near_ties(got_t, want[:, :width], gaps.cpu(),
                                               NEAR_TIE["float32"], f"{tag}: serve --http")
    log(f"[{tag}] serve --http 0 (its defaults: 16 slots x 16 inner steps, f32): 4 requests in "
        f"{sub_s:.2f} s, tokens vs generate: agreement {agree:.6f}, {forked} rows fork (at "
        f"near-ties) | stopped by SIGINT, rc 0")


def ppm_bytes(u8):
    h, w, _ = u8.shape
    return f"P6\n{w} {h}\n255\n".encode() + u8.tobytes()


def http_vision_phase(tag, dev, images):
    """Phase 19: HttpFrontend over a VisionEngine (ladder 8/32/128, u8
    transport, bf16) on the full checkpoint at its default routes: phase
    14's held-out images as raw PPM bodies and as JSON ``image_b64``, to
    /v1/classify and /v1/features from HTTP_CLIENTS threads; the top-1
    against the offline classify of the same u8 images under the near-tie
    rule, the features' debug vectors against the offline forward; the
    fused layer and the inverted residual launched; an oversize body 413;
    then the ``serve-vision --http 0`` command for 4 requests."""
    import base64
    import concurrent.futures
    import http.client

    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.models.mobilevit import (
        classify,
        extract_features,
        load_mobilevit,
    )
    from ggml_experiments_tpu_torch.serving import VisionEngine
    from ggml_experiments_tpu_torch.serving.http import MAX_BODY_BYTES, HttpFrontend

    bf16 = torch.bfloat16
    params = load_mobilevit(VIT_CKPT, device=dev)
    u8 = np.clip(np.round(images[:HTTP_IMAGES] * 255.0), 0, 255).astype(np.uint8)
    x = torch.from_numpy(u8).to(dev).float() / 255.0
    want_cls = classify(params, x, compute_dtype=bf16).float().cpu()
    want_feat = extract_features(params, x, compute_dtype=bf16).float().cpu()
    del x
    eng = VisionEngine(params, image_size=256, batch_sizes=(8, 32, 128), compute_dtype=bf16)
    eng.start()
    front = HttpFrontend(None, vision=eng, port=0)
    front.start()

    def one(i):
        kind = "classify" if i % 4 < 2 else "features"
        if i % 2 == 0:
            code, body = http_call(front.port, "POST", f"/v1/{kind}", raw=ppm_bytes(u8[i]),
                                   headers={"Content-Type": "image/x-portable-pixmap"})
        else:
            code, body = http_call(front.port, "POST", f"/v1/{kind}",
                                   {"image_b64": base64.b64encode(ppm_bytes(u8[i])).decode()})
        check(code == 200, f"{tag}: image {i} {kind}: HTTP {code} {body[:200]!r}")
        return kind, json.loads(body)

    port.reset_kernel_launches()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(HTTP_CLIENTS) as pool:
        replies = list(pool.map(one, range(len(u8))))
    wall = time.perf_counter() - t0
    launches = port.kernel_launches()
    conn = http.client.HTTPConnection("127.0.0.1", front.port, timeout=60)
    conn.putrequest("POST", "/v1/classify")
    conn.putheader("Content-Type", "image/png")
    conn.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
    conn.endheaders()
    big = conn.getresponse().status
    conn.close()
    code, stats = http_call(front.port, "GET", "/v1/vision/stats")
    front.stop()
    eng.stop()
    check(big == 413, f"{tag}: an oversize body got HTTP {big}, want 413")
    check(launches["fused_inverted_residual"] > 0 and launches["fused_transformer_layer"] > 0,
          f"{tag}: the fused layer or the inverted residual was not launched: {launches}")
    got_cls, ref_cls, feat_err, scale = [], [], 0.0, 0.0
    for i, (kind, reply) in enumerate(replies):
        if kind == "classify":
            top = reply["top"]
            row = torch.full((want_cls.shape[1],), -1e30)
            for cls_id, logit in top:
                row[cls_id] = logit
            got_cls.append(row)
            ref_cls.append(want_cls[i])
        else:
            vec = want_feat[i, 0, 0]
            w = torch.cat([vec[:5], vec[-5:]])
            g = torch.tensor(reply["first5"] + reply["last5"])
            check(reply["shape"] == list(want_feat.shape[1:]),
                  f"{tag}: features {i}: shape {reply['shape']}")
            feat_err = max(feat_err, float((g - w).abs().max()))
            scale = max(scale, float(want_feat[i].abs().max()))
    check(feat_err <= VIT_ENGINE_FEATURE_MAX * scale,
          f"{tag}: features differ from the offline forward by {feat_err:.3g} (limit "
          f"{VIT_ENGINE_FEATURE_MAX} x {scale:.3g})")
    agree, flips = argmax_near_ties(f"{tag}: HTTP classify vs offline", torch.stack(got_cls),
                                    torch.stack(ref_cls), VIT_NEAR_TIE)
    log(f"[{tag}] HttpFrontend over a VisionEngine (8/32/128, u8, bf16, default routes): "
        f"{len(u8)} images (PPM bodies and image_b64, classify and features) from "
        f"{HTTP_CLIENTS} clients in {wall:.3f} s = {len(u8) / wall:.1f} requests/s | top-1 "
        f"agreement with the offline classify {agree:.4f} ({flips} flips, at near-ties), "
        f"features max abs err {feat_err:.3g} (largest {scale:.3g}) | launches: fused layer "
        f"{launches['fused_transformer_layer']}, inverted residual "
        f"{launches['fused_inverted_residual']} | oversize body: 413 | /v1/vision/stats "
        f"{stats.decode().strip()}")

    proc, port_no = serve_subprocess(["serve-vision", "--weights", VIT_CKPT, "--compute",
                                      "bfloat16", "--http", "0"],
                                     rb"vision service on 127\.0\.0\.1:(\d+)")
    try:
        t0 = time.perf_counter()
        tops = []
        for i in range(4):
            code, body = http_call(port_no, "POST", "/v1/classify", raw=ppm_bytes(u8[i]),
                                   headers={"Content-Type": "image/x-portable-pixmap"})
            check(code == 200, f"{tag}: serve-vision: HTTP {code} {body[:200]!r}")
            tops.append(json.loads(body)["top"][0])
        sub_s = time.perf_counter() - t0
    finally:
        stop_subprocess(proc, "serve-vision")
    for i, (cls_id, _) in enumerate(tops):
        if cls_id != int(want_cls[i].argmax()):
            top2 = want_cls[i].topk(2).values
            check(float(top2[0] - top2[1]) < VIT_NEAR_TIE,
                  f"{tag}: serve-vision image {i}: top-1 {cls_id}, offline "
                  f"{int(want_cls[i].argmax())}")
    log(f"[{tag}] serve-vision --http 0: 4 classify requests in {sub_s:.2f} s, top-1 as "
        f"offline (near-tie rule) | stopped by SIGINT, rc 0")


def gates_phase(tag, dev, rng, tok):
    """Phase 20: the committed dispatch gates at their edges (no calibration
    file: GXT_TORCH_DECODE_DISPATCH names a missing one), read from the launch
    counters, then the ``bench`` command's JSON lines."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.models import gru_textgen, mobilevit
    from ggml_experiments_tpu_torch.serving import DecodeEngine, engine as engine_mod

    bf16 = torch.bfloat16
    thr = gru_textgen.dispatch_thresholds(reload=True)
    check(thr["source"] == "default" and thr["min_b"] == gru_textgen.DECODE_FUSED_MIN_B
          and thr["min_t"] == gru_textgen.DECODE_FUSED_MIN_T,
          f"{tag}: decode thresholds {thr} are not the committed ones")
    params = load_gru_params(CKPT, qtype="q8_0", device=dev)

    def decode_launches(b, t, cd):
        ids, lens = pad_batch(corpus_prompts(tok, rng, b, 1, 16), 16)
        port.reset_kernel_launches()
        out = gru_textgen.decode(params, ids, lens, t, compute_dtype=cd)
        torch.cuda.synchronize()
        check(out.shape == (b, t), f"{tag}: decode ({b}, {t}) shape {tuple(out.shape)}")
        return port.kernel_launches()["fused_gru_decode"]

    # at the thresholds, and one step of the sweeps' doubling grids past each
    min_b, min_t = thr["min_b"], thr["min_t"]
    cap = gru_textgen.DECODE_FUSED_MAX_B_F32
    f32 = torch.float32
    checks = [((min_b, min_t, bf16), True), ((min_b // 2, min_t, bf16), False),
              ((min_b, min_t // 2, bf16), False), ((cap, min_t, f32), True),
              ((2 * cap, min_t, f32), False), ((2 * cap, min_t, bf16), True)]
    for (b, t, cd), fused_want in checks:
        n = decode_launches(b, t, cd)
        check((n > 0) == fused_want, f"{tag}: decode({b}, {t}, {cdname(cd)}) launched the "
                                     f"persistent kernel {n} times (want "
                                     f"{'some' if fused_want else 'none'})")
    log(f"[{tag}] decode() gate (B, T) >= ({min_b}, {min_t}), at f32 B <= {cap}: "
        + ", ".join(f"({b}, {t}, {cdname(cd)}) -> {'fused' if f else 'scan'}"
                    for (b, t, cd), f in checks))

    slots, inner = engine_mod.FUSED_TICK_MIN_SLOTS, engine_mod.FUSED_TICK_MIN_INNER
    cap = engine_mod.FUSED_TICK_MAX_SLOTS_F32
    f32 = torch.float32
    ecks = [((slots, inner, bf16), True), ((slots // 2, inner, bf16), False),
            ((slots, inner // 2, bf16), False), ((2 * cap, inner, bf16), True),
            ((cap, inner, f32), True), ((2 * cap, inner, f32), False)]
    for (s, i, cd), fused_want in ecks:
        eng = DecodeEngine(params, n_slots=s, max_prompt=16, inner_steps=i, compute_dtype=cd)
        check(eng.use_fused_tick == fused_want, f"{tag}: engine {s} x {i} {cdname(cd)}: fused "
                                                f"tick {eng.use_fused_tick}")
        port.reset_kernel_launches()
        reqs = [eng.submit(p, 8) for p in corpus_prompts(tok, rng, 4, 1, 16)]
        eng.run_until_idle(timeout_s=300)
        n = port.kernel_launches()
        check(all(r._done.is_set() for r in reqs)
              and (n["fused_slot_tick"] > 0) == fused_want
              and (n["qmatmul_q8_0"] > 0) != fused_want,
              f"{tag}: engine {s} x {i} {cdname(cd)} launched {n['fused_slot_tick']} ticks, "
              f"{n['qmatmul_q8_0']} qmatmuls")
    log(f"[{tag}] engine gate (n_slots, inner) >= ({slots}, {inner}), at f32 n_slots <= {cap}: "
        + ", ".join(f"({s}, {i}, {cdname(cd)}) -> {'fused' if f else 'scan'}"
                    for (s, i, cd), f in ecks))

    vit = mobilevit.load_mobilevit(VIT_CKPT, device=dev)
    blocks = ir_blocks(vit)
    want_ir = sum(blk.fused_route(bf16) for blk in blocks)
    x = torch.rand((8, 256, 256, 3), device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    got_ir = {}
    for cd in (bf16, torch.float32):
        port.reset_kernel_launches()
        mobilevit.extract_features(vit, x, compute_dtype=cd)
        torch.cuda.synchronize()
        got_ir[cdname(cd)] = port.kernel_launches()["fused_inverted_residual"]
    widths = [blk.expand_1x1.kernel.shape[-1] for blk in blocks if blk.conv_3x3.stride == 1]
    check(want_ir == sum(e >= mobilevit.IR_FUSED_MIN_EXPAND for e in widths) and want_ir > 0
          and got_ir == {"bfloat16": want_ir, "float32": 0},
          f"{tag}: fused_ir default: {got_ir} inverted-residual launches a forward, want "
          f"{want_ir} at bf16 (stride-1 widths {widths}, E >= "
          f"{mobilevit.IR_FUSED_MIN_EXPAND}) and 0 at f32")
    log(f"[{tag}] fused_ir default on the card: E >= {mobilevit.IR_FUSED_MIN_EXPAND} of the "
        f"stride-1 widths {widths}: {got_ir} launches a forward (bf16, f32)")
    del vit, x
    torch.cuda.empty_cache()

    for argv in (["bench", "--model", "gru", "--batch", "1024", "--steps", "256",
                  "--qtype", "q8_0", "--compute", "bfloat16"],
                 ["bench", "--model", "mobilevit", "--batch", "128", "--compute", "bfloat16"],
                 ["bench", "--model", "mobilevit", "--batch", "128", "--compute", "float32"]):
        rc, out, sec = run_command(argv)
        line = json.loads(out.strip().splitlines()[-1])
        check(rc == 0 and line["device"] == torch.cuda.get_device_name(0)
              and line["ms_per_call"] > 0 and np.isfinite(line["ms_per_call"]),
              f"{tag}: {' '.join(argv)}: rc {rc}, {line}")
        log(f"[{tag}] {' '.join(argv)} ({sec:.1f} s): {json.dumps(line)}")


# ---------------------------------------------------------------------------
# phase 21: multi-device serving (the parent spawns this script as ranks)
# ---------------------------------------------------------------------------

def md_request_set(rng, tok, n, lo, hi, new_lo, new_hi, temp=0.0):
    prompts = corpus_prompts(tok, rng, n, lo, hi)
    return [(p, int(rng.integers(new_lo, new_hi + 1)), temp) for p in prompts]


def md_save_requests(path, reqs):
    import numpy as np

    np.savez(path, flat=np.concatenate([p for p, _, _ in reqs]).astype(np.int32),
             lens=np.asarray([p.size for p, _, _ in reqs], np.int32),
             new=np.asarray([n for _, n, _ in reqs], np.int32),
             temp=np.asarray([t for _, _, t in reqs], np.float32))


def md_load_requests(path):
    import numpy as np

    with np.load(path) as f:
        ends = np.cumsum(f["lens"])
        return [(f["flat"][e - n:e], int(nw), float(t))
                for e, n, nw, t in zip(ends, f["lens"], f["new"], f["temp"])]


def md_save_tokens(path, tokens):
    import numpy as np

    np.savez(path, flat=np.concatenate(tokens).astype(np.int32),
             lens=np.asarray([len(t) for t in tokens], np.int32))


def md_load_tokens(path):
    import numpy as np

    with np.load(path) as f:
        ends = np.cumsum(f["lens"])
        return [f["flat"][e - n:e] for e, n in zip(ends, f["lens"])]


def md_serve(eng, reqs):
    """The primary submits ``reqs`` in order; every rank drives the loop.
    Returns (the primary's tokens, seconds)."""
    import torch

    from ggml_experiments_tpu_torch.parallel import multihost

    multihost.sync_hosts()
    t0 = time.perf_counter()
    handles = ([eng.submit(p, n, temperature=t) for p, n, t in reqs]
               if multihost.is_primary() else [])
    eng.run_until_idle(timeout_s=600)
    torch.cuda.synchronize()
    return [h.result(timeout=0) for h in handles], time.perf_counter() - t0


def md_in_turn(rank, world, fn):
    """``fn()`` on each rank in turn (the others wait at barriers), so that
    two ranks on one card are timed alone. Returns this rank's result."""
    from ggml_experiments_tpu_torch.parallel import multihost

    out = None
    for r in range(world):
        multihost.sync_hosts()
        if r == rank:
            out = fn()
    multihost.sync_hosts()
    return out


def md_serve_rank(tag, work, rank, world, dev):
    """Rank ``rank`` of phase 21's two-rank session: (a) the slot-sharded
    fused tick engine, its shard tick against the plain version; (b) the
    tensor-parallel scan tick and the qmatmul kernel on a column shard; (c)
    the data-parallel MobileViT forward."""
    import numpy as np
    import torch

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.models.mobilevit import (
        extract_features_data_parallel,
        load_mobilevit,
    )
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.parallel import (
        gru_param_specs,
        make_mesh,
        multihost,
        place,
        sharding,
    )
    from ggml_experiments_tpu_torch.serving import DecodeEngine
    from ggml_experiments_tpu_torch.serving.engine import init_state

    f32, bf16 = torch.float32, torch.bfloat16
    primary = multihost.is_primary()
    out = {"rank": rank}
    params = load_gru_params(CKPT, qtype="q8_0", device=dev)
    wf = fused._prep_weights(params)
    n_slots, inner = MD_ENGINE_SHAPE

    # ---- (a) the slot-sharded fused tick --------------------------------------------
    mesh = make_mesh((world, 1))
    dp = place(params, gru_param_specs(params), mesh)   # every leaf replicated
    eng = DecodeEngine(dp, n_slots=n_slots, max_prompt=64, inner_steps=inner,
                       compute_dtype=bf16, use_fused_tick=True, enable_sampling=True, seed=1,
                       top_k=20, top_p=0.9)
    check(eng._fused_slot_axis == "data", f"{tag}: the tick is not slot-sharded")
    reqs = md_load_requests(os.path.join(work, "serve.npz"))
    port.reset_kernel_launches()
    toks, secs = md_serve(eng, reqs)        # timed as it runs: nothing patched in
    out["serve"] = dict(launches=port.kernel_launches()["fused_slot_tick"],
                        digest=eng.state_digest(), steps=eng.stats.device_steps, seconds=secs,
                        tokens_per_s=eng.stats.tokens_per_s, held=sum(
                            r is not None for r in eng._slot_req.values()),
                        plan=str(fused.LAST_PLAN.get("fused_slot_tick")))
    # a second engine serves the same requests with each tick's gather
    # instrumented (a synchronize and a barrier a tick, which the timed run
    # above does not carry): the wait for the peer's tick, then the gather
    gathers, waits = [], []
    real_gather = fused._gather_slots

    def timed_gather(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multihost.sync_hosts()
        t1 = time.perf_counter()
        res = real_gather(*a)
        torch.cuda.synchronize()
        waits.append(t1 - t0)
        gathers.append(time.perf_counter() - t1)
        return res

    eng2 = DecodeEngine(dp, n_slots=n_slots, max_prompt=64, inner_steps=inner,
                        compute_dtype=bf16, use_fused_tick=True, enable_sampling=True, seed=1,
                        top_k=20, top_p=0.9)
    fused._gather_slots = timed_gather
    try:
        toks2, _ = md_serve(eng2, reqs)
    finally:
        fused._gather_slots = real_gather
    check(eng2.state_digest() == out["serve"]["digest"] and all(
        np.array_equal(a, b) for a, b in zip(toks, toks2)),
        f"{tag}: rank {rank}: the instrumented run served other tokens")
    out["serve"].update(gather_ms=[round(1e3 * g, 3) for g in gathers],
                        wait_ms=[round(1e3 * w, 3) for w in waits])
    del eng2
    # the same gather, warm, ten times in lockstep: of a tensor on the card
    # and of a host tensor
    row = 4 * wf.u + 8 + inner
    for where, buf in (("cuda", torch.zeros((n_slots // world, row), dtype=torch.uint8,
                                            device=dev)),
                       ("host", torch.zeros((n_slots // world, row), dtype=torch.uint8))):
        times = []
        for _ in range(11):
            multihost.sync_hosts()
            t0 = time.perf_counter()
            mesh.all_gather(buf, "data")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out["serve"][f"gather_{where}_ms"] = 1e3 * statistics.median(times[1:])
    if primary:
        md_save_tokens(os.path.join(work, "serve_tokens.npz"), toks)

    # each rank's shard of one identical sampled tick against its plain version
    shard = fused.tick_shard(n_slots, wf.mode, inner, world, rank)
    lo, hi = shard.lo, shard.hi
    ids, lens = pad_batch([p for p, _, _ in reqs[:n_slots]], 64)
    st = init_state(params, n_slots, 64)
    st.prompt, st.plen = torch.from_numpy(ids).to(dev), torch.from_numpy(lens).to(dev)
    st.total = st.plen + inner
    st.temp = torch.full((n_slots,), 0.8, device=dev)
    kw = dict(enable_sampling=True, seed=12345, top_k=20, top_p=0.9)
    h_k, prev_k, pos_k, t_k = fused.fused_slot_tick_shard(params, st, inner, shard,
                                                          compute_dtype=bf16, **kw)
    sl = slice(lo, hi)
    t_p, _, _, pos_p, gaps = fused.gru_loop_reference(
        wf, st.prompt[sl], st.plen[sl], st.total[sl], st.prev[sl], st.pos[sl], st.h[sl], inner,
        bf16, temp=st.temp[sl], seed=12345, top_k=20, top_p=0.9, margins=True,
        slot_base=shard.slot_base, key_tile=shard.key_tile)
    check(torch.equal(pos_k, pos_p), f"{tag}: rank {rank}: shard tick cursors differ")
    agree, forked = first_divergence_near_ties(t_k.int(), t_p, gaps, NEAR_TIE["bfloat16"],
                                               f"{tag}: rank {rank} sampled shard tick")
    unkeyed = fused.gru_loop_cuda("fused_slot_tick", wf, st.prompt[sl], st.plen[sl],
                                  st.total[sl], st.prev[sl], st.pos[sl], st.h[sl], inner, bf16,
                                  temp=st.temp[sl], seed=12345, top_k=20, top_p=0.9,
                                  toks_u8=True)[0]
    # the rows whose sampled steps (past the prompt) drew another stream
    sampled_steps = torch.arange(inner, device=dev)[None, :] >= st.plen[sl, None]
    rows = sampled_steps.any(dim=1)
    rekeyed = float(((unkeyed != t_k) & sampled_steps).any(dim=1)[rows].float().mean())
    check(rank == 0 or rekeyed > 0.5, f"{tag}: rank {rank}: the shard's keys changed "
                                      f"{rekeyed:.3f} of its sampled rows' streams")
    # teacher-forced at f32: h against the plain version
    tf_st = init_state(params, n_slots, inner)
    tf_st.prompt = torch.from_numpy(np.random.default_rng(21).integers(
        0, wf.v, (n_slots, inner)).astype(np.int32)).to(dev)
    tf_st.plen = torch.full((n_slots,), inner, dtype=torch.int32, device=dev)
    tf_st.total = tf_st.plen.clone()
    h_k, _, _, tt_k = fused.fused_slot_tick_shard(params, tf_st, inner, shard, compute_dtype=f32)
    tt_p, h_p, *_ = fused.gru_loop_reference(
        wf, tf_st.prompt[sl], tf_st.plen[sl], tf_st.total[sl], tf_st.prev[sl], tf_st.pos[sl],
        tf_st.h[sl], inner, f32, slot_base=shard.slot_base, key_tile=shard.key_tile)
    tf_err = float((h_k - h_p).abs().max())
    check(torch.equal(tt_k.int(), tt_p) and tf_err <= 1e-4,
          f"{tag}: rank {rank}: teacher-forced shard tick h err {tf_err:.3g}")
    greedy = init_state(params, n_slots, 64)
    greedy.prompt, greedy.plen, greedy.total = st.prompt, st.plen, st.total
    port.reset_kernel_launches()
    times = md_in_turn(rank, world, lambda: (
        cuda_ms(lambda: fused.fused_slot_tick_shard(params, greedy, inner, shard,
                                                    compute_dtype=bf16), n=10),
        cuda_ms(lambda: fused.gru_loop_reference(
            wf, greedy.prompt[sl], greedy.plen[sl], greedy.total[sl], greedy.prev[sl],
            greedy.pos[sl], greedy.h[sl], inner, bf16), n=1, warmup=1)))
    weight_bytes = tensor_bytes(wf.emb, wf.wc, wf.ws, wf.uc, wf.us, wf.bias, wf.dc, wf.ds,
                                wf.dbias)
    b = hi - lo
    v, e, u = wf.v, wf.e, wf.u
    ops = 2 * v * e * 3 * u + 2 * b * inner * (3 * u * u + u * v)
    nbytes = weight_bytes + b * 64 * 4 + b * (4 * 4 + 4 * u) + b * (4 * 2 + 4 * u) + b * inner
    b_ms, b_by = bound(nbytes, ops, "bfloat16")
    out["tick"] = dict(lo=lo, hi=hi, slot_base=shard.slot_base, key_tile=shard.key_tile,
                       agree=agree, forked=forked, rekeyed=rekeyed, max_abs_err=tf_err,
                       ms=times[0], plain_ms=times[1], bound_ms=b_ms, bound_by=b_by)
    log(f"[{tag}] rank {rank}: shard slots [{lo}, {hi}) keyed at slot_base "
        f"{shard.slot_base}, key_tile {shard.key_tile}: sampled bf16 tick against its plain "
        f"version {agree:.6f} token agreement ({forked} rows fork, at near-ties), "
        f"{100 * rekeyed:.1f}% of sampled rows draw another stream than an unkeyed launch | "
        f"teacher-forced f32 h max abs err {tf_err:.3g} | greedy bf16 shard tick "
        f"{times[0]:.3f} ms alone on the card, plain {times[1]:.1f} ms, bound {b_ms:.3f} ms "
        f"({b_by})")
    del greedy, tf_st, st
    multihost.sync_hosts()

    # ---- (b) the tensor-parallel scan tick ------------------------------------------
    tp = make_mesh((1, world))
    placed = place(params, gru_param_specs(params), tp)
    rk = placed.cell.recurrent_kernel
    check(isinstance(rk, sharding.Placed) and rk.dim == 1 and rk.local.shape == (1024, 1536)
          and isinstance(placed.dense_kernel, sharding.Placed) and placed.dense_kernel.dim == 0,
          f"{tag}: the TP placement is not column-parallel gates + a row-parallel head")
    tp_slots, tp_inner = MD_TP_SHAPE
    eng_tp = DecodeEngine(placed, n_slots=tp_slots, max_prompt=64, inner_steps=tp_inner,
                          compute_dtype=bf16)
    check(not eng_tp.use_fused_tick, f"{tag}: tensor-parallel params took the fused tick")
    port.reset_kernel_launches()
    toks_tp, secs_tp = md_serve(eng_tp, md_load_requests(os.path.join(work, "tp.npz")))
    out["tp"] = dict(launches=port.kernel_launches()["qmatmul_q8_0"], seconds=secs_tp,
                     digest=eng_tp.state_digest(), steps=eng_tp.stats.device_steps,
                     tokens_per_s=eng_tp.stats.tokens_per_s)
    check(out["tp"]["launches"] > 0, f"{tag}: the TP scan tick launched no qmatmul kernel")
    if primary:
        md_save_tokens(os.path.join(work, "tp_tokens.npz"), toks_tp)
    readings = md_in_turn(rank, world, lambda: qmatmul_phase(
        f"{tag} rank {rank} column shard", rk.local, dev) if rank == 0 else None)
    if readings is not None:
        out["qmatmul"] = {f"{m}:{c}": r for (m, c), r in readings.items()}
    del eng_tp, placed
    torch.cuda.empty_cache()

    # ---- (c) the data-parallel MobileViT forward ------------------------------------
    vit = load_mobilevit(VIT_CKPT, device=dev)
    with np.load(os.path.join(work, "images.npz")) as f:
        images = torch.from_numpy(f["images"])
    feats = {}
    images = images.to(dev)
    for cd in (bf16, f32):
        port.reset_kernel_launches()
        feats[cdname(cd)] = extract_features_data_parallel(vit, images, compute_dtype=cd)
        torch.cuda.synchronize()
        launches = port.kernel_launches()
        secs = []
        for _ in range(3):       # timed once warm: the first call sets up routes and caches
            multihost.sync_hosts()
            t0 = time.perf_counter()
            extract_features_data_parallel(vit, images, compute_dtype=cd)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        secs = statistics.median(secs)
        names = (("fused_transformer_layer", "fused_inverted_residual") if cd == bf16
                 else ("flash_mha",))
        check(all(launches[n] > 0 for n in names), f"{tag}: rank {rank} {cdname(cd)} forward "
                                                   f"launched {launches}")
        out[f"vision_{cdname(cd)}"] = dict(seconds=secs, launches={n: launches[n] for n in names})
    if primary:
        np.savez(os.path.join(work, "features.npz"),
                 **{k: t.cpu().numpy() for k, t in feats.items()})
    out["vision_digest"] = float(feats["bfloat16"].double().abs().sum())
    return out


def md_die_rank(tag, work, rank, world, dev):
    """Phase 21 (d): two ranks snapshot mid-decode; rank 1 dies with no
    shutdown; rank 0's next tick must fail or stall, never complete."""
    import threading

    import torch

    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.parallel import gru_param_specs, make_mesh, multihost, place
    from ggml_experiments_tpu_torch.serving import DecodeEngine

    params = load_gru_params(CKPT, qtype="q8_0", device=dev)
    params = place(params, gru_param_specs(params), make_mesh((world, 1)))
    eng = DecodeEngine(params, n_slots=MD_DIE_SLOTS, max_prompt=64,
                       inner_steps=MD_ENGINE_SHAPE[1], compute_dtype=torch.bfloat16,
                       use_fused_tick=True)
    if multihost.is_primary():
        for p, n, t in md_load_requests(os.path.join(work, "die.npz")):
            eng.submit(p, n)
    eng._tick()
    eng._tick()
    snap = os.path.join(work, "engine.gxt")
    if multihost.is_primary():
        eng.snapshot(snap)
    out = {"rank": rank, "snapshot_written": os.path.exists(snap),
           "slot_axis": eng._fused_slot_axis}
    multihost.sync_hosts()
    if rank == 1:
        os._exit(17)            # no shutdown, no barrier
    status = {"done": False, "error": None}

    def tick():
        try:
            eng._tick()
        except Exception as ex:  # noqa: BLE001 - the peer's death, whatever its form
            status["error"] = f"{type(ex).__name__}: {ex}"[:160]
        status["done"] = True

    t0 = time.perf_counter()
    th = threading.Thread(target=tick, daemon=True)
    th.start()
    th.join(timeout=MD_DEATH_WAIT_S)
    out["peer_death"] = ("error" if status["error"] else
                         "wedged" if not status["done"] else "tick_succeeded")
    out["detail"] = status["error"]
    out["seconds"] = time.perf_counter() - t0
    with open(os.path.join(work, f"die_{rank}.json"), "w") as f:
        json.dump(out, f)
    sys.stdout.flush()
    os._exit(0)                 # the group is unusable now


def md_nccl_rank(tag, work, rank, world, dev):
    """Phase 21 (e): a one-rank NCCL session serving through the engine's
    process-group path (refill broadcast, slot-sharded tick, gather)."""
    import torch
    import torch.distributed as dist

    import ggml_experiments_tpu_torch as port
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.parallel import gru_param_specs, make_mesh, place
    from ggml_experiments_tpu_torch.serving import DecodeEngine

    params = load_gru_params(CKPT, qtype="q8_0", device=dev)
    params = place(params, gru_param_specs(params), make_mesh((1, 1)))
    n_slots, inner = MD_ENGINE_SHAPE
    eng = DecodeEngine(params, n_slots=n_slots, max_prompt=64, inner_steps=inner,
                       compute_dtype=torch.bfloat16, use_fused_tick=True)
    check(eng._fused_slot_axis == "data", f"{tag}: the NCCL session's tick is not sharded")
    port.reset_kernel_launches()
    toks, secs = md_serve(eng, md_load_requests(os.path.join(work, "nccl.npz")))
    md_save_tokens(os.path.join(work, "nccl_tokens.npz"), toks)
    return {"rank": rank, "backend": str(dist.get_backend()), "seconds": secs,
            "steps": eng.stats.device_steps,
            "launches": port.kernel_launches()["fused_slot_tick"]}


def rank_main(argv) -> int:
    """``chip_smoke.py --rank SCENARIO PORT RANK WORLD DIR BACKEND``: one rank
    of a phase-21 session, spawned by the phase. Writes DIR/SCENARIO_RANK.json."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    scenario, port_, rank, world, work, backend = argv
    rank, world = int(rank), int(world)
    os.environ["GXT_TORCH_DECODE_DISPATCH"] = os.path.join(work, "none.json")
    from ggml_experiments_tpu_torch.parallel import multihost

    dev = multihost.initialize(backend, f"tcp://localhost:{port_}", world, rank,
                               device="cuda:0", timeout_s=MD_TIMEOUT_S[scenario])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = {"serve": md_serve_rank, "die": md_die_rank, "nccl": md_nccl_rank}[scenario]
    out = run(f"21 multi-device {scenario}", work, rank, world, dev)
    with open(os.path.join(work, f"{scenario}_{rank}.json"), "w") as f:
        json.dump(out, f)
    multihost.sync_hosts()
    multihost.shutdown()
    return 0


def md_spawn(tag, scenario, world, work, backend):
    """Run ``world`` ranks of ``scenario`` (this script with ``--rank``) and
    print their output. Returns their exit codes."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port_ = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(MD_RANK_ARGV + ["--rank", scenario, str(port_), str(r),
                                               str(world), work, backend],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MD_SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines():
            if line.startswith("["):
                log(line)
        if p.returncode not in (0, 17):
            log(f"[{tag}] rank {r} of {scenario} exited {p.returncode}:\n{text[-6000:]}")
    log(f"[{tag}] {scenario}: {world} rank(s) over {backend} on cuda:0, ran "
        f"{time.perf_counter() - t0:.1f} s from spawn to exit")
    return [p.returncode for p in procs]


def md_result(work, scenario, rank):
    with open(os.path.join(work, f"{scenario}_{rank}.json")) as f:
        return json.load(f)


def multidevice_phase(tag, dev, rng, tok, images, smi):
    """Phase 21: multi-device serving on one card. Two ranks share cuda:0
    over gloo (NCCL refuses two ranks on one device): (a) the slot-sharded
    fused tick engine, (b) the tensor-parallel scan tick, (c) the
    data-parallel MobileViT forward, (d) host death and the snapshot's
    restore in this process; then (e) a one-rank NCCL session. Returns the
    kernels-line entries of the sharded tick and the column-shard qmatmul."""
    import numpy as np
    import torch

    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.models.mobilevit import extract_features, load_mobilevit
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.ops.linear import linear
    from ggml_experiments_tpu_torch.serving import DecodeEngine

    f32, bf16 = torch.float32, torch.bfloat16
    n_slots, inner = MD_ENGINE_SHAPE
    half = n_slots // 2
    # the first wave fills every slot: greedy requests, then the same sampled
    # prompts at the last MD_SAMPLED_PAIRS columns of each shard; a backlog
    # of greedy requests waits for the refills
    greedy = md_request_set(rng, tok, n_slots - 2 * MD_SAMPLED_PAIRS + MD_BACKLOG, 1, 64, 16,
                            256)
    sampled = md_request_set(rng, tok, MD_SAMPLED_PAIRS, 4, 64, 64, 200, temp=0.8)
    g0 = half - MD_SAMPLED_PAIRS
    serve = greedy[:g0] + sampled + greedy[g0:2 * g0] + sampled + greedy[2 * g0:]
    tp_reqs = md_request_set(rng, tok, MD_TP_REQUESTS, 1, 64, 16, 128)
    die = md_request_set(rng, tok, MD_DIE_REQUESTS, 1, 64, 16, 256)
    nccl = md_request_set(rng, tok, MD_NCCL_REQUESTS, 1, 64, 16, 128)
    tmp = tempfile.TemporaryDirectory()
    work = tmp.name
    for name, reqs in (("serve", serve), ("tp", tp_reqs), ("die", die), ("nccl", nccl)):
        md_save_requests(os.path.join(work, f"{name}.npz"), reqs)
    np.savez(os.path.join(work, "images.npz"), images=images[:MD_VIT_IMAGES])

    # the single-process references, on this process's card
    params = load_gru_params(CKPT, qtype="q8_0", device=dev)

    def offline(reqs):
        ids, lens = pad_batch([p for p, _, _ in reqs], 64)
        return fused.fused_gru_decode(params, ids, lens, 64 + max(n for _, n, _ in reqs),
                                      compute_dtype=bf16).cpu().numpy()

    one = DecodeEngine(params, n_slots=n_slots, max_prompt=64, inner_steps=inner,
                       compute_dtype=bf16, use_fused_tick=True, enable_sampling=True, seed=1,
                       top_k=20, top_p=0.9)
    t0 = time.perf_counter()
    one_handles = [one.submit(p, n, temperature=t) for p, n, t in serve]
    one.run_until_idle(timeout_s=600)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # ---- (a), (b), (c): two ranks sharing the card -----------------------------------
    rcs = md_spawn(tag, "serve", 2, work, MD_BACKEND)
    check(rcs == [0, 0], f"{tag}: the two-rank session failed: exit codes {rcs}")
    r0, r1 = md_result(work, "serve", 0), md_result(work, "serve", 1)
    got = md_load_tokens(os.path.join(work, "serve_tokens.npz"))
    check(len(got) == len(serve), f"{tag}: {len(got)} of {len(serve)} requests came back")
    want = offline(serve)
    n_greedy = 0
    for i, ((p, n, t), g) in enumerate(zip(serve, got)):
        check(g.size == p.size + n and np.array_equal(g[:p.size], p) and g.max() < 66,
              f"{tag}: request {i}: {g.size} tokens")
        if t == 0.0:
            n_greedy += 1
            check(np.array_equal(g, want[i, :p.size + n]) and np.array_equal(
                g, one_handles[i].result(timeout=0)),
                f"{tag}: greedy request {i} differs from the offline decode / one process")
    pairs = [(g0 + k, half + g0 + k) for k in range(MD_SAMPLED_PAIRS)]
    distinct = sum(not np.array_equal(got[a], got[b]) for a, b in pairs)
    check(distinct == len(pairs), f"{tag}: {len(pairs) - distinct} identical sampled prompts "
                                  f"in the two shards drew one stream")
    for key in ("digest", "steps"):
        check(r0["serve"][key] == r1["serve"][key], f"{tag}: the ranks' {key} differ: "
                                                    f"{r0['serve'][key]} {r1['serve'][key]}")
    check(r1["serve"]["held"] == 0, f"{tag}: the follower holds requests")
    check(r0["serve"]["launches"] > 0 and r1["serve"]["launches"] > 0,
          f"{tag}: a rank launched no tick: {r0['serve']['launches']}, "
          f"{r1['serve']['launches']}")
    check(r1["tick"]["slot_base"] == half, f"{tag}: rank 1 keyed at {r1['tick']['slot_base']}")
    log(f"[{tag}] (a) {len(serve)} requests ({n_greedy} greedy, each equal to the offline "
        f"decode and to one process's engine; {2 * MD_SAMPLED_PAIRS} sampled, the "
        f"{len(pairs)} prompts repeated in the two shards at the same column all drew distinct "
        f"streams) on a {n_slots} x {inner} engine, each rank ticking {half} slots: "
        f"{r0['serve']['steps']} ticks, state digests equal ({r0['serve']['digest']}), tick "
        f"launches {r0['serve']['launches']} + {r1['serve']['launches']}, plan "
        f"{r0['serve']['plan']}")
    log(f"[{tag}] (a) {smi}: both ranks share one card (gloo on loopback), so these "
        f"figures are overhead, not scaling | shard tick alone on the card: rank 0 "
        f"{r0['tick']['ms']:.3f} ms, rank 1 {r1['tick']['ms']:.3f} ms | the gather of the ticked "
        f"slots, tick by tick (ms), in a second run of the same requests with a sync and a "
        f"barrier a tick: rank 0 {r0['serve']['gather_ms']}, rank 1 "
        f"{r1['serve']['gather_ms']}, after waiting {r0['serve']['wait_ms']} / "
        f"{r1['serve']['wait_ms']} for the peer; warm, alone (median of 10): "
        f"{r0['serve']['gather_cuda_ms']:.3f} ms from the card, "
        f"{r0['serve']['gather_host_ms']:.3f} ms of host tensors | two ranks, uninstrumented, "
        f"{r0['serve']['tokens_per_s']:,.0f} tokens/s ({r0['serve']['seconds']:.3f} s) against "
        f"one process {one.stats.tokens_per_s:,.0f} tokens/s ({one_s:.3f} s), the same engine "
        f"and requests")

    # (b) the tensor-parallel scan tick against the single-process plain loop
    got_tp = md_load_tokens(os.path.join(work, "tp_tokens.npz"))
    ids, lens = pad_batch([p for p, _, _ in tp_reqs], 64)
    steps = 64 + max(n for _, n, _ in tp_reqs)
    ref = gru_textgen.generate(params, ids, lens, steps, compute_dtype=bf16)
    z = torch.zeros(len(tp_reqs), dtype=torch.int32, device=dev)
    tt = torch.full((len(tp_reqs),), steps, dtype=torch.int32, device=dev)
    *_, gaps = fused.gru_loop_reference(
        fused._prep_weights(params), torch.nn.functional.pad(torch.from_numpy(ids).to(dev),
                                                             (0, steps - 64)),
        torch.from_numpy(lens).to(dev), tt, z, z, torch.zeros(len(tp_reqs), 1024, device=dev),
        steps, bf16, margins=True)
    got_pad = np.zeros((len(tp_reqs), steps), np.int64)
    want_pad = ref.cpu().numpy().astype(np.int64)
    for i, ((p, n, _), g) in enumerate(zip(tp_reqs, got_tp)):
        check(g.size == p.size + n, f"{tag}: TP request {i}: {g.size} tokens")
        got_pad[i, :g.size] = g
        got_pad[i, g.size:] = want_pad[i, g.size:]
    agree, forked = first_divergence_near_ties(torch.from_numpy(got_pad),
                                               torch.from_numpy(want_pad), gaps.cpu(),
                                               NEAR_TIE["bfloat16"],
                                               f"{tag}: TP scan tick vs generate")
    check(r0["tp"]["digest"] == r1["tp"]["digest"], f"{tag}: TP state digests differ")
    log(f"[{tag}] (b) {len(tp_reqs)} greedy requests on the TP scan tick ((1, 2) mesh: gate "
        f"kernels column-parallel, 1024 x 1536 a rank through the qmatmul kernel; head "
        f"row-parallel): token agreement with one process's generate {agree:.6f} ({forked} rows "
        f"fork, at near-ties) | qmatmul launches {r0['tp']['launches']} + "
        f"{r1['tp']['launches']} | {r0['tp']['tokens_per_s']:,.0f} tokens/s "
        f"({r0['tp']['steps']} ticks), state digests equal")

    # (c) the data-parallel MobileViT forward against one process's
    vit = load_mobilevit(VIT_CKPT, device=dev)
    x = torch.from_numpy(images[:MD_VIT_IMAGES]).to(dev)
    with np.load(os.path.join(work, "features.npz")) as f:
        dp = {k: torch.from_numpy(f[k]).to(dev) for k in ("bfloat16", "float32")}
    for cd in (bf16, f32):
        want_f = extract_features(vit, x, compute_dtype=cd)
        err = float((dp[cdname(cd)] - want_f).abs().max())
        lim = (VIT_ENGINE_FEATURE_MAX if cd == bf16 else VIT_CPU_FEATURE_REL) * float(
            want_f.abs().max())
        check(err <= lim, f"{tag}: DP {cdname(cd)} features differ by {err:.3g} (limit "
                          f"{lim:.3g})")

        def logits(feats):
            return linear(feats.mean(dim=(1, 2)), vit.classifier_kernel, vit.classifier_bias,
                          compute_dtype=f32).float()

        agree_v, flips = argmax_near_ties(f"{tag}: DP {cdname(cd)} argmax",
                                          logits(dp[cdname(cd)]), logits(want_f), VIT_NEAR_TIE)
        rv = r0[f"vision_{cdname(cd)}"]
        log(f"[{tag}] (c) DP MobileViT {cdname(cd)}, {MD_VIT_IMAGES} images, "
            f"{MD_VIT_IMAGES // 2} a rank: features max abs err {err:.3g} against one process "
            f"(limit {lim:.3g}), argmax agreement {agree_v:.4f} ({flips} flips, at near-ties) | "
            f"rank 0 launches {rv['launches']} | {1e3 * rv['seconds']:.3f} ms a warm DP "
            f"forward (median of 3, gather included)")
    del vit, dp
    torch.cuda.empty_cache()

    # ---- (d) host death, then the restore in this process ----------------------------
    want_die = offline(die)
    uninterrupted = DecodeEngine(params, n_slots=MD_DIE_SLOTS, max_prompt=64,
                                 inner_steps=inner, compute_dtype=bf16, use_fused_tick=True)
    u_handles = [uninterrupted.submit(p, n) for p, n, _ in die]
    uninterrupted.run_until_idle(timeout_s=600)
    rcs = md_spawn(tag, "die", 2, work, MD_BACKEND)
    check(rcs == [0, 17], f"{tag}: host death: exit codes {rcs} (want 0 and 17)")
    with open(os.path.join(work, "die_0.json")) as f:
        d0 = json.load(f)
    check(d0["snapshot_written"] and d0["slot_axis"] == "data"
          and d0["peer_death"] in ("error", "wedged"), f"{tag}: host death: {d0}")
    eng2 = DecodeEngine.restore(os.path.join(work, "engine.gxt"), params, inner_steps=inner,
                                compute_dtype=bf16, use_fused_tick=True)
    partial = sum(1 for r in eng2.restored_requests
                  if 0 < len(r._tokens) < r.prompt_ids.size + r.max_new_tokens)
    queued = sum(1 for r in eng2.restored_requests if not r._tokens)
    check(partial > 0 and queued > 0,
          f"{tag}: the snapshot holds {len(eng2.restored_requests)} requests, {partial} "
        f"mid-way, {queued} queued")
    eng2.run_until_idle(timeout_s=600)
    restored = {request_key(r.prompt_ids, r.max_new_tokens): r.result(timeout=0)
                for r in eng2.restored_requests}
    done_before = len(die) - len(restored)
    for i, ((p, n, _), h) in enumerate(zip(die, u_handles)):
        k = request_key(p, n)
        if k in restored:
            check(np.array_equal(restored[k], h.result(timeout=0)) and np.array_equal(
                restored[k], want_die[i, :p.size + n]),
                f"{tag}: restored request {i} differs from the uninterrupted run")
    log(f"[{tag}] (d) host death: snapshot after 2 ticks of a {MD_DIE_SLOTS}-slot two-rank "
        f"engine, rank 1 exits 17, rank 0's next tick: {d0['peer_death']} after "
        f"{d0['seconds']:.1f} s ({d0['detail']}) | restored in one process: "
        f"{len(restored)} requests ({partial} mid-way, {queued} queued; {done_before} done "
        f"before) finish equal to the uninterrupted engine and the offline decode")

    # ---- (e) one rank over NCCL --------------------------------------------------------
    rcs = md_spawn(tag, "nccl", 1, work, "nccl")
    check(rcs == [0], f"{tag}: the one-rank NCCL session failed: exit code {rcs}")
    n0 = md_result(work, "nccl", 0)
    got_n = md_load_tokens(os.path.join(work, "nccl_tokens.npz"))
    want_n = offline(nccl)
    for i, ((p, n, _), g) in enumerate(zip(nccl, got_n)):
        check(np.array_equal(g, want_n[i, :p.size + n]), f"{tag}: NCCL request {i} differs")
    check("nccl" in n0["backend"] and n0["launches"] > 0, f"{tag}: NCCL session: {n0}")
    log(f"[{tag}] (e) one rank, backend {n0['backend']}: {len(nccl)} requests through the "
        f"refill broadcast and the slot gather on NCCL, {n0['steps']} ticks, {n0['launches']} "
        f"tick launches, every request equal to the offline decode")
    tmp.cleanup()

    ticks = [r0["tick"], r1["tick"]]
    tick_entry = dict(launches=r0["serve"]["launches"] + r1["serve"]["launches"],
                      max_abs_err=max(t["max_abs_err"] for t in ticks), ms=ticks[0]["ms"],
                      plain_ms=ticks[0]["plain_ms"], bound_ms=ticks[0]["bound_ms"],
                      bound_by=ticks[0]["bound_by"], library_ms=None,
                      plan=r0["serve"]["plan"])
    readings = {(int(k.split(":")[0]), k.split(":")[1]): v for k, v in r0["qmatmul"].items()}
    qmm_entry = qmatmul_entry(readings, r0["tp"]["launches"] + r1["tp"]["launches"])
    return tick_entry, qmm_entry


def request_key(prompt_ids, max_new):
    """A request's identity across an engine restore (queued requests are
    renumbered there, so ids do not carry over)."""
    return tuple(int(t) for t in prompt_ids), int(max_new)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import ggml_experiments_tpu_torch as port
    except ImportError as ex:
        print(f"chip_smoke: the port's package is not beside this script ({ex})",
              file=sys.stderr)
        return 2
    import numpy as np

    # the committed decode thresholds, whatever calibration file the machine has
    dispatch_dir = tempfile.TemporaryDirectory()
    os.environ["GXT_TORCH_DECODE_DISPATCH"] = os.path.join(dispatch_dir.name, "none.json")

    from ggml_experiments_tpu_torch import _build, cli
    from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any, load_gru_params
    from ggml_experiments_tpu_torch.models import gru_textgen
    from ggml_experiments_tpu_torch.ops import fused_gru_decode as fused
    from ggml_experiments_tpu_torch.quant.qtensor import dequantize, quantize, to_numpy_blocks
    from ggml_experiments_tpu_torch.serving import DecodeEngine
    from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(0)
    tok = CharTokenizer()
    kernels = {}

    # ---- 1. device and build -------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[1 device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | kernel build {build_s:.1f} s")
    for name in _build.SOURCES:
        log(f"[1 device] ptxas {name}: {_build.ptxas_report(name)}")

    # ---- 2. qmatmul q8_0 kernel vs plain ----------------------------------------
    params = load_gru_params(CKPT, qtype="q8_0", device=dev)
    qmm = {"q8_0": qmatmul_phase("2 qmatmul", params.cell.recurrent_kernel, dev)}

    # ---- 3. generate (scan path) ----------------------------------------------
    B, T = GENERATE_SHAPE
    ids, lens = pad_batch(corpus_prompts(tok, rng, B, 8, 40), 40)
    port.reset_kernel_launches()
    t0 = time.perf_counter()
    out32 = gru_textgen.generate(params, ids, lens, T, compute_dtype=f32)
    out16 = gru_textgen.generate(params, ids, lens, T, compute_dtype=bf16)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = port.kernel_launches()
    check(gen_launches["qmatmul_q8_0"] > 0, f"generate launched no qmatmul: {gen_launches}")
    for out in (out32, out16):
        check(out.shape == (B, T) and int(out.min()) >= 0 and int(out.max()) < 66,
              "generate output shape/range")
    params_cpu = load_gru_params(CKPT, qtype="q8_0", device="cpu")
    ref32 = gru_textgen.generate(params_cpu, ids, lens, T, compute_dtype=f32)
    z = torch.zeros(B, dtype=torch.int32)
    tf = torch.full((B,), T, dtype=torch.int32)
    *_, gaps = fused.gru_loop_reference(fused._prep_weights(params_cpu), ref32, tf, tf, z, z,
                                        torch.zeros(B, 1024), T, f32, margins=True)
    agree, forked = first_divergence_near_ties(out32.cpu(), ref32, gaps, NEAR_TIE["float32"],
                                               "generate f32 cuda vs cpu")
    log(f"[3 generate] B={B} T={T} q8_0 f32+bf16 in {gen_s:.2f} s | qmatmul launches "
        f"{gen_launches['qmatmul_q8_0']} | f32 tokens vs the CPU run: agreement {agree:.6f}, "
        f"{forked} rows fork (all at near-ties) | sample: {tok.decode(out16[0].tolist())[:60]!r}")
    kernels["qmatmul_q8_0"] = qmatmul_entry(qmm["q8_0"], gen_launches["qmatmul_q8_0"])
    del params_cpu

    # ---- 4. persistent fused decode -------------------------------------------
    kernels["fused_gru_decode"] = decode_phase("4 fused decode", params, *DECODE_SHAPE,
                                               TF_F32_SHAPE, rng, tok)
    forced_plan_phase("4 fused decode", params, rng)

    # ---- 5. continuous-batching engine on the fused tick -----------------------
    n_slots, inner = ENGINE_SHAPE
    tick_run = engine_phase("5 engine", params, REQUESTS, n_slots, inner, rng, tok)
    seng = DecodeEngine(params, n_slots=n_slots, max_prompt=64, inner_steps=inner,
                        compute_dtype=bf16, temperature=0.8, top_k=20, top_p=0.9,
                        use_fused_tick=True, seed=1)
    sprompts = corpus_prompts(tok, rng, REQUESTS_SAMPLED, 4, 64)
    t0 = time.perf_counter()
    sreqs = [seng.submit(p, 200) for p in sprompts]
    seng.run_until_idle(timeout_s=600)
    seng_s = time.perf_counter() - t0
    for r, p in zip(sreqs, sprompts):
        res = r.result(timeout=0)
        check(len(res) == p.size + 200 and np.array_equal(res[:p.size], p)
              and res.max() < 66, "sampled request output")
    log(f"[5 engine] sampling engine (temperature 0.8, top-k 20, top-p 0.9): {len(sreqs)} "
        f"requests complete in {seng_s:.3f} s, {seng.stats.tokens_per_s:,.0f} tokens/s | "
        f"sample: {tok.decode(sreqs[0].result(timeout=0)[sprompts[0].size:].tolist())[:60]!r}")
    kernels["fused_slot_tick"] = tick_phase("5 engine", params, n_slots, inner, tick_run,
                                            rng, tok)

    # ---- 7. qmatmul, every other format ---------------------------------------------
    float_params = load_gru_params(CKPT, device="cpu")
    w_rec = float_params.cell.recurrent_kernel.numpy()
    B, T = GENERATE_SHAPE
    ids, lens = pad_batch(corpus_prompts(tok, rng, B, 8, 40), 40)
    ids_t, lens_t = torch.from_numpy(ids).to(dev), torch.from_numpy(lens).to(dev)
    prompt_pad = torch.nn.functional.pad(ids_t, (0, T - ids_t.shape[1]))
    zb = torch.zeros(B, dtype=torch.int32, device=dev)
    tb = torch.full((B,), T, dtype=torch.int32, device=dev)
    params_q4_0 = None
    for qtype in ("q4_0", "q4_1", "q5_0", "q5_1", "q4_k"):
        t0 = time.perf_counter()
        qt = quantize(w_rec, qtype, device=dev)
        quant_s = time.perf_counter() - t0
        log(f"[7 qmatmul] {qtype}: recurrent kernel {qt.shape} quantized on the host in "
            f"{quant_s:.1f} s, {qt.nbytes:,} plane bytes ({qt.stored_bits_per_weight:.3f} "
            f"stored bits/weight)")
        qmm[qtype] = qmatmul_phase("7 qmatmul", qt, dev)
        if qtype == "q4_k":
            continue    # its main path is phase 8's generate from the calibrated checkpoint
        # the format's main path: generate from the checkpoint quantized on load
        p_q = load_gru_params(CKPT, qtype=qtype, device=dev)
        port.reset_kernel_launches()
        out32 = gru_textgen.generate(p_q, ids, lens, T, compute_dtype=f32)
        out16 = gru_textgen.generate(p_q, ids, lens, T, compute_dtype=bf16)
        torch.cuda.synchronize()
        launches = port.kernel_launches()
        name = f"qmatmul_{qtype}"
        check(launches[name] > 0, f"generate {qtype} launched no {name}: {launches}")
        check(all(o.shape == (B, T) and int(o.min()) >= 0 and int(o.max()) < 66
                  for o in (out32, out16)), f"generate {qtype} output shape/range")
        want, _, _, _, gaps = fused.gru_loop_reference(
            fused._prep_weights(p_q), prompt_pad, lens_t, tb, zb, zb,
            torch.zeros(B, 1024, device=dev), T, f32, margins=True)
        agree, forked = first_divergence_near_ties(out32, want, gaps, NEAR_TIE["float32"],
                                                   f"generate {qtype} f32 vs the plain loop")
        log(f"[7 qmatmul] generate B={B} T={T} {qtype} f32+bf16: {name} launches "
            f"{launches[name]} | f32 tokens vs the plain loop: agreement {agree:.6f}, {forked} "
            f"rows fork (all at near-ties)")
        kernels[name] = qmatmul_entry(qmm[qtype], launches[name])
        if qtype == "q4_0":
            params_q4_0 = p_q
    del float_params

    # ---- 8. the calibrated q4_k_m checkpoint, full width --------------------------------
    params_km = load_gru_any(CKPT_Q4KM, device=dev)
    launches, kernels["fused_gru_decode_dense"], kernels["fused_slot_tick_dense"] = \
        calibrated_gru_phase("8 q4_k_m", "gru_synth_q4km.gxt", params_km,
                             load_gru_any(CKPT_Q4KM, device="cpu"), ids, lens, rng, tok,
                             n_slots, inner)
    kernels["qmatmul_q4_k"] = qmatmul_entry(qmm["q4_k"], launches["qmatmul_q4_k"])
    del params_km

    # ---- 9. the q4_0 weight route -------------------------------------------------------
    check(fused._prep_weights(params_q4_0).mode == "q4_0", "q4_0 params took another route")
    kernels["fused_gru_decode_q4_0"] = decode_phase("9 q4_0", params_q4_0, *DECODE_SHAPE_Q4_0,
                                                    DECODE_SHAPE_Q4_0, rng, tok)
    tick_run = engine_phase("9 q4_0", params_q4_0, REQUESTS_ROUTE, n_slots, inner, rng, tok)
    kernels["fused_slot_tick_q4_0"] = tick_phase("9 q4_0", params_q4_0, n_slots, inner,
                                                 tick_run, rng, tok)
    del params_q4_0

    # ---- 10. checkpoint round trip and engine snapshot on the card ---------------------
    with tempfile.TemporaryDirectory() as tmp:
        gxt = os.path.join(tmp, "gru_shakespeare_q5_1.gxt")
        check(cli.main(["quantize", "--input", CKPT, "--output", gxt, "--qtype", "q5_1",
                        "--device", "cuda"]) == 0, "quantize command failed")
        p51 = load_gru_any(gxt, device=dev)
        mem = load_gru_params(CKPT, qtype="q5_1", device=dev)
        for name, a, b in (("cell/kernel", p51.cell.kernel, mem.cell.kernel),
                           ("cell/recurrent_kernel", p51.cell.recurrent_kernel,
                            mem.cell.recurrent_kernel),
                           ("dense_kernel", p51.dense_kernel, mem.dense_kernel)):
            check(a.qtype == b.qtype == "q5_1" and a.shape == b.shape
                  and a.codes.device.type == dev.type, f"{name}: loaded as {a.qtype} {a.shape}")
            for pa, pb in zip(to_numpy_blocks(a), to_numpy_blocks(b)):
                check(np.array_equal(pa, pb), f"{name}: a stored plane differs after the "
                                              f"round trip")
            check(torch.equal(dequantize(a), dequantize(b)), f"{name}: dequantized values "
                                                             f"differ after the round trip")
        for a, b in ((p51.embeddings, mem.embeddings), (p51.cell.bias, mem.cell.bias),
                     (p51.dense_bias, mem.dense_bias)):
            check(torch.equal(a, b), "a float tensor differs after the round trip")
        size = os.path.getsize(gxt)
        log(f"[10 checkpoint] quantize -> {os.path.basename(gxt)} ({size:,} bytes, "
            f"{os.path.getsize(CKPT) / size:.2f}x smaller than gru.bin) -> loaded on the card: "
            f"every plane equal to the in-memory q5_1 quantization")

        prompts = corpus_prompts(tok, rng, REQUESTS_ROUTE, 1, 64)
        new_toks = [int(x) for x in rng.integers(16, 257, len(prompts))]
        keys = [request_key(p, nt) for p, nt in zip(prompts, new_toks)]
        check(len(set(keys)) == len(keys), "snapshot workload has duplicate requests")
        # a quarter of the slots, so that the snapshot also catches a backlog
        ekw = dict(n_slots=max(1, n_slots // 4), max_prompt=64, inner_steps=inner,
                   compute_dtype=bf16, use_fused_tick=True)
        whole = DecodeEngine(p51, **ekw)
        wreqs = [whole.submit(p, nt) for p, nt in zip(prompts, new_toks)]
        whole.run_until_idle(timeout_s=600)
        want = {k: r.result(timeout=0) for k, r in zip(keys, wreqs)}
        eng = DecodeEngine(p51, **ekw)
        reqs = [eng.submit(p, nt) for p, nt in zip(prompts, new_toks)]
        eng._tick()
        eng._tick()
        snap = os.path.join(tmp, "engine.gxt")
        eng.snapshot(snap)
        got = {k: r.result(timeout=0) for k, r in zip(keys, reqs) if r._done.is_set()}
        done_before = len(got)
        eng2 = DecodeEngine.restore(snap, p51, inner_steps=inner, compute_dtype=bf16,
                                    use_fused_tick=True)
        partial = sum(1 for r in eng2.restored_requests
                      if 0 < len(r._tokens) < r.prompt_ids.size + r.max_new_tokens)
        queued = sum(1 for r in eng2.restored_requests if not r._tokens)
        check(partial > 0 and queued > 0, f"snapshot caught {partial} requests mid-way and "
                                          f"{queued} queued: not an interrupted run")
        eng2.run_until_idle(timeout_s=600)
        torch.cuda.synchronize()
        for r in eng2.restored_requests:
            got[request_key(r.prompt_ids, r.max_new_tokens)] = r.result(timeout=0)
        check(set(got) == set(keys), f"{len(set(keys) - set(got))} requests lost by the restore")
        ids10, lens10 = pad_batch(prompts, 64)
        offline = fused.fused_gru_decode(p51, ids10, lens10, 64 + 256, compute_dtype=bf16).cpu()
        for i, (k, p, nt) in enumerate(zip(keys, prompts, new_toks)):
            check(np.array_equal(got[k], want[k]),
                  f"request {i}: restored run differs from the uninterrupted engine")
            check(np.array_equal(got[k], offline[i, :p.size + nt].numpy()),
                  f"request {i}: restored run differs from the offline decode")
        log(f"[10 checkpoint] engine of {eng2.n_slots} slots: snapshot after 2 ticks ({os.path.getsize(snap):,} bytes; "
            f"{done_before} requests done, {partial} mid-way, {queued} queued) -> restore -> "
            f"all {len(keys)} requests equal to the uninterrupted engine and to the offline "
            f"decode (q5_1, dense weight route, on the card)")

    # ---- 11. the fused training pair against its plain versions ------------------------
    del p51, mem
    torch.cuda.empty_cache()
    fparams = load_gru_params(CKPT, device=dev)
    train_k = train_kernel_phase("11 train kernels", fparams, dev, tok)
    del fparams
    torch.cuda.empty_cache()

    # ---- 12. training at full width ----------------------------------------------------
    main_k = train_k[TRAIN_SHAPES[0]]
    train_launches = train_phase("12 training", dev, tok,
                                 (main_k["fwd"]["ms"], main_k["bwd_total_ms"]))
    for part in ("fwd", "bwd", "dwr"):
        name = f"fused_gru_train_{part}"
        kernels[name] = dict(main_k[part], launches=train_launches[name])

    # ---- 13. the vision kernels against their plain versions -------------------------
    from ggml_experiments_tpu_torch.models.mobilevit import load_mobilevit
    from ggml_experiments_tpu_torch.training.image_task import (
        FULL_AMP_FACTOR,
        HELDOUT_SEED,
        make_dataset,
    )

    torch.cuda.empty_cache()
    vit = load_mobilevit(VIT_CKPT, device=dev)
    vision = vision_kernel_phase("13 vision kernels", vit, dev)
    del vit
    torch.cuda.empty_cache()

    # ---- 14. MobileViT through the entry points ----------------------------------------
    t0 = time.perf_counter()
    images, labels = make_dataset(VIT_IMAGES, seed=HELDOUT_SEED, image_size=256,
                                  amp_factor=FULL_AMP_FACTOR)
    log(f"[14 mobilevit] {VIT_IMAGES} held-out images (256 px, task rev 4) made in "
        f"{time.perf_counter() - t0:.1f} s")
    vit_launches, vit, vit_logits = vision_model_phase("14 mobilevit", dev, images, labels)
    for name in ("fused_transformer_layer", *LAYER_KERNELS, "flash_mha",
                 "fused_inverted_residual"):
        kernels[name] = dict(vision[name], launches=vit_launches[name])

    # ---- 15. the vision engine ---------------------------------------------------------
    vision_engine_phase("15 vision engine", vit, images)
    del vit
    torch.cuda.empty_cache()

    # ---- 16. GRU calibration on the card ----------------------------------------------
    gru_calibration_phase("16 gru calibration", dev, rng, tok, n_slots, inner)
    torch.cuda.empty_cache()

    # ---- 17. the MobileViT remainders on the card --------------------------------------
    vision_remainders_phase("17 vision remainders", dev, images, labels, vit_logits)
    del vit_logits
    torch.cuda.empty_cache()

    # ---- 18-20. HTTP serving, the dispatch gates and bench --------------------------------
    http_text_phase("18 http text", dev, rng, tok)
    torch.cuda.empty_cache()
    http_vision_phase("19 http vision", dev, images)
    torch.cuda.empty_cache()
    gates_phase("20 gates", dev, rng, tok)
    torch.cuda.empty_cache()

    # ---- 21. multi-device serving ---------------------------------------------------------
    kernels["fused_slot_tick_sharded"], kernels["qmatmul_q8_0_column_shard"] = \
        multidevice_phase("21 multi-device", dev, rng, tok, images, smi)
    del images
    torch.cuda.empty_cache()

    # ---- 6. kernels ---------------------------------------------------------------
    src = "ggml_experiments_tpu_torch/csrc/"
    qmm_at = "ggml_experiments_tpu/quant/pallas_kernels.py:253"
    dec_at = "ggml_experiments_tpu/ops/fused_gru_decode.py:227"
    tick_at = "ggml_experiments_tpu/ops/fused_gru_decode.py:774"
    meta = {f"qmatmul_{q}": (src + "qmatmul.cu", qmm_at)
            for q in ("q8_0", "q4_0", "q4_1", "q5_0", "q5_1", "q4_k")}
    for route in ("", "_q4_0", "_dense"):
        meta["fused_gru_decode" + route] = (src + "gru_persistent.cu", dec_at)
        meta["fused_slot_tick" + route] = (src + "gru_persistent.cu", tick_at)
    meta["fused_gru_train_fwd"] = (src + "gru_train.cu",
                                   "ggml_experiments_tpu/ops/fused_gru_train.py:186")
    meta["fused_gru_train_bwd"] = (src + "gru_train.cu",
                                   "ggml_experiments_tpu/ops/fused_gru_train.py:285")
    meta["fused_gru_train_dwr"] = (src + "gru_train.cu",
                                   "ggml_experiments_tpu/ops/fused_gru_train.py:285")
    for name in ("fused_transformer_layer",) + LAYER_KERNELS:
        meta[name] = (src + "transformer_layer.cu",
                      "ggml_experiments_tpu/ops/fused_transformer_layer.py:184")
    meta["flash_mha"] = (src + "flash_attention.cu",
                         "ggml_experiments_tpu/ops/flash_attention.py:104")
    meta["fused_inverted_residual"] = (src + "inverted_residual.cu",
                                       "ggml_experiments_tpu/ops/fused_inverted_residual.py:146")
    # phase 21: the tick on one rank's slot shard, the qmatmul kernel on a column shard
    meta["fused_slot_tick_sharded"] = (src + "gru_persistent.cu", tick_at)
    meta["qmatmul_q8_0_column_shard"] = (src + "qmatmul.cu", qmm_at)
    line = []
    for name, (source, replaces) in meta.items():
        check(name in kernels, f"{name} was not measured")
        kd = kernels[name]
        check(kd["launches"] > 0, f"{name} was not launched on its main path")
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": kd["launches"], "max_abs_err": kd["max_abs_err"],
                 "ms": kd["ms"], "plain_ms": kd["plain_ms"], "bound_ms": kd["bound_ms"],
                 "bound_by": kd["bound_by"], "library_ms": kd["library_ms"]}
        if "bfloat16" in kd:     # qmatmul: the main path's bf16 cell beside its f32 one
            entry["bfloat16"] = kd["bfloat16"]
        if "plan" in kd:         # the persistent kernel, the train pair: the plan its run took
            entry["plan"] = kd["plan"]
        line.append(entry)
    log(json.dumps({"kernels": line}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
