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
     path's M=64);
  3. ``generate`` (scan path) at B=64, T=200, f32 and bf16;
  4. ``decode`` routed to the persistent kernel at B=8192, T=512, bf16, its
     tokens against the plain version's on the same inputs, and the kernel
     teacher-forced against its plain version (there at bf16, and at f32 at
     B=1024, T=256);
  5. ``DecodeEngine`` with the fused tick: ~1000 greedy requests, each equal
     to the offline decode; a sampling engine serving 100 requests; the tick
     kernel against its plain version on one identical tick input;
  6. (printed last) one JSON line listing every kernel with its launches on
     its main-path run, its error against its plain version and its times;
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
     (64, 100): forward ``ys`` / ``mhs``; backward ``dmxs`` / ``dwr`` /
     ``dbrec`` / ``dh0`` from a seeded cotangent; two backward launches on the
     same inputs bit-equal;
 12. training: ``train_from_text`` on ``checkpoints/corpus_train.txt``, bf16,
     B=1024, T=100, one epoch (7 steps): the loss is finite and falls, each
     step launches the forward and the backward kernel once and no plain
     version; the same run interrupted after 4 steps and resumed from its
     train-state file ends bit-equal; the trained weights go to a ``gru.bin``
     that ``generate`` reads back; then ``train-gru`` at its default batch of
     64 for one epoch of the corpus's first 60,000 characters;
 13. the three vision kernels against their plain versions, at the shapes
     the main path gives them for B=128 images and on the full checkpoint's
     weights: the fused transformer layer (``csrc/transformer_layer.cu``) at
     (bp, L, C) = (512, 256, 144), (512, 64, 192), (512, 16, 240), each stage's
     first layer with its input projection, its middle layers and its last
     layer with the final LN and the conv_projection (BN, SiLU); flash
     attention (``csrc/flash_attention.cu``) at the same shapes in f32 and
     bf16, beside ``scaled_dot_product_attention``; the fused inverted
     residual (``csrc/inverted_residual.cu``) at (128, 64, 64, 64), E=256,
     with the residual;
 14. MobileViT through the entry points on
     ``checkpoints/mobilevit_synth_full.ggml`` (256 px, hidden 144/192/240,
     2/4/3 layers, 44 labels): ``classify`` of 320 held-out images of the
     full-size task (``make_dataset``, task rev 4) in batches of 128 at f32
     (flash, 9 launches a batch), bf16 (fused layer, 9 a batch) and bf16 with
     ``fused_ir`` (and the inverted residual, 2 a batch), top-1 against the
     labels and argmax agreement with f32; the card's f32 features of the
     first 32 images against the plain CPU run; the calibrated
     ``mobilevit_synth_full_q4km.gxt`` classifying the same images; the
     ``features`` command; ``extract_features`` at B=128 bf16 timed with CUDA
     events and one forward split by ``torch.profiler``;
 15. the ``VisionEngine`` (ladder 8/32/128, u8 transport, bf16): 300 mixed
     classify/features requests in bursts, every 23rd canceled, each served
     result against the offline forward of the same image.

Launch counts are zeroed just before each main-path run and read just after
it; comparison launches are not counted. Any failed check raises, so the
script exits non-zero before its last line, which is the JSON object
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
port's package beside it, it exits non-zero and prints no result.

Tolerances, and why:
  * qmatmul vs the plain product before its output cast, f32 and bf16, every
    format: the decoded weights are bit-equal, the products are exact in f32
    (bf16 operands) or f32 in both, the sums are f32 in other orders, so
    1e-5 relative.
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
    TRAIN_GRAD_REL (readings 0.002-0.006), and two launches bit-equal.
  * The vision kernels at bf16: both sides round to bf16 at the same places
    but sum in other orders and call other exp routines, so a value on a
    rounding boundary may land one bf16 step off and carry on through the
    layer. Max error within VIT_BF16_MAX of the output's largest value, mean
    error within VIT_BF16_MEAN_FRAC of the plain version's own mean distance
    between rounding to bf16 and not rounding (H100 readings and the mutants
    that skip one rounding are in PERF.md). Flash attention at f32: 1e-5
    relative. The card's f32 features against the CPU: VIT_CPU_FEATURE_REL
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
PEAK_OPS = {"float32": 67e12,  # f32 FMA on CUDA cores (the kernels' products)
            "bfloat16": 989e12}  # bf16 dense tensor-core peak
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
# the training pair against its plain versions (limits: see the docstring)
TRAIN_YS_MAX, TRAIN_MHS_MAX = 0.1, 0.25
TRAIN_GRAD_REL = {"dmxs": 2e-2, "dh0": 2e-2, "dwr": 1e-2, "dbrec": 1e-2}


# the vision path (phases 13-15): apple/mobilevit-small widths, trained head
VIT_CKPT = os.path.join(REPO, "checkpoints", "mobilevit_synth_full.ggml")
VIT_Q4KM = os.path.join(REPO, "checkpoints", "mobilevit_synth_full_q4km.gxt")
VIT_BATCH, VIT_IMAGES, VIT_CPU_IMAGES = 128, 320, 32
VIT_IR_SHAPE = (128, 64, 64, 64, 256, 64)     # (B, H, W, C, E, Cout) of layer_2's blocks
VIT_ENGINE_BURSTS = (5, 8, 30, 128, 3, 100, 17, 2, 7)   # 300 requests
VIT_CANCEL_EVERY = 23
# bf16 kernels against their plain versions on the main path's shapes: max
# error within a fraction of the output's largest value, mean error within a
# fraction of the plain version's own mean distance between rounding to bf16
# and not rounding (set from H100 readings so that a kernel that skips one
# bf16 rounding fails: see the docstring)
VIT_BF16_MAX = {"layer": 0.05, "flash": 2 ** -6, "ir": 2 ** -6}
VIT_BF16_MEAN_FRAC = {"layer": 0.15, "flash": 0.1, "ir": 0.01}
VIT_F32_REL = 1e-5                 # flash at f32 against its plain version
VIT_CPU_FEATURE_REL = 1e-4         # card f32 features against the CPU plain run
VIT_NEAR_TIE = 0.1                 # bf16 logit gap under which an argmax may flip
VIT_ENGINE_FEATURE_MAX = 0.02      # engine vs offline features, x the largest feature


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
            # the plain product before its output cast: bf16 operands (whose
            # products are exact in f32), f32 sums; the kernel returns f32
            want = torch.matmul(x.to(cd).float(), dequantize(qt).to(cd).float())
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            check(rel <= 1e-5, f"qmatmul {qt.qtype} M={m} {cdn}: max rel err {rel:.3g}")
            ms = cuda_ms(lambda: qmatmul_cuda(x, qt, cd))
            plain_ms = cuda_ms(lambda: qmatmul_reference(x, qt, cd))
            w = dequantize(qt).to(cd)
            xc = x.to(cd)
            lib_ms = cuda_ms(lambda: torch.matmul(xc, w))
            nbytes = x.numel() * 4 + qt.nbytes + m * n * 4
            b_ms, b_by = bound(nbytes, 2 * m * k * n, cdn)
            out[(m, cdn)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=b_ms, bound_by=b_by)
            log(f"[{tag}] {qt.qtype} M={m} K={k} N={n} {cdn}: max abs err {err:.3g} (rel "
                f"{rel:.3g}) | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | torch.matmul on "
                f"the dequantized plane {lib_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by})")
    return out


def qmatmul_entry(readings, launches):
    """The kernels-line entry of one qmatmul format: the main path's shape is
    generate at B=64, f32 and bf16; times are f32's, the error the larger."""
    m = QMATMUL_MS[-1]
    return dict(readings[(m, "float32")], launches=launches,
                max_abs_err=max(readings[(m, c)]["max_abs_err"]
                                for c in ("float32", "bfloat16")))


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
    check(launches["fused_gru_decode"] > 0, f"{tag}: decode took the scan path: {launches}")
    wf = fused._prep_weights(params)
    v, e, u = wf.v, wf.e, wf.u
    check(toks.shape == (B, T) and int(toks.max()) < v, f"{tag}: decode output shape/range")
    ids_t, lens_t = torch.from_numpy(ids).to(dev), torch.from_numpy(lens).to(dev)
    dec_ms = cuda_ms(lambda: fused.fused_gru_decode(params, ids_t, lens_t, T), n=3, warmup=1)
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
        f"({b_by}) | launches {launches['fused_gru_decode']} | tokens vs the plain version: "
        f"agreement {agree:.6f}, {forked} rows fork (all at near-ties)")

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
                plain_ms=dec_plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


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
        f"{launches['fused_slot_tick']} | breakdown {json.dumps(eng.stats.breakdown())}")
    return launches["fused_slot_tick"]


def tick_phase(tag, params, n_slots, inner, launches, rng, tok):
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
        f"{tick_plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by})")
    return dict(launches=launches, max_abs_err=tick_tf[inner][0], ms=tick_ms,
                plain_ms=tick_plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def train_kernel_phase(tag, fparams, dev, tok):
    """The fused training forward and backward kernels against their plain
    versions at TRAIN_SHAPES, bf16, U=1024: the trained recurrent kernel and
    bias, the input projection of corpus windows, a seeded h0 and cotangent.
    Returns {(B, T): {"fwd": readings, "bwd": readings}}."""
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
    out = {}
    for B, T in TRAIN_SHAPES:
        ex = make_examples(text, tok, DataConfig(seq_length=T))
        ids = ex[np.random.default_rng(B).permutation(len(ex))[:B], :T]
        check(ids.shape == (B, T), f"{tag}: the corpus gives {ids.shape} windows, want {(B, T)}")
        xs = fparams.embeddings[torch.from_numpy(ids.T.copy()).long().to(dev)]   # (T, B, E)
        mxs = input_projection(cell, xs, compute_dtype=bf16).contiguous()
        g = torch.Generator(device=dev).manual_seed(B)
        h0 = (torch.randn((B, u), generator=g, device=dev) * 0.3).to(bf16)
        dys = (torch.randn((T, B, u), generator=g, device=dev) * 0.01).to(bf16)

        ys, mhs = ft.gru_train_fwd_cuda(mxs, h0, wr, brec)
        torch.cuda.synchronize()
        pys, pmhs = ft.gru_train_fwd_plain(mxs, h0, wr, brec)
        # the yardstick of tf_h_check: the plain version's own distance
        # between rounding to bf16 and not rounding, on the same operands
        fys, _ = ft.gru_train_fwd_plain(mxs.float(), h0.float(), wr.float(), brec)
        d_ys = (ys.float() - pys.float()).abs()
        d_f = (fys - pys.float()).abs()
        ys_max, ys_mean, gap = float(d_ys.max()), float(d_ys.mean()), float(d_f.mean())
        s_mean = float(d_ys[:TF_BF16_SHORT].mean())
        s_gap = float(d_f[:TF_BF16_SHORT].mean())
        d_mh = (mhs.float() - pmhs.float()).abs()
        mh_max, mh_mean = float(d_mh.max()), float(d_mh.mean())
        del d_ys, d_f, d_mh, fys
        check(ys_max <= TRAIN_YS_MAX and mh_max <= TRAIN_MHS_MAX
              and ys_mean <= TF_BF16_MEAN_FRAC_LONG * gap
              and s_mean <= TF_BF16_MEAN_FRAC_SHORT * s_gap,
              f"{tag}: forward B={B} T={T}: ys max abs err {ys_max:.3g} (limit {TRAIN_YS_MAX}), "
              f"mhs max {mh_max:.3g} (limit {TRAIN_MHS_MAX}), ys mean {ys_mean:.3g} (limit "
              f"{TF_BF16_MEAN_FRAC_LONG} x {gap:.3g}), over the first {TF_BF16_SHORT} steps "
              f"{s_mean:.3g} (limit {TF_BF16_MEAN_FRAC_SHORT} x {s_gap:.3g})")
        fwd_ms = cuda_ms(lambda: ft.gru_train_fwd_cuda(mxs, h0, wr, brec), n=5, warmup=1)
        fwd_plain_ms = cuda_ms(lambda: ft.gru_train_fwd_plain(mxs, h0, wr, brec), n=2, warmup=1)
        nbytes = tensor_bytes(mxs, h0, wr, brec, ys, mhs)
        fb_ms, fb_by = bound(nbytes, 2 * T * B * u * 3 * u, "bfloat16")
        log(f"[{tag}] forward B={B} T={T} U={u} bf16: ys max abs err {ys_max:.3g}, mean "
            f"{ys_mean:.3g} (plain f32 vs bf16: {gap:.3g}), first {TF_BF16_SHORT} steps mean "
            f"{s_mean:.3g} (plain f32 vs bf16: {s_gap:.3g}) | mhs max {mh_max:.3g}, mean "
            f"{mh_mean:.3g} | kernel {fwd_ms:.3f} ms = "
            f"{fwd_ms * 1e3 / T:.1f} us/step | plain {fwd_plain_ms:.2f} ms | bound "
            f"{fb_ms:.3f} ms ({fb_by}) | library: none")

        # backward from the plain forward's residuals, so both sides get equal inputs
        got = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr)
        again = ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr)
        torch.cuda.synchronize()
        want = ft.gru_train_bwd_plain(mxs, pmhs, pys, dys, h0, wr)
        names = ("dmxs", "dwr", "dbrec", "dh0")
        rel, dmx_abs = {}, 0.0
        for name, a, a2, w in zip(names, got, again, want):
            check(a.shape == w.shape and bool(torch.isfinite(a.float()).all()),
                  f"{tag}: backward B={B}: {name} shape or values")
            check(torch.equal(a, a2), f"{tag}: backward B={B}: two launches on the same inputs "
                                      f"give different {name}")
            d = float((a.float() - w.float()).abs().max())
            rel[name] = d / float(w.float().abs().max())
            if name == "dmxs":
                dmx_abs = d
            check(rel[name] <= TRAIN_GRAD_REL[name],
                  f"{tag}: backward B={B} T={T}: {name} max |diff| / max |plain| = "
                  f"{rel[name]:.3g} > {TRAIN_GRAD_REL[name]}")
        del again
        bwd_ms = cuda_ms(lambda: ft.gru_train_bwd_cuda(mxs, pmhs, pys, dys, h0, wr), n=5,
                         warmup=1)
        bwd_plain_ms = cuda_ms(lambda: ft.gru_train_bwd_plain(mxs, pmhs, pys, dys, h0, wr), n=2,
                               warmup=1)
        nbytes = tensor_bytes(mxs, pmhs, pys, dys, h0, wr, *got)
        bb_ms, bb_by = bound(nbytes, 4 * T * B * u * 3 * u, "bfloat16")
        log(f"[{tag}] backward B={B} T={T} U={u} bf16: max |diff| / max |plain|: "
            + ", ".join(f"{n} {rel[n]:.3g}" for n in names)
            + f" | two launches bit-equal | kernel {bwd_ms:.3f} ms = {bwd_ms * 1e3 / T:.1f} "
              f"us/step | plain {bwd_plain_ms:.2f} ms | bound {bb_ms:.3f} ms ({bb_by}) | "
              f"library: none")
        out[(B, T)] = {
            "fwd": dict(max_abs_err=ys_max, ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=fb_ms,
                        bound_by=fb_by, library_ms=None),
            "bwd": dict(max_abs_err=dmx_abs, ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bb_ms,
                        bound_by=bb_by, library_ms=None)}
        del got, want, ys, mhs, pys, pmhs, mxs, dys, xs
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
    groups = {"backward kernel": 0.0, "forward kernel": 0.0, "library products": 0.0,
              "other device work": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue    # an operator's row repeats its kernels' time
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3 / n
        if "gru_train_bwd_kernel" in e.key:
            groups["backward kernel"] += ms
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
    ``kernel_ms`` is (forward, backward) kernel time at the main shape, for
    the step's breakdown. Returns the kernels' launches on the main run."""
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
    check(launches["fused_gru_train_fwd"] == n_steps
          and launches["fused_gru_train_bwd"] == n_steps and not any(ft.PLAIN_CALLS.values()),
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
    check(all(after[k] - before[k] == 3 for k in ("fused_gru_train_fwd", "fused_gru_train_bwd")),
          f"{tag}: the profiled steps launched {before} -> {after}")
    del grads, adam, scratch, inp, tgt
    rest_ms = step_ms - sum(kernel_ms) - adam_ms
    log(f"[{tag}] train_from_text corpus_train.txt bf16 B={B} T={T} E=256 U=1024: {n_steps} "
        f"steps, loss {losses[0]:.4f} -> {losses[-1]:.4f} | launches fwd "
        f"{launches['fused_gru_train_fwd']} bwd {launches['fused_gru_train_bwd']}, plain-version "
        f"runs 0 | {step_ms:.2f} ms/step (median of {len(steps_s)}, loss read back each step) = "
        f"{B * T / step_ms * 1e3:,.0f} tokens/s | of a step: forward kernel {kernel_ms[0]:.2f} "
        f"ms, backward kernel {kernel_ms[1]:.2f} ms, Adam {adam_ms:.2f} ms, the rest (input "
        f"projection, vocab head, their gradients, loss, host) {rest_ms:.2f} ms | peak device "
        f"memory {peak_gb:.2f} GB")
    if prof is None:
        log(f"[{tag}] torch.profiler recorded no device time: the step is not split further")
    else:
        log(f"[{tag}] 3 steps under torch.profiler: {prof['wall_ms']:.2f} ms/step wall, device "
            f"busy {prof['busy_ms']:.2f} ms/step (idle share {prof['idle_share']:.3f}): "
            + ", ".join(f"{k} {prof[k]:.2f} ms" for k in ("backward kernel", "forward kernel",
                                                          "library products",
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
        check(all(after[k] - before[k] == cli_steps
                  for k in ("fused_gru_train_fwd", "fused_gru_train_bwd"))
              and not any(ft.PLAIN_CALLS.values()),
              f"{tag}: train-gru launched {before} -> {after}")
        log(f"[{tag}] train-gru at its defaults (B=64, T=100, E=256, U=1024) bf16, "
            f"{cli_steps} steps on the corpus's first {TRAIN_CLI_CHARS:,} characters: "
            f"{json.dumps(summary)} in {cli_s:.2f} s | one forward and one backward launch a "
            f"step")
    return launches



def vision_kernel_phase(tag, params, dev):
    """Phase 13: each vision kernel against its plain version on the card at
    the shapes the main path gives it for B=128 images, with the kernel's,
    the plain version's and (flash) the library call's times and the bound.
    Returns {name: kernels-line readings}: a forward's worth of launches
    summed (2 + 4 + 3 layers), errors the largest over the shapes."""
    import torch
    import torch.nn.functional as F

    from ggml_experiments_tpu_torch.ops import flash_attention as fa
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir
    from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl

    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(13)
    tot = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_t=[0.0, 0.0],
                   library_ms=None) for k in ("fused_transformer_layer", "flash_mha")}
    tot["flash_mha"]["library_ms"] = 0.0

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
            f = ops.wi.shape[1]
            cout = got.shape[-1]
            flops = bp * (4 * l * l * c + 8 * l * c * c + 4 * l * c * f
                          + (2 * l * width * c if "input_proj" in kw else 0)
                          + (2 * l * c * cout if "output_proj" in kw else 0))
            nbytes = bp * l * (width + cout) * 2 + sum(
                t.numel() * t.element_size() for t in (ops.wq, ops.wk, ops.wv, ops.wo, ops.wi,
                                                      ops.wo2, ops.win, ops.wout) if t is not None)
            b_ms, b_by = bound(nbytes, flops, "bfloat16")
            t = tot["fused_transformer_layer"]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            t["ms"] += count * ms
            t["plain_ms"] += count * plain_ms
            t["bound_t"][0] += count * nbytes / HBM_BYTES_PER_S * 1e3
            t["bound_t"][1] += count * flops / PEAK_OPS["bfloat16"] * 1e3
            log(f"[{tag}] fused layer {name} x{count}, (bp, L, Cin, C, Cout) = ({bp}, {l}, "
                f"{width}, {c}, {cout}) bf16: max abs err {err:.3g} (largest value {scale:.3g}), "
                f"mean {mean:.3g} (plain f32 vs "
                f"bf16: {gap:.3g}) | kernel {ms:.4f} ms | plain {plain_ms:.3f} ms | bound "
                f"{b_ms:.4f} ms ({b_by}) | library: none")
            del got, x
        # kernel 7 at the same (bp, L, C): f32 (the main path) and bf16
        h = blk.transformer[0].attention.num_heads
        qkv = [torch.randn((bp, l, c), generator=g, device=dev) for _ in range(3)]
        got = fa.flash_mha_cuda(*qkv, h)
        torch.cuda.synchronize()
        want = fa.flash_mha_plain(*qkv, h)
        rel = float((got - want).abs().max()) / float(want.abs().max())
        check(rel <= VIT_F32_REL, f"{tag}: flash f32 (bp, L, C) = ({bp}, {l}, {c}): max rel err "
                                  f"{rel:.3g} > {VIT_F32_REL}")
        q16 = [t.to(bf16) for t in qkv]
        g16 = fa.flash_mha_cuda(*q16, h)
        torch.cuda.synchronize()
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
        b_ms, b_by = bound(nbytes, flops, "float32")
        t = tot["flash_mha"]
        t["max_abs_err"] = max(t["max_abs_err"], float((got - want).abs().max()))
        t["ms"] += n * ms
        t["plain_ms"] += n * plain_ms
        t["library_ms"] += n * lib_ms
        t["bound_t"][0] += n * nbytes / HBM_BYTES_PER_S * 1e3
        t["bound_t"][1] += n * flops / PEAK_OPS["float32"] * 1e3
        log(f"[{tag}] flash (bp, L, C, H) = ({bp}, {l}, {c}, {h}) x{n}: f32 max rel err "
            f"{rel:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, scaled_dot_product_attention "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) | bf16 max abs err {err16:.3g}, mean "
            f"{mean16:.3g} (plain f32 vs bf16: {gap16:.3g}), kernel {ms16:.4f} ms")
        del got, want, qkv, q16, g16, w16, heads
    for t in tot.values():
        t["bound_ms"] = max(t["bound_t"])
        t["bound_by"] = "bytes" if t["bound_t"][0] >= t["bound_t"][1] else "operations"
        del t["bound_t"]

    # kernel 8 at layer_2's shape, with the residual, on the model's folded weights
    b, hh, ww, c, e, cout = VIT_IR_SHAPE
    blk = params.layer_2[1]
    wexp, bexp = fir.folded_conv_weights(blk.expand_1x1)
    kdw, bdw = fir.folded_conv_weights(blk.conv_3x3)
    wred, bred = fir.folded_conv_weights(blk.reduce_1x1)
    args = (wexp.reshape(c, e), bexp, kdw.reshape(3, 3, e), bdw, wred.reshape(e, cout), bred)
    x = torch.randn((b, hh, ww, c), generator=g, device=dev).to(bf16)
    got = fir.fused_ir_cuda(x, *args, use_residual=True)
    torch.cuda.synchronize()
    plain_args = (args[0].to(bf16), args[1], args[2], args[3], args[4].to(bf16), args[5])
    want = fir.fused_ir_plain(x, *plain_args, use_residual=True)
    err, mean, gap, _ = bf16_check(f"{tag}: fused inverted residual {VIT_IR_SHAPE}", "ir", got,
                                   want, fir.fused_ir_plain(x.float(), *args, use_residual=True))
    ms = cuda_ms(lambda: fir.fused_ir_cuda(x, *args, use_residual=True), n=20)
    plain_ms = cuda_ms(lambda: fir.fused_ir_plain(x, *plain_args, use_residual=True), n=3)
    flops = b * hh * ww * (2 * c * e + 18 * e + 2 * e * cout)
    nbytes = b * hh * ww * (c + cout) * 2 + (c * e + e * cout) * 2 + (11 * e + cout) * 4
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    log(f"[{tag}] fused inverted residual (B, H, W, C, E, Cout) = {VIT_IR_SHAPE} bf16: max abs err "
        f"{err:.3g}, mean {mean:.3g} (plain f32 vs bf16: {gap:.3g}) | kernel {ms:.4f} ms | plain "
        f"{plain_ms:.3f} ms | bound {b_ms:.4f} ms ({b_by}) | library: none")
    tot["fused_inverted_residual"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                          bound_by=b_by, library_ms=None)
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


def vision_model_phase(tag, dev, images, labels):
    """Phase 14: MobileViT through the entry points on the full checkpoint
    (see the module docstring). Returns (main-path launches by kernel, the
    bf16 params, the bf16 forward's images/s)."""
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
    p = load_mobilevit(VIT_CKPT, device=dev)
    p_ir = load_mobilevit(VIT_CKPT, device=dev, fused_ir=True)
    check(p.layer_3.transformer[0].attention.flash and p.layer_3.transformer[0].fused
          and not p.layer_2[1].fused and p_ir.layer_2[1].fused,
          f"{tag}: the default routes on the card are not flash + fused layer")

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
    runs = (("f32", p, f32, {"flash_mha": 9}), ("bf16", p, bf16, {"fused_transformer_layer": 9}),
            ("bf16+fused_ir", p_ir, bf16, {"fused_transformer_layer": 9,
                                           "fused_inverted_residual": 2}))
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

    # throughput of extract_features at B=128, bf16, and one forward profiled
    xb = x_all[:VIT_BATCH].to(dev)
    rates = {}
    for name, params in (("bf16", p), ("bf16+fused_ir", p_ir)):
        ms = cuda_ms(lambda: extract_features(params, xb, compute_dtype=bf16), n=10)
        rates[name] = (ms, VIT_BATCH / ms * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extract_features(p, xb, compute_dtype=bf16)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"fused layer kernel": 0.0, "convolutions": 0.0, "other device work": 0.0}
    other = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3
        key = e.key.lower()
        if "layer_kernel" in key:
            groups["fused layer kernel"] += ms
        elif any(w in key for w in ("conv", "cudnn", "xmma", "implicit", "winograd", "nhwc",
                                    "fprop")):
            groups["convolutions"] += ms
        else:
            groups["other device work"] += ms
            other.append((ms, e.key[:60]))
    busy = sum(groups.values())
    log(f"[{tag}] extract_features B={VIT_BATCH} bf16: " + ", ".join(
        f"{k} {ms:.3f} ms = {r:,.0f} images/s" for k, (ms, r) in rates.items())
        + (f" | one forward under torch.profiler: {wall_ms:.2f} ms wall, device busy {busy:.3f} ms "
           f"(idle share {max(0.0, 1 - busy / wall_ms):.3f}): "
           + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()) if busy > 0 else
           " | torch.profiler recorded no device time"))
    log(f"[{tag}] the largest other device work: " + "; ".join(
        f"{k} {ms:.3f} ms" for ms, k in sorted(other, reverse=True)[:6]))
    return main_launches, p


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

    # ---- 5. continuous-batching engine on the fused tick -----------------------
    n_slots, inner = ENGINE_SHAPE
    tick_launches = engine_phase("5 engine", params, REQUESTS, n_slots, inner, rng, tok)
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
    kernels["fused_slot_tick"] = tick_phase("5 engine", params, n_slots, inner, tick_launches,
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
    route = fused._prep_weights(params_km).mode
    check((params_km.cell.recurrent_kernel.qtype, params_km.dense_kernel.qtype, route)
          == ("q4_k", "q8_0", "dense"), f"q4_k_m checkpoint loaded as {route}")
    port.reset_kernel_launches()
    t0 = time.perf_counter()
    out32 = gru_textgen.generate(params_km, ids, lens, T, compute_dtype=f32)
    out16 = gru_textgen.generate(params_km, ids, lens, T, compute_dtype=bf16)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = port.kernel_launches()
    check(launches["qmatmul_q4_k"] > 0, f"generate q4_k_m launched no qmatmul_q4_k: {launches}")
    check(all(o.shape == (B, T) and int(o.min()) >= 0 and int(o.max()) < 66
              for o in (out32, out16)), "generate q4_k_m output shape/range")
    km_cpu = load_gru_any(CKPT_Q4KM, device="cpu")
    ref32 = gru_textgen.generate(km_cpu, ids, lens, T, compute_dtype=f32)
    *_, gaps = fused.gru_loop_reference(fused._prep_weights(km_cpu), ref32, tf, tf, z, z,
                                        torch.zeros(B, 1024), T, f32, margins=True)
    agree, forked = first_divergence_near_ties(out32.cpu(), ref32, gaps, NEAR_TIE["float32"],
                                               "generate q4_k_m f32 cuda vs cpu")
    log(f"[8 q4_k_m] generate B={B} T={T} from gru_synth_q4km.gxt f32+bf16 in {gen_s:.2f} s | "
        f"qmatmul_q4_k launches {launches['qmatmul_q4_k']} | f32 tokens vs the CPU run: "
        f"agreement {agree:.6f}, {forked} rows fork (all at near-ties) | sample: "
        f"{tok.decode(out16[0].tolist())[:60]!r}")
    kernels["qmatmul_q4_k"] = qmatmul_entry(qmm["q4_k"], launches["qmatmul_q4_k"])
    del km_cpu
    kernels["fused_gru_decode_dense"] = decode_phase("8 q4_k_m", params_km, *DECODE_SHAPE,
                                                     TF_F32_SHAPE, rng, tok)
    tick_launches = engine_phase("8 q4_k_m", params_km, REQUESTS_ROUTE, n_slots, inner, rng,
                                 tok)
    kernels["fused_slot_tick_dense"] = tick_phase("8 q4_k_m", params_km, n_slots, inner,
                                                  tick_launches, rng, tok)
    del params_km

    # ---- 9. the q4_0 weight route -------------------------------------------------------
    check(fused._prep_weights(params_q4_0).mode == "q4_0", "q4_0 params took another route")
    kernels["fused_gru_decode_q4_0"] = decode_phase("9 q4_0", params_q4_0, *DECODE_SHAPE_Q4_0,
                                                    DECODE_SHAPE_Q4_0, rng, tok)
    tick_launches = engine_phase("9 q4_0", params_q4_0, REQUESTS_ROUTE, n_slots, inner, rng,
                                 tok)
    kernels["fused_slot_tick_q4_0"] = tick_phase("9 q4_0", params_q4_0, n_slots, inner,
                                                 tick_launches, rng, tok)
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
                                 (main_k["fwd"]["ms"], main_k["bwd"]["ms"]))
    for part in ("fwd", "bwd"):
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
    vit_launches, vit = vision_model_phase("14 mobilevit", dev, images, labels)
    for name in ("fused_transformer_layer", "flash_mha", "fused_inverted_residual"):
        kernels[name] = dict(vision[name], launches=vit_launches[name])

    # ---- 15. the vision engine ---------------------------------------------------------
    vision_engine_phase("15 vision engine", vit, images)
    del vit, images
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
    meta["fused_transformer_layer"] = (src + "transformer_layer.cu",
                                       "ggml_experiments_tpu/ops/fused_transformer_layer.py:184")
    meta["flash_mha"] = (src + "flash_attention.cu",
                         "ggml_experiments_tpu/ops/flash_attention.py:104")
    meta["fused_inverted_residual"] = (src + "inverted_residual.cu",
                                       "ggml_experiments_tpu/ops/fused_inverted_residual.py:146")
    line = []
    for name, (source, replaces) in meta.items():
        check(name in kernels, f"{name} was not measured")
        kd = kernels[name]
        check(kd["launches"] > 0, f"{name} was not launched on its main path")
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": kd["launches"], "max_abs_err": kd["max_abs_err"],
                     "ms": kd["ms"], "plain_ms": kd["plain_ms"], "bound_ms": kd["bound_ms"],
                     "bound_by": kd["bound_by"], "library_ms": kd["library_ms"]})
    log(json.dumps({"kernels": line}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
