#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``ggml_experiments_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes the main path
gives it, then drives the main paths through the entry points a user calls,
at full width (V=66, E=256, U=1024). Phases 2-5 run the committed trained
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
     uninterrupted engine and to the offline decode.

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
