"""Calibration: activation statistics of the trained model as quantization
weights, and the GPTQ recipes built on them.

For ``y = x @ W``, perturbing row ``i`` of W by dW costs ``E[(x_i dW)^2] =
E[x_i^2] dW^2``: each input row's importance is the second moment of the
activation that multiplies it (ggml's ``imatrix`` statistic). GPTQ
(``quant/gptq.py``) uses the whole Gram ``H = E[x xᵀ]``.

GRU: the trained model runs teacher-forced over calibration text, at f32
through ``gru_textgen.step`` on the params' device; the taps are the
embedding rows (token-frequency weighted) for the input kernel, the previous
hidden state for the recurrent kernel and the current one for the vocab
head. MobileViT: the unfused float forward runs over calibration images
inside ``ops.linear.calibration_taps``, which records each float-weight
product's input Gram in call order; :func:`_vision_quantizable` gives the
weights in that order.

The statistics stay on the params' device in float64; the GPTQ recursion
runs there too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ggml_experiments_tpu_torch.quant.gptq import gptq_quantize_q4_k, gptq_quantize_q8_0
from ggml_experiments_tpu_torch.quant.qtensor import quantize

f64 = torch.float64


def _teacher_forced(params, token_seqs):
    """(token ids of the inputs (B*T,), hidden states (T, B, U) float64) of the
    f32 teacher-forced forward over ``token_seqs`` (B, T+1)."""
    from ggml_experiments_tpu_torch.models import gru_textgen

    dev = params.device
    inputs = torch.as_tensor(np.asarray(token_seqs)[:, :-1], device=dev)
    b, t = inputs.shape
    hs = torch.empty((t, b, params.units), dtype=f64, device=dev)
    h = gru_textgen.init_state(params, b)
    with torch.no_grad():
        for j in range(t):
            _, h = gru_textgen.step(params, inputs[:, j], h)
            hs[j] = h
    return inputs.reshape(-1), hs


def _token_freq(toks: torch.Tensor, vocab: int) -> torch.Tensor:
    counts = torch.bincount(toks.long(), minlength=vocab).to(f64)
    return counts / counts.sum()


def _h_prev(hs: torch.Tensor) -> torch.Tensor:
    """The recurrent kernel's inputs: h_{t-1}, zeros at t=0 included (that is
    the state the product sees)."""
    return torch.cat([torch.zeros_like(hs[:1]), hs[:-1]], dim=0)


def collect_gru_moments(params, token_seqs) -> Dict[str, torch.Tensor]:
    """Per-input-row activation second moments for the GRU's weight matrices.

    ``token_seqs``: int array (B, T+1) of teacher-forcing sequences. Returns
    ``{"kernel": (E,), "recurrent_kernel": (U,), "dense_kernel": (U,)}``
    float64 on the params' device."""
    toks, hs = _teacher_forced(params, token_seqs)
    emb = params.embeddings.detach().to(f64)
    u = hs.shape[-1]
    return {
        # input kernel rows multiply emb[token]: token-frequency-weighted
        "kernel": _token_freq(toks, emb.shape[0]) @ emb ** 2,
        "recurrent_kernel": torch.mean(_h_prev(hs).reshape(-1, u) ** 2, dim=0),
        "dense_kernel": torch.mean(hs.reshape(-1, u) ** 2, dim=0),
    }


def collect_gru_hessians(params, token_seqs) -> Dict[str, torch.Tensor]:
    """Input Gram matrices ``H = E[x xᵀ]`` (float64, on the params' device)
    for the GRU's three weight matrices, with the taps of
    :func:`collect_gru_moments`."""
    toks, hs = _teacher_forced(params, token_seqs)
    emb = params.embeddings.detach().to(f64)
    u = hs.shape[-1]
    freq = _token_freq(toks, emb.shape[0])
    h_prev = _h_prev(hs).reshape(-1, u)
    h_cur = hs.reshape(-1, u)
    return {
        "kernel": (emb * freq[:, None]).t() @ emb,
        "recurrent_kernel": h_prev.t() @ h_prev / h_prev.shape[0],
        "dense_kernel": h_cur.t() @ h_cur / h_cur.shape[0],
    }


def _replace_weights(params, kernel, recurrent_kernel, dense_kernel):
    """The GRU params with new weight matrices (and empty derived caches)."""
    return dataclasses.replace(
        params, cell=dataclasses.replace(params.cell, kernel=kernel,
                                         recurrent_kernel=recurrent_kernel),
        dense_kernel=dense_kernel, cache={})


def gptq_gru_params(params, token_seqs, *, head_qtype: str = "q8_0"):
    """The < 5 bits/weight GRU recipe (``q4_k_m``): GPTQ-compensated q4_k on
    the two gate matrices, ``head_qtype`` on the vocab head (GPTQ q8_0 by
    default: ~2% of the weights, feeding the logits directly). Calibration
    runs the float ``params`` over ``token_seqs`` (training text, not the
    eval set); everything runs on the params' device."""
    dev = params.device
    hess = collect_gru_hessians(params, token_seqs)
    if head_qtype == "q8_0":
        head = gptq_quantize_q8_0(params.dense_kernel, hess["dense_kernel"], device=dev)
    else:
        head = quantize(params.dense_kernel, head_qtype, device=dev)
    return _replace_weights(
        params,
        # the input kernel's activations span only the embedding rows (a
        # rank-deficient H): a tiny damp lets the recursion put rounding
        # error into the null space the model never sees
        gptq_quantize_q4_k(params.cell.kernel, hess["kernel"], percdamp=1e-4, device=dev),
        gptq_quantize_q4_k(params.cell.recurrent_kernel, hess["recurrent_kernel"], device=dev),
        head)


def calibrated_gru_params(params, token_seqs, qtype: str = "q4_k"):
    """Round-to-nearest at ``qtype`` with the collected activation moments as
    the grid search's importance (used by q4_k; the other formats ignore
    it); biases and embeddings stay float."""
    dev = params.device
    mom = collect_gru_moments(params, token_seqs)

    def q(w, key):
        return quantize(w, qtype, importance=mom[key].cpu().numpy(), device=dev)

    return _replace_weights(params, q(params.cell.kernel, "kernel"),
                            q(params.cell.recurrent_kernel, "recurrent_kernel"),
                            q(params.dense_kernel, "dense_kernel"))


# ---------------------------------------------------------------------------
# MobileViT: call-order Gram taps, GPTQ over the transformer kernels
# ---------------------------------------------------------------------------


def _vision_quantizable(params):
    """The quantizable weights as (name, holder, field) in forward call order:
    the unfused forward's attention q/k/v/out, then the MLP pair, per layer
    per block; the classifier last. The Gram collector matches taps to
    weights by this order and checks the shapes."""
    out = []
    for bname in ("layer_3", "layer_4", "layer_5"):
        blk = getattr(params, bname)
        for ti, tl in enumerate(blk.transformer):
            a = tl.attention
            out += [
                (f"{bname}.t{ti}.wq", a, "wq"),
                (f"{bname}.t{ti}.wk", a, "wk"),
                (f"{bname}.t{ti}.wv", a, "wv"),
                (f"{bname}.t{ti}.wo", a, "wo"),
                (f"{bname}.t{ti}.intermediate", tl, "intermediate_kernel"),
                (f"{bname}.t{ti}.output", tl, "output_kernel"),
            ]
    if params.classifier_kernel is not None:
        out.append(("classifier", params, "classifier_kernel"))
    return out


def collect_mobilevit_grams(params, images, *, batch: int = 32,
                            compute_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Input Grams ``E[x xᵀ]`` (float64, on the params' device) of every
    quantizable MobileViT weight, keyed like :func:`_vision_quantizable`.

    ``params`` must be float (no qtype) on the unfused path (``fused_layer``
    off: the fused kernels bypass ``ops.linear``). Each batch's Grams are
    f32 products, summed in float64 and divided by the number of batches
    (GPTQ does not depend on the Gram's overall scale)."""
    from ggml_experiments_tpu_torch.models.mobilevit import classify, extract_features
    from ggml_experiments_tpu_torch.ops.linear import calibration_taps

    order = _vision_quantizable(params)
    fwd = classify if params.classifier_kernel is not None else extract_features
    images = np.asarray(images)
    acc, shapes, rows = None, None, 0
    for i in range(0, len(images), batch):
        chunk = torch.from_numpy(np.ascontiguousarray(images[i:i + batch], np.float32))
        with calibration_taps() as taps, torch.no_grad():
            fwd(params, chunk, compute_dtype=compute_dtype)
        if acc is None:
            shapes = [s for s, _, _ in taps]
            acc = [torch.zeros(g.shape, dtype=f64, device=g.device) for _, g, _ in taps]
        for a, (_, g, _) in zip(acc, taps):
            a += g.to(f64)
        rows += 1
    if acc is None:
        raise ValueError("no calibration images supplied")
    if len(acc) != len(order):
        raise AssertionError(
            f"tap count {len(acc)} != quantizable weights {len(order)}: the forward call "
            "order changed (fused layer on, or params already quantized?)")
    out = {}
    for (name, holder, field), wshape, a in zip(order, shapes, acc):
        k = getattr(holder, field).shape[0]
        if tuple(a.shape) != (k, k) or wshape[0] != k:
            raise AssertionError(f"gram/weight shape mismatch at {name}")
        out[name] = a / rows
    return out


def gptq_mobilevit_params(target_params, grams, *, head_qtype: str = "q8_0"):
    """Replace ``target_params``' transformer kernels with GPTQ q4_k QTensors
    (the classifier at ``head_qtype``: GPTQ q8_0 by default) from the Grams
    of :func:`collect_mobilevit_grams`, on the params' device.
    ``target_params`` may be a fresh float load with any route flags: only
    the weight leaves change. Returns the same object, changed in place."""
    dev = target_params.device
    for name, holder, field in _vision_quantizable(target_params):
        w, h = getattr(holder, field), grams[name]
        if name == "classifier" and head_qtype == "q8_0":
            qt = gptq_quantize_q8_0(w, h, device=dev)
        elif name == "classifier":
            qt = quantize(w, head_qtype, device=dev)
        else:
            qt = gptq_quantize_q4_k(w, h, device=dev)
        setattr(holder, field, qt)
    for bname in ("layer_3", "layer_4", "layer_5"):
        for tl in getattr(target_params, bname).transformer:
            # the fused layer's operands gathered from the float weights
            for attr in ("_gxt_fused_operands", "_gxt_fused_operands_f32"):
                tl.__dict__.pop(attr, None)
    return target_params
