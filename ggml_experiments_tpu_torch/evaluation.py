"""Quantization-delta evaluation: logits / top-1 / perplexity against FP32.

Quantized models must match FP32 within the quantization delta at matched
bit-width; for the GRU that is next-token logits, top-1 agreement and
perplexity on teacher-forced sequences, for MobileViT the classifier logits
(or the features of a model without a head).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DeltaReport:
    max_abs: float
    mean_abs: float
    rel_rmse: float           # ||a-b|| / ||b||
    top1_agreement: Optional[float] = None   # fraction of positions agreeing
    ppl_a: Optional[float] = None
    ppl_b: Optional[float] = None

    def as_dict(self) -> Dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def compare_logits(logits_a, logits_b, *, targets: Optional[np.ndarray] = None) -> DeltaReport:
    """a = candidate (e.g. quantized), b = reference (fp32). Last dim = classes."""
    a, b = _np32(logits_a), _np32(logits_b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    diff = np.abs(a - b)
    rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    top1 = float((a.argmax(-1) == b.argmax(-1)).mean())
    ppl_a = ppl_b = None
    if targets is not None:
        ppl_a = perplexity(a, targets)
        ppl_b = perplexity(b, targets)
    return DeltaReport(max_abs=float(diff.max()), mean_abs=float(diff.mean()), rel_rmse=rel,
                       top1_agreement=top1, ppl_a=ppl_a, ppl_b=ppl_b)


def perplexity(logits, targets) -> float:
    """exp(mean NLL) of integer targets under logits (..., T, V)."""
    logits = torch.from_numpy(_np32(logits))
    targets = torch.as_tensor(np.asarray(targets), dtype=torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    return float(torch.exp(nll.mean()))


def eval_gru_delta(params_ref, params_q, token_seqs, *,
                   compute_dtype=torch.float32) -> DeltaReport:
    """Teacher-forced next-token comparison over (B, T+1) sequences; both
    params run on their own device."""
    from ggml_experiments_tpu_torch.models import gru_textgen

    seqs = np.asarray(token_seqs)
    inputs, targets = seqs[:, :-1], seqs[:, 1:]
    la, _ = gru_textgen.forward_sequence(params_q, inputs, compute_dtype=compute_dtype)
    lb, _ = gru_textgen.forward_sequence(params_ref, inputs, compute_dtype=compute_dtype)
    return compare_logits(la, lb, targets=targets)


def eval_mobilevit_delta(params_ref, params_q, images, *,
                         compute_dtype=torch.float32) -> DeltaReport:
    """Logit comparison when both params have a classifier head, else a
    feature comparison (numeric deltas only); each params runs on its own
    device."""
    from ggml_experiments_tpu_torch.models.mobilevit import classify, extract_features

    images = torch.from_numpy(np.ascontiguousarray(images, np.float32))
    with torch.no_grad():
        if params_ref.classifier_kernel is not None and params_q.classifier_kernel is not None:
            return compare_logits(classify(params_q, images, compute_dtype=compute_dtype),
                                  classify(params_ref, images, compute_dtype=compute_dtype))
        a = _np32(extract_features(params_q, images, compute_dtype=compute_dtype))
        b = _np32(extract_features(params_ref, images, compute_dtype=compute_dtype))
    a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    diff = np.abs(a2 - b2)
    return DeltaReport(max_abs=float(diff.max()), mean_abs=float(diff.mean()),
                       rel_rmse=float(np.linalg.norm(a2 - b2) / max(np.linalg.norm(b2), 1e-30)))
