"""Token sampling: greedy, temperature, top-k, nucleus (top-p)."""

from __future__ import annotations

from typing import Optional

import torch

NEG = -1e30


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k largest logits per row (boundary ties kept)."""
    if k <= 0:
        raise ValueError(f"top_k must be positive, got {k}")
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, torch.full_like(logits, NEG))


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the sorted distribution
    with cumulative probability >= p (always keeps the argmax)."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {p}")
    sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # token i is kept iff the cumulative mass BEFORE it is < p
    keep_sorted = (cum - probs) < p
    keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx, keep_sorted)
    return torch.where(keep, logits, torch.full_like(logits, NEG))


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, top_k: Optional[int] = None,
           top_p: Optional[float] = None) -> torch.Tensor:
    """Draw token ids (..., V) -> (...) int32. temperature==0 is greedy."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = logits.float() / temperature
    if top_k is not None:
        x = apply_top_k(x, top_k)
    if top_p is not None:
        x = apply_top_p(x, top_p)
    probs = torch.softmax(x, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)
