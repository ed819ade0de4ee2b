"""Multi-head self-attention over patch tokens, float or block-quantized
projection weights.

The unfused route is the JAX package's einsum path: heads as a reshape of
the channel axis, scores ``q.k^T / sqrt(dh)`` and probabilities stored in
the compute dtype (f32, or bf16 at bf16 compute). With ``flash=True`` and a
sequence length that is a multiple of 8, the score/softmax/context chain goes
to ``ops.flash_attention.flash_mha`` instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ggml_experiments_tpu_torch.device import resolve_dtype
from ggml_experiments_tpu_torch.ops.conv import static_field
from ggml_experiments_tpu_torch.ops.linear import Weight, linear


@dataclasses.dataclass
class AttentionParams:
    wq: Weight
    bq: Optional[torch.Tensor]
    wk: Weight
    bk: Optional[torch.Tensor]
    wv: Weight
    bv: Optional[torch.Tensor]
    wo: Weight
    bo: Optional[torch.Tensor]
    num_heads: int = static_field(4)
    flash: bool = static_field(False)


def softmax_stored(s: torch.Tensor) -> torch.Tensor:
    """Softmax with every step at ``s``'s dtype: exp of the max-shifted
    scores, then a division by their sum (the JAX package's op order)."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def multi_head_attention(p: AttentionParams, x: torch.Tensor, *,
                         compute_dtype=torch.float32) -> torch.Tensor:
    """x: (..., L, C) -> (..., L, C). Dense self-attention, no mask."""
    cd = resolve_dtype(compute_dtype)
    kw = dict(compute_dtype=cd)
    h = p.num_heads
    if p.flash and x.shape[-2] % 8 == 0:
        from ggml_experiments_tpu_torch.ops.flash_attention import flash_mha

        ctx = flash_mha(linear(x, p.wq, p.bq, **kw), linear(x, p.wk, p.bk, **kw),
                        linear(x, p.wv, p.bv, **kw), h, compute_dtype=cd)
        return linear(ctx, p.wo, p.bo, **kw)

    def heads(t):
        *lead, l, c = t.shape
        return t.reshape(*lead, l, h, c // h)

    q = heads(linear(x, p.wq, p.bq, **kw))
    k = heads(linear(x, p.wk, p.bk, **kw))
    v = heads(linear(x, p.wv, p.bv, **kw))
    dh = q.shape[-1]
    scores = torch.einsum("...lhd,...mhd->...hlm", q, k) / math.sqrt(dh)
    probs = softmax_stored(scores)
    ctx = torch.einsum("...hlm,...mhd->...lhd", probs, v)
    *lead, l, c = x.shape
    return linear(ctx.reshape(*lead, l, c), p.wo, p.bo, **kw)
