"""Multi-head self-attention over patch tokens, float or block-quantized
projection weights.

The unfused route is the JAX package's einsum path: heads as a reshape of
the channel axis, scores ``q.k^T / sqrt(dh)`` and probabilities stored in
the compute dtype (f32, or bf16 at bf16 compute). With ``flash=True`` and a
sequence length that is a multiple of 8, the score/softmax/context chain goes
to ``ops.flash_attention.flash_mha`` instead: on the CPU at any head width
(the plain version), on a CUDA device where the kernel takes the heads
(``flash_takes``: width up to 64).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ggml_experiments_tpu_torch.device import resolve_dtype
from ggml_experiments_tpu_torch.ops.conv import static_field
from ggml_experiments_tpu_torch.ops.linear import Weight, linear
from ggml_experiments_tpu_torch.pytree import register_params


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


register_params(AttentionParams)


def softmax_stored(s: torch.Tensor) -> torch.Tensor:
    """Softmax with every step at ``s``'s dtype: exp of the max-shifted
    scores, then a division by their sum (the JAX package's op order)."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def flash_route(l: int, c: int, num_heads: int, device) -> bool:
    """Whether flash attention takes sequences of L tokens of C channels in
    ``num_heads`` heads on ``device``: any shape on the CPU (the plain
    version), the kernel's (``flash_takes``, against the card's shared
    memory, or an H100's where no card is visible) on a CUDA device."""
    if torch.device(device).type != "cuda":
        return True
    from ggml_experiments_tpu_torch.ops.flash_attention import flash_takes

    if not torch.cuda.is_available():
        return flash_takes(l, c, num_heads)
    props = torch.cuda.get_device_properties(torch.device(device))
    return flash_takes(l, c, num_heads, getattr(props, "shared_memory_per_block_optin", 232448))


def multi_head_attention(p: AttentionParams, x: torch.Tensor, *,
                         compute_dtype=torch.float32) -> torch.Tensor:
    """x: (..., L, C) -> (..., L, C). Dense self-attention, no mask."""
    cd = resolve_dtype(compute_dtype)
    kw = dict(compute_dtype=cd)
    h = p.num_heads
    if p.flash and x.shape[-2] % 8 == 0 and flash_route(x.shape[-2], x.shape[-1], h, x.device):
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
