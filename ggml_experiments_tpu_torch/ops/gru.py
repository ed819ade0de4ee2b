"""TF-variant GRU cell (reset-after, dual bias rows), batched.

Weight shapes follow the TF export (in-features first):

* ``kernel``            (embed_dim, 3*units)   gate order [z | r | h]
* ``recurrent_kernel``  (units, 3*units)
* ``bias``              (2, 3*units)           row 0 input bias, row 1 recurrent
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ggml_experiments_tpu_torch.ops.linear import Weight, linear


@dataclasses.dataclass
class GRUCellParams:
    kernel: Weight                  # (E, 3U)
    recurrent_kernel: Weight        # (U, 3U)
    bias: Optional[torch.Tensor]    # (2, 3U) or None

    @property
    def units(self) -> int:
        return self.recurrent_kernel.shape[1] // 3


def gru_combine(mx: torch.Tensor, mh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Gate math given the two biased projections mx = x.W + b0, mh = h.U + b1."""
    u = h.shape[-1]
    z = torch.sigmoid(mx[..., :u] + mh[..., :u])
    r = torch.sigmoid(mx[..., u:2 * u] + mh[..., u:2 * u])
    # reset-after: r gates the *projected* recurrent term
    hh = torch.tanh(mx[..., 2 * u:] + r * mh[..., 2 * u:])
    return z * h + (1.0 - z) * hh


def recurrent_projection(p: GRUCellParams, h: torch.Tensor, *,
                         compute_dtype=torch.float32) -> torch.Tensor:
    b_rec = p.bias[1] if p.bias is not None else None
    return linear(h, p.recurrent_kernel, b_rec, compute_dtype=compute_dtype)


def input_projection(p: GRUCellParams, x: torch.Tensor, *,
                     compute_dtype=torch.float32) -> torch.Tensor:
    b_in = p.bias[0] if p.bias is not None else None
    return linear(x, p.kernel, b_in, compute_dtype=compute_dtype)


def gru_cell(p: GRUCellParams, x: torch.Tensor, h: torch.Tensor, *,
             compute_dtype=torch.float32) -> torch.Tensor:
    """One step. x: (B, E), h: (B, U) -> new h (B, U)."""
    mx = input_projection(p, x, compute_dtype=compute_dtype)
    mh = recurrent_projection(p, h, compute_dtype=compute_dtype)
    return gru_combine(mx, mh, h)


def gru_sequence(p: GRUCellParams, xs: torch.Tensor, h0: torch.Tensor, *,
                 compute_dtype=torch.float32):
    """Run over a full sequence, batch-major. xs: (B, T, E) -> (states
    (B, T, U), final state (B, U)). The input projection of the whole
    sequence is one product; only the recurrent projection runs per step.
    The time-major form and its fused kernel pair belong to training."""
    mxs = input_projection(p, xs, compute_dtype=compute_dtype)  # (B, T, 3U)
    h = h0
    ys = []
    for t in range(xs.shape[1]):
        h = gru_combine(mxs[:, t], recurrent_projection(p, h, compute_dtype=compute_dtype), h)
        ys.append(h)
    if not ys:
        return h0.new_zeros((h0.shape[0], 0, h0.shape[1])), h0
    return torch.stack(ys, dim=1), h
