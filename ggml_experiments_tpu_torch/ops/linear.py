"""Dense / matmul with transparent quantized-weight dispatch.

``compute_dtype=float32`` computes in full f32 with f32 results;
``bfloat16`` rounds the operands to bf16 and returns bf16 (the storage dtype
of the result), as the JAX package's ``linear`` does.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ggml_experiments_tpu_torch.device import resolve_dtype
from ggml_experiments_tpu_torch.quant import QTensor, qmatmul

Weight = Union[torch.Tensor, QTensor]


def matmul(x: torch.Tensor, w: Weight, *, compute_dtype=torch.float32) -> torch.Tensor:
    """``x (..., K) @ w (K, N) -> (..., N)``; QTensor weights use qmatmul."""
    if isinstance(w, QTensor):
        return qmatmul(x, w, compute_dtype=compute_dtype)
    cd = resolve_dtype(compute_dtype)
    return torch.matmul(x.to(cd), w.to(cd))


def linear(x: torch.Tensor, w: Weight, b: Optional[torch.Tensor] = None, *,
           compute_dtype=torch.float32) -> torch.Tensor:
    y = matmul(x, w, compute_dtype=compute_dtype)
    if b is not None:
        y = y + b.to(y.dtype)  # keep bf16 results bf16 (bias is stored f32)
    return y


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row gather (ggml's ``ggml_get_rows``)."""
    return table[ids.long()]
