"""Dense / matmul with transparent quantized-weight dispatch.

``compute_dtype=float32`` computes in full f32 with f32 results;
``bfloat16`` rounds the operands to bf16 and returns bf16 (the storage dtype
of the result), as the JAX package's ``linear`` does.

:func:`calibration_taps` records, for every float-weight product inside its
``with`` block, the input Gram ``x2ᵀ x2`` that GPTQ calibration needs
(``quant/calibration.py``). QTensor weights and the fused kernels (which do
not call :func:`matmul`) are not tapped.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import List, Optional, Tuple, Union

import torch

from ggml_experiments_tpu_torch.device import resolve_dtype
from ggml_experiments_tpu_torch.quant import QTensor, qmatmul

Weight = Union[torch.Tensor, QTensor]

_TAPS: contextvars.ContextVar = contextvars.ContextVar("calibration_taps", default=None)


@contextlib.contextmanager
def calibration_taps():
    """Inside the block, every float-weight :func:`matmul` appends
    ``(weight shape, x2ᵀ x2 (K, K) float32, rows of x2)`` to the yielded list,
    in call order, with ``x2`` the input flattened to (rows, K) in f32. The
    Gram is a full-f32 product (TF32 off on the GPU)."""
    taps: List[Tuple[tuple, torch.Tensor, int]] = []
    token = _TAPS.set(taps)
    try:
        yield taps
    finally:
        _TAPS.reset(token)


def _tap(taps, x: torch.Tensor, w: torch.Tensor) -> None:
    x2 = x.detach().reshape(-1, x.shape[-1]).float()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gram = x2.t() @ x2
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    taps.append((tuple(w.shape), gram, x2.shape[0]))


def matmul(x: torch.Tensor, w: Weight, *, compute_dtype=torch.float32) -> torch.Tensor:
    """``x (..., K) @ w (K, N) -> (..., N)``; QTensor weights use qmatmul;
    any other weight that is not a tensor (a rank's shard of one) computes
    its own product, ``w.matmul(x, compute_dtype=)``."""
    if isinstance(w, QTensor):
        return qmatmul(x, w, compute_dtype=compute_dtype)
    if not isinstance(w, torch.Tensor):
        return w.matmul(x, compute_dtype=compute_dtype)
    taps = _TAPS.get()
    if taps is not None:
        _tap(taps, x, w)
    cd = resolve_dtype(compute_dtype)
    return torch.matmul(x.to(cd), w.to(cd))


def linear(x: torch.Tensor, w: Weight, b: Optional[torch.Tensor] = None, *,
           compute_dtype=torch.float32) -> torch.Tensor:
    """``x @ w + b``; a bias that is not a tensor (a rank's shard of one) is
    gathered whole first, ``b.gather()``."""
    y = matmul(x, w, compute_dtype=compute_dtype)
    if b is not None and not isinstance(b, torch.Tensor):
        b = b.gather()
    if b is not None:
        y = y + b.to(y.dtype)  # keep bf16 results bf16 (bias is stored f32)
    return y


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor, *,
                     one_hot_grad: bool = False) -> torch.Tensor:
    """Row gather (ggml's ``ggml_get_rows``).

    ``one_hot_grad=True`` computes the lookup as a one-hot product instead:
    the same values, but the table's gradient is then a matrix product and
    not a scatter-add. On CUDA the gather's backward sums duplicate rows with
    atomics, in an order that changes from run to run; the product is
    reproducible, which the trainer's bit-exact resume needs. Use it under
    autograd when V is small; the plain gather is the faster forward."""
    if one_hot_grad:
        onehot = torch.nn.functional.one_hot(ids.long(), table.shape[0]).to(table.dtype)
        return torch.matmul(onehot, table)
    return table[ids.long()]
