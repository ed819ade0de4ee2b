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
import torch.utils.checkpoint

from ggml_experiments_tpu_torch.device import resolve_dtype
from ggml_experiments_tpu_torch.ops.linear import Weight, linear
from ggml_experiments_tpu_torch.pytree import register_params


@dataclasses.dataclass
class GRUCellParams:
    kernel: Weight                  # (E, 3U)
    recurrent_kernel: Weight        # (U, 3U)
    bias: Optional[torch.Tensor]    # (2, 3U) or None

    @property
    def units(self) -> int:
        return self.recurrent_kernel.shape[1] // 3


register_params(GRUCellParams)


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


def fused_train_route(p: GRUCellParams, compute_dtype, device,
                      fused: Optional[bool] = None) -> bool:
    """Whether the time-major forward at ``compute_dtype`` on ``device`` (a
    device or its type) takes the fused kernel pair. bf16 (the JAX model's
    route): an explicit ``fused`` decides; otherwise dense float weights with
    a bias, on a GPU, at a width the bf16 kernels take
    (``fused_gru_train.kernels_take``: U a multiple of 8 with U / 8 blocks
    co-resident). f32: only on a GPU, where the f32 kernels
    (``csrc/gru_train_f32.cu``) take the width, unless ``fused=False``; on
    the CPU f32 keeps the plain loop even with ``fused=True``, as the JAX
    package routes only bf16 to its Pallas pair. A recurrent kernel placed
    on a mesh (``parallel.sharding.Placed``) counts as its local shard's
    kind, at the whole weight's U."""
    cd = resolve_dtype(compute_dtype)
    on_card = torch.device(device).type == "cuda"
    if cd == torch.float32 and not on_card:
        return False
    if fused is not None:
        return fused
    w = p.recurrent_kernel
    w = getattr(w, "local", w)
    if not isinstance(w, torch.Tensor) or p.bias is None or not on_card:
        return False
    from ggml_experiments_tpu_torch.ops.fused_gru_train import SMS, kernels_take

    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if torch.cuda.is_available() else SMS)
    return kernels_take(p.units, sms, cd)


def gru_sequence_time_major(p: GRUCellParams, xs_tm: torch.Tensor, h0: torch.Tensor, *,
                            compute_dtype=torch.float32, remat: bool = False,
                            fused: Optional[bool] = None):
    """Time-major forward, the training layout: xs_tm (T, B, E) -> (ys
    (T, B, U), final state (B, U)). The input projection of the whole
    sequence is one product; only the recurrent projection runs per step.

    Where :func:`fused_train_route` says so (bf16 on any device with
    ``fused=True``, or by default on a GPU; f32 on a GPU only) it goes
    through ``ops/fused_gru_train.fused_gru_scan`` at the compute dtype: the
    whole time loop in one kernel forward and one backward, states in the
    compute dtype, on the rows of ``xs_tm`` (a rank's batch rows under data
    parallelism), with a placed recurrent kernel gathered whole (CPU tensors
    with ``fused=True`` run the kernels' plain versions).
    Everything else is a plain time loop under autograd; ``remat=True``
    checkpoints its cell (``torch.utils.checkpoint``), which the fused pair
    does not need."""
    cd = resolve_dtype(compute_dtype)
    mxs = input_projection(p, xs_tm, compute_dtype=cd)  # (T, B, 3U)

    if fused_train_route(p, cd, mxs.device, fused):
        from ggml_experiments_tpu_torch.ops.fused_gru_train import fused_gru_scan

        if p.bias is None:
            raise ValueError("the fused train kernels take a recurrent bias")
        ys = fused_gru_scan(mxs, h0.to(cd), p.recurrent_kernel, p.bias[1], compute_dtype=cd)
        if ys.shape[0] == 0:
            return ys, h0
        return ys, ys[-1]

    def step(h, mx_t):
        return gru_combine(mx_t, recurrent_projection(p, h, compute_dtype=cd), h)

    h = h0
    ys = []
    for t in range(xs_tm.shape[0]):
        if remat:
            h = torch.utils.checkpoint.checkpoint(step, h, mxs[t], use_reentrant=False)
        else:
            h = step(h, mxs[t])
        ys.append(h)
    if not ys:
        return h0.new_zeros((0, h0.shape[0], h0.shape[1])), h0
    return torch.stack(ys), h


def gru_sequence(p: GRUCellParams, xs: torch.Tensor, h0: torch.Tensor, *,
                 compute_dtype=torch.float32, remat: bool = False,
                 fused: Optional[bool] = None):
    """Run over a full sequence, batch-major. xs: (B, T, E) -> (states
    (B, T, U), final state (B, U)): a wrapper over
    :func:`gru_sequence_time_major`, transposing the small (B, T, E)
    embeddings before the 3U-wide projection."""
    ys, h_last = gru_sequence_time_major(p, xs.swapaxes(0, 1), h0, compute_dtype=compute_dtype,
                                         remat=remat, fused=fused)
    return ys.swapaxes(0, 1), h_last
