"""Character-level GRU text generator (embed -> GRU(reset-after) -> dense).

The decode loop keeps the JAX package's semantics: at step j a slot feeds
prompt[j] while j < prompt_length, else its previous prediction, and the
emitted sequence is the tokens *fed*. Weights may be float32 tensors or
QTensors of any block format; the recurrent projection then runs through
that format's qmatmul kernel.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import torch

from ggml_experiments_tpu_torch.device import resolve_dtype
from ggml_experiments_tpu_torch.ops import sampling
from ggml_experiments_tpu_torch.ops.gru import (
    GRUCellParams,
    gru_cell,
    gru_combine,
    gru_sequence,
    input_projection,
    recurrent_projection,
)
from ggml_experiments_tpu_torch.ops.linear import Weight, embedding_lookup, linear


@dataclasses.dataclass(frozen=True)
class GRUConfig:
    vocab_size: int = 66
    embed_dim: int = 256
    units: int = 1024


@dataclasses.dataclass
class GRUTextGenParams:
    embeddings: torch.Tensor              # (V, E) float32
    cell: GRUCellParams                   # kernels may be QTensor
    dense_kernel: Weight                  # (U, V)
    dense_bias: Optional[torch.Tensor]    # (V,)
    # per-params cache of derived device buffers (fused-kernel operands)
    cache: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def vocab_size(self) -> int:
        return self.embeddings.shape[0]

    @property
    def units(self) -> int:
        return self.cell.units

    @property
    def device(self) -> torch.device:
        return self.embeddings.device


def init_state(params: GRUTextGenParams, batch: int) -> torch.Tensor:
    return torch.zeros((batch, params.units), dtype=torch.float32, device=params.device)


def step(params: GRUTextGenParams, token_ids: torch.Tensor, h: torch.Tensor, *,
         compute_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. token_ids: (B,) int, h: (B, U) -> (logits (B, V), h')."""
    x = embedding_lookup(params.embeddings, token_ids)
    h = gru_cell(params.cell, x, h, compute_dtype=compute_dtype)
    logits = linear(h, params.dense_kernel, params.dense_bias, compute_dtype=compute_dtype)
    return logits, h


def forward_sequence(params: GRUTextGenParams, token_ids, h0: Optional[torch.Tensor] = None,
                     *, compute_dtype=torch.float32,
                     time_major: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced full-sequence forward. token_ids: (B, T) int ->
    (logits (B, T, V), final state (B, U)). The input projection and the
    vocab head are whole-sequence products; only the recurrent projection
    runs inside the time loop."""
    if time_major:
        raise NotImplementedError(
            "the time-major forward and its fused train kernels are not ported yet "
            "(ROADMAP.md, 'Port: still to port', item 5: GRU training)")
    ids = torch.as_tensor(token_ids, device=params.device)
    h = init_state(params, ids.shape[0]) if h0 is None else h0
    xs = embedding_lookup(params.embeddings, ids)                   # (B, T, E)
    ys, h_last = gru_sequence(params.cell, xs, h, compute_dtype=compute_dtype)
    logits = linear(ys, params.dense_kernel, params.dense_bias, compute_dtype=compute_dtype)
    return logits, h_last


def generate(
    params: GRUTextGenParams,
    prompt_ids,                 # (B, P) int, 0-padded
    prompt_lengths,             # (B,) int
    total_steps: int,
    *,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Batched generation replicating the reference decode semantics; returns
    the (B, total_steps) int32 tokens fed. Runs on the params' device.
    ``temperature > 0`` samples (optionally top-k / top-p filtered) from
    ``generator`` (a generator on the params' device; seeded 0 if None)."""
    cd = resolve_dtype(compute_dtype)
    dev = params.device
    prompt_ids = torch.as_tensor(prompt_ids, dtype=torch.int64, device=dev)
    prompt_lengths = torch.as_tensor(prompt_lengths, dtype=torch.int64, device=dev)
    b, p = prompt_ids.shape
    if p < total_steps:
        prompt_pad = torch.nn.functional.pad(prompt_ids, (0, total_steps - p))
    else:
        prompt_pad = prompt_ids[:, :total_steps]
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    # the vocab-wide input projection, computed once: per step the
    # x-projection is a row gather of this (V, 3U) table
    proj = input_projection(params.cell, params.embeddings, compute_dtype=cd)
    h = init_state(params, b)
    prev = prompt_pad[:, 0] if total_steps else prompt_ids[:, 0]
    toks = torch.empty((b, total_steps), dtype=torch.int32, device=dev)
    for j in range(total_steps):
        tok = torch.where(j < prompt_lengths, prompt_pad[:, j], prev)
        toks[:, j] = tok
        mx = proj[tok]
        mh = recurrent_projection(params.cell, h, compute_dtype=cd)
        h = gru_combine(mx, mh, h)
        logits = linear(h, params.dense_kernel, params.dense_bias, compute_dtype=cd)
        if temperature > 0.0:
            pred = sampling.sample(logits, generator, temperature=temperature,
                                   top_k=top_k, top_p=top_p)
        else:
            pred = torch.argmax(logits, dim=-1)
        prev = pred.to(torch.int64)
    return toks


# ---------------------------------------------------------------------------
# decode() dispatch thresholds: defaults + on-machine recalibration
# ---------------------------------------------------------------------------

# PLACEHOLDERS: these are the JAX package's TPU-measured crossover points
# (fused kernel iff B >= 2048 and T >= 256). They await re-measurement on the
# H100 (ROADMAP.md); a calibration file overrides them.
_DISPATCH_DEFAULTS = {"min_b": 2048, "min_t": 256, "source": "default"}
_dispatch_cache: Optional[dict] = None


def dispatch_calibration_path() -> str:
    return os.environ.get(
        "GXT_TORCH_DECODE_DISPATCH",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "ggml_experiments_tpu_torch", "decode_dispatch.json"),
    )


def dispatch_thresholds(reload: bool = False) -> dict:
    """The fused-vs-scan routing thresholds decode() uses: the defaults,
    overridden by a calibration file ({"min_b": .., "min_t": ..}) if present."""
    global _dispatch_cache
    if _dispatch_cache is not None and not reload:
        return _dispatch_cache
    thr = dict(_DISPATCH_DEFAULTS)
    path = dispatch_calibration_path()
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
            thr["min_b"] = int(data["min_b"])
            thr["min_t"] = int(data["min_t"])
            thr["source"] = path
        except (KeyError, ValueError, OSError):  # corrupt file: keep defaults
            thr["source"] = f"default (unreadable {path})"
    _dispatch_cache = thr
    return thr


def decode(params: GRUTextGenParams, prompt_ids, prompt_lengths, total_steps: int,
           **kw) -> torch.Tensor:
    """Decode with automatic path selection: greedy + block-quantized weights
    + large batch + long decode go to the persistent fused kernel
    (ops/fused_gru_decode); everything else to :func:`generate`. The fused
    path's bfloat16 default is applied to the scan path too."""
    from ggml_experiments_tpu_torch.ops.fused_gru_decode import (
        fused_gru_decode,
        is_fusable_params,
    )

    greedy = kw.get("temperature", 0.0) == 0.0
    thr = dispatch_thresholds()
    b = len(prompt_ids)
    if (greedy and is_fusable_params(params) and b >= thr["min_b"]
            and total_steps >= thr["min_t"]):
        return fused_gru_decode(params, prompt_ids, prompt_lengths, total_steps,
                                compute_dtype=kw.get("compute_dtype", torch.bfloat16))
    kw.setdefault("compute_dtype", torch.bfloat16)
    return generate(params, prompt_ids, prompt_lengths, total_steps, **kw)
