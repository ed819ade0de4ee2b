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
    gru_sequence_time_major,
    input_projection,
    recurrent_projection,
)
from ggml_experiments_tpu_torch.ops.linear import Weight, embedding_lookup, linear
from ggml_experiments_tpu_torch.parallel.mesh import DATA_AXIS, axis_slice
from ggml_experiments_tpu_torch.parallel.sharding import Placed, full, mesh_of


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


def init_params(config: GRUConfig, generator: torch.Generator,
                device=None) -> GRUTextGenParams:
    """Random float32 params with the Keras defaults' distributions: uniform
    +-0.05 embeddings, Glorot-uniform input and dense kernels, an orthogonal
    recurrent kernel, zero biases. Drawn from ``generator`` on its own device,
    then moved to ``device`` (default: the generator's)."""
    gdev = generator.device
    dev = torch.device(device) if device is not None else gdev
    v, e, u = config.vocab_size, config.embed_dim, config.units

    def uniform(shape, limit):
        x = torch.rand(shape, generator=generator, device=gdev, dtype=torch.float32)
        return ((2.0 * x - 1.0) * limit).to(dev)

    def glorot(shape):
        return uniform(shape, (6.0 / (shape[0] + shape[1])) ** 0.5)

    def orthogonal(rows, cols):
        # QR of a tall normal matrix, signs fixed by R's diagonal; transposed
        # when the result is wide
        tall = torch.randn((max(rows, cols), min(rows, cols)), generator=generator,
                           device=gdev, dtype=torch.float32)
        q, r = torch.linalg.qr(tall)
        q = q * torch.sign(torch.diagonal(r))
        return (q.t() if rows < cols else q).contiguous().to(dev)

    return GRUTextGenParams(
        embeddings=uniform((v, e), 0.05),
        cell=GRUCellParams(
            kernel=glorot((e, 3 * u)),
            recurrent_kernel=orthogonal(u, 3 * u),
            bias=torch.zeros((2, 3 * u), dtype=torch.float32, device=dev),
        ),
        dense_kernel=glorot((u, v)),
        dense_bias=torch.zeros((v,), dtype=torch.float32, device=dev),
    )


def init_state(params: GRUTextGenParams, batch: int) -> torch.Tensor:
    return torch.zeros((batch, params.units), dtype=torch.float32, device=params.device)


def gather_for_loop(params: GRUTextGenParams) -> GRUTextGenParams:
    """The params a decode or sequence loop reads: row-parallel weights and
    sharded biases of params placed on a mesh (``parallel.place``) gathered
    once a call, as XLA hoists a loop-invariant gather; column-parallel
    kernels stay sharded (each product all-gathers its outputs). Unplaced
    params come back as they are."""
    cell = params.cell
    leaves = (params.embeddings, cell.kernel, cell.recurrent_kernel, cell.bias,
              params.dense_kernel, params.dense_bias)
    if not any(isinstance(x, Placed) for x in leaves):
        return params

    def keep(w):
        return w if isinstance(w, Placed) and w.dim == 1 else full(w)

    out = GRUTextGenParams(
        embeddings=full(params.embeddings),
        cell=GRUCellParams(kernel=keep(cell.kernel),
                           recurrent_kernel=keep(cell.recurrent_kernel), bias=full(cell.bias)),
        dense_kernel=keep(params.dense_kernel), dense_bias=full(params.dense_bias))
    out.cache["mesh"] = mesh_of(params)
    return out


def _data_parallel(params: GRUTextGenParams, batch: int):
    """(the params a loop reads (:func:`gather_for_loop`), the mesh if the
    batch splits over its data axis else None, this rank's slice of the
    batch). A data axis wider than one rank gives each rank its slice, whose
    results :func:`_join` gathers."""
    mesh = mesh_of(params)
    loop = gather_for_loop(params)
    if mesh is None or mesh.size(DATA_AXIS) == 1:
        return loop, None, slice(0, batch)
    return loop, mesh, axis_slice(mesh, DATA_AXIS, batch)


def _join(mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The data-parallel ranks' results concatenated along the batch dim."""
    return t if mesh is None else mesh.all_gather(t, DATA_AXIS, dim)


def step(params: GRUTextGenParams, token_ids: torch.Tensor, h: torch.Tensor, *,
         compute_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. token_ids: (B,) int, h: (B, U) -> (logits (B, V), h')."""
    params, mesh, sl = _data_parallel(params, h.shape[0])
    x = embedding_lookup(params.embeddings, torch.as_tensor(token_ids)[sl])
    h = gru_cell(params.cell, x, h[sl], compute_dtype=compute_dtype)
    logits = linear(h, params.dense_kernel, params.dense_bias, compute_dtype=compute_dtype)
    return _join(mesh, logits), _join(mesh, h)


def forward_sequence(params: GRUTextGenParams, token_ids, h0: Optional[torch.Tensor] = None,
                     *, compute_dtype=torch.float32, remat: bool = False,
                     time_major: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced full-sequence forward. token_ids: (B, T) int ->
    (logits (B, T, V), final state (B, U)). With ``time_major=True`` the ids
    are (T, B) and the logits come back (T, B, V): the layout of the time
    loop and the training path (``training/gru_trainer.loss_fn``), where only
    the small int ids are ever transposed. The input projection and the vocab
    head are whole-sequence products; only the recurrent projection runs
    inside the time loop, which at bfloat16 on a GPU is the fused kernel pair
    (``ops/fused_gru_train``). The time-major path takes the embedding
    through a one-hot product, so that its gradient is reproducible.
    ``remat`` checkpoints the plain loop's cell."""
    ids = torch.as_tensor(token_ids, device=params.device)
    bdim = 1 if time_major else 0
    params, mesh, sl = _data_parallel(params, ids.shape[bdim])
    ids = ids[:, sl] if time_major else ids[sl]
    h = init_state(params, ids.shape[bdim]) if h0 is None else h0[sl]
    xs = embedding_lookup(params.embeddings, ids, one_hot_grad=time_major)   # (..., E)
    seq = gru_sequence_time_major if time_major else gru_sequence
    ys, h_last = seq(params.cell, xs, h, compute_dtype=compute_dtype, remat=remat)
    logits = linear(ys, params.dense_kernel, params.dense_bias, compute_dtype=compute_dtype)
    return _join(mesh, logits, bdim), _join(mesh, h_last)


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
    params, mesh, sl = _data_parallel(params, prompt_ids.shape[0])
    prompt_ids, prompt_lengths = prompt_ids[sl], prompt_lengths[sl]
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
    return _join(mesh, toks)


# ---------------------------------------------------------------------------
# decode() dispatch thresholds: defaults + on-machine recalibration
# ---------------------------------------------------------------------------

# decode() takes the persistent kernel from this batch and this many steps on
# (greedy, block-quantized weights), and at f32 up to DECODE_FUSED_MAX_B_F32:
# the whole call, kernel against scan, over B = 64..8192 x T = 64..512 on an
# NVIDIA H100 80GB HBM3 at 700.00 W (tools/torch_recalibrate_decode.py;
# PERF.md, "Dispatch gates"). At bf16 the kernel won every cell
# (1.7-13x), so the gate is the grid's smallest; at f32 it won up to B=256
# (1.45-2.0x) and lost from B=512 (0.70-0.96x), where its CUDA-core products
# fall behind the scan's 3xTF32 qmatmul. A calibration file (bf16) overrides
# the lower bounds.
DECODE_FUSED_MIN_B = 64
DECODE_FUSED_MIN_T = 64
DECODE_FUSED_MAX_B_F32 = 256
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
    thr = {"min_b": DECODE_FUSED_MIN_B, "min_t": DECODE_FUSED_MIN_T, "source": "default"}
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


def decode_route(params: GRUTextGenParams, batch: int, total_steps: int,
                 temperature: float = 0.0, compute_dtype=torch.bfloat16) -> str:
    """``'fused'`` where :func:`decode` takes the persistent kernel (greedy,
    block-quantized weights, (B, T) at or past :func:`dispatch_thresholds`,
    and at f32 B at most ``DECODE_FUSED_MAX_B_F32``), else ``'scan'``."""
    from ggml_experiments_tpu_torch.ops.fused_gru_decode import is_fusable_params

    thr = dispatch_thresholds()
    fused = (temperature == 0.0 and is_fusable_params(params) and batch >= thr["min_b"]
             and total_steps >= thr["min_t"]
             and (resolve_dtype(compute_dtype) == torch.bfloat16
                  or batch <= DECODE_FUSED_MAX_B_F32))
    return "fused" if fused else "scan"


def decode(params: GRUTextGenParams, prompt_ids, prompt_lengths, total_steps: int,
           **kw) -> torch.Tensor:
    """Decode with automatic path selection: greedy + block-quantized weights
    + large batch + long decode go to the persistent fused kernel
    (ops/fused_gru_decode); everything else to :func:`generate`. The fused
    path's bfloat16 default is applied to the scan path too."""
    from ggml_experiments_tpu_torch.ops.fused_gru_decode import fused_gru_decode

    kw.setdefault("compute_dtype", torch.bfloat16)
    if decode_route(params, len(prompt_ids), total_steps, kw.get("temperature", 0.0),
                    kw["compute_dtype"]) == "fused":
        return fused_gru_decode(params, prompt_ids, prompt_lengths, total_steps,
                                compute_dtype=kw["compute_dtype"])
    return generate(params, prompt_ids, prompt_lengths, total_steps, **kw)
