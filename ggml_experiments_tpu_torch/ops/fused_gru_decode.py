"""Persistent fused GRU decode: the whole token loop in one launch.

Two entry points, each with its plain PyTorch version in this module:

* :func:`fused_gru_decode` -- greedy offline decode (``decode()``'s fused
  route). CUDA: ``csrc/gru_persistent.cu`` ``gxt_fused_gru_decode``.
* :func:`fused_slot_tick` -- one serving tick of the continuous-batching
  engine: every slot advances ``inner_steps`` tokens from its cursors, with
  optional Gumbel-argmax temperature sampling and top-k / top-p masks.
  CUDA: the same kernel through ``gxt_fused_slot_tick``.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernel or raise. The arithmetic, shared by kernel and plain
version, is the JAX package's ``_gru_step``: the dequantized planes and the
vocab-wide input-projection table ``emb.W`` are rounded to the compute dtype,
h is rounded to it before each product, every product and sum is f32, the
state stays f32, and the greedy token is the first index of the maximum.
Sampling draws its noise from the JAX package's interpret-mode hash lattice
(its ``_hash_bits_u32``), keyed as the JAX tick keys it: on (seed, step, vocab
row, column within a block, the block's first global slot), where a block is
a tile of the JAX tick's grid (past ``FUSED_TICK_MAX_UNTILED`` slots) or a
shard of a slot-sharded tick (:func:`tick_shard`, :func:`block_keyed_bits`).
The kernel and the plain version draw identical noise, and both draw the JAX
tick's, untiled, tiled or sharded.

The kernel cuts the work one of two ways (``csrc/gru_persistent.cu``):
slot-owned (a block owns a tile of slots for the whole loop and streams the
recurrent plane through shared memory; bf16 only, no grid sync) or
unit-owned (a block owns 8 hidden units, keeps their plane columns in shared
memory and streams h; two grid syncs a step). :func:`decode_plan` chooses
the plan (:class:`DecodePlan`: the decomposition and, slot-owned, the ring
depth that fits) from B; ``gru_loop_cuda(..., config=)`` overrides it.

The weights reach the kernel by one of three routes, chosen as the JAX
package chooses (``_check_quantized``): all three matrices q8_0, or all three
q4_0, stay compressed and are decoded in the kernel's setup; any other
block format, and any mix of formats, is dequantized once per params object
on the device and arrives as dense f32 planes, which the setup copies and
rounds to the compute dtype. The step loop is the same for all three.

Every vocabulary and any U, as the JAX kernels take them: U is padded to Ku,
a multiple of 32 (:class:`FusedWeights`), and the kernel's plans hold any V
(past what a block's shared memory holds, the logits go through a device
scratch). Only U past every plan's resources is refused (:func:`check_plan`).
The routes ask :func:`kernel_refusal` (:func:`loop_refusal` from the shape
alone) before they send the kernel work, and take the scan path where it
refuses; the wrapper still raises on such a shape.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from ggml_experiments_tpu_torch.device import resolve_dtype
from ggml_experiments_tpu_torch.quant.qtensor import (
    QTYPES,
    QTensor,
    dequantize,
    dequantize_padded,
)

NEG = -1e30
M32 = 0xFFFFFFFF

# launches of each CUDA entry point; only the kernel wrappers add to these
LAUNCHES = {"fused_gru_decode": 0, "fused_slot_tick": 0}
# the plan of each entry point's last launch
LAST_PLAN = {}


# weight routes, by their number in the kernel's Args
WEIGHT_MODES = {"q8_0": 0, "q4_0": 1, "dense": 2}


def is_fusable_params(params) -> bool:
    """True iff the fused kernels can run these params: the cell, recurrent
    and dense kernels are all QTensors of a supported block format."""
    ws = (params.cell.kernel, params.cell.recurrent_kernel, params.dense_kernel)
    return all(isinstance(w, QTensor) and w.qtype in QTYPES for w in ws)


def _check_quantized(params) -> str:
    """The weight route for these params: 'q8_0' or 'q4_0' when all three
    matrices share that format (decoded in the kernel), else 'dense'."""
    if not is_fusable_params(params):
        raise ValueError("the fused decode kernels require block-quantized GRU "
                         "params (q8_0/q4_0/q4_1/q5_0/q5_1/q4_k; load with "
                         "qtype='q8_0' etc.)")
    qts = {params.cell.kernel.qtype, params.cell.recurrent_kernel.qtype,
           params.dense_kernel.qtype}
    if len(qts) == 1 and qts <= {"q8_0", "q4_0"}:
        return next(iter(qts))
    return "dense"


@dataclasses.dataclass
class FusedWeights:
    """Kernel-layout operands, contiguous on the params' device. U is padded
    to Ku = U rounded up to 32 (the TPU kernel's padding): the padded units
    have zero plane columns, zero K rows and zero biases, so they stay
    exactly 0 (z = r = 1/2, n = tanh 0) and add nothing to any product.
    With Ke = E rounded up to 32 and G = 3 Ku, by ``mode``:

    * ``q8_0``: codes int8 (Ke, G) / (Ku, G) / (Ku, V), scales f32 (K/32, .)
    * ``q4_0``: codes uint8 nibble-packed (Ke/2, G) / (Ku/2, G) / (Ku/2, V),
      scales as above
    * ``dense``: ``wc``/``uc``/``dc`` are the dequantized f32 planes (E, G) /
      (Ku, G) / (Ku, V); there are no scales
    """

    emb: torch.Tensor    # (V, E) f32
    wc: torch.Tensor     # input kernel
    ws: Optional[torch.Tensor]
    uc: torch.Tensor     # recurrent kernel
    us: Optional[torch.Tensor]
    bias: torch.Tensor   # (2, G) f32: input, recurrent
    dc: torch.Tensor     # dense head
    ds: Optional[torch.Tensor]
    dbias: torch.Tensor  # (V,) f32
    v: int
    e: int
    u: int               # the model's units: the width of h
    mode: str = "q8_0"
    ku: int = 0          # U padded to 32: the planes' units (0: U)

    def __post_init__(self):
        self.ku = self.ku or _ku(self.u)


def _ku(u: int) -> int:
    """Units padded to whole 32-row K blocks, as the kernel takes them."""
    return -(-u // 32) * 32


def _gate_cols(t: torch.Tensor, u: int, ku: int, fill=0) -> torch.Tensor:
    """(..., 3U) gate columns [z | r | n] spread to (..., 3Ku), each gate's
    block padded with ``fill``: column c U + i goes to c Ku + i."""
    if ku == u:
        return t.contiguous()
    out = torch.full((*t.shape[:-1], 3 * ku), fill, dtype=t.dtype, device=t.device)
    for c in range(3):
        out[..., c * ku:c * ku + u] = t[..., c * u:(c + 1) * u]
    return out


def _k_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """t with its rows padded with zeros to ``rows``."""
    return torch.nn.functional.pad(t, (0, 0, 0, rows - t.shape[0])) if t.shape[0] < rows else t


def _prep_weights(params) -> FusedWeights:
    """Kernel-layout weights, built once per params object (for the dense
    route that is one dequantization per params object, not one per call)."""
    hit = params.cache.get("fused_weights")
    if hit is not None:
        return hit
    mode = _check_quantized(params)
    cell = params.cell
    v, e = params.embeddings.shape
    u = cell.recurrent_kernel.shape[0]
    ku = _ku(u)
    g = 3 * u
    dev = params.device
    # a q4_0 byte of two zero codes (nibbles 8); padded scales are 0 too
    zero_code = 0x88 if mode == "q4_0" else 0

    def cols(qt: QTensor, n: int, gates: bool, krows: int):
        # the block formats' planes come K-padded to 32 (Ke, Ku) already
        if mode == "dense":
            w = dequantize(qt).float()
            return _k_rows(_gate_cols(w, u, ku) if gates else w, krows).contiguous(), None
        codes, scales = qt.codes[:, :n], qt.scales[:, :n]
        if gates:
            codes, scales = _gate_cols(codes, u, ku, zero_code), _gate_cols(scales, u, ku)
        return codes.contiguous(), scales.contiguous()

    wc, ws = cols(cell.kernel, g, True, e)
    uc, us = cols(cell.recurrent_kernel, g, True, ku)
    dc, ds = cols(params.dense_kernel, v, False, ku)
    bias = torch.zeros((2, 3 * ku), dtype=torch.float32, device=dev)
    if cell.bias is not None:
        bias.copy_(_gate_cols(cell.bias.float(), u, ku))
    dbias = torch.zeros((v,), dtype=torch.float32, device=dev)
    if params.dense_bias is not None:
        dbias.copy_(params.dense_bias)
    out = FusedWeights(params.embeddings.float().contiguous(), wc, ws, uc, us, bias,
                       dc, ds, dbias, v, e, u, mode, ku)
    params.cache["fused_weights"] = out
    return out


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _rnd(x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    return x.to(cd).float()


def _planes(w: FusedWeights, cd: torch.dtype):
    """Decoded planes rounded to ``cd`` (held as f32) and the input
    projection table round(round(emb) . round(W)): what the kernel keeps,
    by the same three routes."""
    if w.mode not in WEIGHT_MODES:
        raise ValueError(f"unknown weight mode {w.mode!r}")

    def plane(codes, scales, rows):
        if w.mode == "dense":
            return _rnd(codes[:rows], cd)
        qt = QTensor(codes, scales, (scales.shape[0] * 32, codes.shape[1]), w.mode)
        return _rnd(dequantize_padded(qt)[:rows], cd)

    wq = plane(w.wc, w.ws, w.e)
    uq = plane(w.uc, w.us, w.ku)
    dq = plane(w.dc, w.ds, w.ku)
    proj = _rnd(torch.matmul(_rnd(w.emb, cd), wq), cd)
    return proj, uq, dq


def _mul32(x, m: int):
    """(x * m) mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & M32


def block_keyed_bits(seed: int, j: int, rows: int, cols: int, slot_base: int = 0,
                     key_tile: int = 0, device=None) -> torch.Tensor:
    """The JAX package's hash lattice over a launch of ``cols`` slots whose
    column 0 is global slot ``slot_base``, cut into blocks of ``key_tile``
    columns (0: one block), as (cols, rows) int64 holding uint32 values:
    entry [b, r] is the bits of vocab row r for column b, keyed on b - tile0
    within its block and on the block's first global slot slot_base + tile0,
    tile0 = b // key_tile * key_tile, as the JAX tick keys each tile of its
    grid and each shard of a slot-partitioned tick (one block from slot s is
    the JAX ``_hash_bits_u32(..., slot0=s)``)."""
    col = torch.arange(cols, dtype=torch.int64, device=device)[:, None]
    tile0 = col // key_tile * key_tile if key_tile else torch.zeros_like(col)
    r = torch.arange(rows, dtype=torch.int64, device=device)[None, :]
    base = (_mul32(seed & M32, 0x9E3779B9) + _mul32(j & M32, 0x85EBCA6B)) & M32
    x = (base + _mul32(r, 0xC2B2AE35) + _mul32(col - tile0, 0x27D4EB2F)) & M32
    x = x ^ (x >> 13)
    x = _mul32(x, 0xD168AAAD)
    x = (x + _mul32((slot_base + tile0) & M32, 0x165667B1)) & M32
    for mult in (0x2C1B3C6D, 0x297A2D39):
        x = x ^ (x >> 15)
        x = _mul32(x, mult)
    return x ^ (x >> 16)


def _filter_topk(s: torch.Tensor, k: int):
    """(B, V) top-k mask by k rounds of extract-max: threshold = k-th largest
    counting duplicates, kept iff >= it (the TPU tick's `_filter_topk_vb`).
    Returns (masked scores, (B,) gap between the threshold and the best
    dropped score)."""
    b = s.shape[0]
    thr = torch.full((b,), NEG, dtype=s.dtype, device=s.device)
    cnt = torch.zeros((b,), dtype=torch.int64, device=s.device)
    cur = s.clone()
    for _ in range(k):
        m = cur.max(dim=-1).values
        thr = torch.where(cnt < k, m, thr)
        tied = cur == m[:, None]
        cnt = cnt + tied.sum(dim=-1)
        cur = cur.masked_fill(tied, NEG)
    keep = s >= thr[:, None]
    dropped = s.masked_fill(keep, NEG).max(dim=-1).values
    return s.masked_fill(~keep, NEG), thr - dropped


def _filter_topp(s: torch.Tensor, p: float):
    """(B, V) nucleus mask by descending extraction; exact ties at the
    boundary are kept as a group (the TPU tick's `_filter_topp_vb`).
    Returns (masked scores, (B,) smallest relative distance of the running
    mass from the target over the extraction: the score change, in log
    units, that would move the boundary). The extraction stops once every
    row's mass has reached the target (or it has no live score left): no
    later group moves the threshold, and the margin only grows."""
    b, v = s.shape
    mx = s.max(dim=-1, keepdim=True).values
    live = s > NEG * 0.5
    e = torch.where(live, torch.exp(s - mx), torch.zeros_like(s))
    target = p * e.sum(dim=-1)
    thr = torch.full((b,), NEG, dtype=s.dtype, device=s.device)
    cum = torch.zeros((b,), dtype=s.dtype, device=s.device)
    near = torch.full((b,), float("inf"), dtype=s.dtype, device=s.device)
    cur = s.clone()
    for _ in range(v):
        m = cur.max(dim=-1).values
        near = torch.where(m > NEG * 0.5, torch.minimum(near, (cum - target).abs() / target),
                           near)
        open_ = (cum < target) & (m > NEG * 0.5)
        if not bool(open_.any()):
            break
        tied = cur == m[:, None]
        grp = torch.where(tied, e, torch.zeros_like(e)).sum(dim=-1)
        thr = torch.where(open_, m, thr)
        cum = cum + grp
        cur = cur.masked_fill(tied, NEG)
    return torch.where(s >= thr[:, None], s, torch.full_like(s, NEG)), near


def _top2_gap(scores: torch.Tensor) -> torch.Tensor:
    top2 = torch.topk(scores, min(2, scores.shape[-1]), dim=-1).values
    return top2[:, 0] - top2[:, -1]


def _select_reference(logits, temp, seed: int, j: int, top_k: int, top_p: float,
                      slot_base: int = 0, key_tile: int = 0):
    """Greedy first-index argmax, or Gumbel-argmax for slots with temp > 0.
    Returns (token, (B,) margin): how far the scores are from choosing
    otherwise (the best-vs-second gap, and for sampled slots also the top-k
    and top-p boundary distances)."""
    greedy = torch.argmax(logits, dim=-1)
    if temp is None:
        return greedy, _top2_gap(logits)
    b, v = logits.shape
    inv_t = 1.0 / torch.clamp_min(temp, 1e-6)
    s = logits * inv_t[:, None]
    margin = torch.full((b,), float("inf"), device=logits.device)
    if top_k:
        s, gap = _filter_topk(s, min(top_k, v))
        margin = torch.minimum(margin, gap)
    if top_p:
        s, gap = _filter_topp(s, top_p)
        margin = torch.minimum(margin, gap)
    bits = block_keyed_bits(seed, j, v, b, slot_base, key_tile, device=logits.device)
    u01 = ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))
    scored = s + -torch.log(-torch.log(u01))
    sampled = temp > 0.0
    pred = torch.where(sampled, torch.argmax(scored, dim=-1), greedy)
    margin = torch.where(sampled, torch.minimum(margin, _top2_gap(scored)), _top2_gap(logits))
    return pred, margin


def gru_loop_reference(w: FusedWeights, prompt, plen, total, prev, pos, h, steps: int,
                       compute_dtype=torch.bfloat16, temp=None, seed: int = 0,
                       top_k: int = 0, top_p: float = 0.0, margins: bool = False,
                       slot_base: int = 0, key_tile: int = 0):
    """Plain version of the kernel loop. Per step a slot feeds
    ``prompt[b, pos]`` while ``pos < plen`` (token 0 where that lies past the
    prompt buffer) else ``prev``, updates h while ``pos < total`` (held otherwise), and takes the
    next token from the logits. Returns (toks (B, steps) int32, h, prev, pos)
    and, with ``margins=True``, the (B, steps) margin of each step's choice
    (see ``_select_reference``): where it is tiny, two implementations that
    sum in other orders may rightly choose apart. Sampled slots draw the
    noise of :func:`block_keyed_bits` for ``slot_base`` / ``key_tile``. h
    runs at the planes' Ku units, its padded units exactly 0, and comes back
    at U."""
    cd = resolve_dtype(compute_dtype)
    proj, uq, dq = _planes(w, cd)
    b0, b1 = w.bias[0], w.bias[1]
    u = w.ku
    prompt = prompt.long()
    plen, total = plen.long(), total.long()
    prev, pos = prev.long().clone(), pos.long().clone()
    h = torch.nn.functional.pad(h.float(), (0, w.ku - w.u))
    p = prompt.shape[1]
    toks = torch.empty((prompt.shape[0], steps), dtype=torch.int32, device=h.device)
    gaps = torch.empty((prompt.shape[0], steps), dtype=torch.float32, device=h.device)
    for j in range(steps):
        pcur = prompt.gather(1, pos.clamp(max=max(p - 1, 0))[:, None])[:, 0]
        # a cursor inside plen but past the prompt buffer feeds token 0
        pcur = torch.where(pos < p, pcur, torch.zeros_like(pcur))
        tok = torch.where(pos < plen, pcur, prev)
        toks[:, j] = tok
        active = pos < total
        mx = proj[tok] + b0
        mh = torch.matmul(_rnd(h, cd), uq) + b1
        z = torch.sigmoid(mx[:, :u] + mh[:, :u])
        r = torch.sigmoid(mx[:, u:2 * u] + mh[:, u:2 * u])
        hh = torch.tanh(mx[:, 2 * u:] + r * mh[:, 2 * u:])
        h = torch.where(active[:, None], z * h + (1.0 - z) * hh, h)
        logits = torch.matmul(_rnd(h, cd), dq) + w.dbias
        pred, margin = _select_reference(logits, temp, seed, j, top_k, top_p, slot_base,
                                         key_tile)
        if margins:
            gaps[:, j] = margin
        prev = torch.where(active, pred, prev)
        pos = pos + active.long()
    out = (toks, h[:, :w.u] if w.ku != w.u else h, prev.int(), pos.int())
    return out + (gaps,) if margins else out


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232448             # dynamic shared memory a block may opt in to on an H100
SMEM_PER_SM = 233472            # shared memory of an H100 multiprocessor
SMEM_RESERVED = 1024            # of it, what the hardware keeps for each resident block
SLOT_SLOTS = 64                 # slots a slot-owned block owns: one wgmma M tile
SLOT_STAGES = (3, 4)            # ring depths of the slot-owned loop: the deepest that fits
UNIT_STAGES = 3                 # the bf16 unit-owned h ring, which fits two blocks an SM
UNIT_SPLIT = 2                  # bf16 unit-owned blocks a unit group's slot tiles are dealt to
# bf16 batches from here on run slot-owned: on an H100 a slot-owned step
# takes ~260-280 us at any B (64 slots a block, every block streams the
# whole plane), a unit-owned one ~0.08 us a slot (every block reads its
# half of h: 249 us at B=3072, 332 at 4096); they cross near B=3300
# (tools/torch_kernel_bench.py --sweep, PERF.md)
SLOT_MIN_BATCH = 3300
_RING_K, _PASS_ROWS, _UNIT_SLOTS, _HEAD_NT, _F32_CHUNK = 64, 192, 128, 9, 32
# vocabularies up to here keep a unit-owned block's slice of the input
# projection table (V x 24 f32) and its logits (16 x V f32) in shared memory;
# past it both live in device memory, so that two bf16 blocks still share a
# multiprocessor at U = 1024 (csrc kSmemV)
UNIT_SMEM_VOCAB = 128
_F32_VCHUNK = 256               # vocab columns of an f32 head chunk past 256 (csrc kVC)


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How the persistent kernel cuts one launch: ``decomp`` "slot" (a block
    owns SLOT_SLOTS slots for the whole loop and streams the weights through
    a ring of ``stages`` buffers, 3 or 4) or "unit" (8 hidden units a unit
    group, owned by UNIT_SPLIT blocks at bf16 and one at f32; every block
    takes B / grid slots of the logits; ``stages`` 0, the bf16 h ring being
    UNIT_STAGES deep)."""

    decomp: str
    stages: int = 0


def _kp(u: int) -> int:
    return -(-u // _RING_K) * _RING_K


def _vp(v: int) -> int:
    return -(-v // 8) * 8


def slot_logits_in_ring(v: int) -> bool:
    """Whether a slot-owned block's logits (64 x Vp f32) fit the ring buffer
    its last head tile leaves free; else they go through the device scratch
    of B x Vp f32 (:func:`logits_scratch_rows`)."""
    return SLOT_SLOTS * _vp(v) * 4 <= _PASS_ROWS * _RING_K * 2


def logits_scratch_rows(plan: DecodePlan, b: int, v: int) -> int:
    """Rows of the f32 (rows, Vp) device scratch the loop's logits go through
    (0: none, they stay in shared memory): B where a slot-owned block's
    logits outgrow its ring buffer or a unit-owned vocabulary is past
    UNIT_SMEM_VOCAB."""
    wide = not slot_logits_in_ring(v) if plan.decomp == "slot" else v > UNIT_SMEM_VOCAB
    return b if wide else 0


def f32_head_chunk(v: int) -> int:
    """Vocab columns of an f32 unit-owned head chunk: the head is laid out
    as ceil(V / chunk) chunks of (Ku, chunk) f32, one chunk (V itself) up to
    V = 256."""
    return v if v <= _F32_VCHUNK else _F32_VCHUNK


def plan_smem_bytes(plan: DecodePlan, u: int, v: int, bf16: bool) -> int:
    """Dynamic shared memory of the loop kernel under ``plan`` at U units
    (padded to 32 as the kernel takes them) and V (``plan_smem`` of
    csrc/gru_persistent.cu, which the wrapper checks against this)."""
    def a16(x):
        return -(-x // 16) * 16

    ku = _ku(u)
    if plan.decomp == "slot":
        s, stage = SLOT_SLOTS, _PASS_ROWS * _RING_K * 2
        return 1024 + s * _kp(ku) * 2 + plan.stages * stage + 2 * s * 4 + 2 * plan.stages * 8
    small = v <= UNIT_SMEM_VOCAB
    lg = 16 * _vp(v) if small else 0
    if bf16:
        work = max(UNIT_STAGES * _UNIT_SLOTS * _RING_K * 2, (8 * 16 * 8 * _HEAD_NT + lg) * 4)
        w = 24 * _kp(ku) * 2
    else:
        work = max(32 * 260 * 4, (2 * 16 * _F32_CHUNK + 2 * _F32_CHUNK * f32_head_chunk(v)
                                  + lg) * 4)
        w = ku * 24 * 4
    tok = a16(a16(a16(w) + (v * 24 * 4 if small else 0)) + work)
    return tok + (0 if bf16 else 2 * 256 * 4)


def plan_grid(plan: DecodePlan, b: int, u: int, bf16: bool) -> int:
    """Blocks of the loop kernel's launch under ``plan``."""
    if plan.decomp == "slot":
        return -(-b // SLOT_SLOTS)
    return (UNIT_SPLIT if bf16 else 1) * _ku(u) // 8


def plan_refusal(plan: DecodePlan, u: int, v: int, bf16: bool, sms: int = 132,
                 smem_limit: int = SMEM_LIMIT, smem_per_sm: int = SMEM_PER_SM) -> str:
    """Why the kernel cannot launch ``plan`` at (U, V) on a card of ``sms``
    multiprocessors ('' where it can): a plan it has no code for, more unit
    groups than multiprocessors (a cooperative grid is resident at once),
    a block's shared memory past the device's, or two bf16 unit-owned
    blocks that do not fit one multiprocessor together."""
    ku = _ku(u)
    if plan.decomp == "slot":
        ok = bf16 and plan.stages in SLOT_STAGES
    elif plan.decomp == "unit":
        ok = plan.stages == 0 and ku // 8 <= sms
    else:
        ok = False
    if not ok:
        return (f"the persistent kernel has no plan {plan} at U={u}, V={v}, "
                f"{'bf16' if bf16 else 'f32'} on {sms} multiprocessors (slot-owned: bf16, "
                f"stages {SLOT_STAGES}; unit-owned: stages 0, U / 8 <= multiprocessors)")
    need = plan_smem_bytes(plan, u, v, bf16)
    if need > smem_limit:
        return (f"plan {plan} needs {need} bytes of shared memory a block at U={u}, V={v}; "
                f"the device allows {smem_limit}")
    if plan.decomp == "unit" and bf16 and UNIT_SPLIT * (need + SMEM_RESERVED) > smem_per_sm:
        return (f"plan {plan} needs {need} bytes of shared memory a block at U={u}, V={v}; "
                f"{UNIT_SPLIT} such blocks do not fit a multiprocessor's {smem_per_sm}")
    return ""


def check_plan(plan: DecodePlan, u: int, v: int, bf16: bool, sms: int = 132,
               smem_limit: int = SMEM_LIMIT, smem_per_sm: int = SMEM_PER_SM) -> None:
    """Raise ValueError unless the kernel can launch ``plan`` at (U, V)."""
    why = plan_refusal(plan, u, v, bf16, sms, smem_limit, smem_per_sm)
    if why:
        raise ValueError(why)


def decode_plan(b: int, u: int, v: int, compute_dtype=torch.bfloat16, sms: int = 132,
                smem_limit: int = SMEM_LIMIT, smem_per_sm: int = SMEM_PER_SM) -> DecodePlan:
    """The plan for B slots at (U, V) on a card with ``sms`` multiprocessors.
    bf16 batches of at least SLOT_MIN_BATCH run slot-owned (128 blocks at
    B=8192) with the deepest ring that fits shared memory; smaller bf16
    batches and f32 (held token-exact on CUDA-core FMAs) run unit-owned.
    Where the preferred cut does not fit, the first that does; where none
    does, the preferred one (which :func:`check_plan` refuses)."""
    bf16 = resolve_dtype(compute_dtype) == torch.bfloat16
    slot = [DecodePlan("slot", st) for st in sorted(SLOT_STAGES, reverse=True)] if bf16 else []
    order = (slot + [DecodePlan("unit")] if bf16 and b >= SLOT_MIN_BATCH
             else [DecodePlan("unit")] + slot)
    for plan in order:
        if not plan_refusal(plan, u, v, bf16, sms, smem_limit, smem_per_sm):
            return plan
    return order[0]


def loop_refusal(b: int, u: int, v: int, compute_dtype=torch.bfloat16, sms: int = 132,
                 smem_limit: int = SMEM_LIMIT, smem_per_sm: int = SMEM_PER_SM) -> str:
    """Why the persistent kernel takes no launch of B slots at (U, V) on this
    card ('' where :func:`decode_plan` gives a plan it launches), from the
    shape alone: what a route asks before it sends the kernel work."""
    bf16 = resolve_dtype(compute_dtype) == torch.bfloat16
    return plan_refusal(decode_plan(b, u, v, compute_dtype, sms, smem_limit, smem_per_sm),
                        u, v, bf16, sms, smem_limit, smem_per_sm)


def loop_takes(b: int, u: int, v: int, compute_dtype=torch.bfloat16, sms: int = 132,
               smem_limit: int = SMEM_LIMIT, smem_per_sm: int = SMEM_PER_SM) -> bool:
    """Whether the persistent kernel launches B slots at (U, V) (:func:`loop_refusal`)."""
    return not loop_refusal(b, u, v, compute_dtype, sms, smem_limit, smem_per_sm)


def device_limits(device) -> tuple:
    """(multiprocessors, shared memory a block may opt in to, shared memory
    of a multiprocessor) of a CUDA device."""
    props = torch.cuda.get_device_properties(torch.device(device))
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT),
            getattr(props, "shared_memory_per_multiprocessor", SMEM_PER_SM))


def kernel_refusal(params, b: int, compute_dtype, device=None) -> str:
    """Why the persistent kernel cannot run these params at B slots on
    ``device`` (default the params'): '' on the CPU, whose plain version
    takes any shape, and on a CUDA device whose plans take the model's
    (U, V) (:func:`loop_refusal`)."""
    dev = torch.device(device) if device is not None else params.device
    if dev.type != "cuda":
        return ""
    v = params.embeddings.shape[0]
    u = params.cell.recurrent_kernel.shape[0]
    return loop_refusal(b, u, v, compute_dtype, *device_limits(dev))


def plan_slot_tiles(plan: DecodePlan, b: int, u: int, bf16: bool):
    """The slot ranges [(start, stop), ...] the blocks own: a slot-owned
    block's slots for the whole loop, or a unit-owned block's slots of the
    logits and token choice (B / grid slots each)."""
    per = SLOT_SLOTS if plan.decomp == "slot" else -(-b // plan_grid(plan, b, u, bf16))
    return [(s, min(s + per, b)) for s in range(0, b, per)]


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

class _Args(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "emb", "wc", "ws", "uc", "us", "bias", "dc", "ds", "dbias", "prompt",
            "plen", "total", "prev", "pos", "h0", "h1", "toks", "temp", "hb0", "hb1",
            "proj", "wl", "dl", "lg")]
        + [(n, ctypes.c_int) for n in (
            "V", "E", "U", "P", "B", "steps", "toks_u8", "bf16", "sampling", "top_k",
            "wmode", "decomp", "stages", "slot_base", "key_tile")]
        + [("top_p", ctypes.c_float), ("seed", ctypes.c_uint32)]
    )


def _i32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).to(torch.int32).contiguous()


def _check_layout(entry: str, w: FusedWeights) -> None:
    """Raise unless the operands have the dtype, shape and contiguity that
    the kernel's weight route reads."""
    dev = w.emb.device
    if w.mode not in WEIGHT_MODES:
        raise ValueError(f"{entry}: unknown weight mode {w.mode!r}")
    g = 3 * w.ku
    ke = -(-w.e // 32) * 32
    kdiv = 2 if w.mode == "q4_0" else 1
    cdt = {"q8_0": torch.int8, "q4_0": torch.uint8, "dense": torch.float32}[w.mode]
    if w.ku % 32 or not 0 < w.u <= w.ku < w.u + 32:
        raise ValueError(f"{entry}: units U={w.u} must be padded to whole 32-row blocks, "
                         f"got Ku={w.ku}")
    for name, t, rows, ncols in (("wc", w.wc, w.e if w.mode == "dense" else ke // kdiv, g),
                                 ("uc", w.uc, w.ku // kdiv, g), ("dc", w.dc, w.ku // kdiv, w.v)):
        if (t.dtype != cdt or tuple(t.shape) != (rows, ncols) or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{entry}: {w.mode} route wants a contiguous {cdt} {name} of "
                             f"({rows}, {ncols}), got {t.dtype}{tuple(t.shape)}")
    if w.mode != "dense":
        for name, t, rows, ncols in (("ws", w.ws, ke // 32, g), ("us", w.us, w.ku // 32, g),
                                     ("ds", w.ds, w.ku // 32, w.v)):
            if (t is None or t.dtype != torch.float32 or tuple(t.shape) != (rows, ncols)
                    or not t.is_contiguous() or t.device != dev):
                raise ValueError(f"{entry}: {w.mode} route wants contiguous f32 {name} of "
                                 f"({rows}, {ncols})")


_SCRATCH = {}   # device -> the f32 logits scratch, grown as launches ask for more


def _logits_scratch(dev, n: int) -> torch.Tensor:
    """At least n f32 of device memory for the loop's logits, kept per device
    and reused across calls (launches on one stream run in order)."""
    buf = _SCRATCH.get(dev)
    if buf is None or buf.numel() < n:
        buf = _SCRATCH[dev] = torch.empty((n,), dtype=torch.float32, device=dev)
    return buf


def gru_loop_cuda(entry: str, w: FusedWeights, prompt, plen, total, prev, pos, h,
                  steps: int, compute_dtype=torch.bfloat16, temp=None, seed: int = 0,
                  top_k: int = 0, top_p: float = 0.0, toks_u8: bool = False,
                  config: Optional[DecodePlan] = None, slot_base: int = 0,
                  key_tile: int = 0):
    """Launch the persistent kernel through ``entry`` (``fused_gru_decode``
    or ``fused_slot_tick``) under ``config`` (default :func:`decode_plan`;
    a DecodePlan or its fields as a tuple). Returns (toks, h, prev, pos) as
    the plain version does; the inputs are not modified. ``slot_base`` /
    ``key_tile`` key the sampling noise as :func:`block_keyed_bits` does.
    h goes in and comes out at U columns; the kernel runs Ku."""
    from ggml_experiments_tpu_torch import _build

    cd = resolve_dtype(compute_dtype)
    dev = w.emb.device
    if dev.type != "cuda" or h.device != dev:
        raise ValueError(f"{entry}: weights and state must lie on one CUDA device")
    b = h.shape[0]
    if h.shape != (b, w.u) or prompt.dim() != 2 or prompt.shape[0] != b:
        raise ValueError(f"{entry}: h {tuple(h.shape)} / prompt "
                         f"{tuple(prompt.shape)} do not fit U={w.u}")
    if toks_u8 and w.v > 256:
        raise ValueError(f"{entry}: uint8 tokens hold a vocab of at most 256, got V={w.v}")
    _check_layout(entry, w)
    bf16 = cd == torch.bfloat16
    sms, limit, per_sm = device_limits(dev)
    if config is None:
        plan = decode_plan(b, w.u, w.v, cd, sms, limit, per_sm)
    else:
        plan = config if isinstance(config, DecodePlan) else DecodePlan(*config)
    check_plan(plan, w.u, w.v, bf16, sms, limit, per_sm)
    ku = w.ku
    prompt = _i32(prompt, dev)
    plen, total = _i32(plen, dev), _i32(total, dev)
    prev, pos = _i32(prev, dev).clone(), _i32(pos, dev).clone()
    if ku == w.u:
        h0 = h.float().contiguous().clone()
    else:   # the padded units start (and stay) at 0
        h0 = torch.zeros((b, ku), dtype=torch.float32, device=dev)
        h0[:, :w.u] = h
    h1 = torch.empty_like(h0)
    toks = torch.empty((b, steps), dtype=torch.uint8 if toks_u8 else torch.int32, device=dev)
    temp_t = None if temp is None else temp.float().contiguous()
    # the setup launch fills these once per call: the input-projection table,
    # and at bf16 the recurrent plane and the head in the loop's layouts
    proj = torch.empty((w.v, 3 * ku), dtype=torch.bfloat16 if bf16 else torch.float32,
                       device=dev)
    if bf16:
        # slot-owned: whole 64-unit passes of 192 rows, tile by tile
        rows = _PASS_ROWS * -(-ku // 64) if plan.decomp == "slot" else 3 * ku
        wl = torch.empty((rows, _kp(ku)), dtype=torch.bfloat16, device=dev)
        dl = torch.empty((_vp(w.v), _kp(ku)), dtype=torch.bfloat16, device=dev)
    else:
        wl = None
        vc = f32_head_chunk(w.v)
        dl = torch.empty((-(-w.v // vc), ku, vc), dtype=torch.float32, device=dev)
    lg_rows = logits_scratch_rows(plan, b, w.v)
    lg = _logits_scratch(dev, lg_rows * _vp(w.v)) if lg_rows else None
    # bf16: the kernel's tensor-core products read a bf16 copy of h beside it
    hb0 = h0.to(torch.bfloat16) if bf16 else None
    hb1 = torch.empty_like(hb0) if bf16 else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    a = _Args(
        w.emb.data_ptr(), w.wc.data_ptr(), ptr(w.ws), w.uc.data_ptr(), ptr(w.us),
        w.bias.data_ptr(), w.dc.data_ptr(), ptr(w.ds), w.dbias.data_ptr(),
        prompt.data_ptr(), plen.data_ptr(), total.data_ptr(), prev.data_ptr(), pos.data_ptr(),
        h0.data_ptr(), h1.data_ptr(), toks.data_ptr(), ptr(temp_t), ptr(hb0), ptr(hb1),
        proj.data_ptr(), ptr(wl), dl.data_ptr(), ptr(lg),
        w.v, w.e, ku, prompt.shape[1], b, steps, int(toks_u8), int(bf16),
        int(temp_t is not None), int(top_k), WEIGHT_MODES[w.mode],
        int(plan.decomp == "slot"), plan.stages, int(slot_base), int(key_tile), float(top_p),
        seed & M32,
    )
    lib = _build.load("gru_persistent")
    if lib.gxt_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("gru_persistent.cu Args layout differs from _Args")
    lib.gxt_plan_smem.restype = ctypes.c_int
    lib.gxt_plan_smem.argtypes = [ctypes.POINTER(_Args)]
    have, want = lib.gxt_plan_smem(ctypes.byref(a)), plan_smem_bytes(plan, w.u, w.v, bf16)
    if have != want:
        raise RuntimeError(f"{entry}: gru_persistent.cu reckons {have} bytes of shared memory "
                           f"for {plan}, plan_smem_bytes {want}")
    fn = getattr(lib, f"gxt_{entry}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    code = fn(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, f"{entry} {plan}")
    LAUNCHES[entry] += 1
    LAST_PLAN[entry] = plan
    # a slot-owned loop updates h0 in place; a unit-owned one alternates
    out = h0 if plan.decomp == "slot" or steps % 2 == 0 else h1
    return toks, (out if ku == w.u else out[:, :w.u].contiguous()), prev, pos


def _check_tokens(ids: torch.Tensor, v: int) -> None:
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= v):
        raise ValueError(f"prompt token ids must lie in [0, {v})")


def fused_gru_decode(params, prompt_ids, prompt_lengths, total_steps: int, *,
                     compute_dtype=torch.bfloat16, return_state: bool = False):
    """Greedy decode through the persistent kernel; semantics of
    ``models.gru_textgen.generate(temperature=0)``: returns the (B,
    total_steps) int32 tokens fed (and the final f32 state h with
    ``return_state=True``). Runs on the params' device: the plain version on
    the CPU, the kernel on a GPU."""
    w = _prep_weights(params)
    dev = params.device
    prompt = torch.as_tensor(prompt_ids, device=dev).to(torch.int32)
    plen = torch.as_tensor(prompt_lengths, device=dev).to(torch.int32)
    b, p = prompt.shape
    _check_tokens(prompt, w.v)
    if p < total_steps:  # a prompt length past P feeds the pad id 0, as generate does
        prompt = torch.nn.functional.pad(prompt, (0, total_steps - p))
    zeros_i = torch.zeros((b,), dtype=torch.int32, device=dev)
    total = torch.full((b,), total_steps, dtype=torch.int32, device=dev)
    h = torch.zeros((b, w.u), dtype=torch.float32, device=dev)
    args = (w, prompt, plen, total, zeros_i, zeros_i, h, total_steps, compute_dtype)
    if dev.type == "cpu":
        toks, h, _, _ = gru_loop_reference(*args)
    else:
        toks, h, _, _ = gru_loop_cuda("fused_gru_decode", *args)
    return (toks, h) if return_state else toks


# The JAX tick's slot policy, which its noise keying follows: it pads the
# slot axis to whole 128-lane tiles, shards that padded axis, and above its
# measured untiled boundary (per weight route, at up to 256 inner steps; 2048
# past that) runs each shard as a grid of tiles, the widest 128-multiple that
# divides the shard. Each shard and each tile is a noise block.
SLOT_LANES = 128
FUSED_TICK_MAX_UNTILED = {"q8_0": 3712, "q4_0": 3584}


def _auto_tile(bp: int, limit: int) -> int:
    """0 (untiled) at or below ``limit``, else the largest 128-multiple tile
    <= limit that divides ``bp``."""
    if bp <= limit:
        return 0
    for tile in range(min(limit, bp) // SLOT_LANES * SLOT_LANES, 0, -SLOT_LANES):
        if bp % tile == 0:
            return tile
    raise ValueError(f"no boundary-safe tile divides {bp}")


def _auto_slot_tile(bp: int, qtype: str, inner_steps: int = 128) -> int:
    """The JAX tick's tile width for a (local, padded) slot width ``bp``
    under weight route ``qtype``: 0 untiled."""
    limit = FUSED_TICK_MAX_UNTILED.get(qtype, 2048)
    if inner_steps > 256:
        limit = min(limit, 2048)
    return _auto_tile(bp, limit)


@dataclasses.dataclass(frozen=True)
class TickShard:
    """The slots one rank ticks and how their noise is keyed: global slots
    ``[lo, hi)`` (empty where the rank holds only padding), column 0 at
    global slot ``slot_base``, blocks of ``key_tile`` columns (0: one)."""

    lo: int
    hi: int
    slot_base: int
    key_tile: int


def tick_shard(n_slots: int, mode: str, inner_steps: int, n_shards: int = 1, shard: int = 0,
               slot_tile: Optional[int] = None) -> TickShard:
    """Shard ``shard`` of ``n_shards`` of a tick over ``n_slots`` slots: the
    padded slot axis (whole 128s) split evenly, and the noise blocks of the
    JAX tick there (``slot_tile`` None: its auto policy on the local padded
    width; 0: untiled; else that width, which must divide it)."""
    bp = -(-n_slots // SLOT_LANES) * SLOT_LANES
    if bp % n_shards:
        raise ValueError(f"padded slot count {bp} not divisible by {n_shards} shards")
    local = bp // n_shards
    st = _auto_slot_tile(local, mode, inner_steps) if slot_tile is None else int(slot_tile)
    key_tile = st if 0 < st < local else 0
    if key_tile and local % key_tile:
        raise ValueError(f"slot_tile {key_tile} must divide padded slots {local}")
    return TickShard(min(shard * local, n_slots), min((shard + 1) * local, n_slots),
                     shard * local, key_tile)


def fused_slot_tick_shard(params, state, inner_steps: int, shard: TickShard, *,
                          compute_dtype=torch.bfloat16, enable_sampling: bool = False,
                          seed: int = 0, top_k: Optional[int] = None,
                          top_p: Optional[float] = None):
    """Tick the slots ``[shard.lo, shard.hi)`` of the engine's state. Returns
    their (h, prev, pos, toks), toks uint8 when the vocab has at most 255
    entries: the plain version on CPU tensors, the kernel on CUDA ones."""
    if top_k is not None and top_k <= 0:
        raise ValueError(f"top_k must be positive, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    w = _prep_weights(params)
    u8 = w.v <= 255
    sl = slice(shard.lo, shard.hi)
    h = state.h[sl]
    if shard.hi <= shard.lo:
        i32 = torch.zeros((0,), dtype=torch.int32, device=h.device)
        toks = torch.zeros((0, inner_steps), dtype=torch.uint8 if u8 else torch.int32,
                           device=h.device)
        return h.float(), i32, i32.clone(), toks
    args = (w, state.prompt[sl], state.plen[sl], state.total[sl], state.prev[sl],
            state.pos[sl], h, inner_steps, compute_dtype)
    kw = dict(temp=state.temp[sl] if enable_sampling else None, seed=int(seed),
              top_k=int(top_k or 0), top_p=float(top_p or 0.0), slot_base=shard.slot_base,
              key_tile=shard.key_tile)
    if h.device.type == "cpu":
        toks, h, prev, pos = gru_loop_reference(*args, **kw)
        if u8:
            toks = toks.to(torch.uint8)
    else:
        toks, h, prev, pos = gru_loop_cuda("fused_slot_tick", *args, toks_u8=u8, **kw)
    return h, prev, pos, toks


def _gather_slots(mesh, axis: str, local: int, n_slots: int, h, prev, pos, toks):
    """Every rank's (h, prev, pos, toks) of its slots, padded to ``local``
    rows, packed into one byte buffer, all-gathered over ``axis`` and cut
    back to the ``n_slots`` real slots."""
    pad = local - h.shape[0]
    parts = [torch.nn.functional.pad(t.reshape(t.shape[0], math.prod(t.shape[1:])),
                                     (0, 0, 0, pad)) for t in (h, prev, pos, toks)]
    widths = [p.shape[1] * p.element_size() for p in parts]
    buf = torch.cat([p.contiguous().view(torch.uint8) for p in parts], dim=1)
    buf = mesh.all_gather(buf, axis, dim=0)[:n_slots]
    out, at = [], 0
    for t, wd in zip((h, prev, pos, toks), widths):
        out.append(buf[:, at:at + wd].contiguous().view(t.dtype).reshape(n_slots, *t.shape[1:]))
        at += wd
    return out


def fused_slot_tick(params, state, inner_steps: int, *, compute_dtype=torch.bfloat16,
                    enable_sampling: bool = False, seed: int = 0,
                    top_k: Optional[int] = None, top_p: Optional[float] = None,
                    mesh=None, slot_axis: Optional[str] = None,
                    slot_tile: Optional[int] = None):
    """Advance the serving engine's slot state ``inner_steps`` tokens.

    Takes and returns the engine's ``SlotState`` (fields h, prev, pos, total,
    plen, prompt, temp) plus the (B, inner_steps) tokens fed at each step,
    uint8 when the vocab has at most 255 entries. ``enable_sampling`` samples
    slots with ``temp > 0`` by Gumbel-argmax on the hash-lattice noise for
    ``seed``; ``top_k`` / ``top_p`` mask the scaled logits first.

    ``mesh`` / ``slot_axis`` shard the tick's slots over that mesh axis (the
    multi-process serving path): each rank ticks only its part of the padded
    slot axis and the results are all-gathered back, so that every rank
    holds the whole state again. ``slot_tile`` sets the noise blocks as the
    JAX tick's ``slot_tile`` sets its grid (:func:`tick_shard`)."""
    n, r = 1, 0
    if slot_axis is not None:
        if mesh is None or slot_axis not in mesh.axis_names:
            raise ValueError(f"slot_axis={slot_axis!r} requires a mesh with that axis")
        n, r = mesh.size(slot_axis), mesh.index(slot_axis)
    b = state.h.shape[0]
    shard = tick_shard(b, _prep_weights(params).mode, inner_steps, n, r, slot_tile)
    h, prev, pos, toks = fused_slot_tick_shard(
        params, state, inner_steps, shard, compute_dtype=compute_dtype,
        enable_sampling=enable_sampling, seed=seed, top_k=top_k, top_p=top_p)
    if slot_axis is not None:
        h, prev, pos, toks = _gather_slots(mesh, slot_axis, -(-b // SLOT_LANES) * SLOT_LANES // n,
                                           b, h, prev, pos, toks)
    return dataclasses.replace(state, h=h, prev=prev, pos=pos), toks


__all__ = ["DecodePlan", "FUSED_TICK_MAX_UNTILED", "LAST_PLAN", "LAUNCHES", "TickShard",
           "block_keyed_bits", "check_plan", "decode_plan", "device_limits", "fused_gru_decode",
           "fused_slot_tick", "fused_slot_tick_shard", "gru_loop_cuda", "gru_loop_reference",
           "is_fusable_params", "kernel_refusal", "loop_refusal", "loop_takes", "plan_grid",
           "plan_refusal", "plan_slot_tiles", "plan_smem_bytes", "tick_shard"]
