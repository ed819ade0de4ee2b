"""Fused GRU training sequence: the forward over all T steps in one kernel
launch and the backward in two (the time loop, then the recurrent weight
gradient), as a ``torch.autograd.Function``.

:func:`fused_gru_scan` takes the biased input projection of every step
``mxs`` (T, B, 3U), the initial state ``h0`` (B, U), the recurrent kernel
``wr`` (U, 3U) and the recurrent bias ``brec`` (3U,), returns the states
``ys`` (T, B, U) and is differentiable in all four. ``compute_dtype`` is
``torch.bfloat16`` (the default, as the JAX function's) or
``torch.float32``: at the boundary the operands are cast to it and ``brec``
to float32, and the gradients come back in the inputs' dtypes.

On CUDA tensors the forward launches ``gxt_gru_train_fwd`` and the backward
``gxt_gru_train_bwd`` (the time loop) then ``gxt_gru_train_dwr`` (the
recurrent weight gradient), or raise: at bf16 those of ``csrc/gru_train.cu``
(``wgmma``), at f32 the ``_f32`` entry points of ``csrc/gru_train_f32.cu``
(3xTF32 products on tf32 ``wgmma``). On CPU tensors they run the plain
PyTorch versions in this module, which round where the kernels round:

* forward, per step: ``mh = h . wr + brec`` summed in f32, **rounded to the
  compute dtype and stored**; the gates use the rounded ``mh``; ``h' = z*h +
  (1-z)*g`` is rounded to the compute dtype.
* backward, time reversed, hand-derived (no autograd): gates rebuilt from the
  stored ``mxs`` and ``mhs``; ``dh = dy + carry`` in f32; ``dmx = [daz, dar,
  da]`` and ``dmh = [daz, dar, da*r]`` rounded to the compute dtype before
  both products; ``carry = dh*z + dmh . wr^T``; ``dwr += h_prev^T . dmh`` and
  ``dbrec += sum_b dmh`` (the unrounded ``dmh``) kept in f32; ``dh0`` is the
  last carry.

At f32 every rounding to the compute dtype is the identity, as in the JAX
body at ``compute_dtype=float32``: ``mhs`` and ``dmxs`` are stored in f32.

The kernels cut the work into blocks that each own a row tile of the batch
and a group of hidden units; :func:`train_plan` picks the cut and the
wrappers take ``config=`` to force one. At bf16 both recurrences share a
:class:`TrainPlan` (``ub`` units, a resident Wr slice). At f32 neither keeps
a slice: each streams a pre-split Wr operand (:func:`f32_fwd_weight`,
:func:`f32_bwd_weight`) with its A rows through a ring, and each has cuts
of its own (:class:`FwdPlan`, :class:`BwdPlan`, ``train_plan(...,
part=...)``); the f32 dWr GEMM splits K into :func:`dwr_partitions`
partitions. They take
U a multiple of 8 with U / 8 blocks co-resident (U <= 1056 on an H100) and
any B >= 1 in one launch; another U raises ``ValueError`` naming the
shape. The backward's recurrence writes the third gate of dmh
(``da * r``, rounded) into a (T, B, U) plane; dmh's other two thirds are
dmx's bits, so the dWr GEMM reads ``[dmx[..., :2U] | plane]`` and ``[h0;
ys[:-1]]``. The plain versions take any shape, and
``compute_dtype=torch.float64`` runs them without any rounding (for checking
the backward's formulas against autograd).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

# launches of each CUDA entry point; only the kernel wrappers add to these
LAUNCHES = {"fused_gru_train_fwd": 0, "fused_gru_train_bwd": 0, "fused_gru_train_dwr": 0,
            "fused_gru_train_fwd_f32": 0, "fused_gru_train_bwd_f32": 0,
            "fused_gru_train_dwr_f32": 0}
# runs of the plain versions through fused_gru_scan (CPU tensors)
PLAIN_CALLS = {"fused_gru_train_fwd": 0, "fused_gru_train_bwd": 0}
# the plan each recurrence entry point last launched
LAST_PLAN = {}

SMEM_LIMIT = 232448     # dynamic shared memory a block may opt in to on an H100
SMS = 132               # streaming multiprocessors of an H100 SXM
UNIT_GROUPS = (8, 16, 32)
# the f32 recurrences' cuts (rows, units) of a block: 128 or 256 rows give
# each of its two warpgroups its own rows; 64 rows (small batches) give them
# alternate K stages of the same rows. A forward warpgroup holds the f32
# totals of all its 3 units columns (at most 96 floats a thread: 64 units of
# 64 rows, 32 of 128)
F32_FWD_CUTS = ((128, 64), (256, 32), (128, 32), (64, 64), (64, 32), (64, 16), (64, 8))
F32_BWD_CUTS = ((128, 64), (256, 32), (64, 128), (64, 64), (64, 32), (64, 16), (64, 8))
F32_STAGE_K = 32            # K of a ring stage: one 128-byte swizzle row of f32
F32_MAX_STAGES = 16
DWR_TILE = 128              # the f32 dWr GEMM's block tile (M and N)
DWR_STAGE_ROWS = 32         # K rows of one of its stages
DWR_MAX_PARTS = 16
CHUNK_ROWS = 128        # rows of one TMA copy of the recurrences' A operand
TILE_BYTES = CHUNK_ROWS * 128
MAX_STAGES = 8
F32_THREADS = 256       # consumer threads of an f32 recurrence block
COMPUTE_DTYPES = (torch.bfloat16, torch.float32)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _acc_dtype(cd: torch.dtype) -> torch.dtype:
    return torch.float64 if cd == torch.float64 else torch.float32


def _gates(mx: torch.Tensor, mh: torch.Tensor, u: int):
    """Reset-after gate math: (z, r, g, mh_h)."""
    z = torch.sigmoid(mx[:, :u] + mh[:, :u])
    r = torch.sigmoid(mx[:, u:2 * u] + mh[:, u:2 * u])
    mh_h = mh[:, 2 * u:]
    g = torch.tanh(mx[:, 2 * u:] + r * mh_h)
    return z, r, g, mh_h


def gru_train_fwd_plain(mxs, h0, wr, brec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward on operands already cast (``mxs``, ``h0``, ``wr`` in the
    compute dtype, ``brec`` (3U,) in the sum dtype): (ys, mhs)."""
    cd = mxs.dtype
    acc = _acc_dtype(cd)
    t_len, b, g3 = mxs.shape
    u = g3 // 3
    wr_a = wr.to(acc)
    h = h0
    ys = mxs.new_empty((t_len, b, u))
    mhs = torch.empty_like(mxs)
    for t in range(t_len):
        h_a = h.to(acc)
        mh = (torch.matmul(h_a, wr_a) + brec).to(cd)
        z, _, g, _ = _gates(mxs[t].to(acc), mh.to(acc), u)
        h = (z * h_a + (1.0 - z) * g).to(cd)
        ys[t] = h
        mhs[t] = mh
    return ys, mhs


def gru_train_bwd_plain(mxs, mhs, ys, dys, h0, wr):
    """Backward on cast operands: (dmxs in the compute dtype; dwr (U, 3U),
    dbrec (3U,), dh0 (B, U) in the sum dtype)."""
    cd = mxs.dtype
    acc = _acc_dtype(cd)
    t_len, b, g3 = mxs.shape
    u = g3 // 3
    wr_t = wr.to(acc).t()
    dmxs = torch.empty_like(mxs)
    dwr = torch.zeros((u, g3), dtype=acc, device=mxs.device)
    dbrec = torch.zeros((g3,), dtype=acc, device=mxs.device)
    carry = torch.zeros((b, u), dtype=acc, device=mxs.device)
    for t in range(t_len - 1, -1, -1):
        h_prev = (h0 if t == 0 else ys[t - 1]).to(acc)
        z, r, g, mh_h = _gates(mxs[t].to(acc), mhs[t].to(acc), u)
        dh = dys[t].to(acc) + carry
        dz = dh * (h_prev - g)
        da = (dh * (1.0 - z)) * (1.0 - g * g)      # tanh'
        dr = da * mh_h
        daz = dz * z * (1.0 - z)                    # sigmoid'
        dar = dr * r * (1.0 - r)
        dmxs[t] = torch.cat([daz, dar, da], dim=1).to(cd)
        dmh = torch.cat([daz, dar, da * r], dim=1)
        dmh_c = dmh.to(cd).to(acc)
        carry = dh * z + torch.matmul(dmh_c, wr_t)
        dwr += torch.matmul(h_prev.t(), dmh_c)
        dbrec += dmh.sum(dim=0)
    return dmxs, dwr, dbrec, carry


# ---------------------------------------------------------------------------
# the backward's two kernels, plain
# ---------------------------------------------------------------------------

def gru_train_bwd_rec_plain(mxs, mhs, ys, dys, h0, wr):
    """The backward's time loop without dWr, as ``gxt_gru_train_bwd``
    computes it: (dmxs and the plane of ``round(da * r)`` (T, B, U) in the
    compute dtype; dbrec (3U,), dh0 (B, U) in the sum dtype)."""
    cd = mxs.dtype
    acc = _acc_dtype(cd)
    t_len, b, g3 = mxs.shape
    u = g3 // 3
    wr_t = wr.to(acc).t()
    dmxs = torch.empty_like(mxs)
    plane = mxs.new_empty((t_len, b, u))
    dbrec = torch.zeros((g3,), dtype=acc, device=mxs.device)
    carry = torch.zeros((b, u), dtype=acc, device=mxs.device)
    for t in range(t_len - 1, -1, -1):
        h_prev = (h0 if t == 0 else ys[t - 1]).to(acc)
        z, r, g, mh_h = _gates(mxs[t].to(acc), mhs[t].to(acc), u)
        dh = dys[t].to(acc) + carry
        dz = dh * (h_prev - g)
        da = (dh * (1.0 - z)) * (1.0 - g * g)      # tanh'
        dr = da * mh_h
        daz = dz * z * (1.0 - z)                    # sigmoid'
        dar = dr * r * (1.0 - r)
        dmxs[t] = torch.cat([daz, dar, da], dim=1).to(cd)
        plane[t] = (da * r).to(cd)
        dmh = torch.cat([daz, dar, da * r], dim=1)
        carry = dh * z + torch.matmul(dmh.to(cd).to(acc), wr_t)
        dbrec += dmh.sum(dim=0)
    return dmxs, plane, dbrec, carry


def gru_train_dwr_plain(h0, ys, dmxs, plane):
    """dWr (U, 3U) in the sum dtype from the stored operands, as
    ``gxt_gru_train_dwr`` computes it: the sum over t (last first, as the
    plain backward adds) of ``h_prev^T . [dmx[t][:, :2U] | plane[t]]``."""
    acc = _acc_dtype(dmxs.dtype)
    t_len, _, g3 = dmxs.shape
    u = g3 // 3
    dwr = torch.zeros((u, g3), dtype=acc, device=dmxs.device)
    for t in range(t_len - 1, -1, -1):
        h_prev = (h0 if t == 0 else ys[t - 1]).to(acc)
        dmh_c = torch.cat([dmxs[t][:, :2 * u], plane[t]], dim=1).to(acc)
        dwr += torch.matmul(h_prev.t(), dmh_c)
    return dwr


# ---------------------------------------------------------------------------
# the plan: how the recurrences cut the work
# ---------------------------------------------------------------------------

class TrainPlan(NamedTuple):
    """Block (r, g) of a recurrence owns row tile r of ``row_tiles`` and the
    ``ub`` hidden units of group g: ``row_tiles * U / ub`` blocks."""
    ub: int
    row_tiles: int


def tile_rows(b: int, r: int) -> int:
    """Rows of one row tile (``tile_rows`` of csrc/gru_train.cu): whole
    128-row TMA copies, or 64 for a lone tile of at most 64 rows."""
    if r == 1 and b <= 64:
        return 64
    return -(-(-(-b // r)) // CHUNK_ROWS) * CHUNK_ROWS


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def wr_bytes(part: str, ub: int, u: int) -> int:
    """Shared memory of a bf16 block's resident Wr slice in 64-wide tiles:
    the forward's 3ub gate columns over K = U, the backward's ub rows over
    K = 3U (dmx's columns padded to a multiple of 64, then the plane's U).
    The f32 recurrences keep no slice (:func:`f32_fwd_smem_bytes`,
    :func:`f32_bwd_smem_bytes`)."""
    if part == "fwd":
        return -(-u // 64) * 3 * ub * 128
    return -(-(2 * _round_up(u, 32) + u) // 64) * ub * 128


def smem_bytes(part: str, ub: int, u: int, stages: int) -> int:
    """Dynamic shared memory of a bf16 recurrence launch
    (``gxt_gru_train_smem``): the alignment slack, the Wr slice, the ring of
    ``stages`` copies and its barriers."""
    return 1024 + wr_bytes(part, ub, u) + stages * (TILE_BYTES + 16)


def ring_stages(part: str, ub: int, u: int, smem_limit: int = SMEM_LIMIT) -> int:
    """The deepest bf16 ring (at most MAX_STAGES) that fits beside the Wr
    slice; below 2 the unit group does not fit."""
    fixed = smem_bytes(part, ub, u, 0)
    return max(0, min(MAX_STAGES, (smem_limit - fixed) // (TILE_BYTES + 16)))


def _fits(ub: int, u: int, smem_limit: int) -> bool:
    return min(ring_stages(p, ub, u, smem_limit) for p in ("fwd", "bwd")) >= 2


# ---------------------------------------------------------------------------
# the f32 recurrences' cuts and dWr's K partitions
# ---------------------------------------------------------------------------

class FwdPlan(NamedTuple):
    """Block (r, g) of the f32 forward owns row tile r of ``row_tiles``
    (whole chunks of ``rows``) and the ``units`` hidden units of group g:
    ``row_tiles * U / units`` blocks."""
    rows: int
    units: int
    row_tiles: int


class BwdPlan(NamedTuple):
    """Block (r, g) of the f32 backward recurrence owns row tile r of
    ``row_tiles`` (whole chunks of ``rows``) and the ``units`` hidden units
    of group g: ``row_tiles * U / units`` blocks."""
    rows: int
    units: int
    row_tiles: int


def f32_fwd_kp(u: int) -> int:
    """Columns of the forward's split Wr operand: U rounded up to a whole
    32-wide stage."""
    return _round_up(u, F32_STAGE_K)


def f32_bwd_ka(u: int) -> int:
    """Where the plane's columns start in the carry product's K index space:
    dmx's 2U columns padded with zeros to a multiple of the 32-wide stage."""
    return _round_up(2 * u, F32_STAGE_K)


def f32_bwd_kp(u: int) -> int:
    """Columns of the backward's split Wr operand: KA + U rounded up to a
    whole stage."""
    return _round_up(f32_bwd_ka(u) + u, F32_STAGE_K)


def _f32_ring(rows: int, n: int, smem_limit: int) -> Tuple[int, int]:
    """(ring stages, dynamic shared memory) of an f32 recurrence block whose
    B operand has ``n`` rows (``ring_stages`` / ``ring_smem`` of
    csrc/gru_train_f32.cu): the alignment slack; each stage's A rows and
    the block's B hi and lo rows, 128 bytes each, and its two barriers;
    where the warpgroups take alternate stages (64 rows), the second one's
    sums, n / 2 floats a thread."""
    stage = (rows + 2 * n) * 128
    xchg = 128 * (n // 2) * 4 if rows == 64 else 0
    stages = min(F32_MAX_STAGES, (smem_limit - 1024 - xchg) // (stage + 16))
    return stages, 1024 + stages * (stage + 16) + xchg


def f32_fwd_smem_bytes(rows: int, units: int, smem_limit: int = SMEM_LIMIT) -> Tuple[int, int]:
    """(ring stages, dynamic shared memory) of a forward block of the cut
    (``smem_bytes(0, ...)`` of csrc/gru_train_f32.cu): a stage holds the
    chunk's h rows and the block's 3 units rows of Wr^T, hi and lo."""
    return _f32_ring(rows, 3 * units, smem_limit)


def f32_bwd_smem_bytes(rows: int, units: int, smem_limit: int = SMEM_LIMIT) -> Tuple[int, int]:
    """(ring stages, dynamic shared memory) of a backward block of the cut
    (``smem_bytes(1, ...)`` of csrc/gru_train_f32.cu): a stage holds the
    chunk's dmh rows and the block's ``units`` rows of Wr, hi and lo."""
    return _f32_ring(rows, units, smem_limit)


def f32_tile_rows(b: int, r: int, rows: int) -> int:
    """Rows of one f32 row tile: whole chunks of the cut's rows."""
    return _round_up(-(-b // r), rows)


def _f32_plans(b: int, u: int, part: str, sms: int, smem_limit: int) -> list:
    """Every cut an f32 recurrence takes at (B, U): ``units`` divides U, all
    blocks co-resident (one a multiprocessor), no empty row tile, a ring of
    at least two stages."""
    out = []
    if b <= 0 or u <= 0 or u % 8:
        return out
    cuts, smem, plan = ((F32_FWD_CUTS, f32_fwd_smem_bytes, FwdPlan) if part == "fwd"
                        else (F32_BWD_CUTS, f32_bwd_smem_bytes, BwdPlan))
    for rows, units in cuts:
        if u % units or smem(rows, units, smem_limit)[0] < 2:
            continue
        out += [plan(rows, units, r) for r in range(1, sms // (u // units) + 1)
                if (r - 1) * f32_tile_rows(b, r, rows) < b]
    return out


def _fwd_plan_cost(plan: FwdPlan, b: int, u: int) -> Tuple[int, bool, int, int]:
    """More blocks first, then cuts whose two warpgroups each own their rows
    (at 64 rows they take alternate stages, each stage's operands feeding
    one), then wider unit groups (each h fragment a warpgroup splits feeds
    a wider product), then fewer bytes a block streams a step (its chunks
    of h rows and its 3 units rows of Wr^T, hi and lo, again for each
    chunk): the order of ``tools/torch_kernel_bench.py --only train_f32
    --sweep`` on an H100 at U = 1024 (PERF.md)."""
    chunks = f32_tile_rows(b, plan.row_tiles, plan.rows) // plan.rows
    return (-plan.row_tiles * (u // plan.units), plan.rows == 64, -plan.units,
            chunks * (plan.rows + 6 * plan.units))


def _bwd_plan_cost(plan: BwdPlan, b: int, u: int) -> Tuple[int, int, int]:
    """More blocks first, then wider unit groups (each dmh fragment a
    warpgroup splits feeds a wider product), then fewer bytes a block
    streams a step (its chunks of dmh rows and its Wr rows, hi and lo,
    again for each chunk): the order of ``tools/torch_kernel_bench.py
    --only train_f32 --sweep`` on an H100 at U = 1024 (PERF.md)."""
    chunks = f32_tile_rows(b, plan.row_tiles, plan.rows) // plan.rows
    return (-plan.row_tiles * (u // plan.units), -plan.units,
            chunks * (plan.rows + 2 * plan.units))


def f32_fwd_weight(wr: torch.Tensor) -> torch.Tensor:
    """Wr (U, 3U) as the f32 forward's B operand: (2, 3U, KP) f32, the tf32
    hi parts of Wr's transpose then the lo parts (``tf32_split``, as
    ``split_tf32`` of csrc/mma_common.cuh splits), K = U contiguous and
    zeros to :func:`f32_fwd_kp`. Row 24 J + 8 gate + c is column gate * U +
    8 J + c of Wr: the z, r and h columns of each 8 units together, so a
    block of units u0.. reads rows 3 u0.. and a lane's accumulators hold
    the three gates of the same units. Made once a call."""
    from ggml_experiments_tpu_torch.ops.fused_transformer_layer import tf32_split

    u = wr.shape[0]
    j, gate, c = torch.meshgrid(torch.arange(u // 8), torch.arange(3), torch.arange(8),
                                indexing="ij")
    cols = (gate * u + 8 * j + c).reshape(-1).to(wr.device)
    out = torch.zeros((2, 3 * u, f32_fwd_kp(u)), dtype=torch.float32, device=wr.device)
    for i, part in enumerate(tf32_split(wr)):
        out[i, :, :u] = part.t()[cols]
    return out


def f32_bwd_weight(wr: torch.Tensor) -> torch.Tensor:
    """Wr (U, 3U) as the f32 backward's B operand: (2, U, KP) f32, the tf32
    hi parts then the lo parts (``tf32_split``, as ``split_tf32`` of
    csrc/mma_common.cuh splits), each row in the carry product's K order:
    dmx's 2U columns, zeros to :func:`f32_bwd_ka`, the plane's U columns,
    zeros to :func:`f32_bwd_kp`. Made once a call."""
    from ggml_experiments_tpu_torch.ops.fused_transformer_layer import tf32_split

    u = wr.shape[0]
    ka = f32_bwd_ka(u)
    out = torch.zeros((2, u, f32_bwd_kp(u)), dtype=torch.float32, device=wr.device)
    for i, part in enumerate(tf32_split(wr)):
        out[i, :, :2 * u] = part[:, :2 * u]
        out[i, :, ka:ka + u] = part[:, 2 * u:]
    return out


def dwr_stages(t_len: int, b: int) -> int:
    """The f32 dWr GEMM's K stages: stage st holds rows 32 (st % nb).. of
    step st // nb, nb = ceil(B / 32) (rows past B read as zeros)."""
    return t_len * -(-b // DWR_STAGE_ROWS)


def dwr_tiles(u: int) -> int:
    """128 x 128 tiles of dWr in its N index space (dmx's 2U columns padded
    to a multiple of 128, then the plane's U)."""
    return -(-u // DWR_TILE) * -(-(_round_up(2 * u, DWR_TILE) + u) // DWR_TILE)


def dwr_partitions(t_len: int, b: int, u: int, sms: int = SMS) -> int:
    """How many K partitions the f32 dWr GEMM takes: the P (at most
    DWR_MAX_PARTS and the stages) whose tiles x P blocks, one a
    multiprocessor at a time, finish soonest, ceil(tiles P / sms) / P; the
    fewest of those that tie."""
    tiles = dwr_tiles(u)
    top = max(1, min(DWR_MAX_PARTS, dwr_stages(t_len, b)))
    return min(range(1, top + 1), key=lambda p: (-(-tiles * p // sms) / p, p))


def train_plans(b: int, u: int, sms: int = SMS, smem_limit: int = SMEM_LIMIT,
                dtype: torch.dtype = torch.bfloat16, part: str = "fwd") -> list:
    """Every plan the kernels of ``dtype`` take at (B, U). bf16: the
    :class:`TrainPlan` both passes share, ``ub`` dividing U, all blocks
    co-resident (one a multiprocessor), no empty row tile, both passes in
    shared memory with a ring of at least two stages. f32: the cuts of the
    recurrence ``part`` names (:class:`FwdPlan` or :class:`BwdPlan`),
    under the same rules."""
    if dtype == torch.float32:
        return _f32_plans(b, u, part, sms, smem_limit)
    out = []
    if b <= 0 or u <= 0 or u % 8:
        return out
    for ub in UNIT_GROUPS:
        if u % ub or not _fits(ub, u, smem_limit):
            continue
        r = 1
        while r * (u // ub) <= sms and (r - 1) * tile_rows(b, r) < b:
            out.append(TrainPlan(ub, r))
            r += 1
    return out


def _plan_cost(plan: TrainPlan, b: int, u: int) -> Tuple[int, int]:
    """More blocks first, then fewer rows a block: the order of every cell of
    ``tools/torch_kernel_bench.py --sweep`` on an H100 (B = 64 to 4096,
    U = 1024, bf16; PERF.md). A block's time per step follows the rows it
    streams more than the depth of its ring."""
    return -plan.row_tiles * (u // plan.ub), tile_rows(b, plan.row_tiles)


def train_plan(b: int, u: int, sms: int = SMS, smem_limit: int = SMEM_LIMIT,
               dtype: torch.dtype = torch.bfloat16, part: str = "fwd"):
    """The default plan at (B, U) for the kernels of ``dtype`` (at f32, the
    :class:`FwdPlan` or :class:`BwdPlan` of the recurrence ``part`` names);
    ValueError when they take no plan."""
    plans = train_plans(b, u, sms, smem_limit, dtype, part)
    if not plans:
        raise ValueError(f"fused_gru_train: no plan takes (B, U) = ({b}, {u}) on {sms} "
                         f"multiprocessors: U must be a multiple of 8 with U / 8 <= {sms}")
    cost = {FwdPlan: _fwd_plan_cost, BwdPlan: _bwd_plan_cost}.get(type(plans[0]), _plan_cost)
    return min(plans, key=lambda p: cost(p, b, u))


def kernels_take(u: int, sms: int = SMS, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the kernel pair of ``dtype`` takes width U at all (at some batch)."""
    return all(train_plans(1, u, sms, dtype=dtype, part=p) for p in ("fwd", "bwd"))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _check_operands(entry: str, named, dev) -> None:
    for name, t, dtype, shape in named:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{entry}: {name} must be a contiguous {dtype} tensor of {shape} "
                             f"on {dev}, got {t.dtype}{tuple(t.shape)} on {t.device}")
        if dtype == torch.float32 and t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{entry}: {name} must start on a 16-byte boundary (the f32 "
                             f"kernels read 16 bytes a lane)")


def _check_mxs(entry: str, mxs) -> None:
    if mxs.device.type != "cuda" or mxs.dim() != 3 or mxs.shape[2] % 3:
        raise ValueError(f"{entry}: mxs must be a (T, B, 3U) CUDA tensor, got "
                         f"{tuple(mxs.shape)} on {mxs.device}")


def _entry(base: str, cd: torch.dtype) -> str:
    """The launch counter (and LAST_PLAN key) of ``base`` at compute dtype
    ``cd``: the f32 entry points count apart."""
    return base + "_f32" if cd == torch.float32 else base


def _compute_dtype(base: str, x) -> torch.dtype:
    if x.dtype not in COMPUTE_DTYPES:
        raise ValueError(f"{base}: the kernels take bfloat16 or float32 operands, got "
                         f"{x.dtype}")
    return x.dtype


def _device_limits(dev) -> Tuple[int, int]:
    props = torch.cuda.get_device_properties(dev)
    return props.multi_processor_count, getattr(props, "shared_memory_per_block_optin",
                                                SMEM_LIMIT)


def _resolve_plan(entry: str, part: str, config, t_len: int, b: int, u: int, dev,
                  cd: torch.dtype = torch.bfloat16):
    """(plan, ring stages) for a launch: the default plan, or ``config`` if
    the kernels take it; the wrapper's shared-memory reckoning is held
    against the kernel's. An f32 plan is a :class:`FwdPlan` or
    :class:`BwdPlan` (its ring's stages the kernel's own: 0 here)."""
    sms, limit = _device_limits(dev)
    plans = train_plans(b, u, sms, limit, cd, part)
    shape = f"(T, B, U) = ({t_len}, {b}, {u})"
    if not plans:
        raise ValueError(f"{entry}: the kernel takes U a multiple of 8 up to {8 * sms} on this "
                         f"device ({sms} multiprocessors), got {shape}")
    f32 = cd == torch.float32
    if config is None:
        plan = train_plan(b, u, sms, limit, cd, part)
    else:
        plan = type(plans[0])(*config)
    if plan not in plans:
        raise ValueError(f"{entry}: plan {tuple(plan)} does not take {shape} on this device; "
                         f"it takes {[tuple(p) for p in plans]}")
    part_no = 0 if part == "fwd" else 1
    if f32:
        stages = 0
        source = "gru_train_f32.cu"
        need = _lib_f32().gxt_gru_train_f32_smem(part_no, plan.rows, plan.units)
        want = (f32_fwd_smem_bytes if part == "fwd" else f32_bwd_smem_bytes)(plan.rows,
                                                                              plan.units)[1]
    else:
        stages = ring_stages(part, plan.ub, u, limit)
        source, need = "gru_train.cu", _lib().gxt_gru_train_smem(part_no, plan.ub, u, stages)
        want = smem_bytes(part, plan.ub, u, stages)
    if need != want:
        raise RuntimeError(f"{entry}: csrc/{source} takes {need} bytes of shared memory "
                           f"for {tuple(plan)} at U={u}, smem_bytes {want}")
    LAST_PLAN[entry] = plan
    return plan, stages


def _lib():
    from ggml_experiments_tpu_torch import _build

    lib = _build.load("gru_train")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gxt_gru_train_fwd.restype = i
    lib.gxt_gru_train_fwd.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.gxt_gru_train_bwd.restype = i
    lib.gxt_gru_train_bwd.argtypes = [p] * 12 + [i] * 6 + [p]
    lib.gxt_gru_train_dwr.restype = i
    lib.gxt_gru_train_dwr.argtypes = [p] * 5 + [i] * 3 + [p]
    lib.gxt_gru_train_smem.restype = ctypes.c_longlong
    lib.gxt_gru_train_smem.argtypes = [i] * 4
    return lib


def _lib_f32():
    from ggml_experiments_tpu_torch import _build

    lib = _build.load("gru_train_f32")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gxt_gru_train_fwd_f32.restype = i
    lib.gxt_gru_train_fwd_f32.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.gxt_gru_train_bwd_f32.restype = i
    lib.gxt_gru_train_bwd_f32.argtypes = [p] * 12 + [i] * 6 + [p]
    lib.gxt_gru_train_dwr_f32.restype = i
    lib.gxt_gru_train_dwr_f32.argtypes = [p] * 6 + [i] * 4 + [p]
    lib.gxt_gru_train_f32_smem.restype = ctypes.c_longlong
    lib.gxt_gru_train_f32_smem.argtypes = [i] * 3
    return lib


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def gru_train_fwd_cuda(mxs, h0, wr, brec, config=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on operands in the compute dtype (bf16 or
    f32; ``brec`` f32): (ys, mhs). ``config`` forces a plan: ``(ub,
    row_tiles)`` at bf16, ``(rows, units, row_tiles)`` at f32."""
    from ggml_experiments_tpu_torch import _build

    cd = _compute_dtype("fused_gru_train_fwd", mxs)
    entry = _entry("fused_gru_train_fwd", cd)
    _check_mxs(entry, mxs)
    dev = mxs.device
    t_len, b, g3 = mxs.shape
    u = g3 // 3
    _check_operands(entry, (("mxs", mxs, cd, (t_len, b, g3)), ("h0", h0, cd, (b, u)),
                            ("wr", wr, cd, (u, g3)), ("brec", brec, torch.float32, (g3,))),
                    dev)
    ys = torch.empty((t_len, b, u), dtype=cd, device=dev)
    mhs = torch.empty_like(mxs)
    if t_len == 0 or b == 0:
        return ys, mhs
    plan, stages = _resolve_plan(entry, "fwd", config, t_len, b, u, dev, cd)
    ctr = torch.zeros((plan.row_tiles,), dtype=torch.int32, device=dev)
    # the f32 kernel streams Wr^T's tf32 parts, split here once a call
    wop = f32_fwd_weight(wr) if cd == torch.float32 else wr
    ptrs = (mxs.data_ptr(), h0.data_ptr(), wop.data_ptr(), brec.data_ptr(), ys.data_ptr(),
            mhs.data_ptr(), ctr.data_ptr(), t_len, b, u, *plan)
    with torch.cuda.device(dev):
        if cd == torch.float32:
            lib = _lib_f32()
            code = lib.gxt_gru_train_fwd_f32(*ptrs, _stream(dev))
        else:
            lib = _lib()
            code = lib.gxt_gru_train_fwd(*ptrs, stages, _stream(dev))
    _build.check(lib, code, f"{entry} (T, B, U) = ({t_len}, {b}, {u}), plan {tuple(plan)}")
    LAUNCHES[entry] += 1
    return ys, mhs


def gru_train_bwd_rec_cuda(mxs, mhs, ys, dys, h0, wr, config=None):
    """Launch the backward's time loop on operands in the compute dtype:
    (dmxs, plane in it; dbrec, dh0 f32), one launch, one count of
    ``fused_gru_train_bwd`` (``_f32`` at f32). ``config`` forces a plan:
    ``(ub, row_tiles)`` at bf16, ``(rows, units, row_tiles)`` at f32."""
    from ggml_experiments_tpu_torch import _build

    cd = _compute_dtype("fused_gru_train_bwd", mxs)
    entry = _entry("fused_gru_train_bwd", cd)
    _check_mxs(entry, mxs)
    dev = mxs.device
    t_len, b, g3 = mxs.shape
    u = g3 // 3
    f32 = torch.float32
    _check_operands(entry, (("mxs", mxs, cd, (t_len, b, g3)), ("mhs", mhs, cd, (t_len, b, g3)),
                            ("ys", ys, cd, (t_len, b, u)), ("dys", dys, cd, (t_len, b, u)),
                            ("h0", h0, cd, (b, u)), ("wr", wr, cd, (u, g3))), dev)
    # the kernel writes every entry of its outputs
    dmxs = torch.empty_like(mxs)
    plane = torch.empty((t_len, b, u), dtype=cd, device=dev)
    if t_len == 0 or b == 0:
        return (dmxs, plane, torch.zeros((g3,), dtype=f32, device=dev),
                torch.zeros((b, u), dtype=f32, device=dev))
    plan, stages = _resolve_plan(entry, "bwd", config, t_len, b, u, dev, cd)
    dbrec = torch.empty((g3,), dtype=f32, device=dev)
    dbpart = torch.empty((plan.row_tiles, g3), dtype=f32, device=dev)
    dh0 = torch.empty((b, u), dtype=f32, device=dev)
    ctr = torch.zeros((plan.row_tiles,), dtype=torch.int32, device=dev)
    # the f32 kernel streams Wr's tf32 parts, split here once a call
    wop = f32_bwd_weight(wr) if cd == torch.float32 else wr
    ptrs = (mxs.data_ptr(), mhs.data_ptr(), ys.data_ptr(), dys.data_ptr(), h0.data_ptr(),
            wop.data_ptr(), dmxs.data_ptr(), plane.data_ptr(), dbrec.data_ptr(),
            dbpart.data_ptr(), dh0.data_ptr(), ctr.data_ptr(), t_len, b, u)
    with torch.cuda.device(dev):
        if cd == torch.float32:
            lib = _lib_f32()
            code = lib.gxt_gru_train_bwd_f32(*ptrs, *plan, _stream(dev))
        else:
            lib = _lib()
            code = lib.gxt_gru_train_bwd(*ptrs, *plan, stages, _stream(dev))
    _build.check(lib, code, f"{entry} (T, B, U) = ({t_len}, {b}, {u}), plan {tuple(plan)}")
    LAUNCHES[entry] += 1
    return dmxs, plane, dbrec, dh0


def gru_train_dwr_cuda(h0, ys, dmxs, plane) -> torch.Tensor:
    """Launch the dWr GEMM: (U, 3U) f32 from the recurrence's stored
    operands in the compute dtype, one count of ``fused_gru_train_dwr``
    (``_f32`` at f32)."""
    from ggml_experiments_tpu_torch import _build

    cd = _compute_dtype("fused_gru_train_dwr", dmxs)
    entry = _entry("fused_gru_train_dwr", cd)
    _check_mxs(entry, dmxs)
    dev = dmxs.device
    t_len, b, g3 = dmxs.shape
    u = g3 // 3
    _check_operands(entry, (("h0", h0, cd, (b, u)), ("ys", ys, cd, (t_len, b, u)),
                            ("dmxs", dmxs, cd, (t_len, b, g3)),
                            ("plane", plane, cd, (t_len, b, u))), dev)
    if u % 8:
        raise ValueError(f"{entry}: the kernel takes U a multiple of 8, got (T, B, U) = "
                         f"({t_len}, {b}, {u})")
    if t_len == 0 or b == 0:
        return torch.zeros((u, g3), dtype=torch.float32, device=dev)
    dwr = torch.empty((u, g3), dtype=torch.float32, device=dev)
    ptrs = (h0.data_ptr(), ys.data_ptr(), dmxs.data_ptr(), plane.data_ptr(), dwr.data_ptr())
    with torch.cuda.device(dev):
        if cd == torch.float32:
            lib = _lib_f32()
            parts = dwr_partitions(t_len, b, u, _device_limits(dev)[0])
            # the K partitions' sums, added in order by the launch's second kernel
            scratch = torch.empty((parts, u, g3) if parts > 1 else (0,), dtype=torch.float32,
                                  device=dev)
            LAST_PLAN[entry] = parts
            code = lib.gxt_gru_train_dwr_f32(*ptrs, scratch.data_ptr(), t_len, b, u, parts,
                                             _stream(dev))
        else:
            lib = _lib()
            code = lib.gxt_gru_train_dwr(*ptrs, t_len, b, u, _stream(dev))
    _build.check(lib, code, f"{entry} (T, B, U) = ({t_len}, {b}, {u})")
    LAUNCHES[entry] += 1
    return dwr


def gru_train_bwd_cuda(mxs, mhs, ys, dys, h0, wr, config=None):
    """The backward on operands in the compute dtype: the time loop's
    launch, then the dWr GEMM's (one count each): (dmxs in the compute
    dtype; dwr, dbrec, dh0 f32)."""
    dmxs, plane, dbrec, dh0 = gru_train_bwd_rec_cuda(mxs, mhs, ys, dys, h0, wr, config)
    return dmxs, gru_train_dwr_cuda(h0, ys, dmxs, plane), dbrec, dh0


# ---------------------------------------------------------------------------
# the differentiable scan
# ---------------------------------------------------------------------------

def _forward(ops, plain: bool):
    if plain or ops[0].device.type == "cpu":
        PLAIN_CALLS["fused_gru_train_fwd"] += 1
        return gru_train_fwd_plain(*ops)
    return gru_train_fwd_cuda(*ops)


def _backward(ops, plain: bool):
    if plain or ops[0].device.type == "cpu":
        PLAIN_CALLS["fused_gru_train_bwd"] += 1
        return gru_train_bwd_plain(*ops)
    return gru_train_bwd_cuda(*ops)


class _FusedGRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mxs, h0, wr, brec, cd, plain):
        acc = _acc_dtype(cd)
        ops = (mxs.to(cd).contiguous(), h0.to(cd).contiguous(), wr.to(cd).contiguous(),
               brec.reshape(-1).to(acc).contiguous())
        ys, mhs = _forward(ops, plain)
        ctx.save_for_backward(ops[0], mhs, ys, ops[1], ops[2])
        ctx.meta = (cd, plain, mxs.dtype, h0.dtype, wr.dtype, brec.dtype, brec.shape)
        return ys

    @staticmethod
    def backward(ctx, dys):
        mxs, mhs, ys, h0, wr = ctx.saved_tensors
        cd, plain, mxs_dt, h0_dt, wr_dt, brec_dt, brec_shape = ctx.meta
        dmxs, dwr, dbrec, dh0 = _backward((mxs, mhs, ys, dys.to(cd).contiguous(), h0, wr), plain)
        return (dmxs.to(mxs_dt), dh0.to(h0_dt), dwr.to(wr_dt),
                dbrec.reshape(brec_shape).to(brec_dt), None, None)


def _whole_weight(wr) -> torch.Tensor:
    """``wr`` itself, or, for a rank's shard of it (``parallel.sharding.
    Placed``), the whole weight through the shard's differentiable gather.
    Anything that is not then a float tensor raises."""
    if not isinstance(wr, torch.Tensor) and hasattr(wr, "gather"):
        wr = wr.gather()
    if not isinstance(wr, torch.Tensor) or not wr.is_floating_point():
        raise TypeError(f"the fused train kernels take a float recurrent kernel, got "
                        f"{type(wr).__name__}")
    return wr


def fused_gru_scan(mxs, h0, wr, brec, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Time-major fused GRU sequence: mxs (T, B, 3U) -> states ys (T, B, U)
    in ``compute_dtype`` (``torch.bfloat16`` or ``torch.float32``; another
    dtype raises ``ValueError``), differentiable in all four arguments. CUDA
    tensors go through the kernel pair of that dtype, CPU tensors through the
    plain versions.

    On a mesh (the counterpart of the JAX rules ``_fwd_partitioned`` and
    ``_bwd_partitioned``) each rank calls it on its own batch rows, with T, U
    and the weights whole: a ``wr`` placed by ``parallel.gru_param_specs``
    (a column shard) is gathered once a call, and its gradient reaches the
    shard as that shard's slice. The gradients of ``wr`` and ``brec`` are
    this rank's rows' partial sums: the caller sums them over ``data``
    (``training/gru_trainer`` sums every leaf's gradient there, once)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"fused_gru_scan: compute_dtype must be torch.bfloat16 or "
                         f"torch.float32, got {compute_dtype}")
    return _FusedGRUScan.apply(mxs, h0, _whole_weight(wr), brec, compute_dtype, False)


def fused_gru_scan_plain(mxs, h0, wr, brec, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The same function through the plain forward and the plain hand-derived
    backward, on any device. ``compute_dtype=torch.float64`` rounds nowhere."""
    return _FusedGRUScan.apply(mxs, h0, wr, brec, compute_dtype, True)


__all__ = ["BwdPlan", "FwdPlan", "LAST_PLAN", "LAUNCHES", "PLAIN_CALLS", "TrainPlan",
           "dwr_partitions", "f32_bwd_weight", "f32_fwd_weight", "fused_gru_scan",
           "fused_gru_scan_plain", "gru_train_bwd_cuda", "gru_train_bwd_plain",
           "gru_train_bwd_rec_cuda", "gru_train_bwd_rec_plain", "gru_train_dwr_cuda",
           "gru_train_dwr_plain", "gru_train_fwd_cuda", "gru_train_fwd_plain", "kernels_take",
           "smem_bytes", "train_plan", "train_plans"]
