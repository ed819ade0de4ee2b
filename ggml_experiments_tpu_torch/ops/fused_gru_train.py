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
(3xTF32 products on ``mma.sync``). On CPU tensors they run the plain
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
and a group of ``ub`` hidden units; :func:`train_plan` picks the cut
(:class:`TrainPlan`) for the compute dtype (the f32 Wr slice is twice the
bf16 one, so fewer plans fit) and the wrappers take ``config=`` to force
one. They take U a multiple of 8 with U / 8 blocks co-resident (U <= 1056
on an H100) and any B >= 1 in one launch; another U raises ``ValueError``
naming the shape. The backward's recurrence writes the third gate of dmh
(``da * r``, rounded) into a (T, B, U) plane; dmh's other two thirds are
dmx's bits, so the dWr GEMM reads ``[dmx[..., :2U] | plane]`` and ``[h0;
ys[:-1]]``. The plain versions take any shape, and
``compute_dtype=torch.float64`` runs them without any rounding (for checking
the backward's formulas against autograd).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

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
F32_UNIT_GROUPS = (8, 16)   # an f32 slice of 32 units fits only below U = 590
CHUNK_ROWS = 128        # rows of one TMA copy of the recurrences' A operand
TILE_BYTES = CHUNK_ROWS * 128
MAX_STAGES = 8
F32_THREADS = 256       # threads of an f32 recurrence block
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


def _f32_stride(k: int) -> int:
    """Row stride (floats) of an f32 Wr slice row of K columns in shared
    memory (``ks_of`` of csrc/gru_train_f32.cu): 16 mod 32, no bank conflict."""
    return _round_up(k, 32) + 16


def wr_bytes(part: str, ub: int, u: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of a block's resident Wr slice: the forward's 3ub gate
    columns over K = U, the backward's ub rows over K = 3U. bf16: 64-wide
    tiles (the backward's dmx columns padded to a multiple of 64, then the
    plane's U); f32: rows of :func:`_f32_stride` floats."""
    if dtype == torch.float32:
        return 4 * (3 * ub * _f32_stride(u) if part == "fwd" else ub * _f32_stride(3 * u))
    if part == "fwd":
        return -(-u // 64) * 3 * ub * 128
    return -(-(2 * _round_up(u, 32) + u) // 64) * ub * 128


def smem_bytes(part: str, ub: int, u: int, stages: int,
               dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of a recurrence launch (``gxt_gru_train_smem``,
    ``gxt_gru_train_f32_smem``). bf16: the alignment slack, the Wr slice,
    the ring of ``stages`` copies and its barriers. f32 (no ring: ``stages``
    is 0): the slice, which the backward then reuses for its threads' db_rec
    partial sums."""
    if dtype == torch.float32:
        w = wr_bytes(part, ub, u, dtype)
        return w if part == "fwd" else max(w, F32_THREADS * 24 * 4)
    return 1024 + wr_bytes(part, ub, u) + stages * (TILE_BYTES + 16)


def ring_stages(part: str, ub: int, u: int, smem_limit: int = SMEM_LIMIT,
                dtype: torch.dtype = torch.bfloat16) -> int:
    """bf16: the deepest ring (at most MAX_STAGES) that fits beside the Wr
    slice; below 2 the unit group does not fit. f32 reads its A operand
    without a ring: 0."""
    if dtype == torch.float32:
        return 0
    fixed = smem_bytes(part, ub, u, 0)
    return max(0, min(MAX_STAGES, (smem_limit - fixed) // (TILE_BYTES + 16)))


def _fits(ub: int, u: int, smem_limit: int, dtype: torch.dtype) -> bool:
    if dtype == torch.float32:
        return all(smem_bytes(p, ub, u, 0, dtype) <= smem_limit for p in ("fwd", "bwd"))
    return min(ring_stages(p, ub, u, smem_limit) for p in ("fwd", "bwd")) >= 2


def train_plans(b: int, u: int, sms: int = SMS, smem_limit: int = SMEM_LIMIT,
                dtype: torch.dtype = torch.bfloat16) -> List[TrainPlan]:
    """Every plan the kernels of ``dtype`` take at (B, U): ``ub`` divides U,
    all blocks co-resident (one a multiprocessor), no empty row tile, both
    passes in shared memory (bf16: with a ring of at least two stages)."""
    out = []
    if b <= 0 or u <= 0 or u % 8:
        return out
    for ub in F32_UNIT_GROUPS if dtype == torch.float32 else UNIT_GROUPS:
        if u % ub or not _fits(ub, u, smem_limit, dtype):
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
               dtype: torch.dtype = torch.bfloat16) -> TrainPlan:
    """The default plan at (B, U) for the kernels of ``dtype``; ValueError
    when they take no plan."""
    plans = train_plans(b, u, sms, smem_limit, dtype)
    if not plans:
        raise ValueError(f"fused_gru_train: no plan takes (B, U) = ({b}, {u}) on {sms} "
                         f"multiprocessors: U must be a multiple of 8 with U / 8 <= {sms}")
    return min(plans, key=lambda p: _plan_cost(p, b, u))


def kernels_take(u: int, sms: int = SMS, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the kernel pair of ``dtype`` takes width U at all (at some batch)."""
    return bool(train_plans(1, u, sms, dtype=dtype))


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
    against the kernel's."""
    sms, limit = _device_limits(dev)
    plans = train_plans(b, u, sms, limit, cd)
    shape = f"(T, B, U) = ({t_len}, {b}, {u})"
    if not plans:
        raise ValueError(f"{entry}: the kernel takes U a multiple of 8 up to {8 * sms} on this "
                         f"device ({sms} multiprocessors), got {shape}")
    plan = train_plan(b, u, sms, limit, cd) if config is None else TrainPlan(*config)
    if plan not in plans:
        raise ValueError(f"{entry}: plan {tuple(plan)} does not take {shape} on this device; "
                         f"it takes {[tuple(p) for p in plans]}")
    stages = ring_stages(part, plan.ub, u, limit, cd)
    part_no = 0 if part == "fwd" else 1
    if cd == torch.float32:
        source, need = "gru_train_f32.cu", _lib_f32().gxt_gru_train_f32_smem(part_no, plan.ub, u)
    else:
        source, need = "gru_train.cu", _lib().gxt_gru_train_smem(part_no, plan.ub, u, stages)
    want = smem_bytes(part, plan.ub, u, stages, cd)
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
    lib.gxt_gru_train_fwd_f32.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.gxt_gru_train_bwd_f32.restype = i
    lib.gxt_gru_train_bwd_f32.argtypes = [p] * 12 + [i] * 5 + [p]
    lib.gxt_gru_train_dwr_f32.restype = i
    lib.gxt_gru_train_dwr_f32.argtypes = [p] * 5 + [i] * 3 + [p]
    lib.gxt_gru_train_f32_smem.restype = ctypes.c_longlong
    lib.gxt_gru_train_f32_smem.argtypes = [i] * 3
    return lib


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def gru_train_fwd_cuda(mxs, h0, wr, brec, config=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on operands in the compute dtype (bf16 or
    f32; ``brec`` f32): (ys, mhs). ``config`` forces a plan, ``(ub,
    row_tiles)``."""
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
    ptrs = (mxs.data_ptr(), h0.data_ptr(), wr.data_ptr(), brec.data_ptr(), ys.data_ptr(),
            mhs.data_ptr(), ctr.data_ptr(), t_len, b, u, plan.ub, plan.row_tiles)
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
    ``fused_gru_train_bwd`` (``_f32`` at f32)."""
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
    ptrs = (mxs.data_ptr(), mhs.data_ptr(), ys.data_ptr(), dys.data_ptr(), h0.data_ptr(),
            wr.data_ptr(), dmxs.data_ptr(), plane.data_ptr(), dbrec.data_ptr(),
            dbpart.data_ptr(), dh0.data_ptr(), ctr.data_ptr(), t_len, b, u, plan.ub,
            plan.row_tiles)
    with torch.cuda.device(dev):
        if cd == torch.float32:
            lib = _lib_f32()
            code = lib.gxt_gru_train_bwd_f32(*ptrs, _stream(dev))
        else:
            lib = _lib()
            code = lib.gxt_gru_train_bwd(*ptrs, stages, _stream(dev))
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
    ptrs = (h0.data_ptr(), ys.data_ptr(), dmxs.data_ptr(), plane.data_ptr(), dwr.data_ptr(),
            t_len, b, u, _stream(dev))
    with torch.cuda.device(dev):
        if cd == torch.float32:
            lib = _lib_f32()
            code = lib.gxt_gru_train_dwr_f32(*ptrs)
        else:
            lib = _lib()
            code = lib.gxt_gru_train_dwr(*ptrs)
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


__all__ = ["LAST_PLAN", "LAUNCHES", "PLAIN_CALLS", "TrainPlan", "fused_gru_scan",
           "fused_gru_scan_plain", "gru_train_bwd_cuda", "gru_train_bwd_plain",
           "gru_train_bwd_rec_cuda", "gru_train_bwd_rec_plain", "gru_train_dwr_cuda",
           "gru_train_dwr_plain", "gru_train_fwd_cuda", "gru_train_fwd_plain", "kernels_take",
           "smem_bytes", "train_plan", "train_plans"]
