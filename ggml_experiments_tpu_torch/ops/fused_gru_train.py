"""Fused GRU training sequence: forward and backward over all T steps, each
in one kernel launch, as a ``torch.autograd.Function``.

:func:`fused_gru_scan` takes the biased input projection of every step
``mxs`` (T, B, 3U), the initial state ``h0`` (B, U), the recurrent kernel
``wr`` (U, 3U) and the recurrent bias ``brec`` (3U,), returns the states
``ys`` (T, B, U) and is differentiable in all four. At the boundary the
operands are cast to bfloat16 and ``brec`` to float32, and the gradients come
back in the inputs' dtypes.

On CUDA tensors the two passes launch ``csrc/gru_train.cu``
(``gxt_gru_train_fwd`` / ``gxt_gru_train_bwd``) or raise; on CPU tensors they
run the plain PyTorch versions in this module, which round where the kernels
round:

* forward, per step: ``mh = h . wr + brec`` summed in f32, **rounded to bf16
  and stored**; the gates use the rounded ``mh``; ``h' = z*h + (1-z)*g`` is
  rounded to bf16.
* backward, time reversed, hand-derived (no autograd): gates rebuilt from the
  stored ``mxs`` and ``mhs``; ``dh = dy + carry`` in f32; ``dmx = [daz, dar,
  da]`` and ``dmh = [daz, dar, da*r]`` rounded to bf16 before both products;
  ``carry = dh*z + dmh . wr^T``; ``dwr += h_prev^T . dmh`` and ``dbrec +=
  sum_b dmh`` (the unrounded ``dmh``) kept in f32; ``dh0`` is the last carry.

The kernels take U a multiple of 8 with at most 8 units per streaming
multiprocessor (U <= 1056 on an H100) and any B >= 1; another U raises
``ValueError`` naming the shape. One backward launch stages its whole batch
in shared memory, which holds at most 1760 rows at U = 1024, so the backward
walks a larger batch in row tiles (:func:`bwd_batch_tiles`), one launch a
tile, and adds the tiles' f32 weight gradients in tile order
(:func:`bwd_tiled`). The plain versions take any shape, and
``compute_dtype=torch.float64`` runs them without any rounding (for checking
the backward's formulas against autograd).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

# launches of each CUDA entry point; only the kernel wrappers add to these
LAUNCHES = {"fused_gru_train_fwd": 0, "fused_gru_train_bwd": 0}
# runs of the plain versions through fused_gru_scan (CPU tensors)
PLAIN_CALLS = {"fused_gru_train_fwd": 0, "fused_gru_train_bwd": 0}

UNITS_PER_BLOCK = 8
SMEM_LIMIT = 232448     # dynamic shared memory a block may opt in to on an H100


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
# batch tiles of the backward
# ---------------------------------------------------------------------------

def _padded_ld(k: int) -> int:
    """``padded_ld`` of csrc/gru_train.cu: whole 32-wide K steps, and a row
    of (ld / 2) % 32 == 16 words."""
    ld = -(-k // 32) * 32
    return ld + 32 if (ld // 2) % 32 != 16 else ld


def bwd_smem_bytes(b: int, u: int) -> int:
    """Dynamic shared memory of one backward launch over ``b`` rows at U=u
    (``bwd_smem`` of csrc/gru_train.cu): the block's 8 rows of Wr, the
    staged dmh of its 24 gate columns over the batch (B rounded up to 32),
    and its f32 columns of dWr."""
    bp = -(-b // 32) * 32
    return (UNITS_PER_BLOCK * _padded_ld(3 * u) * 2 + 3 * UNITS_PER_BLOCK * _padded_ld(bp) * 2
            + max(u, 256) * 3 * UNITS_PER_BLOCK * 4)


def bwd_batch_tiles(b: int, u: int, smem_limit: int = SMEM_LIMIT):
    """Row ranges [(start, stop), ...] covering 0..b in order, each a batch
    whose backward launch fits ``smem_limit`` bytes of shared memory: one
    range while the whole batch fits (B <= 1760 at U = 1024 on an H100),
    else the fewest tiles, of equal size rounded up to 32 rows (the last
    one shorter)."""
    if b <= 0:
        return []
    if bwd_smem_bytes(b, u) <= smem_limit:
        return [(0, b)]
    most = 0
    while bwd_smem_bytes(most + 32, u) <= smem_limit and most + 32 < b:
        most += 32
    if most == 0:
        raise ValueError(f"fused_gru_train_bwd: U={u} leaves no room for a 32-row batch tile "
                         f"in {smem_limit} bytes of shared memory")
    n = -(-b // most)
    rows = -(-(-(-b // n)) // 32) * 32
    return [(s, min(s + rows, b)) for s in range(0, b, rows)]


def bwd_tiled(run, mxs, mhs, ys, dys, h0, wr, tiles):
    """The backward over the row ``tiles`` of the batch: ``run`` (a kernel
    launch or the plain version) on each tile's rows, dmxs and dh0 put back
    in place, dwr and dbrec (sums over rows) added in tile order, so that
    two runs give the same bits. One tile is one plain call of ``run``."""
    if len(tiles) == 1 and tiles[0] == (0, mxs.shape[1]):
        return run(mxs, mhs, ys, dys, h0, wr)
    dmxs = torch.empty_like(mxs)
    dh0 = dwr = dbrec = None
    for s, e in tiles:
        part = run(mxs[:, s:e].contiguous(), mhs[:, s:e].contiguous(), ys[:, s:e].contiguous(),
                   dys[:, s:e].contiguous(), h0[s:e].contiguous(), wr)
        dmxs[:, s:e] = part[0]
        if dh0 is None:
            dh0 = part[3].new_empty((mxs.shape[1], part[3].shape[1]))
            dwr, dbrec = part[1], part[2]
        else:
            dwr, dbrec = dwr + part[1], dbrec + part[2]
        dh0[s:e] = part[3]
    return dmxs, dwr, dbrec, dh0


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _check_operands(entry: str, named, dev) -> None:
    for name, t, dtype, shape in named:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{entry}: {name} must be a contiguous {dtype} tensor of {shape} "
                             f"on {dev}, got {t.dtype}{tuple(t.shape)} on {t.device}")


def _check_units(entry: str, t_len: int, b: int, u: int, dev) -> None:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if u % UNITS_PER_BLOCK or u // UNITS_PER_BLOCK > sms:
        raise ValueError(
            f"{entry}: the kernel takes U a multiple of {UNITS_PER_BLOCK} up to "
            f"{UNITS_PER_BLOCK * sms} on this device ({sms} multiprocessors), got "
            f"(T, B, U) = ({t_len}, {b}, {u})")


def _lib():
    from ggml_experiments_tpu_torch import _build

    lib = _build.load("gru_train")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gxt_gru_train_fwd.restype = i
    lib.gxt_gru_train_fwd.argtypes = [p] * 6 + [i] * 3 + [p]
    lib.gxt_gru_train_bwd.restype = i
    lib.gxt_gru_train_bwd.argtypes = [p] * 12 + [i] * 3 + [p]
    lib.gxt_gru_train_bwd_smem.restype = i
    lib.gxt_gru_train_bwd_smem.argtypes = [i, i]
    return lib


def gru_train_fwd_cuda(mxs, h0, wr, brec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on bf16 operands (``brec`` f32): (ys, mhs)."""
    from ggml_experiments_tpu_torch import _build

    entry = "fused_gru_train_fwd"
    dev = mxs.device
    if dev.type != "cuda" or mxs.dim() != 3 or mxs.shape[2] % 3:
        raise ValueError(f"{entry}: mxs must be a (T, B, 3U) CUDA tensor, got "
                         f"{tuple(mxs.shape)} on {dev}")
    t_len, b, g3 = mxs.shape
    u = g3 // 3
    bf16 = torch.bfloat16
    _check_operands(entry, (("mxs", mxs, bf16, (t_len, b, g3)), ("h0", h0, bf16, (b, u)),
                            ("wr", wr, bf16, (u, g3)), ("brec", brec, torch.float32, (g3,))),
                    dev)
    _check_units(entry, t_len, b, u, dev)
    ys = torch.empty((t_len, b, u), dtype=bf16, device=dev)
    mhs = torch.empty_like(mxs)
    if t_len == 0 or b == 0:
        return ys, mhs
    lib = _lib()
    with torch.cuda.device(dev):
        code = lib.gxt_gru_train_fwd(mxs.data_ptr(), h0.data_ptr(), wr.data_ptr(),
                                     brec.data_ptr(), ys.data_ptr(), mhs.data_ptr(),
                                     t_len, b, u, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, f"{entry} (T, B, U) = ({t_len}, {b}, {u})")
    LAUNCHES[entry] += 1
    return ys, mhs


def gru_train_bwd_cuda(mxs, mhs, ys, dys, h0, wr):
    """The backward kernel on bf16 operands: (dmxs bf16; dwr, dbrec, dh0
    f32). A batch whose staging exceeds the device's shared memory runs in
    row tiles (:func:`bwd_batch_tiles`), one launch a tile, each adding one
    to ``LAUNCHES["fused_gru_train_bwd"]``; a batch that fits is one launch."""
    entry = "fused_gru_train_bwd"
    dev = mxs.device
    if dev.type != "cuda" or mxs.dim() != 3 or mxs.shape[2] % 3:
        raise ValueError(f"{entry}: mxs must be a (T, B, 3U) CUDA tensor, got "
                         f"{tuple(mxs.shape)} on {dev}")
    t_len, b, g3 = mxs.shape
    u = g3 // 3
    bf16, f32 = torch.bfloat16, torch.float32
    _check_operands(entry, (("mxs", mxs, bf16, (t_len, b, g3)), ("mhs", mhs, bf16, (t_len, b, g3)),
                            ("ys", ys, bf16, (t_len, b, u)), ("dys", dys, bf16, (t_len, b, u)),
                            ("h0", h0, bf16, (b, u)), ("wr", wr, bf16, (u, g3))), dev)
    _check_units(entry, t_len, b, u, dev)
    if t_len == 0 or b == 0:
        return (torch.empty_like(mxs), torch.zeros((u, g3), dtype=f32, device=dev),
                torch.zeros((g3,), dtype=f32, device=dev),
                torch.zeros((b, u), dtype=f32, device=dev))
    props = torch.cuda.get_device_properties(dev)
    limit = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT)
    return bwd_tiled(_bwd_launch, mxs, mhs, ys, dys, h0, wr, bwd_batch_tiles(b, u, limit))


def _bwd_launch(mxs, mhs, ys, dys, h0, wr):
    """One backward launch over a batch that fits shared memory."""
    from ggml_experiments_tpu_torch import _build

    entry = "fused_gru_train_bwd"
    dev = mxs.device
    t_len, b, g3 = mxs.shape
    u = g3 // 3
    bf16, f32 = torch.bfloat16, torch.float32
    lib = _lib()
    need = lib.gxt_gru_train_bwd_smem(b, u)
    if need != bwd_smem_bytes(b, u):
        raise RuntimeError(f"{entry}: csrc/gru_train.cu stages {need} bytes at (B, U) = "
                           f"({b}, {u}), bwd_smem_bytes {bwd_smem_bytes(b, u)}")
    # the kernel writes every entry of its outputs
    dmxs = torch.empty_like(mxs)
    dwr = torch.empty((u, g3), dtype=f32, device=dev)
    dbrec = torch.empty((g3,), dtype=f32, device=dev)
    dh0 = torch.empty((b, u), dtype=f32, device=dev)
    bp = -(-b // 32) * 32
    # staging, double-buffered by the parity of t: dmh of the step and the
    # transpose of h_{t-1}, whose padding columns must read as zeros
    dmh = torch.empty((2, b, g3), dtype=bf16, device=dev)
    hp_t = torch.zeros((2, u, bp), dtype=bf16, device=dev)
    with torch.cuda.device(dev):
        code = lib.gxt_gru_train_bwd(
            mxs.data_ptr(), mhs.data_ptr(), ys.data_ptr(), dys.data_ptr(), h0.data_ptr(),
            wr.data_ptr(), dmxs.data_ptr(), dwr.data_ptr(), dbrec.data_ptr(), dh0.data_ptr(),
            dmh.data_ptr(), hp_t.data_ptr(), t_len, b, u,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, f"{entry} (T, B, U) = ({t_len}, {b}, {u})")
    LAUNCHES[entry] += 1
    return dmxs, dwr, dbrec, dh0


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


def fused_gru_scan(mxs, h0, wr, brec) -> torch.Tensor:
    """Time-major fused GRU sequence: mxs (T, B, 3U) -> states ys (T, B, U)
    in bfloat16, differentiable in all four arguments. CUDA tensors go
    through the kernel pair, CPU tensors through the plain versions."""
    return _FusedGRUScan.apply(mxs, h0, wr, brec, torch.bfloat16, False)


def fused_gru_scan_plain(mxs, h0, wr, brec, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The same function through the plain forward and the plain hand-derived
    backward, on any device. ``compute_dtype=torch.float64`` rounds nowhere."""
    return _FusedGRUScan.apply(mxs, h0, wr, brec, compute_dtype, True)


__all__ = ["LAUNCHES", "PLAIN_CALLS", "bwd_batch_tiles", "bwd_smem_bytes", "bwd_tiled",
           "fused_gru_scan", "fused_gru_scan_plain", "gru_train_bwd_cuda", "gru_train_bwd_plain",
           "gru_train_fwd_cuda", "gru_train_fwd_plain"]
