"""MobileNetV2 inverted residual in one pass: ``csrc/inverted_residual.cu``
(``csrc/inverted_residual_wide.cu`` for the widths it does not take),
``csrc/inverted_residual_f32.cu`` at f32, ``csrc/inverted_residual_s2.cu`` at
stride 2, and their plain PyTorch version.

Replaces the TPU kernel ``ops/fused_inverted_residual.py``
``fused_inverted_residual`` of the JAX package (body ``_ir_kernel``): expand
1x1 -> depthwise 3x3 -> reduce 1x1 with the 4x-expanded activation kept out
of device memory. BN is folded into the weights (:func:`folded_conv_weights`),
so this route differs from the unfused chain, which applies BN in bf16 after
each convolution. The arithmetic, as the TPU body has it:

* ``ex = x . Wexp`` summed in f32 on bf16 operands; ``SiLU(ex + bexp) -> cd``;
  a zero ring around the image (zeros after the SiLU);
* depthwise over the rounded expanded values in f32 with f32 taps. Stride
  1: for each column tap dj the three row taps di summed in order, then the
  three column sums in order. Stride 2: output (i, j) reads input rows and
  columns 2i-1 .. 2i+1, the nine taps summed into one accumulator in (di,
  dj) row-major order. Then ``SiLU(acc + bdw) -> cd``;
* ``out = y . Wred + bred`` in f32, ``+ x`` with the residual (stride 1
  only), ``-> cd``.

At f32 nothing rounds below f32: the products are f32 sums of f32
operands, and the expanded and depthwise values stay f32.

On a CPU tensor :func:`fused_inverted_residual` runs :func:`fused_ir_plain`;
on a CUDA tensor it launches a kernel or raises. At stride 1 and bf16 the
strip kernel (``csrc/inverted_residual.cu``) takes C and Cout multiples of
8, C up to 64, E up to 256 and widths whose weights and rings fit one block
(:func:`ir_plans`); every other width goes to ``csrc/inverted_residual_wide.cu``
(counter ``inverted_residual_wide``; :func:`ir_wide_plan` picks its tile and
the output channels a pass takes). At stride 1 and f32 the block runs on
``csrc/inverted_residual_f32.cu`` (counter ``inverted_residual_f32``; Cout
up to 128). At stride 2, bf16 or f32, it runs on
``csrc/inverted_residual_s2.cu`` (counters ``inverted_residual_s2`` and
``inverted_residual_s2_f32``; even H and W, no residual, Cout up to 256),
which covers MobileViT-small's four downsampling blocks. Those three are one
design (``csrc/ir_hopper.cuh``: an output tile a block, x by TMA, the
weights split once into K-major planes by :func:`ir_wide_operands`,
:func:`ir_f32_operands` and :func:`ir_s2_operands`, the products on wgmma)
and take C as far as a tile's shared memory fits (:func:`ir_tc_tile`,
:func:`ir_wide_plan`; the block's route sends wider f32 and stride-2 blocks
to the unfused chain, :func:`ir_tc_takes`, and a bf16 stride-1 block too
wide for any tile raises). All of them count under
``fused_inverted_residual`` too.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ggml_experiments_tpu_torch.device import current_stream_handle, resolve_dtype
from ggml_experiments_tpu_torch.ops.activations import silu
from ggml_experiments_tpu_torch.ops.fused_transformer_layer import (
    _smem_limit,
    k_tiles,
    swizzle_tiles,
    tf32_split,
)

# launches of the CUDA kernels; only the kernel wrappers add to them
LAUNCHES = {"fused_inverted_residual": 0, "inverted_residual_wide": 0,
            "inverted_residual_f32": 0, "inverted_residual_s2": 0, "inverted_residual_s2_f32": 0}

SMEM_LIMIT = 232448     # bytes of shared memory an H100 block may use


def fused_ir_plain(x, wexp, bexp, kdw, bdw, wred, bred, *, stride: int = 1,
                   use_residual: bool = False) -> torch.Tensor:
    """The kernel's arithmetic. x (B, H, W, C) in the compute dtype, wexp
    (C, E) and wred (E, Cout) in it too; kdw (3, 3, E) and the biases f32."""
    cd = x.dtype
    b, h, w, c = x.shape
    e = wexp.shape[1]
    cout = wred.shape[1]
    ho, wo = h // stride, w // stride
    ex = torch.matmul(x.reshape(-1, c).float(), wexp.float())
    xe = F.pad(silu(ex + bexp).to(cd).reshape(b, h, w, e), (0, 0, 1, 1, 1, 1)).float()
    k = kdw.float()
    if stride == 1:
        acc = torch.zeros((b, h, w, e), dtype=torch.float32, device=x.device)
        for dj in range(3):
            t = torch.zeros((b, h, w + 2, e), dtype=torch.float32, device=x.device)
            for di in range(3):
                t = t + xe[:, di:di + h] * k[di, dj]
            acc = acc + t[:, :, dj:dj + w]
    else:
        acc = torch.zeros((b, ho, wo, e), dtype=torch.float32, device=x.device)
        for di in range(3):
            for dj in range(3):
                acc = acc + xe[:, di:di + h:stride, dj:dj + w:stride] * k[di, dj]
    y = silu(acc + bdw).to(cd)
    out = torch.matmul(y.reshape(-1, e).float(), wred.float()) + bred
    if use_residual:
        out = out + x.reshape(-1, c).float()
    return out.to(cd).reshape(b, ho, wo, cout)


# ---- the strip kernel's plans -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IRPlan:
    """A cut of ``csrc/inverted_residual.cu``: a block owns a strip of ``s``
    output columns of one image and walks down it in bands of ``BAND`` rows;
    x arrives through a ring of ``k`` TMA stages (``k - 1`` bands ahead)."""

    s: int
    k: int


BAND = 2                 # output rows a band (the kernel's R)
PLAN_STRIPS, PLAN_STAGES = (16, 32), (2, 3)
MAX_C, MAX_E = 64, 256   # Wexp's fragments in registers; 16 channels a warp, 16 warps


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def ir_smem_bytes(plan: IRPlan, c: int, e: int, cout: int) -> int:
    """Dynamic shared memory of a launch of ``plan`` (the kernel's ``geom``):
    the ring of R + 2 expanded rows (R = ``BAND``; it first holds Wexp),
    Wred, the y tile, the x ring, the staging tile, bred and the barriers."""
    s, r, k = plan.s, BAND, plan.k
    ep, cn = _pad(e, 64), _pad(cout, 64)
    sp, rs = s + 2, r * s
    slot = _pad(sp * (ep + 8) + ((sp - 1) // (s // 4) + 1) * 16, 8)
    o = 0
    for size in (max((r + 2) * slot * 2, ep * 128), ep // 64 * cn * 128,
                 -(-rs // 64) * ep // 64 * 8192, k * _pad((r + 1) * sp, 8) * 128,
                 cn // 64 * rs * 128):
        o = _pad(o + size, 1024)
    return o + cn * 4 + (k + 1) * 8 + 1024


@functools.lru_cache(maxsize=64)
def ir_plans(c: int, e: int, cout: int, limit: int = SMEM_LIMIT) -> Tuple[IRPlan, ...]:
    """Every plan the strip kernel takes at these widths: C up to 64 and C
    and Cout multiples of 8 (TMA's 16-byte strides), an even E up to 256,
    and the plan's shared memory within ``limit``. Empty: the wide kernel's
    widths (:func:`ir_wide_plan`)."""
    if c % 8 or c > MAX_C or cout % 8 or e % 2 or e > MAX_E:
        return ()
    return tuple(IRPlan(s, k) for s in PLAN_STRIPS for k in PLAN_STAGES
                 if ir_smem_bytes(IRPlan(s, k), c, e, cout) <= limit)


@functools.lru_cache(maxsize=256)
def ir_plan(b: int, h: int, w: int, c: int, e: int, cout: int,
            limit: int = SMEM_LIMIT) -> Optional[IRPlan]:
    """The strip kernel's plan for a (b, h, w, c) input, None where it does
    not take the widths: strips of 32 columns (16 where the image is at most
    16 wide), a 3-stage x ring (2 where 3 does not fit), or the nearest that
    fits."""
    plans = ir_plans(c, e, cout, limit)
    if not plans:
        return None
    s = 32 if w > 16 else 16
    return min(plans, key=lambda p: (p.s != s, -p.k))


# ---- operands ------------------------------------------------------------------------


@dataclasses.dataclass
class IROperands:
    """A block's weights in the strip kernel's layout, made once
    (:func:`ir_operands`): Wexp and Wred as 128-byte swizzled (64-channel
    chunk, output channel, 64) tiles, E and Cout padded to 64 with zeros in
    every vector."""

    c: int
    e: int
    cout: int
    wexp: torch.Tensor
    bexp: torch.Tensor
    kdw: torch.Tensor
    bdw: torch.Tensor
    wred: torch.Tensor
    bred: torch.Tensor
    ptrs: Tuple[int, ...] = dataclasses.field(init=False)   # the six, in the kernels' order

    def __post_init__(self):
        self.ptrs = tuple(t.data_ptr() for t in (self.wexp, self.bexp, self.kdw, self.bdw,
                                                 self.wred, self.bred))


def ir_operands(wexp, bexp, kdw, bdw, wred, bred):
    """wexp (C, E), bexp (E,), kdw (3, 3, E), bdw (E,), wred (E, Cout),
    bred (Cout,), BN folded, on the device of the launch: the strip kernel's
    operands (:class:`IROperands`) where it takes the widths, else
    ``csrc/inverted_residual_wide.cu``'s (:func:`ir_wide_operands`)."""
    c, e = wexp.shape
    cout = wred.shape[1]
    if not ir_plans(c, e, cout):
        return ir_wide_operands(wexp, bexp, kdw, bdw, wred, bred)
    ep, cn = _pad(e, 64), _pad(cout, 64)

    def vec(v, n, rows=1):
        out = torch.zeros((rows, n), dtype=torch.float32, device=v.device)
        out[:, :v.numel() // rows] = v.float().reshape(rows, -1)
        return out.reshape(-1)

    return IROperands(c, e, cout, k_tiles(wexp.t().to(torch.bfloat16), ep).contiguous(),
                      vec(bexp, ep), vec(kdw, ep, rows=9), vec(bdw, ep),
                      k_tiles(wred.t().to(torch.bfloat16), cn).contiguous(), vec(bred, cn))


def _lib(name: str):
    from ggml_experiments_tpu_torch import _build

    lib = _build.load(name)
    if getattr(lib, "_gxt_bound", False):
        return lib
    lib._gxt_bound = True
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "inverted_residual":
        lib.gxt_inverted_residual.restype = i
        lib.gxt_inverted_residual.argtypes = [p] * 8 + [i] * 9 + [p]
        lib.gxt_inverted_residual_smem.restype = ctypes.c_longlong
        lib.gxt_inverted_residual_smem.argtypes = [i] * 5
    elif name == "inverted_residual_f32":
        lib.gxt_ir_f32.restype = i
        lib.gxt_ir_f32.argtypes = [p] * 8 + [i] * 7 + [p]
        lib.gxt_ir_f32_smem.restype = ctypes.c_longlong
        lib.gxt_ir_f32_smem.argtypes = [i] * 3
    elif name == "inverted_residual_s2":
        lib.gxt_ir_s2.restype = i
        lib.gxt_ir_s2.argtypes = [i] + [p] * 8 + [i] * 6 + [p]
        lib.gxt_ir_s2_smem.restype = ctypes.c_longlong
        lib.gxt_ir_s2_smem.argtypes = [i] * 4
    else:
        lib.gxt_ir_wide.restype = i
        lib.gxt_ir_wide.argtypes = [p] * 8 + [i] * 10 + [p]
        lib.gxt_ir_wide_smem.restype = ctypes.c_longlong
        lib.gxt_ir_wide_smem.argtypes = [i] * 4
    return lib


_SMEM_AGREED = set()   # (plan, C, E, Cout) whose reckoning the kernel confirmed
_DEVICE_SMEM = {}      # device index -> shared memory a block may opt into


def fused_ir_cuda(x: torch.Tensor, ops, *, use_residual: bool = False,
                  _plan: Optional[IRPlan] = None) -> torch.Tensor:
    """Launch the kernel that takes ``ops``' widths (:func:`ir_operands`): x
    a bf16 (B, H, W, C) CUDA tensor, stride 1; the strip kernel for
    :class:`IROperands`, ``csrc/inverted_residual_wide.cu`` for
    :class:`IRTCOperands`. ``_plan`` forces the strip kernel's plan (tests,
    sweeps). The host work is kept short: it is part of every call."""
    from ggml_experiments_tpu_torch import _build

    if isinstance(ops, IRTCOperands):
        if _plan is not None:
            raise ValueError(f"fused_ir_cuda: (C, E, Cout) = ({ops.c}, {ops.e}, {ops.cout}) runs "
                             f"on csrc/inverted_residual_wide.cu, which takes no plan")
        return fused_ir_wide_cuda(x, ops, use_residual=use_residual)
    dev = x.device
    if dev.type != "cuda" or x.dim() != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"fused_ir_cuda: x must be a bf16 (B, H, W, C) CUDA tensor, got "
                         f"{x.dtype}{tuple(x.shape)} on {dev}")
    b, h, w, c = x.shape
    e, cout = ops.e, ops.cout
    if ops.c != c or (use_residual and c != cout) or e % 2:
        raise ValueError(f"fused_ir_cuda: weights of ({ops.c}, {e}, {cout}) do not meet x of "
                         f"width {c} (the kernels take an even E)")
    if not x.is_contiguous():
        x = x.contiguous()
    limit = _DEVICE_SMEM.get(dev.index)
    if limit is None:
        limit = _DEVICE_SMEM[dev.index] = _smem_limit(dev)
    plan = _plan or ir_plan(b, h, w, c, e, cout, limit)
    if plan not in ir_plans(c, e, cout, limit):
        raise ValueError(f"fused_ir_cuda: the strip kernel does not take {plan} at (C, E, "
                         f"Cout) = ({c}, {e}, {cout})")
    lib = _lib("inverted_residual")
    if (plan, c, e, cout) not in _SMEM_AGREED:
        need = ir_smem_bytes(plan, c, e, cout)
        if lib.gxt_inverted_residual_smem(plan.s, plan.k, c, e, cout) != need:
            raise RuntimeError(f"fused_ir_cuda: {plan} needs {need} bytes of shared memory "
                               f"here, the kernel reckons otherwise")
        _SMEM_AGREED.add((plan, c, e, cout))
    out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=dev)
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        code = lib.gxt_inverted_residual(x.data_ptr(), *ops.ptrs, out.data_ptr(), b, h, w, c, e,
                                         cout, int(use_residual), plan.s, plan.k,
                                         current_stream_handle(dev))
    if code:
        _build.check(lib, code, f"fused_inverted_residual (B, H, W, C, E, Cout) = ({b}, {h}, "
                                f"{w}, {c}, {e}, {cout}), {plan}")
    LAUNCHES["fused_inverted_residual"] += 1
    return out


# ---- the Hopper tile kernels: f32 at stride 1, bf16 and f32 at stride 2 (and bf16 at
# stride 1 past the strip kernel, below) ------------------------------------------------

F32_MAX_COUT = 128    # the f32 kernel's reduce: two m64 tiles of output channels
S2_MAX_COUT = 256     # the stride-2 kernel's: four
# output tiles (rows, columns) of csrc/ir_hopper.cuh by stride, widest first:
# a launch takes the first whose shared memory fits a block
IR_TC_TILES = {1: ((8, 16), (8, 8), (4, 8)), 2: ((8, 8), (4, 8), (2, 8))}


def _tc_dims(f32: bool):
    """(K of a 128-byte row = expanded channels a chunk, operand parts, the
    expanded chunk's row stride in elements, bytes an element) of
    csrc/ir_hopper.cuh at f32 or bf16."""
    return (32, 2, 40, 4) if f32 else (64, 1, 72, 2)


def _halo(stride: int, t: int) -> int:
    return (t - 1) * stride + 3


def _tc_smem(f32: bool, stride: int, tile, c: int, cout: int, wsl: int = 0) -> int:
    """Dynamic shared memory of a launch of csrc/ir_hopper.cuh (its
    ``layout``): x's halo in slabs of one 128-byte row of channels (each
    rounded up to 1024 bytes; at f32 twice, its tf32 hi and lo parts), a
    chunk of Wexp^T's planes (or ``wsl`` slabs of its K), one of Wred^T's
    (Cout rounded up to 64), y's chunk, the expanded chunk (the halo's
    pixels padded to m64 tiles), three mbarriers and the base's
    alignment."""
    kw, parts, lde, esz = _tc_dims(f32)
    th, tw = tile
    slabs, nc = -(-c // kw), 64 * -(-cout // 64)
    wsl = wsl if 0 < wsl < slabs else slabs
    hp = _halo(stride, th) * _halo(stride, tw)
    return (parts * slabs * _pad(hp * 128, 1024) + parts * wsl * kw * 128 + parts * nc * 128
            + parts * th * tw * 128 + _pad(hp, 64) * lde * esz + 24 + 1024)


def ir_tc_tile(f32: bool, stride: int, c: int, cout: int):
    """The output tile a launch at these widths takes: the widest of
    IR_TC_TILES[stride] whose shared memory fits a block (SMEM_LIMIT), else
    the narrowest (which then does not fit: the wrapper raises)."""
    tiles = IR_TC_TILES[stride]
    return next((t for t in tiles if _tc_smem(f32, stride, t, c, cout) <= SMEM_LIMIT),
                tiles[-1])


def ir_tc_plan(h: int, w: int, stride: int, tile):
    """The tiles of one image in the kernel's block order: (row, column) of
    each tile's first output pixel and of its halo's first input pixel (the
    halo spans ``_halo(stride, rows)`` x ``_halo(stride, columns)`` input
    pixels). Each output pixel lies in one tile. A tile's halo overlaps its
    neighbour's by 2 rows (columns) at stride 1 and by 1 at stride 2, so an
    input pixel is expanded by one tile, or by two or four at the seams."""
    th, tw = tile
    ho, wo = h // stride, w // stride
    return [((oy, ox), (stride * oy - 1, stride * ox - 1))
            for oy in range(0, ho, th) for ox in range(0, wo, tw)]


def _tc_planes(wt: torch.Tensor, rows: int, k: int, kw: int, f32: bool) -> torch.Tensor:
    """A product's operand wt (N, K) as K-major planes: (rows, k) zero-padded,
    cut into 128-byte rows of kw elements; at f32 its tf32 hi and lo parts
    ((2, rows, k / kw, kw)), at bf16 one plane ((1, rows, k / kw, kw))."""
    full = torch.zeros((rows, k), dtype=torch.float32, device=wt.device)
    full[:wt.shape[0], :wt.shape[1]] = wt.float()
    parts = tf32_split(full) if f32 else (full.to(torch.bfloat16),)
    return torch.stack(parts).reshape(len(parts), rows, k // kw, kw)


@dataclasses.dataclass
class IRTCOperands:
    """A block's weights for csrc/ir_hopper.cuh at one compute dtype, made
    once (:func:`ir_f32_operands`, :func:`ir_s2_operands`,
    :func:`ir_wide_operands`). Per chunk of kw expanded channels (32 at f32,
    64 at bf16), as each chunk's bulk copy lands in shared memory: ``wexp``
    (chunks, parts, slabs, kw, kw) holds Wexp^T's rows of the chunk's
    channels, K = C cut into slabs of kw; ``wred`` (passes x chunks, parts,
    ncp, kw) holds, for each pass over ``ncp`` output channels (passes
    outer), Wred^T's rows of the pass's channels for the chunk's K (one pass
    over Cout rounded up to 64 but on the wide kernel); each 128-byte row swizzled, the parts the
    tf32 hi and lo planes at f32 (split once here), one bf16 plane at bf16.
    bexp, kdw (9 rows), bdw padded to the chunks, bred to passes x ncp;
    zeros in every pad. ``tile`` is the wide kernel's output tile (the f32
    and stride-2 kernels pick theirs) and ``wsl`` the slabs of Wexp^T's K its
    buffer holds (:func:`ir_wide_plan`)."""

    c: int
    e: int
    cout: int
    dtype: torch.dtype
    wexp: torch.Tensor
    bexp: torch.Tensor
    kdw: torch.Tensor
    bdw: torch.Tensor
    wred: torch.Tensor
    bred: torch.Tensor
    ncp: int
    tile: Optional[Tuple[int, int]] = None
    wsl: int = 0
    ptrs: Tuple[int, ...] = dataclasses.field(init=False)   # the six, in the kernels' order

    def __post_init__(self):
        self.ptrs = tuple(t.data_ptr() for t in (self.wexp, self.bexp, self.kdw, self.bdw,
                                                 self.wred, self.bred))



def _tc_operands(wexp, bexp, kdw, bdw, wred, bred, cd, max_cout: int, who: str,
                 ncp: int = 0, tile=None, wsl: int = 0) -> IRTCOperands:
    c, e = wexp.shape
    cout = wred.shape[1]
    if not 0 < cout <= max_cout:
        raise ValueError(f"{who}: the kernel takes Cout up to {max_cout}, got {cout}")
    f32 = cd == torch.float32
    kw = _tc_dims(f32)[0]
    ncp = ncp or _pad(cout, 64)
    passes = -(-cout // ncp)
    ep, kp, nc = _pad(e, kw), _pad(c, kw), passes * ncp
    nch = ep // kw
    # Wexp^T (E, C): (parts, ep, slabs, kw) -> (chunks, parts, slabs, kw rows, kw)
    wx = _tc_planes(wexp.t(), ep, kp, kw, f32)
    wx = wx.reshape(wx.shape[0], nch, kw, kp // kw, kw).permute(1, 0, 3, 2, 4)
    # Wred^T (Cout, E): (parts, nc, chunks, kw) -> (passes chunks, parts, ncp, kw)
    wr = _tc_planes(wred.t(), nc, ep, kw, f32)
    wr = wr.reshape(wr.shape[0], passes, ncp, nch, kw).permute(1, 3, 0, 2, 4).reshape(
        passes * nch, wr.shape[0], ncp, kw)

    def vec(v, n, rows=1):
        out = torch.zeros((rows, n), dtype=torch.float32, device=v.device)
        out[:, :v.numel() // rows] = v.float().reshape(rows, -1)
        return out.reshape(-1)

    return IRTCOperands(c, e, cout, cd, swizzle_tiles(wx).contiguous(), vec(bexp, ep),
                        vec(kdw, ep, rows=9), vec(bdw, ep), swizzle_tiles(wr).contiguous(),
                        vec(bred, nc), ncp, tile, wsl)


def ir_f32_smem_bytes(c: int, e: int, cout: int) -> int:
    """Dynamic shared memory of a launch of ``csrc/inverted_residual_f32.cu``
    on its default tile (:func:`ir_tc_tile`; the kernel's ``gxt_ir_f32_smem``),
    -1 where it does not take the widths (Cout past F32_MAX_COUT). E does not
    enter: the kernel walks it in chunks of 32."""
    if c <= 0 or e <= 0 or not 0 < cout <= F32_MAX_COUT:
        return -1
    return _tc_smem(True, 1, ir_tc_tile(True, 1, c, cout), c, cout)


def ir_f32_operands(wexp, bexp, kdw, bdw, wred, bred) -> IRTCOperands:
    """wexp (C, E), bexp (E,), kdw (3, 3, E), bdw (E,), wred (E, Cout),
    bred (Cout,), BN folded, on the device of the launch: the f32 kernel's
    operands (:class:`IRTCOperands`, tf32 hi and lo planes)."""
    return _tc_operands(wexp, bexp, kdw, bdw, wred, bred, torch.float32, F32_MAX_COUT,
                        "ir_f32_operands")


def _tc_x(x: torch.Tensor, f32: bool) -> torch.Tensor:
    """x contiguous with its channels padded with zeros to a multiple of 16
    bytes (the tensor map's strides): a copy only where C is not."""
    step = 4 if f32 else 8
    if x.shape[-1] % step:
        return F.pad(x, (0, step - x.shape[-1] % step))
    return x if x.is_contiguous() else x.contiguous()


def _tc_check_smem(f32, stride, c, cout, dev, who):
    """Raise where the launch's tile (:func:`ir_tc_tile`, as the kernel picks
    it) does not fit the device's block; returns the tile."""
    limit = _DEVICE_SMEM.get(dev.index)
    if limit is None:
        limit = _DEVICE_SMEM[dev.index] = _smem_limit(dev)
    tile = ir_tc_tile(f32, stride, c, cout)
    need = _tc_smem(f32, stride, tile, c, cout)
    if need > limit:
        raise ValueError(f"{who}: C={c} needs {need} bytes of shared memory, the device "
                         f"allows {limit}")
    return tile


_F32_SMEM_AGREED = set()   # (C, E, Cout) whose reckoning the kernel confirmed


def fused_ir_f32_cuda(x: torch.Tensor, ops: IRTCOperands, *,
                      use_residual: bool = False) -> torch.Tensor:
    """Launch ``csrc/inverted_residual_f32.cu``: x an f32 (B, H, W, C) CUDA
    tensor, stride 1."""
    from ggml_experiments_tpu_torch import _build

    dev = x.device
    if dev.type != "cuda" or x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"fused_ir_f32_cuda: x must be an f32 (B, H, W, C) CUDA tensor, got "
                         f"{x.dtype}{tuple(x.shape)} on {dev}")
    b, h, w, c = x.shape
    e, cout = ops.e, ops.cout
    if ops.c != c or ops.dtype != torch.float32 or (use_residual and c != cout):
        raise ValueError(f"fused_ir_f32_cuda: weights of ({ops.c}, {e}, {cout}) do not meet x "
                         f"of width {c}")
    lib = _lib("inverted_residual_f32")
    if (c, e, cout) not in _F32_SMEM_AGREED:
        need = ir_f32_smem_bytes(c, e, cout)
        if lib.gxt_ir_f32_smem(c, e, cout) != need:
            raise RuntimeError(f"fused_ir_f32_cuda: (C, E, Cout) = ({c}, {e}, {cout}) needs "
                               f"{need} bytes of shared memory here, the kernel reckons otherwise")
        _F32_SMEM_AGREED.add((c, e, cout))
    th, tw = _tc_check_smem(True, 1, c, cout, dev, "fused_ir_f32_cuda")
    xk = _tc_x(x, True)
    out = torch.empty((b, h, w, cout), dtype=torch.float32, device=dev)
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        code = lib.gxt_ir_f32(xk.data_ptr(), *ops.ptrs, out.data_ptr(), b, h, w, xk.shape[-1],
                              e, cout, int(use_residual), current_stream_handle(dev))
    if code:
        _build.check(lib, code, f"fused_inverted_residual f32 (B, H, W, C, E, Cout) = ({b}, "
                                f"{h}, {w}, {c}, {e}, {cout}), tile {th} x {tw}")
    LAUNCHES["inverted_residual_f32"] += 1
    LAUNCHES["fused_inverted_residual"] += 1
    return out


# ---- the stride-2 kernel ---------------------------------------------------------------


def _s2_cover(cout: int) -> int:
    """Output channels the stride-2 kernel's reduce covers: Cout rounded up to
    64 (0 past S2_MAX_COUT)."""
    return _pad(cout, 64) if 0 < cout <= S2_MAX_COUT else 0


def ir_s2_smem_bytes(c: int, e: int, cout: int, compute_dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of a launch of ``csrc/inverted_residual_s2.cu``
    on its default tile (:func:`ir_tc_tile`; the kernel's ``gxt_ir_s2_smem``),
    -1 where it does not take the widths (Cout past S2_MAX_COUT). E does not
    enter: the kernel walks it in chunks of 64 (bf16) or 32 (f32)."""
    if c <= 0 or e <= 0 or not _s2_cover(cout):
        return -1
    f32 = resolve_dtype(compute_dtype) == torch.float32
    return _tc_smem(f32, 2, ir_tc_tile(f32, 2, c, cout), c, cout)


def ir_s2_operands(wexp, bexp, kdw, bdw, wred, bred,
                   compute_dtype=torch.bfloat16) -> IRTCOperands:
    """wexp (C, E), bexp (E,), kdw (3, 3, E), bdw (E,), wred (E, Cout),
    bred (Cout,), BN folded, on the device of the launch; the stride-2
    kernel's operands at ``compute_dtype`` (bf16 or f32: :class:`IRTCOperands`)."""
    return _tc_operands(wexp, bexp, kdw, bdw, wred, bred, resolve_dtype(compute_dtype),
                        S2_MAX_COUT, "ir_s2_operands")


def ir_tc_takes(stride: int, c: int, e: int, cout: int, compute_dtype) -> bool:
    """Whether the f32 stride-1 kernel (``stride`` 1) or the stride-2 kernel
    (2, bf16 or f32) takes a block of these widths: Cout within its limit and
    a tile whose shared memory fits a block. Both keep x's whole halo and a
    chunk of Wexp^T in shared memory, and both grow with C: f32 stride 1
    takes C up to 224, f32 stride 2 up to 128-192 and bf16 stride 2 up to
    576-640, by Cout (MobileViT-small's widest C is 128). The block's route
    (``models/mobilevit.py``) turns the rest away before any launch."""
    need = (ir_f32_smem_bytes(c, e, cout) if stride == 1
            else ir_s2_smem_bytes(c, e, cout, compute_dtype))
    return 0 < need <= SMEM_LIMIT


def ir_bf16_takes(c: int, e: int, cout: int) -> bool:
    """Whether a bf16 stride-1 kernel takes a block of these widths: the
    strip kernel (a plan of :func:`ir_plans`) or, past it, the wide kernel
    (a tile of :func:`ir_wide_plan`, C up to 1536; it pads E to 64, so an
    odd E too). The block's route (``models/mobilevit.py``) turns the rest
    away before any launch."""
    return bool(ir_plans(c, e, cout)) or ir_wide_plan(c, cout) is not None


_S2_SMEM_AGREED = set()   # (dtype, C, E, Cout) whose reckoning the kernel confirmed


def fused_ir_s2_cuda(x: torch.Tensor, ops: IRTCOperands, *,
                     use_residual: bool = False) -> torch.Tensor:
    """Launch ``csrc/inverted_residual_s2.cu``: x a (B, H, W, C) CUDA tensor at
    ``ops``' dtype with H and W even -> (B, H/2, W/2, Cout). Raises on a
    residual (the output has another shape than x), odd H or W, widths that
    do not meet x's, a C whose halo does not fit the block's shared memory,
    another dtype or device. The checks of shape come before the device's,
    so that they read the same on the CPU."""
    from ggml_experiments_tpu_torch import _build

    if x.dim() != 4 or x.dtype != ops.dtype:
        raise ValueError(f"fused_ir_s2_cuda: x must be a {ops.dtype} (B, H, W, C) tensor, got "
                         f"{x.dtype}{tuple(x.shape)}")
    b, h, w, c = x.shape
    e, cout = ops.e, ops.cout
    if use_residual:
        raise ValueError("fused_ir_s2_cuda: a stride-2 block has no residual (its output is "
                         "(H/2, W/2))")
    if h % 2 or w % 2:
        raise ValueError(f"fused_ir_s2_cuda: the stride-2 kernel takes even H and W, got "
                         f"{h} x {w}")
    if ops.c != c:
        raise ValueError(f"fused_ir_s2_cuda: weights of ({ops.c}, {e}, {cout}) do not meet x "
                         f"of width {c}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_ir_s2_cuda: x must be a CUDA tensor, got one on {dev}")
    f32 = ops.dtype == torch.float32
    lib = _lib("inverted_residual_s2")
    if (ops.dtype, c, e, cout) not in _S2_SMEM_AGREED:
        need = ir_s2_smem_bytes(c, e, cout, ops.dtype)
        if lib.gxt_ir_s2_smem(int(f32), c, e, cout) != need:
            raise RuntimeError(f"fused_ir_s2_cuda: (C, E, Cout) = ({c}, {e}, {cout}) needs "
                               f"{need} bytes of shared memory here, the kernel reckons otherwise")
        _S2_SMEM_AGREED.add((ops.dtype, c, e, cout))
    th, tw = _tc_check_smem(f32, 2, c, cout, dev, "fused_ir_s2_cuda")
    xk = _tc_x(x, f32)
    out = torch.empty((b, h // 2, w // 2, cout), dtype=ops.dtype, device=dev)
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        code = lib.gxt_ir_s2(int(f32), xk.data_ptr(), *ops.ptrs, out.data_ptr(), b, h, w,
                             xk.shape[-1], e, cout, current_stream_handle(dev))
    if code:
        _build.check(lib, code, f"fused_inverted_residual stride 2 {ops.dtype} (B, H, W, C, E, "
                                f"Cout) = ({b}, {h}, {w}, {c}, {e}, {cout}), tile {th} x {tw}")
    LAUNCHES["inverted_residual_s2_f32" if f32 else "inverted_residual_s2"] += 1
    LAUNCHES["fused_inverted_residual"] += 1
    return out


# ---- the bf16 stride-1 kernel past the strip kernel's widths -----------------------------

# m64 tiles of output channels a pass of csrc/inverted_residual_wide.cu takes on
# each stride-1 tile: a warpgroup holds the reduce's sums of its share of the
# tile's pixels (32 at 8 x 16, 16 at 8 x 8, 8 at 4 x 8) in registers
WIDE_MAX_NCT = {(8, 16): 2, (8, 8): 4, (4, 8): 4}


def ir_wide_smem_bytes(tile, c: int, ncp: int, wsl: int = 0) -> int:
    """Dynamic shared memory of a launch of ``csrc/inverted_residual_wide.cu``
    on ``tile`` with C input channels (padded to a multiple of 8), passes of
    ``ncp`` output channels and ``wsl`` slabs of 64 of Wexp^T's K in its
    buffer (0: all of them) (the kernel's ``gxt_ir_wide_smem``). E does not
    enter: the kernel walks it in chunks of 64."""
    return _tc_smem(False, 1, tile, _pad(c, 8), ncp, wsl)


WIDE_PIECES_TILE = (4, 8)   # the tile that takes Wexp^T in pieces (csrc by_tile)


@functools.lru_cache(maxsize=256)
def ir_wide_plan(c: int, cout: int, limit: int = SMEM_LIMIT):
    """(tile, ncp, wsl) of ``csrc/inverted_residual_wide.cu`` at these
    widths, None where no tile fits a block. On each stride-1 tile the fewest
    passes over Cout (``ncp`` output channels each, a multiple of 64 up to
    the tile's WIDE_MAX_NCT m64 tiles, the passes as even as the m64 tiles
    allow) whose shared memory fits ``limit``; of the tiles the one whose
    passes expand the fewest halo pixels an output pixel (the widest on a
    tie). ``wsl`` is the slabs of 64 input channels of Wexp^T its buffer
    holds: all of C's where a chunk fits whole; else, on the 4 x 8 tile
    alone, the most that fit (the chunk then comes in pieces, C past 768)."""
    best = None
    nt, slabs = -(-cout // 64), -(-c // 64)
    for tile, cap in WIDE_MAX_NCT.items():
        for passes in range(-(-nt // cap), nt + 1):
            ncp = 64 * -(-nt // passes)
            if ir_wide_smem_bytes(tile, c, ncp) <= limit:
                cost = passes * _halo(1, tile[0]) * _halo(1, tile[1]) / (tile[0] * tile[1])
                if best is None or cost < best[0]:
                    best = (cost, tile, ncp, slabs)
                break
    if best is None:   # x's halo on 4 x 8 beside fewer slabs of Wexp^T, one m64 tile a pass
        wsl = next((w for w in range(slabs - 1, 0, -1)
                    if ir_wide_smem_bytes(WIDE_PIECES_TILE, c, 64, w) <= limit), None)
        return None if wsl is None else (WIDE_PIECES_TILE, 64, wsl)
    return best[1:]


def ir_wide_operands(wexp, bexp, kdw, bdw, wred, bred) -> IRTCOperands:
    """wexp (C, E), bexp (E,), kdw (3, 3, E), bdw (E,), wred (E, Cout),
    bred (Cout,), BN folded, on the device of the launch: the operands of
    ``csrc/inverted_residual_wide.cu`` (:class:`IRTCOperands` at bf16, one
    plane, on :func:`ir_wide_plan`'s tile, passes and Wexp^T pieces). Raises
    where x's halo at this C fits no tile's shared memory."""
    c, e = wexp.shape
    cout = wred.shape[1]
    plan = ir_wide_plan(c, cout)
    if plan is None:
        raise ValueError(f"ir_wide_operands: (C, E, Cout) = ({c}, {e}, {cout}): x's halo and one "
                         f"slab of Wexp at C={c} need "
                         f"{ir_wide_smem_bytes(WIDE_PIECES_TILE, c, 64, 1)} bytes of shared "
                         f"memory on the narrowest tile (4 x 8, one m64 tile of output channels a "
                         f"pass), a block has {SMEM_LIMIT}")
    tile, ncp, wsl = plan
    return _tc_operands(wexp, bexp, kdw, bdw, wred, bred, torch.bfloat16, cout,
                        "ir_wide_operands", ncp, tile, wsl)


_WIDE_SMEM_AGREED = set()   # (tile, C, ncp, wsl) whose reckoning the kernel confirmed


def fused_ir_wide_cuda(x: torch.Tensor, ops: IRTCOperands, *,
                       use_residual: bool = False) -> torch.Tensor:
    """Launch ``csrc/inverted_residual_wide.cu`` on :func:`ir_wide_operands`'
    planes: x a bf16 (B, H, W, C) CUDA tensor, stride 1; one launch a pass
    over ``ops.ncp`` output channels. C is padded with zero channels to a
    multiple of 8 (a copy) where it is not one: TMA's 16-byte strides."""
    from ggml_experiments_tpu_torch import _build

    if x.dim() != 4 or x.dtype != torch.bfloat16 or ops.dtype != torch.bfloat16 or not ops.tile:
        raise ValueError(f"fused_ir_wide_cuda: x must be a bf16 (B, H, W, C) tensor on "
                         f"ir_wide_operands' planes, got {x.dtype}{tuple(x.shape)}")
    b, h, w, c = x.shape
    e, cout = ops.e, ops.cout
    if ops.c != c or (use_residual and c != cout):
        raise ValueError(f"fused_ir_wide_cuda: weights of ({ops.c}, {e}, {cout}) do not meet x "
                         f"of width {c}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_ir_wide_cuda: x must be a CUDA tensor, got one on {dev}")
    lib = _lib("inverted_residual_wide")
    tile = IR_TC_TILES[1].index(ops.tile)
    if (ops.tile, c, ops.ncp, ops.wsl) not in _WIDE_SMEM_AGREED:
        need = ir_wide_smem_bytes(ops.tile, c, ops.ncp, ops.wsl)
        if lib.gxt_ir_wide_smem(tile, _pad(c, 8), ops.ncp, ops.wsl) != need:
            raise RuntimeError(f"fused_ir_wide_cuda: (C, Cout) = ({c}, {cout}) on tile "
                               f"{ops.tile} needs {need} bytes of shared memory here, the kernel "
                               f"reckons otherwise")
        limit = _DEVICE_SMEM.get(dev.index)
        if limit is None:
            limit = _DEVICE_SMEM[dev.index] = _smem_limit(dev)
        if need > limit:
            raise ValueError(f"fused_ir_wide_cuda: C={c} needs {need} bytes of shared memory, "
                             f"the device allows {limit}")
        _WIDE_SMEM_AGREED.add((ops.tile, c, ops.ncp, ops.wsl))
    xk = _tc_x(x, False)
    out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=dev)
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        code = lib.gxt_ir_wide(xk.data_ptr(), *ops.ptrs, out.data_ptr(), b, h, w, xk.shape[-1],
                               e, cout, int(use_residual), tile, ops.ncp, ops.wsl,
                               current_stream_handle(dev))
    if code:
        _build.check(lib, code, f"fused_inverted_residual wide (B, H, W, C, E, Cout) = ({b}, "
                                f"{h}, {w}, {c}, {e}, {cout}), tile {ops.tile}, passes of "
                                f"{ops.ncp}")
    passes = -(-cout // ops.ncp)
    LAUNCHES["inverted_residual_wide"] += passes
    LAUNCHES["fused_inverted_residual"] += passes
    return out


def fused_inverted_residual(x, wexp, bexp, kdw, bdw, wred, bred, *, stride: int = 1,
                            use_residual: bool = False,
                            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x (B, H, W, C); wexp (C, E), bexp (E,), kdw (3, 3, E), bdw (E,), wred
    (E, Cout), bred (Cout,), BN folded -> (B, H/stride, W/stride, Cout) in the
    compute dtype. A residual takes stride 1."""
    cd = resolve_dtype(compute_dtype)
    if stride == 2 and use_residual:
        raise ValueError("fused_inverted_residual: a stride-2 block has no residual (its "
                         "output is (H/2, W/2))")
    x = x.to(cd)
    if x.device.type == "cpu":
        return fused_ir_plain(x, wexp.to(cd), bexp.float(), kdw, bdw.float(), wred.to(cd),
                              bred.float(), stride=stride, use_residual=use_residual)
    if stride not in (1, 2) or cd not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_inverted_residual: the CUDA kernels run bf16 or f32 at stride "
                         f"1 or 2, got {cd} at stride {stride}")
    if stride == 2:
        return fused_ir_s2_cuda(x, ir_s2_operands(wexp, bexp, kdw, bdw, wred, bred, cd))
    if cd == torch.float32:
        return fused_ir_f32_cuda(x, ir_f32_operands(wexp, bexp, kdw, bdw, wred, bred),
                                 use_residual=use_residual)
    return fused_ir_cuda(x, ir_operands(wexp, bexp, kdw, bdw, wred, bred),
                         use_residual=use_residual)


def folded_conv_weights(conv):
    """(kernel, bias) of a ``ConvBNAct`` with its folded BN absorbed: the scale
    into the kernel's output channels, the bias kept apart."""
    k = conv.kernel
    if conv.bn is not None:
        return k * conv.bn.scale, conv.bn.bias
    return k, torch.zeros(k.shape[-1], dtype=torch.float32, device=k.device)


def _folded(params):
    wexp, bexp = folded_conv_weights(params.expand_1x1)
    kdw, bdw = folded_conv_weights(params.conv_3x3)
    wred, bred = folded_conv_weights(params.reduce_1x1)
    e = wexp.shape[-1]
    return (wexp.reshape(wexp.shape[-2], e), bexp, kdw.reshape(3, 3, e), bdw,
            wred.reshape(e, wred.shape[-1]), bred)


def block_operands(params, compute_dtype=torch.bfloat16):
    """The block's operands for the kernel of its stride and ``compute_dtype``
    (:func:`ir_operands` at stride 1 and bf16, :class:`IRTCOperands` at f32
    and at stride 2), kept on its params: made at its first
    CUDA call and again when any of its weights or BN vectors is another
    tensor or was written in place (the key holds each tensor's storage,
    shape, stride and version counter, and the entry holds the tensors)."""
    cd = resolve_dtype(compute_dtype)
    f32 = cd == torch.float32
    if params.conv_3x3.stride == 2:
        attr = "_gxt_ir_s2_f32_operands" if f32 else "_gxt_ir_s2_operands"
        make = functools.partial(ir_s2_operands, compute_dtype=cd)
    else:
        attr, make = (("_gxt_ir_f32_operands", ir_f32_operands) if f32
                      else ("_gxt_ir_operands", ir_operands))
    tensors = []
    for conv in (params.expand_1x1, params.conv_3x3, params.reduce_1x1):
        tensors += [conv.kernel] + ([conv.bn.scale, conv.bn.bias] if conv.bn is not None else [])
    key = tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device, t._version)
                for t in tensors)
    hit = getattr(params, attr, None)
    if hit is None or hit[0] != key:
        hit = (key, make(*_folded(params)), tensors)
        object.__setattr__(params, attr, hit)
    return hit[1]


@torch.library.custom_op("gxt::inverted_residual_f32", mutates_args=())
def inverted_residual_f32_op(x: torch.Tensor, wexp: torch.Tensor, bexp: torch.Tensor,
                             kdw: torch.Tensor, bdw: torch.Tensor, wred: torch.Tensor,
                             bred: torch.Tensor, use_residual: bool,
                             stride: int = 1) -> torch.Tensor:
    """What a traced f32 program calls (stride 1 or 2, BN folded, the
    operands of :func:`fused_inverted_residual`). This body is the CPU
    implementation: the plain version."""
    return fused_ir_plain(x, wexp, bexp, kdw, bdw, wred, bred, stride=stride,
                          use_residual=use_residual)


@inverted_residual_f32_op.register_kernel("cuda")
def _inverted_residual_f32_op_cuda(x, wexp, bexp, kdw, bdw, wred, bred, use_residual, stride=1):
    return fused_inverted_residual(x, wexp, bexp, kdw, bdw, wred, bred, stride=stride,
                                   use_residual=use_residual, compute_dtype=torch.float32)


@inverted_residual_f32_op.register_fake
def _inverted_residual_f32_op_fake(x, wexp, bexp, kdw, bdw, wred, bred, use_residual, stride=1):
    return x.new_empty((x.shape[0], x.shape[1] // stride, x.shape[2] // stride, wred.shape[1]))


def inverted_residual_fused(params, x: torch.Tensor, *,
                            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Run an ``InvertedResidualParams`` through :func:`fused_inverted_residual`
    (on the card with the operands :func:`block_operands` keeps: stride 1 on
    the strip, wide or f32 kernel, stride 2 on the stride-2 kernel). Under
    ``torch.export`` an f32 block is the custom op
    ``gxt::inverted_residual_f32`` (:func:`inverted_residual_f32_op`, the
    stride among its arguments), whose CUDA implementation launches the f32
    or the stride-2 kernel."""
    cd = resolve_dtype(compute_dtype)
    stride = params.conv_3x3.stride
    if torch.compiler.is_compiling() and cd == torch.float32 and stride in (1, 2):
        return inverted_residual_f32_op(x.to(cd), *_folded(params), params.use_residual, stride)
    if x.device.type == "cpu" or stride not in (1, 2) or cd not in (torch.bfloat16,
                                                                    torch.float32):
        return fused_inverted_residual(x, *_folded(params), stride=stride,
                                       use_residual=params.use_residual, compute_dtype=cd)
    if stride == 2:
        return fused_ir_s2_cuda(x.to(cd), block_operands(params, cd),
                                use_residual=params.use_residual)
    launch = fused_ir_f32_cuda if cd == torch.float32 else fused_ir_cuda
    return launch(x.to(cd), block_operands(params, cd), use_residual=params.use_residual)
