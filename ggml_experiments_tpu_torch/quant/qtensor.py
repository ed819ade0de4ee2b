"""GGML-class block weight-only quantization, holding torch tensors.

Blocks of 32 consecutive weights along the *reduction* dimension share one
scale (weight-only):

* **q8_0**: ``d = absmax/127``, ``q = rint(x/d)`` stored int8, ``x ~ q*d``.
* **q4_0**: signed max ``m`` (value of largest magnitude), ``d = m/-8``,
  ``q = clamp(rint(x/d) + 8, 0, 15)`` as packed nibbles, ``x ~ (q-8)*d``.
* **q4_1**: ``m = min``, ``d = (max-min)/15``, ``x ~ q*d + m``.
* **q5_0**: ``d = signed_absmax/-16``, ``x ~ (q-16)*d``; the fifth bit rides
  in a separate bit-plane.
* **q5_1**: ``d = (max-min)/31``, ``x ~ q*d + m``.
* **q4_k**: super-block k-quant (``quant/kquant.py``): 4-bit codes, uint8
  sub-block scale/min codes against per-256-row scale-of-scales rows.

A weight ``W[K, N]`` (in-features first, ``y = x @ W``) is stored as

* ``codes``:  int8 ``(Kp, Np)`` (q8_0) or packed uint8 ``(Kp//2, Np)`` (all
  nibble formats: byte ``i`` of a 32-row block holds unpacked rows
  ``(32b+i, 32b+16+i)`` as (low, high) nibbles, block-local)
* ``scales``: float32 ``(Kp//32, Np)``; q4_k: uint8 sub-block scale codes
* ``mins``:   float32 ``(Kp//32, Np)`` q4_1/q5_1; uint8 min codes for q4_k
* ``hibits``: uint8 ``(Kp//8, Np)`` q5_0/q5_1: block-local row ``t`` lives in
  byte ``t % 4`` at bit ``t // 4``
* ``supers``: float32 ``(2*ceil(Kp/256), Np)`` q4_k: scale-of-scales rows,
  then min-scale rows (stacked halves)

with K padded to the 32-row block and N to the 128-lane boundary: the JAX
package's layout, so its planes convert with no reshuffle. Quantization runs
in numpy on the host (bit-identical to the JAX package's numpy codec); the
planes are then placed on the requested device. The unpack and dequantize
functions run on the planes' device; they are the building blocks of the
kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ggml_experiments_tpu_torch.device import DeviceLike, resolve_device
from ggml_experiments_tpu_torch.pytree import register_params

BLOCK = 32  # weights per scale block, along the reduction dim
LANE = 128  # N is padded to this

QTYPES = ("q8_0", "q4_0", "q4_1", "q5_0", "q5_1", "q4_k")
# bits per weight (codes + bit-plane), excluding per-block scale/min rows
QTYPE_BITS = {"q8_0": 8, "q4_0": 4, "q4_1": 4, "q5_0": 5, "q5_1": 5, "q4_k": 4}
# total stored bits/weight including the scale planes
QTYPE_TOTAL_BITS = {
    "q8_0": 8 + 1.0,          # + f32 scale / 32
    "q4_0": 4 + 1.0,
    "q4_1": 4 + 2.0,          # + f32 scale + f32 min / 32
    "q5_0": 5 + 1.0,
    "q5_1": 5 + 2.0,
    "q4_k": 4 + 0.25 + 0.25 + 0.125,  # u8 scale + u8 min / 32 + 2 f16 / 256
}


# per format: plane name -> (dtype, K rows folded into one plane row)
PLANE_SPECS = {
    "q8_0": {"codes": (torch.int8, 1), "scales": (torch.float32, 32)},
    "q4_0": {"codes": (torch.uint8, 2), "scales": (torch.float32, 32)},
    "q4_1": {"codes": (torch.uint8, 2), "scales": (torch.float32, 32),
             "mins": (torch.float32, 32)},
    "q5_0": {"codes": (torch.uint8, 2), "scales": (torch.float32, 32),
             "hibits": (torch.uint8, 8)},
    "q5_1": {"codes": (torch.uint8, 2), "scales": (torch.float32, 32),
             "mins": (torch.float32, 32), "hibits": (torch.uint8, 8)},
    "q4_k": {"codes": (torch.uint8, 2), "scales": (torch.uint8, 32),
             "mins": (torch.uint8, 32), "supers": (torch.float32, 128)},
}
PLANE_NAMES = ("codes", "scales", "mins", "hibits", "supers")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _check_qtype(qtype: str) -> None:
    if qtype not in QTYPES:
        raise ValueError(f"unknown qtype {qtype!r} (expected one of {QTYPES})")


@dataclasses.dataclass
class QTensor:
    """A block-quantized 2-D weight."""

    codes: torch.Tensor     # int8 (Kp, Np) for q8_0; uint8 (Kp//2, Np) nibble-packed
    scales: torch.Tensor    # f32 (Kp//32, Np); q4_k: uint8 sub-block scale codes
    shape: Tuple[int, int]  # logical (K, N)
    qtype: str = "q8_0"
    mins: Optional[torch.Tensor] = None    # f32 (Kp//32, Np) q4_1/q5_1; uint8 q4_k
    hibits: Optional[torch.Tensor] = None  # uint8 (Kp//8, Np), q5_0/q5_1
    supers: Optional[torch.Tensor] = None  # f32 (2*ceil(Kp/256), Np), q4_k only
    # dequantized planes by dtype, and the CUDA kernel's launch arguments
    # under "launch", built on first use by quant.qmatmul
    dense: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def k(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def kp(self) -> int:
        return self.scales.shape[0] * BLOCK

    @property
    def np_(self) -> int:
        return self.codes.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def planes(self):
        """The stored planes that are present, in field order."""
        return [p for p in (getattr(self, name) for name in PLANE_NAMES) if p is not None]

    def check_planes(self) -> None:
        """Raise unless exactly the format's planes are present, each with the
        format's dtype and the padded shape that fits the logical one."""
        _check_qtype(self.qtype)
        k, n = self.shape
        if self.scales is None or self.scales.dim() != 2:
            raise ValueError(f"not {self.qtype} planes: scales missing or not 2-D")
        kp, np_ = self.kp, self.scales.shape[1]
        if np_ % LANE or not (0 < n <= np_) or not (kp - BLOCK < k <= kp):
            raise ValueError(f"not {self.qtype} planes: scales {tuple(self.scales.shape)} "
                             f"for logical ({k}, {n})")
        for name in PLANE_NAMES:
            t = getattr(self, name)
            spec = PLANE_SPECS[self.qtype].get(name)
            if spec is None:
                if t is not None:
                    raise ValueError(f"not {self.qtype} planes: unexpected {name}")
                continue
            dtype, fold = spec
            rows = 2 * (-(-kp // 256)) if name == "supers" else kp // fold
            if t is None or t.dtype != dtype or tuple(t.shape) != (rows, np_):
                got = "missing" if t is None else f"{t.dtype}{tuple(t.shape)}"
                raise ValueError(f"not {self.qtype} planes: {name} {got}, want "
                                 f"{dtype}({rows}, {np_})")

    @property
    def nbytes(self) -> int:
        """Bytes of the padded planes as they lie in device memory."""
        return sum(p.numel() * p.element_size() for p in self.planes())

    @property
    def bits_per_weight(self) -> float:
        """In-memory bits per LOGICAL weight (padded planes over logical
        elements); lane padding inflates it for narrow tensors."""
        return 8.0 * self.nbytes / (self.shape[0] * self.shape[1])

    @property
    def stored_nbytes(self) -> int:
        """Bytes of the LOGICAL-region planes: what checkpoint files store
        (padding trimmed; q4_k supers as f16)."""
        planes = to_numpy_blocks(self)
        n = sum(p.nbytes for p in planes if p is not None)
        if self.qtype == "q4_k":
            n -= planes[3].nbytes // 2  # f32 in memory, f16 on disk
        return n

    @property
    def stored_bits_per_weight(self) -> float:
        return 8.0 * self.stored_nbytes / (self.shape[0] * self.shape[1])

    def dequantize(self) -> torch.Tensor:
        return dequantize(self)


# the planes are the leaves; the format and logical shape the context; the cache dropped
register_params(QTensor, static=("shape", "qtype"), drop=("dense",))


# ---------------------------------------------------------------------------
# host-side (numpy) quantizers
# ---------------------------------------------------------------------------

def _blockify(w: np.ndarray):
    """Pad (K, N) fp weight to (Kp, Np) and reshape to (nb, BLOCK, Np)."""
    k, n = w.shape
    kp, np_ = _round_up(k, BLOCK), _round_up(n, LANE)
    w = np.pad(w.astype(np.float32), ((0, kp - k), (0, np_ - n)))
    return w.reshape(kp // BLOCK, BLOCK, np_), kp, np_


def _quantize_q8_0_arrays(w_blocks: np.ndarray):
    absmax = np.max(np.abs(w_blocks), axis=1)             # (nb, Np)
    d = (absmax / 127.0).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    q = np.rint(w_blocks * inv[:, None, :])
    q = np.clip(q, -127, 127).astype(np.int8)
    return q, d


def _signed_absmax(w_blocks: np.ndarray) -> np.ndarray:
    """Per block, the signed value of the largest-magnitude weight."""
    amax_idx = np.argmax(np.abs(w_blocks), axis=1)         # (nb, Np)
    return np.take_along_axis(w_blocks, amax_idx[:, None, :], axis=1)[:, 0, :]


def _quantize_q4_0_arrays(w_blocks: np.ndarray):
    # ggml Q4_0: m = signed value of the largest-magnitude weight; d = m / -8
    d = (_signed_absmax(w_blocks) / -8.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(np.rint(w_blocks * inv[:, None, :]) + 8.0, 0.0, 15.0)
    return q.astype(np.uint8), d


def _quantize_q5_0_arrays(w_blocks: np.ndarray):
    # ggml Q5_0: the same sign-flip trick at 5 bits; d = signed_absmax / -16
    d = (_signed_absmax(w_blocks) / -16.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(np.rint(w_blocks * inv[:, None, :]) + 16.0, 0.0, 31.0)
    return q.astype(np.uint8), d


def _quantize_offset_arrays(w_blocks: np.ndarray, levels: int):
    # ggml Q4_1/Q5_1: asymmetric per-block affine, m = min, d = (max-min)/L
    mn = w_blocks.min(axis=1).astype(np.float32)           # (nb, Np)
    mx = w_blocks.max(axis=1).astype(np.float32)
    d = ((mx - mn) / levels).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    q = np.clip(np.rint((w_blocks - mn[:, None, :]) * inv[:, None, :]), 0.0, levels)
    return q.astype(np.uint8), d, mn


def _pack_nibbles(q3: np.ndarray) -> np.ndarray:
    """(nb, 32, Np) values 0..15 -> block-local nibble-packed (Kp//2, Np)."""
    nb, _, np_ = q3.shape
    packed = q3[:, : BLOCK // 2] | (q3[:, BLOCK // 2:] << 4)
    return packed.reshape(nb * BLOCK // 2, np_).astype(np.uint8)


def _pack_hibits(hi3: np.ndarray) -> np.ndarray:
    """(nb, 32, Np) bits 0/1 -> bit-plane (Kp//8, Np): block-local row ``t``
    goes to byte ``t % 4``, bit ``t // 4``."""
    nb, _, np_ = hi3.shape
    hb = np.zeros((nb, 4, np_), np.uint8)
    for t in range(BLOCK):
        hb[:, t % 4] |= (hi3[:, t].astype(np.uint8) << (t // 4))
    return hb.reshape(nb * 4, np_)


def _quantize_planes(w: np.ndarray, qtype: str, importance=None) -> dict:
    """The padded numpy planes of ``w`` (K, N) under ``qtype``."""
    k, n = w.shape
    w_blocks, kp, np_ = _blockify(w)
    if qtype == "q4_k":
        from ggml_experiments_tpu_torch.quant import kquant

        imp = None
        if importance is not None:
            imp = np.asarray(importance, np.float64)
            if imp.ndim == 1:
                imp = imp[:, None] * np.ones((1, n))
            imp = np.pad(imp, ((0, kp - k), (0, np_ - n)))
            imp = imp.reshape(kp // BLOCK, BLOCK, np_)
        q, sc, mc, supers = kquant.quantize_q4_k_blocks(w_blocks, imp)
        return dict(codes=_pack_nibbles(q.reshape(kp // BLOCK, BLOCK, np_)), scales=sc,
                    mins=mc, supers=supers)
    if qtype == "q8_0":
        q, d = _quantize_q8_0_arrays(w_blocks)
        return dict(codes=q.reshape(kp, np_), scales=d)
    if qtype == "q4_0":
        q, d = _quantize_q4_0_arrays(w_blocks)
        return dict(codes=_pack_nibbles(q), scales=d)
    if qtype == "q4_1":
        q, d, mn = _quantize_offset_arrays(w_blocks, 15)
        return dict(codes=_pack_nibbles(q), scales=d, mins=mn)
    if qtype == "q5_0":
        q, d = _quantize_q5_0_arrays(w_blocks)
        return dict(codes=_pack_nibbles(q & 0xF), scales=d, hibits=_pack_hibits(q >> 4))
    q, d, mn = _quantize_offset_arrays(w_blocks, 31)  # q5_1
    return dict(codes=_pack_nibbles(q & 0xF), scales=d, mins=mn, hibits=_pack_hibits(q >> 4))


def _from_planes(planes: dict, shape, qtype: str, dev) -> QTensor:
    t = {name: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for name, a in planes.items()}
    return QTensor(shape=(int(shape[0]), int(shape[1])), qtype=qtype, **t)


def quantize(w, qtype: str = "q8_0", *, importance=None,
             device: DeviceLike = None) -> QTensor:
    """Quantize a float ``(K, N)`` weight (numpy or tensor) into a QTensor.

    ``importance``: optional non-negative per-row ``(K,)`` or full ``(K, N)``
    error weights for the q4_k grid search; ignored by the other formats.
    """
    _check_qtype(qtype)
    dev = resolve_device(device)
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    w = np.asarray(w)
    if w.ndim != 2:
        raise ValueError(f"QTensor quantizes 2-D weights, got shape {w.shape}")
    return _from_planes(_quantize_planes(w, qtype, importance), w.shape, qtype, dev)


# ---------------------------------------------------------------------------
# unpack / dequantize, on the planes' device
# ---------------------------------------------------------------------------

def unpack_nibbles(codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Unpack uint8 nibble-packed (Kp//2, Np) -> (Kp, Np) values in [0, 15].
    Widened to int32 before any arithmetic, so nothing wraps."""
    half, np_ = codes.shape
    c3 = codes.reshape((2 * half) // BLOCK, BLOCK // 2, np_).to(torch.int32)
    return torch.cat([c3 & 0xF, c3 >> 4], dim=1).reshape(2 * half, np_).to(dtype)


def unpack_q4(codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Unpack q4_0-packed codes -> (Kp, Np) values in [-8, 7]."""
    return (unpack_nibbles(codes, torch.int32) - 8).to(dtype)


def unpack_hibits(hibits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Unpack the q5 bit-plane (Kp//8, Np) -> (Kp, Np) values in {0, 1}:
    part ``i`` of the concatenation lands block-local rows ``4i..4i+3``."""
    rows, np_ = hibits.shape
    b = hibits.reshape(rows // 4, 4, np_).to(torch.int32)
    parts = [(b >> i) & 1 for i in range(8)]
    return torch.cat(parts, dim=1).reshape(rows * 8, np_).to(dtype)


def effective_scales(qt: QTensor):
    """q4_k: the f32 (eff_d, eff_m) planes of shape (Kp//32, Np), each its own
    f32 product of a sub-block code and its super-block row."""
    nb = qt.scales.shape[0]
    ns = qt.supers.shape[0] // 2
    group = torch.clamp(torch.arange(nb, device=qt.device) // 8, max=ns - 1)
    eff_d = qt.supers[:ns][group] * qt.scales.to(torch.int32).float()
    eff_m = qt.supers[ns:][group] * qt.mins.to(torch.int32).float()
    return eff_d, eff_m


def dequantize_padded(qt: QTensor) -> torch.Tensor:
    """f32 ``(Kp, Np)`` plane. Every format multiplies, rounds, then adds (or
    subtracts) its offset: two roundings, as the JAX package's decoders."""
    _check_qtype(qt.qtype)
    if qt.qtype == "q8_0":
        q = qt.codes.float()
    elif qt.qtype == "q4_0":
        q = unpack_q4(qt.codes)
    else:
        q = unpack_nibbles(qt.codes)
        if qt.hibits is not None:
            q = q + 16.0 * unpack_hibits(qt.hibits)
        if qt.qtype == "q5_0":
            q = q - 16.0
    kp, np_ = q.shape
    q3 = q.reshape(kp // BLOCK, BLOCK, np_)
    if qt.qtype == "q4_k":
        eff_d, eff_m = effective_scales(qt)
        w = q3 * eff_d[:, None, :] - eff_m[:, None, :]
    else:
        w = q3 * qt.scales[:, None, :]
        if qt.mins is not None:
            w = w + qt.mins[:, None, :]
    return w.reshape(kp, np_)


def dequantize(qt: QTensor) -> torch.Tensor:
    """Dequantize to float32 ``(K, N)`` on the QTensor's device."""
    return dequantize_padded(qt)[: qt.k, : qt.n]


def quantization_error(w, qtype: str = "q8_0") -> float:
    """Max-abs dequantization error of ``w`` under ``qtype``."""
    w = np.asarray(w, np.float32)
    deq = dequantize(quantize(w, qtype, device="cpu")).numpy()
    return float(np.max(np.abs(deq - w)))


# ---------------------------------------------------------------------------
# logical-region planes, as the file formats store them
# ---------------------------------------------------------------------------

def to_numpy_blocks(qt: QTensor):
    """Export logical-region planes as numpy, unpadded along N and K.

    Returns ``(codes, scales)`` for q8_0/q4_0, ``(codes, scales, mins,
    hibits)`` for q4_1/q5_x and ``(codes, scales, mins, supers)`` for q4_k
    (absent planes are None)."""
    k, n = qt.shape
    nb = (k + BLOCK - 1) // BLOCK

    def cut(t, rows):
        return None if t is None else t[:rows, :n].cpu().numpy()

    scales = cut(qt.scales, nb)
    codes = cut(qt.codes, nb * BLOCK if qt.qtype == "q8_0" else (nb * BLOCK) // 2)
    if qt.qtype in ("q8_0", "q4_0"):
        return codes, scales
    mins = cut(qt.mins, nb)
    if qt.qtype == "q4_k":
        return codes, scales, mins, cut(qt.supers, 2 * ((nb + 7) // 8))
    return codes, scales, mins, cut(qt.hibits, nb * 4)


def from_numpy_blocks(codes, scales, shape, qtype: str, mins=None, hibits=None,
                      supers=None, *, device: DeviceLike = None) -> QTensor:
    """Rebuild a padded QTensor from logical-region blocks (inverse of
    :func:`to_numpy_blocks`). Whole padded blocks and lane-padding columns
    decode to zero: q4_0 pads codes with 0x88 (nibble 8 is q = 0) and scales
    with 0, every other format pads with zeros. The K padding inside a
    partial last block shares that block's scale and min, so consumers guard
    ``k < K``."""
    _check_qtype(qtype)
    dev = resolve_device(device)
    k, n = (int(d) for d in shape)
    kp, np_ = _round_up(k, BLOCK), _round_up(n, LANE)
    nb = kp // BLOCK

    def pad(a, rows, dtype, fill=0):
        out = np.full((rows, np_), fill, dtype)
        out[: a.shape[0], :n] = a
        return out

    planes = {}
    if qtype == "q4_k":
        planes["codes"] = pad(codes, kp // 2, np.uint8)
        planes["scales"] = pad(scales, nb, np.uint8)
        planes["mins"] = pad(mins, nb, np.uint8)
        planes["supers"] = pad(supers, 2 * ((nb + 7) // 8), np.float32)
        return _from_planes(planes, (k, n), qtype, dev)
    planes["scales"] = pad(scales, nb, np.float32)
    if qtype == "q8_0":
        planes["codes"] = pad(codes, kp, np.int8)
    else:
        planes["codes"] = pad(codes, kp // 2, np.uint8, 0x88 if qtype == "q4_0" else 0)
    if qtype in ("q4_1", "q5_1"):
        planes["mins"] = pad(mins, nb, np.float32)
    if qtype in ("q5_0", "q5_1"):
        planes["hibits"] = pad(hibits, nb * 4, np.uint8)
    return _from_planes(planes, (k, n), qtype, dev)
