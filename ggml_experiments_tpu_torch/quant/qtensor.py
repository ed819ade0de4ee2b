"""Q8_0 block weight-only quantization, holding torch tensors.

Blocks of 32 consecutive weights along the *reduction* dimension share one
f32 scale: ``d = absmax/127``, ``q = rint(x/d)`` stored int8, ``x ~ q*d``
(ggml's Q8_0). A weight ``W[K, N]`` (in-features first, ``y = x @ W``) is
stored as

* ``codes``:  int8 ``(Kp, Np)``
* ``scales``: float32 ``(Kp//32, Np)``

with K padded to the 32-row block and N to the 128-lane boundary, the same
layout as the JAX package, so its planes convert with no reshuffle.
Quantization runs in numpy on the host (bit-identical to the JAX package's
numpy codec); the planes are then placed on the requested device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ggml_experiments_tpu_torch.device import DeviceLike, resolve_device

BLOCK = 32  # weights per scale block, along the reduction dim
LANE = 128  # N is padded to this

QTYPES = ("q8_0",)
_UNPORTED = ("q4_0", "q4_1", "q5_0", "q5_1", "q4_k")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _unported(qtype: str) -> NotImplementedError:
    return NotImplementedError(
        f"qtype {qtype!r} is not ported yet (ROADMAP.md, 'Port: still to "
        f"port', item 1: the other qtypes); only q8_0 is")


@dataclasses.dataclass
class QTensor:
    """A q8_0 block-quantized 2-D weight."""

    codes: torch.Tensor     # int8 (Kp, Np)
    scales: torch.Tensor    # f32 (Kp//32, Np)
    shape: Tuple[int, int]  # logical (K, N)
    qtype: str = "q8_0"
    # dequantized planes by dtype, built on first use by quant.qmatmul
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

    def dequantize(self) -> torch.Tensor:
        return dequantize(self)


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


def quantize(w, qtype: str = "q8_0", *, device: DeviceLike = None) -> QTensor:
    """Quantize a float ``(K, N)`` weight (numpy or tensor) into a QTensor."""
    if qtype in _UNPORTED:
        raise _unported(qtype)
    if qtype != "q8_0":
        raise ValueError(f"unknown qtype {qtype!r} (expected one of {QTYPES})")
    dev = resolve_device(device)
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    w = np.asarray(w)
    if w.ndim != 2:
        raise ValueError(f"QTensor quantizes 2-D weights, got shape {w.shape}")
    k, n = w.shape
    w_blocks, kp, np_ = _blockify(w)
    q, d = _quantize_q8_0_arrays(w_blocks)
    return QTensor(
        codes=torch.from_numpy(q.reshape(kp, np_)).to(dev),
        scales=torch.from_numpy(d).to(dev),
        shape=(k, n),
    )


def dequantize_padded(qt: QTensor) -> torch.Tensor:
    """f32 ``(Kp, Np)`` plane: codes * scales, one rounding per weight."""
    kp, np_ = qt.codes.shape
    w = qt.codes.float().reshape(kp // BLOCK, BLOCK, np_) * qt.scales[:, None, :]
    return w.reshape(kp, np_)


def dequantize(qt: QTensor) -> torch.Tensor:
    """Dequantize to float32 ``(K, N)`` on the QTensor's device."""
    if qt.qtype != "q8_0":
        raise _unported(qt.qtype)
    return dequantize_padded(qt)[: qt.k, : qt.n]
