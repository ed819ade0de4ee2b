"""Q4_K-class super-block quantization (the k-quant family), in numpy.

The classic 4-bit formats (q4_0/q4_1) spend 2 extra bits/weight on per-32-block
f32 scales and pick their grids by round-to-nearest. The k-quant answer is a
*super-block*: sub-block scales are themselves quantized against one
scale-of-scales, and the sub-block affine grid is chosen by a weighted error
search. This module is the port's own copy of the JAX package's numpy
quantizer (``quant/kquant.py`` there), result for result:

* sub-block = 32 rows along K (the classic formats' block);
* super-block = 8 sub-blocks = 256 K rows;
* sub-block scale/min codes are stored as full uint8 (0..255) planes in the
  ``(Kp//32, Np)`` layout the classic formats use for their f32 scales;
* per super-block, two f32 rows in a ``(2*ns, Np)`` plane stored as stacked
  halves: rows ``[0, ns)`` hold ``d`` (the scale-of-scales), rows
  ``[ns, 2*ns)`` hold ``m`` (the min-scale).

Dequantization::

    eff_d[b]  = supers[b//8]      * scale_code[b]       # b = sub-block index
    eff_m[b]  = supers[ns + b//8] * min_code[b]
    w[32b+i]  = q[32b+i] * eff_d[b] - eff_m[b]          # q in [0, 15]

(The min is stored as a subtracted non-negative magnitude: the search clamps
the block minimum to <= 0, so all-positive blocks anchor at 0.)

Storage: 4 (codes) + 0.25 (scale codes) + 0.25 (min codes) + 0.125 (two f16
rows / 256 weights) = 4.625 bits/weight in a checkpoint file.

The quantizer sweeps candidate grids per 32-block, refits (d, m) by weighted
least squares given the rounded codes, keeps the lowest-error grid, quantizes
the per-block (d, m) to uint8 codes against the super-block maxima, and
re-rounds the weight codes against the *decoded* grid (so code rounding sees
the exact scales inference will use). Importance defaults to x^2 + mean(x^2);
callers can pass calibration importance instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

SUB = 32        # rows per sub-block (= qtensor.BLOCK)
GROUP = 8       # sub-blocks per super-block
SUPER = SUB * GROUP  # 256 rows per super-block

# grid-candidate sweep: initial inverse scale 15/(max-min) scanned over
# nearby factors in steps of 0.05 (ggml's make_qkx2_quants idea at half its step)
_CANDIDATE_FACTORS = np.arange(-1.0, 1.001, 0.05) + 15.0


def _weighted_affine_fit(x: np.ndarray, q: np.ndarray, w: np.ndarray):
    """Weighted least-squares (d, m) for x ~ q*d + m, per block.

    x, q, w: (nb, SUB, N). Returns d, m of shape (nb, N). Degenerate blocks
    (constant q) fall back to d=0, m=weighted mean.
    """
    sw = np.sum(w, axis=1)
    swq = np.sum(w * q, axis=1)
    swqq = np.sum(w * q * q, axis=1)
    swx = np.sum(w * x, axis=1)
    swqx = np.sum(w * q * x, axis=1)
    det = swqq * sw - swq * swq
    ok = det > 1e-12
    safe = np.where(ok, det, 1.0)
    d = np.where(ok, (sw * swqx - swq * swx) / safe, 0.0)
    m = np.where(ok, (swqq * swx - swq * swqx) / safe,
                 swx / np.maximum(sw, 1e-12))
    return d, m


def _weighted_err(x, q, d, m, w):
    r = q * d[:, None, :] + m[:, None, :] - x
    return np.sum(w * r * r, axis=1)


def quantize_q4_k_blocks(
    w_blocks: np.ndarray, importance: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Quantize (nb, 32, Np) float blocks to the q4_k planes.

    Returns ``(q, scale_codes, min_codes, supers)``:
    q (nb, 32, Np) uint8 in [0, 15]; scale/min codes (nb, Np) uint8;
    supers (2*ceil(nb/8), Np) f32, stacked halves (d rows then m rows).

    ``importance``: optional non-negative weights, same shape as w_blocks or
    broadcastable: defaults to x^2 + mean(x^2) (ggml's sigma2-regularized
    x^2 weighting: large weights matter more, but zero weights still count).
    """
    x = w_blocks.astype(np.float64)
    nb, sub, n = x.shape
    assert sub == SUB

    sigma2 = np.mean(x * x, axis=1, keepdims=True)
    if importance is None:
        imp = x * x + sigma2
    else:
        # ggml's imatrix combination for q4_K: calibration importance times
        # sqrt(sigma2 + x^2): activation moments say which rows matter,
        # the local term keeps large weights from being sacrificed
        imp = np.broadcast_to(np.asarray(importance, np.float64), x.shape)
        imp = imp * np.sqrt(x * x + sigma2)
        # guard all-zero importance blocks (would make the fit singular)
        zero = np.sum(imp, axis=1, keepdims=True) <= 0
        imp = np.where(zero, 1.0, imp)

    mn = np.minimum(x.min(axis=1), 0.0)          # (nb, N), clamp to <= 0
    mx = np.maximum(x.max(axis=1), 0.0)
    rng = mx - mn

    best_err = np.full((nb, n), np.inf)
    best_d = np.zeros((nb, n))
    best_m = np.zeros((nb, n))

    with np.errstate(divide="ignore", invalid="ignore"):
        for f in _CANDIDATE_FACTORS:
            inv = np.where(rng > 0, f / np.where(rng > 0, rng, 1.0), 0.0)
            q = np.clip(np.rint((x - mn[:, None, :]) * inv[:, None, :]), 0, 15)
            d, m = _weighted_affine_fit(x, q, imp)
            # the stored min is subtracted as a non-negative magnitude
            m = np.minimum(m, 0.0)
            # refit d alone where the min clamp moved m (weighted, m fixed)
            d2 = np.sum(imp * q * (x - m[:, None, :]), axis=1) / np.maximum(
                np.sum(imp * q * q, axis=1), 1e-12
            )
            d = np.where(m == 0.0, d2, d)
            d = np.maximum(d, 0.0)
            err = _weighted_err(x, q, d, m, imp)
            better = err < best_err
            best_err = np.where(better, err, best_err)
            best_d = np.where(better, d, best_d)
            best_m = np.where(better, m, best_m)

    mm = -best_m  # stored magnitude, >= 0

    # ---- quantize the per-block (d, mm) against super-block maxima --------
    ns = (nb + GROUP - 1) // GROUP
    pad = ns * GROUP - nb
    if pad:
        best_d = np.pad(best_d, ((0, pad), (0, 0)))
        mm = np.pad(mm, ((0, pad), (0, 0)))
    dg = best_d.reshape(ns, GROUP, n)
    mg = mm.reshape(ns, GROUP, n)
    # supers round to f16-REPRESENTABLE values here, before any code
    # quantizes against them: checkpoint files then store the supers plane
    # as lossless f16, and in-memory f32 planes dequantize bit-identically
    # to a save/load round trip
    d_super = np.float16(dg.max(axis=1) / 255.0).astype(np.float64)  # (ns, N)
    m_super = np.float16(mg.max(axis=1) / 255.0).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        d_inv = np.where(d_super > 0, 1.0 / np.where(d_super > 0, d_super, 1.0), 0.0)
        m_inv = np.where(m_super > 0, 1.0 / np.where(m_super > 0, m_super, 1.0), 0.0)
    sc = np.clip(np.rint(dg * d_inv[:, None, :]), 0, 255).astype(np.uint8)
    mc = np.clip(np.rint(mg * m_inv[:, None, :]), 0, 255).astype(np.uint8)

    # decoded grid the kernel will actually use
    eff_d = (d_super[:, None, :] * sc).reshape(ns * GROUP, n)[:nb]
    eff_m = (m_super[:, None, :] * mc).reshape(ns * GROUP, n)[:nb]

    # ---- final code rounding against the decoded grid ---------------------
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_d = np.where(eff_d > 0, 1.0 / np.where(eff_d > 0, eff_d, 1.0), 0.0)
    q = np.clip(
        np.rint((x + eff_m[:, None, :]) * inv_d[:, None, :]), 0, 15
    ).astype(np.uint8)

    supers = np.concatenate(
        [d_super.astype(np.float32), m_super.astype(np.float32)], axis=0
    )
    return q, sc.reshape(ns * GROUP, n)[:nb], mc.reshape(ns * GROUP, n)[:nb], supers


def effective_scales_np(
    scale_codes: np.ndarray, min_codes: np.ndarray, supers: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode (eff_d, eff_m) f32 planes of shape (nb, N) from stored codes."""
    nb, n = scale_codes.shape
    ns = supers.shape[0] // 2
    d_super = supers[:ns].astype(np.float32)
    m_super = supers[ns:].astype(np.float32)
    group = np.minimum(np.arange(nb) // GROUP, ns - 1)
    eff_d = d_super[group] * scale_codes.astype(np.float32)
    eff_m = m_super[group] * min_codes.astype(np.float32)
    return eff_d, eff_m
