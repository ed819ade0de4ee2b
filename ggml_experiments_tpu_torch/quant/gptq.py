"""GPTQ: sequential error-compensated quantization onto the q4_k and q8_0 grids.

Round to nearest treats every weight on its own; GPTQ (Frantar et al., 2022)
rounds the input rows of ``W (K, N)`` in order and, after rounding row ``i``,
pushes its rounding error onto the rows not yet rounded through the Cholesky
factor of the inverse Hessian of the layer inputs (``H = E[x xᵀ]``): the
update that minimizes the layer-output error for the rows still free to move.

Composed with the q4_k super-block format (``quant/kquant.py``):

* rows are processed in natural order, one 256-row super-block slab at a
  time; when a slab is reached, its scale-of-scales rows (supers) are fitted
  by the weighted k-quant search on the slab's current (already compensated)
  values, then frozen;
* each 32-row block refits its grid on its current values and snaps the
  block's (d, m) onto the frozen supers' code lattice;
* each row is rounded onto the block's grid and its error propagated to all
  later rows (the standard GPTQ recursion).

The result is an ordinary :class:`QTensor`: the kernels, serving and the
checkpoints cannot tell it from round-to-nearest output.

This is the JAX package's numpy algorithm, result for result. The factor U
(``H⁻¹ = Uᵀ U``) is computed on the host in numpy float64, inverse then
Cholesky, as the JAX package computes it: a device LAPACK sums in another
order, and the CPU and the card then start the recursion from other bits.
The grid fits are the port's numpy ``kquant`` on host copies of the current
rows. The recursion itself, the O(K² N) part, runs in float64 on the
requested device. Its row update is an outer product followed by a
subtraction, each element rounded once as numpy rounds it (a fused
multiply-add would round once less), so the same H and W give the same
planes on the CPU, on the card and in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ggml_experiments_tpu_torch.device import DeviceLike, resolve_device
from ggml_experiments_tpu_torch.quant import kquant
from ggml_experiments_tpu_torch.quant.qtensor import (
    BLOCK,
    QTensor,
    _pack_nibbles,
    from_numpy_blocks,
)

PERCDAMP = 0.01  # standard GPTQ diagonal damping fraction


def _np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _hessian_inverse_chol(h, percdamp: Optional[float] = None) -> np.ndarray:
    """Upper-triangular U with ``H⁻¹ = Uᵀ U`` (damped), the GPTQ recursion
    factor, in numpy float64 on the host.

    ``percdamp``: diagonal damping as a fraction of mean(diag(H)). For a
    rank-deficient input distribution (the GRU input kernel, whose
    activations span only the 66 embedding rows) a small damp (~1e-4) lets
    the recursion push rounding error into the null space the model never
    sees; full-rank inputs keep the standard 0.01."""
    h = _np64(h).copy()
    k = h.shape[0]
    # dead inputs (zero activation everywhere): pin the diagonal so that the
    # factorization exists; their rows then round to nearest
    diag = np.diagonal(h).copy()
    dead = diag <= 0
    h[dead, dead] = 1.0
    if percdamp is None:
        percdamp = PERCDAMP
    damp = percdamp * float(np.mean(diag[~dead])) if (~dead).any() else 1.0
    h[np.arange(k), np.arange(k)] += damp
    hinv = np.linalg.inv(h)
    # numpy's cholesky returns lower L (A = L Lᵀ); U = Lᵀ gives A = Uᵀ U
    return np.linalg.cholesky(hinv).T


def _inverse_or_zero(a: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(a > 0, 1.0 / np.where(a > 0, a, 1.0), 0.0)


def _propagate(wk: torch.Tensor, u: torch.Tensor, i: int, err: torch.Tensor) -> None:
    """``wk[i+1:] -= outer(u[i, i+1:], err)``: the product rounded, then the
    difference (no fused multiply-add)."""
    if i + 1 < wk.shape[0]:
        wk[i + 1:] -= u[i, i + 1:, None] * err[None, :]


def _setup(w, hessian, percdamp, device):
    dev = resolve_device(device)
    if isinstance(w, torch.Tensor):
        wk = w.detach().to(dev, torch.float64).clone()
    else:
        wk = torch.from_numpy(np.array(w, np.float64)).to(dev)
    k, n = wk.shape
    h = _np64(hessian)
    if h.shape != (k, k):
        raise ValueError(f"hessian {h.shape} does not match K={k}")
    u = torch.from_numpy(_hessian_inverse_chol(h, percdamp)).to(dev)
    return dev, wk, h, u


def gptq_quantize_q4_k(w, hessian, importance=None, percdamp: Optional[float] = None, *,
                       device: DeviceLike = None) -> QTensor:
    """Quantize ``w (K, N)`` (numpy or tensor) to q4_k with GPTQ error
    compensation; the recursion runs on ``device`` and the QTensor lands there.

    ``hessian``: (K, K) ``E[x xᵀ]`` of the layer's inputs over calibration
    data. ``importance``: optional per-row grid-search weights; defaults to
    ``diag(hessian)`` (the matching diagonal objective)."""
    dev, wk, h, u = _setup(w, hessian, percdamp, device)
    k, n = wk.shape
    if importance is None:
        importance = np.diagonal(h).copy()
        if not (importance > 0).any():
            importance = None
    if importance is not None:
        importance = _np64(importance)

    nb = (k + BLOCK - 1) // BLOCK
    codes = torch.zeros((nb * BLOCK, n), dtype=torch.uint8, device=dev)
    sc_all = np.zeros((nb, n), np.uint8)
    mc_all = np.zeros((nb, n), np.uint8)
    ns = (nb + kquant.GROUP - 1) // kquant.GROUP
    d_sup_all = np.zeros((ns, n), np.float32)
    m_sup_all = np.zeros((ns, n), np.float32)

    def host_rows(r0, r1):
        """Rows r0:r1 of the current weights and their importance, padded to
        whole blocks, on the host."""
        rows = wk[r0:r1].cpu().numpy()
        pad = (-(r1 - r0)) % BLOCK
        if pad:
            rows = np.pad(rows, ((0, pad), (0, 0)))
        imp = None
        if importance is not None:
            imp = importance[r0:r1, None] * np.ones((1, n))
            if pad:
                imp = np.pad(imp, ((0, pad), (0, 0)))
            imp = imp.reshape(-1, BLOCK, n)
        return rows.reshape(-1, BLOCK, n), imp

    for s0 in range(0, k, kquant.SUPER):
        s1 = min(s0 + kquant.SUPER, k)
        # the slab's supers from its current (compensated) values: frozen
        # before any block of the slab codes its scales against them
        _, _, _, supers = kquant.quantize_q4_k_blocks(*host_rows(s0, s1))
        si = s0 // kquant.SUPER
        d_sup_all[si] = supers[0]
        m_sup_all[si] = supers[1]
        d_sup = supers[0].astype(np.float64)
        m_sup = supers[1].astype(np.float64)
        d_sup_inv = _inverse_or_zero(d_sup)
        m_sup_inv = _inverse_or_zero(m_sup)

        for b0 in range(s0, s1, BLOCK):
            b1 = min(b0 + BLOCK, k)
            # the block's grid refitted on its current values (errors of
            # earlier rows of the slab moved them), snapped onto the supers'
            # code lattice
            blk, bimp = host_rows(b0, b1)
            _, _, _, sup_blk = kquant.quantize_q4_k_blocks(blk, bimp)
            d_fit = sup_blk[0].astype(np.float64) * 255.0
            m_fit = sup_blk[1].astype(np.float64) * 255.0
            sc = np.clip(np.rint(d_fit * d_sup_inv), 0, 255)
            mc = np.clip(np.rint(m_fit * m_sup_inv), 0, 255)
            bi = b0 // BLOCK
            sc_all[bi] = sc.astype(np.uint8)
            mc_all[bi] = mc.astype(np.uint8)
            eff_d_np = d_sup * sc
            eff_d = torch.from_numpy(eff_d_np).to(dev)
            eff_m = torch.from_numpy(m_sup * mc).to(dev)
            inv_d = torch.from_numpy(_inverse_or_zero(eff_d_np)).to(dev)
            # sequential rounding with error feedback
            for i in range(b0, b1):
                q = torch.clamp(torch.round((wk[i] + eff_m) * inv_d), 0, 15)
                codes[i] = q.to(torch.uint8)
                wq = q * eff_d - eff_m
                _propagate(wk, u, i, (wk[i] - wq) / u[i, i])

    packed = _pack_nibbles(codes.cpu().numpy().reshape(nb, BLOCK, n))
    return from_numpy_blocks(packed, sc_all, (k, n), "q4_k", mins=mc_all,
                             supers=np.concatenate([d_sup_all, m_sup_all], axis=0),
                             device=dev)


def gptq_quantize_q8_0(w, hessian, percdamp: Optional[float] = None, *,
                       device: DeviceLike = None) -> QTensor:
    """GPTQ error compensation onto the q8_0 grid: the same recursion with
    the per-block symmetric grid (d = absmax/127, frozen per 32-row block at
    the block's start from its current values). The high-precision tensors
    of mixed recipes (the q4_k_m vocab head) take it, so that their error is
    layer-output-optimal too."""
    dev, wk, _, u = _setup(w, hessian, percdamp, device)
    k, n = wk.shape
    nb = (k + BLOCK - 1) // BLOCK
    codes = torch.zeros((nb * BLOCK, n), dtype=torch.int8, device=dev)
    scales = torch.zeros((nb, n), dtype=torch.float32, device=dev)
    for b0 in range(0, k, BLOCK):
        b1 = min(b0 + BLOCK, k)
        d = wk[b0:b1].abs().amax(dim=0) / 127.0
        scales[b0 // BLOCK] = d.float()
        inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)),
                          torch.zeros_like(d))
        for i in range(b0, b1):
            q = torch.clamp(torch.round(wk[i] * inv), -127, 127)
            codes[i] = q.to(torch.int8)
            _propagate(wk, u, i, (wk[i] - q * d) / u[i, i])
    return from_numpy_blocks(codes[:k].cpu().numpy(), scales.cpu().numpy(), (k, n), "q8_0",
                             device=dev)
