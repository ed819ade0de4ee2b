"""Port: GPTQ (``quant/gptq.py``) against the JAX package's numpy GPTQ.

From the same seeded H and W the port's q4_k and q8_0 recursions (f64 on the
CPU here) give planes bit-equal to the JAX functions'. The contracts of
``tests/test_gptq.py`` run against the port at the same shapes: GPTQ beats
round to nearest on layer-output error, an identity Hessian leaves nothing
worse, the statistics are consistent and PSD, and the recipes build the
formats they promise.
"""

import numpy as np
import pytest
import torch

from ggml_experiments_tpu.quant import gptq as jgptq
from ggml_experiments_tpu_torch.convert import params_from_numpy
from ggml_experiments_tpu_torch.quant import calibration, gptq
from ggml_experiments_tpu_torch.quant.qtensor import QTensor, dequantize, quantize

CPU = "cpu"


@pytest.fixture(autouse=True)
def _two_threads():
    """Beside other test workers, a full-width thread pool per product only
    oversubscribes the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _layer_mse(x, w, qt):
    err = x @ (dequantize(qt).double().numpy() - w)
    return float(np.mean(err ** 2))


def _correlated(rng, k, rank, rows=2048, noise=0.1):
    basis = rng.standard_normal((k, rank))
    x = rng.standard_normal((rows, rank)) @ basis.T
    x += noise * rng.standard_normal(x.shape)
    return x, x.T @ x / x.shape[0]


def _planes(qt):
    """Every stored plane of a QTensor (port or JAX) as numpy."""
    return {n: np.asarray(getattr(qt, n).cpu() if isinstance(qt, QTensor) else getattr(qt, n))
            for n in ("codes", "scales", "mins", "supers") if getattr(qt, n) is not None}


@pytest.mark.parametrize("k,n,percdamp,with_imp", [
    (256, 384, None, False), (300, 130, 1e-4, False), (512, 128, None, True),
    (64, 200, 0.05, True)])
def test_q4_k_planes_bit_equal_to_jax(rng, k, n, percdamp, with_imp):
    """K past one super-block and not a multiple of 32, N off the lane width,
    a given importance and damping: the same planes, bit for bit."""
    x, h = _correlated(rng, k, max(k // 4, 8))
    w = rng.standard_normal((k, n)) * 0.1
    imp = rng.uniform(0.1, 2.0, k) if with_imp else None
    got = gptq.gptq_quantize_q4_k(w, h, importance=imp, percdamp=percdamp, device=CPU)
    want = jgptq.gptq_quantize_q4_k(w, h, importance=imp, percdamp=percdamp)
    assert got.qtype == want.qtype == "q4_k" and got.shape == want.shape == (k, n)
    g, wnt = _planes(got), _planes(want)
    assert g.keys() == wnt.keys() == {"codes", "scales", "mins", "supers"}
    for name in g:
        np.testing.assert_array_equal(g[name], wnt[name], err_msg=name)


@pytest.mark.parametrize("k,n", [(256, 130), (100, 66), (1024, 66)])
def test_q8_0_planes_bit_equal_to_jax(rng, k, n):
    x, h = _correlated(rng, k, 32, rows=4096, noise=0.05)
    w = rng.standard_normal((k, n)) * 0.1
    got = gptq.gptq_quantize_q8_0(torch.from_numpy(w), torch.from_numpy(h), device=CPU)
    want = jgptq.gptq_quantize_q8_0(w, h)
    for name, plane in _planes(want).items():
        np.testing.assert_array_equal(_planes(got)[name], plane, err_msg=name)


def test_hessian_factor_is_the_jax_factor(rng):
    """U comes from numpy on the host, inverse then Cholesky: the JAX bits,
    dead inputs pinned."""
    _, h = _correlated(rng, 96, 20)
    h[5, :] = h[:, 5] = 0.0
    np.testing.assert_array_equal(gptq._hessian_inverse_chol(torch.from_numpy(h)),
                                  jgptq._hessian_inverse_chol(h))
    np.testing.assert_array_equal(gptq._hessian_inverse_chol(h, 1e-4),
                                  jgptq._hessian_inverse_chol(h, 1e-4))


@pytest.mark.parametrize("k,n", [(256, 384), (512, 128)])
def test_gptq_q4_k_beats_rtn_on_layer_output(rng, k, n):
    x, h = _correlated(rng, k, k // 4)
    w = rng.standard_normal((k, n)) * 0.1
    qt_gptq = gptq.gptq_quantize_q4_k(w, h, device=CPU)
    qt_rtn = quantize(w.astype(np.float32), "q4_k", device=CPU)
    mse_gptq, mse_rtn = _layer_mse(x, w, qt_gptq), _layer_mse(x, w, qt_rtn)
    assert mse_gptq < mse_rtn * 0.9, (mse_gptq, mse_rtn)
    assert qt_gptq.qtype == "q4_k" and qt_gptq.shape == (k, n)
    assert qt_gptq.bits_per_weight < 5.0


def test_gptq_q8_0_beats_rtn_on_layer_output(rng):
    k, n = 256, 130
    x, h = _correlated(rng, k, 32, rows=4096, noise=0.05)
    w = rng.standard_normal((k, n)) * 0.1
    qt = gptq.gptq_quantize_q8_0(w, h, device=CPU)
    assert qt.qtype == "q8_0" and qt.shape == (k, n)
    assert _layer_mse(x, w, qt) < _layer_mse(x, w, quantize(w.astype(np.float32), "q8_0",
                                                              device=CPU))


def test_gptq_identity_hessian_equals_blockwise_rtn_error_class(rng):
    w = rng.standard_normal((256, 128)) * 0.1
    qt = gptq.gptq_quantize_q4_k(w, np.eye(256), device=CPU)
    qt0 = quantize(w.astype(np.float32), "q4_k", device=CPU)
    e = float(np.mean((dequantize(qt).double().numpy() - w) ** 2))
    e0 = float(np.mean((dequantize(qt0).double().numpy() - w) ** 2))
    assert e <= e0 * 1.2, (e, e0)


def test_gptq_shape_validation(rng):
    with pytest.raises(ValueError, match="hessian"):
        gptq.gptq_quantize_q4_k(rng.standard_normal((64, 32)), np.eye(32), device=CPU)
    with pytest.raises(ValueError, match="hessian"):
        gptq.gptq_quantize_q8_0(rng.standard_normal((64, 32)), np.eye(32), device=CPU)


def _tiny_gru(rng, v, e, u):
    return params_from_numpy({
        "embeddings": rng.uniform(-0.05, 0.05, (v, e)),
        "kernel": rng.standard_normal((e, 3 * u)) * 0.2,
        "recurrent_kernel": rng.standard_normal((u, 3 * u)) * 0.1,
        "bias": rng.standard_normal((2, 3 * u)) * 0.05,
        "dense_kernel": rng.standard_normal((u, v)) * 0.2,
        "dense_bias": np.zeros(v)}, device=CPU)


def test_collect_gru_moments_and_hessians_consistent(rng):
    """diag(H) equals the moment vector of the same tap, and every Gram is
    PSD."""
    params = _tiny_gru(rng, 20, 16, 32)
    seqs = rng.integers(0, 20, (4, 33)).astype(np.int32)
    mom = calibration.collect_gru_moments(params, seqs)
    hes = calibration.collect_gru_hessians(params, seqs)
    for key in ("kernel", "recurrent_kernel", "dense_kernel"):
        h = hes[key].numpy()
        assert hes[key].dtype == torch.float64
        np.testing.assert_allclose(np.diagonal(h), mom[key].numpy(), rtol=1e-6, atol=1e-9)
        assert np.linalg.eigvalsh(h).min() > -1e-8


def test_gptq_gru_params_structure(rng):
    from ggml_experiments_tpu_torch.ops.fused_gru_decode import is_fusable_params

    params = _tiny_gru(rng, 20, 32, 64)
    seqs = rng.integers(0, 20, (4, 33)).astype(np.int32)
    p = calibration.gptq_gru_params(params, seqs)
    assert p.cell.kernel.qtype == "q4_k" and p.cell.recurrent_kernel.qtype == "q4_k"
    assert p.dense_kernel.qtype == "q8_0" and p.cache == {}
    # the mixed formats still take the fused decode's dense weight route
    assert is_fusable_params(p)
    r = calibration.calibrated_gru_params(params, seqs, qtype="q4_k")
    assert {r.cell.kernel.qtype, r.cell.recurrent_kernel.qtype, r.dense_kernel.qtype} == {"q4_k"}
