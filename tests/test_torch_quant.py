"""Port: q8_0 quantize/dequantize and qmatmul against the JAX package.

The JAX qmatmul runs its Pallas kernel in interpret mode on the CPU (as the
JAX package's own tests run it); the port runs its plain PyTorch version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_experiments_tpu import quant as jquant
from ggml_experiments_tpu.quant import pallas_kernels
from ggml_experiments_tpu_torch import quant as tquant
from ggml_experiments_tpu_torch.quant.qmatmul import (
    LAUNCHES,
    XLA_FALLBACK_MAX_ELEMS,
    qmatmul_q8_0_cuda,
)


@pytest.mark.parametrize("shape", [(64, 128), (70, 200), (1, 3), (256, 66), (33, 129)])
def test_q8_0_quantize_bit_identical(shape):
    w = np.random.default_rng(sum(shape)).normal(0, 0.7, shape).astype(np.float32)
    w[0, 0] = 0.0
    jq = jquant.quantize(w, "q8_0")
    tq = tquant.quantize(w, "q8_0", device="cpu")
    assert tq.codes.dtype == torch.int8 and tq.scales.dtype == torch.float32
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert tq.shape == tuple(jq.shape) and tq.kp == jq.kp and tq.np_ == jq.np_
    np.testing.assert_array_equal(tquant.dequantize(tq).numpy(),
                                  np.asarray(jquant.dequantize(jq)))


def test_all_zero_block_quantizes_to_zero():
    w = np.zeros((32, 128), np.float32)
    tq = tquant.quantize(w, device="cpu")
    assert not tq.codes.any() and not tq.scales.any()


@pytest.mark.parametrize("qtype", ["q4_0", "q4_1", "q5_0", "q5_1", "q4_k"])
def test_unported_qtypes_raise(qtype):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tquant.quantize(np.ones((32, 32), np.float32), qtype, device="cpu")


@pytest.mark.parametrize("k,n,m", [
    (256, 192, 5),      # K*N under the fallback limit: dequant + matmul
    (1024, 1536, 4),    # above it: the kernel route (plain version on CPU)
    (1030, 1100, 3),    # kernel route with ragged K and N
])
def test_qmatmul_f32_matches_jax(k, n, m):
    rng = np.random.default_rng(k + n)
    w = rng.normal(0, 0.1, (k, n)).astype(np.float32)
    x = rng.normal(0, 1.0, (m, k)).astype(np.float32)
    jq = jquant.quantize(w, "q8_0")
    tq = tquant.quantize(w, "q8_0", device="cpu")
    assert (k * n > XLA_FALLBACK_MAX_ELEMS) == (k * n > pallas_kernels.XLA_FALLBACK_MAX_ELEMS)
    ref = np.asarray(jquant.qmatmul(jnp.asarray(x), jq, compute_dtype=jnp.float32))
    out = tquant.qmatmul(torch.from_numpy(x), tq, compute_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    # f32 sums of up to 1030 terms in two orders: 1e-5 relative to the scale
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    plain = tquant.qmatmul_reference(torch.from_numpy(x), tq)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("k,n", [(256, 192), (1024, 1536)])
def test_qmatmul_bf16_matches_jax(k, n):
    rng = np.random.default_rng(7)
    w = rng.normal(0, 0.1, (k, n)).astype(np.float32)
    x = rng.normal(0, 1.0, (4, k)).astype(np.float32)
    jq = jquant.quantize(w, "q8_0")
    tq = tquant.quantize(w, "q8_0", device="cpu")
    ref = np.asarray(jquant.qmatmul(jnp.asarray(x), jq, compute_dtype=jnp.bfloat16)
                     .astype(jnp.float32))
    out = tquant.qmatmul(torch.from_numpy(x), tq, compute_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    # both round the operands to bf16 and store a bf16 result: they differ by
    # at most one bf16 rounding of the output (2**-8 relative)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(ref).max())


def test_qmatmul_batched_leading_dims():
    rng = np.random.default_rng(3)
    tq = tquant.quantize(rng.normal(0, 0.1, (1024, 1100)), device="cpu")
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 1024)).astype(np.float32))
    out = tquant.qmatmul(x, tq)
    np.testing.assert_allclose(out.reshape(6, -1).numpy(),
                               tquant.qmatmul(x.reshape(6, -1), tq).numpy())
    with pytest.raises(ValueError):
        tquant.qmatmul(x[..., :10], tq)


def test_qmatmul_cuda_wrapper_refuses_cpu_tensors():
    tq = tquant.quantize(np.ones((64, 128), np.float32), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        qmatmul_q8_0_cuda(torch.ones((2, 64)), tq)
    assert LAUNCHES["qmatmul_q8_0"] == 0


def test_jax_reference_kept_in_interpret_mode():
    # the comparisons above run the JAX Pallas kernel through the interpreter
    assert jax.default_backend() == "cpu" and pallas_kernels._default_interpret()
