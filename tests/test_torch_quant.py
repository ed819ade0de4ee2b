"""Port: quantize/dequantize of every block format and qmatmul against the JAX package.

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
from ggml_experiments_tpu.quant import qtensor as jqtensor
from ggml_experiments_tpu_torch.quant import kquant as tkquant
from ggml_experiments_tpu_torch.quant import qtensor as tqtensor
from ggml_experiments_tpu_torch.quant.qmatmul import (
    LAUNCHES,
    XLA_FALLBACK_MAX_ELEMS,
    qmatmul_cuda,
)

PLANES = ("codes", "scales", "mins", "hibits", "supers")
NEW_QTYPES = ["q4_0", "q4_1", "q5_0", "q5_1", "q4_k"]
RAGGED = [(64, 128), (70, 200), (1, 3), (256, 66), (33, 129), (300, 40)]


def assert_planes_equal(tq, jq, logical_hibits=False):
    """Every plane of the port's QTensor equals the JAX one's, bit for bit
    (``logical_hibits``: the fifth-bit plane only over the logical columns)."""
    assert tq.qtype == jq.qtype and tq.shape == tuple(jq.shape)
    for name in PLANES:
        a, b = getattr(tq, name), getattr(jq, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "hibits" and logical_hibits:
            a, b = a[:, : tq.n], b[:, : tq.n]
        np.testing.assert_array_equal(a, b, err_msg=name)


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


@pytest.mark.parametrize("shape", RAGGED)
@pytest.mark.parametrize("qtype", NEW_QTYPES)
def test_block_formats_quantize_bit_identical(qtype, shape, monkeypatch):
    """Planes and dequantized values equal the JAX package's, against both of
    its codecs: the numpy one (every plane, padding included) and the one
    ``quantize`` takes by default (the C++ codec where it is built), which
    leaves q5_0's fifth-bit plane 0 over the lane-padding columns where the
    numpy codec writes 1s; both decode that padding to zero."""
    w = np.random.default_rng(sum(shape)).normal(0.1, 0.7, shape).astype(np.float32)
    w[0, 0] = 0.0
    tq = tquant.quantize(w, qtype, device="cpu")
    jq = jquant.quantize(w, qtype)
    assert_planes_equal(tq, jq, logical_hibits=qtype == "q5_0")
    np.testing.assert_array_equal(tquant.dequantize(tq).numpy(),
                                  np.asarray(jquant.dequantize(jq)))
    monkeypatch.setattr(jqtensor, "_native_quantize", lambda w, qtype: None)
    assert_planes_equal(tq, jquant.quantize(w, qtype))
    assert tq.kp == jq.kp and tq.np_ == jq.np_ and tq.nbytes == jq.nbytes
    assert tq.bits_per_weight == jq.bits_per_weight
    assert tq.stored_nbytes == jq.stored_nbytes
    assert tq.stored_bits_per_weight == jq.stored_bits_per_weight


@pytest.mark.parametrize("qtype", list(tquant.QTYPES))
def test_numpy_blocks_round_trip(qtype):
    """to_numpy_blocks gives the JAX package's logical planes, and
    from_numpy_blocks pads them back to planes that dequantize alike; the
    lane padding decodes to exactly zero (the K padding of a partial block
    of an offset format decodes to its min, so consumers guard k < K)."""
    w = np.random.default_rng(5).normal(0.2, 0.5, (70, 200)).astype(np.float32)
    tq = tquant.quantize(w, qtype, device="cpu")
    jq = jquant.quantize(w, qtype)
    tb, jb = tquant.to_numpy_blocks(tq), jqtensor.to_numpy_blocks(jq)
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    names = ("mins", "supers") if qtype == "q4_k" else ("mins", "hibits")
    extra = dict(zip(names, tb[2:]))
    back = tquant.from_numpy_blocks(tb[0], tb[1], tq.shape, qtype, device="cpu", **extra)
    jback = jqtensor.from_numpy_blocks(jb[0], jb[1], jq.shape, qtype, **extra)
    assert_planes_equal(back, jback)
    np.testing.assert_array_equal(back.dequantize().numpy(), tq.dequantize().numpy())
    padded = tqtensor.dequantize_padded(back).numpy()
    assert not padded[:, 200:].any()


@pytest.mark.parametrize("qtype,bits", [("q8_0", 9.0), ("q4_0", 5.0), ("q4_1", 6.0),
                                        ("q5_0", 6.0), ("q5_1", 7.0), ("q4_k", 4.625)])
def test_stored_bits_per_weight_on_aligned_shapes(qtype, bits):
    tq = tquant.quantize(np.random.default_rng(1).normal(size=(512, 128)), qtype, device="cpu")
    assert tq.stored_bits_per_weight == bits == tquant.QTYPE_TOTAL_BITS[qtype]
    assert tquant.QTYPE_BITS[qtype] == jqtensor.QTYPE_BITS[qtype]
    assert tquant.QTYPE_TOTAL_BITS == jqtensor.QTYPE_TOTAL_BITS
    assert tquant.QTYPES == jqtensor.QTYPES


@pytest.mark.parametrize("imp_shape", [(300,), (300, 140)])
def test_q4_k_importance_matches_jax(imp_shape):
    rng = np.random.default_rng(9)
    w = rng.normal(0, 0.3, (300, 140)).astype(np.float32)
    imp = rng.uniform(0, 2, imp_shape)
    imp[:32] = 0.0                      # an all-zero importance block
    tq = tquant.quantize(w, "q4_k", importance=imp, device="cpu")
    assert_planes_equal(tq, jquant.quantize(w, "q4_k", importance=imp))
    plain = tquant.quantize(w, "q4_k", device="cpu")
    assert not np.array_equal(plain.codes.numpy(), tq.codes.numpy())
    sc, mc, sup = tq.scales.numpy(), tq.mins.numpy(), tq.supers.numpy()
    for a, b in zip(tkquant.effective_scales_np(sc, mc, sup),
                    (t.numpy() for t in tqtensor.effective_scales(tq))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("qtype", list(tquant.QTYPES))
def test_unpack_and_error_helpers_match_jax(qtype):
    w = np.random.default_rng(2).normal(0, 1, (64, 128)).astype(np.float32)
    assert tquant.quantization_error(w, qtype) == jqtensor.quantization_error(w, qtype)
    tq, jq = tquant.quantize(w, qtype, device="cpu"), jquant.quantize(w, qtype)
    if qtype == "q8_0":
        return
    np.testing.assert_array_equal(tqtensor.unpack_nibbles(tq.codes).numpy(),
                                  np.asarray(jqtensor.unpack_nibbles(jq.codes)))
    np.testing.assert_array_equal(tqtensor.unpack_q4(tq.codes).numpy(),
                                  np.asarray(jqtensor.unpack_q4(jq.codes)))
    if tq.hibits is not None:
        np.testing.assert_array_equal(tqtensor.unpack_hibits(tq.hibits).numpy(),
                                      np.asarray(jqtensor.unpack_hibits(jq.hibits)))


def test_unknown_qtype_and_bad_rank_raise():
    with pytest.raises(ValueError, match="unknown qtype"):
        tquant.quantize(np.ones((32, 32), np.float32), "q3_k", device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        tquant.quantize(np.ones((32,), np.float32), "q4_0", device="cpu")


QMATMUL_SHAPES = [
    (256, 192, 5),      # K*N under the fallback limit: dequant + matmul
    (1024, 1536, 4),    # above it: the kernel route (plain version on CPU)
    (1030, 1100, 3),    # kernel route with ragged K and N (q4_k: Kp % 256 != 0,
                        # so dequant + matmul in both packages)
]


@pytest.mark.parametrize("k,n,m", QMATMUL_SHAPES)
def test_qmatmul_f32_matches_jax(k, n, m):
    check_qmatmul_f32(k, n, m, "q8_0")


@pytest.mark.parametrize("k,n,m", QMATMUL_SHAPES)
@pytest.mark.parametrize("qtype", NEW_QTYPES)
def test_qmatmul_f32_every_format_matches_jax(k, n, m, qtype):
    check_qmatmul_f32(k, n, m, qtype)


def check_qmatmul_f32(k, n, m, qtype):
    rng = np.random.default_rng(k + n)
    w = (rng.normal(0, 0.1, (k, n)) + 0.03).astype(np.float32)
    x = rng.normal(0, 1.0, (m, k)).astype(np.float32)
    jq = jquant.quantize(w, qtype)
    tq = tquant.quantize(w, qtype, device="cpu")
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
    check_qmatmul_bf16(k, n, "q8_0")


@pytest.mark.parametrize("k,n", [(256, 192), (1024, 1536)])
@pytest.mark.parametrize("qtype", NEW_QTYPES)
def test_qmatmul_bf16_every_format_matches_jax(k, n, qtype):
    check_qmatmul_bf16(k, n, qtype)


def check_qmatmul_bf16(k, n, qtype):
    rng = np.random.default_rng(7)
    w = rng.normal(0, 0.1, (k, n)).astype(np.float32)
    x = rng.normal(0, 1.0, (4, k)).astype(np.float32)
    jq = jquant.quantize(w, qtype)
    tq = tquant.quantize(w, qtype, device="cpu")
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
    for qtype in tquant.QTYPES:
        tq = tquant.quantize(np.ones((64, 128), np.float32), qtype, device="cpu")
        with pytest.raises(ValueError, match="CUDA"):
            qmatmul_cuda(torch.ones((2, 64)), tq)
        assert LAUNCHES[f"qmatmul_{qtype}"] == 0


def test_q4_k_ragged_k_takes_the_dense_route(monkeypatch):
    """Kp % 256 != 0 goes to dequantize + matmul, as in the JAX package,
    never to the kernel route."""
    import importlib

    # the quant package re-exports a function under the module's name
    tqmm = importlib.import_module("ggml_experiments_tpu_torch.quant.qmatmul")
    tq = tquant.quantize(np.random.default_rng(0).normal(size=(1056, 1100)), "q4_k",
                         device="cpu")
    assert tq.kp % 256 and tq.k * tq.n > XLA_FALLBACK_MAX_ELEMS
    monkeypatch.setattr(tqmm, "qmatmul_reference", None)   # the kernel route would call it
    out = tquant.qmatmul(torch.ones((2, 1056)), tq)
    assert out.shape == (2, 1100) and torch.float32 in tq.dense


def test_jax_reference_kept_in_interpret_mode():
    # the comparisons above run the JAX Pallas kernel through the interpreter
    assert jax.default_backend() == "cpu" and pallas_kernels._default_interpret()
