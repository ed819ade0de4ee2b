"""Port: the gru.bin reader/writer and the weight hand-over from the JAX package."""

import os

import numpy as np
import pytest
import torch

from ggml_experiments_tpu import quant as jquant
from ggml_experiments_tpu.formats.gru_bin import read_tensors_py
from ggml_experiments_tpu_torch.convert import params_from_numpy
from ggml_experiments_tpu_torch.formats import gru_bin
from ggml_experiments_tpu_torch.quant import QTensor

CKPTS = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
BINS = [os.path.join(CKPTS, n) for n in ("gru_synth.bin", "gru_shakespeare.bin")]


@pytest.mark.parametrize("path", BINS, ids=os.path.basename)
def test_bin_loads_identical_to_jax_reader_and_round_trips(path, tmp_path):
    want = read_tensors_py(path)
    got = gru_bin.read_tensors(path)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    params = gru_bin.load_gru_params(path, device="cpu")
    for t, b in zip((params.embeddings, params.cell.kernel, params.cell.recurrent_kernel,
                     params.cell.bias, params.dense_kernel, params.dense_bias), want):
        np.testing.assert_array_equal(t.numpy(), b)
    out = tmp_path / "rt.bin"
    gru_bin.save_gru_params(str(out), params)
    with open(path, "rb") as f:
        assert out.read_bytes() == f.read()


def test_q8_0_load_matches_jax_quantize():
    path = BINS[0]
    want = read_tensors_py(path)
    params = gru_bin.load_gru_params(path, qtype="q8_0", device="cpu")
    for qt, w in ((params.cell.kernel, want[1]), (params.cell.recurrent_kernel, want[2]),
                  (params.dense_kernel, want[4])):
        jq = jquant.quantize(w, "q8_0")
        assert isinstance(qt, QTensor) and qt.shape == tuple(jq.shape)
        np.testing.assert_array_equal(qt.codes.numpy(), np.asarray(jq.codes))
        np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(jq.scales))
    assert params.embeddings.dtype == torch.float32          # small tensors stay f32


def test_params_from_jax_planes():
    rng = np.random.default_rng(0)
    a = {"embeddings": rng.normal(size=(66, 8)), "kernel": rng.normal(size=(8, 96)),
         "recurrent_kernel": rng.normal(size=(32, 96)), "bias": rng.normal(size=(2, 96)),
         "dense_kernel": rng.normal(size=(32, 66)), "dense_bias": rng.normal(size=(66,))}
    jq = jquant.quantize(a["recurrent_kernel"].astype(np.float32), "q8_0")
    planes = {"codes": np.asarray(jq.codes), "scales": np.asarray(jq.scales), "shape": jq.shape}
    p = params_from_numpy({**a, "recurrent_kernel": planes}, device="cpu")
    np.testing.assert_array_equal(p.cell.recurrent_kernel.dequantize().numpy(),
                                  np.asarray(jquant.dequantize(jq)))
    assert p.cell.kernel.dtype == torch.float32 and p.units == 32 and p.vocab_size == 66
    with pytest.raises(ValueError, match="q8_0 planes"):
        params_from_numpy({**a, "recurrent_kernel": {**planes, "codes": planes["codes"][:5]}},
                          device="cpu")


def jax_planes(jq):
    """A JAX QTensor's fields as the numpy planes the port's convert takes."""
    out = {"shape": jq.shape, "qtype": jq.qtype}
    for name in ("codes", "scales", "mins", "hibits", "supers"):
        if getattr(jq, name) is not None:
            out[name] = np.asarray(getattr(jq, name))
    return out


@pytest.mark.parametrize("qtype", ["q8_0", "q4_0", "q4_1", "q5_0", "q5_1", "q4_k"])
def test_planes_of_every_format_convert_and_validate(qtype):
    """Per-matrix mixed planes: the recurrent kernel in ``qtype``, the head in
    q8_0, the input kernel float; wrong dtypes, shapes and planes raise."""
    rng = np.random.default_rng(1)
    a = {"embeddings": rng.normal(size=(66, 40)), "kernel": rng.normal(size=(40, 210)),
         "recurrent_kernel": rng.normal(0.2, 1, size=(70, 210)),
         "bias": rng.normal(size=(2, 210)), "dense_kernel": rng.normal(size=(70, 66))}
    jq = jquant.quantize(a["recurrent_kernel"].astype(np.float32), qtype)
    jd = jquant.quantize(a["dense_kernel"].astype(np.float32), "q8_0")
    planes = jax_planes(jq)
    p = params_from_numpy({**a, "recurrent_kernel": planes, "dense_kernel": jax_planes(jd)},
                          device="cpu")
    assert p.cell.recurrent_kernel.qtype == qtype and p.dense_kernel.qtype == "q8_0"
    assert p.cell.kernel.dtype == torch.float32 and p.dense_bias is None
    np.testing.assert_array_equal(p.cell.recurrent_kernel.dequantize().numpy(),
                                  np.asarray(jquant.dequantize(jq)))
    np.testing.assert_array_equal(p.dense_kernel.dequantize().numpy(),
                                  np.asarray(jquant.dequantize(jd)))

    def bad(**change):
        with pytest.raises(ValueError, match=f"{qtype} planes"):
            params_from_numpy({**a, "recurrent_kernel": {**planes, **change}}, device="cpu")

    bad(codes=planes["codes"].astype(np.int16))
    bad(scales=planes["scales"][:, :64])
    bad(shape=(200, 210))
    for name in ("mins", "hibits", "supers"):
        if name in planes:
            bad(**{name: None})
            bad(**{name: planes[name][:-1]})
        else:
            bad(**{name: np.zeros((1, 256), np.uint8)})
    with pytest.raises(ValueError, match="unknown qtype"):
        params_from_numpy({**a, "recurrent_kernel": {**planes, "qtype": "q2_k"}}, device="cpu")


def test_gxt_and_bad_files_raise(tmp_path):
    gxt = gru_bin.load_gru_any(os.path.join(CKPTS, "gru_synth_q4km.gxt"), device="cpu")
    assert isinstance(gxt.cell.recurrent_kernel, QTensor) and gxt.units == 1024
    notgxt = tmp_path / "renamed.gxt"
    notgxt.write_bytes(open(BINS[0], "rb").read(4096))
    with pytest.raises(ValueError, match="GXT1"):
        gru_bin.load_gru_any(str(notgxt), device="cpu")
    data = open(BINS[0], "rb").read()
    cut = tmp_path / "cut.bin"
    cut.write_bytes(data[:1000])
    with pytest.raises(EOFError):
        gru_bin.read_tensors(str(cut))
    bad = tmp_path / "bad.bin"
    bad.write_bytes(np.array([9], "<i4").tobytes())
    with pytest.raises(ValueError):
        gru_bin.read_tensors(str(bad))
    five = tmp_path / "five.bin"
    with open(five, "wb") as f:
        for t in gru_bin.read_tensors(BINS[0])[:5]:
            gru_bin._write_tensor(f, t)
    with pytest.raises(ValueError, match="expected 6"):
        gru_bin.load_gru_params(str(five), device="cpu")
