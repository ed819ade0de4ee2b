"""Port: the native host runtime (runtime/, g++ at first use) against the
port's own numpy codecs, readers and image helpers: the counterparts of the
JAX package's native-runtime tests. The library is built into a temporary
build directory."""

import os

import numpy as np
import pytest

from ggml_experiments_tpu_torch import runtime
from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors_py
from ggml_experiments_tpu_torch.formats.gru_bin import read_tensors_py
from ggml_experiments_tpu_torch.quant import qtensor as Q

GOLD = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module", autouse=True)
def native(tmp_path_factory):
    """The library built into this module's own build directory."""
    mp = pytest.MonkeyPatch()
    build = str(tmp_path_factory.mktemp("native_build"))
    mp.setenv("GXT_TORCH_BUILD_DIR", build)
    if runtime._cxx() is None:
        mp.undo()
        pytest.skip("no g++ on this host: the native runtime is unavailable")
    assert runtime.available()
    assert os.path.dirname(runtime.lib_path()) == build and os.path.exists(runtime.lib_path())
    yield
    mp.undo()


def _numpy_planes(w, qtype):
    """The port's numpy codec on w's logical N columns: what the native codec
    returns."""
    wb, kp, _ = Q._blockify(w)
    wb = wb[..., : w.shape[1]]
    if qtype == "q8_0":
        q, d = Q._quantize_q8_0_arrays(wb)
        return q.reshape(kp, -1), d
    if qtype == "q4_0":
        q, d = Q._quantize_q4_0_arrays(wb)
        return Q._pack_nibbles(q), d
    if qtype == "q4_1":
        q, d, mn = Q._quantize_offset_arrays(wb, 15)
        return Q._pack_nibbles(q), d, mn
    if qtype == "q5_0":
        q, d = Q._quantize_q5_0_arrays(wb)
        return Q._pack_nibbles(q & 0xF), Q._pack_hibits(q >> 4), d
    q, d, mn = Q._quantize_offset_arrays(wb, 31)
    return Q._pack_nibbles(q & 0xF), Q._pack_hibits(q >> 4), d, mn


@pytest.mark.parametrize("shape", [(64, 128), (100, 30), (1024, 66)])
def test_native_q8_matches_numpy(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32)
    got = runtime.quantize_q8_0(w)
    for g, x in zip(got, _numpy_planes(w, "q8_0")):
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("shape", [(64, 128), (100, 30), (256, 144)])
def test_native_q4_matches_numpy(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32)
    got = runtime.quantize_q4_0(w)
    for g, x in zip(got, _numpy_planes(w, "q4_0")):
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("qtype", ["q8_0", "q4_0"])
def test_native_dequant_roundtrip(rng, qtype):
    w = rng.standard_normal((96, 128)).astype(np.float32)
    codes, scales = runtime.quantize_q8_0(w) if qtype == "q8_0" else runtime.quantize_q4_0(w)
    wd = runtime.dequantize(codes, scales, qtype)
    want = Q.dequantize(Q.quantize(w, qtype, device="cpu")).numpy()
    np.testing.assert_array_equal(wd[:96], want)


@pytest.mark.parametrize("qtype", ["q4_1", "q5_0", "q5_1"])
@pytest.mark.parametrize("shape", [(64, 128), (100, 30), (256, 144)])
def test_native_extended_matches_numpy(rng, qtype, shape):
    """Bit-equal to the numpy codec on the N logical columns, the rows past
    K of the last block included (q5_0 writes q = 16 there: fifth bit 1)."""
    w = rng.standard_normal(shape).astype(np.float32) + 0.4
    got = {"q4_1": runtime.quantize_q4_1, "q5_0": runtime.quantize_q5_0,
           "q5_1": runtime.quantize_q5_1}[qtype](w)
    want = _numpy_planes(w, qtype)
    assert len(got) == len(want)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    if qtype == "q5_0" and shape[0] % 32:
        pad_rows = np.arange(shape[0] % 32, 32)
        hib = got[1][-4:]                       # the last block's fifth-bit plane
        assert all((hib[t % 4] >> (t // 4) & 1).all() for t in pad_rows)


@pytest.mark.parametrize("qtype", ["q4_1", "q5_0", "q5_1"])
def test_native_extended_dequant_roundtrip(rng, qtype):
    w = rng.standard_normal((96, 128)).astype(np.float32)
    mins = hibits = None
    if qtype == "q4_1":
        codes, scales, mins = runtime.quantize_q4_1(w)
    elif qtype == "q5_0":
        codes, hibits, scales = runtime.quantize_q5_0(w)
    else:
        codes, hibits, scales, mins = runtime.quantize_q5_1(w)
    wd = runtime.dequantize(codes, scales, qtype, mins=mins, hibits=hibits)
    want = Q.dequantize(Q.quantize(w, qtype, device="cpu")).numpy()
    # built without FMA contraction: q * d + m rounds twice, as the port does
    np.testing.assert_array_equal(wd[:96], want)


def test_native_named_parser_matches_python():
    path = os.path.join(GOLD, "mobilevit_tiny.ggml")
    ours, ref = runtime.read_named_tensors_native(path), read_named_tensors_py(path)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_native_gru_parser_matches_python():
    path = os.path.join(GOLD, "gru_small.bin")
    ours, ref = runtime.read_gru_bin_native(path), read_tensors_py(path)
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_native_parser_rejects_garbage(tmp_path):
    """The indexer refuses the file; the reader that hooks it then raises the
    numpy reader's own error."""
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors

    bad = tmp_path / "bad.ggml"
    bad.write_bytes(b"\xff\xff\xff\xff0123456789")
    with pytest.raises(runtime.NativeParseError, match="native parse error"):
        runtime.read_named_tensors_native(str(bad))
    with pytest.raises(ValueError, match="name length"):
        read_named_tensors(str(bad))


def test_native_bilinear_matches_numpy(rng):
    from ggml_experiments_tpu_torch.utils.image import bilinear_resize_u8_py

    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    for out_h, out_w, scale in [(16, 23, 2.3), (37, 53, 1.0), (7, 10, 5.2)]:
        got = runtime.bilinear_resize_u8(img, out_h, out_w, scale)
        want = bilinear_resize_u8_py(img, out_h, out_w, scale)
        diff = np.abs(got.astype(int) - want.astype(int))
        # f32 operation order differs between the scalar C++ loop and numpy:
        # exact .5 ties may land one code apart
        assert diff.max() <= 1 and (diff != 0).mean() < 1e-3, (diff.max(), (diff != 0).mean())


def test_native_png_unfilter_matches_python(rng):
    """All five filter types, random data: native == the numpy unfilter; a
    bad filter byte raises as the numpy one does."""
    from ggml_experiments_tpu_torch.utils.image_codecs import _png_unfilter

    h, stride, bpp = 37, 61 * 3, 3
    raw = rng.integers(0, 256, (h, stride), np.uint8)
    filters = rng.integers(0, 5, h, np.uint8)
    np.testing.assert_array_equal(runtime.png_unfilter(raw, filters, bpp),
                                  _png_unfilter(raw.astype(np.int32), filters, bpp))
    filters[5] = 7
    with pytest.raises(ValueError, match="bad filter byte 7"):
        runtime.png_unfilter(raw, filters, bpp)


def test_native_q4_k_dequant_matches_python(rng):
    """The native q4_k decoder against the port's dequantizer (quantization
    itself stays numpy-side)."""
    w = rng.standard_normal((300, 130)).astype(np.float32)  # ragged K and N
    qt = Q.quantize(w, "q4_k", device="cpu")
    codes, scales, mins, supers = (qt.codes.numpy(), qt.scales.numpy(), qt.mins.numpy(),
                                   qt.supers.numpy())
    wd = runtime.dequantize(codes, scales, "q4_k", mins=mins, supers=supers)
    want = Q.dequantize(qt).numpy()
    np.testing.assert_allclose(wd[:300, :130], want, rtol=1e-6, atol=1e-7)


def test_build_failure_raises_with_the_log(tmp_path, monkeypatch):
    """A failed build raises with the compiler's output; a missing g++
    makes the runtime unavailable and every entry point None."""
    monkeypatch.setenv("GXT_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(runtime, "CXX_FLAGS", runtime.CXX_FLAGS + ["-include", "no_such.h"])
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*no_such\.h"):
        runtime.load()
    monkeypatch.setattr(runtime, "_cxx", lambda: None)
    monkeypatch.setattr(runtime, "CXX_FLAGS", runtime.CXX_FLAGS + ["-O1"])
    assert not runtime.available() and runtime.quantize_q8_0(np.ones((32, 8))) is None
