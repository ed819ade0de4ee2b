"""Port: the ``.gxt`` checkpoint container against the JAX package's.

Files cross between the packages in both directions: what either ``save``
wrote, the other loads, with equal header entries for the same tree.
"""

import json
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_experiments_tpu import quant as jquant
from ggml_experiments_tpu.formats import checkpoint as jckpt
from ggml_experiments_tpu.formats import gru_bin as jgru_bin
from ggml_experiments_tpu.models import gru_textgen as jg
from ggml_experiments_tpu.ops.gru import GRUCellParams as JCell
from ggml_experiments_tpu_torch import quant as tquant
from ggml_experiments_tpu_torch.convert import params_from_numpy
from ggml_experiments_tpu_torch.formats import checkpoint as tckpt
from ggml_experiments_tpu_torch.formats import gru_bin as tgru_bin

CKPTS = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
GXT_GRU_FILES = ["gru_synth_q4km.gxt"]
PLANES = ("codes", "scales", "mins", "hibits", "supers")
V, E, U = 66, 24, 40           # ragged on purpose: K=24/40 and N=120/66 all need padding


def arrays(seed=0):
    rng = np.random.default_rng(seed)
    a = {"embeddings": rng.normal(0, 0.5, (V, E)), "kernel": rng.normal(0.05, 0.3, (E, 3 * U)),
         "recurrent_kernel": rng.normal(0, 0.2, (U, 3 * U)), "bias": rng.normal(0, 0.1, (2, 3 * U)),
         "dense_kernel": rng.normal(0, 0.4, (U, V)), "dense_bias": rng.normal(0, 0.1, (V,))}
    return {k: x.astype(np.float32) for k, x in a.items()}


def twins(qtype):
    a = arrays()
    q = (lambda w: jquant.quantize(w, qtype)) if qtype else jnp.asarray
    jp = jg.GRUTextGenParams(
        embeddings=jnp.asarray(a["embeddings"]),
        cell=JCell(kernel=q(a["kernel"]), recurrent_kernel=q(a["recurrent_kernel"]),
                   bias=jnp.asarray(a["bias"])),
        dense_kernel=q(a["dense_kernel"]), dense_bias=jnp.asarray(a["dense_bias"]))
    return jp, params_from_numpy(a, qtype=qtype, device="cpu")


def weights(p):
    return {"embeddings": p.embeddings, "cell/kernel": p.cell.kernel,
            "cell/recurrent_kernel": p.cell.recurrent_kernel, "cell/bias": p.cell.bias,
            "dense_kernel": p.dense_kernel, "dense_bias": p.dense_bias}


def assert_same_weights(tp, jp):
    """Port params equal JAX params: floats by value, QTensors plane by plane."""
    for name, t in weights(tp).items():
        j = weights(jp)[name]
        if isinstance(t, tquant.QTensor):
            assert t.qtype == j.qtype and t.shape == tuple(j.shape), name
            for pl in PLANES:
                a, b = getattr(t, pl), getattr(j, pl)
                assert (a is None) == (b is None), (name, pl)
                if a is not None:
                    assert a.numpy().dtype == np.asarray(b).dtype, (name, pl)
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name}.{pl}")
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


def header_entries(path):
    with open(path, "rb") as f:
        assert f.read(4) == b"GXT1"
        (n,) = struct.unpack("<Q", f.read(8))
        head = json.loads(f.read(n))
    return [{k: e.get(k) for k in ("name", "dtype", "shape", "quant")} for e in head["tensors"]]


@pytest.mark.parametrize("name", GXT_GRU_FILES)
def test_committed_gxt_loads_equal_to_jax_loader(name):
    path = os.path.join(CKPTS, name)
    tp = tgru_bin.load_gru_any(path, device="cpu")
    jp = jgru_bin.load_gru_any(path)
    assert_same_weights(tp, jp)
    assert (tp.cell.kernel.qtype, tp.dense_kernel.qtype) == ("q4_k", "q8_0")
    assert (tp.vocab_size, tp.units) == (66, 1024)
    # a quantized checkpoint is served as stored, whatever qtype is asked
    again = tgru_bin.load_gru_any(path, qtype="q8_0", device="cpu")
    assert again.cell.kernel.qtype == "q4_k"
    assert tckpt.read_meta(path) == jckpt.read_meta(path)


@pytest.mark.parametrize("qtype", [None] + list(tquant.QTYPES))
def test_files_cross_between_the_packages(qtype, tmp_path):
    jp, tp = twins(qtype)
    tfile, jfile = str(tmp_path / "port.gxt"), str(tmp_path / "jax.gxt")
    tckpt.save(tfile, tp)
    jckpt.save(jfile, jp)
    assert header_entries(tfile) == header_entries(jfile)
    with open(tfile, "rb") as a, open(jfile, "rb") as b:
        assert a.read() == b.read()                     # the same bytes, blobs included
    t_from_j = tgru_bin.load_gru_checkpoint(jfile, device="cpu")
    assert_same_weights(t_from_j, jgru_bin.load_gru_checkpoint(tfile))
    # a load re-pads the stored logical planes with zeros (an in-memory q5_0
    # quantization holds 1s in its fifth-bit padding), so hold the loaded
    # weights to the in-memory ones by value
    for name, w in weights(tp).items():
        got = weights(t_from_j)[name]
        if isinstance(w, tquant.QTensor):
            w, got = w.dequantize(), got.dequantize()
        np.testing.assert_array_equal(got.numpy(), w.numpy(), err_msg=name)
    assert_same_weights(tckpt.load_into(jfile, tp, device="cpu"), jckpt.load_into(tfile, jp))
    if qtype:
        assert tp.cell.kernel.stored_nbytes == sum(
            e["nbytes"] for e in tckpt.read_header(tfile)["tensors"]
            if e["name"].startswith("cell/kernel."))


@pytest.mark.parametrize("qtype", ["q5_1", "q4_k"])
def test_float_gxt_quantizes_on_load(qtype, tmp_path):
    jp, tp = twins(None)
    path = str(tmp_path / "float.gxt")
    tckpt.save(path, tp)
    assert_same_weights(tgru_bin.load_gru_any(path, qtype=qtype, device="cpu"),
                        jgru_bin.load_gru_any(path, qtype=qtype))
    assert tgru_bin.load_gru_any(path, device="cpu").cell.kernel.dtype == torch.float32


def test_key_paths_dtypes_and_meta(tmp_path):
    """Dict keys sorted, sequences by index, None omitted, dataclass fields by
    name; bf16 through a 16-bit view; scalars; meta read without tensors."""
    tree = {
        "zeta": [torch.arange(6, dtype=torch.int32).reshape(2, 3), None,
                 (np.float32(2.5), np.int64(7))],
        "alpha": {"10": np.array([True, False]), "2": torch.ones(3).to(torch.bfloat16) * 1.5},
        "f16": np.arange(4, dtype=np.float16), "u8": np.arange(5, dtype=np.uint8),
    }
    jtree = {
        "zeta": [jnp.arange(6, dtype=jnp.int32).reshape(2, 3), None,
                 (np.float32(2.5), np.int64(7))],
        "alpha": {"10": np.array([True, False]), "2": jnp.ones(3, jnp.bfloat16) * 1.5},
        "f16": np.arange(4, dtype=np.float16), "u8": np.arange(5, dtype=np.uint8),
    }
    meta = {"kind": "demo", "config": {"units": 3}}
    tfile, jfile = str(tmp_path / "t.gxt"), str(tmp_path / "j.gxt")
    tckpt.save(tfile, tree, meta=meta)
    jckpt.save(jfile, jtree, meta=meta)
    names = [e["name"] for e in header_entries(tfile)]
    assert names == ["alpha/10", "alpha/2", "f16", "u8", "zeta/0", "zeta/2/0", "zeta/2/1"]
    assert header_entries(tfile) == header_entries(jfile)
    assert tckpt.read_meta(tfile) == meta == jckpt.read_meta(tfile)
    assert tckpt.read_meta(str(tmp_path / "t.gxt")) == tckpt.read_header(tfile)["meta"]
    for path in (tfile, jfile):
        flat = tckpt.load_arrays(path, device="cpu")
        assert flat["alpha/2"].dtype == torch.bfloat16 and flat["alpha/2"].tolist() == [1.5] * 3
        assert flat["alpha/10"].tolist() == [True, False]
        assert flat["zeta/0"].tolist() == [[0, 1, 2], [3, 4, 5]]
        assert float(flat["zeta/2/0"]) == 2.5 and int(flat["zeta/2/1"]) == 7
        assert flat["zeta/2/1"].dtype == torch.int64 and flat["f16"].dtype == torch.float16
    jflat = jckpt.load_arrays(tfile)
    assert jflat["alpha/2"].dtype == jnp.bfloat16 and np.asarray(jflat["u8"]).tolist() == [0, 1, 2, 3, 4]
    back = tckpt.load_into(tfile, tree, device="cpu")
    assert back["zeta"][1] is None and isinstance(back["zeta"][2], tuple)
    assert all(e["offset"] % tckpt.ALIGN == 0 for e in tckpt.read_header(tfile)["tensors"])


def test_atomic_write_bad_magic_and_truncation(tmp_path):
    _, tp = twins("q4_1")
    path = str(tmp_path / "a.gxt")
    tckpt.save(path, tp)
    tckpt.save(path, tp)                                 # overwrite in place
    assert sorted(os.listdir(tmp_path)) == ["a.gxt"]     # no .tmp left behind
    with pytest.raises(TypeError):
        tckpt.save(path, {"bad": np.zeros(2, np.complex64)})
    assert sorted(os.listdir(tmp_path)) == ["a.gxt"]     # a failed save removes its temp file
    assert tgru_bin.load_gru_any(path, device="cpu").cell.kernel.qtype == "q4_1"
    bad = tmp_path / "bad.gxt"
    bad.write_bytes(b"GGUF" + bytes(60))
    for fn in (tckpt.read_meta, lambda p: tckpt.load_arrays(p, device="cpu"),
               lambda p: tgru_bin.load_gru_any(p, device="cpu")):
        with pytest.raises(ValueError, match="GXT1"):
            fn(str(bad))
    data = open(path, "rb").read()
    cut = tmp_path / "cut.gxt"
    cut.write_bytes(data[: len(data) - 100])
    with pytest.raises(ValueError, match="truncated"):
        tckpt.load_arrays(str(cut), device="cpu")
    cut.write_bytes(data[:9])
    with pytest.raises(ValueError, match="truncated"):
        tckpt.read_meta(str(cut))
    with pytest.raises(KeyError, match="cell/kernel"):
        tckpt.save(path, {"embeddings": torch.zeros(2, 2)})
        tgru_bin.load_gru_checkpoint(path, device="cpu")
    with pytest.raises(KeyError, match="missing tensor"):
        tckpt.load_into(path, {"other": torch.zeros(1)}, device="cpu")


@pytest.mark.parametrize("qtype", ["q8_0", "q5_0", "q4_k"])
def test_padded_layout_of_older_files_loads(qtype, tmp_path):
    """Files from before the logical layout stored the padded planes and no
    "packed" mark; both loaders take them as they are."""
    w = np.random.default_rng(3).normal(0.1, 0.4, (70, 200)).astype(np.float32)
    tq = tquant.quantize(w, qtype, device="cpu")
    entries, blobs, off = [], [], 0
    for name in PLANES:
        t = getattr(tq, name)
        if t is None:
            continue
        a = t.numpy().astype(np.float16) if name == "supers" else t.numpy()
        off = (off + 63) // 64 * 64
        entries.append({"name": f"w.{name}", "dtype": str(a.dtype), "shape": list(a.shape),
                        "quant": {"qtype": qtype, "logical_shape": [70, 200]},
                        "offset": off, "nbytes": a.nbytes})
        blobs.append(a)
        off += a.nbytes
    header = json.dumps({"version": 1, "tensors": entries}).encode()
    path = tmp_path / "old.gxt"
    with open(path, "wb") as f:
        f.write(b"GXT1" + struct.pack("<Q", len(header)) + header)
        base = f.tell()
        for e, a in zip(entries, blobs):
            f.seek(base + e["offset"])
            f.write(a.tobytes())
    got = tckpt.load_arrays(str(path), device="cpu")["w"]
    want = jckpt.load_arrays(str(path))["w"]
    assert got.qtype == want.qtype == qtype and got.shape == (70, 200)
    for name in PLANES:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b, a.numpy().dtype))
    np.testing.assert_array_equal(got.dequantize().numpy(), tq.dequantize().numpy())


def test_checkpoint_manager_keeps_the_best(tmp_path):
    path = str(tmp_path / "best.gxt")
    mgr = tckpt.CheckpointManager(path)
    assert mgr.maybe_save({"x": torch.tensor([1.0])}, 2.0)
    assert not mgr.maybe_save({"x": torch.tensor([2.0])}, 3.0)
    assert mgr.maybe_save({"x": torch.tensor([3.0])}, 1.0) and mgr.best == 1.0
    assert tckpt.load_arrays(path, device="cpu")["x"].tolist() == [3.0]
    up = tckpt.CheckpointManager(path, best=0.0, mode="max")
    assert up.maybe_save({"x": torch.tensor([4.0])}, 0.5) and not up.maybe_save({}, 0.1)
