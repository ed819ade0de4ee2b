"""Port: AOT artifacts (serving/aot, the aot-export / aot-run commands) and the
custom ops they reach the kernels through, on the CPU against the JAX
package's artifacts.

An artifact replays ``generate`` / ``extract_features`` frozen at export:
the GRU tokens must equal eager ``generate`` and the JAX artifact's
``exp.call`` on the same carried-over parameters; the features must lie
within 1e-5 (relative to the largest) of both. The custom ops' CPU
implementations are the plain versions, bit for bit, and pass
``torch.library.opcheck``.
"""

import importlib
import io
import logging
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_experiments_tpu.formats.gru_bin import load_gru_params as jload_gru
from ggml_experiments_tpu.quant.qtensor import QTensor as JQTensor
from ggml_experiments_tpu.serving import aot as jaot
from ggml_experiments_tpu_torch import cli
from ggml_experiments_tpu_torch.convert import params_from_numpy
from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_params
from ggml_experiments_tpu_torch.models import gru_textgen
from ggml_experiments_tpu_torch.ops import flash_attention as fa
from ggml_experiments_tpu_torch.quant.qtensor import QTYPES, quantize
from ggml_experiments_tpu_torch.serving import aot

qmm = importlib.import_module("ggml_experiments_tpu_torch.quant.qmatmul")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
BIN = os.path.join(GOLD, "gru_small.bin")
MV = os.path.join(GOLD, "mobilevit_tiny.ggml")
SYNTH = os.path.join(REPO, "checkpoints", "gru_synth.bin")
B, P, T = 2, 8, 20


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def carried(jp):
    """The JAX GRU params carried into the port: floats by value, QTensors
    plane by plane."""
    def arr(w):
        if isinstance(w, JQTensor):
            return {"codes": np.asarray(w.codes), "scales": np.asarray(w.scales),
                    "shape": w.shape, "qtype": w.qtype,
                    **{n: np.asarray(getattr(w, n)) for n in ("mins", "hibits", "supers")
                       if getattr(w, n) is not None}}
        return np.asarray(w)

    return params_from_numpy({
        "embeddings": arr(jp.embeddings), "kernel": arr(jp.cell.kernel),
        "recurrent_kernel": arr(jp.cell.recurrent_kernel), "bias": arr(jp.cell.bias),
        "dense_kernel": arr(jp.dense_kernel), "dense_bias": arr(jp.dense_bias)}, device="cpu")


def prompt_batch():
    prompt = np.zeros((B, P), np.int32)
    prompt[:, :3] = [5, 9, 3]
    return prompt, np.full((B,), 3, np.int32)


_ARTIFACTS = {}


def gru_artifact(tmp_path_factory, qtype):
    """(JAX params, port params, the port artifact's path), exported once a
    qtype."""
    if qtype not in _ARTIFACTS:
        jp = jload_gru(BIN, qtype=qtype)
        tp = carried(jp)
        path = str(tmp_path_factory.mktemp("aot") / f"decode_{qtype}.gxa")
        aot.export_gru_decode(tp, batch=B, prompt_len=P, total_steps=T, path=path, qtype=qtype)
        _ARTIFACTS[qtype] = (jp, tp, path)
    return _ARTIFACTS[qtype]


@pytest.mark.parametrize("qtype", [None, "q8_0", "q5_1"])
def test_gru_decode_artifact_matches_eager_and_jax(tmp_path_factory, tmp_path, caplog, qtype):
    jp, tp, path = gru_artifact(tmp_path_factory, qtype)
    with caplog.at_level(logging.WARNING):
        meta, ep = aot.load_artifact(path)
    assert not any("weights_only=False" in r.getMessage() for r in caplog.records)
    assert meta["kind"] == "gru-decode" and meta["total_steps"] == T
    assert meta["device"] == "cpu" and meta["qtype"] == qtype and "torch" in meta
    prompt, lengths = prompt_batch()
    got = aot.call_artifact(ep, tp, torch.from_numpy(prompt), torch.from_numpy(lengths))
    want = gru_textgen.generate(tp, prompt, lengths, T)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    jpath = str(tmp_path / "decode_jax.gxa")
    jaot.export_gru_decode(jp, batch=B, prompt_len=P, total_steps=T, path=jpath)
    _, jexp = jaot.load_artifact(jpath)
    jgot = np.asarray(jexp.call(jp, jnp.asarray(prompt), jnp.asarray(lengths)))
    np.testing.assert_array_equal(got.numpy(), jgot)


def test_artifact_serves_other_weights_and_used_params(tmp_path_factory, rng):
    """One artifact, any params of the same shapes and qtype; params whose
    caches an eager call has filled are taken as they are."""
    _, tp, path = gru_artifact(tmp_path_factory, "q8_0")
    _, ep = aot.load_artifact(path)
    prompt, lengths = prompt_batch()

    def other(w):
        a = rng.standard_normal(tuple(w.shape)).astype(np.float32) * 0.3
        return quantize(a, "q8_0", device="cpu") if hasattr(w, "qtype") else torch.from_numpy(a)

    cell = tp.cell
    op = gru_textgen.GRUTextGenParams(
        embeddings=other(tp.embeddings),
        cell=type(cell)(kernel=other(cell.kernel), recurrent_kernel=other(cell.recurrent_kernel),
                        bias=other(cell.bias)),
        dense_kernel=other(tp.dense_kernel), dense_bias=other(tp.dense_bias))
    want = gru_textgen.generate(op, prompt, lengths, T)      # fills the QTensors' caches
    assert op.dense_kernel.dense and op.cell.kernel.dense
    op.cache["derived"] = torch.zeros(3)
    object.__setattr__(op.cell.recurrent_kernel, "_gxt_operands", ("stale", 1))
    got = aot.call_artifact(ep, op, torch.from_numpy(prompt), torch.from_numpy(lengths))
    assert torch.equal(got, want)
    assert not torch.equal(got, gru_textgen.generate(tp, prompt, lengths, T))


def test_mobilevit_features_artifact_matches_eager_and_jax(tmp_path):
    import sys

    import jax

    sys.path.insert(0, os.path.dirname(__file__))
    from test_golden_mobilevit import TINY

    from ggml_experiments_tpu.formats.ggml_named import read_named_tensors as jread
    from ggml_experiments_tpu.models import mobilevit as jmv
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
    from ggml_experiments_tpu_torch.models import mobilevit as tmv

    cfg = tmv.MobileViTConfig(image_size=TINY.image_size,
                              neck_hidden_sizes=TINY.neck_hidden_sizes,
                              hidden_sizes=TINY.hidden_sizes)
    # flash on: the program reaches the flash op (its CPU implementation)
    tp = tmv.from_named_tensors(read_named_tensors(MV), cfg, device="cpu", flash_attn=True)
    path = str(tmp_path / "feat.gxa")
    aot.export_mobilevit_features(tp, batch=1, image_size=cfg.image_size, path=path)
    meta, ep = aot.load_artifact(path)
    assert meta["kind"] == "mobilevit-features" and meta["image_size"] == cfg.image_size
    assert any("gxt.flash_mha" in str(n.target) for n in ep.graph.nodes)
    img = np.load(os.path.join(GOLD, "mobilevit_tiny.npz"))["image"][None]
    got = aot.call_artifact(ep, tp, torch.from_numpy(img)).numpy()
    want = tmv.extract_features(tp, torch.from_numpy(img)).numpy()
    jp = jmv.from_named_tensors(jread(MV), TINY)
    jpath = str(tmp_path / "feat_jax.gxa")
    jaot.export_mobilevit_features(jp, batch=1, image_size=TINY.image_size, path=jpath)
    _, jexp = jaot.load_artifact(jpath)
    jgot = np.asarray(jexp.call(jp, jax.numpy.asarray(img)))
    for ref in (want, jgot):
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_bad_magic_and_jax_artifacts_refused(tmp_path):
    path = str(tmp_path / "junk.gxa")
    with open(path, "wb") as f:
        f.write(b"NOPE" + b"\0" * 64)
    with pytest.raises(ValueError, match="not a GXA1"):
        aot.load_artifact(path)
    # what the JAX package's save_artifact writes: its header names jax
    header = b'{"version": 1, "jax": "0.9.0", "kind": "gru-decode"}'
    with open(path, "wb") as f:
        f.write(b"GXA1" + struct.pack("<Q", len(header)) + header + b"stablehlo")
    with pytest.raises(ValueError, match="made by the JAX package"):
        aot.load_artifact(path)


def test_artifact_holds_no_weights(tmp_path):
    """At full width (U = 1024) the artifact is the program alone: a few
    KB against the params' megabytes, whatever the number of steps."""
    tp = load_gru_params(SYNTH, qtype="q8_0", device="cpu")
    path = str(tmp_path / "wide.gxa")
    aot.export_gru_decode(tp, batch=1, prompt_len=2, total_steps=3, path=path, qtype="q8_0")
    planes = sum(t.numel() * t.element_size() for t in (
        tp.embeddings, tp.cell.bias, tp.dense_bias,
        *tp.cell.kernel.planes(), *tp.cell.recurrent_kernel.planes(), *tp.dense_kernel.planes()))
    assert os.path.getsize(path) < planes / 100


def test_aot_export_run_cli(tmp_path, capsys):
    """aot-export then aot-run on the CPU, the qtype defaulted from the
    artifact; a qtype or device other than the artifact's is refused."""
    art = str(tmp_path / "feat.gxa")
    assert cli.main(["aot-export", "--model", "mobilevit", "--weights", MV, "--output", art,
                     "--batch", "1", "--image-size", "64", "--qtype", "q8_0",
                     "--device", "cpu"]) == 0
    import json

    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["kind"] == "mobilevit-features" and rec["qtype"] == "q8_0"
    assert rec["image_size"] == 64 and rec["device"] == "cpu"
    assert cli.main(["aot-run", "--artifact", art, "--weights", MV, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "output feature shape" in out and "i0 = 0, i1 = 0" in out
    dec = str(tmp_path / "dec.gxa")
    assert cli.main(["aot-export", "--model", "gru", "--weights", BIN, "--output", dec,
                     "--batch", "1", "--prompt-len", "4", "--steps", "4", "--qtype", "q8_0",
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    assert cli.main(["aot-run", "--artifact", dec, "--weights", BIN, "--prompt", "RO",
                     "--device", "cpu"]) == 0
    text = capsys.readouterr().out.strip()
    assert text.startswith("RO") and len(text) == 4
    with pytest.raises(SystemExit, match="does not match the artifact"):
        cli.main(["aot-run", "--artifact", dec, "--weights", BIN, "--qtype", "q4_0",
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="exported for 'cpu'"):
        cli.main(["aot-run", "--artifact", dec, "--weights", BIN, "--device", "meta"])


@pytest.mark.parametrize("qtype", QTYPES)
def test_qmatmul_op_cpu_is_the_plain_version(rng, qtype):
    qt = quantize(rng.standard_normal((288, 100)).astype(np.float32), qtype, device="cpu")
    x = torch.from_numpy(rng.standard_normal((5, 288)).astype(np.float32))
    args = (qt.codes, qt.scales, qt.mins, qt.hibits, qt.supers, qt.qtype, 288, 100)
    for bf16 in (False, True):
        got = qmm.qmatmul_op(x, *args, bf16)
        want = qmm.qmatmul_reference(x, qt, torch.bfloat16 if bf16 else torch.float32)
        assert got.dtype == torch.float32 and torch.equal(got, want.float())
    torch.library.opcheck(qmm.qmatmul_op, (x, *args, False))


def test_flash_op_cpu_is_the_plain_version(rng):
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 16, 48)).astype(np.float32))
               for _ in range(3))
    assert torch.equal(fa.flash_mha_op(q, k, v, 4), fa.flash_mha_plain(q, k, v, 4))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    assert torch.equal(fa.flash_mha_op(qb, kb, vb, 4), fa.flash_mha_plain(qb, kb, vb, 4))
    torch.library.opcheck(fa.flash_mha_op, (q, k, v, 4))


def test_params_trees_round_trip_through_pytree():
    """Flattening keeps the tensors as leaves and the static fields in the
    context, drops the caches, and gives back equal trees; eager copies
    (dataclasses.replace) are untouched by the registration."""
    import dataclasses

    import torch.utils._pytree as pytree

    tp = carried(jload_gru(BIN, qtype="q4_k"))
    gru_textgen.generate(tp, *prompt_batch(), 2)          # fills the dense caches
    leaves, spec = pytree.tree_flatten(tp)
    # the planes a format lacks are None leaves
    assert all(isinstance(x, torch.Tensor) or x is None for x in leaves)
    assert sum(isinstance(x, torch.Tensor) for x in leaves) == 3 + 3 * 4
    back = pytree.tree_unflatten(leaves, spec)
    assert back.cell.recurrent_kernel.qtype == "q4_k" and back.dense_kernel.dense == {}
    assert back.cell.recurrent_kernel.shape == tp.cell.recurrent_kernel.shape
    assert pytree.tree_flatten(back)[1] == spec
    roundtrip = pytree.treespec_loads(pytree.treespec_dumps(spec))
    assert roundtrip == spec
    assert dataclasses.replace(tp, dense_bias=None).dense_bias is None
    buf = io.StringIO()
    print(spec, file=buf)
    assert "QTensor" in buf.getvalue()


def test_inverted_residual_f32_op_and_its_trace(rng):
    """The f32 fused block's op: its CPU implementation is the plain
    version (opcheck), and a traced f32 stride-1 block calls it. The model
    routes f32 to the kernel on a CUDA device only; the CPU keeps the JAX
    package's unfused chain."""
    from ggml_experiments_tpu_torch.models.mobilevit import InvertedResidualParams
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir
    from ggml_experiments_tpu_torch.ops.conv import ConvBNAct
    from ggml_experiments_tpu_torch.ops.norm import FoldedBN

    def t(*s):
        return torch.from_numpy((rng.standard_normal(s) * 0.2).astype(np.float32))

    def conv(kh, cin, co, dw=False, act="silu"):
        return ConvBNAct(kernel=t(kh, kh, cin, co), bn=FoldedBN(t(co) + 1.0, t(co)),
                         activation=act, depthwise=dw)

    blk = InvertedResidualParams(expand_1x1=conv(1, 8, 64), conv_3x3=conv(3, 1, 64, dw=True),
                                 reduce_1x1=conv(1, 64, 8, act="none"), use_residual=True,
                                 fused=True)
    assert blk.fused_route(torch.float32, "cuda") and blk.fused_route(torch.bfloat16, "cpu")
    assert not blk.fused_route(torch.float32, "cpu") and not blk.fused_route(torch.float32)
    x = t(2, 6, 7, 8) * 5
    args = fir._folded(blk)
    want = fir.fused_ir_plain(x, *args, use_residual=True)
    assert torch.equal(fir.inverted_residual_f32_op(x, *args, True), want)
    torch.library.opcheck(fir.inverted_residual_f32_op, (x, *args, True))

    class Block(torch.nn.Module):
        def forward(self, params, x):
            return fir.inverted_residual_fused(params, x, compute_dtype=torch.float32)

    ep = torch.export.export(Block(), (blk, x), strict=False)
    assert any("gxt.inverted_residual_f32" in str(n.target) for n in ep.graph.nodes)
    assert torch.equal(ep.module()(blk, x), want)


def test_inverted_residual_op_at_stride_2_and_a_features_trace(tmp_path, monkeypatch):
    """At stride 2 the op's fake gives (B, H/2, W/2, Cout) and its CPU
    implementation is the plain version (opcheck). A features artifact
    traced with the card's f32 route (``fused_route`` as it decides on a
    CUDA device, forced here) reaches the op once a fused block, the stride
    among the arguments: layer_2's stride-1 blocks at 1, the four
    downsamplers at 2; replayed here, its features equal eager
    ``extract_features`` on the same route, and lie within 1e-5 of the
    JAX package's unfused forward (BN folded: f32 rounding only)."""
    import sys

    import jax
    from torch._subclasses.fake_tensor import FakeTensorMode

    sys.path.insert(0, os.path.dirname(__file__))
    from test_golden_mobilevit import TINY

    from ggml_experiments_tpu.formats.ggml_named import read_named_tensors as jread
    from ggml_experiments_tpu.models import mobilevit as jmv
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
    from ggml_experiments_tpu_torch.models import mobilevit as tmv
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir

    rng = np.random.default_rng(15)
    args = tuple(torch.from_numpy((rng.standard_normal(s) * 0.2).astype(np.float32))
                 for s in ((16, 64), (64,), (3, 3, 64), (64,), (64, 24), (24,)))
    x = torch.from_numpy(rng.standard_normal((2, 10, 6, 16)).astype(np.float32))
    want = fir.fused_ir_plain(x, *args, stride=2)
    assert want.shape == (2, 5, 3, 24)
    assert torch.equal(fir.inverted_residual_f32_op(x, *args, False, 2), want)
    torch.library.opcheck(fir.inverted_residual_f32_op, (x, *args, False, 2))
    with FakeTensorMode() as mode:
        fake = fir.inverted_residual_f32_op(mode.from_tensor(x),
                                            *(mode.from_tensor(a) for a in args), False, 2)
    assert fake.shape == (2, 5, 3, 24) and fake.dtype == torch.float32

    route = tmv.InvertedResidualParams.fused_route
    monkeypatch.setattr(tmv.InvertedResidualParams, "fused_route",
                        lambda self, cd, device=None, hw=None: route(self, cd, "cuda", hw))
    cfg = tmv.MobileViTConfig(image_size=TINY.image_size,
                              neck_hidden_sizes=TINY.neck_hidden_sizes,
                              hidden_sizes=TINY.hidden_sizes)
    tp = tmv.from_named_tensors(read_named_tensors(MV), cfg, device="cpu", fused_ir=True)
    blocks = [*tp.layer_1, *tp.layer_2, tp.layer_3.downsampling, tp.layer_4.downsampling,
              tp.layer_5.downsampling]
    strides = sorted(b.conv_3x3.stride for b in blocks if b.fused_route(torch.float32))
    assert strides == [1, 1, 2, 2, 2, 2]
    path = str(tmp_path / "feat_s2.gxa")
    aot.export_mobilevit_features(tp, batch=1, image_size=cfg.image_size, path=path)
    _, ep = aot.load_artifact(path)
    nodes = [n for n in ep.graph.nodes if "gxt.inverted_residual_f32" in str(n.target)]
    # the graph keeps an argument that differs from the schema's default (1)
    assert sorted(n.args[8] if len(n.args) > 8 else 1 for n in nodes) == strides
    img = np.load(os.path.join(GOLD, "mobilevit_tiny.npz"))["image"][None]
    got = aot.call_artifact(ep, tp, torch.from_numpy(img))
    assert torch.equal(got, tmv.extract_features(tp, torch.from_numpy(img)))
    jgot = np.asarray(jmv.extract_features(jmv.from_named_tensors(jread(MV), TINY),
                                           jax.numpy.asarray(img)))
    assert np.abs(got.numpy() - jgot).max() <= 1e-5 * np.abs(jgot).max()


def test_transformer_layer_f32_op_and_a_features_trace(tmp_path, monkeypatch):
    """The f32 fused layer's op: its fake gives (bp, L, Cout), its CPU
    implementation is the plain version (opcheck). A features artifact
    traced with the card's f32 layer route (``fused_route`` as it decides on
    a CUDA device, forced here) reaches the op once a routed layer (the tiny
    model's layer_3, L = 16: its block folds conv_1x1 into the first and its
    LN and conv_projection into the last); replayed here, its features meet
    eager ``extract_features`` on the same route within 1e-5 of the largest
    (the features artifact's contract: the traced graph's convolutions
    round apart from eager's, about 2e-6 here, on the route or off it), and
    the JAX package's unfused forward within the same."""
    import sys

    import jax
    from torch._subclasses.fake_tensor import FakeTensorMode

    sys.path.insert(0, os.path.dirname(__file__))
    from test_golden_mobilevit import TINY

    from ggml_experiments_tpu.formats.ggml_named import read_named_tensors as jread
    from ggml_experiments_tpu.models import mobilevit as jmv
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
    from ggml_experiments_tpu_torch.models import mobilevit as tmv
    from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl

    rng = np.random.default_rng(16)

    def t(*s, off=0.0):
        return torch.from_numpy((rng.standard_normal(s) * 0.2 + off).astype(np.float32))

    c, f, cin, cout = 24, 48, 16, 20
    weights = [t(c, c), t(c, c), t(c, c), t(c, c), t(c, f), t(f, c)]
    vectors = [t(c, off=1.0), t(c), t(c), t(c), t(c), t(c), t(c, off=1.0), t(c), t(f), t(c)]
    block = (t(cin, c), t(c, off=1.0), t(c), t(c, cout), t(cout, off=1.0), t(cout))
    x = t(3, 8, cin) * 5
    args = (x, weights, vectors, 4, 1e-5, 1e-6, *block, True)
    want = ftl.fused_transformer_layer_plain(x, ftl._op_operands(*args))
    assert want.shape == (3, 8, cout)
    assert torch.equal(ftl.transformer_layer_f32_op(*args), want)
    torch.library.opcheck(ftl.transformer_layer_f32_op, args)
    torch.library.opcheck(ftl.transformer_layer_f32_op,
                          (t(3, 8, c), weights, vectors, 4, 1e-5, 1e-5, None, None, None, None,
                           None, None, False))
    with FakeTensorMode() as mode:
        fake = ftl.transformer_layer_f32_op(
            mode.from_tensor(x), [mode.from_tensor(w) for w in weights],
            [mode.from_tensor(v) for v in vectors], 4, 1e-5, 1e-6,
            *(mode.from_tensor(b) for b in block), True)
    assert fake.shape == (3, 8, cout) and fake.dtype == torch.float32

    route = tmv.TransformerLayerParams.fused_route
    monkeypatch.setattr(tmv.TransformerLayerParams, "fused_route",
                        lambda self, cd, device=None, l=None, cin=None:
                        route(self, cd, "cuda", l, cin))
    cfg = tmv.MobileViTConfig(image_size=TINY.image_size,
                              neck_hidden_sizes=TINY.neck_hidden_sizes,
                              hidden_sizes=TINY.hidden_sizes)
    tp = tmv.from_named_tensors(read_named_tensors(MV), cfg, device="cpu", fused_layer=True)
    routed = [layer for blk in (tp.layer_3, tp.layer_4, tp.layer_5) for layer in blk.transformer
              if layer.fused_route(torch.float32, None, 16)]
    path = str(tmp_path / "feat_layer.gxa")
    aot.export_mobilevit_features(tp, batch=1, image_size=cfg.image_size, path=path)
    _, ep = aot.load_artifact(path)
    nodes = [n for n in ep.graph.nodes if "gxt.transformer_layer_f32" in str(n.target)]
    assert len(nodes) == len(tp.layer_3.transformer) and len(routed) == len(nodes) + sum(
        len(b.transformer) for b in (tp.layer_4, tp.layer_5))
    img = np.load(os.path.join(GOLD, "mobilevit_tiny.npz"))["image"][None]
    got = aot.call_artifact(ep, tp, torch.from_numpy(img)).numpy()
    want = tmv.extract_features(tp, torch.from_numpy(img)).numpy()
    jgot = np.asarray(jmv.extract_features(jmv.from_named_tensors(jread(MV), TINY),
                                           jax.numpy.asarray(img)))
    for ref in (want, jgot):
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
