"""Port: MobileViT on the CPU against the JAX package and the TF goldens.

Ops and the loader at f32 within 1e-5 of the JAX package on the same numpy
inputs; ``weight.ggml`` bytes equal to the JAX writer's; features against the
TF goldens at the JAX package's own tolerances; the f32 forward within 1e-4
of the JAX forward; bf16 with the kernel routes on against the JAX forward
with the same routes (the JAX model test's tolerance); the q8_0 top-1
contract on the trained tiny checkpoint; the data generator, the q4_k_m
``.gxt`` load and the CLI.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_experiments_tpu.formats import checkpoint as jckpt
from ggml_experiments_tpu.formats import ggml_named as jnamed
from ggml_experiments_tpu.models import mobilevit as jmv
from ggml_experiments_tpu.quant.qtensor import QTensor as JQTensor
from ggml_experiments_tpu_torch import cli
from ggml_experiments_tpu_torch.convert import mobilevit_params_from_numpy
from ggml_experiments_tpu_torch.formats import checkpoint as tckpt
from ggml_experiments_tpu_torch.formats import ggml_named as tnamed
from ggml_experiments_tpu_torch.models import mobilevit as tmv
from ggml_experiments_tpu_torch.ops import conv as tconv
from ggml_experiments_tpu_torch.ops import norm as tnorm
from ggml_experiments_tpu_torch.ops import patches as tpatches
from ggml_experiments_tpu_torch.ops.attention import AttentionParams, multi_head_attention
from ggml_experiments_tpu_torch.quant.qtensor import QTensor
from ggml_experiments_tpu_torch.training import image_task as timg
from ggml_experiments_tpu_torch.utils import image as timage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
TINY_GGML = os.path.join(GOLD, "mobilevit_tiny.ggml")
SYNTH = os.path.join(REPO, "checkpoints", "mobilevit_synth.ggml")
Q4KM = os.path.join(REPO, "checkpoints", "mobilevit_synth_full_q4km.gxt")
TINY = tmv.MobileViTConfig(image_size=64, neck_hidden_sizes=(8, 16, 24, 32, 40, 48, 96),
                           hidden_sizes=(24, 32, 40))
# layer_2 expands 32 -> 128 channels, so its stride-1 blocks take the fused
# inverted residual's gate at 64 px; layer_3 (16 patches) takes the fused layer
ROUTES = tmv.MobileViTConfig(image_size=64, neck_hidden_sizes=(8, 32, 32, 32, 40, 48, 96),
                             hidden_sizes=(24, 32, 40), num_transformer_layers=(2, 1, 1))
CPU = "cpu"


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def jflat(params):
    """The JAX params' leaves by checkpoint key path; QTensors as planes."""
    leaves = jax.tree_util.tree_flatten_with_path(
        params, is_leaf=lambda x: isinstance(x, JQTensor))[0]
    out = {}
    for kp, leaf in leaves:
        if isinstance(leaf, JQTensor):
            out[jckpt._keystr(kp)] = {
                "codes": np.asarray(leaf.codes), "scales": np.asarray(leaf.scales),
                "shape": leaf.shape, "qtype": leaf.qtype,
                **{n: np.asarray(getattr(leaf, n)) for n in ("mins", "hibits", "supers")
                   if getattr(leaf, n) is not None}}
        else:
            out[jckpt._keystr(kp)] = np.asarray(leaf)
    return out


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def tiny_named():
    return tnamed.read_named_tensors(TINY_GGML)


# ---- ops -----------------------------------------------------------------------


def test_layer_norm_and_batchnorm_fold_match_jax(rng):
    from ggml_experiments_tpu.ops import norm as jnorm

    x = rng.standard_normal((3, 5, 40)).astype(np.float32) * 3 + 1
    g, b = rng.standard_normal(40).astype(np.float32), rng.standard_normal(40).astype(np.float32)
    want = np.asarray(jnorm.layer_norm(jnp.asarray(x), g, b, eps=1e-5))
    assert rel_err(tnorm.layer_norm(T(x), T(g), T(b), eps=1e-5), want) < 1e-5
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tnorm.layer_norm(xb, T(g), T(b)).dtype == torch.bfloat16
    stats = [np.abs(rng.standard_normal(16)).astype(np.float32) + 0.1 for _ in range(4)]
    jbn = jnorm.fold_batchnorm(*(jnp.asarray(s) for s in stats), eps=1e-3)
    tbn = tnorm.fold_batchnorm(*(T(s) for s in stats), eps=1e-3)
    assert rel_err(tbn.scale, jbn.scale) < 1e-6 and rel_err(tbn.bias, jbn.bias) < 1e-6
    assert [f.name for f in dataclasses.fields(tbn)] == ["scale", "bias"]


@pytest.mark.parametrize("stride,depthwise,dilation,act", [
    (1, False, 1, "silu"), (2, False, 1, "none"), (1, True, 1, "silu"), (2, True, 1, "silu"),
    (1, False, 2, "silu")])
def test_conv_bn_act_matches_jax(rng, stride, depthwise, dilation, act):
    from ggml_experiments_tpu.ops.conv import ConvBNAct as JConv
    from ggml_experiments_tpu.ops.norm import FoldedBN as JBN

    cin, cout = (12, 12) if depthwise else (6, 10)
    k = (rng.standard_normal((3, 3, 1 if depthwise else cin, cout)) * 0.3).astype(np.float32)
    sc, bi = (rng.uniform(0.5, 1.5, cout).astype(np.float32),
              rng.standard_normal(cout).astype(np.float32))
    x = rng.standard_normal((2, 9, 10, cin)).astype(np.float32)
    kw = dict(activation=act, stride=stride, depthwise=depthwise, dilation=dilation)
    jc = JConv(kernel=jnp.asarray(k), bn=JBN(jnp.asarray(sc), jnp.asarray(bi)), **kw)
    tc = tconv.ConvBNAct(kernel=T(k), bn=tnorm.FoldedBN(T(sc), T(bi)), **kw)
    assert rel_err(tc(T(x)), jc(jnp.asarray(x))) < 1e-5
    # bf16: the conv's result rounded to bf16, BN and the activation in bf16
    want = np.asarray(jc(jnp.asarray(x), compute_dtype=jnp.bfloat16).astype(jnp.float32))
    got = tc(T(x), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.02 * np.abs(want).max(),
                               rtol=0.02)
    # static configuration stays out of the checkpoint's key paths
    assert [name for name, _ in tckpt._flatten(tc)] == ["kernel", "bn/scale", "bn/bias"]


def test_unfold_fold_are_the_jax_permutations(rng):
    from ggml_experiments_tpu.ops import patches as jpatches

    x = rng.standard_normal((2, 8, 6, 5)).astype(np.float32)
    u = tpatches.unfold(T(x), 2)
    np.testing.assert_array_equal(u.numpy(), np.asarray(jpatches.unfold(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(tpatches.fold(u, 2, 8, 6).numpy(), x)
    with pytest.raises(ValueError):
        tpatches.unfold(T(x[:, :7]), 2)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_multi_head_attention_matches_jax(rng, flash, cd):
    from ggml_experiments_tpu.ops.attention import AttentionParams as JAtt
    from ggml_experiments_tpu.ops.attention import multi_head_attention as jmha

    c, h = 24, 4
    w = {n: (rng.standard_normal(s) * 0.2).astype(np.float32) for n, s in
         (("wq", (c, c)), ("bq", (c,)), ("wk", (c, c)), ("bk", (c,)), ("wv", (c, c)),
          ("bv", (c,)), ("wo", (c, c)), ("bo", (c,)))}
    x = rng.standard_normal((2, 3, 16, c)).astype(np.float32)
    jp = JAtt(**{n: jnp.asarray(a) for n, a in w.items()}, num_heads=h, flash=flash)
    tp = AttentionParams(**{n: T(a) for n, a in w.items()}, num_heads=h, flash=flash)
    want = np.asarray(jmha(jp, jnp.asarray(x), compute_dtype=jnp.dtype(cd)).astype(jnp.float32))
    got = multi_head_attention(tp, T(x), compute_dtype=cd).float().numpy()
    if cd == "float32":
        assert rel_err(got, want) < 1e-5
    else:
        np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)


# ---- the named-tensor file and the loader ---------------------------------------


def test_named_tensor_file_round_trip_is_the_jax_writers(tmp_path, tiny_named):
    jnt = jnamed.read_named_tensors_py(TINY_GGML)
    assert list(tiny_named) == list(jnt) and len(tiny_named) == 313
    assert all(np.array_equal(tiny_named[k], jnt[k]) for k in jnt)
    path = str(tmp_path / "rt.ggml")
    tnamed.write_named_tensors(path, list(tiny_named.items()))
    with open(path, "rb") as a, open(TINY_GGML, "rb") as b:
        assert a.read() == b.read()


def test_named_tensor_file_truncation_errors(tmp_path):
    with open(TINY_GGML, "rb") as f:
        data = f.read()
    for cut, err in ((2, EOFError), (7, EOFError), (200, EOFError)):
        p = tmp_path / f"cut{cut}.ggml"
        p.write_bytes(data[:cut])
        with pytest.raises(err):
            tnamed.read_named_tensors(str(p))
        with pytest.raises(err):
            jnamed.read_named_tensors_py(str(p))
    bad = tmp_path / "bad.ggml"
    bad.write_bytes(b"\xff\xff\xff\x7f" + data[4:64])
    with pytest.raises(ValueError, match="name length"):
        tnamed.read_named_tensors(str(bad))


def test_infer_config_and_random_tensors_match_jax(tiny_named):
    assert dataclasses.asdict(tmv.infer_config(tiny_named, image_size=64)) == \
        dataclasses.asdict(jmv.infer_config(tiny_named, image_size=64))
    a = tmv.random_named_tensors(ROUTES, seed=3, classifier=True)
    b = jmv.random_named_tensors(jmv.MobileViTConfig(**dataclasses.asdict(ROUTES)), seed=3,
                                 classifier=True)
    assert list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_loader_matches_jax_leaf_by_leaf(tiny_named):
    """from_named_tensors: the same key paths, BN folded within 1e-6, q8_0
    planes bit-equal, static configuration equal."""
    got = dict(tckpt._flatten(tmv.from_named_tensors(tiny_named, TINY, qtype="q8_0",
                                                     device=CPU)))
    want = jflat(jmv.from_named_tensors(tiny_named, jmv.MobileViTConfig(
        **dataclasses.asdict(TINY)), qtype="q8_0"))
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert isinstance(g, QTensor) and g.qtype == "q8_0" and g.shape == w["shape"]
            np.testing.assert_array_equal(g.codes.numpy(), w["codes"])
            np.testing.assert_array_equal(g.scales.numpy(), w["scales"])
        else:
            assert rel_err(g, w) < 1e-6, k
    p = tmv.from_named_tensors(tiny_named, TINY, device=CPU)
    assert p.layer_3.downsampling.conv_3x3.stride == 2 and not p.layer_3.downsampling.use_residual
    assert p.layer_2[1].use_residual and p.layer_3.transformer[0].attention.num_heads == 4
    assert p.layer_1[0].reduce_1x1.activation == "none" and p.layer_3.conv_1x1.bn is None


def test_loader_errors_and_unported_options(tiny_named):
    broken = dict(tiny_named)
    del broken["tf_mobile_vi_t_model/mobilevit/conv_stem/convolution/kernel:0"]
    with pytest.raises(KeyError, match="conv_stem"):
        tmv.from_named_tensors(broken, TINY, device=CPU)
    extra = dict(tiny_named, **{"tf_mobile_vi_t_model/mobilevit/bogus/kernel:0":
                                np.zeros((1, 1), np.float32)})
    with pytest.raises(ValueError, match="unused weights"):
        tmv.from_named_tensors(extra, TINY, strict=True, device=CPU)
    p = tmv.from_named_tensors(extra, TINY, device=CPU)
    with pytest.raises(ValueError, match="classifier"):
        tmv.classify(p, torch.zeros((1, 64, 64, 3)))
    for kw in (dict(conv_dtype="bfloat16"), dict(stem_space_to_depth=True),
               dict(act_storage="f8_e5m2")):
        with pytest.raises(NotImplementedError, match="item 6"):
            tmv.from_named_tensors(tiny_named, TINY, device=CPU, **kw)
    with pytest.raises(NotImplementedError, match="item 6"):
        timg.train_model({}, None, None)


# ---- the forward against the TF goldens and the JAX package ----------------------


def test_features_match_tf_goldens(tiny_named):
    gold = np.load(os.path.join(GOLD, "mobilevit_tiny.npz"))
    p = tmv.from_named_tensors(tiny_named, TINY, device=CPU)
    feats = tmv.extract_features(p, T(gold["image"])[None]).numpy()
    want = gold["features_chw"].transpose(0, 2, 3, 1)
    assert feats.shape == want.shape == (1, 2, 2, 96)
    np.testing.assert_allclose(feats, want, rtol=1e-3, atol=2e-4)
    p16 = tmv.from_named_tensors(tiny_named, TINY, conv_dtype="float16", device=CPU)
    np.testing.assert_allclose(tmv.extract_features(p16, T(gold["image"])[None]).numpy(),
                               want, rtol=0.05, atol=0.05)


def test_full_config_features_match_tf_golden():
    gold = np.load(os.path.join(GOLD, "mobilevit_full.npz"))
    cfg = tmv.MobileViTConfig()
    p = tmv.from_named_tensors(tmv.random_named_tensors(cfg, seed=int(gold["seed"])), cfg,
                               device=CPU)
    feats = tmv.extract_features(p, T(timage.synthetic_test_image(256))[None]).numpy()
    want = gold["features_chw"].transpose(0, 2, 3, 1)
    assert feats.shape == want.shape == (1, 8, 8, 640)
    np.testing.assert_allclose(feats, want, rtol=2e-3, atol=5e-4)


def test_classifier_logits_match_tf_golden():
    named = tnamed.read_named_tensors(os.path.join(GOLD, "mobilevit_cls_tiny.ggml"))
    gold = np.load(os.path.join(GOLD, "mobilevit_cls_tiny.npz"))
    p = tmv.from_named_tensors(named, TINY, device=CPU)
    logits = tmv.classify(p, T(gold["image"])[None]).numpy()
    np.testing.assert_allclose(logits, gold["logits"], rtol=1e-3, atol=2e-4)


@pytest.fixture(scope="module")
def routes_model():
    named = tmv.random_named_tensors(ROUTES, seed=7, classifier=True)
    jcfg = jmv.MobileViTConfig(**dataclasses.asdict(ROUTES))
    imgs = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    return named, jcfg, imgs


def test_f32_forward_matches_jax_on_carried_parameters(routes_model):
    """The JAX package's parameters carried across by key path: features and
    logits within 1e-4, through the einsum route and the flash route."""
    named, jcfg, imgs = routes_model
    jp = jmv.from_named_tensors(named, jcfg, flash_attn=False, fused_layer=False)
    want_f = np.asarray(jax.jit(jmv.extract_features)(jp, jnp.asarray(imgs)))
    # the JAX head on the JAX features (one compiled forward, not two)
    want_l = (want_f.mean(axis=(1, 2)).astype(np.float64) @ np.asarray(jp.classifier_kernel)
              + np.asarray(jp.classifier_bias))
    for flash in (False, True):
        tp = mobilevit_params_from_numpy(jflat(jp), ROUTES, device=CPU, flash_attn=flash)
        assert tp.layer_3.transformer[0].attention.flash == flash
        assert rel_err(tmv.extract_features(tp, T(imgs)), want_f) < 1e-4
        assert rel_err(tmv.classify(tp, T(imgs)), want_l) < 1e-4


def test_bf16_kernel_routes_match_jax(routes_model):
    """bf16 with fused_ir, flash_attn and fused_layer on: layer_2's stride-1
    blocks take the fused inverted residual, layer_3 (16 patches) the fused
    layer with its projections, layer_4/5 (4 and 1 patches) the unfused
    route; against the JAX forward with the same flags."""
    from ggml_experiments_tpu_torch.ops import fused_inverted_residual as fir
    from ggml_experiments_tpu_torch.ops import fused_transformer_layer as ftl

    named, jcfg, imgs = routes_model
    flags = dict(fused_ir=True, flash_attn=True, fused_layer=True)
    jp = jmv.from_named_tensors(named, jcfg, **flags)
    want = np.asarray(jax.jit(lambda p, x: jmv.extract_features(p, x, compute_dtype=jnp.bfloat16))(
        jp, jnp.asarray(imgs)))
    tp = tmv.from_named_tensors(named, ROUTES, device=CPU, **flags)
    calls = {"ir": 0, "layer": 0}
    real_ir, real_layer = fir.fused_ir_plain, ftl.fused_transformer_layer_plain

    def count(key, fn):
        def inner(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return inner

    fir.fused_ir_plain = count("ir", real_ir)
    ftl.fused_transformer_layer_plain = count("layer", real_layer)
    try:
        got = tmv.extract_features(tp, T(imgs), compute_dtype=torch.bfloat16).numpy()
    finally:
        fir.fused_ir_plain, ftl.fused_transformer_layer_plain = real_ir, real_layer
    assert calls == {"ir": 2, "layer": 2}
    np.testing.assert_allclose(got, want, atol=0.1 * np.abs(want).max(), rtol=0.1)


# ---- the trained tiny classifier, the data, the checkpoint --------------------------


def test_classify_q8_0_contract_on_the_trained_checkpoint():
    """The Δtop-1 contract of tests/test_trained_classifier.py, on 120 held-out
    images from the JAX package's generator."""
    from ggml_experiments_tpu.training.image_task import HELDOUT_SEED, make_dataset

    images, labels = make_dataset(120, seed=HELDOUT_SEED, image_size=64)
    preds = {}
    for qt in (None, "q8_0"):
        p = tmv.load_mobilevit(SYNTH, config=timg.TINY_CLS_CONFIG, qtype=qt, device=CPU)
        preds[qt] = np.concatenate([tmv.classify(p, T(images[i:i + 60])).argmax(-1).numpy()
                                    for i in range(0, 120, 60)])
    acc = {qt: float((pr == labels).mean()) for qt, pr in preds.items()}
    assert 0.85 <= acc[None] <= 0.985, acc
    assert (preds["q8_0"] == preds[None]).mean() >= 0.99
    assert acc[None] - acc["q8_0"] <= 0.009


@pytest.mark.parametrize("size,amp", [(64, 1.0), (256, 0.5)])
def test_make_dataset_is_bit_equal_to_jax(size, amp):
    from ggml_experiments_tpu.training import image_task as jimg

    a = timg.make_dataset(6, seed=timg.HELDOUT_SEED, image_size=size, amp_factor=amp)
    b = jimg.make_dataset(6, seed=jimg.HELDOUT_SEED, image_size=size, amp_factor=amp)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert (timg.HELDOUT_SEED, timg.FULL_AMP_FACTOR, timg.NUM_CLASSES) == \
        (jimg.HELDOUT_SEED, jimg.FULL_AMP_FACTOR, jimg.NUM_CLASSES)


def test_q4_k_m_checkpoint_loads_every_leaf_equal_to_jax():
    got = dict(tckpt._flatten(tmv.load_mobilevit(Q4KM, device=CPU)))
    want = jflat(jmv.load_mobilevit(Q4KM, flash_attn=False, fused_layer=False))
    assert list(got) == list(want) and len(want) > 150
    n_q = 0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            n_q += 1
            assert isinstance(g, QTensor) and g.qtype == w["qtype"] and g.shape == w["shape"]
            for name in ("codes", "scales", "mins", "hibits", "supers"):
                gp = getattr(g, name)
                assert (gp is None) == (name not in w), (k, name)
                if gp is not None:
                    np.testing.assert_array_equal(gp.numpy(), w[name], err_msg=f"{k}.{name}")
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
    assert n_q > 40


# ---- images and the CLI -------------------------------------------------------------


def test_image_utils_match_jax(tmp_path, rng):
    from ggml_experiments_tpu.utils import image as jimage
    from ggml_experiments_tpu.utils import image_codecs as jcodecs

    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    np.testing.assert_array_equal(timage.synthetic_test_image(64),
                                  jimage.synthetic_test_image(64))
    np.testing.assert_array_equal(timage.bilinear_resize_u8(img, 20, 29, 1.8),
                                  jimage.bilinear_resize_u8_py(img, 20, 29, 1.8))
    np.testing.assert_array_equal(timage.preprocess(img, 64), jimage.preprocess(img, 64))
    np.testing.assert_array_equal(timage.preprocess_canvas_u8(img, 64),
                                  jimage.preprocess_canvas_u8(img, 64))
    ppm = tmp_path / "x.ppm"
    ppm.write_bytes(b"P6\n53 37\n255\n" + img.tobytes())
    np.testing.assert_array_equal(timage.load_image(str(ppm)), img)
    np.testing.assert_array_equal(timage.load_and_preprocess(str(ppm), 64),
                                  jimage.load_and_preprocess(str(ppm), 64))
    assert jcodecs.decode(ppm.read_bytes()).shape == img.shape


def test_cli_features_and_classify_match_the_jax_commands(capsys):
    from ggml_experiments_tpu import cli as jcli

    args = ["features", "--weights", TINY_GGML, "--image-size", "64", "--no-flash-attn",
            "--no-fused-layer"]
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert jcli.main(args) == 0
    want = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] == "output feature shape: : Dims: (2, 2, 96)"
    gv = [float(v) for v in got[3].replace("...", "").split(",") if v.strip()]
    wv = [float(v) for v in want[3].replace("...", "").split(",") if v.strip()]
    np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-5)
    args = ["classify", "--weights", SYNTH, "--image-size", "64", "--top-k", "3",
            "--qtype", "q8_0"]
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = [ln.split(":")[0] for ln in capsys.readouterr().out.splitlines()]
    assert jcli.main(args) == 0
    want = [ln.split(":")[0] for ln in capsys.readouterr().out.splitlines()]
    assert got == want and len(got) == 3
    with pytest.raises(NotImplementedError, match="item 4"):
        cli.main(["serve-vision", "--weights", SYNTH])


def test_cli_runs_the_q4_k_m_checkpoint_on_cpu(capsys):
    assert cli.main(["classify", "--weights", Q4KM, "--top-k", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all(ln.startswith("class ") for ln in out)
