"""Port: sub-bf16 activation storage, the space-to-depth stem and bf16
convolution kernels, against the JAX package.

The contracts of ``tests/test_act_storage.py`` on the port: the f32 route is
untouched, the scopes stamp what the JAX package stamps, f8 boundaries
materialize on the bf16 path, the feature noise of the trained full-size
checkpoint is bounded ('early' < 0.35, 'early' < 'all' < 0.45), and the
trained tiny classifier keeps >= 0.9 agreement. Then, on the same inputs as
the JAX package: the bf16 forward under each storage dtype with the fused
inverted residual and the fused layer (their plain versions here) within the
port's bf16 tolerance of the JAX forward with the same flags; the
space-to-depth stem within 1e-5 of the standard stem at f32; bf16-stored
convolution kernels within 1e-4 of the JAX forward.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_experiments_tpu.models import mobilevit as jmv
from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
from ggml_experiments_tpu_torch.models import mobilevit as tmv
from ggml_experiments_tpu_torch.ops.conv import SpaceToDepthStem, space_to_depth_stem
from ggml_experiments_tpu_torch.training import image_task as timg

CKPTS = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
CKPT_FULL = os.path.join(CKPTS, "mobilevit_synth_full.ggml")
CKPT_TINY = os.path.join(CKPTS, "mobilevit_synth.ggml")
CPU = "cpu"
bf16 = torch.bfloat16

TINY = tmv.MobileViTConfig(image_size=64, hidden_sizes=(16, 24, 32),
                           neck_hidden_sizes=(8, 16, 16, 24, 32, 40, 64),
                           num_transformer_layers=(1, 1, 1))
# layer_2's stride-1 blocks take the fused inverted residual at 64 px and
# layer_3 (16 patches) the fused layer (tests/test_torch_mobilevit.py's ROUTES)
ROUTES = tmv.MobileViTConfig(image_size=64, neck_hidden_sizes=(8, 32, 32, 32, 40, 48, 96),
                             hidden_sizes=(24, 32, 40), num_transformer_layers=(2, 1, 1))


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny_named():
    return tmv.random_named_tensors(TINY, seed=3)


def _stores(tree, prefix=""):
    """{path: store} of every module with a ``store`` field, port or JAX."""
    out = {}
    if hasattr(tree, "store"):
        out[prefix] = tree.store
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(_stores(getattr(tree, f.name), f"{prefix}/{f.name}"))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            out.update(_stores(item, f"{prefix}/{i}"))
    return out


def _jcfg(cfg):
    return jmv.MobileViTConfig(**dataclasses.asdict(cfg))


def test_f32_route_untouched(tiny_named):
    imgs = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 64, 64, 3))
                            .astype(np.float32))
    base = tmv.from_named_tensors(tiny_named, TINY, device=CPU)
    f8 = tmv.from_named_tensors(tiny_named, TINY, act_storage="f8_e5m2", device=CPU)
    torch.testing.assert_close(tmv.extract_features(f8, imgs), tmv.extract_features(base, imgs),
                               rtol=0, atol=0)


def test_stamp_scopes(tiny_named):
    base = tmv.from_named_tensors(tiny_named, TINY, device=CPU)
    early = tmv._stamp_act_storage(base, "f8_e5m2")  # default scope
    assert early.conv_stem.store == "f8_e5m2"
    assert early.layer_2[0].expand_1x1.store == "f8_e5m2"
    assert early.layer_3.downsampling.conv_3x3.store == "f8_e5m2"
    # the boundaries feeding the transformer layers and the f32 output stay
    assert early.layer_3.conv_kxk.store == "none"
    assert early.layer_3.fusion.store == "none"
    assert early.layer_4.downsampling.expand_1x1.store == "none"
    assert early.conv_1x1_exp.store == "none"
    full = tmv._stamp_act_storage(base, "f8_e5m2", scope="all")
    assert full.layer_4.downsampling.expand_1x1.store == "f8_e5m2"
    assert full.layer_5.fusion.store == "f8_e5m2"
    assert full.layer_5.conv_kxk.store == "none"
    assert full.conv_1x1_exp.store == "none"
    stem12 = tmv._stamp_act_storage(base, "f8_e5m2", scope="stem12")
    assert stem12.layer_2[0].expand_1x1.store == "f8_e5m2"
    assert stem12.layer_3.downsampling.conv_3x3.store == "none"
    stem = tmv._stamp_act_storage(base, "f8_e5m2", scope="stem")
    assert stem.layer_1[0].conv_3x3.store == "f8_e5m2"
    assert stem.layer_2[0].expand_1x1.store == "none"
    with pytest.raises(ValueError, match="unknown act_storage"):
        tmv._stamp_act_storage(base, "int4")
    with pytest.raises(ValueError, match="scope"):
        tmv._stamp_act_storage(base, "f8_e5m2", scope="some")


@pytest.mark.parametrize("store", ["f8_e5m2", "f8_e4m3", "bfloat16"])
@pytest.mark.parametrize("scope", ["stem", "stem12", "early", "all"])
def test_scopes_stamp_what_jax_stamps(tiny_named, store, scope):
    got = _stores(tmv.from_named_tensors(tiny_named, TINY, act_storage=store,
                                         act_storage_scope=scope, device=CPU))
    want = _stores(jmv.from_named_tensors(tiny_named, _jcfg(TINY), flash_attn=False,
                                          fused_layer=False, act_storage=store,
                                          act_storage_scope=scope))
    assert got == want and len(got) > 20 and store in got.values()


def test_e5m2_materializes_f8_boundaries(tiny_named):
    f8 = tmv.from_named_tensors(tiny_named, TINY, act_storage="f8_e5m2", device=CPU)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 64, 64, 3))
                         .astype(np.float32))
    assert f8.conv_stem(x.to(bf16), compute_dtype=bf16).dtype == torch.float8_e5m2
    assert f8.conv_stem(x, compute_dtype=torch.float32).dtype == torch.float32
    # a residual block re-stores its sum at the storage width
    y = f8.layer_2[1](f8.layer_2[0](f8.layer_1[0](f8.conv_stem(x, compute_dtype=bf16),
                                                  compute_dtype=bf16), compute_dtype=bf16),
                      compute_dtype=bf16)
    assert f8.layer_2[1].use_residual and y.dtype == torch.float8_e5m2
    e4 = tmv.from_named_tensors(tiny_named, TINY, act_storage="f8_e4m3", device=CPU)
    assert e4.conv_stem(x, compute_dtype=bf16).dtype == torch.float8_e4m3fn


def test_e5m2_feature_noise_bounded_on_trained_full():
    """rel RMSE of bf16 + e5m2 features against bf16, full-size trained
    checkpoint, the JAX test's images and bounds."""
    named = read_named_tensors(CKPT_FULL)
    cfg = tmv.infer_config(named, image_size=256)
    base = tmv.from_named_tensors(named, cfg, device=CPU)
    imgs = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 256, 256, 3))
                            .clip(-3, 3).astype(np.float32))
    a = tmv.extract_features(base, imgs, compute_dtype=bf16)
    rels = {}
    for scope in ("early", "all"):
        f8 = tmv._stamp_act_storage(base, "f8_e5m2", scope=scope)
        b = tmv.extract_features(f8, imgs, compute_dtype=bf16)
        rels[scope] = float((a - b).norm() / a.norm())
    assert rels["early"] < 0.35, rels
    assert rels["early"] < rels["all"] < 0.45, rels


def test_e5m2_classifier_agreement_on_trained_tiny():
    images, _ = timg.make_dataset(96, seed=timg.HELDOUT_SEED, image_size=64)
    base = tmv.load_mobilevit(CKPT_TINY, config=timg.TINY_CLS_CONFIG, device=CPU)
    f8 = tmv.load_mobilevit(CKPT_TINY, config=timg.TINY_CLS_CONFIG, act_storage="f8_e5m2",
                            device=CPU)
    pb = timg.top1(base, images, compute_dtype=bf16)
    pf = timg.top1(f8, images, compute_dtype=bf16)
    assert (pb == pf).mean() >= 0.9, float((pb == pf).mean())


def test_storage_casts_round_as_jax():
    """The storage cast of the same bf16 values gives the JAX package's bits
    at every magnitude: round to nearest even, e5m2 overflow to infinity,
    e4m3 overflow (past 464) to NaN."""
    from ggml_experiments_tpu.ops.conv import apply_store as japply_store

    from ggml_experiments_tpu_torch.ops.conv import apply_store

    rng = np.random.default_rng(0)
    y = (rng.standard_normal(50000) * np.exp(rng.uniform(-20, 12, 50000))).astype(np.float32)
    y[:6] = [464.0, -464.0, 472.0, 480.0, np.inf, -np.inf]
    yb = torch.from_numpy(y).to(bf16)
    for store in ("f8_e5m2", "f8_e4m3", "bfloat16"):
        got = apply_store(yb, store).float().numpy()
        want = np.asarray(japply_store(jnp.asarray(y).astype(jnp.bfloat16), store)
                          .astype(jnp.float32))
        np.testing.assert_array_equal(got, want, err_msg=store)
    assert apply_store(torch.ones(3), "f8_e5m2").dtype == torch.float32


@pytest.mark.parametrize("store,scope", [("f8_e5m2", "all"), ("f8_e5m2", "early"),
                                         ("f8_e4m3", "stem12"), ("bfloat16", "all")])
def test_bf16_storage_forward_matches_jax_through_the_kernel_routes(store, scope):
    """fused_ir, flash_attn and fused_layer on, bf16 compute, each storage
    dtype: the plain versions of the inverted residual (which widens an f8
    input and leaves its bf16 output unstored) and the fused layer, against
    the JAX forward with the same flags.

    bf16 storage is the bf16 path's own storage: within the port's bf16
    tolerance of the JAX features. f8 keeps 2-3 mantissa bits: where the two
    packages' bf16 values lie one bf16 step apart (their sums run in other
    orders), the stored values may lie one f8 step apart, and that noise is
    independent between the packages (the casts themselves give the same
    bits, test above). So each package's distance to the f32 features is
    held to the other's, within a factor of 1.5."""
    named = tmv.random_named_tensors(ROUTES, seed=7, classifier=True)
    imgs = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    flags = dict(fused_ir=True, flash_attn=True, fused_layer=True, act_storage=store,
                 act_storage_scope=scope)
    jp = jmv.from_named_tensors(named, _jcfg(ROUTES), **flags)
    want = np.asarray(jax.jit(lambda p, x: jmv.extract_features(
        p, x, compute_dtype=jnp.bfloat16))(jp, jnp.asarray(imgs)))
    tp = tmv.from_named_tensors(named, ROUTES, device=CPU, **flags)
    assert tp.layer_2[1].fused and tp.layer_2[1].expand_1x1.store == store
    got = tmv.extract_features(tp, torch.from_numpy(imgs), compute_dtype=bf16).numpy()
    if store == "bfloat16":
        np.testing.assert_allclose(got, want, atol=0.1 * np.abs(want).max(), rtol=0.1)
        return
    ref = tmv.extract_features(tp, torch.from_numpy(imgs)).numpy()
    noise = [float(np.linalg.norm(f - ref) / np.linalg.norm(ref)) for f in (got, want)]
    assert 0.01 < noise[1] and 2 / 3 <= noise[0] / noise[1] <= 1.5, noise


@pytest.mark.parametrize("cd", [torch.float32, bf16])
def test_space_to_depth_stem_equals_the_standard_stem(tiny_named, cd):
    p = tmv.from_named_tensors(tiny_named, TINY, device=CPU)
    s = tmv.from_named_tensors(tiny_named, TINY, stem_space_to_depth=True, device=CPU)
    assert isinstance(s.conv_stem, SpaceToDepthStem) and s.conv_stem.kernel.shape == (2, 2, 12, 8)
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3))
                         .astype(np.float32))
    a, b = p.conv_stem(x, compute_dtype=cd), s.conv_stem(x, compute_dtype=cd)
    assert a.shape == b.shape == (2, 32, 32, 8) and b.dtype == cd
    if cd == torch.float32:
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
        # the whole forward, and the JAX package's rescattered kernel
        torch.testing.assert_close(tmv.extract_features(s, x), tmv.extract_features(p, x),
                                   rtol=1e-5, atol=1e-5)
        jp = jmv.from_named_tensors(tiny_named, _jcfg(TINY), flash_attn=False,
                                    fused_layer=False, stem_space_to_depth=True)
        np.testing.assert_array_equal(s.conv_stem.kernel.numpy(), np.asarray(jp.conv_stem.kernel))
    else:
        torch.testing.assert_close(b.float(), a.float(), rtol=0.02, atol=0.02 * float(
            a.float().abs().max()))
    with pytest.raises(ValueError, match="stride-2 3x3"):
        space_to_depth_stem(p.layer_1[0].expand_1x1)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_bf16_conv_kernels_match_jax(tiny_named, cd):
    """conv_dtype='bfloat16' stores every convolution kernel in bf16; the
    forward against the JAX package's load with the same policy."""
    p = tmv.from_named_tensors(tiny_named, TINY, conv_dtype="bfloat16", device=CPU)
    assert p.conv_stem.kernel.dtype == bf16 and p.layer_3.fusion.kernel.dtype == bf16
    jp = jmv.from_named_tensors(tiny_named, _jcfg(TINY), conv_dtype="bfloat16",
                                flash_attn=False, fused_layer=False)
    np.testing.assert_array_equal(p.conv_stem.kernel.float().numpy(),
                                  np.asarray(jp.conv_stem.kernel, np.float32))
    imgs = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda q, x: jmv.extract_features(
        q, x, compute_dtype=getattr(jnp, cd)))(jp, jnp.asarray(imgs)))
    got = tmv.extract_features(p, torch.from_numpy(imgs), compute_dtype=cd).numpy()
    if cd == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-4)
    else:
        np.testing.assert_allclose(got, want, atol=0.1 * np.abs(want).max(), rtol=0.1)
