"""Port: the HuggingFace MobileViT converter and the reference golden check
(``tools/torch_convert_hf_mobilevit.py``, ``tools/torch_verify_reference_golden.py``)
against the JAX package's tools, on the CPU.

The counterparts of ``tests/test_hf_converter.py`` and
``tests/test_reference_golden_staging.py``: a seeded tiny ``transformers``
``MobileViTModel`` (their ``TINY_KW``) saved with ``save_pretrained`` stands
in for the hub checkpoint, so nothing is downloaded. The converter's file is
byte-equal to the JAX tool's; the golden check returns 0, 1 and 2 in the
JAX tool's cases, and 2 when ``transformers`` cannot be imported.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import convert_hf_mobilevit as jconv  # noqa: E402
from tools import torch_convert_hf_mobilevit as conv  # noqa: E402
from tools import torch_verify_reference_golden as golden  # noqa: E402
from tools import verify_reference_golden as jgolden  # noqa: E402

TINY_KW = dict(
    image_size=64, neck_hidden_sizes=[8, 16, 24, 32, 40, 48, 96],
    hidden_sizes=[24, 32, 40], num_attention_heads=4, expand_ratio=4.0,
    mlp_ratio=2.0, patch_size=2, conv_kernel_size=3, output_stride=32,
    layer_norm_eps=1e-5, qkv_bias=True, hidden_act="silu",
)
ATOL = 0.02   # the JAX staging test's: f16 convolutions against the f32 oracle


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tiny(seed, cls=None):
    torch.manual_seed(seed)
    return (cls or transformers.MobileViTModel)(transformers.MobileViTConfig(**TINY_KW)).eval()


@pytest.fixture(scope="module")
def converter_dir(tmp_path_factory):
    """tests/test_hf_converter.py's model (seed 3), saved as a local checkpoint."""
    model = _tiny(3)
    d = tmp_path_factory.mktemp("hf_seed3")
    model.save_pretrained(d)
    return str(d), model


@pytest.fixture(scope="module")
def mock_hf_dir(tmp_path_factory):
    """tests/test_reference_golden_staging.py's mock (seed 7)."""
    model = _tiny(7)
    d = tmp_path_factory.mktemp("mock_mobilevit")
    model.save_pretrained(d)
    return str(d), model


def _torch_features(model):
    from ggml_experiments_tpu_torch.utils.image import synthetic_test_image

    img = synthetic_test_image(64)
    with torch.no_grad():
        return model(pixel_values=torch.tensor(img.transpose(2, 0, 1)[None])
                     ).last_hidden_state.numpy().transpose(0, 2, 3, 1)


def test_converted_names_match_the_tf_export(converter_dir):
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors

    tensors = dict(conv.convert_torch(converter_dir[1]))
    names = set(read_named_tensors(os.path.join(REPO, "tests", "goldens", "mobilevit_tiny.ggml")))
    assert set(tensors) == names
    assert [n for n, _ in conv.convert_torch(converter_dir[1])] == \
        [n for n, _ in jconv.convert_torch(converter_dir[1])]


@pytest.mark.parametrize("classifier", [False, True])
def test_converted_file_is_byte_equal_to_the_jax_tools(converter_dir, tmp_path, capsys,
                                                       classifier):
    d, model = converter_dir
    flag = ["--classifier"] if classifier else []
    if classifier:   # the classification export of a seeded head
        d = str(tmp_path / "cls")
        _tiny(3, transformers.MobileViTForImageClassification).save_pretrained(d)
    want, got = str(tmp_path / "jax.ggml"), str(tmp_path / "port.ggml")
    assert jconv.main([d, want, *flag]) == 0
    assert conv.main([d, got, *flag, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("jax.ggml", "port.ggml") == out[1]
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    if classifier:
        return
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
    from ggml_experiments_tpu_torch.models.mobilevit import (
        MobileViTConfig,
        extract_features,
        from_named_tensors,
    )
    from ggml_experiments_tpu_torch.utils.image import synthetic_test_image

    params = from_named_tensors(
        read_named_tensors(got),
        MobileViTConfig(image_size=64, neck_hidden_sizes=(8, 16, 24, 32, 40, 48, 96),
                        hidden_sizes=(24, 32, 40)), device="cpu")
    feats = extract_features(params, torch.from_numpy(synthetic_test_image(64))[None])
    np.testing.assert_allclose(feats.numpy(), _torch_features(model), rtol=1e-5, atol=1e-5)


def test_converter_tf_backend_returns_2(tmp_path, capsys):
    assert conv.main(["apple/mobilevit-small", str(tmp_path / "w.ggml"), "--backend", "tf"]) == 2
    assert "TensorFlow" in capsys.readouterr().err
    assert not (tmp_path / "w.ggml").exists()


def _golden_of(model) -> dict:
    feats = _torch_features(model)[0]
    return {"first5": [float(v) for v in feats[0, 0, :5]],
            "last5": [float(v) for v in feats[0, 0, -5:]], "shape": list(feats.shape)}


def _report(out):
    return json.loads("".join(out.splitlines(True)[1:]))


def test_pipeline_reproduces_mock_golden_as_the_jax_tool(mock_hf_dir, tmp_path, capsys):
    d, model = mock_hf_dir
    args = ["--model", d, "--image-size", "64", "--golden", json.dumps(_golden_of(model)),
            "--atol", str(ATOL)]
    keep = str(tmp_path / "weight.ggml")
    assert golden.main(args + ["--keep", keep, "--device", "cpu"]) == 0
    got = _report(capsys.readouterr().out)
    assert jgolden.main(args) == 0
    want = _report(capsys.readouterr().out)
    assert got["ok"] and got["shape_ok"] and got["max_abs_diff"] <= ATOL
    assert {k: got[k] for k in ("shape", "want_first5", "want_last5", "ok")} == \
        {k: want[k] for k in ("shape", "want_first5", "want_last5", "ok")}
    # the same f16-conv f32 forward: the JAX tool's channels within f32 rounding
    np.testing.assert_allclose(got["got_first5"] + got["got_last5"],
                               want["got_first5"] + want["got_last5"], atol=2e-5)
    from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors

    named = read_named_tensors(keep)
    assert any(k.endswith("conv_stem/convolution/kernel:0") for k in named)
    feats = golden.features_from_named(named, image_size=64, device="cpu")
    assert feats.shape == (2, 2, 96)
    assert golden.verify(feats, atol=ATOL, golden=_golden_of(model))["ok"]


def test_pipeline_detects_mismatch_as_the_jax_tool(mock_hf_dir, capsys):
    d, model = mock_hf_dir
    g = _golden_of(model)
    g["first5"][0] += 1.0   # corrupt the expected vector
    args = ["--model", d, "--image-size", "64", "--golden", json.dumps(g), "--atol", str(ATOL)]
    assert golden.main(args + ["--device", "cpu"]) == 1
    got = _report(capsys.readouterr().out)
    assert jgolden.main(args) == 1
    want = _report(capsys.readouterr().out)
    assert not got["ok"] and got["max_abs_diff"] >= 0.9
    assert abs(got["max_abs_diff"] - want["max_abs_diff"]) < 1e-4


def test_unfetchable_model_exits_2_as_the_jax_tool(tmp_path):
    missing = str(tmp_path / "does-not-exist")
    assert golden.main(["--model", missing, "--device", "cpu"]) == 2
    assert jgolden.main(["--model", missing]) == 2


def test_golden_check_exits_2_without_transformers(mock_hf_dir, monkeypatch, capsys):
    """As on a machine without ``transformers``: rc 2, and why."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert golden.main(["--model", mock_hf_dir[0], "--device", "cpu"]) == 2
    assert "transformers cannot be imported" in capsys.readouterr().err
