"""Port: the continuous-batching VisionEngine on the CPU.

Every result equals the offline forward of the same image (the same plain
kernels, the same batch composition does not matter per image up to f32
summation order); cancel, the release of every waiter on a worker error,
and ``stop`` releasing queued waiters (the JAX engine leaves them waiting,
ROADMAP Queue C).
"""

import threading

import numpy as np
import pytest
import torch

from ggml_experiments_tpu_torch.models import mobilevit as tmv
from ggml_experiments_tpu_torch.serving import VisionEngine
from ggml_experiments_tpu_torch.utils.image import preprocess, preprocess_canvas_u8

CFG = tmv.MobileViTConfig(image_size=64, neck_hidden_sizes=(8, 16, 16, 24, 24, 32, 48),
                          hidden_sizes=(16, 16, 24), num_transformer_layers=(1, 1, 1),
                          num_labels=10)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def params():
    named = tmv.random_named_tensors(CFG, seed=4, classifier=True)
    return tmv.from_named_tensors(named, CFG, device="cpu")


def canvases(n, seed=0):
    rng = np.random.default_rng(seed)
    return [preprocess_canvas_u8(rng.integers(0, 256, (int(rng.integers(30, 90)),
                                                       int(rng.integers(30, 90)), 3),
                                              dtype=np.uint8), 64) for _ in range(n)]


def offline(params, kind, imgs):
    fn = tmv.classify if kind == "classify" else tmv.extract_features
    x = torch.from_numpy(np.stack(imgs)).float() / 255.0
    return fn(params, x, compute_dtype=torch.float32).numpy()


def test_engine_results_equal_the_offline_forward(params):
    eng = VisionEngine(params, image_size=64, batch_sizes=(2, 4, 8),
                       compute_dtype=torch.float32)
    imgs = canvases(23)
    kinds = ["classify" if i % 3 else "features" for i in range(len(imgs))]
    reqs = [eng.submit(im, k) for im, k in zip(imgs, kinds)]
    eng.run_until_idle(timeout=120)
    for kind in ("classify", "features"):
        idx = [i for i, k in enumerate(kinds) if k == kind]
        want = offline(params, kind, [imgs[i] for i in idx])
        for j, i in enumerate(idx):
            np.testing.assert_allclose(reqs[i].result(timeout=0), want[j], rtol=1e-4, atol=1e-5)
    b = eng.stats.breakdown()
    assert eng.stats.images_done == 23 and b["batches"] >= 3 and 0 <= b["pad_fraction"] < 1
    assert set(b) == {"images_per_s", "batches", "pad_fraction", "collate_share",
                      "dispatch_share", "readback_share", "distribute_share", "readback_mb"}
    eng.stop()


def test_f32_transport_and_submit_checks(params):
    eng = VisionEngine(params, image_size=64, batch_sizes=(4,), transport="f32",
                       compute_dtype=torch.float32)
    img = preprocess(np.full((40, 64, 3), 128, np.uint8), 64)
    r = eng.submit(img, "features")
    eng.run_until_idle(timeout=60)
    np.testing.assert_allclose(r.result(0), tmv.extract_features(
        params, torch.from_numpy(img)[None]).numpy()[0], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="float32"):
        eng.submit(np.zeros((64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="shape"):
        eng.submit(np.zeros((16, 64, 3), np.float32))
    with pytest.raises(ValueError, match="kind"):
        eng.submit(img, "segment")
    with pytest.raises(ValueError, match="transport"):
        VisionEngine(params, transport="f16")
    eng.stop()


def test_canceled_requests_never_resolve_with_a_result(params):
    eng = VisionEngine(params, image_size=64, batch_sizes=(2, 4), compute_dtype=torch.float32)
    reqs = [eng.submit(im) for im in canvases(10, seed=1)]
    for r in reqs[::3]:
        r.cancel()
    eng.run_until_idle(timeout=60)
    for i, r in enumerate(reqs):
        if i % 3 == 0:
            with pytest.raises(RuntimeError, match="canceled"):
                r.result(timeout=0)
        else:
            assert r.result(timeout=0).shape == (10,)
    assert eng.stats.requests_canceled == 4 and eng.stats.images_done == 6
    eng.stop()


def test_a_worker_error_releases_every_waiter(params, monkeypatch):
    eng = VisionEngine(params, image_size=64, batch_sizes=(2,), compute_dtype=torch.float32)
    gate = threading.Event()

    def boom(*a, **k):
        gate.wait(5)
        raise RuntimeError("device fault")

    monkeypatch.setitem(eng._fns, "classify", boom)
    reqs = [eng.submit(im) for im in canvases(7, seed=2)]
    eng.start()
    gate.set()
    for r in reqs:
        with pytest.raises(RuntimeError, match="device fault"):
            r.result(timeout=30)
    assert isinstance(eng.error, RuntimeError)
    with pytest.raises(RuntimeError, match="failed"):
        eng.submit(canvases(1)[0])
    eng.stop()


def test_stop_releases_queued_waiters(params):
    """Divergence from the JAX engine (ROADMAP Queue C): its stop() leaves
    queued requests waiting forever; here they raise."""
    eng = VisionEngine(params, image_size=64, batch_sizes=(2,), compute_dtype=torch.float32)
    reqs = [eng.submit(im) for im in canvases(5, seed=3)]
    eng.stop()   # never started: everything is still queued
    for r in reqs:
        assert r.done
        with pytest.raises(RuntimeError, match="stopped"):
            r.result(timeout=0)
    assert eng._open == 0
