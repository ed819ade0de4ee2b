"""Port: training on the synthetic image task (``training/image_task``)
against the JAX package's ``train_model`` and ``top1``.

The loss and its gradient in every named tensor at the trained tiny
checkpoint, from the same minibatch, within rtol 1e-4 of JAX's (the loss
differentiates through the assembly, BN folding included); Adam's update
equal to optax.adam's on the same gradients. Then three steps of
``train_model`` at batch 8 end to end from the same minibatch draws: the
final loss within rtol 1e-4 of the JAX run's. Adam divides each gradient by
its own magnitude, so an element whose gradient sits at its rounding noise
takes a step of up to lr in either package's own direction (the attention key
biases, which the softmax does not see, all do): the trained tensors are
held to 1% in norm, and 99% of all elements to rtol 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ggml_experiments_tpu.models import mobilevit as jmv
from ggml_experiments_tpu.training import image_task as jimg
from ggml_experiments_tpu_torch.formats.ggml_named import read_named_tensors
from ggml_experiments_tpu_torch.models import mobilevit as tmv
from ggml_experiments_tpu_torch.training import image_task as timg

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "mobilevit_synth.ggml")
CPU = "cpu"
STEPS, LR = 3, 1e-3
KEY_BIAS = "/attention/attention/key/bias"


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jcfg():
    return jmv.MobileViTConfig(**{k: getattr(timg.TINY_CLS_CONFIG, k)
                                  for k in timg.TINY_CLS_CONFIG.__dataclass_fields__})


@pytest.fixture(scope="module")
def trained():
    named = read_named_tensors(CKPT)
    x, y = timg.make_dataset(40, seed=timg.TRAIN_SEED, image_size=64)
    got = timg.train_model(named, x, y, steps=STEPS, batch=8, lr=LR, log_every=0, device=CPU)
    want = jimg.train_model(named, x, y, steps=STEPS, batch=8, lr=LR, log_every=0)
    return named, got, want


def test_loss_and_gradients_match_jax():
    named = read_named_tensors(CKPT)
    x, y = timg.make_dataset(8, seed=timg.TRAIN_SEED, image_size=64)
    tr = {k: torch.tensor(v, requires_grad=True) for k, v in named.items()}
    loss = timg.loss_fn(tr, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()

    def jloss(t):
        p = jmv.from_named_tensors(t, _jcfg(), flash_attn=False, fused_layer=False)
        logits = jmv.classify(p, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    jl, jg = jax.jit(jax.value_and_grad(jloss))({k: jnp.asarray(v) for k, v in named.items()})
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jg.values())
    for k, g in jg.items():
        g = np.asarray(g)
        got = tr[k].grad.numpy()
        if KEY_BIAS in k:
            # mathematically zero: rounding noise on both sides
            assert np.abs(got).max() < 1e-5 * scale and np.abs(g).max() < 1e-5 * scale, k
            continue
        np.testing.assert_allclose(got, g, rtol=1e-4, atol=1e-4 * np.abs(g).max() + 1e-12,
                                   err_msg=k)


def test_adam_update_matches_optax():
    """torch.optim.Adam, as train_model makes it, against optax.adam on the
    same three gradients."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    p = torch.tensor(p0, requires_grad=True)
    opt = torch.optim.Adam([p], lr=LR)
    jp, jopt = jnp.asarray(p0), optax.adam(LR)
    state = jopt.init(jp)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
        up, state = jopt.update(jnp.asarray(g), state)
        jp = optax.apply_updates(jp, up)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_train_model_matches_jax(trained):
    named, (got, loss), (want, jloss) = trained
    assert loss == pytest.approx(jloss, rel=1e-4) and np.isfinite(loss)
    assert got.keys() == want.keys() == named.keys()
    close = total = moved = 0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == np.float32 and g.shape == w.shape, k
        # Adam moves an element by at most about lr a step
        assert np.abs(g - named[k]).max() <= STEPS * LR * 1.01, k
        moved += not np.array_equal(g, named[k])
        if KEY_BIAS in k:
            continue
        assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w) + 1e-12, k
        close += int((np.abs(g - w) <= 1e-4 * np.abs(w) + 1e-7).sum())
        total += w.size
    assert moved > 0.9 * len(want) and close >= 0.99 * total, (moved, close, total)


def test_trained_dict_loads_and_classifies(trained):
    """The result is a weight.ggml name map: it loads through the standard
    loader, quantized too, and still classifies far above chance (1/44)
    after three steps at batch 8."""
    _, (got, _), _ = trained
    images, labels = timg.make_dataset(48, seed=timg.HELDOUT_SEED, image_size=64)
    p = tmv.from_named_tensors(got, timg.TINY_CLS_CONFIG, device=CPU)
    q = tmv.from_named_tensors(got, timg.TINY_CLS_CONFIG, qtype="q8_0", device=CPU)
    acc = float((timg.top1(p, images) == labels).mean())
    assert acc > 0.25 and (timg.top1(q, images) == timg.top1(p, images)).mean() >= 0.95


def test_train_model_loss_falls():
    named = read_named_tensors(CKPT)
    x, y = timg.make_dataset(64, seed=timg.TRAIN_SEED, image_size=64)
    # a fresh random head: the loss starts high and has room to fall
    rng = np.random.default_rng(0)
    named = dict(named)
    key = "classifier/kernel:0" if "classifier/kernel:0" in named else next(
        k for k in named if k.endswith("classifier/kernel:0"))
    named[key] = (rng.standard_normal(named[key].shape) * 0.05).astype(np.float32)
    _, first = timg.train_model(named, x, y, steps=1, batch=32, lr=3e-3, log_every=0,
                                device=CPU)
    _, last = timg.train_model(named, x, y, steps=12, batch=32, lr=3e-3, log_every=0,
                               device=CPU)
    assert last < 0.8 * first, (first, last)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_top1_matches_jax(cd):
    images, _ = timg.make_dataset(70, seed=timg.HELDOUT_SEED, image_size=64)
    tp = tmv.load_mobilevit(CKPT, config=timg.TINY_CLS_CONFIG, device=CPU)
    jp = jmv.load_mobilevit(CKPT, config=_jcfg(), flash_attn=False, fused_layer=False)
    got = timg.top1(tp, images, batch=32, compute_dtype=cd)
    want = jimg.top1(jp, images, batch=32, compute_dtype=getattr(jnp, cd))
    assert got.shape == want.shape == (70,) and got.dtype.kind == want.dtype.kind == "i"
    # f32 predictions agree outright; at bf16 one near-tie may flip
    assert (got == want).mean() >= (1.0 if cd == "float32" else 0.98)
