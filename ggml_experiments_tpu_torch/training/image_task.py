"""The synthetic image-classification task of the committed MobileViT
checkpoints: data, training and top-1.

Oriented sinusoidal gratings: the class sets the orientation, the per-sample
generator the frequency, contrast and phase (distractors) and additive pixel
noise. The images are bit-equal to the JAX package's ``make_dataset`` for the
same arguments. :func:`train_model` fine-tunes the whole model with Adam on
its named-tensor dict (the loss differentiates through
``from_named_tensors``, BN folding included), so the result is a
``weight.ggml`` map that loads with any qtype and route; :func:`top1` takes
predictions through the full (quantizable) ``classify`` path.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ggml_experiments_tpu_torch.device import DeviceLike, resolve_device
from ggml_experiments_tpu_torch.models.mobilevit import MobileViTConfig

# the reduced architecture of the committed tiny checkpoint
TINY_CLS_CONFIG = MobileViTConfig(
    image_size=64,
    hidden_sizes=(24, 32, 40),
    neck_hidden_sizes=(8, 16, 24, 32, 40, 48, 96),
    num_labels=44,
)
CLS_SEED = 11          # random_named_tensors init seed
NUM_CLASSES = 44       # orientations 2.05 degrees apart
TRAIN_SEED = 123       # dataset split seeds
HELDOUT_SEED = 456
TASK_REV = 3
NOISE_SIGMA = 0.35
FULL_TASK_REV = 4      # the full-size task: contrast lowered by FULL_AMP_FACTOR
FULL_AMP_FACTOR = 0.5


def make_dataset(n: int, *, seed: int, image_size: int = 64, num_classes: int = NUM_CLASSES,
                 noise: float = NOISE_SIGMA, amp_boost: float = 1.0,
                 amp_factor: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic labeled images: (n, S, S, 3) float32 in [0, 1], (n,) int32.

    The amplitude scales by 64/S so that every resolution has the same
    matched-filter SNR; ``amp_factor`` is part of the task (the full-size
    task runs at FULL_AMP_FACTOR), ``amp_boost`` a training curriculum knob."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32) / image_size
    images = np.empty((n, image_size, image_size, 3), np.float32)
    labels = (np.arange(n) % num_classes).astype(np.int32)
    amp_scale = (64.0 / image_size) * amp_factor * amp_boost
    for i in range(n):
        c = int(labels[i])
        theta = np.pi * (c + 1) / (2 * num_classes)
        freq = rng.uniform(4.5, 7.5)
        amp = rng.uniform(0.12, 0.28) * amp_scale
        phase = rng.uniform(0, 2 * np.pi)
        wave = np.sin(2 * np.pi * freq * (xx * np.cos(theta) + yy * np.sin(theta)) + phase)
        img = 0.5 + amp * np.repeat(wave[..., None], 3, axis=-1)
        img += rng.normal(0.0, noise, img.shape).astype(np.float32)
        images[i] = np.clip(img, 0.0, 1.0)
    return images, labels


def loss_fn(named: Dict[str, torch.Tensor], images: torch.Tensor, labels: torch.Tensor,
            config: MobileViTConfig = TINY_CLS_CONFIG) -> torch.Tensor:
    """Mean softmax cross-entropy of ``classify(from_named_tensors(named))``
    at f32 on the unfused path (the flash, fused-layer and fused
    inverted-residual kernels are forward-only), on the named tensors'
    device; differentiable in every named tensor."""
    from ggml_experiments_tpu_torch.models.mobilevit import classify, from_named_tensors

    dev = next(iter(named.values())).device
    p = from_named_tensors(named, config, flash_attn=False, fused_layer=False, fused_ir=False,
                           device=dev)
    return torch.nn.functional.cross_entropy(classify(p, images), labels.long())


def train_model(
    named: Dict[str, np.ndarray],
    images: np.ndarray,
    labels: np.ndarray,
    *,
    config: MobileViTConfig = TINY_CLS_CONFIG,
    steps: int = 600,
    batch: int = 100,
    lr: float = 1e-3,
    seed: int = 0,
    log_every: int = 100,
    device: DeviceLike = None,
) -> Tuple[Dict[str, np.ndarray], float]:
    """Adam fine-tune of the whole model on the named-tensor dict, on
    ``device``.

    Every step takes :func:`loss_fn` of a minibatch (the assembly is part of
    it, BN folding included, so BN statistics train as plain affine
    parameters) and one ``torch.optim.Adam`` step (optax.adam's update).
    Minibatches are ``np.random.default_rng(seed).choice(len(images), batch,
    replace=False)``, the JAX package's draws. Returns (trained named dict,
    final minibatch loss)."""
    dev = resolve_device(device)
    trainable = {k: torch.tensor(np.asarray(v, np.float32), device=dev, requires_grad=True)
                 for k, v in named.items()}
    opt = torch.optim.Adam(list(trainable.values()), lr=lr)
    imgs = torch.from_numpy(np.asarray(images, np.float32)).to(dev)
    labs = torch.from_numpy(np.asarray(labels)).to(dev).long()
    rng = np.random.default_rng(seed)
    loss = torch.tensor(float("nan"))
    for s in range(steps):
        idx = torch.from_numpy(rng.choice(len(images), batch, replace=False)).to(dev)
        loss = loss_fn(trainable, imgs[idx], labs[idx], config)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and (s % log_every == 0 or s == steps - 1):
            print(f"step {s}: loss {float(loss.detach()):.4f}", flush=True)
    return {k: v.detach().cpu().numpy() for k, v in trainable.items()}, float(loss.detach())


def top1(params, images: np.ndarray, *, batch: int = 64, compute_dtype=torch.float32) -> np.ndarray:
    """Predicted labels through the full (quantizable) classify path, in
    batches of ``batch`` on the params' device."""
    from ggml_experiments_tpu_torch.models.mobilevit import classify

    out = []
    with torch.no_grad():
        for i in range(0, len(images), batch):
            x = torch.from_numpy(np.ascontiguousarray(images[i:i + batch], np.float32))
            out.append(classify(params, x, compute_dtype=compute_dtype).argmax(-1).cpu().numpy())
    return np.concatenate(out, axis=0)
