"""The synthetic image-classification task of the committed MobileViT
checkpoints: its data half.

Oriented sinusoidal gratings: the class sets the orientation, the per-sample
generator the frequency, contrast and phase (distractors) and additive pixel
noise. The images are bit-equal to the JAX package's ``make_dataset`` for the
same arguments, so held-out images can be made without it. Training on the
task (``train_model``) is not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ggml_experiments_tpu_torch.models.mobilevit import UNPORTED, MobileViTConfig

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


def train_model(*args, **kwargs):
    raise NotImplementedError(f"training on the image task {UNPORTED}")
