"""Character-LM data pipeline: corpus text -> char ids -> non-overlapping
(seq_len+1) windows -> (input, shifted-target) pairs -> shuffled fixed-size
batches. Pure numpy on the host; the trainer moves batches to the device.
The corpus is any local text file; ``eval --corpus`` reads its held-out
sequences through this too."""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_length: int = 100
    batch_size: int = 64
    shuffle_buffer: int = 10000
    drop_remainder: bool = True


def load_corpus(path: str) -> str:
    with open(path, "rb") as f:
        return f.read().decode("utf-8")


def make_examples(text: str, tokenizer: CharTokenizer, cfg: DataConfig) -> np.ndarray:
    """All (seq_length+1)-char windows, shape (n, seq_length+1) int32."""
    ids = np.asarray(tokenizer.encode(text), np.int32)
    win = cfg.seq_length + 1
    n = len(ids) // win
    return ids[: n * win].reshape(n, win)


def batches(examples: np.ndarray, cfg: DataConfig, *, seed: int = 0,
            epochs: int = 1) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield shuffled (inputs (B, T), targets (B, T)) int32 batches: one full
    permutation per epoch from ``np.random.default_rng(seed)``, so a seed
    names a stream (exact resume skips along it)."""
    rng = np.random.default_rng(seed)
    b = cfg.batch_size
    for _ in range(epochs):
        order = rng.permutation(len(examples))
        for i in range(0, len(order) - (b - 1 if cfg.drop_remainder else 0), b):
            chunk = examples[order[i: i + b]]
            if cfg.drop_remainder and len(chunk) < b:
                break
            yield chunk[:, :-1], chunk[:, 1:]


def synthetic_corpus(n_chars: int = 50000, seed: int = 0) -> str:
    """Deterministic pseudo-text over the Shakespeare vocab (for tests)."""
    rng = np.random.default_rng(seed)
    words = ["the ", "thou ", "and ", "king ", "lord ", "O ", "my ", "\n"]
    out = []
    total = 0
    while total < n_chars:
        w = words[int(rng.integers(len(words)))]
        out.append(w)
        total += len(w)
    return "".join(out)[:n_chars]
