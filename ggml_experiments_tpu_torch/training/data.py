"""Character-LM data pipeline: corpus text -> char ids -> non-overlapping
(seq_len+1) windows -> (input, shifted-target) pairs. Pure numpy on the host.
The corpus is any local text file; ``eval --corpus`` reads its held-out
sequences through this."""

from __future__ import annotations

import dataclasses

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
