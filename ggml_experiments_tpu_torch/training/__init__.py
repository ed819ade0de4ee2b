"""Training: the GRU char-LM trainer, its data pipeline and input prefetch."""

from ggml_experiments_tpu_torch.training import data, gru_trainer
from ggml_experiments_tpu_torch.training.gru_trainer import TrainConfig, train, train_from_text

__all__ = ["data", "gru_trainer", "TrainConfig", "train", "train_from_text"]
