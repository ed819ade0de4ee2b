"""Models: the character-level GRU text generator and MobileViT (``models.mobilevit``)."""

from ggml_experiments_tpu_torch.models.gru_textgen import (
    GRUConfig,
    GRUTextGenParams,
    decode,
    forward_sequence,
    generate,
    init_params,
)

__all__ = ["GRUConfig", "GRUTextGenParams", "decode", "forward_sequence", "generate",
           "init_params"]
