"""Q8_0 weight-only quantization and the fused dequant + matmul."""

from ggml_experiments_tpu_torch.quant.qmatmul import (
    XLA_FALLBACK_MAX_ELEMS,
    qmatmul,
    qmatmul_reference,
)
from ggml_experiments_tpu_torch.quant.qtensor import (
    BLOCK,
    LANE,
    QTYPES,
    QTensor,
    dequantize,
    quantize,
)

__all__ = [
    "BLOCK", "LANE", "QTYPES", "QTensor", "XLA_FALLBACK_MAX_ELEMS",
    "dequantize", "qmatmul", "qmatmul_reference", "quantize",
]
