"""Block weight-only quantization (q8_0, q4_0, q4_1, q5_0, q5_1, q4_k) and
the fused dequant + matmul."""

from ggml_experiments_tpu_torch.quant.qmatmul import (
    XLA_FALLBACK_MAX_ELEMS,
    qmatmul,
    qmatmul_reference,
)
from ggml_experiments_tpu_torch.quant.qtensor import (
    BLOCK,
    LANE,
    QTYPE_BITS,
    QTYPE_TOTAL_BITS,
    QTYPES,
    QTensor,
    dequantize,
    from_numpy_blocks,
    quantization_error,
    quantize,
    to_numpy_blocks,
)

__all__ = [
    "BLOCK", "LANE", "QTYPES", "QTYPE_BITS", "QTYPE_TOTAL_BITS", "QTensor",
    "XLA_FALLBACK_MAX_ELEMS", "dequantize", "from_numpy_blocks", "qmatmul",
    "qmatmul_reference", "quantization_error", "quantize", "to_numpy_blocks",
]
