"""PyTorch + CUDA port of ggml_experiments_tpu for NVIDIA Hopper (H100).

Character-level GRU text generation under every block format (scan path
and the persistent fused decode), the continuous-batching serving engine
with snapshot/restore, the native ``.gxt`` checkpoint container, the
quantization-delta evaluation, and GRU training (``train-gru``) through the
fused forward/backward kernel pair. Each TPU kernel on that path is a
hand-written CUDA kernel under ``csrc/``, built at first use by ``_build``;
every kernel wrapper runs its plain PyTorch version on CPU tensors. Entry
points run on ``cuda`` unless given ``device="cpu"``.
"""

__version__ = "0.1.0"


def _launch_counters():
    from ggml_experiments_tpu_torch.ops.fused_gru_decode import LAUNCHES as fused
    from ggml_experiments_tpu_torch.ops.fused_gru_train import LAUNCHES as train
    from ggml_experiments_tpu_torch.quant.qmatmul import LAUNCHES as qmm

    return qmm, fused, train


def kernel_launches() -> dict:
    """Launch counts of every CUDA kernel wrapper, by kernel name."""
    return {k: v for counts in _launch_counters() for k, v in counts.items()}


def reset_kernel_launches() -> None:
    for counts in _launch_counters():
        for k in counts:
            counts[k] = 0
