"""Device choice for the port's entry points.

Entry points take ``device=``; left out, it is ``cuda``, and without a GPU
that raises instead of carrying on silently on the CPU. Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu'")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    """``torch.float32`` / ``torch.bfloat16`` from a dtype or its name."""
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(str(dtype))
    if out not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype!r}")
    return out
