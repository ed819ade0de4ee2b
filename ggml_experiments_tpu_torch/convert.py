"""Build the port's GRU params from numpy arrays.

``arrays`` holds the six gru.bin tensors by name (``embeddings``, ``kernel``,
``recurrent_kernel``, ``bias``, ``dense_kernel``, ``dense_bias``). Each of the
three weight matrices may instead be an already-quantized q8_0 weight given
as a dict of numpy planes ``{"codes": (Kp, Np) int8, "scales": (Kp/32, Np)
f32, "shape": (K, N)}`` (the JAX package's QTensor layout), so both packages
can be handed identical weights.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ggml_experiments_tpu_torch.device import DeviceLike, resolve_device
from ggml_experiments_tpu_torch.models.gru_textgen import GRUTextGenParams
from ggml_experiments_tpu_torch.ops.gru import GRUCellParams
from ggml_experiments_tpu_torch.quant.qtensor import BLOCK, LANE, QTensor, quantize


def qtensor_from_planes(planes: Mapping, device) -> QTensor:
    codes = np.asarray(planes["codes"])
    scales = np.asarray(planes["scales"], np.float32)
    k, n = (int(d) for d in planes["shape"])
    if (codes.dtype != np.int8 or codes.shape[0] % BLOCK or codes.shape[1] % LANE
            or scales.shape != (codes.shape[0] // BLOCK, codes.shape[1])):
        raise ValueError(f"not q8_0 planes: codes {codes.dtype}{codes.shape}, "
                         f"scales {scales.shape}")
    return QTensor(torch.from_numpy(codes.copy()).to(device),
                   torch.from_numpy(scales.copy()).to(device), (k, n))


def params_from_numpy(arrays: Mapping, qtype: Optional[str] = None,
                      device: DeviceLike = None) -> GRUTextGenParams:
    dev = resolve_device(device)

    def f32(a):
        return None if a is None else torch.from_numpy(np.array(a, np.float32)).to(dev)

    def weight(a):
        if isinstance(a, Mapping):
            return qtensor_from_planes(a, dev)
        if qtype:
            return quantize(np.asarray(a, np.float32), qtype, device=dev)
        return f32(a)

    return GRUTextGenParams(
        embeddings=f32(arrays["embeddings"]),
        cell=GRUCellParams(
            kernel=weight(arrays["kernel"]),
            recurrent_kernel=weight(arrays["recurrent_kernel"]),
            bias=f32(arrays.get("bias")),
        ),
        dense_kernel=weight(arrays["dense_kernel"]),
        dense_bias=f32(arrays.get("dense_bias")),
    )
