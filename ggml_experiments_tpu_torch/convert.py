"""Build the port's GRU params from numpy arrays.

``arrays`` holds the six gru.bin tensors by name (``embeddings``, ``kernel``,
``recurrent_kernel``, ``bias``, ``dense_kernel``, ``dense_bias``). Each of the
three weight matrices may instead be an already-quantized weight given as a
dict of numpy planes in the JAX package's QTensor layout: ``codes``,
``scales``, ``shape`` (logical ``(K, N)``), ``qtype`` (default ``q8_0``) and
the format's ``mins`` / ``hibits`` / ``supers``. The matrices may differ in
qtype, so both packages can be handed identical weights.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ggml_experiments_tpu_torch.device import DeviceLike, resolve_device
from ggml_experiments_tpu_torch.models.gru_textgen import GRUTextGenParams
from ggml_experiments_tpu_torch.ops.gru import GRUCellParams
from ggml_experiments_tpu_torch.quant.qtensor import PLANE_NAMES, QTYPES, QTensor, quantize


def qtensor_from_planes(planes: Mapping, device) -> QTensor:
    """A QTensor from padded numpy planes, after checking each plane's dtype
    and shape against its format."""
    qtype = planes.get("qtype", "q8_0")
    if qtype not in QTYPES:
        raise ValueError(f"unknown qtype {qtype!r} (expected one of {QTYPES})")
    tensors = {name: torch.from_numpy(np.array(planes[name]))
               for name in PLANE_NAMES if planes.get(name) is not None}
    if "codes" not in tensors or "scales" not in tensors:
        raise ValueError(f"not {qtype} planes: codes or scales missing")
    qt = QTensor(shape=tuple(int(d) for d in planes["shape"]), qtype=qtype, **tensors)
    qt.check_planes()
    for name in tensors:
        setattr(qt, name, tensors[name].to(device))
    return qt


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
