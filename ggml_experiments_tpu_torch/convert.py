"""Build the port's GRU params, and its trainer's Adam state, from numpy arrays.

``arrays`` holds the six gru.bin tensors by name (``embeddings``, ``kernel``,
``recurrent_kernel``, ``bias``, ``dense_kernel``, ``dense_bias``). Each of the
three weight matrices may instead be an already-quantized weight given as a
dict of numpy planes in the JAX package's QTensor layout: ``codes``,
``scales``, ``shape`` (logical ``(K, N)``), ``qtype`` (default ``q8_0``) and
the format's ``mins`` / ``hibits`` / ``supers``. The matrices may differ in
qtype, so both packages can be handed identical weights.

``requires_grad=True`` gives float32 training parameters, and
:func:`adam_state_from_numpy` turns an optax Adam state ``(count, mu, nu)``,
its moments as the same six named arrays, into the trainer's optimizer state:
with both, the two packages' trainers continue from one point.
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
                      device: DeviceLike = None,
                      requires_grad: bool = False) -> GRUTextGenParams:
    dev = resolve_device(device)
    if requires_grad and (qtype or any(isinstance(a, Mapping) for a in arrays.values())):
        raise ValueError("training parameters are float32: no qtype, no quantized planes")

    def f32(a):
        if a is None:
            return None
        return torch.from_numpy(np.array(a, np.float32)).to(dev).requires_grad_(requires_grad)

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


def adam_state_from_numpy(count, mu: Mapping, nu: Mapping, device: DeviceLike = None):
    """The trainer's optimizer state from an optax ``ScaleByAdamState``:
    ``count`` steps taken, ``mu`` / ``nu`` the first and second moments as the
    six named arrays of :func:`params_from_numpy`."""
    from ggml_experiments_tpu_torch.training.gru_trainer import AdamState

    return (AdamState(count=torch.tensor(int(count), dtype=torch.int32),
                      mu=params_from_numpy(mu, device=device),
                      nu=params_from_numpy(nu, device=device)),)
