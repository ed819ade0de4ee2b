"""Reader/writer for the reference's positional GRU weight file (``gru.bin``).

Per tensor: ``int32 n_dims``, then the dims **in reversed order**, then raw
little-endian float32 data, row-major in the original TF shape. Tensors are
identified by position:

  0. embeddings        (vocab, embed)   = (66, 256)
  1. cell kernel       (embed, 3*units) = (256, 3072)
  2. recurrent kernel  (units, 3*units) = (1024, 3072)
  3. cell bias         (2, 3*units)     = (2, 3072)
  4. dense kernel      (units, vocab)   = (1024, 66)
  5. dense bias        (vocab,)         = (66,)
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List, Optional

import numpy as np

from ggml_experiments_tpu_torch.device import DeviceLike
from ggml_experiments_tpu_torch.models.gru_textgen import GRUTextGenParams

TENSOR_NAMES = ("embeddings", "kernel", "recurrent_kernel", "bias",
                "dense_kernel", "dense_bias")


def _read_tensor(f: BinaryIO) -> Optional[np.ndarray]:
    head = f.read(4)
    if len(head) == 0:
        return None
    if len(head) < 4:
        raise EOFError("truncated gru.bin record header")
    (n_dims,) = struct.unpack("<i", head)
    if not 0 < n_dims <= 4:
        raise ValueError(f"implausible gru.bin n_dims {n_dims}")
    body = f.read(4 * n_dims)
    if len(body) != 4 * n_dims:
        raise EOFError(f"truncated gru.bin dims ({len(body)}/{4 * n_dims} bytes)")
    dims = struct.unpack(f"<{n_dims}i", body)
    if any(d <= 0 for d in dims):
        raise ValueError(f"implausible gru.bin dims {dims}")
    shape = tuple(reversed(dims))  # file stores dims reversed
    count = int(np.prod(shape))
    data = np.frombuffer(f.read(4 * count), dtype="<f4")
    if data.size != count:
        raise EOFError(f"truncated gru.bin tensor: wanted {count} floats, got {data.size}")
    return data.astype(np.float32).reshape(shape)


def _write_tensor(f: BinaryIO, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr, dtype="<f4")
    f.write(struct.pack("<i", arr.ndim))
    for d in reversed(arr.shape):
        f.write(struct.pack("<i", d))
    f.write(arr.tobytes())


def read_tensors(path: str) -> List[np.ndarray]:
    """All tensors of a gru.bin file, in file order: indexed by the native
    runtime where it is available, else by :func:`read_tensors_py`, the plain
    version, which also names the fault of a file the native indexer
    refuses."""
    from ggml_experiments_tpu_torch import runtime

    if not runtime.available():
        return read_tensors_py(path)
    try:
        return runtime.read_gru_bin_native(path)
    except runtime.NativeParseError:
        read_tensors_py(path)
        raise


def read_tensors_py(path: str) -> List[np.ndarray]:
    """The numpy reader."""
    out = []
    with open(path, "rb") as f:
        while True:
            t = _read_tensor(f)
            if t is None:
                return out
            out.append(t)


def load_gru_params(path: str, *, qtype: Optional[str] = None,
                    device: DeviceLike = None) -> GRUTextGenParams:
    """Load ``gru.bin`` into params on ``device``; a ``qtype`` quantizes the
    cell, recurrent and dense kernels (embeddings and biases stay f32)."""
    from ggml_experiments_tpu_torch.convert import params_from_numpy

    tensors = read_tensors(path)
    if len(tensors) != 6:
        raise ValueError(f"{path}: expected 6 tensors, found {len(tensors)}")
    arrays = dict(zip(TENSOR_NAMES, tensors))
    u = arrays["recurrent_kernel"].shape[0]
    if (arrays["kernel"].shape[1] != 3 * u or arrays["recurrent_kernel"].shape[1] != 3 * u
            or arrays["bias"].shape != (2, 3 * u)):
        raise ValueError(
            f"{path}: inconsistent GRU shapes: kernel {arrays['kernel'].shape}, "
            f"recurrent {arrays['recurrent_kernel'].shape}, bias {arrays['bias'].shape}")
    return params_from_numpy(arrays, qtype=qtype, device=device)


def save_gru_params(path: str, params: GRUTextGenParams) -> None:
    """Write params in the reference's binary layout (QTensors are
    dequantized: the format is float32-only)."""

    def to_np(w):
        if hasattr(w, "dequantize"):
            w = w.dequantize()
        return w.detach().float().cpu().numpy()

    with open(path, "wb") as f:
        for w in (params.embeddings, params.cell.kernel, params.cell.recurrent_kernel,
                  params.cell.bias, params.dense_kernel, params.dense_bias):
            _write_tensor(f, to_np(w))


def load_gru_checkpoint(path: str, *, device: DeviceLike = None) -> GRUTextGenParams:
    """Load GRU params from a native ``.gxt`` checkpoint (float or quantized),
    rebuilt from the checkpoint's key paths, so a file written by the
    ``quantize`` command serves directly."""
    from ggml_experiments_tpu_torch.formats.checkpoint import load_arrays
    from ggml_experiments_tpu_torch.ops.gru import GRUCellParams

    flat = load_arrays(path, device=device)
    for name in ("embeddings", "cell/kernel", "cell/recurrent_kernel", "dense_kernel"):
        if name not in flat:
            raise KeyError(f"{path}: {name!r} not present; keys: {sorted(flat)[:8]}...")
    return GRUTextGenParams(
        embeddings=flat["embeddings"],
        cell=GRUCellParams(
            kernel=flat["cell/kernel"],
            recurrent_kernel=flat["cell/recurrent_kernel"],
            bias=flat.get("cell/bias"),
        ),
        dense_kernel=flat["dense_kernel"],
        dense_bias=flat.get("dense_bias"),
    )


def load_gru_any(path: str, *, qtype: Optional[str] = None,
                 device: DeviceLike = None) -> GRUTextGenParams:
    """Dispatch on extension: a native ``.gxt`` checkpoint, else the
    reference gru.bin. A float ``.gxt`` is quantized on load when ``qtype`` is
    given; an already quantized one is served as stored."""
    if not path.endswith(".gxt"):
        return load_gru_params(path, qtype=qtype, device=device)
    from ggml_experiments_tpu_torch.quant import QTensor, quantize

    params = load_gru_checkpoint(path, device=device)
    if qtype is not None and not isinstance(params.cell.kernel, QTensor):
        dev = params.device
        params.cell.kernel = quantize(params.cell.kernel, qtype, device=dev)
        params.cell.recurrent_kernel = quantize(params.cell.recurrent_kernel, qtype, device=dev)
        params.dense_kernel = quantize(params.dense_kernel, qtype, device=dev)
    return params
