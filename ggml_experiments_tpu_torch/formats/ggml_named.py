"""Reader and writer of the reference's named-tensor weight file (``weight.ggml``).

A flat stream of records until end of file, each

  int32 name_len | ascii name | int32 n_dims | int32 dims[n_dims] (natural TF
  order) | float32 data (row-major in that shape)

Names are full TF variable paths, e.g.
``tf_mobile_vi_t_model/mobilevit/conv_stem/convolution/kernel:0``. The reader
stops cleanly at the end of the file and raises on a truncated record. The
reference loader's f16 policy for names containing "convolution" is a load
option of ``models.mobilevit`` (``conv_dtype``), not part of the format.
numpy, with the native runtime's indexer where it is available.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict, Iterable, Optional, Tuple

import numpy as np


def read_named_tensors(path: str) -> Dict[str, np.ndarray]:
    """Parse the whole file into ``{tf_variable_path: float32 ndarray}``:
    indexed by the native runtime where it is available, else by
    :func:`read_named_tensors_py`, the plain version, which also names the
    fault of a file the native indexer refuses."""
    from ggml_experiments_tpu_torch import runtime

    if not runtime.available():
        return read_named_tensors_py(path)
    try:
        return runtime.read_named_tensors_native(path)
    except runtime.NativeParseError:
        read_named_tensors_py(path)
        raise


def read_named_tensors_py(path: str) -> Dict[str, np.ndarray]:
    """The numpy reader."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        while True:
            rec = _read_record(f)
            if rec is None:
                return out
            name, arr = rec
            out[name] = arr


def _read_exact(f: BinaryIO, n: int, what: str) -> bytes:
    buf = f.read(n)
    if len(buf) != n:
        raise EOFError(f"truncated {what} ({len(buf)}/{n} bytes)")
    return buf


def _read_record(f: BinaryIO) -> Optional[Tuple[str, np.ndarray]]:
    head = f.read(4)
    if len(head) == 0:
        return None
    if len(head) < 4:
        raise EOFError("truncated record header")
    (name_len,) = struct.unpack("<i", head)
    if not 0 < name_len < 4096:
        raise ValueError(f"implausible name length {name_len}")
    name = _read_exact(f, name_len, "tensor name").decode("ascii")
    (n_dims,) = struct.unpack("<i", _read_exact(f, 4, f"{name} n_dims"))
    if not 0 < n_dims <= 4:
        raise ValueError(f"{name}: implausible n_dims {n_dims}")
    dims = struct.unpack(f"<{n_dims}i", _read_exact(f, 4 * n_dims, f"{name} dims"))
    if any(d <= 0 for d in dims):
        raise ValueError(f"{name}: implausible dims {dims}")
    count = int(np.prod(dims))
    data = np.fromfile(f, dtype="<f4", count=count)
    if data.size != count:
        raise EOFError(f"{name}: truncated data ({data.size}/{count} floats)")
    return name, data.reshape(dims)


def write_named_tensors(path: str, tensors: Iterable[Tuple[str, np.ndarray]]) -> None:
    with open(path, "wb") as f:
        for name, arr in tensors:
            arr = np.ascontiguousarray(arr, dtype="<f4")
            nb = name.encode("ascii")
            f.write(struct.pack("<i", len(nb)))
            f.write(nb)
            f.write(struct.pack("<i", arr.ndim))
            for d in arr.shape:
                f.write(struct.pack("<i", d))
            arr.tofile(f)
