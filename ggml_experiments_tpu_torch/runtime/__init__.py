"""The native host runtime: ctypes bindings of ``runtime/native/gxt_native.cpp``.

The host-side jobs around the card's kernels in C++: the block codecs, the
reference's bilinear resample and PNG unfilter, and the indexers of the two
binary weight formats. The library is built with ``g++ -O3 -shared -fPIC`` at
first use into the git-ignored build directory (``_build.build_dir()``,
``build/`` or ``GXT_TORCH_BUILD_DIR``), hash-named by its source and flags
like the CUDA kernels, and its ABI version is checked on load. A failed
build or load raises with the compiler's log; only a missing ``g++`` makes
:func:`available` false, and then every entry point returns None.

Each entry point has a numpy plain version in the package that the tests
hold it to: the codecs of ``quant/qtensor.py`` (the port quantizes on the
device; these codecs are the module's API, not its quantize path), the
readers of ``formats/gru_bin.py`` and ``formats/ggml_named.py``, and the
image helpers of ``utils/image.py`` and ``utils/image_codecs.py``, which
call the native versions where the library is available. The codecs return
planes of N columns (no lane padding), bit-equal to the numpy codec on them,
the rows past K included (q5_0 writes q = 16 there: a 1 in the fifth-bit
plane, as the numpy codec does).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "gxt_native.cpp")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
ABI = 3

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}   # library path -> the loaded library


class NativeParseError(ValueError):
    """The native indexer refused a weight file."""


def _cxx() -> Optional[str]:
    return shutil.which("g++")


def lib_path() -> str:
    """Where the library of this source and these flags is built."""
    from ggml_experiments_tpu_torch import _build

    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(_build.build_dir(), f"libgxt_native_{h.hexdigest()[:12]}.so")


def _build_lib(out: str, cxx: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for runtime/native/gxt_native.cpp (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; None where there is no
    ``g++``."""
    out = lib_path()
    lib = _libs.get(out)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(out)
        if lib is not None:
            return lib
        if not os.path.exists(out):
            cxx = _cxx()
            if cxx is None:
                return None
            _build_lib(out, cxx)
        lib = ctypes.CDLL(out)
        lib.gxt_abi_version.restype = ctypes.c_int
        if lib.gxt_abi_version() != ABI:
            raise RuntimeError(f"{out}: ABI {lib.gxt_abi_version()}, expected {ABI}")
        lib.ggml_named_index.restype = ctypes.c_int64
        lib.gru_bin_index.restype = ctypes.c_int64
        _libs[out] = lib
    return lib


def available() -> bool:
    return load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _i64(*xs):
    return [ctypes.c_int64(int(x)) for x in xs]


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed rc={rc}")


# ---------------------------------------------------------------------------
# Quant codecs
# ---------------------------------------------------------------------------

def _planes(w: np.ndarray):
    w = np.ascontiguousarray(w, np.float32)
    k, n = w.shape
    return w, k, n, (k + 31) // 32 * 32


def quantize_q8_0(w: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Q8_0: (codes int8 (Kp, N), scales f32 (Kp/32, N)), or None."""
    lib = load()
    if lib is None:
        return None
    w, k, n, kp = _planes(w)
    codes = np.empty((kp, n), np.int8)
    scales = np.empty((kp // 32, n), np.float32)
    _check(lib.q8_0_quantize(_ptr(w), *_i64(k, n), _ptr(codes), _ptr(scales)), "q8_0_quantize")
    return codes, scales


def quantize_q4_0(w: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Q4_0: (codes u8 (Kp/2, N), scales f32 (Kp/32, N)), or None."""
    lib = load()
    if lib is None:
        return None
    w, k, n, kp = _planes(w)
    codes = np.empty((kp // 2, n), np.uint8)
    scales = np.empty((kp // 32, n), np.float32)
    _check(lib.q4_0_quantize(_ptr(w), *_i64(k, n), _ptr(codes), _ptr(scales)), "q4_0_quantize")
    return codes, scales


def quantize_q4_1(w: np.ndarray):
    """Q4_1: (codes u8 (Kp/2, N), scales f32, mins f32), or None."""
    lib = load()
    if lib is None:
        return None
    w, k, n, kp = _planes(w)
    codes = np.empty((kp // 2, n), np.uint8)
    scales = np.empty((kp // 32, n), np.float32)
    mins = np.empty((kp // 32, n), np.float32)
    _check(lib.q4_1_quantize(_ptr(w), *_i64(k, n), _ptr(codes), _ptr(scales), _ptr(mins)),
           "q4_1_quantize")
    return codes, scales, mins


def quantize_q5_0(w: np.ndarray):
    """Q5_0: (codes u8 (Kp/2, N), hibits u8 (Kp/8, N), scales), or None."""
    lib = load()
    if lib is None:
        return None
    w, k, n, kp = _planes(w)
    codes = np.empty((kp // 2, n), np.uint8)
    hibits = np.empty((kp // 8, n), np.uint8)
    scales = np.empty((kp // 32, n), np.float32)
    _check(lib.q5_0_quantize(_ptr(w), *_i64(k, n), _ptr(codes), _ptr(hibits), _ptr(scales)),
           "q5_0_quantize")
    return codes, hibits, scales


def quantize_q5_1(w: np.ndarray):
    """Q5_1: (codes, hibits, scales, mins), or None."""
    lib = load()
    if lib is None:
        return None
    w, k, n, kp = _planes(w)
    codes = np.empty((kp // 2, n), np.uint8)
    hibits = np.empty((kp // 8, n), np.uint8)
    scales = np.empty((kp // 32, n), np.float32)
    mins = np.empty((kp // 32, n), np.float32)
    _check(lib.q5_1_quantize(_ptr(w), *_i64(k, n), _ptr(codes), _ptr(hibits), _ptr(scales),
                             _ptr(mins)), "q5_1_quantize")
    return codes, hibits, scales, mins


def dequantize(codes: np.ndarray, scales: np.ndarray, qtype: str,
               mins: Optional[np.ndarray] = None,
               hibits: Optional[np.ndarray] = None,
               supers: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """The f32 (Kp, N) plane of a format's planes, or None. q4_k takes its
    uint8 sub-block scale and min codes as ``scales`` and ``mins`` and its
    f32 stacked scale-of-scales rows as ``supers``."""
    lib = load()
    if lib is None:
        return None
    n = codes.shape[1]
    u8 = lambda a: np.ascontiguousarray(a, np.uint8)  # noqa: E731
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    if qtype == "q4_k":
        codes, sc, mc, sp = u8(codes), u8(scales), u8(mins), f32(supers)
        kp = codes.shape[0] * 2
        out = np.empty((kp, n), np.float32)
        rc = lib.q4_k_dequantize(_ptr(codes), _ptr(sc), _ptr(mc), _ptr(sp),
                                 *_i64(kp, n, sp.shape[0] // 2), _ptr(out))
    elif qtype == "q8_0":
        codes, scales = np.ascontiguousarray(codes, np.int8), f32(scales)
        kp = codes.shape[0]
        out = np.empty((kp, n), np.float32)
        rc = lib.q8_0_dequantize(_ptr(codes), _ptr(scales), *_i64(kp, n), _ptr(out))
    elif qtype == "q4_0":
        codes, scales = u8(codes), f32(scales)
        kp = codes.shape[0] * 2
        out = np.empty((kp, n), np.float32)
        rc = lib.q4_0_dequantize(_ptr(codes), _ptr(scales), *_i64(kp, n), _ptr(out))
    elif qtype == "q4_1":
        codes, scales, mins = u8(codes), f32(scales), f32(mins)
        kp = codes.shape[0] * 2
        out = np.empty((kp, n), np.float32)
        rc = lib.q4_1_dequantize(_ptr(codes), _ptr(scales), _ptr(mins), *_i64(kp, n), _ptr(out))
    elif qtype == "q5_0":
        codes, hibits, scales = u8(codes), u8(hibits), f32(scales)
        kp = codes.shape[0] * 2
        out = np.empty((kp, n), np.float32)
        rc = lib.q5_0_dequantize(_ptr(codes), _ptr(hibits), _ptr(scales), *_i64(kp, n),
                                 _ptr(out))
    elif qtype == "q5_1":
        codes, hibits, scales, mins = u8(codes), u8(hibits), f32(scales), f32(mins)
        kp = codes.shape[0] * 2
        out = np.empty((kp, n), np.float32)
        rc = lib.q5_1_dequantize(_ptr(codes), _ptr(hibits), _ptr(scales), _ptr(mins),
                                 *_i64(kp, n), _ptr(out))
    else:
        raise ValueError(qtype)
    _check(rc, f"{qtype}_dequantize")
    return out


# ---------------------------------------------------------------------------
# Images
# ---------------------------------------------------------------------------

def bilinear_resize_u8(img: np.ndarray, out_h: int, out_w: int,
                       scale: float) -> Optional[np.ndarray]:
    """The reference's bilinear resample of a u8 HWC image, or None."""
    lib = load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), np.uint8)
    _check(lib.bilinear_resize_u8(_ptr(img), *_i64(h, w, c, out_h, out_w),
                                  ctypes.c_float(scale), _ptr(out)), "bilinear_resize_u8")
    return out


def png_unfilter(raw: np.ndarray, filters: np.ndarray, bpp: int) -> Optional[np.ndarray]:
    """PNG scanline unfilter: raw (H, stride) filtered bytes and the rows'
    filter types -> the reconstructed bytes, or None. A filter type past 4
    raises ValueError."""
    lib = load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, np.uint8)
    filters = np.ascontiguousarray(filters, np.uint8)
    h, stride = raw.shape
    out = np.empty((h, stride), np.uint8)
    rc = lib.png_unfilter(_ptr(raw), *_i64(h, stride, bpp), _ptr(filters), _ptr(out))
    if rc != 0:
        raise ValueError(f"PNG: bad filter byte {int(filters[filters > 4][0])}")
    return out


# ---------------------------------------------------------------------------
# Weight-file readers (indexed natively, payloads read in bulk with numpy)
# ---------------------------------------------------------------------------

_MAX_TENSORS = 4096


def _read_payloads(path: str, count: int, n_dims, dims, offsets) -> List[np.ndarray]:
    out = []
    with open(path, "rb") as f:
        for i in range(count):
            shape = tuple(int(d) for d in dims[i * 4: i * 4 + n_dims[i]])
            f.seek(int(offsets[i]))
            out.append(np.fromfile(f, "<f4", count=int(np.prod(shape))).reshape(shape))
    return out


def read_named_tensors_native(path: str) -> Optional[Dict[str, np.ndarray]]:
    """A ``weight.ggml`` file as ``{name: f32 array}``, or None. A file the
    indexer refuses raises :class:`NativeParseError`."""
    lib = load()
    if lib is None:
        return None
    name_buf = ctypes.create_string_buffer(1 << 20)
    n_dims = np.zeros(_MAX_TENSORS, np.int32)
    dims = np.zeros(_MAX_TENSORS * 4, np.int32)
    offsets = np.zeros(_MAX_TENSORS, np.int64)
    count = lib.ggml_named_index(path.encode(), name_buf, *_i64(len(name_buf)), _ptr(n_dims),
                                 _ptr(dims), _ptr(offsets), *_i64(_MAX_TENSORS))
    if count < 0:
        raise NativeParseError(f"{path}: native parse error {-count}")
    names = [n.decode("ascii") for n in name_buf.raw.split(b"\0")[:count]]
    return dict(zip(names, _read_payloads(path, count, n_dims, dims, offsets)))


def read_gru_bin_native(path: str) -> Optional[List[np.ndarray]]:
    """A ``gru.bin`` file's tensors in file order, or None. A file the
    indexer refuses raises :class:`NativeParseError`."""
    lib = load()
    if lib is None:
        return None
    n_dims = np.zeros(_MAX_TENSORS, np.int32)
    dims = np.zeros(_MAX_TENSORS * 4, np.int32)
    offsets = np.zeros(_MAX_TENSORS, np.int64)
    count = lib.gru_bin_index(path.encode(), _ptr(n_dims), _ptr(dims), _ptr(offsets),
                              *_i64(_MAX_TENSORS))
    if count < 0:
        raise NativeParseError(f"{path}: native parse error {-count}")
    return _read_payloads(path, count, n_dims, dims, offsets)
