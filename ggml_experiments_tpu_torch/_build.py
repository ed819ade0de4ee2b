"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (``build/libgxt_<name>_<hash>.so``, the hash covering
the sources) and is loaded with :mod:`ctypes`. The build runs at first use;
:func:`build_all` starts one ``nvcc`` per source, all at once. A missing
compiler, a failed build or a failed load raises: there is no fallback.

``GXT_TORCH_BUILD_DIR`` overrides the build directory (default: ``build/``
beside the package).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG_DIR, "csrc")
SOURCES = ("qmatmul", "gru_persistent", "gru_train", "flash_attention",
           "transformer_layer", "inverted_residual")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> str:
    return os.environ.get("GXT_TORCH_BUILD_DIR",
                          os.path.join(os.path.dirname(_PKG_DIR), "build"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"libgxt_{name}_{h.hexdigest()[:12]}.so")


def _start(name: str):
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, proc, tmp, out


def _finish(job) -> None:
    name, proc, tmp, out = job
    log, _ = proc.communicate()
    with open(out[:-3] + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every kernel source that has no up-to-date library, one
    ``nvcc`` per source, all started together."""
    with _LOCK:
        jobs = [j for j in (_start(n) for n in SOURCES) if j is not None]
        errors = []
        for job in jobs:
            try:
                _finish(job)
            except RuntimeError as ex:
                errors.append(str(ex))
        if errors:
            raise RuntimeError("\n".join(errors))


def ptxas_report(name: str) -> str:
    """The compiler's register / shared-memory lines for one kernel source."""
    log = _lib_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return " | ".join(line.strip() for line in f
                          if "registers" in line or "spill" in line)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if name not in SOURCES:
        raise KeyError(name)
    build_all()
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(_lib_path(name))
            lib.gxt_error_string.restype = ctypes.c_char_p
            lib.gxt_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = lib.gxt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
