"""Native checkpoint container (``.gxt``) for trees of float tensors and
block-quantized weights.

Layout: ``GXT1`` magic | uint64 header_len | JSON header | 64-byte-aligned raw
little-endian tensor blobs. The header maps flattened key paths to
dtype/shape/offset; a :class:`QTensor` leaf expands to ``<path>.codes``,
``<path>.scales`` and its format's ``.mins`` / ``.hibits`` / ``.supers`` with
the logical shape and qtype recorded. Files are byte-compatible with the JAX
package's ``formats/checkpoint.py``: either package loads what the other
saved.

Key paths are written as the JAX package writes them for the same tree:
dataclass fields by name in field order (fields declared ``compare=False``
are derived caches and are not stored), dict keys **sorted**, sequences by
index, ``None`` omitted, joined with ``/`` (``cell/kernel.codes``,
``state/h``, ``inflight/3/prompt``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ggml_experiments_tpu_torch.device import DeviceLike, resolve_device
from ggml_experiments_tpu_torch.quant.qtensor import QTensor, from_numpy_blocks, to_numpy_blocks

MAGIC = b"GXT1"
ALIGN = 64

_DTYPES = {
    "float32": np.float32,
    "float16": np.float16,
    "bfloat16": None,  # stored through a 16-bit integer view
    "int8": np.int8,
    "uint8": np.uint8,
    "int32": np.int32,
    "int64": np.int64,
    "uint32": np.uint32,
    "bool": np.bool_,
}
_QUANT_SUFFIXES = (".scales", ".mins", ".hibits", ".supers")


def _fields(obj):
    return [f for f in dataclasses.fields(obj) if f.compare]


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in the JAX package's pytree order."""
    if tree is None:
        return []
    if isinstance(tree, QTensor):
        return [("/".join(prefix), tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in _fields(tree):
            out += _flatten(getattr(tree, f.name), prefix + (f.name,))
        return out
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], prefix + (str(key),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, item in enumerate(tree):
            out += _flatten(item, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _rebuild(template: Any, flat: Dict[str, Any], path: str, prefix: Tuple[str, ...] = ()):
    """``template``'s structure with every leaf replaced from ``flat``."""
    if template is None:
        return None
    if dataclasses.is_dataclass(template) and not isinstance(template, (type, QTensor)):
        # built anew, so that derived caches start empty; static configuration
        # (fields marked {"static": True}) is the template's
        kw = {f.name: _rebuild(getattr(template, f.name), flat, path, prefix + (f.name,))
              for f in _fields(template)}
        kw.update({f.name: getattr(template, f.name) for f in dataclasses.fields(template)
                   if f.metadata.get("static")})
        return type(template)(**kw)
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, path, prefix + (str(k),)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, flat, path, prefix + (str(i),))
                              for i, v in enumerate(template))
    name = "/".join(prefix)
    if name not in flat:
        raise KeyError(f"checkpoint {path} missing tensor {name!r}")
    return flat[name]


def _np_for_write(arr) -> Tuple[np.ndarray, str]:
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(arr)
    if str(a.dtype) not in _DTYPES:
        raise TypeError(f"checkpoint cannot store dtype {a.dtype}")
    return a, str(a.dtype)


def save(path: str, tree: Any, meta: Optional[Dict] = None) -> None:
    """Serialize a tree of tensors, numpy arrays and QTensors to ``path``.

    ``meta``: optional JSON-serializable dict stored in the header, read by
    :func:`read_meta` without touching tensor data. The write is atomic (temp
    file, flushed to disk, then ``os.replace``): a crash mid-save leaves the
    previous good file intact."""
    entries: List[Dict] = []
    blobs: List[np.ndarray] = []

    def add(name: str, arr, extra=None):
        a, dtype = _np_for_write(arr)
        e = {"name": name, "dtype": dtype, "shape": list(a.shape)}
        if extra:
            e.update(extra)
        entries.append(e)
        blobs.append(np.ascontiguousarray(a))

    for name, leaf in _flatten(tree):
        if not isinstance(leaf, QTensor):
            add(name, leaf)
            continue
        # logical-region planes: lane and K padding trimmed, re-padded on load
        q = {"quant": {"qtype": leaf.qtype, "logical_shape": list(leaf.shape),
                       "packed": "logical"}}
        planes = to_numpy_blocks(leaf)
        add(name + ".codes", planes[0], q)
        add(name + ".scales", planes[1], q)
        if leaf.qtype == "q4_k":
            add(name + ".mins", planes[2], q)
            # lossless: quantize() rounds supers to f16-representable values
            add(name + ".supers", planes[3].astype(np.float16), q)
        elif len(planes) == 4:
            if planes[2] is not None:
                add(name + ".mins", planes[2], q)
            if planes[3] is not None:
                add(name + ".hibits", planes[3], q)

    off = 0
    for e, b in zip(entries, blobs):
        off = (off + ALIGN - 1) // ALIGN * ALIGN
        e["offset"] = off
        e["nbytes"] = int(b.nbytes)
        off += b.nbytes
    head = {"version": 1, "tensors": entries}
    if meta:
        head["meta"] = meta
    header = json.dumps(head).encode()
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<Q", len(header)))
            f.write(header)
            base = f.tell()
            for e, b in zip(entries, blobs):
                f.seek(base + e["offset"])
                f.write(b.tobytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _read_header(f, path: str) -> Dict:
    if f.read(4) != MAGIC:
        raise ValueError(f"{path}: not a GXT1 checkpoint")
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError(f"{path}: truncated GXT1 header")
    (hlen,) = struct.unpack("<Q", raw)
    body = f.read(hlen)
    if len(body) != hlen:
        raise ValueError(f"{path}: truncated GXT1 header")
    return json.loads(body)


def read_header(path: str) -> Dict:
    """The whole JSON header (``version``, ``tensors``, optional ``meta``)."""
    with open(path, "rb") as f:
        return _read_header(f, path)


def read_meta(path: str) -> Dict:
    """Header metadata only (no tensor reads); {} when absent."""
    return read_header(path).get("meta", {})


def _tensor(a: np.ndarray, dtype: str, dev) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def load_arrays(path: str, *, device: DeviceLike = None) -> Dict[str, Any]:
    """Load as a flat dict ``{keypath: tensor | QTensor}`` on ``device``.
    Reads both the logical (trimmed) quantized layout and the older layout
    that stored the padded planes as they were."""
    dev = resolve_device(device)
    raw: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    quant: Dict[str, Dict] = {}
    with open(path, "rb") as f:
        header = _read_header(f, path)
        base = f.tell()
        for e in header["tensors"]:
            if e["dtype"] == "none":
                continue
            if e["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: tensor {e['name']!r} has unknown dtype {e['dtype']!r}")
            f.seek(base + e["offset"])
            buf = f.read(e["nbytes"])
            npdt = np.uint16 if e["dtype"] == "bfloat16" else _DTYPES[e["dtype"]]
            count = int(np.prod(e["shape"], dtype=np.int64))
            if len(buf) != e["nbytes"] or count * np.dtype(npdt).itemsize != e["nbytes"]:
                raise ValueError(f"{path}: tensor {e['name']!r} is truncated or mis-sized")
            raw[e["name"]] = np.frombuffer(buf, npdt).reshape(e["shape"])
            dtypes[e["name"]] = e["dtype"]
            if "quant" in e:
                quant[e["name"]] = e["quant"]

    out: Dict[str, Any] = {}
    for name, arr in raw.items():
        if name.endswith(".codes") and name in quant:
            stem = name[: -len(".codes")]
            q = quant[name]
            if stem + ".scales" not in raw:
                raise ValueError(f"{path}: quantized tensor {stem!r} has no scales")
            planes = {p: raw.get(f"{stem}.{p}") for p in ("mins", "hibits", "supers")}
            if planes["supers"] is not None:
                planes["supers"] = planes["supers"].astype(np.float32)
            shape = tuple(q["logical_shape"])
            if q.get("packed") == "logical":
                out[stem] = from_numpy_blocks(arr, raw[stem + ".scales"], shape, q["qtype"],
                                              device=dev, **planes)
            else:  # older layout: planes stored padded, taken as they are
                from ggml_experiments_tpu_torch.convert import qtensor_from_planes

                out[stem] = qtensor_from_planes(
                    dict(codes=arr, scales=raw[stem + ".scales"], shape=shape,
                         qtype=q["qtype"], **planes), dev)
        elif name.endswith(_QUANT_SUFFIXES) and name in quant:
            continue  # paired with .codes
        else:
            out[name] = _tensor(arr, dtypes[name], dev)
    return out


def load_into(path: str, template: Any, *, device: DeviceLike = None) -> Any:
    """Load a checkpoint into the structure of ``template`` (same tree)."""
    return _rebuild(template, load_arrays(path, device=device), path)


@dataclasses.dataclass
class CheckpointManager:
    """Best-by-metric checkpoint rotation (save only when the monitored
    metric improves)."""

    path: str
    best: float = float("inf")
    mode: str = "min"

    def maybe_save(self, tree: Any, metric: float) -> bool:
        better = metric < self.best if self.mode == "min" else metric > self.best
        if better:
            self.best = metric
            save(self.path, tree)
        return better
