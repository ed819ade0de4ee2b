"""Parameter dataclasses as pytree nodes, so that ``torch.export`` takes a
params tree as a program input (``serving/aot``).

:func:`register_params` registers a dataclass with ``torch.utils._pytree``:
its tensor and sub-tree fields are the children (tensors are leaves); its
static fields (``{"static": True}`` metadata, and the fields named in
``static``) go in the context, which is serialized as tagged JSON so that
tuples come back as tuples; the fields named in ``drop`` (per-object caches
of derived device buffers) are left out, and an unflattened object gets
their defaults. Attributes set outside the fields (the kernels' ``_gxt_*``
operand caches) are not carried either. So a params tree whose caches an
eager call has filled flattens to the same spec as a fresh one, which is
what lets an exported program take it.

Registration leaves eager code alone: nothing in the port flattens params
through ``torch.utils._pytree`` besides ``torch.export``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable

import torch.utils._pytree as pytree

_PREFIX = "ggml_experiments_tpu_torch."


def _enc(obj):
    """JSON form of a context value, keeping the tuple/list distinction."""
    if isinstance(obj, tuple):
        return {"t": "tuple", "v": [_enc(x) for x in obj]}
    if isinstance(obj, list):
        return {"t": "list", "v": [_enc(x) for x in obj]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "v", "v": obj}
    raise TypeError(f"a static field of a params tree must be plain data, got {type(obj)}: "
                    f"{obj!r}")


def _dec(d):
    if d["t"] == "tuple":
        return tuple(_dec(x) for x in d["v"])
    if d["t"] == "list":
        return [_dec(x) for x in d["v"]]
    return d["v"]


def register_params(cls, *, static: Iterable[str] = (), drop: Iterable[str] = ()):
    """Register the dataclass ``cls`` as a pytree node (see the module
    docstring); returns ``cls``."""
    static, drop = set(static), set(drop)
    fields = [f for f in dataclasses.fields(cls) if f.name not in drop]
    ctx_names = tuple(f.name for f in fields if f.name in static or f.metadata.get("static"))
    child_names = tuple(f.name for f in fields if f.name not in ctx_names)

    def flatten(obj):
        return ([getattr(obj, n) for n in child_names],
                tuple(getattr(obj, n) for n in ctx_names))

    def flatten_with_keys(obj):
        children, ctx = flatten(obj)
        return [(pytree.GetAttrKey(n), c) for n, c in zip(child_names, children)], ctx

    def unflatten(children, ctx):
        return cls(**dict(zip(child_names, children)), **dict(zip(ctx_names, ctx)))

    pytree.register_pytree_node(
        cls, flatten, unflatten, serialized_type_name=_PREFIX + cls.__name__,
        to_dumpable_context=lambda ctx: json.dumps(_enc(ctx)),
        from_dumpable_context=lambda s: _dec(json.loads(s)),
        flatten_with_keys_fn=flatten_with_keys)
    return cls
