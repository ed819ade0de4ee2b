"""Tensor-parallel placement rules for the GRU's and MobileViT's parameters.

The rules are the JAX package's (``parallel/sharding.py``), Megatron-style so
that each product needs one collective:

* GRU: gate kernels column-parallel over ``model`` (the 3U gate dim), the
  state replicated (its product is all-gathered back to (B, 3U) every step);
  the vocab head row-parallel; embeddings and the head's bias replicated;
* MobileViT: Q/K/V and the MLP-in column-parallel (their biases sharded
  alike), attention-out and MLP-out row-parallel, the classifier
  row-parallel; the convolutions, LayerNorms and the other biases
  replicated.

A spec is a :class:`PartitionSpec`: a tuple of mesh axis names (or None) per
dimension, compared leaf by leaf with the JAX package's. :func:`place` gives
each rank its own shards as :class:`Placed` leaves, which carry what the
sharded products need (axis, dimension, the mesh and its groups, the global
shape); replicated leaves stay plain tensors. A Placed weight computes its
own product (:meth:`Placed.matmul`, which ``ops/linear.matmul`` calls for
any weight that is not a tensor): a column-parallel one runs the product on
the local columns and all-gathers the outputs; a row-parallel one is
all-gathered before the product (the JAX qmatmul rule's gather path), so the
result is one device's bit for bit.

Block-quantized weights shard codes and scales (and their other planes) by
the same logical spec, with the JAX package's sanitization
(:func:`qtensor_sharding`).

Every gather goes through ``multihost.all_gather``, whose backward hands a
rank its own slice of the gradient: a float shard whose ``local`` requires
grad is trainable, and its gradient is this rank's part of the whole
weight's (the train step then sums it over ``data``:
``training/gru_trainer``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

from ggml_experiments_tpu_torch.ops import linear
from ggml_experiments_tpu_torch.ops.attention import AttentionParams
from ggml_experiments_tpu_torch.ops.gru import GRUCellParams
from ggml_experiments_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from ggml_experiments_tpu_torch.quant.qmatmul import qmatmul
from ggml_experiments_tpu_torch.quant.qtensor import BLOCK, PLANE_NAMES, QTensor


class PartitionSpec(tuple):
    """Mesh axis (or None) per dimension of a leaf; ``P()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec
Weight = Union[torch.Tensor, QTensor]


def _shard(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide over {n} ranks")
    w = t.shape[dim] // n
    return t.narrow(dim, i * w, w).contiguous()


@dataclasses.dataclass(eq=False)
class Placed:
    """This rank's shard of a weight: ``local`` is the slice along ``dim``
    (0 row-parallel, 1 column-parallel; 0 for a sharded vector) that the
    rank at its coordinate of the mesh ``axis`` holds; ``global_shape`` is
    the whole weight's logical shape (what ``.shape`` reports). ``local`` may
    be a leaf that requires grad: :meth:`gather` and :meth:`matmul` are
    differentiable in it."""

    local: Weight
    spec: PartitionSpec
    dim: int
    axis: str
    mesh: Mesh
    global_shape: Tuple[int, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.global_shape

    def gather(self) -> Weight:
        """The whole weight, all-gathered over the axis: for a QTensor every
        plane, so that it equals the unsharded planes bit for bit."""
        if isinstance(self.local, QTensor):
            qt = self.local
            planes = {name: self.mesh.all_gather(getattr(qt, name), self.axis, self.dim)
                      for name in PLANE_NAMES if getattr(qt, name) is not None}
            return QTensor(shape=tuple(self.global_shape), qtype=qt.qtype, **planes)
        return self.mesh.all_gather(self.local, self.axis, self.dim)

    def matmul(self, x: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
        """``x @ self``: column-parallel, the local product (a QTensor's
        kernel-or-matmul gate decided on the whole weight's K*N, as the JAX
        package decides it) all-gathered along N; row-parallel, the whole
        weight gathered first. A float column shard whose input has more rows
        than the weight (K) is gathered too, the smaller of the two transfers
        (the train step's whole-sequence input projection: T*B rows, K = E).
        Under autograd the local product's input gradient, which each rank
        forms from its own columns, is summed over the axis (Megatron's
        ``f``), and the outputs' gather hands each rank its columns'
        gradient."""
        rows = x.numel() // max(x.shape[-1], 1)
        if self.dim == 0 or (not isinstance(self.local, QTensor)
                             and rows > self.global_shape[0]):
            return linear.matmul(x, self.gather(), compute_dtype=compute_dtype)
        x = self.mesh.sum_grad(x, self.axis)
        if isinstance(self.local, QTensor):
            y = qmatmul(x, self.local, compute_dtype=compute_dtype, gate_shape=self.global_shape)
        else:
            y = linear.matmul(x, self.local, compute_dtype=compute_dtype)
        y = self.mesh.all_gather(y, self.axis, dim=y.dim() - 1)
        return y[..., :self.global_shape[1]]


def _spec_dim(spec) -> Tuple[Optional[int], Optional[str]]:
    """(dimension, axis) of the one sharded dimension of ``spec``."""
    dims = [(d, a) for d, a in enumerate(spec or ()) if a is not None]
    if len(dims) > 1:
        raise ValueError(f"{spec}: one sharded dimension a leaf")
    return dims[0] if dims else (None, None)


def qtensor_sharding(mesh: Mesh, qt: QTensor, spec) -> Union[QTensor, Placed]:
    """Place a QTensor's planes with a partition spec, as the JAX package
    does. Row-parallel (``P('model', None)``) shards K, which block
    quantization ties to scale rows: it is honored only when every shard
    holds whole 32-row blocks (``Kp % (32 * n) == 0``) and never for q4_k
    (its supers plane stacks two halves that a row shard would split); q4_0
    and the other nibble formats' codes then shard at Kp/2. Otherwise the
    request falls back to column-parallel (N is padded to 128 lanes and
    divides). A replicated spec, or a one-rank axis, returns the QTensor
    itself."""
    axes = [a for a in (spec or ()) if a is not None]
    row, col = (tuple(spec) + (None, None))[:2] if axes else (None, None)
    if qt.qtype == "q4_k":
        row = None
    if row is not None and qt.kp % (BLOCK * mesh.size(row)) == 0:
        eff = P(row, col)
    elif axes:
        eff = P(None, axes[0])
    else:
        return qt
    dim, axis = _spec_dim(eff)
    n, i = mesh.size(axis), mesh.index(axis)
    if n == 1:
        return qt
    planes = {name: _shard(getattr(qt, name), dim, n, i)
              for name in PLANE_NAMES if getattr(qt, name) is not None}
    if dim == 0:
        local_shape = (qt.kp // n, qt.n)
    else:
        local_shape = (qt.k, qt.np_ // n)
    local = QTensor(shape=local_shape, qtype=qt.qtype, **planes)
    return Placed(local, eff, dim, axis, mesh, tuple(qt.shape))


def _place_leaf(leaf, spec, mesh: Mesh):
    if leaf is None:
        return None
    if isinstance(leaf, QTensor):
        return qtensor_sharding(mesh, leaf, spec)
    dim, axis = _spec_dim(spec)
    if dim is None or mesh.size(axis) == 1:
        return leaf
    return Placed(_shard(leaf, dim, mesh.size(axis), mesh.index(axis)), P(*spec), dim, axis,
                  mesh, tuple(leaf.shape))


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over the tensor / QTensor leaves of a params
    dataclass tree and the spec tree shaped like it; the ``cache`` field of
    a params object is not a leaf (the result gets an empty one)."""
    if tree is None or isinstance(tree, (torch.Tensor, QTensor)):
        return fn(tree, specs)
    if dataclasses.is_dataclass(tree):
        kw = {f.name: ({} if f.name == "cache" else
                       _zip_map(fn, getattr(tree, f.name), getattr(specs, f.name)))
              for f in dataclasses.fields(tree) if f.init}
        return type(tree)(**kw)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_map(fn, t, s) for t, s in zip(tree, specs))
    return tree


def spec_like(tree: Any, spec_tree: Any):
    """The spec of every leaf of ``tree``, in ``tree``'s structure (specs
    broadcast onto QTensor leaves)."""
    return _zip_map(lambda _, s: s, tree, spec_tree)


def place(tree: Any, spec_tree: Any, mesh: Mesh):
    """Each leaf as this rank holds it under its spec: a :class:`Placed`
    shard, or the leaf itself where the spec (or its axis) replicates it.
    A placed params object remembers its mesh (:func:`mesh_of`)."""
    out = _zip_map(lambda leaf, s: _place_leaf(leaf, s, mesh), tree, spec_tree)
    if hasattr(out, "cache"):
        out.cache["mesh"] = mesh
    return out


def mesh_of(params) -> Optional[Mesh]:
    """The mesh :func:`place` put ``params`` on (None if unplaced)."""
    return getattr(params, "cache", {}).get("mesh")


def full(x):
    """The whole leaf (a Placed one all-gathered)."""
    return x.gather() if isinstance(x, Placed) else x


def gru_param_specs(params):
    """The spec tree shaped like ``params`` (a ``GRUTextGenParams``)."""
    col = P(None, MODEL_AXIS)
    return type(params)(
        embeddings=P(),
        cell=GRUCellParams(
            kernel=col,
            recurrent_kernel=col,
            bias=None if params.cell.bias is None else P(None, MODEL_AXIS),
        ),
        dense_kernel=P(MODEL_AXIS, None),
        dense_bias=None if params.dense_bias is None else P(),
    )


def _replicated(tree):
    """``P()`` for every tensor leaf of ``tree`` (None stays None)."""
    return _zip_map(lambda leaf, _: None if leaf is None else P(), tree, tree)


def _attention_specs(p: AttentionParams) -> AttentionParams:
    col, row = P(None, MODEL_AXIS), P(MODEL_AXIS, None)
    return dataclasses.replace(p, wq=col, bq=P(MODEL_AXIS), wk=col, bk=P(MODEL_AXIS), wv=col,
                               bv=P(MODEL_AXIS), wo=row, bo=P())


def mobilevit_param_specs(params):
    """The spec tree shaped like ``params`` (a ``MobileViTParams``): the
    convolutions replicated, each transformer layer's dense kernels
    Megatron-paired over ``model``, the classifier row-parallel. Its static
    fields (heads, eps, patch size, the kernel routes) are ``params``'."""
    rep = P()

    def layer_spec(tl):
        return dataclasses.replace(
            _replicated(tl), attention=_attention_specs(tl.attention),
            intermediate_kernel=P(None, MODEL_AXIS), intermediate_bias=P(MODEL_AXIS),
            output_kernel=P(MODEL_AXIS, None))

    def block_spec(b):
        return dataclasses.replace(_replicated(b),
                                   transformer=tuple(layer_spec(t) for t in b.transformer))

    return dataclasses.replace(
        _replicated(params),
        layer_3=block_spec(params.layer_3), layer_4=block_spec(params.layer_4),
        layer_5=block_spec(params.layer_5),
        classifier_kernel=None if params.classifier_kernel is None else P(MODEL_AXIS, None),
        classifier_bias=None if params.classifier_bias is None else rep)


__all__ = ["P", "PartitionSpec", "Placed", "full", "gru_param_specs", "mesh_of",
           "mobilevit_param_specs", "place", "qtensor_sharding", "spec_like"]
