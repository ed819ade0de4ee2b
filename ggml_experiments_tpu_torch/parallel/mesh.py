"""The device mesh and its named axes over ``torch.distributed``.

One rank is one device. The ranks form a 2-D mesh with axes

* ``"data"``  -- data parallelism: batches and the serving engine's slots
  split over it;
* ``"model"`` -- tensor parallelism: weight shards and the collectives
  that join their products.

:func:`make_mesh` builds it as a ``DeviceMesh`` (``init_device_mesh`` with
``mesh_dim_names=AXES``) whose per-axis groups inherit the default group's
backend; :class:`Mesh` keeps that mesh with this rank's coordinates, so that
the placement rules (``parallel/sharding.py``) read sizes and coordinates
alone and a collective asks for its axis's group. A process outside any
group has a ``(1, 1)`` mesh with no groups; a one-rank group has one with
groups, whose collectives run on that rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch.distributed as dist

from ggml_experiments_tpu_torch.parallel import multihost

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


def infer_mesh_shape(n_devices: int, max_model: int = 8) -> Tuple[int, int]:
    """(data, model) shape: tensor parallelism up to ``max_model`` ranks,
    then data parallelism."""
    model = 1
    for cand in (2, 4, 8):
        if cand <= max_model and n_devices % cand == 0:
            model = cand
    return n_devices // model, model


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) mesh of ranks and this rank's place in it.
    ``device_mesh`` holds the process groups; a mesh built without it (one
    rank, or a layout the placement rules are asked about) has none and
    refuses collectives over an axis wider than one rank."""

    shape: Tuple[int, int]
    coords: Tuple[int, int] = (0, 0)
    device_mesh: Optional[Any] = None
    axis_names = AXES

    def _at(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r} (axes {self.axis_names})")
        return self.axis_names.index(axis)

    def size(self, axis: str) -> int:
        return self.shape[self._at(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self._at(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None for a
        one-rank axis of a mesh without groups)."""
        if self.device_mesh is None:
            if self.size(axis) == 1:
                return None
            raise RuntimeError(f"a collective over {axis!r} needs a mesh built by make_mesh "
                               f"in a process group")
        return self.device_mesh.get_group(axis)

    def all_gather(self, t, axis: str, dim: int = 0):
        """The tensors of this rank's line along ``axis``, concatenated along
        ``dim`` in coordinate order. A mesh with groups runs the collective
        even on a one-rank axis."""
        group = self.group(axis)
        return t if group is None else multihost.all_gather(t, group, dim=dim)


def make_mesh(shape: Optional[Tuple[int, int]] = None, *, device_type: str = "cuda") -> Mesh:
    """The (data, model) mesh over every rank of the default group
    (:func:`infer_mesh_shape` when ``shape`` is None). ``device_type`` is the
    ranks' device type, as ``init_device_mesh`` takes it."""
    n = multihost.process_count()
    if shape is None:
        shape = infer_mesh_shape(n)
    d, m = shape
    if d * m != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    if not multihost.in_session():
        return Mesh((1, 1))
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device_type, (d, m), mesh_dim_names=AXES)
    world = str(dist.get_backend())
    for axis in AXES:
        if dm.size(AXES.index(axis)) > 1 and str(dist.get_backend(dm.get_group(axis))) != world:
            raise RuntimeError(f"the {axis!r} group runs {dist.get_backend(dm.get_group(axis))}, "
                               f"the default group {world}")
    return Mesh((d, m), (dm.get_local_rank(DATA_AXIS), dm.get_local_rank(MODEL_AXIS)), dm)


def axis_slice(mesh: Mesh, axis: str, n: int) -> slice:
    """This rank's slice of an ``n``-long batch or slot axis split over the
    mesh ``axis`` (``n`` must divide)."""
    size = mesh.size(axis)
    if n % size:
        raise ValueError(f"{n} does not divide over the {axis!r} axis of {size}")
    per = n // size
    return slice(mesh.index(axis) * per, (mesh.index(axis) + 1) * per)


__all__ = ["AXES", "DATA_AXIS", "MODEL_AXIS", "Mesh", "axis_slice", "infer_mesh_shape",
           "make_mesh"]
