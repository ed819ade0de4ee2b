"""Mesh, sharding rules, multi-process placement and the differentiable
collectives of the DP + TP train step (over ``torch.distributed``)."""

from ggml_experiments_tpu_torch.parallel import mesh, multihost, sharding
from ggml_experiments_tpu_torch.parallel.mesh import (
    AXES,
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    axis_slice,
    infer_mesh_shape,
    make_mesh,
)
from ggml_experiments_tpu_torch.parallel.sharding import (
    P,
    PartitionSpec,
    gru_param_specs,
    mobilevit_param_specs,
    place,
)

__all__ = [
    "mesh",
    "multihost",
    "sharding",
    "AXES",
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "P",
    "PartitionSpec",
    "axis_slice",
    "infer_mesh_shape",
    "make_mesh",
    "gru_param_specs",
    "mobilevit_param_specs",
    "place",
]
