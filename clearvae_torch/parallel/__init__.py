"""Data and tensor parallelism over ``torch.distributed`` device meshes
(counterpart of ``clearvae_tpu/parallel``): ``mesh.py``, the 1-D data mesh
and the collectives of a step under it; ``tp.py``, the 2-D (data, model)
mesh that shards the state over ``model``."""

from clearvae_torch.parallel.mesh import (DATA_AXIS, Shard, data_axis_size,
                                          make_mesh, place_state,
                                          replicate_state, shard_rows,
                                          warn_if_not_divisible)
from clearvae_torch.parallel.tp import MODEL_AXIS, make_mesh2d, param_spec

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Shard", "data_axis_size", "make_mesh",
           "make_mesh2d", "param_spec", "place_state", "replicate_state",
           "shard_rows", "warn_if_not_divisible"]
