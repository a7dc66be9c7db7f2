"""Mesh layer: source parallelism and edge sharding over ranks on
``torch.distributed``."""

from paralleljohnson_tpu_torch.parallel import multihost
from paralleljohnson_tpu_torch.parallel.mesh import (
    edge_sharded_bellman_ford,
    make_edge_mesh,
    make_mesh,
    make_mesh_2d,
    sharded_fanout,
    sharded_fanout_2d,
    sharded_dia_fanout,
    sharded_gs_fanout,
    sharded_tight_pred,
)

__all__ = [
    "edge_sharded_bellman_ford",
    "make_edge_mesh",
    "make_mesh",
    "make_mesh_2d",
    "multihost",
    "sharded_fanout",
    "sharded_fanout_2d",
    "sharded_dia_fanout",
    "sharded_gs_fanout",
    "sharded_tight_pred",
]
