"""Sharded and distributed pipelines over a mesh of process-owned shards.

Counterpart of ``ska_sdp_func_python_tpu/parallel``: the JAX package's
``jax.sharding`` mesh and the collectives XLA inserts become shards owned
by processes and the collectives of :mod:`.collectives` on
``torch.distributed`` (NCCL on the card, gloo on the CPU).
"""

from . import multihost
from .distributed import (
    distributed_invert,
    distributed_predict,
    distributed_solve_gaintable,
)
from .fused import sharded_ical
from .mesh import NamedSharding, P, make_mesh, replicated, shard_rows
from .redistribute import redistribute_visibility, reshard
from .selfcal import distributed_ical

__all__ = [
    "multihost",
    "reshard",
    "redistribute_visibility",
    "make_mesh",
    "replicated",
    "shard_rows",
    "P",
    "NamedSharding",
    "distributed_invert",
    "distributed_predict",
    "distributed_solve_gaintable",
    "distributed_ical",
    "sharded_ical",
]
