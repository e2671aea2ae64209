"""The multi-process runtime around the sharded pipelines.

Counterpart of ``ska_sdp_func_python_tpu/parallel/multihost.py``, on
``torch.distributed``:

* :func:`initialize` brings up the process group from its arguments or
  the ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` environment
  (idempotent; a no-op when nothing names a group);
* :func:`global_mesh` is a mesh over every process's shards;
* :func:`local_shard_indices` says which shards this process owns and
  builds (its plans and sorted streams only for its own rows);
* :func:`stack_shards_global` keeps each process's own shard states as
  one :class:`~.mesh.Sharded` value: no process ever holds the whole.

Nothing tells a program of a cluster: a run gives the group's address
(``tcp://host:port``), its size and each process's rank.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import Mesh, Sharded, make_mesh

__all__ = [
    "initialize",
    "global_mesh",
    "local_shard_indices",
    "stack_shards_global",
    "process_count",
    "process_index",
]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout_s: float = 600.0,
) -> None:
    """Initialise the ``torch.distributed`` process group (idempotent).

    ``coordinator_address`` is ``host:port`` of rank 0; the arguments
    default to ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``. With none of them set this is a single-process run and
    nothing is initialised. ``backend`` defaults to "nccl" where there is
    a CUDA card and "gloo" otherwise; "gloo" with shards on the card
    stages their collectives through host buffers (:mod:`.collectives`).
    """
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return  # single-process run
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize needs the coordinator address, the process count and "
            "this process's index (arguments or MASTER_ADDR/MASTER_PORT, "
            "WORLD_SIZE, RANK)"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(axis_names=("data",), shape=None, devices=None) -> Mesh:
    """A mesh over every process's shards (``devices``: this process's)."""
    return make_mesh(shape=shape, axis_names=axis_names, devices=devices)


def local_shard_indices(mesh: Mesh, axis: str = "data") -> list:
    """Indices along ``axis`` of the shards this process owns."""
    if len(mesh.axis_names) != 1 or mesh.axis_names[0] != axis:
        raise ValueError(
            "local_shard_indices supports 1D meshes (one shard per index); "
            f"got axes {mesh.axis_names}"
        )
    return list(mesh.local)


def stack_shards_global(
    shard_states: list, local_ds: list, mesh: Mesh, axis: str = "data"
) -> Sharded:
    """This process's shard states (``shard_states[k]`` is shard
    ``local_ds[k]``'s) as one value sharded along its leading axis."""
    if list(local_ds) != list(mesh.local):
        raise ValueError(f"shards {list(local_ds)}, this process owns {list(mesh.local)}")
    return Sharded(mesh, 0, list(shard_states))
