"""The port's mesh: shards owned by processes.

Counterpart of ``ska_sdp_func_python_tpu/parallel/mesh.py``. The JAX
layer is one program over a ``jax.sharding.Mesh`` of devices, with the
collectives XLA inserts inside ``shard_map``. Here the mesh is ``nshards``
shards along one axis ("data"), owned by processes: process r of W owns
the contiguous block ``[r k, (r + 1) k)``, k = nshards / W (the JAX
package's ``multihost.local_shard_indices``), runs its shards one after
another on their devices (several may share one card), and a collective
is the sum over the local shards followed by a ``torch.distributed``
collective across processes (:mod:`.collectives`). One process with 8
CPU shards is the JAX test mesh, one process with 4 shards on one card
drives the card, and a run of one shard per process on four cards is the
same code.

DTensor and ``DeviceMesh`` are not used: they need one process per
device, which a one-card machine cannot give for a mesh of four.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import default_device

__all__ = ["Mesh", "Sharded", "make_mesh", "P", "NamedSharding", "replicated", "shard_rows"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``nshards`` shards along ``axis_names[0]``; ``local`` are the global
    indices of this process's shards, ``devices`` the device of each, and
    ``group`` the process group (None: one process, no
    ``torch.distributed``)."""

    nshards: int
    local: tuple
    devices: tuple
    group: object = None
    axis_names: tuple = ("data",)

    @property
    def shape(self) -> dict:
        """Shards per axis, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_names[0]: self.nshards}

    @property
    def multiprocess(self) -> bool:
        return self.group is not None and torch.distributed.get_world_size(self.group) > 1


@dataclasses.dataclass
class Sharded:
    """A value split along dimension ``dim`` over a mesh's shards
    (``dim`` None: replicated), held as this process's pieces, one per
    local shard in ``mesh.local`` order; no process holds the whole."""

    mesh: Mesh
    dim: int | None
    pieces: list

    def gather(self) -> torch.Tensor:
        """The whole value on this process (an all-gather across
        processes)."""
        if self.dim is None:
            return self.pieces[0]
        from .collectives import all_gather

        return torch.cat(all_gather(self.mesh, self.pieces), dim=self.dim)


class P(tuple):
    """A partition spec: the mesh axis (or None) of each dimension."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement record: ``spec`` over ``mesh``."""

    mesh: Mesh
    spec: P


def make_mesh(shape=None, axis_names=("data",), devices=None) -> Mesh:
    """A one-axis mesh over every process of the ``torch.distributed``
    group (when one is initialised).

    :param shape: ``(nshards,)``; defaults to ``len(devices)`` times the
        number of processes
    :param devices: this process's shard devices (None:
        ``config.default_device()``, the card); one device serves all of
        this process's shards, else one device a shard
    """
    if devices is None:
        devices = [default_device()]
    devices = [torch.device(d) for d in devices]
    dist = torch.distributed
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    if shape is None:
        shape = (len(devices) * world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} for axes {tuple(axis_names)}")
    if len(shape) != 1:
        # as the JAX package's local_shard_indices: its pipelines shard
        # one axis
        raise ValueError(
            "the port's meshes have one axis (one shard per index); got "
            f"mesh shape {dict(zip(axis_names, shape))}"
        )
    nshards = shape[0]
    if nshards < 1 or nshards % world:
        raise ValueError(f"{nshards} shards over {world} processes")
    k = nshards // world
    if len(devices) == 1:
        devices = devices * k
    elif len(devices) != k:
        raise ValueError(f"{len(devices)} devices for {k} local shards")
    return Mesh(
        nshards=nshards,
        local=tuple(range(rank * k, (rank + 1) * k)),
        devices=tuple(devices),
        group=group,
        axis_names=tuple(axis_names),
    )


def replicated(mesh: Mesh) -> NamedSharding:
    """Placement replicated across the whole mesh."""
    return NamedSharding(mesh, P())


def shard_rows(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Placement that splits the leading dimension over ``axis``."""
    return NamedSharding(mesh, P(axis))
