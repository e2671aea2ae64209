"""Resharding between the stages' decompositions.

Counterpart of ``ska_sdp_func_python_tpu/parallel/redistribute.py``.
Gridding prefers baseline shards (uv footprints local), gain solves time
shards (solution intervals local), spectral stages channel shards. A
value here is a :class:`~.mesh.Sharded` record (the mesh, the sharded
dimension and this process's pieces) or a whole tensor that every
process holds. Within a process a reshard re-slices; across processes
the pieces travel by an all-gather (:func:`.collectives.all_gather`) and
each process keeps its new pieces (``Sharded.gather``). Values come back
unchanged, bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from .mesh import Mesh, Sharded

__all__ = ["reshard", "redistribute_visibility"]


def _reshard_leaf(leaf, mesh: Mesh, dim):
    if isinstance(leaf, Sharded) and leaf.dim == dim and leaf.mesh == mesh:
        return leaf
    x = leaf.gather() if isinstance(leaf, Sharded) else leaf
    if dim is None:
        return Sharded(mesh, None, [x.to(dev) for dev in mesh.devices])
    n = x.shape[dim]
    if n % mesh.nshards:
        raise ValueError(f"dimension {dim} of {n} does not split over {mesh.nshards} shards")
    k = n // mesh.nshards
    return Sharded(mesh, dim, [x.narrow(dim, d * k, k).to(dev) for d, dev in zip(mesh.local, mesh.devices)])


def _leaves(tree):
    """The tensor (or Sharded) leaves of a dataclass, mapping or sequence
    with the function that rebuilds it from new leaves."""
    if isinstance(tree, (torch.Tensor, Sharded)):
        return [tree], lambda ls: ls[0]
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)
                 if isinstance(getattr(tree, f.name), (torch.Tensor, Sharded))]
        return ([getattr(tree, n) for n in names],
                lambda ls: dataclasses.replace(tree, **dict(zip(names, ls))))
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda ls: dict(zip(keys, ls))
    return list(tree), lambda ls: type(tree)(ls)


def reshard(tree, mesh: Mesh, out_dims, axis: str = "data"):
    """Reshard so that leaf ``i`` is split along dimension ``out_dims[i]``
    (None: replicated) over the mesh's shards.

    ``tree`` is a tensor, a :class:`Sharded`, or a dataclass, dict or
    sequence of them; ``out_dims`` one int or None for every leaf, or a
    flat list with one entry per leaf."""
    leaves, rebuild = _leaves(tree)
    if isinstance(out_dims, (int, type(None))):
        dims = [out_dims] * len(leaves)
    else:
        dims = list(out_dims)
        if len(dims) != len(leaves):
            raise ValueError(f"out_dims has {len(dims)} entries for {len(leaves)} leaves")
    return rebuild([_reshard_leaf(leaf, mesh, d) for leaf, d in zip(leaves, dims)])


def redistribute_visibility(vis, mesh: Mesh, to: str = "time", axis: str = "data"):
    """Reshard a Visibility between the two row decompositions:
    ``to="time"`` splits the time axis (solution intervals local),
    ``to="baseline"`` the baseline axis (uv footprints local). Data fields
    ``[ntime, nbaseline, ...]`` are split, per-axis metadata replicated."""
    if to not in ("time", "baseline"):
        raise ValueError(f"unknown target decomposition {to!r}")
    dim = 0 if to == "time" else 1
    leaves, _ = _leaves(vis)

    def ndim(leaf):
        return len(leaf.pieces[0].shape) if isinstance(leaf, Sharded) else leaf.ndim

    return reshard(vis, mesh, [dim if ndim(leaf) >= 2 else None for leaf in leaves], axis=axis)
