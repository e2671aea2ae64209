"""Collectives over a :class:`~.mesh.Mesh` of process-owned shards.

The port's counterpart of the ``psum``, ``psum_scatter``, ``pmax`` and
all-gather that XLA inserts into the JAX package's ``shard_map``
programs (it has no module of its own there). Each function takes the
list of this process's local-shard tensors, in ``mesh.local`` order, and
returns the global result, the same bits on every process whatever the
layout of shards over processes:

- integer tensors: the local sum, then ``all_reduce(SUM)`` (a
  reduce-scatter for :func:`psum_scatter`), exact in any order;
- floating and complex tensors: the partial of every shard is gathered
  (``all_gather`` across processes; for :func:`psum_scatter` an
  all-to-all of each process's blocks) and added in global shard order
  0 .. n - 1;
- maxima: the local maximum, then ``all_reduce(MAX)``.

Complex tensors travel as ``view_as_real``. NCCL serves CUDA tensors and
gloo CPU tensors; a gloo group (``multihost.initialize(backend="gloo")``)
given CUDA tensors stages them through pinned host buffers (gloo's
reductions and gathers of CUDA tensors do not cover every dtype), which
the counters show as ``staged_bytes``. A CPU tensor in an NCCL group raises:
there is no silent switch of backend. With no group (one process) the
local shards are the whole mesh.

Each op counts its calls and bytes: ``bytes`` those of one shard's
result, as the JAX package's audit reads them from the HLO; ``comm_bytes``
those of the buffers that ``torch.distributed`` fills on this process (0
with no group), which is what the process group moves to it: a psum of
floats gathers every shard's partial, W copies; a psum of integers
all-reduces the whole tensor; :func:`psum_scatter` receives this
process's blocks only. :func:`recording` also lists each call as (op,
dtypes, bytes).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = [
    "psum",
    "psum_scatter",
    "pmax",
    "all_gather",
    "collective_counts",
    "reset_collective_counts",
    "recording",
]

_OPS = ("psum", "psum_scatter", "pmax", "all_gather")
_COUNTS = {op: {"calls": 0, "bytes": 0, "comm_bytes": 0, "staged_bytes": 0} for op in _OPS}
_RECORD: list | None = None


def collective_counts() -> dict:
    """Calls, result bytes, bytes received through ``torch.distributed``
    and host-staged bytes per op since the last reset."""
    return {op: dict(c) for op, c in _COUNTS.items()}


def reset_collective_counts() -> None:
    for c in _COUNTS.values():
        c.update(calls=0, bytes=0, comm_bytes=0, staged_bytes=0)


@contextlib.contextmanager
def recording():
    """Yields a list that receives ``(op, dtypes, bytes)`` for every
    collective call made inside the ``with`` block."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _count(op: str, results) -> None:
    nbytes = sum(t.numel() * t.element_size() for t in results)
    _COUNTS[op]["calls"] += 1
    _COUNTS[op]["bytes"] += nbytes
    if _RECORD is not None:
        _RECORD.append((op, tuple(str(t.dtype).replace("torch.", "") for t in results), nbytes))


def _comm(mesh: Mesh, t: torch.Tensor, op: str, fn, inplace: bool = True) -> torch.Tensor:
    """``fn`` (a collective on a real tensor that returns its result) on
    ``t`` across the mesh's processes; the result on ``t``'s device.
    ``inplace``: ``fn`` writes into its argument, so ``t`` is copied."""
    backend = dist.get_backend(mesh.group)
    real = torch.view_as_real(t) if t.is_complex() else t
    if t.device.type == "cuda" and backend == "gloo":
        host = torch.empty(real.shape, dtype=real.dtype, pin_memory=True)
        host.copy_(real)
        _COUNTS[op]["staged_bytes"] += host.numel() * host.element_size()
        out = fn(host)
        _COUNTS[op]["comm_bytes"] += out.numel() * out.element_size()
        out = out.to(t.device)
    elif t.device.type == "cpu" and backend == "nccl":
        raise RuntimeError(
            f"{op}: a CPU tensor in an NCCL group; initialise the group with "
            "backend='gloo' for CPU shards"
        )
    else:
        out = fn(real.clone() if inplace else real.contiguous())
        _COUNTS[op]["comm_bytes"] += out.numel() * out.element_size()
    return torch.view_as_complex(out) if t.is_complex() else out


def _all_reduce(mesh: Mesh, op=None):
    def fn(b):
        dist.all_reduce(b, op=op or dist.ReduceOp.SUM, group=mesh.group)
        return b

    return fn


def _reduce_scatter(mesh: Mesh):
    """Sum over the processes, each receiving its 1/W of dim 0."""

    def fn(b):
        nproc = dist.get_world_size(mesh.group)
        out = torch.empty((b.shape[0] // nproc, *b.shape[1:]), dtype=b.dtype, device=b.device)
        rs = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        rs(out, b, group=mesh.group)
        return out

    return fn


def _all_to_all(mesh: Mesh):
    """Block q of dim 0 to process q; block r of the result from process r."""

    def fn(b):
        out = torch.empty_like(b)
        dist.all_to_all_single(out, b, group=mesh.group)
        return out

    return fn


def _exact(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex())


def _gather(mesh: Mesh, parts: list, op: str = "all_gather") -> list:
    """Every shard's tensor in global shard order, on ``mesh.devices[0]``."""
    dev = mesh.devices[0]
    parts = [p.to(dev) for p in parts]
    if len(parts) != len(mesh.local):
        raise ValueError(f"{len(parts)} parts for {len(mesh.local)} local shards")
    if mesh.group is None:
        return parts

    def fn(b):
        # process r owns shards [r k, (r + 1) k): rank order is shard order
        out = [torch.empty_like(b) for _ in range(dist.get_world_size(mesh.group))]
        dist.all_gather(out, b, group=mesh.group)
        return torch.cat(out)

    return list(_comm(mesh, torch.stack(parts), op, fn).unbind(0))


def _sum(mesh: Mesh, parts: list, op: str) -> torch.Tensor:
    dev = mesh.devices[0]
    if _exact(parts[0]):
        total = parts[0].to(dev)
        for p in parts[1:]:
            total = total + p.to(dev)
        if mesh.group is not None:
            total = _comm(mesh, total, op, _all_reduce(mesh))
        return total
    allp = _gather(mesh, parts, op)
    total = allp[0]
    for p in allp[1:]:
        total = total + p
    return total


def psum(mesh: Mesh, parts: list):
    """The sum over every shard of the mesh of ``parts`` (one tensor, or one
    tuple of tensors, per local shard: a tuple is one collective, as XLA
    fuses a tuple all-reduce). Returns a tensor or a tuple on
    ``mesh.devices[0]``."""
    if isinstance(parts[0], tuple):
        out = tuple(_sum(mesh, [p[i] for p in parts], "psum") for i in range(len(parts[0])))
        _count("psum", out)
        return out
    out = _sum(mesh, parts, "psum")
    _count("psum", (out,))
    return out


def psum_scatter(mesh: Mesh, parts: list, dim: int = 0) -> list:
    """Reduce-scatter: the global sum of ``parts`` split along ``dim`` into
    ``nshards`` equal blocks; returns this process's blocks, one per local
    shard (``dim`` must divide by ``nshards``). Across processes a process
    receives only its own blocks: integers summed over its shards, then a
    ``torch.distributed`` reduce-scatter (exact in any order); floats
    through an all-to-all that brings it every shard's partial of its
    blocks, added in global shard order (the same bits as one process)."""
    n = parts[0].shape[dim]
    if n % mesh.nshards:
        raise ValueError(f"dimension {dim} of {n} over {mesh.nshards} shards")
    k = n // mesh.nshards
    if mesh.group is None:
        total = _sum(mesh, parts, "psum_scatter")
        blocks = [total.narrow(dim, d * k, k) for d in mesh.local]
    else:
        dev, nloc = mesh.devices[0], len(mesh.local)
        nproc = dist.get_world_size(mesh.group)
        xs = [p.to(dev).movedim(dim, 0) for p in parts]
        if _exact(xs[0]):
            mine = xs[0]
            for x in xs[1:]:
                mine = mine + x
            mine = _comm(mesh, mine.contiguous(), "psum_scatter", _reduce_scatter(mesh), False)
        else:
            # [nloc, W, n / W, ...] -> [W, nloc, n / W, ...]: process q's
            # blocks of every local partial go to q; back come every
            # process's partials of this one's blocks, in rank order, which
            # is global shard order
            rest = xs[0].shape[1:]
            send = torch.stack(xs).reshape(nloc, nproc, n // nproc, *rest).transpose(0, 1)
            got = _comm(mesh, send.contiguous(), "psum_scatter", _all_to_all(mesh), False)
            got = got.reshape(nproc * nloc, n // nproc, *rest)
            mine = got[0]
            for x in got[1:]:
                mine = mine + x
        blocks = [mine.narrow(0, j * k, k).movedim(0, dim) for j in range(nloc)]
    _count("psum_scatter", blocks[:1])
    return blocks


def pmax(mesh: Mesh, parts: list) -> torch.Tensor:
    """The elementwise maximum over every shard of the mesh."""
    dev = mesh.devices[0]
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(dev))
    if mesh.group is not None:
        out = _comm(mesh, out, "pmax", _all_reduce(mesh, dist.ReduceOp.MAX))
    _count("pmax", (out,))
    return out


def all_gather(mesh: Mesh, parts: list) -> list:
    """Every shard's tensor (equal shapes), in global shard order, on
    ``mesh.devices[0]``."""
    out = _gather(mesh, parts)
    _count("all_gather", out)
    return out
