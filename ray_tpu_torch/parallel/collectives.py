"""Collectives over mesh axes, differentiable as `jax.vjp` of the same
`shard_map` would differentiate them.

Counterpart: ray_tpu/parallel/collectives.py. The reference writes
`jax.lax` collectives inside `shard_map` and XLA lowers them to ICI
transfers; here each is an explicit call over the mesh axis's process
group, wrapped in a `torch.autograd.Function` whose backward is the
transpose JAX uses under shard_map's replication typing:

    psum          sum of per-rank partials -> a value equal on every rank;
                  backward: identity (the cotangent is equal on every rank)
    pvary         a value equal on every rank used by per-rank computation;
                  forward: identity; backward: psum
    all_gather    backward: psum_scatter        psum_scatter  backward: all_gather
    ppermute      backward: the inverse permutation
    all_to_all    backward: all_to_all with split and concat swapped
    all_gather_invariant   gather to a value equal on every rank;
                  backward: this rank's block of the cotangent

`axis` is a mesh axis name or a tuple of them; an axis of size 1 (or one
the mesh lacks) makes the collective an identity, and `mesh=None` too.

Transport: every call goes through `_run`, which decides how bytes move.
Under the gloo backend a CUDA tensor is staged through pinned host memory
(gloo's CUDA support does not cover every collective used here); under
nccl CUDA tensors go directly. Nothing switches backend: the mesh's
backend is the process group's.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import Mesh

_all_gather_base = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_base = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


# ------------------------------------------------------------- transport
def _run(mesh: Mesh, x: torch.Tensor, op):
    """op(tensor on the backend's side) -> tensor there; the result comes
    back on x's device. Counts the call in mesh.stats."""
    staged = x.is_cuda and mesh.backend == "gloo"
    if staged:
        # the producing kernels' time is not the collective's
        torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    if staged:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        out = op(host).to(x.device)
    else:
        out = op(x.contiguous())
    mesh.stats["calls"] += 1
    mesh.stats["bytes"] += x.numel() * x.element_size()
    mesh.stats["seconds"] += time.perf_counter() - t0
    return out


def _all_reduce(x, axis, mesh, op=dist.ReduceOp.SUM):
    group, _ranks = mesh.group(axis)

    def reduce(t):
        t = t.clone()
        dist.all_reduce(t, op=op, group=group)
        return t

    return _run(mesh, x, reduce)


def _group_order(ranks) -> list[int] | None:
    """For each group rank (ascending global rank), the index of its block
    in `ranks`' order; None when the two orders agree."""
    order = sorted(range(len(ranks)), key=ranks.__getitem__)
    return None if order == list(range(len(ranks))) else order


def _all_gather(x, axis, mesh, dim):
    group, ranks = mesh.group(axis)

    def gather(t):
        out = torch.empty((len(ranks) * t.shape[0], *t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        _all_gather_base(out, t, group=group)
        return out

    out = _run(mesh, x.movedim(dim, 0), gather)
    order = _group_order(ranks)
    if order is not None:  # blocks row-major over `axis` as given
        blocks = out.chunk(len(ranks))
        out = torch.cat([blocks[order.index(i)] for i in range(len(ranks))])
    return out.movedim(0, dim)


def _reduce_scatter(x, axis, mesh, dim):
    group, ranks = mesh.group(axis)
    n = len(ranks)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} ({x.shape[dim]}) does not "
                         f"divide over {axis} ({n})")
    x = x.movedim(dim, 0)
    order = _group_order(ranks)
    if order is not None:  # group rank g keeps block order[g]
        blocks = x.chunk(n)
        x = torch.cat([blocks[i] for i in order])

    def scatter(t):
        out = torch.empty((t.shape[0] // n, *t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        _reduce_scatter_base(out, t, group=group)
        return out

    return _run(mesh, x, scatter).movedim(0, dim)


def _own_block(x, axis, mesh, dim):
    n = mesh.size(mesh.live_axes(axis))
    step = x.shape[dim] // n
    return x.narrow(dim, mesh.index(mesh.live_axes(axis)) * step, step)


def _all_to_all(x, axis, mesh, split, concat):
    (a,) = mesh.live_axes(axis) or (None,)
    if a is None:
        return x
    group, ranks = mesh.group(a)
    n = len(ranks)
    if x.shape[split] % n:
        raise ValueError(f"dimension {split} ({x.shape[split]}) does not "
                         f"divide over {a} ({n})")

    def exchange(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    blocks = _run(mesh, torch.stack(x.chunk(n, dim=split)), exchange)
    return torch.cat(blocks.unbind(0), dim=concat)


def _ppermute(x, axis, mesh, perm):
    group, ranks = mesh.group(axis)
    me = mesh.coords[axis]
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]

    def permute(t):
        out = torch.zeros_like(t)
        ops = [dist.P2POp(dist.isend, t, ranks[d], group=group) for d in dst]
        ops += [dist.P2POp(dist.irecv, out, ranks[s], group=group)
                for s in src]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out

    return _run(mesh, x, permute)


# ------------------------------------------------- differentiable forms
def _live(mesh, axis) -> bool:
    return mesh is not None and bool(mesh.live_axes(axis))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return _all_reduce(x, axis, mesh)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.axis, ctx.mesh), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = (axis, mesh, dim)
        return _all_gather(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, ct):
        return _reduce_scatter(ct, *ctx.args), None, None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = (axis, mesh, dim)
        return _reduce_scatter(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, ct):
        return _all_gather(ct, *ctx.args), None, None, None


class _AllGatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim):
        ctx.args = (axis, mesh, dim)
        return _all_gather(x, axis, mesh, dim)

    @staticmethod
    def backward(ctx, ct):
        return _own_block(ct, *ctx.args).contiguous(), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, perm):
        ctx.args = (axis, mesh, [(d, s) for s, d in perm])
        return _ppermute(x, axis, mesh, perm)

    @staticmethod
    def backward(ctx, ct):
        return _ppermute(ct, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, split, concat):
        ctx.args = (axis, mesh, concat, split)
        return _all_to_all(x, axis, mesh, split, concat)

    @staticmethod
    def backward(ctx, ct):
        return _all_to_all(ct, *ctx.args), None, None, None, None


def psum(x, axis, mesh: Mesh | None):
    """Sum of the per-rank values over `axis`, equal on every rank."""
    return _PSum.apply(x, axis, mesh) if _live(mesh, axis) else x


def pmean(x, axis, mesh: Mesh | None):
    return psum(x, axis, mesh) / (mesh.size(axis) if mesh else 1)


def pvary(x, axis, mesh: Mesh | None):
    """Mark a value equal on every rank of `axis` as used per rank: the
    identity, whose backward sums the per-rank cotangents over `axis`."""
    return _PVary.apply(x, axis, mesh) if _live(mesh, axis) else x


def pmax(x, axis, mesh: Mesh | None):
    """Elementwise max over `axis` (no gradient)."""
    if not _live(mesh, axis):
        return x.detach()
    return _all_reduce(x.detach(), axis, mesh, op=dist.ReduceOp.MAX)


def all_gather(x, axis, mesh: Mesh | None, dim: int = 0, tiled: bool = True):
    """The blocks of every rank along `axis`, concatenated on `dim`
    (tiled) or stacked on a new `dim`."""
    if not tiled:
        return all_gather(x.unsqueeze(dim), axis, mesh, dim, tiled=True)
    if not _live(mesh, axis):
        return x
    return _AllGather.apply(x, axis, mesh, dim % x.dim())


def psum_scatter(x, axis, mesh: Mesh | None, dim: int = 0):
    """Sum over `axis`, of which this rank keeps its block along `dim`."""
    if not _live(mesh, axis):
        return x
    return _PSumScatter.apply(x, axis, mesh, dim % x.dim())


def all_gather_invariant(x, axis, mesh: Mesh | None, dim: int = 0):
    """all_gather whose result is used as a value equal on every rank."""
    if not _live(mesh, axis):
        return x
    return _AllGatherInvariant.apply(x, axis, mesh, dim % x.dim())


def ppermute(x, axis: str, mesh: Mesh | None, perm):
    """Send this rank's value to the rank at `dst` for each (src, dst) of
    `perm` (coordinates along `axis`); a rank that no pair sends to gets
    zeros."""
    if not _live(mesh, axis):
        return x
    return _PPermute.apply(x, axis, mesh, list(perm))


def ppermute_ring(x, axis_name: str, mesh: Mesh | None, shift: int = 1):
    """Rotate shards one step around the axis ring (the primitive under
    ring attention and the pipeline handoff)."""
    n = mesh.size(axis_name) if mesh else 1
    return ppermute(x, axis_name, mesh,
                    [(i, (i + shift) % n) for i in range(n)])


def all_to_all(x, axis_name: str, mesh: Mesh | None, split_axis: int,
               concat_axis: int):
    """Tiled all_to_all: split `split_axis` into one block per rank, send
    block j to rank j, concatenate the received blocks on `concat_axis`."""
    if not _live(mesh, axis_name):
        return x
    return _AllToAll.apply(x, axis_name, mesh, split_axis % x.dim(),
                           concat_axis % x.dim())


def mesh_allreduce(mesh: Mesh, x, axis_name: str = "dp"):
    """Whole-tensor sum of every rank's `x` over one mesh axis, from host
    code (no gradient)."""
    if not _live(mesh, axis_name):
        return x.detach().clone()
    return _all_reduce(x.detach(), axis_name, mesh)


def broadcast_object(obj, mesh: Mesh, src: int = 0):
    """Rank `src`'s picklable `obj` on every rank of the mesh (the default
    process group)."""
    if mesh.backend is None:
        return obj
    box = [obj if mesh.rank == src else None]
    dist.broadcast_object_list(box, src=src)
    return box[0]
