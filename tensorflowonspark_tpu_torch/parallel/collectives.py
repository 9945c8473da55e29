"""Differentiable collectives over a mesh axis's group: what ``shard_map``
gives the JAX package's ``parallel`` modules implicitly (``ppermute``,
``psum`` and their transposes), written out as ``torch.autograd
.Function``s.

Semantics: a value is either *replicated* (the same on every rank of
the group, as the caller's loss is) or *partial* (each rank holds a
term of a sum). :class:`ReduceFromGroup` turns partials into their
replicated sum; its backward passes the replicated gradient through
unchanged, since each term's gradient is the sum's. :class:`CopyToGroup`
marks a replicated value entering rank-local work (each rank's gradient
is then a partial); its backward sums the partial gradients. The pair is
Megatron's ``g`` / ``f``, and with it every gradient comes back exact and
replicated. :class:`Shift` is ``ppermute`` by a fixed step around the
ring, its backward the inverse shift. :class:`KeepAlive` keeps received
blocks in a rank's graph, so every rank runs every shift's backward (a
P2P backward that one rank skips would leave its neighbours waiting).

On a one-rank group each of them is the identity, with no communication.
"""

import torch
import torch.distributed as dist


def _size(group):
    return dist.get_world_size(group)


def shift(group, tensors, step):
    """Send each tensor to rank ``i + step`` of ``group`` and receive its
    replacement from rank ``i - step``, all in one ``batch_isend_irecv``
    (every rank posts its sends and receives together, so no ordering of
    the ranks deadlocks, a ring of two included). Returns the received
    tensors. Gloo sends CPU tensors only; NCCL takes one card a rank."""
    size = _size(group)
    if size == 1:
        return list(tensors)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + step) % size)
    src = dist.get_global_rank(group, (me - step) % size)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = []
    for t, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, t, dst, group))
        ops.append(dist.P2POp(dist.irecv, r, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs


class Shift(torch.autograd.Function):
    """``Shift.apply(group, step, *tensors)``: each tensor from rank
    ``i - step`` (what ``ppermute`` with ``perm = [(i, i + step)]`` gives
    rank ``i``); the backward sends each gradient back to the rank its
    tensor came from."""

    @staticmethod
    def forward(ctx, group, step, *tensors):
        ctx.group, ctx.step = group, step
        return tuple(shift(group, tensors, step))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(shift(ctx.group, grads, -ctx.step))


class KeepAlive(torch.autograd.Function):
    """``KeepAlive.apply(out, *blocks)``: ``out`` unchanged, with
    ``blocks`` in its graph (their gradient zero), so the shifts that
    brought them run their backward on this rank too."""

    @staticmethod
    def forward(ctx, out, *blocks):
        ctx.shapes = [(b.shape, b.dtype, b.device) for b in blocks]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g, *_):
        return (g,) + tuple(torch.zeros(s, dtype=dt, device=dev)
                            for s, dt, dev in ctx.shapes)


def _all_reduce(t, group):
    if _size(group) == 1:
        return t
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


class ReduceFromGroup(torch.autograd.Function):
    """``ReduceFromGroup.apply(partial, group)``: the replicated sum of
    the ranks' partials (``psum``); backward: the identity."""

    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class CopyToGroup(torch.autograd.Function):
    """``CopyToGroup.apply(replicated, group)``: the identity; backward:
    the sum of the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def axis_of(mesh, axis):
    """``(size, this rank's index, group)`` of ``mesh``'s axis ``axis``."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError("mesh axes {} have no {!r} axis".format(names, axis))
    return (mesh.shape[names.index(axis)], mesh.get_local_rank(axis),
            mesh.get_group(axis))
