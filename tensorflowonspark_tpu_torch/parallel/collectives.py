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

:class:`CollectiveRecorder` measures: the calls and payload bytes of each
collective family issued in its scope (DTensor's and these functions'),
for ``tp_scaling_model`` and the smoke's TP decode phase.
"""

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode


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


#: collective family of each c10d / functional-collective op (by its
#: op name, the namespace dropped): what :class:`CollectiveRecorder` counts
_FAMILIES = {
    "all_reduce": "all_reduce", "all_reduce_": "all_reduce",
    "all_reduce_coalesced": "all_reduce",
    "all_reduce_coalesced_": "all_reduce",
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "all_gather_into_tensor": "all_gather",
    "all_gather_into_tensor_coalesced": "all_gather",
    "all_gather_into_tensor_out": "all_gather",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_coalesced_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "reduce_scatter_tensor": "reduce_scatter",
    "reduce_scatter_tensor_coalesced": "reduce_scatter",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "all_to_all_single": "all_to_all", "alltoall_": "all_to_all",
    "alltoall_base_": "all_to_all",
    "send": "send_recv", "recv_": "send_recv",
    "recv_any_source_": "send_recv",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "scatter_": "scatter", "gather_": "gather", "reduce_": "reduce",
}


def _nbytes(x):
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(e) for e in x)
    return 0


class CollectiveRecorder(TorchDispatchMode):
    """``with CollectiveRecorder() as rec: ...`` counts, per collective
    family (``all_reduce``, ``all_gather``, ``reduce_scatter``,
    ``all_to_all``, ``send_recv``, ``broadcast``, ...), the calls
    (``ops``) and payload bytes (``bytes``) of every collective issued
    in its scope on this thread and its autograd backward: DTensor's
    redistributions (functional collectives) and ``torch.distributed``'s
    own calls (the c10d ops this module's functions make). ``bytes`` is
    the collective's OUTPUT as the reference's HLO count reads it: the
    reduced tensor of an all-reduce, the gathered tensor of an
    all-gather, the tensors sent or received point to point. A ring's
    own traffic (``2 (n - 1) / n`` of an all-reduce's payload on the
    wire) is not modelled.

    A measurement tool: it is a ``TorchDispatchMode``, active only
    inside its ``with``, and nothing on the main path enters one.
    DTensor operations are let through first (``NotImplemented``), so
    the recorder sees the collectives they turn into."""

    def __init__(self):
        super(CollectiveRecorder, self).__init__()
        self.families = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        ns = getattr(func, "namespace", "")
        family = _FAMILIES.get(getattr(packet, "__name__", "")) \
            if ns in ("c10d", "_c10d_functional") else None
        if family is not None:
            # the functional ops return their output; c10d's in-place
            # ops take it as their first argument
            n = _nbytes(out) if ns == "_c10d_functional" \
                else _nbytes(args[0] if args else ())
            rec = self.families.setdefault(family, {"ops": 0, "bytes": 0})
            rec["ops"] += 1
            rec["bytes"] += n
        return out

    @property
    def total_bytes(self):
        return sum(f["bytes"] for f in self.families.values())
