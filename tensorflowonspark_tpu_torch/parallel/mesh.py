"""Mesh construction over the process group — the port of
``tensorflowonspark_tpu/parallel/mesh.py``.

The reference builds a ``jax.sharding.Mesh`` over devices and lets XLA
emit the collectives from sharding annotations. The port runs one
process per card (``NodeContext.initialize_torch`` pins each rank to its
own), so a mesh axis spans *ranks*: :func:`build_mesh` returns a
``torch.distributed.device_mesh.DeviceMesh`` over the group's ranks with
``mesh_dim_names`` = the axis names, whose per-axis sub-groups carry the
collectives the ``parallel`` modules issue by hand. ``devices=`` is a
list of ranks.

Axis conventions used across the port (models/ and examples/ follow
these names):

- ``data``  — batch (pure DP; the reference's only strategy family)
- ``model`` — tensor parallelism (weights sharded)
- ``stage`` — pipeline parallelism
- ``seq``   — sequence/context parallelism (ring attention)
- ``expert``— MoE expert parallelism

The shape arithmetic (:func:`respec_for_width`, :func:`mesh_shape`,
:func:`hybrid_mesh_shape`) is pure Python and needs no process group;
torch is imported only by the functions that build a mesh, so importing
this module starts no process group and touches no card.
"""

import math

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"

#: seconds the one-rank group :func:`build_mesh` starts waits at its
#: rendezvous (the bound ``NodeContext.initialize_torch`` uses)
RENDEZVOUS_TIMEOUT = 300.0


def respec_for_width(axis_shapes, n_devices, resize_axis=DATA_AXIS):
    """Re-derive ``axis_shapes`` for a different device count.

    The elastic-resize enabler (the parallel modules' placements name
    mesh axes, not ranks, so the same application state lays out on any
    rank count that factors): shrink or grow the ``resize_axis``
    (default ``data``) so the product matches ``n_devices``, while the
    model/stage/seq/expert axes keep their sizes — their collectives
    and weight shards are what the program's placements were written
    against, so they must not silently change shape.

    Raises ``ValueError`` (loudly, naming the failing axes) when the
    fixed axes cannot factor into ``n_devices`` — the caller (the
    supervisor's ElasticResize policy) must treat that as "this width
    is not reachable", not retry.

    Returns a new ordered ``{axis: size}`` dict; the resize axis is
    inserted outermost when it was absent (DP outermost is the hybrid
    DCN/ICI convention).
    """
    n = int(n_devices)
    if n < 1:
        raise ValueError(
            "cannot respec a mesh for {} devices".format(n))
    shapes = dict(axis_shapes or {resize_axis: n})
    fixed = {a: int(s) for a, s in shapes.items() if a != resize_axis}
    for axis, size in fixed.items():
        if size == -1:
            raise ValueError(
                "cannot respec for width: axis {!r} is -1 (inferred); "
                "only the {!r} axis may change size across a resize — "
                "resolve the shape with build_mesh first".format(
                    axis, resize_axis))
        if size < 1:
            raise ValueError(
                "cannot respec for width: axis {!r} has invalid size "
                "{}".format(axis, size))
    known = math.prod(fixed.values()) if fixed else 1
    if n % known:
        raise ValueError(
            "cannot lay out {} devices: the fixed axes {} occupy {} "
            "devices per {!r}-slice and {} % {} != 0 — the {!r} axis "
            "cannot absorb the remainder. Reachable widths are "
            "multiples of {}.".format(
                n, fixed, known, resize_axis, n, known, resize_axis,
                known))
    width = n // known
    out = {}
    if resize_axis not in shapes:
        out[resize_axis] = width
    for axis in shapes:
        out[axis] = width if axis == resize_axis else shapes[axis]
    return out


def mesh_shape(axis_shapes, n):
    """``(names, sizes)`` of a mesh of ``n`` ranks: :func:`build_mesh`'s
    arithmetic without a process group. One axis may be ``-1`` (inferred
    so the product equals ``n``); default ``{'data': n}``."""
    if not axis_shapes:
        axis_shapes = {DATA_AXIS: n}
    names = list(axis_shapes.keys())
    sizes = [int(s) for s in axis_shapes.values()]
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        inferred = names[sizes.index(-1)]
        known = math.prod(s for s in sizes if s != -1)
        if known == 0:
            # distinct from the non-divisible case below: n % 0 is a
            # crash and known == 0 means ANOTHER axis was given size 0,
            # which no device count can satisfy
            zeros = [a for a, s in zip(names, sizes) if s == 0]
            raise ValueError(
                "cannot infer axis {!r}: axis(es) {} have size 0 in "
                "{}".format(inferred, zeros,
                            dict(zip(names, sizes))))
        if n % known:
            raise ValueError(
                "cannot infer axis {!r}: {} devices do not divide by "
                "the known axes' product {} ({})".format(
                    inferred, n, known, dict(zip(names, sizes))))
        sizes[sizes.index(-1)] = n // known
    total = math.prod(sizes)
    if total != n:
        raise ValueError(
            "mesh {} needs {} devices but {} are available".format(
                dict(zip(names, sizes)), total, n))
    return names, sizes


def hybrid_mesh_shape(dcn_axis_shapes, ici_axis_shapes, n, n_hosts=1):
    """``(names, sizes)`` of a hybrid mesh of ``n`` ranks on ``n_hosts``
    hosts (equal ranks a host): :func:`build_hybrid_mesh`'s arithmetic
    without a process group. The DCN axes come first."""
    overlap = set(dcn_axis_shapes) & set(ici_axis_shapes)
    if overlap:
        raise ValueError(
            "axes {} appear in both dcn and ici shapes; an axis lives on "
            "exactly one of the two networks".format(sorted(overlap)))
    dcn_names = list(dcn_axis_shapes)
    ici_names = list(ici_axis_shapes)
    dcn_sizes = [int(s) for s in dcn_axis_shapes.values()]
    ici_sizes = [int(s) for s in ici_axis_shapes.values()]
    all_names = dcn_names + ici_names
    all_sizes = dcn_sizes + ici_sizes
    if all_sizes.count(-1) > 1:
        raise ValueError(
            "at most one hybrid mesh axis (across dcn and ici shapes) "
            "may be -1; got {} and {}".format(dict(dcn_axis_shapes),
                                              dict(ici_axis_shapes)))
    if -1 in all_sizes:
        # same two-case split as mesh_shape: a 0-sized sibling axis vs
        # a device count the known axes' product does not divide
        inferred = all_names[all_sizes.index(-1)]
        known = math.prod(s for s in all_sizes if s != -1)
        if known == 0:
            zeros = [a for a, s in zip(all_names, all_sizes) if s == 0]
            raise ValueError(
                "cannot infer hybrid axis {!r}: axis(es) {} have size "
                "0 in dcn={} ici={}".format(
                    inferred, zeros, dict(dcn_axis_shapes),
                    dict(ici_axis_shapes)))
        if n % known:
            raise ValueError(
                "cannot infer hybrid axis {!r}: {} devices do not "
                "divide by the known axes' product {} (dcn={} "
                "ici={})".format(inferred, n, known,
                                 dict(dcn_axis_shapes),
                                 dict(ici_axis_shapes)))
        idx = all_sizes.index(-1)
        if idx < len(dcn_sizes):
            dcn_sizes[idx] = n // known
        else:
            ici_sizes[idx - len(dcn_sizes)] = n // known
    total = math.prod(dcn_sizes) * math.prod(ici_sizes)
    if total != n:
        raise ValueError(
            "hybrid mesh dcn={} x ici={} needs {} devices but {} are "
            "available".format(dict(zip(dcn_names, dcn_sizes)),
                               dict(zip(ici_names, ici_sizes)), total, n))
    if n_hosts > 1 and math.prod(dcn_sizes) != n_hosts:
        # a layout-specific message: DCN axes must jointly equal the
        # host count (then the ICI axes, the rest of the product, are a
        # host's rank count) — anything else would put an "ICI" axis
        # across a host boundary and quietly ride the slow network
        raise ValueError(
            "hybrid mesh cannot factor onto this topology: dcn "
            "axes {} multiply to {} but the hardware has {} "
            "slices — dcn axes must exactly cover the slice "
            "count".format(dict(zip(dcn_names, dcn_sizes)),
                           math.prod(dcn_sizes), n_hosts))
    return dcn_names + ici_names, dcn_sizes + ici_sizes


def host_major(ranks, hosts):
    """``ranks`` reordered host by host (hosts in order of first
    appearance, a host's ranks in their order) and the host count —
    the grouping :func:`node.local_device_index` makes for cards.
    ``hosts[i]`` is the host of ``ranks[i]``. Raises ``ValueError``
    when hosts hold different rank counts (no ICI axis fits them)."""
    if len(hosts) != len(ranks):
        raise ValueError("{} hosts for {} ranks".format(len(hosts),
                                                        len(ranks)))
    groups = {}
    for r, h in zip(ranks, hosts):
        groups.setdefault(h, []).append(r)
    counts = {h: len(g) for h, g in groups.items()}
    if len(set(counts.values())) > 1:
        raise ValueError(
            "hosts hold different rank counts {}: a hybrid mesh needs "
            "the same ranks on every host".format(counts))
    return [r for g in groups.values() for r in g], len(groups)


def _ensure_group(device=None):
    """The default process group, started as a one-rank group when none
    is initialized (NCCL on the card, gloo on the CPU; ``device`` as
    :func:`device_info.default_device` takes it). Returns the mesh's
    device type: the group's backend's (NCCL's card, gloo's CPU), but
    ``"cuda"`` for a gloo group asked for a CUDA ``device`` — ranks
    sharing one card, as ``chip_smoke.py``'s TP decode phase runs them
    until a 4-card NCCL cell replaces that setup (then this goes)."""
    import datetime

    import torch.distributed as dist

    if not dist.is_initialized():
        from tensorflowonspark_tpu_torch import device_info, util

        dev = device_info.default_device(device)
        if dev.type == "cuda":
            import torch

            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method="tcp://127.0.0.1:{}".format(util.find_free_port()),
            world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT))
    backend = str(dist.get_backend())
    if "nccl" in backend:
        return "cuda"
    if backend == "gloo" and device is not None:
        import torch

        # ranks sharing one card: gloo over CUDA tensors
        return torch.device(device).type
    return "cpu"


def _device_mesh(device_type, ranks, names, sizes):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    grid = torch.tensor(list(ranks), dtype=torch.int64).reshape(sizes)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(names))


def build_mesh(axis_shapes=None, devices=None, device=None):
    """Build a ``DeviceMesh`` over the process group's ranks.

    Args:
      axis_shapes: ordered ``{axis_name: size}``; one axis may be ``-1``
        (inferred so the product equals the rank count). Default:
        ``{'data': <n_ranks>}``.
      devices: the ranks to lay out, in order (default every rank of
        the default group).
      device: with no process group initialized, the device of the
        one-rank group this call starts (the card unless ``"cpu"``).
        Over an existing group the mesh takes the backend's device
        (NCCL's card, gloo's CPU), except that a gloo group asked for
        ``"cuda"`` lays its mesh on the card: ranks that share one card,
        which NCCL refuses (only for that, until a 4-card NCCL cell
        replaces it).

    Every rank of the group must call it with the same arguments: the
    mesh's per-axis sub-groups are formed collectively. With no group
    initialized it starts a one-rank group, so a program runs alone as
    the reference's does on one chip.
    """
    import torch.distributed as dist

    device_type = _ensure_group(device)
    ranks = list(devices) if devices is not None \
        else list(range(dist.get_world_size()))
    names, sizes = mesh_shape(axis_shapes, len(ranks))
    return _device_mesh(device_type, ranks, names, sizes)


def build_hybrid_mesh(dcn_axis_shapes, ici_axis_shapes, devices=None,
                      device=None):
    """Mesh spanning several hosts: DCN axes outer, ICI inner.

    The multi-host layout recipe (the public scaling playbook): axes
    whose collectives must ride the slow inter-host network (usually
    just ``data``) go OUTERMOST, while model/seq/stage axes stay inside
    a host so their collectives ride NVLink. Every rank's hostname is
    gathered and the ranks are laid out host-major (:func:`host_major`):
    every inner block is one host's ranks. On one host the layout is the
    contiguous reshape, and only the shape errors apply.

    Args:
      dcn_axis_shapes: ordered ``{axis: size}`` across hosts
        (e.g. ``{"data": n_hosts}``).
      ici_axis_shapes: ordered ``{axis: size}`` within a host
        (e.g. ``{"model": 8}``). Axis names must not overlap. One axis
        across BOTH dicts may be ``-1`` (inferred so the product equals
        the rank count, same contract as :func:`build_mesh`).
      devices: the ranks to lay out (default every rank).
      device: as :func:`build_mesh`'s.

    Returns a ``DeviceMesh`` with the DCN axes first.
    """
    import socket

    import torch.distributed as dist

    device_type = _ensure_group(device)
    ranks = list(devices) if devices is not None \
        else list(range(dist.get_world_size()))
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, socket.gethostname())
    ordered, n_hosts = host_major(ranks, [gathered[r] for r in ranks])
    names, sizes = hybrid_mesh_shape(dcn_axis_shapes, ici_axis_shapes,
                                     len(ranks), n_hosts)
    return _device_mesh(device_type, ordered, names, sizes)


def data_parallel_sharding(mesh, axis=DATA_AXIS):
    """DTensor placements that split the leading (batch) dim over
    ``axis`` and replicate over every other axis of ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def replicated_sharding(mesh):
    """DTensor placements that replicate over every axis (params under
    pure DP)."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]
