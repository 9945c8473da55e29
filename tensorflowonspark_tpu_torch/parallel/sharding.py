"""Tensor-parallel sharding rules: name-pattern -> spec -> DTensor
placements — the port of ``tensorflowonspark_tpu/parallel/sharding.py``.

The JAX package annotates weight matrices with a ``model`` mesh axis and
lets XLA emit the all-gather/reduce-scatter pattern. The port does the
same through DTensor: :func:`distribute_params` swaps each parameter of
a module for a ``distribute_tensor`` DTensor laid out by the rules (the
port's ``jax.device_put(params, shardings)``), and DTensor's sharding
propagation issues the collectives over the mesh's ``model`` sub-group
when the module runs. Plain tensors a forward makes (masks, ids) must
meet the DTensors inside ``torch.distributed.tensor.experimental
.implicit_replication()``, which the Trainer's mesh step provides.

A rule is ``(regex, template)``: the regex searches the parameter's
dotted name (``named_parameters()``), the template is a tuple of axis
names / None with length <= the parameter's ndim, padded with None on
the left (the reference's convention of sharding the trailing dims). A
spec is that padded tuple; :func:`placements_of` turns a spec into one
placement per mesh axis (``Shard(dim)`` where an axis names a dim,
``Replicate()`` elsewhere).

The megatron-style pairing to follow in rules: shard the UP projection's
output dim and the DOWN projection's input dim, so the intervening
activation stays sharded and only one collective pair per block is
needed. The port's ``Dense`` is ``nn.Linear`` with weight ``[out, in]``
(``models/_layers.py``), so the reference's ``ffn_in/kernel (None,
"model")`` is ``ffn_in.weight ("model", None)`` here, and the attention
``DenseGeneral`` kernels ``[H, N, D]`` / ``[N, D, H]`` are ``Linear``
weights over the fused ``N * D`` head rows / columns. The catalogs below
are rewritten for those names and layouts; the tests hold each entry
against the reference's spec through ``convert``'s name map.

A fused head dim is named by a :class:`HeadAxis` in the template: it
shards by WHOLE heads, as the reference's ``N`` axis does, so its
divisibility check reads the head count ``N``, not ``N * D`` (the head
size comes from the attention module the parameter belongs to, its
``head_dim``). Without it a 2-head layer at ``tp = 4`` would put half a
head on each rank where the reference replicates the heads.

Decode under ``DECODER_TP_RULES`` (``generation.generate`` of a model
laid out by :func:`distribute_params`): :func:`head_shards` tells an
attention module how its heads are split — the megatron decode keeps
``N / tp`` heads and their KV cache on each rank, and one all-reduce
after ``attn.out`` and one after ``mlp_out`` per block bring the
partial sums back to replicated.
"""

import collections
import functools
import logging
import re

logger = logging.getLogger(__name__)


class HeadAxis(str):
    """A mesh axis name in a rule template whose tensor dim is fused
    attention heads (``N * D`` rows or columns): the dim shards only by
    whole heads. It IS the axis name everywhere else (``placements_of``,
    ``param_path_specs``); :func:`constrain_spec` reads the head size."""


def _named(params):
    """``[(dotted name, tensor)]`` of a module or a name -> tensor dict."""
    if hasattr(params, "named_parameters"):
        return list(params.named_parameters())
    return list(params.items())


def param_path_specs(params, rules, default=None):
    """{name: spec} for every parameter; first matching rule wins.

    Args:
      params: an ``nn.Module`` (its ``named_parameters()``) or a
        ``{dotted name: tensor}`` dict.
      rules: ordered ``[(regex, template)]``, where template is a tuple
        of axis names / None with length <= the parameter's ndim (padded
        with None on the left to match).
      default: spec for unmatched parameters (None = replicate).

    Raw specs are NOT divisibility-guarded — pass each through
    :func:`constrain_spec` (what :func:`tree_shardings` does) before
    laying a parameter out on a concrete mesh.
    """
    out = {}
    for name, leaf in _named(params):
        spec = None
        for pattern, template in rules:
            if re.search(pattern, name):
                pad = leaf.dim() - len(template)
                if pad < 0:
                    raise ValueError(
                        "rule {} template {} longer than param {} ndim {}"
                        .format(pattern, template, name, leaf.dim()))
                spec = (None,) * pad + tuple(template)
                break
        if spec is None:
            spec = tuple(default) if default else ()
        out[name] = spec
    return out


def _axis_size(mesh, axis):
    return mesh.shape[tuple(mesh.mesh_dim_names).index(axis)]


def constrain_spec(spec, shape, mesh, name="<param>", head_dim=None):
    """Drop spec dims that don't divide their mesh axes (replicate them).

    Public so callers building placements straight from
    ``param_path_specs`` specs get the same degrade-to-replicate
    behavior as :func:`tree_shardings`. The fallback WARNS: for a tiny
    dim (2-head bias) it is the intended degrade, but on a flagship
    config it usually means a misconfigured mesh width about to
    replicate a large matrix — memory blowup, not a crash, so it must
    be visible in default logging.

    A :class:`HeadAxis` dim is checked in units of ``head_dim`` (the
    attention module's head size): it keeps its axis only when the
    HEAD count divides the axis. ``head_dim`` is required for one."""
    fixed = []
    for i, axis in enumerate(spec):
        if axis is None or i >= len(shape):
            fixed.append(axis)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        n = 1
        for a in axes:
            n *= _axis_size(mesh, a)
        size, unit = shape[i], "size"
        if any(isinstance(a, HeadAxis) for a in axes):
            if not head_dim or shape[i] % head_dim:
                raise ValueError(
                    "{} dim {} is fused heads: its head size is needed "
                    "(got {!r} for size {})".format(name, i, head_dim,
                                                     shape[i]))
            size, unit = shape[i] // head_dim, "heads"
        if size % n:
            logger.warning(
                "replicating %s dim %d: %s %d does not divide mesh "
                "axes %r (=%d)", name, i, unit, size, axes, n)
            fixed.append(None)
        else:
            fixed.append(axis)
    return tuple(fixed)


def placements_of(spec, mesh):
    """One DTensor placement per mesh axis for ``spec``: ``Shard(i)``
    on each axis that names tensor dim ``i``, ``Replicate()`` on every
    other axis. Raises ``ValueError`` for an axis ``mesh`` lacks."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, axis in enumerate(spec):
        if axis is None:
            continue
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a not in names:
                raise ValueError("spec {} names axis {!r}; the mesh has "
                                 "{}".format(spec, a, names))
            out[names.index(a)] = Shard(i)
    return out


def _head_dim(module, name):
    """``head_dim`` of the nearest module above parameter ``name`` that
    has one (the attention module a q/k/v/out weight belongs to), or
    None (``module`` a name -> tensor dict, or no such module)."""
    if not hasattr(module, "get_submodule"):
        return None
    parts = name.split(".")[:-1]
    while parts:
        hd = getattr(module.get_submodule(".".join(parts)), "head_dim",
                     None)
        if isinstance(hd, int):
            return hd
        parts.pop()
    return None


def tree_shardings(params, mesh, rules, default=None):
    """``{name: placements}`` for every parameter of ``params`` (a module
    or a name -> tensor dict), for ``distribute_tensor``.

    A rule dim whose size does not divide its mesh axis falls back to
    replication for that dim (t5x-style): rule catalogs are written for
    the flagship configs, and a tiny head count or a 2-row type-vocab
    table must degrade to a replicated dim, not a hard error at wider
    TP (BERT's 2 heads at tp=4). Fused head dims (:class:`HeadAxis`)
    count whole heads, so ``params`` must then be the module."""
    shapes = dict(_named(params))
    return {name: placements_of(
        constrain_spec(spec, tuple(shapes[name].shape), mesh, name=name,
                       head_dim=_head_dim(params, name)),
        mesh)
        for name, spec in param_path_specs(params, rules, default).items()}


def _row_sharded_lookup(weight, ids):
    """``F.embedding(ids, weight)`` for a ``weight`` DTensor sharded by
    rows over one mesh axis, replicated over the others: each rank looks
    up the ids that fall in its rows (zeros elsewhere) and one all-reduce
    over that axis's group sums the ranks' rows (Megatron's
    vocab-parallel embedding). Returns a replicated DTensor; the table's
    gradient comes back on its own rows (``Shard(0)``).

    DTensor's own lookup on a row-sharded table (its masked partial)
    fails in the backward in this torch ("Redistribution from one partial
    type (P(sum)) to another (MaskP...) is unsupported") and when a
    reduction meets it first (Wide & Deep's wide sum), hence this one."""
    import torch
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Replicate

    from tensorflowonspark_tpu_torch.parallel.collectives import (
        ReduceFromGroup)

    mesh = weight.device_mesh
    dim = [i for i, p in enumerate(weight.placements) if p.is_shard(0)][0]
    local = weight.to_local()
    rows = local.shape[0]
    if isinstance(ids, DTensor):
        ids = ids.to_local()
    shifted = ids.long() - mesh.get_local_rank(dim) * rows
    hit = (shifted >= 0) & (shifted < rows)
    out = F.embedding(torch.where(hit, shifted, torch.zeros_like(shifted)),
                      local) * hit[..., None].to(local.dtype)
    out = ReduceFromGroup.apply(out, mesh.get_group(dim))
    return DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _sharded_embedding_forward(module, ids):
    """``module.forward`` of an embedding whose table is row-sharded
    (:func:`_row_sharded_lookup`), cast to the module's ``dtype`` where
    it has one (``models._layers.Embed``)."""
    out = _row_sharded_lookup(module.weight, ids)
    dtype = getattr(module, "dtype", None)
    return out if dtype is None else out.to(dtype)


def distribute_params(module, mesh, rules, default=None, src_data_rank=0):
    """Lay ``module``'s parameters out on ``mesh`` by ``rules``: each
    becomes an ``nn.Parameter`` over a ``distribute_tensor`` DTensor
    (the port's ``jax.device_put(params, tree_shardings(...))``), in
    place. ``distribute_tensor`` scatters from the mesh's first rank, so
    every rank starts from rank 0's values (the replicated init);
    ``src_data_rank=None`` sends nothing — each rank keeps its own
    slice of its own values, which every rank must then hold alike. That
    is only for ranks sharing one card over a gloo group, which has no
    scatter of CUDA tensors (``chip_smoke.py``'s TP decode phase), and
    goes when a 4-card NCCL cell replaces that setup. An ``nn.Embedding``
    whose table is sharded by rows over one axis looks up through
    :func:`_row_sharded_lookup`. Call it before building the optimizer,
    whose moments then take each parameter's placements. Returns
    ``module``."""
    import torch.nn as nn
    from torch.distributed.tensor import Shard, distribute_tensor

    placements = tree_shardings(module, mesh, rules, default)
    for mod_name, mod in module.named_modules():
        for p_name, p in list(mod.named_parameters(recurse=False)):
            name = mod_name + "." + p_name if mod_name else p_name
            dt = distribute_tensor(p.detach(), mesh, placements[name],
                                   src_data_rank=src_data_rank)
            mod.register_parameter(
                p_name, nn.Parameter(dt, requires_grad=p.requires_grad))
        if isinstance(mod, nn.Embedding) and [
                pl for pl in mod.weight.placements
                if not pl.is_replicate()] == [Shard(0)]:
            mod.forward = functools.partial(_sharded_embedding_forward, mod)
    return module


#: how an attention module's heads lie over a mesh: ``tp`` ranks each
#: hold ``N / tp`` heads, this rank the ``index``-th slice; ``mesh`` and
#: ``dim`` (the mesh dim the heads are split over) are None when tp is 1
HeadShards = collections.namedtuple("HeadShards",
                                    ("tp", "index", "mesh", "dim"))


def head_shards(attn):
    """The TP layout of attention module ``attn``'s heads, read off its
    ``query`` weight: a DTensor sharded on its rows (``Shard(0)``, the
    fused ``N * D`` head rows) over mesh dim ``dim`` splits the heads
    ``mesh.size(dim)`` ways; a plain or replicated weight is ``tp = 1``
    (the whole-head fallback of :func:`constrain_spec` leaves q/k/v
    replicated when ``tp`` does not divide ``N``). ``key`` and
    ``value`` must lie as ``query`` does."""
    w = attn.query.weight
    placements = tuple(getattr(w, "placements", ()))
    for other in (attn.key.weight, attn.value.weight):
        if tuple(getattr(other, "placements", ())) != placements:
            raise ValueError(
                "attention key/value weights lie as {} where the query "
                "weight lies as {}".format(
                    getattr(other, "placements", None), placements))
    split = [i for i, p in enumerate(placements) if not p.is_replicate()]
    if not split:
        return HeadShards(1, 0, None, None)
    if len(split) != 1 or not placements[split[0]].is_shard(0):
        raise ValueError("attention query weight placements {} are not "
                         "a head split (Shard(0) on one mesh dim, "
                         "replicated on the others)".format(placements))
    mesh, dim = w.device_mesh, split[0]
    tp = mesh.size(dim)
    if attn.num_heads % tp:
        raise ValueError("{} heads do not split {} ways".format(
            attn.num_heads, tp))
    return HeadShards(tp, mesh.get_local_rank(dim), mesh, dim)


#: the model axis over fused attention heads
_HEADS = HeadAxis("model")

#: Megatron-style TP rules for the port's models/bert.py (model axis):
#: the reference's [H, N, D] query/key/value kernels sharded on heads
#: are the fused head ROWS of the [N*D, H] weights here, the [N, D, H]
#: out kernel's heads its COLUMNS.
BERT_TP_RULES = (
    (r"attention\.(query|key|value)\.weight", (_HEADS, None)),  # [N*D, H]
    (r"attention\.(query|key|value)\.bias", (_HEADS,)),         # [N*D]
    (r"attention\.out\.weight", (None, _HEADS)),                # [H, N*D]
    (r"ffn_in\.weight", ("model", None)),                        # [I, H]
    (r"ffn_in\.bias", ("model",)),
    (r"ffn_out\.weight", (None, "model")),                       # [H, I]
    (r"word_embeddings\.weight", (None, "model")),               # [V, H]
)

#: TP rules for models/resnet.py (shard the convs' output channels:
#: OIHW weights here, HWIO kernels in the reference).
RESNET_TP_RULES = (
    (r"Conv_\d+\.weight", ("model", None, None, None)),
    (r"Dense_\d+\.weight", ("model", None)),
)

#: TP rules for models/widedeep.py (BASELINE config #4 "ETL -> TPU
#: embedding tables"): the fused categorical tables are the dominant
#: params (hash_buckets x num_cat rows) — row-shard them over ``model``
#: so each rank holds a table shard; the first MLP pair follows the
#: megatron up/down convention.
WIDEDEEP_TP_RULES = (
    (r"(deep|wide)_embeddings\.weight", ("model", None)),
    (r"mlp_0\.weight", ("model", None)),
    (r"mlp_0\.bias", ("model",)),
    (r"mlp_1\.weight", (None, "model")),
)

#: TP rules for models/decoder.py (the generation LM): the megatron
#: split — q/k/v projections shard the heads (the fused rows), the
#: output projection merges over heads (its columns), the MLP follows
#: the up/down convention.
DECODER_TP_RULES = (
    (r"attn\.(query|key|value)\.weight", (_HEADS, None)),        # [N*D, H]
    (r"attn\.(query|key|value)\.bias", (_HEADS,)),               # [N*D]
    (r"attn\.out\.weight", (None, _HEADS)),                      # [H, N*D]
    (r"mlp_in\.weight", ("model", None)),
    (r"mlp_in\.bias", ("model",)),
    (r"mlp_out\.weight", (None, "model")),
)
