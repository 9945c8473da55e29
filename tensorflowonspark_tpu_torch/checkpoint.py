"""Training checkpoint/resume on ``torch.distributed.checkpoint`` — the
port of ``tensorflowonspark_tpu/checkpoint.py``.

Reference behavior (SURVEY.md §5 "Checkpoint / resume"): the reference
delegates checkpointing to TF (MonitoredTrainingSession / Keras callbacks
writing to shared storage); recovery = resubmit + restore latest. The
framework wires the checkpointer to the node's role, user code decides
when to save. The JAX package saves through orbax; the port saves
through DCP (``torch.distributed.checkpoint``):

- **What is saved.** For a ``training.TrainState`` (which carries its
  module), ``{"model", "optim", "step", "extra"}``: the model's and the
  optimizer's state dicts from
  ``torch.distributed.checkpoint.state_dict.get_state_dict`` (parameter
  names, not positions, key the optimizer's moments), the step, and the
  model's buffers. :meth:`Checkpointer.restore` loads into a fresh
  state of the same shapes and puts it back with ``set_state_dict``.
  Any other state is a tree of arrays, as orbax takes one: nested
  dicts, lists and tuples whose leaves are tensors or numpy arrays.
  Restore then returns a NEW tree shaped like ``state_like`` (numpy
  leaves come back as numpy, at their dtypes) and leaves ``state_like``
  untouched.
- **Layout.** One directory per step under the root, named by the step
  (``<root>/5``), as orbax names them; DCP writes ``.metadata`` and one
  ``__<rank>_0.distcp`` per writing rank in it.
- **Commit.** A local step is written into ``<root>/.tmp-<step>`` and
  renamed into place (``os.replace``) once DCP has finished, so a step
  directory is whole or absent.
- **Who saves.** In one process (no group, or a one-rank group) only
  the chief writes (a replicated state's non-chief ``save()`` is a
  no-op, a sharded one's raises). Under a group of several ranks every
  rank calls ``save()``: DCP's save is a collective (plans gathered, a
  barrier), and its planner writes each replicated tensor once and
  each DTensor shard from the rank that holds it.

Remote roots: a ``scheme://`` root is refused (``fs.require_local``)
unless ``allow_remote=True``, which hands it to DCP's own fsspec storage
layer: no temporary directory there (an object store has no rename), so
a step counts as committed once its ``.metadata``, which DCP writes
last, exists.

Sharded state (the ``parallel`` package's DTensor parameters): see
:func:`is_fully_replicated` and :func:`respec_like`. DCP saves each
DTensor's shards from the ranks that hold them and reshards on load, so
a state saved on one mesh restores on another (the cross-mesh restore).
"""

import logging
import os
import shutil

logger = logging.getLogger(__name__)

_TMP_PREFIX = ".tmp-"
_METADATA = ".metadata"


def _tensors(state):
    """The tensors of a state: a ``TrainState``'s module parameters and
    buffers and its optimizer's tensors, or the tensor leaves of nested
    dicts, lists and tuples."""
    import torch

    def walk(node):
        if torch.is_tensor(node):
            yield node
        elif isinstance(node, dict):
            for v in node.values():
                yield from walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                yield from walk(v)

    model = getattr(state, "model", None)
    if model is None:
        return list(walk(state))
    out = list(model.parameters()) + list(model.buffers())
    return out + list(walk(list(state["opt_state"].state.values())))


def is_fully_replicated(state):
    """True when every tensor of ``state`` is replicated: plain tensors
    count as replicated (every process can reconstruct them); a DTensor
    counts when every placement is ``Replicate()``. One sharded DTensor
    makes the whole state sharded for checkpoint-protocol purposes."""
    from torch.distributed.tensor import DTensor

    return all(p.is_replicate()
               for t in _tensors(state) if isinstance(t, DTensor)
               for p in t.placements)


def _respec(path, t, mesh):
    """An empty DTensor of ``t``'s shape and dtype on ``mesh``, each
    placement moved to the axis of the same name."""
    from torch.distributed.tensor import Replicate, empty

    old = tuple(t.device_mesh.mesh_dim_names or ())
    new = tuple(mesh.mesh_dim_names or ())
    sharded = {old[i]: p for i, p in enumerate(t.placements)
               if not p.is_replicate()}
    missing = sorted(set(sharded) - set(new))
    if missing:
        raise ValueError(
            "cannot respec leaf {} onto mesh axes {}: its placements {} "
            "over axes {} name axis(es) {} the target mesh does not "
            "have".format(path, sorted(new), tuple(t.placements), old,
                          missing))
    return empty(tuple(t.shape), dtype=t.dtype, device_mesh=mesh,
                 placements=[sharded.get(a, Replicate()) for a in new],
                 requires_grad=t.requires_grad)


def respec_like(state, mesh):
    """Cross-mesh restore template: ``state`` with every DTensor re-laid
    (empty, same shape and dtype) onto ``mesh``, each placement moved to
    the mesh axis of the same NAME.

    The elastic-resize enabler: placements here name mesh axes through
    the mesh's ``mesh_dim_names``, so the same state lays out on any
    mesh that still has the axes it is sharded over. DCP reshards a
    checkpoint's DTensors onto the template's layout on load, so a save
    taken at one width restores bitwise at another.

    ``state``: a ``TrainState`` (its module's DTensor parameters and
    buffers are replaced in place and its optimizer takes the new
    parameters in their place, their moments dropped; the state is
    returned) or nested
    dicts, lists and tuples of tensors (a new structure is returned).
    Plain tensors pass through unchanged.

    Raises ``ValueError`` naming the leaf and axis when a DTensor is
    sharded over an axis ``mesh`` does not have (``respec_for_width``
    keeps non-data axes intact precisely so this never fires on a
    data-axis resize).
    """
    import torch
    import torch.nn as nn
    from torch.distributed.tensor import DTensor

    model = getattr(state, "model", None)
    if model is not None:
        moved = {}
        for mod_name, mod in model.named_modules():
            pre = "model." + (mod_name + "." if mod_name else "")
            for name, p in list(mod.named_parameters(recurse=False)):
                if isinstance(p, DTensor):
                    new = nn.Parameter(_respec(pre + name, p.detach(), mesh),
                                       requires_grad=p.requires_grad)
                    mod.register_parameter(name, new)
                    moved[id(p)] = new
            for name, b in list(mod.named_buffers(recurse=False)):
                if isinstance(b, DTensor):
                    setattr(mod, name, _respec(pre + name, b, mesh))
        # the optimizer keeps its hyperparameters and takes the new
        # parameters, their moments dropped (the restore loads them)
        opt = state["opt_state"]
        for group in opt.param_groups:
            for i, p in enumerate(group["params"]):
                if id(p) in moved:
                    opt.state.pop(p, None)
                    group["params"][i] = moved[id(p)]
        state["params"] = dict(model.named_parameters())
        state["extra"] = dict(model.named_buffers())
        return state

    def walk(node, path):
        if isinstance(node, DTensor):
            return _respec(path, node, mesh)
        if torch.is_tensor(node):
            return node
        if isinstance(node, dict):
            return {k: walk(v, path + "[{!r}]".format(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + "[{}]".format(i))
                              for i, v in enumerate(node))
        return node

    return walk(state, "")


def _group():
    """(initialized, rank) of the default process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True, dist.get_rank()
    return False, 0


def _barrier():
    import torch.distributed as dist

    dist.barrier()


def _module_of(state):
    model = getattr(state, "model", None)
    if model is None:
        raise TypeError(
            "checkpoint needs the train state from Trainer.init (a "
            "training.TrainState, which carries its module); got a {}"
            .format(type(state).__name__))
    return model


def _state_dict(state):
    """The dict DCP saves and loads in place: the model's and the
    optimizer's state dicts by parameter name, the step, the buffers."""
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model_sd, optim_sd = get_state_dict(_module_of(state),
                                        state["opt_state"])
    return {"model": model_sd, "optim": optim_sd, "step": int(state["step"]),
            "extra": dict(state["extra"])}


def _is_tree(state):
    """A tree of arrays, not a ``TrainState``."""
    return getattr(state, "model", None) is None


def _tree_leaves(state):
    """``[(path, leaf)]`` of a tree of arrays: dict keys and sequence
    indices joined by ``/``. Raises naming the first leaf that is not a
    tensor or a numpy array."""
    import numpy as np
    import torch

    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node, key=str):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif torch.is_tensor(node) or isinstance(node, (np.ndarray,
                                                        np.generic)):
            out.append(("/".join(path), node))
        else:
            raise TypeError(
                "checkpoint needs the train state from Trainer.init (a "
                "training.TrainState) or a tree of arrays; got a {} at "
                "{!r}".format(type(node).__name__, "/".join(path)))

    walk(state, ())
    return out


def _tree_state_dict(state, fresh=False):
    """The flat dict DCP saves (or, with ``fresh``, loads into: every
    array leaf a new tensor, so the caller's tree is never written)."""
    import numpy as np
    import torch

    sd = {}
    for path, leaf in _tree_leaves(state):
        if torch.is_tensor(leaf):
            leaf = leaf.detach().clone() if fresh else leaf.detach()
        else:
            leaf = torch.from_numpy(np.array(leaf))
        sd[path or "_"] = leaf
    return sd


def _tree_like(state_like, sd):
    """A new tree shaped like ``state_like`` from the loaded flat dict."""
    import numpy as np
    import torch

    def build(node, path):
        if isinstance(node, dict):
            return type(node)((k, build(v, path + (str(k),)))
                              for k, v in node.items())
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + (str(i),))
                              for i, v in enumerate(node))
        value = sd["/".join(path) or "_"]
        if torch.is_tensor(node):
            return value
        return np.asarray(value.numpy(), dtype=node.dtype)

    return build(state_like, ())


class Checkpointer(object):
    """Step-indexed train-state checkpoints under ``directory``.

    Args:
      directory: checkpoint root. Must be shared storage (NFS, or a
        remote scheme with ``allow_remote=True``) in multi-host setups.
      chief: whether this node is in the master family (``ctx.job_name``).
        Governs saves without a process group only; under one every rank
        saves.
      max_to_keep: retention (None keeps every step).
      allow_remote: pass scheme'd roots (``memory://``, ``s3://`` ...)
        to DCP's fsspec storage instead of rejecting them.
    """

    def __init__(self, directory, chief=True, max_to_keep=3,
                 allow_remote=False):
        from tensorflowonspark_tpu_torch import fs

        self._fs = None
        if allow_remote and fs.scheme_of(directory) is not None:
            import fsspec

            self.directory = os.fspath(directory).rstrip("/")
            self._fs, self._root = fsspec.core.url_to_fs(self.directory)
            self._fs.makedirs(self._root, exist_ok=True)
        else:
            self.directory = os.path.abspath(
                fs.require_local(directory, "checkpointing"))
            # every process makes the root (exist_ok makes the race
            # benign); an empty root is inert
            os.makedirs(self.directory, exist_ok=True)
        self.chief = chief
        self.max_to_keep = max_to_keep
        # Skip-decision bookkeeping: the already-persisted guard in
        # save() must be PROVABLY CONSISTENT across ranks — DCP's save
        # is a collective, so if one rank skips while a sibling enters,
        # the sibling hangs at the barrier forever. A live scan per call
        # is not consistent (a sibling's commit can land between two
        # ranks' scans), so the decision derives only from (a) this
        # snapshot, taken once before this run makes any save (every
        # rank sees the same settled disk state at construction), and
        # (b) the steps THIS instance saved — both identical across
        # ranks that make the same save() calls, which the collective
        # contract already requires. A step landed mid-run by an
        # unrelated writer surfaces as an error at the rename.
        self._steps_on_disk = frozenset(self.all_steps())
        self._saved_steps = set()

    # -- the root's contents ----------------------------------------------

    def _path(self, name):
        if self._fs is not None:
            return "{}/{}".format(self._root, name)
        return os.path.join(self.directory, str(name))

    def _url(self, step):
        if self._fs is not None:
            return "{}/{}".format(self.directory, step)
        return self._path(step)

    def all_steps(self):
        """Committed steps under the root, ascending."""
        if self._fs is not None:
            names = [p.rstrip("/").rsplit("/", 1)[-1]
                     for p in self._fs.ls(self._root, detail=False)]
            return sorted(int(n) for n in names if n.isdigit()
                          and self._fs.exists(
                              "{}/{}/{}".format(self._root, n, _METADATA)))
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(self._path(n)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _remove(self, step):
        if self._fs is not None:
            self._fs.rm(self._path(step), recursive=True)
        else:
            shutil.rmtree(self._path(step), ignore_errors=True)

    # -- save / restore ---------------------------------------------------

    def save(self, step, state, force=False):
        """Commit ``state`` at ``step``; returns True if this process saved.

        An already-persisted step is never overwritten: the call
        returns False. "Already persisted" means on disk when this
        Checkpointer was constructed, or saved through this instance — a
        deliberately rank-consistent definition (see __init__). To
        replace a step, delete it first. ``force`` is accepted for the
        reference's signature (orbax's save-interval policy; every call
        here saves).

        Replicated state in one process: the chief commits and everyone
        else no-ops. Under a group of several ranks, every rank must call
        ``save`` with the same steps (DCP's collective; each DTensor's
        shards are written by the ranks that hold them). A non-chief
        that holds sharded state (:func:`is_fully_replicated` false)
        alone raises: its shards could never reach the checkpoint and a
        restore would return garbage with no warning.
        """
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        distributed, rank = _group()
        single = not distributed or dist.get_world_size() == 1
        if not self.chief and single:
            if not is_fully_replicated(state):
                raise ValueError(
                    "Checkpointer(chief=False).save() got a non-replicated "
                    "(sharded) state in a single-process runtime: this "
                    "process's shards cannot reach the checkpoint and a "
                    "restore would return garbage. Sharded states need "
                    "either all ranks saving under a process group, or "
                    "chief=True in the single-process case.")
            # the chief's bytes are ours too; only safe with no sibling
            # waiting for us at DCP's barrier
            return False
        step = int(step)
        if step in self._saved_steps or step in self._steps_on_disk:
            # Already persisted (e.g. a periodic hook fired on the final
            # step and the epilogue force-saves the same step): a no-op —
            # the caller's intent ("step N must be on disk") holds. The
            # decision is the same on every rank (see __init__).
            return False
        from tensorflowonspark_tpu_torch import goodput

        coordinator = rank == 0
        with goodput.ledger().track("checkpoint_save"):
            sd = _tree_state_dict(state) if _is_tree(state) \
                else _state_dict(state)
            if self._fs is not None:
                dcp.save(sd, checkpoint_id=self._url(step),
                         no_dist=not distributed)
            else:
                tmp = self._path(_TMP_PREFIX + str(step))
                if coordinator:
                    shutil.rmtree(tmp, ignore_errors=True)  # a dead save's
                    os.makedirs(tmp)
                if distributed:
                    _barrier()
                dcp.save(sd, checkpoint_id=tmp, no_dist=not distributed)
                if coordinator:
                    os.replace(tmp, self._path(step))
            if coordinator and self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    self._remove(old)
            if distributed:
                _barrier()  # every rank sees the step committed
        self._saved_steps.add(step)
        if coordinator:
            # fault-injection site (chaos.py corrupt_checkpoint=N):
            # garbles the step it just committed so the fallback-restore
            # path is exercisable deterministically; O(1) when unarmed
            from tensorflowonspark_tpu_torch import chaos
            chaos.on_checkpoint_saved(step, self.directory)
        return True

    def restore(self, state_like, step=None, fallback=False):
        """Restore into ``state_like`` (a fresh state from
        ``Trainer.init`` of the same model shapes), in place; returns it,
        or None if no checkpoint exists (a tree of arrays is not
        written: a new tree shaped like it is returned). The parameters,
        the optimizer's moments and step counts, the buffers and
        ``state["step"]`` come back bitwise. Under a process group every rank must call it with
        the same step (DCP's load is a collective).

        ``fallback=True`` (the recovery posture): when the chosen step
        fails to restore (the classic cause: a writer killed mid-commit
        left a corrupt latest — chaos.py's corrupt_checkpoint injection
        reproduces it), walk back through older steps until one
        restores. The first error is re-raised only when EVERY step
        fails.
        """
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.api import CheckpointException
        from torch.distributed.checkpoint.state_dict import set_state_dict

        if step is not None:
            candidates = [int(step)]
        else:
            candidates = sorted(self.all_steps(), reverse=True)
        if not candidates:
            return None
        from tensorflowonspark_tpu_torch import goodput

        distributed, _ = _group()
        first_error = None
        for s in candidates:
            try:
                with goodput.ledger().track("restore"):
                    if _is_tree(state_like):
                        sd = _tree_state_dict(state_like, fresh=True)
                        dcp.load(sd, checkpoint_id=self._url(s),
                                 no_dist=not distributed)
                        return _tree_like(state_like, sd)
                    sd = _state_dict(state_like)
                    dcp.load(sd, checkpoint_id=self._url(s),
                             no_dist=not distributed)
                    set_state_dict(_module_of(state_like),
                                   state_like["opt_state"],
                                   model_state_dict=sd["model"],
                                   optim_state_dict=sd["optim"])
                    for name, value in sd["extra"].items():
                        buf = state_like["extra"][name]
                        if value is not buf:
                            buf.copy_(value)
                    state_like["step"] = int(sd["step"])
                    return state_like
            # DCP's CheckpointException derives from BaseException
            except (Exception, CheckpointException) as e:  # noqa: BLE001
                if not fallback:
                    raise
                if first_error is None:
                    first_error = e
                logger.warning(
                    "checkpoint step %d failed to restore (%s); "
                    "falling back to the previous step", s, e)
        raise RuntimeError(
            "no checkpoint step under {} could be restored "
            "(tried {})".format(self.directory, candidates)) from first_error

    def wait(self):
        """Saves are synchronous: nothing to wait for (the reference's
        surface, where orbax commits asynchronously)."""

    def close(self):
        """Nothing to release (the reference's surface)."""


def hook(checkpointer, every_steps=100):
    """Trainer ``train_loop`` hook: save every N steps."""

    def _hook(step_no, state, metrics):
        if step_no % every_steps == 0:
            checkpointer.save(int(state["step"]), state)

    return _hook
