"""Training checkpoint/resume on ``torch.distributed.checkpoint`` — the
port of ``tensorflowonspark_tpu/checkpoint.py``.

Reference behavior (SURVEY.md §5 "Checkpoint / resume"): the reference
delegates checkpointing to TF (MonitoredTrainingSession / Keras callbacks
writing to shared storage); recovery = resubmit + restore latest. The
framework wires the checkpointer to the node's role, user code decides
when to save. The JAX package saves through orbax; the port saves
through DCP (``torch.distributed.checkpoint``):

- **What is saved.** ``{"model", "optim", "step", "extra"}``: the
  model's and the optimizer's state dicts from
  ``torch.distributed.checkpoint.state_dict.get_state_dict`` (parameter
  names, not positions, key the optimizer's moments), the step, and the
  model's buffers. The train state is a ``training.TrainState``, which
  carries its module. :meth:`Checkpointer.restore` loads into a fresh
  state of the same shapes and puts it back with ``set_state_dict``.
- **Layout.** One directory per step under the root, named by the step
  (``<root>/5``), as orbax names them; DCP writes ``.metadata`` and one
  ``__<rank>_0.distcp`` per writing rank in it.
- **Commit.** A local step is written into ``<root>/.tmp-<step>`` and
  renamed into place (``os.replace``) once DCP has finished, so a step
  directory is whole or absent.
- **Who saves.** Without a process group only the chief writes (the
  state is replicated, so a non-chief ``save()`` is a no-op). Under an
  initialized group every rank calls ``save()``: DCP's save is a
  collective (plans gathered, a barrier), and its planner writes each
  replicated tensor once.

Remote roots: a ``scheme://`` root is refused (``fs.require_local``)
unless ``allow_remote=True``, which hands it to DCP's own fsspec storage
layer: no temporary directory there (an object store has no rename), so
a step counts as committed once its ``.metadata``, which DCP writes
last, exists.

Left for a later slice (ROADMAP Queue 1 item 6, ``parallel/``):
``is_fully_replicated`` and ``respec_like``, the sharded-state protocol
and the cross-mesh restore. Plain tensors count as replicated.
"""

import logging
import os
import shutil

logger = logging.getLogger(__name__)

_TMP_PREFIX = ".tmp-"
_METADATA = ".metadata"


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

        Without a process group the chief commits and everyone else
        no-ops; under one, every rank must call ``save`` with the same
        steps (DCP's collective).
        """
        import torch.distributed.checkpoint as dcp

        distributed, rank = _group()
        if not self.chief and not distributed:
            # the chief's bytes are ours too; only safe OUTSIDE a group,
            # where no sibling waits for us at DCP's barrier
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
            sd = _state_dict(state)
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
        or None if no checkpoint exists. The parameters, the optimizer's
        moments and step counts, the buffers and ``state["step"]`` come
        back bitwise. Under a process group every rank must call it with
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
