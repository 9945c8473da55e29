"""Data-parallel training harness — the port of
``tensorflowonspark_tpu/training.py``.

The reference's ``Trainer`` jit-compiles one data-parallel step over a
device mesh: params replicated, the batch split over the ``data`` axis,
the gradient all-reduce emitted by XLA. The port runs the step eagerly,
one process per card: when ``torch.distributed`` is initialized (by
:meth:`NodeContext.initialize_torch`, or by the caller), :meth:`init`
wraps the model in ``DistributedDataParallel``, whose broadcast at
construction is the reference's replicated init and whose bucketed
all-reduce averages the gradients. Each rank steps on its own local
batch, so the global batch is world x local, as
``make_array_from_process_local_data`` assembles it in the reference;
the returned loss is the global mean (an all-reduce average), the same
on every rank. With no process group the step is the one-card step.
There is no donation: the model and optimizer update their tensors in
place (the reference returns new pytrees; the port keeps PyTorch's
in-place optimizer step, which holds one copy of the parameters and the
optimizer moments instead of two). ``state`` keeps the reference's keys
so code written against it reads the same.

Typical ``map_fun`` body::

    dev = ctx.initialize_torch()
    trainer = training.Trainer(model, training.adamw(3e-4), device=dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(0))
    for batch in infeed.device_batches(feed_batches, trainer.device):
        state, metrics = trainer.step(state, batch)

The mode is the module's ``training`` flag: a step puts the model in
training mode (the reference's ``train=True`` / ``deterministic=False``).
``dropout_rng=True`` makes each step's dropout masks a function of the
step number alone, as the reference's ``fold_in(PRNGKey(0), step)``
does: the step runs inside ``torch.random.fork_rng`` with the CPU and
the trainer's card seeded from the step (and, under DDP, the rank, so
each rank's rows draw their own masks, as the rows of the reference's
global batch do), so a resumed run draws the same masks and torch's
own generator is left as it was. JAX's masks are not reproduced
bitwise (other generator, other bits).

**A mesh** (``mesh=``, a ``DeviceMesh`` from ``parallel.build_mesh`` or
``ctx.mesh()``): with only a ``data`` axis (or no axis above 1 besides
it) the DDP path above runs unchanged. With another axis above 1 — a
``model`` axis whose parameters ``parallel.sharding.distribute_params``
laid out as DTensors, which DDP cannot wrap — the step runs the model
with the batch's plain tensors read as replicated over the mesh
(``implicit_replication``: each ``data`` rank's own batch, shared by the
ranks of its model group), brings each gradient to its parameter's
placements, averages the gradient's LOCAL shard over the ``data_axis``
sub-group (one all-reduce a parameter) and steps; the optimizer's
moments take the parameters' placements. The loss is the mean over the
data ranks. The reference's ``constrain_state`` (keeping the state's
layout across steps) holds by construction: the parameters are updated
in place, on their placements.

Nothing else of the reference is left out: its ``donate_state`` /
``train_mode_kwarg`` have no counterpart in eager PyTorch.
"""

import contextlib
import logging
import time

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils import checkpoint as _checkpoint

from tensorflowonspark_tpu_torch import device_info

logger = logging.getLogger(__name__)


def softmax_xent(logits, batch):
    """Mean softmax cross-entropy; expects integer labels in
    ``batch["y"]`` (every leading axis of ``logits`` is averaged)."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           batch["y"].reshape(-1).long())


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
    """An optimizer factory with optax ``adamw``'s defaults (note the
    weight decay: 1e-4, where ``torch.optim.AdamW`` defaults to 1e-2).
    Every parameter is decayed, biases and LayerNorm scales included, as
    optax does without a mask: one parameter group."""

    def make(params):
        return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                                 eps=eps, weight_decay=weight_decay)

    return make


class TrainState(dict):
    """The train state: a dict with the reference's keys (``params``,
    ``extra``, ``opt_state``, ``step``) that also carries the module it
    was built from (``.model``, never a DDP wrapper), which
    ``checkpoint.Checkpointer`` needs to name the optimizer's state."""

    def __init__(self, model, *args, **kwargs):
        super(TrainState, self).__init__(*args, **kwargs)
        self.model = model


class _Remat(nn.Module):
    """Recompute ``inner``'s forward in the backward
    (``torch.utils.checkpoint``); DDP wraps this module, so its hooks
    see one forward per step."""

    def __init__(self, inner):
        super(_Remat, self).__init__()
        self.inner = inner

    def forward(self, *inputs):
        return _checkpoint.checkpoint(self.inner, *inputs,
                                      use_reentrant=False)


def _world():
    """(initialized, world size) of the default process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True, dist.get_world_size()
    return False, 1


class Trainer(object):
    """Data-parallel trainer: one process per card, DDP when a process
    group is initialized, the one-card step otherwise.

    Args:
      model: an ``nn.Module`` called with the batch's ``input_keys``
        values, in order.
      optimizer: a factory ``params -> torch.optim.Optimizer`` (e.g.
        :func:`adamw`), called once by :meth:`init`.
      loss_fn: ``(logits, batch) -> scalar loss``.
      input_keys: batch keys passed positionally to the model; only
        trailing keys may be absent.
      remat: recompute the forward pass in the backward
        (``torch.utils.checkpoint``) instead of storing activations.
      device: where the model trains (:func:`device_info.default_device`:
        the card unless ``"cpu"`` is asked for).
      dropout_rng: seed each step's random draws (dropout masks) from
        the step number alone, leaving torch's generator as it was;
        False draws from torch's generator as it stands.
      mesh: an optional ``DeviceMesh``; one with an axis above 1 other
        than ``data_axis`` selects the sharded step (module docstring).
      data_axis: the mesh axis the batch is split over.
    """

    def __init__(self, model, optimizer, loss_fn=softmax_xent,
                 input_keys=("x",), remat=False, device=None,
                 dropout_rng=False, mesh=None, data_axis="data"):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.input_keys = tuple(input_keys)
        self.remat = remat
        self.device = device_info.default_device(device)
        self.dropout_rng = bool(dropout_rng)
        #: what a step calls: the model, under ``_Remat`` and DDP as
        #: configured (built by :meth:`init`)
        self.net = None
        #: ranks in the process group a step all-reduces over (1 alone;
        #: the data axis's size under a sharded mesh)
        self.world_size = 1
        self.mesh = mesh
        self.data_axis = data_axis
        #: the data axis's group under a sharded mesh (None otherwise)
        self._data_group = None
        self._data_rank = 0

    def _sharded(self):
        """Whether the mesh has an axis above 1 other than the data
        axis (the DTensor step instead of DDP)."""
        if self.mesh is None:
            return False
        return any(size > 1 for name, size in zip(
            self.mesh.mesh_dim_names, self.mesh.shape)
            if name != self.data_axis)

    def _inputs(self, batch):
        if not isinstance(batch, dict):
            return (batch,)
        # Positional binding: only TRAILING keys may be absent — a missing
        # middle key would silently shift later arrays into the wrong
        # model argument.
        values = []
        missing = None
        for k in self.input_keys:
            if k in batch:
                if missing is not None:
                    raise KeyError(
                        "batch is missing input key {!r} but provides the "
                        "later key {!r}; positional binding would be "
                        "corrupted".format(missing, k))
                values.append(batch[k])
            elif missing is None:
                missing = k
        return tuple(values)

    def _on_device(self, batch):
        def put(x):
            if not torch.is_tensor(x):
                x = torch.as_tensor(x)
            return x.to(self.device, non_blocking=True)

        if isinstance(batch, dict):
            return {k: put(v) for k, v in batch.items()}
        return put(batch)

    def init(self, generator=None):
        """Train state ``{params, extra, opt_state, step}`` on the
        trainer's device (a :class:`TrainState`). ``generator`` (a
        ``torch.Generator`` on that device) re-initialises the weights
        through the model's ``init_weights``; without one the model keeps
        the weights it has (e.g. loaded with ``load_state_dict``).
        ``params``/``extra`` are the model's own parameters and buffers,
        ``opt_state`` the optimizer built over them. Under an initialized
        process group the model is wrapped in ``DistributedDataParallel``
        here, which broadcasts rank 0's weights to every rank: the
        reference's replicated init."""
        self.model.to(self.device)
        if generator is not None:
            init = getattr(self.model, "init_weights", None)
            if init is None:
                raise TypeError("{} has no init_weights(generator)".format(
                    type(self.model).__name__))
            init(generator)
        net = _Remat(self.model) if self.remat else self.model
        distributed, self.world_size = _world()
        if self._sharded():
            # DDP cannot wrap DTensor parameters: the step averages the
            # gradients over the data axis itself
            self.world_size, self._data_rank, self._data_group = 1, 0, None
            if self.data_axis in self.mesh.mesh_dim_names:
                from tensorflowonspark_tpu_torch.parallel.collectives import (
                    axis_of)

                self.world_size, self._data_rank, self._data_group = \
                    axis_of(self.mesh, self.data_axis)
        elif distributed:
            net = nn.parallel.DistributedDataParallel(
                net, device_ids=([self.device.index]
                                 if self.device.type == "cuda" else None),
                find_unused_parameters=False)
        self.net = net
        params = dict(self.model.named_parameters())
        return TrainState(self.model, {
            "params": params,
            "extra": dict(self.model.named_buffers()),
            "opt_state": self.optimizer(list(params.values())),
            "step": 0})

    def step(self, state, batch):
        """One training step on this rank's local batch; returns
        ``(state, {"loss": loss})`` with the loss a 0-d tensor on the
        device (reading it synchronises): the mean over the global
        batch, the same on every rank."""
        if self.net is None:
            raise RuntimeError("Trainer.step before Trainer.init")
        self.net.train()
        batch = self._on_device(batch)
        inputs = self._inputs(batch)
        opt = state["opt_state"]
        opt.zero_grad(set_to_none=True)
        sharded = self._sharded()
        with self._step_rng(state["step"]), _replicated_inputs(sharded):
            loss = self.loss_fn(self.net(*inputs), batch)
            loss.backward()
        if sharded:
            loss = _local(loss)
            self._average_gradients()
        opt.step()
        state["step"] += 1
        loss = loss.detach()
        if self.world_size > 1:
            import torch.distributed as dist

            loss = loss.clone()
            # SUM: gloo has no AVG
            dist.all_reduce(loss, group=self._data_group)
            loss /= self.world_size
        return state, {"loss": loss}

    def _average_gradients(self):
        """The sharded step's gradient sync: each gradient brought to its
        parameter's placements (a DTensor's partial sums reduced over its
        model group) and its local shard averaged over the data axis."""
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor

        with torch.no_grad():
            for p in self.model.parameters():
                g = p.grad
                if g is None:
                    continue
                if isinstance(g, DTensor):
                    if tuple(g.placements) != tuple(p.placements):
                        g = g.redistribute(p.device_mesh, p.placements)
                    local = g.to_local().clone()
                else:
                    local = g
                if self.world_size > 1:
                    dist.all_reduce(local, group=self._data_group)
                    local /= self.world_size
                if isinstance(g, DTensor):
                    local = DTensor.from_local(
                        local, p.device_mesh, p.placements, run_check=False,
                        shape=p.shape, stride=p.stride())
                p.grad = local

    @contextlib.contextmanager
    def _step_rng(self, step):
        """With ``dropout_rng``: the step's forward and backward draw from
        generators seeded with ``step`` (and the rank, under DDP; the
        CPU's and the trainer's card's), restored afterwards."""
        if not self.dropout_rng:
            yield
            return
        if self.world_size > 1:
            import torch.distributed as dist

            rank = (self._data_rank if self._data_group is not None
                    else dist.get_rank())
            step = int(step) * self.world_size + rank
        cuda = self.device.type == "cuda"
        devices = [self.device.index or 0] if cuda else []
        with torch.random.fork_rng(devices=devices):
            torch.random.default_generator.manual_seed(int(step))
            if cuda:
                with torch.cuda.device(devices[0]):
                    torch.cuda.manual_seed(int(step))
            yield

    def train_loop(self, state, batches, log_every=50, hooks=(),
                   ledger=None):
        """Drive steps over a batch iterator. Returns ``(state,
        total_steps, examples/sec)``; examples are global (each rank's
        local batch times the world size). ``hooks``: callables
        ``(step_no, state, metrics) -> None``.

        Goodput accounting (goodput.py), as in the reference: each
        step-call window is charged to the ledger as ``productive_step``
        — the FIRST of a process's life as ``compile`` (it loads the
        kernels and warms the allocator and cuBLAS) — and mirrored into
        the flight recorder as a ``train_step``/``compile`` span. The
        step returns once its work is queued on the card; the queue is
        bounded, so successive call windows cover the card's time
        without a synchronisation that would stall the pipeline.
        ``ledger=None`` charges the process-global ledger (the one the
        DataFeed's heartbeat snapshot carries to the driver);
        ``ledger=False`` opts out. A custom ledger receives only this
        loop's step envelopes; the feed's waits always charge
        ``goodput.ledger()``.
        """
        from tensorflowonspark_tpu_torch import goodput

        if ledger is None:
            ledger = goodput.ledger()
        n = 0
        examples = 0
        t0 = time.monotonic()
        metrics = None
        for batch in batches:
            if ledger:
                with ledger.step_span():
                    state, metrics = self.step(state, batch)
            else:
                state, metrics = self.step(state, batch)
            n += 1
            examples += _batch_size(batch) * self.world_size
            for hook in hooks:
                hook(n, state, metrics)
            if log_every and n % log_every == 0:
                loss = float(metrics["loss"])
                dt = time.monotonic() - t0
                logger.info("step %d loss %.4f (%.1f ex/s)", n, loss,
                            examples / dt)
        if metrics is not None:
            float(metrics["loss"])  # wait for the last step's work
        dt = max(time.monotonic() - t0, 1e-9)
        return state, n, examples / dt


def _replicated_inputs(sharded):
    """Under a sharded mesh: plain tensors meet DTensors as replicated
    ones (``implicit_replication``); otherwise nothing."""
    if not sharded:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _local(t):
    """A replicated DTensor's value as a plain tensor (the loss)."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _batch_size(batch):
    if isinstance(batch, dict):
        batch = next(iter(batch.values()))
    return batch.shape[0]
