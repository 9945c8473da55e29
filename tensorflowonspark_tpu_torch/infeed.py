"""Host-to-device infeed: overlap transfer with the device step — the
port of ``tensorflowonspark_tpu/infeed.py``.

- :func:`prefetch` — wrap any batch iterator with an N-deep background
  staging thread; errors on that thread re-raise at the consuming
  ``next()``, and closing the generator early joins the thread.
- :func:`device_batches` — the one-card counterpart of
  ``sharded_batches``: each host batch is copied into pinned memory and
  its host-to-device copy started on a side CUDA stream, so the copy of
  batch N+1 runs while step N computes.

Batches are arrays, or dicts/lists/tuples of them (numpy or torch).
"""

import queue as _queue
import threading
import time

import numpy as np
import torch

from tensorflowonspark_tpu_torch import device_info

_END = object()


def _tree_map(fn, batch):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(fn(v) for v in batch)
    return fn(batch)


def _host_copy(x):
    """A tensor that owns its memory: a copy out of the caller's buffer
    (a feed may reuse it for the next batch)."""
    if torch.is_tensor(x):
        return x.detach().clone()
    return torch.from_numpy(np.array(x, copy=True))


def prefetch(batch_iter, size=2, device_put=None, timers=None):
    """Iterate ``batch_iter`` with ``size`` batches staged ahead.

    ``device_put``: callable applied to each array of a batch on the
    staging thread (default: copy it into a torch tensor on the host).
    Yields staged batches in order. ``timers``: optional
    ``tracing.StageTimers``; each batch's staging time lands in its
    ``device_put`` stage.

    Closing the generator early (break, an error in the consumer)
    cancels and joins the staging thread — a bare ``put`` there would
    strand it on a full queue, holding staged batches.
    """
    put = device_put or _host_copy
    buf = _queue.Queue(maxsize=size)
    stop = threading.Event()

    def _put(item):
        """Bounded put that observes cancellation; False when cancelled."""
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def _stage():
        try:
            for batch in batch_iter:
                t0 = time.monotonic()
                staged = _tree_map(put, batch)
                if timers is not None:
                    timers.add("device_put", time.monotonic() - t0)
                if stop.is_set() or not _put(staged):
                    return
            _put(_END)
        except BaseException as e:  # noqa: BLE001 - re-raised at next()
            _put(e)

    t = threading.Thread(target=_stage, name="infeed-prefetch", daemon=True)
    t.start()

    try:
        while True:
            item = buf.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:  # unblock a put-in-flight so the join below is prompt
            while True:
                buf.get_nowait()
        except _queue.Empty:
            pass
        t.join(timeout=5.0)


def device_batches(batch_iter, device=None, size=2, timers=None):
    """Prefetch onto one device: yield batches whose arrays are tensors
    on ``device`` (:func:`device_info.default_device`).

    On a card, the staging thread copies each array into pinned host
    memory (a copy out of the caller's buffer, so a reused buffer cannot
    be overwritten under a staged batch) and starts a ``non_blocking``
    copy to the card on a side stream; the consumer's stream waits for
    that copy before the batch is yielded. On the CPU each array is
    copied. ``timers`` forwards to :func:`prefetch`.
    """
    device = device_info.default_device(device)
    if device.type != "cuda":
        return prefetch(batch_iter, size=size,
                        device_put=lambda x: _host_copy(x).to(device),
                        timers=timers)
    side = torch.cuda.Stream(device)

    def put(x):
        host = torch.as_tensor(x) if not torch.is_tensor(x) else x
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        with torch.cuda.stream(side):
            staged = _Staged(pinned.to(device, non_blocking=True))
            staged.done.record(side)
        return staged

    return _consume(prefetch(batch_iter, size=size, device_put=put,
                             timers=timers), device)


class _Staged(object):
    """A tensor whose copy to the card was started on a side stream,
    with the event that marks the copy's end."""

    __slots__ = ("tensor", "done")

    def __init__(self, tensor):
        self.tensor = tensor
        self.done = torch.cuda.Event()


def _consume(staged_batches, device):
    try:
        for batch in staged_batches:
            stream = torch.cuda.current_stream(device)

            def ready(staged):
                stream.wait_event(staged.done)
                # the side stream allocated it; the consumer's stream
                # uses it from here on
                staged.tensor.record_stream(stream)
                return staged.tensor

            yield _tree_map(ready, batch)
    finally:
        staged_batches.close()
