"""Executor-side user API for the queue feed plane — the port's copy of
``tensorflowonspark_tpu/datafeed.py``, with both transports (the shm
ring and the broker queues).

Reference: ``tensorflowonspark/TFNode.py :: DataFeed`` (SURVEY.md §2
"Executor user API"): the object user ``map_fun`` code uses to pull training
batches off the input queue, push inference results to the output queue, and
observe end-of-feed.

Differences from the reference:

- Queue items are *chunks* assembled feeder-side, not single records —
  preferably :class:`~tensorflowonspark_tpu_torch.frames.ColumnarChunk` (records
  stacked into contiguous per-column arrays; see frames.py), with plain
  record lists as the fallback for ragged/object records.
  ``next_batch`` re-slices chunks to the requested batch size — column
  slices are views, so re-slicing moves no data — and batches never
  straddle an ``EndPartition``.
- With ``input_mapping``, ``next_batch`` returns columns as numpy arrays
  (ready for ``torch.from_numpy``), not python lists. When the feeder sent
  columnar chunks, the arrays pass through with zero per-record work.
- ``numpy_batches()`` is an infinite-batch generator suitable for wrapping
  in a prefetching infeed (``infeed.device_batches``) — the analog of the reference's
  ``tf.data.Dataset.from_generator(DataFeed...)`` idiom.

Zero-copy ring consume path (the small-batch feed-gap fix): when the
node's shm ring is active, chunks are decoded as views INTO the ring
mapping (``ShmRing.read_view``) instead of being memcpy'd out
(``read_obj``), and the mapped batch is assembled with a single gather
per column into a reusable staging buffer; the ring slot is released
only after that copy. This kills both fixed copies the old path paid
per chunk (the read-side materialize AND the ``frames.concat`` in
``_combine``). Contract: with staging reuse on (the default), a mapped
columnar batch is valid until the NEXT ``next_batch`` call — consumers
that hold batches longer must copy (``np.array``). Every framework
consumer (``infeed.device_batches``' pinned staging copy,
``pad_to_batch``'s ``np.resize``) already copies within that window.
``TFOS_FEED_STAGING=0`` restores per-batch ownership (fresh buffer per
batch, still single-gather); ``TFOS_FEED_ZERO_COPY=0`` restores the
copying ``read_obj`` consume path entirely.
"""

import logging
import os
import time

import numpy as np

from tensorflowonspark_tpu_torch import chaos
from tensorflowonspark_tpu_torch import frames as frames_lib
from tensorflowonspark_tpu_torch import goodput as goodput_mod
from tensorflowonspark_tpu_torch import tracing
from tensorflowonspark_tpu_torch.frames import ColumnarChunk
from tensorflowonspark_tpu_torch.marker import EndFeed, EndPartition, Marker

logger = logging.getLogger(__name__)


class _RingSlot(object):
    """Shared ownership of one zero-copy ring message.

    Decoded column arrays alias the ring mapping until the release runs;
    the release fires exactly once, after every aliasing row has been
    copied out (gathered into a staging batch or materialized into
    rows). Chunk slices and coalesced multi-frame siblings share one
    slot, so the row countdown spans all of them.
    """

    __slots__ = ("_release", "_remaining")

    def __init__(self, release, rows):
        self._release = release
        self._remaining = rows

    def consume(self, rows):
        """``rows`` more aliasing rows were copied out; release at zero."""
        self._remaining -= rows
        if self._remaining <= 0:
            self.drop()

    def drop(self):
        """Unconditional release (terminate/abort paths). Idempotent."""
        if self._release is not None:
            release, self._release = self._release, None
            release()


class _RingSegment(object):
    """A ColumnarChunk whose columns are views into the shm ring, plus
    the slot bookkeeping that keeps the producer away until consumed."""

    __slots__ = ("chunk", "slot")

    def __init__(self, chunk, slot):
        self.chunk = chunk
        self.slot = slot


def _seg_len(seg):
    if isinstance(seg, _RingSegment):
        return len(seg.chunk)
    return len(seg)


def _seg_slice(seg, start, stop):
    if isinstance(seg, _RingSegment):
        return _RingSegment(seg.chunk.slice(start, stop), seg.slot)
    if isinstance(seg, ColumnarChunk):
        return seg.slice(start, stop)
    return seg[start:stop]


def _seg_rows(seg):
    if isinstance(seg, _RingSegment):
        # row extraction outlives the slot: copy out, then release
        seg.chunk.materialize()
        seg.slot.consume(len(seg.chunk))
        return seg.chunk.records()
    if isinstance(seg, ColumnarChunk):
        return seg.records()
    return list(seg)


def _unpin_segments(segs):
    """Copy consumed ring segments out of the mapping and free their
    slots, in place (each becomes a plain owned ColumnarChunk)."""
    for i, seg in enumerate(segs):
        if isinstance(seg, _RingSegment):
            seg.chunk.materialize()
            seg.slot.consume(len(seg.chunk))
            segs[i] = seg.chunk


class DataFeed(object):
    """Pull batches from / push results to this node's queue broker.

    Args mirror the reference: ``mgr`` (a ``ManagerClient``), ``train_mode``
    (True = no output queue), ``qname_in``/``qname_out``, ``input_mapping``
    (ordered {record_field -> name}; when set, batches are dicts of numpy
    arrays keyed by the mapped names).
    """

    def __init__(self, mgr, train_mode=True, qname_in="input", qname_out="output",
                 input_mapping=None):
        self.mgr = mgr
        self.train_mode = train_mode
        self.qname_in = qname_in
        self.qname_out = qname_out
        self.input_mapping = dict(input_mapping) if input_mapping else None
        self.input_tensors = list(input_mapping.values()) if input_mapping else None
        self.done_feeding = False
        # Fast path: when the node created a native shm ring for the feed
        # (the default for a local broker — see node.py), chunks arrive
        # there: a gather-memcpy into the mapping instead of a manager-proxy
        # TCP round trip per chunk. The queue stays the control/results
        # channel.
        self._ring = None
        ring_name = None
        try:
            ring_name = mgr.get("shm_name")
        except Exception:  # noqa: BLE001 - kv store may be gone at teardown
            pass
        if ring_name and qname_in == "input":
            from tensorflowonspark_tpu_torch import shm
            self._ring = shm.ShmRing.open(ring_name)
        self._queue_in = None if self._ring else mgr.get_queue(qname_in)
        self._queue_out = None if train_mode else mgr.get_queue(qname_out)
        self._pending = []  # segments: ColumnarChunk | _RingSegment | list
        self._backlog = []  # items decoded ahead from a coalesced frame
        self._unpacked = 0  # queue pieces left before task_done is owed
        # Zero-copy consume path knobs (module docstring): both default on.
        self._zero_copy = os.environ.get("TFOS_FEED_ZERO_COPY", "1") == "1"
        self._staging_reuse = os.environ.get("TFOS_FEED_STAGING", "1") == "1"
        self._staging = {}  # per-output-column reusable gather buffers
        # feed-plane visibility the reference lacked (SURVEY.md §5
        # tracing): how long the consumer sat blocked on the queue, plus
        # the per-stage breakdown (ring wait / decode / gather; the
        # prefetcher adds device_put into the same instance).
        self.timers = tracing.StageTimers()
        self._wait_s = 0.0  # cumulative blocked-on-transport seconds
        # Observability plane: the feed counters (records /
        # chunks / batches / staging) and stage timers live in ONE
        # MetricsRegistry — stats() reads the same Counters the
        # registry renders, so user-visible stats and scraped series
        # can never disagree — and its compact snapshot rides the
        # progress heartbeat into the broker kv, where node.py's beat
        # thread piggybacks it on the BEAT lease: the driver's
        # cluster.metrics() / the reservation server's /metrics
        # endpoint see every executor's feed-stage breakdown without a
        # new channel.
        self._counts = tracing.Counters()
        self.metrics = tracing.MetricsRegistry()
        self.metrics.add_counters("tfos_feed", self._counts)
        self.metrics.add_timers("tfos_feed_stage", self.timers)
        # Goodput plane (goodput.py): the PROCESS ledger registers into
        # this registry, so the beat-piggybacked snapshot carries the
        # trainer's wall-time classification (productive steps, compile,
        # checkpoint, feed waits) to the driver on the channel the feed
        # metrics already ride — and this feed charges its blocked
        # transport reads to it as ``feed_wait``.
        self.goodput = goodput_mod.ledger()
        self.goodput.register(self.metrics)
        # the trainer's span ring (train_step/compile/badput spans land
        # in the process recorder): surface its eviction tally too
        tracing.expose_flight_drops(self.metrics,
                                    tracing.flight_recorder())
        try:
            # publish the (empty) snapshot immediately: an executor
            # whose feed never serves a batch still beats a metrics
            # key, so the driver's rollup distinguishes "idle feed"
            # from "no feed plane at all"
            self.mgr.set("metrics", self.metrics.snapshot())
        except Exception:  # noqa: BLE001 - kv store may be gone
            pass
        # Progress heartbeat: a throttled batches-served counter in the
        # broker kv. node.shutdown() re-arms its termination grace while
        # this advances, so a trainer legitimately stepping through a deep
        # buffered backlog (slow steps: big models, slow host-to-device
        # transfers) is not killed as "unresponsive" mid-progress: a hard
        # join cap would kill a live trainer whose steps take seconds
        # each. Counting non-empty batches
        # SERVED — not queue items — matters: chunks are buffered into
        # _pending as they arrive, so the final batches step with no
        # queue traffic; and post-end-of-feed empty batches count as no
        # progress at all.
        self._hb_at = None       # monotonic of the last heartbeat publish
        self._last_progress = None  # monotonic of the last non-empty batch
        self._metrics_flushed = False  # final end-of-feed flush, once

    def next_batch(self, batch_size):
        """Next batch of up to ``batch_size`` records.

        Blocks until data arrives. Returns a short (possibly empty) batch at
        an ``EndPartition`` boundary or at end-of-feed; after end-of-feed,
        ``should_stop()`` is True and subsequent calls return empty batches.

        Reference: ``TFNode.DataFeed.next_batch`` — same contract, including
        ``task_done`` accounting per queue item so the feeder's
        ``queue.join()`` unblocks once the partition is consumed.
        """
        segs = []
        count = 0
        while count < batch_size:
            take = batch_size - count
            if self._pending:
                seg = self._pending[0]
                n = _seg_len(seg)
                if n <= take:
                    segs.append(seg)
                    count += n
                    self._pending.pop(0)
                else:
                    segs.append(_seg_slice(seg, 0, take))
                    self._pending[0] = _seg_slice(seg, take, n)
                    count += take
                continue
            if self.done_feeding:
                break
            if not self._backlog:
                # About to read the transport while this batch spans
                # messages: release the already-consumed segments' ring
                # slots first (copy out + free). Load-bearing twice
                # over. (1) Correctness: ring.read_view's sequential-
                # consumption contract — the read position is the tail,
                # which only release advances, so reading again with a
                # slot still held would re-deliver the SAME message
                # (duplicated records, then a desynced stream when both
                # slots release). (2) Liveness: a held slot pins bytes
                # the producer may need to send the very data we would
                # block waiting for. Costs one extra copy ONLY for
                # message-spanning batches; the batch-within-one-message
                # steady state never gets here with ring segments in
                # hand and stays zero-copy.
                _unpin_segments(segs)
            t0 = time.monotonic()
            with self.goodput.track("feed_wait"):
                # blocked-on-transport time (decode included — it is
                # part of what the trainer waits on) is feed_wait
                # badput; innermost-wins nesting keeps it out of any
                # enclosing productive_step claim
                item = self._next_item()
            self._wait_s += time.monotonic() - t0
            if isinstance(item, Marker):
                self._item_done()
                if isinstance(item, EndFeed):
                    self.done_feeding = True
                if isinstance(item, (EndPartition, EndFeed)) and count:
                    break
                if isinstance(item, EndFeed):
                    break
                continue  # EndPartition with empty batch: keep reading
            if isinstance(item, (ColumnarChunk, _RingSegment)):
                seg = item
            else:
                seg = item if isinstance(item, list) else [item]
            self._pending.append(seg)
            self._counts.inc("records", _seg_len(seg))
            self._counts.inc("chunks")
            self._item_done()
        # A trailing partition marker that traveled WITH the final chunk
        # (tail coalescing) is consumed in-call: the feeder's queue join
        # — and a supervised feed's partition ACK — then completes with
        # the batch that finished the partition, not one call later.
        # Only with _pending empty: leftover records mean the partition
        # is NOT fully consumed yet, and its task_done must wait.
        while count and not self._pending and self._backlog \
                and isinstance(self._backlog[0], Marker):
            item = self._backlog.pop(0)
            self._item_done()
            if isinstance(item, EndFeed):
                self.done_feeding = True
        if count:
            # Non-empty batches only: an empty batch after end-of-feed is
            # not progress, and must not re-arm the shutdown grace (a
            # buggy map_fun spinning on empty next_batch calls would
            # otherwise hold off termination forever).
            self._counts.inc("batches")
            self._last_progress = time.monotonic()
            self._heartbeat()
            # deterministic fault injection (chaos.py): kill/stall sites
            # keyed on batches served — a no-op O(1) check when unarmed.
            # An injected consumer stall is feed-plane badput: charge
            # it where a real stalled transport would land
            with self.goodput.track("feed_wait"):
                chaos.on_batch(self, self._counts.get("batches"))
        if self.done_feeding and not self._metrics_flushed:
            # final flush at end-of-feed: the 2s heartbeat throttle
            # otherwise leaves everything since the last publish — on a
            # short job, most of the run — out of the driver's
            # harvested rollup
            self._metrics_flushed = True
            self._publish_metrics()
        return self._combine(segs)

    def _heartbeat(self):
        """Publish batches-served progress — and the compact metrics
        snapshot the BEAT lease piggybacks — to the kv, at most every
        2s (two small RPCs — negligible against a chunk's payload)."""
        now = time.monotonic()
        if self._hb_at is not None and now - self._hb_at < 2.0:
            return
        if chaos.on_heartbeat():  # injected heartbeat outage: do NOT
            return                # advance the throttle — retry next batch
        self._hb_at = now
        self._publish_metrics()

    def publish_metrics(self):
        """Force-publish progress + the registry snapshot NOW,
        bypassing the 2s heartbeat throttle (and re-arming it). The
        supervised step boundary calls this so a trainer killed right
        after a step loses at most the publish-to-beat gap of goodput
        accounting, not a whole throttle window."""
        self._hb_at = time.monotonic()
        self._publish_metrics()

    def _publish_metrics(self):
        """Best-effort publish of progress + the registry snapshot to
        the broker kv (the beat thread piggybacks both on the BEAT
        lease). Respects an injected heartbeat outage (chaos.py)."""
        if chaos.on_heartbeat():
            return
        try:
            self.mgr.set("feed_hb", self._counts.get("batches"))
            self.mgr.set("metrics", self.metrics.snapshot())
        except Exception:  # noqa: BLE001 - kv store may be gone at teardown
            pass

    def _combine(self, segs):
        """Assemble consumed segments into the user-facing batch shape."""
        if self.input_tensors is None:
            rows = []
            for seg in segs:
                rows.extend(_seg_rows(seg))
            return rows
        cols_only = segs and all(
            isinstance(s, (ColumnarChunk, _RingSegment)) for s in segs)
        if cols_only:
            with self.timers.timed("gather"):
                return self._gather_columns(segs)
        rows = []
        for seg in segs:
            rows.extend(_seg_rows(seg))
        return self._stack_columns(rows)

    def _gather_columns(self, segs):
        """Mapped columnar batch with AT MOST one copy per column.

        One owned chunk (queue-transport steady state): its column views
        pass through untouched — zero copy, as before. Anything else —
        ring-backed views (which must not outlive their slot) or
        multi-segment batches (which previously paid a ``frames.concat``
        allocation+copy on top of the read-side materialize) — gathers
        each column straight into a staging buffer, then releases the
        ring slots. The staging buffer is reused across batches whenever
        rows/trailing-shape/dtype repeat (the steady state), so the
        gather lands on already-faulted pages with zero per-batch
        allocation; see the module docstring for the validity contract
        this implies.
        """
        chunks = [s.chunk if isinstance(s, _RingSegment) else s
                  for s in segs]
        first = chunks[0]
        if first.names is not None:
            fields = list(self.input_mapping.keys())

            def col(chunk, j):
                return chunk.cols[chunk.names.index(fields[j])]
        else:
            def col(chunk, j):
                return chunk.cols[j]

        if len(segs) == 1 and isinstance(segs[0], ColumnarChunk):
            return {name: col(first, j)
                    for j, name in enumerate(self.input_tensors)}
        total = sum(len(c) for c in chunks)
        out = {}
        for j, name in enumerate(self.input_tensors):
            srcs = [col(c, j) for c in chunks]
            if len({(s.dtype, s.shape[1:]) for s in srcs}) > 1:
                # heterogeneous segments (mixed feeds): numpy's upcasting
                # concat is the only correct assembly — and it copies, so
                # the slot release below stays safe
                out[name] = np.concatenate(srcs)
                continue
            dst = self._staging_buffer(name, total, srcs[0])
            pos = 0
            for s in srcs:
                n = s.shape[0]
                dst[pos:pos + n] = s  # the single gather memcpy
                pos += n
            out[name] = dst[:total]
        for s in segs:
            if isinstance(s, _RingSegment):
                s.slot.consume(len(s.chunk))
        return out

    def _staging_buffer(self, name, rows, like):
        """Reusable gather destination for output column ``name``."""
        buf = self._staging.get(name) if self._staging_reuse else None
        if (buf is not None and buf.dtype == like.dtype
                and buf.shape[1:] == like.shape[1:]
                and buf.shape[0] >= rows):
            self._counts.inc("staging_reuse")
            return buf
        buf = np.empty((rows,) + like.shape[1:], like.dtype)
        if self._staging_reuse:
            self._staging[name] = buf
        self._counts.inc("staging_alloc")
        return buf

    def _next_item(self):
        """Blocking read of the next feed item (chunk or Marker).

        Bounded waits with state checks between them: a consumer blocked
        on a feed whose producer side died must raise, not hang forever.
        'error' aborts immediately; 'terminating' (set by the driver's
        shutdown AFTER it queued EndFeed, and by our own terminate())
        gets a short grace so an in-flight EndFeed can still arrive, then
        aborts — otherwise a feeder that died mid-shutdown would park
        this consumer on an empty feed until the shutdown timeout.
        """
        import queue as _queue
        if self._backlog:
            # items decoded ahead of time from a coalesced multi-frame
            return self._backlog.pop(0)
        idle_terminating = 0
        # One wait sample per DELIVERED item, spanning however many empty
        # 5s polls preceded it — so timers.per_ms() reads as per-item
        # wait, not a per-poll mean diluted (or inflated) by idle polls.
        t_wait = time.monotonic()
        while True:
            if self._ring is not None:
                view, release = self._ring.read_view(timeout=5.0)
                if view is not None:
                    self.timers.add("ring_wait", time.monotonic() - t_wait)
                    items = self._decode_message(view, release)
                    if items:  # empty multi-frame: nothing to deliver
                        self._backlog.extend(items[1:])
                        return items[0]
                    t_wait = time.monotonic()
            else:
                try:
                    item = self._queue_in.get(block=True, timeout=5.0)
                    self.timers.add("queue_wait",
                                    time.monotonic() - t_wait)
                    if isinstance(item, frames_lib.FrameList):
                        # tail coalescing: one queue item carrying
                        # several feed items ([final chunk, EndPartition]
                        # today). _item_done fires the single task_done
                        # on the LAST piece.
                        pieces = list(item)
                        self._unpacked = len(pieces)
                        self._backlog.extend(pieces[1:])
                        return pieces[0]
                    return item
                except _queue.Empty:
                    pass
            state = self.mgr.get("state")
            if state in ("error", "stopped"):  # terminal states: abort now
                raise RuntimeError(
                    "feed aborted: node state is {!r}".format(state))
            if state == "terminating":
                idle_terminating += 1
                if idle_terminating >= 3:  # ~15s with no EndFeed showing
                    raise RuntimeError(
                        "feed aborted: node is terminating and no "
                        "end-of-feed marker arrived")

    def _decode_message(self, view, release):
        """One ring message → list of feed items (≥1 for coalesced
        multi-frames).

        Columnar payloads stay ZERO-COPY views into the ring mapping,
        wrapped in :class:`_RingSegment` with the slot bookkeeping that
        defers ``release`` until every aliased row has been copied out —
        which is also why blocking in ``_next_item`` can never deadlock
        against a producer blocked on ring space: this is only reached
        with ``_pending``/``_backlog`` empty AND the current batch's
        consumed segments unpinned (``_unpin_segments`` in next_batch),
        i.e. with no slots held by this consumer.
        """
        t0 = time.monotonic()
        try:
            obj = frames_lib.decode(view)
        except BaseException:
            release()  # never strand the producer on a corrupt frame
            raise
        objs = list(obj) if isinstance(obj, frames_lib.FrameList) else [obj]
        rows = sum(len(o) for o in objs if isinstance(o, ColumnarChunk))
        if rows and self._zero_copy:
            slot = _RingSlot(release, rows)
            items = [_RingSegment(o, slot)
                     if isinstance(o, ColumnarChunk) and len(o)
                     else (o.materialize() if isinstance(o, ColumnarChunk)
                           else o)
                     for o in objs]
        else:
            # marker-only messages, legacy object frames, or zero-copy
            # disabled: copy out and free the slot immediately
            for o in objs:
                if isinstance(o, ColumnarChunk):
                    o.materialize()
            release()
            items = objs
        self.timers.add("decode", time.monotonic() - t0)
        return items

    def _item_done(self):
        if self._queue_in is None:
            return
        if self._unpacked > 1:
            # piece of a coalesced multi-item: the queue saw ONE put, so
            # only the last piece's consumption calls task_done
            self._unpacked -= 1
            return
        self._unpacked = 0
        self._queue_in.task_done()

    def _stack_columns(self, batch):
        """Stack row records column-wise into {mapped_name: np.ndarray}."""
        cols = {name: [] for name in self.input_tensors}
        fields = list(self.input_mapping.keys())
        for rec in batch:
            if isinstance(rec, dict):
                values = [rec[k] for k in fields]
            else:
                values = list(rec)
            for name, v in zip(self.input_tensors, values):
                cols[name].append(v)
        return {name: np.asarray(vs) for name, vs in cols.items()}

    def numpy_batches(self, batch_size, pad_to_batch=False):
        """Generator of non-empty batches until end-of-feed.

        The idiomatic consumption loop: wrap in
        ``infeed.device_batches`` (its staging thread copies each array
        out of the reused staging buffer) to overlap the host-to-device
        copy with the device step.

        ``pad_to_batch=True`` repeats a short batch's own records
        (modularly — partition tails can be smaller than half a batch)
        until it reaches ``batch_size``: jit-compiled steps want one
        static batch shape (CUDA graphs and compiled steps want the
        same), and a repeated tail record only biases the
        last step of an epoch marginally — the same trade every
        drop-remainder/pad input pipeline makes. Applies to both record
        lists and (via column-wise ``np.resize``) mapped column dicts.
        """
        while not self.should_stop():
            batch = self.next_batch(batch_size)
            size = len(batch) if self.input_tensors is None else \
                (len(next(iter(batch.values()))) if batch else 0)
            if size == 0:
                continue
            if pad_to_batch and size < batch_size:
                if self.input_tensors is None:
                    batch = list(batch)
                    while len(batch) < batch_size:
                        batch.extend(batch[: batch_size - len(batch)])
                else:
                    # np.resize repeats the array cyclically along axis 0
                    # when flattened; reshape keeps trailing dims intact
                    batch = {k: np.resize(v, (batch_size,) + v.shape[1:])
                             for k, v in batch.items()}
            yield batch

    def stats(self):
        """Consumer-side feed-plane counters: {records, chunks, wait_s,
        staging_alloc, staging_reuse, batches, heartbeat_age_s,
        last_progress_age_s, stages: {stage: seconds}}.

        ``heartbeat_age_s`` / ``last_progress_age_s`` (None until the
        first publish / first non-empty batch) make the supervisor's
        stall classification observable from user code: a growing
        progress age with a live trainer is exactly the feeder-stall /
        ring-wedge signature supervisor.py keys on. Schema is pinned by
        tests/test_datafeed.py::test_stats_schema.
        """
        now = time.monotonic()
        counts = self._counts.snapshot()["counts"]
        out = {"records": counts.get("records", 0),
               "chunks": counts.get("chunks", 0),
               "wait_s": self._wait_s,
               "staging_alloc": counts.get("staging_alloc", 0),
               "staging_reuse": counts.get("staging_reuse", 0)}
        out["stages"] = self.timers.snapshot()
        out["batches"] = counts.get("batches", 0)
        out["heartbeat_age_s"] = None if self._hb_at is None \
            else now - self._hb_at
        out["last_progress_age_s"] = None if self._last_progress is None \
            else now - self._last_progress
        return out

    def should_stop(self):
        """True once the feed has ended (reference: ``DataFeed.should_stop``)."""
        return self.done_feeding and not self._pending and not self._backlog

    def batch_results(self, results):
        """Push a batch of inference results to the output queue.

        Reference: ``DataFeed.batch_results``. The node runtime counts
        records in vs. records out per partition, so results must be pushed
        1:1 with consumed records (order preserved).
        """
        if self._queue_out is None:
            raise RuntimeError("batch_results() requires train_mode=False")
        self._queue_out.put(list(results), block=True)

    def terminate(self):
        """Signal termination and drain the input queue so feeders unblock.

        Reference: ``DataFeed.terminate`` — sets state='terminating' and
        consumes (with ``task_done``) whatever the feeders already queued.
        """
        logger.info("DataFeed terminating: draining input feed")
        self.mgr.set("state", "terminating")
        self.done_feeding = True
        if not self._metrics_flushed:
            # a terminated feed never reaches the end-of-feed flush in
            # next_batch — publish what it measured before draining
            self._metrics_flushed = True
            self._publish_metrics()
        # Free any zero-copy slots first: draining reads the ring at the
        # tail, which the held slots pin — and a terminated feed will
        # never gather them out.
        for seg in self._pending + self._backlog:
            if isinstance(seg, _RingSegment):
                seg.slot.drop()
        self._pending = []
        self._backlog = []
        if self._queue_in is not None and self._unpacked:
            # discarded pieces of a coalesced queue item: settle its one
            # owed task_done so the feeder's join can still drain
            self._unpacked = 0
            self._queue_in.task_done()
        import queue as _queue
        count = 0
        if self._ring is not None:
            while self._ring.read(timeout=1.0) is not None:
                count += 1
        else:
            while True:
                try:
                    self._queue_in.get(block=True, timeout=1.0)
                    self._queue_in.task_done()
                    count += 1
                except _queue.Empty:
                    break
        logger.info("DataFeed terminate drained %d items", count)
