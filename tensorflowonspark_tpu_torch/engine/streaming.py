"""Micro-batch streaming: the Spark Streaming DStream analog — the port's
copy of ``tensorflowonspark_tpu/engine/streaming.py``.

Reference capability (SURVEY.md §2 Cluster API row): ``TFCluster.run``
"also supports Spark Streaming DStreams" — continuous feeding where each
micro-batch RDD is pushed through the same queue plane, and
``shutdown(ssc)`` stops the stream first (§3.5).

Shape kept deliberately Spark-like::

    ssc = StreamingContext(sc, batch_interval=1.0)
    stream = ssc.queueStream(rdd_queue)        # or .textFileStream(dir)
    tfc.train(stream)                          # foreachRDD per interval
    ssc.start(); ...; tfc.shutdown(ssc)

One driver thread (``streaming-loop``) polls every stream once an
interval and runs the registered actions on what it found; ``stop``
joins it, drains what is still queued and re-raises a loop error.
"""

import logging
import os
import queue as _queue
import threading
import time

logger = logging.getLogger(__name__)


class DStream(object):
    """A stream of RDDs delivered to registered callbacks per interval."""

    def __init__(self, ssc):
        self.ssc = ssc
        self._actions = []

    def foreachRDD(self, fn):
        """Register ``fn(rdd)`` to run on every micro-batch."""
        self._actions.append(fn)
        return self

    def _dispatch(self, rdd):
        for fn in self._actions:
            fn(rdd)


class _QueueStream(DStream):
    def __init__(self, ssc, rdd_queue):
        super(_QueueStream, self).__init__(ssc)
        self._queue = rdd_queue

    def _poll(self):
        try:
            return self._queue.get_nowait()
        except _queue.Empty:
            return None


class _TextFileStream(DStream):
    """Watches a directory; new files become line-RDDs (one per batch)."""

    def __init__(self, ssc, directory, num_slices=None):
        super(_TextFileStream, self).__init__(ssc)
        self.directory = directory
        self.num_slices = num_slices
        self._seen = set(os.listdir(directory)) if os.path.isdir(directory) \
            else set()

    def _poll(self):
        if not os.path.isdir(self.directory):
            return None
        # Hidden files are invisible, exactly as Spark's textFileStream
        # treats them: writers land data atomically by writing
        # ".name.tmp" in place then renaming — a poll must never read a
        # half-written file.
        new = sorted(n for n in
                     set(os.listdir(self.directory)) - self._seen
                     if not n.startswith("."))
        if not new:
            return None
        self._seen.update(new)
        lines = []
        for name in new:
            with open(os.path.join(self.directory, name)) as f:
                lines.extend(f.read().splitlines())
        return self.ssc.sc.parallelize(lines, self.num_slices)


class StreamingContext(object):
    """Driver-side micro-batch scheduler over the engine context."""

    def __init__(self, sc, batch_interval=1.0):
        self.sc = sc
        self.batch_interval = batch_interval
        self._streams = []
        self._thread = None
        self._stop = threading.Event()
        self._error = None

    def queueStream(self, rdds):
        """Stream draining a queue.Queue of RDDs (or a prefilled list)."""
        q = rdds
        if isinstance(rdds, (list, tuple)):
            q = _queue.Queue()
            for r in rdds:
                q.put(r)
        stream = _QueueStream(self, q)
        self._streams.append(stream)
        return stream

    def textFileStream(self, directory, num_slices=None):
        """Stream of the lines of each new (non-hidden) file landing in
        ``directory``, one RDD of ``num_slices`` partitions a poll."""
        stream = _TextFileStream(self, directory, num_slices)
        self._streams.append(stream)
        return stream

    def start(self):
        def _loop():
            try:
                while not self._stop.is_set():
                    t0 = time.monotonic()
                    for stream in self._streams:
                        rdd = stream._poll()
                        if rdd is not None:
                            stream._dispatch(rdd)
                    left = self.batch_interval - (time.monotonic() - t0)
                    if left > 0:
                        self._stop.wait(left)
            except BaseException as e:  # noqa: BLE001 - surfaced on stop
                logger.error("streaming loop failed", exc_info=True)
                self._error = e

        self._thread = threading.Thread(target=_loop, name="streaming-loop",
                                        daemon=True)
        self._thread.start()

    def awaitTermination(self, timeout=None):
        self._thread.join(timeout)

    def stop(self, drain=True):
        """Stop the loop; with ``drain`` run one final poll so queued
        micro-batches aren't dropped. Re-raises a loop error if one hit."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if drain and self._error is None:
            for stream in self._streams:
                while True:
                    rdd = stream._poll()
                    if rdd is None:
                        break
                    stream._dispatch(rdd)
        if self._error is not None:
            raise RuntimeError("streaming loop failed") from self._error
