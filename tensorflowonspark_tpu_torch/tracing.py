"""Serving instrumentation the port's engine uses — the port's own copy
of ``StageTimers``, ``Counters`` and ``Histogram`` from
``tensorflowonspark_tpu/tracing.py`` (stdlib only).

- :class:`StageTimers` answers "where did the time go": named
  wall-clock accumulators (``prefill``, ``decode_step``,
  ``block_alloc``, ``prefix_lookup``, ``host_schedule``).
- :class:`Counters` answers "what did the loop do": monotonic counts
  (tokens, prefills, preemptions, prefix hits) and gauges (queue
  depth, slot occupancy, free KV blocks).
- :class:`Histogram` carries latency distributions (TTFT, per-token
  latency, decode step, queue wait, request) with ``quantile(q)``.

All three follow the single-writer convention: the engine's scheduler
thread writes, readers take copies; the unlocked dict and int updates
are benign under the GIL.
"""

import math
import time


class StageTimers(object):
    """Named wall-clock accumulators: one entry per pipeline stage."""

    __slots__ = ("_t", "_n")

    def __init__(self):
        self._t = {}
        self._n = {}

    def add(self, stage, seconds):
        """Accumulate one sample for ``stage``."""
        self._t[stage] = self._t.get(stage, 0.0) + seconds
        self._n[stage] = self._n.get(stage, 0) + 1

    def timed(self, stage):
        """``with timers.timed("decode_step"):`` — context-manager
        sampling."""
        return _StageSpan(self, stage)

    def snapshot(self):
        """{stage: {"seconds": total, "samples": count}}."""
        return {k: {"seconds": v, "samples": self._n[k]}
                for k, v in self._t.items()}


class _StageSpan(object):
    __slots__ = ("_timers", "_stage", "_t0")

    def __init__(self, timers, stage):
        self._timers = timers
        self._stage = stage

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._timers.add(self._stage, time.monotonic() - self._t0)


class Counters(object):
    """Named monotonic counters + gauges for a scheduler loop."""

    __slots__ = ("_counts", "_gauges")

    def __init__(self):
        self._counts = {}
        self._gauges = {}

    def inc(self, name, n=1):
        """Add ``n`` to monotonic counter ``name``."""
        self._counts[name] = self._counts.get(name, 0) + n

    def gauge(self, name, value):
        """Set instantaneous gauge ``name``."""
        self._gauges[name] = value

    def snapshot(self):
        """{"counts": {...}, "gauges": {...}} — stable copies."""
        return {"counts": dict(self._counts), "gauges": dict(self._gauges)}


class Histogram(object):
    """Fixed log-bucket latency histogram with ``quantile(q)``.

    Bounds ``lo * growth**i`` plus a +Inf overflow bucket, so the
    relative quantile error is bounded by ``growth`` across the whole
    range; exact ``min``/``max`` are kept so clamped tails report
    honestly."""

    __slots__ = ("lo", "growth", "_bounds", "_counts", "_n", "_min", "_max")

    def __init__(self, lo=1e-4, hi=3600.0, growth=math.sqrt(2.0)):
        self.lo = float(lo)
        self.growth = float(growth)
        n = int(math.ceil(math.log(float(hi) / self.lo)
                          / math.log(self.growth))) + 1
        self._bounds = [self.lo * self.growth ** i for i in range(n)]
        self._counts = [0] * (n + 1)
        self._n = 0
        self._min = None
        self._max = None

    def observe(self, value):
        """Record one sample (seconds)."""
        value = float(value)
        self._n += 1
        if self._min is None or value < self._min:
            self._min = value
        if self._max is None or value > self._max:
            self._max = value
        if value <= self._bounds[0]:
            i = 0
        elif value > self._bounds[-1]:
            i = len(self._counts) - 1
        else:
            i = int(math.log(value / self.lo) / math.log(self.growth))
            i = max(0, min(i, len(self._bounds) - 1))
            while self._bounds[i] < value:
                i += 1
        self._counts[i] += 1

    def quantile(self, q):
        """Approximate q-quantile (seconds); None when empty. Error is
        bounded by one bucket; clamped to the observed min/max."""
        if not self._n:
            return None
        q = float(q)
        if q <= 0.0:
            return self._min
        if q >= 1.0:
            return self._max
        rank = max(1, int(math.ceil(q * self._n)))
        cum = 0
        for i, c in enumerate(self._counts):
            if not c:
                continue
            if cum + c >= rank:
                if i == len(self._bounds):
                    value = self._max
                else:
                    upper = self._bounds[i]
                    lower = upper / self.growth
                    value = lower * self.growth ** ((rank - cum) / float(c))
                return min(max(value, self._min), self._max)
            cum += c
        return self._max
