"""Goodput plane: badput-attributed wall time — the port's copy of
``tensorflowonspark_tpu/goodput.py``.

The north star is "as fast as the hardware allows" — but throughput
numbers alone cannot say what fraction of a supervised, elastic job's
wall time was actually PRODUCTIVE. This module makes every non-step
second visible, MLPerf-goodput style:

- :class:`GoodputLedger` — classifies every second of a process's wall
  time into ``productive_step`` vs a badput taxonomy (:data:`BADPUT`:
  ``compile`` / ``checkpoint_save`` / ``restore`` / ``reform`` /
  ``resize_drain`` / ``feed_wait`` / ``idle``). The mechanism is a
  charge stack: every instant belongs to exactly one category (the
  innermost open interval, or ``idle`` when none is open), so the
  categories sum to wall time BY CONSTRUCTION — the invariant the
  chaos e2e pins within tolerance. Hooks live at the already-
  instrumented sites: the trainer step loop (``training.Trainer.
  train_loop``), ``checkpoint.Checkpointer.save``/``restore``,
  ``DataFeed``'s blocked transport reads, and the SupervisedCluster's
  recovery/resize timeline.
- :func:`ledger` — the process-global ledger every framework hook
  charges by default (the ``tracing.flight_recorder()`` idiom), so a
  map_fun gets goodput accounting with ZERO caller changes: the
  trainer-side ledger registers into the DataFeed's MetricsRegistry
  and its snapshot rides the existing BEAT lease to the driver.
- :class:`StragglerDetector` — driver-side skew watch over the
  BEAT-carried per-executor step-time EWMAs: an executor whose
  effective step time (EWMA, or its stalled-progress age when the
  step counter freezes) exceeds ``skew_threshold`` x the fleet median
  raises an OBSERVE-ONLY ``straggler`` incident through the
  Supervisor (recovery policies never see it — skew is a signal, not
  a failure).
- :func:`job_report` — the driver-side composition: a supervised
  job's own ledger (reform / resize_drain — the windows no trainer
  exists to measure) folded with the merged executor snapshots
  accumulated across attempts, against the job's wall clock.

Exposition (families cataloged in ``tracing.METRIC_FAMILIES``):
``tfos_badput_seconds{stage=<category>}`` (+``_samples``),
``tfos_goodput_productive_seconds`` / ``tfos_goodput_steps``,
``tfos_goodput_ratio`` / ``tfos_goodput_step_ewma_seconds`` gauges,
and the driver-rendered ``tfos_train_step_skew{executor=}``.

Import discipline: pure python, no torch/numpy — safe in driver
processes that must not initialize a device backend.
"""

import logging
import threading
import time

from tensorflowonspark_tpu_torch import tracing

logger = logging.getLogger(__name__)

#: the badput taxonomy (everything that is not a productive step);
#: ``idle`` is the residual category — wall time no hook claimed
BADPUT = ("compile", "checkpoint_save", "restore", "reform",
          "resize_drain", "feed_wait", "idle")

#: the productive category (the goodput numerator)
PRODUCTIVE = "productive_step"

#: every category a ledger can report
CATEGORIES = (PRODUCTIVE,) + BADPUT

#: EWMA weight for the per-step wall-time estimate the straggler
#: detector compares across the fleet
STEP_EWMA_ALPHA = 0.2

#: flight-recorder spans shorter than this are not emitted (a 50us
#: feed poll must not flood the ring the serving plane shares)
MIN_SPAN_S = 1e-3


class GoodputLedger(object):
    """Charge-stack wall-time classifier.

    Every instant is charged to exactly one category: the innermost
    open interval's, or ``idle`` when none is open. ``enter``/``exit``
    (or the :meth:`track` context manager) open/close intervals;
    nesting attributes time to the innermost category only — a
    checkpoint save inside a step envelope is ``checkpoint_save``, not
    double-counted. Because charging happens at every transition and
    the categories partition the timeline, ``sum(categories) ==
    wall_s`` exactly (modulo float addition error) — the invariant
    :meth:`report` exposes and the chaos e2e pins.

    Thread-safe: the trainer thread, the feed consumer, and a driver's
    supervisor loop may all charge one ledger (a lock guards the
    stack; charges are O(1)). Exposition: :meth:`register` adds the
    ledger to a ``tracing.MetricsRegistry`` — badput categories as the
    ``tfos_badput`` stage-labeled timer families, productive time and
    the ratio/EWMA gauges under the ``tfos_goodput`` counter prefix —
    with a registry hook refreshing the open interval at snapshot
    time, so a BEAT-carried snapshot is current, not
    last-transition-stale.

    ``flight``: a ``tracing.FlightRecorder`` to mirror closed
    intervals into as named spans (>= :data:`MIN_SPAN_S` only), giving
    ``scripts/trace_dump.py`` a training-run timeline; defaults to the
    process-global recorder, pass ``flight=False`` to disable.
    """

    def __init__(self, clock=time.monotonic, flight=None):
        self._clock = clock
        self._lock = threading.Lock()
        #: badput accumulators (stage-labeled timer families)
        self.timers = tracing.StageTimers()
        #: productive seconds + steps, ratio / step-EWMA gauges
        self.counters = tracing.Counters()
        self._stack = []            # open (category, entered_at)
        self._t0 = clock()
        self._mark = self._t0       # last charge instant
        self._step_ewma = None
        self._steps = 0
        self._compile_claimed = False  # exactly ONE compile step span
        if flight is False:
            self._flight = None
        else:
            self._flight = flight if flight is not None \
                else tracing.flight_recorder()

    # -- charging ---------------------------------------------------------

    def _charge_locked(self, now):
        """Charge [_mark, now] to the current innermost category."""
        dt = now - self._mark
        if dt <= 0:
            return
        category = self._stack[-1][0] if self._stack else "idle"
        if category == PRODUCTIVE:
            self.counters.inc("productive_seconds", dt)
        else:
            self.timers.add(category, dt)
        self._mark = now

    def enter(self, category):
        """Open a ``category`` interval (innermost-wins nesting)."""
        now = self._clock()
        with self._lock:
            self._charge_locked(now)
            self._stack.append((category, now))

    def exit(self):
        """Close the innermost interval (no-op on an empty stack)."""
        now = self._clock()
        with self._lock:
            self._charge_locked(now)
            if not self._stack:
                return
            category, entered = self._stack.pop()
        if self._flight is not None and now - entered >= MIN_SPAN_S:
            self._flight.span(category, entered, now)

    def track(self, category):
        """``with ledger.track("checkpoint_save"):`` — scoped charge."""
        return _Tracked(self, category)

    def note_step(self, seconds, compile_step=False, end=None):
        """Account one training step that JUST finished: the trailing
        ``seconds`` of wall time become ``productive_step`` (or
        ``compile`` for a step known to have traced+compiled — the
        loop's first), and the step-time EWMA the straggler detector
        compares across the fleet advances. The window is CONSUMED
        from the charge machine (it ends at ``end``/now), so the
        residual accounting cannot also claim it as idle; any portion
        an inner hook already charged (a feed wait inside the step
        window) stays with that category — innermost wins, exactly as
        for nested intervals. The EWMA deliberately EXCLUDES compile
        steps: a one-off 30s trace must not dominate the skew signal
        for the next hundred steps."""
        seconds = float(seconds)
        now = self._clock() if end is None else end
        start = now - seconds
        with self._lock:
            if start > self._mark:
                # the gap before the step belongs to whatever category
                # was current (usually idle)
                self._charge_locked(start)
            dt = now - self._mark
            if dt > 0:
                if compile_step:
                    self.timers.add("compile", dt)
                else:
                    self.counters.inc("productive_seconds", dt)
                self._mark = now
            self._account_step_locked(seconds, compile_step)
        self._step_flight(compile_step, start, now)

    def _account_step_locked(self, seconds, compile_step):
        """steps counter + EWMA + gauge refresh for one finished step
        (lock held) — the ONE copy :meth:`note_step` and
        :meth:`step_span` share. The EWMA deliberately excludes
        compile steps."""
        if not compile_step:
            self.counters.inc("steps")
            self._steps += 1
            self._step_ewma = seconds if self._step_ewma is None \
                else STEP_EWMA_ALPHA * seconds \
                + (1.0 - STEP_EWMA_ALPHA) * self._step_ewma
        self._refresh_gauges_locked()

    def _step_flight(self, compile_step, start, end):
        """Mirror one finished step into the flight recorder. Steps
        are the timeline's headline spans: no MIN_SPAN_S filter (the
        ring is bounded either way — churn evicts, and eviction is
        itself exported as spans_dropped)."""
        if self._flight is not None:
            self._flight.span("compile" if compile_step
                              else "train_step", start, end,
                              step=self._steps)

    def step_span(self, first_is_compile=True):
        """``with ledger.step_span():`` — a stack interval charged as
        ``productive_step`` (the train_loop hook; the FIRST span of a
        ledger's life is the ``compile`` step when
        ``first_is_compile``). Inner hooks (a checkpoint save, a feed
        wait) nest innermost-wins on top of it, and the step's EWMA
        advances by the whole span's wall time on close."""
        return _StepSpan(self, first_is_compile)

    # -- reading ----------------------------------------------------------

    def refresh(self):
        """Charge the open interval up to now (keeps snapshots and the
        ratio gauge current without a category transition)."""
        now = self._clock()
        with self._lock:
            self._charge_locked(now)
            self._refresh_gauges_locked()

    def _refresh_gauges_locked(self):
        wall = max(self._mark - self._t0, 1e-12)
        productive = self.counters.get("productive_seconds")
        self.counters.gauge("ratio", round(productive / wall, 6))
        # the ledger's own measured wall rides the snapshot so any
        # reader can verify the sum-to-wall invariant against the
        # SAME atomically-published numbers (categories and wall are
        # refreshed together, under one lock)
        self.counters.gauge("wall_seconds", round(wall, 6))
        if self._step_ewma is not None:
            self.counters.gauge("step_ewma_seconds",
                                round(self._step_ewma, 6))

    @property
    def step_ewma_s(self):
        with self._lock:
            return self._step_ewma

    def wall_s(self):
        return self._clock() - self._t0

    def categories(self):
        """{category: seconds}, charged to now (zero-filled over
        :data:`CATEGORIES`; idle includes the residual)."""
        self.refresh()
        with self._lock:
            out = {c: 0.0 for c in CATEGORIES}
            out.update(self.timers.snapshot())
            out[PRODUCTIVE] = self.counters.get("productive_seconds")
            return out

    def report(self):
        """{wall_s, goodput_ratio, productive_s, badput: {category:
        s}, steps, step_ewma_s, unaccounted_s}. ``unaccounted_s`` is
        wall minus every category — ~0 by construction (the pinned
        invariant); a large value means a hook pair is unbalanced."""
        cats = self.categories()
        with self._lock:
            wall = self._mark - self._t0
            steps = self._steps
            ewma = self._step_ewma
        productive = cats[PRODUCTIVE]
        badput = {c: round(cats[c], 6) for c in BADPUT}
        accounted = productive + sum(cats[c] for c in BADPUT)
        return {
            "wall_s": round(wall, 6),
            "productive_s": round(productive, 6),
            "goodput_ratio": round(productive / wall, 6) if wall > 0
            else 0.0,
            "badput": badput,
            "steps": steps,
            "step_ewma_s": None if ewma is None else round(ewma, 6),
            "unaccounted_s": round(wall - accounted, 6),
        }

    def register(self, registry):
        """Expose this ledger through ``registry``: ``tfos_badput``
        stage-labeled timers, ``tfos_goodput`` counters/gauges, and a
        snapshot hook keeping the open interval + ratio current (so
        the BEAT-piggybacked snapshot the DataFeed publishes carries
        up-to-the-beat accounting). Idempotent per registry."""
        registry.add_timers("tfos_badput", self.timers)
        registry.add_counters("tfos_goodput", self.counters)
        registry.add_hook(self.refresh)
        return self


class _Tracked(object):
    __slots__ = ("_ledger", "_category")

    def __init__(self, ledger, category):
        self._ledger = ledger
        self._category = category

    def __enter__(self):
        self._ledger.enter(self._category)
        return self

    def __exit__(self, *exc):
        self._ledger.exit()


class _StepSpan(object):
    __slots__ = ("_ledger", "_first_is_compile", "_t0", "_compile")

    def __init__(self, ledger, first_is_compile):
        self._ledger = ledger
        self._first_is_compile = first_is_compile

    def __enter__(self):
        # a REAL stack interval (not a note_step window): an inner
        # hook opening mid-step (a checkpoint save, a feed wait) must
        # find the step category underneath it, so the compute BEFORE
        # the inner interval stays productive — with a detached window
        # that leading compute would charge to idle at the inner
        # enter()'s transition. The is-this-the-compile-step check and
        # the stack push happen under ONE lock hold: an unlocked
        # check-then-act would let two concurrent first spans both read
        # "no step yet" and both charge as compile (the ledger's
        # documented multi-thread charging contract)
        ledger = self._ledger
        now = ledger._clock()
        with ledger._lock:
            # the claim flag (not the timers) is what makes this
            # exactly-once: two spans OPEN concurrently before either
            # charges, so "compile not yet in timers" alone would let
            # both read as the compile step
            self._compile = self._first_is_compile \
                and not ledger._compile_claimed \
                and ledger._steps == 0 \
                and "compile" not in ledger.timers.snapshot()
            if self._compile:
                ledger._compile_claimed = True
            ledger._charge_locked(now)
            ledger._stack.append(
                ("compile" if self._compile else PRODUCTIVE, now))
        self._t0 = now
        return self

    def __exit__(self, *exc):
        ledger = self._ledger
        now = ledger._clock()
        # the EWMA advances by the WHOLE span wall time (the step took
        # this long, inner charges notwithstanding — that is the skew
        # signal)
        with ledger._lock:
            ledger._charge_locked(now)
            if ledger._stack:
                ledger._stack.pop()
            ledger._account_step_locked(now - self._t0, self._compile)
        ledger._step_flight(self._compile, self._t0, now)


# -- process-global ledger --------------------------------------------------

_LEDGER = None
_LEDGER_LOCK = threading.Lock()


def ledger():
    """The process-global :class:`GoodputLedger` every framework hook
    charges by default (one trainer process == one ledger — trainers
    are child processes, so each attempt starts a fresh one)."""
    global _LEDGER
    with _LEDGER_LOCK:
        if _LEDGER is None:
            _LEDGER = GoodputLedger()
        return _LEDGER


def reset():
    """Discard the process-global ledger (tests; a fresh one is built
    on the next :func:`ledger` call, re-basing its wall clock)."""
    global _LEDGER
    with _LEDGER_LOCK:
        _LEDGER = None


# -- driver-side skew -------------------------------------------------------

def _gauges_of(view):
    """The tfos_goodput gauge dict carried by a per-executor metrics
    snapshot (empty when the executor publishes no ledger)."""
    metrics = view.get("metrics") or {}
    counters = (metrics.get("counters") or {}).get("tfos_goodput") or {}
    return counters.get("gauges") or {}


def _median(values):
    """LOWER median: with an even count (the 2-executor fleet), the
    baseline must be the healthy half — the upper median IS the
    straggler there, and skew against itself would never fire."""
    values = sorted(values)
    return values[(len(values) - 1) // 2] if values else None


def step_skew(per_executor):
    """Pure per-executor skew from BEAT-carried step-time EWMAs:
    {eid: ewma / fleet_median}. Executors without an EWMA (no steps
    yet) are omitted; a single-executor fleet has skew 1.0 by
    definition. The ``tfos_train_step_skew{executor=}`` gauge the
    driver's /metrics renders."""
    ewmas = {}
    for eid, view in per_executor.items():
        ewma = _gauges_of(view).get("step_ewma_seconds")
        if ewma:
            ewmas[eid] = float(ewma)
    med = _median(list(ewmas.values()))
    if not med:
        return {}
    return {eid: round(e / med, 4) for eid, e in ewmas.items()}


def attach_step_skew(per_executor):
    """Annotate a ``Server.metrics_snapshot()`` view in place with
    ``step_skew`` per executor (where computable) and return it — the
    driver stats endpoint's render path."""
    for eid, skew in step_skew(per_executor).items():
        per_executor[eid]["step_skew"] = skew
    return per_executor


def skew_rows(per_executor):
    """Straggler-table rows ``[{executor, skew, step_ewma_s}]`` out of
    skew-annotated per-executor views (``cluster.metrics()``'s
    ``executors`` map / a driver ``/stats`` document's) — the shape
    ``metrics_report.format_straggler_table`` renders; executors with
    no computable skew (no steps yet) are omitted."""
    rows = []
    for eid, view in (per_executor or {}).items():
        skew = view.get("step_skew")
        if skew is None:
            continue
        rows.append({"executor": eid, "skew": skew,
                     "step_ewma_s":
                     _gauges_of(view).get("step_ewma_seconds")})
    return rows


class StragglerDetector(object):
    """Driver-side skew watch over the fleet's step-time signals.

    Two signatures, one verdict:

    - a SLOW executor: its BEAT-carried step-time EWMA exceeds
      ``skew_threshold`` x the fleet median;
    - a STALLED executor: its ``train_step`` counter stopped advancing
      — the EWMA freezes at its last healthy value, so the detector
      substitutes the stall age (seconds since the step last moved,
      tracked here) once it exceeds the median step time. This is what
      makes an injected feed stall fire the incident deterministically
      (the executor keeps beating; nothing else is wrong with it).

    Observe-only by contract: :meth:`observe` RETURNS findings; the
    Supervisor records them as ``straggler`` incidents with evidence
    but never feeds them to a recovery policy — skew is a capacity
    signal (deal with the slow host), not a failure. One report per
    executor per episode: a straggler that recovers below threshold
    re-arms.
    """

    def __init__(self, skew_threshold=3.0, min_executors=2,
                 min_stall_s=5.0, clock=time.monotonic):
        self.skew_threshold = float(skew_threshold)
        self.min_executors = int(min_executors)
        #: stall ages below this never substitute for the EWMA — a
        #: short legitimate pause (a checkpoint save, a slow batch)
        #: must not read as a stall on a fleet with sub-second steps
        self.min_stall_s = float(min_stall_s)
        self._clock = clock
        self._progress = {}   # eid -> (last train_step, t of change)
        self._flagged = set()

    def observe(self, per_executor, now=None):
        """One detection pass over ``Server.metrics_snapshot()``-shaped
        views; returns [{executor_id, skew, effective_s, median_s,
        stalled}] for NEWLY flagged stragglers."""
        now = now if now is not None else self._clock()
        effective = {}
        for eid, view in per_executor.items():
            ewma = _gauges_of(view).get("step_ewma_seconds")
            step = view.get("train_step")
            if step is not None:
                prev = self._progress.get(eid)
                if prev is None or prev[0] != step:
                    self._progress[eid] = (step, now)
            if not ewma:
                continue
            ewma = float(ewma)
            eff, stalled = ewma, False
            prev = self._progress.get(eid)
            if prev is not None:
                stall_age = now - prev[1]
                if stall_age > max(ewma, self.min_stall_s):
                    eff, stalled = stall_age, True
            effective[eid] = (eff, stalled)
        if len(effective) < self.min_executors:
            return []
        med = _median([e for e, _ in effective.values()])
        if not med:
            return []
        found = []
        for eid, (eff, stalled) in effective.items():
            skew = eff / med
            if skew >= self.skew_threshold:
                if eid not in self._flagged:
                    self._flagged.add(eid)
                    found.append({"executor_id": eid,
                                  "skew": round(skew, 3),
                                  "effective_s": round(eff, 6),
                                  "median_s": round(med, 6),
                                  "stalled": stalled})
            else:
                self._flagged.discard(eid)  # recovered: re-arm
        return found


# -- job-level composition --------------------------------------------------

def merged_categories(merged_snapshot):
    """{category: seconds} out of a merged executor registry snapshot
    (``tracing.merge_snapshots`` output): the ``tfos_badput`` timer
    totals plus the ``tfos_goodput`` productive counter."""
    out = {c: 0.0 for c in CATEGORIES}
    if not merged_snapshot:
        return out
    timers = (merged_snapshot.get("timers") or {}).get("tfos_badput") \
        or {}
    for category, seconds in (timers.get("t") or {}).items():
        out[category] = out.get(category, 0.0) + float(seconds)
    counters = (merged_snapshot.get("counters") or {}) \
        .get("tfos_goodput") or {}
    out[PRODUCTIVE] += float(
        (counters.get("counts") or {}).get("productive_seconds", 0.0))
    return out


def job_report(wall_s, driver_ledger=None, merged_snapshots=(),
               width=1):
    """Fold a job's accounting into one report against ITS wall clock.

    ``merged_snapshots``: the per-attempt merged executor snapshots
    (each attempt's trainers run a fresh process-global ledger; their
    categories SUM across attempts). ``driver_ledger``: the
    SupervisedCluster's own ledger — it charges only the windows no
    trainer exists to measure (``reform`` between attempts,
    ``resize_drain`` teardown), so executor and driver categories
    never overlap-count by construction; its idle (attempts running)
    is dropped in favor of the executors' own accounting.

    ``width``: executor seconds are divided by the width so the report
    stays in JOB wall-clock units (N executors each productive for the
    whole window == ratio 1.0, not N). The residual lands in ``idle``;
    ``unaccounted_s`` keeps the signed raw gap for the invariant pin.

    Accounting bound, stated honestly: the driver's reform window and
    a new trainer's ledger OVERLAP for the tail of each formation (the
    trainer process is up and its ledger ticking idle while the driver
    still waits out the barrier), so those seconds can count twice —
    once as driver ``reform``, once as executor ``idle``. The
    over-count is bounded by (formations x trainer-bootstrap-inside-
    barrier) and surfaces as a NEGATIVE ``unaccounted_s`` (the idle
    row's ``max(residual, 0)`` floor never hides the sign) — the chaos
    e2e pins it within the 2% tolerance; jobs with pathologically slow
    formations should read ``unaccounted_s`` before trusting ``idle``.
    """
    wall_s = float(wall_s)
    cats = {c: 0.0 for c in CATEGORIES}
    for snap in merged_snapshots:
        for category, seconds in merged_categories(snap).items():
            cats[category] = cats.get(category, 0.0) + seconds
    scale = 1.0 / max(int(width), 1)
    cats = {c: s * scale for c, s in cats.items()}
    exec_idle = cats.pop("idle", 0.0)
    if driver_ledger is not None:
        driver = driver_ledger.categories()
        for category in ("reform", "resize_drain"):
            cats[category] = cats.get(category, 0.0) \
                + driver.get(category, 0.0)
    productive = cats.get(PRODUCTIVE, 0.0)
    accounted = sum(cats.values()) + exec_idle
    residual = wall_s - accounted
    badput = {c: round(cats.get(c, 0.0), 6) for c in BADPUT
              if c != "idle"}
    badput["idle"] = round(exec_idle + max(residual, 0.0), 6)
    return {
        "wall_s": round(wall_s, 6),
        "productive_s": round(productive, 6),
        "goodput_ratio": round(productive / wall_s, 6)
        if wall_s > 0 else 0.0,
        "badput": badput,
        "unaccounted_s": round(residual, 6),
    }
