"""Serving SLO plane: burn-rate alerts, synthetic canaries, attribution
— the port's copy of ``tensorflowonspark_tpu/slo.py`` (stdlib plus the
port's own ``qos`` and ``tracing``).

This module is the serving-side analog of the training goodput ledger:
it turns the raw metric families the fleet already exports into an
*opinion* — are we meeting our objectives, how fast are we spending the
error budget, and where did THIS request's wall-clock go.

Three cooperating pieces, each pure where it matters:

``SloSpec`` / ``BurnRateAlerts``
    Declarative per-tenant objectives (TTFT p99, per-token p99,
    availability) evaluated with the multi-window multi-burn-rate
    recipe: an alert fires only when BOTH the short and the long window
    of a pair burn faster than the pair's threshold, and clears when
    the short windows recover.  Time is an argument everywhere, so the
    whole engine is table-testable with synthetic clocks.

``CanaryProber``
    A driver-side loop issuing deterministic temp=0 probes through the
    REAL router path as a reserved low-priority tenant
    (:data:`CANARY_TENANT`).  The QoS plane guarantees the canary never
    displaces real traffic; the first successful probe pins the
    expected token ids, and any later divergence is a bitwise
    correctness alert — the one signal no latency histogram can carry.

``attribute_intervals`` / ``attribute_trace``
    Per-request critical-path attribution: classify every wall-clock
    second of a request into one of :data:`STAGES` from its
    FlightRecorder span tree.  The sweep partitions the base span with
    innermost-wins precedence, so the stage seconds sum to the wall
    by construction rather than by luck.

``SloMonitor`` glues the pure pieces to a live router (the port's
``fleet.FleetRouter`` builds one; any object with the router's read
surface serves):
sampling SLIs from the router's own histograms (router-observed wall,
which *includes* network grayness the engines cannot see), from merged
replica beat snapshots, and from per-tenant dispatch tallies, then
rendering ``tfos_slo_*`` metric lines and the ``GET /slo`` verdict.
Evaluation is scrape-driven (the Prometheus pull model): there is no
extra thread on the router.
"""

import collections
import json
import threading
import time
import urllib.error
import urllib.request

from tensorflowonspark_tpu_torch import qos, tracing

__all__ = [
    "CANARY_TENANT", "DEFAULT_SPECS", "DEFAULT_WINDOWS", "STAGES",
    "SloSpec", "parse_specs", "SliSeries", "latency_good_total",
    "BurnRateAlerts", "attribute_intervals", "attribute_trace",
    "CanaryProber", "SloMonitor",
]

# Reserved tenant for synthetic probes — defined in the QoS vocabulary
# so the whole plane agrees on the name; re-exported here because the
# SLO plane is the only minter of traffic under it.
CANARY_TENANT = qos.CANARY_TENANT

# (short_window_s, long_window_s, burn_rate_threshold) pairs.  The
# classic page/ticket split: the fast pair catches a full outage in
# minutes, the slow pair catches a simmering brownout in hours.  Both
# windows of a pair must exceed the threshold for the pair to fire.
DEFAULT_WINDOWS = ((300.0, 3600.0, 14.4), (1800.0, 21600.0, 6.0))

# Declarative defaults: availability on the router's own request tally
# (quota 429s excluded as policy-not-failure), latency objectives on
# the engine-side serving histograms carried by replica beats.
DEFAULT_SPECS = (
    "name=availability,kind=availability,family=tfos_fleet_requests,"
    "objective=0.999",
    "name=ttft_p99,kind=latency,family=tfos_serving_ttft_seconds,"
    "threshold=1.0,objective=0.99",
    "name=token_p99,kind=latency,family=tfos_serving_token_latency_seconds,"
    "threshold=0.25,objective=0.99",
)

_KINDS = ("latency", "availability")


def _parse_window_triplet(text):
    """``"300/3600/14.4"`` -> ``(300.0, 3600.0, 14.4)``."""
    parts = text.split("/")
    if len(parts) != 3:
        raise ValueError(
            "window must be short/long/burn, got {!r}".format(text))
    short_s, long_s, burn = (float(p) for p in parts)
    if short_s <= 0 or long_s <= 0 or burn <= 0:
        raise ValueError("window values must be positive: {!r}".format(text))
    if short_s >= long_s:
        raise ValueError(
            "short window must be < long window: {!r}".format(text))
    return (short_s, long_s, burn)


class SloSpec(object):
    """One declarative objective, parsed from a ``k=v,...`` string.

    Grammar (``;`` joins multiple specs in one string)::

        name=<slug>,kind=latency|availability,family=<metric family>,
        objective=<0..1>[,threshold=<seconds>][,tenant=<tenant>]
        [,fast=<short>/<long>/<burn>][,slow=<short>/<long>/<burn>]

    ``threshold`` is required for ``kind=latency`` (the "good" bound on
    the histogram); ``tenant`` defaults to the QoS default tenant and
    scopes availability tallies (latency histograms are fleet-wide).
    """

    __slots__ = ("name", "kind", "family", "objective", "threshold",
                 "tenant", "windows")

    def __init__(self, name, kind, family, objective, threshold=None,
                 tenant=None, windows=DEFAULT_WINDOWS):
        if kind not in _KINDS:
            raise ValueError("kind must be one of {}, got {!r}".format(
                _KINDS, kind))
        if not name or not isinstance(name, str):
            raise ValueError("spec needs a name")
        if not family or not str(family).startswith("tfos_"):
            raise ValueError(
                "family must be a tfos_* metric family, got {!r}".format(
                    family))
        objective = float(objective)
        if not 0.0 < objective < 1.0:
            raise ValueError(
                "objective must be in (0, 1), got {}".format(objective))
        if kind == "latency":
            if threshold is None:
                raise ValueError("latency spec needs threshold=")
            threshold = float(threshold)
            if threshold <= 0:
                raise ValueError("threshold must be positive")
        self.name = name
        self.kind = kind
        self.family = family
        self.objective = objective
        self.threshold = threshold
        self.tenant = qos.validate_tenant(tenant)
        self.windows = tuple(windows)
        if not self.windows:
            raise ValueError("spec needs at least one window pair")

    @classmethod
    def parse(cls, text):
        fields = {}
        for part in str(text).split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError("bad spec field {!r}".format(part))
            key, value = part.split("=", 1)
            fields[key.strip()] = value.strip()
        unknown = set(fields) - {"name", "kind", "family", "objective",
                                 "threshold", "tenant", "fast", "slow"}
        if unknown:
            raise ValueError("unknown spec fields: {}".format(
                ", ".join(sorted(unknown))))
        for required in ("name", "kind", "family", "objective"):
            if required not in fields:
                raise ValueError("spec missing {}=".format(required))
        fast = (_parse_window_triplet(fields["fast"])
                if "fast" in fields else DEFAULT_WINDOWS[0])
        slow = (_parse_window_triplet(fields["slow"])
                if "slow" in fields else DEFAULT_WINDOWS[1])
        return cls(name=fields["name"], kind=fields["kind"],
                   family=fields["family"],
                   objective=float(fields["objective"]),
                   threshold=(float(fields["threshold"])
                              if "threshold" in fields else None),
                   tenant=fields.get("tenant"), windows=(fast, slow))

    def to_dict(self):
        return {
            "name": self.name, "kind": self.kind, "family": self.family,
            "objective": self.objective, "threshold": self.threshold,
            "tenant": self.tenant,
            "windows": [list(w) for w in self.windows],
        }

    def __repr__(self):
        return "SloSpec({})".format(self.to_dict())


def parse_specs(specs):
    """Normalise a spec source into a list of :class:`SloSpec`.

    Accepts a ``;``-joined string, an iterable of strings and/or
    already-built :class:`SloSpec` objects, or ``None`` for
    :data:`DEFAULT_SPECS`.  Duplicate names are rejected — the name is
    the alert identity.
    """
    if specs is None:
        specs = DEFAULT_SPECS
    if isinstance(specs, str):
        specs = [s for s in specs.split(";") if s.strip()]
    out = []
    seen = set()
    for item in specs:
        spec = item if isinstance(item, SloSpec) else SloSpec.parse(item)
        if spec.name in seen:
            raise ValueError("duplicate spec name {!r}".format(spec.name))
        seen.add(spec.name)
        out.append(spec)
    return out


def latency_good_total(hist_snap, threshold_s):
    """(good, total) from a histogram wire snapshot.

    ``good`` counts samples that landed in buckets whose upper bound is
    <= ``threshold_s`` — the histogram-native reading of "requests at
    or under the objective's latency bound".  Returns ``(0, 0)`` for an
    empty or malformed snapshot.
    """
    if not hist_snap or not hist_snap.get("counts"):
        return (0, 0)
    counts = hist_snap["counts"]
    lo = float(hist_snap.get("lo", 1e-4))
    growth = float(hist_snap.get("growth", 2.0))
    total = int(hist_snap.get("n", sum(counts)))
    good = 0
    bound = lo
    # counts[0] is the underflow bucket (<= lo); the last bucket is the
    # +Inf overflow and is never "good" unless threshold is infinite.
    for i in range(len(counts) - 1):
        if bound <= threshold_s + 1e-12:
            good += int(counts[i])
        else:
            break
        bound *= growth
    return (good, total)


class SliSeries(object):
    """Windowed (good, total) deltas over timestamped cumulative samples.

    Callers feed monotonically-growing cumulative counters; the series
    answers "how many good/total landed inside the trailing W seconds"
    by differencing against the latest sample at or before ``now - W``
    (falling back to the oldest retained sample when the series is
    younger than the window — partial-window honesty rather than a
    silent zero).  Negative deltas (a replica restart reset the
    counter) clamp to re-baselining at the current sample.
    """

    __slots__ = ("_samples", "_horizon")

    def __init__(self, horizon_s=2 * 21600.0):
        self._samples = collections.deque()
        self._horizon = float(horizon_s)

    def record(self, now, good, total):
        samples = self._samples
        if samples and now < samples[-1][0]:
            return  # refuse time travel; keep the series sorted
        samples.append((float(now), int(good), int(total)))
        cutoff = now - self._horizon
        while len(samples) > 2 and samples[1][0] <= cutoff:
            samples.popleft()

    def window(self, now, window_s):
        """(good_delta, total_delta) over the trailing window, or ``None``
        when fewer than two samples exist."""
        samples = self._samples
        if len(samples) < 2:
            return None
        target = now - window_s
        baseline = samples[0]
        for sample in samples:
            if sample[0] <= target:
                baseline = sample
            else:
                break
        latest = samples[-1]
        good = latest[1] - baseline[1]
        total = latest[2] - baseline[2]
        if total < 0 or good < 0:
            return None  # counter reset mid-window; wait to re-baseline
        return (good, total)

    def burn_rate(self, now, window_s, objective):
        """error_fraction / allowed_error_fraction over the window.

        ``None`` means "cannot say" (no samples yet); a window with
        samples but zero traffic burns at 0 — an idle fleet is not an
        outage.
        """
        delta = self.window(now, window_s)
        if delta is None:
            return None
        good, total = delta
        if total <= 0:
            return 0.0
        error_fraction = (total - good) / float(total)
        return error_fraction / max(1.0 - objective, 1e-9)


class BurnRateAlerts(object):
    """Pure multi-window multi-burn-rate evaluator for a spec set.

    Drive it with ``observe(name, now, good, total)`` cumulative
    samples, then ``evaluate(now)`` to get per-spec verdicts and the
    raise/clear transitions since the previous evaluation.  The
    hysteresis is the standard one: a pair fires only when BOTH its
    windows exceed the pair's burn threshold, the alert clears only
    when every pair's SHORT window has recovered (long windows keep
    memory of the incident for hours; waiting on them would hold the
    page long after the bleeding stopped).
    """

    def __init__(self, specs=None):
        self.specs = parse_specs(specs)
        self._series = {s.name: SliSeries(
            horizon_s=2 * max(w[1] for w in s.windows))
            for s in self.specs}
        self._firing = {s.name: False for s in self.specs}
        self._alerts_total = {s.name: 0 for s in self.specs}

    def observe(self, name, now, good, total):
        self._series[name].record(now, good, total)

    def evaluate(self, now):
        """-> (verdicts, transitions).

        ``verdicts`` is one dict per spec with the per-window burn
        rates, remaining error budget (1 - slow-long-window burn,
        unclamped so an exhausted budget reads honestly negative), and
        the firing flag.  ``transitions`` lists ``("raise"|"clear",
        verdict)`` state changes.
        """
        verdicts = []
        transitions = []
        for spec in self.specs:
            series = self._series[spec.name]
            windows = []
            any_pair_firing = False
            all_short_hot = False
            for short_s, long_s, threshold in spec.windows:
                short_burn = series.burn_rate(now, short_s, spec.objective)
                long_burn = series.burn_rate(now, long_s, spec.objective)
                pair_firing = (short_burn is not None
                               and long_burn is not None
                               and short_burn > threshold
                               and long_burn > threshold)
                any_pair_firing = any_pair_firing or pair_firing
                short_hot = short_burn is not None and short_burn > threshold
                all_short_hot = all_short_hot or short_hot
                windows.append({
                    "short_s": short_s, "long_s": long_s,
                    "threshold": threshold,
                    "short_burn": short_burn, "long_burn": long_burn,
                    "firing": pair_firing,
                })
            was_firing = self._firing[spec.name]
            if not was_firing and any_pair_firing:
                firing = True
            elif was_firing and not all_short_hot:
                firing = False  # every short window recovered
            else:
                firing = was_firing
            self._firing[spec.name] = firing
            slow_long = spec.windows[-1][1]
            budget_burn = series.burn_rate(now, slow_long, spec.objective)
            budget_remaining = (None if budget_burn is None
                                else 1.0 - budget_burn)
            verdict = {
                "slo": spec.name, "kind": spec.kind, "family": spec.family,
                "tenant": spec.tenant, "objective": spec.objective,
                "threshold": spec.threshold, "windows": windows,
                "firing": firing, "alerts_total":
                    self._alerts_total[spec.name],
                "error_budget_remaining": budget_remaining,
            }
            if firing and not was_firing:
                self._alerts_total[spec.name] += 1
                verdict["alerts_total"] = self._alerts_total[spec.name]
                transitions.append(("raise", verdict))
            elif was_firing and not firing:
                transitions.append(("clear", verdict))
            verdicts.append(verdict)
        return verdicts, transitions

    def alerts_total(self):
        return dict(self._alerts_total)


# --------------------------------------------------------------------------
# Per-request critical-path attribution
# --------------------------------------------------------------------------

STAGES = ("router_overhead", "queue_wait", "admission", "prefill",
          "kv_ship", "decode", "preempted", "hedge_wait")

# span name -> (nesting level, stage).  Higher level wins when spans
# overlap (innermost-wins).  Level 2 is reserved for the synthetic
# hedge-overlap span manufactured from concurrent upstream attempts.
_SPAN_STAGES = {
    "dispatch": (0, "router_overhead"),
    "upstream": (1, "router_overhead"),
    "__hedge_overlap__": (2, "hedge_wait"),
    "request": (3, "admission"),
    "queue": (4, "queue_wait"),
    "preempted": (4, "preempted"),
    "prefill": (5, "prefill"),
    "decode": (5, "decode"),
    "decode_step": (6, "decode"),
    "kv.pack": (6, "kv_ship"),
    "kv.ship": (6, "kv_ship"),
    "kv.splice": (6, "kv_ship"),
}


def _multi_cover(intervals):
    """Regions of the number line covered by >= 2 of the intervals."""
    events = []
    for start, end in intervals:
        if end > start:
            events.append((start, 1))
            events.append((end, -1))
    events.sort()
    out = []
    depth = 0
    region_start = None
    for t, delta in events:
        prev = depth
        depth += delta
        if prev < 2 <= depth:
            region_start = t
        elif prev >= 2 > depth and region_start is not None:
            if t > region_start:
                out.append((region_start, t))
            region_start = None
    return out


def attribute_intervals(intervals):
    """Partition a request's wall-clock into :data:`STAGES` seconds.

    ``intervals`` is an iterable of ``(name, start_s, end_s)`` spans
    (absolute seconds on any common clock).  The base window is the
    widest ``dispatch`` span (router traces) or, failing that, the
    widest ``request`` span (engine-only traces); spans outside the
    base are clamped to it.  Every boundary-to-boundary segment inside
    the base is assigned to exactly one stage — the covering span with
    the highest nesting level, later start breaking level ties — so
    ``sum(stages.values()) == wall_s`` by construction.

    Returns ``{"wall_s", "t0", "t1", "stages": {stage: seconds},
    "unattributed_s"}`` (``unattributed_s`` is always 0 when a real
    base span exists, and folds the degenerate no-base case honestly).
    """
    spans = []
    upstreams = []
    for name, start, end in intervals:
        start = float(start)
        end = float(end)
        if end < start:
            start, end = end, start
        level_stage = _SPAN_STAGES.get(name)
        if level_stage is None:
            continue
        spans.append((name, level_stage[0], level_stage[1], start, end))
        if name == "upstream":
            upstreams.append((start, end))
    # Hedged requests run two upstream attempts concurrently; the
    # overlap region is time spent WAITING on the race, not router CPU.
    for start, end in _multi_cover(upstreams):
        level, stage = _SPAN_STAGES["__hedge_overlap__"]
        spans.append(("__hedge_overlap__", level, stage, start, end))
    base = None
    for base_name in ("dispatch", "request"):
        candidates = [s for s in spans if s[0] == base_name]
        if candidates:
            base = max(candidates, key=lambda s: s[4] - s[3])
            break
    stages = {stage: 0.0 for stage in STAGES}
    if base is None:
        if not spans:
            return {"wall_s": 0.0, "t0": 0.0, "t1": 0.0,
                    "stages": stages, "unattributed_s": 0.0}
        t0 = min(s[3] for s in spans)
        t1 = max(s[4] for s in spans)
    else:
        t0, t1 = base[3], base[4]
    if t1 <= t0:
        return {"wall_s": 0.0, "t0": t0, "t1": t1,
                "stages": stages, "unattributed_s": 0.0}
    clamped = []
    for name, level, stage, start, end in spans:
        start = max(start, t0)
        end = min(end, t1)
        if end > start:
            clamped.append((level, stage, start, end))
    boundaries = sorted({t0, t1}
                        | {s[2] for s in clamped} | {s[3] for s in clamped})
    unattributed = 0.0
    for left, right in zip(boundaries, boundaries[1:]):
        mid = 0.5 * (left + right)
        best = None
        for level, stage, start, end in clamped:
            if start <= mid < end:
                # innermost wins; equal depth goes to the later start
                # (the span that began most recently is the most
                # specific description of "now")
                key = (level, start)
                if best is None or key > best[0]:
                    best = (key, stage)
        width = right - left
        if best is None:
            unattributed += width
        else:
            stages[best[1]] += width
    return {"wall_s": t1 - t0, "t0": t0, "t1": t1, "stages": stages,
            "unattributed_s": unattributed}


def trace_intervals(doc, trace):
    """Extract ``(name, start_s, end_s)`` spans for one trace id from a
    chrome-trace document (``FlightRecorder.chrome_trace()`` or a
    ``stitch_traces`` product)."""
    if isinstance(doc, dict):
        events = doc.get("traceEvents", [])
    else:
        events = doc or []
    trace = int(trace)
    out = []
    for event in events:
        if event.get("ph") != "X":
            continue
        if int(event.get("tid", -1)) != trace:
            continue
        ts = float(event.get("ts", 0.0)) / 1e6
        dur = float(event.get("dur", 0.0)) / 1e6
        out.append((event.get("name", ""), ts, ts + dur))
    return out


def attribute_trace(doc, trace):
    """Critical-path attribution for one trace id in a chrome-trace doc."""
    return attribute_intervals(trace_intervals(doc, trace))


# --------------------------------------------------------------------------
# Synthetic canary prober
# --------------------------------------------------------------------------

class CanaryProber(object):
    """Driver-side synthetic prober through the real router path.

    Issues deterministic (temp=0 — the serving engine is greedy unless
    told otherwise) probes under :data:`CANARY_TENANT` at ``low``
    priority, so the QoS plane guarantees the canary never preempts or
    displaces real traffic.  The first successful probe pins the
    expected token ids; any later mismatch increments the drift counter
    and fires ``on_drift`` — a bitwise correctness SLI.

    ``start()`` runs a background loop (daemon thread, joined by
    ``stop()``); ``probe_once()`` is usable standalone for tests and
    for scrape-driven probing.
    """

    def __init__(self, url, prompt, max_new_tokens=4, interval=5.0,
                 timeout=30.0, expected_tokens=None, on_drift=None,
                 history=256):
        self.url = url
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.interval = float(interval)
        self.timeout = float(timeout)
        self.expected = (list(expected_tokens)
                         if expected_tokens is not None else None)
        self.on_drift = on_drift
        self._history = collections.deque(maxlen=int(history))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._probes = 0
        self._failures = 0
        self._drift = 0

    def probe_once(self, now=None):
        """One synchronous probe.  Returns the history record."""
        t0 = time.monotonic()
        now = time.time() if now is None else now
        body = json.dumps({
            "prompt": self.prompt,
            "max_new_tokens": self.max_new_tokens,
            "tenant": CANARY_TENANT,
            "priority": "low",
        }).encode()
        status = None
        tokens = None
        error = None
        try:
            req = urllib.request.Request(
                self.url, data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                status = resp.status
                payload = json.loads(resp.read())
                tokens = list(payload.get("tokens", []))
        except urllib.error.HTTPError as exc:
            status = exc.code
            error = "http {}".format(exc.code)
        except Exception as exc:  # connection refused, timeout, bad json
            error = "{}: {}".format(type(exc).__name__, exc)
        latency = time.monotonic() - t0
        ok = status == 200 and tokens is not None
        drift = False
        with self._lock:
            self._probes += 1
            if ok:
                if self.expected is None:
                    self.expected = list(tokens)
                elif tokens != self.expected:
                    drift = True
                    self._drift += 1
            else:
                self._failures += 1
            record = {"t": now, "ok": ok, "status": status,
                      "latency_s": latency, "drift": drift,
                      "tokens": tokens, "error": error}
            self._history.append(record)
        if drift and self.on_drift is not None:
            try:
                self.on_drift(record, list(self.expected))
            except Exception:
                pass  # a broken drift hook must not kill the prober
        return record

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="tfos-slo-canary", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=self.timeout + self.interval + 5.0)
            self._thread = None

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception:
                pass  # probe_once already records failures; never die
            self._stop.wait(self.interval)

    def counters(self):
        with self._lock:
            return {"probes": self._probes, "failures": self._failures,
                    "drift": self._drift}

    def history(self):
        with self._lock:
            return [dict(r) for r in self._history]

    def sli(self):
        """Cumulative (good, total) availability tally for burn engines."""
        with self._lock:
            return (self._probes - self._failures, self._probes)


# --------------------------------------------------------------------------
# Live glue: SloMonitor
# --------------------------------------------------------------------------

class SloMonitor(object):
    """Scrape-driven SLO evaluation against a live ``FleetRouter``.

    SLI sources are resolved by family:

    - ``kind=availability`` reads the router's per-tenant dispatch
      tallies (client disconnects excluded entirely; quota 429s
      excluded from good AND total as policy-not-failure; >=500 is bad)
    - ``tfos_fleet_*`` latency families read the router's OWN registry
      histograms — router-observed wall includes network grayness that
      engine-side clocks can never see
    - other (``tfos_serving_*``) latency families merge the
      beat-carried histogram snapshots across replicas

    ``sample()`` is invoked from ``/metrics`` and ``/slo`` handlers —
    the Prometheus pull model, no extra router thread.  Lock ordering:
    the monitor lock is taken FIRST, then router accessors that take
    the router's ``_obs_lock``; never the reverse.
    """

    def __init__(self, router, specs=None):
        self.router = router
        self.engine = BurnRateAlerts(specs)
        self.specs = self.engine.specs
        self.canary = None
        self._supervisor = None
        self._lock = threading.RLock()
        self._incidents = []
        self._last_verdicts = []

    # -- wiring ------------------------------------------------------------

    def attach_canary(self, prober):
        with self._lock:
            self.canary = prober
            if prober is not None and prober.on_drift is None:
                prober.on_drift = self._on_canary_drift
        return prober

    def attach_supervisor(self, supervisor):
        with self._lock:
            self._supervisor = supervisor

    # -- sampling ----------------------------------------------------------

    def _sli(self, spec):
        """Cumulative (good, total) for one spec, or None if unreadable."""
        router = self.router
        if spec.kind == "availability":
            tallies = router.slo_tallies()
            tally = tallies.get(spec.tenant)
            if tally is None:
                return (0, 0)
            return (tally[0], tally[1])
        if spec.family.startswith("tfos_fleet"):
            hist = router.metrics.get_histogram(spec.family)
            if hist is None:
                return None
            snap = hist.snapshot()
            return latency_good_total(snap, spec.threshold)
        # tfos_serving_* — merge beat-carried replica snapshots
        good = 0
        total = 0
        found = False
        for view in router.replica_views():
            metrics = view.get("metrics") or {}
            hists = metrics.get("hists") or {}
            snap = hists.get(spec.family)
            if not snap:
                continue
            found = True
            g, t = latency_good_total(snap, spec.threshold)
            good += g
            total += t
        if not found:
            return (0, 0)
        return (good, total)

    def sample(self, now=None):
        """Feed fresh SLIs, evaluate, record transitions. -> verdicts."""
        now = time.monotonic() if now is None else now
        with self._lock:
            for spec in self.specs:
                try:
                    sli = self._sli(spec)
                except Exception:
                    sli = None
                if sli is not None:
                    self.engine.observe(spec.name, now, sli[0], sli[1])
            verdicts, transitions = self.engine.evaluate(now)
            self._last_verdicts = verdicts
            for kind, verdict in transitions:
                self._record_transition(kind, verdict)
            return verdicts

    def _record_transition(self, kind, verdict):
        evidence = {"verdict": verdict}
        try:
            evidence["replicas"] = self.router.replica_views()
        except Exception:
            evidence["replicas"] = []
        try:
            evidence["flight"] = self.router.flight.tail(64)
        except Exception:
            evidence["flight"] = []
        incident = {"t": time.time(), "kind": "slo_" + kind,
                    "slo": verdict["slo"], "evidence": evidence}
        self._incidents.append(incident)
        del self._incidents[:-64]
        supervisor = self._supervisor
        if supervisor is not None and kind == "raise":
            try:
                supervisor.record_slo_incident(
                    "slo_burn_rate", "slo {} burning over budget".format(
                        verdict["slo"]), payload=evidence)
            except Exception:
                pass

    def _on_canary_drift(self, record, expected):
        evidence = {"record": record, "expected": expected}
        with self._lock:
            incident = {"t": time.time(), "kind": "slo_canary_drift",
                        "slo": "canary", "evidence": evidence}
            self._incidents.append(incident)
            del self._incidents[:-64]
            supervisor = self._supervisor
        if supervisor is not None:
            try:
                supervisor.record_slo_incident(
                    "slo_canary_drift",
                    "canary output drifted from pinned tokens",
                    payload=evidence)
            except Exception:
                pass

    # -- read-side ---------------------------------------------------------

    def incidents(self):
        with self._lock:
            return [dict(i) for i in self._incidents]

    def firing(self):
        with self._lock:
            return [v["slo"] for v in self._last_verdicts if v["firing"]]

    def max_fast_burn(self, now=None):
        """Largest fast-pair short-window burn across specs (0.0 when
        nothing has traffic).  The autoscaler's UP-pressure signal."""
        verdicts = self.sample(now=now)
        best = 0.0
        for verdict in verdicts:
            windows = verdict["windows"]
            if not windows:
                continue
            burn = windows[0].get("short_burn")
            if burn is not None and burn > best:
                best = burn
        return best

    def verdict(self, now=None):
        verdicts = self.sample(now=now)
        canary = None
        prober = self.canary
        if prober is not None:
            canary = {"counters": prober.counters(),
                      "expected_pinned": prober.expected is not None,
                      "history": prober.history()[-32:]}
        return {
            "specs": verdicts,
            "firing": [v["slo"] for v in verdicts if v["firing"]],
            "alerts_total": self.engine.alerts_total(),
            "canary": canary,
            "incidents": len(self.incidents()),
        }

    def metric_lines(self, now=None):
        """Hand-rendered OpenMetrics lines for the router's /metrics."""
        verdicts = self.sample(now=now)
        fmt = tracing._fmt
        lines = []
        if verdicts:
            lines.append("# TYPE tfos_slo_error_budget_remaining gauge")
            for v in verdicts:
                if v["error_budget_remaining"] is None:
                    continue
                lines.append(
                    'tfos_slo_error_budget_remaining{{slo="{}",tenant="{}"}}'
                    ' {}'.format(v["slo"], v["tenant"],
                                 fmt(v["error_budget_remaining"])))
            lines.append("# TYPE tfos_slo_burn_rate gauge")
            for v in verdicts:
                for w in v["windows"]:
                    for which, burn in (("short", w["short_burn"]),
                                        ("long", w["long_burn"])):
                        if burn is None:
                            continue
                        window_s = w["{}_s".format(which)]
                        lines.append(
                            'tfos_slo_burn_rate{{slo="{}",tenant="{}",'
                            'window="{:g}"}} {}'.format(
                                v["slo"], v["tenant"], window_s, fmt(burn)))
            lines.append("# TYPE tfos_slo_alerts counter")
            for name, count in sorted(self.engine.alerts_total().items()):
                lines.append(
                    'tfos_slo_alerts_total{{slo="{}"}} {}'.format(
                        name, count))
        prober = self.canary
        if prober is not None:
            counters = prober.counters()
            for family, key in (("tfos_slo_canary_probes", "probes"),
                                ("tfos_slo_canary_failures", "failures"),
                                ("tfos_slo_canary_drift", "drift")):
                lines.append("# TYPE {} counter".format(family))
                lines.append("{}_total {}".format(family, counters[key]))
        return lines
