"""SLO-driven autoscaler for the serving fleet — the port's copy of
``tensorflowonspark_tpu/autoscale.py``.

Capacity stops being a constructor argument: this module closes the
loop between the SLO signals the fleet already publishes (per-replica
``queue_wait_ewma_s``, TTFT p99 histograms, slot/KV occupancy — all
riding the fleet's serving BEAT leases) and the fleet's width. A
driver-side control loop reads the reservation server's serving
snapshot, runs a PURE decision function, and drives
``ServingFleet.spawn_replica`` / ``retire_replica`` /
``replace_replica``:

- **Scale-up, fast** — any live replica's queue-wait EWMA past the
  SLO, TTFT p99 past its target, or slot saturation with a standing
  queue is a BREACH; one replica is added per ``up_cooldown_s`` until
  ``max_replicas`` (hysteresis: breaches scale quickly, but never in a
  tight loop). Placement is evidence-gated the way the training
  plane's regrow probe is: scale-up happens only onto capacity that
  EXISTS
  (``ServingFleet.free_executor``); no free executor means a logged
  ``scale_up_blocked`` decision, not an invented replica.
- **Scale-down, slow** — sustained idleness (no queue anywhere, mean
  occupancy under the low watermark) retires the least-loaded replica
  through the zero-loss quiesce -> drain -> deregister path
  (``retire_replica`` — ``rolling_drain``'s contract), gated by the
  LONG ``down_cooldown_s`` measured from the last scale in EITHER
  direction, so a burst's trailing edge cannot flap the fleet.
- **Replacement** — a replica whose lease expired (SIGKILLed executor)
  or whose engine died is repaired, not scaled around: same identity,
  fresh fencing epoch minted BEFORE the replacement's first beat
  (a partitioned corpse can never serve stale), on whatever
  free executor exists. Replacement is exempt from scale cooldowns —
  it restores the target, it doesn't change it.
- **Evidence-gated cold start** — a fleet that has served NOTHING
  (zero completions, empty queues, idle slots) holds: the controller
  never scales on the absence of evidence.

Every decision is recorded supervisor-style — a ``tracing.EventLog``
entry carrying the evidence snapshot (the per-replica views the
decision priced) — and mirrored as a FlightRecorder instant into the
ROUTER's span ring, so ``GET /debug/trace`` timelines show scale
events against the very request spans that triggered them. Counters
(``tfos_autoscale_*``) register into the router's metrics registry and
render on its ``/metrics``.

The decision function (:func:`decide`) is pure — views in, decision
out, time injected — so tests/test_autoscale.py pins the policy table
without sockets, exactly as fleet.route_order and ReplicaHealth are
pinned.
"""

import logging
import threading
import time

from tensorflowonspark_tpu_torch import tracing

logger = logging.getLogger(__name__)


class AutoscalePolicy(object):
    """Scaling rules: SLO thresholds, watermarks, hysteresis, bounds.

    Args:
      min_replicas / max_replicas: the fleet's width clamps.
      queue_wait_slo_s: a live replica's ``queue_wait_ewma_s`` past
        this is an SLO breach (work is waiting for slots).
      ttft_p99_slo_s: optional TTFT p99 target (read from each
        replica's beat-carried histogram snapshot); None disables.
      occupancy_high: mean slot-occupancy fraction at or above which a
        STANDING queue (any ``queue_depth`` > 0) reads as saturation —
        occupancy alone is healthy utilization, occupancy + queue is a
        breach.
      occupancy_low: mean occupancy at or below which (with empty
        queues everywhere) the fleet reads as idle — the scale-down
        signal.
      up_cooldown_s: minimum seconds between scale-UPs (fast — a
        breach under load deserves quick capacity, but never a tight
        spawn loop).
      down_cooldown_s: minimum seconds since the LAST SCALE IN EITHER
        DIRECTION before a scale-down (slow — the hysteresis that
        stops a bursty workload flapping the fleet).
      dead_after_s: lease age past which a replica is presumed lost
        (executor death) and REPLACED.
    """

    def __init__(self, min_replicas=1, max_replicas=4,
                 queue_wait_slo_s=0.75, ttft_p99_slo_s=None,
                 occupancy_high=0.85, occupancy_low=0.25,
                 up_cooldown_s=2.0, down_cooldown_s=20.0,
                 dead_after_s=3.0, burn_rate_up_threshold=None):
        if int(min_replicas) < 1:
            raise ValueError("min_replicas must be >= 1")
        if int(max_replicas) < int(min_replicas):
            raise ValueError("max_replicas must be >= min_replicas")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_wait_slo_s = float(queue_wait_slo_s)
        self.ttft_p99_slo_s = None if ttft_p99_slo_s is None \
            else float(ttft_p99_slo_s)
        self.occupancy_high = float(occupancy_high)
        self.occupancy_low = float(occupancy_low)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.dead_after_s = float(dead_after_s)
        #: SLO-plane coupling: when the router's SloMonitor
        #: reports a fast-window error-budget burn above this multiple,
        #: that is UP pressure even before queues visibly back up — a
        #: gray replica burns budget while the healthy one keeps the
        #: queue short. None disables the term.
        self.burn_rate_up_threshold = None if burn_rate_up_threshold \
            is None else float(burn_rate_up_threshold)


class ScaleDecision(object):
    """One evaluated decision: ``action`` (hold/up/down/replace),
    the human reason, the replica it targets (down/replace), the
    evidence views it priced, and — for tiered fleets — the
    tier the decision sizes (None on homogeneous fleets; a spawn
    applied from a tiered decision carries it to
    ``ServingFleet.spawn_replica(tier=...)``)."""

    HOLD, UP, DOWN, REPLACE = "hold", "up", "down", "replace"

    def __init__(self, action, reason, replica_id=None, evidence=None,
                 tier=None):
        self.action = action
        self.reason = reason
        self.replica_id = replica_id
        self.evidence = evidence or {}
        self.tier = tier

    def __repr__(self):
        return "ScaleDecision({}, {!r}, replica={}{})".format(
            self.action, self.reason, self.replica_id,
            ", tier={}".format(self.tier) if self.tier else "")


def replica_view(rid, info):
    """One replica's compact decision view from its serving-snapshot
    entry (None info = tracked by the fleet but no lease at all)."""
    info = info or {}
    gauges = info.get("serving") or {}
    metrics = info.get("metrics") or {}
    counts = ((metrics.get("counters") or {}).get("tfos_serving")
              or {}).get("counts") or {}
    ttft = (metrics.get("hists") or {}).get("tfos_serving_ttft_seconds")
    slots = int(gauges.get("slots") or 0)
    return {
        "replica_id": str(rid),
        "age": info.get("age"),
        "alive": gauges.get("alive", False),
        "draining": bool(gauges.get("draining")),
        "queue_depth": int(gauges.get("queue_depth") or 0),
        # per-priority queue split: lets decide() tell a HIGH-
        # class breach (buy hardware) from LOW-only backlog (declared
        # soak load — tolerate). Empty on engines predating the gauge.
        "queue_by_class": dict(gauges.get("queue_by_class") or {}),
        "slot_occupancy": int(gauges.get("slot_occupancy") or 0),
        "slots": slots,
        "queue_wait_ewma_s": float(gauges.get("queue_wait_ewma_s")
                                   or 0.0),
        "kv_blocks_free": gauges.get("kv_blocks_free"),
        "kv_blocks_total": gauges.get("kv_blocks_total"),
        "completed": int(counts.get("requests_completed") or 0),
        "ttft_p99_s": tracing.snapshot_quantile(ttft, 0.99)
        if ttft else None,
        # prefix warmth: the beat-carried chain digest,
        # summarized as summed resident depth — the signal that makes
        # sustained-idle retirement prefer the COLDEST replica, so a
        # scale-down doesn't destroy the fleet's hottest cache
        "prefix_warmth": _digest_warmth(gauges.get("prefix_digest")),
        "generated_prefix_hit_blocks": int(
            gauges.get("generated_prefix_hit_blocks") or 0),
        "executor": (info.get("host") or {}).get("executor"),
        # disaggregation tier: partitions decide() into
        # independent per-tier sizing pools ("mixed" — every pre-tier
        # replica — keeps the fleet one pool)
        "tier": str(gauges.get("tier") or "mixed"),
    }


def _digest_warmth(digest):
    """Scalar warmth of one beat-carried prefix digest: summed chain
    depths (blocks of resident, reusable prefix). Zero for contiguous
    replicas' zero schema or malformed entries — cold by definition."""
    warmth = 0
    for entry in digest or []:
        try:
            warmth += max(0, int(entry[1]))
        except (TypeError, ValueError, IndexError):
            continue
    return warmth


def _load_key(view):
    """Least-loaded ordering for scale-down victim selection (the
    retiree should strand as little in-flight work as possible)."""
    return (view["queue_depth"] + view["slot_occupancy"],
            view["queue_wait_ewma_s"], view["replica_id"])


def _retire_key(view):
    """Scale-down victim ordering: coldest cache first —
    summed digest depth, then the generated-prefix hit tally (a
    replica actively serving multi-turn reuse is the last thing to
    retire) — with :func:`_load_key` breaking warmth ties, so among
    equally cold replicas the retiree still strands the least
    in-flight work. ``view.get`` defaults keep the key total for
    hand-built test views."""
    return (int(view.get("prefix_warmth") or 0),
            int(view.get("generated_prefix_hit_blocks") or 0)) \
        + _load_key(view)


def _state_key(base, tier):
    """Cooldown-stamp key: per-tier sub-state (``last_up:prefill``)
    for tiered pools, the legacy flat key for homogeneous fleets —
    each tier's hysteresis runs independently (a prefill burst must
    not block a decode scale-down, and vice versa)."""
    return base if tier is None else "{}:{}".format(base, tier)


def decide(policy, views, state, now, burn_rate=None):
    """PURE scaling decision: per-replica ``views`` (see
    :func:`replica_view`), controller ``state`` ({"last_up",
    "last_down"} monotonic stamps or None, plus per-tier
    ``last_up:<tier>`` sub-keys on tiered fleets), injected ``now``
    -> :class:`ScaleDecision`. Never mutates ``state`` — the
    controller stamps it only when an action actually applies.

    Rule order: replacement (repair) outranks scaling; breaches
    outrank idleness; every scale respects the clamps, its cooldown,
    and the no-evidence gate. Tiered fleets are sized PER
    TIER: each tier is its own pool with its own cooldown sub-state
    and its own min/max clamp (the policy's bounds apply to each tier
    independently — a saturated prefill tier scales on its backlog
    while an idle decode tier shrinks on its slots, in the same
    poll cycle's priority order: any UP beats any DOWN)."""
    # -- repair: a dead member is replaced, cooldowns notwithstanding
    # (tier-blind — a corpse is repaired whatever it served; the
    # fleet's spawn path re-derives its tier from the identity)
    for view in views:
        if view["draining"]:
            continue
        lease_dead = view["age"] is None \
            or view["age"] > policy.dead_after_s
        if lease_dead or not view["alive"]:
            return ScaleDecision(
                ScaleDecision.REPLACE,
                "lease expired (age {})".format(view["age"])
                if lease_dead else "engine dead under a live lease",
                replica_id=view["replica_id"],
                evidence={"views": views},
                tier=view.get("tier"))
    tiers = sorted({str(v.get("tier") or "mixed") for v in views})
    if len(tiers) <= 1:
        return _decide_pool(policy, views, state, now,
                            burn_rate=burn_rate)
    decisions = [
        _decide_pool(policy,
                     [v for v in views
                      if str(v.get("tier") or "mixed") == tier],
                     state, now, tier=tier, burn_rate=burn_rate)
        for tier in tiers]
    for decision in decisions:
        if decision.action == ScaleDecision.UP:
            return decision
    for decision in decisions:
        if decision.action != ScaleDecision.HOLD:
            return decision
    return ScaleDecision(
        ScaleDecision.HOLD,
        "; ".join("{}: {}".format(d.tier, d.reason)
                  for d in decisions),
        evidence={"tiers": {d.tier: d.evidence for d in decisions}})


def _decide_pool(policy, views, state, now, tier=None, burn_rate=None):
    """One pool's scaling verdict (the whole fleet, or one tier of a
    tiered fleet): the breach/idle policy table over ``views``, with
    cooldown stamps read from the pool's own sub-state."""
    live = [v for v in views
            if v["age"] is not None and v["age"] <= policy.dead_after_s
            and v["alive"] and not v["draining"]]
    evidence = {"views": views, "live": len(live)}
    if tier is not None:
        evidence["tier"] = tier
    if not live:
        return ScaleDecision(ScaleDecision.HOLD, "no live replicas",
                             evidence=evidence, tier=tier)
    total_slots = sum(v["slots"] for v in live) or 1
    occupancy = sum(v["slot_occupancy"] for v in live) / float(total_slots)
    queue = sum(v["queue_depth"] for v in live)
    max_qwait = max(v["queue_wait_ewma_s"] for v in live)
    ttfts = [v["ttft_p99_s"] for v in live if v["ttft_p99_s"] is not None]
    completed = sum(v["completed"] for v in live)
    by_class = {"high": 0, "normal": 0, "low": 0}
    for v in live:
        for cls, n in (v.get("queue_by_class") or {}).items():
            if cls in by_class:
                try:
                    by_class[cls] += int(n)
                except (TypeError, ValueError):
                    continue
    evidence.update(occupancy=round(occupancy, 3), queue_depth=queue,
                    max_queue_wait_ewma_s=round(max_qwait, 4),
                    ttft_p99_s=round(max(ttfts), 4) if ttfts else None,
                    completed=completed,
                    queue_by_class=dict(by_class))
    # -- evidence-gated cold start: a fleet that has served nothing
    # and holds no work must not scale on the absence of evidence
    if completed == 0 and queue == 0 and occupancy == 0.0:
        return ScaleDecision(ScaleDecision.HOLD, "cold (no evidence)",
                             evidence=evidence, tier=tier)
    # breach terms are gated on STANDING work (queue > 0): the
    # queue-wait EWMA and TTFT histogram are history — they hold their
    # last burst's values while the fleet sits idle, and a breach that
    # no current request is experiencing must not pin the fleet wide
    # (it would also block every scale-down forever)
    breach = []
    if queue > 0 and max_qwait > policy.queue_wait_slo_s:
        breach.append("queue_wait_ewma {:.3f}s > SLO {:.3f}s".format(
            max_qwait, policy.queue_wait_slo_s))
    if policy.ttft_p99_slo_s is not None and ttfts and queue > 0 \
            and max(ttfts) > policy.ttft_p99_slo_s:
        breach.append("ttft_p99 {:.3f}s > SLO {:.3f}s".format(
            max(ttfts), policy.ttft_p99_slo_s))
    if occupancy >= policy.occupancy_high and queue > 0:
        breach.append(
            "slots saturated ({:.0%}) with {} queued".format(
                occupancy, queue))
    # SLO-plane burn: evidence-gated on the pool having served
    # at all — unlike the queue-gated terms above, budget burn IS
    # current pain (the windowed SLI only moves while bad requests
    # land), so a gray replica scales the pool before queues back up
    if burn_rate is not None \
            and policy.burn_rate_up_threshold is not None \
            and completed > 0 \
            and burn_rate > policy.burn_rate_up_threshold:
        evidence["burn_rate"] = round(burn_rate, 3)
        breach.append(
            "error-budget burn {:.1f}x > {:.1f}x threshold".format(
                burn_rate, policy.burn_rate_up_threshold))
    if breach:
        reason = "; ".join(breach)
        # per-priority breach view: a backlog made ENTIRELY of
        # LOW-class work is declared soak load — it opted into waiting
        # (absorbing idle capacity is its whole job), so it tolerates
        # the breach instead of buying hardware; any HIGH/normal work
        # standing in the queue scales as before. Guarded on the class
        # tally accounting for the WHOLE queue: replicas predating the
        # gauge report nothing, and an unaccounted backlog must keep
        # the legacy scale-up behavior.
        if queue > 0 and by_class["high"] + by_class["normal"] == 0 \
                and by_class["low"] >= queue:
            return ScaleDecision(
                ScaleDecision.HOLD,
                "LOW-class-only backlog tolerated: " + reason,
                evidence=evidence, tier=tier)
        if len(live) >= policy.max_replicas:
            return ScaleDecision(
                ScaleDecision.HOLD,
                "SLO breach but at max_replicas ({}): {}".format(
                    policy.max_replicas, reason), evidence=evidence,
                tier=tier)
        last_up = state.get(_state_key("last_up", tier))
        if last_up is not None and now - last_up < policy.up_cooldown_s:
            return ScaleDecision(
                ScaleDecision.HOLD,
                "SLO breach inside up-cooldown ({:.1f}s < {:.1f}s)"
                .format(now - last_up, policy.up_cooldown_s),
                evidence=evidence, tier=tier)
        return ScaleDecision(ScaleDecision.UP, reason,
                             evidence=evidence, tier=tier)
    if queue == 0 and occupancy <= policy.occupancy_low:
        if len(live) <= policy.min_replicas:
            return ScaleDecision(
                ScaleDecision.HOLD, "idle at min_replicas",
                evidence=evidence, tier=tier)
        if completed == 0:
            # live gauges can read idle while every request so far
            # shed/failed — never shrink a fleet that has not proven
            # it can serve
            return ScaleDecision(
                ScaleDecision.HOLD, "idle but zero completions",
                evidence=evidence, tier=tier)
        stamps = [t for t in (state.get(_state_key("last_up", tier)),
                              state.get(_state_key("last_down", tier)))
                  if t is not None]
        last_scale = max(stamps) if stamps else None
        if last_scale is not None \
                and now - last_scale < policy.down_cooldown_s:
            return ScaleDecision(
                ScaleDecision.HOLD,
                "idle inside down-cooldown ({:.1f}s < {:.1f}s)".format(
                    now - last_scale, policy.down_cooldown_s),
                evidence=evidence, tier=tier)
        victim = min(live, key=_retire_key)
        return ScaleDecision(
            ScaleDecision.DOWN,
            "idle (occupancy {:.0%} <= {:.0%}, empty queues; "
            "retiring coldest cache)".format(
                occupancy, policy.occupancy_low),
            replica_id=victim["replica_id"], evidence=evidence,
            tier=tier)
    return ScaleDecision(ScaleDecision.HOLD, "within SLO",
                         evidence=evidence, tier=tier)


class AutoscaleController(object):
    """Driver-side control loop binding :func:`decide` to a
    ``fleet.ServingFleet``: read the serving BEAT snapshot, decide,
    apply (spawn / retire / replace), record. Runs on its own daemon
    thread (:meth:`start`); :meth:`poll_once` is exposed so tests
    drive it deterministically."""

    def __init__(self, fleet, policy=None, interval=0.25,
                 drain_timeout=None, events=None, spawn_timeout=None):
        self.fleet = fleet
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.interval = float(interval)
        #: bound on a retirement's zero-loss drain (None = wait for
        #: the admitted work, the zero-loss posture)
        self.drain_timeout = drain_timeout
        self.spawn_timeout = spawn_timeout
        #: supervisor-style decision log, evidence snapshot per entry
        self.events = events if events is not None else tracing.EventLog()
        self.counters = tracing.Counters()
        self._state = {"last_up": None, "last_down": None}
        self._last_record = None
        self._last_note = None
        # one control step at a time: poll_once is public (tests and
        # operators drive it) AND the loop thread calls it — two
        # concurrent evaluations of the same evidence would BOTH
        # apply (a double scale-down retires two replicas for one
        # idle verdict) and race the cooldown stamps and the
        # decision-suppression memos (unlocked read-modify-writes).
        # Pinned by test_autoscale.py's two-thread barrier test.
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        router = getattr(fleet, "router", None)
        #: scale instants land in the ROUTER's flight ring so
        #: /debug/trace shows them against request spans
        self.flight = router.flight if router is not None \
            else tracing.flight_recorder()
        if router is not None:
            router.metrics.add_counters("tfos_autoscale", self.counters)

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="tfos-autoscale", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the loop must survive
                logger.exception("autoscale poll failed")
            self._stop.wait(self.interval)

    # -- one control step --------------------------------------------------

    def views(self):
        """Per-replica decision views for every replica the fleet
        TRACKS (a tracked replica with no lease at all shows age None
        — the replacement signal)."""
        snapshot = self.fleet.reservation.serving_snapshot()
        return [replica_view(r.replica_id,
                             snapshot.get(r.replica_id))
                for r in list(self.fleet.replicas)]

    def poll_once(self, now=None):
        """One full control step (read -> decide -> record -> apply),
        serialized: a caller landing while another step is mid-apply
        waits and then evaluates FRESH state (the first step's stamps
        and fleet changes), so one idle verdict can never retire two
        replicas."""
        with self._lock:
            # `now` defaults AFTER the lock: a step that waited out a
            # long apply must price cooldowns at the time it actually
            # runs, not at the time it queued
            return self._poll_locked(
                now if now is not None else time.monotonic())

    def _poll_locked(self, now):
        recovering = getattr(self.fleet.reservation, "recovering",
                             None)  # stub reservations lack it
        if recovering is not None and recovering():
            # control-plane recovery grace: a restarted
            # reservation server's snapshot is floors-without-leases
            # until the incumbents re-announce — every view reads
            # age None, the REPLACE signature. Scaling on that would
            # spawn replacements (fresh epochs!) for replicas that
            # are alive and about to re-register; hold until the
            # grace window clears.
            self.counters.inc("decisions")
            decision = ScaleDecision(
                ScaleDecision.HOLD, "reservation server recovering "
                "(journal floors seeded, awaiting re-announce)")
            self._record(decision, 0, len(self.fleet.replicas))
            return decision
        views = self.views()
        burn_rate = None
        if self.policy.burn_rate_up_threshold is not None:
            # SLO-plane coupling: the router's monitor samples
            # on demand; the largest fast-window burn across specs is
            # the scalar UP-pressure signal. Best-effort — a fleet
            # without a router (or a sampling hiccup) scales on the
            # classic terms alone.
            monitor = getattr(getattr(self.fleet, "router", None),
                              "slo", None)
            if monitor is not None:
                try:
                    burn_rate = monitor.max_fast_burn()
                except Exception:  # noqa: BLE001 - advisory signal
                    burn_rate = None
        decision = decide(self.policy, views, self._state, now,
                          burn_rate=burn_rate)
        self.counters.inc("decisions")
        live = sum(1 for v in views
                   if v["age"] is not None
                   and v["age"] <= self.policy.dead_after_s
                   and v["alive"] and not v["draining"])
        target = len(self.fleet.replicas)
        if decision.action == ScaleDecision.UP:
            target += 1
        elif decision.action == ScaleDecision.DOWN:
            target -= 1
        self.counters.gauge("replicas_live", live)
        self.counters.gauge("replicas_target", target)
        self._record(decision, live, target)
        if decision.action == ScaleDecision.UP:
            self._apply_up(decision, now)
        elif decision.action == ScaleDecision.DOWN:
            self._apply_down(decision, now)
        elif decision.action == ScaleDecision.REPLACE:
            self._apply_replace(decision, now)
        return decision

    def _record(self, decision, live, target):
        """Supervisor-style decision trail: every DISTINCT decision is
        logged with its evidence snapshot (and non-holds mirrored as
        router-ring trace instants). Consecutive identical decisions —
        a steady hold, but equally a REPLACE re-issued every poll
        while no capacity exists — are logged once: the trail shows
        state changes, not a poll-rate heartbeat that would churn the
        EventLog ring out of its real history."""
        key = (decision.action, decision.reason, decision.replica_id,
               decision.tier)
        if key == self._last_record:
            return
        self._last_record = key
        self.events.record(
            "autoscale_decision", action=decision.action,
            reason=decision.reason, replica=decision.replica_id,
            tier=decision.tier, replicas_live=live,
            replicas_target=target, evidence=decision.evidence)
        if decision.action != ScaleDecision.HOLD:
            self.flight.instant(
                "autoscale_" + decision.action,
                reason=decision.reason,
                replica=decision.replica_id or "",
                replicas_live=live, replicas_target=target)
            logger.warning("autoscale %s: %s (live %d -> target %d)",
                           decision.action, decision.reason, live,
                           target)

    def _note_once(self, name, **detail):
        """Record an apply-side event unless it is an identical repeat
        of the previous one — a blocked replacement re-evaluated every
        poll must not flood the EventLog (counters still tick)."""
        key = (name, tuple(sorted(detail.items())))
        if key == self._last_note:
            return
        self._last_note = key
        self.events.record(name, **detail)

    def _applied(self, name, **detail):
        """Record a SUCCESSFUL apply (always logged; resets the
        repeat-suppression state so a later identical failure is a
        fresh story)."""
        self._last_note = None
        self._last_record = None
        self.events.record(name, **detail)

    def _apply_up(self, decision, now):
        from tensorflowonspark_tpu_torch import fleet as fleet_mod

        up_key = _state_key("last_up", decision.tier)
        if self.fleet.placement == "executors" \
                and self.fleet.free_executor() is None:
            # the regrow-probe gate: capacity must EXIST; a blocked
            # scale-up is a recorded fact, not a spin
            self.counters.inc("scale_up_blocked")
            self._note_once("autoscale_blocked",
                            reason="no free executor")
            self._state[up_key] = now  # re-probe after the cooldown
            return
        try:
            # a tiered decision's spawn lands IN that tier:
            # sizing the prefill pool must grow a prefill replica
            replica = self.fleet.spawn_replica(
                timeout=self.spawn_timeout, tier=decision.tier)
        except fleet_mod.NoCapacity as e:
            self.counters.inc("scale_up_blocked")
            self._note_once("autoscale_blocked", reason=str(e))
            self._state[up_key] = now
            return
        self._state[up_key] = now
        self.counters.inc("scale_ups")
        self._applied("autoscale_scaled_up",
                      replica=replica.replica_id,
                      tier=decision.tier,
                      executor=getattr(replica, "executor_id", None))

    def _apply_down(self, decision, now):
        clean = self.fleet.retire_replica(
            decision.replica_id, drain_timeout=self.drain_timeout)
        self._state[_state_key("last_down", decision.tier)] = now
        self.counters.inc("scale_downs")
        if not clean:
            self.counters.inc("unclean_retirements")
        self._applied("autoscale_scaled_down",
                      replica=decision.replica_id,
                      tier=decision.tier,
                      drained_clean=bool(clean))

    def _supervisor_watches(self, replica):
        """True when the fleet's supervisor holds a RestartEngine
        watch over THIS replica object — only then is in-process
        engine death someone else's repair. A replica spawned after
        supervise() (or an unsupervised fleet) has no watcher, and
        deferring for it would wedge the controller forever."""
        sup = getattr(self.fleet, "supervisor", None)
        if sup is None:
            return False
        return any(entry.get("replica") is replica
                   for entry in getattr(sup, "_watched", []))

    def _apply_replace(self, decision, now):
        from tensorflowonspark_tpu_torch import fleet as fleet_mod

        rid = decision.replica_id
        replica = self.fleet._replica(rid)
        if replica is None:
            return
        info = self.fleet.reservation.serving_snapshot().get(rid) or {}
        lease_fresh = (info.get("age") or 1e9) <= self.policy.dead_after_s
        remote = getattr(replica, "remote", False)
        try:
            if lease_fresh and not remote:
                if self._supervisor_watches(replica):
                    # the supervisor's RestartEngine owns this repair;
                    # replacing from here would race it
                    self._note_once(
                        "autoscale_replace_deferred", replica=rid,
                        reason="in-process engine death -> supervisor")
                    return
                # UNWATCHED in-process engine death: repair here —
                # stop the corpse, respawn in place, readmit
                old = replica.server.engine
                if old is not None:
                    old.stop()
                replica.respawn_engine()
                if self.fleet.router is not None:
                    self.fleet.router.readmit(rid, owner=None)
            elif lease_fresh:
                # executor alive, engine dead: respawn IN PLACE over
                # the lifecycle RPC — cheaper than a cross-executor
                # replacement and keeps the placement ledger intact
                replica.respawn_engine()
                if self.fleet.router is not None:
                    self.fleet.router.readmit(rid, owner=None)
            elif not remote:
                # driver-placement dead lease: the replica OBJECT
                # lives in this process, so the lease died because
                # its beat loop stopped (fenced by an operator mint,
                # or a wedged beat) — not because an executor
                # vanished. replace_replica cannot apply (it raises
                # for driver fleets, which used to wedge the
                # controller in a permanent REPLACE loop); the repair
                # verb is re_register: fresh epoch, restarted beat
                # loop, same engine
                replica.re_register()
                if self.fleet.router is not None:
                    self.fleet.router.readmit(rid, owner=None)
            else:
                self.fleet.replace_replica(rid,
                                           timeout=self.spawn_timeout)
        except fleet_mod.NoCapacity as e:
            self.counters.inc("scale_up_blocked")
            self._note_once("autoscale_blocked", replica=rid,
                            reason=str(e))
            return
        except Exception as e:  # noqa: BLE001 - retried next poll
            logger.warning("autoscale replacement of %s failed: %s",
                           rid, e)
            self._note_once("autoscale_replace_failed", replica=rid,
                            reason=str(e))
            return
        self.counters.inc("replacements")
        self._applied("autoscale_replaced", replica=rid,
                      in_place=lease_fresh)
