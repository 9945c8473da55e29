"""Supervision plane: failure detection, classification and recovery —
the port's copy of ``tensorflowonspark_tpu/supervisor.py``.

The reference has no answer to a mid-job trainer or executor death
beyond Spark's coarse task retry (SURVEY.md §5). This module
AGGREGATES liveness from the signals the framework already produces,
CLASSIFIES the failure, and DRIVES a pluggable recovery policy:

Signals (all ride the per-executor heartbeat lease that node.py's beat
thread publishes through the reservation ``Server``):

1. the lease itself — a missing/expired lease is executor loss;
2. DataFeed progress counters (``feed_hb``) — a frozen counter with a
   live trainer is a feed-plane stall (queue transport) or ring wedge
   (shm transport);
3. trainer-process exit status surfaced by node.py's watchdog — an
   abnormal exit code is a trainer crash.

Failure taxonomy: ``trainer_crash`` | ``feeder_stall`` | ``ring_wedge``
| ``executor_lost``, plus ``engine_dead`` for watched serving engines,
``serving_replica_lost`` for executor-hosted fleet replicas and
``replica_fenced``; observe-only incidents (``straggler`` skew through
``goodput.StragglerDetector``, serving SLO burn) never reach a policy.

Policies: :class:`FailJob`, :class:`RestartFromCheckpoint`,
:class:`Blacklist`, :class:`ElasticResize` (the pure verdicts of the
training plane) and :class:`RestartEngine`, the serving-plane policy:
a watched ``DecodeEngine`` whose scheduler died is stopped, rebuilt
from its own construction config (``engine.respawn()``) after a
bounded backoff and re-armed on its ``ModelServer``; each successful
re-arm counts one ``engine_restarts`` (a deliberate ``respawn()`` —
a rolling drain, ``/admin/respawn`` — counts nothing).

The serving plane hooks in through :meth:`Supervisor.watch` (one
engine + server), :meth:`Supervisor.watch_fleet` (every in-process
replica of a ``fleet.ServingFleet``: the router quiesces the replica
before the restart and readmits it after) and
:meth:`Supervisor.watch_serving` (executor-hosted replicas, classified
from their serving leases; the autoscaler owns their replacement).
``ServingFleet.supervise()`` arms both.

The training plane: ``cluster.run(..., supervise=SupervisorConfig(...))``
returns a :class:`SupervisedCluster` with the familiar
``train``/``shutdown`` surface and the detect -> decide -> recover loop
inside. A trainer publishes its milestones through :func:`attach`
(``TrainerSide.step`` after each step's checkpoint: the chaos step
site and the elastic boundary drain), feed partitions are acked as
consumed (:func:`acked_feed`) so a reformed attempt replays only the
unacked ones, and :func:`recovery_stages` reads the MTTR breakdown
(detect / reform / restore / first step) off the event log.
Recovery is exactly-once when every consumed partition's checkpoint
committed before the crash: one partition per checkpointed step.
"""

import contextlib
import logging
import threading
import time

from tensorflowonspark_tpu_torch import goodput as goodput_mod
from tensorflowonspark_tpu_torch import tracing

logger = logging.getLogger(__name__)

#: classification kinds the monitor emits from lease evidence
KINDS = ("trainer_crash", "feeder_stall", "ring_wedge", "executor_lost")


class FailureEvent(object):
    """One classified failure: what died, where, and the evidence.

    ``payload`` is the classifying heartbeat lease's payload (plus
    whatever the reporter attached); :meth:`as_dict` surfaces the two
    observability exhibits every incident should travel with —
    the failing executor's beat-carried metrics snapshot (its
    feed-stage breakdown at the moment of classification: a
    ``feeder_stall`` arrives with the stalled executor's stages
    attached) and the flight recorder's recent tail (the black-box
    timeline of what the process was doing; see
    ``tracing.FlightRecorder``)."""

    __slots__ = ("kind", "executor_id", "detail", "payload", "t", "wall")

    def __init__(self, kind, executor_id=None, detail="", payload=None):
        self.kind = kind
        self.executor_id = executor_id
        self.detail = detail
        self.payload = payload or {}
        self.t = time.monotonic()
        self.wall = time.time()

    def as_dict(self):
        return {"kind": self.kind, "executor_id": self.executor_id,
                "detail": self.detail, "wall": self.wall,
                "evidence": {"metrics": self.payload.get("metrics"),
                             "flight": self.payload.get("flight")}}

    def __str__(self):
        where = "" if self.executor_id is None \
            else " on executor {}".format(self.executor_id)
        return "{}{}: {}".format(self.kind, where, self.detail)


class Decision(object):
    """A policy's verdict on one failure.

    ``RESIZE`` (elastic resize): reform at ``width`` — no blacklist
    permanence, no waiting for a replacement executor; the
    SupervisedCluster rebalances un-ACKed feed partitions across the
    new width through the existing per-partition ACK ledger."""

    __slots__ = ("action", "delay", "exclude", "reason", "width")

    FAIL = "fail"
    RESTART = "restart"
    RESIZE = "resize"

    def __init__(self, action, delay=0.0, exclude=frozenset(), reason="",
                 width=None):
        self.action = action
        self.delay = float(delay)
        self.exclude = frozenset(exclude)
        self.reason = reason
        self.width = None if width is None else int(width)


class FailJob(object):
    """Clean teardown; the error re-raises on the driver (the
    unsupervised default, made explicit and composable)."""

    def decide(self, event, restarts, failure_counts, excluded,
               num_executors, width=None):
        return Decision(Decision.FAIL,
                        reason="FailJob policy: no recovery attempted")


class RestartFromCheckpoint(object):
    """Resubmit-and-restore with bounded exponential backoff.

    ``max_restarts`` bounds recovery attempts across the job (not per
    executor); backoff grows ``backoff * backoff_factor**restarts``
    capped at ``max_backoff``. The restore itself happens trainer-side:
    a supervised map_fun opens its ``checkpoint.Checkpointer`` and
    restores the latest step (``fallback=True`` recommended — a writer
    killed mid-commit can leave a corrupt latest), exactly the
    resubmit+restore contract tests/test_resume.py proves.
    """

    def __init__(self, max_restarts=2, backoff=1.0, backoff_factor=2.0,
                 max_backoff=60.0):
        self.max_restarts = int(max_restarts)
        self.backoff = float(backoff)
        self.backoff_factor = float(backoff_factor)
        self.max_backoff = float(max_backoff)

    def decide(self, event, restarts, failure_counts, excluded,
               num_executors, width=None):
        if restarts >= self.max_restarts:
            return Decision(
                Decision.FAIL,
                reason="gave up after {} restart(s)".format(restarts))
        delay = min(self.backoff * self.backoff_factor ** restarts,
                    self.max_backoff)
        return Decision(Decision.RESTART, delay=delay,
                        reason="restart {} of {}".format(
                            restarts + 1, self.max_restarts))


class Blacklist(RestartFromCheckpoint):
    """RestartFromCheckpoint that additionally excludes a repeatedly
    failing executor and reforms the cluster at reduced width.

    ``max_failures``: attributed failures before an executor is
    blacklisted. ``min_width``: floor on the reformed cluster's size —
    dropping below it fails the job (a 1-node "cluster" may be exactly
    what you want for drain-and-finish, or not; choose explicitly).
    """

    def __init__(self, max_failures=2, min_width=1, max_restarts=4, **kw):
        super(Blacklist, self).__init__(max_restarts=max_restarts, **kw)
        self.max_failures = int(max_failures)
        self.min_width = int(min_width)

    def decide(self, event, restarts, failure_counts, excluded,
               num_executors, width=None):
        base = super(Blacklist, self).decide(
            event, restarts, failure_counts, excluded, num_executors)
        if base.action == Decision.FAIL:
            return base
        newly = {eid for eid, n in failure_counts.items()
                 if eid is not None and n >= self.max_failures} \
            - set(excluded)
        width_after = num_executors - len(set(excluded) | newly)
        if newly and width_after < self.min_width:
            return Decision(
                Decision.FAIL,
                reason="blacklisting {} would shrink the cluster below "
                       "min_width={}".format(sorted(newly), self.min_width))
        reason = base.reason
        if newly:
            reason += "; blacklisting executor(s) {} -> width {}".format(
                sorted(newly), width_after)
        return Decision(Decision.RESTART, delay=base.delay, exclude=newly,
                        reason=reason)


class ElasticResize(RestartFromCheckpoint):
    """Width as a RECOVERABLE dimension: on executor loss, reform
    immediately at width-1 instead of blacklisting (no permanence) or
    waiting for a replacement; when capacity returns, a regrow probe
    reforms back up at the next checkpoint boundary.

    Mechanics (docs/fault_tolerance.md "Elastic resize"):

    - ``executor_lost`` / ``reform_failed`` → ``Decision.RESIZE`` at
      the current width minus one (floored at ``min_width``; below it
      the job fails honestly). Un-ACKed feed partitions rebalance
      across the surviving width through the existing per-partition
      ACK ledger — nothing is lost, nothing double-fed.
    - ``shrink_grace_s``: before committing the shrink, the
      SupervisedCluster polls engine liveness for this long — a
      flapping executor that returns inside the grace keeps the
      original width (reform, not resize).
    - Regrow: during an attempt running below ``max_width`` (default:
      the job's configured width), the SupervisedCluster probes engine
      capacity every ``regrow_probe_s``; when spare executors exist it
      requests a BOUNDARY DRAIN — every trainer raises
      :class:`ResizeDrain` at its next ``TrainerSide.step`` site,
      which is AFTER that step's checkpoint committed and its
      partition was acked, so the reform up is exactly-once by the
      same argument as the chaos kill site.
    - Other failure kinds (trainer crash at intact width) fall back to
      the inherited same-width RestartFromCheckpoint behavior.

    ``max_restarts`` bounds ALL recovery reforms (shrinks included) so
    a flapping fleet cannot reform forever.
    """

    def __init__(self, min_width=1, max_width=None, shrink_grace_s=0.0,
                 regrow_probe_s=0.5, max_restarts=8, **kw):
        super(ElasticResize, self).__init__(max_restarts=max_restarts,
                                            **kw)
        self.min_width = int(min_width)
        self.max_width = None if max_width is None else int(max_width)
        self.shrink_grace_s = float(shrink_grace_s)
        self.regrow_probe_s = float(regrow_probe_s)

    def decide(self, event, restarts, failure_counts, excluded,
               num_executors, width=None):
        base = super(ElasticResize, self).decide(
            event, restarts, failure_counts, excluded, num_executors)
        if base.action == Decision.FAIL:
            return base
        if event.kind not in ("executor_lost", "reform_failed"):
            return base  # intact width: plain restart-from-checkpoint
        width = int(width) if width is not None \
            else num_executors - len(excluded)
        target = width - 1
        if target < self.min_width:
            return Decision(
                Decision.FAIL,
                reason="cannot shrink below min_width={} (width was "
                       "{})".format(self.min_width, width))
        return Decision(
            Decision.RESIZE, width=target,
            reason="{}; shrinking {} -> {} (no replacement "
                   "awaited)".format(base.reason, width, target))


class ResizeDrain(RuntimeError):
    """Raised by ``TrainerSide.step`` when the driver requested a
    boundary drain (elastic regrow): the trainer exits AT the
    checkpoint boundary — the just-committed step is restorable and
    its partition acked — so the reform up to the new width replays
    exactly the unconsumed remainder. Supervision-aware map_funs let
    it propagate (the supervisor treats the resulting attempt end as
    planned, not as a failure)."""


class RestartEngine(object):
    """Serving-plane recovery policy for :meth:`Supervisor.watch`: when
    a watched ``DecodeEngine``'s scheduler dies (uncaught loop error —
    NOT a deliberate stop/drain), rebuild the engine from its own
    construction config (``engine.respawn()``) with bounded exponential
    backoff and re-arm the ``ModelServer``, instead of leaving the
    replica answering 503 forever.

    The dying loop already failed every outstanding handle with the
    retriable ``serving.EngineFailed`` (clients retry; HTTP surfaces it
    as 503 + Retry-After), so a restart only has to bring the engine
    back for FRESH requests; ``tracing.Counters``' ``engine_restarts``
    counts the rebuilds (the respawned engine shares the dead one's
    counters). ``max_restarts`` bounds rebuilds per watch entry; when
    exhausted the server is marked unhealthy permanently — the same
    terminal state as an unwatched death, reached honestly.
    """

    def __init__(self, max_restarts=3, backoff=0.5, backoff_factor=2.0,
                 max_backoff=30.0):
        self.max_restarts = int(max_restarts)
        self.backoff = float(backoff)
        self.backoff_factor = float(backoff_factor)
        self.max_backoff = float(max_backoff)

    def decide(self, restarts):
        if restarts >= self.max_restarts:
            return Decision(
                Decision.FAIL,
                reason="gave up after {} engine restart(s)".format(restarts))
        delay = min(self.backoff * self.backoff_factor ** restarts,
                    self.max_backoff)
        return Decision(Decision.RESTART, delay=delay,
                        reason="engine restart {} of {}".format(
                            restarts + 1, self.max_restarts))


class SupervisorConfig(object):
    """Knobs for the supervision plane.

    Args:
      policy: recovery policy (default :class:`RestartFromCheckpoint`).
      heartbeat_interval: seconds between node heartbeat-lease beats
        (shipped to nodes via cluster_meta).
      heartbeat_timeout: lease age classified as executor loss. Must
        comfortably exceed the interval; 5x is a sane floor.
      stall_timeout: seconds of frozen feed progress (with a live
        trainer) classified as feeder stall / ring wedge. Set it above
        the slowest legitimate step time.
      poll_interval: monitor classification cadence.
      classify_grace: how long a surfaced task error waits for the
        monitor to attribute it to a lease before a generic event is
        synthesized.
      shutdown_timeout / drain_timeout: bounds on attempt teardown and
        post-abort job drain — a recovery must never hang on the very
        wedge it is recovering from.
      teardown_grace: seconds without feed progress a surviving trainer
        gets to reach its step boundary when an attempt is torn down
        (the nodes' shutdown floors it at 5). A survivor stopped between
        consuming a partition (acked) and committing its step loses that
        partition: set it above the slowest step plus its checkpoint
        save.
      straggler_skew: step-time skew (executor effective step time /
        fleet lower-median) at which an OBSERVE-ONLY ``straggler``
        incident is raised (goodput.StragglerDetector; None disables).
        Incidents never reach the recovery policy — skew is a capacity
        signal, not a failure.
      straggler_min_stall_s: floor below which a frozen step counter
        is not substituted for the EWMA (checkpoint pauses must not
        read as stalls).
    """

    def __init__(self, policy=None, heartbeat_interval=1.0,
                 heartbeat_timeout=15.0, stall_timeout=120.0,
                 poll_interval=0.5, classify_grace=3.0,
                 shutdown_timeout=120.0, drain_timeout=60.0,
                 straggler_skew=3.0, straggler_min_stall_s=5.0,
                 teardown_grace=1.0):
        self.policy = policy if policy is not None else RestartFromCheckpoint()
        self.heartbeat_interval = float(heartbeat_interval)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.stall_timeout = float(stall_timeout)
        self.poll_interval = float(poll_interval)
        self.classify_grace = float(classify_grace)
        self.shutdown_timeout = float(shutdown_timeout)
        self.drain_timeout = float(drain_timeout)
        self.straggler_skew = None if straggler_skew is None \
            else float(straggler_skew)
        self.straggler_min_stall_s = float(straggler_min_stall_s)
        self.teardown_grace = float(teardown_grace)


class Supervisor(object):
    """Driver-side monitor: aggregates leases, classifies failures,
    tracks recovery milestones, and watches serving engines.

    One instance supervises one cluster *attempt* (bound to that
    attempt's reservation ``Server``); the shared :class:`tracing
    .EventLog` carries the timeline across attempts. Also usable
    standalone (``Supervisor()``) purely as an engine watcher via
    :meth:`watch`.
    """

    def __init__(self, server=None, executors=(), config=None, events=None,
                 attempt=1, alive_fn=None, incidents=None):
        self.server = server
        self.executors = list(executors)
        self.config = config or SupervisorConfig()
        self.events = events if events is not None else tracing.EventLog()
        self.attempt = attempt
        #: OBSERVE-ONLY incidents (straggler skew): recorded with
        #: evidence like failures, but NEVER fed to a recovery policy.
        #: A SupervisedCluster passes one shared list so incidents
        #: survive across attempts (the EventLog idiom).
        self._incidents = incidents if incidents is not None else []
        self._straggler = None
        if self.config.straggler_skew is not None:
            self._straggler = goodput_mod.StragglerDetector(
                skew_threshold=self.config.straggler_skew,
                min_stall_s=self.config.straggler_min_stall_s)
        #: optional engine liveness view (Context.executors_alive): an
        #: executor whose process the ENGINE has already seen die is
        #: classified executor_lost immediately instead of waiting out
        #: heartbeat_timeout — the detect-stage win the elastic shrink
        #: MTTR leg measures
        self.alive_fn = alive_fn
        self._lock = threading.Lock()
        self._failures = []
        self._failure_evt = threading.Event()
        self._reported = set()      # executor ids already attributed
        self._progress = {}         # eid -> (feed_hb value, t of change)
        self._restored_step = None
        self._restored_seen = False
        self._first_step_seen = False
        self._watched = []          # serving engines under watch
        self._serving_watch = None  # executor-hosted fleet lease watch
        self._stop = threading.Event()
        self._thread = None
        self._started = time.monotonic()

    # -- lifecycle -------------------------------------------------------

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="tfos-supervisor", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # one last read of the leases: a milestone whose beat landed
        # after the monitor's last poll — a job's last step, carried only
        # by its node's final synchronous beat when the job ends right
        # after it — would otherwise never reach the event log, leaving
        # the MTTR stages without their first post-restore step
        if self.server is not None:
            try:
                self._track_recovery(self.server.lease_snapshot())
            except Exception:  # noqa: BLE001 - the log is best-effort
                logger.debug("final lease read failed", exc_info=True)

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - monitor must survive
                logger.exception("supervisor poll failed")
            self._stop.wait(self.config.poll_interval)

    # -- classification --------------------------------------------------

    def poll_once(self, now=None):
        """One classification pass (the monitor thread's body; exposed
        so unit tests drive it deterministically without the thread)."""
        now = now if now is not None else time.monotonic()
        self._classify_engine_liveness()
        if self.server is not None:
            leases = self.server.lease_snapshot()
            for event in self._classify(leases, now):
                self._report(event)
            self._track_recovery(leases)
            self._classify_stragglers(leases, now)
        self._check_watched()
        self._check_serving_leases()

    def _classify_engine_liveness(self):
        """Fast-path executor-lost detection from the engine's own
        liveness view: a lost connection is definitive (and near
        instant) evidence, so don't wait out heartbeat_timeout for the
        lease to age. Lease classification remains the backstop for
        engines without the view (Spark) and for processes that go
        dark without dying."""
        if self.alive_fn is None:
            return
        try:
            alive = set(self.alive_fn())
        except Exception:  # noqa: BLE001 - liveness view is best-effort
            return
        for eid in self.executors:
            if eid not in self._reported and eid not in alive:
                self._report(FailureEvent(
                    "executor_lost", eid,
                    "engine reports the executor process gone "
                    "(connection lost)"))

    def _classify(self, leases, now):
        """Lease snapshot -> new FailureEvents (one per executor, ever:
        an executor already attributed stays attributed)."""
        events = []
        cfg = self.config
        for eid in self.executors:
            if eid in self._reported:
                continue
            lease = leases.get(eid)
            if lease is None:
                # never beat at all: only suspicious once formation slack
                # has passed (the barrier opened before we were built, so
                # the first beat should land within one timeout)
                if now - self._started > cfg.heartbeat_timeout:
                    events.append(FailureEvent(
                        "executor_lost", eid,
                        "no heartbeat lease registered within "
                        "{:.0f}s".format(cfg.heartbeat_timeout)))
                continue
            payload = lease["payload"]
            state = payload.get("state")
            if state == "stopped":
                # Node lifecycle completed cleanly: nothing to classify.
                continue
            if lease["age"] > cfg.heartbeat_timeout \
                    and state != "terminating":
                # 'terminating' leases age out BY DESIGN: teardown
                # silences the beat thread after one final synchronous
                # beat, so a finished node aging past heartbeat_timeout
                # during a slow sibling's shutdown is NOT executor loss
                # (misattributing it would poison Blacklist's
                # failure_counts for a healthy executor). Crash evidence
                # carried by that final beat still classifies below.
                events.append(FailureEvent(
                    "executor_lost", eid,
                    "heartbeat lease expired (age {:.1f}s > "
                    "{:.0f}s)".format(lease["age"], cfg.heartbeat_timeout),
                    payload))
                continue
            exit_code = payload.get("trainer_exit")
            if exit_code not in (None, 0):
                events.append(FailureEvent(
                    "trainer_crash", eid,
                    "trainer exited with code {}".format(exit_code),
                    payload))
                continue
            if state == "error":
                events.append(FailureEvent(
                    "trainer_crash", eid, "node state is 'error'", payload))
                continue
            if payload.get("trainer_alive") is False and exit_code is None \
                    and state == "running":
                events.append(FailureEvent(
                    "trainer_crash", eid,
                    "trainer process dead with no exit status", payload))
                continue
            hb = payload.get("feed_hb")
            if hb is None or state != "running":
                continue
            prev = self._progress.get(eid)
            if prev is None or prev[0] != hb:
                self._progress[eid] = (hb, now)
            elif now - prev[1] > cfg.stall_timeout:
                kind = "ring_wedge" \
                    if payload.get("feed_transport") == "shm" \
                    else "feeder_stall"
                events.append(FailureEvent(
                    kind, eid,
                    "feed progress frozen at {} batches for {:.0f}s "
                    "with a live trainer".format(hb, now - prev[1]),
                    payload))
        return events

    def _report(self, event):
        with self._lock:
            if event.executor_id is not None:
                self._reported.add(event.executor_id)
            self._failures.append(event)
        self.events.record("failure_detected", attempt=self.attempt,
                           kind=event.kind, executor=event.executor_id,
                           detail=event.detail)
        # black-box postmortem: every classified failure carries
        # the flight recorder's recent tail — for a chaos run that is
        # the last thing each plane did before the incident, dumped
        # automatically instead of reconstructed from logs. Taken AFTER
        # the failure_detected record above, so the incident's own
        # classification instant is part of its dump.
        if "flight" not in event.payload:
            event.payload["flight"] = tracing.flight_recorder().tail(64)
        logger.error("supervisor detected failure: %s", event)
        self._failure_evt.set()

    def _track_recovery(self, leases):
        """Record the restore / first-post-restore-step milestones the
        MTTR stage breakdown is computed from."""
        for eid, lease in leases.items():
            payload = lease["payload"]
            restored = payload.get("restored_step")
            if restored is not None and not self._restored_seen:
                self._restored_seen = True
                self._restored_step = int(restored)
                self.events.record("restored", attempt=self.attempt,
                                   step=int(restored), executor=eid)
            step = payload.get("train_step")
            if step is not None and self._restored_seen \
                    and not self._first_step_seen \
                    and int(step) > (self._restored_step or 0):
                self._first_step_seen = True
                self.events.record("first_step", attempt=self.attempt,
                                   step=int(step), executor=eid)

    def _classify_stragglers(self, leases, now):
        """Observe-only skew detection (goodput plane): an executor
        whose effective step time (BEAT-carried EWMA, or its frozen
        step counter's age) exceeds the configured skew vs the fleet
        median raises a ``straggler`` INCIDENT — recorded with the
        offender's beat-carried metrics snapshot and the flight tail
        as evidence, exactly like a failure's, but never handed to a
        recovery policy: skew asks for an operator (or an autoscaler),
        not a restart."""
        if self._straggler is None:
            return
        # beats that STOPPED are a liveness problem, not a skew
        # signal: a dead node's frozen step counter would otherwise
        # read as a stall and fire a spurious straggler before the
        # heartbeat-timeout classification reports it lost (and its
        # inflated stall age would skew the median used to judge
        # genuinely slow survivors)
        stale_after = max(3 * self.config.heartbeat_interval, 3.0)
        views = {}
        for eid, lease in leases.items():
            payload = lease["payload"]
            if payload.get("role") == "serving":
                continue  # serving replicas have no train steps
            if lease.get("age", 0.0) > stale_after:
                continue  # beats stopped: liveness owns this executor
            if payload.get("state") in ("terminating", "stopped",
                                        "error") \
                    or payload.get("trainer_alive") is False:
                continue  # dying/dead: crash classification owns it
            if eid in self._reported:
                continue  # already attributed as a failure
            views[eid] = {"metrics": payload.get("metrics"),
                          "train_step": payload.get("train_step")}
        for finding in self._straggler.observe(views, now=now):
            eid = finding["executor_id"]
            payload = leases.get(eid, {}).get("payload", {})
            event = FailureEvent(
                "straggler", eid,
                "step time {}x the fleet median ({:.3f}s vs "
                "{:.3f}s{})".format(
                    finding["skew"], finding["effective_s"],
                    finding["median_s"],
                    "; step counter frozen" if finding["stalled"]
                    else ""),
                dict(payload))
            self._report_incident(event, finding)

    def _report_incident(self, event, detail=None):
        """Record an observe-only incident: evidence attached like
        :meth:`_report`'s, EventLog milestone recorded, but the event
        goes to :meth:`incidents` — never to the failure list the
        recovery loop drains."""
        self.events.record("incident", attempt=self.attempt,
                           kind=event.kind, executor=event.executor_id,
                           detail=event.detail)
        if "flight" not in event.payload:
            event.payload["flight"] = tracing.flight_recorder().tail(64)
        incident = event.as_dict()
        if detail:
            incident["detail_fields"] = dict(detail)
        with self._lock:
            self._incidents.append(incident)
        logger.warning("supervisor incident (observe-only): %s", event)

    def record_slo_incident(self, kind, detail, payload=None):
        """Public observe-only incident entry point for the serving SLO
        plane (:mod:`tensorflowonspark_tpu_torch.slo`): a burn-rate raise or
        canary drift lands in :meth:`incidents` with the standard
        evidence schema (payload + flight-recorder tail), never in the
        failure list the recovery loop drains — an SLO page is a human
        signal, not a restart trigger."""
        self._report_incident(
            FailureEvent(kind, "serving", detail, dict(payload or {})))

    def incidents(self):
        """Observe-only incidents recorded so far (straggler skew,
        serving SLO burn/drift); each carries the same evidence schema
        as a failure."""
        with self._lock:
            return list(self._incidents)

    # -- failure access --------------------------------------------------

    def first_failure(self):
        with self._lock:
            return self._failures[0] if self._failures else None

    def failures(self):
        with self._lock:
            return list(self._failures)

    def wait_for_failure(self, timeout):
        self._failure_evt.wait(timeout)
        return self.first_failure()

    # -- serving-plane watch ---------------------------------------------

    def watch(self, engine, server=None, restart=None, router=None,
              replica=None):
        """Watch a serving ``DecodeEngine``; when its scheduler thread
        dies (or the engine breaks), mark ``server`` (a ``ModelServer``)
        unhealthy so ``GET /healthz`` answers 503 — a dead scheduler
        must not leave the HTTP surface answering as if healthy.

        ``restart`` (a :class:`RestartEngine`) upgrades the response
        from mark-and-abandon to RECOVER: the dead engine is stopped,
        rebuilt via ``engine.respawn()`` after the policy's backoff,
        and re-armed on ``server`` (``attach_engine`` clears the
        unhealthy mark, /healthz returns to 200). Deliberate deaths —
        ``stop()`` / ``drain()`` flip ``stopping`` first — are never
        resurrected: an operator retiring a replica must not fight its
        own supervisor.

        Fleet plane: ``router`` (a ``fleet.FleetRouter``) is
        told to STOP ROUTING first — ``router.quiesce(replica_id)``
        lands before any restart work, so no fresh request races into
        the rebuild window — and readmitted only after a successful
        re-arm. ``replica`` (a ``fleet.Replica``) keeps the watch
        following the replica's CURRENT engine when something else
        swaps it (a rolling-drain upgrade re-points the watch at the
        successor instead of leaving it staring at a deliberately
        drained corpse)."""
        self._watched.append({"engine": engine, "server": server,
                              "restart": restart, "router": router,
                              "replica": replica, "restarts": 0,
                              "dead": False})
        self.start()
        return self

    def watch_fleet(self, fleet, restart=None):
        """Watch every IN-PROCESS replica of a ``fleet.ServingFleet``:
        a dead replica scheduler quiesces that replica at the router
        FIRST, then restarts through :class:`RestartEngine` (default
        policy; pass your own to re-tune), then readmits. One entry
        per replica, all driven by this supervisor's monitor thread.
        Executor-hosted replicas have no driver-side engine object to
        poll — they are covered by :meth:`watch_serving`'s lease
        classification instead."""
        for replica in fleet.replicas:
            if getattr(replica, "remote", False):
                continue
            self.watch(replica.engine, server=replica.server,
                       restart=restart if restart is not None
                       else RestartEngine(),
                       router=fleet.router, replica=replica)
        return self

    def watch_serving(self, fleet, stale_after=1.0):
        """Attribute EXECUTOR-HOSTED replica death: classify
        the fleet's serving BEAT leases the way cluster supervision
        classifies trainer leases. A replica whose lease expired
        (SIGKILLed executor — the beat died with the process) or whose
        lease says the engine is dead is quiesced at the router and
        reported ONCE per episode as an attributed ``serving_replica_
        lost`` failure with the last lease payload as evidence. No
        RestartEngine budget burns here — the driver cannot respawn an
        engine inside a dead executor; repair belongs to the
        autoscaler's replacement path (same identity, fresh fencing
        epoch), and a FENCED corpse that resurfaces is deliberately
        ignored (its replacement is the live story). Keep
        ``stale_after`` BELOW the autoscale policy's ``dead_after_s``
        (default 1.0 vs 3.0) so the attributed incident lands before
        the repair erases its evidence. Recovery —
        the lease returning fresh under a live engine — re-arms the
        episode and readmits nothing itself (the replacement path's
        wire-verified readmit already did)."""
        self._serving_watch = {"fleet": fleet,
                               "stale_after": float(stale_after),
                               "reported": set()}
        self.start()
        return self

    def _check_serving_leases(self):
        watch = self._serving_watch
        if watch is None:
            return
        fleet = watch["fleet"]
        recovering = getattr(fleet.reservation, "recovering",
                             None)  # stub reservations lack it
        if recovering is not None and recovering():
            # control-plane recovery grace: a restarted
            # journal-seeded reservation server knows the FLOORS but
            # has not heard the incumbents re-announce yet — every
            # lease looks expired for a beat interval or two. Those
            # are recovery artifacts, not deaths; classifying them
            # now would quiesce (and incident-report) a fleet of
            # perfectly healthy replicas.
            return
        snapshot = fleet.reservation.serving_snapshot()
        for replica in list(fleet.replicas):
            if not getattr(replica, "remote", False):
                continue
            rid = replica.replica_id
            info = snapshot.get(rid)
            age = (info or {}).get("age")
            gauges = (info or {}).get("serving") or {}
            epoch = (info or {}).get("epoch")
            current = fleet.reservation.lease_epoch(rid)
            if epoch is not None and current is not None \
                    and epoch < current:
                # superseded incarnation (replacement in flight or
                # already serving): the corpse's lease is history,
                # not a fresh failure
                continue
            dead = age is None or age > watch["stale_after"] \
                or gauges.get("alive") is False
            if dead and rid not in watch["reported"]:
                watch["reported"].add(rid)
                reason = ("serving lease expired (age {}s > {}s) — "
                          "executor presumed lost".format(
                              round(age, 2) if age is not None else None,
                              watch["stale_after"])
                          if age is None or age > watch["stale_after"]
                          else "lease fresh but engine dead")
                if fleet.router is not None:
                    fleet.router.quiesce(rid, reason, owner="supervisor")
                self.events.record("serving_replica_lost", replica=rid,
                                   executor=replica.executor_id,
                                   reason=reason)
                self._report(FailureEvent(
                    "serving_replica_lost", None,
                    "replica {} (executor {}): {}".format(
                        rid, replica.executor_id, reason),
                    payload={"lease": info, "replica": rid}))
            elif not dead and rid in watch["reported"]:
                watch["reported"].discard(rid)
                if fleet.router is not None:
                    # release OUR hold (owner-scoped): the lease
                    # recovered WITHOUT a replacement — a beat stall,
                    # not a death — so spawn_replica's force-clear
                    # will never run, and an unreleased supervisor
                    # quiesce would hold a healthy replica out of
                    # routing forever (a 1-replica fleet: 503s
                    # despite a live, beating replica)
                    fleet.router.readmit(rid, owner="supervisor")
                self.events.record("serving_replica_recovered",
                                   replica=rid)

    def _check_watched(self):
        for entry in self._watched:
            replica = entry.get("replica")
            if replica is not None and replica.engine is not None \
                    and replica.engine is not entry["engine"]:
                # the replica's engine was swapped out from under the
                # watch (rolling-drain upgrade / manual attach_engine):
                # follow the successor — the old corpse is retired by
                # design and must not trip a death report. HEAL only
                # the marks THIS WATCH applied (gated on "marked", and
                # the router hold is owner-scoped): a poll that read
                # the dying engine could have quiesced the router /
                # marked the server unhealthy AFTER the swapper's own
                # attach+readmit, which would otherwise strand a
                # healthy replica administratively DOWN forever. A
                # rolling drain's OWN hold is untouched — it releases
                # only after its wire-verified /healthz, so the heal
                # can never readmit an unverified successor on the
                # drain's behalf.
                entry["engine"] = replica.engine
                entry["dead"] = False
                if entry.pop("marked", False):
                    rid = getattr(entry["engine"], "replica_id", None)
                    if entry.get("router") is not None \
                            and rid is not None:
                        entry["router"].readmit(rid, owner="supervisor")
                    if entry.get("server") is not None:
                        entry["server"].attach_engine(entry["engine"])
            if replica is not None and getattr(replica, "fenced", False):
                # lease fencing: a FENCED replica is
                # administratively superseded — another holder owns its
                # identity's current epoch. Its engine's liveness is
                # irrelevant until a deliberate re_register(), and a
                # RestartEngine respawn here would burn restart budget
                # reviving a scheduler behind a server answering 410.
                # Report once per fence episode, then stand down.
                if not entry.get("fence_reported"):
                    entry["fence_reported"] = True
                    rid = getattr(entry["engine"], "replica_id", None)
                    self.events.record("replica_fenced", replica=rid)
                    self._report(FailureEvent(
                        "replica_fenced", None,
                        "replica {} fenced (stale lease epoch); "
                        "supervision suspended until re_register"
                        .format(rid)))
                continue
            entry.pop("fence_reported", None)  # re-registered: resume
            if entry["dead"]:
                continue
            health = entry["engine"].healthy()
            if health.get("alive"):
                continue
            if replica is not None and replica.engine is not None \
                    and replica.engine is not entry["engine"]:
                # the engine was swapped between the health read and
                # now (rolling drain racing this poll): do nothing —
                # the next poll's swap branch follows and heals
                continue
            entry["dead"] = True
            reason = "decode engine scheduler dead: {}".format(
                health.get("broken") or
                ("stopped" if health.get("stopping")
                 else "scheduler thread exited"))
            rid = getattr(entry["engine"], "replica_id", None)
            if entry.get("router") is not None and rid is not None:
                # fleet ordering contract: the router stops routing to
                # this replica BEFORE any recovery work, so the rebuild
                # window never absorbs fresh traffic. "marked" records
                # that this watch placed marks, so the swap-heal branch
                # above knows they are its own to clear
                entry["router"].quiesce(rid, reason, owner="supervisor")
                entry["marked"] = True
            self.events.record("engine_dead", reason=reason,
                               replica=rid)
            # evidence: the ENGINE's flight recorder tail — the spans
            # of the very requests in flight when the scheduler died
            flight = getattr(entry["engine"], "flight", None)
            self._report(FailureEvent(
                "engine_dead", None, reason,
                payload=None if flight is None
                else {"flight": flight.tail(64)}))
            if entry["restart"] is not None \
                    and not health.get("stopping") \
                    and not health.get("draining") \
                    and hasattr(entry["engine"], "respawn"):
                # draining counts as deliberate too: an engine that
                # crashes MID-DRAIN belongs to the operator retiring
                # it (ModelServer.drain is about to stop the server) —
                # respawning it would leak a fresh scheduler against a
                # server that is going away
                self._restart_engine(entry, reason)
                continue
            if entry["server"] is not None:
                entry["server"].mark_unhealthy(reason)
                entry["marked"] = True

    def _restart_engine(self, entry, reason):
        """Drive one RestartEngine recovery: decide -> backoff ->
        stop the corpse -> respawn -> re-arm, retrying failed respawns
        INSIDE this call until the policy exhausts. The retry loop must
        live here, not across polls: stopping the corpse flips its
        ``stopping`` flag, so a later poll would read the death as
        deliberate and silently disable recovery with restart budget
        remaining. Runs on the monitor thread (backoff + retries pause
        other classification — acceptable for a serving-only
        supervisor; use one Supervisor per concern if that bites)."""
        server = entry["server"]
        old = entry["engine"]
        while not self._stop.is_set():
            decision = entry["restart"].decide(entry["restarts"])
            if decision.action != Decision.RESTART:
                self.events.record("engine_restart_exhausted",
                                   reason=decision.reason)
                if server is not None:
                    server.mark_unhealthy(
                        "{} ({})".format(reason, decision.reason))
                    entry["marked"] = True
                return
            if server is not None:
                # 503 for the rebuild window: a restart takes real time
                # (backoff + engine construction) and the LB must not
                # route into it
                server.mark_unhealthy(
                    "engine restarting: {}".format(reason))
                entry["marked"] = True
            if decision.delay:
                logger.info("engine restart backing off %.1fs",
                            decision.delay)
                if self._stop.wait(decision.delay):
                    return  # supervisor stopped mid-backoff
            entry["restarts"] += 1
            try:
                # stop() joins the (dead) scheduler and fails any
                # handle the corpse still holds; respawn() rebuilds
                # from the engine's own construction config, sharing
                # its counters
                old.stop()
                fresh = old.respawn()
            except Exception as e:  # noqa: BLE001 - policy bounds retries
                logger.exception("engine respawn failed")
                self.events.record("engine_restart_failed", error=str(e))
                continue  # decide again: next attempt or exhaustion
            entry["engine"] = fresh
            entry["dead"] = False
            fresh.counters.inc("engine_restarts")
            if server is not None:
                server.attach_engine(fresh)
            rid = getattr(fresh, "replica_id", None)
            if entry.get("router") is not None and rid is not None:
                # re-arm order: engine attached (healthz back to 200)
                # BEFORE the router resumes routing to this replica;
                # releases only the supervisor's own hold
                entry["router"].readmit(rid, owner="supervisor")
            entry["marked"] = False
            self.events.record("engine_restarted",
                               restarts=entry["restarts"], reason=reason)
            logger.warning("decode engine restarted (restart %d): %s",
                           entry["restarts"], reason)
            return

    # -- remote abort ----------------------------------------------------

    def abort_attempt(self, cluster_info, cluster_meta, reason):
        """Flip every node's broker state to 'error' so blocked feeders,
        joins, and DataFeed consumers unwind (their bounded waits all
        check state) — the driver's only lever against a wedge that will
        never surface a task error on its own. Best effort per node."""
        import multiprocessing

        from tensorflowonspark_tpu_torch import manager
        authkey = bytes.fromhex(cluster_meta["authkey"])
        multiprocessing.current_process().authkey = authkey
        for node_meta in cluster_info:
            try:
                mgr = manager.connect(tuple(node_meta["mgr_addr"]), authkey)
                try:
                    mgr.get_queue("error").put(
                        "supervisor abort: {}".format(reason), block=False)
                except Exception:  # noqa: BLE001 - error queue may be full
                    pass
                mgr.set("state", "error")
            except Exception:  # noqa: BLE001 - node may be gone entirely
                logger.debug("abort could not reach executor %s",
                             node_meta.get("executor_id"), exc_info=True)


# -- supervised feed closures (run on executors) ---------------------------

def _drain_iter(iterator):
    for _ in iterator:
        pass


def acked_feed(cluster_info, cluster_meta, acked, feed_timeout=600,
               qname="input"):
    """Feed closure for ``mapPartitionsWithIndex``: feeds a partition to
    the local node and ACKs it against the reservation server once the
    node consumed it; partitions in ``acked`` (consumed by a previous
    attempt) are drained without feeding — the replay-only-unacked
    mechanic of RestartFromCheckpoint."""
    acked = frozenset(acked)

    def _fn(idx, iterator):
        from tensorflowonspark_tpu_torch import node as node_mod
        from tensorflowonspark_tpu_torch import reservation as reservation_mod
        if idx in acked:
            for _ in iterator:
                pass
            return iter(())
        consumed = node_mod._feed_one_partition(
            iterator, cluster_info, cluster_meta, feed_timeout, qname)
        if consumed:
            client = reservation_mod.Client(cluster_meta["server_addr"])
            try:
                client.ack(idx)
            finally:
                client.close()
        return iter(())

    return _fn


# -- trainer-side helpers --------------------------------------------------

class TrainerSide(object):
    """Trainer-process handle publishing recovery milestones.

    Writes ``restored_step`` / ``train_step`` into the node's broker kv,
    which the heartbeat lease carries to the driver — how the supervisor
    sees "restore finished" and "first post-restore step" without any
    new channel. Also hosts the chaos kill-at-step injection site, AFTER
    the step (and its checkpoint) committed, so a killed step N is
    restorable at N.
    """

    #: seconds between resize_drain polls in :meth:`step` — the drain
    #: check is one extra broker RPC, so fast step loops only pay it
    #: ~4x/second instead of per step; a pending drain is still caught
    #: at a step boundary, just up to this much later
    drain_poll_interval = 0.25

    #: seconds between forced metrics flushes in :meth:`step` (goodput
    #: plane): the step boundary force-publishes the feed registry —
    #: which carries the process goodput ledger — BEFORE the chaos
    #: kill site, so a killed trainer's accounting is current to
    #: within this throttle instead of the feed's 2s heartbeat window
    metrics_flush_interval = 0.5

    def __init__(self, mgr, restored_step=None, feed=None):
        self.mgr = mgr
        self.feed = feed
        self._drain_checked = float("-inf")
        self._flushed = float("-inf")
        if restored_step is not None:
            self.report_restore(restored_step)

    def report_restore(self, step):
        self.mgr.set("restored_step", int(step))
        self.mgr.set("train_step", int(step))

    def step(self, step):
        from tensorflowonspark_tpu_torch import chaos
        self.mgr.set("train_step", int(step))
        now = time.monotonic()
        if self.feed is not None \
                and now - self._flushed >= self.metrics_flush_interval:
            # flush BEFORE the kill site: a step-N kill must not lose
            # step N's goodput charges to the heartbeat throttle
            self._flushed = now
            try:
                self.feed.publish_metrics()
            except Exception:  # noqa: BLE001 - accounting best-effort
                pass
        chaos.on_step(int(step))
        # elastic regrow: the step site IS the checkpoint boundary
        # (callers publish AFTER the step's checkpoint committed and
        # its partition acked — the same discipline the chaos kill
        # site rides), so a driver-requested boundary drain exits here
        # and the reform up is exactly-once by construction
        now = time.monotonic()
        if now - self._drain_checked < self.drain_poll_interval:
            return
        self._drain_checked = now
        target = self.mgr.get("resize_drain")
        if target is not None:
            raise ResizeDrain(
                "resize drain requested at step {} (reforming at "
                "width {})".format(int(step), target))

    def hook(self, base=0):
        """``Trainer.train_loop`` hook: publishes ``base + step_no``."""
        def _hook(step_no, state, metrics):
            self.step(base + step_no)
        return _hook


def attach(ctx, restored_step=None, feed=None):
    """Supervision-aware map_fun boilerplate::

        restored = ckpt.restore(state, fallback=True)
        start = 0 if restored is None else int(restored["step"])
        sup = supervisor.attach(ctx, restored_step=start, feed=feed)
        ...
        sup.step(int(state["step"]))   # after each step's checkpoint

    ``feed`` (the map_fun's DataFeed): lets the step boundary
    force-flush the metrics/goodput snapshot before the chaos kill
    site — tighter accounting across a kill, optional otherwise."""
    return TrainerSide(ctx.mgr, restored_step=restored_step, feed=feed)


# -- MTTR extraction -------------------------------------------------------

def recovery_stages(events, kill_wall=None):
    """MTTR stage breakdown from a supervision :class:`tracing.EventLog`.

    Stages (seconds, None when the span's endpoints are absent):
    ``detect`` (fault injection -> failure_detected; needs ``kill_wall``,
    e.g. a chaos fuse's fire time), ``reform`` (failure_detected ->
    cluster_formed), ``restore`` (cluster_formed -> restored), and
    ``first_step`` (restored -> first post-restore step). ``mttr_s`` is
    fault->first_step when ``kill_wall`` is known, else
    detection->first_step.
    """
    detected = events.last("failure_detected")
    if detected is None:
        return None

    def _after(name):
        for event in events.events(name):
            if event["t"] >= detected["t"]:
                return event
        return None

    formed = _after("cluster_formed")
    restored = _after("restored")
    first = _after("first_step")

    def _span(a, b):
        return None if a is None or b is None else round(b["t"] - a["t"], 3)

    out = {
        "detect_s": None if kill_wall is None
        else round(detected["wall"] - kill_wall, 3),
        "reform_s": _span(detected, formed),
        "restore_s": _span(formed, restored),
        "first_step_s": _span(restored, first),
    }
    if first is not None:
        out["mttr_s"] = round(first["wall"] - kill_wall, 3) \
            if kill_wall is not None else round(first["t"] - detected["t"], 3)
    else:
        out["mttr_s"] = None
    return out


# -- the supervised cluster lifecycle --------------------------------------

class SupervisedCluster(object):
    """``cluster.run(..., supervise=cfg)``'s return value: the familiar
    ``train``/``shutdown`` surface with the detect->decide->recover loop
    inside.

    Built-in-engine semantics: attempts reform clusters on the same
    executor processes (a dead trainer is a child process; the executor
    survives), and :class:`Blacklist` exclusions route jobs away from an
    executor without restarting the engine. InputMode.SPARK jobs replay
    only unacked feed partitions; InputMode.TENSORFLOW jobs resubmit the
    whole (self-reading) map_fun, which restores from its checkpoint.
    """

    def __init__(self, sc, map_fun, tf_args, num_executors, config=None,
                 run_kwargs=None):
        from tensorflowonspark_tpu_torch import cluster as cluster_mod
        self._cluster_mod = cluster_mod
        self.sc = sc
        self.map_fun = map_fun
        self.tf_args = tf_args
        self.num_executors = int(num_executors)
        self.config = config if isinstance(config, SupervisorConfig) \
            else SupervisorConfig()
        self.run_kwargs = dict(run_kwargs or {})
        self.input_mode = self.run_kwargs.get(
            "input_mode", cluster_mod.InputMode.SPARK)
        self.events = tracing.EventLog()
        self.excluded = set()
        self.failure_counts = {}
        self.attempts = []          # one dict per FAILED attempt
        self.formations = 0
        #: the ONE width source of truth (elastic resize): every
        #: formation is exactly this wide. Blacklist exclusions and
        #: RESIZE decisions both update it (and record width_change),
        #: so /metrics' tfos_cluster_width gauge, the EventLog, and the
        #: formation math can never disagree.
        self.width = int(num_executors)
        self._resize_target = None  # planned regrow width, drain sent
        self._last_probe = 0.0
        self._acked = set()
        self._last_metrics = None   # rollup harvested before teardown
        #: goodput plane (goodput.py): the DRIVER's ledger charges only
        #: the windows no trainer exists to measure — reform (detect/
        #: teardown/backoff/formation) and planned resize-drain
        #: teardown; everything inside a live attempt is accounted by
        #: the executors' own ledgers, harvested per attempt below and
        #: folded by goodput_report()
        self.goodput = goodput_mod.GoodputLedger()
        self._goodput_wall_s = None  # frozen at job completion/failure
        self._attempt_rollups = {}  # formation ordinal -> last rollup
        self._next_form_category = "reform"
        #: observe-only incidents (straggler skew), shared across every
        #: attempt's Supervisor like the EventLog
        self.incidents = []
        self._tfc = None
        self._supervisor = None
        self._done = False
        self.events.record("job_start", num_executors=self.num_executors)
        self._form()

    # -- public surface --------------------------------------------------

    @property
    def cluster_info(self):
        return self._tfc.cluster_info if self._tfc is not None else None

    def tensorboard_url(self):
        return self._tfc.tensorboard_url() if self._tfc is not None else None

    def metrics(self):
        """Cluster-wide observability rollup (``TFCluster.metrics``
        shape): per-executor beat-carried feed-stage + step-rate series
        plus the merged cluster view. Live while an attempt is running;
        after shutdown (or between attempts) the view harvested from
        the last live cluster is returned, so a completed supervised
        job can still report what its executors measured. Safe against
        a concurrent teardown (the recovery loop nulls ``_tfc``): a
        harvest that loses that race just returns the previous view."""
        self._harvest_metrics()
        return self._last_metrics

    def metrics_url(self):
        """The live attempt's driver-side OpenMetrics URL
        (``TFCluster.metrics_url``), or None between attempts / after
        shutdown (each reformation binds a fresh stats port)."""
        tfc = self._tfc
        return tfc.metrics_url() if tfc is not None else None

    def train(self, dataRDD, num_epochs=0, feed_timeout=600, qname="input"):
        """Supervised feed: like ``TFCluster.train`` but partitions are
        acked as consumed, failures classify and recover per the policy,
        and the final (clean) shutdown happens inside — a successful
        ``train`` leaves nothing running. Raises when the policy gives
        up; ``report()`` carries the full timeline either way."""
        InputMode = self._cluster_mod.InputMode
        assert self.input_mode == InputMode.SPARK, \
            "supervised train() requires InputMode.SPARK"
        if hasattr(dataRDD, "foreachRDD"):
            raise NotImplementedError(
                "supervised streaming training is not supported; use the "
                "unsupervised cluster for DStreams")
        if num_epochs > 1:
            dataRDD = self.sc.union([dataRDD] * num_epochs)
        # the ack ledger is per-train(): partition ordinals are indices
        # into THIS dataRDD, and a second train() on a fresh dataset
        # must not inherit the first one's acks (it would silently drain
        # every colliding partition unfed — total data loss dressed up
        # as success)
        self._acked = set()
        self.events.record("train_start",
                           partitions=dataRDD.getNumPartitions())
        while True:
            if self._tfc is None:
                try:
                    self._form()
                except Exception as e:  # noqa: BLE001 - policy decides
                    self._recover_or_raise(
                        FailureEvent("reform_failed", None, str(e)))
                    continue
            failure = self._run_feed_attempt(dataRDD, feed_timeout, qname)
            if failure is None:
                failure = self._final_shutdown()
                if failure is None:
                    self._done = True
                    self._freeze_goodput_wall()
                    self._resize_target = None  # drain raced completion
                    self.events.record("job_complete",
                                       formations=self.formations)
                    return
            if self._resize_target is not None:
                if failure.kind in ("executor_lost", "feeder_stall",
                                    "ring_wedge", "reform_failed"):
                    # a REAL failure landed inside the drain window —
                    # kinds the drain itself can never produce (its
                    # trainers exit with code 1, classifying as
                    # trainer_crash/task_failure). The planned resize
                    # is moot: capacity just changed under it, so the
                    # policy must decide with the failure on the books
                    self._resize_target = None
                    self._recover_or_raise(failure)
                    continue
                # planned boundary drain (elastic regrow), not a real
                # failure: the trainers exited via ResizeDrain at their
                # checkpoint boundary — reform at the target width
                # without consulting the policy or advancing
                # failure_counts. (A genuine trainer crash racing the
                # drain is indistinguishable from the drain's own exit
                # and rides this path too — bounded at one uncounted
                # reform per regrow, and the reformed attempt's own
                # failures count normally.)
                self._complete_resize(failure)
                continue
            self._recover_or_raise(failure)

    def inference(self, dataRDD, feed_timeout=600, qname="output"):
        raise NotImplementedError(
            "supervised inference is not implemented: the result-RDD "
            "contract (exactly one output row per input record) has no "
            "replay story yet; run inference unsupervised")

    def shutdown(self, ssc=None, grace_secs=0, timeout=None):
        """SPARK mode: finalize (train() already supervised the work).
        TENSORFLOW mode: the supervised attempt loop lives HERE — each
        attempt awaits the inline map_fun job and a failure reforms the
        cluster so the resubmitted map_fun restores from its checkpoint.
        Returns :meth:`report`."""
        if ssc is not None:
            raise NotImplementedError(
                "supervised streaming shutdown is not supported")
        InputMode = self._cluster_mod.InputMode
        while not self._done:
            if self._tfc is None:
                try:
                    self._form()
                except Exception as e:  # noqa: BLE001 - policy decides
                    self._recover_or_raise(
                        FailureEvent("reform_failed", None, str(e)))
                    continue
            if self.input_mode == InputMode.TENSORFLOW:
                failure = self._await_result(self._tfc.async_result)
                if failure is None:
                    failure = self._final_shutdown(grace_secs=grace_secs)
            else:
                failure = self._final_shutdown(grace_secs=grace_secs)
            if failure is None:
                self._done = True
                self._freeze_goodput_wall()
                self.events.record("job_complete",
                                   formations=self.formations)
                break
            self._recover_or_raise(failure)
        return self.report()

    def report(self):
        """The supervision ledger: formations, failures, exclusions,
        ack coverage, MTTR stages, goodput accounting, observe-only
        incidents, and the raw event timeline."""
        return {
            "formations": self.formations,
            "failures": [a["failure"] for a in self.attempts],
            "width": self.width,
            "width_changes": [
                {k: e[k] for k in ("from_width", "to_width", "reason")}
                for e in self.events.events("width_change")],
            "excluded": sorted(self.excluded),
            "acked_partitions": len(self._acked),
            "recovery": recovery_stages(self.events),
            "goodput": self.goodput_report(),
            "incidents": list(self.incidents),
            "events": self.events.events(),
        }

    def goodput_report(self):
        """Job-level goodput accounting (goodput.job_report): the
        driver ledger's recovery windows folded with every attempt's
        merged executor categories, against this job's wall clock.
        Executor seconds are normalized by the configured width, so
        ``goodput_ratio`` reads in job wall-clock units (1.0 == every
        executor productive for the whole wall time); elastic attempts
        running below the configured width under-count proportionally
        — honest for a degraded job. ``profile_recovery`` prints it."""
        self._harvest_metrics()
        merged = []
        for ordinal in sorted(self._attempt_rollups):
            rollup = self._attempt_rollups[ordinal] or {}
            snap = (rollup.get("cluster") or {}).get("merged")
            if snap:
                merged.append(snap)
        # the wall denominator FREEZES when the job completes or fails
        # — a report read minutes after shutdown must describe the job,
        # not dilute its ratio with post-job elapsed time as idle
        wall = self._goodput_wall_s if self._goodput_wall_s is not None \
            else self.goodput.wall_s()
        return goodput_mod.job_report(
            wall, driver_ledger=self.goodput,
            merged_snapshots=merged, width=self.num_executors)

    def _freeze_goodput_wall(self):
        if self._goodput_wall_s is None:
            self._goodput_wall_s = self.goodput.wall_s()

    # -- attempt machinery -----------------------------------------------

    def _form(self):
        width = self.width
        attempt_no = len(self.attempts) + 1
        self.events.record("reform_start", attempt=attempt_no, width=width)
        # the formation window is recovery badput: "reform" normally,
        # "resize_drain" when this formation completes a planned
        # boundary drain (elastic regrow). The job's FIRST formation is
        # startup, not recovery — the taxonomy's reform means the
        # window BETWEEN attempts, and a clean zero-failure job must
        # report reform 0 — so it stays uncharged (it lands in the
        # report's idle residual)
        category, self._next_form_category = \
            self._next_form_category, "reform"
        if self.formations == 0 and category == "reform":
            category = None
        with self.goodput.track(category) if category \
                else contextlib.nullcontext():
            tfc = self._cluster_mod.run(
                self.sc, self.map_fun, self.tf_args, width,
                exclude_executors=frozenset(self.excluded),
                beat_interval=self.config.heartbeat_interval,
                prefer_alive=True,
                **self.run_kwargs)
        self.formations += 1
        self._tfc = tfc
        # width gauge: this formation's width against the job's
        # CONFIGURED width — width < target on /metrics is the
        # operator's "running degraded after a shrink" signal
        tfc.server.set_cluster_width(width, target=self.num_executors)
        self._supervisor = Supervisor(
            server=tfc.server, executors=tfc.executor_ids,
            config=self.config, events=self.events,
            attempt=attempt_no, incidents=self.incidents,
            alive_fn=getattr(self.sc, "executors_alive", None)).start()
        self.events.record("cluster_formed", attempt=attempt_no,
                           width=width, executors=list(tfc.executor_ids))

    def _run_feed_attempt(self, dataRDD, feed_timeout, qname):
        tfc = self._tfc
        mapped = dataRDD.mapPartitionsWithIndex(acked_feed(
            tfc.cluster_info, tfc.cluster_meta, frozenset(self._acked),
            feed_timeout=feed_timeout, qname=qname))
        # feed tasks may only run on executors HOSTING this formation's
        # nodes: after an elastic shrink (or mid-attempt regrow of
        # capacity) the engine can have alive executors that are not
        # cluster members, and a feed task landing there has no node to
        # feed. Blacklist exclusions fold into the same set.
        exclude = set(tfc.exclude)
        members = set(tfc.executor_ids)
        universe = set(range(self.num_executors)) | \
            set(self._capacity() or ())
        exclude |= universe - members
        kwargs = {"exclude": frozenset(exclude)} if exclude else {}
        result = mapped.foreachPartitionAsync(_drain_iter, **kwargs)
        failure = self._await_result(result, probe=self._regrow_probe)
        # harvest acks even on failure: the next attempt must not replay
        # what this one's trainers already consumed
        self._acked |= tfc.server.acked_partitions()
        return failure

    def _await_result(self, result, probe=None):
        """Poll a job result against the monitor; None on success, else
        the classified FailureEvent. A monitor-detected failure aborts
        the attempt remotely first so blocked tasks unwind. ``probe``
        (the elastic regrow capacity watch) runs once per poll."""
        sup = self._supervisor
        while True:
            if probe is not None:
                try:
                    probe()
                except Exception:  # noqa: BLE001 - probe is best-effort
                    logger.debug("regrow probe failed", exc_info=True)
            failure = sup.first_failure()
            if failure is not None:
                # monitor OFF before the remote abort: the abort flips
                # every node's state to 'error', and a still-polling
                # monitor would attribute those self-inflicted errors to
                # healthy executors — poisoning failure_counts, which
                # Blacklist decides exclusions from. The whole
                # abort+drain window is recovery badput (goodput
                # plane): the _recover_or_raise that follows continues
                # the same reform charge
                with self.goodput.track("reform"):
                    sup.stop()
                    sup.abort_attempt(self._tfc.cluster_info,
                                      self._tfc.cluster_meta,
                                      str(failure))
                    self._drain_result(result)
                return failure
            err = result.first_error()
            if err is not None:
                # task error beat the monitor: give classification one
                # grace window to attribute it to a lease
                failure = sup.wait_for_failure(self.config.classify_grace)
                # drain in-flight tasks BEFORE returning: a feed task
                # that consumed its partition may be one reply away
                # from completing — its ACK must land before the
                # caller harvests acked_partitions(), or the partition
                # replays against state that already contains it
                self._drain_result(result)
                return failure if failure is not None else FailureEvent(
                    "task_failure", None, str(err))
            if result.done():
                return None
            time.sleep(self.config.poll_interval)

    def _drain_result(self, result, timeout=None):
        deadline = time.monotonic() + (timeout or self.config.drain_timeout)
        while not result.done() and time.monotonic() < deadline:
            time.sleep(0.1)

    # -- elastic resize (regrow) -----------------------------------------

    def _elastic_policy(self):
        """The configured policy when it carries the elastic knobs
        (duck-typed: min_width/max_width/regrow_probe_s), else None."""
        policy = self.config.policy
        if all(hasattr(policy, a) for a in
               ("min_width", "max_width", "regrow_probe_s",
                "shrink_grace_s")):
            return policy
        return None

    def _capacity(self):
        """Alive, non-excluded engine executors (None without the
        engine's liveness view — Spark contexts cannot regrow)."""
        alive_fn = getattr(self.sc, "executors_alive", None)
        if alive_fn is None:
            return None
        try:
            return [e for e in alive_fn() if e not in self.excluded]
        except Exception:  # noqa: BLE001 - liveness view is best-effort
            return None

    def _regrow_probe(self):
        """Capacity watch, run from the attempt poll loop: when the
        job runs below its elastic max width and spare executors
        exist, request a boundary drain so the next checkpoint
        boundary reforms UP. One shot per attempt (the drain itself
        ends the attempt)."""
        policy = self._elastic_policy()
        if policy is None or self._resize_target is not None \
                or self._tfc is None:
            return
        now = time.monotonic()
        if now - self._last_probe < policy.regrow_probe_s:
            return
        self._last_probe = now
        max_width = policy.max_width if policy.max_width is not None \
            else self.num_executors
        if self.width >= max_width:
            return
        capacity = self._capacity()
        if capacity is None or len(capacity) <= self.width:
            return
        target = min(len(capacity), max_width)
        self._resize_target = target
        self.events.record("regrow_requested", width=self.width,
                           target=target, capacity=len(capacity))
        logger.warning("elastic regrow: capacity %d > width %d; "
                       "requesting boundary drain to reform at %d",
                       len(capacity), self.width, target)
        self._request_resize_drain(target)

    def _request_resize_drain(self, target):
        """Set every node's broker ``resize_drain`` key so each trainer
        exits via :class:`ResizeDrain` at its next step boundary
        (checkpoint committed, partition acked). Best effort per node —
        the analog of :meth:`Supervisor.abort_attempt`, but cooperative
        and boundary-aligned instead of immediate."""
        import multiprocessing

        from tensorflowonspark_tpu_torch import manager
        tfc = self._tfc
        if tfc is None:
            return
        authkey = bytes.fromhex(tfc.cluster_meta["authkey"])
        multiprocessing.current_process().authkey = authkey
        for node_meta in tfc.cluster_info:
            try:
                mgr = manager.connect(tuple(node_meta["mgr_addr"]), authkey)
                mgr.set("resize_drain", int(target))
            except Exception:  # noqa: BLE001 - node may be gone
                logger.debug("resize drain could not reach executor %s",
                             node_meta.get("executor_id"), exc_info=True)

    def _complete_resize(self, failure):
        """Finish a PLANNED resize: tear the drained attempt down and
        move width to the target — no policy consult, no
        failure_counts (the 'failure' here is the drain's own exit
        surfacing through the normal channels)."""
        target, self._resize_target = self._resize_target, None
        attempt_no = len(self.attempts) + 1
        self.events.record("attempt_teardown", attempt=attempt_no,
                           kind="resize_drain", surfaced=failure.kind)
        with self.goodput.track("resize_drain"):
            self._teardown(
                "resize drain (regrow to width {})".format(target),
                attempt_no=attempt_no)
        # the formation that completes the resize is part of its cost
        self._next_form_category = "resize_drain"
        self._record_width_change(target, "regrow: capacity returned")
        # the next loop iteration reforms at the new width

    def _record_width_change(self, new_width, reason):
        if new_width == self.width:
            return
        self.events.record("width_change", from_width=self.width,
                           to_width=new_width, reason=reason)
        logger.warning("cluster width %d -> %d (%s)", self.width,
                       new_width, reason)
        self.width = int(new_width)

    def _harvest_metrics(self):
        """Snapshot the live cluster's metrics rollup before a teardown
        discards it — a completed (or failed) supervised job must still
        be able to report what its executors measured. Reads ``_tfc``
        ONCE (a concurrent teardown may null it between check and use)
        and treats any failure as best-effort."""
        tfc = self._tfc
        if tfc is None:
            return
        try:
            rollup = tfc.metrics()
            self._last_metrics = rollup
            # per-ATTEMPT accumulation (goodput plane): each attempt's
            # trainers run fresh process ledgers, so the job's total
            # accounting is the SUM of attempts' merged snapshots;
            # within one attempt the counters are cumulative, so
            # overwriting by formation ordinal keeps only the latest
            # harvest of each attempt — unless the new harvest is
            # EMPTY (a final beat whose broker was already gone
            # carries metrics=None): never regress a rollup that has
            # data to one that lost it
            merged = (rollup.get("cluster") or {}).get("merged") or {}
            if any(merged.get(k) for k in ("counters", "timers",
                                           "hists")) \
                    or self.formations not in self._attempt_rollups:
                self._attempt_rollups[self.formations] = rollup
        except Exception:  # noqa: BLE001 - observability is best-effort
            logger.debug("metrics harvest failed", exc_info=True)

    def _final_shutdown(self, grace_secs=0):
        """Shut the live cluster down cleanly; None on success, else the
        failure it surfaced (monitor-attributed when possible)."""
        self._harvest_metrics()
        tfc, sup = self._tfc, self._supervisor
        try:
            tfc.shutdown(grace_secs=grace_secs,
                         timeout=self.config.shutdown_timeout)
        except Exception as e:  # noqa: BLE001 - classified below
            # A shutdown-surfaced error is usually the monitor's failure
            # seen through a different channel (a trainer killed so fast
            # its node drained the whole feed as error-state no-ops, so
            # the job "completed" before a beat carried the crash): give
            # classification one grace window to attribute it to a lease
            # — the exact analog of the task-error path in _await_result.
            # An unattributed shutdown_failure carries no executor_id and
            # can never advance Blacklist's failure_counts.
            failure = sup.wait_for_failure(self.config.classify_grace) \
                if sup is not None else None
            self._stop_monitor()
            self._tfc = None
            return failure if failure is not None else FailureEvent(
                "shutdown_failure", None, str(e))
        # re-harvest AFTER the shutdown join (goodput plane): the
        # trainers' FINAL accounting flush rides their last synchronous
        # beat, which only lands once node.shutdown has joined them —
        # the pre-shutdown harvest above would miss the last steps'
        # charges to the publish-throttle window. The lease payloads
        # stay readable in memory after Server.stop(); a failed
        # re-harvest keeps the earlier one (best-effort either way).
        self._harvest_metrics()
        self._stop_monitor()
        self._tfc = None
        return None

    def _stop_monitor(self):
        if self._supervisor is not None:
            self._supervisor.stop()

    def _teardown_attempt(self, attempt_no, failure):
        self.events.record("attempt_teardown", attempt=attempt_no,
                           kind=failure.kind)
        self._teardown(str(failure), attempt_no=attempt_no)

    def _teardown(self, reason, attempt_no=None):
        """Tear the live attempt down after a failure or planned drain:
        abort surviving nodes FIRST (their trainers may still be
        consuming — an executor loss ends the feed job without ever
        delivering EndFeed to the survivors, and a shutdown join with a
        dead executor raises before dispatching), then best-effort
        shutdown."""
        self._harvest_metrics()
        sup = self._supervisor
        self._stop_monitor()
        tfc, self._tfc = self._tfc, None
        if tfc is None:
            return
        try:
            (sup or Supervisor()).abort_attempt(
                tfc.cluster_info, tfc.cluster_meta, reason)
        except Exception:  # noqa: BLE001 - nodes may all be gone
            logger.debug("attempt abort failed", exc_info=True)
        # Shut down the members still alive. With a lost member the
        # shutdown job (one task per member) fails at dispatch and
        # reaches no survivor: a surviving trainer inside its consume ->
        # commit window (its partition consumed and acked, its step not
        # yet checkpointed) would run on against a stopped reservation
        # server and die uncommitted, losing an acked partition. Shut
        # down, each survivor's trainer gets EndFeed and teardown_grace
        # to reach its step boundary while the server still answers.
        alive_fn = getattr(self.sc, "executors_alive", None)
        try:
            alive = set(alive_fn()) if alive_fn is not None else None
        except Exception:  # noqa: BLE001 - liveness view is best-effort
            alive = None
        if alive is not None:
            members = [e for e in tfc.executor_ids if e in alive]
            if members and len(members) < len(tfc.executor_ids):
                tfc.executor_ids = members
                # a revived executor under a lost member's id hosts no
                # node of this attempt
                tfc.exclude = frozenset(set(tfc.exclude)
                                        | (alive - set(members)))
        try:
            tfc.shutdown(grace_secs=self.config.teardown_grace,
                         timeout=self.config.shutdown_timeout)
        except Exception as e:  # noqa: BLE001 - this IS the failure
            logger.info("attempt %s teardown surfaced: %s",
                        attempt_no if attempt_no is not None else "?", e)

    def _recover_or_raise(self, failure):
        # the whole recovery window — teardown, decision, backoff —
        # is reform badput on the driver ledger (the next _form adds
        # the formation itself); the context closes on the FAIL raise
        # path too
        with self.goodput.track("reform"):
            self._recover_or_raise_inner(failure)

    def _recover_or_raise_inner(self, failure):
        attempt_no = len(self.attempts) + 1
        restarts = len(self.attempts)  # restarts already performed
        self.attempts.append({"attempt": attempt_no,
                              "failure": failure.as_dict()})
        if failure.executor_id is not None:
            self.failure_counts[failure.executor_id] = \
                self.failure_counts.get(failure.executor_id, 0) + 1
        self._teardown_attempt(attempt_no, failure)
        decision = self._decide(failure, restarts)
        self.events.record("decision", attempt=attempt_no,
                           action=decision.action, delay=decision.delay,
                           exclude=sorted(decision.exclude),
                           width=decision.width,
                           reason=decision.reason)
        if decision.action == Decision.FAIL:
            self._done = True
            self._freeze_goodput_wall()
            self.events.record("job_failed", attempt=attempt_no,
                               kind=failure.kind)
            raise RuntimeError(
                "supervised job failed after {} attempt(s) — {} ({})".format(
                    attempt_no, failure, decision.reason))
        if decision.action == Decision.RESIZE:
            self._apply_shrink(decision)
        if decision.exclude:
            self.excluded |= set(decision.exclude)
            self.events.record("blacklisted",
                               executors=sorted(decision.exclude))
            # blacklist and resize share ONE width source of truth
            self._record_width_change(
                self.num_executors - len(self.excluded),
                "blacklist: excluded {}".format(sorted(decision.exclude)))
        if decision.delay:
            logger.info("supervisor backing off %.1fs before restart",
                        decision.delay)
            time.sleep(decision.delay)
        # the next loop iteration (train) or shutdown pass reforms

    def _decide(self, failure, restarts):
        """Consult the policy, passing the current width only to
        policies that take it — user-defined policies implementing the
        pre-elastic 5-argument ``decide`` signature keep working."""
        import inspect
        policy = self.config.policy
        kwargs = {}
        try:
            params = inspect.signature(policy.decide).parameters
            if "width" in params or any(
                    p.kind == inspect.Parameter.VAR_KEYWORD
                    for p in params.values()):
                kwargs["width"] = self.width
        except (TypeError, ValueError):  # unintrospectable callable
            pass
        return policy.decide(
            failure, restarts, dict(self.failure_counts),
            frozenset(self.excluded), self.num_executors, **kwargs)

    def _apply_shrink(self, decision):
        """Commit (or cancel) a RESIZE decision: hold for the policy's
        shrink grace first — a flapping executor that returns within it
        keeps the original width (reform, not resize)."""
        grace = getattr(self.config.policy, "shrink_grace_s", 0.0)

        def _capacity_back():
            capacity = self._capacity()
            return capacity is not None and len(capacity) >= self.width

        deadline = time.monotonic() + max(0.0, grace)
        returned = _capacity_back()
        while not returned and time.monotonic() < deadline:
            time.sleep(0.05)
            returned = _capacity_back()
        if returned:
            self.events.record("shrink_cancelled", width=self.width,
                               reason="capacity available within "
                                      "shrink grace")
            logger.warning("shrink to %s cancelled: capacity for width "
                           "%d is available", decision.width, self.width)
            return
        self._record_width_change(decision.width, decision.reason)
