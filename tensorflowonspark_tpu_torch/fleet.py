"""Serving fleet: replica registry + metrics-driven router — the port's
copy of ``tensorflowonspark_tpu/fleet.py``, on the port's
``DecodeEngine`` / ``ModelServer``.

One ``DecodeEngine`` + ``ModelServer`` per process is the serving
ceiling; the reference design (SURVEY: ``TFCluster.run()`` fan-out)
points past it — many identical workers behind one dispatch point.
This module is that dispatch point, stitched through the planes the
port already has:

- **Registry** — N replicas (in-process, or in executor processes)
  ride the reservation server's BEAT leases (reservation.py): each
  :class:`Replica` beats a ``role: "serving"`` payload carrying its
  HTTP address and the engine's live load gauges
  (``DecodeEngine.load_stats``: queue depth, slot occupancy,
  queue-wait EWMA, alive/draining, the prefix digest) plus its
  metrics-registry snapshot. ``Server.serving_snapshot()`` is the
  router's one view of the fleet.
- **Router** — :class:`FleetRouter`, a standalone HTTP front end
  (``POST :generate``, ``GET /healthz``, ``GET /metrics`` with
  per-replica labels, ``GET /debug/trace`` stitched across replicas)
  doing least-loaded, prefix- and session-aware dispatch from those
  live gauges. Failover rides the serving error taxonomy: ``Shed`` /
  ``Draining`` / ``EngineFailed`` / connection failures are retriable,
  so the router re-dispatches to the next-best replica through
  ``serving.retry_call`` (bounded backoff + full jitter, honoring
  ``Retry-After``); only ``EngineFailed``-shaped failures count
  against a replica's health. Hedging, tenant spread and quotas, and
  the two-stage prefill -> decode dispatch over ``:prefill`` /
  ``/kv/splice`` sit on the same path.
- **Health** — :class:`ReplicaHealth`: repeated failures (or a dead
  lease) stop routing to a replica; after a cooldown it goes HALF-OPEN
  and the router's probe loop verifies ``/healthz`` before readmitting.
- **Rolling drain** — :meth:`FleetRouter.rolling_drain`: one replica
  at a time, quiesce -> ``engine.drain()`` (zero loss) -> successor
  engine (``respawn()``, or ``upgrade=`` for a weight swap) ->
  ``attach_engine`` -> ``/healthz`` over the wire -> readmit.
- **Control plane** — lease epochs fence a superseded replica, control
  epochs fence a deposed router (:class:`RouterStandby`), and a
  ``journal=`` (``controlstate``) keeps both monotonic across
  :meth:`ServingFleet.restart_reservation`.

The dispatch policy (:func:`route_order`, :func:`affinity_plan`) and
the health state machine are PURE — time injected, no sockets.

Weights. In-process replicas (``placement="driver"``) each get their
own copy of the caller's module, so a rolling ``upgrade=`` swaps only
the drained replica's weights. Executor-hosted replicas
(``placement="executors"``) never receive a module: the spec carries
the module's class, its constructor config and its ``state_dict`` as
host numpy arrays (:func:`module_spec`; bfloat16 as its 16-bit
pattern), and the executor's :class:`ServingNode` builds the module
on its own device
(``engine_kw["device"]``, default the card).

Policy planes: :meth:`ServingFleet.supervise` arms a
``supervisor.Supervisor`` (a dead in-process scheduler is quiesced at
the router, restarted through ``RestartEngine`` and readmitted; a lost
executor-hosted replica is attributed from its lease), and
:meth:`ServingFleet.autoscale` an ``autoscale.AutoscaleController``
over the width verbs (:meth:`ServingFleet.spawn_replica`,
:meth:`~ServingFleet.retire_replica`,
:meth:`~ServingFleet.replace_replica`).

In-process quickstart (the shape ``cluster.serving_fleet`` wraps)::

    with ServingFleet(model, replicas=3, name="lm") as f:
        url = "http://%s:%d" % f.router_addr
        # POST {url}/v1/models/lm:generate   -> routed + failover
        f.rolling_drain()                  # zero-loss engine cycle
"""

import collections
import copy
import http.client
import importlib
import inspect
import json
import logging
import math
import os
import random
import socket
import threading
import time
import uuid

import numpy as np
import torch

from tensorflowonspark_tpu_torch import chaos, device_info, paging, \
    reservation, serving, tracing
from tensorflowonspark_tpu_torch import slo as slo_mod
from tensorflowonspark_tpu_torch.qos import (
    DEFAULT_PRIORITY, QosPolicy, QuotaExceeded, QuotaTable,
    validate_priority, validate_tenant)

logger = logging.getLogger(__name__)

#: lease age (seconds) past which a replica's gauges are too stale to
#: route on — the router's default; a beat interval fits ~8x inside it
DEFAULT_STALE_AFTER = 2.0

#: default TCP connect bound for upstream exchanges (seconds): a
#: black-holed SYN (partitioned replica) must fail over in this long,
#: not the full read timeout a long generation legitimately needs
DEFAULT_CONNECT_TIMEOUT = 5.0


class NoReplicaAvailable(serving.Retriable):
    """The router found no routable replica (all stale, down, draining,
    or dead). Retriable — replicas recover, leases refresh."""

    def __init__(self, msg, retry_after=0.5):
        super(NoReplicaAvailable, self).__init__(msg)
        self.retry_after = float(retry_after)


class ReplicaUnavailable(serving.Retriable):
    """One upstream attempt failed for a transient reason; the next
    attempt should go to the next-best replica. ``retry_after=0`` when
    other candidates remain (immediate failover — waiting would only
    add latency), the upstream's Retry-After once the fleet is
    exhausted for this pass."""

    def __init__(self, msg, retry_after=0.0):
        super(ReplicaUnavailable, self).__init__(msg)
        self.retry_after = float(retry_after)


# -- dispatch policy (pure: no sockets, time injected) ---------------------

def load_score(view):
    """Order key for least-loaded dispatch: primary = work the replica
    holds (queued + occupied slots + requests this router already has
    open against it — the router's own in-flight count covers the beat
    staleness window, when a burst it just dispatched is not yet in
    any gauge); secondary = the replica's queue-wait EWMA (two equally
    backlogged replicas differ in how fast they drain); final =
    replica_id, so ties break deterministically."""
    return (int(view.get("queue_depth") or 0)
            + int(view.get("slot_occupancy") or 0)
            + int(view.get("inflight") or 0),
            float(view.get("queue_wait_ewma_s") or 0.0),
            str(view.get("replica_id")))


def route_order(views, stale_after=DEFAULT_STALE_AFTER):
    """Pure dispatch policy: replica view dicts -> replica ids to try,
    best first. Excluded entirely: stale leases (``age`` missing or >
    ``stale_after`` — gauges that old describe a replica that may no
    longer exist), dead engines (``alive`` False), draining replicas,
    and DOWN health states. HEALTHY candidates come first, least
    loaded to most (:func:`load_score`); PROBE candidates (half-open:
    cooldown expired, recovery unverified) rank after every healthy
    one — they get traffic only as a last resort; the probe loop's
    out-of-band /healthz check is the normal readmission path."""
    healthy, probing = [], []
    for view in views:
        age = view.get("age")
        if age is None or age > stale_after:
            continue
        if view.get("alive") is False:
            continue
        if view.get("draining"):
            continue
        state = view.get("state", ReplicaHealth.UP)
        if state == ReplicaHealth.DOWN:
            continue
        bucket = probing if state == ReplicaHealth.PROBE else healthy
        bucket.append((load_score(view), str(view.get("replica_id"))))
    healthy.sort()
    probing.sort()
    return [rid for _, rid in healthy] + [rid for _, rid in probing]


def view_tier(view):
    """One replica view's serving tier: ``"prefill"``,
    ``"decode"``, or ``"mixed"`` — absent/falsy gauges (every pre-tier
    replica) read as ``"mixed"``, the full-service default."""
    return str(view.get("tier") or "mixed")


def decode_eligible(views):
    """The views a ``:generate`` may land on: everything EXCEPT
    dedicated prefill-tier replicas, which exist to fill KV blocks and
    ship them — routing a decode stream onto one would burn its
    compute budget on the slow phase the split exists to isolate.
    Degenerate fleets (every replica prefill-tier — a misconfiguration
    mid-rollout) fall back to all views: serving slowly beats 503."""
    eligible = [v for v in views if view_tier(v) != "prefill"]
    return eligible if eligible else views


# -- prefix/session affinity (pure policy + TTL'd map) --------------

#: seconds a session -> replica affinity entry stays trusted without a
#: fresh dispatch renewing it. Long enough to span a human turn gap,
#: short enough that an entry pointing at a replica whose cache has
#: since churned (or that left the fleet quietly) self-heals
DEFAULT_AFFINITY_TTL = 30.0

#: the load guard: extra backlog (queued + occupied + router-inflight)
#: a WARM replica may carry over the least-loaded routable one and
#: still win the request. Past this, affinity loses to load — a warm
#: replica must never become a hotspot amplifier
DEFAULT_LOAD_GUARD = 4


def digest_match(view, tokens):
    """Matched prefix depth — in FULL blocks, 0 = cold — of a prompt's
    ``tokens`` against one replica view's beat-carried prefix digest.
    Pure: hashes the prompt's chain prefixes with the SAME
    :func:`paging.chain_digest` the pool published with, deepest
    first, and returns the first (deepest) resident chain. Each
    view's own ``prefix_digest_block_size`` governs the chain
    boundaries, so a heterogeneous fleet (mixed block sizes, or
    contiguous replicas publishing the zero schema) matches
    correctly per replica."""
    digest = view.get("prefix_digest") or []
    block_size = int(view.get("prefix_digest_block_size") or 0)
    if not digest or block_size <= 0 or not tokens:
        return 0
    depths = {}
    for entry in digest:
        try:
            depths[str(entry[0])] = max(depths.get(str(entry[0]), 0),
                                        int(entry[1]))
        except (TypeError, ValueError, IndexError):
            continue
    if not depths:
        return 0
    shareable = max(0, (len(tokens) - 1) // block_size)
    for j in range(min(shareable, max(depths.values())), 0, -1):
        if paging.chain_digest(tokens, j * block_size) in depths:
            return j
    return 0


def affinity_plan(views, digest_matches=None, session_hint=None,
                  stale_after=DEFAULT_STALE_AFTER,
                  load_guard=DEFAULT_LOAD_GUARD):
    """:func:`affinity_order` plus the bookkeeping the router's
    counters need: ``(order, info)`` where ``info`` carries
    ``promoted`` (warm replicas that won their preference),
    ``guarded`` (warm replicas the load guard demoted back to their
    load-order position), and ``hint_routable`` (whether the session's
    remembered replica survived :func:`route_order`'s health gates at
    all — False is the failover-COLD signal: the warm replica is dead,
    draining, or stale, and the request must proceed cold rather than
    error)."""
    base = route_order(views, stale_after)
    matches = digest_matches or {}
    hint = str(session_hint) if session_hint is not None else None
    info = {"promoted": [], "guarded": [],
            "hint_routable": hint is not None and hint in base}
    if not base:
        return base, info
    by_rid = {str(v.get("replica_id")): v for v in views}

    def _backlog(rid):
        v = by_rid.get(rid) or {}
        return (int(v.get("queue_depth") or 0)
                + int(v.get("slot_occupancy") or 0)
                + int(v.get("inflight") or 0))

    coldest = min(_backlog(rid) for rid in base)
    warm = []
    for pos, rid in enumerate(base):
        depth = int(matches.get(rid) or 0)
        is_hint = hint is not None and rid == hint
        if not is_hint and depth <= 0:
            continue
        view = by_rid.get(rid) or {}
        if view.get("state") == ReplicaHealth.PROBE:
            # a half-open replica's warmth must not defeat the
            # last-resort ranking its unverified recovery earned
            continue
        # session affinity outranks digest warmth (the session's
        # replica holds the conversation's GENERATED chain, which a
        # digest truncated at top-K may not show); among digest
        # matches, deeper resident prefix = more prefill skipped
        warm.append((0 if is_hint else 1, -depth, pos, rid))
    warm.sort()
    for _, _, _, rid in warm:
        view = by_rid.get(rid) or {}
        slots = int(view.get("slots") or 0)
        saturated = slots > 0 \
            and int(view.get("slot_occupancy") or 0) >= slots \
            and int(view.get("queue_depth") or 0) > 0
        if saturated or _backlog(rid) - coldest > load_guard:
            # the load guard: a warm replica carrying materially more
            # backlog than the least-loaded routable one loses the
            # request COLD — affinity is a preference, never a
            # hotspot amplifier
            info["guarded"].append(rid)
            continue
        info["promoted"].append(rid)
    promoted = info["promoted"]
    order = promoted + [rid for rid in base if rid not in promoted]
    return order, info


def affinity_order(views, digest_matches=None, session_hint=None,
                   stale_after=DEFAULT_STALE_AFTER,
                   load_guard=DEFAULT_LOAD_GUARD):
    """Pure prefix/session-aware dispatch order, composed WITH
    :func:`route_order` (never around it — health, staleness, and
    drain exclusions always win): warm replicas (the session's
    remembered replica first, then digest matches by descending
    resident depth) are promoted ahead of the load ranking, EXCEPT
    any whose backlog exceeds the least-loaded routable replica's by
    more than ``load_guard`` (or whose slots are saturated with a
    standing queue) — those keep their plain load-order position.
    Replicas excluded by :func:`route_order` never appear, however
    warm: a dead or draining warm replica fails over cold by
    construction."""
    return affinity_plan(views, digest_matches, session_hint,
                         stale_after, load_guard)[0]


class AffinityMap(object):
    """TTL'd, capacity-bounded ``session/prefix key -> replica_id``
    map — the router's dispatch memory. Thread-safe (dispatch threads
    note and look up concurrently; drain/retire purge from control
    threads); every read of an entry validates its TTL, so a stale
    entry is evidence-free and self-evicts rather than steering a
    conversation at a replica whose cache has long since churned.
    Capacity is LRU over NOTE recency: the map must stay bounded no
    matter how many one-shot sessions pass through."""

    def __init__(self, capacity=2048, ttl_s=DEFAULT_AFFINITY_TTL,
                 now=time.monotonic):
        self.capacity = max(1, int(capacity))
        self.ttl_s = float(ttl_s)
        self._now = now
        self._lock = threading.Lock()
        self._entries = collections.OrderedDict()  # key -> (rid, stamp)

    def note(self, key, replica_id, now=None):
        """Record (or renew) ``key``'s affinity for ``replica_id``,
        evicting the least-recently-noted entry past capacity."""
        if key is None:
            return
        now = now if now is not None else self._now()
        with self._lock:
            self._entries.pop(str(key), None)
            self._entries[str(key)] = (str(replica_id), now)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def lookup(self, key, now=None):
        """``key``'s remembered replica id, or None (unknown or
        expired — expired entries are evicted on the spot)."""
        if key is None:
            return None
        now = now if now is not None else self._now()
        with self._lock:
            entry = self._entries.get(str(key))
            if entry is None:
                return None
            rid, stamp = entry
            if now - stamp > self.ttl_s:
                self._entries.pop(str(key), None)
                return None
            return rid

    def evict(self, key):
        """Drop ``key``; True when an entry actually existed (the
        caller's once-per-incident counter guard)."""
        with self._lock:
            return self._entries.pop(str(key), None) is not None

    def purge_replica(self, replica_id):
        """Drop every entry pointing at ``replica_id`` — retirement /
        rolling drain make the replica's cache unreachable (or gone),
        so steering sessions at it would be pure harm. Returns the
        purge count."""
        rid = str(replica_id)
        with self._lock:
            stale = [k for k, (r, _) in self._entries.items()
                     if r == rid]
            for key in stale:
                self._entries.pop(key)
            return len(stale)

    def __len__(self):
        with self._lock:
            return len(self._entries)


class ReplicaHealth(object):
    """Per-replica failure tracking with half-open recovery. Pure state
    machine (``now`` injected everywhere) so the transition table is
    unit-testable without sockets; thread-safe because the dispatch
    threads and the probe loop both write.

    States: UP (routable) -> DOWN after ``fail_threshold`` consecutive
    failures, for a cooldown that doubles per consecutive down period
    (capped at ``max_cooldown``) -> PROBE once the cooldown expires
    (half-open: eligible for ONE verification — the router's probe
    loop GETs /healthz) -> UP on success, DOWN again (longer) on
    failure. :meth:`quiesce` is the administrative override (rolling
    drain, supervisor restart window): DOWN with no probe path until
    :meth:`readmit` — the operator knows when the replica is back, the
    router must not guess."""

    UP, DOWN, PROBE = "up", "down", "probe"

    def __init__(self, fail_threshold=2, cooldown=1.0,
                 cooldown_factor=2.0, max_cooldown=30.0):
        self.fail_threshold = max(1, int(fail_threshold))
        self.cooldown = float(cooldown)
        self.cooldown_factor = float(cooldown_factor)
        self.max_cooldown = float(max_cooldown)
        self._lock = threading.Lock()
        self._r = {}  # rid -> {fails, downs, down_until, quiesced}

    def _rec(self, rid):
        return self._r.setdefault(str(rid), {
            "fails": 0, "downs": 0, "down_until": None, "quiesced": {}})

    def state(self, rid, now):
        with self._lock:
            rec = self._r.get(str(rid))
            if rec is None:
                return self.UP
            if rec["quiesced"]:
                return self.DOWN
            if rec["down_until"] is None:
                return self.UP
            return self.DOWN if now < rec["down_until"] else self.PROBE

    def note_success(self, rid, now=None):
        """A request (or probe) against ``rid`` succeeded: full reset —
        consecutive-failure count, down state, AND the cooldown
        escalation (a replica that proved itself healthy starts its
        next incident from the base cooldown).

        EXCEPT during an active cooldown (now < down_until): a success
        landing there is STALE evidence — a long request admitted
        before the replica went down, completing after (nothing is
        routed to a DOWN replica, so no fresh evidence can exist).
        Honoring it would re-open a just-downed replica and let one
        straggler completion defeat the geometric escalation a
        flapping replica earns; recovery from DOWN goes through the
        half-open probe, never through leftovers."""
        with self._lock:
            rec = self._r.get(str(rid))
            if rec is None or rec["quiesced"]:
                return
            if rec["down_until"] is not None:
                now = now if now is not None else time.monotonic()
                if now < rec["down_until"]:
                    return
            rec.update(fails=0, downs=0, down_until=None)

    def note_failure(self, rid, now, reason=""):
        """A request (or probe) against ``rid`` failed for a
        health-relevant reason (engine death, connection failure —
        NOT shed/backpressure). A failure while half-open re-downs
        immediately with an escalated cooldown; otherwise failures
        count toward ``fail_threshold``."""
        with self._lock:
            rec = self._rec(rid)
            half_open = rec["down_until"] is not None \
                and now >= rec["down_until"]
            rec["fails"] += 1
            if half_open or rec["fails"] >= self.fail_threshold:
                rec["fails"] = 0
                rec["downs"] += 1
                hold = min(
                    self.cooldown
                    * self.cooldown_factor ** (rec["downs"] - 1),
                    self.max_cooldown)
                rec["down_until"] = now + hold
                logger.warning(
                    "replica %s marked down for %.1fs (down #%d)%s",
                    rid, hold, rec["downs"],
                    ": " + reason if reason else "")

    def quiesce(self, rid, reason="", owner="operator"):
        """Administrative hold: excluded from routing, no half-open
        path, until :meth:`readmit`. Holds are OWNER-SCOPED (one per
        owner string): rolling drain and the supervisor place
        independent holds on the same replica, and each clears only
        its own — a supervisor racing a rolling drain must not be able
        to readmit a replica the drain is still holding back pending
        its wire-verified /healthz."""
        with self._lock:
            self._rec(rid)["quiesced"][str(owner)] = reason or "quiesced"
        logger.info("replica %s quiesced by %s%s", rid, owner,
                    ": " + reason if reason else "")

    def readmit(self, rid, owner="operator"):
        """Release ``owner``'s hold on ``rid``; failure state (counts,
        cooldown escalation) resets only once the LAST hold clears —
        the caller that verified the replica is back. ``owner=None``
        force-clears every hold (an operator override)."""
        with self._lock:
            rec = self._r.get(str(rid))
            if rec is None:
                return
            if owner is None:
                rec["quiesced"].clear()
            else:
                rec["quiesced"].pop(str(owner), None)
            if not rec["quiesced"]:
                rec.update(fails=0, downs=0, down_until=None)
        logger.info("replica %s hold released by %s", rid, owner)

    def forget(self, rid):
        """Drop every record of ``rid`` — a RETIRED replica (autoscale
        scale-down) must not leave failure state behind that would
        prejudice a future replica reusing the id."""
        with self._lock:
            self._r.pop(str(rid), None)

    def known(self):
        with self._lock:
            return list(self._r)


# -- replica-side agent ----------------------------------------------------

class Replica(object):
    """One serving replica's fleet agent: starts its :class:`serving.
    ModelServer`, then beats the reservation server with the serving
    lease payload — identity, HTTP address, live load gauges, and the
    engine's metrics-registry snapshot — every ``beat_interval``
    seconds. The beat keeps flowing through engine death and restart
    (a dead engine beats ``alive: False``, which is exactly what the
    router needs to know), and reads the engine through the SERVER so
    an ``attach_engine`` swap (supervisor restart, rolling drain) is
    picked up on the next beat."""

    #: location marker: in-process Replica agents are driver-local;
    #: RemoteReplica handles (executor-hosted) override this
    remote = False

    def __init__(self, server, reservation_addr, beat_interval=0.25,
                 host_meta=None, connect_timeout=2.0,
                 reconnect_backoff=0.25, reconnect_backoff_cap=4.0):
        self.server = server
        self.reservation_addr = tuple(reservation_addr)
        self.beat_interval = float(beat_interval)
        #: bound on ONE reconnect attempt to the reservation server —
        #: deliberately short (seconds, not the OS connect timeout):
        #: the beat thread holds the replica lock across the attempt,
        #: and stop()/re_register() wait on that lock
        self.connect_timeout = float(connect_timeout)
        #: reconnect backoff schedule after a connection-level beat
        #: failure: starts at ``reconnect_backoff``, doubles per
        #: consecutive failure, capped (pre-jitter) at
        #: ``reconnect_backoff_cap`` — the replica keeps SERVING the
        #: whole time; only its lease announcements are delayed
        self.reconnect_backoff = float(reconnect_backoff)
        self.reconnect_backoff_cap = float(reconnect_backoff_cap)
        #: reconnects survived so far (mirrors the engine's
        #: ``beat_reconnects`` counter -> tfos_serving_beat_
        #: reconnects_total; kept here too so engineless replicas and
        #: tests can observe it directly)
        self.beat_reconnects = 0
        self._backoff = 0.0  # current delay; 0 = healthy cadence
        self.replica_id = server.replica_id
        if self.replica_id is None:
            raise ValueError(
                "fleet replicas need a replica identity: mount an "
                "engine (its replica_id is the default) or pass "
                "ModelServer(replica_id=...)")
        #: {"executor": id, "pid": n} for executor-hosted replicas —
        #: rides every beat so the driver can join replica_id to the
        #: process actually serving it (the autoscaler's placement
        #: ledger and the pids-differ-from-driver acceptance pin)
        self.host_meta = dict(host_meta) if host_meta else None
        self.addr = None
        #: lease fencing: the epoch minted by the reservation
        #: server for THIS incarnation of the identity; every beat
        #: carries it. None until the first successful lease call.
        self.epoch = None
        #: set once a beat came back FENCED (another holder registered
        #: for this identity — typically a replacement spawned while
        #: this replica was partitioned away): beating stops and the
        #: server refuses to serve until :meth:`re_register`
        self.fenced = False
        self._client = None
        # guards epoch / fenced / _client: the beat thread mutates
        # all three, and re_register()/stop() land from operator or
        # supervisor threads. Unserialized, a re_register racing an
        # in-flight FENCED beat could have its clear overwritten by
        # the beat's latch — the replica ends permanently fenced with
        # a dead beat loop while re_register reports success (pinned
        # by test_fleet.py's barrier test). Each beat iteration holds
        # the lock end to end; the exchange is one small framed
        # message, so re_register/stop wait at most one beat.
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    @property
    def engine(self):
        """The CURRENT engine behind this replica's server (attach_
        engine swaps it; a stopped server has none)."""
        return self.server.engine

    def start(self):
        self.addr = self.server.start()
        self._thread = threading.Thread(
            target=self._beat_loop, daemon=True,
            name="tfos-fleet-beat-{}".format(self.replica_id))
        self._thread.start()
        return self.addr

    def _payload(self):
        engine = self.server.engine
        payload = {"role": "serving", "replica_id": self.replica_id,
                   "addr": list(self.addr), "model": self.server.name,
                   "state": "serving"}
        if self.host_meta is not None:
            payload["host"] = self.host_meta
        if engine is not None:
            payload["serving"] = engine.load_stats()
            payload["metrics"] = engine.metrics.snapshot()
        else:
            # stopped server / restart gap: the lease must say so, not
            # vanish (a vanished lease reads as replica loss)
            payload["serving"] = {"replica_id": self.replica_id,
                                  "alive": False, "draining": False,
                                  "queue_depth": 0, "slot_occupancy": 0,
                                  "queue_wait_ewma_s": 0.0}
        return payload

    def _beat_loop(self):
        while not self._stop.is_set():
            if not self._beat_once():
                return  # fenced: beating stops until re_register()
            backoff = self._backoff
            if backoff:
                # reservation server unreachable: jittered backoff so
                # a fleet whose server died together doesn't hammer
                # the restarted one in lockstep (thundering herd)
                delay = backoff * (0.5 + random.random())
            else:
                delay = self.beat_interval
            self._stop.wait(delay)

    def _beat_once(self):
        """One beat iteration, atomic under the replica lock (state
        reads, the exchange, and any fence latch are one unit — a
        re_register serializes entirely before or entirely after it).
        Returns False when the loop must exit (this identity was
        fenced).

        Connection-level failures (reservation server dead, network
        partition) are NEVER fatal to the loop: the replica keeps
        serving headless, and the next iteration reconnects after a
        bounded jittered backoff. The epoch belongs to the IDENTITY's
        incarnation, not the TCP connection, so a reconnect beats the
        SAME epoch — a restarted journal-seeded reservation server
        adopts it (replicas are the source of truth), and only a
        genuinely superseded epoch earns FENCED."""
        with self._lock:
            try:
                if self._client is None:
                    self._client = reservation.Client(
                        self.reservation_addr,
                        connect_timeout=self.connect_timeout)
                    if self._backoff:
                        # a previous iteration failed, so this connect
                        # is a RECONNECT the operator should see
                        self.beat_reconnects += 1
                        engine = self.server.engine
                        counters = getattr(engine, "counters", None)
                        if counters is not None:
                            counters.inc("beat_reconnects")
                        logger.info(
                            "replica %s beat reconnected to "
                            "reservation server (reconnect #%d, "
                            "epoch %s kept)", self.replica_id,
                            self.beat_reconnects, self.epoch)
                if self.epoch is None:
                    # acquire the fencing epoch before the first beat
                    # (and after any reconnect that lost it); the
                    # epoch belongs to the IDENTITY's incarnation, not
                    # the TCP connection, so a mere reconnect reuses it
                    self.epoch = self._client.lease(self.replica_id)
                self._client.beat(self.replica_id, self._payload(),
                                  epoch=self.epoch)
                self._backoff = 0.0
            except reservation.Fenced as e:
                # NON-retriable by design: someone else holds a newer
                # epoch for this identity. Serving on would be the
                # split-brain double-serve this plane exists to close —
                # stop beating, refuse requests, await re_register()
                logger.error(
                    "replica %s FENCED (stale epoch %s): %s — serving "
                    "refused until re_register()",
                    self.replica_id, self.epoch, e)
                self.fenced = True
                self.server.fence(
                    "lease epoch {} superseded by {}".format(
                        self.epoch, e.epoch))
                return False
            except Exception as e:  # noqa: BLE001 - beats must survive
                self._backoff = min(
                    self.reconnect_backoff_cap,
                    self._backoff * 2 if self._backoff
                    else self.reconnect_backoff)
                logger.warning(
                    "replica %s beat failed (%s); retrying in ~%.2fs "
                    "— replica keeps serving", self.replica_id, e,
                    self._backoff)
                if self._client is not None:
                    try:
                        self._client.close()
                    except Exception:  # noqa: BLE001
                        pass
                    self._client = None
        return True

    # -- lifecycle (shared verbs: rolling_drain / retirement call these
    # on in-process Replicas and RemoteReplicas alike) ---------------------

    def drain_engine(self, timeout=None):
        """Zero-loss drain of the CURRENT engine (every admitted
        request finishes; the engine ends stopped, the server stays
        up); returns the engine's clean-drain verdict. Raises
        RuntimeError when no engine is mounted (a stopped server
        mid-cycle has nothing to drain OR rebuild from — the caller
        must abort, not guess)."""
        engine = self.server.engine
        if engine is None:
            raise RuntimeError(
                "replica {} has no mounted engine to drain".format(
                    self.replica_id))
        return engine.drain(timeout=timeout)

    def respawn_engine(self, upgrade=None):
        """Build and attach the drained engine's successor:
        ``upgrade(old) -> new`` when given (a weight swap), else
        ``old.respawn()`` (same construction config, shared metrics).
        ``attach_engine`` clears the unhealthy mark, so /healthz
        recovers once the fresh scheduler is up."""
        old = self.server.engine
        if old is None:
            raise RuntimeError(
                "replica {} has no engine to respawn from".format(
                    self.replica_id))
        fresh = upgrade(old) if upgrade is not None else old.respawn()
        self.server.attach_engine(fresh)
        return fresh

    def re_register(self):
        """Deliberately rejoin the fleet after being fenced: mint a
        FRESH lease epoch (superseding whoever fenced us — the caller
        asserts this replica is the one that should serve), clear the
        server's fenced latch, and restart the beat loop. The operator/
        supervisor decision the ``Fenced`` taxonomy demands — never an
        automatic retry.

        Serialized against the beat loop: the reset runs either before
        a beat iteration (which then simply leases the fresh epoch) or
        after its fence latch (which this reset then clears and, the
        fenced loop being on its way out, a FRESH loop replaces) —
        never interleaved with one, so a racing FENCED verdict can no
        longer overwrite this reset and strand the replica fenced with
        no beat loop."""
        with self._lock:
            was_fenced = self.fenced
            self.epoch = None  # re-acquired by the loop's lease call
            self.fenced = False
            self.server.unfence()
        thread = self._thread
        if was_fenced and thread is not None and thread.is_alive():
            # the latch ran under the lock BEFORE this reset took it,
            # so the old loop is exiting; wait it out rather than
            # racing a corpse that is still returning
            thread.join(timeout=5)
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._beat_loop, daemon=True,
                name="tfos-fleet-beat-{}".format(self.replica_id))
            self._thread.start()
        logger.info("replica %s re-registering (fresh lease epoch)",
                    self.replica_id)

    def stop(self):
        self._stop.set()
        thread = self._thread
        if thread is not None and thread.is_alive():
            # a beat mid-exchange against a DEAD reservation server
            # would otherwise hold the lock until its socket timeout;
            # abort() closes the client's socket out of band (the one
            # lock-free operation the client allows), so the blocked
            # call fails NOW and teardown stays bounded
            client = self._client  # lock-free peek: abort() is the
            # client's designated out-of-band close, safe mid-call
            if client is not None:
                try:
                    client.abort()
                except Exception:  # noqa: BLE001
                    pass
        if thread is not None:
            thread.join(timeout=5)
            self._thread = None
        if thread is None or not thread.is_alive():
            # loop is down: the lock is free and closing is safe
            with self._lock:
                if self._client is not None:
                    try:
                        self._client.close()
                    except Exception:  # noqa: BLE001
                        pass
                    self._client = None
        else:
            # a beat wedged past the join timeout still owns the
            # client; closing it out from under a mid-exchange daemon
            # thread is the use-after-close this lock exists to stop
            logger.warning(
                "replica %s beat thread busy at stop(); leaving its "
                "client to the daemon thread", self.replica_id)
        engine = self.server.engine
        self.server.stop()
        if engine is not None:
            # the replica's engine goes with it (the reference's
            # ModelServer.stop stops its engine): a stopped fleet must
            # not leave schedulers, and their KV pools, running
            engine.stop()


def module_spec(model):
    """The wire form of a decode module for an executor-hosted replica:
    ``{"cls": "module:QualName", "config": {...}, "state": {name:
    (host array, dtype name)}}``. ``config`` holds the constructor's
    arguments, read back off the module's attributes of the same names
    (``DecoderLM``: vocab, hidden, num_heads, num_layers, max_len); a
    module whose constructor takes an argument it does not keep raises.
    The state goes as numpy arrays
    on the host (bfloat16, which numpy lacks, as its 16-bit pattern), so
    no CUDA tensor ever crosses the task wire."""
    cls = type(model)
    config = {}
    for name, param in inspect.signature(cls.__init__).parameters.items():
        if name in ("self", "device") or param.kind in (
                param.VAR_POSITIONAL, param.VAR_KEYWORD):
            continue
        if not hasattr(model, name):
            if param.default is param.empty:
                raise ValueError(
                    "{} keeps no attribute for its constructor argument "
                    "{!r}, so its spec cannot be shipped".format(
                        cls.__name__, name))
            continue
        config[name] = getattr(model, name)
    state = {}
    for key, tensor in model.state_dict().items():
        t = tensor.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            state[key] = (t.view(torch.int16).numpy().copy(), "bfloat16")
        else:
            state[key] = (t.numpy().copy(), str(t.dtype).split(".")[-1])
    return {"cls": "{}:{}".format(cls.__module__, cls.__qualname__),
            "config": config, "state": state}


def build_module(spec, device):
    """Inverse of :func:`module_spec`: construct the module on
    ``device`` (without initializing it, when the constructor takes a
    ``device``) and load the shipped state. Every parameter and buffer
    takes its shipped dtype first, so a bfloat16 or float16 module
    comes back at the dtype and bits it had on the driver, not at the
    constructor's default (a shared tensor is cast once)."""
    mod_name, qual = spec["cls"].split(":")
    cls = importlib.import_module(mod_name)
    for part in qual.split("."):
        cls = getattr(cls, part)
    device = torch.device(device)
    model = None
    if "device" in inspect.signature(cls.__init__).parameters:
        model = cls(**spec["config"], device="meta")
        if any(name not in spec["state"]
               for name, _ in model.named_buffers()):
            model = None  # a non-persistent buffer needs its own init
        else:
            model = model.to_empty(device=device)
    if model is None:
        model = cls(**spec["config"]).to(device)
    state = {}
    for key, (array, dtype) in spec["state"].items():
        t = torch.from_numpy(np.asarray(array))
        if dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        state[key] = t
    owned = dict(model.named_parameters(remove_duplicate=False))
    owned.update(model.named_buffers(remove_duplicate=False))
    for key, t in state.items():
        own = owned.get(key)
        if own is not None and own.dtype != t.dtype:
            own.data = own.data.to(t.dtype)
    model.load_state_dict(state)
    return model.eval()


class ServingNode(object):
    """One EXECUTOR-HOSTED serving replica: DecodeEngine + ModelServer
    + :class:`Replica` beat agent, built inside the executor process
    from a driver-shipped spec (the paper's ``TFCluster.run``
    executor-role bootstrap applied to serving). The node also mounts
    the remote lifecycle RPCs (``POST /admin/drain|respawn|
    re_register|stop``) on its own HTTP server — rolling drains,
    autoscale retirement, and fence recovery need a transport to an
    executor-hosted replica, and the replica's server IS it.

    ``spec`` (a plain picklable dict, shipped inside the
    ``node.serve_replica`` closure):

    - ``replica_id`` / ``name`` — serving identity + model name
    - ``module`` — :func:`module_spec` of the decode module (class,
      constructor config, host-side state dict); OR ``builder``, a
      zero-arg callable returning the module (load from a
      checkpoint/export path on the executor instead of shipping
      weights over the task wire)
    - ``engine_kw`` — DecodeEngine knobs (slots, kv paging,
      ``attn_impl``, ``device``, ...) — the spawn config rides here
      verbatim; the module is built on ``engine_kw["device"]`` (default
      the card, :func:`device_info.default_device`)
    - ``reservation_addr`` / ``beat_interval`` — the driver's BEAT
      registry and cadence
    """

    def __init__(self, spec, executor_id=None, host=None):
        self.spec = dict(spec)
        self.replica_id = str(self.spec["replica_id"])
        self.executor_id = executor_id
        self.host = host or "127.0.0.1"
        self.replica = None
        self.server = None

    def start(self):
        spec = self.spec
        kw = dict(spec.get("engine_kw") or {})
        device = device_info.default_device(kw.get("device"))
        builder = spec.get("builder")
        if builder is not None:
            model = builder()
        else:
            model = build_module(spec["module"], device)
        # QoS policy may ride its own top-level spec key —
        # operators keep the tenant policy (weights/quotas) separate
        # from engine spawn knobs; an explicit engine_kw wins
        if "qos" in spec:
            kw.setdefault("qos_policy", spec["qos"])
        kw.setdefault("flight", tracing.FlightRecorder())
        engine = serving.DecodeEngine(model, replica_id=self.replica_id,
                                      **kw)
        try:
            self.server = serving.ModelServer(
                None, engine=engine, name=spec.get("name", "model"),
                host=self.host, port=0)
            self.replica = Replica(
                self.server, tuple(spec["reservation_addr"]),
                beat_interval=float(spec.get("beat_interval", 0.25)),
                connect_timeout=float(spec.get("connect_timeout", 2.0)),
                host_meta={"executor": self.executor_id,
                           "pid": os.getpid()})
        except BaseException:
            engine.stop()
            raise
        self.server.register_admin("drain", self._rpc_drain)
        self.server.register_admin("respawn", self._rpc_respawn)
        self.server.register_admin("re_register", self._rpc_re_register)
        self.server.register_admin("stop", self._rpc_stop)
        addr = self.replica.start()
        logger.info("serving node %s up on %s:%d (executor %s, pid %d)",
                    self.replica_id, addr[0], addr[1], self.executor_id,
                    os.getpid())
        return addr

    # -- admin RPC handlers (run on the replica's HTTP threads) ------------

    def _rpc_drain(self, payload):
        timeout = payload.get("timeout")
        clean = self.replica.drain_engine(
            timeout=None if timeout is None else float(timeout))
        return {"replica_id": self.replica_id, "clean": bool(clean)}

    def _rpc_respawn(self, payload):
        old = self.server.engine
        if old is not None:
            old.stop()
        fresh = self.replica.respawn_engine()
        return {"replica_id": self.replica_id,
                "attn_impl": fresh.attn_impl, "ok": True}

    def _rpc_re_register(self, payload):
        self.replica.re_register()
        return {"replica_id": self.replica_id, "ok": True}

    def _rpc_stop(self, payload):
        # respond FIRST, then tear down: stop() closes the very HTTP
        # server this handler is answering through, and the driver's
        # bounded-deadline RPC must see its 200 rather than a reset
        # tfos: unjoined(the timer tears down its own process; nothing survives to join it)
        timer = threading.Timer(0.2, self.stop)
        timer.daemon = True
        timer.name = "tfos-admin-stop-{}".format(self.replica_id)
        timer.start()
        return {"replica_id": self.replica_id, "stopping": True}

    def stop(self):
        if self.replica is not None:
            self.replica.stop()  # beat thread + server + engine
        elif self.server is not None:
            self.server.stop()


class RemoteReplica(object):
    """Driver-side handle to an executor-hosted replica: same lifecycle
    verbs as the in-process :class:`Replica` (``drain_engine`` /
    ``respawn_engine`` / ``re_register`` / ``stop``), each a bounded
    ``POST /admin/<verb>`` against the replica's own HTTP server at its
    lease-advertised address. Routing never goes through this object —
    the router reads addresses straight off the BEAT snapshot — so the
    handle exists purely for lifecycle (rolling drain, autoscale
    retirement, fence recovery) and placement bookkeeping
    (``executor_id``)."""

    remote = True

    def __init__(self, replica_id, reservation_server, executor_id=None,
                 admin_timeout=30.0, connect_timeout=3.0):
        self.replica_id = str(replica_id)
        self.reservation = reservation_server
        self.executor_id = executor_id
        self.admin_timeout = float(admin_timeout)
        self.connect_timeout = float(connect_timeout)
        #: control epoch stamped on every admin RPC: the
        #: replica keeps a monotonic floor and refuses 409 any write
        #: stamped below it — a deposed driver's late ship_fence/
        #: drain/spawn can no longer land. None = unstamped
        #: (back-compat; replicas admit header-less calls).
        self.control_epoch = None

    @property
    def addr(self):
        """The replica's CURRENT lease-advertised address (a
        replacement spawned under the same identity moves it); None
        once the lease is gone."""
        info = self.reservation.serving_snapshot().get(self.replica_id)
        addr = (info or {}).get("addr")
        return tuple(addr) if addr else None

    @property
    def engine(self):
        """Executor-hosted engines have no driver-side object; the
        None is the marker in-process code paths branch on."""
        return None

    def _admin(self, verb, body=None, timeout=None):
        addr = self.addr
        if addr is None:
            raise RuntimeError(
                "replica {} has no live lease (no address to reach "
                "its admin surface)".format(self.replica_id))
        headers = None
        if self.control_epoch is not None:
            headers = {"X-TFOS-Control-Epoch": str(self.control_epoch)}
        status, raw, _ = _http_request(
            addr, "POST", "/admin/{}".format(verb),
            body=json.dumps(body or {}).encode(),
            timeout=timeout if timeout is not None else self.admin_timeout,
            connect_timeout=self.connect_timeout,
            extra_headers=headers,
            net_src="driver", net_dst=self.replica_id)
        try:
            parsed = json.loads(raw)
        except ValueError:
            parsed = {}
        if status != 200:
            raise RuntimeError(
                "admin {} on replica {} answered {}: {}".format(
                    verb, self.replica_id, status,
                    parsed.get("error", raw[:200])))
        return parsed

    def drain_engine(self, timeout=None):
        # the RPC read deadline must outlast the drain itself; an
        # unbounded (None) drain gets a 600s read cap — the drain
        # still completes server-side past it, only the verdict is
        # lost (and reported as unclean)
        rpc_timeout = 600.0 if timeout is None \
            else float(timeout) + self.admin_timeout
        out = self._admin("drain", {"timeout": timeout},
                          timeout=rpc_timeout)
        return bool(out.get("clean"))

    def respawn_engine(self, upgrade=None):
        if upgrade is not None:
            raise NotImplementedError(
                "upgrade= callables cannot cross the process boundary "
                "to an executor-hosted replica; ship new weights via a "
                "respawn-from-checkpoint spec instead")
        return self._admin("respawn")

    def re_register(self):
        return self._admin("re_register")

    def stop(self, timeout=10.0):
        """Remote teardown with a bounded deadline; best-effort — a
        dead executor's replica needs no stopping, and stop() must
        never hang a fleet teardown on a corpse. Returns True when the
        replica acknowledged."""
        try:
            self._admin("stop", timeout=timeout)
            return True
        except (OSError, RuntimeError,
                http.client.HTTPException) as e:
            logger.info("remote stop of replica %s best-effort "
                        "failed: %s", self.replica_id, e)
            return False


# -- router ----------------------------------------------------------------

class _ClientGone(RuntimeError):
    """The router's OWN client disconnected mid-dispatch. The upstream
    connection is torn down so the replica's socket-EOF cancellation
    (the disconnect path) fires there too — the router must not
    turn a vanished client back into a slot decoding to max_new."""


class _HedgeLost(RuntimeError):
    """Internal to hedged dispatch: this attempt was aborted because
    its rival already produced the winning response (or the hedge had
    no alternative replica to go to). Never surfaces to clients and
    never counts as a disconnect or a failover."""


def _http_request(addr, method, path, body=None, timeout=600.0,
                  abort=None, extra_headers=None, connect_timeout=None,
                  net_src=None, net_dst=None):
    """One plain HTTP exchange -> (status, raw body bytes, headers).

    ``abort`` (zero-arg callable): polled while the exchange runs;
    when it turns True the upstream connection is CLOSED — the replica
    sees socket EOF and cancels the in-flight body exactly as it would
    for a directly-connected client — and :class:`_ClientGone` is
    raised. Without ``abort`` the exchange is a plain blocking call.
    ``extra_headers``: request headers to add (the trace-propagation
    ``X-TFOS-Trace`` rides this).

    Timeouts are SPLIT: ``connect_timeout`` bounds the TCP connect
    (default: min(``timeout``, 5s)) while ``timeout`` bounds the
    response read. One shared number was wrong in both directions — a
    black-holed SYN against a partitioned replica deserves seconds
    before failover, a long generation legitimately needs minutes of
    read patience, and a single knob can't say both.

    ``net_src``/``net_dst`` label the exchange for the chaos network
    fault plane (``chaos.on_net``): a drop/partition injection raises
    ``chaos.NetPartitioned`` (an OSError — the caller's existing
    unreachable-replica handling fires), ``net_delay`` stalls the
    exchange, and ``net_dup`` delivers the request a second time (the
    duplicate's response is discarded — the replica-side dedup window
    is what makes it harmless)."""
    if connect_timeout is None:
        connect_timeout = min(float(timeout), DEFAULT_CONNECT_TIMEOUT)
    action = None
    if chaos.net_armed():
        # request-side loss raises NetPartitioned here, before any
        # bytes move; "drop_response" means the peer EXECUTES the
        # request and only the answer is lost — the ambiguous-timeout
        # shape idempotent dispatch exists to absorb
        action = chaos.on_net(net_src, net_dst, response_capable=True)
    headers = {"Content-Type": "application/json"} if body else {}
    if extra_headers:
        headers.update(extra_headers)
    out = _http_exchange(addr, method, path, body, headers, timeout,
                         connect_timeout, abort)
    if action == "drop_response":
        # the exchange ran to completion on the peer; its response
        # dies here. The caller sees the same ConnectionError a real
        # mid-exchange partition yields — it CANNOT know the work
        # happened, and must rely on the idempotency key when it
        # retries
        raise chaos.NetPartitioned(
            "chaos: response from {} lost after the request was "
            "delivered and executed".format(net_dst))
    if action == "dup":
        # duplicate delivery (net_dup): the transport hands the peer
        # the SAME request again — sequentially, so tests observe a
        # deterministic order — and discards the second response
        try:
            _http_exchange(addr, method, path, body, headers, timeout,
                           connect_timeout, None)
        except (OSError, http.client.HTTPException):
            pass
    return out


def _http_exchange(addr, method, path, body, headers, timeout,
                   connect_timeout, abort):
    conn = http.client.HTTPConnection(addr[0], int(addr[1]),
                                      timeout=connect_timeout)
    # connect under the CONNECT bound, then widen the socket deadline
    # to the read timeout for the exchange itself
    try:
        conn.connect()
        conn.sock.settimeout(float(timeout))
    except BaseException:
        conn.close()
        raise
    if abort is None:
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read(), dict(resp.getheaders())
        finally:
            conn.close()
    done = threading.Event()
    box = {}

    def _exchange():
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            box["out"] = (resp.status, resp.read(),
                          dict(resp.getheaders()))
        except BaseException as e:  # noqa: BLE001 - delivered below
            box["err"] = e
        finally:
            done.set()

    # tfos: unjoined(abandoned by design on abort: it may be blocked in recv on the socket just shut down)
    worker = threading.Thread(target=_exchange, daemon=True,
                              name="tfos-fleet-upstream")
    worker.start()
    try:
        while not done.wait(0.05):
            if abort():
                # shutdown() BEFORE close(): the worker thread is
                # blocked in recv on this socket, and close() alone
                # neither wakes it nor sends FIN while the in-flight
                # syscall pins the file description — the replica
                # would never see the EOF its disconnect-cancel polls
                # for (same Linux pitfall as the reservation
                # listener's accept)
                try:
                    if conn.sock is not None:
                        conn.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                conn.close()
                done.wait(5.0)
                raise _ClientGone("client disconnected mid-dispatch")
        if "err" in box:
            raise box["err"]
        return box["out"]
    finally:
        conn.close()


class FleetRouter(object):
    """Metrics-driven HTTP front end over a fleet of serving replicas.

    Routes ``POST /v1/models/<name>:generate`` to the least-loaded
    replica (live BEAT gauges via ``reservation.Server.
    serving_snapshot``; policy in :func:`route_order`), failing over
    on retriable upstream errors. ``GET /healthz`` reports the
    router's own fitness (503 once NO replica is routable) plus the
    per-replica view; ``GET /metrics`` exposes the router's registry
    and every replica's beat-carried engine snapshot as
    ``replica``-labeled series in one OpenMetrics document.

    Health discipline: an ``EngineFailed``-shaped 503, a connection
    failure, or an upstream timeout counts against the replica
    (:class:`ReplicaHealth` — repeated failures stop routing, with
    half-open /healthz probing for recovery); a ``Shed`` or 429 is
    LOAD, not unhealthiness — fail over, don't penalize; a
    ``Draining`` replica excludes itself via its own beat payload.

    ``replicas``: the in-process :class:`Replica` objects (when the
    fleet is local) — required only by :meth:`rolling_drain`, which
    needs engine/server access; routing itself is address-based and
    replica-location-agnostic.
    """

    def __init__(self, reservation_server, name="model",
                 host="127.0.0.1", port=0, replicas=None,
                 stale_after=DEFAULT_STALE_AFTER, attempts=4,
                 fail_threshold=2, cooldown=1.0, max_cooldown=30.0,
                 probe_interval=0.25, upstream_timeout=600.0,
                 connect_timeout=DEFAULT_CONNECT_TIMEOUT,
                 base_delay=0.05, max_delay=2.0,
                 hedge_quantile=None, hedge_min_delay=0.05,
                 hedge_min_samples=20,
                 affinity_ttl=DEFAULT_AFFINITY_TTL,
                 affinity_capacity=2048,
                 load_guard=DEFAULT_LOAD_GUARD,
                 affinity_enabled=True, two_stage=True,
                 prefill_timeout=120.0, qos=None, slo=None):
        self.reservation = reservation_server
        self.name = name
        self.replicas = list(replicas or [])
        self.stale_after = float(stale_after)
        self.attempts = int(attempts)
        self.upstream_timeout = float(upstream_timeout)
        #: TCP connect bound, split from the read timeout: a
        #: partitioned replica's black-holed SYN fails over in seconds
        self.connect_timeout = float(connect_timeout)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.probe_interval = float(probe_interval)
        #: hedged requests: once an attempt has run longer than
        #: this quantile of the router's OWN upstream-latency histogram
        #: (floored at ``hedge_min_delay``), a second attempt goes to a
        #: DIFFERENT replica and the first response wins — the
        #: tail-latency answer to one gray (slow-but-alive) replica.
        #: None disables hedging; the delay is evidence-based, so no
        #: hedge fires until ``hedge_min_samples`` upstream latencies
        #: have been observed (a cold router never hedges). Replica-
        #: side idempotent dispatch (the dedup window keyed on
        #: ``X-TFOS-Request-Id``) is what makes the losing attempt
        #: harmless.
        self.hedge_quantile = None if hedge_quantile is None \
            else float(hedge_quantile)
        self.hedge_min_delay = float(hedge_min_delay)
        self.hedge_min_samples = int(hedge_min_samples)
        #: prefix/session-aware dispatch: the TTL'd
        #: session -> replica memory fed by dispatch history, and the
        #: load-guard bound affinity_order enforces so a warm replica
        #: past the backlog threshold loses to the least-loaded cold
        #: one (the hotspot-amplifier stop)
        self.load_guard = int(load_guard)
        #: False = pure least-loaded routing (the honest baseline the
        #: bench's affinity leg publishes alongside the warm numbers)
        self.affinity_enabled = bool(affinity_enabled)
        #: two-stage dispatch: when the fleet holds BOTH a
        #: prefill tier and decode-eligible replicas, each :generate
        #: first places its prompt on a prefill replica (digest-aware,
        #: the deepest prefix match re-prefills the least) which ships
        #: the filled KV blocks to the chosen decode replica; the
        #: decode dispatch then PREFERS that replica so the splice is
        #: actually consumed. Strictly best-effort: every failure in
        #: the stage degrades to plain single-stage dispatch.
        self.two_stage = bool(two_stage)
        #: bound on one staged :prefill call (covers prefill compute +
        #: the KV ship; generous because a missed stage only costs a
        #: cold decode-side prefill, never a failed request)
        self.prefill_timeout = float(prefill_timeout)
        #: multi-tenant QoS at the router: the same per-tenant
        #: token-bucket quotas the engines enforce, checked BEFORE any
        #: upstream attempt — an over-quota tenant is refused in one
        #: hop instead of burning failover attempts fleet-wide. None =
        #: no router-side quotas (engine-side enforcement still holds
        #: for direct-API callers).
        self.qos_policy = QosPolicy.from_spec(qos)
        self._quota = QuotaTable(self.qos_policy)
        #: (warm_rid, cold_rid) pre-warms currently in flight
        #: (predictive placement; guarded by _obs_lock) — one shipment
        #: per pair at a time, so a burst of guarded dispatches can't
        #: stampede the saturated warm replica with prefill POSTs
        self._prewarm_inflight = set()
        self.affinity = AffinityMap(capacity=affinity_capacity,
                                    ttl_s=affinity_ttl)
        #: reason -> count behind tfos_fleet_affinity_breaks{reason}
        #: (written under _obs_lock like every other router tally)
        self._affinity_breaks = {}
        #: reason -> count behind tfos_fleet_affinity_resets{reason}: a
        #: router that came up COLD over a fleet already holding
        #: serving sessions (standby takeover, same-name restart) —
        #: the honest explanation for a warm-hit-rate dip
        self._affinity_resets = {}
        # what start() labels a cold-over-live-fleet reset with;
        # RouterStandby overrides to "takeover" before starting its
        # replacement router
        self._affinity_reset_reason = "restart"
        self.health = ReplicaHealth(fail_threshold=fail_threshold,
                                    cooldown=cooldown,
                                    max_cooldown=max_cooldown)
        self.counters = tracing.Counters()
        self.timers = tracing.StageTimers()
        self.metrics = tracing.MetricsRegistry()
        self.metrics.add_counters("tfos_fleet", self.counters)
        self.metrics.add_timers("tfos_fleet_stage", self.timers)
        self._hist_request = self.metrics.histogram(
            "tfos_fleet_request_seconds")
        self._hist_upstream = self.metrics.histogram(
            "tfos_fleet_upstream_seconds")
        self._hist_overhead = self.metrics.histogram(
            "tfos_fleet_route_overhead_seconds")
        #: the router's own span ring (trace-context propagation): one
        #: minted trace id per client request, a ``dispatch`` envelope
        #: plus one ``upstream`` span per attempt — stitched with the
        #: replicas' rings by GET /debug/trace into the end-to-end
        #: timeline of a (possibly failed-over) request
        self.flight = tracing.FlightRecorder()
        tracing.expose_flight_drops(self.metrics, self.flight)
        # router-side slices of the per-request attribution families:
        # dispatch-minus-upstream residual, hedge-race overlap, and the
        # two-stage kv ship (the engine owns queue/prefill/decode)
        self._hist_attrib = {
            stage: self.metrics.histogram(
                "tfos_slo_attrib_{}_seconds".format(stage))
            for stage in ("router_overhead", "hedge_wait", "kv_ship")}
        #: serving SLO plane: burn-rate alerts + /slo verdict
        #: over this router's own histograms, per-tenant availability
        #: tallies, and beat-carried replica snapshots. ``slo=`` takes
        #: a spec string/list (slo.parse_specs grammar); None = the
        #: default objectives. Evaluation is scrape-driven.
        self.slo = slo_mod.SloMonitor(self, specs=slo)
        #: tenant -> [good, total] availability tallies (guarded by
        #: _obs_lock): client disconnects never counted, quota 429s
        #: excluded as policy-not-failure, >=500 counts against
        self._slo_tallies = {}
        self._inflight = {}
        self._inflight_lock = threading.Lock()
        # every histogram/timer/counter write goes through this lock:
        # dispatch runs on a ThreadingHTTPServer thread PER REQUEST,
        # and tracing's unlocked read-modify-writes are single-writer
        # by convention — concurrent observes would silently lose
        # samples in the very numbers the fleet bench publishes
        self._obs_lock = threading.Lock()
        #: dispatches seen (guarded by _obs_lock) — drives the
        #: kill_router_at_request chaos site
        self._dispatch_seen = 0
        self._host, self._port = host, int(port)
        self._httpd = None
        self._thread = None
        self._probe_stop = threading.Event()
        self._probe_thread = None

    # -- fleet view --------------------------------------------------------

    def slo_tallies(self):
        """Per-tenant cumulative availability ``(good, total)`` pairs —
        the SLI source for ``kind=availability`` SLO specs."""
        with self._obs_lock:
            return {t: tuple(v) for t, v in self._slo_tallies.items()}

    def _note_affinity_reset(self, reason):
        with self._obs_lock:
            self._affinity_resets[reason] = \
                self._affinity_resets.get(reason, 0) + 1

    def _snapshot(self):
        return self.reservation.serving_snapshot()

    def replica_views(self, now=None, snapshot=None):
        """The view dicts :func:`route_order` prices, one per live
        serving lease: beat gauges + this router's own in-flight count
        and health state."""
        now = now if now is not None else time.monotonic()
        snapshot = snapshot if snapshot is not None else self._snapshot()
        views = []
        with self._inflight_lock:
            inflight = dict(self._inflight)
        for rid, info in sorted(snapshot.items()):
            gauges = info.get("serving") or {}
            views.append({
                "replica_id": rid,
                "age": info.get("age"),
                "addr": info.get("addr"),
                "alive": gauges.get("alive", True),
                "draining": bool(gauges.get("draining")),
                "queue_depth": gauges.get("queue_depth", 0),
                "slot_occupancy": gauges.get("slot_occupancy", 0),
                "queue_wait_ewma_s": gauges.get("queue_wait_ewma_s", 0.0),
                # kernel config: which attention formulation
                # each replica runs, so a heterogeneous fleet (e.g. a
                # staged fused-kernel rollout) is legible from the
                # router's health view; plus the generated-prefix hit
                # tally, the multi-turn-reuse signal
                "attn_impl": gauges.get("attn_impl"),
                "generated_prefix_hit_blocks": gauges.get(
                    "generated_prefix_hit_blocks", 0),
                # speed-path config: which replicas speculate
                # / serve int8 KV and at what live acceptance rate —
                # a staged rollout of either knob is legible from one
                # probe (zero schema on replicas with both off)
                "speculate_k": gauges.get("speculate_k", 0),
                "spec_acceptance_rate": gauges.get(
                    "spec_acceptance_rate", 0.0),
                "kv_dtype": gauges.get("kv_dtype"),
                # disaggregation plane: which tier the replica
                # serves (two-stage dispatch routes :prefill at the
                # prefill tier, :generate around it) and the lease
                # fencing epoch its KV shipments are stamped with —
                # the splice side refuses epochs at or below a
                # broadcast fence floor
                "tier": gauges.get("tier") or "mixed",
                "epoch": info.get("epoch"),
                # prefix-warmth signal: the beat-carried
                # top-K chain digest affinity_order prices, the slot
                # count the load guard's saturation check reads, and
                # the truncation-honesty flag (zero schema —
                # empty/0/False — on contiguous replicas)
                # multi-tenant QoS: per-tenant queued/active/
                # token gauges plus the per-class queue split, beat-
                # carried so dispatch can spread one tenant's burst
                # across replicas and the autoscaler can tell a HIGH-
                # class breach from LOW-only backlog
                "queue_by_class": gauges.get("queue_by_class") or {},
                "tenants": gauges.get("tenants") or {},
                "slots": gauges.get("slots", 0),
                "prefix_digest": gauges.get("prefix_digest") or [],
                "prefix_digest_block_size": gauges.get(
                    "prefix_digest_block_size", 0),
                "digest_truncated": bool(
                    gauges.get("digest_truncated")),
                "inflight": inflight.get(rid, 0),
                "state": self.health.state(rid, now),
            })
        return views

    def _note_inflight(self, rid, delta):
        with self._inflight_lock:
            self._inflight[rid] = max(
                0, self._inflight.get(rid, 0) + delta)

    # -- health controls (supervisor / rolling drain hooks) ----------------

    def quiesce(self, replica_id, reason="", owner="operator"):
        """Stop routing to ``replica_id`` until the same ``owner``
        readmits — the supervisor calls this BEFORE restarting a dead
        replica's engine, and rolling drain before draining one; each
        holds and releases independently (see
        :meth:`ReplicaHealth.quiesce`)."""
        self.health.quiesce(replica_id, reason, owner=owner)

    def readmit(self, replica_id, owner="operator"):
        self.health.readmit(replica_id, owner=owner)

    # -- dispatch ----------------------------------------------------------

    def dispatch(self, raw_body, client_gone=None):
        """Route one ``:generate`` body; returns ``(status, body_bytes,
        retry_after_or_None)`` — the upstream's response verbatim on
        success or a non-retriable status, a final 503 once every
        failover attempt is spent. ``client_gone`` (zero-arg callable
        from the HTTP layer) is polled while the upstream call runs: a
        disconnected end client tears down the upstream connection, so
        the replica's own socket-EOF cancellation fires and the slot
        frees — the router must not insulate replicas from the disconnect
        contract (:class:`_ClientGone` propagates)."""
        t0 = time.monotonic()
        # chaos site: kill_router_at_request=K dies like a
        # SIGKILLed router process on the K-th dispatch — mid-request,
        # listener closed, in-flight connections reset. The standby
        # takeover e2e and fault_plane.control_mttr bench drive it.
        with self._obs_lock:
            self._dispatch_seen += 1
            seen = self._dispatch_seen
        if chaos.on_router_request(seen, ident=self.name):
            self.crash()
            raise _ClientGone(
                "chaos: router killed at request {}".format(seen))
        upstream_spent = [0.0]
        tried = set()
        # upstream attempts actually made — counted explicitly because
        # ``tried`` is CLEARED when every replica has been attempted
        # once (so a same-replica retry can proceed), and len(tried)
        # would then under-report a real failover on the dispatch span
        attempts_made = [0]
        # ONE trace id per client request, minted here and forwarded
        # to every upstream attempt via X-TFOS-Trace — failover
        # attempts REUSE it, so the replicas' engine spans and this
        # router's spans share a timeline row end to end
        trace = tracing.mint_trace_id()
        # ONE idempotency key per client request, reused
        # verbatim by every failover retry and hedge attempt: the
        # replica-side dedup window replays (or joins) a request it
        # already executed instead of generating it twice — what makes
        # retrying an AMBIGUOUS timeout (did it run before the
        # response was lost?) safe
        request_id = uuid.uuid4().hex
        # affinity inputs, parsed ONCE per client request: the
        # optional session key and the (first) prompt's tokens, which
        # every attempt's affinity_order matches against the replicas'
        # beat-carried digests. Parse failures leave both None — an
        # unparseable body routes load-only and the upstream answers
        # its own 400; the router must not pre-judge it
        session, prompt_tokens = self._affinity_inputs(raw_body) \
            if self.affinity_enabled or self.two_stage else (None, None)
        # tenant identity, parsed once like the affinity keys:
        # a malformed tenant/priority routes under the DEFAULTS and
        # the upstream answers the authoritative 400 — the router must
        # not pre-judge a body it cannot parse
        tenant, priority = self._qos_inputs(raw_body)
        # router-side quota gate: the same post-paid buckets the
        # engines enforce, checked BEFORE any upstream attempt so an
        # over-quota tenant is refused in one hop. Charged below by
        # the tokens the winning response actually delivered — one
        # dispatch returns once no matter how many failover/hedge
        # attempts ran, and the replicas' DedupWindow means those
        # duplicates generated nothing extra, so the accounting stays
        # exact with no double-charge.
        try:
            self._quota.admit(tenant)
        except QuotaExceeded as e:
            with self._obs_lock:
                self.counters.inc("requests")
                self.counters.inc("quota_rejections")
            body = json.dumps(
                {"error": str(e), "kind": "QuotaExceeded",
                 "tenant": tenant}).encode()
            return 429, body, max(1, int(math.ceil(e.retry_after)))
        # two-stage dispatch: prefill placement + KV ship run
        # BEFORE the decode attempt, so by the time the :generate
        # lands, the decode replica's pool already holds the prompt's
        # blocks (its own prefill collapses to a prefix-cache hit).
        # `prefer` pins the decode pick to the ship target; None (no
        # tiers, stage failed, nothing shippable) means plain dispatch
        prefer = self._stage_prefill(prompt_tokens, session, trace) \
            if self.two_stage and prompt_tokens else None
        status = None
        try:
            try:
                status, body, headers = serving.retry_call(
                    lambda: self._attempt_hedged(
                        raw_body, tried, upstream_spent, client_gone,
                        trace, attempts_made, request_id,
                        session=session, prompt_tokens=prompt_tokens,
                        prefer=prefer, tenant=tenant,
                        priority=priority),
                    attempts=self.attempts, base_delay=self.base_delay,
                    max_delay=self.max_delay)
                retry_after = None
                if status == 200:
                    # post-paid usage: drain this tenant's router-side
                    # bucket by the tokens the response delivered
                    self._quota.charge(
                        tenant, self._delivered_tokens(body))
                elif status == 429:
                    # a replica's own quota refusal passes through
                    # verbatim (see _attempt) — surface its honest
                    # Retry-After instead of a bare 429
                    try:
                        retry_after = max(1, int(math.ceil(float(
                            headers.get("Retry-After")))))
                    except (TypeError, ValueError):
                        retry_after = None
            except serving.Retriable as e:
                status = 503
                body = json.dumps(
                    {"error": str(e),
                     "kind": type(e).__name__}).encode()
                retry_after = max(
                    1, int(getattr(e, "retry_after", 1.0) or 1))
        finally:
            # in a finally so a _ClientGone (499) dispatch still
            # counts: tfos_fleet_requests is "requests the router
            # answered (ANY status)" and the latency/overhead
            # histograms must not silently exclude disconnects
            now = time.monotonic()
            wall = now - t0
            self.flight.span("dispatch", t0, now, trace=trace,
                             status=status if status is not None
                             else "client_gone",
                             attempts=attempts_made[0] or 1)
            with self._obs_lock:
                self.counters.inc("requests")
                self._hist_request.observe(wall, trace=trace)
                self._hist_overhead.observe(
                    max(wall - upstream_spent[0], 0.0))
                self._hist_attrib["router_overhead"].observe(
                    max(wall - upstream_spent[0], 0.0), trace=trace)
                # per-tenant availability tally (SLO plane): a client
                # that hung up is nobody's failure and a quota 429 is
                # policy — neither spends error budget; >=500 does
                if status is not None and status != 429:
                    tally = self._slo_tallies.setdefault(tenant, [0, 0])
                    tally[1] += 1
                    if status < 500:
                        tally[0] += 1
        return status, body, retry_after

    @staticmethod
    def _affinity_inputs(raw_body):
        """(session, prompt_tokens) best-effort parsed from a
        ``:generate`` body — the affinity keys. ``prompt_tokens`` is
        the FIRST prompt of a nested body (a multi-prompt body shares
        one dispatch, so one representative chain is what the digest
        match can use); None for anything malformed."""
        try:
            parsed = json.loads(raw_body or b"{}")
        except (ValueError, UnicodeDecodeError):
            return None, None
        if not isinstance(parsed, dict):
            return None, None
        session = parsed.get("session")
        if not isinstance(session, str) or not session:
            session = None
        prompts = parsed.get("prompt")
        tokens = None
        if isinstance(prompts, list) and prompts:
            first = prompts[0] if isinstance(prompts[0], (list, tuple)) \
                else prompts
            if first and all(isinstance(t, int)
                             and not isinstance(t, bool)
                             for t in first):
                tokens = list(first)
        return session, tokens

    @staticmethod
    def _qos_inputs(raw_body):
        """(tenant, priority) best-effort parsed from a ``:generate``
        body — the router's quota/spread keys. Anything malformed maps
        to the defaults here: the upstream answers the authoritative
        400 (the router must not pre-judge a body it cannot parse),
        and a client cannot dodge its quota by mangling the field —
        the engine-side 400 rejects the request before any work."""
        try:
            parsed = json.loads(raw_body or b"{}")
        except (ValueError, UnicodeDecodeError):
            parsed = None
        if not isinstance(parsed, dict):
            parsed = {}
        try:
            tenant = validate_tenant(parsed.get("tenant"))
        except (TypeError, ValueError):
            tenant = validate_tenant(None)
        try:
            priority = validate_priority(parsed.get("priority"))
        except (TypeError, ValueError):
            priority = DEFAULT_PRIORITY
        return tenant, priority

    @staticmethod
    def _delivered_tokens(body):
        """Token count of a 200 ``:generate`` response body (flat or
        nested), for post-paid quota charging; 0 for anything that
        doesn't parse — never a dispatch failure."""
        try:
            tokens = json.loads(body).get("tokens")
        except (ValueError, AttributeError):
            return 0
        if not isinstance(tokens, list):
            return 0
        if tokens and isinstance(tokens[0], list):
            return sum(len(t) for t in tokens if isinstance(t, list))
        return len(tokens)

    def _stage_prefill(self, prompt_tokens, session, trace):
        """Stage one of two-stage dispatch: place the prompt
        on a prefill-tier replica and have it ship the filled KV
        blocks to the decode replica stage two will prefer. Returns
        that decode replica_id (the dispatch preference) or None —
        no prefill tier, nothing shippable, or any failure: the stage
        is strictly best-effort, and every exit degrades to plain
        single-stage dispatch (the decode side re-prefills cold).

        Placement is the tentpole's routing contract: prefill-side,
        the DEEPEST digest match wins (it re-prefills the least);
        decode-side, :func:`affinity_plan` over the decode tier picks
        exactly where stage two will route, so the shipped prefix
        registers in the prefix cache of the replica that consumes
        it — and a decode replica already holding the prefix skips
        the stage entirely (nothing to ship)."""
        t0 = time.monotonic()
        try:
            snapshot = self._snapshot()
            views = self.replica_views(time.monotonic(), snapshot)
            prefill_views = [v for v in views
                             if view_tier(v) == "prefill"]
            decode_views = decode_eligible(
                [v for v in views if view_tier(v) != "prefill"])
            prefill_order = route_order(prefill_views,
                                        self.stale_after)
            if not prefill_order or not decode_views:
                return None
            # stage 1: prefill placement, deepest digest match first
            p_matches = {}
            for view in prefill_views:
                depth = digest_match(view, prompt_tokens)
                if depth:
                    p_matches[str(view.get("replica_id"))] = depth
            p_rid = max(prefill_order,
                        key=lambda r: (p_matches.get(r, 0),
                                       -prefill_order.index(r)))
            p_view = next(v for v in prefill_views
                          if str(v.get("replica_id")) == p_rid)
            block = int(p_view.get("prefix_digest_block_size") or 0)
            if block <= 0 or len(prompt_tokens) < block:
                # an unpaged prefill replica exports nothing, and a
                # sub-block prompt ships zero full blocks — skip the
                # round trip instead of prefilling for no shipment
                return None
            # stage 2: decode placement — the same affinity plan the
            # decode attempt will run, so ship target == route target
            hint = self.affinity.lookup(session) \
                if session is not None else None
            d_matches = {}
            for view in decode_views:
                depth = digest_match(view, prompt_tokens)
                if depth:
                    d_matches[str(view.get("replica_id"))] = depth
            d_order, _ = affinity_plan(
                decode_views, d_matches, hint, self.stale_after,
                self.load_guard)
            if not d_order:
                return None
            d_rid = d_order[0]
            if d_matches.get(d_rid):
                # the decode replica already holds this prefix (an
                # earlier shipment, or its own serving history) —
                # prefer it, ship nothing
                with self._obs_lock:
                    self.counters.inc("prefill_skips")
                return d_rid
            d_view = next(v for v in decode_views
                          if str(v.get("replica_id")) == d_rid)
            p_addr = (snapshot.get(p_rid) or {}).get("addr")
            d_addr = (snapshot.get(d_rid) or {}).get("addr")
            if not p_addr or not d_addr:
                return None
            body = json.dumps({
                "prompt": list(prompt_tokens),
                "session": session,
                # the prefill replica stamps its shipment with its OWN
                # lease epoch; the decode side's fence floor (raised
                # when a replica is replaced or retired) is what keeps
                # an orphaned shipment from a dead incarnation out
                "src_epoch": p_view.get("epoch"),
                "ship": {"addr": "{}:{}".format(d_addr[0], d_addr[1]),
                         "replica_id": d_rid,
                         "epoch": d_view.get("epoch")},
            }).encode()
            with self._obs_lock:
                self.counters.inc("prefill_dispatches")
            ship_t0 = time.monotonic()
            status, rbody, _hdrs = _http_request(
                tuple(p_addr), "POST",
                "/v1/models/{}:prefill".format(self.name), body=body,
                timeout=self.prefill_timeout,
                connect_timeout=self.connect_timeout,
                extra_headers={"X-TFOS-Trace": str(trace)},
                net_src="router", net_dst=p_rid)
            out = {}
            if status == 200:
                try:
                    out = json.loads(rbody)
                except ValueError:
                    out = {}
            if status == 200 and out.get("shipped"):
                with self._obs_lock:
                    self.counters.inc("prefill_ships")
                    # the staged prefill+ship ran BEFORE the decode
                    # attempt, serially on the dispatch path: its wall
                    # is the request's kv_ship attribution slice
                    self._hist_attrib["kv_ship"].observe(
                        time.monotonic() - ship_t0, trace=trace)
                self.flight.instant(
                    "prefill_staged", trace=trace, prefill=p_rid,
                    decode=d_rid, blocks=out.get("blocks", 0),
                    bytes=out.get("bytes", 0),
                    transport=out.get("transport", ""))
                return d_rid
            # prefilled-but-not-shipped (or upstream refusal): the
            # decode preference still stands when the prefill side
            # answered at all — a cold decode there is no worse than
            # a cold decode anywhere else
            with self._obs_lock:
                self.counters.inc("prefill_misses")
            return d_rid if status == 200 else None
        except (OSError, ValueError, KeyError, StopIteration,
                TimeoutError, http.client.HTTPException) as e:
            # includes chaos.NetPartitioned (a ConnectionError): a
            # partitioned prefill tier must never fail the request —
            # the decode side serves cold, correctly
            with self._obs_lock:
                self.counters.inc("prefill_errors")
            logger.debug("prefill stage skipped: %s", e)
            return None
        finally:
            with self._obs_lock:
                self.timers.add("prefill", time.monotonic() - t0)

    def _affinity_break(self, reason):
        """Tally one affinity break (warm preference not honored) under
        ``reason`` — the tfos_fleet_affinity_breaks{reason} series."""
        with self._obs_lock:
            self._affinity_breaks[reason] = \
                self._affinity_breaks.get(reason, 0) + 1

    def _affinity_failover(self, session, rid, hint):
        """A health-relevant upstream failure on ``rid``: when it was
        the session's WARM target, evict the map entry (the failover
        proceeds COLD — the dedup key already makes the retry safe)
        and count the break once per incident (evict() reports whether
        an entry actually existed)."""
        if session is None or hint is None or rid != hint:
            return
        if self.affinity.evict(session):
            self._affinity_break("failover_cold")

    def _spread_tenant(self, tenant, order, views):
        """Burst spreading: when the first-pick replica
        already holds a strict majority of this tenant's fleet-wide
        backlog (queued + active, read from the beat-carried tenant
        gauges), demote it in favor of the candidate carrying the
        LEAST of that tenant — one noisy tenant's burst spreads across
        the fleet instead of stacking its own convoy on one replica.
        The caller only invokes this when nothing warmer pinned the
        leader (ship target / session hint / digest match), so
        affinity always outranks spreading. Returns the (possibly
        re-ordered) candidate list."""
        by_rid = {str(v.get("replica_id")): (v.get("tenants") or {})
                  for v in views}

        def burden(rid):
            t = by_rid.get(rid, {}).get(tenant) or {}
            try:
                return int(t.get("queued", 0)) + int(t.get("active", 0))
            except (TypeError, ValueError):
                return 0

        total = sum(burden(r) for r in order)
        lead = burden(order[0])
        # "concentrating" = the leader holds a strict majority of a
        # backlog worth spreading (>1: a single queued request is not
        # a burst, and zero-schema replicas report nothing)
        if total <= 1 or lead * 2 <= total:
            return order
        best = min(order[1:], key=burden)
        if burden(best) >= lead:
            return order
        with self._obs_lock:
            self.counters.inc("tenant_spreads")
        return [best] + [r for r in order if r != best]

    def _maybe_prewarm(self, warm_rids, cold_rid, prompt_tokens,
                       session, trace, snapshot):
        """Minimal digest-driven predictive placement: the request's
        warm replica sat past the load guard, so THIS dispatch went
        cold to ``cold_rid`` — have the saturated warm replica ship
        the prefix there via the kv-ship plane (its ``:prefill``
        surface: prefix-cache hit + ship) so the next turn of this hot
        prefix lands warm instead of re-prefilling. Strictly best-effort on a daemon
        thread — the current request never waits on it — and bounded
        to one in-flight shipment per (warm, cold) pair."""
        warm_rid = next(iter(warm_rids), None)
        if warm_rid is None or warm_rid == cold_rid:
            return
        w_info = snapshot.get(warm_rid) or {}
        c_info = snapshot.get(cold_rid) or {}
        w_addr, c_addr = w_info.get("addr"), c_info.get("addr")
        if not w_addr or not c_addr:
            return
        key = (warm_rid, cold_rid)
        with self._obs_lock:
            if key in self._prewarm_inflight:
                return
            self._prewarm_inflight.add(key)
            self.counters.inc("prefix_prewarms")
        self.flight.instant("prefix_prewarm", trace=trace,
                            warm=warm_rid, cold=cold_rid)
        body = json.dumps({
            "prompt": list(prompt_tokens),
            "session": session,
            "src_epoch": w_info.get("epoch"),
            "ship": {"addr": "{}:{}".format(c_addr[0], c_addr[1]),
                     "replica_id": cold_rid,
                     "epoch": c_info.get("epoch")},
        }).encode()

        def _run():
            try:
                _http_request(
                    tuple(w_addr), "POST",
                    "/v1/models/{}:prefill".format(self.name),
                    body=body, timeout=self.prefill_timeout,
                    connect_timeout=self.connect_timeout,
                    extra_headers={"X-TFOS-Trace": str(trace)},
                    net_src="router", net_dst=warm_rid)
            except (OSError, ValueError, TimeoutError,
                    http.client.HTTPException) as e:
                # a failed pre-warm costs nothing: the next dispatch
                # just prefills cold, exactly as it would have anyway
                logger.debug("prefix pre-warm skipped: %s", e)
            finally:
                with self._obs_lock:
                    self._prewarm_inflight.discard(key)

        # tfos: unjoined(best-effort background shipment, never awaited by a dispatch; completion observable via tfos_fleet_prefix_prewarms)
        threading.Thread(target=_run, daemon=True,
                         name="tfos-fleet-prewarm").start()

    def _hedge_delay(self):
        """Seconds to wait before hedging, derived from the router's
        own upstream-latency histogram at ``hedge_quantile`` (floored
        at ``hedge_min_delay``); None while hedging is off or the
        histogram holds fewer than ``hedge_min_samples`` observations
        — the delay is evidence, never a cold guess."""
        if self.hedge_quantile is None:
            return None
        with self._obs_lock:
            if self._hist_upstream.count < self.hedge_min_samples:
                return None
            q = self._hist_upstream.quantile(self.hedge_quantile)
        if q is None:
            return None
        return max(float(q), self.hedge_min_delay)

    def _attempt_hedged(self, raw_body, tried, upstream_spent,
                        client_gone, trace, attempts_made, request_id,
                        session=None, prompt_tokens=None, prefer=None,
                        tenant=None, priority=None):
        """One retry_call step, possibly racing TWO upstream attempts:
        the primary starts immediately; if it is still running after
        :meth:`_hedge_delay`, a hedge attempt goes to a DIFFERENT
        replica (``tried`` already excludes the primary's) and the
        first response wins. The loser is aborted through the same
        teardown a vanished client gets (socket shutdown -> replica's
        disconnect cancel frees the slot) — and because both attempts
        carry the same ``X-TFOS-Request-Id``, a loser that had already
        finished generating is just a dedup-window entry, not a
        duplicate completion. With hedging off (or no evidence yet)
        this is exactly one plain :meth:`_attempt` on the caller's
        thread."""
        hedge_delay = self._hedge_delay()
        if hedge_delay is None:
            return self._attempt(raw_body, tried, upstream_spent,
                                 client_gone, trace, attempts_made,
                                 request_id, session=session,
                                 prompt_tokens=prompt_tokens,
                                 prefer=prefer, tenant=tenant,
                                 priority=priority)
        cv = threading.Condition()
        outcomes = []  # (label, "ok"|"err", payload) in arrival order
        lose = threading.Event()
        # label -> (replica_id, warm) recorded by each attempt at pick
        # time: the race loop — not the attempts — owns the affinity
        # map under hedging, because only it knows which attempt WON
        # (an attempt that merely completed must not note the map)
        picked = {}

        def _run(label, skip_if_no_alternative=False):
            try:
                if skip_if_no_alternative:
                    # a hedge only makes sense against a DIFFERENT
                    # replica; with nobody else routable, joining the
                    # primary's replica would just clear `tried` and
                    # confuse failover bookkeeping
                    views = decode_eligible(self.replica_views())
                    if not [r for r in route_order(views,
                                                   self.stale_after)
                            if r not in tried]:
                        raise _HedgeLost("no alternative replica")
                out = self._attempt(raw_body, tried, upstream_spent,
                                    client_gone, trace, attempts_made,
                                    request_id, lose=lose,
                                    hedge=skip_if_no_alternative,
                                    session=session,
                                    prompt_tokens=prompt_tokens,
                                    picked=picked, label=label,
                                    prefer=prefer, tenant=tenant,
                                    priority=priority)
                with cv:
                    outcomes.append((label, "ok", out))
                    cv.notify_all()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                with cv:
                    outcomes.append((label, "err", e))
                    cv.notify_all()

        # tfos: unjoined(the race loop collects outcomes via the cv; a losing attempt may outlive the dispatch by design)
        threading.Thread(target=_run, args=("primary",), daemon=True,
                         name="tfos-fleet-attempt").start()
        with cv:
            if not outcomes:
                cv.wait(hedge_delay)
            hedged = not outcomes
        live = 1
        hedge_t0 = None
        if hedged:
            with self._obs_lock:
                self.counters.inc("hedges")
            self.flight.instant("hedge_fired", trace=trace,
                                delay_s=round(hedge_delay, 4))
            hedge_t0 = time.monotonic()
            # tfos: unjoined(same contract as the primary attempt above)
            threading.Thread(target=_run,
                             args=("hedge", True), daemon=True,
                             name="tfos-fleet-hedge").start()
            live = 2
        seen = 0
        last_err = None
        while True:
            with cv:
                while len(outcomes) <= seen:
                    cv.wait(0.05)
                label, kind, payload = outcomes[seen]
            seen += 1
            if hedge_t0 is not None:
                # first arrival after the hedge launched ends the
                # two-attempt race window — the hedge_wait slice of the
                # request's attribution (a _HedgeLost means the hedge
                # never actually ran, so no overlap existed)
                if not isinstance(payload, _HedgeLost):
                    with self._obs_lock:
                        self._hist_attrib["hedge_wait"].observe(
                            time.monotonic() - hedge_t0, trace=trace)
                hedge_t0 = None
            if kind == "ok":
                lose.set()
                if label == "hedge":
                    with self._obs_lock:
                        self.counters.inc("hedge_wins")
                    self.flight.instant("hedge_won", trace=trace)
                if session is not None:
                    rid, warm = picked.get(label, (None, False))
                    if label == "hedge" and not warm:
                        # a COLD hedge won the race: the answer stands,
                        # but remembering the cold replica would poison
                        # the session's affinity — count the break and
                        # leave the map alone (the warm entry, if any,
                        # survives for the next turn)
                        self._affinity_break("hedge_cold_win")
                    elif rid is not None:
                        self.affinity.note(session, rid)
                return payload
            if isinstance(payload, _HedgeLost):
                live -= 1  # hedge had nowhere to go; primary decides
            elif isinstance(payload, _ClientGone):
                # the END CLIENT is gone: nothing left to win. The
                # race loop owns the count — exactly one per dispatch,
                # no matter how many racing attempts saw the vanish
                lose.set()
                with self._obs_lock:
                    self.counters.inc("client_disconnects")
                raise payload
            else:
                live -= 1
                last_err = payload
            if live == 0:
                # every live attempt failed; surface the last real
                # error (payload as a fallback guards the impossible
                # all-_HedgeLost case against `raise None`)
                raise last_err if last_err is not None else payload

    def _attempt(self, raw_body, tried, upstream_spent,
                 client_gone=None, trace=0, attempts_made=None,
                 request_id=None, lose=None, hedge=False,
                 session=None, prompt_tokens=None, picked=None,
                 label=None, prefer=None, tenant=None, priority=None):
        """One dispatch attempt: pick the best untried replica —
        prefix/session-aware via :func:`affinity_plan`, so the
        session's remembered replica or the deepest digest match wins
        unless the load guard demotes it — POST, classify the outcome.
        Raises Retriable to make retry_call fail over; anything else
        returns verbatim for the client. ``lose`` (hedging): an event
        that aborts this attempt because its rival already won — the
        teardown path is the client-disconnect one, but it is
        accounted as a lost hedge, not a disconnect. ``hedge``: this
        attempt exists only to race a DIFFERENT replica, so it must
        never take the clear-and-retry-same-replica fallback — with no
        alternative at pick time it withdraws (:class:`_HedgeLost`)
        and leaves the primary to decide; because affinity ordering
        applies to every pick, a hedge naturally lands on the
        next-warmest untried alternative. ``picked``/``label``
        (hedging): pick-time ``(replica_id, warm)`` reported back so
        the race loop — the only place that knows which attempt WON —
        can own the affinity-map note."""
        if client_gone is not None and client_gone():
            # vanished before we even picked: don't burn a slot.
            # Under hedging (lose is not None) the OUTER race loop
            # owns the disconnect count — two racing attempts seeing
            # the same vanished client must tally ONE disconnect
            if lose is None:
                with self._obs_lock:
                    self.counters.inc("client_disconnects")
            raise _ClientGone("client disconnected before dispatch")
        now = time.monotonic()
        t_pick = time.monotonic()
        snapshot = self._snapshot()
        # :generate routes AROUND the prefill tier: its
        # replicas fill and ship KV blocks; decode streams belong to
        # the decode/mixed tiers (decode_eligible keeps the all-
        # prefill degenerate fleet servable)
        views = decode_eligible(self.replica_views(now, snapshot))
        hint = self.affinity.lookup(session) \
            if session is not None else None
        matches = {}
        if prompt_tokens:
            for view in views:
                depth = digest_match(view, prompt_tokens)
                if depth:
                    matches[str(view.get("replica_id"))] = depth
        full_order, plan = affinity_plan(
            views, matches, hint, self.stale_after, self.load_guard)
        if prefer is not None and prefer in full_order \
                and prefer not in tried:
            # two-stage dispatch already shipped this prompt's KV
            # blocks to `prefer`: landing anywhere else forfeits the
            # splice (the whole point of the staging). Failover still
            # works — a preferred replica that errors joins `tried`
            # and the next attempt proceeds on plain affinity order
            full_order = [prefer] + [r for r in full_order
                                     if r != prefer]
        elif tenant is not None and len(full_order) > 1 \
                and full_order[0] != hint \
                and not matches.get(full_order[0]):
            # burst spreading: only when nothing pinned the
            # leader — a ship target, session hint, or digest match
            # (warmth) always outranks spreading
            full_order = self._spread_tenant(tenant, full_order, views)
        if hint is not None and not plan["hint_routable"]:
            # the session's warm replica is dead, draining, or stale:
            # the request proceeds COLD (never an error — the colder
            # candidates below serve it), and the map entry goes now,
            # so the next turn doesn't re-court the corpse. evict()
            # reports whether an entry still existed — the
            # once-per-incident guard for the break counter.
            if self.affinity.evict(session):
                self._affinity_break("failover_cold")
            hint = None
        with self._obs_lock:
            order = [rid for rid in full_order if rid not in tried]
            if not order and tried:
                if hedge:
                    # the hedge's whole point is a DIFFERENT replica;
                    # clearing `tried` here would erase the request's
                    # failover exclusions and re-dispatch to the
                    # primary's own (possibly gray) replica — withdraw
                    # instead, even if the pre-launch check passed and
                    # a staleness flip emptied the field since
                    raise _HedgeLost("no alternative replica at pick")
                # every routable replica was tried this request: clear
                # the per-request exclusions so backoff + a fresh pick
                # can retry one (it may have recovered — bounded by
                # retry_call's attempt budget either way)
                tried.clear()
                order = list(full_order)
            if order:
                tried.add(order[0])
            self.timers.add("pick", time.monotonic() - t_pick)
        if not order:
            with self._obs_lock:
                self.counters.inc("no_replica")
            raise NoReplicaAvailable(
                "no routable replica ({} known)".format(len(views)))
        rid = order[0]
        warm = rid == hint or bool(matches.get(rid))
        if picked is not None and label is not None:
            picked[label] = (rid, warm)
        if warm:
            # the request landed on a replica whose cache plausibly
            # holds its prefix (session memory or digest match) — the
            # fleet-wide warm-TTFT signal the bench pins
            with self._obs_lock:
                self.counters.inc("affinity_hits")
        elif any(g not in tried for g in plan["guarded"]):
            # warm candidates existed but the load guard sent the
            # request to a colder, less-loaded replica — affinity
            # yielded to load, by design
            self._affinity_break("load_guard")
            # digest-driven predictive placement: this request's hot
            # prefix saturated its warm replica, so THIS dispatch
            # serves cold — but the warm replica can ship the prefix
            # to the cold pick via the kv-ship plane so the NEXT one
            # lands warm
            if prompt_tokens:
                self._maybe_prewarm(
                    [g for g in plan["guarded"] if g not in tried],
                    rid, prompt_tokens, session, trace, snapshot)
        addr = (snapshot.get(rid) or {}).get("addr")
        if not addr:
            raise ReplicaUnavailable(
                "replica {} has no advertised address".format(rid))
        more = len(order) > 1
        path = "/v1/models/{}:generate".format(self.name)
        abort = client_gone
        if lose is not None:
            abort = lambda: ((client_gone is not None and client_gone())
                             or lose.is_set())
        with self._obs_lock:
            if attempts_made is not None:
                attempts_made[0] += 1
            attempt_no = attempts_made[0] if attempts_made else 1
        extra = {"X-TFOS-Trace": str(trace)}
        if tenant is not None:
            # tenant identity survives failover: every retry and hedge
            # of one client request carries the same headers, so
            # replica-side logs/traces and any tier-crossing hop see
            # one consistent identity (the BODY fields stay the
            # engine's authoritative source)
            extra["X-TFOS-Tenant"] = str(tenant)
            extra["X-TFOS-Priority"] = str(priority or DEFAULT_PRIORITY)
        if request_id is not None:
            # idempotency key + attempt ordinal: every retry and hedge
            # of one client request shares the id, so the replica's
            # dedup window can absorb duplicates of work it already did
            extra["X-TFOS-Request-Id"] = str(request_id)
            extra["X-TFOS-Attempt"] = str(attempt_no)
        self._note_inflight(rid, +1)
        t_up = time.monotonic()
        try:
            status, body, headers = _http_request(
                addr, "POST", path, body=raw_body,
                timeout=self.upstream_timeout,
                connect_timeout=self.connect_timeout, abort=abort,
                extra_headers=extra, net_src="router", net_dst=rid)
        except _ClientGone:
            if lose is not None and lose.is_set():
                # aborted because the rival attempt won — the client is
                # still there; must not count as a disconnect
                raise _HedgeLost("hedge rival won")
            # OUR client hung up; the upstream teardown already told
            # the replica (socket EOF -> its disconnect cancel). Not a
            # replica failure, not retriable — there is nobody left to
            # answer. Hedged attempts (lose is not None) leave the
            # count to the outer race loop: both racing attempts see
            # the same vanished client, which is ONE disconnect
            if lose is None:
                with self._obs_lock:
                    self.counters.inc("client_disconnects")
            raise
        except (OSError, http.client.HTTPException) as e:
            self.health.note_failure(rid, time.monotonic(),
                                     reason=str(e))
            self._affinity_failover(session, rid, hint)
            with self._obs_lock:
                self.counters.inc("failovers")
            raise ReplicaUnavailable(
                "replica {} unreachable: {}".format(rid, e),
                retry_after=0.0 if more else 0.5)
        finally:
            dt = time.monotonic() - t_up
            self.flight.span("upstream", t_up, t_up + dt, trace=trace,
                             replica=rid)
            with self._obs_lock:
                self.timers.add("upstream", dt)
                self._hist_upstream.observe(dt)
                upstream_spent[0] += dt
            self._note_inflight(rid, -1)
        if status == 410 and self._retriable_kind(status, body) == "Fenced":
            # a FENCED replica (stale lease epoch) can never serve this
            # request — non-retriable AT the replica, but the fleet
            # holds a valid successor, so the router fails over and
            # hard-downs the fenced address
            self.health.note_failure(rid, time.monotonic(),
                                     reason="Fenced")
            self._affinity_failover(session, rid, hint)
            with self._obs_lock:
                self.counters.inc("failovers")
                self.counters.inc("fenced_upstreams")
            raise ReplicaUnavailable(
                "replica {} is fenced (stale lease epoch)".format(rid),
                retry_after=0.0 if more else 0.5)
        if status == 429 \
                and self._retriable_kind(status, body) == "QuotaExceeded":
            # per-tenant quota refusal is POLICY, not load: the
            # quota follows the TENANT across every replica, so failing
            # over would just re-ask the same question elsewhere (and a
            # fleet of N replicas would multiply the tenant's effective
            # quota by N). Pass the replica's verdict through verbatim,
            # honest Retry-After included; the replica behaved
            # correctly, so it stays healthy.
            self.health.note_success(rid)
            return status, body, headers
        if status in serving.RETRIABLE_HTTP_STATUS:
            kind = self._retriable_kind(status, body)
            if kind == "EngineFailed":
                # the one transient that is replica UNHEALTHINESS;
                # Shed/QueueFull are load, Draining self-excludes via
                # its beat — penalizing those would eject replicas for
                # doing admission control correctly. Same split for
                # affinity: only health-relevant failures evict the
                # session's map entry — a warm replica shedding load
                # is still the warm replica next turn
                self.health.note_failure(rid, time.monotonic(),
                                         reason=kind)
                self._affinity_failover(session, rid, hint)
            with self._obs_lock:
                self.counters.inc("failovers")
            retry_after = headers.get("Retry-After")
            try:
                retry_after = float(retry_after)
            except (TypeError, ValueError):
                retry_after = 1.0
            raise ReplicaUnavailable(
                "replica {} answered {} ({})".format(rid, status, kind),
                retry_after=0.0 if more else retry_after)
        self.health.note_success(rid)
        if session is not None and lose is None:
            # un-hedged attempts ARE the winner, so they note the map
            # themselves; hedged attempts leave it to the race loop
            # (only it knows which rival actually won — and a cold
            # hedge win must count a break, not poison the map)
            self.affinity.note(session, rid)
        return status, body, headers

    @staticmethod
    def _retriable_kind(status, body):
        try:
            parsed = json.loads(body)
            kind = parsed.get("kind") \
                or ("Draining" if parsed.get("status") == "draining"
                    else None)
        except (ValueError, AttributeError):
            kind = None
        if status == 429:
            # 429 bodies carry a kind (QuotaExceeded must
            # be told apart from backpressure); a bare 429 predates it
            # and can only be the engine's QueueFull
            return kind or "QueueFull"
        return kind or "Retriable"

    # -- half-open probing -------------------------------------------------

    def _probe_loop(self):
        while not self._probe_stop.is_set():
            try:
                self._probe_once()
            except Exception:  # noqa: BLE001 - probing must survive
                logger.exception("fleet probe pass failed")
            self._probe_stop.wait(self.probe_interval)

    def _probe_once(self, now=None):
        """Verify every half-open replica out-of-band: GET /healthz;
        200 readmits (note_success), anything else re-downs with an
        escalated cooldown. Recovery never risks a live request."""
        now = now if now is not None else time.monotonic()
        snapshot = self._snapshot()
        for rid in self.health.known():
            if self.health.state(rid, now) != ReplicaHealth.PROBE:
                continue
            addr = (snapshot.get(rid) or {}).get("addr")
            if not addr:
                continue
            with self._obs_lock:
                self.counters.inc("probes")
            try:
                status, _, _ = _http_request(addr, "GET", "/healthz",
                                             timeout=5.0,
                                             net_src="router",
                                             net_dst=rid)
            except (OSError, http.client.HTTPException) as e:
                status, e_str = None, str(e)
            if status == 200:
                self.health.note_success(rid)
                logger.info("replica %s probe OK: readmitted", rid)
            else:
                self.health.note_failure(
                    rid, time.monotonic(),
                    reason="probe answered {}".format(status)
                    if status is not None else "probe failed: " + e_str)

    # -- operational surface ----------------------------------------------

    def healthz(self):
        """(status_code, body): 200 while at least one replica is
        routable, 503 otherwise; the body carries the per-replica view
        (state / lease age / gauges / in-flight) an operator or LB
        reads to tell WHICH replica is the problem."""
        now = time.monotonic()
        views = self.replica_views(now)
        order = route_order(views, self.stale_after)
        body = {"status": "ok" if order else "unavailable",
                "model": self.name,
                "routable": len(order),
                "affinity_entries": len(self.affinity),
                "replicas": {v["replica_id"]: {
                    "state": v["state"], "age": v["age"],
                    "alive": v["alive"], "draining": v["draining"],
                    "queue_depth": v["queue_depth"],
                    "slot_occupancy": v["slot_occupancy"],
                    "attn_impl": v["attn_impl"],
                    "generated_prefix_hit_blocks":
                        v["generated_prefix_hit_blocks"],
                    "speculate_k": v["speculate_k"],
                    "spec_acceptance_rate": v["spec_acceptance_rate"],
                    "kv_dtype": v["kv_dtype"],
                    "tier": v["tier"],
                    # per-replica warmth at a glance: how many chains
                    # the replica's digest publishes, and whether the
                    # top-K bound cut any
                    "prefix_digest_chains": len(v["prefix_digest"]),
                    "digest_truncated": v["digest_truncated"],
                    "inflight": v["inflight"]} for v in views}}
        return (200 if order else 503), body

    def metrics_text(self):
        """One OpenMetrics document: the router's own registry
        (unlabeled) + every replica's beat-carried engine snapshot as
        ``replica``-labeled series + hand-rendered per-replica routing
        gauges — rendered through the one grammar-correct
        multi-snapshot core, so each family appears once."""
        now = time.monotonic()
        snapshot = self._snapshot()
        views = self.replica_views(now, snapshot)
        order = set(route_order(views, self.stale_after))
        # read the map size BEFORE taking _obs_lock (the AffinityMap
        # has its own lock; never nest the two)
        affinity_entries = len(self.affinity)
        # SLO sampling ALSO runs before _obs_lock: the monitor takes
        # its own lock then calls router accessors that take _obs_lock
        # — the one allowed ordering (monitor lock -> _obs_lock)
        try:
            slo_lines = self.slo.metric_lines(now=now)
        except Exception:
            slo_lines = []
        with self._obs_lock:
            self.counters.gauge("replicas", len(views))
            self.counters.gauge("replicas_routable", len(order))
            self.counters.gauge("affinity_entries", affinity_entries)
            breaks = dict(self._affinity_breaks)
            resets = dict(self._affinity_resets)
        lines = []
        if breaks:
            lines.append("# TYPE tfos_fleet_affinity_breaks counter")
            for reason in sorted(breaks):
                lines.append(
                    'tfos_fleet_affinity_breaks{{reason="{}"}} {}'
                    .format(reason, breaks[reason]))
        if resets:
            lines.append("# TYPE tfos_fleet_affinity_resets counter")
            for reason in sorted(resets):
                lines.append(
                    'tfos_fleet_affinity_resets_total{{reason="{}"}} {}'
                    .format(reason, resets[reason]))
        lines.extend(slo_lines)
        for family, key in (
                ("tfos_fleet_replica_up",
                 lambda v: 1 if v["replica_id"] in order else 0),
                ("tfos_fleet_replica_lease_age_seconds",
                 lambda v: v["age"]),
                ("tfos_fleet_replica_inflight",
                 lambda v: v["inflight"])):
            if not views:
                continue
            lines.append("# TYPE {} gauge".format(family))
            for v in views:
                lines.append('{}{{replica="{}"}} {}'.format(
                    family, v["replica_id"], tracing._fmt(key(v))))
        # tier topology: replica -> serving tier as an info-
        # pattern gauge, so the prefill/decode split is legible from
        # one scrape next to the per-tier load series
        if views:
            lines.append("# TYPE tfos_fleet_replica_tier gauge")
            for v in views:
                lines.append(
                    'tfos_fleet_replica_tier{{replica="{}",tier="{}"}}'
                    ' 1'.format(v["replica_id"], v["tier"]))
        # replica_id -> executor join: which executor hosts
        # each replica, from the beat-carried host metadata — the
        # info-pattern gauge an operator joins autoscale decisions and
        # per-replica series against (absent for driver-local replicas)
        hosted = [(rid, snapshot[rid]["host"]) for rid in sorted(snapshot)
                  if snapshot[rid].get("host")]
        if hosted:
            lines.append("# TYPE tfos_serving_replica_host gauge")
            for rid, host in hosted:
                lines.append(
                    'tfos_serving_replica_host{{replica_id="{}",'
                    'executor="{}"}} 1'.format(rid,
                                               host.get("executor")))
        labeled = [((), self.metrics.snapshot())]
        for rid in sorted(snapshot):
            m = snapshot[rid].get("metrics")
            if m:
                labeled.append(((("replica", rid),), m))
        body = tracing.render_labeled(labeled)
        if lines:
            body = "\n".join(lines) + "\n" + body
        return body

    def debug_trace(self):
        """(stitched_chrome_trace, dropped_total) — the router's span
        ring plus every live replica's ``GET /debug/trace`` dump,
        stitched onto ONE wall-clock-aligned timeline
        (``tracing.stitch_traces``): a request that failed over
        mid-stream reads as one causal row — router ``dispatch``
        envelope, an ``upstream`` span per attempt, and each replica's
        engine spans — because every span shares the minted
        ``X-TFOS-Trace`` id. Replica fetches are best-effort (a dead
        replica's ring is simply absent); ``dropped_total`` sums every
        source ring's eviction tally (the ``X-TFOS-Trace-Dropped``
        response header — ring saturation must not be silent)."""
        snapshot = self._snapshot()
        fetched = {}
        fetched_lock = threading.Lock()

        def _fetch(rid, addr):
            try:
                status, body, _ = _http_request(addr, "GET",
                                                "/debug/trace",
                                                timeout=5.0)
                if status == 200:
                    doc = json.loads(body)
                    with fetched_lock:
                        fetched[rid] = doc
            except (OSError, ValueError,
                    http.client.HTTPException) as e:
                logger.debug("trace fetch from replica %s failed: %s",
                             rid, e)

        # fetch CONCURRENTLY: the dump is most wanted exactly when
        # some replicas are wedged, and sequential 5s timeouts would
        # make it cost 5s per hung host instead of ~one fetch's worth
        threads = []
        for rid in sorted(snapshot):
            addr = (snapshot.get(rid) or {}).get("addr")
            if not addr:
                continue
            t = threading.Thread(target=_fetch, args=(rid, addr),
                                 daemon=True,
                                 name="tfos-trace-fetch-{}".format(rid))
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=6.0)
        # a straggler past the join timeout may STILL insert (daemon
        # thread): snapshot under the lock, into a DIFFERENT name —
        # rebinding `fetched` would swap the closure cell the straggler
        # writes through, putting its insert right back into the dict
        # the stitch iterates
        with fetched_lock:
            docs = dict(fetched)
        sources = [("router", self.flight.chrome_trace())]
        sources.extend((rid, docs[rid]) for rid in sorted(docs))
        stitched = tracing.stitch_traces(sources)
        return stitched, sum(stitched["dropped"].values())

    # -- rolling drain -----------------------------------------------------

    def rolling_drain(self, upgrade=None, drain_timeout=None,
                      healthz_timeout=30.0):
        """Zero-downtime engine upgrade across the fleet, one replica
        at a time: quiesce (this router stops routing new work to it)
        -> drain (every admitted request finishes — the zero-loss
        contract) -> build the successor (``upgrade(old_engine)`` ->
        new engine, e.g. same config with fresh weights; default
        ``respawn()``) -> re-arm -> wait for ``GET /healthz`` to
        answer 200 over the wire -> readmit. Traffic keeps flowing
        through the remaining replicas for the whole cycle. Works over
        in-process Replica agents AND executor-hosted RemoteReplicas —
        both speak the same ``drain_engine``/``respawn_engine`` verbs
        (remotely those are the /admin lifecycle RPCs); ``upgrade=``
        callables are in-process only.

        Returns a report dict: per-replica ``{replica_id,
        drained_clean, recovered, wall_s}`` plus ``zero_loss`` (every
        drain finished all admitted work) and ``completed`` (every
        replica recovered; the cycle ABORTS — replica left quiesced —
        rather than drain a second replica while one is down, so a
        failed upgrade degrades capacity by exactly one replica)."""
        if not self.replicas:
            raise RuntimeError(
                "rolling_drain needs Replica handles (router "
                "constructed with replicas=[...])")
        if upgrade is not None and any(getattr(r, "remote", False)
                                       for r in self.replicas):
            # refuse UP FRONT: discovering this on the first remote
            # respawn would already have drained (and stopped) that
            # replica's engine for nothing
            raise NotImplementedError(
                "rolling_drain(upgrade=...) cannot cross the process "
                "boundary to executor-hosted replicas; ship new "
                "weights via a respawn-from-checkpoint spec instead")
        report = {"replicas": [], "zero_loss": True, "completed": True}
        for replica in list(self.replicas):
            rid = replica.replica_id
            t0 = time.monotonic()
            self.quiesce(rid, "rolling drain", owner="rolling-drain")
            # the respawned engine comes back with an EMPTY prefix
            # cache: sessions remembered against the old incarnation
            # would steer at cold blocks — purge them now
            self.affinity.purge_replica(rid)
            clean = recovered = False
            try:
                clean = replica.drain_engine(timeout=drain_timeout)
                replica.respawn_engine(upgrade=upgrade)
            except (RuntimeError, OSError,
                    http.client.HTTPException) as e:
                # stopped server mid-cycle / unreachable executor:
                # nothing to drain OR rebuild from — abort rather than
                # guess at a successor (replica left quiesced)
                logger.error("rolling drain of replica %s failed: %s",
                             rid, e)
            else:
                recovered = self._await_healthz(replica.addr,
                                                healthz_timeout)
            if recovered:
                self.readmit(rid, owner="rolling-drain")
            wall = time.monotonic() - t0
            report["replicas"].append(
                {"replica_id": rid, "drained_clean": bool(clean),
                 "recovered": recovered, "wall_s": round(wall, 3)})
            report["zero_loss"] &= bool(clean)
            if not recovered:
                logger.error(
                    "rolling drain ABORTED: replica %s did not answer "
                    "a healthy /healthz within %.0fs (left quiesced)",
                    rid, healthz_timeout)
                report["completed"] = False
                break
        return report

    @staticmethod
    def _await_healthz(addr, timeout):
        if not addr:
            return False
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            try:
                status, _, _ = _http_request(addr, "GET", "/healthz",
                                             timeout=5.0)
                if status == 200:
                    return True
            except (OSError, http.client.HTTPException):
                pass
            time.sleep(0.05)
        return False

    # -- http plumbing -----------------------------------------------------

    def start(self):
        """Serve in a daemon thread; returns (host, port). Also starts
        the half-open probe loop."""
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer

        router = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code, body_bytes, content_type, headers=None):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body_bytes)))
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body_bytes)

            def _send_json(self, code, obj, headers=None):
                self._send(code, json.dumps(obj).encode("utf-8"),
                           "application/json", headers)

            def do_GET(self):
                if self.path == "/healthz":
                    code, body = router.healthz()
                    return self._send_json(code, body)
                if self.path == "/metrics":
                    return self._send(
                        200, router.metrics_text().encode("utf-8"),
                        serving.OPENMETRICS_CONTENT_TYPE)
                if self.path == "/slo":
                    return self._send_json(200, router.slo.verdict())
                if self.path == "/debug/trace":
                    stitched, dropped = router.debug_trace()
                    return self._send(
                        200, json.dumps(stitched).encode("utf-8"),
                        "application/json",
                        headers={"X-TFOS-Trace-Dropped": str(dropped)})
                return self._send_json(
                    404, {"error": "not found: %s" % self.path})

            def _client_gone(self):
                """True once OUR client closed its connection (readable
                with EOF — a live client waiting on its response sends
                nothing). Polled during the upstream exchange so an
                end-client disconnect propagates: upstream teardown ->
                replica's socket-EOF cancel -> slot freed (the disconnect
                contract, preserved through the router)."""
                import select
                try:
                    readable, _, _ = select.select(
                        [self.connection], [], [], 0)
                    if not readable:
                        return False
                    return self.connection.recv(
                        1, socket.MSG_PEEK) == b""
                except (OSError, ValueError):
                    return True

            def do_POST(self):
                # read the body before any reply, a refusal too: a
                # connection closed with unread request bytes is reset,
                # and the reset can overtake the reply
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    n = 0
                raw = (self.rfile.read(n) if n > 0 else b"") or b"{}"
                if self.path != "/v1/models/%s:generate" % router.name:
                    return self._send_json(
                        404, {"error": "not found: %s" % self.path})
                try:
                    status, body, retry_after = router.dispatch(
                        raw, client_gone=self._client_gone)
                    headers = {} if retry_after is None \
                        else {"Retry-After": str(retry_after)}
                    return self._send(status, body, "application/json",
                                      headers)
                except _ClientGone as e:
                    # the socket is almost certainly gone; best-effort
                    # 499 (client closed request), never a 500 dump
                    try:
                        return self._send_json(499, {"error": str(e)})
                    except OSError:
                        return
                except Exception as e:  # noqa: BLE001 - surface as 500
                    logger.exception("fleet dispatch failed")
                    return self._send_json(500, {"error": str(e)})

            def log_message(self, fmt, *args):  # quiet by default
                logger.debug("fleet router: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          Handler)
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tfos-fleet-router",
            daemon=True)
        self._thread.start()
        self._probe_stop.clear()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="tfos-fleet-probe",
            daemon=True)
        self._probe_thread.start()
        # honesty tally: a router starting with an EMPTY
        # AffinityMap over replicas that have ALREADY served traffic
        # lost someone's session warmth — record why (takeover vs
        # restart) so the warm-hit-rate dip is attributable from the
        # scrape alone. A fresh fleet (no completions yet) is not a
        # reset; it never had warmth to lose.
        if len(self.affinity) == 0:
            try:
                snapshot = self._snapshot()
            except Exception:
                snapshot = {}
            served = any(
                ((info.get("metrics") or {}).get("counters", {})
                 .get("tfos_serving", {}) or {}).get("counts", {})
                .get("requests_completed", 0)
                for info in snapshot.values())
            if served:
                self._note_affinity_reset(self._affinity_reset_reason)
        logger.info("fleet router for %r on %s:%d", self.name,
                    self._host, self._port)
        return self._host, self._port

    @property
    def addr(self):
        return (self._host, self._port)

    def stop(self):
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)
            self._probe_thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10)
            self._httpd = None

    def crash(self):
        """Chaos only: die the way a SIGKILLed router process
        looks from outside — listening socket gone mid-traffic, no
        drain, no goodbye. In-flight requests fail with connection
        resets, exactly as a real kill's would; the warm-standby
        takeover e2e pins that the fleet recovers anyway. Runs the
        serve-loop shutdown from a helper thread because crash() is
        typically called from INSIDE a handler thread (the
        kill_router_at_request site)."""
        self._probe_stop.set()
        httpd, self._httpd = self._httpd, None
        self._thread = None
        if httpd is None:
            return
        try:
            httpd.server_close()  # the listener dies NOW
        except OSError:
            pass
        # tfos: unjoined(crash emulation — a killed process joins nothing)
        threading.Thread(target=httpd.shutdown, daemon=True,
                         name="tfos-fleet-router-crash").start()
        logger.warning("fleet router %r CRASHED (chaos kill) on %s:%d",
                       self.name, self._host, self._port)

    def __enter__(self):
        if self._httpd is None:
            self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


# -- fleet (driver-local or executor-hosted replicas) ----------------------

class NoCapacity(RuntimeError):
    """spawn_replica found no free executor to place a replica on —
    the autoscaler's evidence-gated "capacity exists" check failed
    (the regrow-probe pattern: scale-up waits for capacity, it never
    invents it)."""


class ServingFleet(object):
    """N serving replicas + reservation registry + router, wired and
    lifecycle-managed as one object (the shape the fleet bench, the
    chaos e2e, and ``cluster.serving_fleet`` use).

    ``model`` is the decode module (a port ``DecoderLM``).

    ``placement="driver"`` (default): every replica is a
    ``DecodeEngine`` in THIS process (``replica-<i>`` identity, its own
    copy of ``model`` on ``engine_kw["device"]``)
    behind its own ``ModelServer`` on an ephemeral port — the
    in-process shape. On one card its engines take turns launching
    (one lock a card, ``serving._launch_turn``), and each step carries
    only its own replica's batch: two in-process replicas serve about
    0.6x the tokens/s of one engine holding all their slots (PERF.md,
    an H100). Replicas in one process buy isolation and zero-loss
    upgrades, not throughput; for throughput on one card, give one
    engine more slots.

    ``placement="executors"``: replicas run INSIDE executor
    processes — ``sc`` (an engine :class:`~tensorflowonspark_tpu_torch
    .engine.context.Context`) ships a ``node.serve_replica`` bootstrap
    task per chosen executor, the executor-side :class:`ServingNode`
    builds the engine+server there and registers over the SAME BEAT
    lease with its real HTTP address, and the router routes to it
    exactly as it does to in-process replicas (dispatch is
    address-based). Fleet width stops being bounded by one process;
    :meth:`spawn_replica` / :meth:`retire_replica` /
    :meth:`replace_replica` make it dynamic (the autoscaler's verbs).

    ``start()`` blocks until every replica's first BEAT lease is live,
    so the router can route the moment it returns."""

    def __init__(self, model, replicas=2, name="model",
                 engine_kw=None, host="127.0.0.1", beat_interval=0.25,
                 reservation_server=None, router_kw=None,
                 placement="driver", sc=None, executors=None,
                 spawn_timeout=120.0, tiers=None, journal=None):
        #: tier topology: ``{"prefill": n, "decode": m}``
        #: (any subset of prefill/decode/mixed). When given it
        #: OVERRIDES ``replicas`` — the fleet forms with exactly the
        #: stated widths, each engine spawned with its tier, and the
        #: router's two-stage dispatch turns on by virtue of the tiers
        #: existing. None = a homogeneous "mixed" fleet.
        self.tiers = {str(t): int(n) for t, n in tiers.items()} \
            if tiers else None
        if self.tiers:
            bad = [t for t in self.tiers
                   if t not in ("prefill", "decode", "mixed")]
            if bad:
                raise ValueError(
                    "unknown tier(s) {}: tiers maps 'prefill' / "
                    "'decode' / 'mixed' to replica counts".format(bad))
            if any(n < 0 for n in self.tiers.values()):
                raise ValueError("tier widths must be >= 0")
            replicas = sum(self.tiers.values())
        if int(replicas) < 1:
            raise ValueError("a fleet needs >= 1 replica")
        if placement not in ("driver", "executors"):
            raise ValueError(
                "placement must be 'driver' or 'executors', got "
                "{!r}".format(placement))
        if placement == "executors" and sc is None:
            raise ValueError(
                "placement='executors' needs sc= (an engine Context "
                "to ship the serving bootstrap tasks through)")
        self.model = model
        self.n_replicas = int(replicas)
        self.name = name
        self.engine_kw = dict(engine_kw or {})
        self.host = host
        self.beat_interval = float(beat_interval)
        self.router_kw = dict(router_kw or {})
        self.placement = placement
        self.sc = sc
        #: optional explicit executor-id pool replicas may land on
        #: (None = any alive executor)
        self.executors = list(executors) if executors is not None \
            else None
        self.spawn_timeout = float(spawn_timeout)
        #: durable epoch-floor journal: a PATH the fleet's
        #: OWNED reservation server persists its fencing-epoch floors
        #: to — what lets restart_reservation() (and a whole restarted
        #: driver) come back unable to re-mint any epoch the old
        #: incarnation ever issued. None = in-memory floors. A
        #: ControlJournal instance is accepted and reduced to its
        #: path: restarts must REOPEN the file, not share a
        #: possibly-dead file handle.
        if journal is not None and not isinstance(journal, str):
            journal = getattr(journal, "path", None) or str(journal)
        if journal is not None and reservation_server is not None:
            raise ValueError(
                "journal= applies to the fleet's OWNED reservation "
                "server; attach the journal to your own Server "
                "(reservation.Server(..., journal=path)) instead")
        self.journal_path = journal
        #: control epoch: minted at start(), stamped on every
        #: admin RPC this driver issues — the leadership fence a
        #: warm-standby takeover raises to depose this driver
        self.control_epoch = None
        self._own_reservation = reservation_server is None
        self.reservation = reservation_server \
            if reservation_server is not None \
            else reservation.Server(0, journal=self.journal_path)
        self.replicas = []
        self.router = None
        self.supervisor = None
        self.autoscaler = None
        self._started = False
        self._resv_addr = None
        self._next_idx = 0
        self._module_spec = None
        self._spawns = {}  # rid -> AsyncResult of its bootstrap task
        # rid -> tier, recorded at spawn: a REPLACEMENT must
        # come back in its predecessor's tier, or a repaired
        # prefill/decode split silently collapses to mixed
        self._tier_by_rid = {}
        # guards the width bookkeeping (replicas / _next_idx /
        # _spawns) AND the executor-placement decision: the
        # autoscaler's control thread and operator threads drive
        # spawn/retire/replace concurrently, and the unlocked
        # ``_next_idx += 1`` read-modify-write can mint the SAME
        # replica id twice (two engines, one identity, one lease —
        # split-brain by construction), an unlocked list-mutation can
        # make ``_replica`` skip a member mid-scan, and an unlocked
        # free_executor()-then-dispatch lets two spawns both pick the
        # SAME free executor. RLock: the placement section holds it
        # across helpers (free_executor / _dispatch_spawn) that take
        # it themselves. Pinned by test_fleet.py's concurrent
        # _new_rid/_replica tests.
        self._lock = threading.RLock()

    # -- replica construction ----------------------------------------------

    def _new_rid(self):
        with self._lock:
            rid = "replica-{}".format(self._next_idx)
            self._next_idx += 1
            return rid

    def _replica(self, rid):
        with self._lock:
            for replica in self.replicas:
                if replica.replica_id == str(rid):
                    return replica
        return None

    def _track(self, replica):
        with self._lock:
            self.replicas.append(replica)

    def _untrack(self, replica):
        """Remove ``replica`` from the registry; True when it was
        tracked (the membership check and the removal are one atomic
        unit — two concurrent untracks cannot both 'win')."""
        with self._lock:
            if replica in self.replicas:
                self.replicas.remove(replica)
                return True
            return False

    def _formation_tiers(self):
        """The tier of each formation replica in spawn order
        (prefill first, so the feed side of the split is up before
        decode traffic can stage against it); ``[None] * n`` for an
        untiered fleet."""
        if not self.tiers:
            return [None] * self.n_replicas
        plan = []
        for tier in ("prefill", "decode", "mixed"):
            plan.extend([tier] * self.tiers.get(tier, 0))
        return plan

    def _replica_module(self):
        """A module of this replica's own: in-process replicas never
        share one, so a rolling ``upgrade=`` swaps only the drained
        replica's weights."""
        return copy.deepcopy(self.model)

    def _spawn_local_replica(self, rid, tier=None):
        # one FlightRecorder PER replica (unless the caller provided
        # one): real deployments have one ring per process, and the
        # router's /debug/trace stitch labels spans by source —
        # in-process replicas sharing the process-global ring would
        # each dump EVERYONE's spans under their own label
        kw = dict(self.engine_kw)
        kw.setdefault("flight", tracing.FlightRecorder())
        if tier is not None:
            kw["tier"] = tier
        with self._lock:
            self._tier_by_rid[rid] = tier
        engine = serving.DecodeEngine(self._replica_module(),
                                      replica_id=rid, **kw)
        try:
            server = serving.ModelServer(None, engine=engine,
                                         name=self.name, host=self.host,
                                         port=0)
            replica = Replica(server, self._resv_addr,
                              beat_interval=self.beat_interval)
            # tracked BEFORE start(): a replica that fails to start
            # must be reachable by the cleanup below, or its engine's
            # scheduler thread leaks
            self._track(replica)
        except BaseException:
            engine.stop()
            raise
        replica.start()
        return replica

    def _host_module(self):
        """The module's wire form (:func:`module_spec`), cached: the
        spawn spec rides a serialized task closure into the executor,
        and device tensors must not cross that wire."""
        if self._module_spec is None and self.model is not None:
            self._module_spec = module_spec(self.model)
        return self._module_spec

    def alive_executors(self):
        alive_fn = getattr(self.sc, "executors_alive", None)
        if alive_fn is None:
            return []
        eligible = list(alive_fn())
        if self.executors is not None:
            eligible = [e for e in eligible if e in self.executors]
        return eligible

    def replica_hosts(self):
        """{replica_id: executor_id} for executor-hosted replicas —
        the placement ledger scale-up consults."""
        with self._lock:
            return {r.replica_id: r.executor_id for r in self.replicas
                    if getattr(r, "remote", False)}

    def free_executor(self):
        """An alive, eligible executor hosting no replica — the
        evidence-gated "capacity exists" probe (None when the fleet is
        packed; scale-up must wait, as the regrow probe does)."""
        hosting = set(self.replica_hosts().values())
        for eid in self.alive_executors():
            if eid not in hosting:
                return eid
        return None

    def _dispatch_spawn(self, rid, eid, tier=None):
        """Ship one serving bootstrap task pinned to executor ``eid``
        (exclusion of every other alive executor is how the engine's
        one-task-per-executor dispatch is pointed at exactly one) and
        track the driver-side RemoteReplica handle."""
        from tensorflowonspark_tpu_torch import node as node_mod

        alive = self.alive_executors()
        if eid not in alive:
            raise RuntimeError(
                "executor {} is not alive/eligible (alive: {})".format(
                    eid, alive))
        engine_kw = dict(self.engine_kw)
        if tier is not None:
            engine_kw["tier"] = tier
        with self._lock:
            self._tier_by_rid[rid] = tier
        spec = {"replica_id": rid, "name": self.name,
                "reservation_addr": list(self._resv_addr),
                "beat_interval": self.beat_interval,
                "engine_kw": engine_kw,
                "module": self._host_module()}
        rdd = self.sc.parallelize([eid], 1)
        result = rdd.foreachPartitionAsync(
            node_mod.serve_replica(spec), one_task_per_executor=True,
            exclude=[e for e in alive if e != eid])
        replica = RemoteReplica(rid, self.reservation, executor_id=eid)
        replica.control_epoch = self.control_epoch
        with self._lock:
            self._spawns[rid] = result
            self.replicas.append(replica)
        return replica

    def _await_lease(self, rid, timeout, min_epoch=None):
        """Block until ``rid``'s serving lease is live and FRESH
        (and, for a replacement, carries an epoch newer than the fence
        minted against the corpse); surfaces the bootstrap task's own
        error if it failed instead."""
        deadline = time.monotonic() + float(timeout)
        fresh_age = max(3 * self.beat_interval, 1.0)
        result = self._spawns.get(rid)
        while time.monotonic() < deadline:
            if result is not None:
                err = result.first_error()
                if err is not None:
                    raise RuntimeError(
                        "serving bootstrap task for {} failed: "
                        "{}".format(rid, err[1]))
            info = self.reservation.serving_snapshot().get(rid)
            if info is not None and info.get("addr") \
                    and (info.get("age") or 1e9) < fresh_age \
                    and (min_epoch is None
                         or (info.get("epoch") or 0) > min_epoch):
                return info
            time.sleep(0.02)
        raise TimeoutError(
            "replica {}'s serving lease did not arrive within "
            "{}s".format(rid, timeout))

    # -- lifecycle ---------------------------------------------------------

    def start(self, form_timeout=None):
        if self._started:
            return self
        form_timeout = float(form_timeout) if form_timeout is not None \
            else (30.0 if self.placement == "driver"
                  else self.spawn_timeout)
        try:
            if self._own_reservation:
                self._resv_addr = self.reservation.start(host=self.host)
            else:
                self._resv_addr = self.reservation.addr
            # leadership fence: every admin RPC this driver
            # issues carries this epoch; a standby that takes over
            # mints a HIGHER one and the replicas refuse ours 409
            self.control_epoch = self.reservation.mint_control_epoch()
            plan = self._formation_tiers()
            if self.placement == "driver":
                for tier in plan:
                    self._spawn_local_replica(self._new_rid(),
                                              tier=tier)
            else:
                eligible = self.alive_executors()
                if len(eligible) < self.n_replicas:
                    raise RuntimeError(
                        "fleet needs {} executors but only {} are "
                        "alive/eligible".format(self.n_replicas,
                                                len(eligible)))
                for eid, tier in zip(eligible[:self.n_replicas], plan):
                    self._dispatch_spawn(self._new_rid(), eid,
                                         tier=tier)
            # formation barrier: every replica's lease must be live
            # before the router opens, or the first requests race the
            # first beats (spawn-task errors surface here too)
            deadline = time.monotonic() + form_timeout
            for replica in list(self.replicas):
                self._await_lease(
                    replica.replica_id,
                    max(deadline - time.monotonic(), 0.1))
            self.router = FleetRouter(self.reservation, name=self.name,
                                      host=self.host,
                                      replicas=self.replicas,
                                      **self.router_kw)
            self.router.start()
        except BaseException:
            # a failed formation must not strand what it already
            # started: the caller has no fleet reference yet, so N
            # engine scheduler threads, HTTP servers, beat threads,
            # and the owned reservation server would leak for the
            # process lifetime. stop() handles partial state.
            self.stop()
            raise
        self._started = True
        return self

    # -- elastic width (the autoscaler's verbs) ----------------------------

    def spawn_replica(self, replica_id=None, executor_id=None,
                      timeout=None, tier=None):
        """Grow the fleet by one replica (or respawn ``replica_id`` —
        a REPLACEMENT under the same identity). Executor placement
        picks a free executor (:meth:`free_executor`; raises
        :class:`NoCapacity` when none exists); a replacement first
        MINTS a fresh fencing epoch against the incumbent, so a
        partitioned-but-alive corpse can never serve stale after its
        replacement registers (lease fencing, applied at every
        (re)spawn). Blocks until the new replica's lease is live AND
        its /healthz answers 200 over the wire, then force-clears any
        corpse-era router health state for the id. Returns the replica
        handle."""
        if not self._started:
            raise RuntimeError("fleet is not started")
        timeout = float(timeout) if timeout is not None \
            else self.spawn_timeout
        replacing = replica_id is not None \
            and self._replica(replica_id) is not None
        rid = str(replica_id) if replica_id is not None \
            else self._new_rid()
        if tier is None:
            # a replacement (or tier-less respawn) inherits its
            # identity's recorded tier — repairing a prefill replica
            # as "mixed" would silently shrink the prefill tier
            tier = self._tier_by_rid.get(rid)
        min_epoch = None
        if self.placement == "driver":
            if replacing:
                raise NotImplementedError(
                    "driver-placement replicas are restarted in place "
                    "(Replica.respawn_engine), not replaced by respawn")
            replica = self._spawn_local_replica(rid, tier=tier)
        else:
            # the pick and the dispatch are ONE atomic placement
            # decision: free_executor() reads the hosting ledger, and
            # two concurrent spawns racing between the read and
            # _dispatch_spawn's track would both pick the same free
            # executor — the second bootstrap can never run there and
            # burns its whole spawn_timeout on a fleet with genuinely
            # free capacity elsewhere
            with self._lock:
                corpse = self._replica(rid) if replacing else None
                if corpse is not None:
                    # untrack the corpse BEFORE the pick: its own
                    # executor must count as free for its replacement
                    # (a revived executor is a valid — often the only
                    # — target; picking around it wedged a
                    # single-executor fleet in NoCapacity forever)
                    self._untrack(corpse)
                try:
                    eid = executor_id if executor_id is not None \
                        else self.free_executor()
                    if eid is None:
                        raise NoCapacity(
                            "no free executor to place replica {} on "
                            "(alive/eligible: {}, hosting: {})".format(
                                rid, self.alive_executors(),
                                self.replica_hosts()))
                    if replacing:
                        # fence the corpse BEFORE the replacement's
                        # first lease call: from this instant any beat
                        # the old holder still manages is answered
                        # FENCED. Minted only once capacity exists —
                        # a blocked replacement must not fence an
                        # incarnation nothing will supersede.
                        min_epoch = self.reservation.mint_epoch(rid)
                    replica = self._dispatch_spawn(rid, eid, tier=tier)
                except BaseException:
                    # the dead identity must STAY TRACKED on any
                    # pre-dispatch failure, or the autoscaler forgets
                    # it ever existed and REPLACE stops re-firing
                    # (the hardening contract)
                    if corpse is not None:
                        self._track(corpse)
                    raise
        try:
            info = self._await_lease(rid, timeout, min_epoch=min_epoch)
            if not FleetRouter._await_healthz(tuple(info["addr"]),
                                              min(timeout, 30.0)):
                raise RuntimeError(
                    "replica {} lease is live but /healthz never "
                    "answered 200".format(rid))
        except BaseException:
            # a FRESH spawn that failed is simply not part of the
            # fleet (the next breach re-fires scale-up); a failed
            # REPLACEMENT must keep its handle TRACKED — the identity
            # is still a fleet member below target, and untracking it
            # would make the autoscaler forget the dead replica ever
            # existed (no further REPLACE decisions, a min=1 fleet
            # stuck at zero forever)
            if not replacing:
                self._untrack(replica)
            raise
        if self.router is not None:
            # wire-verified above: clear every hold and any failure
            # escalation the DEAD incarnation earned (owner=None is
            # the force-clear) so the replacement is routable now, not
            # after the corpse's cooldown expires
            self.router.readmit(rid, owner=None)
        if min_epoch is not None:
            # the ship plane's half of the fence: every live
            # replica raises its floor against the DEAD incarnation's
            # epoch, so a KV shipment it packed before dying — still
            # in flight, or replayed by a partitioned-but-alive corpse
            # — can never splice into a pool the replacement is
            # already filling
            self._broadcast_ship_fence(rid, min_epoch)
        logger.info("replica %s %s (%s)", rid,
                    "replaced" if replacing else "spawned",
                    "executor {}".format(replica.executor_id)
                    if getattr(replica, "remote", False) else "driver")
        return replica

    def replace_replica(self, replica_id, timeout=None):
        """Respawn a DEAD executor-hosted replica under the SAME
        identity on whatever free executor exists — the autoscaler's
        repair verb (lease expired -> router down-marked -> this). The
        fencing mint inside :meth:`spawn_replica` guarantees the old
        incarnation can never serve again."""
        if self.placement != "executors":
            raise RuntimeError(
                "replace_replica is for executor-hosted fleets")
        return self.spawn_replica(replica_id=replica_id,
                                  timeout=timeout)

    def retire_replica(self, replica_id, drain_timeout=None):
        """Zero-loss scale-down of one replica: quiesce at the router
        (no new dispatches) -> ``drain_engine`` (every admitted
        request finishes — ``rolling_drain``'s zero-loss contract) ->
        stop the replica (remote: bounded /admin/stop RPC) -> mint a
        fencing epoch (a zombie whose stop RPC never landed latches
        itself on its next beat instead of serving stale) ->
        deregister the lease and forget router health state. Returns
        the clean-drain verdict."""
        replica = self._replica(replica_id)
        if replica is None:
            raise KeyError(
                "no replica {!r} in this fleet".format(replica_id))
        rid = replica.replica_id
        if self.router is not None:
            self.router.quiesce(rid, "retiring (scale-down)",
                                owner="autoscale")
            # a retired replica's cache leaves the fleet with it:
            # purge its affinity entries so no session is steered at
            # an identity that no longer serves
            self.router.affinity.purge_replica(rid)
        clean = False
        try:
            clean = replica.drain_engine(timeout=drain_timeout)
        except (RuntimeError, OSError,
                http.client.HTTPException) as e:
            logger.warning("retirement drain of replica %s failed "
                           "(%s); stopping anyway", rid, e)
        try:
            replica.stop()
        except Exception as e:  # noqa: BLE001 - teardown is best-effort
            logger.warning("retirement stop of replica %s failed: %s",
                           rid, e)
        fence_epoch = self.reservation.mint_epoch(rid)
        self._untrack(replica)
        self.reservation.drop_lease(rid)
        if self.router is not None:
            self.router.readmit(rid, owner="autoscale")
            self.router.health.forget(rid)
        # a retired prefill replica's in-flight shipments die with it:
        # fence its epoch fleet-wide so a zombie whose stop RPC never
        # landed cannot splice stale blocks into live decode pools
        self._broadcast_ship_fence(rid, fence_epoch)
        logger.info("replica %s retired (drain %s)", rid,
                    "clean" if clean else "UNCLEAN")
        return clean

    def _broadcast_ship_fence(self, rid, min_epoch):
        """Raise every live replica's KV-splice fence floor against
        shipments ``rid`` minted at or below ``min_epoch`` (POST
        /admin/ship_fence; the floor is monotonic and the RPC
        idempotent, so re-broadcasts are harmless). Best-effort BY
        DESIGN: a replica the broadcast misses still never serves
        wrong bytes — the splice path's resident-chain dedupe and
        block-table registration only ever ADD a prefix that decodes
        bitwise-identically; the fence exists to stop a dead
        incarnation's stale-cache shipments from wasting pool blocks
        and warming wrong prefixes."""
        body = json.dumps({"replica_id": str(rid),
                           "min_epoch": int(min_epoch)}).encode()
        headers = None
        if self.control_epoch is not None:
            headers = {"X-TFOS-Control-Epoch": str(self.control_epoch)}
        for other, info in sorted(
                self.reservation.serving_snapshot().items()):
            if other == str(rid) or not info.get("addr"):
                continue
            try:
                status, rbody, _ = _http_request(
                    tuple(info["addr"]), "POST", "/admin/ship_fence",
                    body=body, timeout=5.0, extra_headers=headers)
                if status != 200:
                    logger.warning(
                        "ship-fence broadcast to %s answered %s: %s",
                        other, status, rbody[:200])
            except (OSError, http.client.HTTPException) as e:
                logger.warning("ship-fence broadcast to %s failed: %s",
                               other, e)

    def _broadcast_control_fence(self, epoch):
        """Raise every live replica's CONTROL-epoch floor to ``epoch``
        (POST /admin/control_fence): from the moment a replica adopts
        it, any admin RPC stamped below — a deposed driver's late
        ship_fence/drain/stop — is refused 409. Monotonic and
        idempotent like the ship fence; best-effort per replica (a
        missed replica still fences the moment the new leader's first
        stamped admin RPC reaches it, since replicas adopt any
        higher stamp they see)."""
        body = json.dumps({"control_epoch": int(epoch)}).encode()
        headers = {"X-TFOS-Control-Epoch": str(int(epoch))}
        for other, info in sorted(
                self.reservation.serving_snapshot().items()):
            if not info.get("addr"):
                continue
            try:
                status, rbody, _ = _http_request(
                    tuple(info["addr"]), "POST", "/admin/control_fence",
                    body=body, timeout=5.0, extra_headers=headers)
                if status != 200:
                    logger.warning(
                        "control-fence broadcast to %s answered %s: %s",
                        other, status, rbody[:200])
            except (OSError, http.client.HTTPException) as e:
                logger.warning("control-fence broadcast to %s "
                               "failed: %s", other, e)

    def restart_reservation(self, recovery_grace=None):
        """Replace a dead reservation server with a journal-seeded
        restart on the SAME port (every replica's beat loop is
        retrying exactly that address) — the "driver comes back"
        half of control-plane survivability.

        The restarted server can never re-mint a stale epoch (its
        floors come from the journal), starts in a recovery grace
        window while journal-known identities re-announce (the
        supervisor/autoscaler hold dead-lease verdicts until it
        clears), and rebuilds its serving snapshot purely from the
        replicas' re-announced BEAT payloads — the replicas are the
        source of truth. The router keeps routing throughout: its
        snapshot reads simply go stale during the outage and warm
        back as beats land. Returns the new server."""
        old = self.reservation
        old_addr = self._resv_addr
        if not old.done.is_set():
            old.stop()
        kw = {}
        if recovery_grace is not None:
            kw["recovery_grace"] = recovery_grace
        fresh = reservation.Server(0, journal=self.journal_path, **kw)
        self._resv_addr = fresh.start(
            host=self.host,
            port=old_addr[1] if old_addr else 0)
        self.reservation = fresh
        # rewire every reader of the old (dead) server object —
        # snapshot-based routing and admin addressing both follow
        # self.reservation, so the swap is one reference each
        if self.router is not None:
            self.router.reservation = fresh
        with self._lock:
            for replica in self.replicas:
                if getattr(replica, "remote", False):
                    replica.reservation = fresh
        # NOTE: control_epoch is NOT re-minted: the journal's control
        # floor already covers this driver's stamp, so existing admin
        # stamps stay valid (and without a journal, re-minting from a
        # cold floor could mint BELOW the replicas' adopted floors)
        logger.warning(
            "reservation server restarted on %s (journal %s, "
            "recovering=%s)", self._resv_addr,
            self.journal_path or "ABSENT",
            fresh.recovering())
        return fresh

    def autoscale(self, policy=None, **controller_kw):
        """Arm the SLO-driven autoscaler (``autoscale.py``): a
        driver-side control loop scaling this fleet between the policy's
        min/max_replicas from the SLO signals the replicas already
        beat. Returns the started controller (also stashed on
        ``self.autoscaler`` for stop())."""
        from tensorflowonspark_tpu_torch import autoscale as autoscale_mod

        if self.autoscaler is None:
            self.autoscaler = autoscale_mod.AutoscaleController(
                self, policy=policy, **controller_kw)
            self.autoscaler.start()
        return self.autoscaler

    @property
    def router_addr(self):
        return self.router.addr

    def url(self, path=""):
        host, port = self.router.addr
        return "http://{}:{}{}".format(host, port, path)

    def supervise(self, restart=None, config=None):
        """Arm the recovery loop: a Supervisor watching every
        in-process replica (dead scheduler -> router quiesced first ->
        RestartEngine respawn -> router readmit) and, for
        executor-hosted replicas, classifying their serving LEASES
        (expired lease / dead engine -> quiesce + attributed incident;
        the autoscaler owns the replacement, so no restart budget
        burns on an executor the driver cannot respawn in place).
        Returns the supervisor."""
        from tensorflowonspark_tpu_torch import supervisor as supervisor_mod

        if self.supervisor is None:
            self.supervisor = supervisor_mod.Supervisor(config=config)
            self.supervisor.watch_fleet(self, restart=restart)
            if any(getattr(r, "remote", False) for r in self.replicas):
                self.supervisor.watch_serving(self)
        return self.supervisor

    def rolling_drain(self, upgrade=None, drain_timeout=None,
                      healthz_timeout=30.0):
        return self.router.rolling_drain(
            upgrade=upgrade, drain_timeout=drain_timeout,
            healthz_timeout=healthz_timeout)

    def stop(self):
        if self.autoscaler is not None:
            self.autoscaler.stop()
            self.autoscaler = None
        if self.supervisor is not None:
            self.supervisor.stop()
            self.supervisor = None
        if self.router is not None:
            self.router.stop()
            self.router = None
        for replica in list(self.replicas):
            # RemoteReplica.stop is a bounded /admin/stop RPC and
            # swallows unreachable-executor failures — teardown must
            # not hang on (or leak) executor-hosted node processes
            try:
                replica.stop()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                logger.warning("stop of replica %s failed",
                               replica.replica_id, exc_info=True)
        # start() is re-callable (it re-forms the fleet): the stopped
        # corpses must not linger in the registry, or a restart would
        # route/drain/watch over duplicate replica_ids with dead
        # engines
        with self._lock:
            self.replicas = []
            self._spawns = {}
            self._tier_by_rid = {}
            # a re-start() names from replica-0 again (fresh
            # formation; identity reuse is safe — Client.lease mints
            # the NEXT epoch even against a shared reservation
            # server's history)
            self._next_idx = 0
        if self._own_reservation:
            self.reservation.stop()
            # a stopped Server cannot serve again (its done latch stays
            # set); give a potential re-start() a fresh one — seeded
            # from the same journal, so even a stop/start cycle keeps
            # the epoch floors it already minted
            self.reservation = reservation.Server(
                0, journal=self.journal_path)
        self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# -- router warm standby -------------------------------------------

class RouterStandby(object):
    """Warm-standby :class:`FleetRouter`: follows the fleet's state
    passively and takes over on leader death by minting a HIGHER
    control epoch, so the fleet keeps serving through a router crash
    and the deposed leader can never act again (its admin RPCs are
    stamped below the new floor — replicas refuse them 409).

    Detection discipline: only CONNECTION-LEVEL failures of the
    leader's /healthz count toward takeover. A 503 (no routable
    replica) is an alive-but-degraded leader — taking over would
    trade a degraded fleet for a split brain. ``confirm`` consecutive
    misses at ``probe_interval`` bound the detection window; the
    takeover itself is one control-epoch mint (journal-durable when
    the reservation server has one) + one router start, so the
    fleet-serves-again window is detection + milliseconds.

    While standing by, the watch loop also shadows the leader's
    soft state (per-tenant quota bucket levels) so the promoted
    router starts WARM: a tenant in debt cannot launder its backlog
    through the failover. The AffinityMap deliberately starts cold —
    affinity is a latency optimization the first post-takeover
    dispatches rebuild from live traffic, and inheriting stale
    session pins from a dead router's view risks hotspotting."""

    def __init__(self, fleet, probe_interval=0.25, confirm=3):
        self.fleet = fleet
        self.probe_interval = float(probe_interval)
        self.confirm = int(confirm)
        #: the promoted router (None until takeover); also installed
        #: as ``fleet.router`` so every fleet verb follows leadership
        self.router = None
        self.took_over = threading.Event()
        #: control epoch this standby minted at takeover (None before)
        self.control_epoch = None
        self.counters = tracing.Counters()
        self._quota_state = {}
        self._misses = 0
        self._stop = threading.Event()
        self._thread = None
        #: serializes promotion: the watch thread and a direct
        #: take_over() call must not both promote
        self._lock = threading.Lock()

    def start(self):
        self._thread = threading.Thread(
            target=self._watch_loop, daemon=True,
            name="tfos-router-standby")
        self._thread.start()
        return self

    def _leader_alive(self):
        """True while the leader ANSWERS — any HTTP status counts
        (503 = degraded, not dead). Only a connection-level failure
        (listener gone, reset, timeout) is evidence of death."""
        router = self.fleet.router
        if router is None or router._httpd is None:
            return False
        try:
            _http_request(router.addr, "GET", "/healthz",
                          timeout=2.0, connect_timeout=1.0,
                          net_src="standby", net_dst="router")
            return True
        except (OSError, http.client.HTTPException):
            return False

    def _watch_loop(self):
        while not self._stop.is_set():
            if self._leader_alive():
                self._misses = 0
                router = self.fleet.router
                if router is not None:
                    # shadow the leader's quota view (thread-safe
                    # snapshot) so takeover restores it warm
                    self._quota_state = router._quota.snapshot()
            else:
                self._misses += 1
                if self._misses >= self.confirm:
                    try:
                        self.take_over()
                    except Exception:  # noqa: BLE001
                        logger.exception(
                            "standby takeover failed; re-confirming "
                            "leader death")
                        self._misses = 0
                        self._stop.wait(self.probe_interval)
                        continue
                    return
            self._stop.wait(self.probe_interval)

    def take_over(self):
        """Promote this standby NOW: mint a higher control epoch,
        start a fresh router over the same reservation state, restore
        the shadowed quota levels, install it as the fleet's router,
        and fence the deposed leader fleet-wide. Idempotent-ish: a
        second call is refused once promotion completed."""
        with self._lock:
            return self._take_over_locked()

    def _take_over_locked(self):
        if self.took_over.is_set():
            raise RuntimeError("standby already took over")
        fleet = self.fleet
        epoch = fleet.reservation.mint_control_epoch()
        old = fleet.router
        if old is not None:
            # make the deposition physical, not just logical: even a
            # wedged-but-listening old router must stop serving before
            # the standby opens (the no-request-served-by-both pin)
            try:
                old.crash()
            except Exception:  # noqa: BLE001
                pass
        router = FleetRouter(fleet.reservation, name=fleet.name,
                             host=fleet.host, replicas=fleet.replicas,
                             **fleet.router_kw)
        # the replacement router's AffinityMap deliberately starts
        # cold; label the reset start() records so the scrape explains
        # the warm-hit dip as a TAKEOVER, not a mere restart
        router._affinity_reset_reason = "takeover"
        router.start()
        router._quota.restore(self._quota_state)
        router.metrics.add_counters("tfos_control", self.counters)
        fleet.router = router
        fleet.control_epoch = epoch
        with fleet._lock:
            for replica in fleet.replicas:
                if getattr(replica, "remote", False):
                    replica.control_epoch = epoch
        fleet._broadcast_control_fence(epoch)
        self.router = router
        self.control_epoch = epoch
        self.counters.inc("takeovers")
        self.counters.gauge("epoch", epoch)
        self.took_over.set()
        logger.warning(
            "standby TOOK OVER as router for %r on %s:%d (control "
            "epoch %d; deposed leader's admin writes now refuse 409)",
            fleet.name, router.addr[0], router.addr[1], epoch)
        return router

    def stop(self):
        """Stop WATCHING. The promoted router (if any) now belongs to
        the fleet — fleet.stop() owns its teardown."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
