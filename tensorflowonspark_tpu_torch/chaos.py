"""Deterministic fault-injection harness for the supervision plane —
the port's copy of ``tensorflowonspark_tpu/chaos.py`` (same spec
grammar, same ``TFOS_CHAOS`` variable, same seeded plans).

The port's sites are the feed plane's (``DataFeed``'s ``on_batch``,
the heartbeat publishers' ``on_heartbeat``), the reservation
server's (``on_reservation_beat``, and ``on_net`` around every
reservation message), the checkpointer's (``on_checkpoint_saved``,
with the corruption helpers it calls) and the decode engine's serving
sites (``on_decode_step``, ``on_serving_request``, ``on_token``). Left
for later slices, with the sites that fire them: the step and router
points (``kill_trainer_at_step``, ``drop_executor_then_return_after``,
``kill_router_at_request``, ``restart_reservation_after``; ROADMAP
Queue 1 items 9-11) and the driver-side choreography helpers
(``schedule_executor_return``, ``kill_when``); the port's parser refuses
those points instead of arming a site that never fires.

Fault-injection suites need failures that land at an exact, repeatable
moment — "SIGKILL the trainer right after step 3", not "sleep 0.5s and
hope". This module owns that choreography so the kill logic lives in ONE
place with instrumented sites in the framework itself, instead of being
re-derived per test (a source of load-dependent flakiness).

Arming. Injections are armed by a spec string, either explicitly
(:func:`arm`) or via the ``TFOS_CHAOS`` env var — the env path is how a
driver arms the *trainer* process: the spec rides ``executor_env`` into
the executor and fork/spawn inherits it. Spec grammar::

    point=value[,only=EID][,fuse=PATH][;point2=...]

- ``only=EID`` restricts the injection to the process whose
  ``TFOS_TRAINER_EXECUTOR_ID`` matches (set by node.py's trainer entry)
  — how a 2-executor blacklist test kills executor 1's trainer only.
  Non-numeric values scope by the SITE's caller-supplied identity
  instead.
- ``fuse=PATH`` makes the injection single-shot ACROSS process
  incarnations: firing creates the fuse file (content: wall-clock fire
  time), and an existing fuse disarms. A restarted trainer inherits the
  same env, so without a fuse a kill-at-step-N injection would fire
  again on every recovery attempt — fuses are what make
  "kill once, then recover" expressible.

Injection points (each checked at an instrumented framework site):

- ``kill_trainer_at_batch=N`` — SIGKILL when DataFeed has served N
  non-empty batches (fired by ``DataFeed.next_batch``).
- ``kill_trainer_when_queued=1`` — SIGKILL on the first batch served
  while this trainer holds an UNCONSUMED EndPartition marker (the
  value is grammar-required but unused): the marker rides the feeder's
  final put, so holding it proves the feeder finished writing and is
  parked in its queue join on the owed task_done — the kill provably
  lands in the join-park window, never mid-write. Queue transport
  only; needs batch_size < the final chunk's record count (a batch
  that consumes the marker in-call settles the join before the hook
  runs, no kill fires, and the caller's positive assertion fails
  loudly instead of flaking).
- ``stall_consumer_for=T`` (alias ``stall_ring_slot``) — the consumer
  sleeps T seconds once, holding whatever ring slots its pending
  segments pin: the producer wedges on ring space and the feed progress
  counter freezes while the trainer stays alive — the ring-wedge
  signature the supervisor classifies.
- ``drop_heartbeats_for=T`` — suppress heartbeat publishing (DataFeed's
  feed_hb AND node.py's reservation beats) for T seconds from the first
  suppressed attempt: lets tests drive executor-lost detection without
  killing anything.
- ``kill_reservation_server=N`` — the reservation server crashes in
  place at its N-th BEAT (:func:`on_reservation_beat`).
- ``corrupt_checkpoint=N`` — after ``Checkpointer.save`` commits step N,
  garble every file of that step on disk (fired by checkpoint.py); the
  restore-with-fallback path is the recovery under test.
Network fault plane (fired at the transport site
``reservation.MessageSocket.send`` wraps around every reservation
message, via :func:`on_net`; the reference also fires it around the
fleet router's HTTP exchanges). Process faults kill things; these break
the WIRES between healthy processes, which is where ambiguous timeouts
— "did the request execute before the response was lost?" — come from.
Endpoint scoping uses ``SRC:DST`` pairs (either side ``*``): the router
dispatches as ``router:<replica_id>``, a replica/executor beats as
``<id>:reservation``. Sites that pass no identity at all match only
fully-wildcarded (``*:*`` / unscoped) injections.

- ``net_drop=P[,only=SRC:DST][,seed=N][,for=T]`` — each matching
  exchange independently fails with probability P (a seeded
  ``random.Random(seed)`` draw — the k-th matching exchange consumes
  the k-th draw, so a given seed yields the same drop schedule every
  run; ``P=1`` is the deterministic always-drop). The failure is
  :class:`NetPartitioned` (a ``ConnectionError``): the caller cannot
  tell whether the peer saw the request — exactly the ambiguity
  idempotent dispatch exists for.
- ``net_delay=T[,only=SRC:DST][,for=W]`` — every matching exchange is
  delayed T seconds before it starts: the gray-replica signature
  (alive, beating, SLOW) hedged requests exist for.
- ``net_dup=P[,only=SRC:DST][,seed=N][,for=T]`` — each matching
  exchange is DUPLICATED with seeded probability P: the transport
  delivers the same request twice (the duplicate's response is
  discarded). The replica-side dedup window is the behavior under
  test — without it a duplicated ``:generate`` decodes twice. HTTP
  transport only: ``MessageSocket`` is a framed request/response TCP
  stream, where the transport cannot duplicate a frame (and injecting
  one would desynchronize the protocol, not model a network fault) —
  that site ignores the dup action.
- ``net_partition=SRC:DST,for=T`` — from the first matched exchange,
  the SRC->DST link is DOWN for T seconds (every matching exchange
  raises :class:`NetPartitioned`); after T the partition HEALS and the
  injection is spent — re-arm for another flap. ``for=`` is mandatory:
  a partition that never heals is just a drop, and the heal is the
  moment split-brain fencing and retry dedup get tested. The OPENING
  exchange (in flight when the link died) loses only its RESPONSE on
  transports that can tell the difference — the request was delivered
  and executed, the caller just never learns it (see :func:`on_net`).
Serving-plane points (fired at ``serving.DecodeEngine``'s
instrumented sites, so the request-lifecycle story is deterministically
testable):

- ``kill_scheduler_at_step=N`` — raise :class:`SchedulerKilled` inside
  the decode scheduler loop once N decode steps completed: the thread
  dies exactly as an uncaught device error would kill it, outstanding
  handles fail retriable, and ``DecodeEngine.respawn`` is the recovery
  under test.
- ``stall_decode_for=T`` — the scheduler sleeps T seconds once at a
  step boundary: in-flight deadlines expire while the engine stays
  alive — the slow-replica signature deadline eviction exists for.
- ``disconnect_client_at_token=N`` — the first request to reach N
  emitted tokens is cancelled as if its client disconnected
  mid-stream; the step-boundary slot-free path is the behavior under
  test.
- ``kill_serving_executor_at_request=K,only=<replica_id>,fuse=PATH`` —
  whole-EXECUTOR loss on the serving plane: once the scoped replica's
  engine has seen K requests submitted, SIGKILL the executor process
  hosting it. It refuses to fire outside an executor-hosted serving
  node (``TFOS_SERVING_EXECUTOR_ID`` unset), and ``fuse`` is mandatory.

Every fire is logged loudly. All checks are O(1) dict lookups when
nothing is armed, so instrumented sites cost nothing in production.
"""

import logging
import os
import random
import signal
import threading
import time

logger = logging.getLogger(__name__)

ENV_VAR = "TFOS_CHAOS"

#: transport-level points (the network fault plane)
NET_POINTS = ("net_drop", "net_delay", "net_dup", "net_partition")

#: spec keys that accept the generic grammar above
POINTS = ("kill_trainer_at_batch", "kill_trainer_when_queued",
          "stall_consumer_for", "stall_ring_slot", "drop_heartbeats_for",
          "kill_reservation_server", "corrupt_checkpoint",
          "kill_scheduler_at_step", "stall_decode_for",
          "disconnect_client_at_token",
          "kill_serving_executor_at_request") + NET_POINTS


class SchedulerKilled(RuntimeError):
    """kill_scheduler_at_step fired: the decode scheduler thread dies
    by raising this (the thread-level analog of SIGKILL — threads
    cannot be signalled, and any uncaught raise kills the loop the
    same way a real device error does)."""


class NetPartitioned(ConnectionError):
    """A net_drop / net_partition injection ate this transport
    exchange. Deliberately a ``ConnectionError``: every caller's
    existing connection-failure handling (beat retry, router failover,
    lease expiry) must treat an injected network fault EXACTLY like a
    real one — no chaos-aware special cases to go stale in."""


class Injection(object):
    """One armed injection point."""

    __slots__ = ("point", "value", "only", "fuse", "fired", "started",
                 "window", "seed", "endpoints", "_rng")

    def __init__(self, point, value, only=None, fuse=None, window=None,
                 seed=None, endpoints=None):
        self.point = point
        self.value = value
        self.only = only
        self.fuse = fuse
        self.fired = False
        self.started = None  # for duration-window points
        #: ``for=T`` — seconds the effect lasts from its first matched
        #: check; None = no window (single-shot points keep their own
        #: semantics, net drop/delay/dup apply until disarm)
        self.window = window
        #: ``seed=N`` — the probability schedule's RNG seed (net_drop /
        #: net_dup); a fixed seed makes the k-th matching exchange's
        #: draw identical across runs
        self.seed = seed
        #: (src, dst) endpoint pattern for net points (either may be
        #: ``"*"``); None matches every instrumented site
        self.endpoints = endpoints
        self._rng = None

    @property
    def rng(self):
        """Seeded per-injection RNG (lazily built): the deterministic
        draw schedule behind probabilistic net points."""
        if self._rng is None:
            self._rng = random.Random(0 if self.seed is None
                                      else self.seed)
        return self._rng

    def matches_net(self, src, dst):
        """Endpoint scoping for transport sites: ``only=SRC:DST`` (or
        net_partition's value) against the site's identities. A site
        that passes None for a side only matches ``*`` on that side —
        an unlabeled transport can never be caught by a scoped spec."""
        if self.endpoints is None:
            return True
        esrc, edst = self.endpoints
        src_ok = esrc == "*" or (src is not None and str(src) == esrc)
        dst_ok = edst == "*" or (dst is not None and str(dst) == edst)
        return src_ok and dst_ok

    def in_window(self):
        """True while inside the ``[first match, +for)`` effect window
        (no ``for=`` means always, once matched). The window opens at
        the FIRST matched check and the injection is marked spent at
        expiry — how ``net_partition`` heals deterministically."""
        if self.window is None:
            return True
        now = time.monotonic()
        if self.started is None:
            self.started = now
            logger.warning("CHAOS %s window open for %gs", self.point,
                           self.window)
        if now - self.started < self.window:
            return True
        if not self.fired:
            self.mark_fired()
            logger.warning("CHAOS %s window expired (healed)", self.point)
        return False

    def ready(self, ident=None):
        """Armed, not yet fired, fuse intact, and scoped to this process
        (or, for multi-replica sites sharing one process, to the
        caller-supplied ``ident`` — how a fleet test kills ONE replica's
        scheduler when every replica's engine runs in the same
        process)."""
        if self.fired:
            return False
        if self.fuse and os.path.exists(self.fuse):
            return False
        if self.only is not None:
            if ident is not None and str(ident) == str(self.only):
                return True
            eid = os.environ.get("TFOS_TRAINER_EXECUTOR_ID")
            try:
                return eid is not None and int(eid) == int(self.only)
            except (TypeError, ValueError):
                return False
        return True

    def mark_fired(self):
        self.fired = True
        if self.fuse:
            try:
                with open(self.fuse, "x") as f:
                    f.write(repr(time.time()))
            except FileExistsError:
                pass


_lock = threading.Lock()
_explicit = None   # spec armed via arm(); wins over the env
_parsed_for = object()  # spec string the cache below was parsed from
_injections = {}


def parse_spec(spec):
    """Spec string -> {point: Injection}; raises ValueError on bad specs
    (a typo'd chaos spec must fail the test loudly, not silently not
    inject)."""
    out = {}
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        fields = entry.split(",")
        if "=" not in fields[0]:
            raise ValueError("chaos entry %r needs point=value" % entry)
        point, value = fields[0].split("=", 1)
        point = point.strip()
        if point not in POINTS:
            raise ValueError("unknown chaos point %r (known: %s)"
                             % (point, ", ".join(POINTS)))
        if point == "stall_ring_slot":  # alias
            point = "stall_consumer_for"
        only = fuse = window = seed = endpoints = None
        for field in fields[1:]:
            if "=" not in field:
                raise ValueError("chaos field %r needs key=value" % field)
            k, v = field.split("=", 1)
            k = k.strip()
            if k == "only":
                if point in NET_POINTS:
                    # net scoping is an endpoint pair, not a process id
                    endpoints = _parse_endpoints(point, v)
                    continue
                # numeric executor ids stay ints (the TFOS_TRAINER_
                # EXECUTOR_ID scoping); anything else is a replica
                # ident matched against the site's caller-supplied id
                try:
                    only = int(v)
                except ValueError:
                    only = v.strip()
            elif k == "fuse":
                fuse = v
            elif k == "for":
                try:
                    window = float(v)
                except ValueError:
                    raise ValueError(
                        "chaos field for=%r must be seconds" % v)
            elif k == "seed":
                try:
                    seed = int(v)
                except ValueError:
                    raise ValueError(
                        "chaos field seed=%r must be an integer" % v)
            else:
                raise ValueError("unknown chaos field %r" % k)
        if point == "net_partition":
            # the VALUE is the partitioned link (src:dst); for= is the
            # outage duration and is mandatory — a partition that never
            # heals is just net_drop, and the HEAL is the moment the
            # fencing/dedup behavior under test actually runs
            endpoints = _parse_endpoints(point, value)
            if window is None:
                raise ValueError(
                    "net_partition requires for=T (the heal time); "
                    "use net_drop for a permanent fault")
            value = "0"
        if point in NET_POINTS:
            out[point] = Injection(point, float(value), only=only,
                                   fuse=fuse, window=window, seed=seed,
                                   endpoints=endpoints)
            continue
        if window is not None or seed is not None:
            raise ValueError(
                "chaos fields for=/seed= only apply to net points "
                "({}), not {}".format(", ".join(NET_POINTS), point))
        if point == "kill_serving_executor_at_request" and not fuse:
            # the spec rides executor_env into EVERY executor
            # incarnation, and a replacement replica keeps the victim's
            # replica_id — without a fuse it re-fires at the same
            # request count forever
            raise ValueError(
                "kill_serving_executor_at_request requires fuse=PATH "
                "(the kill must be single-shot across executor "
                "incarnations — the replacement replica inherits both "
                "the armed spec and the victim's replica_id)")
        out[point] = Injection(point, float(value), only=only, fuse=fuse)
    return out


def _parse_endpoints(point, raw):
    """``SRC:DST`` -> (src, dst); either side may be ``*``."""
    parts = str(raw).strip().split(":")
    if len(parts) != 2 or not parts[0] or not parts[1]:
        raise ValueError(
            "{} endpoints must be SRC:DST (either side may be '*'), "
            "got {!r}".format(point, raw))
    return parts[0], parts[1]


def arm(spec):
    """Arm this process explicitly (tests); overrides the env spec."""
    global _explicit, _parsed_for
    with _lock:
        _explicit = spec
        _parsed_for = object()  # invalidate cache


def disarm():
    """Drop the explicit spec and any fired-state; the process follows
    the ``TFOS_CHAOS`` env var again (unset it too for a clean slate —
    the test fixture does)."""
    global _explicit, _parsed_for
    with _lock:
        _explicit = None
        _parsed_for = object()


def _current():
    """{point: Injection} for the active spec, cached per spec value."""
    global _parsed_for, _injections
    spec = _explicit if _explicit is not None else os.environ.get(ENV_VAR)
    with _lock:
        if spec != _parsed_for:
            _injections = parse_spec(spec) if spec else {}
            _parsed_for = spec
        return _injections


def armed(point, ident=None):
    """The ready :class:`Injection` for ``point``, else None.
    ``ident`` scopes multi-replica sites: an ``only=<ident>`` injection
    fires only when the calling site passes a matching identity."""
    if point == "stall_ring_slot":
        point = "stall_consumer_for"
    inj = _current().get(point)
    return inj if inj is not None and inj.ready(ident) else None


def _kill_self(inj, why):
    logger.error("CHAOS firing %s (%s): SIGKILL pid %d",
                 inj.point, why, os.getpid())
    inj.mark_fired()
    os.kill(os.getpid(), signal.SIGKILL)


# -- instrumented-site hooks ----------------------------------------------

def on_batch(feed, batches_served):
    """DataFeed site, after each non-empty batch is assembled."""
    inj = armed("kill_trainer_at_batch")
    if inj is not None and batches_served >= inj.value:
        _kill_self(inj, "batch %d >= %g" % (batches_served, inj.value))
    inj = armed("kill_trainer_when_queued")
    if inj is not None:
        if getattr(feed, "_queue_in", None) is None:
            raise RuntimeError(
                "kill_trainer_when_queued needs the queue transport "
                "(the ring has no join to park in)")

        # The ONE provable "feeder finished writing, its join is
        # blocked on this trainer" event: this trainer holds the
        # partition's EndPartition marker UNCONSUMED (in the decode
        # backlog). The marker always rides the feeder's final put
        # (tail coalescing frames it with the last chunk), so holding
        # it proves every put of the partition completed — the kill
        # cannot land mid-write — and its pending task_done proves the
        # feeder's join is still blocked. Queue depth proves neither:
        # queued items can be mid-partition chunks with the feeder
        # still writing behind them (the mid-put race this harness
        # exists to eliminate). Checked per batch, NOT polled: the
        # backlog only advances when this consumer consumes, so on a
        # multi-chunk partition the marker arrives on a later
        # next_batch call. Needs batch_size < the final chunk's record
        # count (otherwise the same call consumes the marker and fires
        # its task_done before this hook runs — no kill ever fires,
        # and the caller's positive assertion fails loudly).
        from tensorflowonspark_tpu_torch import marker as marker_mod
        if any(isinstance(item, marker_mod.Marker)
               for item in feed._backlog):
            _kill_self(inj, "holding an unconsumed EndPartition marker "
                            "(feeder parked in its join)")
    inj = armed("stall_consumer_for")
    if inj is not None:
        inj.mark_fired()
        logger.warning("CHAOS stalling consumer for %gs "
                       "(ring slots stay pinned)", inj.value)
        time.sleep(inj.value)


def on_decode_step(steps_done, ident=None):
    """Decode-scheduler site (serving.DecodeEngine._loop), called at
    each step boundary with the number of COMPLETED decode steps.
    ``stall_decode_for`` sleeps here (once); ``kill_scheduler_at_step``
    raises :class:`SchedulerKilled` once ``steps_done`` reaches N.
    ``ident`` is the engine's replica id: an ``only=<replica_id>``
    injection targets ONE engine of several in one process."""
    inj = armed("stall_decode_for", ident)
    if inj is not None:
        inj.mark_fired()
        logger.warning("CHAOS stalling decode scheduler for %gs",
                       inj.value)
        time.sleep(inj.value)
    inj = armed("kill_scheduler_at_step", ident)
    if inj is not None and steps_done >= inj.value:
        inj.mark_fired()
        logger.error("CHAOS firing kill_scheduler_at_step "
                     "(step %d >= %g, replica %s): killing the decode "
                     "scheduler", steps_done, inj.value, ident)
        raise SchedulerKilled(
            "chaos: decode scheduler killed at step {}".format(steps_done))


def on_serving_request(requests_seen, ident=None):
    """Serving-admission site (serving.DecodeEngine._submit_many),
    called with the cumulative number of requests this engine has seen
    submitted. ``kill_serving_executor_at_request=K,only=<replica_id>``
    SIGKILLs the WHOLE executor process hosting the replica once the
    K-th request arrives. Refuses outside an executor-hosted serving
    node: the process about to die must actually BE an executor (the
    hosting node sets ``TFOS_SERVING_EXECUTOR_ID``), not a test process
    that merely armed the spec."""
    inj = armed("kill_serving_executor_at_request", ident)
    if inj is None or requests_seen < inj.value:
        return
    if os.environ.get("TFOS_SERVING_EXECUTOR_ID") is None:
        raise RuntimeError(
            "kill_serving_executor_at_request can only fire inside an "
            "executor-hosted serving node (the hosting node sets "
            "TFOS_SERVING_EXECUTOR_ID); this process is not one — "
            "scope the injection with only=<replica_id> or arm it via "
            "executor_env")
    _kill_self(inj, "serving request %d >= %g on replica %s"
               % (requests_seen, inj.value, ident))


def on_token(tokens_emitted):
    """Token-delivery site (serving.DecodeEngine._deliver); True means
    'this request's client just disconnected' — the engine cancels the
    request and the step-boundary eviction frees its slot. Fires once,
    on the first request to reach N emitted tokens."""
    inj = armed("disconnect_client_at_token")
    if inj is None or tokens_emitted < inj.value:
        return False
    inj.mark_fired()
    logger.warning("CHAOS disconnect_client_at_token: simulating client "
                   "disconnect after %d tokens", tokens_emitted)
    return True


def on_reservation_beat(beats_seen):
    """Reservation-server BEAT site (reservation.Server._handle),
    called with the cumulative BEAT messages this server has handled.
    ``kill_reservation_server=N`` returns True once the N-th beat
    lands; the server then CRASHES in place (``Server.crash()`` — the
    in-process SIGKILL emulation: lease-table state already written,
    the reply never sent). Single-shot: the in-process
    ``fired`` latch survives the server's restart (same process), so
    the restarted server is never re-killed at the same beat count."""
    inj = armed("kill_reservation_server")
    if inj is None or beats_seen < inj.value:
        return False
    inj.mark_fired()
    logger.error("CHAOS kill_reservation_server: crashing the "
                 "reservation server at BEAT %d >= %g",
                 beats_seen, inj.value)
    return True


def on_heartbeat():
    """Heartbeat-publish sites; True = suppress this publish.

    The suppression window is [first suppressed attempt, +T seconds);
    after it expires the injection is spent and heartbeats resume.
    """
    inj = armed("drop_heartbeats_for")
    if inj is None:
        return False
    if inj.started is None:
        inj.started = time.monotonic()
        logger.warning("CHAOS dropping heartbeats for %gs", inj.value)
    if time.monotonic() - inj.started < inj.value:
        return True
    inj.mark_fired()
    return False


def on_net(src=None, dst=None, response_capable=False):
    """Transport-exchange site (the network fault plane). Called once
    per exchange by the instrumented transports — ``fleet.
    _http_request`` (router<->replica HTTP) and ``reservation.
    MessageSocket.send`` (reservation messages, beats included) — with
    the exchange's endpoint identities.

    Effects, in precedence order: an ACTIVE ``net_partition`` window or
    a ``net_drop`` draw loses the exchange; ``net_delay`` sleeps before
    the exchange runs; ``net_dup`` returns ``"dup"``, telling the
    transport to deliver the exchange TWICE (the caller discards the
    duplicate's response). Returns None when nothing fires. O(1) dict
    lookups when no net point is armed.

    A LOST exchange has two faces, and the difference is the whole
    point of idempotent dispatch: request-side loss (the peer never saw
    it) raises :class:`NetPartitioned` before any bytes move;
    response-side loss — the peer EXECUTED the request, only the answer
    died on the wire — returns ``"drop_response"``, telling a
    ``response_capable`` transport to run the exchange, discard the
    response, and raise. Sites that can't separate the two (a one-way
    message send) pass ``response_capable=False`` and get request-side
    loss only. Deterministic choreography: a ``net_partition``'s
    OPENING exchange is response-side (it was in flight when the link
    died — the classic ambiguous timeout), the rest of the window is
    request-side (the link is known down); ``net_drop`` draws the side
    from the same seeded RNG as the drop itself (50/50), so a fixed
    seed fixes the whole schedule."""
    cur = _current()
    inj = cur.get("net_partition")
    if inj is not None and not inj.fired and inj.matches_net(src, dst):
        opening = inj.started is None
        if inj.in_window():
            if opening and response_capable:
                logger.warning(
                    "CHAOS net_partition: %s -> %s opening exchange "
                    "loses its RESPONSE (request delivered)", src, dst)
                return "drop_response"
            raise NetPartitioned(
                "chaos net_partition: {} -> {} is partitioned".format(
                    src, dst))
    inj = cur.get("net_drop")
    if inj is not None and not inj.fired and inj.matches_net(src, dst) \
            and inj.in_window() and inj.rng.random() < inj.value:
        if response_capable and inj.rng.random() < 0.5:
            logger.warning("CHAOS net_drop: %s -> %s loses its "
                           "RESPONSE (request delivered)", src, dst)
            return "drop_response"
        logger.warning("CHAOS net_drop: dropping %s -> %s exchange",
                       src, dst)
        raise NetPartitioned(
            "chaos net_drop: {} -> {} exchange lost".format(src, dst))
    inj = cur.get("net_delay")
    if inj is not None and not inj.fired and inj.matches_net(src, dst) \
            and inj.in_window():
        time.sleep(inj.value)
    inj = cur.get("net_dup")
    if inj is not None and not inj.fired and inj.matches_net(src, dst) \
            and inj.in_window() and inj.rng.random() < inj.value:
        logger.warning("CHAOS net_dup: duplicating %s -> %s exchange",
                       src, dst)
        return "dup"
    return None


def net_armed():
    """True when any net point is armed (transports use this to skip
    per-exchange bookkeeping entirely in production)."""
    cur = _current()
    return any(p in cur for p in NET_POINTS)


def on_checkpoint_saved(step, directory, wait=None):
    """Checkpointer site, after a successful save of ``step``."""
    inj = armed("corrupt_checkpoint")
    if inj is None or int(step) != int(inj.value):
        return
    if wait is not None:
        wait()  # an asynchronous commit must land before we garble it
    inj.mark_fired()
    corrupt_step(directory, int(step))


def corrupt_step(directory, step):
    """Garble every regular file of checkpoint ``step`` in place
    (overwrite leading bytes + truncate): a restore of this step must
    fail, which is exactly what the fallback-restore path recovers
    from. Returns the number of files corrupted."""
    step_dir = os.path.join(directory, str(step))
    count = 0
    for root, _dirs, files in os.walk(step_dir):
        for name in files:
            path = os.path.join(root, name)
            try:
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    f.write(b"\xde\xad\xbe\xef" * 4)
                    f.truncate(max(16, size // 2))
                count += 1
            except OSError:
                continue
    logger.warning("CHAOS corrupted checkpoint step %s under %s "
                   "(%d files)", step, directory, count)
    return count

