"""Continuous-batching decode serving — the port of the
``DecodeEngine`` and the ``:generate`` / ``:prefill`` / ``/kv/splice``
surface of ``tensorflowonspark_tpu/serving.py``.

:class:`DecodeEngine` owns a paged KV cache (one block pool per layer,
shared by ``slots`` rows through per-slot block tables) and a scheduler
thread. Requests enter freed slots at decode-step boundaries, prefill
only the tail their resident shared prefix does not cover, grow block
by block as they decode, and leave individually on EOS or length;
under pool exhaustion the youngest admission is preempted and re-enters
later with a continuation prefill. Attention runs through
``ops.paged_attention``: the hand-written CUDA kernel on the card
(``attn_impl="fused"``), or the materialized-view oracle
(``attn_impl="gather"``). ``kv_block_size=0`` selects the contiguous
per-slot cache instead (no pool: two einsums over ``[slots, L]``).

``speculate_k`` (>= 2, paged only) turns each step into a speculative
round: a weight-tied draft of the first ``draft_layers`` blocks
proposes ``k`` tokens with ``k`` one-token steps into its own pool (at
the target's table rows and cursors), the target scores the window in
one ``k``-query apply, and the longest run of draft tokens equal to the
target's own picks is emitted, with the target's correction after it:
at temperature 0 exactly the plain engine's tokens.

Disaggregation: an engine's ``tier`` ("prefill", "decode" or "mixed")
rides ``load_stats``; :meth:`DecodeEngine.export_prefix` packs a
prompt's resident block chain (pool rows as stored, int8 codes with
their scales) and :meth:`DecodeEngine.import_prefix` splices one into
another engine's pool, both on the scheduler thread.

:class:`ModelServer` takes the reference's signature, ``(model_dir,
name="model", host="127.0.0.1", port=8501, batch_window_ms=0,
engine=None)``: an export (``export.load_model``, on the card unless
``device="cpu"`` is asked for) behind the TF-Serving REST routes, a
decode engine behind ``:generate``, or both::

    GET  /v1/models/<name>             -> model status
    GET  /v1/models/<name>/metadata    -> signature metadata
    POST /v1/models/<name>:predict     {"instances": [...]} row format
                                       or {"inputs": {...}} columnar
    POST /v1/models/<name>:generate    {"prompt": [...] or [[...], ...],
                                        "max_new_tokens": N}
                                    -> {"tokens": [...] or [[...], ...]}
    POST /v1/models/<name>:prefill     {"prompt": [...], "ship"?: {"addr":
                                        "host:port", "replica_id"?}}
                                    -> {"prefilled", "blocks", "shipped",
                                        "bytes"?, "transport"?, "reason"?}
    POST /kv/splice                    a packed shipment (octet-stream), or
                                       an empty body with
                                       ``X-TFOS-KV-Via: shm``
    POST /admin/<name>                 registered lifecycle RPCs:
                                       ship_fence {"replica_id",
                                       "min_epoch"}, control_fence
                                       {"control_epoch"}, and whatever
                                       :meth:`ModelServer.register_admin`
                                       mounts (404 for the rest)
    GET  /healthz                      liveness, gauges, dedup window
    GET  /metrics                      OpenMetrics exposition of the
                                       engine's ``MetricsRegistry``
    GET  /debug/trace                  the flight recorder as Chrome
                                       trace JSON (``X-TFOS-Trace-Dropped``)

``:predict`` runs the export's ``apply_fn`` under
``torch.inference_mode()``, one request at a time, or, with
``batch_window_ms > 0``, through :class:`_Batcher`, which merges
concurrent requests of one input signature into one apply call.

The serving planes sit between the HTTP surface and the scheduler:

- QoS: ``tenant`` / ``priority`` identify a request (``qos``); the
  admission scan is the weighted-fair planner (per-(tenant, class) FIFO
  buckets, strict classes, a stronger waiting class preempts a weaker
  slot), and a ``qos_policy``'s token buckets refuse an indebted tenant
  (429 + ``Retry-After``), charged at delivery.
- Admission control: a ``deadline_s`` body is priced against the
  engine's own step and prefill EWMAs and block pressure
  (:meth:`DecodeEngine.estimate_admission`); an infeasible body is shed
  whole at the door (:class:`Shed`, 503 + ``Retry-After``).
- Lifecycle: :meth:`DecodeEngine.drain` / :meth:`DecodeEngine.respawn`,
  :meth:`ModelServer.drain` and SIGTERM drain; ``chaos``'s serving
  sites sit at the step boundary, admission and token delivery.
- Observability: one ``MetricsRegistry`` per engine (latency
  histograms, counters, stage timers, per-stage SLO attribution from
  ``slo.attribute_intervals``) and a ``FlightRecorder`` of per-request
  spans.
- Fleet-facing server state: the ``X-TFOS-Request-Id`` dedup window,
  lease fencing (410), the control-epoch fence (409), ``X-TFOS-Trace``
  adoption.

Error taxonomy on the wire: malformed body 400 (for ``:predict``:
ragged, non-numeric, empty and 0-d inputs and a batch-size mismatch;
for ``:generate``: a malformed ``tenant``, ``priority`` or
``session``), :class:`QueueFull` 429, ``qos.QuotaExceeded`` 429 with
``Retry-After``, :class:`Retriable` (:class:`Shed`, :class:`Draining`,
:class:`EngineFailed`) 503 with ``Retry-After``, :class:`Fenced` 410,
:class:`DeadlineExceeded` 504, :class:`Cancelled` 499; ``/kv/splice``:
:class:`SpliceRejected` 409 with its ``reason``, a malformed shipment
400; an ``/admin`` call stamped below the control-epoch floor 409.

Run a server from a shell (an export behind ``:predict``; SIGTERM
drains)::

    python -m tensorflowonspark_tpu_torch.serving --model-dir EXPORT \
        --name mnist --port 8501 [--device cpu]

The fleet that hosts engines behind one router is ``fleet.py``; the
supervisor that restarts a dead scheduler is ``supervisor.py``, the
autoscaler that sizes the fleet ``autoscale.py``. Left out of this port
so far (see ROADMAP.md, Queue 1): the profiler hooks. ``compile_stats``
reports program counts as None (eager PyTorch keeps no program cache).
``_Batcher`` drops the reference's power-of-two padding of a merged
batch, which bounds ``jit``'s compile cache; eager PyTorch has none,
and padding would only add rows to compute.
"""

import collections
import contextlib
import itertools
import json
import logging
import math
import os
import queue as queue_mod
import random
import socket
import threading
import time

import numpy as np
import torch

from tensorflowonspark_tpu_torch import chaos
from tensorflowonspark_tpu_torch import device_info
from tensorflowonspark_tpu_torch import frames
from tensorflowonspark_tpu_torch import generation
from tensorflowonspark_tpu_torch import kvship
from tensorflowonspark_tpu_torch import paging
from tensorflowonspark_tpu_torch import qos
from tensorflowonspark_tpu_torch import slo
from tensorflowonspark_tpu_torch import tracing
from tensorflowonspark_tpu_torch.qos import QuotaExceeded  # noqa: F401 - HTTP taxonomy re-export

logger = logging.getLogger(__name__)

#: content type a /metrics response declares (OpenMetrics exposition)
OPENMETRICS_CONTENT_TYPE = tracing.OPENMETRICS_CONTENT_TYPE

_STREAM_DONE = object()
_ENGINE_IDS = itertools.count()

#: the per-request stages whose seconds the attribution histograms
#: ``tfos_slo_attrib_<stage>_seconds`` carry
_ATTRIB_STAGES = ("queue_wait", "admission", "prefill", "decode",
                  "preempted")

#: {card index: the lock its engines take turns on}, see _launch_turn
_LAUNCH_TURNS = {}
_LAUNCH_TURNS_LOCK = threading.Lock()


def _launch_turn(device):
    """The lock every engine of this process on ``device``'s card holds
    while it launches a prefill or a decode step (a null context off
    the card). An eager step is a few hundred launches. Two engines
    launching at once on one card contend for the interpreter's lock
    and the driver at every op, and each step then takes several times
    the host CPU it takes alone; taking turns, a step waits only for
    the other engine's launches (``profile_serving.py --layouts``
    measures both)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    with _LAUNCH_TURNS_LOCK:
        return _LAUNCH_TURNS.setdefault(index, threading.Lock())


class Retriable(RuntimeError):
    """The request failed for a TRANSIENT serving-side reason; the
    client should retry (HTTP 503 with ``Retry-After``)."""

    #: advisory seconds before a retry is worth attempting
    retry_after = 1.0


class Shed(Retriable):
    """Admission refused the request because its deadline is
    infeasible."""

    def __init__(self, msg, retry_after=1.0):
        super(Shed, self).__init__(msg)
        self.retry_after = max(1.0, float(retry_after))


class Draining(Retriable):
    """The engine/server is draining: new work must go elsewhere."""

    retry_after = 5.0


class EngineFailed(Retriable):
    """The decode scheduler died; outstanding handles fail with this."""


#: HTTP statuses a serving surface answers for TRANSIENT conditions —
#: 429 (QueueFull backpressure) and 503 (Shed / Draining / EngineFailed)
RETRIABLE_HTTP_STATUS = (429, 503)

#: fraction of a Retry-After floor added as jitter by retry_call: N
#: clients told the same "Retry-After: T" by one recovering replica
#: spread over [T, T*(1+this)] instead of stampeding it at exactly +T
RETRY_AFTER_JITTER = 0.25


def http_retriable(status, retry_after=None):
    """Map an upstream HTTP status to the matching client-side
    :class:`Retriable` (None when the status is not transient) — the
    one place the wire's 429/503 + ``Retry-After`` contract turns back
    into the exception :func:`retry_call` retries. ``retry_after`` is
    the response header value (seconds), if any."""
    if status not in RETRIABLE_HTTP_STATUS:
        return None
    err = Retriable("upstream answered {}".format(status))
    try:
        err.retry_after = max(0.0, float(retry_after))
    except (TypeError, ValueError):
        err.retry_after = 1.0 if status == 503 else 0.5
    return err


def retry_call(fn, attempts=4, base_delay=0.1, max_delay=5.0,
               sleep=time.sleep, rng=None):
    """Call ``fn()``, retrying ONLY :class:`Retriable` failures with
    bounded exponential backoff and full jitter.

    The one client-side retry loop (a fleet router's and an HTTP
    client's, instead of ad-hoc loops): non-retriable errors — bad
    requests, real server faults, cancellations — propagate on the
    first raise; a retriable one is retried up to ``attempts`` total
    calls, sleeping
    ``uniform(0, min(max_delay, base_delay * 2**attempt))`` between
    tries (full jitter — N clients retrying a shed replica must not
    re-arrive in lockstep). ``exc.retry_after`` refines the delay: a
    POSITIVE value (the wire's ``Retry-After``) floors it, capped at
    ``max_delay``, PLUS up to ``RETRY_AFTER_JITTER`` of itself in
    jitter — the server said when a retry is worth attempting, and
    coming back sooner just buys another refusal, but N clients all
    told "Retry-After: 2" by the same recovering replica must not
    re-arrive at +2.000s in one synchronized stampede (the jitter is
    NOT capped by ``max_delay``: capping would re-synchronize exactly
    the clients whose floor hit the cap); an EXPLICIT
    ``retry_after == 0`` skips the sleep entirely — the router's
    failover shape, where the next attempt goes to a DIFFERENT
    replica and any wait is pure added latency; absent/None means
    plain jittered backoff. ``sleep``/``rng`` are injectable for
    deterministic tests; the final attempt's exception propagates
    unchanged."""
    rng = rng if rng is not None else random.random
    attempts = max(1, int(attempts))
    attempt = 0
    while True:
        try:
            return fn()
        except Retriable as e:
            attempt += 1
            if attempt >= attempts:
                raise
            try:
                retry_after = float(getattr(e, "retry_after", None))
            except (TypeError, ValueError):
                retry_after = None
            if retry_after is not None and retry_after <= 0.0:
                continue  # explicit immediate failover: no sleep
            delay = min(float(max_delay),
                        float(base_delay) * (2.0 ** (attempt - 1)))
            delay *= rng()
            if retry_after is not None:
                floor = min(retry_after, float(max_delay))
                delay = max(delay, floor * (1.0 + RETRY_AFTER_JITTER
                                            * rng()))
            if delay > 0.0:
                sleep(delay)


class SpliceRejected(RuntimeError):
    """A KV shipment was refused deliberately (HTTP 409): ``reason`` is
    one of "unpaged", "block_size", "kv_dtype", "malformed",
    "pool_exhausted", "fenced" or "engine". The shipping side gives up
    and the decode side prefills cold."""

    def __init__(self, reason, msg):
        super(SpliceRejected, self).__init__(msg)
        self.reason = str(reason)


class Cancelled(RuntimeError):
    """The request was cancelled (``handle.cancel()``, an abandoned
    :meth:`GenerationHandle.stream`, or a disconnected HTTP client);
    its slot was freed at the next decode-step boundary."""


class DeadlineExceeded(Cancelled):
    """The request's deadline passed before it completed; the engine
    evicted it at the next decode-step boundary."""


class QueueFull(RuntimeError):
    """The engine's admission queue is at ``max_queue`` — backpressure
    (HTTP 429)."""


class Fenced(RuntimeError):
    """This replica's serving lease epoch was superseded (another
    holder registered for its identity — see ``reservation.Fenced``):
    it must not serve. NON-retriable: the HTTP surface answers 410
    (Gone) with ``kind: "Fenced"`` — a client or router should
    re-resolve to the current holder, never retry here."""


class DedupWindow(object):
    """Bounded TTL + LRU idempotency window for request replay.

    The exactly-once half of partition-tolerant dispatch: a retry of a
    request this replica ALREADY executed (the ambiguous-timeout shape
    — the response was lost, not the work) must not execute twice.
    Keyed on the router's ``X-TFOS-Request-Id``; three cases:

    - **fresh** — no entry: the caller becomes the OWNER, executes,
      and publishes the outcome (``complete``) or withdraws
      (``fail`` — failed attempts are NOT cached, a later retry gets a
      clean execution).
    - **completed** — a finished entry inside the TTL: the stored
      response is REPLAYED verbatim (a dedup *hit*).
    - **in-flight** — the original is still executing: the retry JOINS
      it (waits on the owner's outcome) instead of racing a duplicate
      generation (a dedup *join*) — this is what makes a post-timeout
      failover that lands back on the same replica safe while the
      first execution is still running.

    Bounded two ways: ``ttl_s`` (entries expire — a replay window, not
    a permanent ledger) and ``capacity`` (LRU eviction — memory stays
    bounded under sustained traffic). Evicting an in-flight entry is
    safe: joiners hold the entry object itself, so the owner's outcome
    still resolves them; the id just stops deduplicating afterwards.
    Thread-safe (HTTP handler threads share it). ``now`` is injectable
    for deterministic TTL tests."""

    def __init__(self, capacity=2048, ttl_s=120.0, now=time.monotonic):
        self.capacity = max(1, int(capacity))
        self.ttl_s = float(ttl_s)
        self._now = now
        self._lock = threading.Lock()
        self._entries = collections.OrderedDict()  # rid -> _DedupEntry

    class _Entry(object):
        __slots__ = ("done", "response", "error", "created")

        def __init__(self, created):
            self.done = threading.Event()
            self.response = None
            self.error = None
            self.created = created

    def begin(self, request_id):
        """(entry, owner): ``owner`` True means the caller must execute
        and then call :meth:`complete` or :meth:`fail`; False means the
        entry belongs to an earlier arrival — replay/join it."""
        rid = str(request_id)
        now = self._now()
        with self._lock:
            self._expire_locked(now)
            entry = self._entries.get(rid)
            if entry is not None:
                # TTL is since-last-access: the refresh keeps the
                # OrderedDict's insertion order == recency order, so
                # head-scan expiry is exact
                entry.created = now
                self._entries.move_to_end(rid)
                return entry, False
            entry = self._Entry(now)
            self._entries[rid] = entry
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
            return entry, True

    def complete(self, request_id, entry, response):
        """Publish the owner's successful response for replay."""
        entry.response = response
        entry.done.set()

    def fail(self, request_id, entry, error):
        """Withdraw a failed execution: joiners already waiting get the
        error (they were the same request — hiding it would hang them),
        but the entry leaves the window so a LATER retry re-executes
        instead of replaying a transient failure forever."""
        entry.error = error
        entry.done.set()
        with self._lock:
            if self._entries.get(str(request_id)) is entry:
                del self._entries[str(request_id)]

    def _expire_locked(self, now):
        while self._entries:
            rid, entry = next(iter(self._entries.items()))
            if now - entry.created <= self.ttl_s:
                break
            del self._entries[rid]

    def stats(self):
        with self._lock:
            return {"entries": len(self._entries),
                    "capacity": self.capacity, "ttl_s": self.ttl_s}


class GenerationHandle(object):
    """One in-flight generation request against a :class:`DecodeEngine`.

    The scheduler thread emits tokens into the handle as each step
    completes; clients iterate :meth:`stream` or block on
    :meth:`result`. ``deadline`` (absolute ``time.monotonic``) and
    :meth:`cancel` evict the request at the next step boundary.
    ``latency`` is submit-to-completion wall time.

    ``tenant`` / ``priority`` are the QoS identity (validated upstream
    by ``qos.validate_tenant`` / ``validate_priority``); ``session`` is
    an opaque conversation id the engine never interprets; ``trace`` is
    the request's flight-recorder row (an externally minted id, such as
    a router's ``X-TFOS-Trace``, is adopted verbatim)."""

    def __init__(self, prompt, max_new_tokens, deadline=None, trace=None,
                 session=None, tenant=None, priority=None):
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline
        self.submitted = time.monotonic()
        self.completed = None
        self.tenant = tenant if tenant is not None else qos.DEFAULT_TENANT
        self.priority = priority if priority is not None \
            else qos.DEFAULT_PRIORITY
        self.session = str(session) if session is not None else None
        self.trace = int(trace) if trace is not None \
            else tracing.next_trace_id()
        self._tokens = []
        self._q = queue_mod.Queue()
        self._done = threading.Event()
        self._error = None
        self._cancel_requested = False
        # observability cursors (the scheduler thread writes)
        self._last_emit_at = None   # monotonic of the last emitted token
        self._decode_t0 = None      # monotonic of prefill completion
        self._preempt_at = None     # monotonic of the last eviction
        # (name, t0, t1) lifecycle spans for critical-path attribution
        # (slo.attribute_intervals) at finish
        self._attr_spans = []

    # -- scheduler side --------------------------------------------------

    def _emit(self, token):
        self._tokens.append(int(token))
        self._q.put(int(token))

    def _finish(self, error=None):
        self._error = error
        self.completed = time.monotonic()
        self._done.set()
        self._q.put(_STREAM_DONE)

    def _evictable(self, now):
        """Why the scheduler should evict this request now, or None."""
        if self._cancel_requested:
            return Cancelled("request cancelled")
        if self.deadline is not None and now > self.deadline:
            return DeadlineExceeded(
                "deadline exceeded after {} of {} tokens".format(
                    len(self._tokens), self.max_new_tokens))
        return None

    # -- client side -----------------------------------------------------

    def cancel(self):
        """Ask the engine to stop generating. Returns False if the
        request had already completed. Idempotent."""
        if self._done.is_set():
            return False
        self._cancel_requested = True
        return True

    def stream(self, timeout=600.0):
        """Yield generated tokens as the engine emits them; ``timeout``
        bounds the wait for EACH token. Abandoning the generator cancels
        the request."""
        while True:
            try:
                item = self._q.get(timeout=timeout)
            except queue_mod.Empty:
                raise TimeoutError("no token within {}s".format(timeout))
            if item is _STREAM_DONE:
                if self._error is not None:
                    raise self._error
                return
            try:
                yield item
            except GeneratorExit:
                self.cancel()
                raise

    def result(self, timeout=600.0):
        """Block until complete; returns prompt + generated tokens."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                "generation did not complete within {}s".format(timeout))
        if self._error is not None:
            raise self._error
        return list(self.prompt) + list(self._tokens)

    @property
    def generated(self):
        """Tokens emitted so far (complete once :meth:`result` returns)."""
        return list(self._tokens)

    @property
    def latency(self):
        return (self.completed - self.submitted) \
            if self.completed is not None else None


class DecodeEngine(object):
    """Continuous batching over a KV cache for a port ``DecoderLM``.

    ``model`` is moved to ``device`` (``None``: the card; ``"cpu"`` must
    be asked for). ``kv_block_size`` (None: the largest divisor of
    ``total_len`` up to 16) must divide ``total_len``; 0 selects the
    contiguous per-slot cache, where ``kv_blocks``, ``attn_impl``,
    ``kv_dtype="int8"`` and ``speculate_k`` raise. ``kv_blocks``
    (None: ``slots * total_len / kv_block_size``, capacity parity with
    a contiguous cache) is the pool size without the scratch row.
    ``attn_impl``: ``"fused"`` (kernel on the card, plain blockwise
    version on the CPU) or ``"gather"`` (the oracle). ``kv_dtype``:
    None/``"float32"`` or ``"int8"``. ``generator``: a seeded
    ``torch.Generator`` on ``device``, required when ``temperature >
    0``. ``speculate_k`` (None, or >= 2) and ``draft_layers`` (default
    ``num_layers // 2``) turn on speculative rounds; ``tier`` is
    "prefill", "decode" or "mixed" (the default); ``replica_id`` names
    the engine in shipments, scrapes and chaos scoping (default: unique
    in the process; a respawned engine keeps it).

    Observability: ``counters`` / ``timers`` (``tracing.Counters`` /
    ``StageTimers``), ``metrics`` (a ``tracing.MetricsRegistry``) and
    ``flight`` (a ``tracing.FlightRecorder``; default the process-global
    one) are shared when given — :meth:`respawn` passes its own, so one
    series continues across a restart. ``qos_policy`` (a
    ``qos.QosPolicy``, its kwargs dict, or None) sets per-tenant fair
    share weights and token-rate quotas.

    Request lifecycle: ``submit(..., deadline_s=T)`` sheds an infeasible
    deadline at the door (:class:`Shed`, priced by
    :meth:`estimate_admission`); an admitted request past its deadline,
    or cancelled, is evicted at the next step boundary. :meth:`drain`
    refuses new work and finishes the admitted; :meth:`respawn` builds a
    fresh engine from this one's construction config. Counts: ``shed``,
    ``cancelled``, ``deadline_exceeded``, ``preemptions``, and
    ``engine_restarts`` (the supervisor's restarts after a scheduler
    death, ``supervisor.RestartEngine``)."""

    def __init__(self, model, slots=8, total_len=None, buckets=None,
                 temperature=0.0, top_k=None, top_p=None, eos_token=None,
                 generator=None, counters=None, timers=None, max_queue=1024,
                 metrics=None, flight=None, replica_id=None,
                 kv_block_size=None, kv_blocks=None, prefix_cache=True,
                 attn_impl=None, speculate_k=None, draft_layers=None,
                 kv_dtype=None, tier=None, qos_policy=None, device=None):
        self.device = device_info.default_device(device)
        self._turn = _launch_turn(self.device)
        self.replica_id = str(replica_id) if replica_id is not None \
            else "engine-{}-{}".format(os.getpid(), next(_ENGINE_IDS))
        # construction config, verbatim, so respawn() can rebuild an
        # identical engine after a scheduler death
        self._spawn_args = dict(
            model=model, slots=slots, total_len=total_len,
            buckets=buckets, temperature=temperature, top_k=top_k,
            top_p=top_p, eos_token=eos_token, generator=generator,
            max_queue=max_queue, replica_id=self.replica_id,
            kv_block_size=kv_block_size, kv_blocks=kv_blocks,
            prefix_cache=prefix_cache, attn_impl=attn_impl,
            speculate_k=speculate_k, draft_layers=draft_layers,
            kv_dtype=kv_dtype, tier=tier, qos_policy=qos_policy,
            device=device)
        if tier is None:
            tier = "mixed"
        if tier not in ("prefill", "decode", "mixed"):
            raise ValueError(
                "tier must be 'prefill', 'decode', or 'mixed', "
                "got {!r}".format(tier))
        self.tier = str(tier)
        total_len = int(total_len or model.max_len)
        if total_len > model.max_len:
            raise ValueError(
                "total_len {} exceeds model.max_len {}".format(
                    total_len, model.max_len))
        if int(slots) < 1:
            raise ValueError("slots must be >= 1, got {}".format(slots))
        self.model = model.to(self.device).eval()
        self.slots = int(slots)
        self.total_len = total_len
        self.buckets = tuple(sorted(int(b) for b in buckets)) if buckets \
            else generation.default_buckets(total_len)
        if self.buckets[-1] > total_len:
            raise ValueError(
                "largest bucket {} exceeds total_len {}".format(
                    self.buckets[-1], total_len))
        self.eos_token = None if eos_token is None else int(eos_token)
        self.max_queue = None if max_queue is None else int(max_queue)
        generation.check_sampling_config(temperature, top_k, top_p,
                                         generator)
        self._temperature = float(temperature)
        self._top_k = None if top_k is None else int(top_k)
        self._top_p = None if top_p is None else float(top_p)
        self._generator = generator
        self.counters = counters if counters is not None \
            else tracing.Counters()
        self.timers = timers if timers is not None else tracing.StageTimers()
        #: the engine's observability plane: one MetricsRegistry with its
        #: counters, stage timers and latency histograms (GET /metrics
        #: renders it; registration is idempotent, so a respawned engine
        #: re-adds the same shared objects under the same names)
        self.metrics = metrics if metrics is not None \
            else tracing.MetricsRegistry()
        self.metrics.add_counters("tfos_serving", self.counters)
        self.metrics.add_timers("tfos_serving_stage", self.timers)
        #: latency distributions in seconds, written by the scheduler
        #: thread (``kv_ship_ms``: milliseconds, by :meth:`note_ship`)
        self.histograms = {name: self.metrics.histogram(family)
                           for name, family in (
                               ("ttft", "tfos_serving_ttft_seconds"),
                               ("token",
                                "tfos_serving_token_latency_seconds"),
                               ("decode_step",
                                "tfos_serving_decode_step_seconds"),
                               ("queue_wait",
                                "tfos_serving_queue_wait_seconds"),
                               ("request", "tfos_serving_request_seconds"),
                               ("drain", "tfos_serving_drain_seconds"))}
        # per-request critical-path attribution: at finish the request's
        # lifecycle spans are partitioned into stages
        # (slo.attribute_intervals, sum-to-wall by construction), each
        # stage's seconds into its own histogram
        self._hist_attrib = {
            stage: self.metrics.histogram(
                "tfos_slo_attrib_{}_seconds".format(stage))
            for stage in _ATTRIB_STAGES}
        #: per-request span timeline (admit, queue, prefill, decode,
        #: preempt, finish/evict/shed); GET /debug/trace renders it
        self.flight = flight if flight is not None \
            else tracing.flight_recorder()
        tracing.expose_flight_drops(self.metrics, self.flight)
        #: shipped-KV accounting: PHYSICAL bytes (pool rows as stored)
        #: and blocks, written by handler threads and the scheduler, so
        #: only under ``_cv`` (:meth:`note_ship`, :meth:`_kv_import`)
        self.kv_counters = self.metrics.add_counters(
            "tfos_kv", tracing.Counters())
        self.histograms["kv_ship_ms"] = self.metrics.histogram(
            "tfos_kv_ship_ms")
        self._splice_failures = {}  # reason -> count, under _cv
        # -- the QoS plane -------------------------------------------
        self.qos_policy = qos.QosPolicy.from_spec(qos_policy)
        # weighted-fair admission with strict classes; scheduler-thread
        # private (select/charge run only inside the admission scan)
        self._qos_sched = qos.FairScheduler(self.qos_policy)
        # post-paid per-tenant token buckets: the scheduler charges
        # deliveries, handler threads check admission (own lock)
        self._quota = qos.QuotaTable(self.qos_policy)
        # tenant-labeled tallies behind the tfos_qos_* families; all
        # mutate under _cv
        self._qos_admitted = {}          # (tenant, class) -> requests
        self._qos_preemptions = {}       # (tenant, class) -> evictions
        self._qos_tokens = {}            # tenant -> generated tokens
        self._qos_quota_rejections = {}  # tenant -> refusals
        self._hist_qwait_class = {
            name: self.metrics.histogram(
                "tfos_qos_queue_wait_{}_seconds".format(name))
            for name in qos.PRIORITIES}
        if kv_block_size is None:
            kv_block_size = next(b for b in range(16, 0, -1)
                                 if total_len % b == 0)
        self.kv_block_size = int(kv_block_size)
        self._paged = self.kv_block_size > 0
        if kv_dtype in ("fp32", "float32"):
            kv_dtype = None
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                "kv_dtype must be None/'fp32'/'float32' or 'int8', "
                "got {!r}".format(kv_dtype))
        if speculate_k is not None and int(speculate_k) < 2:
            raise ValueError(
                "speculate_k must be >= 2 (a 1-token window is a "
                "plain decode step plus a wasted draft), got "
                "{}".format(speculate_k))
        if speculate_k is None and draft_layers is not None:
            raise ValueError("draft_layers needs speculate_k")
        self._spec_k = 0 if speculate_k is None else int(speculate_k)
        self.draft_layers = 0
        self._draft = None
        self._draft_cache = None
        if self._paged:
            if total_len % self.kv_block_size:
                raise ValueError(
                    "kv_block_size {} must divide total_len {}".format(
                        self.kv_block_size, total_len))
            self._blocks_per_slot = total_len // self.kv_block_size
            self.kv_blocks = int(kv_blocks) if kv_blocks is not None \
                else self.slots * self._blocks_per_slot
            if self.kv_blocks < 1:
                raise ValueError("kv_blocks must be >= 1, got {}".format(
                    self.kv_blocks))
            self.prefix_cache = bool(prefix_cache)
            if attn_impl is None:
                attn_impl = "fused"
            if attn_impl not in ("fused", "gather"):
                raise ValueError(
                    "attn_impl must be 'fused' or 'gather', got "
                    "{!r}".format(attn_impl))
            self.attn_impl = attn_impl
            self.kv_dtype = "int8" if kv_dtype == "int8" else "float32"
            self._pool = paging.BlockPool(self.kv_blocks,
                                          self.kv_block_size,
                                          kv_dtype=self.kv_dtype)
            self._cache = generation.init_paged_cache(
                self.model, self.slots, total_len, self.kv_blocks,
                self.kv_block_size, kv_dtype=kv_dtype, device=self.device)
            if self._spec_k:
                if draft_layers is None:
                    draft_layers = max(1, self.model.num_layers // 2)
                # the draft's modules ARE the target's first blocks; its
                # own (shallower) pool shares the target's tables and
                # cursors, so one BlockPool governs both
                self._draft = generation.draft_model(self.model,
                                                     draft_layers)
                self.draft_layers = self._draft.num_layers
                self._draft_cache = generation.init_paged_cache(
                    self._draft, self.slots, total_len, self.kv_blocks,
                    self.kv_block_size, kv_dtype=kv_dtype,
                    device=self.device)
        else:
            if kv_blocks is not None:
                raise ValueError(
                    "kv_blocks needs a paged engine (kv_block_size>0)")
            if attn_impl is not None:
                raise ValueError(
                    "attn_impl needs a paged engine (kv_block_size>0)")
            if kv_dtype == "int8":
                raise ValueError(
                    "kv_dtype='int8' needs a paged engine "
                    "(kv_block_size>0): quantized KV lives in the "
                    "block pool")
            if self._spec_k:
                raise ValueError(
                    "speculate_k needs a paged engine "
                    "(kv_block_size>0): the fused verify writes "
                    "through the block tables' scratch routing")
            self.kv_blocks = 0
            self.prefix_cache = False
            self.attn_impl = "contiguous"
            self.kv_dtype = "float32"
            self._pool = None
            self._cache = generation.init_cache(
                self.model, self.slots, total_len, device=self.device)
        self._last_tallies = {}
        self._head_block_memo = None
        self._queue = collections.deque()
        # KV ship/splice jobs: export and import touch the pool and the
        # cache, the scheduler thread's monopoly, so client threads
        # queue them here under _cv and wait on a per-job event
        self._kv_jobs = collections.deque()
        self._cv = threading.Condition()
        self._stopping = False
        self._draining = False
        self._broken = None
        self._failed_requests = 0  # admitted-but-failed ledger (drain)
        #: cumulative requests submitted (the
        #: kill_serving_executor_at_request chaos count)
        self._requests_seen = 0
        # admission-control evidence: EWMAs of this engine's own decode
        # step and prefill wall times (the scheduler writes, submit
        # reads under _cv); None until the first sample, so a cold
        # engine never sheds
        self._step_ewma = None
        self._prefill_ewma = None
        # tokens emitted per round per active slot under speculation
        # (the divisor that prices a round's tokens); None until the
        # first round
        self._tokens_round_ewma = None
        self._qwait_ewma = None
        self._ewma_alpha = 0.3
        self._slot_req = [None] * self.slots
        # host-authoritative cursors and block tables: row s mirrors
        # _slot_blocks[s] padded with scratch (0); a freed slot's row
        # resets to scratch and its cursor to 0, so the idle slot's
        # per-step write lands in the scratch block
        self._idx = np.zeros(self.slots, np.int32)
        self._last = np.zeros(self.slots, np.int32)
        if self._paged:
            self._slot_blocks = [[] for _ in range(self.slots)]
            self._tables = np.zeros((self.slots, self._blocks_per_slot),
                                    np.int32)
            self._admit_seq = itertools.count()
            self._slot_seq = [0] * self.slots
            # leading FULL blocks of each slot's sequence already
            # published to the prefix registry
            self._slot_registered = [0] * self.slots
        self._publish_kv_gauges()
        if self._paged:
            # one hook per registry, reading whichever engine registered
            # last: a respawned engine shares the registry and takes over
            if getattr(self.metrics, "_digest_engine", None) is None:
                registry = self.metrics
                registry.add_hook(
                    lambda: registry._digest_engine._publish_digest_gauges())
            self.metrics._digest_engine = self
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tfos-torch-decode-engine")
        self._thread.start()

    # -- client API ------------------------------------------------------

    def validate(self, prompt, max_new_tokens):
        """Raise ValueError/TypeError if the request cannot be served;
        returns the normalized ``(prompt, max_new)``."""
        prompt = [int(t) for t in prompt]
        max_new = int(max_new_tokens)
        if not prompt:
            raise ValueError("prompt must be non-empty")
        vocab = self.model.vocab
        bad = next((t for t in prompt if not 0 <= t < vocab), None)
        if bad is not None:
            raise ValueError(
                "prompt token {} outside vocab [0, {})".format(bad, vocab))
        if max_new < 0:
            raise ValueError(
                "max_new_tokens must be >= 0, got {}".format(max_new))
        generation.bucket_for(len(prompt), self.buckets)
        if len(prompt) + max_new > self.total_len:
            raise ValueError(
                "prompt {} + max_new_tokens {} exceeds total_len {}".format(
                    len(prompt), max_new, self.total_len))
        if self._paged:
            need = self._pool.blocks_for(len(prompt) + max_new)
            if need > self.kv_blocks:
                raise ValueError(
                    "request needs up to {} KV blocks but the pool has "
                    "{} (kv_blocks)".format(need, self.kv_blocks))
        return prompt, max_new

    def submit(self, prompt, max_new_tokens, deadline_s=None, session=None,
               tenant=None, priority=None):
        """Queue one request; returns its :class:`GenerationHandle`.
        ``deadline_s`` (seconds from now) sheds the request at the door
        when it is infeasible under the engine's measured rates
        (:class:`Shed`) and evicts it at the first step boundary past
        it. ``session``: an opaque conversation id on the handle.
        ``tenant`` / ``priority``: the QoS identity (omitted: the
        ``default`` tenant at ``normal``); a malformed value raises
        ``ValueError``, a tenant whose bucket is in debt
        ``qos.QuotaExceeded``."""
        return self._submit_many([self.validate(prompt, max_new_tokens)],
                                 deadline_s=deadline_s, session=session,
                                 tenant=tenant, priority=priority)[0]

    def estimate_admission(self, max_new_tokens, prompt=None):
        """``{"queue_wait_s", "service_s"}``: what admitting a request of
        ``max_new_tokens`` now would cost, from the engine's own EWMAs
        of decode-step and prefill wall times. Queued requests each owe
        one serial prefill; the token backlog (queued ``max_new`` plus
        what active slots still owe) drains at ``slots`` tokens a step;
        ``service_s`` is the request's own prefill plus ``max_new``
        steps (a speculative engine's step divided by its tokens per
        round). ``prompt`` lets a paged engine price block pressure:
        when the pool cannot supply its prefill blocks now, the wait is
        floored at the earliest possible release. Zeros until the engine
        has served anything."""
        with self._cv:
            return self._estimate_locked(int(max_new_tokens),
                                         prompt=prompt)

    def _estimate_locked(self, max_new, extra_requests=0, extra_tokens=0,
                         prompt=None, extra_blocks=0):
        """``extra_*``: work ahead of this request that is not queued
        yet — the earlier members of the same body during whole-body
        shed vetting (member k waits behind members 0..k-1)."""
        step = self._step_ewma or 0.0
        prefill = self._prefill_ewma or 0.0
        tpr = max(self._tokens_round_ewma or 1.0, 1.0)
        step = step / tpr
        backlog = extra_tokens + sum(h.max_new_tokens for h in self._queue)
        remaining = []
        for s in range(self.slots):
            handle = self._slot_req[s]
            if handle is not None:
                owed = max(handle.max_new_tokens - len(handle._tokens), 0)
                backlog += owed
                remaining.append(owed)
        wait = (len(self._queue) + extra_requests) * prefill \
            + backlog * step / self.slots
        if self._paged and prompt is not None and step:
            # one atomic pool snapshot: a torn plan/capacity read would
            # double-count the deficit (spurious shed) or mask it
            _, need, lru_shared, allocatable, _ = \
                self._pool.plan_admission(prompt)
            deficit = need + lru_shared + extra_blocks - allocatable
            if deficit > 0 and remaining:
                wait = max(wait, min(remaining) * step)
        return {"queue_wait_s": wait,
                "service_s": prefill + max_new * step}

    def _submit_many(self, vetted, deadline_s=None, trace=None,
                     session=None, tenant=None, priority=None):
        """Atomically queue a whole vetted body: every request is queued
        or none is (QueueFull, QuotaExceeded, Shed, draining, stopped and
        broken raise before any handle exists). ``max_new == 0``
        requests complete inline. ``trace`` adopts an external trace id
        for every handle of the body; ``tenant`` / ``priority`` are one
        identity for the whole body."""
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if not deadline_s > 0:
                raise ValueError(
                    "deadline_s must be > 0, got {}".format(deadline_s))
        tenant = qos.validate_tenant(tenant)
        priority = qos.validate_priority(priority)
        # the quota gate: post-paid, so this check never charges
        # (usage is charged at delivery); QuotaTable has its own lock
        try:
            self._quota.admit(tenant)
        except qos.QuotaExceeded:
            self.note_quota_rejection(tenant, requests=len(vetted))
            raise
        with self._cv:
            # the chaos site counts under _cv (handlers submit in
            # parallel) and BEFORE admission
            self._requests_seen += len(vetted)
            chaos.on_serving_request(self._requests_seen,
                                     ident=self.replica_id)
            # draining outranks stopped: a drained engine ends with both
            # set, and a racer must still get the retriable 503
            if self._draining:
                raise Draining(
                    "engine is draining; not accepting new requests")
            if self._stopping:
                raise RuntimeError("engine stopped")
            if self._broken is not None:
                raise EngineFailed("engine failed: {}".format(self._broken))
            queueing = sum(1 for _, mn in vetted if mn > 0)
            if self.max_queue is not None and \
                    len(self._queue) + queueing > self.max_queue:
                raise QueueFull(
                    "admission queue full ({} waiting, max_queue {})"
                    .format(len(self._queue), self.max_queue))
            if deadline_s is not None:
                # shed the WHOLE body if any member is infeasible,
                # members priced cumulatively (member k queues behind
                # 0..k-1); max_new == 0 members never queue
                ahead_requests = ahead_tokens = ahead_blocks = 0
                for prompt, max_new in vetted:
                    if max_new == 0:
                        continue
                    est = self._estimate_locked(
                        max_new, extra_requests=ahead_requests,
                        extra_tokens=ahead_tokens, prompt=prompt,
                        extra_blocks=ahead_blocks)
                    need = est["queue_wait_s"] + est["service_s"]
                    if need > deadline_s:
                        self.counters.inc("shed", len(vetted))
                        self.flight.instant(
                            "shed", requests=len(vetted),
                            deadline_s=deadline_s,
                            queue_wait_s=round(est["queue_wait_s"], 3),
                            service_s=round(est["service_s"], 3))
                        raise Shed(
                            "deadline {:.2f}s infeasible: estimated "
                            "queue wait {:.2f}s + service {:.2f}s"
                            .format(deadline_s, est["queue_wait_s"],
                                    est["service_s"]),
                            retry_after=math.ceil(est["queue_wait_s"]))
                    ahead_requests += 1
                    ahead_tokens += max_new
                    if self._paged:
                        ahead_blocks += self._pool.blocks_for(len(prompt))
            deadline = None if deadline_s is None \
                else time.monotonic() + deadline_s
            handles = []
            for prompt, max_new in vetted:
                handle = GenerationHandle(prompt, max_new, deadline=deadline,
                                          trace=trace, session=session,
                                          tenant=tenant, priority=priority)
                self.flight.instant("admit", trace=handle.trace,
                                    prompt_len=len(prompt), max_new=max_new,
                                    deadline_s=deadline_s,
                                    session=handle.session or "",
                                    tenant=tenant, priority=priority)
                if max_new == 0:
                    handle._finish()
                    self._trace_finish(handle, "finish",
                                       record_latency=False)
                else:
                    self._queue.append(handle)
                handles.append(handle)
            if queueing:
                self.counters.gauge("queue_depth", len(self._queue))
                self._cv.notify()
        return handles

    def generate(self, prompt, max_new_tokens, timeout=600.0):
        """Blocking convenience: submit + result."""
        return self.submit(prompt, max_new_tokens).result(timeout)

    def healthy(self):
        """``{alive, scheduler_thread, stopping, draining, broken}``:
        ``alive`` is False once the scheduler died or the engine was
        stopped; a draining engine is still alive (it finishes its
        admitted work) but refuses new requests."""
        with self._cv:
            broken = self._broken
            stopping = self._stopping
            draining = self._draining
        thread_alive = self._thread.is_alive()
        return {"alive": thread_alive and not stopping and broken is None,
                "scheduler_thread": thread_alive,
                "stopping": stopping,
                "draining": draining,
                "broken": str(broken) if broken is not None else None}

    def load_stats(self):
        """Live load gauges: queue depth (also by priority class), slot
        occupancy, queue-wait EWMA, per-tenant backlog and usage, pool
        headroom, prefix-cache hit rate and digest, the engine's
        attention, KV, speculation and tier configuration, the live
        acceptance rate and the shipped-KV bytes (physical: pool rows
        as stored). A contiguous engine reports the zero schema."""
        with self._cv:
            queue_depth = len(self._queue)
            occupancy = len(self._active_slots())
            qwait = self._qwait_ewma
            queue_by_class = dict.fromkeys(qos.PRIORITIES, 0)
            tenant_queued = {}
            for h in self._queue:
                queue_by_class[h.priority] = \
                    queue_by_class.get(h.priority, 0) + 1
                tenant_queued[h.tenant] = tenant_queued.get(h.tenant, 0) + 1
            tenant_active = {}
            for s in self._active_slots():
                handle = self._slot_req[s]
                if handle is not None:
                    tenant_active[handle.tenant] = \
                        tenant_active.get(handle.tenant, 0) + 1
            qos_tokens = dict(self._qos_tokens)
            kv = {"kv_ship_bytes": self.kv_counters.get("ship_bytes"),
                  "kv_ship_blocks": self.kv_counters.get("ship_blocks"),
                  "kv_spliced_bytes": self.kv_counters.get("spliced_bytes"),
                  "kv_spliced_blocks":
                  self.kv_counters.get("spliced_blocks")}
        health = self.healthy()
        proposed = self.counters.get("spec_proposed")
        stats = {"device": str(self.device),
                 "replica_id": self.replica_id,
                 "tier": self.tier,
                 "queue_depth": queue_depth,
                 "slot_occupancy": occupancy,
                 "slots": self.slots,
                 "queue_wait_ewma_s": round(qwait, 6)
                 if qwait is not None else 0.0,
                 "alive": health["alive"],
                 "draining": health["draining"],
                 "queue_by_class": queue_by_class,
                 "tenants": {t: {"queued": tenant_queued.get(t, 0),
                                 "active": tenant_active.get(t, 0),
                                 "tokens": qos_tokens.get(t, 0)}
                             for t in set(tenant_queued)
                             | set(tenant_active) | set(qos_tokens)},
                 "attn_impl": self.attn_impl,
                 "kv_dtype": self.kv_dtype,
                 "speculate_k": self._spec_k,
                 "draft_layers": self.draft_layers,
                 "spec_acceptance_rate": round(
                     self.counters.get("spec_accepted") / proposed, 4)
                 if proposed else 0.0}
        stats.update(kv)
        if self._paged:
            ps = self._pool.stats()
            dig = self._pool.prefix_digest()
            stats.update({
                "kv_blocks_total": ps["total"],
                "kv_blocks_free": ps["free"],
                "prefix_hit_rate": round(ps["hit_rate"], 4),
                "generated_prefix_hit_blocks": ps["generated_hits"],
                "generated_prefix_registered": ps["generated_registered"],
                "prefix_digest": dig["top"],
                "prefix_digest_block_size": dig["block_size"],
                "digest_truncated": dig["truncated"]})
        else:
            stats.update({"kv_blocks_total": 0, "kv_blocks_free": 0,
                          "prefix_hit_rate": 0.0,
                          "generated_prefix_hit_blocks": 0,
                          "generated_prefix_registered": 0,
                          "prefix_digest": [],
                          "prefix_digest_block_size": 0,
                          "digest_truncated": False})
        return stats

    def _caches(self):
        return [self._cache] + ([self._draft_cache] if self._spec_k else [])

    def kv_cache_bytes(self):
        """Resident KV-cache bytes: the block pools (scratch row and an
        int8 pool's scales included) or the contiguous per-slot
        regions, plus the draft's pool when speculating."""
        return sum(t.numel() * t.element_size()
                   for cache in self._caches() for layer in cache
                   for name, t in layer.items()
                   if name in ("cached_key", "cached_value", "key_scale",
                               "value_scale"))

    def _time_calls(self, stage, fn, reps):
        """One unmeasured warm call, then ``reps`` timed calls of
        ``fn`` recorded as ``stage`` samples in ``timers`` (CUDA events
        on the card, the host clock on the CPU). Returns the stage's
        mean ms over every sample recorded so far."""
        cuda = self.device.type == "cuda"
        fn()
        for _ in range(max(1, int(reps))):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                self.timers.add(stage, start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                fn()
                self.timers.add(stage, time.perf_counter() - t0)
        return self.timers.per_ms().get(stage)

    def measure_attn(self, reps=3, depth=None):
        """Time ONE decode-shaped call of this engine's attention (the
        paged kernel on the card under ``attn_impl="fused"``, the plain
        gather under ``"gather"``) at the live pool's shapes, every slot
        ``depth`` tokens deep (default ``total_len // 2``; stated, not
        read from the cursors, since an idle engine's slots park at 0),
        one layer's pools. Records ``attn`` samples in ``timers``:
        ``reps`` timed calls after one unmeasured warm call, so the
        kernel's route counts rise by exactly ``reps + 1``. Returns the
        stage's mean ms, or None on a contiguous engine. Call while the
        engine is idle (it reads the live pool)."""
        if not self._paged:
            return None
        from tensorflowonspark_tpu_torch.ops import paged_attention as pa

        layer = self._cache[0]
        kp, vp = layer["cached_key"], layer["cached_value"]
        ks, vs = layer.get("key_scale"), layer.get("value_scale")
        n, d = kp.shape[2], kp.shape[3]
        depth = int(depth) if depth is not None else self.total_len // 2
        depth = max(1, min(depth, self.total_len))
        bps = self._blocks_per_slot
        tables = torch.as_tensor(
            (np.arange(self.slots)[:, None] * bps
             + np.arange(bps)[None, :]) % self.kv_blocks + 1,
            dtype=torch.int32, device=self.device)
        q = torch.zeros((self.slots, 1, n, d), dtype=torch.float32,
                        device=self.device)
        pos = torch.full((self.slots, 1), depth - 1, dtype=torch.int32,
                         device=self.device)
        impl = "gather" if self.attn_impl == "gather" else None
        with torch.no_grad():
            return self._time_calls(
                "attn", lambda: pa.paged_attention(
                    q, kp, vp, tables, pos, impl=impl, k_scale=ks,
                    v_scale=vs), reps)

    def measure_dequant(self, reps=3):
        """Time ONE whole-pool dequantize (codes x scales, K and V) at
        the live int8 pool's shapes, one layer, recorded as ``dequant``
        samples in ``timers`` — the worst case of what the int8 path
        adds to a step (the kernel dequantizes only live blocks, in
        registers). Returns the stage's mean ms, or None on an engine
        that does not store int8."""
        if not self._paged or self.kv_dtype != "int8":
            return None
        from tensorflowonspark_tpu_torch.ops import paged_attention as pa

        layer = self._cache[0]
        with torch.no_grad():
            return self._time_calls(
                "dequant", lambda: (
                    pa.dequantize_kv(layer["cached_key"],
                                     layer["key_scale"]),
                    pa.dequantize_kv(layer["cached_value"],
                                     layer["value_scale"])), reps)

    def measure_spec(self, reps=3, depth=None):
        """Time a speculative round's two halves apart — the draft's
        ``k`` one-token steps and the target's ``k``-query verify — at
        the engine's pool shapes with every slot ``depth`` tokens deep
        (default ``total_len // 2``), on copies of the pools (both
        halves write in place), each as :meth:`_time_calls` times it.
        Records ``draft`` and ``verify`` samples in ``timers``; returns
        ``{"draft": ms, "verify": ms}`` (each stage's mean), or None on
        an engine that does not speculate."""
        if not self._spec_k:
            return None
        k = self._spec_k
        depth = int(depth) if depth is not None else self.total_len // 2
        depth = max(1, min(depth, self.total_len - k))
        bps = self._blocks_per_slot
        dev = self.device
        tables = torch.as_tensor(
            (np.arange(self.slots)[:, None] * bps
             + np.arange(bps)[None, :]) % self.kv_blocks + 1,
            dtype=torch.int32, device=dev)
        idx = torch.full((self.slots,), depth, dtype=torch.int32,
                         device=dev)
        last = torch.zeros(self.slots, dtype=torch.int32, device=dev)
        feed = torch.zeros((self.slots, k), dtype=torch.int32, device=dev)
        propose, verify = generation.speculative_probe_fns(
            self.model, self._draft, k, self._temperature, self._top_k,
            self._top_p, self.attn_impl)
        cache = [{n: t.clone() for n, t in layer.items()}
                 for layer in self._cache]
        draft_cache = [{n: t.clone() for n, t in layer.items()}
                       for layer in self._draft_cache]
        gen = None
        if self._temperature:
            gen = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            return {"draft": self._time_calls(
                        "draft", lambda: propose(draft_cache, last, idx,
                                                 tables, gen), reps),
                    "verify": self._time_calls(
                        "verify", lambda: verify(cache, feed, idx, tables,
                                                 gen), reps)}

    def outstanding(self):
        """Queued + in-flight request count (the number drain waits on)."""
        with self._cv:
            return len(self._queue) + len(self._active_slots())

    def drain(self, timeout=None):
        """Graceful shutdown: refuse new submissions (:class:`Draining`),
        finish every ADMITTED request — queued and in-flight — then stop
        the scheduler. Returns True when nothing admitted was lost;
        False when ``timeout`` (seconds) expired first or the engine
        broke mid-drain (the stragglers fail with the stop or break
        error), and False on an engine that already stopped with
        requests in flight. ``timeout=None`` waits as long as the work
        takes."""
        t_drain0 = time.monotonic()
        with self._cv:
            if self._stopping:
                return self.outstanding() == 0 \
                    and self._failed_requests == 0
            if not self._draining:
                self._draining = True
                logger.info(
                    "decode engine draining: %d queued, %d in flight",
                    len(self._queue), len(self._active_slots()))
            failed_before = self._failed_requests
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        while True:
            with self._cv:
                left = len(self._queue) + len(self._active_slots())
                dead = self._broken is not None \
                    or not self._thread.is_alive()
            if left == 0 or dead:
                break
            if deadline is not None and time.monotonic() > deadline:
                logger.warning(
                    "drain timed out with %d request(s) outstanding; "
                    "they will fail with the stop error", left)
                break
            time.sleep(0.02)
        self.stop()
        self.histograms["drain"].observe(time.monotonic() - t_drain0)
        self.flight.instant("drain", outstanding=left)
        # a loop death mid-drain fails-and-clears the outstanding work,
        # so left == 0 alone would misreport a loss as a clean drain
        return left == 0 and self._failed_requests == failed_before

    def respawn(self):
        """A fresh engine from this engine's construction config,
        SHARING its counters, timers, metrics registry and flight
        recorder, so lifecycle counts (``engine_restarts``, tokens,
        shed and cancel tallies) and latency histograms continue across
        the restart as one series. Counts nothing itself: the
        supervisor's ``RestartEngine`` counts one ``engine_restarts``
        after re-arming a respawn that follows a scheduler death; a
        deliberate respawn (rolling drain, ``/admin/respawn``) is not a
        restart. Call :meth:`stop` on the dead engine first."""
        return DecodeEngine(counters=self.counters, timers=self.timers,
                            metrics=self.metrics, flight=self.flight,
                            **self._spawn_args)

    def compile_stats(self):
        """The reference's compile-bound report in its degraded form:
        ``decode_programs`` / ``prefill_programs`` (and
        ``spec_round_programs`` on a speculative engine) are None —
        eager PyTorch keeps no program cache to count — and ``buckets``
        is the prefill bucket count."""
        stats = {"decode_programs": None, "prefill_programs": None,
                 "buckets": len(self.buckets)}
        if self._spec_k:
            stats["spec_round_programs"] = None
        return stats

    def stop(self):
        """Stop the scheduler; queued and in-flight requests fail with
        RuntimeError. Idempotent."""
        with self._cv:
            if self._stopping:
                return
            self._stopping = True
            self._cv.notify_all()
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            logger.warning("decode engine scheduler still inside a device "
                           "call after 30s")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- scheduler loop --------------------------------------------------

    def _active_slots(self):
        return [s for s in range(self.slots)
                if self._slot_req[s] is not None]

    def _ewma(self, prev, sample):
        return sample if prev is None \
            else self._ewma_alpha * sample \
            + (1.0 - self._ewma_alpha) * prev

    def _trace_finish(self, handle, outcome, error=None,
                      record_latency=True):
        """Close a request's span tree: the decode span (prefill end ->
        last activity) when it decoded, the outer request span (admit ->
        done) and a terminal instant named for the outcome. The request
        histogram and the attribution observe NORMAL engine-served
        completions only (``record_latency=False`` keeps inline
        ``max_new == 0`` finishes out: they do no engine work and
        complete on the caller's thread)."""
        now = handle.completed if handle.completed is not None \
            else time.monotonic()
        # a request evicted between preemption and re-admission never
        # resumed decoding: its decode-so-far span was closed by
        # _preempt, and a new one would bill the evicted gap as decode
        resumed = (handle._preempt_at is None
                   or (handle._decode_t0 is not None
                       and handle._decode_t0 > handle._preempt_at))
        if handle._decode_t0 is not None and resumed:
            self.flight.span("decode", handle._decode_t0, now,
                             trace=handle.trace,
                             tokens=len(handle._tokens))
            handle._attr_spans.append(("decode", handle._decode_t0, now))
        self.flight.span("request", handle.submitted, now,
                         trace=handle.trace, outcome=outcome,
                         tokens=len(handle._tokens),
                         error=None if error is None else str(error))
        self.flight.instant(outcome, trace=handle.trace)
        if outcome == "finish" and record_latency:
            self.histograms["request"].observe(now - handle.submitted,
                                               trace=handle.trace)
            self._observe_attribution(handle, now)

    def _observe_attribution(self, handle, now):
        """Partition the finished request's wall into named stages and
        feed the per-stage attribution histograms (scheduler thread
        only, like every engine histogram)."""
        intervals = list(handle._attr_spans)
        intervals.append(("request", handle.submitted, now))
        report = slo.attribute_intervals(intervals)
        for stage, hist in self._hist_attrib.items():
            seconds = report["stages"].get(stage)
            if seconds:
                hist.observe(seconds, trace=handle.trace)

    def _evict(self, handle, err):
        handle._finish(err)
        self.counters.inc("deadline_exceeded"
                          if isinstance(err, DeadlineExceeded)
                          else "cancelled")
        self._trace_finish(handle, "evict", error=err)
        logger.info("evicted request after %d/%d tokens: %s",
                    len(handle._tokens), handle.max_new_tokens, err)

    def _prune_queue_locked(self, now):
        """Drop cancelled/expired requests from the admission queue
        (caller holds ``_cv``)."""
        if not any(h._evictable(now) for h in self._queue):
            return
        kept = collections.deque()
        for handle in self._queue:
            err = handle._evictable(now)
            if err is None:
                kept.append(handle)
            else:
                self._evict(handle, err)
        self._queue = kept

    def _evict_expired(self, now):
        """Free every active slot whose request is cancelled or past its
        deadline, before the step computes for it."""
        for s in self._active_slots():
            err = self._slot_req[s]._evictable(now)
            if err is not None:
                self._evict(self._slot_req[s], err)
                self._slot_req[s] = None
                self._release_slot(s)

    def _plan_admission_locked(self):
        """Weighted-fair admission plan (caller holds ``_cv``, at a step
        boundary); returns ``(admits, victims)``.

        Queue entries group into per-(tenant, class) FIFO buckets and
        ``qos.FairScheduler`` picks each admission: strict priority
        classes first, the largest deficit within the strongest class,
        so a starved tenant catches up while ``_queue`` stays the one
        source of truth for drain, eviction and estimates. One tenant at
        one class is the plain FIFO scan (one bucket, heads in queue
        order).

        Block gating is unchanged: the winner enters a slot only when
        its prefill blocks are obtainable now, judged from one
        ``plan_admission`` snapshot, with no bypass past a block-starved
        winner; an unchanged pool epoch means the old verdict stands.
        Fairness is charged in what gates entry: KV blocks on a paged
        engine (at least 1), slots otherwise.

        ``victims``: slot ids to preempt after ``_cv`` is released
        (``_preempt`` re-acquires it). While a strictly stronger class
        waits — for a slot or for blocks — the weakest-class youngest
        active slot yields, at most one per scan; the continuation
        re-prefills prompt + emitted tokens (token-identical at
        temperature 0). A contiguous engine never preempts."""
        admits = []
        if not self._queue:
            return admits, []
        free = [s for s in range(self.slots) if self._slot_req[s] is None]
        planned_blocks = 0
        block_starved = False
        buckets = collections.OrderedDict()
        for h in self._queue:
            buckets.setdefault((h.tenant, h.priority), []).append(h)
        backlogged = {t for t, _ in buckets}
        while free and buckets:
            keys = list(buckets)
            winner = keys[self._qos_sched.select(keys)]
            head = buckets[winner][0]
            cost = 1.0
            if self._paged:
                if self._head_block_memo == (head, self._pool.epoch()):
                    block_starved = True
                    break
                _, need, lru_shared, allocatable, epoch = \
                    self._pool.plan_admission(head.prompt + head._tokens)
                if need + lru_shared + planned_blocks > allocatable:
                    self._head_block_memo = (head, epoch)
                    block_starved = True
                    break
                self._head_block_memo = None
                planned_blocks += need + lru_shared
                cost = float(max(1, need + lru_shared))
            s = free.pop(0)
            # occupy the slot at pop time, so the failure paths find it;
            # deque.remove matches by identity (handles define no __eq__)
            self._queue.remove(head)
            buckets[winner].pop(0)
            if not buckets[winner]:
                del buckets[winner]
            self._slot_req[s] = head
            admits.append((s, head))
            self._qos_sched.charge(winner[0], cost, backlogged=backlogged)
            self._qos_admitted[winner] = \
                self._qos_admitted.get(winner, 0) + 1
        victims = []
        if buckets and self._paged and (block_starved or not free):
            waiting = min(qos.priority_rank(p) for _, p in buckets)
            admitted = {s for s, _ in admits}
            cands = [s for s in self._active_slots()
                     if s not in admitted
                     and qos.priority_rank(self._slot_req[s].priority)
                     > waiting]
            if cands:
                victims.append(max(cands, key=lambda v: (
                    qos.priority_rank(self._slot_req[v].priority),
                    self._slot_seq[v])))
        return admits, victims

    def _loop(self):
        ctx = torch.cuda.device(self.device) \
            if self.device.type == "cuda" else contextlib.nullcontext()
        try:
            with ctx, torch.no_grad():
                self._run()
        except BaseException as e:  # noqa: BLE001 - fail every client
            logger.exception("decode engine loop died")
            with self._cv:
                self._broken = e
                self._fail_outstanding(
                    EngineFailed("decode engine failed: {}".format(e)))

    def _run(self):
        steps = 0
        while True:
            with self._cv:
                while (not self._stopping and not self._queue
                       and not self._kv_jobs
                       and not self._active_slots()):
                    self._cv.wait()
                if self._stopping:
                    self._fail_outstanding(RuntimeError("engine stopped"))
                    return
                # KV ship/splice jobs drain under the lock and run
                # outside it: no admission or step interleaves with
                # pool surgery, since both run on this thread
                kv_jobs = list(self._kv_jobs)
                self._kv_jobs.clear()
                self._prune_queue_locked(time.monotonic())
                with self.timers.timed("qos_plan"):
                    admits, victims = self._plan_admission_locked()
                self.counters.gauge("queue_depth", len(self._queue))
            # class preemption outside the lock (_preempt re-acquires
            # _cv): the freed slot and blocks admit the waiting stronger
            # class at the next scan, one step later
            for s in victims:
                if self._slot_req[s] is not None:
                    self._preempt(s)
            for job in kv_jobs:
                self._run_kv_job(job)
            # prefill outside the lock: submit() never waits on the card
            for s, handle in admits:
                self._admit(s, handle)
            self._evict_expired(time.monotonic())
            if self._paged:
                self._grow_active_blocks()
            active = self._active_slots()
            self.counters.gauge("slot_occupancy", len(active))
            if not active:
                continue
            # serving chaos sites: a stall or a scheduler kill lands
            # here, between steps (replica_id scopes only=<replica>)
            chaos.on_decode_step(steps, self.replica_id)
            t0 = time.monotonic()
            if self._spec_k:
                with self.timers.timed("spec_round"):
                    with self._turn:
                        drafts, targets = generation.paged_spec_round(
                            self.model, self._draft, self._cache,
                            self._draft_cache, self._last, self._idx,
                            self._tables, self._spec_k,
                            temperature=self._temperature,
                            top_k=self._top_k, top_p=self._top_p,
                            generator=self._generator,
                            attn_impl=self.attn_impl)
                    # the per-round host sync
                    drafts = drafts.cpu().numpy()
                    targets = targets.cpu().numpy()
            else:
                with self.timers.timed("decode_step"):
                    with self._turn:
                        if self._paged:
                            toks = generation.paged_decode_step(
                                self.model, self._cache, self._last,
                                self._idx, self._tables,
                                temperature=self._temperature,
                                top_k=self._top_k, top_p=self._top_p,
                                generator=self._generator,
                                attn_impl=self.attn_impl)
                        else:
                            toks = generation.decode_step(
                                self.model, self._cache, self._last,
                                self._idx, temperature=self._temperature,
                                top_k=self._top_k, top_p=self._top_p,
                                generator=self._generator)
                    toks = toks.cpu().numpy()  # the per-step host sync
            t1 = time.monotonic()
            self._step_ewma = self._ewma(self._step_ewma, t1 - t0)
            self.histograms["decode_step"].observe(t1 - t0)
            # engine-row span (tid 0): the step this round's tokens
            # came from
            self.flight.span("decode_step", t0, t1, active=len(active),
                             step=steps)
            steps += 1
            self.counters.inc("decode_steps")
            with self.timers.timed("host_schedule"):
                if self._spec_k:
                    delivered = self._spec_deliver(active, drafts, targets)
                else:
                    for s in active:
                        # the step wrote the fed token at _idx[s]:
                        # advance the cursor, then deliver the emission
                        self._idx[s] += 1
                        self._deliver(s, int(toks[s]))
                    delivered = len(active)
                self.counters.inc("tokens", delivered)
                # decode_tokens excludes prefill-emitted firsts, so
                # decode_tokens / decode_steps is the mean occupancy
                # (under speculation, tokens a round)
                self.counters.inc("decode_tokens", delivered)
                self.counters.gauge("slot_occupancy",
                                    len(self._active_slots()))

    def _spec_deliver(self, active, drafts, targets):
        """Token-matching acceptance and delivery of one round: ``a`` is
        the longest prefix where the draft's proposal equals the target's
        own pick, and the round emits ``targets[:a + 1]`` (the accepted
        picks and the correction), clamped to the request's window
        ``min(k, remaining)``. Every emitted token is a target pick: at
        temperature 0 the plain engine's argmax chain. Rejected
        positions' K/V lies past the new cursor, rewritten by the next
        round before any query can see it. The counters tally only the
        emittable window, so ``spec_rounds <= spec_proposed <= k *
        spec_rounds`` and ``spec_accepted <= spec_proposed``."""
        k = self._spec_k
        delivered = 0
        for s in active:
            handle = self._slot_req[s]
            window = min(k, max(1, handle.max_new_tokens
                                - len(handle._tokens)))
            a = 0
            while a < window and drafts[s, a] == targets[s, a]:
                a += 1
            self.counters.inc("spec_rounds")
            self.counters.inc("spec_proposed", window)
            self.counters.inc("spec_accepted", a)
            for tok in targets[s, :min(a + 1, window)]:
                if self._slot_req[s] is None:
                    break  # completed mid-window (EOS or length)
                self._idx[s] += 1
                self._deliver(s, int(tok))
                delivered += 1
        if active:
            self._tokens_round_ewma = self._ewma(
                self._tokens_round_ewma, delivered / len(active))
        return delivered

    def _fail_outstanding(self, err):
        """Fail every queued and in-flight handle (caller holds
        ``_cv``)."""
        failed = [self._slot_req[s] for s in self._active_slots()]
        for s in range(self.slots):
            self._slot_req[s] = None
            self._release_slot(s)
        failed.extend(self._queue)
        self._queue.clear()
        # KV jobs' client threads park on per-job events: wake them
        # with the same error
        for job in self._kv_jobs:
            job["error"] = err
            job["done"].set()
        self._kv_jobs.clear()
        for handle in failed:
            handle._finish(err)
            self.flight.instant("failed", trace=handle.trace,
                                error=str(err))
        # the loss ledger drain() reads: these requests were ADMITTED
        # and did not finish
        self._failed_requests += len(failed)
        self.counters.gauge("queue_depth", 0)
        self.counters.gauge("slot_occupancy", 0)

    def _publish_kv_gauges(self):
        """Refresh the pool gauges and roll the pool's monotonic tallies
        (prefix hits/misses, LRU evictions, generated-prefix
        registrations and hits) into the counters; zeros on a
        contiguous engine."""
        if not self._paged:
            for gauge in ("kv_blocks_total", "kv_blocks_free",
                          "kv_blocks_cached", "prefix_digest_chains",
                          "prefix_digest_truncated"):
                self.counters.gauge(gauge, 0)
            return
        stats = self._pool.stats()
        self.counters.gauge("kv_blocks_total", stats["total"])
        self.counters.gauge("kv_blocks_free", stats["free"])
        self.counters.gauge("kv_blocks_cached", stats["cached"])
        for counter, tally in (
                ("prefix_evictions", "evictions"),
                ("prefix_hit_blocks", "hits"),
                ("prefix_miss_blocks", "misses"),
                ("generated_prefix_registered", "generated_registered"),
                ("generated_prefix_hit_blocks", "generated_hits")):
            delta = stats[tally] - self._last_tallies.get(tally, 0)
            if delta > 0:
                self.counters.inc(counter, delta)
                self._last_tallies[tally] = stats[tally]

    def _publish_digest_gauges(self):
        """The prefix digest's gauges (chains published, truncation).
        The digest sorts every registered chain (milliseconds of host
        time at a full pool), so a snapshot hook computes it when the
        registry is read — a scrape — instead of on every pool change
        of every step."""
        dig = self._pool.prefix_digest()
        self.counters.gauge("prefix_digest_chains", len(dig["top"]))
        self.counters.gauge("prefix_digest_truncated",
                            1 if dig["truncated"] else 0)

    def _release_slot(self, slot):
        """Return a freed slot's blocks to the pool and park its table
        row on scratch and its cursor at 0 (a contiguous slot only parks
        its cursor)."""
        if not self._paged:
            self._idx[slot] = 0
            return
        if self._slot_blocks[slot]:
            self._pool.release(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
        self._tables[slot][:] = 0
        self._idx[slot] = 0
        self._slot_registered[slot] = 0
        self._publish_kv_gauges()

    def _register_generated(self, slot, handle):
        """Publish every not-yet-registered FULL block of ``slot``'s
        sequence into the prefix registry (a block decode filled holds
        the K/V of ``(prompt + emitted)[:block_end]``). Must run while
        the slot still holds its block references."""
        if not self.prefix_cache:
            return
        bs = self.kv_block_size
        full = min(int(self._idx[slot]) // bs, len(self._slot_blocks[slot]))
        if full <= self._slot_registered[slot]:
            return
        chain = handle.prompt + handle._tokens
        n_prompt = len(handle.prompt)
        for j in range(self._slot_registered[slot], full):
            end = (j + 1) * bs
            self._pool.register(
                chain, end, self._slot_blocks[slot][j],
                origin="prompt" if end <= n_prompt else "generated")
        self._slot_registered[slot] = full
        self._publish_kv_gauges()

    # -- KV-block shipping (disaggregation; run on the scheduler thread) --

    def export_prefix(self, tokens, src_epoch=None, timeout=30.0):
        """Pack ``tokens``'s resident full-block KV chain into wire
        buffers, the prefill tier's half of a shipment. Returns
        ``(buffers, meta)`` (:func:`kvship.pack` output and the header
        it embeds), or None when nothing is resident (a contiguous
        engine, or a prompt shorter than a block). The buffers carry the
        pool rows as stored, so the physical cost is exactly
        ``frames.frame_bytes(buffers)``. ``src_epoch`` is stamped into
        the header for the receiver's fence."""
        return self._kv_call({"kind": "export", "tokens": list(tokens),
                              "src_epoch": src_epoch}, timeout)

    def import_prefix(self, meta, rows, timeout=30.0):
        """Splice a shipment into this engine's pool: allocate, write
        the shipped rows (bytes as stored, no requantization), register
        the chain, so a greedy decode over it equals one that prefilled
        here. Blocks already resident are skipped (resident-chain
        dedupe), which makes a duplicate delivery a no-op. Raises
        :class:`SpliceRejected` on a geometry or dtype mismatch,
        malformed rows or pool pressure. Returns ``{"spliced_blocks",
        "skipped_blocks", "bytes"}`` (``bytes``: the novel rows only)."""
        return self._kv_call({"kind": "import", "meta": meta,
                              "rows": rows}, timeout)

    def _kv_call(self, job, timeout):
        """Queue a KV job for the scheduler thread and wait for its
        verdict (from any thread)."""
        job["done"] = threading.Event()
        job["error"] = None
        job["result"] = None
        with self._cv:
            if self._broken is not None:
                raise EngineFailed(
                    "engine failed: {}".format(self._broken))
            if self._stopping:
                raise EngineFailed("engine stopped")
            self._kv_jobs.append(job)
            self._cv.notify_all()
        if not job["done"].wait(timeout):
            raise TimeoutError("kv {} job not scheduled within {}s".format(
                job["kind"], timeout))
        if job["error"] is not None:
            raise job["error"]
        return job["result"]

    def _run_kv_job(self, job):
        """Run one drained KV job (scheduler thread, outside ``_cv``).
        An Exception fails only the job's waiter; anything else wakes
        the waiter and then takes the loop down."""
        try:
            if job["kind"] == "export":
                job["result"] = self._kv_export(job["tokens"],
                                                job.get("src_epoch"))
            else:
                job["result"] = self._kv_import(job["meta"], job["rows"])
        except BaseException as e:  # noqa: BLE001 - job-scoped verdict
            job["error"] = e
            if not isinstance(e, Exception):
                job["done"].set()
                raise
        job["done"].set()

    def _kv_export(self, tokens, src_epoch):
        if not self._paged:
            return None
        # walk and pin at once, so no block is recycled mid-gather
        chain = self._pool.resident_chain(tokens, acquire=True)
        if not chain:
            return None
        ids = [bid for bid, _ in chain]
        t0 = time.monotonic()
        try:
            with self.timers.timed("kv_pack"):
                rows = generation.gather_block_rows(self._cache, ids)
        finally:
            self._pool.release(ids)
        bs = self.kv_block_size
        meta = {"tokens": list(tokens)[:len(ids) * bs],
                "block_size": bs,
                "kv_dtype": self.kv_dtype,
                "origins": [origin for _, origin in chain],
                "src_replica": self.replica_id,
                "src_epoch": src_epoch}
        buffers = kvship.pack(meta, rows)
        self.flight.span("kv.pack", t0, time.monotonic(), blocks=len(ids),
                         bytes=frames.frame_bytes(buffers))
        return buffers, meta

    def _kv_import(self, meta, rows):
        if not self._paged:
            raise SpliceRejected("unpaged",
                                 "target engine has no block pool")
        bs = self.kv_block_size
        if int(meta.get("block_size") or 0) != bs:
            raise SpliceRejected(
                "block_size",
                "shipment block_size {!r} != pool block_size {}".format(
                    meta.get("block_size"), bs))
        if meta.get("kv_dtype") != self.kv_dtype:
            raise SpliceRejected(
                "kv_dtype",
                "shipment kv_dtype {!r} != pool kv_dtype {!r} — ship "
                "endpoints must share pool dtype (no requant on splice)"
                .format(meta.get("kv_dtype"), self.kv_dtype))
        tokens = list(meta.get("tokens") or ())
        n = len(tokens) // bs
        if n <= 0:
            return {"spliced_blocks": 0, "skipped_blocks": 0, "bytes": 0}
        rows = [(key, np.asarray(arr)) for key, arr in rows]
        for key, arr in rows:
            if arr.shape[:1] != (n,):
                raise SpliceRejected(
                    "malformed",
                    "row {!r} carries {} block(s), token chain spans {}"
                    .format(key, arr.shape[0] if arr.ndim else 0, n))
        origins = list(meta.get("origins") or ())
        origins += ["prompt"] * (n - len(origins))
        t0 = time.monotonic()
        # resident-chain dedupe: whatever prefix of the chain the pool
        # holds already (an earlier delivery, or local traffic) is
        # skipped, so a second splice never double-allocates
        skip = len(self._pool.resident_chain(tokens))
        if skip >= n:
            return {"spliced_blocks": 0, "skipped_blocks": n, "bytes": 0}
        try:
            ids = self._pool.alloc(n - skip)
        except paging.PoolExhausted as e:
            raise SpliceRejected("pool_exhausted", str(e))
        novel = [(key, arr[skip:n]) for key, arr in rows]
        try:
            with self.timers.timed("kv_splice"):
                generation.scatter_block_rows(self._cache, ids, novel)
        except ValueError as e:
            self._pool.release(ids)  # unregistered: back to the free list
            raise SpliceRejected("malformed", str(e))
        except Exception:
            self._pool.release(ids)
            raise
        for j, bid in enumerate(ids):
            # first writer wins: a link local traffic registered
            # meanwhile keeps its block, and ours returns to the free
            # list at the release below
            self._pool.register(tokens, (skip + j + 1) * bs, bid,
                                origin=origins[skip + j])
        # registered blocks park in the LRU, the state a locally
        # prefilled and released prefix is in: the follow-up admission
        # needs no disaggregation awareness
        self._pool.release(ids)
        self._publish_kv_gauges()
        n_bytes = sum(int(arr.nbytes) for _, arr in novel)
        self.flight.span("kv.splice", t0, time.monotonic(),
                         blocks=len(ids), bytes=n_bytes)
        with self._cv:
            self.kv_counters.inc("spliced_blocks", len(ids))
            self.kv_counters.inc("spliced_bytes", n_bytes)
        return {"spliced_blocks": len(ids), "skipped_blocks": skip,
                "bytes": n_bytes}

    def note_ship(self, blocks, n_bytes, seconds):
        """Record one confirmed shipment leaving this engine: physical
        wire bytes and wall time (handler threads write, so under
        ``_cv``)."""
        with self._cv:
            self.kv_counters.inc("ship_blocks", int(blocks))
            self.kv_counters.inc("ship_bytes", int(n_bytes))
            self.histograms["kv_ship_ms"].observe(seconds * 1000.0)

    def note_splice_failure(self, reason):
        """Count one refused or failed splice under its reason."""
        with self._cv:
            self._splice_failures[reason] = \
                self._splice_failures.get(reason, 0) + 1

    def splice_failures(self):
        """``{reason: count}`` snapshot."""
        with self._cv:
            return dict(self._splice_failures)

    def note_quota_rejection(self, tenant, requests=1):
        """Count quota refusals (429 QuotaExceeded); handler threads
        write, so under ``_cv``."""
        with self._cv:
            self._qos_quota_rejections[tenant] = \
                self._qos_quota_rejections.get(tenant, 0) + int(requests)

    def qos_tallies(self):
        """One consistent snapshot of the QoS counters for the metrics
        surface: ``{"admitted": {(tenant, class): n}, "preemptions":
        {(tenant, class): n}, "quota_rejections": {tenant: n},
        "tokens": {tenant: n}}``."""
        with self._cv:
            return {"admitted": dict(self._qos_admitted),
                    "preemptions": dict(self._qos_preemptions),
                    "quota_rejections": dict(self._qos_quota_rejections),
                    "tokens": dict(self._qos_tokens)}

    def _preempt(self, slot):
        """Free a slot's blocks (under pool exhaustion, or for a
        stronger waiting class) and requeue its request at the queue
        FRONT; it re-enters with a continuation
        prefill of prompt + emitted tokens, so its stream continues
        (token-identical at temperature 0)."""
        handle = self._slot_req[slot]
        self._slot_req[slot] = None
        self._release_slot(slot)
        now = time.monotonic()
        if handle._decode_t0 is not None:
            # close the decode-so-far segment: the preempted stage
            # starts here, not at the last decode step
            self.flight.span("decode", handle._decode_t0, now,
                             trace=handle.trace,
                             tokens=len(handle._tokens), preempted=True)
            handle._attr_spans.append(("decode", handle._decode_t0, now))
        handle._preempt_at = now
        with self._cv:
            self._queue.appendleft(handle)
            key = (handle.tenant, handle.priority)
            self._qos_preemptions[key] = \
                self._qos_preemptions.get(key, 0) + 1
            self.counters.gauge("queue_depth", len(self._queue))
        self.counters.inc("preemptions")
        self.flight.instant("preempt", trace=handle.trace,
                            tokens=len(handle._tokens))
        logger.info("preempted request after %d/%d tokens (kv pool "
                    "pressure); requeued at front", len(handle._tokens),
                    handle.max_new_tokens)

    def _grow_active_blocks(self):
        """Give every active slot the blocks this round's writes land
        in, allocating as sequences cross block boundaries: a plain step
        writes one position, a speculative round up to ``k``, so growth
        covers ``min(k, tokens the request can still emit)`` (a write
        past that is a rejected proposal no cursor will reach, and may
        land in scratch). Every fully written block is registered each
        round, since lookahead allocates ahead of the cursor. Under
        exhaustion the weakest class's YOUNGEST admission is preempted,
        so the oldest of the strongest class always progresses
        (``validate`` guarantees a lone request's worst case fits the
        pool)."""
        bs = self.kv_block_size
        look = self._spec_k or 1
        for s in sorted(self._active_slots(),
                        key=lambda v: self._slot_seq[v]):
            handle = self._slot_req[s]
            if handle is None:
                continue  # preempted by an earlier slot's growth
            self._register_generated(s, handle)
            cover = min(look, max(1, handle.max_new_tokens
                                  - len(handle._tokens)))
            need = min((int(self._idx[s]) + cover - 1) // bs + 1,
                       self._blocks_per_slot)
            while self._slot_req[s] is not None \
                    and len(self._slot_blocks[s]) < need:
                try:
                    with self.timers.timed("block_alloc"):
                        new_id = self._pool.alloc(1)[0]
                except paging.PoolExhausted:
                    # preempting s itself ends the while
                    self._preempt(max(self._active_slots(), key=lambda v: (
                        qos.priority_rank(self._slot_req[v].priority),
                        self._slot_seq[v])))
                    continue
                self._tables[s][len(self._slot_blocks[s])] = new_id
                self._slot_blocks[s].append(new_id)
            self._publish_kv_gauges()

    def _admit(self, slot, handle):
        """Prefill ``handle``'s prompt into ``slot`` and emit its first
        token (a ``max_new_tokens=1`` request completes here)."""
        if self._paged:
            return self._admit_paged(slot, handle)
        n = len(handle.prompt)
        bucket = generation.bucket_for(n, self.buckets)
        toks = np.zeros(bucket, np.int32)
        toks[:n] = handle.prompt
        t0 = time.monotonic()
        self._observe_queue_wait(handle, t0, slot)
        with self.timers.timed("prefill"), self._turn:
            first = int(generation.prefill_into_slot(
                self.model, self._cache, slot, toks, n,
                temperature=self._temperature, top_k=self._top_k,
                top_p=self._top_p, generator=self._generator))
        self._observe_prefill(handle, t0, time.monotonic(), bucket, n)
        self.counters.inc("prefills")
        self._idx[slot] = n
        self._last[slot] = first
        self._deliver(slot, first)
        self.counters.inc("tokens")

    def _observe_queue_wait(self, handle, now, slot):
        """Queue-wait metrics and span for a request's FIRST admission;
        a preemption re-entry records its time out of the slot as a
        ``preempted`` span instead."""
        if handle._decode_t0 is None:
            wait = now - handle.submitted
            self.histograms["queue_wait"].observe(wait)
            self._hist_qwait_class.get(
                handle.priority,
                self._hist_qwait_class[qos.DEFAULT_PRIORITY]).observe(wait)
            self._qwait_ewma = self._ewma(self._qwait_ewma, wait)
            self.flight.span("queue", handle.submitted, now,
                             trace=handle.trace, slot=slot)
            handle._attr_spans.append(("queue", handle.submitted, now))
        elif handle._preempt_at is not None:
            self.flight.span("preempted", handle._preempt_at, now,
                             trace=handle.trace, slot=slot)
            handle._attr_spans.append(("preempted", handle._preempt_at,
                                       now))

    def _observe_prefill(self, handle, t0, t1, bucket, n, prefix_blocks=0):
        self._prefill_ewma = self._ewma(self._prefill_ewma, t1 - t0)
        self.flight.span("prefill", t0, t1, trace=handle.trace,
                         bucket=bucket, prompt_len=n,
                         prefix_blocks=prefix_blocks)
        handle._attr_spans.append(("prefill", t0, t1))
        handle._decode_t0 = t1

    def _admit_paged(self, slot, handle):
        """Paged admission: point the slot's table at resident shared
        prefix blocks, allocate private blocks for the rest, prefill
        only the un-shared tail, and emit the first token. Also the
        preemption re-entry path (prompt + emitted tokens)."""
        full = handle.prompt + handle._tokens
        n = len(full)
        bs = self.kv_block_size
        shared = []
        if self.prefix_cache:
            with self.timers.timed("prefix_lookup"):
                # a preemption continuation re-walks onto its own
                # blocks: not multi-turn reuse, so not counted as such
                shared = self._pool.match_prefix(
                    full, count_generated=handle._decode_t0 is None)
        start = len(shared) * bs
        with self.timers.timed("block_alloc"):
            # acquire BEFORE alloc: an LRU-resident shared block must
            # not be evicted by this very admission's alloc
            self._pool.acquire(shared)
            try:
                new_ids = self._pool.alloc(
                    self._pool.blocks_for(n) - len(shared))
            except paging.PoolExhausted:
                self._pool.release(shared)
                raise
        ids = list(shared) + new_ids
        self._slot_blocks[slot] = ids
        row = self._tables[slot]
        row[:] = 0
        row[:len(ids)] = ids
        self._slot_seq[slot] = next(self._admit_seq)
        tail = full[start:]
        try:
            bucket = generation.bucket_for(len(tail), self.buckets)
        except ValueError:
            # a continuation's prompt+generated tail can outgrow custom
            # buckets (validate vets only the original prompt)
            bucket = self.total_len
        toks = np.zeros(bucket, np.int32)
        toks[:len(tail)] = tail
        t0 = time.monotonic()
        self._observe_queue_wait(handle, t0, slot)
        with self.timers.timed("prefill"), self._turn:
            first = int(generation.paged_prefill_into_slot(
                self.model, self._cache, row, toks, len(tail), start,
                temperature=self._temperature, top_k=self._top_k,
                top_p=self._top_p, generator=self._generator,
                attn_impl=self.attn_impl))
        self._observe_prefill(handle, t0, time.monotonic(), bucket, n,
                              prefix_blocks=len(shared))
        self.counters.inc("prefills")
        if self._spec_k:
            # mirror the tail into the draft's pool: the draft attends
            # the same prefix through the same table row (a prefix hit
            # skips both prefills; shared blocks were mirrored when
            # their writer prefilled or decoded them). Its pick is
            # dropped: this call is for its writes.
            with self.timers.timed("draft_prefill"):
                with self._turn:
                    generation.paged_prefill_into_slot(
                        self._draft, self._draft_cache, row, toks,
                        len(tail), start, attn_impl=self.attn_impl)
        if self.prefix_cache:
            # publish every FULL block of the admitted sequence; blocks
            # past the original prompt exist only on preemption re-entry
            for j in range(n // bs):
                end = (j + 1) * bs
                self._pool.register(
                    full, end, ids[j],
                    origin="prompt" if end <= len(handle.prompt)
                    else "generated")
            self._slot_registered[slot] = n // bs
        else:
            self._slot_registered[slot] = 0
        self._publish_kv_gauges()
        self._idx[slot] = n
        self._last[slot] = first
        self._deliver(slot, first)
        self.counters.inc("tokens")

    def _deliver(self, slot, token):
        """Append one emitted token to the slot's request; complete and
        free the slot on EOS or length. ``_idx[slot]`` always holds the
        position where ``_last[slot]`` is written by the NEXT step."""
        handle = self._slot_req[slot]
        handle._emit(token)
        now = time.monotonic()
        if handle._last_emit_at is None:
            self.histograms["ttft"].observe(now - handle.submitted,
                                            trace=handle.trace)
        else:
            self.histograms["token"].observe(now - handle._last_emit_at,
                                             trace=handle.trace)
        handle._last_emit_at = now
        self._last[slot] = token
        # QoS usage, post-paid at ACTUAL delivery (a dedup-replayed
        # retry delivers nothing, so it is never charged twice)
        self._quota.charge(handle.tenant, 1)
        with self._cv:
            self._qos_tokens[handle.tenant] = \
                self._qos_tokens.get(handle.tenant, 0) + 1
        done = (self.eos_token is not None and token == self.eos_token) \
            or len(handle._tokens) >= handle.max_new_tokens
        if done:
            if self._paged:
                # a sequence can finish with its last decode-filled
                # block complete: publish it before the slot releases it
                self._register_generated(slot, handle)
            handle._finish()
            self._slot_req[slot] = None
            self._release_slot(slot)
            self.counters.inc("requests_completed")
            self._trace_finish(handle, "finish")
            # a tenant that went fully idle drops its deficit counter
            # (the table stays bounded by live tenants)
            with self._cv:
                live = any(h.tenant == handle.tenant for h in self._queue) \
                    or any(self._slot_req[s] is not None
                           and self._slot_req[s].tenant == handle.tenant
                           for s in range(self.slots))
                if not live:
                    self._qos_sched.forget(handle.tenant)
        elif chaos.on_token(len(handle._tokens)):
            # chaos disconnect_client_at_token: the client vanished
            # mid-stream; eviction lands at the next step boundary
            handle.cancel()


class _BadRequest(ValueError):
    """A malformed request body (HTTP 400)."""


def _as_array(name, value):
    """Client JSON column -> ndarray; ragged/mistyped rows are a 400.

    ``np.asarray`` turns rows of differing lengths into a ValueError (or
    a dtype=object array that would fail inside the apply) — both are
    the client's malformed request, not a server fault."""
    try:
        arr = np.asarray(value)
    except ValueError as e:
        raise _BadRequest("input %r is ragged or mistyped: %s" % (name, e))
    if arr.dtype == object:
        raise _BadRequest(
            "input %r rows have inconsistent shapes or types" % name)
    if arr.dtype.kind in "USV":
        # mixed numeric/string rows coerce to a numpy str dtype; the
        # exported apply_fn takes no string tensors
        raise _BadRequest(
            "input %r is non-numeric (dtype %s)" % (name, arr.dtype))
    return arr


def _to_batch(payload, signature):
    """TF-Serving request JSON -> {name: ndarray} batch dict."""
    if not isinstance(payload, dict):
        raise _BadRequest("request body must be a JSON object")
    if "instances" in payload:
        rows = payload["instances"]
        if not isinstance(rows, list) or not rows:
            raise _BadRequest("'instances' must be a non-empty list")
        if isinstance(rows[0], dict):
            names = rows[0].keys()
            cols = {n: [] for n in names}
            for i, row in enumerate(rows):
                if not isinstance(row, dict) or row.keys() != names:
                    raise _BadRequest(
                        "instance %d keys differ from instance 0" % i)
                for n in names:
                    cols[n].append(row[n])
        else:
            # single unnamed input: take the signature's (or 'x')
            inputs = signature.get("inputs") or ["x"]
            if len(inputs) != 1:
                raise _BadRequest(
                    "unnamed instances need a single-input signature")
            cols = {inputs[0]: rows}
        return {n: _as_array(n, v) for n, v in cols.items()}
    if "inputs" in payload:
        cols = payload["inputs"]
        if isinstance(cols, dict):
            return {n: _as_array(n, v) for n, v in cols.items()}
        inputs = signature.get("inputs") or ["x"]
        if len(inputs) != 1:
            raise _BadRequest("unnamed inputs need a single-input signature")
        return {inputs[0]: _as_array(inputs[0], cols)}
    raise _BadRequest("request needs 'instances' or 'inputs'")


def _listify(x):
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:  # numpy has no bfloat16
            x = x.float()
        x = x.detach().cpu().numpy()
    return np.asarray(x).tolist()


def _to_json(outputs, row_format):
    """apply_fn outputs (tensors or arrays) -> TF-Serving response dict."""
    if isinstance(outputs, dict):
        cols = {k: _listify(v) for k, v in outputs.items()}
    elif isinstance(outputs, (tuple, list)):
        cols = {"output_%d" % i: _listify(v) for i, v in enumerate(outputs)}
    else:
        cols = {"output": _listify(outputs)}
    if not row_format:
        return {"outputs": cols if len(cols) > 1
                else next(iter(cols.values()))}
    names = list(cols)
    n = len(cols[names[0]])
    if len(names) == 1:
        return {"predictions": cols[names[0]]}
    return {"predictions": [
        {name: cols[name][i] for name in names} for i in range(n)]}


def _slice_outputs(outputs, lo, hi):
    """Row-slice an apply_fn result of any supported shape."""
    if isinstance(outputs, dict):
        return {k: v[lo:hi] for k, v in outputs.items()}
    if isinstance(outputs, (tuple, list)):
        return type(outputs)(v[lo:hi] for v in outputs)
    return outputs[lo:hi]


class _Batcher(object):
    """Cross-request batching window for the card's benefit.

    The first request opens a ``window_ms`` collection period; every
    request that arrives in it with the SAME input signature (names,
    trailing dims, dtypes) is concatenated along axis 0 into ONE apply
    call (up to ``max_batch`` rows), and the outputs are split back per
    request. A request with another signature runs in its own group, so
    batching changes the call count, not what a row computes. A single
    request larger than ``max_batch`` runs alone at its own size.
    ``apply`` is ``batch -> outputs`` (the server binds the variables
    and ``torch.inference_mode``).
    """

    def __init__(self, apply, window_ms, max_batch=64, submit_timeout=600.0):
        self._apply = apply
        self._window_s = window_ms / 1000.0
        self._max_batch = max_batch
        self._submit_timeout = submit_timeout
        self._stopping = False
        self._q = queue_mod.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tfos-torch-batcher")
        self._thread.start()

    def submit(self, batch):
        """Blocking: returns this request's slice of the batched outputs.

        The batch's SHAPE is validated here, before it can reach the
        shared batcher thread: an empty dict or a 0-d input would fail
        the whole group. The wait is bounded, so a dead batcher surfaces
        as per-request errors, never as hung clients."""
        if not batch:
            raise _BadRequest("empty input batch")
        lens = set()
        for k, v in batch.items():
            if getattr(v, "ndim", 0) < 1:
                raise _BadRequest(
                    "input %r is 0-d; batchable inputs need a leading "
                    "batch axis" % k)
            lens.add(len(v))
        if len(lens) != 1:
            raise _BadRequest(
                "inputs disagree on batch size: %s" % sorted(lens))
        if self._stopping:
            raise RuntimeError("server is stopping")
        done = threading.Event()
        item = {"batch": batch, "done": done}
        self._q.put(item)
        if not done.wait(self._submit_timeout):
            raise RuntimeError(
                "batched predict timed out after {}s".format(
                    self._submit_timeout))
        if "error" in item:
            raise item["error"]
        return item["out"]

    @staticmethod
    def _sig(batch):
        return tuple(sorted((k, v.shape[1:], str(v.dtype))
                            for k, v in batch.items()))

    @staticmethod
    def _rows(item):
        return len(next(iter(item["batch"].values())))

    def _loop(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            group = [first]
            try:
                deadline = time.monotonic() + self._window_s
                sig = self._sig(first["batch"])
                group_rows = self._rows(first)
                passed_on = []
                while group_rows < self._max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=left)
                    except queue_mod.Empty:
                        break
                    if nxt is None:
                        passed_on.append(None)
                        break
                    if (self._sig(nxt["batch"]) == sig and
                            group_rows + self._rows(nxt) <=
                            self._max_batch):
                        group.append(nxt)
                        group_rows += self._rows(nxt)
                    else:
                        passed_on.append(nxt)  # next round
                for item in passed_on:
                    self._q.put(item)
            except Exception as e:  # noqa: BLE001 - never kill the loop
                for item in group:
                    item["error"] = e
                    item["done"].set()
                continue
            self._run_group(group)

    def _run_group(self, group):
        try:
            rows = [self._rows(i) for i in group]
            if len(group) == 1:
                merged = group[0]["batch"]
            else:
                names = group[0]["batch"].keys()
                merged = {n: np.concatenate([i["batch"][n] for i in group])
                          for n in names}
            outputs = self._apply(merged)
            if len(group) == 1:
                group[0]["out"] = outputs
            else:
                lo = 0
                for item, n in zip(group, rows):
                    item["out"] = _slice_outputs(outputs, lo, lo + n)
                    lo += n
        except Exception as e:  # noqa: BLE001 - delivered per request
            for item in group:
                item["error"] = e
        finally:
            for item in group:
                item["done"].set()

    def stop(self):
        self._stopping = True
        self._q.put(None)
        self._thread.join(timeout=10)
        # a request that raced stop() past the sentinel would wait its
        # full submit timeout; fail it now instead
        while True:
            try:
                item = self._q.get(False)
            except queue_mod.Empty:
                break
            if item is not None:
                item["error"] = RuntimeError("server stopped")
                item["done"].set()


class ModelServer(object):
    """HTTP server, TF-Serving REST shaped, over ``http.server`` (one
    thread per connection): an exported model behind ``:predict`` and
    the model routes, and/or a :class:`DecodeEngine` behind
    ``:generate``.

    ``model_dir``: an export of ``export.save_model`` (None for an
    engine-only server). ``batch_window_ms``: 0 serves each
    ``:predict`` as its own apply call behind one lock; > 0 coalesces
    concurrent same-signature requests inside the window
    (:class:`_Batcher`). ``replica_id``: the server's stable serving
    identity (default: the mounted engine's). ``dedup_capacity`` /
    ``dedup_ttl_s`` bound the ``X-TFOS-Request-Id`` replay window
    (:class:`DedupWindow`). ``device``: where the export's variables
    load (:func:`device_info.default_device`: the card unless
    ``"cpu"``). The engine, when given, is the caller's to stop
    (:meth:`drain` stops it, through the engine's own drain).
    """

    def __init__(self, model_dir, name="model", host="127.0.0.1",
                 port=8501, batch_window_ms=0, engine=None, replica_id=None,
                 dedup_capacity=2048, dedup_ttl_s=120.0, device=None):
        from tensorflowonspark_tpu_torch import export as export_lib

        if model_dir is not None:
            apply_fn, variables, signature = export_lib.load_model(
                model_dir, device=device)
        elif engine is None:
            raise ValueError("ModelServer needs a model_dir, an engine, "
                             "or both")
        else:  # engine-only server: :generate is the whole surface
            apply_fn, variables, signature = None, None, {}
        self.name = str(name)
        self.signature = signature or {}
        self._apply_fn = apply_fn
        self._variables = variables
        self._lock = threading.Lock()  # one owner: requests serialize
        self._batcher = (_Batcher(self._apply, batch_window_ms)
                         if batch_window_ms and apply_fn is not None
                         else None)
        self.engine = engine
        self._replica_id = None if replica_id is None else str(replica_id)
        #: ``:predict`` apply calls made (one per batcher group)
        self.apply_calls = 0
        self._host = host
        self._port = int(port)
        self._httpd = None
        self._thread = None
        #: set by :meth:`mark_unhealthy` (a supervisor or any operator
        #: hook); /healthz then answers 503
        self._unhealthy = None
        #: lease-fencing latch: while set, :generate / :predict /
        #: :prefill answer 410 ``kind: "Fenced"`` and /healthz 503
        #: ``status: "fenced"``
        self._fenced = None
        #: idempotent dispatch: the replay window keyed on
        #: ``X-TFOS-Request-Id`` (server-level, so it survives
        #: :meth:`attach_engine`)
        self._dedup = DedupWindow(capacity=dedup_capacity,
                                  ttl_s=dedup_ttl_s)
        self._dedup_hits = 0
        self._dedup_joined = 0
        self._dedup_obs_lock = threading.Lock()
        #: graceful-drain latch; the lock and memo make drain()
        #: idempotent (a second caller returns the first one's verdict)
        self._draining = False
        self._drain_lock = threading.Lock()
        self._drain_result = None
        #: POST requests inside a handler: drain waits for their
        #: responses to be written
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        #: ``POST /admin/<name>`` -> ``fn(payload) -> response``
        #: (:meth:`register_admin`); 404 for the rest of /admin/
        self._admin = {}
        # splice fence floors: replica id -> the epoch a shipment from it
        # must exceed (raised by /admin/ship_fence, never lowered)
        self._ship_fence = {}
        self._ship_fence_lock = threading.Lock()
        self.register_admin("ship_fence", self._admin_ship_fence)
        #: control-epoch floor: the admin-plane fence. A stamped admin
        #: call (``X-TFOS-Control-Epoch``) below it is refused 409
        #: ``kind: "ControlFenced"``; the floor rises to every admitted
        #: stamp and to ``/admin/control_fence`` broadcasts
        self._control_epoch = 0
        self._control_lock = threading.Lock()
        self._control_counters = tracing.Counters()
        self.register_admin("control_fence", self._admin_control_fence)

    @property
    def replica_id(self):
        """The server's stable serving identity: the explicit one, else
        the mounted engine's (stable across ``respawn()``), else None."""
        if self._replica_id is not None:
            return self._replica_id
        return getattr(self.engine, "replica_id", None)

    def _apply(self, batch):
        # called by the batcher's thread or under self._lock: serialized
        self.apply_calls += 1
        with torch.inference_mode():
            return self._apply_fn(self._variables, batch)

    @property
    def address(self):
        """``(host, port)`` the server listens on (after :meth:`start`)."""
        return self._host, self._port

    def predict(self, payload):
        """``{"instances"|"inputs": ...}`` -> TF-Serving response dict."""
        if self._apply_fn is None:
            raise _BadRequest(
                "no exported model mounted; this server only serves "
                ":generate (decode engine)")
        row_format = "instances" in payload
        batch = _to_batch(payload, self.signature)
        if self._batcher is not None:
            outputs = self._batcher.submit(batch)
        else:
            with self._lock:
                outputs = self._apply(batch)
        return _to_json(outputs, row_format)

    def status(self):
        return {"model_version_status": [{
            "version": "1", "state": "AVAILABLE",
            "status": {"error_code": "OK", "error_message": ""}}]}

    def metadata(self):
        from tensorflowonspark_tpu_torch import export as export_lib

        return {"model_spec": {"name": self.name,
                               "signature_name": "serving_default"},
                "metadata": {"signature_def": self.signature,
                             "format": export_lib._FORMAT}}

    def generate(self, payload, client_gone=None, trace=None,
                 request_id=None):
        """Idempotent ``:generate``: with a ``request_id`` (a router's
        ``X-TFOS-Request-Id``, reused by every retry of one client
        request) a request this server already answered is replayed
        from the stored response (a dedup hit), and one still executing
        is joined (the retry waits on the original) instead of running
        twice; a failed execution is withdrawn, so a later retry runs
        clean. Without one it is a plain execution
        (:meth:`_generate_once`). Raises :class:`Fenced` while the
        server is fenced."""
        if self._fenced is not None:
            raise Fenced("replica is fenced: " + self._fenced)
        if request_id is None:
            return self._generate_once(payload, client_gone, trace)
        entry, owner = self._dedup.begin(request_id)
        if not owner:
            hit = entry.done.is_set()
            with self._dedup_obs_lock:
                if hit:
                    self._dedup_hits += 1
                else:
                    self._dedup_joined += 1
                counters = getattr(self.engine, "counters", None)
                if counters is not None:
                    counters.inc("dedup_hits" if hit else "dedup_joined")
            logger.info("request %s deduplicated (%s)", request_id,
                        "replayed" if hit else "joined in-flight")
            deadline = time.monotonic() + 600.0
            while not entry.done.wait(0.05):
                if client_gone is not None and client_gone():
                    # OUR client vanished; the owner's may not have —
                    # never cancel the original's work from here
                    raise Cancelled(
                        "client disconnected while joined to an "
                        "in-flight duplicate")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        "joined in-flight duplicate did not complete "
                        "within 600s")
            if entry.error is not None:
                raise entry.error
            return entry.response
        try:
            out = self._generate_once(payload, client_gone, trace)
        except BaseException as e:
            # transient failures are not cached: a later retry re-runs
            self._dedup.fail(request_id, entry, e)
            raise
        self._dedup.complete(request_id, entry, out)
        return out

    def _generate_once(self, payload, client_gone=None, trace=None):
        """``{"prompt": [[...], ...] or [...], "max_new_tokens": N,
        "deadline_s"?, "session"?, "tenant"?, "priority"?}`` ->
        ``{"tokens": ...}`` (prompt + generated tokens per prompt; a
        flat prompt is answered un-nested). The whole body is vetted
        before any of it is queued, and queued atomically; a malformed
        ``session`` / ``tenant`` / ``priority`` is a 400. ``trace``
        adopts an external trace id for the body's spans."""
        engine = self.engine
        if engine is None:
            raise _BadRequest("no decode engine mounted; this server only "
                              "serves :predict")
        if not isinstance(payload, dict) or "prompt" not in payload:
            raise _BadRequest("request needs a 'prompt' field")
        prompts = payload["prompt"]
        if not isinstance(prompts, list) or not prompts:
            raise _BadRequest("'prompt' must be a non-empty list")
        flat = not isinstance(prompts[0], (list, tuple))
        if flat:
            prompts = [prompts]
        try:
            max_new = int(payload.get("max_new_tokens", 16))
        except (TypeError, ValueError):
            raise _BadRequest("max_new_tokens must be an integer")
        deadline_s = payload.get("deadline_s")
        if deadline_s is not None:
            try:
                deadline_s = float(deadline_s)
            except (TypeError, ValueError):
                raise _BadRequest("deadline_s must be a number")
            if not deadline_s > 0:
                raise _BadRequest("deadline_s must be > 0")
        session = payload.get("session")
        if session is not None and not isinstance(session, str):
            raise _BadRequest("session must be a string")
        try:
            tenant = qos.validate_tenant(payload.get("tenant"))
            priority = qos.validate_priority(payload.get("priority"))
        except (TypeError, ValueError) as e:
            raise _BadRequest(str(e))
        try:
            vetted = [engine.validate(p, max_new) for p in prompts]
        except (ValueError, TypeError) as e:
            raise _BadRequest(str(e))
        handles = engine._submit_many(vetted, deadline_s=deadline_s,
                                      trace=trace, session=session,
                                      tenant=tenant, priority=priority)
        try:
            tokens = [self._await_handle(h, handles, client_gone)
                      for h in handles]
        except BaseException:
            # an error answers the WHOLE body: stop its siblings
            for h in handles:
                h.cancel()
            raise
        return {"tokens": tokens[0] if flat else tokens}

    @staticmethod
    def _await_handle(handle, body, client_gone, poll_s=0.05,
                      timeout=600.0):
        """``result()`` that also watches the client's socket: a client
        that disconnected cancels the whole body's requests."""
        if client_gone is None:
            return handle.result(timeout)
        deadline = time.monotonic() + timeout
        while not handle._done.wait(poll_s):
            if client_gone():
                for h in body:
                    h.cancel()
                raise Cancelled("client disconnected")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "generation did not complete within {}s".format(
                        timeout))
        return handle.result(0.1)

    def prefill(self, payload, trace=None):
        """``POST :prefill``, the prefill tier's entry point: ``{"prompt":
        [t, ...], "session"?, "src_epoch"?, "ship"?: {"addr": "host:port",
        "replica_id"?}}``. The prompt runs through the normal admission
        path as a one-token generation (bucketing, prefix registration),
        then its resident block chain is exported and, when ``ship``
        names a decode peer, delivered to that peer's ``/kv/splice``. A
        failed shipment is not a failed request: the answer is 200 with
        ``shipped: false`` and a ``reason``, no bytes are accounted, and
        the decode side prefills cold."""
        engine = self.engine
        if engine is None:
            raise _BadRequest("no decode engine mounted on this server")
        if self._fenced is not None:
            raise Fenced("replica is fenced: " + self._fenced)
        if not isinstance(payload, dict) or "prompt" not in payload:
            raise _BadRequest("request needs a 'prompt' field")
        prompt = payload["prompt"]
        if not isinstance(prompt, list) or not prompt \
                or isinstance(prompt[0], (list, tuple)):
            raise _BadRequest(":prefill takes ONE flat token list")
        session = payload.get("session")
        if session is not None and not isinstance(session, str):
            raise _BadRequest("session must be a string")
        try:
            vetted = engine.validate(prompt, 1)
        except (ValueError, TypeError) as e:
            raise _BadRequest(str(e))
        engine._submit_many([vetted], trace=trace,
                            session=session)[0].result(600.0)
        out = {"prefilled": True, "blocks": 0, "shipped": False}
        export = engine.export_prefix(vetted[0],
                                      src_epoch=payload.get("src_epoch"))
        if export is None:
            return out  # nothing resident to ship (sub-block prompt)
        buffers, meta = export
        out["blocks"] = len(meta["origins"])
        ship = payload.get("ship")
        if not isinstance(ship, dict) or not ship.get("addr"):
            return out
        n_bytes = frames.frame_bytes(buffers)
        t0 = time.monotonic()
        try:
            status, body, transport = kvship.ship(
                ship["addr"], buffers, src=self.replica_id,
                dst=ship.get("replica_id"))
        except (kvship.ShipError, chaos.NetPartitioned) as e:
            out["reason"] = str(e)
            return out
        t1 = time.monotonic()
        if status != 200:
            try:
                out["reason"] = json.loads(body).get("error", "")
            except (ValueError, AttributeError):
                out["reason"] = "splice answered {}".format(status)
            return out
        # accounted only on a confirmed splice: a dropped response
        # raised above, and bytes are never claimed for a delivery this
        # side cannot prove
        engine.note_ship(out["blocks"], n_bytes, t1 - t0)
        engine.flight.span("kv.ship", t0, t1, trace=trace or 0,
                           blocks=out["blocks"], bytes=n_bytes,
                           transport=transport)
        out.update(shipped=True, bytes=n_bytes, transport=transport)
        try:
            out["splice"] = json.loads(body)
        except ValueError:
            pass
        return out

    def splice_shipment(self, meta, rows):
        """Fence-check one unpacked shipment, then splice it into the
        mounted engine (the body of ``POST /kv/splice``). Every refusal
        counts in the engine's ``splice_failures()`` by reason."""
        engine = self.engine
        if engine is None:
            raise SpliceRejected("engine", "no decode engine mounted")
        src = meta.get("src_replica")
        epoch = meta.get("src_epoch")
        with self._ship_fence_lock:
            floor = None if src is None else self._ship_fence.get(str(src))
        if floor is not None and (epoch is None or int(epoch) <= floor):
            # a shipment from a replaced incarnation never splices
            engine.note_splice_failure("fenced")
            raise SpliceRejected(
                "fenced",
                "shipment from {} at epoch {} is below fence floor {}"
                .format(src, epoch, floor))
        try:
            return engine.import_prefix(meta, rows)
        except SpliceRejected as e:
            engine.note_splice_failure(e.reason)
            raise
        except (Retriable, TimeoutError):
            engine.note_splice_failure("engine")
            raise

    def ship_fence(self, replica_id, min_epoch):
        """Raise the splice fence floor for shipments claiming
        ``replica_id`` (monotonic: a floor never lowers); ``POST
        /admin/ship_fence``."""
        rid = str(replica_id)
        with self._ship_fence_lock:
            cur = self._ship_fence.get(rid)
            if cur is None or int(min_epoch) > cur:
                self._ship_fence[rid] = int(min_epoch)
            floor = self._ship_fence[rid]
        logger.info("ship fence: shipments from %s now need epoch > %d",
                    rid, floor)
        return {"replica_id": rid, "min_epoch": floor}

    def _admin_ship_fence(self, payload):
        if not isinstance(payload, dict) or \
                payload.get("replica_id") is None:
            raise _BadRequest("ship_fence needs a replica_id")
        return self.ship_fence(payload["replica_id"],
                               payload.get("min_epoch", 0))

    # -- control-epoch fence ----------------------------------------------

    def admit_control_epoch(self, epoch):
        """Admission check and adoption for a stamped admin RPC's control
        epoch: a stamp at or above the floor is admitted and raises the
        floor to it; one below is refused (the caller is a deposed
        driver). Returns ``(admitted, floor)``; the floor never lowers."""
        epoch = int(epoch)
        with self._control_lock:
            if epoch >= self._control_epoch:
                self._control_epoch = epoch
                return True, epoch
            self._control_counters.inc("admin_rejections")
            floor = self._control_epoch
        self._mount_control_counters()
        logger.warning(
            "refusing admin RPC stamped control epoch %d < floor %d "
            "(caller is a deposed driver)", epoch, floor)
        return False, floor

    def control_epoch_floor(self):
        """Current admin-plane control-epoch floor (0: no stamped call
        seen yet — every stamp is admitted)."""
        with self._control_lock:
            return self._control_epoch

    def _admin_control_fence(self, payload):
        """``POST /admin/control_fence {"control_epoch": N}``: raises the
        floor like any admitted stamp; idempotent and monotonic."""
        if not isinstance(payload, dict) or \
                payload.get("control_epoch") is None:
            raise ValueError("control_fence needs a control_epoch")
        epoch = int(payload["control_epoch"])
        with self._control_lock:
            if epoch > self._control_epoch:
                self._control_epoch = epoch
            floor = self._control_epoch
        logger.info("control fence: admin RPCs now need control epoch "
                    ">= %d", floor)
        return {"control_epoch": floor}

    def _mount_control_counters(self):
        """Expose the control-plane counters
        (``tfos_control_admin_rejections_total``) on the current
        engine's registry; idempotent, re-mounted on every rejection so
        a respawned engine's registry picks them up."""
        metrics = getattr(self.engine, "metrics", None)
        if metrics is not None:
            metrics.add_counters("tfos_control", self._control_counters)

    def register_admin(self, name, fn):
        """Mount ``fn(payload_dict) -> response_dict`` as ``POST
        /admin/<name>``. Admin routes bypass the fenced and draining
        gates: the RPCs that resolve those states must stay reachable."""
        self._admin[str(name)] = fn

    # -- health -------------------------------------------------------------

    def attach_engine(self, engine):
        """(Re-)arm ``:generate`` with ``engine`` (a respawned one) and
        clear any unhealthy mark."""
        self.engine = engine
        self._unhealthy = None
        logger.info("serving re-armed with a fresh decode engine")

    def mark_unhealthy(self, reason):
        """Flip /healthz to 503 (an operator or supervisor hook)."""
        self._unhealthy = str(reason)
        logger.error("serving marked unhealthy: %s", reason)

    def fence(self, reason):
        """Refuse to serve: this replica's lease epoch was superseded.
        ``:generate`` / ``:predict`` / ``:prefill`` answer 410 ``kind:
        "Fenced"`` (non-retriable: go to the current holder) and
        /healthz 503 ``status: "fenced"``. The engine keeps running (its
        in-flight work finishes)."""
        self._fenced = str(reason)
        logger.error("serving FENCED: %s", reason)

    def unfence(self):
        """Clear the fenced latch (a fresh lease epoch was acquired)."""
        self._fenced = None
        logger.info("serving unfenced (fresh lease epoch)")

    def healthz(self):
        """``(status, body)`` for ``GET /healthz``: 503 when fenced
        (outranks everything), draining (a distinct ``status:
        "draining"``), the engine's scheduler is dead, or the server was
        marked unhealthy; else 200. The body carries the engine's
        liveness, its queue and slot gauges, counts, pool and kernel
        configuration (and, beyond the reference's keys, the engine's
        ``device``), and the dedup window."""
        body = {"status": "ok", "model": self.name}
        rid = self.replica_id
        if rid is not None:
            body["replica_id"] = rid
        with self._dedup_obs_lock:
            body["dedup"] = dict(self._dedup.stats(),
                                 hits=self._dedup_hits,
                                 joined=self._dedup_joined)
        if self._fenced is not None:
            body["status"] = "fenced"
            body["reason"] = self._fenced
            return 503, body
        engine = self.engine
        if engine is not None:
            health = engine.healthy()
            snap = engine.counters.snapshot()
            body["engine"] = health
            body["queue_depth"] = snap["gauges"].get("queue_depth", 0)
            body["slot_occupancy"] = snap["gauges"].get("slot_occupancy",
                                                        0)
            body["counts"] = snap["counts"]
            # getattr: supervision fakes duck-type only healthy() +
            # counters, and a health probe must not 500 over a gauge
            load_stats = getattr(engine, "load_stats", None)
            if callable(load_stats):
                load = load_stats()
                # "device" is the port's one key beyond the reference's
                # body: where the engine runs (the card, or a CPU asked
                # for)
                for key in ("device", "kv_blocks_total", "kv_blocks_free",
                            "prefix_hit_rate", "attn_impl",
                            "generated_prefix_hit_blocks",
                            "generated_prefix_registered",
                            "speculate_k", "spec_acceptance_rate",
                            "kv_dtype"):
                    body[key] = load[key]
            if self._draining:
                # mid-drain the engine goes draining -> stopped by
                # design: a planned retirement, not "unhealthy"
                body["status"] = "draining"
                body["reason"] = "server is draining; " \
                    "{} request(s) still in flight".format(
                        engine.outstanding()
                        if health["scheduler_thread"] else 0)
                return 503, body
            if not health["alive"]:
                body["status"] = "unhealthy"
                body["reason"] = health.get("broken") or \
                    "decode engine scheduler is not running"
                return 503, body
        if self._draining:
            body["status"] = "draining"
            body["reason"] = "server is draining"
            return 503, body
        if self._unhealthy is not None:
            body["status"] = "unhealthy"
            body["reason"] = self._unhealthy
            return 503, body
        return 200, body

    # -- observability (GET /metrics, GET /debug/trace) ---------------------

    def metrics_text(self):
        """OpenMetrics exposition of the mounted engine's registry plus
        the info gauges (replica id, attention formulation, KV dtype)
        and the labeled splice-failure and QoS counters — the body of
        ``GET /metrics``. An engine-less server exposes an empty but
        valid document."""
        engine = self.engine
        registry = getattr(engine, "metrics", None)
        text = tracing.MetricsRegistry().render() if registry is None \
            else registry.render()
        info = ""
        rid = self.replica_id
        if rid is not None:
            info += ('# TYPE tfos_serving_replica_info gauge\n'
                     'tfos_serving_replica_info{{replica_id="{}"}} 1\n'
                     .format(rid))
        impl = getattr(engine, "attn_impl", None)
        if impl is not None:
            info += ('# TYPE tfos_serving_attn_impl gauge\n'
                     'tfos_serving_attn_impl{{impl="{}"}} 1\n'
                     .format(impl))
        kv_dtype = getattr(engine, "kv_dtype", None)
        if kv_dtype is not None:
            info += ('# TYPE tfos_serving_kv_dtype gauge\n'
                     'tfos_serving_kv_dtype{{dtype="{}"}} 1\n'
                     .format(kv_dtype))
        if engine is not None:
            counts = engine.splice_failures()
            if counts:
                info += "# TYPE tfos_splice_failures counter\n"
                for reason in sorted(counts):
                    info += ('tfos_splice_failures_total'
                             '{{reason="{}"}} {}\n'
                             .format(reason, counts[reason]))
            # tenant names are bounded by qos's grammar (64 chars of
            # [A-Za-z0-9._-]), so label values need no escaping
            t = engine.qos_tallies()
            for family, label_keys, key in (
                    ("tfos_qos_admitted", ("tenant", "class"), "admitted"),
                    ("tfos_qos_preemptions", ("tenant", "class"),
                     "preemptions"),
                    ("tfos_qos_quota_rejections", ("tenant",),
                     "quota_rejections"),
                    ("tfos_qos_tokens", ("tenant",), "tokens")):
                if not t[key]:
                    continue
                info += "# TYPE {} counter\n".format(family)
                for label in sorted(t[key]):
                    values = label if isinstance(label, tuple) \
                        else (label,)
                    info += "{}_total{{{}}} {}\n".format(
                        family, ",".join('{}="{}"'.format(k, v) for k, v
                                         in zip(label_keys, values)),
                        t[key][label])
        if info:
            text = text.replace("# EOF\n", info + "# EOF\n")
        return text

    def debug_trace(self):
        """Chrome trace-event JSON of the engine's flight recorder (the
        process-global one without an engine) — the body of ``GET
        /debug/trace``; loads in Perfetto."""
        flight = getattr(self.engine, "flight", None)
        if flight is None:
            flight = tracing.flight_recorder()
        return flight.chrome_trace()

    # -- graceful drain -----------------------------------------------------

    def drain(self, timeout=None):
        """Graceful shutdown in load-balancer order: /healthz turns to
        the distinct ``draining`` 503, new POST work is refused (503 +
        ``Retry-After``), every admitted request finishes (the engine's
        :meth:`DecodeEngine.drain`) and its response is written, then
        the HTTP server stops. ``timeout`` bounds both; None waits for
        the engine as long as the work takes and caps the delivery wait
        at 30 s. Returns True only when every admitted request finished
        and its response was handed to the HTTP layer. Idempotent: a
        concurrent second caller (a double SIGTERM) gets the first
        drain's verdict."""
        self._draining = True
        with self._drain_lock:
            if self._drain_result is not None:
                return self._drain_result
            logger.info("serving %r draining", self.name)
            overall = None if timeout is None \
                else time.monotonic() + max(float(timeout), 0.0)
            engine = self.engine
            drained = True
            if engine is not None:
                drained = engine.drain(
                    timeout=None if overall is None
                    else max(overall - time.monotonic(), 0.0))
            # zero loss includes DELIVERY: wait for in-flight POST
            # handlers to finish writing (the batcher stays up for an
            # admitted :predict in this window)
            delivery_deadline = overall if overall is not None \
                else time.monotonic() + 30.0
            while True:
                with self._inflight_lock:
                    left = self._inflight
                if left == 0:
                    break
                if time.monotonic() >= delivery_deadline:
                    logger.warning(
                        "drain: %d response(s) still being written at "
                        "the delivery deadline", left)
                    drained = False
                    break
                time.sleep(0.02)
            if self._batcher is not None:
                self._batcher.stop()
                self._batcher = None
            self.stop()
            logger.info("serving %r drained (%s) and stopped", self.name,
                        "zero loss" if drained else "TIMED OUT with "
                        "requests outstanding")
            self._drain_result = drained
            return drained

    def install_sigterm_drain(self, timeout=None):
        """Arm SIGTERM -> :meth:`drain` (finish admitted work, then
        exit). Must run on the main thread; the handler hands the drain
        to a non-daemon thread, which the interpreter joins at exit.
        Returns the previous handler."""
        import signal as signal_mod

        def _on_sigterm(signum, frame):
            logger.warning("SIGTERM: draining serving %r", self.name)
            # tfos: unjoined(non-daemon: interpreter exit IS the join)
            threading.Thread(target=self.drain,
                             kwargs={"timeout": timeout},
                             name="tfos-torch-serving-drain",
                             daemon=False).start()

        return signal_mod.signal(signal_mod.SIGTERM, _on_sigterm)

    # -- http plumbing ------------------------------------------------------

    def start(self):
        """Serve in a daemon thread; returns ``(host, port)``."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code, obj, headers=None):
                body = json.dumps(obj).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for name, value in (headers or {}).items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def _send_text(self, code, text, content_type):
                body = text.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _client_gone(self):
                """True once the client closed its connection."""
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

            def _kv_splice(self):
                """``POST /kv/splice``: adopt one shipment — the frames
                body, or an empty body with ``X-TFOS-KV-Via: shm``
                naming the ring the shipment sits in (co-hosted). The
                rows are zero-copy views, so the splice runs before the
                ring slot is released."""
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    n = 0
                # consume the body first, on refusal paths too
                body = self.rfile.read(n) if n else b""
                if server._fenced is not None:
                    return self._send(
                        410, {"error": "replica is fenced: "
                              + server._fenced, "kind": "Fenced"})
                if server._draining:
                    return self._send(
                        503, {"error": "server is draining",
                              "kind": "Draining"},
                        headers={"Retry-After": "5"})
                engine = server.engine
                try:
                    if self.headers.get("X-TFOS-KV-Via") == "shm":
                        ring, lock = kvship.consumer_ring(
                            self.headers.get("X-TFOS-KV-Ring", ""))
                        with lock:
                            view, release = ring.read_view(timeout=5.0)
                            try:
                                meta, rows = kvship.unpack(view)
                                result = server.splice_shipment(meta, rows)
                            finally:
                                release()
                    else:
                        meta, rows = kvship.unpack(body)
                        result = server.splice_shipment(meta, rows)
                except SpliceRejected as e:
                    # deliberate: no retry fixes a fence or a dtype
                    return self._send(409, {"error": str(e),
                                            "reason": e.reason,
                                            "kind": "SpliceRejected"})
                except ValueError as e:  # malformed frame or version
                    if engine is not None:
                        engine.note_splice_failure("malformed")
                    return self._send(400, {"error": str(e)})
                except OSError as e:  # the named ring is gone
                    if engine is not None:
                        engine.note_splice_failure("engine")
                    return self._send(503, {"error": str(e)},
                                      headers={"Retry-After": "1"})
                except (Retriable, TimeoutError) as e:
                    return self._send(503, {"error": str(e)},
                                      headers={"Retry-After": "1"})
                except Exception as e:  # noqa: BLE001 - surface as 500
                    logger.exception("/kv/splice failed")
                    return self._send(500, {"error": str(e)})
                return self._send(200, result)

            def do_GET(self):
                if self.path == "/healthz":
                    return self._send(*server.healthz())
                if self.path == "/metrics":
                    return self._send_text(200, server.metrics_text(),
                                           OPENMETRICS_CONTENT_TYPE)
                if self.path == "/debug/trace":
                    trace = server.debug_trace()
                    # ring saturation travels with the dump
                    return self._send(
                        200, trace,
                        headers={"X-TFOS-Trace-Dropped":
                                 str(trace.get("dropped", 0))})
                base = "/v1/models/%s" % server.name
                if self.path == base:
                    return self._send(200, server.status())
                if self.path == base + "/metadata":
                    return self._send(200, server.metadata())
                return self._send(404, {"error": "not found: %s"
                                        % self.path})

            def do_POST(self):
                with server._inflight_lock:
                    server._inflight += 1
                try:
                    return self._do_post_tracked()
                finally:
                    with server._inflight_lock:
                        server._inflight -= 1

            def _admin_post(self):
                """``POST /admin/<name>``: registered lifecycle RPCs,
                past the fenced and draining gates; a call stamped below
                the control-epoch floor is refused 409."""
                fn = server._admin.get(self.path[len("/admin/"):])
                if fn is None:
                    return self._send(404, {"error": "not found: %s"
                                            % self.path})
                raw_ce = self.headers.get("X-TFOS-Control-Epoch")
                if raw_ce is not None:
                    try:
                        ce = int(raw_ce)
                    except ValueError:
                        return self._send(
                            400, {"error": "malformed X-TFOS-Control-"
                                  "Epoch: %r" % raw_ce})
                    admitted, floor = server.admit_control_epoch(ce)
                    if not admitted:
                        return self._send(
                            409, {"error": "control epoch %d is below "
                                  "this replica's floor %d (a newer "
                                  "driver took over)" % (ce, floor),
                                  "kind": "ControlFenced",
                                  "control_epoch": floor})
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    return self._send(200, fn(payload or {}))
                except (_BadRequest, ValueError) as e:
                    # malformed JSON or a missing field: the caller's
                    return self._send(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 - surface as 500
                    logger.exception("admin %s failed", self.path)
                    return self._send(500, {"error": str(e)})

            def _do_post_tracked(self):
                if self.path.startswith("/admin/"):
                    return self._admin_post()
                if self.path == "/kv/splice":
                    # an octet-stream shipment, never JSON
                    return self._kv_splice()
                # a router-minted X-TFOS-Trace id is adopted as the
                # engine trace id (a malformed one: a local id)
                trace = None
                raw_trace = self.headers.get("X-TFOS-Trace")
                if raw_trace:
                    try:
                        trace = int(raw_trace)
                    except ValueError:
                        trace = None
                request_id = self.headers.get("X-TFOS-Request-Id") or None
                base = "/v1/models/%s" % server.name
                routes = {
                    base + ":predict": server.predict,
                    base + ":generate": lambda payload: server.generate(
                        payload, client_gone=self._client_gone,
                        trace=trace, request_id=request_id),
                    base + ":prefill": lambda payload: server.prefill(
                        payload, trace=trace)}
                handler = routes.get(self.path)
                if handler is None:
                    return self._send(404, {"error": "not found: %s"
                                            % self.path})
                if server._fenced is not None:
                    return self._send(
                        410, {"error": "replica is fenced: "
                              + server._fenced, "kind": "Fenced"})
                if server._draining:
                    return self._send(
                        503, {"error": "server is draining",
                              "status": "draining", "kind": "Draining"},
                        headers={"Retry-After": "5"})
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    return self._send(200, handler(payload))
                except (_BadRequest, json.JSONDecodeError) as e:
                    return self._send(400, {"error": str(e)})
                except Fenced as e:
                    return self._send(410, {"error": str(e),
                                            "kind": "Fenced"})
                except QueueFull as e:
                    return self._send(429, {"error": str(e)})
                except QuotaExceeded as e:
                    # policy, not load: the quota follows the tenant,
                    # and Retry-After is the bucket's refill time
                    return self._send(
                        429, {"error": str(e), "kind": "QuotaExceeded",
                              "tenant": e.tenant},
                        headers={"Retry-After":
                                 str(int(math.ceil(e.retry_after)))})
                except DeadlineExceeded as e:
                    return self._send(504, {"error": str(e)})
                except Cancelled as e:
                    try:
                        return self._send(499, {"error": str(e)})
                    except OSError:
                        return
                except Retriable as e:
                    return self._send(
                        503, {"error": str(e), "kind": type(e).__name__},
                        headers={"Retry-After":
                                 str(int(math.ceil(e.retry_after)))})
                except Exception as e:  # noqa: BLE001 - surface as 500
                    logger.exception("%s failed", self.path)
                    return self._send(500, {"error": str(e)})

            def log_message(self, fmt, *args):  # quiet by default
                logger.debug("serving: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tfos-torch-serving",
            daemon=True)
        self._thread.start()
        logger.info("serving %r on %s:%d", self.name, self._host, self._port)
        return self._host, self._port

    def stop(self):
        """Stop the HTTP server and the batching window (the engine is
        the caller's to stop)."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._batcher is not None:
            self._batcher.stop()
            self._batcher = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


def main(argv=None):
    """``python -m tensorflowonspark_tpu_torch.serving --model-dir
    EXPORT``: serve an export over the TF-Serving-shaped REST surface;
    SIGTERM drains (finishes admitted requests) and exits."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Serve an exported model over TF-Serving-shaped REST")
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--name", default="model")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8501)
    ap.add_argument("--batch-window-ms", type=float, default=0,
                    help="coalesce concurrent same-shape requests into "
                         "one batched model call inside this window "
                         "(0 = off)")
    ap.add_argument("--drain-timeout", type=float, default=None,
                    help="bound (seconds) on the SIGTERM graceful "
                         "drain; default: wait for all admitted work "
                         "(zero loss)")
    ap.add_argument("--device", default=None,
                    help="where the export loads (default: the card; "
                         "'cpu' must be asked for)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = ModelServer(args.model_dir, name=args.name,
                         host=args.host, port=args.port,
                         batch_window_ms=args.batch_window_ms,
                         device=args.device)
    host, port = server.start()
    server.install_sigterm_drain(timeout=args.drain_timeout)
    print("serving %s at http://%s:%d/v1/models/%s" % (
        args.model_dir, host, port, args.name), flush=True)
    try:
        # the serve thread ends when drain() stops the server
        server._thread.join()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
