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
    POST /admin/ship_fence             {"replica_id", "min_epoch"}
    GET  /healthz

``:predict`` runs the export's ``apply_fn`` under
``torch.inference_mode()``, one request at a time, or, with
``batch_window_ms > 0``, through :class:`_Batcher`, which merges
concurrent requests of one input signature into one apply call.

Error taxonomy on the wire: malformed body 400 (for ``:predict``:
ragged, non-numeric, empty and 0-d inputs and a batch-size mismatch),
:class:`QueueFull` 429, :class:`Retriable` (:class:`Shed`,
:class:`Draining`, :class:`EngineFailed`) 503 with ``Retry-After``,
:class:`DeadlineExceeded` 504, :class:`Cancelled` 499;
``/kv/splice``: :class:`SpliceRejected` 409 with its ``reason``, a
malformed shipment 400.

Left out of this port so far (see ROADMAP.md, Queue 1 items 8-9): the
QoS fair scheduler (admission here is the block-gated FIFO the
reference runs with one priority class), SLO and the serving chaos
sites, the flight recorder and ``/metrics``, and the fleet plane's
server state (dedup window, replica fencing and control epochs, drain,
the other ``/admin`` routes). ``_Batcher`` drops the reference's
power-of-two padding of a merged batch, which bounds ``jit``'s compile
cache; eager PyTorch has none, and padding would only add rows to
compute.
"""

import collections
import contextlib
import itertools
import json
import logging
import math
import queue as queue_mod
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
from tensorflowonspark_tpu_torch import tracing

logger = logging.getLogger(__name__)

_STREAM_DONE = object()
_ENGINE_IDS = itertools.count()


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


class GenerationHandle(object):
    """One in-flight generation request against a :class:`DecodeEngine`.

    The scheduler thread emits tokens into the handle as each step
    completes; clients iterate :meth:`stream` or block on
    :meth:`result`. ``deadline`` (absolute ``time.monotonic``) and
    :meth:`cancel` evict the request at the next step boundary."""

    def __init__(self, prompt, max_new_tokens, deadline=None):
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline
        self.submitted = time.monotonic()
        self.completed = None
        self._tokens = []
        self._q = queue_mod.Queue()
        self._done = threading.Event()
        self._error = None
        self._cancel_requested = False
        self._last_emit_at = None   # monotonic of the last emitted token
        self._admitted = False      # first admission done (queue wait)

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
    the engine in shipments (default: unique in the process)."""

    def __init__(self, model, slots=8, total_len=None, buckets=None,
                 temperature=0.0, top_k=None, top_p=None, eos_token=None,
                 generator=None, max_queue=1024, kv_block_size=None,
                 kv_blocks=None, prefix_cache=True, attn_impl=None,
                 kv_dtype=None, speculate_k=None, draft_layers=None,
                 tier=None, replica_id=None, device=None):
        self.device = device_info.default_device(device)
        self.replica_id = str(replica_id) if replica_id is not None \
            else "engine-{}".format(next(_ENGINE_IDS))
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
        self.counters = tracing.Counters()
        self.timers = tracing.StageTimers()
        #: latency distributions in seconds, written by the scheduler
        #: thread; ``kv_ship_ms`` (milliseconds) by :meth:`note_ship`
        self.histograms = {name: tracing.Histogram() for name in (
            "ttft", "token", "decode_step", "queue_wait", "request",
            "kv_ship_ms")}
        #: shipped-KV accounting: PHYSICAL bytes (pool rows as stored)
        #: and blocks, written by handler threads and the scheduler, so
        #: only under ``_cv`` (:meth:`note_ship`, :meth:`_kv_import`)
        self.kv_counters = tracing.Counters()
        self._splice_failures = {}  # reason -> count, under _cv
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
        self._broken = None
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

    def submit(self, prompt, max_new_tokens, deadline_s=None):
        """Queue one request; returns its :class:`GenerationHandle`.
        ``deadline_s`` (seconds from now) evicts the request at the
        first step boundary past it."""
        return self._submit_many([self.validate(prompt, max_new_tokens)],
                                 deadline_s=deadline_s)[0]

    def _submit_many(self, vetted, deadline_s=None):
        """Atomically queue a whole vetted body: every request is queued
        or none is. ``max_new == 0`` requests complete inline."""
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if not deadline_s > 0:
                raise ValueError(
                    "deadline_s must be > 0, got {}".format(deadline_s))
        with self._cv:
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
            deadline = None if deadline_s is None \
                else time.monotonic() + deadline_s
            handles = []
            for prompt, max_new in vetted:
                handle = GenerationHandle(prompt, max_new, deadline=deadline)
                if max_new == 0:
                    handle._finish()
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
        """{alive, scheduler_thread, stopping, broken}: ``alive`` is
        False once the scheduler died or the engine was stopped."""
        with self._cv:
            broken = self._broken
            stopping = self._stopping
        thread_alive = self._thread.is_alive()
        return {"alive": thread_alive and not stopping and broken is None,
                "scheduler_thread": thread_alive,
                "stopping": stopping,
                "broken": str(broken) if broken is not None else None}

    def load_stats(self):
        """Live load gauges: queue depth, slot occupancy, queue-wait
        EWMA, pool headroom and prefix-cache hit rate, the engine's
        attention, KV, speculation and tier configuration, the live
        acceptance rate and the shipped-KV bytes (physical: pool rows
        as stored). A contiguous engine reports the zero schema."""
        with self._cv:
            queue_depth = len(self._queue)
            occupancy = len(self._active_slots())
            qwait = self._qwait_ewma
            kv = {"kv_ship_bytes": self.kv_counters.get("ship_bytes"),
                  "kv_ship_blocks": self.kv_counters.get("ship_blocks"),
                  "kv_spliced_bytes": self.kv_counters.get("spliced_bytes"),
                  "kv_spliced_blocks":
                  self.kv_counters.get("spliced_blocks")}
        proposed = self.counters.get("spec_proposed")
        stats = {"device": str(self.device),
                 "replica_id": self.replica_id,
                 "tier": self.tier,
                 "queue_depth": queue_depth,
                 "slot_occupancy": occupancy,
                 "slots": self.slots,
                 "queue_wait_ewma_s": round(qwait, 6)
                 if qwait is not None else 0.0,
                 "alive": self.healthy()["alive"],
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
            stats.update({
                "kv_blocks_total": ps["total"],
                "kv_blocks_free": ps["free"],
                "prefix_hit_rate": round(ps["hit_rate"], 4),
                "generated_prefix_hit_blocks": ps["generated_hits"],
                "generated_prefix_registered": ps["generated_registered"]})
        else:
            stats.update({"kv_blocks_total": 0, "kv_blocks_free": 0,
                          "prefix_hit_rate": 0.0,
                          "generated_prefix_hit_blocks": 0,
                          "generated_prefix_registered": 0})
        return stats

    def measure_spec(self, reps=3, depth=None):
        """Time a speculative round's two halves apart — the draft's
        ``k`` one-token steps and the target's ``k``-query verify — at
        the engine's pool shapes with every slot ``depth`` tokens deep
        (default ``total_len // 2``), on copies of the pools (both
        halves write in place). CUDA events on the card, the host clock
        on the CPU. Records ``draft`` and ``verify`` samples in
        ``timers``; returns ``{"draft": ms, "verify": ms}`` (means), or
        None on an engine that does not speculate."""
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
        halves = (("draft", lambda: propose(draft_cache, last, idx, tables,
                                            gen)),
                  ("verify", lambda: verify(cache, feed, idx, tables,
                                            gen)))
        cuda = dev.type == "cuda"
        ms = {"draft": [], "verify": []}
        with torch.no_grad():
            for _, fn in halves:
                fn()  # warm
            for _ in range(max(1, int(reps))):
                for name, fn in halves:
                    if cuda:
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        fn()
                        end.record()
                        end.synchronize()
                        ms[name].append(start.elapsed_time(end))
                    else:
                        t0 = time.perf_counter()
                        fn()
                        ms[name].append((time.perf_counter() - t0) * 1e3)
                    self.timers.add(name, ms[name][-1] / 1e3)
        return {name: sum(v) / len(v) for name, v in ms.items()}

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

    def _evict(self, handle, err):
        handle._finish(err)
        self.counters.inc("deadline_exceeded"
                          if isinstance(err, DeadlineExceeded)
                          else "cancelled")

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
        """Block-gated FIFO admission (caller holds ``_cv``): the queue
        head enters a free slot only when its prefill blocks are
        obtainable now, judged from one ``plan_admission`` snapshot;
        there is no bypass past a block-starved head. While the head
        waits, an unchanged pool epoch means the old verdict stands. A
        contiguous engine gates on slots alone."""
        admits = []
        free = [s for s in range(self.slots) if self._slot_req[s] is None]
        planned_blocks = 0
        while free and self._queue:
            head = self._queue[0]
            if self._paged:
                if self._head_block_memo == (head, self._pool.epoch()):
                    break
                _, need, lru_shared, allocatable, epoch = \
                    self._pool.plan_admission(head.prompt + head._tokens)
                if need + lru_shared + planned_blocks > allocatable:
                    self._head_block_memo = (head, epoch)
                    break
                self._head_block_memo = None
                planned_blocks += need + lru_shared
            s = free.pop(0)
            self._queue.popleft()
            # occupy the slot at pop time, so the failure paths find it
            self._slot_req[s] = head
            admits.append((s, head))
        return admits

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
                admits = self._plan_admission_locked()
                self.counters.gauge("queue_depth", len(self._queue))
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
            t0 = time.monotonic()
            if self._spec_k:
                with self.timers.timed("spec_round"):
                    drafts, targets = generation.paged_spec_round(
                        self.model, self._draft, self._cache,
                        self._draft_cache, self._last, self._idx,
                        self._tables, self._spec_k,
                        temperature=self._temperature, top_k=self._top_k,
                        top_p=self._top_p, generator=self._generator,
                        attn_impl=self.attn_impl)
                    # the per-round host sync
                    drafts = drafts.cpu().numpy()
                    targets = targets.cpu().numpy()
            else:
                with self.timers.timed("decode_step"):
                    if self._paged:
                        toks = generation.paged_decode_step(
                            self.model, self._cache, self._last, self._idx,
                            self._tables, temperature=self._temperature,
                            top_k=self._top_k, top_p=self._top_p,
                            generator=self._generator,
                            attn_impl=self.attn_impl)
                    else:
                        toks = generation.decode_step(
                            self.model, self._cache, self._last, self._idx,
                            temperature=self._temperature,
                            top_k=self._top_k, top_p=self._top_p,
                            generator=self._generator)
                    toks = toks.cpu().numpy()  # the per-step host sync
            self.histograms["decode_step"].observe(time.monotonic() - t0)
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
        self.counters.gauge("queue_depth", 0)
        self.counters.gauge("slot_occupancy", 0)

    def _publish_kv_gauges(self):
        """Refresh the pool gauges and roll the pool's monotonic tallies
        (prefix hits/misses, LRU evictions, generated-prefix
        registrations and hits) into the counters; zeros on a
        contiguous engine."""
        if not self._paged:
            for gauge in ("kv_blocks_total", "kv_blocks_free",
                          "kv_blocks_cached"):
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
        return kvship.pack(meta, rows), meta

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

    def _preempt(self, slot):
        """Free a slot's blocks under pool exhaustion and requeue its
        request at the queue FRONT; it re-enters with a continuation
        prefill of prompt + emitted tokens, so its stream continues
        (token-identical at temperature 0)."""
        handle = self._slot_req[slot]
        self._slot_req[slot] = None
        self._release_slot(slot)
        with self._cv:
            self._queue.appendleft(handle)
            self.counters.gauge("queue_depth", len(self._queue))
        self.counters.inc("preemptions")
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
        exhaustion the YOUNGEST admission is preempted, so the oldest
        always progresses (``validate`` guarantees a lone request's
        worst case fits the pool)."""
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
                    self._preempt(max(self._active_slots(),
                                      key=lambda v: self._slot_seq[v]))
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
        self._observe_queue_wait(handle, time.monotonic())
        with self.timers.timed("prefill"):
            first = int(generation.prefill_into_slot(
                self.model, self._cache, slot, toks, n,
                temperature=self._temperature, top_k=self._top_k,
                top_p=self._top_p, generator=self._generator))
        self.counters.inc("prefills")
        self._idx[slot] = n
        self._last[slot] = first
        self._deliver(slot, first)
        self.counters.inc("tokens")

    def _observe_queue_wait(self, handle, now):
        """Queue-wait metrics, for a request's FIRST admission only (a
        preemption re-entry is a continuation, not a queue wait)."""
        if handle._admitted:
            return
        wait = now - handle.submitted
        self.histograms["queue_wait"].observe(wait)
        self._qwait_ewma = wait if self._qwait_ewma is None else \
            self._ewma_alpha * wait \
            + (1.0 - self._ewma_alpha) * self._qwait_ewma
        handle._admitted = True

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
                    full, count_generated=not handle._admitted)
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
        self._observe_queue_wait(handle, time.monotonic())
        with self.timers.timed("prefill"):
            first = int(generation.paged_prefill_into_slot(
                self.model, self._cache, row, toks, len(tail), start,
                temperature=self._temperature, top_k=self._top_k,
                top_p=self._top_p, generator=self._generator,
                attn_impl=self.attn_impl))
        self.counters.inc("prefills")
        if self._spec_k:
            # mirror the tail into the draft's pool: the draft attends
            # the same prefix through the same table row (a prefix hit
            # skips both prefills; shared blocks were mirrored when
            # their writer prefilled or decoded them). Its pick is
            # dropped: this call is for its writes.
            with self.timers.timed("draft_prefill"):
                generation.paged_prefill_into_slot(
                    self._draft, self._draft_cache, row, toks, len(tail),
                    start, attn_impl=self.attn_impl)
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
            self.histograms["ttft"].observe(now - handle.submitted)
        else:
            self.histograms["token"].observe(now - handle._last_emit_at)
        handle._last_emit_at = now
        self._last[slot] = token
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
            self.histograms["request"].observe(
                handle.completed - handle.submitted)


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
    (:class:`_Batcher`). ``device``: where the export's variables load
    (:func:`device_info.default_device`: the card unless ``"cpu"``).
    The engine, when given, is the caller's to stop.
    """

    def __init__(self, model_dir, name="model", host="127.0.0.1",
                 port=8501, batch_window_ms=0, engine=None, device=None):
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
        #: ``:predict`` apply calls made (one per batcher group)
        self.apply_calls = 0
        self._host = host
        self._port = int(port)
        self._httpd = None
        self._thread = None
        # splice fence floors: replica id -> the epoch a shipment from it
        # must exceed (raised by /admin/ship_fence, never lowered)
        self._ship_fence = {}
        self._ship_fence_lock = threading.Lock()

    @property
    def replica_id(self):
        """The mounted engine's replica id (None without an engine): the
        ``src`` a shipment from here carries."""
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

    def generate(self, payload, client_gone=None):
        """``{"prompt": [[...], ...] or [...], "max_new_tokens": N}`` ->
        ``{"tokens": ...}`` (prompt + generated tokens per prompt; a flat
        prompt is answered un-nested). The whole body is vetted before
        any of it is queued, and queued atomically."""
        if self.engine is None:
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
        try:
            vetted = [self.engine.validate(p, max_new) for p in prompts]
        except (ValueError, TypeError) as e:
            raise _BadRequest(str(e))
        handles = self.engine._submit_many(vetted, deadline_s=deadline_s)
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

    def prefill(self, payload):
        """``POST :prefill``, the prefill tier's entry point: ``{"prompt":
        [t, ...], "src_epoch"?, "ship"?: {"addr": "host:port",
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
        if not isinstance(payload, dict) or "prompt" not in payload:
            raise _BadRequest("request needs a 'prompt' field")
        prompt = payload["prompt"]
        if not isinstance(prompt, list) or not prompt \
                or isinstance(prompt[0], (list, tuple)):
            raise _BadRequest(":prefill takes ONE flat token list")
        try:
            vetted = engine.validate(prompt, 1)
        except (ValueError, TypeError) as e:
            raise _BadRequest(str(e))
        engine._submit_many([vetted])[0].result(600.0)
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

    def healthz(self):
        """``(status, body)``: 200 while the engine (if any) is alive,
        else 503."""
        if self.engine is None:
            return 200, {"status": "ok", "model": self.name}
        stats = self.engine.load_stats()
        ok = stats["alive"]
        stats["status"] = "ok" if ok else "unhealthy"
        return (200 if ok else 503), stats

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

            def _client_gone(self):
                """True once the client closed its connection."""
                import select
                import socket
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
                base = "/v1/models/%s" % server.name
                if self.path == base:
                    return self._send(200, server.status())
                if self.path == base + "/metadata":
                    return self._send(200, server.metadata())
                return self._send(404, {"error": "not found: %s"
                                        % self.path})

            def do_POST(self):
                if self.path == "/kv/splice":
                    # an octet-stream shipment, never JSON
                    return self._kv_splice()
                base = "/v1/models/%s" % server.name
                routes = {
                    base + ":predict": server.predict,
                    base + ":generate": lambda payload: server.generate(
                        payload, client_gone=self._client_gone),
                    base + ":prefill": server.prefill,
                    "/admin/ship_fence": server._admin_ship_fence}
                handler = routes.get(self.path)
                if handler is None:
                    return self._send(404, {"error": "not found: %s"
                                            % self.path})
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    return self._send(200, handler(payload))
                except (_BadRequest, json.JSONDecodeError) as e:
                    return self._send(400, {"error": str(e)})
                except QueueFull as e:
                    return self._send(429, {"error": str(e)})
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
            self._thread = None
        if self._batcher is not None:
            self._batcher.stop()
            self._batcher = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
