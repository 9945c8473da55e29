"""Metrics, events and request spans — the port's copy of
``tensorflowonspark_tpu/tracing.py`` (stdlib only).

- :class:`StageTimers` answers "where did the time go": named
  wall-clock accumulators (the feed plane's ``ring_wait`` / ``decode``
  / ``gather`` / ``device_put``; the engine's ``prefill``,
  ``decode_step``, ``block_alloc``, ``prefix_lookup``,
  ``host_schedule``).
- :class:`Counters` answers "what did the loop do": monotonic counts
  and gauges (queue depth, slot occupancy, free KV blocks, records
  fed).
- :class:`Histogram` carries latency distributions with
  ``quantile(q)``.
- :class:`EventLog` — a bounded timestamped event record.
- :class:`MetricsRegistry` — one named home for the three above, with
  :meth:`MetricsRegistry.render` producing OpenMetrics text (the
  reservation server's driver-side ``GET /metrics``) and
  :meth:`MetricsRegistry.snapshot` the compact JSON-able form that rides
  the heartbeat leases to the driver (:func:`merge_snapshots`,
  :func:`cluster_rollup`, ``cluster.metrics()``).
- :data:`METRIC_FAMILIES` — the catalog of every exported family, the
  same table as the reference's, so a scrape of either package reads
  the same names.
- :class:`FlightRecorder` — a bounded ring of request-scoped span
  events, dumpable as Chrome trace-event JSON; :func:`flight_recorder`
  is the process-global one.

Counters, StageTimers and Histograms follow the single-writer
convention: one thread writes, readers take copies; the unlocked dict
and int updates are benign under the GIL.

Left for later slices: the profiler hooks (``start_profiler_server``,
``trace``) and the TensorBoard ``SummaryWriter`` / ``metrics_hook``.
"""

import collections
import itertools
import logging
import math
import os
import threading
import time

logger = logging.getLogger(__name__)


class StageTimers(object):
    """Named wall-clock accumulators: one entry per pipeline stage.

    Cheap enough for per-chunk use (a dict add per sample, no locks).
    The feed plane's convention is one instance per DataFeed, shared
    with the infeed prefetcher (``infeed.prefetch(..., timers=...)``);
    the prefetch staging thread is the only cross-thread writer and
    ``snapshot()`` is read at end of run, so the unlocked add is a
    benign last-sample race, never a torn total.
    """

    __slots__ = ("_t", "_n")

    def __init__(self):
        self._t = {}
        self._n = {}

    def add(self, stage, seconds):
        """Accumulate one sample for ``stage``."""
        self._t[stage] = self._t.get(stage, 0.0) + seconds
        self._n[stage] = self._n.get(stage, 0) + 1

    def timed(self, stage):
        """``with timers.timed("decode"):`` — context-manager sampling."""
        return _StageSpan(self, stage)

    def snapshot(self):
        """{stage: total_seconds} — stable copy for artifacts/logs."""
        return dict(self._t)

    def counts(self):
        """{stage: samples} — for per-sample (per-chunk/batch) math."""
        return dict(self._n)

    def per_ms(self):
        """{stage: mean milliseconds per sample} — the human-readable
        breakdown bench.py and profile_fed.py print."""
        return {k: round(v * 1000.0 / max(self._n.get(k, 1), 1), 3)
                for k, v in self._t.items()}


class Counters(object):
    """Named monotonic counters + gauges for a serving/scheduler loop.

    The feed plane's :class:`StageTimers` answers "where did the time
    go"; this answers "what did the loop do" — requests queued, slots
    occupied, tokens emitted per step. Single-writer convention (the
    owning scheduler thread); readers take :meth:`snapshot` copies, so
    the unlocked dict ops are benign under the GIL exactly like
    StageTimers' adds.
    """

    __slots__ = ("_counts", "_gauges")

    def __init__(self):
        self._counts = {}
        self._gauges = {}

    def inc(self, name, n=1):
        """Add ``n`` to monotonic counter ``name``."""
        self._counts[name] = self._counts.get(name, 0) + n

    def gauge(self, name, value):
        """Set instantaneous gauge ``name`` (e.g. queue depth)."""
        self._gauges[name] = value

    def get(self, name):
        """Current value of counter ``name`` (0 when absent) — so the
        owning loop can branch on its own tallies without keeping a
        parallel ledger."""
        return self._counts.get(name, 0)

    def set_count(self, name, value):
        """Set counter ``name`` absolutely — for MIRRORING an external
        monotonic source (e.g. a FlightRecorder's ``dropped`` tally)
        into the exposition; never for resetting. The mirror stays
        monotonic as long as the source is."""
        self._counts[name] = value

    def snapshot(self):
        """{"counts": {...}, "gauges": {...}} — stable copies."""
        return {"counts": dict(self._counts), "gauges": dict(self._gauges)}

    def rate(self, numerator, denominator):
        """counts[numerator] / counts[denominator] (0 when empty) — e.g.
        ``rate("decode_tokens", "decode_steps")`` = mean decode
        occupancy per step."""
        d = self._counts.get(denominator, 0)
        return self._counts.get(numerator, 0) / d if d else 0.0


class EventLog(object):
    """Bounded timestamped event record for supervision timelines.

    Each event carries both clocks: ``t`` (monotonic — span math) and
    ``wall`` (epoch — correlating with out-of-process evidence like a
    chaos fuse file's fire time). Thread-safe: the supervisor's monitor
    thread and the supervised-run driver loop both append.

    ``capacity`` bounds the log to a ring of the most recent events
    (default 4096 — a supervised run that beats forever must not grow
    driver memory without limit); overflow evicts the OLDEST event and
    increments :attr:`dropped`. Span extraction (``span``,
    ``supervisor.recovery_stages``) therefore describes the retained
    window — at the default capacity that is far more history than any
    MTTR computation needs.
    """

    def __init__(self, capacity=4096):
        self._events = collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        #: events evicted by the ring bound (monotonic counter)
        self.dropped = 0

    def record(self, name, **detail):
        """Append one event; returns its dict (already stamped)."""
        event = {"name": name, "t": time.monotonic(), "wall": time.time()}
        if detail:
            event.update(detail)
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(event)
        # mirror into the process-global flight recorder: supervision
        # milestones land in the same black box serving spans do, so an
        # incident dump reads as one interleaved timeline
        flight_recorder().instant(name, **detail)
        logger.debug("event %s %s", name, detail)
        return event

    def events(self, name=None):
        """All events (or those named ``name``), oldest first."""
        with self._lock:
            events = list(self._events)
        if name is not None:
            events = [e for e in events if e["name"] == name]
        return events

    def last(self, name, **match):
        """Most recent event named ``name`` whose fields match, or None."""
        for event in reversed(self.events(name)):
            if all(event.get(k) == v for k, v in match.items()):
                return event
        return None

    def span(self, from_name, to_name, **match):
        """Seconds between the last matching ``from_name`` and the first
        matching ``to_name`` at or after it; None when either is absent.
        The from/to pairing is how MTTR stages (detect -> reform ->
        restore -> first step) are extracted from one log."""
        start = self.last(from_name, **match)
        if start is None:
            return None
        for event in self.events(to_name):
            if event["t"] >= start["t"] and \
                    all(event.get(k) == v for k, v in match.items()):
                return event["t"] - start["t"]
        return None


#: content type every /metrics response declares (OpenMetrics
#: exposition) — shared by ModelServer and the reservation server's
#: driver-side stats endpoint so scrapers see ONE contract
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"

#: canonical catalog of every exported OpenMetrics family:
#: {family: (type, labels, meaning)}. The family name is what appears in
#: the ``# TYPE`` line; counters expose ``<family>_total`` samples and
#: histograms expose ``_bucket``/``_sum``/``_count``. The table is the
#: reference package's, row for row (tests/test_torch_feed.py holds the
#: two equal), so both packages export one set of names.
METRIC_FAMILIES = {
    # -- serving plane (DecodeEngine registry; ModelServer /metrics) --
    "tfos_serving_ttft_seconds":
        ("histogram", "", "submit -> first emitted token"),
    "tfos_serving_token_latency_seconds":
        ("histogram", "", "gap between consecutive emitted tokens"),
    "tfos_serving_decode_step_seconds":
        ("histogram", "", "one fixed-shape decode step, wall clock"),
    "tfos_serving_queue_wait_seconds":
        ("histogram", "", "submit -> prefill start (admission queue)"),
    "tfos_serving_request_seconds":
        ("histogram", "", "submit -> completion, whole request"),
    "tfos_serving_drain_seconds":
        ("histogram", "", "DecodeEngine.drain wall clock"),
    "tfos_serving_tokens":
        ("counter", "", "tokens emitted (prefill firsts included)"),
    "tfos_serving_decode_tokens":
        ("counter", "", "tokens emitted by decode steps only"),
    "tfos_serving_decode_steps":
        ("counter", "", "fixed-shape decode steps run"),
    "tfos_serving_prefills":
        ("counter", "", "prompt prefills (one per admission)"),
    "tfos_serving_requests_completed":
        ("counter", "", "requests finished normally (EOS/length)"),
    "tfos_serving_shed":
        ("counter", "", "requests refused at admission (infeasible "
                        "deadline)"),
    "tfos_serving_cancelled":
        ("counter", "", "requests evicted by cancel/disconnect"),
    "tfos_serving_deadline_exceeded":
        ("counter", "", "requests evicted past their deadline"),
    "tfos_serving_engine_restarts":
        ("counter", "", "RestartEngine rebuilds of a dead scheduler"),
    # -- paged KV cache: block pool + prefix cache --
    "tfos_serving_kv_blocks_total":
        ("gauge", "", "usable KV blocks in the paged pool (0 on a "
                      "contiguous engine)"),
    "tfos_serving_kv_blocks_free":
        ("gauge", "", "KV blocks obtainable right now (free list + "
                      "evictable prefix-cached)"),
    "tfos_serving_kv_blocks_cached":
        ("gauge", "", "refcount-0 blocks retained by the prefix cache "
                      "(evictable subset of kv_blocks_free)"),
    "tfos_serving_prefix_hit_blocks":
        ("counter", "", "shareable prompt blocks found resident at "
                        "admission (each skips its share of prefill)"),
    "tfos_serving_prefix_miss_blocks":
        ("counter", "", "shareable prompt blocks NOT resident at "
                        "admission (prefilled fresh)"),
    "tfos_serving_prefix_evictions":
        ("counter", "", "prefix-cached blocks reclaimed by the LRU "
                        "under allocation pressure"),
    "tfos_serving_preemptions":
        ("counter", "", "in-flight requests preempted (blocks freed, "
                        "requeued for continuation) under pool "
                        "exhaustion"),
    # -- fused paged attention + generated-prefix registration --
    "tfos_serving_attn_impl":
        ("gauge", "impl", "constant 1 carrying the engine's attention "
                          "formulation (fused / gather / contiguous) — "
                          "info-pattern join key for kernel-config "
                          "rollouts across a fleet"),
    "tfos_serving_generated_prefix_registered":
        ("counter", "", "decode-GENERATED full blocks published into "
                        "the prefix registry (multi-turn conversation "
                        "reuse; prompt-block registrations excluded)"),
    "tfos_serving_generated_prefix_hit_blocks":
        ("counter", "", "prefix-cache block hits that landed on a "
                        "decode-generated registration (subset of "
                        "tfos_serving_prefix_hit_blocks; preemption "
                        "continuations re-hitting their own blocks "
                        "excluded)"),
    # -- prefix-chain digest export: BEAT-carried warmth --
    "tfos_serving_prefix_digest_chains":
        ("gauge", "", "resident prefix chains the engine's bounded "
                      "top-K digest currently publishes in its BEAT "
                      "payload (0 on a contiguous engine)"),
    "tfos_serving_prefix_digest_truncated":
        ("gauge", "", "1 when the registry holds more chains than the "
                      "digest's top-K bound (the published digest is "
                      "an honest subset), else 0"),
    # -- speculative decoding + int8 paged KV --
    "tfos_serving_spec_proposed":
        ("counter", "", "draft tokens proposed by speculative rounds, "
                        "clamped to each request's emittable window "
                        "min(speculate_k, remaining) — so between 1x "
                        "and speculate_k x tfos_serving_spec_rounds"),
    "tfos_serving_spec_accepted":
        ("counter", "", "proposed draft tokens the target's verify "
                        "accepted (<= proposed; accepted/proposed is "
                        "the live acceptance rate load_stats and the "
                        "BEAT payload carry)"),
    "tfos_serving_spec_rounds":
        ("counter", "", "speculative draft+verify rounds run, counted "
                        "per active slot (a round over 3 slots counts "
                        "3)"),
    "tfos_serving_kv_dtype":
        ("gauge", "dtype", "constant 1 carrying the engine's KV pool "
                           "storage dtype (int8 fast path vs the "
                           "compute dtype) — info-pattern join key "
                           "for quantization rollouts across a "
                           "fleet"),
    "tfos_serving_queue_depth":
        ("gauge", "", "requests waiting for a slot"),
    "tfos_serving_slot_occupancy":
        ("gauge", "", "slots holding an in-flight sequence"),
    "tfos_serving_stage_seconds":
        ("counter", "stage", "scheduler wall seconds per stage "
                             "(qos_plan / prefill / decode_step / "
                             "host_schedule; speculative engines add "
                             "spec_round / draft_prefill plus the "
                             "draft and verify probes, int8 engines "
                             "the dequant probe)"),
    "tfos_serving_stage_samples":
        ("counter", "stage", "samples behind tfos_serving_stage_seconds"),
    "tfos_serving_replica_info":
        ("gauge", "replica_id", "constant 1 carrying the engine's stable "
                                "replica identity (join key for scraped "
                                "series and router decisions)"),
    # -- idempotent dispatch: replica-side dedup window --
    "tfos_serving_dedup_hits":
        ("counter", "", "retried/duplicated requests answered from the "
                        "dedup window's stored completion (executed "
                        "once, replayed — the partition-flap proof "
                        "that retries were absorbed)"),
    "tfos_serving_dedup_joined":
        ("counter", "", "duplicate deliveries that JOINED a still-"
                        "executing original instead of racing a second "
                        "generation"),
    # -- multi-tenant QoS plane --
    "tfos_qos_admitted":
        ("counter", "tenant,class", "admissions the weighted-fair "
                                    "scheduler granted, by tenant and "
                                    "priority class"),
    "tfos_qos_preemptions":
        ("counter", "tenant,class", "in-flight sequences preempted, by "
                                    "the tenant/class that was evicted "
                                    "(pool exhaustion or a stronger "
                                    "class waiting; subset context for "
                                    "tfos_serving_preemptions)"),
    "tfos_qos_quota_rejections":
        ("counter", "tenant", "admissions refused 429 QuotaExceeded "
                              "because the tenant's token bucket was "
                              "in debt"),
    "tfos_qos_tokens":
        ("counter", "tenant", "tokens actually delivered per tenant "
                              "(the post-paid usage that drains its "
                              "quota bucket)"),
    "tfos_qos_queue_wait_high_seconds":
        ("histogram", "", "submit -> prefill start for HIGH-class "
                          "admissions (per-class split of "
                          "tfos_serving_queue_wait_seconds — the "
                          "isolation number the antagonist bench "
                          "pins)"),
    "tfos_qos_queue_wait_normal_seconds":
        ("histogram", "", "submit -> prefill start for normal-class "
                          "admissions"),
    "tfos_qos_queue_wait_low_seconds":
        ("histogram", "", "submit -> prefill start for LOW-class "
                          "admissions (grows under pressure by "
                          "design: LOW absorbs the backlog)"),
    # -- fleet plane (FleetRouter registry; router /metrics) --
    "tfos_fleet_requests":
        ("counter", "", "requests the router answered (any status)"),
    "tfos_fleet_failovers":
        ("counter", "", "upstream attempts abandoned for another replica "
                        "after a retriable failure"),
    "tfos_fleet_no_replica":
        ("counter", "", "dispatch attempts that found no routable replica"),
    "tfos_fleet_probes":
        ("counter", "", "half-open health probes sent to down replicas"),
    "tfos_fleet_client_disconnects":
        ("counter", "", "dispatches abandoned because the router's own "
                        "client disconnected (upstream torn down so "
                        "the replica's disconnect cancel fires)"),
    "tfos_fleet_hedges":
        ("counter", "", "hedge attempts launched (primary still "
                        "running past the quantile-derived hedge "
                        "delay)"),
    "tfos_fleet_hedge_wins":
        ("counter", "", "requests whose HEDGE attempt produced the "
                        "winning response (the gray-replica tail the "
                        "hedge clipped)"),
    "tfos_fleet_fenced_upstreams":
        ("counter", "", "upstream attempts answered 410 Fenced (stale "
                        "lease epoch) — failed over and hard-downed"),
    "tfos_fleet_replicas":
        ("gauge", "", "replicas with a live serving lease"),
    "tfos_fleet_replicas_routable":
        ("gauge", "", "replicas currently eligible for dispatch"),
    "tfos_fleet_request_seconds":
        ("histogram", "", "router-observed request wall clock "
                          "(all dispatch attempts included)"),
    "tfos_fleet_upstream_seconds":
        ("histogram", "", "one upstream POST attempt, wall clock"),
    "tfos_fleet_route_overhead_seconds":
        ("histogram", "", "request wall clock minus its upstream "
                          "attempts (pick + failover bookkeeping)"),
    "tfos_fleet_stage_seconds":
        ("counter", "stage", "router wall seconds per stage "
                             "(pick / upstream / prefill)"),
    "tfos_fleet_stage_samples":
        ("counter", "stage", "samples behind tfos_fleet_stage_seconds"),
    "tfos_fleet_replica_up":
        ("gauge", "replica", "1 when the replica is routable, 0 when "
                             "down / stale / draining / quiesced"),
    "tfos_fleet_replica_lease_age_seconds":
        ("gauge", "replica", "seconds since each replica's last BEAT"),
    "tfos_fleet_replica_inflight":
        ("gauge", "replica", "requests the router holds open against "
                             "each replica"),
    # -- prefix-aware routing + session affinity --
    "tfos_fleet_affinity_hits":
        ("counter", "", "dispatches whose first-pick replica was WARM "
                        "for the request (session-affinity hint or "
                        "beat-digest prefix match promoted it over "
                        "pure least-loaded order)"),
    "tfos_fleet_affinity_breaks":
        ("counter", "reason", "times affinity was deliberately NOT "
                              "honored: load_guard (warm replica past "
                              "the backlog guard lost to a colder "
                              "one), failover_cold (warm replica dead/"
                              "fenced/draining — served cold, map "
                              "entry evicted), hedge_cold_win (a cold "
                              "hedge beat the warm primary; map left "
                              "unpoisoned)"),
    "tfos_fleet_affinity_entries":
        ("gauge", "", "live session -> replica entries in the "
                      "router's TTL'd affinity map"),
    # -- prefill/decode disaggregation: two-stage dispatch --
    "tfos_fleet_prefill_dispatches":
        ("counter", "", "staged :prefill calls the two-stage "
                        "dispatcher sent to the prefill tier"),
    "tfos_fleet_prefill_ships":
        ("counter", "", "staged prefills whose KV blocks were "
                        "confirmed shipped to the chosen decode "
                        "replica (the decode attempt then lands "
                        "warm)"),
    "tfos_fleet_prefill_skips":
        ("counter", "", "stages skipped because the chosen decode "
                        "replica already held the prompt's prefix "
                        "(digest match — nothing to ship)"),
    "tfos_fleet_prefill_misses":
        ("counter", "", "staged prefills that completed WITHOUT a "
                        "confirmed ship (splice refused, transport "
                        "failed, or unshippable) — the decode side "
                        "re-prefills cold"),
    "tfos_fleet_prefill_errors":
        ("counter", "", "prefill stages abandoned on a transport/"
                        "routing error (partitioned or dead prefill "
                        "tier; the request degrades to single-stage "
                        "dispatch)"),
    "tfos_fleet_replica_tier":
        ("gauge", "replica,tier", "constant 1 joining each replica to "
                                  "its serving tier (prefill / decode "
                                  "/ mixed) — the disaggregation "
                                  "topology at a glance"),
    # -- multi-tenant QoS at the router --
    "tfos_fleet_quota_rejections":
        ("counter", "", "dispatches the ROUTER refused 429 "
                        "QuotaExceeded from its own quota table "
                        "before any upstream attempt (engine-side "
                        "refusals count in tfos_qos_quota_rejections "
                        "on the replica)"),
    "tfos_fleet_tenant_spreads":
        ("counter", "", "dispatches re-ordered away from a replica "
                        "already concentrating the requesting "
                        "tenant's backlog (burst spreading; affinity "
                        "preferences still win)"),
    "tfos_fleet_prefix_prewarms":
        ("counter", "", "predictive placements triggered: a tenant's "
                        "hot prefix saturated its warm replica past "
                        "the load guard, so the router staged the "
                        "prefix onto the chosen cold replica via the "
                        "kv-ship plane"),
    # -- executor-hosted serving + SLO autoscaler --
    "tfos_serving_replica_host":
        ("gauge", "replica_id,executor", "constant 1 joining each "
                                         "executor-hosted replica to "
                                         "the executor that runs it "
                                         "(absent for driver-local "
                                         "replicas)"),
    "tfos_autoscale_decisions":
        ("counter", "", "autoscale control-loop evaluations (every "
                        "poll, holds included)"),
    "tfos_autoscale_scale_ups":
        ("counter", "", "replicas added by the autoscaler (SLO breach "
                        "-> spawn on a free executor)"),
    "tfos_autoscale_scale_downs":
        ("counter", "", "replicas retired by the autoscaler (sustained "
                        "idle -> zero-loss drain retirement)"),
    "tfos_autoscale_replacements":
        ("counter", "", "dead replicas repaired under the same "
                        "identity (lease expiry -> fenced replacement "
                        "spawn, or in-place respawn RPC)"),
    "tfos_autoscale_scale_up_blocked":
        ("counter", "", "scale-ups (or replacements) the capacity gate "
                        "refused — no free executor existed"),
    "tfos_autoscale_unclean_retirements":
        ("counter", "", "scale-down drains that timed out or failed "
                        "(zero-loss retirement is the contract; this "
                        "counting up is an alert)"),
    "tfos_autoscale_replicas_live":
        ("gauge", "", "replicas with a fresh lease and a live engine, "
                      "as the autoscaler last counted them"),
    "tfos_autoscale_replicas_target":
        ("gauge", "", "replica count the autoscaler currently wants "
                      "(live adjusted by its latest decision)"),
    # -- feed plane (DataFeed registry; BEAT-piggybacked to the driver) --
    "tfos_feed_stage_seconds":
        ("counter", "stage", "host-side feed wall seconds per stage "
                             "(ring_wait / queue_wait / decode / gather "
                             "/ device_put)"),
    "tfos_feed_stage_samples":
        ("counter", "stage", "samples behind tfos_feed_stage_seconds"),
    "tfos_feed_records":
        ("counter", "", "records consumed off the feed transport"),
    "tfos_feed_chunks":
        ("counter", "", "chunks consumed off the feed transport"),
    "tfos_feed_batches":
        ("counter", "", "non-empty batches served to the trainer"),
    "tfos_feed_staging_alloc":
        ("counter", "", "staging-buffer allocations (gather path)"),
    "tfos_feed_staging_reuse":
        ("counter", "", "staging-buffer reuses (gather path)"),
    # -- cluster rollup (reservation server's driver-side /metrics) --
    "tfos_cluster_executors":
        ("gauge", "", "executors with a live heartbeat lease"),
    "tfos_cluster_train_step":
        ("gauge", "executor", "last training step each executor beat"),
    "tfos_cluster_feed_hb_batches":
        ("gauge", "executor", "DataFeed batches-served progress counter"),
    "tfos_cluster_lease_age_seconds":
        ("gauge", "executor", "seconds since each executor's last beat"),
    "tfos_cluster_width":
        ("gauge", "", "executors in the live formation (elastic resize "
                      "shrinks/grows this)"),
    "tfos_cluster_width_target":
        ("gauge", "", "the job's configured width (width < target means "
                      "running degraded after a shrink)"),
    # -- goodput plane (goodput.py; rides the feed registry's BEAT
    # snapshot; rendered per-executor on the driver /metrics) --
    "tfos_badput_seconds":
        ("counter", "stage", "non-productive wall seconds per badput "
                             "category (compile / checkpoint_save / "
                             "restore / reform / resize_drain / "
                             "feed_wait / idle)"),
    "tfos_badput_samples":
        ("counter", "stage", "samples behind tfos_badput_seconds"),
    "tfos_goodput_productive_seconds":
        ("counter", "", "wall seconds spent in productive training "
                        "steps (the goodput numerator)"),
    "tfos_goodput_steps":
        ("counter", "", "productive training steps accounted by the "
                        "goodput ledger"),
    "tfos_goodput_ratio":
        ("gauge", "", "productive_seconds / ledger wall time (per "
                      "process; derive cluster ratios from the summed "
                      "seconds, not by summing this gauge)"),
    "tfos_goodput_step_ewma_seconds":
        ("gauge", "", "EWMA of recent productive step wall times (the "
                      "straggler detector's per-executor signal)"),
    "tfos_goodput_wall_seconds":
        ("gauge", "", "the ledger's measured wall time, published "
                      "atomically with its categories — verify "
                      "sum(categories) == this against one snapshot"),
    "tfos_train_step_skew":
        ("gauge", "executor", "executor step-time EWMA / fleet "
                              "lower-median (driver-computed; the "
                              "SLOW straggler signature — a STALLED "
                              "executor's EWMA freezes, so stalls "
                              "surface via the straggler incident, "
                              "not this gauge)"),
    # -- trace plane (FlightRecorder ring saturation) --
    "tfos_trace_spans_dropped":
        ("counter", "", "span events evicted from the FlightRecorder "
                        "ring (capacity overflow — raise capacity or "
                        "dump more often if this grows)"),
    # -- KV shipping plane --
    "tfos_kv_ship_bytes":
        ("counter", "", "PHYSICAL bytes of KV shipments successfully "
                        "delivered from this replica (codes + scales "
                        "as transferred — an int8 pool ships ~3.2x "
                        "fewer bytes than the dequantized size; never "
                        "priced logically)"),
    "tfos_kv_ship_blocks":
        ("counter", "", "KV blocks successfully shipped from this "
                        "replica to a decode-tier peer"),
    "tfos_kv_spliced_bytes":
        ("counter", "", "physical bytes of NOVEL shipped rows spliced "
                        "into this replica's pool (dedupe-skipped "
                        "blocks contribute nothing)"),
    "tfos_kv_spliced_blocks":
        ("counter", "", "shipped blocks adopted into this replica's "
                        "pool by block-table splice"),
    "tfos_kv_ship_ms":
        ("histogram", "", "wall milliseconds per successful shipment "
                          "(pack + transport + splice verdict, as the "
                          "shipping side observes it)"),
    "tfos_splice_failures":
        ("counter", "reason", "shipments this replica refused or "
                              "failed to splice, by bounded reason "
                              "(fenced / block_size / kv_dtype / "
                              "pool_exhausted / malformed / unpaged / "
                              "engine) — 'fenced' growing means a "
                              "retired incarnation is still shipping"),
    # -- control-plane survivability --
    "tfos_serving_beat_reconnects":
        ("counter", "", "beat-loop reconnects to the reservation "
                        "server (bounded jittered retry after a "
                        "connection-level beat failure; the lease "
                        "re-registers with its SAME epoch)"),
    "tfos_control_epoch":
        ("gauge", "", "current control epoch (router leadership "
                      "fence) as the reservation server publishes it; "
                      "absent until one is minted"),
    "tfos_control_recovery_pending":
        ("gauge", "", "journal-seeded identities a restarted "
                      "reservation server is still waiting to hear "
                      "re-announce (0 once recovery completes or the "
                      "grace window expires)"),
    "tfos_control_takeovers":
        ("counter", "", "warm-standby router takeovers (leader death "
                        "detected -> higher control epoch minted -> "
                        "standby serving)"),
    "tfos_control_admin_rejections":
        ("counter", "", "admin RPCs a replica refused 409 "
                        "ControlFenced because the caller stamped a "
                        "control epoch below the replica's floor (a "
                        "deposed driver is still issuing writes)"),
    # -- serving SLO plane (slo.py) ------------------------------------
    "tfos_fleet_affinity_resets":
        ("counter", "reason", "times a router came up with an EMPTY "
                              "AffinityMap over a fleet that already "
                              "held serving sessions (takeover = warm-"
                              "standby promotion, restart = same-name "
                              "router restart): the honest explanation "
                              "for a warm-hit-rate dip after failover"),
    "tfos_slo_error_budget_remaining":
        ("gauge", "slo,tenant", "fraction of the error budget left "
                                "over the slowest window (1 - burn); "
                                "negative when the budget is spent"),
    "tfos_slo_burn_rate":
        ("gauge", "slo,tenant,window", "error-budget burn multiple per "
                                       "window (1.0 = spending exactly "
                                       "the budget)"),
    "tfos_slo_alerts":
        ("counter", "slo", "burn-rate alert raises per SLO (clears do "
                           "not decrement; the count is incident "
                           "history)"),
    "tfos_slo_canary_probes":
        ("counter", "", "synthetic canary probes issued through the "
                        "real router path under the reserved "
                        "low-priority canary tenant"),
    "tfos_slo_canary_failures":
        ("counter", "", "canary probes that failed (non-200 or "
                        "transport error): black-box availability"),
    "tfos_slo_canary_drift":
        ("counter", "", "canary probes whose temp=0 output diverged "
                        "from the pinned expected tokens: bitwise "
                        "correctness alert"),
    "tfos_slo_attrib_router_overhead_seconds":
        ("histogram", "", "per-request seconds attributed to router "
                          "work (dispatch minus upstream residency)"),
    "tfos_slo_attrib_queue_wait_seconds":
        ("histogram", "", "per-request seconds attributed to the "
                          "engine admission queue"),
    "tfos_slo_attrib_admission_seconds":
        ("histogram", "", "per-request seconds inside the engine "
                          "request span not covered by a deeper stage "
                          "(scheduler bookkeeping)"),
    "tfos_slo_attrib_prefill_seconds":
        ("histogram", "", "per-request seconds attributed to prefill"),
    "tfos_slo_attrib_kv_ship_seconds":
        ("histogram", "", "per-request seconds attributed to KV-block "
                          "pack/ship/splice (disaggregated path)"),
    "tfos_slo_attrib_decode_seconds":
        ("histogram", "", "per-request seconds attributed to decode "
                          "slot residency"),
    "tfos_slo_attrib_preempted_seconds":
        ("histogram", "", "per-request seconds spent evicted between "
                          "preemption and re-admission"),
    "tfos_slo_attrib_hedge_wait_seconds":
        ("histogram", "", "per-request seconds where two upstream "
                          "attempts raced (hedge launched, winner "
                          "undecided)"),
}


class Histogram(object):
    """Fixed log-bucket latency histogram with ``quantile(q)``.

    Buckets are geometric: bounds ``lo * growth**i`` for ``i`` in
    ``range(n)`` plus a +Inf overflow, so relative quantile error is
    bounded by ``growth`` (the bucket resolution) across the whole
    range — the property that lets one fixed layout serve microsecond
    decode steps and minute-long drains alike. Defaults: 100us .. ~1h
    at sqrt(2) growth = 52 buckets of int, a few hundred bytes.

    Single-writer convention like :class:`Counters`: the owning
    scheduler thread observes; readers take snapshots / quantiles, and
    the unlocked int adds are benign under the GIL. Observations
    outside the range clamp into the edge buckets; exact ``min``/
    ``max`` are tracked so clamped tails still report honestly.
    """

    __slots__ = ("lo", "growth", "_bounds", "_counts", "_sum", "_n",
                 "_min", "_max", "_exemplars")

    def __init__(self, lo=1e-4, hi=3600.0, growth=math.sqrt(2.0)):
        self.lo = float(lo)
        self.growth = float(growth)
        n = int(math.ceil(math.log(float(hi) / self.lo)
                          / math.log(self.growth))) + 1
        self._bounds = [self.lo * self.growth ** i for i in range(n)]
        self._counts = [0] * (n + 1)  # +1: the +Inf overflow bucket
        self._sum = 0.0
        self._n = 0
        self._min = None
        self._max = None
        # bucket index -> (trace_id, value): the LAST traced sample per
        # bucket, emitted as an OpenMetrics exemplar so a scraped p99
        # bucket links straight to a loadable trace
        self._exemplars = {}

    def observe(self, value, trace=None):
        """Record one sample (seconds); ``trace`` attaches the trace id
        as that bucket's exemplar."""
        value = float(value)
        self._sum += value
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
            # log-position, then the forward scan only to absorb float
            # edge error: O(1) in practice
            i = int(math.log(value / self.lo) / math.log(self.growth))
            i = max(0, min(i, len(self._bounds) - 1))
            while self._bounds[i] < value:
                i += 1
        self._counts[i] += 1
        if trace:
            self._exemplars[i] = (int(trace), value)

    @property
    def count(self):
        return self._n

    @property
    def sum(self):
        return self._sum

    def quantile(self, q):
        """Approximate q-quantile (seconds); None when empty. Error is
        bounded by one bucket (a factor of ``growth``): the returned
        value log-interpolates within the quantile's bucket and clamps
        to the observed min/max, so degenerate single-value
        distributions come back exact."""
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
                if i == len(self._bounds):  # overflow bucket
                    value = self._max
                else:
                    upper = self._bounds[i]
                    lower = upper / self.growth
                    frac = (rank - cum) / float(c)
                    value = lower * self.growth ** frac
                return min(max(value, self._min), self._max)
            cum += c
        return self._max

    def snapshot(self):
        """Compact JSON-able state (mergeable via
        :func:`merge_snapshots` when the layouts match)."""
        snap = {"lo": self.lo, "growth": self.growth,
                "counts": list(self._counts),
                "sum": self._sum, "n": self._n,
                "min": self._min, "max": self._max}
        if self._exemplars:
            snap["exemplars"] = {i: list(ex)
                                 for i, ex in self._exemplars.items()}
        return snap


def snapshot_quantile(snap, q):
    """Approximate q-quantile from a :meth:`Histogram.snapshot` dict —
    the same bucket math as :meth:`Histogram.quantile`, usable on
    snapshots that crossed the BEAT wire (the autoscaler prices a
    replica's TTFT p99 from its lease-carried snapshot without
    reconstructing a Histogram). None when the snapshot is empty or
    malformed."""
    try:
        n = int(snap["n"])
        counts = snap["counts"]
        lo, growth = float(snap["lo"]), float(snap["growth"])
        smin, smax = snap.get("min"), snap.get("max")
    except (TypeError, KeyError, ValueError):
        return None
    if not n:
        return None
    q = float(q)
    if q <= 0.0:
        return smin
    if q >= 1.0:
        return smax
    rank = max(1, int(math.ceil(q * n)))
    cum = 0
    n_bounds = len(counts) - 1
    for i, c in enumerate(counts):
        if not c:
            continue
        if cum + c >= rank:
            if i == n_bounds:  # overflow bucket
                value = smax
            else:
                upper = lo * growth ** i
                lower = upper / growth
                value = lower * growth ** ((rank - cum) / float(c))
            if smin is not None:
                value = max(value, smin)
            if smax is not None:
                value = min(value, smax)
            return value
        cum += c
    return smax


def _fmt(value):
    """OpenMetrics sample value: ints verbatim, floats shortest-round."""
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    return repr(float(value))


def _labels(pairs):
    if not pairs:
        return ""
    return "{" + ",".join('{}="{}"'.format(k, v) for k, v in pairs) + "}"


class MetricsRegistry(object):
    """Named home for one plane's Counters / StageTimers / Histograms.

    Three jobs:

    - :meth:`render` — OpenMetrics text exposition (``GET /metrics``):
      every registered metric under a stable, cataloged family name
      (see :data:`METRIC_FAMILIES`), terminated with ``# EOF``.
    - :meth:`snapshot` — the compact JSON-able form executors piggyback
      on BEAT heartbeat leases; :func:`merge_snapshots` folds many into
      a cluster rollup.
    - lookup — ``histogram(name)`` creates-or-returns, so bench.py and
      the profile scripts read p50/p95/p99 from the same instances the
      engine writes (no private sample lists).

    Registration is idempotent by name (a respawned engine re-adds the
    same shared objects).
    """

    def __init__(self):
        self._counters = {}   # prefix -> Counters
        self._timers = {}     # family stem -> StageTimers
        self._hists = {}      # family -> Histogram
        self._hooks = []      # zero-arg callables run before snapshot

    # -- registration / lookup -------------------------------------------

    def add_hook(self, fn):
        """Register a zero-arg callable run before every
        :meth:`snapshot` (and therefore every :meth:`render`): the
        sync point for values that live outside the registered objects
        — a FlightRecorder's ``dropped`` tally mirrored into a
        counter, a goodput ledger charging its open interval — so a
        scrape or BEAT-carried snapshot is current, not
        last-event-stale. Hooks must be cheap and never raise
        (failures are logged and swallowed). Idempotent per callable."""
        if fn not in self._hooks:
            self._hooks.append(fn)
        return fn

    def add_counters(self, prefix, counters):
        """Expose ``counters`` as ``<prefix>_<key>`` families: counts
        render as ``<prefix>_<key>_total`` counters, gauges as plain
        ``<prefix>_<key>`` gauges."""
        self._counters[prefix] = counters
        return counters

    def add_timers(self, stem, timers):
        """Expose ``timers`` as two stage-labeled counter families:
        ``<stem>_seconds_total{stage=...}`` and
        ``<stem>_samples_total{stage=...}``."""
        self._timers[stem] = timers
        return timers

    def histogram(self, family, **kwargs):
        """Create-or-return the histogram registered as ``family``."""
        hist = self._hists.get(family)
        if hist is None:
            hist = self._hists[family] = Histogram(**kwargs)
        return hist

    def get_histogram(self, family):
        return self._hists.get(family)

    # -- exposition -------------------------------------------------------

    def render(self, extra_labels=()):
        """OpenMetrics text of everything registered (ends ``# EOF``).

        ``extra_labels``: (key, value) pairs stamped on every sample —
        how the driver's cluster endpoint renders per-executor series
        from beat-carried snapshots under one family name."""
        return render_snapshot(self.snapshot(),
                               extra_labels=extra_labels)

    def snapshot(self):
        """Compact JSON-able state: {"counters": {prefix: ...},
        "timers": {stem: {"t": ..., "n": ...}}, "hists": {family: ...}}.
        Safe to ship over the JSON reservation wire (BEAT payloads)."""
        for hook in self._hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 - exposition must survive
                logger.debug("registry snapshot hook failed",
                             exc_info=True)
        return {
            "counters": {p: c.snapshot()
                         for p, c in self._counters.items()},
            "timers": {s: {"t": t.snapshot(), "n": t.counts()}
                       for s, t in self._timers.items()},
            "hists": {f: h.snapshot() for f, h in self._hists.items()},
        }


def render_snapshot(snapshot, extra_labels=()):
    """OpenMetrics text from a :meth:`MetricsRegistry.snapshot` dict.

    Shared by live registries (``MetricsRegistry.render``) and the
    driver-side cluster endpoint, which renders snapshots that crossed
    the BEAT wire. Families render in sorted order; output ends with
    the OpenMetrics ``# EOF`` terminator.
    """
    return _render([(tuple(extra_labels), snapshot)])


def _render(labeled_snapshots):
    """OpenMetrics text for many (labels, snapshot) pairs: each family
    appears ONCE (the grammar's rule), carrying one labeled sample set
    per snapshot — how N executors' beat-carried snapshots expose as N
    ``executor``-labeled series under shared family names."""
    lines = []

    def _family(name, ftype):
        meta = METRIC_FAMILIES.get(name)
        lines.append("# TYPE {} {}".format(name, ftype))
        if meta and meta[2]:
            lines.append("# HELP {} {}".format(name, meta[2]))

    def _union(section, *path):
        keys = set()
        for _, snapshot in labeled_snapshots:
            node = snapshot.get(section) or {}
            for p in path:
                node = node.get(p, {}) if isinstance(node, dict) else {}
            keys |= set(node)
        return sorted(keys)

    for prefix in _union("counters"):
        for key in _union("counters", prefix, "counts"):
            name = "{}_{}".format(prefix, key)
            _family(name, "counter")
            for extra, snapshot in labeled_snapshots:
                counts = (snapshot.get("counters", {}).get(prefix) or
                          {}).get("counts") or {}
                if key in counts:
                    lines.append("{}_total{} {}".format(
                        name, _labels(extra), _fmt(counts[key])))
        for key in _union("counters", prefix, "gauges"):
            name = "{}_{}".format(prefix, key)
            _family(name, "gauge")
            for extra, snapshot in labeled_snapshots:
                gauges = (snapshot.get("counters", {}).get(prefix) or
                          {}).get("gauges") or {}
                if key in gauges:
                    lines.append("{}{} {}".format(
                        name, _labels(extra), _fmt(gauges[key])))
    for stem in _union("timers"):
        for suffix, part in (("seconds", "t"), ("samples", "n")):
            name = "{}_{}".format(stem, suffix)
            _family(name, "counter")
            for extra, snapshot in labeled_snapshots:
                values = (snapshot.get("timers", {}).get(stem) or
                          {}).get(part) or {}
                for stage in sorted(values):
                    lines.append("{}_total{} {}".format(
                        name, _labels((("stage", stage),) + extra),
                        _fmt(values[stage])))
    for family in _union("hists"):
        _family(family, "histogram")
        for extra, snapshot in labeled_snapshots:
            snap = (snapshot.get("hists") or {}).get(family)
            if snap is None:
                continue
            bounds = [snap["lo"] * snap["growth"] ** i
                      for i in range(len(snap["counts"]) - 1)]
            # exemplar keys arrive as ints locally but as strings after
            # a JSON round-trip (beat wire); normalise once
            exemplars = {int(k): v for k, v in
                         (snap.get("exemplars") or {}).items()}

            def _exemplar(index):
                ex = exemplars.get(index)
                if not ex:
                    return ""
                return ' # {{trace_id="{}"}} {}'.format(
                    ex[0], _fmt(ex[1]))

            cum = 0
            for i, (bound, count) in enumerate(zip(bounds,
                                                   snap["counts"])):
                cum += count
                lines.append("{}_bucket{} {}{}".format(
                    family,
                    _labels((("le", "{:.6g}".format(bound)),) + extra),
                    cum, _exemplar(i)))
            lines.append("{}_bucket{} {}{}".format(
                family, _labels((("le", "+Inf"),) + extra),
                cum + snap["counts"][-1],
                _exemplar(len(snap["counts"]) - 1)))
            lines.append("{}_sum{} {}".format(
                family, _labels(extra), _fmt(snap["sum"])))
            lines.append("{}_count{} {}".format(
                family, _labels(extra), _fmt(snap["n"])))
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def render_labeled(labeled_snapshots):
    """OpenMetrics text for many ``(label_pairs, snapshot)`` sets under
    the one grammar-correct multi-snapshot core (each family appears
    ONCE, carrying one labeled sample set per snapshot). How the fleet
    router exposes its own registry plus every replica's beat-carried
    engine snapshot as ``replica``-labeled series in a single
    document."""
    return _render([(tuple(labels), snap)
                    for labels, snap in labeled_snapshots])


def merge_snapshots(snapshots):
    """Fold many :meth:`MetricsRegistry.snapshot` dicts into one rollup.

    Counts, gauges, timer totals, and histogram buckets SUM (a gauge
    sum is the cluster-wide total — queue depth across replicas, slots
    occupied across engines); histogram layouts must match to merge
    (mismatched layouts keep the first and log). The cluster view
    ``cluster.metrics()`` returns is built from this.
    """
    out = {"counters": {}, "timers": {}, "hists": {}}
    for snap in snapshots:
        if not snap:
            continue
        for prefix, c in (snap.get("counters") or {}).items():
            dst = out["counters"].setdefault(
                prefix, {"counts": {}, "gauges": {}})
            for k, v in (c.get("counts") or {}).items():
                dst["counts"][k] = dst["counts"].get(k, 0) + v
            for k, v in (c.get("gauges") or {}).items():
                dst["gauges"][k] = dst["gauges"].get(k, 0) + v
        for stem, t in (snap.get("timers") or {}).items():
            dst = out["timers"].setdefault(stem, {"t": {}, "n": {}})
            for k, v in (t.get("t") or {}).items():
                dst["t"][k] = dst["t"].get(k, 0.0) + v
            for k, v in (t.get("n") or {}).items():
                dst["n"][k] = dst["n"].get(k, 0) + v
        for family, h in (snap.get("hists") or {}).items():
            dst = out["hists"].get(family)
            if dst is None:
                out["hists"][family] = {
                    k: (list(v) if isinstance(v, list) else v)
                    for k, v in h.items()}
                continue
            if (dst["lo"], dst["growth"], len(dst["counts"])) != \
                    (h["lo"], h["growth"], len(h["counts"])):
                logger.warning("histogram %s layouts differ; keeping "
                               "the first snapshot's", family)
                continue
            dst["counts"] = [a + b for a, b in zip(dst["counts"],
                                                   h["counts"])]
            dst["sum"] += h["sum"]
            dst["n"] += h["n"]
            for k, pick in (("min", min), ("max", max)):
                if h.get(k) is not None:
                    dst[k] = h[k] if dst.get(k) is None \
                        else pick(dst[k], h[k])
    return out


def cluster_rollup(per_executor):
    """{eid: lease-ish view} -> the ``cluster.metrics()`` shape:
    ``{"executors": per_executor, "cluster": {executors, train_step,
    merged}}`` where ``merged`` sums every executor's beat-carried
    registry snapshot (:func:`merge_snapshots`)."""
    return {
        "executors": per_executor,
        "cluster": {
            "executors": len(per_executor),
            "train_step": {eid: view.get("train_step")
                           for eid, view in per_executor.items()},
            "merged": merge_snapshots(
                [view.get("metrics") for view in per_executor.values()]),
        },
    }


def render_cluster(per_executor, cluster_gauges=None):
    """OpenMetrics text for the driver-side cluster endpoint: the
    cluster gauges plus every executor's snapshot re-rendered under an
    ``executor`` label (one family, N labeled series — the shape a
    Prometheus scrape aggregates itself). ``cluster_gauges`` adds
    server-level gauge families ({family: value} — the elastic-resize
    width gauges ride this)."""
    lines = ["# TYPE tfos_cluster_executors gauge",
             "tfos_cluster_executors {}".format(len(per_executor))]
    for family in sorted(cluster_gauges or {}):
        lines.append("# TYPE {} gauge".format(family))
        lines.append("{} {}".format(family,
                                    _fmt(cluster_gauges[family])))
    for name, key in (("tfos_cluster_train_step", "train_step"),
                      ("tfos_cluster_feed_hb_batches", "feed_hb"),
                      ("tfos_cluster_lease_age_seconds", "age"),
                      # goodput plane: per-executor step-time skew vs
                      # the fleet median (goodput.attach_step_skew
                      # annotates the views before this render)
                      ("tfos_train_step_skew", "step_skew")):
        samples = [(eid, view.get(key))
                   for eid, view in sorted(per_executor.items())
                   if view.get(key) is not None]
        if not samples:
            continue
        lines.append("# TYPE {} gauge".format(name))
        for eid, value in samples:
            lines.append("{}{} {}".format(
                name, _labels((("executor", eid),)), _fmt(value)))
    body = "\n".join(lines) + "\n"
    labeled = [((("executor", eid),), view["metrics"])
               for eid, view in sorted(per_executor.items())
               if view.get("metrics")]
    if labeled:
        body += _render(labeled).replace("# EOF\n", "")
    return body + "# EOF\n"


#: process-wide monotonic trace-id source (serving request timelines)
_TRACE_IDS = itertools.count(1)


def next_trace_id():
    """Fresh per-process trace id (int) for one request's span tree."""
    return next(_TRACE_IDS)


def mint_trace_id():
    """Fresh trace id for CROSS-PROCESS propagation (the fleet
    router's ``X-TFOS-Trace`` header): the local counter offset by a
    pid-derived high field, so a router-minted id adopted by a replica
    engine is vanishingly unlikely to collide with the replica's own
    locally-assigned ids (collisions are cosmetic — two requests
    sharing a Perfetto row — but a router that mints thousands should
    not alias replica-local rows systematically). The +1 keeps the
    salt NON-ZERO even when ``pid % 2048 == 0`` — a zero salt would
    make every minted id collide with the local ``next_trace_id``
    sequence, exactly the aliasing this exists to prevent. Stays an
    int: Chrome-trace ``tid`` fields must be numeric."""
    return (((os.getpid() & 0x7FF) + 1) << 20) \
        | (next(_TRACE_IDS) & 0xFFFFF)


class FlightRecorder(object):
    """Bounded ring of span events — the serving plane's black box.

    Every serving request gets a trace id at admission; the engine
    lands its span events (admit -> queue -> prefill -> decode ->
    finish/evict/shed) here, and :meth:`chrome_trace` renders the ring
    as Chrome trace-event JSON that loads directly in Perfetto /
    chrome://tracing (``GET /debug/trace``, scripts/trace_dump.py).
    Supervision milestones mirror in as instant events (EventLog), so
    the tail a Supervisor dumps into incident evidence reads as one
    interleaved timeline.

    Ring semantics: ``capacity`` most recent events are kept (default
    4096); overflow evicts oldest and counts into :attr:`dropped` —
    recording is always O(1) and memory is bounded no matter how long
    the process serves. Thread-safe appends (scheduler thread, HTTP
    handlers, and the supervisor all write).
    """

    def __init__(self, capacity=4096):
        self._events = collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self.dropped = 0
        #: trace epoch: ts fields are microseconds since this instant
        self.epoch = time.monotonic()
        #: the wall-clock time of ``epoch`` — what lets two processes'
        #: dumps be stitched onto one timeline (:func:`stitch_traces`):
        #: monotonic clocks have per-process zero points, wall clocks
        #: share one (to host clock sync)
        self.epoch_wall = time.time() - (time.monotonic() - self.epoch)

    def _append(self, event):
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(event)

    def _ts(self, t):
        return int((t - self.epoch) * 1e6)

    @staticmethod
    def _clean(args):
        """Chrome-trace args must be JSON-able; coerce anything exotic
        (an exception object in an evict arg, say) to str."""
        out = {}
        for k, v in args.items():
            if isinstance(v, (str, int, float, bool, type(None))):
                out[k] = v
            elif isinstance(v, (list, tuple)):
                out[k] = [x if isinstance(x, (str, int, float, bool,
                                              type(None))) else str(x)
                          for x in v]
            else:
                out[k] = str(v)
        return out

    def span(self, name, t0, t1, trace=0, **args):
        """One complete ('X') span: [t0, t1] monotonic seconds, on the
        row of request ``trace`` (tid). Returns the event dict."""
        event = {"name": name, "ph": "X", "ts": self._ts(t0),
                 "dur": max(self._ts(t1) - self._ts(t0), 0),
                 "pid": os.getpid(), "tid": int(trace),
                 "args": self._clean(args)}
        self._append(event)
        return event

    def instant(self, name, trace=0, **args):
        """One instant ('i') event at now, on ``trace``'s row."""
        event = {"name": name, "ph": "i", "s": "t",
                 "ts": self._ts(time.monotonic()),
                 "pid": os.getpid(), "tid": int(trace),
                 "args": self._clean(args)}
        self._append(event)
        return event

    def events(self):
        with self._lock:
            return list(self._events)

    def tail(self, n=64):
        """Most recent ``n`` events, oldest first — the incident dump
        the Supervisor attaches to failure evidence."""
        with self._lock:
            events = list(self._events)
        return events[-int(n):]

    def clear(self):
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def chrome_trace(self, events=None):
        """{"traceEvents": [...]} — the Chrome trace-event JSON object
        Perfetto loads. Adds thread_name metadata so each request's
        trace id renders as a labeled row."""
        events = self.events() if events is None else list(events)
        pid = os.getpid()
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "ts": 0, "args": {"name": "tfos"}}]
        for tid in sorted({e["tid"] for e in events}):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "ts": 0,
                         "args": {"name": "engine" if tid == 0
                                  else "request {}".format(tid)}})
        # epochWall/dropped: top-level metadata Perfetto ignores but
        # stitch_traces (cross-process timeline alignment) and the
        # router's /debug/trace saturation header read
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "epochWall": self.epoch_wall, "dropped": self.dropped}


def expose_flight_drops(registry, flight):
    """Surface ``flight.dropped`` — span events the bounded ring
    evicted — as the ``tfos_trace_spans_dropped`` counter family on
    ``registry``: a snapshot hook mirrors the live tally, so every
    scrape (and every BEAT-carried snapshot) reports ring saturation
    instead of losing spans silently. Returns the backing Counters."""
    counters = registry.add_counters(
        "tfos_trace", registry._counters.get("tfos_trace") or Counters())
    # ONE hook per registry, summing over every ring ever exposed on
    # it: re-exposure of a known ring is a no-op (a respawned engine
    # shares registry AND ring, and a fresh closure per respawn would
    # defeat add_hook's identity check — N restarts would pile up N
    # dead-engine hooks), while genuinely distinct rings accumulate
    # instead of last-write-wins clobbering each other's tally
    sources = getattr(registry, "_flight_drop_sources", None)
    if sources is None:
        sources = registry._flight_drop_sources = []

        def _sync():
            counters.set_count("spans_dropped",
                               sum(f.dropped for f in sources))

        registry.add_hook(_sync)
    if not any(f is flight for f in sources):
        sources.append(flight)
    return counters


def stitch_traces(labeled_docs):
    """Fold several ``chrome_trace`` documents — typically from
    DIFFERENT processes (a fleet router + its replicas) — into one
    Perfetto-loadable timeline.

    ``labeled_docs``: [(label, doc)] pairs. Each source becomes its own
    Chrome-trace PROCESS (synthetic pid = source index, process_name =
    label) — in-process fleets share a real pid, and distinct synthetic
    pids keep each source's rows grouped under its label either way.
    Timestamps are aligned onto the FIRST doc's epoch via each doc's
    ``epochWall`` (docs without one pass through unshifted), so a
    request that failed over between replicas reads as one causal
    timeline: its spans share a trace id (tid) across sources.

    Returns {"traceEvents": [...], "displayTimeUnit": "ms",
    "dropped": {label: n}} — ``dropped`` carries each source ring's
    eviction tally (the saturation signal ``X-TFOS-Trace-Dropped``
    sums)."""
    out = []
    dropped = {}
    base_wall = None
    for label, doc in labeled_docs:
        wall = doc.get("epochWall")
        if base_wall is None and wall is not None:
            base_wall = wall
    for idx, (label, doc) in enumerate(labeled_docs):
        wall = doc.get("epochWall")
        shift = 0 if wall is None or base_wall is None \
            else int((wall - base_wall) * 1e6)
        dropped[str(label)] = int(doc.get("dropped") or 0)
        out.append({"name": "process_name", "ph": "M", "pid": idx,
                    "tid": 0, "ts": 0, "args": {"name": str(label)}})
        for event in doc.get("traceEvents") or ():
            event = dict(event)
            event["pid"] = idx
            if event.get("ph") != "M":
                event["ts"] = int(event.get("ts", 0)) + shift
            elif event.get("name") == "process_name":
                continue  # replaced by the labeled row above
            out.append(event)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "dropped": dropped}


_FLIGHT = FlightRecorder()


def flight_recorder():
    """The process-global :class:`FlightRecorder` — the default black
    box every plane shares unless handed its own instance."""
    return _FLIGHT


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


