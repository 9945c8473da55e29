"""The port's serving fleet (``tensorflowonspark_tpu_torch/fleet.py``)
held against the JAX package's.

- PURE policy — the reference's own unit cases of ``tests/test_fleet.py``
  (``serving.retry_call``, ``route_order``, ``digest_match``,
  ``affinity_order`` / ``affinity_plan``, ``AffinityMap``, the
  ``ReplicaHealth`` state machine, the fleet's locking pins and the
  reservation server's serving view) run on BOTH packages, and seeded
  random view tables with injected times go through both packages'
  policy functions, which must return equal outputs.
- E2E — the reference's tier-1 fleet cases run against the port (over
  real HTTP, the port's engines on the CPU, weights converted from the
  JAX params with ``convert.from_flax``), with every token held against
  the JAX package's ``generation.generate_jit``. Then the slice's own
  cases: a 2-replica fleet under concurrency, the rolling drain under
  traffic, failover from a killed scheduler, the two-stage prefill ->
  decode tiers, an executor-hosted fleet on an engine ``Context``
  (supervised: its replicas' leases classified), ``cluster.serving_fleet``
  with the policy planes armed, the module wire form at every float
  dtype, and the SLO monitor and canary prober against a live fleet.
- The reference's slow / chaos cases are mirrored under the same marks.

The widths are the reference test's (V 17, H 32, 4 heads, 2 layers,
max_len 48). ``reference_cases`` rebinds the reference's test functions
to the port's modules through thin shims that keep the reference's
``(model, params)`` call shape (``_Engine``, ``_Fleet``), put the port's
engines on the CPU, and hold ``_solo`` to the JAX package's generate.
"""

import contextlib
import copy
import glob
import inspect
import json
import os
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_qos
from tensorflowonspark_tpu import fleet as jfleet
from tensorflowonspark_tpu import paging as jpaging
from tensorflowonspark_tpu.models.decoder import DecoderLM as JDecoderLM
from tensorflowonspark_tpu_torch import (chaos, cluster, convert, fleet,
                                         paging, reservation, serving, slo,
                                         tracing)
from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

V, H, NH, L, MAXLEN = 17, 32, 4, 2, 48

#: the JAX decode module the reference's ``_solo`` runs
JDEC = JDecoderLM(vocab=V, hidden=H, num_heads=NH, num_layers=L,
                  max_len=MAXLEN, decode=True)


def jax_params():
    train = JDecoderLM(vocab=V, hidden=H, num_heads=NH, num_layers=L,
                       max_len=MAXLEN, decode=False)
    return train.init(jax.random.PRNGKey(7),
                      jnp.zeros((2, MAXLEN), jnp.int32))["params"]


def port_model(params):
    """The port's DecoderLM on the JAX params (``convert.from_flax``)."""
    m = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L, max_len=MAXLEN)
    m.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return m.eval()


#: (id(params), prompt, max_new) -> (params, tokens); holding params keeps
#: its id from being reused while the entry lives
_SOLO = {}


def jax_solo(params, prompt, max_new):
    """The JAX package's ``generate_jit`` tokens, memoized: every new
    (prompt, max_new) pair is a jit compile."""
    from tensorflowonspark_tpu import generation as jgen

    key = (id(params), tuple(prompt), int(max_new))
    if key not in _SOLO:
        out = jgen.generate_jit(JDEC, params,
                                jnp.asarray([prompt], jnp.int32), max_new)
        _SOLO[key] = (params, np.asarray(out)[0].tolist())
    return list(_SOLO[key][1])


# -- the reference's call shape over the port ------------------------------

class _Engine(serving.DecodeEngine):
    """``DecodeEngine(model, params, ...)`` as the reference's cases call
    it: ``params`` is already in the port module; the engine runs on the
    CPU unless told otherwise."""

    def __init__(self, model, params=None, *args, **kw):
        kw.setdefault("device", "cpu")
        super(_Engine, self).__init__(model, *args, **kw)


class _Fleet(fleet.ServingFleet):
    """``ServingFleet(model, params, ...)`` as the reference's cases call
    it, with the replicas' engines on the CPU."""

    def __init__(self, model, params=None, *args, **kw):
        kw["engine_kw"] = dict({"device": "cpu"}, **(kw.get("engine_kw")
                                                   or {}))
        super(_Fleet, self).__init__(model, *args, **kw)


def shim(module, **overrides):
    """A module object with ``module``'s names, ``overrides`` on top."""
    out = types.ModuleType(module.__name__ + "_shim")
    out.__dict__.update(module.__dict__)
    out.__dict__.update(overrides)
    return out


def port_namespace(filename, port_imports=False, **extra):
    """``(reference module, namespace)`` for ``tests/<filename>`` with its
    cases rebound to the port (see the module docstring)."""
    ref, ns = test_torch_qos.reference_cases(
        filename, port_imports=port_imports, chaos=chaos, paging=paging,
        reservation=reservation,
        tracing=tracing,
        serving=shim(serving, DecodeEngine=_Engine),
        fleet=shim(fleet, ServingFleet=_Fleet), **extra)
    ns["_solo"] = lambda dec, params, prompt, max_new: jax_solo(
        params, prompt, max_new)
    return ref, ns


def call_case(fn, lm, request):
    """Call a rebound case with the fixtures its signature names."""
    kw = {}
    for name in inspect.signature(fn).parameters:
        kw[name] = lm if name == "lm" else request.getfixturevalue(name)
    return fn(**kw)


REF, PORT = port_namespace("test_fleet.py")


@pytest.fixture(scope="module")
def lm():
    params = jax_params()
    return port_model(params), params


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    chaos.disarm()


#: the reference's unit cases that need no model: each runs on both
#: packages
PURE_CASES = (
    "test_retry_call_retries_only_retriable",
    "test_retry_call_bounded_attempts_and_backoff_growth",
    "test_retry_call_retry_after_jitter_spreads_synchronized_clients",
    "test_retry_call_full_jitter_bounded_by_envelope",
    "test_retry_call_honors_retry_after_floor_capped",
    "test_retry_call_zero_retry_after_fails_over_immediately",
    "test_http_retriable_mapping",
    "test_route_order_least_loaded",
    "test_route_order_router_inflight_counts_as_load",
    "test_route_order_queue_wait_breaks_equal_backlog",
    "test_route_order_deterministic_tie_break_by_id",
    "test_route_order_excludes_stale_dead_draining_down",
    "test_route_order_probe_ranks_after_every_healthy",
    "test_route_order_empty_when_nothing_routable",
    "test_digest_match_deepest_resident_chain",
    "test_digest_match_respects_each_views_block_size",
    "test_affinity_order_promotes_hint_then_deepest_digest",
    "test_affinity_load_guard_demotes_overloaded_warm_replica",
    "test_affinity_never_promotes_probe_and_fails_over_cold",
    "test_affinity_map_ttl_capacity_and_purge",
    "test_health_threshold_then_down_then_probe_then_recover",
    "test_health_probe_failure_redowns_with_escalated_cooldown",
    "test_health_success_resets_escalation",
    "test_health_cooldown_capped",
    "test_health_holds_are_owner_scoped",
    "test_health_quiesce_is_administrative_no_probe_path",
    "test_new_rid_concurrent_unique",
    "test_replica_lookup_survives_concurrent_churn",
    "test_re_register_never_loses_to_inflight_fence",
    "test_concurrent_executor_spawns_pick_distinct_executors",
    "test_replacement_can_reuse_the_corpses_own_executor",
    "test_reservation_serving_snapshot_and_stats_view",
    "test_router_404_and_healthz_unavailable_when_no_replicas",
)

#: the reference's tier-1 cases over a model: run on the port, tokens
#: held against the JAX package's generate
E2E_CASES = (
    "test_replica_id_stable_across_respawn",
    "test_default_replica_ids_are_distinct",
    "test_healthz_and_metrics_carry_replica_id",
    "test_engine_failed_503_carries_kind",
    "test_two_replica_fleet_routes_and_matches_solo",
    "test_draining_replica_excluded_by_its_own_beat",
    "test_client_disconnect_propagates_through_router",
    "test_fleet_stop_then_start_reforms",
    "test_router_mints_trace_and_debug_trace_stitches_replica",
    "test_session_affinity_sticky_routing_and_schema",
)


@pytest.mark.parametrize("case", PURE_CASES)
def test_reference_unit_case_on_both_packages(case, request):
    call_case(getattr(REF, case), None, request)
    chaos.disarm()
    call_case(PORT[case], None, request)


@pytest.mark.parametrize("case", E2E_CASES)
def test_reference_fleet_case_on_the_port(case, lm, request):
    call_case(PORT[case], lm, request)


# -- the pure policy on seeded tables: equal outputs -----------------------

def _random_views(rng, n, block_size, prompts):
    views = []
    for i in range(n):
        digest = []
        for prompt in prompts:
            if rng.rand() < 0.5:
                depth = int(rng.randint(1, len(prompt) // block_size + 1))
                digest.append([paging.chain_digest(
                    prompt, depth * block_size), depth])
        views.append({
            "replica_id": "replica-%d" % rng.randint(0, 2 * n),
            "age": None if rng.rand() < 0.1 else float(rng.rand() * 3),
            "alive": bool(rng.rand() > 0.1),
            "draining": bool(rng.rand() < 0.1),
            "queue_depth": int(rng.randint(0, 6)),
            "slot_occupancy": int(rng.randint(0, 5)),
            "slots": int(rng.choice([0, 4])),
            "inflight": int(rng.randint(0, 3)),
            "queue_wait_ewma_s": float(rng.choice([0.0, 0.01, 0.2])),
            "tier": str(rng.choice(["", "mixed", "prefill", "decode"])),
            "state": str(rng.choice(["up", "up", "down", "probe"])),
            "prefix_digest": digest,
            "prefix_digest_block_size": block_size,
        })
    return views


@pytest.mark.parametrize("seed", range(6))
def test_policy_functions_equal_on_seeded_tables(seed):
    rng = np.random.RandomState(seed)
    block = int(rng.choice([4, 8, 16]))
    prompts = [rng.randint(0, V, size=int(rng.randint(1, 60))).tolist()
               for _ in range(4)]
    for _ in range(25):
        views = _random_views(rng, int(rng.randint(0, 6)), block, prompts)
        stale = float(rng.choice([0.5, 2.0, 5.0]))
        guard = int(rng.randint(0, 6))
        assert fleet.route_order(views, stale) == \
            jfleet.route_order(views, stale)
        assert [fleet.load_score(v) for v in views] == \
            [jfleet.load_score(v) for v in views]
        assert [fleet.view_tier(v) for v in views] == \
            [jfleet.view_tier(v) for v in views]
        assert fleet.decode_eligible(views) == jfleet.decode_eligible(views)
        for prompt in prompts:
            matches = {str(v["replica_id"]): fleet.digest_match(v, prompt)
                       for v in views}
            assert matches == {str(v["replica_id"]):
                               jfleet.digest_match(v, prompt)
                               for v in views}
            hint = str(rng.choice(["replica-0", "replica-3", "none"]))
            assert fleet.affinity_plan(views, matches, hint, stale, guard) \
                == jfleet.affinity_plan(views, matches, hint, stale, guard)
            assert fleet.affinity_order(views, matches, None, stale,
                                        guard) == \
                jfleet.affinity_order(views, matches, None, stale, guard)


def test_chain_digest_is_the_references():
    """``digest_match`` hashes with the port's ``paging.chain_digest``,
    the hash the port's pool publishes with: it must be the reference's,
    or a mixed fleet's prefix affinity would never match."""
    rng = np.random.RandomState(3)
    for _ in range(200):
        toks = rng.randint(0, 50257, size=int(rng.randint(1, 80))).tolist()
        n = int(rng.randint(0, len(toks) + 1))
        assert paging.chain_digest(toks, n) == jpaging.chain_digest(toks, n)


@pytest.mark.parametrize("seed", range(3))
def test_pool_digest_equals_the_references_through_seeded_churn(seed):
    """The digest a replica beats (``BlockPool.prefix_digest``, which
    the port memoizes between pool changes) equals the reference pool's
    after every step of one seeded stream of admissions (prefix hits,
    allocation with eviction, registration), releases, cache drops and
    walks that admit nothing (hit tallies without a pool change), read
    at two digest widths, each twice."""
    rng = np.random.RandomState(seed)
    bs = 4
    pools = (paging.BlockPool(14, bs), jpaging.BlockPool(14, bs))
    base = [rng.randint(0, V, size=int(rng.randint(5, 26))).tolist()
            for _ in range(5)]
    live = []  # one block list per admitted request, shared by both
    for _ in range(300):
        op = rng.rand()
        if op < 0.55:
            toks = list(base[rng.randint(len(base))])
            toks = toks[:int(rng.randint(1, len(toks) + 1))]
            blocks = []
            for pool in pools:
                ids = pool.match_prefix(toks)
                need = pool.blocks_for(len(toks)) - len(ids)
                pool.acquire(ids)
                if pool.allocatable() < need:
                    pool.release(ids)
                    blocks.append(None)
                    continue
                got = ids + pool.alloc(need)
                for j in range(len(ids), len(toks) // bs):
                    pool.register(toks, (j + 1) * bs, got[j])
                blocks.append(got)
            assert (blocks[0] is None) == (blocks[1] is None)
            if blocks[0] is not None:
                assert blocks[0] == blocks[1]
                live.append(blocks[0])
        elif op < 0.9 and live:
            done = live.pop(rng.randint(len(live)))
            for pool in pools:
                pool.release(done)
        elif op >= 0.97:
            assert pools[0].drop_cache() == pools[1].drop_cache()
        elif op >= 0.9:
            # a walk that admits nothing still tallies chain hits
            toks = base[rng.randint(len(base))]
            assert pools[0].match_prefix(toks) == pools[1].match_prefix(toks)
        # the default width first: the memo of the last step's final read
        # must not survive this step's change
        for top_k in (None, 3, 3, None):
            kw = {} if top_k is None else {"top_k": top_k}
            assert pools[0].prefix_digest(**kw) == \
                pools[1].prefix_digest(**kw)


def test_forget_digest_makes_the_next_read_sort_again(monkeypatch):
    """A repeated ``prefix_digest`` read of an unchanged pool hashes no
    chain (the memo answers); after ``forget_digest`` the next read
    hashes every resident chain again and returns the same digest."""
    bs = 4
    pool = paging.BlockPool(8, bs)
    toks = list(range(1, 13))
    got = pool.alloc(pool.blocks_for(len(toks)))
    for j in range(len(toks) // bs):
        pool.register(toks, (j + 1) * bs, got[j])
    hashed = []
    real = paging.chain_digest
    monkeypatch.setattr(paging, "chain_digest",
                        lambda *a: hashed.append(a) or real(*a))
    first = pool.prefix_digest()
    assert len(hashed) == 3 and len(first["top"]) == 3
    assert pool.prefix_digest() == first and len(hashed) == 3
    pool.forget_digest()
    assert pool.prefix_digest() == first and len(hashed) == 6


@pytest.mark.parametrize("seed", range(3))
def test_health_and_affinity_map_equal_on_seeded_event_streams(seed):
    """One seeded stream of failures, successes, holds and readmits at
    injected times through both packages' ``ReplicaHealth``, and of
    notes, lookups and purges through both ``AffinityMap``s: every
    observable state is equal."""
    rng = np.random.RandomState(seed)
    clock = [0.0]
    hp = fleet.ReplicaHealth(fail_threshold=2, cooldown=0.5,
                             max_cooldown=4.0)
    hj = jfleet.ReplicaHealth(fail_threshold=2, cooldown=0.5,
                              max_cooldown=4.0)
    ap = fleet.AffinityMap(capacity=5, ttl_s=1.0, now=lambda: clock[0])
    aj = jfleet.AffinityMap(capacity=5, ttl_s=1.0, now=lambda: clock[0])
    rids = ["r0", "r1", "r2"]
    for _ in range(400):
        clock[0] += float(rng.rand() * 0.3)
        now = clock[0]
        rid = rids[rng.randint(3)]
        op = rng.randint(7)
        owner = str(rng.randint(2))
        for h in (hp, hj):
            if op == 0:
                h.note_failure(rid, now, reason="x")
            elif op == 1:
                h.note_success(rid, now)
            elif op == 2:
                h.quiesce(rid, owner=owner)
            elif op == 3:
                h.readmit(rid, owner=owner)
        key = "s%d" % rng.randint(8)
        if op in (4, 5):
            ap.note(key, rid, now)
            aj.note(key, rid, now)
        elif op == 6:
            assert ap.purge_replica(rid) == aj.purge_replica(rid)
        assert [hp.state(r, now) for r in rids] == \
            [hj.state(r, now) for r in rids]
        assert ap.lookup(key, now) == aj.lookup(key, now)
        assert len(ap) == len(aj)
    assert sorted(hp.known()) == sorted(hj.known())


def _wire_refusals(serving_mod, eng):
    """The four retriable/fencing refusals of ``eng`` behind a server of
    ``serving_mod`` over real HTTP: {kind: (status, body, headers)}."""
    srv = serving_mod.ModelServer(None, engine=eng, name="m", port=0)
    host, port = srv.start()
    url = "http://%s:%d/v1/models/m:generate" % (host, port)
    got = {}

    def post(payload):
        req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                     headers={"Content-Type":
                                              "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.read(), dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, e.read(), dict(e.headers)

    try:
        # a warm engine prices a deadline from its own EWMAs and sheds an
        # infeasible one at the door
        assert post({"prompt": [1, 2], "max_new_tokens": 4})[0] == 200
        eng._broken = RuntimeError("boom")
        got["EngineFailed"] = post({"prompt": [1, 2], "max_new_tokens": 2})
        eng._broken = None
        got["Shed"] = post({"prompt": [1, 2], "max_new_tokens": 40,
                            "deadline_s": 1e-9})
        srv.fence("superseded")
        got["Fenced"] = post({"prompt": [1, 2], "max_new_tokens": 2})
        srv.unfence()
        eng.drain()
        got["Draining"] = post({"prompt": [1, 2], "max_new_tokens": 2})
    finally:
        eng._broken = None
        srv.stop()
        eng.stop()
    return got


def test_retriable_kinds_on_the_wire_match_the_reference(lm):
    """The router's failover reads a refusal's ``kind`` and
    ``Retry-After`` (``FleetRouter._retriable_kind``): the port's server
    answers ``Shed``, ``Draining``, ``EngineFailed`` and ``Fenced`` with
    the JAX package's statuses, body keys and ``Retry-After`` presence,
    and both packages' classifiers read both servers' bodies alike."""
    from tensorflowonspark_tpu import serving as jserving

    model, params = lm
    port_got = _wire_refusals(
        serving, serving.DecodeEngine(model, slots=1, device="cpu"))
    jax_got = _wire_refusals(jserving,
                             jserving.DecodeEngine(JDEC, params, slots=1))
    assert sorted(port_got) == sorted(jax_got)
    for kind, (status, body, headers) in port_got.items():
        jstatus, jbody, jheaders = jax_got[kind]
        assert status == jstatus == (410 if kind == "Fenced" else 503)
        assert sorted(json.loads(body)) == sorted(json.loads(jbody)), kind
        assert ("Retry-After" in headers) == ("Retry-After" in jheaders)
        for raw in (body, jbody):
            assert fleet.FleetRouter._retriable_kind(status, raw) == kind
            assert jfleet.FleetRouter._retriable_kind(status, raw) == kind
        if kind != "Fenced":
            assert float(headers["Retry-After"]) >= 0, kind
            assert serving.http_retriable(
                status, headers["Retry-After"]) is not None


# -- the slice's own fleet cases -------------------------------------------

def _post(url, payload, timeout=120, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(url, timeout=30):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _concurrently(fn, n):
    out, errors = [None] * n, []

    def run(i):
        try:
            out[i] = fn(i)
        except Exception as e:  # noqa: BLE001 - the assertion
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, errors


PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11], [10, 2], [3, 3, 3, 1],
           list(range(1, 17)), [16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5,
                                4, 3, 2, 1, 1, 2]]


def test_launch_turn_is_one_lock_a_card():
    """Engines of one process on one card share one launch lock; another
    card has its own, and off the card there is nothing to take."""
    turn = serving._launch_turn
    assert turn(torch.device("cuda:0")) is turn(torch.device("cuda:0"))
    assert turn(torch.device("cuda:0")) is not turn(torch.device("cuda:1"))
    assert isinstance(turn(torch.device("cuda:1")), type(threading.Lock()))
    assert isinstance(turn(torch.device("cpu")), contextlib.nullcontext)


def test_two_engines_take_turns_at_every_launch(lm, monkeypatch):
    """Two engines given one recording turn: each takes it once a
    prefill and once a decode step, every prefill and step launches
    while its own thread holds it, and the tokens still equal the JAX
    package's."""
    model, params = lm
    real = threading.Lock()
    state = {"owner": None, "taken": 0, "outside": []}

    class Turn(object):
        def __enter__(self):
            real.acquire()
            state["owner"] = threading.get_ident()
            state["taken"] += 1

        def __exit__(self, *exc):
            state["owner"] = None
            real.release()

    def held(fn):
        def run(*a, **k):
            if state["owner"] != threading.get_ident():
                state["outside"].append(fn.__name__)
            return fn(*a, **k)
        return run

    for name in ("paged_prefill_into_slot", "paged_decode_step"):
        monkeypatch.setattr(serving.generation, name,
                            held(getattr(serving.generation, name)))
    shared = Turn()
    monkeypatch.setattr(serving, "_launch_turn", lambda device: shared)
    engines = [serving.DecodeEngine(copy.deepcopy(model), slots=2,
                                    device="cpu") for _ in range(2)]
    try:
        out, errors = _concurrently(
            lambda i: engines[i % 2].submit(PROMPTS[i], 6).result(60),
            len(PROMPTS))
        assert not errors, errors
        for prompt, got in zip(PROMPTS, out):
            assert got == jax_solo(params, prompt, 6)
        launches = sum(e.counters.get("prefills")
                       + e.counters.get("decode_steps") for e in engines)
    finally:
        for e in engines:
            e.stop()
    assert state["taken"] == launches and not state["outside"]


def test_two_replica_fleet_equals_jax_generate(lm):
    """Seven concurrent requests through the router of a 2-replica port
    fleet over real HTTP: each output equals the JAX package's
    ``generate_jit`` on the same weights at temperature 0, both replicas
    served, and the router's ``/metrics`` shows them by label."""
    model, params = lm
    with fleet.ServingFleet(model, replicas=2, name="lm",
                            engine_kw={"slots": 2, "device": "cpu"},
                            beat_interval=0.05) as f:
        url = f.url("/v1/models/lm:generate")
        out, errors = _concurrently(
            lambda i: _post(url, {"prompt": PROMPTS[i],
                                  "max_new_tokens": 8})[1]["tokens"],
            len(PROMPTS))
        assert not errors, errors
        for prompt, got in zip(PROMPTS, out):
            assert got == jax_solo(params, prompt, 8)
        served = {r.replica_id: r.engine.counters.get("requests_completed")
                  for r in f.replicas}
        assert sum(served.values()) == len(PROMPTS)
        assert all(n > 0 for n in served.values()), served
        _, text = _get(f.url("/metrics"))
        for rid in served:
            assert 'tfos_serving_requests_completed_total{{replica="{}"}}' \
                .format(rid) in text
        assert "tfos_fleet_route_overhead_seconds" in text
        # the replicas are separate modules: an upgrade swaps one only
        mods = [r.engine.model for r in f.replicas]
        assert mods[0] is not mods[1] and model not in mods


def test_rolling_drain_two_replicas_zero_lost(lm):
    """``rolling_drain(upgrade=)`` across two replicas while clients keep
    sending: zero lost requests, every engine replaced under its
    identity, every output the JAX package's."""
    model, params = lm
    with fleet.ServingFleet(model, replicas=2, name="lm",
                            engine_kw={"slots": 2, "device": "cpu"},
                            beat_interval=0.05) as f:
        url = f.url("/v1/models/lm:generate")
        old = {r.replica_id: r.engine for r in f.replicas}
        stop = threading.Event()
        done, failures = [], []

        def client(c):
            i = 0
            while not stop.is_set() or i < 2:
                prompt = PROMPTS[(c + i) % len(PROMPTS)]
                i += 1
                try:
                    _, body = _post(url, {"prompt": prompt,
                                          "max_new_tokens": 8})
                    done.append((prompt, body["tokens"]))
                except Exception as e:  # noqa: BLE001 - the assertion
                    failures.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for t in threads:
            t.start()

        def upgrade(engine):
            fresh = port_model(params)
            return serving.DecodeEngine(fresh, slots=2, device="cpu",
                                        replica_id=engine.replica_id)

        try:
            report = f.rolling_drain(upgrade=upgrade, healthz_timeout=30)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=120)
        assert report["completed"] and report["zero_loss"], report
        assert not failures, failures
        assert len(done) >= 6
        for r in f.replicas:
            assert r.engine is not old[r.replica_id]
        for prompt, tokens in done:
            assert tokens == jax_solo(params, prompt, 8)


def test_killed_scheduler_fails_over_with_zero_client_failures(lm):
    """``kill_scheduler_at_step`` on one replica mid-stream: every client
    request still completes with the JAX package's tokens (the router
    fails over), the dead replica reads down in the router's
    ``/healthz``, and the failover is counted."""
    model, params = lm
    with fleet.ServingFleet(model, replicas=2, name="lm",
                            engine_kw={"slots": 2, "device": "cpu"},
                            beat_interval=0.05) as f:
        url = f.url("/v1/models/lm:generate")
        _post(url, {"prompt": [1, 2, 3], "max_new_tokens": 2})
        chaos.arm("kill_scheduler_at_step=3,only=replica-1")
        out, errors = _concurrently(
            lambda i: _post(url, {"prompt": PROMPTS[i % len(PROMPTS)],
                                  "max_new_tokens": 8},
                            timeout=180)[1]["tokens"], 8)
        assert not errors, errors
        for i, got in enumerate(out):
            assert got == jax_solo(params, PROMPTS[i % len(PROMPTS)], 8)
        assert not f.replicas[1].engine.healthy()["alive"]
        counts = f.router.counters.snapshot()["counts"]
        assert counts.get("failovers", 0) >= 1, counts
        def health():
            return json.loads(_get(f.url("/healthz"))[1])

        assert chaos.poll_until(
            lambda: health()["replicas"]["replica-1"]["alive"] is False,
            timeout=30)
        assert health()["routable"] == 1
        _, text = _get(f.url("/metrics"))
        assert 'tfos_fleet_replica_up{replica="replica-1"} 0' in text


def test_two_stage_tiers_ship_and_splice(lm):
    """``tiers={"prefill": 1, "decode": 1}``: each :generate prefills on
    the prefill replica, which ships the KV blocks to the decode replica;
    the decode replica's prefix hits are exactly the shipped blocks, and
    the tokens are the JAX package's."""
    model, params = lm
    with fleet.ServingFleet(model, name="lm",
                            tiers={"prefill": 1, "decode": 1},
                            engine_kw={"slots": 2, "device": "cpu",
                                       "kv_block_size": 8},
                            beat_interval=0.05) as f:
        pre, dec = f.replicas
        assert (pre.engine.tier, dec.engine.tier) == ("prefill", "decode")
        url = f.url("/v1/models/lm:generate")
        prompts = [list(range(1, 17)) + [3, 4, 5],
                   [16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1,
                    1, 2, 3, 4, 5, 6, 7, 8, 9]]
        for prompt in prompts:
            _, body = _post(url, {"prompt": prompt, "max_new_tokens": 6})
            assert body["tokens"] == jax_solo(params, prompt, 6)
        counts = f.router.counters.snapshot()["counts"]
        assert counts.get("prefill_ships") == len(prompts), counts
        shipped = pre.engine.kv_counters.get("ship_blocks")
        spliced = dec.engine.kv_counters.get("spliced_blocks")
        assert shipped == spliced == sum((len(p) - 1) // 8 for p in prompts)
        assert dec.engine.counters.get("prefix_hit_blocks") == spliced
        assert dec.engine.counters.get("prefills") == len(prompts)


def test_executor_hosted_fleet_on_an_engine_context(lm, tmp_path):
    """``cluster.serving_fleet(placement="executors")`` on a 2-executor
    ``Context`` with ``engine_kw={"device": "cpu"}``: each replica runs
    in its own executor process (the lease names its pid), builds the
    module from the shipped state dict, serves the JAX package's tokens,
    and a rolling drain cycles both over the admin RPCs; ``stop`` and
    ``sc.stop()`` leave no executor process and no KV-ship ring."""
    from tensorflowonspark_tpu_torch.engine import Context

    model, params = lm
    sc = Context(2, work_root=str(tmp_path / "engine"))
    try:
        f = cluster.serving_fleet(model, replicas=2, name="lm",
                                  placement="executors", sc=sc,
                                  engine_kw={"slots": 2, "device": "cpu"},
                                  beat_interval=0.05)
        try:
            snap = f.reservation.serving_snapshot()
            pids = {info["host"]["pid"] for info in snap.values()}
            assert len(pids) == 2 and os.getpid() not in pids
            assert all(info["serving"]["device"] == "cpu"
                       for info in snap.values())
            assert all(r.remote and r.engine is None for r in f.replicas)
            url = f.url("/v1/models/lm:generate")
            out, errors = _concurrently(
                lambda i: _post(url, {"prompt": PROMPTS[i],
                                      "max_new_tokens": 8})[1]["tokens"],
                4)
            assert not errors, errors
            for i, got in enumerate(out):
                assert got == jax_solo(params, PROMPTS[i], 8)
            report = f.rolling_drain()
            assert report["completed"] and report["zero_loss"], report
            # supervision of executor-hosted replicas is lease
            # classification (the executor-loss case of
            # test_torch_autoscale.py kills one): no in-process engine is
            # watched, the fleet's serving leases are
            sup = f.supervise()
            assert sup is f.supervisor and f.supervise() is sup
            assert sup._watched == [] and sup._thread is not None
            assert sup._serving_watch["fleet"] is f
        finally:
            f.stop()
    finally:
        sc.stop()
    for pid in pids:
        assert chaos.poll_until(lambda: not _alive(pid), timeout=30), pid
    assert not [p for p in glob.glob("/dev/shm/tfos-kvship-*")
                if p.rsplit(".", 1)[-1] in {str(x) for x in pids}]


def _alive(pid):
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    with open("/proc/%d/stat" % pid) as fh:  # a zombie is not alive
        return fh.read().split(")")[-1].split()[0] != "Z"


def test_module_spec_roundtrip_keeps_bfloat16_and_builds_on_device(lm):
    """The wire form of a module: host numpy arrays only (bfloat16 as its
    16-bit pattern), rebuilt bit for bit on the asked device."""
    import torch

    model, _ = lm
    half = port_model(jax_params()).to(torch.bfloat16)
    for m in (model, half):
        spec = fleet.module_spec(m)
        assert spec["config"] == {"vocab": V, "hidden": H, "num_heads": NH,
                                  "num_layers": L, "max_len": MAXLEN}
        assert all(isinstance(a, np.ndarray)
                   for a, _ in spec["state"].values())
        built = fleet.build_module(spec, "cpu")
        assert built is not m
        for key, t in m.state_dict().items():
            assert torch.equal(built.state_dict()[key], t), key


def test_fleet_stop_stops_every_replica_engine(lm):
    """``ServingFleet.stop()`` stops each in-process replica's engine
    with its server, as the reference's does: no scheduler thread (and
    no KV pool it holds) outlives the fleet."""
    model, params = lm
    f = fleet.ServingFleet(model, replicas=2, name="lm",
                           engine_kw={"slots": 1, "device": "cpu"})
    f.start()
    engines = [r.engine for r in f.replicas]
    _, body = _post(f.url("/v1/models/lm:generate"),
                    {"prompt": [3, 1], "max_new_tokens": 3})
    assert body["tokens"] == jax_solo(params, [3, 1], 3)
    f.stop()
    for engine in engines:
        assert engine.healthy()["stopping"]
        assert not engine._thread.is_alive()


def _bits(t):
    """A tensor's stored bits: floats through a same-width integer view."""
    if not t.is_floating_point():
        return t
    return t.view({8: torch.int64, 4: torch.int32,
                   2: torch.int16}[t.element_size()])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_build_module_keeps_each_tensors_dtype_and_bits(lm, dtype):
    """``module_spec`` -> ``build_module`` gives back every parameter and
    buffer at the dtype and bits it had on the driver (the constructor
    builds at its default float32 on the meta device first), on the
    asked device, as the module's own tensors."""
    model, _ = lm
    m = copy.deepcopy(model).to(getattr(torch, dtype))
    built = fleet.build_module(fleet.module_spec(m), "cpu")
    want, got = m.state_dict(), built.state_dict()
    assert list(got) == list(want)
    for key, tensor in want.items():
        assert got[key].dtype == tensor.dtype, (key, got[key].dtype)
        assert got[key].device.type == "cpu", key
        assert torch.equal(_bits(got[key]), _bits(tensor)), key
    assert {p.dtype for p in built.parameters()} == {getattr(torch, dtype)}
    assert not any(p.is_meta for p in built.parameters())


def test_bf16_executor_replica_answers_as_the_in_process_one(lm, tmp_path):
    """A bfloat16 model served from an executor process comes back in
    bfloat16: its replica answers every prompt with the tokens of an
    in-process replica of the same bfloat16 module at temperature 0 (a
    float32 copy of the same weights answers one of them differently)."""
    from tensorflowonspark_tpu_torch.engine import Context

    model, _ = lm
    half = copy.deepcopy(model).to(torch.bfloat16)
    engine_kw = {"slots": 2, "device": "cpu"}

    def answers(f):
        url = f.url("/v1/models/lm:generate")
        return [_post(url, {"prompt": p, "max_new_tokens": 16})[1]["tokens"]
                for p in PROMPTS]

    with fleet.ServingFleet(half, replicas=1, name="lm", engine_kw=engine_kw,
                            beat_interval=0.05) as f:
        local = answers(f)
        assert f.replicas[0].engine.model.head.weight.dtype == \
            torch.bfloat16
    sc = Context(1, work_root=str(tmp_path / "engine"))
    try:
        f = cluster.serving_fleet(half, replicas=1, name="lm",
                                  placement="executors", sc=sc,
                                  engine_kw=engine_kw, beat_interval=0.05)
        try:
            assert answers(f) == local
        finally:
            f.stop()
    finally:
        sc.stop()


def test_cluster_serving_fleet_and_the_refusals_of_item_9b(lm):
    """``cluster.serving_fleet`` forms and starts a fleet in one call and
    arms the policy planes it was asked for: ``supervise=True`` watches
    every in-process replica (the reference's ``test_cluster_serving_
    fleet_helper``), ``autoscale=`` starts the controller, and the
    fleet's own ``supervise()`` / ``autoscale()`` return the armed
    planes; ``stop()`` stops both."""
    from tensorflowonspark_tpu_torch import autoscale, supervisor

    model, params = lm
    f = cluster.serving_fleet(model, replicas=2, name="lm",
                              engine_kw={"slots": 1, "device": "cpu"},
                              supervise=True,
                              restart=supervisor.RestartEngine(
                                  max_restarts=5),
                              autoscale=autoscale.AutoscalePolicy(
                                  min_replicas=2, max_replicas=2))
    try:
        sup, ctl = f.supervisor, f.autoscaler
        assert isinstance(sup, supervisor.Supervisor)
        assert len(sup._watched) == 2
        assert all(e["restart"].max_restarts == 5 for e in sup._watched)
        assert isinstance(ctl, autoscale.AutoscaleController)
        assert ctl.policy.max_replicas == 2 and ctl._thread is not None
        assert f.supervise() is sup and f.autoscale() is ctl
        _, body = _post(f.url("/v1/models/lm:generate"),
                        {"prompt": [2, 4], "max_new_tokens": 3})
        assert body["tokens"] == jax_solo(params, [2, 4], 3)
        assert "tfos_autoscale_decisions_total" in f.router.metrics_text()
    finally:
        f.stop()
    assert f.supervisor is None and f.autoscaler is None
    assert sup._thread is None and ctl._thread is None
    f = cluster.serving_fleet(model, replicas=1, name="lm",
                              engine_kw={"slots": 1, "device": "cpu"},
                              autoscale=True)
    try:
        assert f.supervisor is None
        assert f.autoscaler.policy.max_replicas == \
            autoscale.AutoscalePolicy().max_replicas
    finally:
        f.stop()


def test_fleet_without_a_card_raises_unless_cpu_is_asked(lm):
    """No fallback: with no card and no explicit ``device="cpu"`` a
    replica cannot form."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    model, _ = lm
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.ServingFleet(model, replicas=1).start()


def test_slo_monitor_and_canary_prober_on_a_live_fleet(lm):
    """The port's ``SloMonitor`` (the router's own) with a
    ``CanaryProber`` attached, against a live 2-replica port fleet: the
    canary's probes succeed through the router and pin the JAX package's
    tokens, the per-tenant availability tallies count real traffic, and
    the verdict renders on ``/metrics``."""
    model, params = lm
    with fleet.ServingFleet(model, replicas=2, name="lm",
                            engine_kw={"slots": 2, "device": "cpu"},
                            beat_interval=0.05) as f:
        url = f.url("/v1/models/lm:generate")
        prober = f.router.slo.attach_canary(
            slo.CanaryProber(url, [1, 2, 3], max_new_tokens=4,
                             timeout=30.0))
        for _ in range(4):
            assert prober.probe_once()["ok"]
        assert prober.counters() == {"probes": 4, "failures": 0,
                                     "drift": 0}
        assert prober.expected == jax_solo(params, [1, 2, 3], 4)
        for i in range(3):
            _post(url, {"prompt": PROMPTS[i], "max_new_tokens": 3,
                        "tenant": "alpha"})
        assert f.router.slo_tallies()["alpha"] == (3, 3)
        verdict = f.router.slo.verdict()
        assert verdict["specs"] and verdict["firing"] == [], verdict
        assert verdict["canary"]["counters"]["probes"] == 4
        _, text = _get(f.url("/metrics"))
        assert "tfos_slo_" in text and text.endswith("# EOF\n")


# -- mirrors of the reference's slow / chaos cases -------------------------

@pytest.mark.slow
def test_rolling_drain_zero_lost_requests_under_traffic(lm):
    """The reference's three-replica weight-upgrade cycle under live
    traffic, on the port."""
    call_case(PORT["test_rolling_drain_zero_lost_requests_under_traffic"],
              lm, None)


@pytest.mark.slow
@pytest.mark.chaos
def test_fleet_kill_one_replica_zero_client_visible_failures(lm):
    """Three replicas under ``f.supervise()``, one scheduler killed
    mid-stream: zero client-visible failures and solo-equal tokens; the
    supervisor quiesces the replica, restarts its engine (one
    ``engine_restarts``) and readmits it — the reference's own case."""
    call_case(PORT["test_fleet_kill_one_replica_zero_client_visible_"
                   "failures"], lm, None)


@pytest.mark.slow
@pytest.mark.chaos
def test_failover_request_yields_one_stitched_cross_replica_trace(
        lm, tmp_path, request):
    call_case(PORT[
        "test_failover_request_yields_one_stitched_cross_replica_trace"],
        lm, request)


@pytest.mark.slow
@pytest.mark.chaos
def test_affinity_kill_warm_replica_fails_over_cold(lm):
    """The warm replica of a conversation dies mid-session under
    supervision: the next turn is served cold with solo-equal tokens,
    the broken affinity is counted, and the supervisor readmits the
    killed replica — the reference's own case."""
    call_case(PORT["test_affinity_kill_warm_replica_fails_over_cold"],
              lm, None)
