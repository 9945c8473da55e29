"""The port's SLO-driven autoscaler (``tensorflowonspark_tpu_torch/
autoscale.py``) held against the JAX package's.

- PURE — the reference's 16 ``decide`` / ``replica_view`` tables of
  ``tests/test_autoscale.py`` run on BOTH packages, rebound to each
  package's modules; then a seeded random sequence of replica views,
  cooldown stamps and injected times drives both packages' ``decide``
  side by side, step for step: equal decisions, equal state.
- CONTROLLER — the reference's controller cases against the port's
  fleet (engines on the CPU, weights converted from the JAX params with
  ``convert.from_flax``), every token held against the JAX package's
  ``generate_jit`` at temperature 0; the stub-fleet cases
  (concurrent polls, a driver replica's dead lease, the supervisor's
  lease-recovery release, the reservation-recovery hold) on both.
- The reference's slow / chaos cases (executor-hosted placement, a
  burst scaling onto a free executor, a SIGKILLed serving executor
  attributed by the supervisor and replaced by the autoscaler) are
  mirrored under the same marks, on an engine ``Context`` of the port.
"""

import threading

import numpy as np
import pytest

import tensorflowonspark_tpu
import test_torch_fleet
from tensorflowonspark_tpu import autoscale as jautoscale
from tensorflowonspark_tpu import chaos as jchaos
from tensorflowonspark_tpu_torch import (autoscale, chaos, cluster,
                                         supervisor, tracing)

from test_torch_fleet import jax_params, port_model, shim


def _serving_fleet(model, params=None, *args, **kw):
    """``cluster.serving_fleet(model, params, ...)`` as the reference's
    cases call it, with the replicas' engines on the CPU."""
    kw["engine_kw"] = dict({"device": "cpu"}, **(kw.get("engine_kw") or {}))
    return cluster.serving_fleet(model, *args, **kw)


def _context(num_executors, extra_env=None):
    """The reference's executor ``Context`` helper on the port's engine."""
    from tensorflowonspark_tpu_torch.engine import Context

    return Context(num_executors, executor_env=dict(extra_env or {}))


REF, PORT = test_torch_fleet.port_namespace(
    "test_autoscale.py", autoscale=autoscale,
    AutoscalePolicy=autoscale.AutoscalePolicy,
    ScaleDecision=autoscale.ScaleDecision, decide=autoscale.decide,
    cluster=shim(cluster, serving_fleet=_serving_fleet))
PORT["_context"] = _context
CONTROL_REF, CONTROL = test_torch_fleet.port_namespace(
    "test_controlplane.py", autoscale=autoscale, supervisor=supervisor)

#: the reference's pure decision tables and view extraction
TABLES = (
    "test_decide_breach_scales_up",
    "test_decide_up_cooldown_suppresses_flap",
    "test_decide_up_clamped_at_max",
    "test_decide_cold_start_holds_without_evidence",
    "test_decide_idle_scales_down_least_loaded",
    "test_decide_down_retires_coldest_cache_first",
    "test_decide_down_warmth_tie_breaks_by_generated_hits_then_load",
    "test_decide_down_clamped_at_min",
    "test_decide_down_cooldown_counts_scales_in_both_directions",
    "test_decide_idle_with_zero_completions_holds",
    "test_decide_stale_breach_without_standing_queue_is_history",
    "test_decide_ttft_breach_needs_standing_queue_too",
    "test_decide_dead_lease_replaces_before_anything_else",
    "test_decide_engine_dead_under_live_lease_replaces",
    "test_decide_draining_replica_is_not_dead_and_not_live",
    "test_decide_never_mutates_state",
    "test_replica_view_extracts_gauges_ttft_and_host",
    "test_replica_view_no_lease_reads_dead",
)

#: the controller cases over stub fleets (no model): both packages
STUB_CASES = (
    "test_concurrent_poll_once_retires_exactly_once",
    "test_replace_dead_lease_driver_placement_re_registers",
    "test_watch_serving_releases_hold_on_lease_recovery",
)

#: the controller cases over a real in-process fleet: the port
FLEET_CASES = (
    "test_controller_records_decisions_and_metrics",
    "test_controller_repairs_unwatched_inprocess_engine_death",
    "test_retire_replica_under_live_traffic_zero_loss",
)


@pytest.fixture(scope="module")
def lm():
    params = jax_params()
    return port_model(params), params


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    chaos.disarm()
    jchaos.disarm()


@pytest.mark.parametrize("case", TABLES)
def test_reference_decide_table_on_both_packages(case):
    getattr(REF, case)()
    PORT[case]()


@pytest.mark.parametrize("case", STUB_CASES)
def test_reference_controller_stub_case_on_both_packages(case,
                                                         monkeypatch):
    getattr(REF, case)()
    # the lease-recovery case imports the supervisor inside its body:
    # point that import at the port's module for the port's run
    monkeypatch.setattr(tensorflowonspark_tpu, "supervisor", supervisor,
                        raising=False)
    PORT[case]()


def test_reference_autoscaler_recovery_hold_on_both_packages():
    getattr(CONTROL_REF, "test_autoscaler_holds_during_recovery")()
    CONTROL["test_autoscaler_holds_during_recovery"]()


@pytest.mark.parametrize("case", FLEET_CASES)
def test_reference_controller_case_on_the_port(case, lm):
    PORT[case](lm)


def test_autoscale_closed_loop_on_the_port(lm):
    """The reference's closed loop (``test_autoscale_closed_loop_inprocess``)
    on the port, with its scale-up asserted while it holds: a burst
    breaches the queue-wait SLO -> 1 scales to 2 with zero
    client-visible failures; sustained idle retires back to 1 through
    the zero-loss drain path, and the retired replica's lease is
    DEREGISTERED.

    The port's eager CPU engine takes longer over a burst's tail than
    the policy's 1 s down-cooldown, so the controller may already have
    retired the second replica (its queues empty, occupancy 50%: idle
    by the policy) when the burst returns. A watcher thread therefore
    polls for both replicas with live leases WHILE the burst runs and
    records that the fleet reached 2."""
    dec, params = lm
    AutoscalePolicy = autoscale.AutoscalePolicy
    scaled_to, post = PORT["_scaled_to"], PORT["_post"]
    pol = AutoscalePolicy(min_replicas=1, max_replicas=2,
                          queue_wait_slo_s=0.05, up_cooldown_s=0.3,
                          down_cooldown_s=1.0, occupancy_low=0.999,
                          dead_after_s=10.0)
    f = _serving_fleet(dec, params, replicas=1, engine_kw={"slots": 2})
    ctl = f.autoscale(policy=pol, interval=0.1)
    reached, stop = threading.Event(), threading.Event()

    def watch():
        while not stop.is_set() and not reached.is_set():
            if scaled_to(f, 2):
                reached.set()
            stop.wait(0.02)

    watcher = threading.Thread(target=watch, name="scaled-to-2")
    watcher.start()
    try:
        url = f.url("/v1/models/model:generate")
        prompts = [[(i % 5) + 1, 2, 3, 4] for i in range(12)]
        outs = [None] * len(prompts)
        errors = []

        def burst():
            def client(i):
                try:
                    _, outs[i] = post(url, {"prompt": prompts[i],
                                            "max_new_tokens": 20})
                except Exception as e:  # noqa: BLE001 - asserted below
                    errors.append(repr(e))
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        # a short burst can fall between beat/poll samples on a fast
        # warm box; re-burst (bounded) until the breach is observed
        for _ in range(3):
            burst()
            if reached.wait(5.0):
                break
        stop.set()
        watcher.join()
        assert errors == [], "scale-up must be client-invisible"
        assert reached.is_set(), \
            "burst must have scaled 1 -> 2 (events: {})".format(
                ctl.events.events("autoscale_decision"))
        # the new replica is tracked in fleet.replicas before the
        # controller tallies the counter — poll the tiny gap closed
        assert chaos.poll_until(
            lambda: ctl.counters.snapshot()["counts"]
            .get("scale_ups", 0) >= 1, timeout=5.0)
        # every response is bitwise solo-identical (spot-check a few)
        for i in (0, 5, 11):
            if outs[i] is not None:
                assert outs[i]["tokens"] == test_torch_fleet.jax_solo(
                    params, prompts[i], 20)
        # sustained idle -> retire back to min with the lease dropped
        assert chaos.poll_until(lambda: scaled_to(f, 1), timeout=30.0), \
            "idle fleet must retire to min_replicas"
        assert chaos.poll_until(
            lambda: ctl.counters.snapshot()["counts"]
            .get("scale_downs", 0) >= 1, timeout=5.0)
        down = ctl.events.events("autoscale_scaled_down")
        assert down and down[-1]["drained_clean"], \
            "retirement must be the zero-loss drain path"
        retired = down[-1]["replica"]
        assert retired not in f.reservation.serving_snapshot(), \
            "retired replica's lease must be deregistered"
        # post-retirement traffic still lands (the survivor serves)
        out = PORT["_post_with_retry"](url, {"prompt": [1, 2, 3],
                                             "max_new_tokens": 4})
        assert out["tokens"] == test_torch_fleet.jax_solo(params,
                                                          [1, 2, 3], 4)
    finally:
        stop.set()
        watcher.join()
        f.stop()


def test_the_module_carries_the_references_names():
    for name in ("AutoscalePolicy", "ScaleDecision", "replica_view",
                 "decide", "AutoscaleController"):
        assert hasattr(autoscale, name) and hasattr(jautoscale, name)
    assert vars(autoscale.AutoscalePolicy()) == \
        vars(jautoscale.AutoscalePolicy())
    mine = {n for n in vars(autoscale.AutoscaleController)
            if not n.startswith("__")}
    assert mine == {n for n in vars(jautoscale.AutoscaleController)
                    if not n.startswith("__")}


# -- seeded view sequences: both packages' decide, side by side -------------

def _random_view(rng, i, tiers):
    view = {
        "replica_id": "replica-%d" % i,
        "age": None if rng.rand() < 0.05 else float(rng.rand() * 4),
        "alive": bool(rng.rand() > 0.08),
        "draining": bool(rng.rand() < 0.08),
        "queue_depth": int(rng.choice([0, 0, 0, 1, 3, 6])),
        "slot_occupancy": int(rng.randint(0, 5)),
        "slots": int(rng.choice([2, 4])),
        "queue_wait_ewma_s": float(rng.choice([0.0, 0.01, 0.3, 1.5])),
        "kv_blocks_free": None, "kv_blocks_total": None,
        "completed": int(rng.choice([0, 3, 40])),
        "ttft_p99_s": None if rng.rand() < 0.5
        else float(rng.choice([0.05, 0.4, 2.0])),
        "prefix_warmth": int(rng.randint(0, 6)),
        "generated_prefix_hit_blocks": int(rng.randint(0, 3)),
        "executor": None,
        "tier": str(rng.choice(tiers)),
    }
    if rng.rand() < 0.3:
        view["queue_by_class"] = {
            cls: int(rng.randint(0, 3)) for cls in ("high", "normal", "low")
            if rng.rand() < 0.6}
    return view


def _stamp(state, decision, now):
    """The controller's own bookkeeping after an applied decision."""
    if decision.action == "up":
        state[autoscale._state_key("last_up", decision.tier)] = now
    elif decision.action == "down":
        state[autoscale._state_key("last_down", decision.tier)] = now


@pytest.mark.parametrize("seed", range(8))
def test_decide_sequences_equal_on_seeded_views(seed):
    """A seeded stream of fleets (homogeneous or tiered, dead, draining,
    cold, saturated, idle, class-split queues, SLO burn) through both
    packages' ``decide``: the same decision — action, reason, replica,
    tier, evidence — at every step, and the same controller state after
    stamping each applied scale."""
    rng = np.random.RandomState(seed)
    tiers = ["mixed"] if seed % 2 == 0 else ["prefill", "decode", "mixed"]
    kw = dict(min_replicas=int(rng.randint(1, 3)),
              max_replicas=int(rng.randint(3, 6)),
              queue_wait_slo_s=float(rng.choice([0.05, 0.5])),
              ttft_p99_slo_s=None if seed % 3 == 0 else 0.3,
              occupancy_high=0.8, occupancy_low=0.3,
              up_cooldown_s=1.0, down_cooldown_s=5.0,
              dead_after_s=float(rng.choice([1.5, 3.0])),
              burn_rate_up_threshold=None if seed % 4 == 0 else 2.0)
    policies = (autoscale.AutoscalePolicy(**kw),
                jautoscale.AutoscalePolicy(**kw))
    states = ({"last_up": None, "last_down": None},
              {"last_up": None, "last_down": None})
    now = 100.0
    for _ in range(200):
        now += float(rng.choice([0.1, 0.5, 2.0, 6.0]))
        views = [_random_view(rng, i, tiers)
                 for i in range(int(rng.randint(0, 6)))]
        burn = None if rng.rand() < 0.5 else float(rng.choice([0.5, 3.0]))
        got = [mod.decide(pol, views, state, now, burn_rate=burn)
               for mod, pol, state in zip((autoscale, jautoscale), policies,
                                          states)]
        assert [(d.action, d.reason, d.replica_id, d.tier, d.evidence)
                for d in got][0] == \
            [(d.action, d.reason, d.replica_id, d.tier, d.evidence)
             for d in got][1]
        for state, decision in zip(states, got):
            _stamp(state, decision, now)
        assert states[0] == states[1]


def test_replica_view_equal_on_a_live_beat(lm):
    """Both packages read one live replica's serving-snapshot entry into
    the same decision view."""
    model, _ = lm
    with test_torch_fleet.fleet.ServingFleet(
            model, replicas=1, name="lm",
            engine_kw={"slots": 2, "device": "cpu"},
            beat_interval=0.05) as f:
        test_torch_fleet._post(f.url("/v1/models/lm:generate"),
                               {"prompt": [1, 2, 3], "max_new_tokens": 4})
        assert chaos.poll_until(lambda: autoscale.replica_view(
            "replica-0", f.reservation.serving_snapshot()["replica-0"])
            ["completed"] == 1, timeout=10)
        info = f.reservation.serving_snapshot()["replica-0"]
        assert autoscale.replica_view("replica-0", info) == \
            jautoscale.replica_view("replica-0", info)
        assert tracing.snapshot_quantile(
            info["metrics"]["hists"]["tfos_serving_ttft_seconds"], 0.99) \
            == autoscale.replica_view("replica-0", info)["ttft_p99_s"]


# -- mirrors of the reference's slow / chaos cases -------------------------

@pytest.mark.slow
def test_executor_hosted_fleet_pids_differ_and_bitwise(lm):
    PORT["test_executor_hosted_fleet_pids_differ_and_bitwise"](lm)


@pytest.mark.slow
def test_executor_hosted_burst_scales_one_to_two_zero_failures(lm):
    PORT["test_executor_hosted_burst_scales_one_to_two_zero_failures"](lm)


@pytest.mark.slow
@pytest.mark.chaos
def test_kill_serving_executor_failover_and_replacement(lm):
    PORT["test_kill_serving_executor_failover_and_replacement"](lm)
