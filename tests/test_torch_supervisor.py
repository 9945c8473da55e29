"""The port's supervision plane (``tensorflowonspark_tpu_torch/supervisor.py``)
and the completed ``goodput`` held against the JAX package's.

- PURE — the reference's own unit cases run on BOTH packages, rebound
  to each package's modules (``test_torch_fleet.port_namespace``): the
  recovery policies and the lease classification of
  ``tests/test_recovery.py``, ``RestartEngine``'s bounded backoff
  (``tests/test_serving_lifecycle.py``), the straggler detector, the
  supervisor's observe-only incidents and the job-level goodput report
  (``tests/test_goodput.py``), and the serving-lease watch's recovery
  grace (``tests/test_controlplane.py``).
- ENGINES — the reference's restart cases against the port's engines on
  the CPU (weights converted from the JAX params), every token held
  against the JAX package's ``generate_jit``; the two cases that poison
  a JAX engine's ``params`` poison the port engine's module instead.
- BOTH FLEETS — ``engine_restarts`` after a rolling drain and after a
  supervised restart, read off a 2-replica fleet of each package.
- The reference's slow / chaos case is mirrored under the same marks.

Widths: the reference fleet test's (V 17, H 32, 4 heads, 2 layers,
max_len 48). Tokens are compared equal at temperature 0.
"""

import copy
import threading

import pytest

import test_torch_fleet
from tensorflowonspark_tpu import chaos as jchaos
from tensorflowonspark_tpu import fleet as jfleet
from tensorflowonspark_tpu_torch import (chaos, fleet, goodput,
                                         metrics_report, supervisor)

from test_torch_fleet import jax_params, jax_solo, port_model


def _namespace(filename):
    return test_torch_fleet.port_namespace(
        filename, supervisor=supervisor, goodput=goodput,
        metrics_report=metrics_report)


RECOVERY_REF, RECOVERY = _namespace("test_recovery.py")
LIFECYCLE_REF, LIFECYCLE = _namespace("test_serving_lifecycle.py")
GOODPUT_REF, GOODPUT = _namespace("test_goodput.py")
CONTROL_REF, CONTROL = _namespace("test_controlplane.py")

#: (namespace pair, case) of the reference's unit cases that need no
#: model: each runs on both packages
PURE_CASES = [(RECOVERY_REF, RECOVERY, case) for case in (
    "test_failjob_policy_never_restarts",
    "test_restart_policy_backoff_then_gives_up",
    "test_blacklist_policy_excludes_after_max_failures",
    "test_blacklist_policy_respects_min_width",
    "test_classify_trainer_crash_from_exit_code",
    "test_classify_trainer_dead_without_exit_status",
    "test_classify_executor_lost_on_expired_lease",
    "test_classify_executor_lost_when_lease_never_registers",
    "test_classify_feeder_stall_vs_ring_wedge",
    "test_healthy_and_progressing_cluster_raises_nothing",
    "test_recovery_milestones_tracked_from_leases",
    "test_reservation_beat_lease_and_partition_acks",
    "test_healthz_reports_engine_liveness_and_counters",
    "test_healthz_mark_unhealthy_flips_http_route",
    "test_supervisor_watch_marks_server_unhealthy_on_engine_death",
)] + [(LIFECYCLE_REF, LIFECYCLE,
       "test_restart_engine_policy_decides_bounded_backoff")] + [
    (GOODPUT_REF, GOODPUT, case) for case in (
        "test_step_skew_uses_lower_median",
        "test_attach_step_skew_annotates_views_in_place",
        "test_straggler_detector_flags_slow_executor_once_and_rearms",
        "test_straggler_detector_substitutes_stall_age_for_frozen_step",
        "test_straggler_detector_gates",
        "test_supervisor_raises_straggler_incident_observe_only",
        "test_supervisor_straggler_ignores_serving_leases",
        "test_supervisor_config_can_disable_straggler_detection",
        "test_merged_categories_sums_executors",
        "test_job_report_width_normalization_and_driver_fold",
        "test_job_report_residual_lands_in_idle",
        "test_format_goodput_and_straggler_table_render",
        "test_straggler_pass_skips_dead_and_stale_executors",
    )] + [(CONTROL_REF, CONTROL,
           "test_supervisor_lease_watch_holds_fire_during_recovery")]


@pytest.fixture(scope="module")
def lm():
    params = jax_params()
    return port_model(params), params


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    chaos.disarm()
    jchaos.disarm()
    goodput.reset()


@pytest.mark.parametrize("ref,port,case", PURE_CASES,
                         ids=[c for _, _, c in PURE_CASES])
def test_reference_unit_case_on_both_packages(ref, port, case):
    getattr(ref, case)()
    jchaos.disarm()
    port[case]()


def test_the_module_carries_the_references_names():
    """Everything the reference's supervision module defines is here:
    the core, the serving half and the training-cluster half."""
    from tensorflowonspark_tpu import supervisor as jsupervisor

    core = ("KINDS", "FailureEvent", "Decision", "FailJob",
            "RestartFromCheckpoint", "Blacklist", "ElasticResize",
            "ResizeDrain", "RestartEngine", "SupervisorConfig",
            "Supervisor")
    for name in core:
        assert hasattr(supervisor, name) and hasattr(jsupervisor, name)
    assert supervisor.KINDS == jsupervisor.KINDS
    mine = {n for n in vars(supervisor.Supervisor) if not n.startswith("__")}
    theirs = {n for n in vars(jsupervisor.Supervisor)
              if not n.startswith("__")}
    assert mine == theirs
    for name in ("SupervisedCluster", "acked_feed", "TrainerSide",
                 "recovery_stages", "attach"):
        assert hasattr(supervisor, name) and hasattr(jsupervisor, name)
    mine = {n for n in vars(supervisor.SupervisedCluster)
            if not n.startswith("__")}
    assert mine == {n for n in vars(jsupervisor.SupervisedCluster)
                    if not n.startswith("__")}


@pytest.mark.parametrize("policy,kind,width", [
    ("elastic", "executor_lost", None), ("elastic", "trainer_crash", 3),
    ("elastic", "reform_failed", 1), ("blacklist", "trainer_crash", None)])
def test_training_policies_decide_as_the_references(policy, kind, width):
    """The training plane's pure verdicts, ported ahead of the cluster
    half that drives them: each package decides the same action, delay,
    exclusion, width and reason over a sweep of restart counts."""
    from tensorflowonspark_tpu import supervisor as jsupervisor

    def verdicts(mod):
        pol = mod.ElasticResize(min_width=2, max_restarts=3, backoff=0.5) \
            if policy == "elastic" \
            else mod.Blacklist(max_failures=2, min_width=1, max_restarts=3)
        out = []
        for restarts in range(5):
            d = pol.decide(mod.FailureEvent(kind, 1, "t"), restarts,
                           {1: restarts}, frozenset(), 4, width=width)
            out.append((d.action, d.delay, d.exclude, d.width, d.reason))
        return out

    assert verdicts(supervisor) == verdicts(jsupervisor)


# -- the reference's restart cases on the port's engines -------------------

def test_watch_does_not_resurrect_a_deliberate_stop(lm):
    LIFECYCLE["test_watch_does_not_resurrect_a_deliberate_stop"](lm)


def _poisoned(model):
    """A copy of ``model`` that constructs and allocates like it but
    raises at its first forward call (the port's stand-in for the
    reference's poisoned ``params``)."""
    bad = copy.deepcopy(model)

    def forward(*args, **kw):
        raise RuntimeError("poisoned module")

    bad.forward = forward
    return bad


def test_supervisor_restarts_dead_engine_and_rearms_server(lm):
    """The reference's recovery pin on the port: the live engine's
    module is poisoned so its scheduler dies, ``RestartEngine`` rebuilds
    from the ORIGINAL construction config (the unpoisoned module), the
    server re-arms, ``engine_restarts`` reads 1 on the shared counters,
    and a fresh request is the JAX package's tokens."""
    from tensorflowonspark_tpu_torch import serving

    model, params = lm
    eng = serving.DecodeEngine(model, slots=2, device="cpu")
    ms = serving.ModelServer(None, name="lm", engine=eng)
    sup = supervisor.Supervisor(
        config=supervisor.SupervisorConfig(poll_interval=0.05))
    try:
        sup.watch(eng, server=ms,
                  restart=supervisor.RestartEngine(max_restarts=2,
                                                   backoff=0.05))
        eng.model = _poisoned(model)
        handle = eng.submit([1, 2, 3], 8)
        with pytest.raises(serving.Retriable):
            handle.result(120)
        assert chaos.poll_until(
            lambda: ms.engine is not eng and ms._unhealthy is None,
            timeout=60)
        fresh = ms.engine
        assert fresh.counters is eng.counters
        assert fresh.counters.get("engine_restarts") == 1
        assert fresh.model is model
        assert fresh.submit([1, 2, 3], 4).result(120) == \
            jax_solo(params, [1, 2, 3], 4)
        assert ms.healthz()[0] == 200
    finally:
        sup.stop()
        ms.stop()
        ms.engine.stop()


def test_restart_exhaustion_marks_server_unhealthy(lm):
    """A permanently broken engine (its stored construction module
    poisoned too) gets the one allowed restart, dies again on its first
    request, and the policy lands the server 503 for good."""
    from tensorflowonspark_tpu_torch import serving

    model, _ = lm
    eng = serving.DecodeEngine(model, slots=1, device="cpu")
    ms = serving.ModelServer(None, name="lm", engine=eng)
    sup = supervisor.Supervisor(
        config=supervisor.SupervisorConfig(poll_interval=0.05))
    try:
        bad = _poisoned(model)
        eng.model = bad
        eng._spawn_args["model"] = bad
        sup.watch(eng, server=ms,
                  restart=supervisor.RestartEngine(max_restarts=1,
                                                   backoff=0.01))
        with pytest.raises(serving.Retriable):
            eng.submit([1, 2, 3], 8).result(120)
        assert chaos.poll_until(
            lambda: ms.engine is not eng and ms._unhealthy is None,
            timeout=60)
        with pytest.raises(serving.Retriable):
            ms.engine.submit([1, 2, 3], 8).result(120)
        assert chaos.poll_until(
            lambda: ms._unhealthy is not None
            and "gave up" in ms._unhealthy, timeout=60)
        assert ms.healthz()[0] == 503
        assert len(sup.events.events("engine_restarted")) == 1
        assert eng.counters.get("engine_restarts") == 1
    finally:
        sup.stop()
        ms.stop()
        ms.engine.stop()


# -- engine_restarts on both packages' fleets ------------------------------

def _restarts(f):
    return [r.engine.counters.snapshot()["counts"].get("engine_restarts", 0)
            for r in f.replicas]


def _fleet_restarts(make, chaos_mod, solo):
    """``engine_restarts`` per replica of a 2-replica in-process fleet
    after one rolling drain, then after a ``kill_scheduler_at_step`` on
    replica-1 under ``supervise()``; every answer equals ``solo``."""
    with make() as f:
        url = f.url("/v1/models/lm:generate")
        test_torch_fleet._post(url, {"prompt": [1, 2, 3],
                                     "max_new_tokens": 2})
        assert f.router.rolling_drain()["zero_loss"]
        drained = _restarts(f)
        sup = f.supervise()
        chaos_mod.arm("kill_scheduler_at_step=2,only=replica-1")
        for _ in range(10):
            out, errors = test_torch_fleet._concurrently(
                lambda i: test_torch_fleet._post(
                    url, {"prompt": [1 + i % 5, 2, 3],
                          "max_new_tokens": 10}, timeout=180)[1]["tokens"],
                6)
            assert not errors, errors
            for i, got in enumerate(out):
                assert got == solo([1 + i % 5, 2, 3], 10)
            if chaos.poll_until(
                    lambda: sup.events.events("engine_restarted"),
                    timeout=5):
                break
        chaos_mod.disarm()
        assert sup.events.events("engine_restarted")
        return drained, _restarts(f)


def test_engine_restarts_equal_between_the_packages(lm):
    """The same weights on both packages' fleets: a rolling drain is not
    a restart (``[0, 0]`` on each), a supervised restart of replica-1
    counts one on it and none on replica-0 (``[0, 1]`` on each)."""
    from tensorflowonspark_tpu.models.decoder import DecoderLM as JDecoderLM

    model, params = lm
    jdec = JDecoderLM(vocab=test_torch_fleet.V, hidden=test_torch_fleet.H,
                      num_heads=test_torch_fleet.NH,
                      num_layers=test_torch_fleet.L,
                      max_len=test_torch_fleet.MAXLEN, decode=True)

    def solo(prompt, n):
        return jax_solo(params, prompt, n)

    got = {
        "jax": _fleet_restarts(
            lambda: jfleet.ServingFleet(jdec, params, replicas=2, name="lm",
                                        engine_kw={"slots": 2},
                                        beat_interval=0.05),
            jchaos, solo),
        "port": _fleet_restarts(
            lambda: fleet.ServingFleet(model, replicas=2, name="lm",
                                       engine_kw={"slots": 2,
                                                  "device": "cpu"},
                                       beat_interval=0.05),
            chaos, solo)}
    assert got["jax"] == got["port"] == ([0, 0], [0, 1]), got


def test_rolling_drain_under_a_supervisor_moves_no_count(lm):
    """A supervised fleet's rolling drain swaps every engine: the watch
    follows each successor (a kill of the drained-in engine is then
    restarted), and the drain itself counts no restart."""
    model, params = lm
    with fleet.ServingFleet(model, replicas=2, name="lm",
                            engine_kw={"slots": 2, "device": "cpu"},
                            beat_interval=0.05) as f:
        sup = f.supervise(restart=supervisor.RestartEngine(backoff=0.05))
        sup.config.poll_interval = 0.05
        url = f.url("/v1/models/lm:generate")
        box = {}
        sender = threading.Thread(target=lambda: box.update(
            zip(("out", "errors"), test_torch_fleet._concurrently(
                lambda i: test_torch_fleet._post(
                    url, {"prompt": [1 + i % 5, 2], "max_new_tokens": 8},
                    timeout=180)[1]["tokens"], 6))))
        sender.start()
        report = f.rolling_drain()
        sender.join()
        assert report["zero_loss"] and not box["errors"], box["errors"]
        assert _restarts(f) == [0, 0]
        successor = f.replicas[0].engine
        assert chaos.poll_until(
            lambda: all(e["engine"] is r.engine
                        for e, r in zip(sup._watched, f.replicas)),
            timeout=10)
        chaos.arm("kill_scheduler_at_step=1,only=replica-0")
        with pytest.raises(Exception):
            successor.submit([1, 2, 3], 6).result(60)
        chaos.disarm()
        assert chaos.poll_until(
            lambda: f.replicas[0].engine is not successor
            and f.replicas[0].engine.healthy()["alive"], timeout=30)
        assert _restarts(f) == [1, 0]
        _, body = test_torch_fleet._post(url, {"prompt": [9, 2, 3],
                                               "max_new_tokens": 4})
        assert body["tokens"] == jax_solo(params, [9, 2, 3], 4)


# -- mirrors of the reference's slow / chaos case --------------------------

@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_scheduler_kill_autorestart_e2e(lm):
    LIFECYCLE["test_chaos_scheduler_kill_autorestart_e2e"](lm)
