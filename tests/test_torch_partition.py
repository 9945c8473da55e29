"""Partition tolerance and the control plane of the port's fleet, held
against the JAX package.

- The reference's cases of ``tests/test_partition_tolerance.py`` — the
  netchaos grammar and seeded schedules, the dedup window, the
  cooldown-window interleavings of ``ReplicaHealth``, the split
  connect/read timeouts of ``fleet._http_request``, idempotent dispatch
  over HTTP, a partition's lost response absorbed by the dedup window,
  lease fencing and the router's failover from a fenced replica, the
  evidence-based hedge delay — run on the port (the pure ones on both
  packages), tokens held against the JAX package's generate.
- The reference's control-plane cases of ``tests/test_controlplane.py``
  that need no supervisor or autoscaler: the ModelServer's control-epoch
  fence and the router and reservation chaos points.
- The slice's own control-plane cases: a journal-seeded
  ``restart_reservation`` while serving (no epoch goes backwards), the
  ``kill_reservation_server`` + ``restart_reservation_after`` chaos
  choreography, and a ``RouterStandby`` takeover fired by
  ``kill_router_at_request`` whose deposed leader's control epoch is
  refused 409.
- The reference's slow / chaos cases of both files are mirrored under
  the same marks.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

import test_torch_fleet
from tensorflowonspark_tpu_torch import chaos, fleet

REF, PORT = test_torch_fleet.port_namespace("test_partition_tolerance.py")
CREF, CPORT = test_torch_fleet.port_namespace("test_controlplane.py")
call_case = test_torch_fleet.call_case
jax_solo = test_torch_fleet.jax_solo

#: pure and transport cases: run on both packages
PURE_CASES = (
    "test_net_spec_grammar_parses_points_and_fields",
    "test_net_drop_schedule_is_seed_deterministic",
    "test_net_endpoint_scoping",
    "test_net_partition_opening_exchange_loses_response_then_heals",
    "test_net_dup_and_delay",
    "test_dedup_window_replay_join_and_withdraw",
    "test_dedup_window_ttl_and_lru_bounds",
    "test_health_stale_success_cannot_reopen_active_cooldown",
    "test_health_interleaved_quiesce_during_cooldown_and_probe",
    "test_health_concurrent_interleavings_keep_invariants",
    "test_http_request_read_timeout_independent_of_connect",
    "test_http_request_connect_timeout_bounds_unaccepted_connect",
    "test_hedge_delay_is_evidence_based",
)

#: cases over a model: run on the port
E2E_CASES = (
    "test_generate_dedup_replays_completed_request",
    "test_generate_dedup_joins_in_flight_duplicate",
    "test_net_dup_delivery_absorbed_by_dedup",
    "test_partition_flap_retry_absorbed_zero_duplicates",
    "test_fenced_server_answers_non_retriable_410",
    "test_replica_fenced_after_replacement_registers",
    "test_router_fails_over_from_fenced_replica",
)

#: the control plane's unit cases (no supervisor, no autoscaler)
CONTROL_CASES = (
    "test_control_fence_adopts_at_or_above_refuses_below",
    "test_control_fence_http_409_400_and_unstamped_passthrough",
    "test_chaos_kill_reservation_server_point_fires_once",
    "test_chaos_kill_router_at_request_scopes_by_name",
)


@pytest.fixture(scope="module")
def lm():
    params = test_torch_fleet.jax_params()
    return test_torch_fleet.port_model(params), params


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    chaos.disarm()


@pytest.mark.parametrize("case", PURE_CASES)
def test_reference_pure_case_on_both_packages(case, request):
    call_case(getattr(REF, case), None, request)
    REF.chaos.disarm()
    call_case(PORT[case], None, request)


def test_net_spec_grammar_rejects_bad_specs():
    """The reference's rejection cases on both packages' parsers — its
    own case (whose step point, ``kill_trainer_at_step``, the port takes
    since its training supervision) and a serving point — and the
    port's step and executor points parse as the reference's do."""
    REF.test_net_spec_grammar_rejects_bad_specs()
    PORT["test_net_spec_grammar_rejects_bad_specs"]()
    for mod in (REF.chaos, chaos):
        with pytest.raises(ValueError, match="only apply to net points"):
            mod.parse_spec("kill_scheduler_at_step=3,for=1")
        assert set(mod.parse_spec(
            "kill_trainer_at_step=3;drop_executor_then_return_after=1,"
            "only=1,fuse=/nonexistent/fuse")) == {
                "kill_trainer_at_step", "drop_executor_then_return_after"}
    assert set(chaos.parse_spec(
        "kill_router_at_request=2,only=lm;restart_reservation_after=0.5"
    )) == {"kill_router_at_request", "restart_reservation_after"}


@pytest.mark.parametrize("case", E2E_CASES)
def test_reference_partition_case_on_the_port(case, lm, request):
    call_case(PORT[case], lm, request)


@pytest.mark.parametrize("case", CONTROL_CASES)
def test_reference_control_case_on_both_packages(case, request):
    call_case(getattr(CREF, case), None, request)
    CREF.chaos.disarm()
    call_case(CPORT[case], None, request)


def _post(url, payload, timeout=120, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _fleet(model, tmp_path, **kw):
    return fleet.ServingFleet(
        model, replicas=2, name="lm",
        engine_kw={"slots": 2, "device": "cpu"}, beat_interval=0.05,
        journal=str(tmp_path / "control.journal"), **kw)


def test_restart_reservation_with_a_journal_keeps_every_epoch(lm, tmp_path):
    """``ServingFleet(journal=)`` then ``restart_reservation()`` while a
    client keeps sending: zero client failures, the replicas re-announce
    the SAME epochs to the journal-seeded server, the control epoch and
    every fresh mint land strictly above the old ones."""
    model, params = lm
    with _fleet(model, tmp_path) as f:
        url = f.url("/v1/models/lm:generate")
        assert _post(url, {"prompt": [1, 2], "max_new_tokens": 2})[0] == 200
        epochs = {r.replica_id: r.epoch for r in f.replicas}
        control = f.control_epoch
        assert control == 1 and set(epochs.values()) == {1}
        stop = threading.Event()
        results = []

        def client():
            i = 0
            while not stop.is_set():
                prompt = [1 + i % 4, 2, 3]
                i += 1
                results.append((prompt, _post(url, {"prompt": prompt,
                                                    "max_new_tokens": 3})))

        t = threading.Thread(target=client)
        t.start()
        try:
            time.sleep(0.2)
            old = f.reservation
            fresh = f.restart_reservation(recovery_grace=10.0)
            assert fresh is not old and fresh.addr == old.addr
            assert fresh.journal is not None
            assert chaos.poll_until(
                lambda: {k: v.get("epoch") for k, v in
                         fresh.serving_snapshot().items()} == epochs,
                timeout=30)
            assert chaos.poll_until(lambda: not fresh.recovering(),
                                    timeout=30)
            time.sleep(0.2)
        finally:
            stop.set()
            t.join(timeout=60)
        assert results and all(r[1][0] == 200 for r in results), \
            [r for r in results if r[1][0] != 200][:3]
        for prompt, (_, body) in results:
            assert body["tokens"] == jax_solo(params, prompt, 3)
        assert all(r.epoch == epochs[r.replica_id] for r in f.replicas)
        assert f.reservation.mint_control_epoch() > control
        assert f.reservation.mint_epoch("replica-0") > epochs["replica-0"]
        f.replicas[0].re_register()  # undo the probe mint's fence


def test_reservation_chaos_kill_and_scheduled_restart(lm, tmp_path):
    """``kill_reservation_server`` crashes the server at a beat;
    ``schedule_reservation_restart`` brings it back after
    ``restart_reservation_after``'s headless time. The fleet serves
    throughout and the replicas count their reconnects."""
    model, _ = lm
    with _fleet(model, tmp_path) as f:
        url = f.url("/v1/models/lm:generate")
        dead = f.reservation
        chaos.arm("kill_reservation_server=6;restart_reservation_after=0.3")
        restarter = chaos.schedule_reservation_restart(f)
        assert chaos.poll_until(dead.done.is_set, timeout=30)
        assert _post(url, {"prompt": [4, 5], "max_new_tokens": 3})[0] == 200
        restarter.join(timeout=30)
        assert f.reservation is not dead
        assert chaos.poll_until(
            lambda: len(f.reservation.serving_snapshot()) == 2, timeout=30)
        assert chaos.poll_until(
            lambda: all(r.beat_reconnects >= 1 for r in f.replicas),
            timeout=30)
        assert _post(url, {"prompt": [5, 4], "max_new_tokens": 3})[0] == 200


def test_router_standby_takes_over_and_fences_the_old_leader(lm, tmp_path):
    """``kill_router_at_request`` crashes the leader at its 2nd dispatch;
    the ``RouterStandby`` confirms the death, mints a higher control
    epoch, serves, and the deposed leader's stamped admin write is
    refused 409 ControlFenced while the new leader's is admitted."""
    model, params = lm
    with _fleet(model, tmp_path) as f:
        url = f.url("/v1/models/lm:generate")
        old_router, old_epoch = f.router, f.control_epoch
        sb = fleet.RouterStandby(f, probe_interval=0.05, confirm=2).start()
        try:
            chaos.arm("kill_router_at_request=2,only=lm")
            assert _post(url, {"prompt": [1, 2], "max_new_tokens": 2})[0] \
                == 200
            # the killed dispatch answers 499; the listener is gone
            assert _post(url, {"prompt": [2, 1], "max_new_tokens": 2},
                         timeout=30)[0] == 499
            with pytest.raises(OSError):
                _post(url, {"prompt": [2, 1], "max_new_tokens": 2},
                      timeout=30)
            assert sb.took_over.wait(timeout=30)
            assert f.router is not old_router and f.router is sb.router
            assert f.control_epoch == sb.control_epoch > old_epoch
            status, body = _post(f.url("/v1/models/lm:generate"),
                                 {"prompt": [2, 1], "max_new_tokens": 4})
            assert status == 200
            assert body["tokens"] == jax_solo(params, [2, 1], 4)
            rep = "http://%s:%d/admin/ship_fence" % tuple(
                f.replicas[0].addr)
            status, resp = _post(rep, {"replica_id": "x", "min_epoch": 1},
                                 headers={"X-TFOS-Control-Epoch":
                                          str(old_epoch)})
            assert status == 409 and resp["kind"] == "ControlFenced"
            assert resp["control_epoch"] == f.control_epoch
            status, _ = _post(rep, {"replica_id": "x", "min_epoch": 1},
                              headers={"X-TFOS-Control-Epoch":
                                       str(f.control_epoch)})
            assert status == 200
            assert sb.counters.snapshot()["counts"]["takeovers"] == 1
            with pytest.raises(RuntimeError, match="already took over"):
                sb.take_over()
        finally:
            sb.stop()


# -- mirrors of the reference's slow / chaos cases -------------------------

@pytest.mark.slow
@pytest.mark.chaos
def test_partition_flap_cycles_zero_duplicates(lm, request):
    call_case(PORT["test_partition_flap_cycles_zero_duplicates"], lm,
              request)


@pytest.mark.slow
def test_hedged_request_beats_gray_replica(lm, request):
    call_case(PORT["test_hedged_request_beats_gray_replica"], lm, request)


@pytest.mark.slow
@pytest.mark.chaos
def test_reservation_bounce_zero_failures_same_epochs(lm, request):
    call_case(CPORT["test_reservation_bounce_zero_failures_same_epochs"],
              lm, request)


@pytest.mark.slow
@pytest.mark.chaos
def test_fleet_stop_bounded_after_reservation_crash(lm, request):
    call_case(CPORT["test_fleet_stop_bounded_after_reservation_crash"], lm,
              request)


@pytest.mark.slow
@pytest.mark.chaos
def test_router_standby_takeover_fences_old_leader(lm, request):
    call_case(CPORT["test_router_standby_takeover_fences_old_leader"], lm,
              request)
