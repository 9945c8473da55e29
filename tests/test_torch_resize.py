"""Elastic resize on the port held against the JAX package's.

- PURE — the reference's own cases of ``tests/test_resize.py`` that need
  no cluster run on BOTH packages, rebound to each package's modules:
  ``ElasticResize``'s decision table, the legacy five-argument policies,
  the width gauges on the reservation server's ``/metrics``, the
  supervisor's engine-liveness fast path, ``TrainerSide``'s cooperative
  boundary drain and its throttle, the ``drop_executor_then_return_after``
  grammar and its refusal outside a trainer.
- ``Context.revive_executor`` — the reference's case on the port's
  engine: a SIGKILLed executor is reaped at dispatch, revived under its
  id and runs a job again.
- The reference's elastic e2e (shrink 2 -> 1, regrow 1 -> 2, the
  exactly-once boundary across three formations) is mirrored under its
  slow / chaos marks on the port's ``Context``.
"""

import inspect

import pytest

import test_torch_fleet
from tensorflowonspark_tpu import chaos as jchaos
from tensorflowonspark_tpu_torch import chaos, cluster, supervisor
from tensorflowonspark_tpu_torch.engine import Context

REF, PORT = test_torch_fleet.port_namespace(
    "test_resize.py", port_imports=True, cluster=cluster,
    supervisor=supervisor, Context=Context)

#: the reference's cases that need no cluster: each on both packages
PURE_CASES = (
    "test_elastic_resize_shrinks_on_executor_loss",
    "test_elastic_resize_respects_min_width_and_budget",
    "test_elastic_resize_restarts_at_intact_width_on_trainer_crash",
    "test_elastic_resize_width_defaults_from_exclusions",
    "test_legacy_policies_accept_width_kwarg",
    "test_decide_supports_legacy_five_arg_policies",
    "test_server_width_gauges_render_on_cluster_metrics",
    "test_supervisor_classifies_executor_lost_from_engine_liveness",
    "test_supervisor_liveness_view_errors_are_non_fatal",
    "test_trainer_side_step_raises_resize_drain_at_boundary",
    "test_trainer_side_drain_poll_is_throttled",
    "test_parse_spec_drop_executor_point",
    "test_drop_executor_refuses_outside_trainer",
)


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    monkeypatch.delenv(chaos.ENV_VAR, raising=False)
    chaos.disarm()
    jchaos.disarm()
    yield
    chaos.disarm()
    jchaos.disarm()


def _call(fn, request, label):
    """Call a rebound case with the fixtures its signature names, each
    package's run in a ``tmp_path`` of its own."""
    kw = {}
    for name in inspect.signature(fn).parameters:
        if name == "tmp_path":
            kw[name] = request.getfixturevalue("tmp_path") / label
            kw[name].mkdir()
        else:
            kw[name] = request.getfixturevalue(name)
    return fn(**kw)


@pytest.mark.parametrize("case", PURE_CASES)
def test_reference_case_on_both_packages(case, request):
    _call(getattr(REF, case), request, "jax")
    jchaos.disarm()
    _call(PORT[case], request, "port")


def test_revive_executor_restores_engine_capacity(tmp_path):
    PORT["test_revive_executor_restores_engine_capacity"](tmp_path)


def test_revive_executor_keeps_its_id_and_work_dir(tmp_path):
    """The revived process registers under the old id and appends to
    the old work dir's log; a standalone context (no local spawning)
    refuses to revive."""
    import os

    sc = Context(num_executors=1, work_root=str(tmp_path / "engine"))
    try:
        log = os.path.join(sc.work_root, "executor-0", "executor.log")
        old_pid = sc._procs[0].pid
        sc._procs[0].kill()

        def _dead():
            try:
                sc.parallelize([1], 1).foreachPartition(lambda it: None)
            except Exception:  # noqa: BLE001 - the job on the corpse
                pass
            return sc.executors_alive() == []

        assert chaos.poll_until(_dead, timeout=30)
        assert sc.revive_executor(0) is True
        assert sc.executors_alive() == [0]
        assert sc._procs[-1].pid != old_pid
        assert sc._procs[-1].poll() is None
        assert os.path.getsize(log) > 0
        assert sc.parallelize([3, 4], 1).mapPartitions(
            lambda it: [sum(it)]).collect() == [7]
    finally:
        sc.stop()
    standalone = object.__new__(Context)
    standalone._lock = sc._lock
    standalone._handles = {}
    standalone._spawn_local = False
    with pytest.raises(NotImplementedError, match="local mode"):
        standalone.revive_executor(0)


def test_the_supervised_cluster_carries_the_references_surface():
    """``SupervisedCluster`` has every method of the reference's (the
    formation, attempt, teardown and decide loop, the regrow probe and
    the shrink)."""
    from tensorflowonspark_tpu import supervisor as jsupervisor

    mine = {n for n in vars(supervisor.SupervisedCluster)
            if not n.startswith("__")}
    theirs = {n for n in vars(jsupervisor.SupervisedCluster)
              if not n.startswith("__")}
    assert mine == theirs
    assert {n for n in vars(supervisor.TrainerSide)
            if not n.startswith("__")} == \
        {n for n in vars(jsupervisor.TrainerSide) if not n.startswith("__")}


# -- mirror of the reference's slow / chaos case ---------------------------

@pytest.mark.chaos
@pytest.mark.slow
def test_elastic_shrink_then_regrow_matches_uninterrupted(tmp_path):
    PORT["test_elastic_shrink_then_regrow_matches_uninterrupted"](tmp_path)


def _slow_window_map_fun():
    """The reference's elastic trainer (a checkpoint chain per executor,
    the drop-executor site before the first read, ack confirmed before
    the checkpoint), with a consume -> commit window of ``args["hold"]``
    seconds on each step — a first step on a card (cuBLAS, the kernels'
    first load) takes seconds."""

    def train_fun(args, ctx):
        import json as _json
        import os as _os
        import time as _time

        import numpy as _np

        from tensorflowonspark_tpu_torch import chaos as _chaos
        from tensorflowonspark_tpu_torch import checkpoint as _checkpoint
        from tensorflowonspark_tpu_torch import reservation as _reservation
        from tensorflowonspark_tpu_torch import supervisor as _supervisor

        eid = ctx.executor_id
        ckpt = _checkpoint.Checkpointer(
            _os.path.join(args["dir"], "exec-{}".format(eid)))
        like = {"step": _np.array(0, _np.int32),
                "seen": _np.array(0.0, _np.float64)}
        restored = ckpt.restore(like, fallback=True)
        state = restored if restored is not None else like
        step = int(state["step"])
        start = step
        sup = _supervisor.attach(
            ctx, restored_step=step if restored is not None else None)
        sup.step(step)  # drop_executor chaos site (only=<eid> scoped)
        feed = ctx.get_data_feed(train_mode=True)

        def _acked_up_to(n):
            client = _reservation.Client(ctx.cluster_meta["server_addr"])
            try:
                return _chaos.poll_until(lambda: len(client.acked()) >= n,
                                         timeout=60)
            finally:
                client.close()

        while not feed.should_stop():
            batch = feed.next_batch(args["batch"])
            if not batch:
                continue
            _time.sleep(args["hold"])  # the slow step
            step += 1
            state = {"step": _np.array(step, _np.int32),
                     "seen": _np.array(float(state["seen"]) + sum(batch),
                                       _np.float64)}
            if not _acked_up_to(step - start):
                raise RuntimeError("feed ack never observed")
            ckpt.save(step, state)
            sup.step(step)
        with open(_os.path.join(args["dir"],
                                "final-{}.json".format(eid)), "w") as f:
            _json.dump({"step": step, "seen": float(state["seen"])}, f)

    return train_fun


def test_a_survivor_mid_step_commits_before_its_attempt_is_torn_down(
        tmp_path):
    """Executor 1 is dropped while executor 0's trainer is inside its
    consume -> commit window (a 2 s step): the partition executor 0
    consumed is acked, so the teardown must let that trainer finish its
    step — the reservation server up, its node shut down with the
    config's ``teardown_grace`` — or the partition is lost. The job ends
    exactly once over the shrink and the regrow."""
    import json
    import os

    ckpt_dir = str(tmp_path / "ckpt")
    os.makedirs(ckpt_dir)
    fuse = str(tmp_path / "fuse")
    batch, parts = 4, 4
    records = list(range(batch * parts))
    sc = Context(
        num_executors=2, work_root=str(tmp_path / "engine"),
        executor_env={
            chaos.ENV_VAR:
                "drop_executor_then_return_after=1,only=1,fuse=" + fuse,
            "TFOS_FEED_TRANSPORT": "queue"})
    cfg = supervisor.SupervisorConfig(
        policy=supervisor.ElasticResize(min_width=1, max_restarts=4,
                                        backoff=0.1, regrow_probe_s=0.2),
        heartbeat_interval=0.25, heartbeat_timeout=20.0,
        poll_interval=0.1, classify_grace=10.0, teardown_grace=30.0)
    try:
        tfc = cluster.run(sc, _slow_window_map_fun(),
                          {"dir": ckpt_dir, "batch": batch, "hold": 2.0},
                          num_executors=2,
                          input_mode=cluster.InputMode.SPARK, supervise=cfg)
        chaos.schedule_executor_return(sc, 1, fuse, delay=1.0)
        tfc.train(sc.parallelize(records, parts), feed_timeout=60)
    finally:
        sc.stop()
    assert os.path.exists(fuse), "the drop never fired"
    totals = {"step": 0, "seen": 0.0}
    for eid in (0, 1):
        path = os.path.join(ckpt_dir, "final-{}.json".format(eid))
        if os.path.exists(path):
            final = json.load(open(path))
            totals["step"] += final["step"]
            totals["seen"] += final["seen"]
    rep = tfc.report()
    assert [f["kind"] for f in rep["failures"]] == ["executor_lost"], rep
    assert rep["acked_partitions"] == parts
    assert totals == {"step": parts, "seen": float(sum(records))}, totals
