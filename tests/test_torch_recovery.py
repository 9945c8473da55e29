"""The port's training supervision (``cluster.run(supervise=)``,
``supervisor.SupervisedCluster``, the chaos step site) held against the
JAX package's.

- PURE — the reference's own cases of ``tests/test_recovery.py`` that
  need no cluster (the chaos spec grammar and fuses, the heartbeat
  drop window, the corruption helpers, ``poll_until``, the event log
  and the MTTR stages) run on BOTH packages, rebound to each package's
  modules; the fallback-restore cases run on the port's
  ``Checkpointer`` (numpy state, as the reference's). Imports inside
  the rebound functions' bodies are pointed at the port
  (``test_torch_qos.port_code``), so a rebound map_fun imports the
  port in its trainer process.
- CROSS-PACKAGE — ``recovery_stages`` over one seeded event log, and
  ``acked_feed`` draining acked partitions unfed, give equal results
  on both packages; the reference's supervised kill job (its
  ``_ckpt_train_fun``: numpy state, one partition a checkpointed step,
  a SIGKILL after step 3) runs on each package, and the two reports
  agree on formations, failure kinds, width and acked partitions, with
  the same ``final.json``; a small ``DecoderLM`` trainer killed after
  step 2 and restored by the port's ``SupervisedCluster`` takes the
  uninterrupted port run's losses and the JAX ``Trainer``'s.
- The reference's slow / chaos end-to-end cases are mirrored under the
  same marks, on the port's engine ``Context``.
"""

import json
import os
import time

import numpy as np
import pytest

import test_torch_fleet
from tensorflowonspark_tpu import chaos as jchaos
from tensorflowonspark_tpu import supervisor as jsupervisor
from tensorflowonspark_tpu import tracing as jtracing
from tensorflowonspark_tpu_torch import chaos, cluster, supervisor, tracing
from tensorflowonspark_tpu_torch.engine import Context

REF, PORT = test_torch_fleet.port_namespace(
    "test_recovery.py", port_imports=True, cluster=cluster,
    supervisor=supervisor, Context=Context)

#: the reference's cases that need no cluster: each on both packages
PURE_CASES = (
    "test_parse_spec_points_and_fields",
    "test_parse_spec_stall_alias",
    "test_arm_overrides_env_and_disarm_restores_env",
    "test_fuse_is_single_shot_across_incarnations",
    "test_only_scopes_to_executor",
    "test_drop_heartbeats_window_expires",
    "test_corrupt_latest_checkpoint_garbles_files",
    "test_poll_until_is_event_driven",
    "test_eventlog_record_last_span",
    "test_recovery_stages_breakdown",
)

#: the reference's checkpoint cases: the port's Checkpointer
CHECKPOINT_CASES = (
    "test_restore_fallback_walks_past_corrupt_latest",
    "test_restore_fallback_every_step_corrupt_is_terminal",
    "test_corrupt_checkpoint_injection_point",
)


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    """No armed injection leaks between cases, in either package."""
    monkeypatch.delenv(chaos.ENV_VAR, raising=False)
    chaos.disarm()
    jchaos.disarm()
    yield
    chaos.disarm()
    jchaos.disarm()


def _call(fn, request, label):
    """Call a rebound case with the fixtures its signature names; each
    package's run gets a ``tmp_path`` of its own (a fuse one run left
    behind must not disarm the other's injection)."""
    import inspect

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


@pytest.mark.parametrize("bad", [
    "frobnicate=1", "kill_trainer_at_step", "kill_trainer_at_step=1,zap",
    "kill_trainer_at_step=1,zap=2"])
def test_reference_parse_spec_rejects_typos_on_both_packages(bad):
    REF.test_parse_spec_rejects_typos_loudly(bad)
    PORT["test_parse_spec_rejects_typos_loudly"](bad)


@pytest.mark.parametrize("case", CHECKPOINT_CASES)
def test_reference_checkpoint_case_on_the_port(case, request):
    _call(PORT[case], request, "port")


def test_the_chaos_module_carries_the_references_points():
    assert set(chaos.POINTS) == set(jchaos.POINTS)
    for name in ("on_step", "kill_when", "schedule_executor_return",
                 "latest_step_on_disk", "corrupt_latest_checkpoint"):
        assert callable(getattr(chaos, name)), name


# -- cross-package ---------------------------------------------------------

def _seeded_log(mod, seed):
    """One seeded supervision timeline recorded into ``mod``'s EventLog
    with injected times (the same monotonic and wall stamps in both)."""
    rng = np.random.RandomState(seed)
    log = mod.EventLog()
    t, names = 100.0, ("restored", "failure_detected", "cluster_formed",
                       "restored", "first_step")
    for name in ("cluster_formed", "restored", "first_step") + names * (
            1 + seed % 2):
        t += float(rng.choice([0.05, 0.4, 1.5, 3.0]))
        if rng.rand() < 0.15:
            continue  # a milestone a run never reached
        log.record(name, step=int(rng.randint(0, 9)))
        log._events[-1]["t"] = t
        log._events[-1]["wall"] = 1.7e9 + t
    return log


@pytest.mark.parametrize("seed", range(6))
def test_recovery_stages_equal_on_one_seeded_event_log(seed):
    """``recovery_stages`` of each package over the same timeline (some
    milestones missing): equal dicts, with and without a kill time."""
    ours, theirs = _seeded_log(tracing, seed), _seeded_log(jtracing, seed)
    assert ours.events() == theirs.events()
    for kill_wall in (None, 1.7e9 + 50.0):
        assert supervisor.recovery_stages(ours, kill_wall) == \
            jsupervisor.recovery_stages(theirs, kill_wall)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_acked_feed_drains_acked_partitions_unfed(pkg, monkeypatch):
    """``acked_feed`` on each package: an acked partition is drained
    without feeding (no node call, no new ack); an unacked one is fed
    and acked against the reservation server."""
    import importlib

    base = "tensorflowonspark_tpu" + ("" if pkg == "jax" else "_torch")
    sup_mod = importlib.import_module(base + ".supervisor")
    node_mod = importlib.import_module(base + ".node")
    res_mod = importlib.import_module(base + ".reservation")
    fed = []

    def feed_one(iterator, cluster_info, cluster_meta, feed_timeout,
                 qname):
        fed.append(list(iterator))
        return True

    monkeypatch.setattr(node_mod, "_feed_one_partition", feed_one)
    server = res_mod.Server(1)
    addr = server.start()
    try:
        fn = sup_mod.acked_feed([], {"server_addr": list(addr)}, {0, 2})
        drained = []

        def part(values):
            for v in values:
                drained.append(v)
                yield v

        assert list(fn(0, part([1, 2]))) == []
        assert list(fn(2, part([5]))) == []
        assert fed == [] and drained == [1, 2, 5]
        assert server.acked_partitions() == set()
        assert list(fn(1, iter([3, 4]))) == []
        assert fed == [[3, 4]]
        assert chaos.poll_until(lambda: server.acked_partitions() == {1},
                                timeout=10)
    finally:
        server.stop()


def _kill_job(ns, tmp):
    """The reference's supervised kill job (its acceptance e2e's body)
    on the package ``ns`` names: returns the report and ``final.json``."""
    ckpt_dir = str(tmp / "ckpt")
    os.makedirs(ckpt_dir)
    fuse = str(tmp / "fuse")
    sup = ns["supervisor"]
    records = list(range(ns["BATCH"] * ns["PARTS"]))
    sc = ns["_supervised_ctx"](
        tmp, chaos_spec="kill_trainer_at_step=3,fuse={}".format(fuse))
    cfg = sup.SupervisorConfig(
        policy=sup.RestartFromCheckpoint(max_restarts=2, backoff=0.1),
        heartbeat_interval=0.25, heartbeat_timeout=20.0,
        poll_interval=0.1, classify_grace=10.0)
    try:
        tfc = ns["cluster"].run(
            sc, ns["_ckpt_train_fun"], {"dir": ckpt_dir,
                                        "batch": ns["BATCH"]},
            num_executors=1, input_mode=ns["cluster"].InputMode.SPARK,
            supervise=cfg)
        assert isinstance(tfc, sup.SupervisedCluster)
        tfc.train(sc.parallelize(records, ns["PARTS"]), feed_timeout=60)
    finally:
        sc.stop()
    assert os.path.exists(fuse), "the injection never fired"
    with open(os.path.join(ckpt_dir, "final.json")) as f:
        return tfc.report(), json.load(f)


@pytest.fixture(scope="module")
def kill_jobs(tmp_path_factory):
    """The kill job once on each package (fork start, queue transport)."""
    out = {}
    for name, ns in (("jax", vars(REF)), ("port", PORT)):
        t0 = time.monotonic()
        rep, final = _kill_job(ns, tmp_path_factory.mktemp(name))
        out[name] = {"report": rep, "final": final,
                     "seconds": time.monotonic() - t0}
    return out


def test_supervised_kill_job_recovers_exactly_once_on_both(kill_jobs):
    records = list(range(REF.BATCH * REF.PARTS))
    for name, got in kill_jobs.items():
        rep = got["report"]
        assert got["final"] == {"step": REF.PARTS,
                                "seen": float(sum(records))}, name
        assert rep["formations"] == 2, (name, rep)
        assert [f["kind"] for f in rep["failures"]] == ["trainer_crash"]
        stages = rep["recovery"]
        assert stages["restore_s"] is not None, (name, stages)
        assert stages["first_step_s"] is not None, (name, stages)
        assert stages["mttr_s"] is not None, (name, stages)


def test_supervised_kill_job_reports_agree_between_packages(kill_jobs):
    """The ledger a user reads: formations, failure kinds and their
    executors, width history, exclusions and acked partitions equal;
    the same ``final.json``; the same event names in the same order."""
    def ledger(rep):
        return {"formations": rep["formations"],
                "failures": [(f["kind"], f["executor_id"])
                             for f in rep["failures"]],
                "width": rep["width"],
                "width_changes": rep["width_changes"],
                "excluded": rep["excluded"],
                "acked_partitions": rep["acked_partitions"],
                "events": [e["name"] for e in rep["events"]]}

    jax_run, port_run = kill_jobs["jax"], kill_jobs["port"]
    assert ledger(port_run["report"]) == ledger(jax_run["report"])
    assert port_run["final"] == jax_run["final"]
    assert set(port_run["report"]["recovery"]) == \
        set(jax_run["report"]["recovery"])


# -- a DecoderLM trainer killed and restored -------------------------------

V, H, NH, L, T = 64, 32, 4, 2, 32
LR = 1e-3
STEPS, B = 4, 2
#: the port's restore is bitwise, so the restored run's losses equal the
#: uninterrupted run's to rounding; against the JAX Trainer the bound is
#: ``tests/test_torch_training.py``'s
RESTORE_RTOL = 1e-5
LOSS_RTOL = 1e-4


def _decoder_map_fun():
    """The trainer, built in a function so it ships by value: the
    port's ``DecoderLM`` from the given weights, ``Trainer(adamw)``, one
    feed partition a step, ``Checkpointer`` after each step, then the
    ack, then ``sup.step`` (the chaos kill site); each step's loss is
    appended to ``losses.jsonl``."""

    def train_fun(args, ctx):
        import json as _json
        import os as _os

        import numpy as _np
        import torch as _torch

        from tensorflowonspark_tpu_torch import chaos as _chaos
        from tensorflowonspark_tpu_torch import checkpoint as _checkpoint
        from tensorflowonspark_tpu_torch import reservation as _reservation
        from tensorflowonspark_tpu_torch import supervisor as _supervisor
        from tensorflowonspark_tpu_torch import training as _training
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

        cfg = args["model"]
        model = DecoderLM(cfg["vocab"], hidden=cfg["hidden"],
                          num_heads=cfg["heads"], num_layers=cfg["layers"],
                          max_len=cfg["max_len"])
        model.load_state_dict({k: _torch.from_numpy(v)
                               for k, v in args["weights"].items()})
        trainer = _training.Trainer(model, _training.adamw(args["lr"]),
                                    device="cpu")
        state = trainer.init()
        ckpt = _checkpoint.Checkpointer(args["dir"])
        restored = ckpt.restore(state, fallback=True)
        step = int(state["step"])
        start = step
        sup = _supervisor.attach(
            ctx, restored_step=step if restored is not None else None)
        feed = ctx.get_data_feed(train_mode=True)

        def acked_up_to(n):
            client = _reservation.Client(ctx.cluster_meta["server_addr"])
            try:
                return _chaos.poll_until(lambda: len(client.acked()) >= n,
                                         timeout=30)
            finally:
                client.close()

        while not feed.should_stop():
            rows = feed.next_batch(args["batch"])
            if not rows:
                continue
            rows = _np.asarray(rows, _np.int64)
            state, metrics = trainer.step(
                state, {"x": rows[:, :-1], "y": rows[:, 1:]})
            step = int(state["step"])
            with open(_os.path.join(args["dir"], "losses.jsonl"), "a") as f:
                f.write(_json.dumps({"step": step,
                                     "loss": float(metrics["loss"])})
                        + "\n")
            ckpt.save(step, state)
            acked_up_to(step - start)  # one partition == one step
            sup.step(step)  # chaos kill site: after checkpoint and ack

    return train_fun


def _rows():
    rng = np.random.RandomState(11)
    return rng.randint(0, V, (STEPS * B, T + 1)).astype(np.int64)


def _jax_run(rows):
    """The JAX ``Trainer`` on a one-device mesh over the same batches:
    its initial params (the port's weights come from them) and losses."""
    import jax
    import optax
    from jax.sharding import Mesh

    from tensorflowonspark_tpu import training as jtraining
    from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jt = jtraining.Trainer(
        JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L, max_len=T),
        optax.adamw(LR), mesh, loss_fn=jtraining.softmax_xent)
    state = jt.init(jax.random.PRNGKey(0), rows[:B, :-1].astype(np.int32))
    params = jax.tree.map(np.asarray, state["params"])
    losses = []
    for i in range(STEPS):
        batch = rows[i * B:(i + 1) * B].astype(np.int32)
        state, metrics = jt.step(state, {"x": batch[:, :-1],
                                         "y": batch[:, 1:]})
        losses.append(float(metrics["loss"]))
    return params, losses


def _uninterrupted_port_losses(params, rows):
    from tensorflowonspark_tpu_torch import convert, training
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    model = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L, max_len=T)
    model.load_state_dict(convert.from_flax(params))
    trainer = training.Trainer(model, training.adamw(LR), device="cpu")
    state = trainer.init()
    out = []
    for i in range(STEPS):
        batch = rows[i * B:(i + 1) * B]
        state, metrics = trainer.step(state, {"x": batch[:, :-1],
                                              "y": batch[:, 1:]})
        out.append(float(metrics["loss"]))
    return out


def test_decoder_trainer_restored_after_a_kill_takes_the_same_losses(
        tmp_path):
    """A 2-layer ``DecoderLM`` trainer SIGKILLed after step 2's
    checkpoint: the port's ``SupervisedCluster`` reforms, the trainer
    restores step 2 (weights and AdamW moments) and takes steps 3-4.
    Every step's loss equals the uninterrupted port run's within
    ``RESTORE_RTOL`` and the JAX ``Trainer``'s within ``LOSS_RTOL``."""
    from tensorflowonspark_tpu_torch import convert

    rows = _rows()
    params, ref = _jax_run(rows)
    ckpt_dir = str(tmp_path / "ckpt")
    os.makedirs(ckpt_dir)
    fuse = str(tmp_path / "fuse")
    weights = {k: v.numpy() for k, v in convert.from_flax(params).items()}
    sc = Context(num_executors=1, work_root=str(tmp_path / "engine"),
                 executor_env={
                     "TFOS_FEED_TRANSPORT": "queue",
                     chaos.ENV_VAR: "kill_trainer_at_step=2,fuse=" + fuse})
    cfg = supervisor.SupervisorConfig(
        policy=supervisor.RestartFromCheckpoint(max_restarts=2,
                                                backoff=0.1),
        heartbeat_interval=0.25, heartbeat_timeout=20.0,
        poll_interval=0.1, classify_grace=10.0)
    try:
        tfc = cluster.run(
            sc, _decoder_map_fun(),
            {"dir": ckpt_dir, "batch": B, "lr": LR, "weights": weights,
             "model": {"vocab": V, "hidden": H, "heads": NH, "layers": L,
                       "max_len": T}},
            num_executors=1, input_mode=cluster.InputMode.SPARK,
            supervise=cfg)
        tfc.train(sc.parallelize([r.tolist() for r in rows], STEPS),
                  feed_timeout=60)
    finally:
        sc.stop()
    assert os.path.exists(fuse), "the kill never fired"
    rep = tfc.report()
    assert rep["formations"] == 2
    assert [f["kind"] for f in rep["failures"]] == ["trainer_crash"]
    assert rep["acked_partitions"] == STEPS
    with open(os.path.join(ckpt_dir, "losses.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    # the killed step is not re-run: one loss a step, in order
    assert [e["step"] for e in logged] == list(range(1, STEPS + 1)), logged
    got = [e["loss"] for e in logged]
    want = _uninterrupted_port_losses(params, rows)
    for g, w in zip(got, want):
        assert abs(g - w) <= RESTORE_RTOL * abs(w), (got, want)
    for g, w in zip(got, ref):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (got, ref)


# -- mirrors of the reference's slow / chaos cases -------------------------

@pytest.mark.chaos
@pytest.mark.slow
def test_supervised_recovery_matches_uninterrupted_step_count(tmp_path):
    PORT["test_supervised_recovery_matches_uninterrupted_step_count"](
        tmp_path)


@pytest.mark.chaos
@pytest.mark.slow
def test_blacklist_excludes_twice_killed_executor(tmp_path):
    PORT["test_blacklist_excludes_twice_killed_executor"](tmp_path)


def test_profile_recovery_restart_mode_on_the_cpu(tmp_path, capsys):
    """``python -m tensorflowonspark_tpu_torch.profile_recovery --mode
    restart --device cpu`` at a small size: the kill fires, the job ends
    exactly once, and the printed ledger and MTTR stages are the
    report's."""
    from tensorflowonspark_tpu_torch import profile_recovery

    out = str(tmp_path / "legs.json")
    rc = profile_recovery.main([
        "--mode", "restart", "--device", "cpu", "--vocab", "64",
        "--hidden", "32", "--heads", "4", "--layers", "2", "--seq", "128",
        "--batch", "2", "--steps", "2", "--kill-at", "1",
        "--work", str(tmp_path / "work"), "--out", out])
    assert rc == 0
    with open(out) as f:
        (leg,) = json.load(f)
    assert leg["fired"] and leg["exactly_once"]
    assert leg["ledger"]["formations"] == 2
    assert leg["ledger"]["failures"] == ["trainer_crash"]
    assert leg["step_ids"] == [1, 2]
    assert [t["restored_step"] for t in leg["trainers"]] == [None, 1]
    assert all(leg["recovery"][k] is not None
               for k in ("detect_s", "reform_s", "restore_s", "mttr_s"))
    printed = capsys.readouterr().out
    assert "restart leg: wall" in printed and "exactly_once True" in printed


class _Leases(object):
    """A reservation server's lease read surface over a dict the test
    edits."""

    def __init__(self):
        self.leases = {}

    def lease_snapshot(self):
        return {eid: dict(lease) for eid, lease in self.leases.items()}


def test_stopping_the_monitor_records_milestones_its_last_poll_missed():
    """The restored trainer's first step can ride only its node's final
    synchronous beat when the job ends right after it (the restart-mode
    case above: 2 steps, killed after the first). A monitor that has not
    polled since — a poll interval on a loaded box — must still record
    ``restored`` and ``first_step`` when it stops, or the MTTR stages
    lose their first step and ``mttr_s``."""
    server = _Leases()
    server.leases[0] = {"age": 0.0, "payload": {"state": "running",
                                                "feed_hb": 0}}
    sup = supervisor.Supervisor(
        server=server, executors=[0],
        config=supervisor.SupervisorConfig(poll_interval=60.0,
                                           heartbeat_timeout=60.0))
    sup.start()
    # the monitor's first poll has read the running lease; its next is a
    # minute away
    assert chaos.poll_until(lambda: 0 in sup._progress, timeout=10)
    server.leases[0] = {"age": 0.0, "payload": {
        "state": "stopped", "restored_step": 1, "train_step": 2}}
    sup.stop()
    assert [e["step"] for e in sup.events.events("restored")] == [1]
    assert [e["step"] for e in sup.events.events("first_step")] == [2]
    assert sup.first_failure() is None
