#!/usr/bin/env python3
"""Supervised training's recovery on the port, measured: a trainer
killed and restored, and an executor lost and returned.

    python3 -m tensorflowonspark_tpu_torch.profile_recovery \
        [--mode restart|shrink|both] [--device cuda|cpu] [--layers 12]

Both modes train a ``DecoderLM`` (GPT-2-small's width by default: vocab
50257, hidden 768, 12 heads, 1024 positions; random weights from the
seed, float32) through ``cluster.run(..., supervise=SupervisorConfig)``
on an engine ``Context``, fed a seeded motif stream (rows repeating a
random motif, ``y`` = ``x`` shifted by one) as one feed partition a
step. Each trainer restores its ``Checkpointer`` chain, publishes its
milestones through ``supervisor.attach``, and per step: trains, logs the
loss and its flash launches, confirms the partition's ack with the
reservation server, saves a checkpoint and calls ``sup.step`` (the chaos
step site, and the elastic boundary drain).

- ``restart`` (one executor, ``--layers`` deep, 12 by default):
  ``kill_trainer_at_step=K`` SIGKILLs the trainer after step K's
  checkpoint; ``RestartFromCheckpoint`` reforms, the new trainer
  restores step K and finishes. One step after the restore runs under
  ``tracing.trace`` (a ``torch.profiler`` Chrome trace) and the loss
  goes through ``tracing.SummaryWriter``.
- ``shrink`` (two executors, 2 layers): each trainer trains alone (no
  process group: two ranks on one card cannot form an NCCL group) and
  keeps its own checkpoint chain; ``drop_executor_then_return_after=T,only=1``
  SIGKILLs executor 1 (and its trainer) at its first step site,
  ``ElasticResize(min_width=1)`` reforms at width 1 with the unacked
  partitions on the survivor, ``chaos.schedule_executor_return`` revives
  the executor T seconds later and the regrow probe drains the survivor
  at a step boundary and reforms at width 2.

Each mode prints the MTTR stages (``supervisor.recovery_stages``:
detect, reform, restore, first step, MTTR, from the chaos fuse's fire
time), the ledger (formations, failure kinds, widths, acked partitions,
exclusions), the ``exactly_once`` verdict (every partition consumed by
exactly one committed step: the steps logged are each step once, and the
rows' token sum equals the data's), the flash launches summed over
attempts, each trainer's peak memory and the walls. ``chip_smoke.py``
phase 15 runs these legs (:func:`restart_leg`, :func:`shrink_leg`) and
checks them. On the CPU (``--device cpu``, with ``--vocab``,
``--hidden``, ``--heads``, ``--seq`` cut down) the same harness runs
with attention on the plain path (no kernel launches).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

SEED = 1234
#: seconds a surviving trainer gets to reach its step boundary when an
#: attempt is torn down: above a first step on the card (seconds: cuBLAS
#: and the kernels' first load) plus a 1.5 GB checkpoint save
TEARDOWN_GRACE = 60.0
#: seconds from executor 1's drop to its return in ``shrink``: past the
#: shrink's teardown, which waits for the survivor's step boundary (its
#: first step on a card plus a checkpoint save: ~10 s) — an executor
#: back sooner cancels the shrink (``ElasticResize`` keeps the width)
SHRINK_RETURN_AFTER = 20.0
GPT2 = {"vocab": 50257, "hidden": 768, "heads": 12, "layers": 12,
        "max_len": 1024}


def motif_rows(steps, batch, seq, vocab, seed=SEED):
    """``steps * batch`` rows of ``seq + 1`` token ids, each repeating a
    random motif of 16-64 tokens from a pool of 256 ids (``chip_smoke.py``
    phase 5's stream: same seed, same draws)."""
    rng = np.random.RandomState(seed + 3)
    pool = rng.choice(vocab, size=min(256, vocab), replace=False)
    rows = np.empty((steps * batch, seq + 1), np.int64)
    for r in range(steps * batch):
        motif = pool[rng.randint(0, len(pool), size=rng.randint(16, 65))]
        rows[r] = np.resize(motif, seq + 1)
    return rows


def state_digest(state):
    """sha256 over every parameter, every optimizer moment and step
    count (parameter-name order) and the step: equal digests are a
    bitwise equal train state."""
    import hashlib

    h = hashlib.sha256()
    names = {id(p): n for n, p in state["params"].items()}
    for name, p in sorted(state["params"].items()):
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    opt = state["opt_state"]
    for p, st in sorted(opt.state.items(), key=lambda kv: names[id(kv[0])]):
        for k in sorted(st):
            h.update(k.encode())
            h.update(st[k].detach().cpu().numpy().tobytes())
    h.update(str(int(state["step"])).encode())
    return h.hexdigest()


# -- the trainers (run in processes forked from the executors) -------------

def _trainer_setup(args, ctx, ckpt_dir, torch_before):
    """Model, trainer, state and checkpointer of a supervised trainer;
    the state restored from ``ckpt_dir``'s latest step if it has one.
    ``torch_before``: whether torch was loaded when the trainer began
    (inherited from its executor). Returns ``(torch, dev, trainer,
    state, ckpt, restored, probe)``."""
    import torch

    # a trainer forked from an executor that had touched CUDA would be
    # in a "bad fork": node._refuse_cuda_executor refuses that executor
    # before it forks, and this reading is the trainer's own evidence
    in_bad_fork = bool(torch.cuda._is_in_bad_fork())
    from tensorflowonspark_tpu_torch import checkpoint, training
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = ctx.initialize_torch(args["device"])
    cfg = args["model"]
    model = DecoderLM(cfg["vocab"], hidden=cfg["hidden"],
                      num_heads=cfg["heads"], num_layers=cfg["layers"],
                      max_len=cfg["max_len"], device=dev)
    trainer = training.Trainer(model, training.adamw(args["lr"]), device=dev)
    gen = (torch.Generator(device=dev) if dev.type == "cuda"
           else torch.Generator())
    state = trainer.init(gen.manual_seed(args["seed"]))
    ckpt = checkpoint.Checkpointer(ckpt_dir, max_to_keep=2)
    t0 = time.monotonic()
    restored = ckpt.restore(state, fallback=True)
    probe = {"pid": os.getpid(), "executor": ctx.executor_id,
             "torch_in_executor": torch_before, "in_bad_fork": in_bad_fork,
             "device": str(dev),
             "restored_step": None if restored is None
             else int(restored["step"]),
             "restore_s": time.monotonic() - t0}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    return torch, dev, trainer, state, ckpt, restored, probe


#: seconds an aborted attempt's trainer keeps waiting for its
#: partition's ack: once the node's state flips, the feeder decides
#: within its 1 s drain poll and acks (or not) at once
ABORTED_ACK_WAIT = 5.0


def _acked_up_to(ctx, n, timeout):
    """Whether the reservation server holds ``n`` acks (this attempt's
    steps), waiting at most ``timeout`` s — or ``ABORTED_ACK_WAIT`` s
    once the driver has aborted the attempt (node state ``error``): the
    feeder of a partition this trainer already read may then have
    returned unconsumed, so no ack comes, and the step must end
    uncommitted for the partition to replay."""
    from tensorflowonspark_tpu_torch import chaos, reservation

    client = reservation.Client(ctx.cluster_meta["server_addr"])
    aborted = [None]

    def done():
        if len(client.acked()) >= n:
            return True
        if ctx.mgr.get("state") in ("error", "stopped"):
            aborted[0] = aborted[0] or time.monotonic()
            return time.monotonic() - aborted[0] > ABORTED_ACK_WAIT
        return False

    try:
        return chaos.poll_until(done, timeout=timeout, interval=0.1) \
            and len(client.acked()) >= n
    finally:
        client.close()


def _log(path, record):
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def _supervised_loop(args, ctx, ckpt_dir, log_path, drop_site):
    """The supervised step loop both modes run: restore, attach, then per
    partition train -> log -> ack -> checkpoint -> ``sup.step``.
    ``drop_site``: call ``sup.step`` once before the first read (the
    drop-executor chaos site fires there, before the target consumes
    anything)."""
    torch_before = "torch" in sys.modules
    from tensorflowonspark_tpu_torch import supervisor, tracing
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    torch, dev, trainer, state, ckpt, restored, probe = _trainer_setup(
        args, ctx, ckpt_dir, torch_before)
    step = int(state["step"])
    start = step
    _log(log_path, dict(probe, event="start", wall=time.time()))
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping={"tokens": "tokens"})
    sup = supervisor.attach(
        ctx, restored_step=step if restored is not None else None,
        feed=feed)
    if drop_site:
        sup.step(step)
    for name in fa.launches:
        fa.launches[name] = 0
    writer = None
    while not feed.should_stop():
        batch = feed.next_batch(args["batch"])
        if not batch or not len(batch["tokens"]):
            continue
        rows = np.array(batch["tokens"])  # out of the reused staging buffer
        t0 = time.monotonic()
        tensors = {"x": torch.from_numpy(rows[:, :-1]).to(dev),
                   "y": torch.from_numpy(rows[:, 1:]).to(dev)}
        traced = args.get("trace_step") == step + 1
        if traced:
            window = tracing.trace(args["trace_dir"])
            window.__enter__()
        state, metrics = trainer.step(state, tensors)
        loss = float(metrics["loss"])  # waits for the step
        if traced:
            window.__exit__(None, None, None)
        step = int(state["step"])
        step_s = time.monotonic() - t0
        if traced and args.get("summary_dir"):
            # built here, past the first post-restore step, so its
            # start-up (tensorboard's imports) stays out of the MTTR
            writer = tracing.SummaryWriter(args["summary_dir"])
        if writer is not None:
            writer.scalar("train/loss", loss, step)
        # ack confirmed BEFORE the checkpoint: an abort racing the
        # feeder's join leaves a consumed partition unacked, and
        # committing it first would turn its replay into a double count
        if not _acked_up_to(ctx, step - start, args["ack_timeout"]):
            raise RuntimeError("feed ack never observed; step {} aborted "
                               "uncommitted".format(step))
        t1 = time.monotonic()
        ckpt.save(step, state)
        save_s = time.monotonic() - t1
        _log(log_path, {
            "event": "step", "step": step, "loss": loss,
            "seen": int(rows.sum()), "rows": len(rows),
            "launches": dict(fa.launches), "step_s": step_s,
            "save_s": save_s, "wall": time.time(),
            "executor": ctx.executor_id, "pid": os.getpid(),
            "trace": window.path if traced else None,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)})
        sup.step(step)  # chaos kill site and drain site
    if writer is not None:
        writer.close()
    _log(log_path, {"event": "done", "step": step, "wall": time.time(),
                    "executor": ctx.executor_id, "pid": os.getpid(),
                    "summary_backend": writer.backend if writer else None,
                    "digest": state_digest(state)})


def restart_train_fun(args, ctx):
    """The ``restart`` mode's trainer (one executor, one chain)."""
    _supervised_loop(args, ctx, args["ckpt_dir"], args["log"],
                     drop_site=False)


def elastic_train_fun(args, ctx):
    """The ``shrink`` mode's trainer: a checkpoint chain per executor,
    the drop-executor site before the first read."""
    eid = ctx.executor_id
    _supervised_loop(args, ctx,
                     os.path.join(args["ckpt_dir"], "exec-{}".format(eid)),
                     args["log"], drop_site=True)


def executor_cuda_probe(iterator):
    """Run as a task in each executor: whether it holds a CUDA context
    (it must not: its trainers fork from it)."""
    list(iterator)
    torch = sys.modules.get("torch")
    return [{"pid": os.getpid(),
             "cuda_initialized": bool(torch is not None
                                      and torch.cuda.is_initialized())}]


# -- the legs (run in the driver) -------------------------------------------

def _read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _ledger(rep):
    return {"formations": rep["formations"],
            "failures": [f["kind"] for f in rep["failures"]],
            "failure_executors": [f["executor_id"] for f in rep["failures"]],
            "widths": [e["width"] for e in rep["events"]
                       if e["name"] == "cluster_formed"],
            "width": rep["width"],
            "excluded": rep["excluded"],
            "acked_partitions": rep["acked_partitions"]}


class _Window(object):
    """The ``EventLog`` read surface ``recovery_stages`` uses, over the
    events before the ``nth`` ``until`` event: the shrink's own stages,
    before the planned regrow drain's exit is detected in turn."""

    def __init__(self, events, until, nth=1):
        found = events.events(until)
        cut = found[nth]["t"] if len(found) > nth else float("inf")
        self._events = [e for e in events.events() if e["t"] < cut]

    def events(self, name=None):
        return [e for e in self._events if name is None or e["name"] == name]

    def last(self, name):
        found = self.events(name)
        return found[-1] if found else None


def _regrow_stages(events):
    """Capacity back -> regrow drain requested -> reformed at the target
    width -> that formation's first step (seconds; None when absent)."""
    asked = next(iter(events.events("regrow_requested")), None)
    if asked is None:
        return None
    formed = next((e for e in events.events("cluster_formed")
                   if e["t"] >= asked["t"]), None)
    first = next((e for e in events.events("first_step")
                  if formed is not None and e["t"] >= formed["t"]), None)
    return {"drain_to_formed_s": None if formed is None
            else round(formed["t"] - asked["t"], 3),
            "formed_width": None if formed is None else formed["width"],
            "first_step_s": None if first is None
            else round(first["t"] - formed["t"], 3)}


def _sum_launches(steps):
    """Launches summed over attempts: each trainer's counts are
    cumulative from zero, so each pid's last step holds its total."""
    last = {}
    for s in steps:
        last[s["pid"]] = s["launches"]
    out = {}
    for counts in last.values():
        for k, v in counts.items():
            out[k] = out.get(k, 0) + v
    return out


def _probe_executors(sc):
    """:func:`executor_cuda_probe` once in every live executor."""
    alive = sc.executors_alive()
    parts = sc.run_job(sc.parallelize(alive, len(alive)),
                       executor_cuda_probe,
                       one_task_per_executor=True).get(timeout=120)
    return [p for part in parts for p in part]


def restart_leg(rows, model, work, device=None, batch=8, kill_at=5,
                lr=3e-4, seed=SEED, trace_step=None, transport="shm"):
    """One executor; the trainer SIGKILLed after step ``kill_at``'s
    checkpoint and restored by ``RestartFromCheckpoint``. ``rows``
    (``[steps * batch, seq + 1]``) are fed as one partition a step.
    Returns the leg's record (see the module docstring)."""
    from tensorflowonspark_tpu_torch import chaos, supervisor
    from tensorflowonspark_tpu_torch.engine import Context

    parts = len(rows) // batch
    fuse = os.path.join(work, "kill.fuse")
    log = os.path.join(work, "restart.jsonl")
    args = {"device": device, "model": dict(model), "batch": batch,
            "lr": lr, "seed": seed, "ckpt_dir": os.path.join(work, "ckpt"),
            "log": log, "ack_timeout": 60, "trace_step": trace_step,
            "trace_dir": os.path.join(work, "trace"),
            "summary_dir": os.path.join(work, "tb")}
    cfg = supervisor.SupervisorConfig(
        policy=supervisor.RestartFromCheckpoint(max_restarts=2, backoff=0.1),
        heartbeat_interval=0.25, heartbeat_timeout=60.0, poll_interval=0.1,
        classify_grace=10.0, teardown_grace=TEARDOWN_GRACE)
    sc = Context(num_executors=1, work_root=os.path.join(work, "engine"),
                 executor_env={
                     "TFOS_FEED_TRANSPORT": transport,
                     chaos.ENV_VAR: "kill_trainer_at_step={},fuse={}".format(
                         kill_at, fuse)})
    try:
        from tensorflowonspark_tpu_torch import cluster

        t0 = time.monotonic()
        tfc = cluster.run(sc, restart_train_fun, args, 1, supervise=cfg,
                          input_mode=cluster.InputMode.SPARK)
        tfc.train(sc.parallelize([{"tokens": r} for r in rows], parts),
                  feed_timeout=600)
        wall = time.monotonic() - t0
        probes = _probe_executors(sc)
    finally:
        sc.stop()
    left = [p.pid for p in sc._procs if p.poll() is None]
    fired = os.path.exists(fuse)
    kill_wall = float(open(fuse).read()) if fired else None
    rep = tfc.report()
    entries = _read_log(log)
    steps = [e for e in entries if e["event"] == "step"]
    starts = [e for e in entries if e["event"] == "start"]
    done = [e for e in entries if e["event"] == "done"]
    step_ids = [s["step"] for s in steps]
    return {
        "mode": "restart", "model": dict(model), "parts": parts,
        "kill_at": kill_at, "fired": fired, "wall_s": wall,
        "ledger": _ledger(rep),
        "recovery": supervisor.recovery_stages(tfc.events,
                                               kill_wall=kill_wall),
        "exactly_once": (step_ids == list(range(1, parts + 1))
                         and sum(s["seen"] for s in steps)
                         == int(rows.sum())
                         and rep["acked_partitions"] == parts),
        "losses": [s["loss"] for s in steps],
        "step_ids": step_ids,
        "launches": _sum_launches(steps),
        "peak_bytes": {str(s["pid"]): s["peak_bytes"] for s in steps},
        "save_s": [s["save_s"] for s in steps],
        "step_s": [s["step_s"] for s in steps],
        "trainers": starts,
        "digest": done[-1]["digest"] if done else None,
        "summary_backend": done[-1]["summary_backend"] if done else None,
        "trace": next((s["trace"] for s in steps if s["trace"]), None),
        "executor_probes": probes, "processes_left": left}


def shrink_leg(rows, model, work, device=None, batch=8, lr=3e-4,
               seed=SEED, return_after=None, transport="shm"):
    """Two executors; executor 1 dropped at its first step site and
    returned ``return_after`` seconds later; ``ElasticResize`` shrinks
    to width 1 and regrows to 2. Returns the leg's record."""
    from tensorflowonspark_tpu_torch import chaos, supervisor
    from tensorflowonspark_tpu_torch.engine import Context

    parts = len(rows) // batch
    if return_after is None:
        return_after = SHRINK_RETURN_AFTER
    fuse = os.path.join(work, "drop.fuse")
    log = os.path.join(work, "shrink.jsonl")
    args = {"device": device, "model": dict(model), "batch": batch,
            "lr": lr, "seed": seed, "ckpt_dir": os.path.join(work, "ckpt"),
            "log": log, "ack_timeout": 60}
    cfg = supervisor.SupervisorConfig(
        policy=supervisor.ElasticResize(min_width=1, max_restarts=4,
                                        backoff=0.1, regrow_probe_s=0.2),
        heartbeat_interval=0.25, heartbeat_timeout=60.0, poll_interval=0.1,
        classify_grace=10.0, teardown_grace=TEARDOWN_GRACE)
    # each trainer trains alone on its partitions, with no collective
    # between them (two ranks on one card cannot form an NCCL group)
    sc = Context(num_executors=2, work_root=os.path.join(work, "engine"),
                 executor_env={
                     "TFOS_FEED_TRANSPORT": transport,
                     "TFOS_TPU_DISTRIBUTED": "0",
                     chaos.ENV_VAR: "drop_executor_then_return_after={},"
                                    "only=1,fuse={}".format(return_after,
                                                            fuse)})
    try:
        from tensorflowonspark_tpu_torch import cluster

        t0 = time.monotonic()
        tfc = cluster.run(sc, elastic_train_fun, args, 2, supervise=cfg,
                          input_mode=cluster.InputMode.SPARK)
        chaos.schedule_executor_return(sc, 1, fuse, delay=return_after)
        tfc.train(sc.parallelize([{"tokens": r} for r in rows], parts),
                  feed_timeout=600)
        wall = time.monotonic() - t0
        probes = _probe_executors(sc)
    finally:
        sc.stop()
    left = [p.pid for p in sc._procs if p.poll() is None]
    fired = os.path.exists(fuse)
    kill_wall = float(open(fuse).read()) if fired else None
    rep = tfc.report()
    entries = _read_log(log)
    steps = [e for e in entries if e["event"] == "step"]
    starts = [e for e in entries if e["event"] == "start"]
    # one committed step per partition, across every executor's chain
    last_by_exec = {}
    for s in steps:
        last_by_exec[s["executor"]] = s["step"]
    return {
        "mode": "shrink", "model": dict(model), "parts": parts,
        "return_after": return_after, "fired": fired, "wall_s": wall,
        "ledger": _ledger(rep),
        "width_changes": rep["width_changes"],
        "regrow_requested": any(e["name"] == "regrow_requested"
                                for e in rep["events"]),
        # the executor loss's recovery, before the regrow drain's exit
        # is detected in turn
        "recovery": supervisor.recovery_stages(
            _Window(tfc.events, "failure_detected"), kill_wall=kill_wall),
        "regrow": _regrow_stages(tfc.events),
        "exactly_once": (len(steps) == parts
                         and sum(last_by_exec.values()) == parts
                         and sum(s["seen"] for s in steps)
                         == int(rows.sum())
                         and rep["acked_partitions"] == parts),
        "steps_by_executor": {str(k): v for k, v in last_by_exec.items()},
        "launches": _sum_launches(steps),
        "peak_bytes": {str(s["pid"]): s["peak_bytes"] for s in steps},
        "trainers": starts,
        "executor_probes": probes, "processes_left": left}


def _print_leg(leg):
    rec = leg["recovery"] or {}
    print("{} leg: wall {:.2f}s; MTTR stages {}".format(
        leg["mode"], leg["wall_s"], json.dumps(rec)))
    print("{} ledger: {}; exactly_once {}".format(
        leg["mode"], json.dumps(leg["ledger"]), leg["exactly_once"]))
    peaks = {k: (None if v is None else round(v / 2 ** 30, 3))
             for k, v in leg["peak_bytes"].items()}
    print("{} flash launches over attempts {}; trainer peak GiB {}".format(
        leg["mode"], leg["launches"], peaks))
    if leg.get("regrow") is not None:
        print("shrink regrow: {}".format(json.dumps(leg["regrow"])))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("restart", "shrink", "both"),
                    default="both")
    ap.add_argument("--device", default=None,
                    help="the trainers' device (default: the card)")
    ap.add_argument("--vocab", type=int, default=GPT2["vocab"])
    ap.add_argument("--hidden", type=int, default=GPT2["hidden"])
    ap.add_argument("--heads", type=int, default=GPT2["heads"])
    ap.add_argument("--layers", type=int, default=GPT2["layers"],
                    help="restart mode's depth (shrink runs 2 layers)")
    ap.add_argument("--seq", type=int, default=GPT2["max_len"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--kill-at", type=int, default=5)
    ap.add_argument("--return-after", type=float, default=SHRINK_RETURN_AFTER)
    ap.add_argument("--work", default=None,
                    help="work directory (default: a fresh one under the "
                         "current directory, removed at the end)")
    ap.add_argument("--out", default=None, help="write the legs as JSON")
    args = ap.parse_args(argv)
    import shutil
    import tempfile

    work = args.work or tempfile.mkdtemp(prefix=".tfos-recovery-",
                                         dir=os.getcwd())
    rows = motif_rows(args.steps, args.batch, args.seq, args.vocab)
    model = {"vocab": args.vocab, "hidden": args.hidden,
             "heads": args.heads, "layers": args.layers,
             "max_len": args.seq}
    legs = []
    try:
        if args.mode in ("restart", "both"):
            os.makedirs(os.path.join(work, "restart"), exist_ok=True)
            legs.append(restart_leg(
                rows, model, os.path.join(work, "restart"),
                device=args.device, batch=args.batch, kill_at=args.kill_at,
                trace_step=args.kill_at + 2))
            _print_leg(legs[-1])
        if args.mode in ("shrink", "both"):
            os.makedirs(os.path.join(work, "shrink"), exist_ok=True)
            legs.append(shrink_leg(
                rows, dict(model, layers=2), os.path.join(work, "shrink"),
                device=args.device, batch=args.batch,
                return_after=args.return_after))
            _print_leg(legs[-1])
    finally:
        if args.work is None:
            shutil.rmtree(work, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(legs, f, indent=1)
    return 0 if all(leg["exactly_once"] for leg in legs) else 1


if __name__ == "__main__":
    sys.exit(main())
