"""The port's cluster plane: ``cluster.run`` → ``tfc.train``/``inference``
→ ``DataFeed`` in a forked trainer, on the CPU.

Micro-jobs that mirror the reference's ``tests/test_cluster.py`` on the
port's engine with 2 executors (a train round-trip over the shm ring, an
inference round-trip in exact order, the deep-partition case on the
queues, TENSORFLOW mode inline, a ``map_fun`` error surfacing at
``shutdown``); the port's serializer on closures, lambdas and
``__main__`` functions in a process where ``cloudpickle`` cannot be
imported; a 2-executor gloo all-reduce through
``NodeContext.initialize_torch``; no executor or trainer process holding
``jax``, ``tensorflowonspark_tpu`` or ``cloudpickle``, or a CUDA context
in an executor; and the slice as a whole — the same tiny ``DecoderLM``
weights and records through the JAX package's ``cluster.run`` with its
``Trainer`` and through the port's with its own give the same per-step
losses (1e-4 relative).

``map_fun``s are defined inside the tests: the engine ships them by
value, and the executors cannot import this test module.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tensorflowonspark_tpu_torch import cluster, reservation
from tensorflowonspark_tpu_torch.engine import Context

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREIGN = ("jax", "jaxlib", "flax", "optax", "tensorflowonspark_tpu",
           "cloudpickle")
#: per-step losses of the two trainers (tests/test_torch_training.py)
LOSS_RTOL = 1e-4


@pytest.fixture()
def sc(tmp_path):
    ctx = Context(num_executors=2, work_root=str(tmp_path / "engine"),
                  executor_env={"TFOS_FEED_TRANSPORT": "shm"})
    yield ctx
    ctx.stop()


def test_spark_mode_train_roundtrip_over_the_ring(sc, tmp_path):
    """Each node sums what it is fed over the shm ring; totals add up,
    and neither the executor nor the trainer holds a foreign module or
    (in the executor) a CUDA context."""
    out_dir = str(tmp_path / "sums")
    os.makedirs(out_dir)

    def map_fun(args, ctx):
        feed = ctx.get_data_feed(train_mode=True)
        total = count = 0
        while not feed.should_stop():
            batch = feed.next_batch(8)
            total += sum(batch)
            count += len(batch)
        foreign = sorted(m for m in sys.modules
                         if m.split(".")[0] in args["foreign"]
                         and sys.modules[m] is not None)
        with open(os.path.join(args["out_dir"],
                               "node-{}.json".format(ctx.executor_id)),
                  "w") as f:
            json.dump({"total": total, "count": count,
                       "job_name": ctx.job_name, "foreign": foreign,
                       "transport": ctx.mgr.get("feed_transport"),
                       "ring": feed._ring is not None}, f)

    def probe(it):
        import torch
        list(it)
        return [{"cuda": torch.cuda.is_initialized(),
                 "foreign": sorted(m for m in sys.modules
                                   if m.split(".")[0] in FOREIGN
                                   and sys.modules[m] is not None)}]

    tfc = cluster.run(sc, map_fun, {"out_dir": out_dir, "foreign": FOREIGN},
                      num_executors=2, input_mode=cluster.InputMode.SPARK)
    assert len(tfc.cluster_info) == 2
    tfc.train(sc.parallelize(range(100), 4), num_epochs=2)
    probes = sc.parallelize([0, 1], 2).mapPartitions(probe).collect()
    tfc.shutdown()
    stats = [json.load(open(os.path.join(out_dir, f)))
             for f in sorted(os.listdir(out_dir))]
    assert len(stats) == 2
    assert sum(s["total"] for s in stats) == sum(range(100)) * 2
    assert sum(s["count"] for s in stats) == 200
    assert sorted(s["job_name"] for s in stats) == ["chief", "worker"]
    assert all(s["transport"] == "shm" and s["ring"] for s in stats)
    assert all(s["foreign"] == [] for s in stats)
    assert probes == [{"cuda": False, "foreign": []}] * 2
    # the executors' feed counters reached the driver on the final beats
    merged = tfc.metrics()["cluster"]["merged"]["counters"]["tfos_feed"]
    assert merged["counts"]["records"] == 200


def test_spark_mode_inference_roundtrip_in_order(sc):
    def map_fun(args, ctx):
        feed = ctx.get_data_feed(train_mode=False)
        while not feed.should_stop():
            batch = feed.next_batch(8)
            if batch:
                feed.batch_results([x * 10 for x in batch])

    tfc = cluster.run(sc, map_fun, {}, num_executors=2,
                      input_mode=cluster.InputMode.SPARK)
    results = tfc.inference(sc.parallelize(range(20), 4)).collect()
    assert results == [x * 10 for x in range(20)]
    tfc.shutdown()


def test_inference_deep_partition_no_wedge_on_queues(tmp_path):
    """A partition deep enough to fill BOTH bounded queues streams
    through instead of deadlocking ``batch_results`` against the feeder's
    backpressure, in exact order."""

    def map_fun(args, ctx):
        feed = ctx.get_data_feed(train_mode=False)
        while not feed.should_stop():
            batch = feed.next_batch(8)
            if batch:
                feed.batch_results([x + 1 for x in batch])

    sc = Context(num_executors=2, work_root=str(tmp_path / "engine"),
                 executor_env={"TFOS_FEED_TRANSPORT": "queue"})
    try:
        tfc = cluster.run(sc, map_fun, {}, num_executors=2,
                          input_mode=cluster.InputMode.SPARK)
        n = 8000
        results = tfc.inference(sc.parallelize(range(n), 2),
                                feed_timeout=60).collect()
        assert results == [x + 1 for x in range(n)]
        views = tfc.server.lease_snapshot()
        tfc.shutdown()
    finally:
        sc.stop()
    assert {v["payload"]["feed_transport"] for v in views.values()} == \
        {"queue"}


def test_tensorflow_mode_inline(sc, tmp_path):
    out_dir = str(tmp_path / "marks")
    os.makedirs(out_dir)

    def map_fun(args, ctx):
        with open(os.path.join(args["out_dir"],
                               "node-{}".format(ctx.executor_id)), "w") as f:
            f.write("{}:{}".format(ctx.job_name, ctx.task_index))

    tfc = cluster.run(sc, map_fun, {"out_dir": out_dir}, num_executors=2,
                      input_mode=cluster.InputMode.TENSORFLOW)
    tfc.shutdown()
    assert sorted(os.listdir(out_dir)) == ["node-0", "node-1"]
    assert open(os.path.join(out_dir, "node-0")).read() == "chief:0"


def test_map_fun_error_surfaces_at_shutdown(sc):
    def map_fun(args, ctx):
        feed = ctx.get_data_feed(train_mode=True)
        feed.next_batch(1)
        raise ValueError("boom on node {}".format(ctx.executor_id))

    tfc = cluster.run(sc, map_fun, {}, num_executors=2,
                      input_mode=cluster.InputMode.SPARK)
    tfc.train(sc.parallelize(range(10), 2))
    with pytest.raises(RuntimeError) as err:
        tfc.shutdown(grace_secs=1)
    assert "boom" in str(err.value.__cause__ or err.value)


def test_later_planes_refuse_loudly(sc):
    later = "Fleet hosting and the policy planes"
    with pytest.raises(NotImplementedError, match=later):
        cluster.run(sc, lambda a, c: None, {}, 2, supervise=object())
    with pytest.raises(NotImplementedError, match=later):
        reservation.Server(1, journal="/nonexistent/journal")


def test_serializer_ships_closures_without_cloudpickle(tmp_path):
    """A ``__main__`` script (functions, a lambda, a closure over a
    list, a recursive function, a default argument) pickles with the
    port's serializer and loads in another process; neither side can
    import cloudpickle."""
    script = tmp_path / "main_side.py"
    script.write_text(textwrap.dedent("""
        import subprocess, sys
        sys.modules["cloudpickle"] = None
        sys.path.insert(0, {root!r})
        from tensorflowonspark_tpu_torch.engine import serializer

        SCALE = 3

        def helper(x):
            return x * SCALE

        def fact(n):
            return 1 if n <= 1 else n * fact(n - 1)

        def make(offset):
            seen = [offset]

            def inner(x, extra=2, *, kw=5):
                return helper(x) + seen[0] + extra + kw
            return inner

        payload = serializer.dumps({{
            "inner": make(10), "lam": lambda y: y + SCALE, "fact": fact,
            "ref": serializer.loads}})
        child = (
            "import sys; sys.modules['cloudpickle'] = None; "
            "sys.path.insert(0, {root!r}); "
            "from tensorflowonspark_tpu_torch.engine import serializer; "
            "f = serializer.loads(sys.stdin.buffer.read()); "
            "print(f['inner'](1), f['lam'](1), f['fact'](5), "
            "f['ref'] is serializer.loads, "
            "serializer.loads(serializer.dumps(f['inner']))(2))")
        out = subprocess.run([sys.executable, "-c", child], input=payload,
                             capture_output=True, check=True)
        print(out.stdout.decode().strip())
    """).format(root=ROOT))
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "20 4 120 True 23"


def test_initialize_torch_gloo_all_reduce(tmp_path):
    """With ``TFOS_TPU_DISTRIBUTED=1`` each trainer joins one gloo group
    at the chief's reserved port; an all-reduce sums the ranks."""
    out_dir = str(tmp_path / "ranks")
    os.makedirs(out_dir)

    def map_fun(args, ctx):
        import torch
        import torch.distributed as dist

        dev = ctx.initialize_torch("cpu")
        t = torch.tensor([float(ctx.executor_id + 1)])
        dist.all_reduce(t)
        with open(os.path.join(args["out"], "r%d" % ctx.executor_id),
                  "w") as f:
            json.dump({"sum": t.item(), "rank": dist.get_rank(),
                       "world": dist.get_world_size(), "device": str(dev),
                       "backend": dist.get_backend()}, f)
        dist.destroy_process_group()

    sc = Context(num_executors=2, work_root=str(tmp_path / "engine"),
                 executor_env={"TFOS_TPU_DISTRIBUTED": "1"})
    try:
        tfc = cluster.run(sc, map_fun, {"out": out_dir}, num_executors=2,
                          input_mode=cluster.InputMode.TENSORFLOW)
        tfc.shutdown()
    finally:
        sc.stop()
    got = [json.load(open(os.path.join(out_dir, "r%d" % i)))
           for i in range(2)]
    assert [g["rank"] for g in got] == [0, 1]
    assert all(g["sum"] == 3.0 and g["world"] == 2 and g["device"] == "cpu"
               and g["backend"] == "gloo" for g in got)


def test_rendezvous_that_cannot_form_raises_within_its_bound(tmp_path):
    """Rank 1 of a two-rank gloo group never joins: rank 0's
    ``initialize_torch`` raises after ``cluster.run(rendezvous_timeout=
    3)`` seconds (not torch's 30 minutes), in the trainer, and the error
    surfaces at ``shutdown``."""
    bound, margin = 3.0, 20.0
    out_dir = str(tmp_path / "ranks")
    os.makedirs(out_dir)

    def map_fun(args, ctx):
        import time as _time

        if ctx.executor_id == 1:
            return  # never joins the group
        t0 = _time.monotonic()
        try:
            ctx.initialize_torch("cpu")
        except Exception as e:  # noqa: BLE001 - recorded, then re-raised
            with open(os.path.join(args["out"], "r0"), "w") as f:
                json.dump({"s": _time.monotonic() - t0,
                           "error": type(e).__name__}, f)
            raise
        with open(os.path.join(args["out"], "r0"), "w") as f:
            json.dump({"s": _time.monotonic() - t0, "error": None}, f)

    sc = Context(num_executors=2, work_root=str(tmp_path / "engine"),
                 executor_env={"TFOS_TPU_DISTRIBUTED": "1"})
    try:
        tfc = cluster.run(sc, map_fun, {"out": out_dir}, num_executors=2,
                          input_mode=cluster.InputMode.TENSORFLOW,
                          rendezvous_timeout=bound)
        assert tfc.cluster_meta["rendezvous_timeout"] == bound
        with pytest.raises(RuntimeError, match="DistStoreError|[Tt]imed out"):
            tfc.shutdown()
    finally:
        sc.stop()
    got = json.load(open(os.path.join(out_dir, "r0")))
    assert got["error"] is not None
    assert bound - 0.5 <= got["s"] <= bound + margin, got


# -- the slice as a whole ------------------------------------------------------

CFG = {"vocab": 64, "hidden": 32, "num_heads": 2, "num_layers": 2,
       "max_len": 32}
LR, BATCH, STEPS = 1e-3, 2, 6


def test_slice_losses_match_the_reference_cluster(tmp_path):
    import jax
    import jax.numpy as jnp
    from flax import traverse_util
    from tensorflowonspark_tpu import cluster as jcluster
    from tensorflowonspark_tpu.engine import Context as JaxContext
    from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM

    params = JaxLM(**CFG).init(jax.random.PRNGKey(3),
                               jnp.zeros((1, CFG["max_len"]), jnp.int32))
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray,
                                                   params["params"]))
    weights = str(tmp_path / "weights.npz")
    np.savez(weights, **{"/".join(k): v for k, v in flat.items()})
    rows = np.random.RandomState(5).randint(
        0, CFG["vocab"], (BATCH * STEPS, CFG["max_len"] + 1))
    records = [{"tokens": r} for r in rows]

    def jax_fun(args, ctx):
        import numpy as np
        import jax
        import jax.numpy as jnp
        import optax
        from flax import traverse_util
        from jax.sharding import Mesh
        from tensorflowonspark_tpu import training
        from tensorflowonspark_tpu.models.decoder import DecoderLM

        flat = dict(np.load(args["params"]))
        params = traverse_util.unflatten_dict(
            {tuple(k.split("/")): v for k, v in flat.items()})
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        tr = training.Trainer(DecoderLM(**args["cfg"]), optax.adamw(args["lr"]),
                              mesh, loss_fn=training.softmax_xent)
        params = jax.tree.map(jnp.asarray, params)
        state = jax.device_put(
            {"params": params, "extra": {}, "opt_state": tr.optimizer.init(params),
             "step": jnp.zeros((), jnp.int32)}, tr.replicated)
        feed = ctx.get_data_feed(train_mode=True,
                                 input_mapping={"tokens": "tokens"})

        def batches():
            for b in feed.numpy_batches(args["batch"]):
                t = b["tokens"]
                yield {"x": t[:, :-1].astype(np.int32),
                       "y": t[:, 1:].astype(np.int32)}

        losses = []
        tr.train_loop(state, batches(), log_every=0,
                      hooks=[lambda i, s, m: losses.append(float(m["loss"]))])
        with open(args["out"], "w") as f:
            json.dump({"losses": losses, "records": feed.stats()["records"]}, f)

    def port_fun(args, ctx):
        import numpy as np
        import torch
        from tensorflowonspark_tpu_torch import convert, infeed, training
        from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

        dev = ctx.initialize_torch("cpu")
        tree = {}
        for key, value in np.load(args["params"]).items():
            node = tree
            *path, leaf = key.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = value
        model = DecoderLM(**args["cfg"])
        model.load_state_dict(convert.from_flax(tree))
        tr = training.Trainer(model, training.adamw(args["lr"]), device=dev)
        feed = ctx.get_data_feed(train_mode=True,
                                 input_mapping={"tokens": "tokens"})

        def batches():
            for b in feed.numpy_batches(args["batch"]):
                t = b["tokens"]
                yield {"x": t[:, :-1], "y": t[:, 1:]}

        losses = []
        tr.train_loop(tr.init(), infeed.device_batches(batches(), device=dev),
                      log_every=0,
                      hooks=[lambda i, s, m: losses.append(float(m["loss"]))])
        with open(args["out"], "w") as f:
            json.dump({"losses": losses, "records": feed.stats()["records"],
                       "torch": torch.__version__}, f)

    runs = {}
    for name, Ctx, clu, fun in (("jax", JaxContext, jcluster, jax_fun),
                                ("port", Context, cluster, port_fun)):
        out = str(tmp_path / (name + ".json"))
        sc = Ctx(num_executors=1, work_root=str(tmp_path / ("eng-" + name)),
                 executor_env={"TFOS_FEED_TRANSPORT": "shm"})
        try:
            tfc = clu.run(sc, fun, {"params": weights, "cfg": CFG, "lr": LR,
                                    "batch": BATCH, "out": out},
                          num_executors=1,
                          input_mode=clu.InputMode.SPARK)
            tfc.train(sc.parallelize(records, 3), num_epochs=1)
            tfc.shutdown()
        finally:
            sc.stop()
        runs[name] = json.load(open(out))
    want, got = runs["jax"]["losses"], runs["port"]["losses"]
    assert len(want) == len(got) == STEPS
    assert runs["jax"]["records"] == runs["port"]["records"] == len(records)
    for w, g in zip(want, got):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (got, want)
