"""The port's Spark Streaming analog (``engine/streaming.py``) on its
own and through the port's cluster, on the CPU.

Mirrors the reference's cases: ``tests/test_streaming_cluster.py``
(micro-batches consumed across intervals, a mid-stream shutdown that
drains what is queued, a trainer error surfacing at ``shutdown(ssc)``)
and the streaming cases of ``tests/test_parity_modules.py``
(``queueStream``, ``textFileStream`` with hidden files invisible until
renamed, a queue-fed cluster). Then the slice as a whole: the same
seeded micro-batches stream through the JAX package's cluster into its
``Trainer`` and through the port's into its own, from the same tiny
``DecoderLM`` weights, and the per-step losses agree within 1e-4
relative (the bound of ``tests/test_torch_cluster.py``).

``map_fun``s are defined inside functions: the engine ships them by
value, and the executors cannot import this test module.
"""

import json
import os
import queue
import time

import numpy as np
import pytest

from tensorflowonspark_tpu_torch import cluster
from tensorflowonspark_tpu_torch.engine import Context, StreamingContext

#: per-step losses of the two trainers (tests/test_torch_cluster.py)
LOSS_RTOL = 1e-4


@pytest.fixture()
def sc(tmp_path):
    ctx = Context(num_executors=2, work_root=str(tmp_path / "engine"))
    yield ctx
    ctx.stop()


def _make_summing_map_fun():
    def map_fun(args, ctx):
        import json as _json
        import os as _os
        feed = ctx.get_data_feed(train_mode=True)
        total = 0
        count = 0
        while not feed.should_stop():
            batch = feed.next_batch(8)
            total += sum(batch)
            count += len(batch)
        path = _os.path.join(args["out_dir"],
                             "node-%d.json" % ctx.executor_id)
        with open(path, "w") as f:
            _json.dump({"total": total, "count": count}, f)
    return map_fun


def _totals(out_dir):
    stats = [json.load(open(os.path.join(out_dir, f)))
             for f in sorted(os.listdir(out_dir))]
    return (sum(s["total"] for s in stats), sum(s["count"] for s in stats))


def test_streaming_train_consumes_micro_batches(sc, tmp_path):
    """Trainers consume records pushed across several stream intervals."""
    out_dir = str(tmp_path / "sums")
    os.makedirs(out_dir)
    tfc = cluster.run(sc, _make_summing_map_fun(), {"out_dir": out_dir},
                      num_executors=2, input_mode=cluster.InputMode.SPARK)
    ssc = StreamingContext(sc, batch_interval=0.1)
    rdd_queue = queue.Queue()
    stream = ssc.queueStream(rdd_queue)
    tfc.train(stream)  # registers the per-micro-batch feed
    ssc.start()
    pushed = []
    for i in range(3):
        lo, hi = i * 20, (i + 1) * 20
        rdd_queue.put(sc.parallelize(range(lo, hi), 2))
        pushed.extend(range(lo, hi))
        time.sleep(0.15)
    tfc.shutdown(ssc)
    total, count = _totals(out_dir)
    assert count == len(pushed)
    assert total == sum(pushed)


def test_streaming_shutdown_mid_stream_drains_pending(sc, tmp_path):
    """shutdown(ssc) mid-stream: queued micro-batches the loop never got
    to poll are drained, not dropped, and the cluster closes cleanly."""
    out_dir = str(tmp_path / "sums")
    os.makedirs(out_dir)
    tfc = cluster.run(sc, _make_summing_map_fun(), {"out_dir": out_dir},
                      num_executors=2, input_mode=cluster.InputMode.SPARK)
    ssc = StreamingContext(sc, batch_interval=60.0)
    rdd_queue = queue.Queue()
    stream = ssc.queueStream(rdd_queue)
    tfc.train(stream)
    rdd_queue.put(sc.parallelize(range(10), 2))
    ssc.start()
    time.sleep(0.3)  # first poll happens; the loop now sleeps out 60 s
    rdd_queue.put(sc.parallelize(range(10, 30), 2))
    rdd_queue.put(sc.parallelize(range(30, 40), 2))
    tfc.shutdown(ssc)
    total, count = _totals(out_dir)
    assert count == 40
    assert total == sum(range(40))


def test_streaming_micro_batch_error_surfaces_at_shutdown(sc):
    """A trainer blowing up mid-stream surfaces on the driver at
    shutdown(ssc) instead of hanging the stream loop."""

    def map_fun(args, ctx):
        feed = ctx.get_data_feed(train_mode=True)
        feed.next_batch(1)
        raise ValueError("stream boom")

    tfc = cluster.run(sc, map_fun, {}, num_executors=2,
                      input_mode=cluster.InputMode.SPARK)
    ssc = StreamingContext(sc, batch_interval=0.1)
    stream = ssc.queueStream([sc.parallelize(range(10), 2)])
    tfc.train(stream)
    ssc.start()
    time.sleep(0.3)
    with pytest.raises(RuntimeError) as err:
        tfc.shutdown(ssc, grace_secs=1)
    assert "boom" in str(err.value.__cause__ or err.value)


def test_streaming_queue_stream(sc):
    seen = []
    ssc = StreamingContext(sc, batch_interval=0.05)
    q = queue.Queue()
    stream = ssc.queueStream(q)
    stream.foreachRDD(lambda rdd: seen.append(sorted(rdd.collect())))
    ssc.start()
    q.put(sc.parallelize([1, 2, 3], 2))
    q.put(sc.parallelize([4, 5], 1))
    deadline = time.monotonic() + 10
    while len(seen) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    ssc.stop()
    assert seen[:2] == [[1, 2, 3], [4, 5]]


def test_streaming_text_file_stream(sc, tmp_path):
    d = tmp_path / "incoming"
    d.mkdir()
    seen = []
    ssc = StreamingContext(sc, batch_interval=0.05)
    ssc.textFileStream(str(d), num_slices=1).foreachRDD(
        lambda rdd: seen.extend(rdd.collect()))
    ssc.start()
    # hidden files are invisible (Spark semantics): a writer's dotfile
    # tmp must never be read, even once renamed content appears later
    (d / ".b.txt.tmp").write_text("half-writ")
    (d / "a.txt").write_text("one\ntwo\n")
    deadline = time.monotonic() + 10
    while len(seen) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    os.rename(str(d / ".b.txt.tmp"), str(d / "b.txt"))
    deadline = time.monotonic() + 10
    while len(seen) < 3 and time.monotonic() < deadline:
        time.sleep(0.05)
    ssc.stop()
    assert seen == ["one", "two", "half-writ"]


def test_streaming_loop_error_re_raises_at_stop(sc):
    """An action that raises ends the loop; ``stop`` re-raises it (and
    drains nothing after it)."""
    ssc = StreamingContext(sc, batch_interval=0.05)

    def boom(rdd):
        raise ValueError("action boom")

    ssc.queueStream([sc.parallelize([1], 1)]).foreachRDD(boom)
    ssc.start()
    ssc.awaitTermination(10)
    with pytest.raises(RuntimeError, match="streaming loop failed") as err:
        ssc.stop()
    assert "action boom" in str(err.value.__cause__)


def test_streaming_cluster_train(sc):
    """The reference DStream path: continuous queue-fed training."""

    def map_fun(args, ctx):
        feed = ctx.get_data_feed(train_mode=True)
        total = 0
        while not feed.should_stop():
            total += sum(feed.next_batch(16))
        with open(os.path.join(args["dir"], "sum-%d" % ctx.executor_id),
                  "w") as f:
            f.write(json.dumps(total))

    workdir = sc.work_root
    tfc = cluster.run(sc, map_fun, {"dir": workdir}, num_executors=2,
                      input_mode=cluster.InputMode.SPARK)
    ssc = StreamingContext(sc, batch_interval=0.05)
    q = queue.Queue()
    tfc.train(ssc.queueStream(q))
    ssc.start()
    q.put(sc.parallelize(range(10), 2))
    q.put(sc.parallelize(range(10, 20), 2))
    time.sleep(1.0)
    tfc.shutdown(ssc)
    sums = [json.loads(open(os.path.join(workdir, name)).read())
            for name in os.listdir(workdir) if name.startswith("sum-")]
    assert sum(sums) == sum(range(20))


# -- the slice as a whole: streaming-fed training, JAX vs port ---------------

CFG = {"vocab": 64, "hidden": 32, "num_heads": 2, "num_layers": 2,
       "max_len": 32}
LR, BATCH = 1e-3, 2
#: records per micro-batch (each slice a whole number of batches)
MICRO_BATCHES = (4, 4, 4)


def _trainers():
    """(jax_fun, port_fun): the two packages' streaming-fed trainers."""

    def jax_fun(args, ctx):
        import json
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
        tr = training.Trainer(DecoderLM(**args["cfg"]),
                              optax.adamw(args["lr"]), mesh,
                              loss_fn=training.softmax_xent)
        params = jax.tree.map(jnp.asarray, params)
        state = jax.device_put(
            {"params": params, "extra": {},
             "opt_state": tr.optimizer.init(params),
             "step": jnp.zeros((), jnp.int32)}, tr.replicated)
        feed = ctx.get_data_feed(train_mode=True)

        def batches():
            for rows in feed.numpy_batches(args["batch"]):
                t = np.stack([np.array(r.split(","), np.int32)
                              for r in rows])
                yield {"x": t[:, :-1], "y": t[:, 1:]}

        losses = []
        tr.train_loop(state, batches(), log_every=0,
                      hooks=[lambda i, s, m: losses.append(float(m["loss"]))])
        with open(args["out"], "w") as f:
            json.dump({"losses": losses,
                       "records": feed.stats()["records"]}, f)

    def port_fun(args, ctx):
        import json
        import numpy as np
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
        feed = ctx.get_data_feed(train_mode=True)

        def batches():
            for rows in feed.numpy_batches(args["batch"]):
                t = np.stack([np.array(r.split(","), np.int64)
                              for r in rows])
                yield {"x": t[:, :-1], "y": t[:, 1:]}

        losses = []
        tr.train_loop(tr.init(), infeed.device_batches(batches(), device=dev),
                      log_every=0,
                      hooks=[lambda i, s, m: losses.append(float(m["loss"]))])
        with open(args["out"], "w") as f:
            json.dump({"losses": losses,
                       "records": feed.stats()["records"]}, f)

    return jax_fun, port_fun


def test_streaming_fed_losses_match_the_reference_cluster(tmp_path):
    """The same seeded micro-batches (text lines of token ids, as a
    ``textFileStream`` delivers them) stream through each package's
    ``StreamingContext.queueStream`` → ``tfc.train(dstream)`` →
    ``shutdown(ssc)`` into a one-executor cluster whose trainer starts
    from the same flax weights: the same steps and losses."""
    import jax
    import jax.numpy as jnp
    from flax import traverse_util
    from tensorflowonspark_tpu import cluster as jcluster
    from tensorflowonspark_tpu.engine import Context as JaxContext
    from tensorflowonspark_tpu.engine.streaming import (
        StreamingContext as JaxStreamingContext)
    from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM

    params = JaxLM(**CFG).init(jax.random.PRNGKey(4),
                               jnp.zeros((1, CFG["max_len"]), jnp.int32))
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray,
                                                   params["params"]))
    weights = str(tmp_path / "weights.npz")
    np.savez(weights, **{"/".join(k): v for k, v in flat.items()})
    rows = np.random.RandomState(6).randint(
        0, CFG["vocab"], (sum(MICRO_BATCHES), CFG["max_len"] + 1))
    lines = [",".join(str(int(t)) for t in r) for r in rows]
    jax_fun, port_fun = _trainers()
    runs = {}
    for name, Ctx, SSC, clu, fun in (
            ("jax", JaxContext, JaxStreamingContext, jcluster, jax_fun),
            ("port", Context, StreamingContext, cluster, port_fun)):
        out = str(tmp_path / (name + ".json"))
        sc = Ctx(num_executors=1, work_root=str(tmp_path / ("eng-" + name)),
                 executor_env={"TFOS_FEED_TRANSPORT": "shm"})
        try:
            tfc = clu.run(sc, fun, {"params": weights, "cfg": CFG, "lr": LR,
                                    "batch": BATCH, "out": out},
                          num_executors=1, input_mode=clu.InputMode.SPARK)
            ssc = SSC(sc, batch_interval=0.05)
            q = queue.Queue()
            tfc.train(ssc.queueStream(q))
            ssc.start()
            start = 0
            for n in MICRO_BATCHES:
                q.put(sc.parallelize(lines[start:start + n], 2))
                start += n
            tfc.shutdown(ssc)
        finally:
            sc.stop()
        runs[name] = json.load(open(out))
    want, got = runs["jax"]["losses"], runs["port"]["losses"]
    assert len(want) == len(got) == len(rows) // BATCH
    assert runs["jax"]["records"] == runs["port"]["records"] == len(rows)
    for w, g in zip(want, got):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (got, want)
