"""The port's ``engine/spark_adapter`` against the in-tree fake pyspark.

Mirrors the reference's ``tests/test_spark_adapter.py`` case by case:
no pyspark ships in this image, so the contract is proven against
``tests/fakes/pyspark.py`` (same lazy-RDD semantics, put on
``sys.path`` as the reference test does), including a single-executor
``cluster.run`` train / shutdown of the port over the adapter — the
spark-submit code path minus the JVM.
"""

import os
import sys
import time

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fakes"))

import pyspark  # noqa: E402  (the fake above)

from tensorflowonspark_tpu_torch import cluster, node, util  # noqa: E402
from tensorflowonspark_tpu_torch.engine import spark_adapter  # noqa: E402


@pytest.fixture()
def fake_sc():
    sc = pyspark.SparkContext(master="local[2]", appName="adapter-test")
    yield sc
    sc.stop()


def test_parallelize_union_mappartitions(fake_sc):
    eng = spark_adapter.SparkEngineAdapter(fake_sc, num_executors=2)
    rdd = eng.parallelize(range(10), 3)
    assert rdd.getNumPartitions() == 3
    assert sorted(rdd.collect()) == list(range(10))
    doubled = rdd.mapPartitions(lambda it: (x * 2 for x in it))
    assert sorted(doubled.collect()) == [x * 2 for x in range(10)]
    # epochs-style union (cluster.train does sc.union([rdd] * epochs))
    u = eng.union([rdd, rdd])
    assert u.count() == 20
    assert eng.defaultParallelism == fake_sc.defaultParallelism
    # real pyspark materializes EMPTY partitions when slices > records;
    # the contract (and user fns) must tolerate them
    sparse = eng.parallelize(range(2), 5)
    assert sparse.getNumPartitions() == 5
    assert sorted(sparse.collect()) == [0, 1]
    seen = []
    sparse.foreachPartition(lambda it: seen.append(len(list(it))))
    assert sorted(seen) == [0, 0, 0, 1, 1]


def test_num_executors_default(fake_sc):
    assert spark_adapter.from_spark(fake_sc).num_executors == \
        fake_sc.defaultParallelism
    assert spark_adapter.from_spark(fake_sc, 7).num_executors == 7


def test_foreach_partition_async_contract(fake_sc, tmp_path):
    eng = spark_adapter.SparkEngineAdapter(fake_sc, num_executors=2)
    out = str(tmp_path / "marks")
    os.makedirs(out)

    def write_mark(it):
        ids = list(it)
        with open(os.path.join(out, "part-%d" % ids[0]), "w") as f:
            f.write(str(ids))

    res = eng.parallelize(range(2), 2).foreachPartitionAsync(
        write_mark, one_task_per_executor=True)
    assert res.get(timeout=30) is None
    assert sorted(os.listdir(out)) == ["part-0", "part-1"]
    assert res.ready() and res.done() and res.successful()
    assert res.first_error() is None


def test_async_error_and_timeout(fake_sc):
    eng = spark_adapter.SparkEngineAdapter(fake_sc, num_executors=2)

    def boom(it):
        list(it)
        raise ValueError("partition exploded")

    res = eng.parallelize(range(2), 2).foreachPartitionAsync(boom)
    with pytest.raises(ValueError, match="partition exploded"):
        res.get(timeout=30)
    assert res.first_error()[0] == 0 and not res.successful()

    def slow(it):
        list(it)
        time.sleep(5)

    res = eng.parallelize(range(1), 1).foreachPartitionAsync(slow)
    with pytest.raises(TimeoutError):
        res.get(timeout=0.2)
    res.get(timeout=30)  # and it still completes


def test_cluster_run_over_spark_adapter(fake_sc, tmp_path, monkeypatch):
    """The spark-submit path end to end on the port: cluster.run + queue
    feed + train + shutdown over the adapter, one executor (the fake runs
    partition tasks in the driver process, so one bootstrap is the
    honest limit — real Spark gives each node its own executor
    process)."""
    monkeypatch.chdir(tmp_path)
    util.write_executor_id(0)
    node._NODE_STATE.clear()
    out = str(tmp_path / "sums")
    os.makedirs(out)

    def map_fun(args, ctx):
        feed = ctx.get_data_feed(train_mode=True)
        total = 0
        while not feed.should_stop():
            total += sum(feed.next_batch(8))
        with open(os.path.join(args["out"], "total"), "w") as f:
            f.write(str(total))

    eng = spark_adapter.SparkEngineAdapter(fake_sc, num_executors=1)
    try:
        tfc = cluster.run(eng, map_fun, {"out": out}, num_executors=1,
                          input_mode=cluster.InputMode.SPARK)
        tfc.train(eng.parallelize(range(100), 2), num_epochs=2)
        tfc.shutdown()
        assert int(open(os.path.join(out, "total")).read()) == \
            sum(range(100)) * 2
    finally:
        proc = node._NODE_STATE.get("trainer_proc")
        if proc is not None and proc.is_alive():
            proc.terminate()
            proc.join(5)
        ring = node._NODE_STATE.get("shm_ring")
        if ring is not None:
            ring.unlink()
            ring.close()
        node._NODE_STATE.clear()


def test_foreach_partition_async_fail_fast_false_runs_all(fake_sc, tmp_path):
    """fail_fast=False (cleanup jobs): one raising partition must not stop
    the others — on real Spark a raising task would cancel the stage, so
    the adapter catches per partition and re-raises the collected errors
    after every partition ran (EndFeed must reach every executor)."""
    eng = spark_adapter.SparkEngineAdapter(fake_sc, num_executors=3)
    marker_dir = tmp_path / "ran"
    marker_dir.mkdir()

    def work(it, _dir=str(marker_dir)):
        items = list(it)
        open(os.path.join(_dir, "p-%d" % items[0]), "w").close()
        if items[0] == 1:
            raise ValueError("partition 1 exploded")

    res = eng.parallelize([0, 1, 2], 3).foreachPartitionAsync(
        work, fail_fast=False)
    with pytest.raises(RuntimeError) as ei:
        res.get(timeout=60)
    assert "partition 1 exploded" in str(ei.value)
    assert sorted(os.listdir(str(marker_dir))) == ["p-0", "p-1", "p-2"]
