"""Optional pyspark adapter: run the cluster API on a real Spark engine —
the port's copy of ``tensorflowonspark_tpu/engine/spark_adapter.py``.

SURVEY.md §7.3 ("No pyspark in env") keeps the first-party engine
(engine/context.py) as the default execution substrate but owes a thin
shim "so spark-submit parity can be demonstrated". This is that shim:
it wraps a live ``pyspark.SparkContext`` in the exact contract
``cluster.run`` / ``TFCluster`` consume from the first-party engine —

    sc.parallelize(data, num_slices)  -> RDD
    sc.union([rdds])                  -> RDD
    sc.defaultParallelism
    rdd.mapPartitions(f) / .foreachPartition(f)
    rdd.foreachPartitionAsync(f, one_task_per_executor=) -> result.get()
    rdd.union / .getNumPartitions / .collect / .count

so a reference program's ``spark-submit`` launch path works by passing
``SparkEngineAdapter(spark_context)`` wherever the engine ``Context``
would go (reference: ``TFCluster.run(sc, ...)`` took the real
SparkContext directly).

Placement notes, same constraints the reference documented for
TFoS-on-Spark:

- Run with one task slot per executor (``spark.executor.cores`` ==
  ``spark.task.cpus``) so the ``num_executors`` bootstrap tasks land on
  distinct executors. PySpark has no placement API; the reference
  relied on exactly this configuration, and so does the shim
  (``one_task_per_executor`` is accepted and honored *by partition
  count*, the same mechanism ``TFSparkNode.run`` used).
- Pass ``manager_mode="remote"`` to ``cluster.run`` so each node's
  queue broker binds its routable IP instead of loopback — Spark may
  schedule feed tasks on any executor.
- pyspark's RDD API has no async job submission, so
  ``foreachPartitionAsync`` runs the blocking ``foreachPartition`` on a
  driver-side thread (exactly how the reference's TFCluster kept the
  bootstrap job running behind the barrier).

This module imports pyspark lazily: the framework never requires it.
Nothing here touches torch or CUDA: the Spark executors run the same
bootstrap closures as the engine's, and only a node's forked trainer
takes the card.
"""

import logging
import threading

logger = logging.getLogger(__name__)


class SparkAsyncResult(object):
    """`AsyncResult.get(timeout)`-shaped handle over a driver thread."""

    def __init__(self, fn):
        self._error = None
        self._done = threading.Event()

        def runner():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - re-raised in get()
                self._error = e
            finally:
                self._done.set()

        self._thread = threading.Thread(  # tfos: unjoined(get() waits on the done Event instead; the daemon thread ends with fn())
            target=runner, name="spark-adapter-job", daemon=True)
        self._thread.start()

    def get(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                "spark job still running after {}s".format(timeout))
        if self._error is not None:
            raise self._error
        return None

    def ready(self):
        return self._done.is_set()

    def done(self):
        return self._done.is_set()

    def successful(self):
        return self._done.is_set() and self._error is None

    def first_error(self):
        """(task_id, error) like the engine's AsyncResult; pyspark gives
        no per-task attribution, so the job's error maps to task 0."""
        return (0, self._error) if self._error is not None else None


class SparkRDDAdapter(object):
    """First-party-RDD surface over a pyspark RDD."""

    def __init__(self, engine, rdd):
        self.ctx = engine
        self._rdd = rdd

    # -- the contract cluster.py / examples consume ----------------------

    def mapPartitions(self, f):
        return SparkRDDAdapter(self.ctx, self._rdd.mapPartitions(f))

    def map(self, f):
        return SparkRDDAdapter(self.ctx, self._rdd.map(f))

    def union(self, other):
        other_rdd = other._rdd if isinstance(other, SparkRDDAdapter) else other
        return SparkRDDAdapter(self.ctx, self._rdd.union(other_rdd))

    def getNumPartitions(self):
        return self._rdd.getNumPartitions()

    def collect(self):
        return self._rdd.collect()

    def count(self):
        return self._rdd.count()

    def take(self, n):
        return self._rdd.take(n)

    def foreachPartition(self, f):
        self.foreachPartitionAsync(f).get()

    def foreachPartitionAsync(self, f, one_task_per_executor=False,
                              fail_fast=True):
        """Async partition job; see module docstring for the placement
        contract behind ``one_task_per_executor``."""
        del one_task_per_executor  # honored by partition count + spark conf

        if fail_fast:
            # Spark's native semantics already abort the job on a failed
            # task (after task retries), which is exactly fail-fast.
            def run_and_discard(it, _f=f):
                _f(it)
                return iter(())

            rdd = self._rdd.mapPartitions(run_and_discard)
            # pyspark evaluates lazily: count() is the canonical cheap
            # action that forces every partition exactly once
            return SparkAsyncResult(rdd.count)

        # fail_fast=False (cleanup jobs: EndFeed must reach EVERY
        # executor): a raising task would make Spark cancel the stage's
        # remaining tasks, so no task may ever raise — each partition
        # catches its own error and returns it as data; the collected
        # errors re-raise on the driver after all partitions ran.
        #
        # Deliberate no-retry tradeoff: returning the error as data also
        # OPTS OUT of Spark's native task retry, so a transiently
        # failing cleanup partition runs exactly once — less delivery
        # assurance than Spark's default for transient faults. In-task
        # retries cannot fix this safely: the partition iterator cannot
        # be rewound (a replay would feed a truncated partition), a
        # "consumed nothing yet" guard races fns that hand the iterator
        # to a background thread (node._inference's feeder — a zombie
        # feeder from attempt 1 can steal records from attempt 2 or
        # trip 'generator already executing'), and the framework's own
        # fail_fast=False task (node.shutdown) drains its iterator as
        # its first statement so it could never qualify anyway. Callers
        # needing stronger cleanup delivery should make the cleanup
        # idempotent and resubmit the job.
        def run_catching(it, _f=f):
            try:
                _f(it)
                return iter(())
            except Exception:  # noqa: BLE001 - re-raised collected below
                import traceback
                return iter([traceback.format_exc()])

        rdd = self._rdd.mapPartitions(run_catching)

        def collect_then_raise(_rdd=rdd):
            errors = _rdd.collect()
            if errors:
                raise RuntimeError(
                    "{} partition task(s) failed; first:\n{}".format(
                        len(errors), errors[0]))

        return SparkAsyncResult(collect_then_raise)


class SparkEngineAdapter(object):
    """Engine-``Context``-shaped adapter over a ``pyspark.SparkContext``.

    ``num_executors`` is what ``cluster.run(sc, ..., num_executors=N)``
    should be called with; when not given it falls back to
    ``sc.defaultParallelism`` (the reference's own convention for local
    runs).
    """

    def __init__(self, spark_context, num_executors=None):
        self._sc = spark_context
        self.num_executors = int(num_executors or
                                 spark_context.defaultParallelism)

    @property
    def defaultParallelism(self):
        return self._sc.defaultParallelism

    def parallelize(self, data, num_slices=None):
        return SparkRDDAdapter(
            self, self._sc.parallelize(list(data),
                                       num_slices or self.num_executors))

    def union(self, rdds):
        # flat SparkContext.union, not pairwise chaining: K-deep nested
        # UnionRDD lineage (sc.union([rdd] * epochs) in cluster.train)
        # risks StackOverflowError serializing the DAG on real Spark
        if all(isinstance(r, SparkRDDAdapter) for r in rdds):
            return SparkRDDAdapter(
                self, self._sc.union([r._rdd for r in rdds]))
        out = rdds[0]
        for r in rdds[1:]:
            out = out.union(r)
        return out

    def stop(self):
        """No-op: the SparkContext's lifecycle belongs to the caller
        (spark-submit / SparkSession), not to the framework."""

    def __repr__(self):
        return "SparkEngineAdapter({!r}, num_executors={})".format(
            self._sc, self.num_executors)


def from_spark(spark_context=None, num_executors=None):
    """Build an adapter; with no argument, attach to the active context.

    The zero-argument form is the spark-submit path::

        from tensorflowonspark_tpu_torch.engine import spark_adapter
        sc = spark_adapter.from_spark()        # active SparkContext
        cluster.run(sc, map_fun, args, sc.num_executors,
                    manager_mode="remote", ...)
    """
    if spark_context is None:
        import pyspark
        spark_context = pyspark.SparkContext.getOrCreate()
    return SparkEngineAdapter(spark_context, num_executors)
