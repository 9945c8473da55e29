"""RDD: lazy partitioned collection with Spark-shaped operations.

Only the surface the reference framework actually exercises is implemented
(SURVEY.md §3 call stacks): ``parallelize`` data lives driver-side and
ships with tasks (exactly Spark's ``sc.parallelize`` semantics); transforms
compose lazily per partition; actions run jobs through the driver context.

``union`` matters more than it looks: the reference implements training
epochs as ``sc.union([dataRDD] * num_epochs)`` (SURVEY.md §3.2), so unioned
partitions must preserve order and re-run their transform chains
independently.
"""

import itertools


class _Partition(object):
    """One partition: a driver-side payload + a composed transform chain."""

    __slots__ = ("payload", "transform")

    def __init__(self, payload, transform=None):
        self.payload = payload
        self.transform = transform

    def compute(self):
        it = iter(self.payload)
        return self.transform(it) if self.transform is not None else it

    def with_transform(self, f):
        prev = self.transform

        def chained(it, _prev=prev, _f=f):
            return _f(_prev(it)) if _prev is not None else _f(it)

        return _Partition(self.payload, chained)


class RDD(object):
    def __init__(self, ctx, partitions):
        self.ctx = ctx
        self._partitions = list(partitions)

    # -- transformations (lazy) ------------------------------------------

    def mapPartitions(self, f):
        """f(iterator) -> iterator, applied per partition on the executor."""
        return RDD(self.ctx, [p.with_transform(f) for p in self._partitions])

    def mapPartitionsWithIndex(self, f):
        """f(index, iterator) -> iterator; index is the partition ordinal."""
        parts = []
        for i, p in enumerate(self._partitions):
            def indexed(it, _i=i, _f=f):
                return _f(_i, it)
            parts.append(p.with_transform(indexed))
        return RDD(self.ctx, parts)

    def map(self, f):
        return self.mapPartitions(lambda it, _f=f: (_f(x) for x in it))

    def flatMap(self, f):
        return self.mapPartitions(
            lambda it, _f=f: itertools.chain.from_iterable(_f(x) for x in it))

    def filter(self, f):
        return self.mapPartitions(lambda it, _f=f: (x for x in it if _f(x)))

    def union(self, other):
        return RDD(self.ctx, self._partitions + other._partitions)

    def coalesce(self, num_partitions):
        """Concatenate payloads into fewer partitions (driver-side data only;
        transforms must not have been applied yet — matches how the
        framework uses it, straight off ``parallelize``)."""
        if any(p.transform is not None for p in self._partitions):
            raise ValueError("coalesce() only supported before transformations")
        payload = [x for p in self._partitions for x in p.payload]
        return self.ctx.parallelize(payload, num_partitions)

    repartition = coalesce

    # -- actions ---------------------------------------------------------

    def getNumPartitions(self):
        return len(self._partitions)

    def collect(self):
        results = self.ctx.run_job(self, _collect_partition).get()
        return [x for part in results for x in part]

    def count(self):
        return sum(self.ctx.run_job(self, _count_partition).get())

    def take(self, n):
        """First n records, computing as few partitions as possible.

        Spark-shaped scan: try 1 partition, then geometrically larger
        batches (x4) until n records are gathered — a take(1) on a
        many-partition RDD costs one task, not a full job.
        """
        out = []
        i = 0
        width = 1
        while i < len(self._partitions) and len(out) < n:
            batch = self._partitions[i:i + width]
            # In-task limit: tasks return at most the records still
            # needed, never the whole partition (Spark's runJob shape).
            need = n - len(out)
            results = self.ctx.run_job(
                RDD(self.ctx, batch),
                lambda it, _k=need: list(itertools.islice(it, _k))).get()
            for part in results:
                out.extend(part)
                if len(out) >= n:
                    break
            i += len(batch)
            width *= 4
        return out[:n]

    def first(self):
        got = self.take(1)
        if not got:
            raise ValueError("RDD is empty")
        return got[0]

    def foreachPartition(self, f, exclude=()):
        """Run f over every partition; blocks; re-raises executor errors."""
        self.foreachPartitionAsync(f, exclude=exclude).get()

    def foreachPartitionAsync(self, f, one_task_per_executor=False,
                              fail_fast=True, exclude=()):
        """Async partition job -> :class:`AsyncResult` (reference:
        ``nodeRDD.foreachPartitionAsync(TFSparkNode.run(...))``).

        ``one_task_per_executor`` pins task i to executor i — the cluster
        bootstrap job needs exactly one node task resident per executor
        (SURVEY.md §3.1), a placement Spark gets from its scheduler and we
        make explicit. ``fail_fast=False`` opts out of
        abort-on-first-failure (cleanup jobs that must reach every
        executor). ``exclude`` bars the named executor ids from this job
        (the supervision plane's blacklist; see Context.run_job).
        """
        def run_and_discard(it, _f=f):
            _f(it)
            return None

        return self.ctx.run_job(self, run_and_discard,
                                one_task_per_executor=one_task_per_executor,
                                fail_fast=fail_fast, exclude=exclude)

    def saveAsTextFile(self, path):
        """Write one ``part-NNNNN`` file per partition under ``path``."""
        import os
        os.makedirs(path, exist_ok=False)
        results = self.ctx.run_job(self, _collect_partition).get()
        for i, part in enumerate(results):
            with open(os.path.join(path, "part-%05d" % i), "w") as fh:
                for x in part:
                    fh.write(str(x))
                    fh.write("\n")


def _collect_partition(it):
    return list(it)


def _count_partition(it):
    return sum(1 for _ in it)
