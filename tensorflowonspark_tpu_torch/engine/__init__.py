"""Spark-shaped execution engine (the substrate the reference borrowed from
Spark) — the port's copy of ``tensorflowonspark_tpu/engine/``, local
mode.

SURVEY.md §7 "Environment reality check": pyspark is not in the image, so
the framework supplies its own driver/executor engine with a Spark-
compatible *shape* — an RDD with partitions, closure-shipping tasks,
async partition jobs, and driver-visible task errors — sized to what the
cluster layer (cluster.py / node.py) actually needs. If real pyspark
appears later, a thin adapter can swap in underneath cluster.py, whose
surface deliberately mirrors ``TFCluster.run(sc, ...)``.

Pieces:
- :mod:`~tensorflowonspark_tpu_torch.engine.rdd` — lazy partitioned collections.
- :mod:`~tensorflowonspark_tpu_torch.engine.executor` — executor process main
  loop (connects back to the driver, runs tasks serially like a 1-core
  Spark executor).
- :mod:`~tensorflowonspark_tpu_torch.engine.context` — driver context: spawns /
  accepts executors, schedules tasks, surfaces errors.
- :mod:`~tensorflowonspark_tpu_torch.engine.serializer` — the port's own
  by-value closure pickler (no ``cloudpickle``).
- :mod:`~tensorflowonspark_tpu_torch.engine.dataframe` — named, typed
  columns over a row RDD (``Context.createDataFrame``).
- :mod:`~tensorflowonspark_tpu_torch.engine.streaming` — the DStream
  analog (``StreamingContext``: ``queueStream``, ``textFileStream``,
  ``foreachRDD``) that ``cluster.train`` feeds from.
- :mod:`~tensorflowonspark_tpu_torch.engine.spark_adapter` — the
  lazy-pyspark shim (``SparkEngineAdapter``, ``from_spark``) that runs
  the cluster API on a real ``SparkContext``.
"""

from tensorflowonspark_tpu_torch.engine.context import Context  # noqa: F401
from tensorflowonspark_tpu_torch.engine.rdd import RDD  # noqa: F401
from tensorflowonspark_tpu_torch.engine.spark_adapter import (  # noqa: F401
    SparkEngineAdapter, from_spark)
from tensorflowonspark_tpu_torch.engine.streaming import (  # noqa: F401
    DStream, StreamingContext)
