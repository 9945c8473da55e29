"""Driver-side cluster API — the framework's main entry point; the port's
copy of ``tensorflowonspark_tpu/cluster.py``.

Reference: ``tensorflowonspark/TFCluster.py`` (SURVEY.md §2 "Cluster API",
§3.1/§3.5 call stacks): assign executor→role template, start the
reservation barrier, launch the async node-bootstrap job, wait for the
cluster to form, and hand back a handle with ``train`` / ``inference`` /
``shutdown`` / ``tensorboard_url``.

The reference's "<10 lines of code change" conversion story is preserved:

    cluster = TFCluster.run(sc, map_fun, args, num_executors,
                            input_mode=InputMode.SPARK)
    cluster.train(dataRDD, num_epochs)
    cluster.shutdown()

where ``sc`` is an :class:`~tensorflowonspark_tpu_torch.engine.Context`,
a real ``SparkContext`` wrapped in
:class:`~tensorflowonspark_tpu_torch.engine.spark_adapter.SparkEngineAdapter`,
or any object with the same RDD surface, and ``map_fun(args, ctx)``
receives a :class:`~tensorflowonspark_tpu_torch.node.NodeContext`.
``train`` also takes a DStream from
:class:`~tensorflowonspark_tpu_torch.engine.streaming.StreamingContext`,
which ``shutdown(ssc)`` stops first.

Left for later slices: ``run(supervise=...)`` (the supervision plane)
and ``serving_fleet`` (the fleet plane), both waiting for the ROADMAP
Queue 1 item "Fleet hosting and the policy planes"; ``supervise=``
raises.
"""

import logging
import os
import random
import string
import threading
import time

from tensorflowonspark_tpu_torch import node, reservation

logger = logging.getLogger(__name__)


class InputMode(object):
    """How the user fn gets its data (reference: ``TFCluster.InputMode``)."""

    TENSORFLOW = 0  #: user fn reads files itself (runs in the foreground)
    SPARK = 1       #: records stream from RDD partitions via queues (background)


class TFCluster(object):
    """Handle to a running cluster; returned by :func:`run`."""

    def __init__(self, sc, cluster_info, cluster_meta, input_mode, server,
                 async_result, queues, num_executors, executor_ids=None,
                 exclude=frozenset()):
        self.sc = sc
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.input_mode = input_mode
        self.server = server
        self.async_result = async_result
        self.queues = queues
        self.num_executors = num_executors
        #: physical executor ids hosting this cluster's nodes (differs
        #: from range(num_executors) when executors are blacklisted)
        self.executor_ids = list(executor_ids) if executor_ids is not None \
            else list(range(num_executors))
        #: executor ids barred from running this cluster's data tasks
        self.exclude = frozenset(exclude)

    # -- training --------------------------------------------------------

    def train(self, dataRDD, num_epochs=0, feed_timeout=600, qname="input"):
        """Feed an RDD (or a DStream, for continuous training) to the
        cluster (``InputMode.SPARK``).

        Epochs are implemented exactly as the reference does (SURVEY.md
        §3.2): ``sc.union([dataRDD] * num_epochs)`` — partition order is
        preserved, so every epoch replays the same data stream. A DStream
        registers a per-micro-batch feed instead (reference: Spark
        Streaming support in ``TFCluster.train``).
        """
        assert self.input_mode == InputMode.SPARK, \
            "train() requires InputMode.SPARK"
        if hasattr(dataRDD, "foreachRDD"):  # DStream
            logger.info("continuous training from stream")
            dataRDD.foreachRDD(
                lambda rdd: rdd.foreachPartition(
                    node.train(self.cluster_info, self.cluster_meta,
                               feed_timeout=feed_timeout, qname=qname)))
            return
        logger.info("training over %d partitions, %d epoch(s)",
                    dataRDD.getNumPartitions(), max(num_epochs, 1))
        if num_epochs > 1:
            dataRDD = self.sc.union([dataRDD] * num_epochs)
        fn = node.train(self.cluster_info, self.cluster_meta,
                        feed_timeout=feed_timeout, qname=qname)
        if self.exclude:
            # engine-only kwarg: blacklisted executors must not pull feed
            # tasks (they host no node for this cluster incarnation)
            dataRDD.foreachPartition(fn, exclude=self.exclude)
        else:
            dataRDD.foreachPartition(fn)

    def inference(self, dataRDD, feed_timeout=600, qname="output"):
        """Feed an RDD through the cluster for inference; returns an RDD of
        result rows (reference: ``TFCluster.inference`` → RDD[str],
        SURVEY.md §3.3).
        """
        assert self.input_mode == InputMode.SPARK, \
            "inference() requires InputMode.SPARK"
        if self.exclude:
            raise NotImplementedError(
                "inference() on a cluster with blacklisted executors is "
                "not supported: the result RDD's job placement cannot "
                "honor the exclusion")
        return dataRDD.mapPartitions(
            node.inference(self.cluster_info, self.cluster_meta,
                           feed_timeout=feed_timeout, qname=qname))

    # -- lifecycle -------------------------------------------------------

    def shutdown(self, ssc=None, grace_secs=0, timeout=259200):
        """Stop the cluster; re-raise any executor-side error on the driver.

        Reference: ``TFCluster.shutdown`` (SURVEY.md §3.5): stop streaming
        first if present; SPARK mode feeds stop markers and joins the
        background trainers; waits for the async bootstrap job; stops the
        reservation server; errors surface as a raised ``RuntimeError``.
        """
        shutdown_error = None
        stream_error = None
        if ssc is not None:
            # A failed micro-batch must not short-circuit the teardown —
            # trainers would hang on the input queue and the real error
            # (surfaced by node.shutdown below) would be masked.
            try:
                ssc.stop()
            except Exception as e:  # noqa: BLE001 - re-raised after cleanup
                stream_error = e
        if self.input_mode == InputMode.SPARK:
            workers = self.sc.parallelize(self.executor_ids,
                                          len(self.executor_ids))
            # EndFeed goes to every input-like queue the cluster created
            # (everything that isn't the output/error plane).
            feed_queues = tuple(q for q in self.queues
                                if q not in ("output", "error")) or ("input",)
            try:
                # fail_fast=False: EndFeed must reach EVERY executor even
                # if one node's shutdown task raises — aborting siblings
                # would strand their trainers on a queue that never ends.
                workers.foreachPartitionAsync(
                    node.shutdown(self.cluster_info, self.cluster_meta,
                                  queues=feed_queues, grace_secs=grace_secs),
                    one_task_per_executor=True,
                    fail_fast=False,
                    **({"exclude": self.exclude} if self.exclude else {})
                    ).get(timeout=timeout)
            except Exception as e:  # noqa: BLE001 - re-raised after cleanup
                shutdown_error = e

        # Wait for the node-bootstrap job itself (in TENSORFLOW mode this is
        # where foreground map_fun errors surface).
        bootstrap_error = None
        try:
            self.async_result.get(timeout=timeout)
        except Exception as e:  # noqa: BLE001
            bootstrap_error = e

        if self.input_mode == InputMode.TENSORFLOW:
            # Cleanup pass the SPARK branch gets from node.shutdown: kill
            # the chief's TensorBoard subprocess, drain the error queue.
            workers = self.sc.parallelize(self.executor_ids,
                                          len(self.executor_ids))
            try:
                workers.foreachPartitionAsync(
                    node.shutdown(self.cluster_info, self.cluster_meta,
                                  queues=(), grace_secs=grace_secs),
                    one_task_per_executor=True,
                    fail_fast=False,
                    **({"exclude": self.exclude} if self.exclude else {})
                    ).get(timeout=timeout)
            except Exception as e:  # noqa: BLE001
                if bootstrap_error is None:
                    shutdown_error = e

        self.server.stop()

        if shutdown_error is not None:
            raise RuntimeError(
                "cluster shutdown surfaced a trainer error:\n{}".format(
                    shutdown_error)) from shutdown_error
        if bootstrap_error is not None:
            raise RuntimeError(
                "cluster node failed:\n{}".format(
                    bootstrap_error)) from bootstrap_error
        if stream_error is not None:
            raise RuntimeError(
                "streaming feed failed") from stream_error
        logger.info("cluster shut down cleanly")

    def tensorboard_url(self):
        """URL of the TensorBoard spawned on the chief node, or None."""
        for n in self.cluster_info:
            if n.get("tb_port"):
                return "http://{}:{}".format(n["host"], n["tb_port"])
        return None

    # -- observability ----------------------------------------------------

    def metrics(self):
        """Cluster-wide observability rollup from the BEAT-piggybacked
        registry snapshots: ``{"executors": {eid: {metrics, train_step,
        feed_hb, state, age}}, "cluster": {executors, train_step,
        merged}}`` where ``merged`` sums every executor's feed-stage
        timers and counters (``tracing.merge_snapshots``). The same
        view the driver's stats endpoint serves over HTTP — see
        :meth:`metrics_url` and docs/observability.md. Per-executor
        views carry ``step_skew`` (goodput plane) once trainers have
        beaten step-time EWMAs."""
        from tensorflowonspark_tpu_torch import goodput, tracing
        return tracing.cluster_rollup(
            goodput.attach_step_skew(self.server.metrics_snapshot()))

    def metrics_url(self):
        """URL of the driver-side OpenMetrics exposition (the
        reservation server's stats HTTP port), or None if it failed to
        bind. ``GET /metrics`` there renders every executor's series
        under an ``executor`` label — one scrape target for the whole
        cluster."""
        if self.server.stats_addr is None:
            return None
        return "http://{}:{}/metrics".format(*self.server.stats_addr)


def run(sc, map_fun, tf_args, num_executors, num_ps=0, tensorboard=False,
        input_mode=InputMode.SPARK, log_dir=None, driver_ps_nodes=False,
        master_node="chief", reservation_timeout=reservation.DEFAULT_TIMEOUT,
        queues=("input", "output", "error"), eval_node=False,
        manager_mode="local", filesystems=None, supervise=None,
        exclude_executors=(), beat_interval=None, prefer_alive=False,
        rendezvous_timeout=None):
    """Start a cluster: one node per executor, roles per the template.

    Reference: ``TFCluster.run`` (SURVEY.md §3.1). ``num_ps`` is accepted
    for API parity but parameter-server roles are not meaningful here
    (SURVEY.md §2.3: async-PS DP is not idiomatic — DP is synchronous
    all-reduce over torch.distributed); passing ``num_ps > 0`` still creates
    ps-role nodes for program compatibility, and their fns simply see
    ``ctx.job_name == 'ps'``. ``driver_ps_nodes`` (reference: run ps tasks
    as driver-side threads) raises: silently ignoring it would change
    where a migrated program's ps fns execute.

    ``filesystems``: optional ``{scheme: opener}`` dict registered (via
    ``fs.register_filesystem``) in every executor AND trainer process —
    the fs registry is process-local, so driver-side registrations alone
    never reach workers; this is the supported way to make ``hdfs://``/
    ``gs://`` paths resolvable cluster-wide. Openers ship through the
    engine's serializer, so module-level functions or closures both work.

    ``rendezvous_timeout``: seconds a trainer's
    ``NodeContext.initialize_torch`` waits for the other ranks to form
    the ``torch.distributed`` group (default
    :data:`node.DEFAULT_RENDEZVOUS_TIMEOUT`, 300, the reference's bound)
    before it raises.

    ``supervise``: the supervision plane is not ported yet; passing one
    raises. ``exclude_executors`` / ``beat_interval`` are that plane's
    plumbing: blacklist a set of engine executor ids (built-in engine
    only) and override the heartbeat-lease cadence.
    """
    if supervise is not None:
        raise NotImplementedError(
            "cluster.run(supervise=...) is not ported yet: the supervision "
            "plane comes with the ROADMAP Queue 1 item 'Fleet hosting and "
            "the policy planes'")
    if driver_ps_nodes:
        raise NotImplementedError(
            "driver_ps_nodes is not supported: async parameter-server DP "
            "is not idiomatic here (SURVEY.md §2.3) so ps fns run as "
            "ordinary ps-role cluster nodes; pass num_ps>0 for that, or "
            "drop driver_ps_nodes from the migrated program.")
    # 1. executor -> role template (reference: cluster_template build).
    needed = num_ps + 1 + (1 if eval_node else 0)
    if needed > num_executors:
        raise ValueError(
            "cluster needs at least {} executors for num_ps={}, master, "
            "eval_node={} but num_executors={}".format(
                needed, num_ps, eval_node, num_executors))
    exclude = frozenset(exclude_executors or ())
    alive_fn = getattr(sc, "executors_alive", None)
    if exclude and alive_fn is None:
        raise NotImplementedError(
            "exclude_executors requires the built-in engine "
            "(Context.executors_alive); Spark contexts cannot "
            "blacklist at this layer")
    if alive_fn is not None and (exclude or prefer_alive):
        # Supervision plane (Blacklist exclusions, ElasticResize
        # reforms): form the cluster on the first num_executors ALIVE,
        # non-excluded engine executors — after an executor loss the
        # surviving ids are not range(num_executors), and a shrunken
        # or regrown width must land on whatever capacity exists NOW.
        # Needs the built-in engine's liveness view; a Spark sc has no
        # analog (prefer_alive simply falls back to range there).
        executor_ids = [e for e in alive_fn() if e not in exclude]
        if len(executor_ids) < num_executors:
            raise RuntimeError(
                "cluster needs {} executors but only {} are alive and "
                "not blacklisted ({} excluded)".format(
                    num_executors, len(executor_ids), sorted(exclude)))
        executor_ids = executor_ids[:num_executors]
    else:
        executor_ids = list(range(num_executors))
    template = {}
    pos = 0
    if num_ps > 0:
        template["ps"] = executor_ids[pos:pos + num_ps]
        pos += num_ps
    template[master_node] = [executor_ids[pos]]
    pos += 1
    if eval_node:
        template["evaluator"] = [executor_ids[pos]]
        pos += 1
    if pos < len(executor_ids):
        template["worker"] = executor_ids[pos:]
    logger.info("cluster template: %s", template)

    # 2. reservation barrier on the driver.
    server = reservation.Server(num_executors)
    server_addr = server.start()
    # width gauge (elastic resize observability): this formation's
    # width; a SupervisedCluster overrides the target with the job's
    # configured width so a shrunken attempt reads degraded
    server.set_cluster_width(num_executors, target=num_executors)

    # 3. cluster metadata shipped to every node task.
    cluster_id = "{}-{}".format(
        int(time.time()),
        "".join(random.choice(string.ascii_lowercase) for _ in range(6)))
    cluster_meta = {
        "id": cluster_id,
        "cluster_template": template,
        "server_addr": list(server_addr),
        "authkey": os.urandom(20).hex(),
        "default_fs": os.environ.get("TFOS_DEFAULT_FS", "file://"),
        "working_dir": os.getcwd(),
        "num_executors": num_executors,
        "master_node": master_node,
        # 'local': broker binds loopback (feed tasks run in the node's own
        # executor process — our engine's layout). 'remote': bind the
        # routable IP, for engines whose data tasks may land elsewhere.
        "manager_mode": manager_mode,
        "reservation_timeout": reservation_timeout,
        # {scheme: opener}; travels inside the shipped node closure
        "filesystems": dict(filesystems or {}),
        # heartbeat-lease cadence for the supervision plane (node.py's
        # beat thread); SupervisorConfig tightens it for fast detection
        "beat_interval": float(beat_interval) if beat_interval else None,
        # bound on the trainers' torch.distributed rendezvous
        "rendezvous_timeout": (float(rendezvous_timeout)
                               if rendezvous_timeout else None),
    }

    # 4. async bootstrap job: one pinned task per executor.
    try:
        nodeRDD = sc.parallelize(executor_ids, len(executor_ids))
        background = (input_mode == InputMode.SPARK)
        async_result = nodeRDD.foreachPartitionAsync(
            node.run(map_fun, tf_args, cluster_meta, tensorboard=tensorboard,
                     log_dir=log_dir, queues=tuple(queues),
                     background=background),
            one_task_per_executor=True,
            **({"exclude": exclude} if exclude else {}))

        # 5. wait for the cluster to form; fail fast if ANY node task died
        # (not only when all finished — the survivors are blocked at the
        # barrier, so done() would never flip).
        def _status():
            err = async_result.first_error()
            if err is not None:
                raise RuntimeError(
                    "cluster node task {} failed during bootstrap: {}".format(
                        err[0], err[1]))

        cluster_info = server.await_reservations(timeout=reservation_timeout,
                                                 status=_status)
    except BaseException:
        # Don't leak the barrier: executors still blocked in
        # await_reservations see the server vanish and fail their node
        # tasks instead of occupying their serial task slot for the full
        # reservation timeout.
        server.stop()
        raise
    logger.info("cluster formed: %s", [
        "{}:{} {}:{}".format(n["job_name"], n["task_index"], n["host"],
                             n["port"]) for n in cluster_info])

    return TFCluster(sc, cluster_info, cluster_meta, input_mode, server,
                     async_result, tuple(queues), num_executors,
                     executor_ids=executor_ids, exclude=exclude)

