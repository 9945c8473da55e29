"""Node runtime: the executor-side heart of the framework — the port's
copy of ``tensorflowonspark_tpu/node.py``, the training half.

Reference: ``tensorflowonspark/TFSparkNode.py`` (SURVEY.md §2 "Node
runtime", §3.1/§3.2 call stacks). One bootstrap task runs per executor and:
derives the node ordinal, starts the per-node queue broker, binds the
accelerator, reserves the ports the node will serve on, registers with the
driver's reservation barrier, blocks until the whole cluster is formed,
then runs the user ``map_fun`` — in a background process for
``InputMode.SPARK`` (the queue-fed path), or in the foreground for
``InputMode.TENSORFLOW`` (direct file reads).

Differences from the reference:

- **The trainer owns the card.** The *trainer* process (forked below)
  is the first and only process of a node to touch CUDA
  (:meth:`NodeContext.initialize_torch`); this bootstrap/feeder process
  must never initialize it — not even ``torch.cuda.is_available()``,
  which creates the driver state a forked child cannot reuse. The
  executor's own code is stdlib and numpy only.
- **TF_CONFIG → torch.distributed.** Instead of exporting ``TF_CONFIG``
  for a TF gRPC server mesh, the barrier's sorted node list yields each
  participant's rank and the chief's reserved port becomes the
  ``init_process_group`` address.
- **Chunked feed.** Feed tasks batch records into chunks before the queue
  ``put`` — the reference's per-record manager-proxy round trip is its
  documented bottleneck (SURVEY.md §3.2 hot loop) and is not reproduced.
  Chunks are size-targeted (FEED_FRAME_BYTES) so tiny records coalesce
  into full frames, and on the ring a partition's tail chunk rides one
  message with its EndPartition marker — the per-message fixed costs the
  small-batch regime otherwise pays per chunk.

- **InputMode.TENSORFLOW forks too.** The reference runs the user fn
  inline in the executor; the port runs it in the forked trainer and
  the bootstrap task waits for it, so the executor stays free of CUDA
  in both modes (see :func:`run`).
- **One card per rank.** :meth:`NodeContext.initialize_torch` gives each
  rank of a host its own card (:func:`local_device_index`).

Left for a later slice: ``serve_replica``/``stop_replica``
(executor-hosted serving, with the ROADMAP Queue 1 item "Fleet hosting
and the policy planes").
"""

import datetime
import logging
import multiprocessing
import os
import queue as _queue
import subprocess
import sys
import threading
import time

from tensorflowonspark_tpu_torch import manager, marker, reservation, util
from tensorflowonspark_tpu_torch.datafeed import DataFeed

logger = logging.getLogger(__name__)

#: Chunk size for the feed plane when record byte sizes are unknowable
#: (object/ragged records): records per queue item, tuned for pickling
#: cost, not device batch size — DataFeed re-slices. All-ndarray records
#: get size-targeted chunks instead (FEED_FRAME_BYTES below).
FEED_CHUNK = 256

#: Byte target per transport frame for measurable (all-ndarray) records:
#: tiny records coalesce into frames of about this size so per-message
#: fixed costs (frame-header pickling, ring wakeups, slot bookkeeping)
#: amortize across many records — the bulk regime gets that amortization
#: for free from its ~38MB frames; the small-batch regime pays the fixed
#: costs on every chunk unless the feeder packs more records per frame.
#: Env-tunable: TFOS_FEED_FRAME_BYTES.
FEED_FRAME_BYTES = 4 * 1024 * 1024

#: Hard cap on records per chunk regardless of the byte target: bounds
#: the feeder's stacking latency for minuscule records (an unbounded
#: target would stall the trainer's first batch behind a whole-partition
#: stack).
FEED_CHUNK_MAX = 4096

#: Per-executor node state, set by the bootstrap task and read by the
#: feed/shutdown tasks that later run in the same executor process
#: (reference: executor_id file + ``_get_manager`` reconnect).
_NODE_STATE = {}

#: seconds a trainer waits for the others at the torch.distributed
#: rendezvous before it raises: the reference's bound (jax's default
#: ``initialization_timeout``); ``cluster_meta["rendezvous_timeout"]``
#: (``cluster.run(rendezvous_timeout=)``) overrides it
DEFAULT_RENDEZVOUS_TIMEOUT = 300.0


def _state():
    """The live per-process node state dict — ALWAYS use this in closures.

    The closures returned by ``run``/``train``/``inference``/``shutdown``
    are nested functions, so the serializer ships them to executors BY VALUE
    and copies referenced module globals (including the ``_NODE_STATE``
    dict) into a private ``__globals__``. A bare ``_NODE_STATE[...]``
    inside such a closure therefore reads/writes a dead per-closure copy
    on the executor, while module-level helpers (pickled by reference)
    read the real module dict — a split-brain. Module *functions* are
    pickled by reference, so routing every access through this accessor
    keeps all parties on the one true dict. Resolved via ``sys.modules``
    for belt-and-braces against any by-value fallback.
    """
    import sys
    return sys.modules[__name__]._NODE_STATE


def _cleanup_ring(ring_name):
    """atexit hook: never leak a /dev/shm ring from an aborted run."""
    try:
        from tensorflowonspark_tpu_torch import shm
        shm._load().shmring_unlink(ring_name.encode())
    except Exception:  # noqa: BLE001 - best effort at interpreter exit
        pass


class NodeContext(object):
    """Handed to the user ``map_fun`` as its second argument.

    Reference: ``TFSparkNode.py :: TFNodeContext`` — executor_id, job_name,
    task_index, cluster_spec, defaultFS, working_dir, mgr + helpers.
    """

    def __init__(self, executor_id, job_name, task_index, cluster_info,
                 cluster_meta, mgr_addr=None, mgr_authkey=None, mgr=None):
        self.executor_id = executor_id
        self.job_name = job_name
        self.task_index = task_index
        self.cluster_info = cluster_info
        self.cluster_meta = cluster_meta
        self.default_fs = cluster_meta.get("default_fs", "file://")
        self.working_dir = cluster_meta.get("working_dir", os.getcwd())
        self._mgr_addr = mgr_addr
        self._mgr_authkey = mgr_authkey
        self._mgr = mgr
        #: the trainer's device, once :meth:`initialize_torch` bound it
        self.device = None
        master = cluster_meta.get("master_node", "chief")
        self.num_workers = sum(
            1 for n in cluster_info
            if n.get("job_name") in (master, "chief", "worker"))

    # -- queue plane -----------------------------------------------------

    @property
    def mgr(self):
        """Queue-broker client, connected lazily (the trainer is a freshly
        spawned process and must authkey-stamp itself before connecting)."""
        if self._mgr is None:
            multiprocessing.current_process().authkey = self._mgr_authkey
            self._mgr = manager.connect(self._mgr_addr, self._mgr_authkey)
        return self._mgr

    def get_data_feed(self, train_mode=True, qname_in="input",
                      qname_out="output", input_mapping=None):
        """The queue-fed input API (reference: ``TFNodeContext.get_data_feed``)."""
        return DataFeed(self.mgr, train_mode, qname_in, qname_out, input_mapping)

    # -- paths -----------------------------------------------------------

    def absolute_path(self, path):
        """Absolutize a user path against default_fs / working dir.

        Reference: ``TFNodeContext.absolute_path`` / ``TFNode.hdfs_path``.
        The reference resolved remote schemes through TF's gfile+Hadoop;
        here remote schemes require a registered opener (fs.py) — an
        unregistered scheme fails HERE, loudly, instead of as a
        confusing ENOENT deep inside a reader.
        """
        from tensorflowonspark_tpu_torch import fs
        if fs.scheme_of(path) is not None:
            # canonical message + chained probe cause, same as fs.open
            return fs.ensure_supported(path)
        if path.startswith("file://") or os.path.isabs(path):
            return path
        return os.path.join(self.working_dir, path)

    # -- cluster / devices ------------------------------------------------

    def cluster_spec(self):
        """{job_name: [host:port, ...]} — the TF_CONFIG-shaped view."""
        spec = {}
        for node in self.cluster_info:
            spec.setdefault(node["job_name"], []).append(
                "{}:{}".format(node["host"], node["port"]))
        return spec

    def participants(self):
        """Nodes that join the device collective: the worker family.

        ps/evaluator roles (kept for API parity, SURVEY.md §2.3) park
        outside the collective — they never call init_process_group and must not be
        counted as processes or host the coordinator.
        """
        return [n for n in self.cluster_info
                if n.get("job_name") not in ("ps", "evaluator")]

    def coordinator_address(self):
        """host:port of the first participant — the torch.distributed
        rendezvous (its reserved port; the TF_CONFIG analog)."""
        first = self.participants()[0]
        return "{}:{}".format(first["host"], first["port"])

    def initialize_torch(self, device=None):
        """Bind this node's trainer to its device and join the collective;
        returns the ``torch.device``. The ``start_cluster_server`` analog.

        ``device`` is :func:`device_info.default_device`'s argument: None
        means this rank's card (raising when there is none), ``"cpu"``
        the CPU, and an explicit device wins. This rank's card is
        ``cuda:<i>`` with ``i`` its position among the participants on
        its host, modulo the cards it sees (:func:`local_device_index`),
        so ranks that share a host take different cards (the reference
        gave each process its own local devices); it becomes the current
        device (``torch.cuda.set_device``) before the group forms.
        With more than one participant and ``TFOS_TPU_DISTRIBUTED`` on
        (the default), this calls ``torch.distributed.init_process_group``
        at :meth:`coordinator_address` with rank = this node's index among
        the participants — NCCL on the card, gloo on the CPU — and a
        bound of :data:`DEFAULT_RENDEZVOUS_TIMEOUT` seconds (or
        ``cluster_meta["rendezvous_timeout"]``) on the group's forming
        and its collectives: a rank that never joins makes the others
        raise after it, in the trainer, and the error surfaces at
        ``cluster.shutdown``. ps/evaluator nodes are not participants and
        get their device only.

        Call it in the trainer (the ``map_fun``), never in the executor:
        the first CUDA call of a process creates its CUDA context, and
        the trainer is forked from the executor.
        """
        import torch

        from tensorflowonspark_tpu_torch import device_info

        participants = self.participants()
        ids = [n["executor_id"] for n in participants]
        if device is None and torch.cuda.is_available():
            device = "cuda:{}".format(local_device_index(
                participants if self.executor_id in ids
                else self.cluster_info, self.executor_id,
                torch.cuda.device_count()))
        device = device_info.default_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if (len(participants) > 1 and self.executor_id in ids
                and _distributed_enabled()):
            import torch.distributed as dist

            if not dist.is_initialized():
                timeout = (self.cluster_meta.get("rendezvous_timeout")
                           or DEFAULT_RENDEZVOUS_TIMEOUT)
                dist.init_process_group(
                    backend="nccl" if device.type == "cuda" else "gloo",
                    init_method="tcp://" + self.coordinator_address(),
                    world_size=len(participants),
                    rank=ids.index(self.executor_id),
                    timeout=datetime.timedelta(seconds=float(timeout)))
        self.device = device
        return device

    def mesh(self, axis_shapes=None):
        """A ``DeviceMesh`` over the participants' ranks
        (:func:`parallel.mesh.build_mesh` over the group
        :meth:`initialize_torch` formed; call that first).

        ``axis_shapes``: ordered {axis_name: size}; defaults to a pure
        data-parallel mesh ``{'data': n_ranks}`` (the reference's only
        parallelism family, SURVEY.md §2.3). A lone participant gets a
        one-rank group on its device. Imports torch lazily: only the
        trainer process may do this.
        """
        from tensorflowonspark_tpu_torch.parallel import mesh as mesh_lib

        return mesh_lib.build_mesh(axis_shapes, device=self.device)

    def task_sorted_index(self):
        """This node's index in the sorted cluster_info == its
        torch.distributed rank among the participants when no
        ps/evaluator node precedes it."""
        for i, node in enumerate(self.cluster_info):
            if node["executor_id"] == self.executor_id:
                return i
        raise RuntimeError(
            "executor {} not present in cluster_info".format(self.executor_id))


def local_device_index(nodes, executor_id, visible):
    """The card index of ``executor_id``'s trainer: its position among
    the ``nodes`` (cluster_info entries, in rank order) whose ``host``
    equals its own, modulo ``visible`` cards. One host of N ranks and N
    cards gives each rank its own card; more ranks than cards share them
    round-robin; a host with one rank takes card 0."""
    if visible < 1:
        raise ValueError("no visible card to choose from")
    host = None
    for n in nodes:
        if n["executor_id"] == executor_id:
            host = n["host"]
            break
    else:
        raise ValueError("executor {} is not among the nodes".format(
            executor_id))
    local = [n["executor_id"] for n in nodes if n["host"] == host]
    return local.index(executor_id) % visible


def _distributed_enabled():
    """Default ON: a real multi-node cluster that skipped
    ``init_process_group`` would train as N unsynchronized replicas and
    produce silently wrong models. A single-host test harness whose
    trainers each train alone opts out with ``TFOS_TPU_DISTRIBUTED=0``
    (the reference's variable, kept so programs port unchanged)."""
    return os.environ.get("TFOS_TPU_DISTRIBUTED", "1") == "1"


def run(fn, tf_args, cluster_meta, tensorboard=False, log_dir=None,
        queues=("input", "output", "error"), background=True):
    """Return the bootstrap closure run once per executor.

    Reference: ``TFSparkNode.run(fn, tf_args, cluster_meta, tensorboard,
    log_dir, queues, background)`` — the returned ``_mapfn`` is shipped via
    ``nodeRDD.foreachPartitionAsync`` (SURVEY.md §3.1).
    """

    def _mapfn(iterator):
        # Partition payload is [executor_id]; also cross-check the engine's
        # persisted ordinal (reference: util.read_executor_id).
        ids = list(iterator)
        from tensorflowonspark_tpu_torch.engine import executor as engine_executor
        info = engine_executor.get_executor_info()
        executor_id = ids[0] if ids else info.get("executor_id")

        # Duplicate-bootstrap guard (reference: cluster-id check in
        # TFSparkNode.run for retried tasks).
        if _state().get("cluster_id") == cluster_meta["id"]:
            logger.warning("executor %s already bootstrapped for cluster %s; "
                           "skipping duplicate node task", executor_id,
                           cluster_meta["id"])
            return

        job_name, task_index = _assign_role(executor_id,
                                            cluster_meta["cluster_template"])
        # Feed plane allocator tuning (8x consumer-copy rate on fresh
        # pages; util.tune_malloc docstring): set in the bootstrap
        # process so fork-started trainers inherit the tuned arena.
        util.tune_malloc()
        host = info.get("host") or util.get_ip_address()
        authkey = bytes.fromhex(cluster_meta["authkey"])
        _register_filesystems(cluster_meta)

        # 1. queue broker for this node (the process-boundary bridge)
        mgr = manager.start(authkey, list(queues),
                            mode=cluster_meta.get("manager_mode", "local"),
                            host=host)

        # 1b. native shm ring: the feed fast path when the broker is
        # local (feeder and trainer share this host — always true for
        # the fork/spawn trainer below). The default is 'auto': a
        # measured-at-startup micro-probe picks whichever transport
        # actually moves a representative chunk faster ON THIS HOST
        # (the two are within noise on small boxes, and a wrong static
        # default costs the whole feed plane). TFOS_FEED_TRANSPORT=
        # shm|queue forces; remote-mode brokers stay on queues (the
        # ring is host-local).
        ring = None
        transport = os.environ.get("TFOS_FEED_TRANSPORT")
        if transport is None:
            transport = ("auto" if cluster_meta.get("manager_mode", "local")
                         == "local" else "queue")
        if transport in ("shm", "auto"):
            from tensorflowonspark_tpu_torch import shm
            probe_rates = None
            if shm.available():
                # the creator pid in the name is what lets sweep_stale
                # prove a segment's owner died (SIGKILL leaves no other
                # cleanup path); the sweep clears THIS slot's leftovers
                # from any earlier cluster before we allocate
                shm.sweep_stale(executor_id)
                ring_name = "/tfos-{}-{}.{}".format(
                    cluster_meta["id"][-10:], executor_id, os.getpid())
                shm._load().shmring_unlink(ring_name.encode())  # clear stale
                try:
                    ring = shm.ShmRing.create(ring_name)
                except OSError as e:
                    probe_rates = {"error": "ring create failed: %s" % e}
                    logger.warning("shm ring disabled (%s); using queues", e)
                if ring is not None and transport == "auto":
                    choice, probe_rates = _probe_feed_transport(ring)
                    # the probe moved real bytes through the ring, and a
                    # failed leg may leave a consumer thread behind:
                    # recreate the segment either way so the trainer can
                    # never read probe residue as training data (the
                    # zombie's mmap stays valid but orphaned)
                    ring.close()
                    shm._load().shmring_unlink(ring_name.encode())
                    ring = None
                    if choice == "shm":
                        try:
                            ring = shm.ShmRing.create(ring_name)
                        except OSError as e:
                            probe_rates = dict(
                                probe_rates,
                                error="ring recreate failed: %s" % e)
                            logger.warning("shm ring recreate failed (%s); "
                                           "using queues", e)
                    else:
                        logger.info("transport probe picked queue (%s)",
                                    probe_rates)
                if ring is not None:
                    mgr.set("shm_name", ring_name)
                    import atexit
                    atexit.register(_cleanup_ring, ring_name)
                    logger.info("feed fast path: shm ring %s", ring_name)
            else:
                probe_rates = {"error": "native shm ring unavailable"}
                log = (logger.warning if transport == "shm" else logger.info)
                log("shm feed transport %s but the native ring is "
                    "unavailable; using queues",
                    "requested" if transport == "shm" else "probed")
            if transport == "auto":
                # every auto run records why its transport was chosen
                mgr.set("feed_transport_probe", probe_rates)
        # the effective transport, observable by feeders/tools either way
        mgr.set("feed_transport", "shm" if ring is not None else "queue")

        # 2. reserve the port this node serves on (chief's doubles as the
        # torch.distributed rendezvous address)
        port = int(os.environ.get("TFOS_SERVER_PORT", 0)) or util.find_free_port()

        # 3. optional tensorboard on the designated master node
        tb_port, tb_pid = 0, 0
        if tensorboard and job_name == cluster_meta.get("master_node", "chief"):
            tb_port, tb_pid = _start_tensorboard(log_dir)

        # 4. register with the driver's barrier; block until cluster formed
        client = reservation.Client(cluster_meta["server_addr"])
        node_meta = {"executor_id": executor_id, "host": host,
                     "job_name": job_name, "task_index": task_index,
                     "port": port, "tb_port": tb_port, "tb_pid": tb_pid,
                     "mgr_addr": list(mgr.address), "pid": os.getpid()}
        client.register(node_meta)
        cluster_info = client.await_reservations(
            timeout=cluster_meta.get("reservation_timeout",
                                     reservation.DEFAULT_TIMEOUT))
        client.close()
        logger.info("node %s/%d (executor %s) sees cluster of %d",
                    job_name, task_index, executor_id, len(cluster_info))

        mgr.set("endpoint", {"host": host, "mgr_addr": list(mgr.address)})

        ctx = NodeContext(executor_id, job_name, task_index, cluster_info,
                          cluster_meta, mgr_addr=mgr.address,
                          mgr_authkey=authkey, mgr=mgr)

        _state().update(cluster_id=cluster_meta["id"], mgr=mgr,
                        executor_id=executor_id, ctx=ctx,
                        trainer_proc=None, tb_pid=tb_pid, shm_ring=ring)

        # Supervision heartbeat lease (supervisor.py): a small status
        # beat to the driver's reservation server, carrying the three
        # liveness signals the Supervisor classifies — node state +
        # feed progress (broker kv), trainer process exit status, and
        # the beat's very arrival (executor liveness). Always on: the
        # beat is one tiny JSON message per interval and the lease
        # table is what makes an unsupervised cluster debuggable too.
        # Seed the metrics kv with an empty registry snapshot BEFORE
        # the first beat: the driver's rollup then distinguishes "node
        # up, feed idle" (empty snapshot) from "no observability plane"
        # (None) even while the trainer process is still importing —
        # the trainer's DataFeed overwrites it with real numbers.
        from tensorflowonspark_tpu_torch import tracing as tracing_mod
        mgr.set("metrics", tracing_mod.MetricsRegistry().snapshot())
        _start_beat_thread(cluster_meta, mgr, executor_id)

        proc = _start_trainer(fn, tf_args, executor_id, job_name,
                              task_index, cluster_info, cluster_meta, mgr)
        if background:
            # InputMode.SPARK: the trainer runs in a child process (it will
            # own the card); this bootstrap task returns so the executor's
            # task slot frees up for feed tasks (SURVEY.md §3.2).
            _state()["trainer_proc"] = proc
            logger.info("spawned background trainer pid %d", proc.pid)

            # Watchdog: a trainer killed without running its exception
            # handler (OOM SIGKILL) would leave state='running' and feeders
            # blocked until feed_timeout; flip state the moment it exits
            # abnormally. (Reference has no analog — its feeders just time
            # out; SURVEY.md §5 failure-detection.)
            def _watch(proc=proc, mgr=mgr, executor_id=executor_id):
                proc.join()
                try:
                    # surfaced to the supervisor via the heartbeat lease
                    # payload AND readable from user/test code
                    mgr.set("trainer_exit", proc.exitcode)
                except Exception:  # noqa: BLE001 - broker may be gone
                    pass
                if proc.exitcode not in (0, None) and \
                        mgr.get("state") == "running":
                    msg = ("trainer on executor {} exited with code {} "
                           "without reporting an error (killed?)".format(
                               executor_id, proc.exitcode))
                    logger.error(msg)
                    try:
                        mgr.get_queue("error").put(msg)
                        mgr.set("state", "error")
                    except Exception:
                        pass

            # tfos: unjoined(exits with the trainer process it watches; the executor task has no later teardown hook)
            threading.Thread(target=_watch, name="trainer-watchdog",
                             daemon=True).start()
        else:
            # InputMode.TENSORFLOW: the user fn runs in the foreground —
            # this task waits for the trainer — but in the forked trainer
            # process, not inline as in the reference, so the executor
            # never holds a CUDA context (a later trainer forked from it
            # could not use the card) and the card's memory is released
            # when the trainer exits. Errors reach the error queue (the
            # trainer puts its traceback there) AND fail this task.
            _state()["trainer_proc"] = proc
            proc.join()
            mgr.set("trainer_exit", proc.exitcode)
            if proc.exitcode != 0:
                raise RuntimeError(
                    "trainer on executor {} exited with code {}:\n{}".format(
                        executor_id, proc.exitcode,
                        mgr.get("trainer_error") or "(no traceback)"))

    return _mapfn


def _start_trainer(fn, tf_args, executor_id, job_name, task_index,
                   cluster_info, cluster_meta, mgr):
    """Start the trainer process of this node (it will own the card).

    Start method: fork (default) is safe *because this executor process
    never initializes CUDA* — the child is the first CUDA toucher — and
    it inherits the user fn without pickling. spawn
    (TFOS_TRAINER_START_METHOD=spawn) is available for paranoid
    isolation; it ships one opaque serializer payload, since mp
    re-pickles spawn args with *standard* pickle, which cannot handle
    dynamically-defined closures.
    """
    method = os.environ.get("TFOS_TRAINER_START_METHOD", "fork")
    args = (fn, tf_args, executor_id, job_name, task_index, cluster_info,
            cluster_meta, list(mgr.address))
    if method == "fork":
        proc = multiprocessing.get_context("fork").Process(
            target=_trainer_main_fork, args=args,
            name="tfos-trainer-%s" % executor_id)
    else:
        from tensorflowonspark_tpu_torch.engine import serializer
        proc = multiprocessing.get_context("spawn").Process(
            target=_trainer_main, args=(serializer.dumps(args),),
            name="tfos-trainer-%s" % executor_id)
    proc.daemon = True
    proc.start()
    return proc


#: default seconds between heartbeat-lease beats (env: TFOS_BEAT_INTERVAL;
#: supervised runs tighten it via SupervisorConfig -> cluster_meta)
DEFAULT_BEAT_INTERVAL = 2.0


def _beat_payload(mgr, executor_id):
    """One heartbeat lease payload: the supervisor's raw signal set."""
    proc = _state().get("trainer_proc")

    def _kv(key):
        try:
            return mgr.get(key)
        except Exception:  # noqa: BLE001 - broker may be gone at teardown
            return None

    return {"state": _kv("state"), "feed_hb": _kv("feed_hb"),
            "train_step": _kv("train_step"),
            "restored_step": _kv("restored_step"),
            "feed_transport": _kv("feed_transport"),
            # compact MetricsRegistry snapshot the trainer's DataFeed
            # publishes alongside feed_hb (tracing.py): the lease
            # carries each executor's feed-stage breakdown to the
            # driver, where cluster.metrics() merges the fleet's view
            # and a failure's incident evidence quotes the stalled
            # executor's stages
            "metrics": _kv("metrics"),
            "trainer_alive": None if proc is None else proc.is_alive(),
            "trainer_exit": None if proc is None else proc.exitcode,
            "executor_id": executor_id, "pid": os.getpid()}


def _start_beat_thread(cluster_meta, mgr, executor_id):
    """Publish this node's heartbeat lease to the reservation server.

    Daemon thread; exits when this node's cluster incarnation ends
    (shutdown pops the state's cluster_id; a reform replaces it) or the
    node reaches the stopped state. A dead/unreachable server just drops
    the connection and retries next tick — beats must never take a node
    down. chaos.on_heartbeat() gates each send so the harness can
    simulate an executor going dark without killing anything.
    """
    interval = float(os.environ.get("TFOS_BEAT_INTERVAL", 0) or
                     cluster_meta.get("beat_interval") or
                     DEFAULT_BEAT_INTERVAL)
    cluster_id = cluster_meta["id"]
    server_addr = cluster_meta["server_addr"]

    def _beat_loop():
        from tensorflowonspark_tpu_torch import chaos
        client = None
        payload = None
        try:
            while _state().get("cluster_id") == cluster_id:
                payload = _beat_payload(mgr, executor_id)
                if not chaos.on_heartbeat():
                    try:
                        if client is None:
                            # short connect bound: a dead
                            # reservation server must cost one tick a
                            # few seconds, not the OS connect timeout
                            client = reservation.Client(
                                server_addr, connect_timeout=5)
                        client.beat(executor_id, payload)
                    except Exception:  # noqa: BLE001 - beat must retry
                        # ANY send failure (conn refused, EOF mid-reply,
                        # codec error) drops the connection and retries
                        # next tick — a beat thread that dies silently
                        # blinds the supervisor to every later failure
                        logger.debug("heartbeat send failed; will retry",
                                     exc_info=True)
                        if client is not None:
                            try:
                                client.close()
                            except Exception:  # noqa: BLE001
                                pass
                        client = None
                if payload.get("state") == "stopped":
                    break
                time.sleep(interval)
            logger.info("beat loop for executor %s exiting: cluster_id=%r "
                        "(beating %r), state=%r", executor_id,
                        _state().get("cluster_id"), cluster_id,
                        payload.get("state") if payload else None)
        except BaseException:
            logger.exception("beat loop for executor %s died", executor_id)
            raise
        finally:
            if client is not None:
                try:
                    client.close()
                except Exception:  # noqa: BLE001
                    pass

    # tfos: unjoined(silenced by _shutdown's final SYNCHRONOUS beat at teardown; the daemon loop ends with the executor)
    threading.Thread(target=_beat_loop, name="tfos-beat-%s" % executor_id,
                     daemon=True).start()


def _register_filesystems(cluster_meta):
    """Replay driver-provided {scheme: opener} registrations here.

    The fs registry is process-local (fs.py); cluster.run ships the
    openers in cluster_meta so executors, trainers, and data-task
    processes all resolve the same remote schemes. Idempotent.
    """
    openers = cluster_meta.get("filesystems") or {}
    if openers:
        from tensorflowonspark_tpu_torch import fs
        for scheme, opener in openers.items():
            fs.register_filesystem(scheme, opener)


def _trainer_main(payload):
    """spawn-mode entry: unwrap the serializer payload first."""
    from tensorflowonspark_tpu_torch.engine import serializer
    util.tune_malloc()  # spawn starts a fresh libc: re-apply the tuning
    _trainer_main_fork(*serializer.loads(payload))


def _close_inherited_sockets():
    """Close every socket fd a forked trainer inherited from the executor.

    Fork duplicates the executor's fds — including its engine-driver
    connection and the queue broker's *listen* socket — and those
    duplicates break failure detection from the grave (found by the
    chaos suite): when the executor is SIGKILLed,
    (a) the driver never sees EOF on its executor connection because
    the trainer's copy keeps the TCP stream established, so the engine
    hangs instead of failing the task; and (b) the trainer's own broker
    reconnect SUCCEEDS against the inherited listen socket that nothing
    accepts on, parking the error path in recv() forever. The trainer
    needs none of these — it builds every connection it uses fresh
    (broker by address, ring by name) — so owning zero inherited
    sockets restores the invariant that a process's death closes its
    endpoints.

    dup2(/dev/null) rather than close(): the forked copies of the
    executor's python socket objects still reference these fd numbers,
    and a bare close would free the numbers for reuse — a stale
    object's destructor could then close an unrelated fd the trainer
    opened later. dup2 drops the kernel socket reference (what we
    need) while keeping the slot occupied by /dev/null, which the
    stale destructors may close harmlessly.
    """
    import stat as stat_mod
    fds = None
    for fd_dir in ("/proc/self/fd", "/dev/fd"):  # linux, then macOS/BSD
        try:
            fds = [int(f) for f in os.listdir(fd_dir)]
            break
        except OSError:
            continue
    if fds is None:  # no fd listing on this platform: nothing safe to do
        return
    devnull = os.open(os.devnull, os.O_RDWR)
    for fd in fds:
        if fd < 3 or fd == devnull:
            continue
        try:
            if stat_mod.S_ISSOCK(os.fstat(fd).st_mode):
                os.dup2(devnull, fd)
        except OSError:
            continue
    os.close(devnull)


def _trainer_main_fork(fn, tf_args, executor_id, job_name, task_index,
                       cluster_info, cluster_meta, mgr_addr):
    """Entry of the trainer process — the card's owner.

    Mirrors the reference's ``fn_wrapper``: run the user fn; on exception,
    push the traceback to the 'error' queue so ``shutdown()`` can re-raise
    it on the driver (SURVEY.md §3.5).
    """
    _close_inherited_sockets()
    logging.basicConfig(
        level=os.environ.get("TFOS_LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s trainer[{}] %(name)s: %(message)s"
        .format(executor_id))
    # chaos.py scoping: `only=EID` injections fire in the one trainer
    # whose executor matches (how a blacklist test kills one node of N)
    os.environ["TFOS_TRAINER_EXECUTOR_ID"] = str(executor_id)
    authkey = bytes.fromhex(cluster_meta["authkey"])
    multiprocessing.current_process().authkey = authkey
    _register_filesystems(cluster_meta)  # spawn mode starts from scratch
    ctx = NodeContext(executor_id, job_name, task_index, cluster_info,
                      cluster_meta, mgr_addr=tuple(mgr_addr),
                      mgr_authkey=authkey)
    try:
        fn(tf_args, ctx)
    except BaseException:  # noqa: BLE001 - must reach the driver
        import traceback
        tb = traceback.format_exc()
        logger.error("trainer failed:\n%s", tb)
        try:
            ctx.mgr.get_queue("error").put(tb)
            ctx.mgr.set("trainer_error", tb)
            ctx.mgr.set("state", "error")
        except Exception:
            pass
        sys.exit(1)


def _assign_role(executor_id, cluster_template):
    """executor ordinal -> (job_name, task_index).

    Reference: the cluster_template built in ``TFCluster.run`` maps executor
    index ranges to ps/chief/worker/evaluator roles.
    """
    for job_name, ids in cluster_template.items():
        if executor_id in ids:
            return job_name, ids.index(executor_id)
    raise RuntimeError(
        "executor {} not in cluster template {}".format(
            executor_id, cluster_template))


def _start_tensorboard(log_dir):
    """Spawn `tensorboard --logdir` if the binary exists; (port, pid)."""
    import shutil
    exe = shutil.which("tensorboard")
    if exe is None or not log_dir:
        logger.info("tensorboard unavailable or no log_dir; skipping")
        return 0, 0
    port = util.find_free_port()
    proc = subprocess.Popen(
        [exe, "--logdir", log_dir, "--port", str(port), "--bind_all"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    logger.info("tensorboard pid %d on port %d", proc.pid, port)
    return port, proc.pid


# -- data-plane closures (run on arbitrary executors) ----------------------

def _get_manager(cluster_info, cluster_meta, executor_id):
    """Connect to the queue broker of the node on this executor.

    Reference: ``TFSparkNode._get_manager``. Fast path: the broker lives in
    this very process (our engine runs feed tasks in the executor process
    that bootstrapped the node) — use the cached client. Slow path: look up
    the node's advertised mgr_addr in cluster_info and connect with the
    cluster authkey from cluster_meta.
    """
    st = _state()
    if st.get("executor_id") == executor_id and "mgr" in st:
        return st["mgr"]
    for node in cluster_info:
        if node["executor_id"] == executor_id:
            authkey = bytes.fromhex(cluster_meta["authkey"])
            multiprocessing.current_process().authkey = authkey
            return manager.connect(tuple(node["mgr_addr"]), authkey)
    raise RuntimeError(
        "no cluster node found for executor {}".format(executor_id))


def _local_executor_id():
    from tensorflowonspark_tpu_torch.engine import executor as engine_executor
    info = engine_executor.get_executor_info()
    eid = info.get("executor_id")
    if eid is None:
        eid = util.read_executor_id()
    return eid


def train(cluster_info, cluster_meta, feed_timeout=600, qname="input"):
    """Feed closure: push this partition's records into the local node's
    input queue, chunked; block until consumed.

    Reference: ``TFSparkNode.train`` → ``_train`` (SURVEY.md §3.2 hot path).
    """

    def _train(iterator):
        _feed_one_partition(iterator, cluster_info, cluster_meta,
                            feed_timeout, qname)

    return _train


def _feed_one_partition(iterator, cluster_info, cluster_meta, feed_timeout,
                        qname="input"):
    """Feed one partition into this executor's node; True iff the node
    consumed it fully (the feed-level acknowledgement supervisor.py's
    replay bookkeeping is built on). Shared by the plain ``train``
    closure and the supervised acked-feed closure."""
    mgr = _get_manager(cluster_info, cluster_meta, _local_executor_id())
    state = mgr.get("state")
    if state in ("terminating", "stopped", "error"):
        logger.info("feed task skipping: node state is %r", state)
        # Drain the partition so upstream iterators don't block.
        for _ in iterator:
            pass
        return False
    count = _feed_partition(iterator, mgr, qname, feed_timeout)
    # block (bounded) until the partition is consumed
    consumed = _join_feed(mgr, qname, feed_timeout)
    logger.info("fed %d records to %r (consumed=%s)", count, qname, consumed)
    return bool(consumed)


def _feed_ring(qname):
    """The node's shm ring, when the fast path is active for this queue."""
    if qname == "input":
        return _state().get("shm_ring")
    return None


def _columnar_leaves(record):
    """``record``'s field values iff the feed would columnarize it;
    None otherwise. THE one gate shared by _pack_chunk (whether to
    stack) and _chunk_limit (whether byte-targeted sizing applies) —
    a drifted copy would size chunks for a packing that never happens.

    Only records whose fields are numpy numeric values (arrays or 0-d
    scalars — a ``(image, np.int64_label)`` tuple is the canonical feed
    record and must not flunk this gate) qualify: python scalars /
    strings / objects must round-trip with their exact types, and only
    bulk array payloads benefit from raw-byte framing anyway.
    """
    import numpy as np

    if isinstance(record, dict):
        leaves = list(record.values())
    elif isinstance(record, (tuple, list)):
        leaves = list(record)
    else:
        leaves = [record]
    if leaves and all(
            isinstance(v, (np.ndarray, np.generic))
            and v.dtype.kind in "biufc"
            for v in leaves):
        return leaves
    return None


def _pack_chunk(records):
    """Stack a chunk of records into a ColumnarChunk when possible.

    Columnar chunks move as raw contiguous bytes (frames.py) and the
    consumer re-slices them without per-record work — the feed plane's
    main copy-count lever (SURVEY.md §7.3). Records that don't stack
    (ragged shapes, object/string payloads) fall back to the plain list
    chunk with identical semantics.
    """
    from tensorflowonspark_tpu_torch import frames as frames_lib

    if _columnar_leaves(records[0]) is None:
        return list(records)
    try:
        return frames_lib.ColumnarChunk.from_records(records)
    except Exception:  # noqa: BLE001 - ragged shapes etc → legacy path
        return list(records)


def _pack_chunks(records):
    """``records`` → list of feed items to enqueue.

    Normally one item. The exception: a size-targeted accumulation
    (``_chunk_limit``, up to FEED_CHUNK_MAX records, sized from the
    FIRST record) whose later records turned out ragged/mixed falls
    back to a pickled row list — unsplittable by the ring's oversize
    path and a single giant pickle on the queue — so oversized fallback
    lists re-split to the legacy FEED_CHUNK bound here.
    """
    packed = _pack_chunk(records)
    if isinstance(packed, list) and len(packed) > FEED_CHUNK:
        return [packed[i:i + FEED_CHUNK]
                for i in range(0, len(packed), FEED_CHUNK)]
    return [packed]


def _chunk_limit(first_record):
    """Records per chunk for this partition: size-targeted for records
    the feed will columnarize (same gate as _pack_chunk — byte-sizing a
    pickled-row chunk would 16x a path the frame target was never meant
    to touch), FEED_CHUNK otherwise.

    Never sized BELOW FEED_CHUNK — bulk-regime records (147KB images)
    already hit multi-MB frames at 256 records and shrinking them would
    regress the tuned path; the target only coalesces MORE records when
    they are small.
    """
    leaves = _columnar_leaves(first_record)
    if leaves is None:
        return FEED_CHUNK
    rec_bytes = sum(v.nbytes for v in leaves) or 1
    try:
        target = int(os.environ.get("TFOS_FEED_FRAME_BYTES", "") or
                     FEED_FRAME_BYTES)
    except ValueError:
        target = FEED_FRAME_BYTES
    return max(FEED_CHUNK, min(FEED_CHUNK_MAX, target // rec_bytes))


def _feed_partition(iterator, mgr, qname, feed_timeout, cancel=None):
    """Push one partition into ``qname`` as chunks + EndPartition; returns
    the record count. Shared by the train and inference feed closures.
    Transport is the shm ring when active (node bootstrap created it),
    else the manager queue. ``cancel`` (a ``threading.Event``) aborts the
    feed between chunks — set by a concurrent consumer that failed, so a
    background feeder never outlives its task.

    Two per-message-cost amortizations for the small-batch regime:
    chunks are size-targeted (``_chunk_limit`` — tiny records pack into
    ~FEED_FRAME_BYTES frames instead of 256-record slivers), and on the
    ring the partition's final chunk coalesces with its EndPartition
    marker into ONE gather write (``frames.FrameList``) — for a
    small partition that halves the message count outright. One chunk is
    buffered (``prev``) to make the tail identifiable; backpressure
    semantics are unchanged, the feeder just runs one chunk ahead.
    """
    ring = _feed_ring(qname)
    q = None if ring is not None else mgr.get_queue(qname)

    def put(obj, deadline):
        if cancel is not None and cancel.is_set():
            raise RuntimeError("feed cancelled by consumer")
        if ring is not None:
            _ring_put(ring, obj, mgr, deadline, cancel=cancel)
        else:
            _bounded_put(q, obj, mgr, deadline, cancel=cancel)

    deadline = time.monotonic() + feed_timeout
    chunk = []
    limit = None
    prev = None
    count = 0

    def emit(obj):
        """Buffer one item; flush the previously buffered one."""
        nonlocal prev, deadline
        if prev is not None:
            put(prev, deadline)
            deadline = time.monotonic() + feed_timeout
        prev = obj

    for item in iterator:
        if limit is None:
            limit = _chunk_limit(item)
        chunk.append(item)
        if len(chunk) >= limit:
            for packed in _pack_chunks(chunk):
                emit(packed)
            count += len(chunk)
            chunk = []
    if chunk:
        for packed in _pack_chunks(chunk):
            emit(packed)
        count += len(chunk)
    end = marker.EndPartition()
    if prev is None:
        put(end, deadline)
    else:
        # Both transports coalesce the final chunk with its EndPartition
        # into ONE message. On the ring that halves the tail's message
        # count; on the queue it additionally makes the partition ack
        # prompt: the consumer unpacks the marker in the same next_batch
        # call that returns the final chunk, so ``queue.join()`` — and a
        # supervised feed's ACK — completes with the batch, not one call
        # later (the off-by-one that would make a kill-after-step-N
        # replay an already-consumed partition).
        from tensorflowonspark_tpu_torch import frames as frames_lib
        put(frames_lib.FrameList([prev, end]), deadline)
    return count


def _probe_feed_transport(ring, reps=4, records=32):
    """Measured-at-startup transport pick; returns ('shm'|'queue', rates).

    A static shm-when-local default can lose: on some hosts the ring
    measured slower than the queue. This
    pushes the same representative columnar chunk through both
    transports' dominant cost paths — the queue leg as pickle + TCP
    loopback round trips (what the manager-proxy hop pays per chunk;
    see the in-function note for why not real proxies), the shm leg
    through write_obj/read_obj on the live ring — and picks the
    measured winner. Ties break toward shm: equal copy cost still
    leaves the manager socket free for control traffic. Any probe
    failure keeps shm (the pre-probe default) so a broken probe can
    never disable the fast path.

    The probe moves real bytes through ``ring``, and a failed leg can
    leave its consumer thread (and unread residue) behind — the caller
    must recreate the ring segment afterwards, never feed through the
    probed one.
    """
    import numpy as np

    from tensorflowonspark_tpu_torch import frames as frames_lib

    chunk = frames_lib.ColumnarChunk(
        [np.zeros((records, 64, 64, 3), np.float32),
         np.zeros((records,), np.int32)], names=("x", "y"))
    nbytes = sum(c.nbytes for c in chunk.cols)

    def timed(write_one, read_one):
        errs = []

        def consume():
            try:
                for _ in range(reps):
                    read_one()
            except Exception as e:  # noqa: BLE001 - surfaces as no-pick
                errs.append(e)

        t = threading.Thread(target=consume, daemon=True,
                             name="transport-probe-consumer")
        t0 = time.monotonic()
        t.start()
        for _ in range(reps):
            write_one()
        t.join(timeout=30)
        if t.is_alive() or errs:
            raise RuntimeError("probe leg failed: {}".format(
                errs[0] if errs else "consumer timeout"))
        return time.monotonic() - t0

    listener = None
    try:
        def shm_read():
            if ring.read_obj(timeout=10.0) is None:
                raise TimeoutError("ring read timed out")

        t_shm = timed(lambda: ring.write_obj(chunk, timeout=10.0), shm_read)

        # Queue leg: a raw TCP Connection pair over loopback — the same
        # pickle + TCP wire cost the manager-proxy path pays per chunk,
        # WITHOUT touching the live broker. Deliberately not manager
        # proxies: a BaseProxy plants an mp Finalize whose _decref does
        # blocking connect+challenge I/O at GC/exit time against this
        # process's own single-accepter server — under feed load that
        # wedged the accepter mid-Thread.start() and starved the
        # trainer's handshake (found via the deep-partition test).
        # A fresh authkey keeps the HMAC challenge on the pair (an
        # unauthenticated listener would unpickle whatever local peer
        # connected first), and SO_SNDTIMEO bounds the writes so a dead
        # consumer can't wedge bootstrap in send().
        import socket as _socket
        import struct as _struct
        from multiprocessing.connection import Client as _ConnClient
        from multiprocessing.connection import Listener as _Listener

        probe_key = os.urandom(16)
        listener = _Listener(("127.0.0.1", 0), authkey=probe_key)
        rconn_box = {}

        def _accept():
            rconn_box["c"] = listener.accept()

        # the authkey handshake is synchronous on BOTH ends, so accept
        # must already be in flight when Client() connects
        acceptor = threading.Thread(target=_accept, daemon=True,
                                    name="tfos-probe-accept")
        acceptor.start()
        wconn = _ConnClient(listener.address, authkey=probe_key)
        try:  # from here every exit path must close both pair ends
            acceptor.join(timeout=10)
            if "c" not in rconn_box:
                raise RuntimeError("probe pair handshake timed out")
            _socket.socket(fileno=os.dup(wconn.fileno())).setsockopt(
                _socket.SOL_SOCKET, _socket.SO_SNDTIMEO,
                _struct.pack("ll", 10, 0))

            def q_read():
                rconn_box["c"].recv()

            def q_write():
                wconn.send(chunk)

            t_queue = timed(q_write, q_read)
        finally:
            wconn.close()
            if "c" in rconn_box:
                rconn_box["c"].close()
    except Exception as e:  # noqa: BLE001 - probe is advisory
        logger.warning("transport probe failed (%s); keeping shm", e)
        return "shm", {"error": str(e)}
    finally:
        if listener is not None:
            try:
                listener.close()
            except Exception:  # noqa: BLE001
                pass

    rate = lambda t: round(reps * nbytes / t / 1e6, 1) if t > 0 else float("inf")  # noqa: E731,E501
    rates = {"shm_mb_s": rate(t_shm), "queue_mb_s": rate(t_queue)}
    choice = "shm" if t_shm <= 1.1 * t_queue else "queue"
    logger.info("feed transport probe: %s -> %s", rates, choice)
    return choice, rates


#: serializes same-process ring writers: the ring is SPSC, and an engine
#: that ever runs two feed tasks concurrently in one executor process
#: must not interleave gather-writes (the queue transport was implicitly
#: thread-safe; this keeps the ring equally safe).
_RING_WRITE_LOCK = threading.Lock()


def _ring_put(ring, obj, mgr, deadline, cancel=None):
    """shm-ring analog of _bounded_put: bounded writes + state checks.

    Frame-encodes once; retries move no bytes until space frees. A
    ``frames.FrameList`` coalesces several objects into one message
    (gather write — the tail-coalescing path). A frame too large for the
    ring (> capacity/2) de-coalesces first, then splits chunks
    record-wise and re-sends — semantics are unchanged since DataFeed
    re-slices chunks anyway."""
    from tensorflowonspark_tpu_torch import frames as frames_lib

    multi = isinstance(obj, frames_lib.FrameList)
    bufs = frames_lib.encode_multi(obj) if multi else frames_lib.encode(obj)
    while True:
        try:
            with _RING_WRITE_LOCK:
                ring.write_buffers(bufs, timeout=1.0)
            return
        except TimeoutError:
            if cancel is not None and cancel.is_set():
                raise RuntimeError("feed cancelled by consumer")
            if mgr.get("state") in ("terminating", "stopped", "error"):
                raise RuntimeError("feed aborted: node is terminating")
            if time.monotonic() > deadline:
                raise RuntimeError("feed timeout exceeded")
        except ValueError:
            if multi:
                for part in obj:
                    _ring_put(ring, part, mgr, deadline, cancel=cancel)
                return
            if isinstance(obj, frames_lib.ColumnarChunk) and len(obj) > 1:
                half = len(obj) // 2
                _ring_put(ring, obj.slice(0, half), mgr, deadline,
                          cancel=cancel)
                _ring_put(ring, obj.slice(half, len(obj)), mgr, deadline,
                          cancel=cancel)
                return
            raise RuntimeError(
                "feed record does not fit the shm ring; raise "
                "TFOS_SHM_CAPACITY or lower FEED_CHUNK")


def _join_feed(mgr, qname, feed_timeout, on_error="return"):
    """Wait (bounded) for the queue to drain; never hang on a dead trainer.

    The reference's feeder does a bare ``queue.join()`` — correct while the
    trainer lives, a permanent hang when it died mid-batch. Here the join is
    chunked with state checks: trainer error/termination either returns
    (train path — the real traceback surfaces at ``shutdown()``) or raises
    (inference path — results can never arrive); feed_timeout still raises.
    """
    ring = _feed_ring(qname)

    def _drained():
        if ring is not None:
            return ring.wait_drained(timeout=1.0)
        return mgr.join_queue(qname, 1.0)

    deadline = time.monotonic() + feed_timeout
    while not _drained():
        state = mgr.get("state")
        if state in ("error", "terminating", "stopped"):
            if on_error == "raise":
                raise RuntimeError(
                    "feed incomplete: node state is {!r}".format(state))
            logger.warning("feed incomplete: node state is %r", state)
            return False
        if time.monotonic() > deadline:
            raise RuntimeError("feed timeout: partition not consumed within "
                               "{}s".format(feed_timeout))
    return True


def _put_chunk(q, chunk, mgr, deadline):
    _bounded_put(q, list(chunk), mgr, deadline)


def _bounded_put(q, item, mgr, deadline, cancel=None):
    """put with terminating-state + timeout checks (reference: abort if
    mgr state == 'terminating'; raise on feed_timeout -> task fail).
    The broker queues are bounded (manager.QUEUE_MAXSIZE), so queue.Full
    is the live backpressure path.

    Only ``queue.Full`` is retried — anything else (e.g. an unpicklable
    record) must surface immediately with its real traceback, not spin
    until a misleading 'feed timeout'.
    """
    while True:
        try:
            q.put(item, block=True, timeout=1.0)
            return
        except _queue.Full:
            if cancel is not None and cancel.is_set():
                raise RuntimeError("feed cancelled by consumer")
            if mgr.get("state") in ("terminating", "stopped", "error"):
                raise RuntimeError("feed aborted: node is terminating")
            if time.monotonic() > deadline:
                raise RuntimeError("feed timeout exceeded")


def inference(cluster_info, cluster_meta, feed_timeout=600, qname="output"):
    """Inference closure: push partition records, then pull exactly as many
    results as records pushed; yields result rows.

    Reference: ``TFSparkNode.inference`` → ``_inference`` (SURVEY.md §3.3):
    per-partition count/order is guaranteed by ``q_in.join()`` + counted
    ``q_out`` reads.
    """

    def _inference(iterator):
        mgr = _get_manager(cluster_info, cluster_meta, _local_executor_id())

        # Feed in a background thread and drain results HERE, concurrently:
        # feeding the whole partition before touching the output queue
        # (the reference's order) wedges once BOTH bounded queues fill —
        # trainer blocked on a full output queue, feeder blocked on a full
        # input queue — and only feed_timeout breaks the embrace.
        feed_state = {"count": None, "error": None}
        cancel = threading.Event()

        def _feed():
            try:
                n = _feed_partition(iterator, mgr, "input", feed_timeout,
                                    cancel=cancel)
                _join_feed(mgr, "input", feed_timeout, on_error="raise")
                feed_state["count"] = n
            except BaseException as e:  # noqa: BLE001 - re-raised below
                feed_state["error"] = e

        feeder = threading.Thread(target=_feed, name="inference-feed",
                                  daemon=True)
        feeder.start()

        q_out = mgr.get_queue(qname)
        results = []
        deadline = time.monotonic() + feed_timeout
        try:
            while True:
                if feed_state["error"] is not None:
                    raise feed_state["error"]
                count = feed_state["count"]
                if count is not None and len(results) >= count:
                    break
                try:
                    batch = q_out.get(block=True, timeout=1.0)
                except _queue.Empty:
                    if mgr.get("state") in ("error", "terminating",
                                            "stopped"):
                        raise RuntimeError(
                            "inference aborted: trainer terminated with "
                            "{}/{} results delivered".format(
                                len(results), count if count is not None
                                else "?"))
                    if count is None:
                        # Feeding still in progress: its OWN per-put
                        # deadline (_feed_partition) governs liveness.
                        # The drain deadline arms once the feed is done,
                        # preserving the pre-concurrency semantics for
                        # trainers that emit only at partition end.
                        deadline = time.monotonic() + feed_timeout
                    elif time.monotonic() > deadline:
                        raise RuntimeError("inference results timeout")
                    continue
                q_out.task_done()
                deadline = time.monotonic() + feed_timeout
                if isinstance(batch, list):
                    results.extend(batch)
                else:
                    results.append(batch)
        except BaseException:
            cancel.set()  # the feeder must not outlive a failed task
            raise
        feeder.join()
        if feed_state["error"] is not None:
            raise feed_state["error"]
        return iter(results[:feed_state["count"]])

    return _inference


def shutdown(cluster_info, cluster_meta, queues=("input",), grace_secs=0):
    """Shutdown closure, one per executor: surface trainer errors, stop the
    feed, join the background trainer.

    Reference: ``TFSparkNode.shutdown`` → ``_shutdown`` (SURVEY.md §3.5).
    Raises on the executor if the trainer pushed an error — the driver's
    ``cluster.shutdown()`` re-raises it (error-propagation contract).
    """

    def _shutdown(iterator):
        for _ in iterator:
            pass
        mgr = _get_manager(cluster_info, cluster_meta, _local_executor_id())
        # End-of-feed marker unblocks DataFeed.next_batch deterministically.
        # Bounded put: a full channel means the trainer stopped consuming —
        # it will see the state flip below instead.
        for qname in queues:
            ring = _feed_ring(qname)
            try:
                if ring is not None:
                    ring.write_obj(marker.EndFeed(), timeout=5.0)
                else:
                    mgr.get_queue(qname).put(marker.EndFeed(), block=True,
                                             timeout=5.0)
            except Exception:
                pass
        if mgr.get("state") == "running":
            mgr.set("state", "terminating")

        st = _state()
        proc = st.get("trainer_proc")
        we_terminated = False
        if proc is not None:
            # Progress-aware join: the grace window is a NO-PROGRESS bound,
            # not a wall-clock cap. While the trainer's DataFeed heartbeat
            # (kv "feed_hb", a batches-served counter) keeps advancing,
            # the deadline re-arms — a trainer slowly draining a deep feed
            # backlog (slow steps: big models, slow host-to-device copies)
            # is alive, not wedged: a hard 60s join would kill a live
            # trainer whose steps take seconds each. An explicit
            # grace_secs is authoritative (tests
            # use small ones); the 60s floor applies only to the default.
            # Hard floor of 5s regardless: the heartbeat is throttled to
            # one publish per 2s, so a window at or under the throttle
            # structurally cannot observe a live trainer's progress.
            grace = grace_secs if grace_secs and grace_secs > 0 else 60
            grace = max(grace, 5)
            def _hb():
                try:
                    return mgr.get("feed_hb")
                except Exception:  # noqa: BLE001 - broker may be gone
                    return None
            last_hb = _hb()
            deadline = time.monotonic() + grace
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                proc.join(timeout=min(2.0, remaining))
                if not proc.is_alive():
                    break
                hb = _hb()
                if hb is not None and hb != last_hb:
                    last_hb = hb
                    deadline = time.monotonic() + grace
            if proc.is_alive():
                logger.warning("trainer pid %d unresponsive (no feed "
                               "progress for %.0fs); terminating",
                               proc.pid, grace)
                we_terminated = True
                proc.terminate()
                proc.join(timeout=10)
                if proc.is_alive():
                    # SIGTERM can't be delivered to a process wedged in a
                    # C-level call (the very mode that gets here); leaking
                    # it would hold the card and the shm ring open.
                    logger.warning("trainer pid %d survived SIGTERM; "
                                   "killing", proc.pid)
                    proc.kill()
                    proc.join(timeout=5)
        tb_pid = st.get("tb_pid")
        if tb_pid:
            try:
                os.kill(tb_pid, 15)
            except OSError:
                pass
        ring = st.pop("shm_ring", None)
        if ring is not None:
            ring.unlink()
            ring.close()
        st.pop("cluster_id", None)

        # Error surfacing: anything on the error queue fails this task.
        errors = []
        try:
            eq = mgr.get_queue("error")
            while True:
                try:
                    errors.append(eq.get(block=False))
                    eq.task_done()
                except _queue.Empty:
                    break
        except Exception:
            pass
        # A trainer killed in the shutdown window can race the watchdog's
        # state check and report nothing — its exit code is still evidence.
        if (proc is not None and not errors and not we_terminated
                and proc.exitcode not in (0, None)):
            errors.append("trainer exited with code {} without reporting "
                          "an error (killed?)".format(proc.exitcode))

        # Final supervision beat, SYNCHRONOUS and best-effort: popping
        # cluster_id above silenced the beat thread, and a failure whose
        # whole window (crash -> this teardown) fits inside one beat
        # interval would otherwise never ride a beat at all — the
        # supervisor would see only an unattributable shutdown error.
        # This task is still running, so the driver's shutdown .get() is
        # still blocked and the reservation server is provably alive:
        # the terminal evidence (state, exit code) lands in the lease
        # BEFORE the error below reaches the driver.
        try:
            exit_code = None if proc is None else proc.exitcode
            # bounded connect: "provably alive" above assumes
            # the driver is healthy — a CRASHED reservation server
            # must not wedge executor teardown for the OS timeout
            fc = reservation.Client(tuple(cluster_meta["server_addr"]),
                                    connect_timeout=5)
            try:
                # the FULL payload, not a minimal one: a beat REPLACES
                # the lease payload wholesale, and the goodput plane's
                # driver-side harvest reads the metrics snapshot off
                # the LAST lease — a final beat that dropped "metrics"
                # would erase the trainer's final accounting flush
                payload = _beat_payload(mgr, _local_executor_id())
                payload.update({
                    "trainer_exit": exit_code,
                    "trainer_alive": False if proc is not None else None,
                    "final": True, "errors": len(errors)})
                fc.beat(_local_executor_id(), payload)
            finally:
                fc.close()
        except Exception:  # noqa: BLE001 - server may already be gone
            pass

        if errors:
            raise RuntimeError(
                "trainer on executor {} failed:\n{}".format(
                    _local_executor_id(), "\n---\n".join(str(e) for e in errors)))

    return _shutdown
