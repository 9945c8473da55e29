"""Per-executor queue broker: the process-boundary bridge of the feed
plane — the port's copy of ``tensorflowonspark_tpu/manager.py``.

Reference: ``tensorflowonspark/TFManager.py`` (SURVEY.md §2 "Queue broker"):
a ``multiprocessing.managers.BaseManager`` serving one joinable queue per
canonical name ('input', 'output', 'error') plus a shared k/v dict (cluster
state machine: 'running' | 'terminating' | 'stopped'), authkey-protected,
bound to localhost ('local' mode) or the executor's routable IP ('remote'
mode, for engines that run worker processes on other hosts).

This broker bridges the *feeder* process (runs data tasks, owns no device) and
the *trainer* process (runs the user map_fun, owns the card). Throughput
fix (SURVEY.md §7.3 "Feed throughput"): queue items are batches
(lists of records), assembled feeder-side — the reference's per-record
manager-proxy round trip is its known bottleneck and is deliberately not
reproduced. The manager proxy then costs one round trip per *chunk*, and
``DataFeed`` re-slices chunks to the requested batch size.
"""

import logging
import os
import queue as _queue
import threading
from multiprocessing.managers import BaseManager

logger = logging.getLogger(__name__)

# Canonical queue names (reference: TFSparkNode.run's `queues` default).
QUEUES_TRAIN = ["input", "error"]
QUEUES_INFERENCE = ["input", "output", "error"]


class _KV(object):
    """Lock-protected k/v store (cluster state machine + endpoint info)."""

    def __init__(self):
        self._d = {}
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            return self._d.get(key)

    def set(self, key, value):
        with self._lock:
            self._d[key] = value


class _Control(object):
    """Server-side helper: queue operations the stock proxy lacks.

    ``join(qname, timeout)`` is the load-bearing one: a feeder must be able
    to wait for its partition to be consumed *without* blocking forever when
    the trainer has died (the reference's bare ``queue.join()`` can hang
    exactly that way; SURVEY.md §5 failure-detection notes feed timeouts as
    the mitigation — this makes the timeout enforceable during the join).
    """

    def __init__(self, qdict):
        self._qdict = qdict

    def join(self, qname, timeout):
        """True once all items put to ``qname`` were task_done'd."""
        import time as _time
        q = self._qdict[qname]
        deadline = _time.monotonic() + timeout
        with q.all_tasks_done:
            while q.unfinished_tasks:
                left = deadline - _time.monotonic()
                if left <= 0:
                    return False
                q.all_tasks_done.wait(left)
        return True


class _ManagerBase(BaseManager):
    pass


class ManagerClient(object):
    """Handle to a broker, same API surface as the reference's TFManager.

    ``get_queue(name)`` returns a shared joinable-queue proxy (put/get/
    task_done/join/qsize/empty all forwarded); ``get``/``set`` hit the shared
    k/v store. Proxies are cached per name — manager round trips are per
    *operation*, not per lookup.
    """

    def __init__(self, mgr, address, authkey, local=None):
        self._mgr = mgr
        self.address = tuple(address)
        self.authkey = authkey
        self._kv = None
        self._control = None
        self._qcache = {}
        self._lock = threading.Lock()
        # In-process fast path: when the broker server runs in THIS process
        # (manager.start), ``local`` carries the real (qdict, kv, control)
        # objects and every operation is a direct call — no proxy pickling,
        # no TCP round trip. The reference pays a manager-proxy hop even
        # for same-process access (TFManager 'local' mode); on a feed plane
        # moving tens of MB per chunk that hop is measurable, so it's gone.
        # The fork-safety note: a forked child inherits a COPY of these
        # objects, so children must never reuse an inherited client —
        # node.py's trainer always reconnects via (address, authkey).
        self._local_pid = os.getpid() if local else None
        self._local = local

    def _use_local(self):
        return self._local is not None and os.getpid() == self._local_pid

    def get_queue(self, qname):
        if self._use_local():
            return self._local[0][qname]
        with self._lock:
            if qname not in self._qcache:
                self._qcache[qname] = self._mgr.get_queue(qname)
            return self._qcache[qname]

    def _kv_proxy(self):
        with self._lock:
            if self._kv is None:
                self._kv = self._mgr.get_kv()
            return self._kv

    def get(self, key):
        if self._use_local():
            return self._local[1].get(key)
        return self._kv_proxy().get(key)

    def set(self, key, value):
        if self._use_local():
            return self._local[1].set(key, value)
        return self._kv_proxy().set(key, value)

    def join_queue(self, qname, timeout):
        """Bounded-wait queue join; True if fully consumed (see _Control)."""
        if self._use_local():
            return self._local[2].join(qname, timeout)
        with self._lock:
            if self._control is None:
                self._control = self._mgr.get_control()
            control = self._control
        return control.join(qname, timeout)


#: Max chunks buffered per DATA (input-like) queue. Bounded so (a) a
#: feeder ahead of the trainer backpressures instead of ballooning
#: broker RAM, and (b) the queue.Full path in the feed closures (state
#: checks, feed_timeout) is live. Sized for COLUMNAR chunks
#: (node.FEED_CHUNK=256 records — a 224px uint8 image chunk is ~38MB):
#: 16 chunks ≈ 600MB ceiling and ~16 device batches of runway.
QUEUE_MAXSIZE = 16

#: Output/error queues hold small result rows, not bulk frames, and the
#: inference pattern feeds the WHOLE partition before draining results
#: (node._inference) — so they get a deep bound: a shallow one would
#: wedge trainer batch_results against the input backpressure until
#: feed_timeout.
RESULT_QUEUE_MAXSIZE = 256


def start(authkey, queues, mode="local", host=None, maxsize=QUEUE_MAXSIZE):
    """Start a broker server in a daemon thread of *this* process.

    Returns a connected :class:`ManagerClient` (``.address`` is the
    endpoint to publish via the reservation meta). Reference:
    ``TFManager.start(authkey, queues, mode)``.

    The reference spawns the manager as a forked server process so it
    survives Spark's python-worker recycling; our engine's executor
    processes are long-lived, so a daemon server thread suffices and dies
    with the node — one less orphan to reap on task retry.
    """
    qdict = {name: _queue.Queue(
        maxsize=RESULT_QUEUE_MAXSIZE if name in ("output", "error")
        else maxsize) for name in queues}
    kv = _KV()
    kv.set("state", "running")

    class _Server(_ManagerBase):
        pass

    # Registered callables return *proxies* to server-held objects — exactly
    # right for the shared queues and the kv store. Value-returning calls
    # (kv.get) happen as proxy *method* calls, which return real values.
    control = _Control(qdict)
    _Server.register("get_queue", callable=lambda qname: qdict[qname])
    _Server.register("get_kv", callable=lambda: kv)
    _Server.register("get_control", callable=lambda: control)

    if mode == "remote":
        if host is None:
            from tensorflowonspark_tpu_torch.util import get_ip_address
            host = get_ip_address()
        address = (host, 0)
    else:
        address = ("127.0.0.1", 0)

    mgr = _Server(address=address, authkey=authkey)
    server = mgr.get_server()
    # tfos: unjoined(process-lifetime queue broker; serve_forever ends with the executor process)
    threading.Thread(target=server.serve_forever, name="tfmanager-server",
                     daemon=True).start()
    # get_server() binds immediately, so server.address is final here.
    client = connect(server.address, authkey,
                     local=(qdict, kv, control))
    logger.info("queue broker listening at %s (mode=%s)", server.address, mode)
    return client


def connect(address, authkey, local=None):
    """Connect to a broker from a sibling process.

    Reference: ``TFManager.connect(addr, authkey)``. Callers in freshly
    spawned processes must first set
    ``multiprocessing.current_process().authkey`` (the node runtime does).
    ``local`` is manager.start's same-process fast path — see
    :class:`ManagerClient`.
    """

    class _Client(_ManagerBase):
        pass

    _Client.register("get_queue")
    _Client.register("get_kv")
    _Client.register("get_control")
    mgr = _Client(address=tuple(address), authkey=authkey)
    mgr.connect()
    return ManagerClient(mgr, address, authkey, local=local)
