"""Cluster-formation barrier + service discovery (the control plane) —
the port's copy of ``tensorflowonspark_tpu/reservation.py``.

Reference: ``tensorflowonspark/reservation.py`` (SURVEY.md §2 "Reservation
service"): a zero-dependency TCP rendezvous hosted on the driver. Every
executor registers its node metadata (host, ports, authkey, role); everyone
blocks until exactly N registrations exist; then every node can fetch the
full cluster_info list. Message types REG / QUERY / QINFO / STOP.

Differences from the reference's design:

- Wire format is length-prefixed JSON, not pickle: registration messages
  cross trust boundaries (any process that can reach the port), and the
  driver must never unpickle executor-supplied bytes. Binary fields
  (authkeys) travel hex-encoded.
- The barrier's output doubles as the *collective bootstrap*: once all
  N nodes are registered, node metas are sorted deterministically and the
  chief's (host, coordinator_port) becomes the
  ``torch.distributed.init_process_group`` address — the piece
  ``TF_CONFIG`` provided in the reference.
- The service stays up after the barrier opens and carries the
  *supervision plane* (supervisor.py): BEAT messages register per-executor
  heartbeat leases (liveness + a small status payload the driver-side
  Supervisor classifies), and ACK messages record fed partitions as
  consumed so a restart-from-checkpoint recovery replays only the
  unacknowledged ones. The same BEAT leases carry the *fleet plane*
  (fleet.py): serving replicas beat with ``role: "serving"`` payloads
  (HTTP address + live load gauges + engine metrics snapshot), which
  :meth:`Server.serving_snapshot` exposes to the FleetRouter's
  least-loaded dispatch and the ``/stats`` replica view. With a
  ``journal`` (``controlstate.ControlJournal``) the lease and control
  epochs are durable across a server restart. The reference's server
  spoke only
  REG/QUERY/QINFO/STOP and went idle after formation (SURVEY.md §5: no
  failure detection beyond Spark task retry).

"""

import json
import logging
import socket
import struct
import threading
import time

from tensorflowonspark_tpu_torch import chaos, tracing

logger = logging.getLogger(__name__)

#: Default seconds to wait for all nodes to register (reference default 600).
DEFAULT_TIMEOUT = 600

#: Default seconds a STARTED message may take to finish arriving before
#: the server gives up on the connection (see MessageSocket). Idle time
#: BETWEEN messages is never bounded — only a half-open / wedged peer
#: that stalled mid-message trips this.
DEFAULT_RECV_DEADLINE = 30.0

_LEN = struct.Struct(">I")
_MAX_MSG = 16 * 1024 * 1024


class TimeoutError_(RuntimeError):
    """Barrier did not complete within the timeout."""


class Fenced(RuntimeError):
    """This beater's lease epoch is STALE: another holder registered
    for the same identity after it (typically: a replacement spawned
    while this one was partitioned away). NON-retriable by design —
    re-beating harder cannot make a superseded lease current; the only
    way back is an explicit re-registration (``Client.lease``), which
    is an operator/supervisor decision, not a retry loop's."""

    def __init__(self, msg, epoch=None):
        super(Fenced, self).__init__(msg)
        #: the CURRENT epoch held by the replacement (None if unknown)
        self.epoch = epoch


class Reservations(object):
    """Thread-safe registry counting up to ``required`` node registrations.

    Reference: ``reservation.Reservations`` — lock-protected list + count.
    """

    def __init__(self, required):
        self.required = required
        self._lock = threading.Condition()
        self._meta = []

    def add(self, meta):
        """Register one node; a re-registration (retried worker) with the
        same executor_id *replaces* the stale entry — it must not double
        count, or the barrier opens early and the sorted-index == process-
        index contract breaks."""
        with self._lock:
            eid = meta.get("executor_id")
            for i, m in enumerate(self._meta):
                if eid is not None and m.get("executor_id") == eid:
                    self._meta[i] = meta
                    break
            else:
                self._meta.append(meta)
            if self.done():
                self._lock.notify_all()

    def done(self):
        return len(self._meta) >= self.required

    def get(self):
        with self._lock:
            return list(self._meta)

    def remaining(self):
        with self._lock:
            return self.required - len(self._meta)

    def wait(self, timeout=DEFAULT_TIMEOUT):
        deadline = time.monotonic() + timeout
        with self._lock:
            while not self.done():
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError_(
                        "timed out waiting for {} of {} node reservations".format(
                            self.required - len(self._meta), self.required))
                self._lock.wait(left)
            return list(self._meta)


class MessageSocket(object):
    """Length-prefixed JSON messages over a stream socket.

    Reference: ``reservation.MessageSocket`` (which framed *pickled* payloads
    — deliberately not reproduced; see module docstring).

    ``recv_deadline`` bounds how long a message that has STARTED
    arriving may take to finish: once any byte of a frame is in, the
    rest (header remainder + body) must land within the deadline or the
    read fails with ``ConnectionError``. Waiting for the FIRST byte of
    the next message stays unbounded — an idle-but-healthy peer (a
    registered client between beats) is normal, but a half-open TCP
    peer that died mid-frame used to wedge the server's handler thread
    in ``recv`` forever. The server arms this on every accepted
    connection (:data:`DEFAULT_RECV_DEADLINE`); clients default to
    unbounded for compatibility.

    ``net_src``/``net_dst`` label this socket's exchanges for the
    chaos network fault plane (``chaos.on_net``); unlabeled sockets
    only match fully-wildcarded injections.
    """

    def __init__(self, sock, recv_deadline=None):
        self.sock = sock
        self.recv_deadline = recv_deadline
        self.net_src = None
        self.net_dst = None

    def send(self, msg):
        data = json.dumps(msg, separators=(",", ":")).encode("utf-8")
        frame = _LEN.pack(len(data)) + data
        if chaos.net_armed():
            # instrumented transport site: may raise NetPartitioned
            # (a ConnectionError — callers treat it like a real one)
            # or sleep (net_delay). A one-way send can't lose a
            # response alone, so every loss here is request-side
            # (response_capable=False); and a "dup" action is IGNORED
            # — this is a framed request/response stream over TCP,
            # where the transport cannot duplicate a frame, and
            # re-sending one here would desynchronize the protocol
            # (the peer answers twice, every later call reads the
            # previous call's reply). net_dup models duplicated
            # EXCHANGES, which only the HTTP transport can express.
            chaos.on_net(self.net_src, self.net_dst)
        self.sock.sendall(frame)

    def receive(self):
        header = self._recv_exact(_LEN.size)
        (length,) = _LEN.unpack(header)
        if length > _MAX_MSG:
            raise ValueError("reservation message too large: {} bytes".format(length))
        return json.loads(
            self._recv_exact(length, mid_message=True).decode("utf-8"))

    def _recv_exact(self, n, mid_message=False):
        """Read exactly ``n`` bytes. ``mid_message``: part of the frame
        already arrived, so the whole read is deadline-bounded from
        entry; otherwise the deadline arms only once the first chunk
        lands (waiting for a message to BEGIN is idle, not a stall)."""
        buf = bytearray()
        deadline = None
        if mid_message and self.recv_deadline is not None:
            deadline = time.monotonic() + self.recv_deadline
        while len(buf) < n:
            if deadline is None and buf and self.recv_deadline is not None:
                deadline = time.monotonic() + self.recv_deadline
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise ConnectionError(
                        "reservation peer stalled mid-message "
                        "({}/{} bytes after {}s)".format(
                            len(buf), n, self.recv_deadline))
                self.sock.settimeout(left)
                try:
                    chunk = self.sock.recv(n - len(buf))
                except socket.timeout:
                    raise ConnectionError(
                        "reservation peer stalled mid-message "
                        "({}/{} bytes after {}s)".format(
                            len(buf), n, self.recv_deadline))
                finally:
                    self.sock.settimeout(None)
            else:
                chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("reservation peer closed connection")
            buf.extend(chunk)
        return bytes(buf)

    def close(self):
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class Server(object):
    """Driver-hosted rendezvous server.

    Reference: ``reservation.Server`` — ``start()`` binds an ephemeral port,
    a background thread serves REG/QUERY/QINFO/STOP until stopped.
    """

    def __init__(self, count, recv_deadline=DEFAULT_RECV_DEADLINE,
                 journal=None, recovery_grace=5.0):
        self.reservations = Reservations(count)
        #: mid-message receive deadline armed on every accepted
        #: connection (see MessageSocket) — a half-open peer fails its
        #: handler thread in bounded time instead of wedging it forever
        self.recv_deadline = recv_deadline
        self._sock = None
        self._thread = None
        self._stats_httpd = None
        #: (host, port) of the driver-side stats HTTP endpoint
        #: (/metrics + /stats), set by start(); None if it failed
        self.stats_addr = None
        self.done = threading.Event()
        # supervision plane: heartbeat leases + consumed-partition acks
        # (read by supervisor.Supervisor, which runs in this process)
        self._sup_lock = threading.Lock()
        self._leases = {}   # executor_id -> (monotonic recv time, payload)
        # lease fencing: identity -> current epoch, minted
        # monotonically by LEASE messages. Once an identity has an
        # epoch, only beats carrying the CURRENT epoch refresh its
        # lease; anything else is answered FENCED and dropped — a
        # replica re-beating after a partition healed cannot overwrite
        # its replacement's lease (the split-brain double-serve window)
        self._epochs = {}
        self._acked = set()  # partition ids fully consumed by a trainer
        # elastic-resize bookkeeping (ONE source of truth for width:
        # SupervisedCluster sets these at every formation, so /metrics
        # and /stats show the live attempt's width vs the configured
        # target — a shrunken job is visibly degraded, not implicit in
        # Decision.exclude set arithmetic)
        self._cluster_width = None
        self._cluster_width_target = None
        # durable safety floors: when a journal is attached,
        # every minted epoch hits disk BEFORE it leaves the building,
        # and a restarted server seeds its mint state from the
        # journal's floors — monotonicity survives restart by
        # construction. `journal` accepts a ControlJournal or a path.
        if isinstance(journal, str):
            from tensorflowonspark_tpu_torch import controlstate
            journal = controlstate.ControlJournal(journal)
        self.journal = journal
        self._control_epoch = 0
        #: identities whose floors came from the journal but whose
        #: incumbents have not re-announced yet (recovery tracking)
        self._awaiting_reannounce = set()
        self._recovery_grace = float(recovery_grace)
        self._recovery_deadline = None  # armed by start() when recovering
        #: cumulative BEAT messages handled (guarded by _sup_lock) —
        #: drives the kill_reservation_server chaos site
        self._beats_seen = 0
        if journal is not None:
            floors = journal.epoch_floors()
            if floors:
                self._epochs.update(floors)
                self._awaiting_reannounce = set(floors)
            self._control_epoch = journal.control_floor()

    def lease_snapshot(self):
        """{executor_id: {"age": seconds since last beat, "payload": ...}}
        — the supervisor's raw liveness view."""
        now = time.monotonic()
        with self._sup_lock:
            return {eid: {"age": now - t, "payload": dict(payload)}
                    for eid, (t, payload) in self._leases.items()}

    def acked_partitions(self):
        """Partition ids acknowledged as fully consumed (stable copy)."""
        with self._sup_lock:
            return set(self._acked)

    def lease_epoch(self, executor_id):
        """The CURRENT minted epoch for ``executor_id`` (None when the
        identity never acquired one — legacy epoch-less beats)."""
        with self._sup_lock:
            return self._epochs.get(executor_id)

    def mint_epoch(self, executor_id):
        """Mint the next lease epoch for ``executor_id`` and make it
        current — every outstanding older epoch is fenced from this
        moment. The server-side half of ``Client.lease``; also callable
        in-process (the supervisor spawning a replacement replica
        fences the incumbent BEFORE the replacement's first beat).

        With a journal attached, the epoch is fsync'd durable BEFORE
        it becomes current or is returned: a crash landed anywhere
        after the journal write leaves the recovered floor >= every
        epoch any caller ever saw (the safe direction — a floor may
        exceed reality, never trail it)."""
        with self._sup_lock:
            epoch = self._epochs.get(executor_id, 0) + 1
            if self.journal is not None:
                # persist-before-publish: holding _sup_lock through
                # the fsync serializes mints against the journal, so
                # no later mint can return before an earlier one is
                # durable
                self.journal.record_epoch(executor_id, epoch)
            self._epochs[executor_id] = epoch
            self._awaiting_reannounce.discard(executor_id)
        logger.info("lease epoch %d minted for %r", epoch, executor_id)
        return epoch

    def mint_control_epoch(self):
        """Mint the next CONTROL epoch — the admin-plane fencing
        token. A router taking over leadership mints one and stamps
        every admin RPC with it; replicas refuse writes below their
        observed floor (409), so a deposed leader's late writes land
        nowhere. Journal-backed like lease epochs: durable before
        returned, monotonic across server restarts by construction."""
        with self._sup_lock:
            epoch = self._control_epoch + 1
            if self.journal is not None:
                self.journal.record_control(epoch)
            self._control_epoch = epoch
        logger.info("control epoch %d minted", epoch)
        return epoch

    def control_epoch(self):
        """The highest minted control epoch (0 = never minted)."""
        with self._sup_lock:
            return self._control_epoch

    def recovering(self):
        """True while this server is a journal-seeded restart whose
        incumbents have not all re-announced and the recovery grace
        window is still open. Supervisor/autoscaler dead-lease
        classification gates on this: right after a restart the lease
        table is EMPTY by construction (replicas re-populate it via
        their next beats), and classifying that emptiness as fleet
        death would trigger a pointless mass-replacement storm."""
        with self._sup_lock:
            if not self._awaiting_reannounce:
                return False
            if self._recovery_deadline is None:
                return True  # start() not called yet — still cold
            if time.monotonic() >= self._recovery_deadline:
                # grace expired: whoever never re-announced really is
                # gone; let the supervisor/autoscaler see it
                self._awaiting_reannounce.clear()
                return False
            return True

    def drop_lease(self, identity):
        """Remove ``identity``'s lease (deliberate deregistration — a
        retired serving replica must vanish from ``serving_snapshot``
        rather than linger as an ever-aging corpse the autoscaler would
        keep counting). The identity's EPOCH is kept: a zombie beat
        from a stop RPC that never landed re-creates nothing — the
        retirer minted a fresh epoch first, so the zombie is answered
        FENCED and latches itself. Returns True when a lease was
        dropped."""
        with self._sup_lock:
            dropped = self._leases.pop(identity, None) is not None
        if dropped:
            logger.info("lease for %r dropped (deregistered)", identity)
        return dropped

    def set_cluster_width(self, width, target=None):
        """Publish this formation's width (and the job's configured
        target width) for the driver-side /metrics and /stats views —
        ``tfos_cluster_width`` / ``tfos_cluster_width_target``."""
        with self._sup_lock:
            self._cluster_width = None if width is None else int(width)
            if target is not None:
                self._cluster_width_target = int(target)

    def cluster_gauges(self):
        """{family: value} of the width gauges (only those set)."""
        with self._sup_lock:
            out = {}
            if self._cluster_width is not None:
                out["tfos_cluster_width"] = self._cluster_width
            if self._cluster_width_target is not None:
                out["tfos_cluster_width_target"] = \
                    self._cluster_width_target
            if self._control_epoch:
                out["tfos_control_epoch"] = self._control_epoch
            if self.journal is not None:
                out["tfos_control_recovery_pending"] = \
                    len(self._awaiting_reannounce)
            return out

    def serving_snapshot(self):
        """{replica_id: serving-replica view} from leases whose BEAT
        payload declares ``role: "serving"`` — the fleet plane
        (fleet.py): each view carries the lease age, the replica's
        advertised HTTP address, its model name, the live load gauges
        (``serving``: queue depth / slot occupancy / queue-wait EWMA /
        alive / draining, see ``DecodeEngine.load_stats``), and the
        beat-piggybacked engine registry snapshot (``metrics``). The
        FleetRouter's least-loaded dispatch and per-replica /metrics
        labels both read this; ``GET /stats`` exposes it as the
        ``serving`` key."""
        out = {}
        for eid, lease in self.lease_snapshot().items():
            payload = lease["payload"]
            if payload.get("role") != "serving":
                continue
            out[str(eid)] = {
                "age": round(lease["age"], 3),
                "addr": payload.get("addr"),
                "model": payload.get("model"),
                "epoch": payload.get("epoch"),
                "serving": payload.get("serving") or {},
                "metrics": payload.get("metrics"),
                # executor-hosted replicas: where this replica
                # actually runs ({"executor": id, "pid": n}) — the
                # replica_id -> host join the autoscaler places by and
                # the router's replica_host info gauge renders; absent
                # for driver-local replicas
                "host": payload.get("host"),
            }
        return out

    def metrics_snapshot(self):
        """{executor_id: per-executor observability view} from the
        latest BEAT payloads: the beat-piggybacked MetricsRegistry
        snapshot (feed stages + counters), the train-step and
        feed-progress gauges, node state, and lease age. The raw
        material for ``cluster.metrics()`` (merged via
        ``tracing.cluster_rollup``) and the driver-side ``/metrics``
        exposition."""
        out = {}
        for eid, lease in self.lease_snapshot().items():
            payload = lease["payload"]
            out[eid] = {"metrics": payload.get("metrics"),
                        "train_step": payload.get("train_step"),
                        "feed_hb": payload.get("feed_hb"),
                        "state": payload.get("state"),
                        "age": round(lease["age"], 3)}
        return out

    def start(self, host=None, port=0):
        """Bind and serve in the background; returns (host, port).

        ``port`` (default ephemeral) lets a RESTARTED server rebind
        its predecessor's advertised port, so replicas reconnecting to
        the address they already hold find the new incarnation without
        re-discovery (headless-fleet recovery)."""
        if host is None:
            from tensorflowonspark_tpu_torch.util import get_ip_address
            host = get_ip_address()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # Bind the wildcard so both loopback (local tests) and the routable
        # interface (real executors) can connect; advertise the routable host.
        self._sock.bind(("", int(port)))
        self._sock.listen(64)
        port = self._sock.getsockname()[1]
        self.addr = (host, port)
        with self._sup_lock:
            if self._awaiting_reannounce:
                self._recovery_deadline = \
                    time.monotonic() + self._recovery_grace
        self._thread = threading.Thread(target=self._serve, name="reservation-server",
                                        daemon=True)
        self._thread.start()
        self._start_stats_http()
        logger.info("reservation server listening at %s (stats http %s)",
                    self.addr, self.stats_addr)
        return self.addr

    def _start_stats_http(self):
        """Tiny driver-side observability endpoint next to the TCP
        rendezvous port: ``GET /metrics`` renders the cluster's
        beat-piggybacked metrics in OpenMetrics text (per-executor
        ``executor``-labeled series — scrape the driver and the whole
        fleet is visible), ``GET /stats`` the same view as JSON.
        Best-effort: a bind failure logs and leaves ``stats_addr``
        None rather than failing cluster formation."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                from tensorflowonspark_tpu_torch import goodput
                if self.path == "/metrics":
                    code, ctype = 200, tracing.OPENMETRICS_CONTENT_TYPE
                    # goodput plane: annotate per-executor step-time
                    # skew vs the fleet median so the exposition
                    # carries tfos_train_step_skew{executor=...}
                    body = tracing.render_cluster(
                        goodput.attach_step_skew(
                            server.metrics_snapshot()),
                        cluster_gauges=server.cluster_gauges()) \
                        .encode("utf-8")
                elif self.path == "/stats":
                    code, ctype = 200, "application/json"
                    stats = tracing.cluster_rollup(
                        goodput.attach_step_skew(
                            server.metrics_snapshot()))
                    # elastic resize: live width vs configured target
                    gauges = server.cluster_gauges()
                    stats["cluster"]["width"] = gauges.get(
                        "tfos_cluster_width")
                    stats["cluster"]["width_target"] = gauges.get(
                        "tfos_cluster_width_target")
                    # fleet plane: per-replica serving view (lease age,
                    # addr, load gauges) keyed by replica_id — the
                    # operator's "what is the router seeing" endpoint.
                    # The registry snapshot is dropped from this JSON
                    # view (it is /metrics' job, rendered per-replica)
                    stats["serving"] = {
                        rid: {k: v for k, v in view.items()
                              if k != "metrics"}
                        for rid, view in
                        server.serving_snapshot().items()}
                    body = json.dumps(stats).encode("utf-8")
                else:
                    code, ctype = 404, "application/json"
                    body = json.dumps(
                        {"error": "not found: %s" % self.path}) \
                        .encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # quiet by default
                logger.debug("stats http: " + fmt, *args)

        try:
            httpd = ThreadingHTTPServer(("", 0), Handler)
        except OSError as e:
            logger.warning("driver stats endpoint failed to start: %s", e)
            with self._sup_lock:
                self._stats_httpd = None
            self.stats_addr = None
            return
        with self._sup_lock:
            self._stats_httpd = httpd
        self.stats_addr = (self.addr[0], httpd.server_address[1])
        # tfos: unjoined(stop() shuts the httpd down; serve_forever returns and the daemon exits)
        threading.Thread(target=httpd.serve_forever,
                         name="reservation-stats-http",
                         daemon=True).start()

    def _serve(self):
        while not self.done.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break  # listening socket closed by stop()
            # tfos: unjoined(one daemon per connection, bounded by recv_deadline; ends at socket close)
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True, name="tfos-resv-conn").start()

    def _handle(self, conn):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        ms = MessageSocket(conn, recv_deadline=self.recv_deadline)
        try:
            while not self.done.is_set():
                msg = ms.receive()
                mtype = msg.get("type")
                if mtype == "REG":
                    self.reservations.add(msg["meta"])
                    ms.send({"type": "OK"})
                elif mtype == "QUERY":
                    ms.send({"type": "STATE", "done": self.reservations.done()})
                elif mtype == "QINFO":
                    ms.send({"type": "INFO", "meta": self.reservations.get(),
                             "done": self.reservations.done()})
                elif mtype == "LEASE":
                    eid = msg.get("executor_id")
                    ms.send({"type": "LEASE", "executor_id": eid,
                             "epoch": self.mint_epoch(eid)})
                elif mtype == "BEAT":
                    eid = msg.get("executor_id")
                    epoch = msg.get("epoch")
                    payload = msg.get("payload") or {}
                    with self._sup_lock:
                        self._beats_seen += 1
                        beats_seen = self._beats_seen
                        current = self._epochs.get(eid)
                        if current is None and epoch is not None:
                            # headless-fleet recovery: a server
                            # that never minted for this identity (cold
                            # start, or journal deliberately moved
                            # aside) ADOPTS the replica's announced
                            # epoch as current — the replicas are the
                            # source of truth for their own leases. A
                            # journal-seeded restart never lands here:
                            # its floors cover every epoch ever minted,
                            # so `current` is the floor and a matching
                            # re-announce re-registers the SAME epoch.
                            self._epochs[eid] = int(epoch)
                            if self.journal is not None:
                                self.journal.record_epoch(eid, epoch)
                            current = int(epoch)
                            logger.info(
                                "adopted announced epoch %d for %r",
                                current, eid)
                        fenced = current is not None and epoch != current
                        if not fenced:
                            if epoch is not None:
                                # the lease view carries its epoch, so
                                # snapshots/routers can see which
                                # incarnation is current
                                payload = dict(payload, epoch=epoch)
                            self._leases[eid] = (time.monotonic(), payload)
                            self._awaiting_reannounce.discard(eid)
                    # chaos site: kill_reservation_server=N
                    # crashes the server at the N-th BEAT, AFTER the
                    # lease-table write but BEFORE the reply — the
                    # SIGKILL-between-state-and-ack window the journal
                    # property test pins (the beater sees only a dead
                    # socket, exactly as a real kill looks)
                    if chaos.on_reservation_beat(beats_seen):
                        self.crash()
                        return  # no reply: the kill ate it
                    if fenced:
                        # the stale beat must NOT refresh the lease —
                        # the replacement's is the live one — and the
                        # beater must learn it is superseded
                        logger.warning(
                            "fencing stale beat from %r (epoch %r, "
                            "current %r)", eid, epoch, current)
                        ms.send({"type": "FENCED", "executor_id": eid,
                                 "epoch": current})
                    else:
                        ms.send({"type": "OK"})
                elif mtype == "ACK":
                    with self._sup_lock:
                        self._acked.add(msg.get("partition"))
                    ms.send({"type": "OK"})
                elif mtype == "ACKS":
                    with self._sup_lock:
                        acked = sorted(self._acked)
                    ms.send({"type": "ACKS", "partitions": acked})
                elif mtype == "STOP":
                    self.done.set()
                    self._close_listener()  # unblock _serve's accept()
                    ms.send({"type": "OK"})
                else:
                    ms.send({"type": "ERR", "error": "unknown type {!r}".format(mtype)})
        except (ConnectionError, ValueError, OSError):
            pass
        finally:
            ms.close()

    def await_reservations(self, timeout=DEFAULT_TIMEOUT, status=None):
        """Block until all N nodes registered; returns sorted cluster_info.

        ``status`` is an optional zero-arg callable polled for early-abort
        (the reference passes the SparkContext to notice cancelled jobs).
        """
        deadline = time.monotonic() + timeout
        while not self.reservations.done():
            if status is not None:
                status()
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError_(
                    "timed out waiting for {} node registrations".format(
                        self.reservations.remaining()))
            try:
                self.reservations.wait(min(left, 1.0))
            except TimeoutError_:
                continue
        return sort_cluster_info(self.reservations.get())

    def _close_listener(self):
        if self._sock is not None:
            # shutdown() BEFORE close(): on Linux, close() alone does
            # not wake a thread blocked in accept() — the serve thread
            # would sit there until stop()'s 5s join timeout expired,
            # a teardown tax every cluster/fleet spin paid. shutdown()
            # on a listening socket raises ENOTCONN on some platforms
            # (harmless) but reliably unblocks accept() here.
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass

    def stop(self):
        self.done.set()
        self._close_listener()
        with self._sup_lock:
            httpd, self._stats_httpd = self._stats_httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.journal is not None:
            self.journal.close()

    def crash(self):
        """Chaos only: die the way a SIGKILLed driver process
        looks from outside — listener gone mid-conversation, no STOP
        handshake, no replies to in-flight messages, no thread joins.
        Every lease, epoch, and ack in MEMORY is lost exactly as a
        real kill loses them; only the journal's fsync'd floors
        survive, which is the entire point. A restarted server
        (``journal=`` the same path) re-seeds its floors from disk and
        re-learns the live leases from the replicas' re-announced
        beats."""
        logger.error("reservation server CRASHED (chaos kill) — "
                     "in-memory leases/epochs lost, journal floors %s",
                     "retained" if self.journal is not None
                     else "ABSENT (no journal)")
        self.done.set()
        self._close_listener()
        with self._sup_lock:
            httpd, self._stats_httpd = self._stats_httpd, None
        if httpd is not None:
            try:
                httpd.server_close()
            except OSError:
                pass
            # shutdown() blocks until the serve loop notices; crash()
            # can be called from a handler thread, so park it off-path
            # tfos: unjoined(crash emulation — a killed process joins nothing)
            threading.Thread(target=httpd.shutdown,
                             daemon=True,
                             name="tfos-resv-crash").start()
        if self.journal is not None:
            # a killed process's fd is simply gone; everything durable
            # is already on disk (fsync-before-reply)
            self.journal.close()


class Client(object):
    """Executor-side client of the rendezvous server.

    Reference: ``reservation.Client`` — one persistent connection; register,
    poll until the barrier opens, fetch the full node list.
    """

    def __init__(self, server_addr, connect_timeout=30):
        self.server_addr = tuple(server_addr)
        sock = socket.create_connection(self.server_addr,
                                        timeout=connect_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        self._ms = MessageSocket(sock)
        self._lock = threading.Lock()

    def _call(self, msg):
        with self._lock:
            self._ms.send(msg)
            return self._ms.receive()

    def abort(self):
        """Out-of-band close: shut the socket down WITHOUT taking the
        call lock, so a thread wedged inside :meth:`_call` against a
        dead server fails out with ``ConnectionError``/``OSError``
        immediately instead of holding its caller hostage. The bounded
        close path driver teardown uses after a reservation-server
        crash — ``close()`` itself is also lock-free, but
        ``abort`` names the intent at call sites."""
        self._ms.close()

    def register(self, meta):
        resp = self._call({"type": "REG", "meta": meta})
        if resp.get("type") != "OK":
            raise RuntimeError("registration rejected: {!r}".format(resp))

    def get_reservations(self):
        return sort_cluster_info(self._call({"type": "QINFO"})["meta"])

    def await_reservations(self, timeout=DEFAULT_TIMEOUT, poll_interval=0.1):
        """Poll until all nodes registered; returns sorted cluster_info."""
        deadline = time.monotonic() + timeout
        while True:
            # Cheap QUERY while waiting (O(1) reply); one QINFO at the end —
            # N clients polling full metas would be O(N^2) on the driver.
            resp = self._call({"type": "QUERY"})
            if resp.get("done"):
                return sort_cluster_info(self._call({"type": "QINFO"})["meta"])
            if time.monotonic() > deadline:
                raise TimeoutError_("timed out awaiting cluster reservations")
            time.sleep(poll_interval)
            # back off gently to keep the driver's accept loop unloaded
            poll_interval = min(poll_interval * 1.5, 2.0)

    def lease(self, executor_id):
        """Acquire a fresh lease epoch for ``executor_id`` — the
        fencing token every subsequent :meth:`beat` must carry. Minting
        SUPERSEDES any prior holder of the identity: its next beat is
        answered FENCED (see :class:`Fenced`). Serving replicas acquire
        one before their first beat; a fenced replica re-registers
        through here (a deliberate act, never an automatic retry)."""
        # same chaos labels as beat(): a partition scoped to this
        # identity's reservation link must catch its LEASE exchanges
        # too — a fully partitioned replica cannot mint an epoch
        # through a supposedly-down link
        self._ms.net_src = executor_id
        self._ms.net_dst = "reservation"
        resp = self._call({"type": "LEASE", "executor_id": executor_id})
        if resp.get("type") != "LEASE":
            raise RuntimeError("lease rejected: {!r}".format(resp))
        return int(resp["epoch"])

    def beat(self, executor_id, payload=None, epoch=None):
        """Refresh this executor's heartbeat lease (supervision plane).
        ``payload`` is a small JSON-able status dict (trainer liveness,
        feed progress, train step) the Supervisor classifies. ``epoch``
        (from :meth:`lease`) is the fencing token: a beat carrying a
        stale one raises :class:`Fenced` — NON-retriable; the caller
        must stop acting as the identity's serving incarnation."""
        # label the exchange for the chaos network fault plane: a
        # net_partition=<id>:reservation spec catches exactly this
        # identity's beats
        self._ms.net_src = executor_id
        self._ms.net_dst = "reservation"
        msg = {"type": "BEAT", "executor_id": executor_id,
               "payload": payload or {}}
        if epoch is not None:
            msg["epoch"] = int(epoch)
        resp = self._call(msg)
        if resp.get("type") == "FENCED":
            raise Fenced(
                "beat fenced: {!r} epoch {} superseded (current {})"
                .format(executor_id, epoch, resp.get("epoch")),
                epoch=resp.get("epoch"))
        if resp.get("type") != "OK":
            raise RuntimeError("beat rejected: {!r}".format(resp))

    def ack(self, partition):
        """Record feed partition ``partition`` as fully consumed; a
        supervised restart skips acked partitions on replay."""
        resp = self._call({"type": "ACK", "partition": partition})
        if resp.get("type") != "OK":
            raise RuntimeError("ack rejected: {!r}".format(resp))

    def acked(self):
        """Partitions acknowledged so far (the driver-side view a trainer
        or test can poll to observe the exactly-once boundary — e.g.
        'my step N's partition has been recorded consumed')."""
        resp = self._call({"type": "ACKS"})
        if resp.get("type") != "ACKS":
            raise RuntimeError("acks query rejected: {!r}".format(resp))
        return set(resp.get("partitions") or ())

    def request_stop(self):
        try:
            self._call({"type": "STOP"})
        except (ConnectionError, OSError):
            pass

    def close(self):
        self._ms.close()


def sort_cluster_info(meta_list):
    """Deterministic node ordering: by executor_id (every view identical).

    The sorted list is the framework's ``cluster_spec`` analog: index in the
    sorted list == the torch.distributed rank; entry 0's host/port is the
    coordination-service address (SURVEY.md §2.4 plane 1).
    """
    return sorted(meta_list, key=lambda m: m.get("executor_id", 0))
