"""KV-block shipping: the wire plane of prefill/decode disaggregation —
the port's own copy of ``tensorflowonspark_tpu/kvship.py`` (numpy and
the standard library, on the port's ``frames``, ``shm`` and ``chaos``).

Disaggregation splits serving into a prefill tier (compute-bound,
bursty) and a decode tier (bandwidth-bound, steady). This module owns
the bytes between them:

- :func:`pack` / :func:`unpack` — one shipment (the resident prefix
  blocks of one prompt) over the frames codec: a pickled meta
  header (token chain, block size, pool dtype, per-block origins,
  source identity + fencing epoch) plus the pool rows of every
  shippable cache leaf as RAW column payloads. On an int8 pool those
  payloads are the codes and per-head scales AS STORED — no dequant
  round-trip, which is both the 3.2x byte win and the bitwise-parity
  guarantee (the decode side splices the exact bytes prefill wrote).
- :func:`ship` — deliver one packed shipment to a decode replica's
  ``POST /kv/splice``: a co-hosted zero-copy path (the frames gather
  straight into a :class:`shm.ShmRing` mapping, with a tiny HTTP
  notify) and a socket path (the frames as one request body). The
  shm path degrades to the socket path whenever the ring is missing,
  full, or too small — shipping is best-effort by design: a failed
  ship costs the decode tier a cold local re-prefill, never a wrong
  answer.

The layout is byte-identical to the reference's: either side's
:func:`unpack` reads the other's :func:`pack`. Chaos discipline
mirrors the reference fleet router's: the ``chaos.on_net`` verdict is
taken BEFORE any bytes move (request-side loss means the decode side
never saw the shipment), ``drop_response`` delivers the shipment then
raises (the splice HAPPENED but the prefill side must believe it
failed — the duplicate-splice case, which the decode side's
resident-chain dedupe makes idempotent), and ``dup`` re-delivers
once, discarding the second response (the post-timeout retry case).

No serving imports here — serving.py imports this module, never the
reverse.
"""

import atexit
import http.client
import logging
import threading

import numpy as np

from tensorflowonspark_tpu_torch import chaos, frames, shm

logger = logging.getLogger(__name__)

#: wire-format version stamped into every shipment header; unpack
#: rejects unknown versions loudly instead of misreading raw payloads
WIRE_VERSION = 1

#: seconds a shm-ring write may block before the ship falls back to
#: the socket path (a FULL ring means the consumer is behind — backing
#: off to TCP beats stalling the prefill worker's handler thread)
RING_WRITE_TIMEOUT_S = 0.2


class ShipError(RuntimeError):
    """A shipment could not be delivered (transport-level). The caller
    treats it exactly like a chaos partition: fall back to cold local
    prefill on the decode side, never retry into a double-splice."""


def pack(meta, rows):
    """(meta dict, ``[(path_key, rows_array)]``) -> list of wire buffers.

    ``rows`` is :func:`generation.gather_block_rows` output: one array
    of shape ``[n_blocks, ...]`` per pool leaf, in the LEAF's storage
    dtype. The arrays ride as raw column payloads (zero pickling) of
    one :func:`frames.encode_multi` frame; ``meta`` rides in the
    pickled header. Returns the buffer list ``shm.ShmRing.
    write_buffers`` / the socket sender move verbatim — physical
    transfer cost is exactly :func:`frames.frame_bytes` of it."""
    names = tuple(k for k, _ in rows)
    cols = [np.ascontiguousarray(r) for _, r in rows]
    hdr = dict(meta)
    hdr["v"] = WIRE_VERSION
    hdr["n_blocks"] = int(cols[0].shape[0]) if cols else 0
    return frames.encode_multi(
        [hdr, frames.ColumnarChunk(cols, names=names)])


def unpack(view):
    """One shipment frame (bytes/memoryview) -> ``(meta, rows)``.

    ``rows`` come back as ZERO-COPY views into ``view`` (frames.decode
    semantics): splice synchronously while the source buffer is alive,
    or materialize. Raises ValueError on anything that is not a
    well-formed shipment of this wire version."""
    try:
        obj = frames.decode(view)
    except Exception as e:  # noqa: BLE001 - decode failure modes are
        # open-ended (pickle, struct, slicing) and ALL of them mean
        # the same thing to a splice handler: malformed shipment
        raise ValueError("undecodable KV shipment: {}".format(e))
    if not isinstance(obj, frames.FrameList) or len(obj) != 2:
        raise ValueError("not a KV shipment frame")
    meta, chunk = obj
    if not isinstance(meta, dict) or \
            meta.get("v") != WIRE_VERSION or \
            not isinstance(chunk, frames.ColumnarChunk) or \
            chunk.names is None:
        raise ValueError("malformed KV shipment (wire version {!r})"
                         .format(meta.get("v") if isinstance(meta, dict)
                                 else None))
    return meta, list(zip(chunk.names, chunk.cols))


def split_addr(addr):
    """'host:port' (or a (host, port) pair) -> (host, int port)."""
    if isinstance(addr, (tuple, list)):
        return str(addr[0]), int(addr[1])
    host, _, port = str(addr).rpartition(":")
    return host, int(port)


def _co_hosted(host):
    """True when ``host`` names this machine (loopback): the shm ring
    mapping is reachable, so the zero-copy path applies."""
    return host in ("127.0.0.1", "localhost", "::1")


# -- transport ----------------------------------------------------------
#
# Producer rings are cached per (src, dst) pair and live until process
# exit: one ring serves every shipment between a replica pair, and the
# name embeds this process's pid so shm.sweep_stale can reap them
# after a SIGKILL. Consumer-side opens are cached per name WITH a
# per-ring lock — ShmRing's sequential-consumption contract (at most
# one outstanding read_view) must hold across concurrent /kv/splice
# handler threads.

_rings_lock = threading.Lock()
_producer_rings = {}   # (src, dst) -> ShmRing (created by this process)
_consumer_rings = {}   # name -> (ShmRing, threading.Lock)


def producer_ring(src, dst):
    """Create-or-return this process's ship ring toward ``dst``.
    Raises OSError when the native ring is unavailable."""
    with _rings_lock:
        ring = _producer_rings.get((src, dst))
        if ring is None:
            ring = shm.ShmRing.create(
                shm.kvship_ring_name(src, dst), shm.KVSHIP_CAPACITY)
            _producer_rings[(src, dst)] = ring
        return ring


def consumer_ring(name):
    """Open-or-return the named ship ring plus its consumption lock
    (the decode server serializes read_view/release under it)."""
    with _rings_lock:
        entry = _consumer_rings.get(name)
        if entry is None:
            entry = (shm.ShmRing.open(name), threading.Lock())
            _consumer_rings[name] = entry
        return entry


def close_rings():
    """Close every cached ring (unlinking the ones this process
    created). Tests and engine teardown call this; atexit backstops."""
    with _rings_lock:
        for ring in _producer_rings.values():
            ring.close()
            ring.unlink()
        _producer_rings.clear()
        for ring, _lock in _consumer_rings.values():
            ring.close()
        _consumer_rings.clear()


atexit.register(close_rings)


def _post(host, port, path, body_buffers, headers, timeout):
    """One POST of gathered ``body_buffers`` (no caller-side concat);
    returns (status, body bytes)."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        total = sum(memoryview(b).nbytes for b in body_buffers)
        conn.putrequest("POST", path)
        conn.putheader("Content-Type", "application/octet-stream")
        conn.putheader("Content-Length", str(total))
        for k, v in (headers or {}).items():
            conn.putheader(k, v)
        conn.endheaders()
        for b in body_buffers:
            conn.send(bytes(b) if not isinstance(b, (bytes, memoryview))
                      else b)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _deliver(addr, buffers, via, timeout):
    """Move one shipment to ``addr``'s /kv/splice; returns
    (status, body, transport). ``via``: 'auto' / 'shm' / 'socket'."""
    host, port = split_addr(addr)
    if via in ("auto", "shm") and _co_hosted(host) and shm.available():
        try:
            # the frames gather lands straight in the ring mapping; the
            # empty-body notify tells the decode server WHICH ring its
            # one pending message sits in
            ring = producer_ring("local", "{}:{}".format(host, port))
            ring.write_buffers(buffers, timeout=RING_WRITE_TIMEOUT_S)
            status, body = _post(
                host, port, "/kv/splice", [b""],
                {"X-TFOS-KV-Via": "shm", "X-TFOS-KV-Ring": ring.name},
                timeout)
            return status, body, "shm"
        except (OSError, TimeoutError, ValueError) as e:
            if via == "shm":
                raise ShipError("shm ship failed: {}".format(e))
            logger.debug("kvship shm path unavailable (%s); "
                         "falling back to socket", e)
    status, body = _post(host, port, "/kv/splice", buffers, None, timeout)
    return status, body, "socket"


def ship(addr, buffers, src=None, dst=None, via="auto", timeout=30.0):
    """Deliver one packed shipment to ``http://addr/kv/splice``.

    Returns ``(status, body_bytes, transport)`` — 200 means spliced
    (body carries the decode side's block accounting JSON), 409 means
    deliberately rejected (fenced / dtype / pool pressure; body names
    the reason). Raises :class:`chaos.NetPartitioned` under an armed
    partition between ``src`` and ``dst`` and :class:`ShipError` on
    transport failure — both mean "assume not spliced": the decode
    side dedupes resident chains, so a shipment that secretly landed
    costs nothing on retry or fallback."""
    action = None
    if chaos.net_armed():
        # the verdict BEFORE bytes move: request-side loss raises here
        # and the decode side never sees the shipment
        action = chaos.on_net(src=src, dst=dst, response_capable=True)
    try:
        status, body, transport = _deliver(addr, buffers, via, timeout)
    except (OSError, http.client.HTTPException) as e:
        raise ShipError("ship to {} failed: {}".format(addr, e))
    if action == "dup":
        # post-timeout duplicate delivery: re-send once, discard the
        # second response — the splice path must tolerate it (and
        # does: resident-chain dedupe makes a double splice a no-op)
        try:
            _deliver(addr, buffers, via, timeout)
        except (OSError, http.client.HTTPException, ShipError):
            pass
    if action == "drop_response":
        # the shipment LANDED; the response did not — the prefill side
        # must treat it as failed (never report shipped bytes for it)
        raise chaos.NetPartitioned(
            "response from {} dropped".format(dst or addr))
    return status, body, transport
