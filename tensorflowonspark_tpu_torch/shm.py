"""Python binding for the native shared-memory feed ring — the port's
copy of ``tensorflowonspark_tpu/shm.py``, over the same source,
``native/shm_ring.cpp``.

The fast path of the feed plane: the manager queue (manager.py) remains
the control channel, while bulk record chunks ride this SPSC ring — a
gather-memcpy into one mmap'd region instead of pickled TCP round trips
through a manager proxy per chunk. The ring blocks on futexes (no
polling — critical on small hosts where a spinning consumer starves
the producer) and keeps messages contiguous, so the consumer can decode
columnar frames (frames.py) as zero-copy views into the mapping.

Enabled per cluster with ``TFOS_FEED_TRANSPORT=shm`` (the default when the
broker is local and the ring builds — see node.py); semantics
(EndPartition/EndFeed markers, drain-on-consume, state aborts) are
identical to the queue path.

The library builds with ``g++`` at first use (never at import) into
``tensorflowonspark_tpu_torch/_build/`` (git-ignored), the directory the
CUDA kernels build into (``ops/_build.py``). Its file name carries a
hash of the source and the flags, so an edited source rebuilds; each
building process writes a temporary file of its own and renames it
into place, so concurrent builds (every executor of a host builds
lazily) leave one whole library and never load a half-written one. Everything
degrades gracefully: ``available()`` is False where g++ or POSIX shm is
missing.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "shm_ring.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
#: g++ flags of the ring library (the reference's, unchanged)
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_LIBS = ("-lrt", "-pthread")
_lib = None
_lib_lock = threading.Lock()

_from_memory = ctypes.pythonapi.PyMemoryView_FromMemory
_from_memory.restype = ctypes.py_object
_from_memory.argtypes = (ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_int)
_PyBUF_READ = 0x100


def library_path():
    """Where the ring library is (or will be) built: the file name
    carries a hash of the source and the flags."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS + _LIBS).encode())
    return os.path.join(BUILD_DIR, "libshmring-{}.so".format(
        h.hexdigest()[:16]))


def _build(target):
    # per-pid temp: concurrent executor processes all build lazily; a
    # shared temp file would tear. os.replace of complete files is
    # atomic, so the last build's whole file wins.
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.{}.tmp".format(target, os.getpid())
    cmd = (["g++"] + list(CXX_FLAGS) + ["-o", tmp, _SRC] + list(_LIBS))
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, target)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.shmring_create.restype = ctypes.c_void_p
        lib.shmring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.shmring_open.restype = ctypes.c_void_p
        lib.shmring_open.argtypes = [ctypes.c_char_p]
        lib.shmring_write.restype = ctypes.c_int
        lib.shmring_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64, ctypes.c_int]
        lib.shmring_write_gather.restype = ctypes.c_int
        lib.shmring_write_gather.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int]
        lib.shmring_read_ptr.restype = ctypes.c_void_p
        lib.shmring_read_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_uint64)]
        lib.shmring_advance.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.shmring_peek_len.restype = ctypes.c_int64
        lib.shmring_peek_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.shmring_read.restype = ctypes.c_int64
        lib.shmring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_uint64, ctypes.c_int]
        lib.shmring_pending.restype = ctypes.c_uint64
        lib.shmring_pending.argtypes = [ctypes.c_void_p]
        lib.shmring_wait_drained.restype = ctypes.c_int
        lib.shmring_wait_drained.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.shmring_close.argtypes = [ctypes.c_void_p]
        lib.shmring_unlink.argtypes = [ctypes.c_char_p]
        _lib = lib
        return lib


def sweep_stale(executor_id=None, pattern=None):
    """Unlink rings whose creating process is dead; returns names removed.

    SIGKILL is the one exit the atexit/shutdown cleanups cannot cover:
    a feeder killed -9 leaves its segment behind,
    and since ring names embed the cluster id, a *new* cluster would
    never reuse (and thus never clear) the old name. Ring names embed
    the creator pid (``/tfos-<id>-<eid>.<pid>``, node.py) precisely so
    this sweep can test liveness: dead pid -> stale segment. Scoped to
    one executor slot at node bootstrap (never touching a concurrent
    cluster's live rings, whose pids are alive); unscoped from the
    engine driver's stop() on hosts it owns. pid-less legacy names are
    left alone — liveness is unknowable for them.

    ``pattern`` (a ``/dev/shm`` glob) narrows the sweep to one ring
    family instead of one executor slot.
    """
    import glob
    import re

    pat = pattern if pattern is not None else (
        "/dev/shm/tfos-*-{}.*".format(executor_id)
        if executor_id is not None else "/dev/shm/tfos-*.*")
    removed = []
    for path in glob.glob(pat):
        base = os.path.basename(path)
        m = re.match(r".+\.(\d+)$", base)
        if not m:
            continue
        pid = int(m.group(1))
        try:
            os.kill(pid, 0)
            continue  # creator alive: the ring is (or may be) live
        except ProcessLookupError:
            pass
        except OSError:
            continue  # EPERM etc.: can't prove death, leave it
        try:
            _load().shmring_unlink(("/" + base).encode())
            removed.append("/" + base)
            logger.info("swept stale shm ring %s (dead pid %d)", base, pid)
        except Exception:  # noqa: BLE001 - best effort
            pass
    return removed


def available():
    """True if the native ring can be built/loaded on this host."""
    try:
        _load()
        return True
    except Exception as e:  # noqa: BLE001
        logger.info("native shm ring unavailable: %s", e)
        return False


#: below this ring size the transport is not worth it (one 256-image
#: uint8 224px frame is ~38MB and messages are capped at capacity/2)
MIN_USEFUL_CAPACITY = 64 * 1024 * 1024


def default_capacity():
    """Ring data-region size: enough runway for a few full device batches
    (a 256-image uint8 224px frame is ~38MB), env-tunable and bounded by
    half of /dev/shm's free space so a ring never fights the host for it.

    Returns 0 when /dev/shm can't fit a useful ring — callers must fall
    back to the queue transport (tmpfs pages materialize lazily, so an
    oversized ring would SIGBUS the producer mid-feed, not fail create).
    """
    want = 256 * 1024 * 1024
    env = os.environ.get("TFOS_SHM_CAPACITY")
    if env:
        want = int(env)
    try:
        st = os.statvfs("/dev/shm")
        free_half = st.f_bavail * st.f_frsize // 2
        if want > free_half:
            # The env override is clamped too: tmpfs pages materialize
            # lazily, so an oversized ring SIGBUSes the producer mid-feed
            # instead of failing create — honoring the override verbatim
            # would re-open exactly that hazard.
            if env:
                logger.warning(
                    "TFOS_SHM_CAPACITY=%s exceeds half of /dev/shm free "
                    "space; clamping to %d", env, free_half)
            want = free_half
    except OSError:
        pass
    # The env override does not bypass the uselessly-small floor either:
    # a clamped-down ring whose max message (capacity/2) can't hold one
    # record would fail mid-feed, whereas 0 makes node.py fall back to
    # the queue transport cleanly.
    return want if want >= MIN_USEFUL_CAPACITY else 0


#: capacity of a KV-ship ring: shipments are a few blocks of pool rows
#: (megabytes, not the feed plane's image frames), so a small explicit
#: capacity beats :func:`default_capacity`'s feed-sized floor
KVSHIP_CAPACITY = 16 * 1024 * 1024


def kvship_ring_name(src_replica, dst_replica):
    """Canonical shm segment name of the src->dst KV-ship ring. The
    prefill side creates it, and the name ends in the creator's pid like
    the feed rings (``/tfos-...<name>.<pid>``), so :func:`sweep_stale`
    reaps rings a killed prefill process left behind. Replica ids are
    cut to the shm-name alphabet (no dots: the pid suffix must stay the
    only ``.``-delimited field)."""
    def _safe(s):
        return "".join(ch if ch.isalnum() or ch in "-_" else "-"
                       for ch in str(s))
    return "/tfos-kvship-{}-{}.{}".format(
        _safe(src_replica), _safe(dst_replica), os.getpid())


class ShmRing(object):
    """One SPSC byte-message ring. create() on the producer-side host
    process; open() from the consumer. Not thread-safe per side."""

    DEFAULT_CAPACITY = 64 * 1024 * 1024

    def __init__(self, handle, name, owner):
        self._h = handle
        self.name = name
        self._owner = owner

    @classmethod
    def create(cls, name, capacity=None):
        lib = _load()
        capacity = capacity or default_capacity()
        if not capacity:
            raise OSError("/dev/shm too small for a useful ring "
                          "(need {}MB free)".format(
                              2 * MIN_USEFUL_CAPACITY // 2 ** 20))
        handle = lib.shmring_create(name.encode(), capacity)
        if not handle:
            raise OSError("shmring_create failed for {!r}".format(name))
        return cls(handle, name, owner=True)

    @classmethod
    def open(cls, name):
        lib = _load()
        handle = lib.shmring_open(name.encode())
        if not handle:
            raise OSError("shmring_open failed for {!r}".format(name))
        return cls(handle, name, owner=False)

    # -- raw message API ---------------------------------------------------

    def write(self, data, timeout=None):
        """Write one message; raises TimeoutError/ValueError."""
        rc = _load().shmring_write(
            self._h, bytes(data), len(data),
            -1 if timeout is None else int(timeout * 1000))
        if rc == -1:
            raise TimeoutError("shm ring full")
        if rc == -2:
            raise ValueError("message larger than ring capacity")

    def write_buffers(self, buffers, timeout=None):
        """One message gathered from several byte-like buffers (no
        caller-side concat; raw array memory goes straight to the mmap)."""
        import numpy as np

        n = len(buffers)
        ptrs = (ctypes.c_void_p * n)()
        lens = (ctypes.c_uint64 * n)()
        holds = []  # keep buffer owners alive across the call
        for i, b in enumerate(buffers):
            if isinstance(b, bytes):
                ptrs[i] = ctypes.cast(b, ctypes.c_void_p)
                lens[i] = len(b)
                holds.append(b)
                continue
            # numpy arrays and contiguous byte-likes: zero-copy address
            a = b if isinstance(b, np.ndarray) else \
                np.frombuffer(b, dtype=np.uint8)
            a = np.ascontiguousarray(a)
            ptrs[i] = a.ctypes.data
            lens[i] = a.nbytes
            holds.append(a)
        rc = _load().shmring_write_gather(
            self._h, ptrs, lens, n,
            -1 if timeout is None else int(timeout * 1000))
        del holds
        if rc == -1:
            raise TimeoutError("shm ring full")
        if rc == -2:
            raise ValueError("message larger than ring capacity")

    def read(self, timeout=None):
        """Read one message; returns bytes or None on timeout."""
        lib = _load()
        t = -1 if timeout is None else int(timeout * 1000)
        out_len = ctypes.c_uint64()
        ptr = lib.shmring_read_ptr(self._h, t, ctypes.byref(out_len))
        if not ptr:
            return None
        data = ctypes.string_at(ptr, out_len.value)
        lib.shmring_advance(self._h, out_len.value)
        return data

    def read_view(self, timeout=None):
        """(memoryview, release) of the next message, zero copy.

        The view addresses the ring mapping directly; call ``release()``
        exactly once when done to free the slot (until then the producer
        can't reclaim the space).

        SEQUENTIAL-CONSUMPTION CONTRACT: at most one outstanding view.
        The read position is the consumer tail, which only ``release``
        advances — a second ``read_view`` before releasing the first
        returns the SAME message again (and releasing both then
        over-advances the tail, desyncing the stream). DataFeed upholds
        this by unpinning every held slot before each blocking read.
        """
        lib = _load()
        t = -1 if timeout is None else int(timeout * 1000)
        out_len = ctypes.c_uint64()
        ptr = lib.shmring_read_ptr(self._h, t, ctypes.byref(out_len))
        if not ptr:
            return None, None
        view = _from_memory(ptr, out_len.value, _PyBUF_READ)
        n = out_len.value
        done = [False]  # one-shot: a double release would advance the
        # tail past an unconsumed message and desync the stream

        def release(_lib=lib, _h=self._h, _n=n, _done=done):
            if _done[0]:
                return
            _done[0] = True
            _lib.shmring_advance(_h, _n)

        return view, release

    def pending(self):
        """Unconsumed bytes (0 == fully drained)."""
        return int(_load().shmring_pending(self._h))

    def wait_drained(self, timeout=None):
        """Block until the consumer drained everything; True if drained.

        Futex-sleeps on the consumer's advance counter — the feeder's
        partition join wakes the instant the trainer releases the last
        message, instead of on a poll tick."""
        return bool(_load().shmring_wait_drained(
            self._h, -1 if timeout is None else int(timeout * 1000)))

    # -- object / frame API ------------------------------------------------

    def write_obj(self, obj, timeout=None):
        """Frame-encode ``obj`` (frames.py) and write it.

        ColumnarChunks move as raw column bytes; other objects pickle into
        the frame header.
        """
        from tensorflowonspark_tpu_torch import frames
        self.write_buffers(frames.encode(obj), timeout)

    def read_obj(self, timeout=None):
        """Read one frame → object; None on timeout.

        ColumnarChunk columns are copied out of the ring (one memcpy) so
        the slot frees immediately and the result owns its memory. A
        coalesced multi-object frame (frames.encode_multi) comes back as
        a FrameList with every chunk materialized the same way.

        This is the copying legacy path (probes, drains, tools); the
        trainer's DataFeed consumes via read_view + a staging gather
        instead, releasing the slot only after the single copy out.
        """
        from tensorflowonspark_tpu_torch import frames
        view, release = self.read_view(timeout)
        if view is None:
            return None
        try:
            obj = frames.decode(view)
            objs = obj if isinstance(obj, frames.FrameList) else (obj,)
            for o in objs:
                if isinstance(o, frames.ColumnarChunk):
                    o.materialize()
            return obj
        finally:
            release()

    def close(self):
        if self._h:
            _load().shmring_close(self._h)
            self._h = None

    def unlink(self):
        try:
            _load().shmring_unlink(self.name.encode())
        except Exception:  # noqa: BLE001
            pass

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass
