"""Small host/process utilities — the port's copy of
``tensorflowonspark_tpu/util.py``.

Reference: ``tensorflowonspark/util.py``: ``get_ip_address``,
``find_in_path``, ``single_node_env``,
``write_executor_id``/``read_executor_id``.

The executor-id persistence trick matters here exactly as it does in the
reference: a re-launched worker process (task retry) must keep the same
node ordinal, because device binding and the queue-broker endpoint are
keyed on it.

Not carried over: the reference's TPU-tunnel health probes, which have
no counterpart on a CUDA host.
"""

import errno
import logging
import os
import socket

logger = logging.getLogger(__name__)

EXECUTOR_ID_FILE = "executor_id"


def get_ip_address():
    """IPv4 address of this host's first interface that is up and not
    loopback, read from the kernel (``SIOCGIFADDR``): no packet is sent
    and no name is looked up. ``127.0.0.1`` when there is none (an
    isolated host, where loopback is the right answer) or the platform
    has no such ioctl."""
    try:
        import fcntl
        import struct
        names = [n for _, n in socket.if_nameindex() if n != "lo"]
    except (ImportError, OSError, AttributeError):
        return "127.0.0.1"
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for name in names:
            try:
                raw = fcntl.ioctl(s.fileno(), 0x8915,  # SIOCGIFADDR
                                  struct.pack("256s", name[:15].encode()))
            except OSError:  # no IPv4 address on this interface
                continue
            addr = socket.inet_ntoa(raw[20:24])
            if not addr.startswith("127."):
                return addr
    finally:
        s.close()
    return "127.0.0.1"


def find_free_port(host=""):
    """Reserve an ephemeral TCP port and return it (socket is closed).

    Mirrors the reference's port-reservation in ``TFSparkNode.run`` (bind
    port 0, publish via reservation, then hand it to the server). There is a
    tiny close->rebind race window, same as the reference accepts.
    """
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def find_in_path(path, file_name):
    """Find a file in a ':'-separated search path; '' if absent."""
    for p in path.split(os.pathsep):
        candidate = os.path.join(p, file_name)
        if os.path.exists(candidate) and os.path.isfile(candidate):
            return candidate
    return ""


def write_executor_id(num, cwd=None):
    """Persist this worker's node ordinal in its working dir.

    Reference: ``util.write_executor_id`` — Spark may recycle python workers;
    the ordinal must survive so a re-launched worker keeps its identity.
    """
    path = os.path.join(cwd or os.getcwd(), EXECUTOR_ID_FILE)
    with open(path, "w") as f:
        f.write(str(num))


def read_executor_id(cwd=None):
    """Read the persisted node ordinal, or None if never written."""
    path = os.path.join(cwd or os.getcwd(), EXECUTOR_ID_FILE)
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError) as e:
        if isinstance(e, OSError) and e.errno not in (errno.ENOENT,):
            raise
        return None


def single_node_env(num_devices=1):
    """Environment setup for a non-cluster single-node run.

    Reference: ``util.single_node_env`` (GPU pinning via CUDA_VISIBLE_DEVICES
    for standalone runs). Here the trainer process picks its card through
    ``device_info``; this keeps host-side BLAS threads bounded so feeder
    processes don't fight the device-owning process for cores.
    """
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")


_MALLOC_TUNED = False


def tune_malloc():
    """Stop glibc from round-tripping big feed buffers through the kernel.

    Batch-sized allocations (a 224px uint8 batch-256 column is 38MB)
    exceed glibc's mmap threshold, so every consumer-side materialize
    got fresh mmap'd pages — and paid the kernel's zero-fill fault for
    all of them — then gave them straight back at free.
    Raising M_MMAP_THRESHOLD keeps these blocks in the heap arena and
    M_TRIM_THRESHOLD stops free() from returning the top of the heap,
    so each batch's destination reuses already-faulted pages. Price:
    up to TFOS_MALLOC_RETAIN_BYTES of freed heap stays resident per
    process — bounded, and small against a training host's RAM.

    Called at node bootstrap (forked trainers inherit the setting);
    TFOS_MALLOC_TUNE=0 disables. No-op (False) off glibc.
    """
    global _MALLOC_TUNED
    if _MALLOC_TUNED or os.environ.get("TFOS_MALLOC_TUNE") == "0":
        return _MALLOC_TUNED
    try:
        retain = int(os.environ.get("TFOS_MALLOC_RETAIN_BYTES") or
                     (256 << 20))
    except ValueError:
        retain = 256 << 20
    # mallopt takes a C int; ctypes silently truncates to 32 bits, and
    # e.g. 4GiB would become threshold 0 — every allocation forced
    # through mmap, the exact pathology this tuning exists to fix.
    retain = max(1, min(retain, (1 << 31) - 1))
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6")
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        ok = (libc.mallopt(M_TRIM_THRESHOLD, retain) == 1 and
              libc.mallopt(M_MMAP_THRESHOLD, retain) == 1)
    except Exception:  # noqa: BLE001 - musl/macOS etc: leave defaults
        ok = False
    _MALLOC_TUNED = ok
    if ok:
        logger.debug("malloc tuned: retain %d bytes in-arena", retain)
    return ok
