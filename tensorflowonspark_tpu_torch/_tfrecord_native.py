"""ctypes binding for the native TFRecord codec — the port's copy of
``tensorflowonspark_tpu/_tfrecord_native.py``, over the same source,
``native/tfrecord_codec.cpp``.

Throughput path for TFRecord reads: one mmap/read of the file, one C
scan that validates framing + both CRCs and returns every record's
(offset, length), then zero-copy memoryview slices — instead of four
python-level reads and two python/c-extension crc calls per record.
Dense feature columns batch-decode straight into numpy arrays.

Follows the port's ``shm.py``: the library builds with ``g++`` at first
use (never at import) into ``tensorflowonspark_tpu_torch/_build/``
(git-ignored), under a file name that carries a hash of the source and
the flags, so an edited source rebuilds; each building process writes a
temporary file of its own and renames it into place, so concurrent
builds leave one whole library. The JAX package's
``_libtfrecord.so`` is never loaded. ``available()`` is False (and the
pure-python tfrecord.py codec takes over) wherever the toolchain is
missing. tfrecord.py remains the canonical implementation; tests assert
byte-exact agreement.

Nothing is left out: every function of the reference is here.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "tfrecord_codec.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
#: g++ flags of the codec library (the reference's, unchanged)
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_lib = None
_lib_lock = threading.Lock()
_u64p = ctypes.POINTER(ctypes.c_uint64)


def library_path():
    """Where the codec library is (or will be) built: the file name
    carries a hash of the source and the flags."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, "libtfrecord-{}.so".format(
        h.hexdigest()[:16]))


def _build(target):
    # per-pid temp: concurrent executor processes all build lazily; a
    # shared temp file would tear. os.replace of complete files is
    # atomic, so the last build's whole file wins.
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.{}.tmp".format(target, os.getpid())
    cmd = ["g++"] + list(CXX_FLAGS) + ["-o", tmp, _SRC]
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
        lib.tfrec_crc32c.restype = ctypes.c_uint32
        lib.tfrec_crc32c.argtypes = (ctypes.c_char_p, ctypes.c_uint64)
        lib.tfrec_masked_crc32c.restype = ctypes.c_uint32
        lib.tfrec_masked_crc32c.argtypes = (ctypes.c_char_p, ctypes.c_uint64)
        lib.tfrec_index.restype = ctypes.c_int64
        lib.tfrec_index.argtypes = (
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
            _u64p, _u64p, ctypes.c_uint64)
        for fn, outp in ((lib.tfrec_batch_floats,
                          ctypes.POINTER(ctypes.c_float)),
                         (lib.tfrec_batch_int64,
                          ctypes.POINTER(ctypes.c_int64))):
            fn.restype = ctypes.c_int64
            fn.argtypes = (ctypes.c_void_p, _u64p, _u64p, ctypes.c_uint64,
                           ctypes.c_char_p, ctypes.c_uint64, outp,
                           ctypes.c_uint64)
        _lib = lib
        return _lib


def available():
    """True when the native codec builds/loads on this host."""
    try:
        _load()
        return True
    except Exception as e:  # noqa: BLE001 - degrade to pure python
        logger.debug("native tfrecord codec unavailable: %s", e)
        return False


def crc32c(data):
    return _load().tfrec_crc32c(bytes(data), len(data))


def masked_crc32c(data):
    return _load().tfrec_masked_crc32c(bytes(data), len(data))


_ERRORS = {-1: "truncated TFRecord", -2: "corrupt TFRecord: bad length crc",
           -3: "corrupt TFRecord: bad data crc"}


def _addr(mv):
    """Base address of a (possibly read-only) buffer. numpy keeps the
    view alive via the returned array's .base; callers hold mv anyway."""
    return ctypes.c_void_p(np.frombuffer(mv, np.uint8).ctypes.data)


def index_buffer(buf, verify_crc=True):
    """Validate framing over a whole-file buffer; return (offsets, lengths)
    uint64 arrays addressing each record's payload within ``buf``."""
    mv = memoryview(buf)
    n = mv.nbytes
    if n == 0:
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    # every record costs >= 16 framing+payload bytes
    cap = n // 16 + 1
    offsets = np.empty(cap, np.uint64)
    lengths = np.empty(cap, np.uint64)
    base = _addr(mv)
    count = _load().tfrec_index(
        base, n, 1 if verify_crc else 0,
        offsets.ctypes.data_as(_u64p), lengths.ctypes.data_as(_u64p), cap)
    if count < 0:
        raise ValueError(_ERRORS.get(count, "TFRecord scan error %d" % count))
    return offsets[:count], lengths[:count]


def iter_records(buf, verify_crc=True):
    """Yield zero-copy memoryview payload slices from a file buffer."""
    mv = memoryview(buf)
    offsets, lengths = index_buffer(mv, verify_crc)
    for off, ln in zip(offsets.tolist(), lengths.tolist()):
        yield mv[off:off + ln]


def _batch(buf, offsets, lengths, name, width, dtype):
    mv = memoryview(buf)
    m = len(offsets)
    out = np.empty((m, width), dtype)
    if m == 0:
        return out
    name_b = name.encode("utf-8")
    base = _addr(mv)
    lib = _load()
    offs = np.ascontiguousarray(offsets, np.uint64)
    lens = np.ascontiguousarray(lengths, np.uint64)
    if dtype == np.float32:
        rc = lib.tfrec_batch_floats(
            base, offs.ctypes.data_as(_u64p), lens.ctypes.data_as(_u64p),
            m, name_b, len(name_b),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), width)
    else:
        rc = lib.tfrec_batch_int64(
            base, offs.ctypes.data_as(_u64p), lens.ctypes.data_as(_u64p),
            m, name_b, len(name_b),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), width)
    if rc != 0:
        raise ValueError(
            "record %d: feature %r missing, wrong kind, or not %d values"
            % (-rc - 1, name, width))
    return out


def batch_floats(buf, offsets, lengths, name, width):
    """[m, width] float32 of feature ``name`` across the indexed records."""
    return _batch(buf, offsets, lengths, name, width, np.float32)


def batch_int64(buf, offsets, lengths, name, width):
    """[m, width] int64 of feature ``name`` across the indexed records."""
    return _batch(buf, offsets, lengths, name, width, np.int64)
