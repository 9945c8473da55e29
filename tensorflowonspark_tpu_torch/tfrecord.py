"""TFRecord + tf.train.Example codec — no TensorFlow dependency; the
port's copy of ``tensorflowonspark_tpu/tfrecord.py``, writing the same
bytes.

Reference capability: the ``tensorflow-hadoop`` connector JAR (Java) that
``dfutil`` drove through Spark's Hadoop I/O (SURVEY.md §2 "TFRecord
interop", §2.2 native table). The format is tiny, so the framework owns
it outright:

record framing (tfrecord_writer.cc upstream):
    uint64 length | uint32 masked_crc32c(length) | bytes data |
    uint32 masked_crc32c(data)

payload: a ``tf.train.Example`` protobuf —
    Example{ features: Features{ feature: map<string, Feature> } }
    Feature is oneof bytes_list(1) / float_list(2) / int64_list(3).

The proto wire codec below is hand-rolled for exactly this fixed schema
(varint + length-delimited walking). crc32c comes from the C-accelerated
``google_crc32c`` when present, else a pure-python table fallback.
Reads take the native codec (:mod:`_tfrecord_native`, built from
``native/tfrecord_codec.cpp``) when it builds and the file is a local
regular file; :data:`codec_reads` counts which codec each read used.

Nothing is left out: every function of the reference is here.
"""

import io
import os
import struct

import numpy as np

try:
    import google_crc32c

    def _crc32c(data):
        return google_crc32c.value(bytes(data))
except ImportError:  # pragma: no cover - present in the image
    _TABLE = []

    def _crc32c(data, _poly=0x82F63B78):
        if not _TABLE:
            for n in range(256):
                c = n
                for _ in range(8):
                    c = (c >> 1) ^ (_poly if c & 1 else 0)
                _TABLE.append(c)
        crc = 0xFFFFFFFF
        for b in bytes(data):
            crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF


def masked_crc32c(data):
    """TFRecord's rotated+offset crc32c mask."""
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# -- record framing --------------------------------------------------------

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")

_NATIVE = None  # tri-state: None = unprobed

#: reads per codec, this process: "native" (the C scan over an mmap) or
#: "python" (the per-record loop) — one count per file read by
#: tfrecord_iterator, count_records or read_batch
codec_reads = {"native": 0, "python": 0}


def _native_ok():
    """Native codec availability, probed once (TFOS_TFRECORD_NATIVE=0
    opts out)."""
    global _NATIVE
    if _NATIVE is None:
        if os.environ.get("TFOS_TFRECORD_NATIVE", "1") != "1":
            _NATIVE = False
        else:
            try:
                from tensorflowonspark_tpu_torch import _tfrecord_native
                _NATIVE = _tfrecord_native.available()
            except Exception:  # noqa: BLE001 - pure python remains
                _NATIVE = False
    return _NATIVE


class TFRecordWriter(object):
    """Append-only TFRecord file writer (context manager)."""

    def __init__(self, path):
        from tensorflowonspark_tpu_torch import fs
        self._f = fs.open(path, "wb")  # remote schemes via fs registry

    def write(self, record):
        record = bytes(record)
        header = _U64.pack(len(record))
        self._f.write(header)
        self._f.write(_U32.pack(masked_crc32c(header)))
        self._f.write(record)
        self._f.write(_U32.pack(masked_crc32c(record)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _read_exact(f, n):
    """Read exactly n bytes (or whatever remains at EOF).

    Registered remote openers (fs.py) may hand back raw/network streams
    whose read() legally returns short — a single read() would then
    misreport intact files as truncated/corrupt.
    """
    chunks = []
    got = 0
    while got < n:
        chunk = f.read(n - got)
        if not chunk:
            break
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _try_mmap(f):
    """mmap of an open local REGULAR file for the native scan, or None.

    None means "not mmap-able" — sockets/pipes/remote streams (a socket's
    fileno fstats as size 0, which must not read as an empty file) and
    openers without a usable fileno. ``f`` is NOT closed either way, so a
    one-shot stream opener keeps its handle for the streaming fallback."""
    import mmap
    import stat as stat_mod

    try:
        st = os.fstat(f.fileno())
        if not stat_mod.S_ISREG(st.st_mode):
            return None
        if st.st_size == 0:
            return b""
        return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except (AttributeError, OSError, ValueError, io.UnsupportedOperation):
        return None


def tfrecord_iterator(path, verify_crc=True):
    """Yield raw record bytes from a TFRecord file (fs registry handles
    remote schemes).

    Fast path: when the native codec builds (``_tfrecord_native``) AND
    the path is a local regular file, the file is mmapped and framing +
    both CRCs are validated in one C scan before the first yield. Each
    record is materialised as ``bytes`` either way, so the yielded type
    never depends on whether the host could build the codec (zero-copy
    views stay internal to :func:`read_batch`, where the native dense
    decode consumes them without the copy). Note the eagerness
    tradeoff: the whole file is validated up front, so consuming only
    the first records of a huge file is cheaper via
    :func:`first_record` or the python loop below — which remains the
    canonical fallback and the only remote-stream path (it never
    buffers the file in RAM)."""
    from tensorflowonspark_tpu_torch import fs
    f = fs.open(path, "rb")
    buf = _try_mmap(f) if _native_ok() else None
    if buf is not None:
        from tensorflowonspark_tpu_torch import _tfrecord_native
        f.close()
        codec_reads["native"] += 1
        for view in _tfrecord_native.iter_records(buf, verify_crc):
            yield bytes(view)
        return
    codec_reads["python"] += 1
    with f:
        for data in _iter_stream(f, verify_crc):
            yield data


def _iter_stream(f, verify_crc):
    """The lazy per-record loop over an OPEN stream (never buffers the
    file; the only path for non-mmap-able remote streams)."""
    while True:
        header = _read_exact(f, 8)
        if not header:
            return
        if len(header) < 8:
            raise ValueError("truncated TFRecord length header")
        (length,) = _U64.unpack(header)
        crc_bytes = _read_exact(f, 4)
        if len(crc_bytes) < 4:
            raise ValueError("truncated TFRecord length crc")
        (length_crc,) = _U32.unpack(crc_bytes)
        if verify_crc and masked_crc32c(header) != length_crc:
            raise ValueError("corrupt TFRecord: bad length crc")
        data = _read_exact(f, length)
        if len(data) < length:
            raise ValueError("truncated TFRecord payload")
        crc_bytes = _read_exact(f, 4)
        if len(crc_bytes) < 4:
            raise ValueError("truncated TFRecord data crc")
        (data_crc,) = _U32.unpack(crc_bytes)
        if verify_crc and masked_crc32c(data) != data_crc:
            raise ValueError("corrupt TFRecord: bad data crc")
        yield data


# -- protobuf wire primitives ---------------------------------------------

def _write_varint(buf, value):
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            buf.append(bits | 0x80)
        else:
            buf.append(bits)
            return


def _read_varint(data, pos):
    shift = 0
    result = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _tag(field, wire_type):
    return (field << 3) | wire_type


def _write_len_delimited(buf, field, payload):
    _write_varint(buf, _tag(field, 2))
    _write_varint(buf, len(payload))
    buf.extend(payload)


# -- Example encoding ------------------------------------------------------

def _encode_feature(values):
    """values: list of bytes/str | float | int -> Feature message bytes."""
    inner = bytearray()
    if not values:
        return bytes(inner)  # empty Feature (no kind set)
    v0 = values[0]
    if isinstance(v0, (bytes, bytearray, str, np.bytes_)):
        sub = bytearray()
        for v in values:
            if isinstance(v, str):
                v = v.encode("utf-8")
            _write_len_delimited(sub, 1, bytes(v))
        _write_len_delimited(inner, 1, sub)  # bytes_list = field 1
    elif isinstance(v0, (float, np.floating)):
        packed = np.asarray(values, "<f4").tobytes()
        sub = bytearray()
        _write_len_delimited(sub, 1, packed)  # packed floats, field 1
        _write_len_delimited(inner, 2, sub)  # float_list = field 2
    elif isinstance(v0, (int, np.integer, bool)):
        sub = bytearray()
        packed = bytearray()
        for v in values:
            _write_varint(packed, int(v) & 0xFFFFFFFFFFFFFFFF)
        _write_len_delimited(sub, 1, packed)  # packed varints, field 1
        _write_len_delimited(inner, 3, sub)  # int64_list = field 3
    else:
        raise TypeError("unsupported feature value type: {}".format(type(v0)))
    return bytes(inner)


def encode_example(features):
    """{name: scalar | list | 1-D ndarray} -> serialized tf.train.Example.

    Type mapping mirrors the reference's ``dfutil.toTFExample``:
    bytes/str -> bytes_list, float -> float_list, int/bool -> int64_list.
    """
    fmap = bytearray()
    # deterministic output: sorted feature names (map order is unspecified
    # in proto, but byte-stable files diff nicely)
    for name in sorted(features):
        values = features[name]
        if isinstance(values, np.ndarray):
            values = values.reshape(-1).tolist()
        elif not isinstance(values, (list, tuple)):
            values = [values]
        entry = bytearray()
        _write_len_delimited(entry, 1, name.encode("utf-8"))  # key
        _write_len_delimited(entry, 2, _encode_feature(list(values)))  # value
        _write_len_delimited(fmap, 1, bytes(entry))  # map entry: feature=1
    example = bytearray()
    _write_len_delimited(example, 1, bytes(fmap))  # features = field 1
    return bytes(example)


# -- Example decoding ------------------------------------------------------

def _iter_fields(data):
    """Yield (field_number, wire_type, value, next_pos) over a message."""
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 2:
            length, pos = _read_varint(data, pos)
            value = data[pos:pos + length]
            pos += length
        elif wire == 5:
            value = data[pos:pos + 4]
            pos += 4
        elif wire == 1:
            value = data[pos:pos + 8]
            pos += 8
        else:
            raise ValueError("unsupported wire type {}".format(wire))
        yield field, wire, value


def _decode_packed_varints(data):
    out = []
    pos = 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        if v >= 1 << 63:  # two's-complement int64
            v -= 1 << 64
        out.append(v)
    return out


def _decode_feature(data):
    """Feature message -> (kind, values)."""
    for field, wire, value in _iter_fields(data):
        if field == 1:  # bytes_list
            vals = [bytes(v) for f, w, v in _iter_fields(value) if f == 1]
            return "bytes", vals
        if field == 2:  # float_list
            vals = []
            for f, w, v in _iter_fields(value):
                if f != 1:
                    continue
                if w == 2:  # packed
                    vals.extend(np.frombuffer(v, "<f4").tolist())
                else:  # unpacked 32-bit
                    vals.append(struct.unpack("<f", v)[0])
            return "float", vals
        if field == 3:  # int64_list
            vals = []
            for f, w, v in _iter_fields(value):
                if f != 1:
                    continue
                if w == 2:
                    vals.extend(_decode_packed_varints(v))
                else:
                    x = v if isinstance(v, int) else _read_varint(v, 0)[0]
                    if x >= 1 << 63:
                        x -= 1 << 64
                    vals.append(x)
            return "int64", vals
    return "empty", []


def parse_example(data):
    """Serialized Example -> {name: (kind, values)}."""
    out = {}
    for field, wire, value in _iter_fields(data):
        if field != 1:  # features
            continue
        for f, w, entry in _iter_fields(value):
            if f != 1:  # feature map entry
                continue
            name = None
            feat = ("empty", [])
            for ef, ew, ev in _iter_fields(entry):
                if ef == 1:
                    # bytes() no-ops on bytes records and materialises
                    # the memoryview slices _iter_fields produces
                    name = bytes(ev).decode("utf-8")
                elif ef == 2:
                    feat = _decode_feature(ev)
            if name is not None:
                out[name] = feat
    return out


# -- directory-level helpers ----------------------------------------------

def write_tfrecords(path, examples, compress=False):
    """Write an iterable of feature-dicts to one TFRecord file."""
    assert not compress, "compression not supported"
    count = 0
    with TFRecordWriter(path) as w:
        for features in examples:
            w.write(encode_example(features))
            count += 1
    return count


def first_record(path, verify_crc=True):
    """First record's bytes (or None if the file is empty) via the LAZY
    streaming loop — O(one record) of I/O regardless of file size, where
    the native :func:`tfrecord_iterator` path would CRC-scan the whole
    file before yielding. The schema-inference read (dfutil) wants this."""
    from tensorflowonspark_tpu_torch import fs
    with fs.open(path, "rb") as f:
        return next(_iter_stream(f, verify_crc), None)


def count_records(path, verify_crc=True):
    """Number of records in a TFRecord file — metadata-rate via the
    native framing index when available (no per-record python work)."""
    if _native_ok():
        from tensorflowonspark_tpu_torch import _tfrecord_native
        from tensorflowonspark_tpu_torch import fs
        with fs.open(path, "rb") as f:
            buf = _try_mmap(f)
        if buf is not None:
            codec_reads["native"] += 1
            return len(_tfrecord_native.index_buffer(buf, verify_crc)[0])
    return sum(1 for _ in tfrecord_iterator(path, verify_crc))


def read_examples(path):
    """Yield parsed {name: (kind, values)} dicts from a TFRecord file."""
    for record in tfrecord_iterator(path):
        yield parse_example(record)


def read_batch(path, schema, verify_crc=True):
    """Dense columnar read: ``{name: ndarray[m, width]}`` for a fixed
    schema, in file order.

    ``schema``: ``{feature_name: (dtype, width)}`` with dtype
    ``"float32"``/``"int64"`` — the dense-features shape of the W&D /
    Criteo pipelines, where per-record python parsing dominates load
    time. Uses the native batch decoder when available; falls back to
    :func:`parse_example`. Raises ``ValueError`` when a record misses a
    feature or its arity differs (a dense schema is a contract, not a
    hint).
    """
    for name, (dtype, width) in schema.items():
        if dtype not in ("float32", "int64"):
            raise ValueError(
                "schema dtype for %r must be float32 or int64" % name)
    if _native_ok():
        from tensorflowonspark_tpu_torch import _tfrecord_native
        from tensorflowonspark_tpu_torch import fs
        with fs.open(path, "rb") as f:
            buf = _try_mmap(f)
        if buf is not None:
            offsets, lengths = _tfrecord_native.index_buffer(buf, verify_crc)
            codec_reads["native"] += 1
            out = {}
            for name, (dtype, width) in schema.items():
                fn = (_tfrecord_native.batch_floats if dtype == "float32"
                      else _tfrecord_native.batch_int64)
                out[name] = fn(buf, offsets, lengths, name, width)
            return out
    columns = {name: [] for name in schema}
    for i, parsed in enumerate(read_examples(path)):
        for name, (dtype, width) in schema.items():
            if name not in parsed:
                raise ValueError(
                    "record %d: feature %r missing, wrong kind, or not "
                    "%d values" % (i, name, width))
            kind, values = parsed[name]
            expect = "float" if dtype == "float32" else "int64"
            if kind != expect or len(values) != width:
                raise ValueError(
                    "record %d: feature %r missing, wrong kind, or not "
                    "%d values" % (i, name, width))
            columns[name].append(values)
    return {name: np.asarray(columns[name],
                             "float32" if schema[name][0] == "float32"
                             else "int64").reshape(len(columns[name]),
                                                   schema[name][1])
            for name in schema}


def list_tfrecord_files(directory):
    """part-* files under ``directory``, sorted (the Hadoop layout).

    Directory listing needs a real filesystem — remote schemes fail
    loudly here (fs.require_local) instead of as an os.listdir ENOENT.
    """
    from tensorflowonspark_tpu_torch import fs

    directory = fs.require_local(directory, "TFRecord shard listing")
    names = [n for n in sorted(os.listdir(directory))
             if n.startswith("part-") and not n.endswith(".crc")]
    return [os.path.join(directory, n) for n in names]
