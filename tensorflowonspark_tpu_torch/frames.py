"""Columnar feed frames: the wire format of the data plane — the port's
copy of ``tensorflowonspark_tpu/frames.py``, byte for byte the same
format, so either package decodes the other's frames.

The reference ships feed data as pickled lists of per-record tuples
through a multiprocessing manager proxy (``TFSparkNode._train`` →
``TFManager`` queues; SURVEY.md §3.2 hot path) — every byte is pickled,
TCP-framed, and unpickled per hop, and the consumer re-stacks records one
by one. On a host whose CPU budget is shared with the accelerator runtime
(the common accelerator-host shape), those copies ARE the feed ceiling.

Here the feeder stacks records into contiguous per-column arrays once,
and the frame codec moves them as raw bytes:

- :class:`ColumnarChunk` — a batch of N records as column arrays
  (positional or named), sliceable without touching the data.
- :func:`encode` — object → list of buffers ``[u32 hdrlen][hdr pickle]
  [col bytes]...``; column payloads are raw array memory, never pickled.
  Arbitrary objects (markers, legacy record lists) embed in the header.
- :func:`encode_multi` — several objects → ONE frame (one transport
  message). The feeder coalesces tiny chunks and trailing markers this
  way so per-message fixed costs (header pickle, ring wakeup, slot
  bookkeeping) amortize across them — the small-batch regime pays those
  costs per chunk where the bulk regime amortizes them per 38MB frame.
- :func:`decode` — memoryview → object; column arrays come back as
  ZERO-COPY views into the source buffer (callers that outlive the
  buffer must ``.materialize()``). Multi-object frames decode to a
  :class:`FrameList` (so a frame carrying a pickled *record list* stays
  distinguishable from a frame carrying several objects).

Used by the shm ring transport (shm.py) where the buffers land in the
mmap with a single gather-memcpy; the manager-queue transport pickles
:class:`ColumnarChunk` whole (protocol 5 moves the column arrays as
single out-of-band buffers, so even that path stacks exactly once).
"""

import pickle
import struct

import numpy as np

_LEN = struct.Struct("<I")


class FrameList(list):
    """``decode()`` result for a multi-object frame (``encode_multi``).

    A plain ``list`` would be ambiguous: legacy record-list chunks also
    travel as one pickled list inside an object frame, and consumers
    (DataFeed) treat those as a single segment of records. The subclass
    marks "these are SEPARATE feed items sharing one transport message".
    """

    __slots__ = ()


class ColumnarChunk(object):
    """N records stacked column-wise.

    ``cols``: list of arrays, each with leading dim N (record index).
    ``names``: optional tuple of field names (dict-shaped records);
    positional (tuple-shaped records) when None.
    """

    __slots__ = ("cols", "names", "scalar")

    def __init__(self, cols, names=None, scalar=False):
        self.cols = list(cols)
        self.names = tuple(names) if names is not None else None
        self.scalar = scalar  # records were bare values, not tuples/dicts

    def __len__(self):
        return 0 if not self.cols else int(self.cols[0].shape[0])

    def slice(self, start, stop):
        """View of records [start:stop) — no data movement."""
        return ColumnarChunk([c[start:stop] for c in self.cols], self.names,
                             self.scalar)

    def materialize(self):
        """Own the memory (copy out of any transient buffer).

        Must COPY views: ``np.ascontiguousarray`` returns an already-
        contiguous view unchanged, which for ring-backed ``frombuffer``
        views would alias memory the producer is about to overwrite —
        silent data corruption. OWNDATA is the contract.
        """
        self.cols = [c if c.flags["OWNDATA"] and c.flags["C_CONTIGUOUS"]
                     else np.array(c, order="C", copy=True)
                     for c in self.cols]
        return self

    def record(self, i):
        """Record ``i`` in the original row shape (value, tuple, or dict)."""
        if self.scalar:
            return self.cols[0][i]
        vals = [c[i] for c in self.cols]
        if self.names is None:
            return tuple(vals)
        return dict(zip(self.names, vals))

    def records(self):
        """Back to row-major records (compat path, copies)."""
        return [self.record(i) for i in range(len(self))]

    @classmethod
    def from_records(cls, records, names=None):
        """Stack row records (bare values, tuples, or dicts) into columns.

        Raises TypeError/ValueError for ragged or non-array-able records —
        callers fall back to the object frame.
        """
        if not records:
            return cls([], names)
        first = records[0]
        if isinstance(first, dict):
            names = tuple(first.keys()) if names is None else tuple(names)
            cols = [np.stack([np.asarray(r[k]) for r in records])
                    for k in names]
            return cls(cols, names)
        if isinstance(first, (tuple, list)):
            width = len(first)
            cols = [np.stack([np.asarray(r[i]) for r in records])
                    for i in range(width)]
            return cls(cols, None)
        return cls([np.stack([np.asarray(r) for r in records])], None,
                   scalar=True)


def concat(chunks):
    """Concatenate ColumnarChunks (one copy; used for batch re-slicing)."""
    nonempty = [c for c in chunks if len(c)]
    if not nonempty:
        # All-empty input: preserve the shape metadata of the first chunk
        # so downstream column lookups still resolve.
        first = chunks[0]
        return ColumnarChunk(first.cols, first.names, first.scalar)
    chunks = nonempty
    if len(chunks) == 1:
        return chunks[0]
    names = chunks[0].names
    width = len(chunks[0].cols)
    cols = [np.concatenate([c.cols[i] for c in chunks]) for i in range(width)]
    return ColumnarChunk(cols, names)


def _part_meta(obj, payloads):
    """Header entry for one object; column payload buffers append to
    ``payloads``."""
    if isinstance(obj, ColumnarChunk):
        cols = [np.ascontiguousarray(c) for c in obj.cols]
        payloads.extend(memoryview(c).cast("B") for c in cols)
        return {"k": "cols", "names": obj.names, "scalar": obj.scalar,
                "meta": [(c.dtype.str, c.shape) for c in cols]}
    return {"k": "obj", "obj": obj}


def _decode_part(hdr, view, off):
    """One header entry → (object, next payload offset). Column arrays are
    zero-copy views into ``view``."""
    if hdr["k"] == "obj":
        return hdr["obj"], off
    cols = []
    for dtype_str, shape in hdr["meta"]:
        dt = np.dtype(dtype_str)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        arr = np.frombuffer(view, dtype=dt, count=n, offset=off)
        cols.append(arr.reshape(shape))
        off += n * dt.itemsize
    return ColumnarChunk(cols, hdr["names"], hdr.get("scalar", False)), off


def encode(obj):
    """object → list of byte-like buffers forming one frame."""
    payloads = []
    hdr = pickle.dumps(_part_meta(obj, payloads), protocol=5)
    return [_LEN.pack(len(hdr)), hdr] + payloads


def encode_multi(objs):
    """Several objects → ONE frame (one transport message).

    Column payloads of every ColumnarChunk ride as raw bytes after a
    single pickled header describing all parts, so N tiny objects cost
    one message's fixed overhead instead of N. ``decode`` returns them
    as a :class:`FrameList` in order.
    """
    payloads = []
    parts = [_part_meta(obj, payloads) for obj in objs]
    hdr = pickle.dumps({"k": "multi", "parts": parts}, protocol=5)
    return [_LEN.pack(len(hdr)), hdr] + payloads


def frame_bytes(buffers):
    """Total wire bytes of an :func:`encode`/:func:`encode_multi`
    result — the PHYSICAL transfer cost (header + raw column payloads
    as they sit in memory). This is the one place ship-byte accounting
    reads: int8 KV shipments are priced by their codes+scales
    buffers, never by the logical dequantized size."""
    total = 0
    for b in buffers:
        total += memoryview(b).nbytes
    return total


def decode(view):
    """One frame (memoryview/bytes) → object (or FrameList for multi).

    ColumnarChunk columns are zero-copy views into ``view``.
    """
    view = memoryview(view)
    (hdrlen,) = _LEN.unpack_from(view, 0)
    hdr = pickle.loads(view[4:4 + hdrlen])
    off = 4 + hdrlen
    if hdr["k"] == "multi":
        out = FrameList()
        for part in hdr["parts"]:
            obj, off = _decode_part(part, view, off)
            out.append(obj)
        return out
    obj, _ = _decode_part(hdr, view, off)
    return obj
