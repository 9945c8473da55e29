"""Durable control-plane state: the fencing-epoch journal — the port's
copy of ``tensorflowonspark_tpu/controlstate.py`` (stdlib only; the
file format is the reference's, byte for byte, so a journal written by
either package reads back in the other).

Lease epochs are the cluster's split-brain guard: every serving
identity beats with a monotonically minted epoch, and a stale beat is
answered FENCED. That guarantee lived entirely in the reservation
server's memory — kill the driver and a restarted server, having
forgotten every floor, would happily re-mint epoch 1 for an identity
whose real incumbent holds epoch 7. The incumbent's next beat would
then be FENCED by its own *past*, or worse, two replicas could both
hold "current" epochs for one identity. This module is the fix: a
small append-only journal the server fsyncs BEFORE an epoch leaves the
building, so monotonicity survives restart by construction.

Design (deliberately boring — this is the safety floor everything else
stands on):

- **Append-only JSON lines.** One record per line:
  ``{"t": "epoch", "id": <identity>, "e": <int>}`` for lease-epoch
  mints, ``{"t": "control", "e": <int>}`` for control-epoch mints
  (router leadership fencing), ``{"t": "lease", "id": ..., "meta":
  {...}}`` for the latest lease metadata (addr/model/host hints a
  restarted driver can show while replicas re-announce).
- **fsync before reply.** :meth:`record_epoch` returns only after the
  bytes are on disk. A crash landed between fsync and the caller
  seeing the epoch leaves the journal's floor >= anything ever
  *returned* — the safe direction (a floor may exceed reality, never
  trail it).
- **Torn tail is tolerated, torn middle is not.** A crash mid-append
  can leave exactly one partial record — the final line. Recovery
  drops an unparseable FINAL line silently. An unparseable line
  *followed by valid records* means the file was corrupted some other
  way (bit rot, concurrent writer, truncation), and recovery raises
  :class:`JournalCorrupt` LOUDLY: silently continuing could re-mint a
  stale epoch, exactly the failure this journal exists to prevent.
  The operator decides (restore a copy, or deliberately move the file
  aside to accept a cold start) — the code never decides for them.
- **Compaction on rewrite.** When the live file accumulates
  ``compact_every`` appends past the last snapshot, the journal
  rewrites itself as one snapshot record per identity (+ control
  epoch) into a temp file, fsyncs it, and atomically renames over the
  live path (then fsyncs the directory so the rename itself is
  durable). Crash at ANY point leaves either the old complete file or
  the new complete file — never a mix.
"""

import json
import logging
import os
import threading

logger = logging.getLogger(__name__)

#: Default number of appended records after which the journal compacts
#: itself on the next write. Small enough that the file stays a few KB
#: for steady fleets, large enough that compaction is rare.
DEFAULT_COMPACT_EVERY = 4096


class JournalCorrupt(RuntimeError):
    """The journal has an unparseable record that is NOT the final
    line — not a torn append but real corruption. Refusing to load is
    the only safe answer: guessing at floors risks re-minting a stale
    epoch, the exact split-brain this journal prevents."""


class ControlJournal(object):
    """Append-only, fsync'd journal of fencing-epoch floors.

    Thread-safe: every mutation happens under one lock, and writes hit
    disk before the method returns. The reservation server owns the
    canonical instance; tests drive it directly to property-test crash
    interleavings (see tests/test_torch_controlstate.py).
    """

    def __init__(self, path, compact_every=DEFAULT_COMPACT_EVERY):
        self.path = str(path)
        self.compact_every = int(compact_every)
        self._lock = threading.Lock()
        self._epochs = {}        # identity -> highest journaled epoch
        self._control_epoch = 0  # highest journaled control epoch
        self._meta = {}          # identity -> latest lease metadata
        self._appends = 0        # records appended since last snapshot
        self._fh = None
        with self._lock:
            self._recover_locked()
            self._open_append_locked()

    # -- recovery ------------------------------------------------------

    def _recover_locked(self):
        """Replay the journal into the in-memory floors. Tolerates a
        torn FINAL line (crash mid-append); raises JournalCorrupt on
        any earlier unparseable record."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as fh:
            raw = fh.read()
        lines = raw.split(b"\n")
        # a well-formed file ends with a newline, so the split's last
        # element is empty; anything else is a torn tail candidate
        records, bad_at = [], None
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line.decode("utf-8")))
            except (ValueError, UnicodeDecodeError):
                bad_at = i
                break
        if bad_at is not None:
            trailing = any(l.strip() for l in lines[bad_at + 1:])
            if trailing:
                raise JournalCorrupt(
                    "journal {} has an unparseable record at line {} "
                    "with valid records after it — refusing to load "
                    "(a guessed floor could re-mint a stale epoch); "
                    "restore the journal or deliberately move it "
                    "aside to accept a cold start".format(
                        self.path, bad_at + 1))
            logger.warning(
                "journal %s: dropping torn final record (crash "
                "mid-append) — %d complete records recovered",
                self.path, len(records))
            # truncate the torn fragment away: otherwise the next
            # append would share its line and the FOLLOWING recovery
            # would drop an acknowledged record with it
            keep = sum(len(l) + 1 for l in lines[:bad_at])
            with open(self.path, "r+b") as fh:
                fh.truncate(keep)
                fh.flush()
                os.fsync(fh.fileno())
        for rec in records:
            t = rec.get("t")
            if t == "epoch":
                ident = rec.get("id")
                self._epochs[ident] = max(
                    self._epochs.get(ident, 0), int(rec.get("e", 0)))
            elif t == "control":
                self._control_epoch = max(
                    self._control_epoch, int(rec.get("e", 0)))
            elif t == "lease":
                self._meta[rec.get("id")] = rec.get("meta") or {}
            # unknown record types are skipped: a newer writer may add
            # kinds an older reader can ignore without losing safety
            # (floors only ever come from records it DOES understand)
        self._appends = len(records)
        if records:
            logger.info(
                "journal %s recovered: %d identities (max epoch %s), "
                "control epoch %d", self.path, len(self._epochs),
                max(self._epochs.values()) if self._epochs else None,
                self._control_epoch)

    def _open_append_locked(self):
        self._fh = open(self.path, "ab")

    # -- views ---------------------------------------------------------

    def epoch_floors(self):
        """{identity: floor} — every epoch ever durably minted (stable
        copy). A restarted server seeds its mint state from this."""
        with self._lock:
            return dict(self._epochs)

    def epoch_floor(self, identity):
        with self._lock:
            return self._epochs.get(identity, 0)

    def control_floor(self):
        """Highest durably minted control epoch (0 = never minted)."""
        with self._lock:
            return self._control_epoch

    def lease_meta(self):
        """{identity: latest journaled lease metadata} (stable copy)."""
        with self._lock:
            return {k: dict(v) for k, v in self._meta.items()}

    # -- writes (fsync before return) ----------------------------------

    def record_epoch(self, identity, epoch):
        """Durably record that ``epoch`` was minted for ``identity``.
        MUST be called before the epoch is returned to any caller: the
        journal's floor must always cover everything the outside world
        has seen. Returns the epoch for chaining."""
        with self._lock:
            epoch = int(epoch)
            self._epochs[identity] = max(
                self._epochs.get(identity, 0), epoch)
            self._append_locked(
                {"t": "epoch", "id": identity, "e": epoch})
        return epoch

    def record_control(self, epoch):
        """Durably record a minted control epoch (router leadership
        fence). Same fsync-before-return contract as record_epoch."""
        with self._lock:
            epoch = int(epoch)
            self._control_epoch = max(self._control_epoch, epoch)
            self._append_locked({"t": "control", "e": epoch})
        return epoch

    def record_lease_meta(self, identity, meta):
        """Durably note ``identity``'s latest lease metadata (small
        JSON-able dict: addr/model/host). Advisory — floors never
        depend on it — so it shares the append path for simplicity."""
        with self._lock:
            self._meta[identity] = dict(meta or {})
            self._append_locked(
                {"t": "lease", "id": identity,
                 "meta": self._meta[identity]})

    def _append_locked(self, rec):
        line = json.dumps(rec, separators=(",", ":")).encode("utf-8") \
            + b"\n"
        self._fh.write(line)
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._appends += 1
        if self._appends >= self.compact_every:
            self._compact_locked()

    # -- compaction ----------------------------------------------------

    def compact(self):
        """Rewrite the journal as one snapshot record per identity.
        Atomic: crash at any point leaves old-complete or new-complete,
        never a mix."""
        with self._lock:
            self._compact_locked()

    def _compact_locked(self):
        tmp = self.path + ".compact"
        with open(tmp, "wb") as fh:
            for ident, epoch in sorted(self._epochs.items(),
                                       key=lambda kv: str(kv[0])):
                fh.write(json.dumps(
                    {"t": "epoch", "id": ident, "e": epoch},
                    separators=(",", ":")).encode("utf-8") + b"\n")
            if self._control_epoch:
                fh.write(json.dumps(
                    {"t": "control", "e": self._control_epoch},
                    separators=(",", ":")).encode("utf-8") + b"\n")
            for ident, meta in sorted(self._meta.items(),
                                      key=lambda kv: str(kv[0])):
                fh.write(json.dumps(
                    {"t": "lease", "id": ident, "meta": meta},
                    separators=(",", ":")).encode("utf-8") + b"\n")
            fh.flush()
            os.fsync(fh.fileno())
        if self._fh is not None:
            self._fh.close()
        os.replace(tmp, self.path)
        # fsync the directory so the rename itself survives power loss
        dirfd = os.open(os.path.dirname(os.path.abspath(self.path)),
                        os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        self._appends = len(self._epochs) + len(self._meta) \
            + (1 if self._control_epoch else 0)
        self._open_append_locked()
        logger.info("journal %s compacted to %d records",
                    self.path, self._appends)

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
