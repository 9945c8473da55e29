"""Pluggable filesystem registry for remote path schemes — the port's
copy of ``tensorflowonspark_tpu/fs.py``.

Reference parity gap, made explicit: the reference leans on TF's
``tf.io.gfile`` + a Hadoop ``defaultFS`` for ``hdfs://`` model/export
paths (``TFNode.hdfs_path``, ``TFNodeContext.absolute_path`` —
SURVEY.md §2 "TFNode" row). This framework bundles no HDFS/GCS client,
so remote schemes are a *registration point* instead of a silent
pass-through: callers register ``scheme -> opener`` once (e.g. backed by
``fsspec``, ``gcsfs``, or a site-local client) and every path consumer
(``ctx.absolute_path``, TFRecord readers, checkpoint/export helpers)
resolves through here. Unregistered remote schemes fail loudly with a
how-to-fix error rather than a confusing downstream ENOENT.

    from tensorflowonspark_tpu_torch import fs
    fs.register_filesystem("gs", my_gcs_open)      # open(path, mode)
    with fs.open("gs://bucket/data.tfrecord", "rb") as f: ...

Local paths (``file://`` or bare) use the builtin filesystem and never
need registration.
"""

import builtins
import os
import re

_SCHEME_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")

_REGISTRY = {}


class UnsupportedSchemeError(RuntimeError):
    """A remote path scheme nobody registered an opener for."""


def require_local(path, what):
    """Fail loudly when a directory-level consumer gets a remote path.

    The registry serves per-FILE opens (TFRecord read/write). Consumers
    that need directory semantics — orbax checkpoints, model export,
    shard listing — require a local/NFS path: an ``opener`` can't
    makedirs/listdir, and orbax brings its own remote backends. Without
    this guard a remote path would be silently written to a local
    directory literally named ``gs:`` (os.path.abspath of a URL).
    """
    if scheme_of(path) is not None:
        raise UnsupportedSchemeError(
            "{} requires a local or NFS path, got {!r}: the fs registry "
            "serves per-file opens only (directory semantics — makedirs/"
            "listdir/atomic rename — need a real filesystem; for remote "
            "checkpoints use orbax's own storage backends, for remote "
            "TFRecords read/write individual files via fs.open)".format(
                what, path))
    return local_part(path)


def scheme_of(path):
    """'hdfs' for 'hdfs://x/y', None for local/bare paths.

    Accepts PathLike (fspath'd first) — pathlib users predate the
    registry and must keep working.
    """
    m = _SCHEME_RE.match(os.fspath(path))
    if not m:
        return None
    s = m.group(1).lower()
    return None if s == "file" else s


def register_filesystem(scheme, opener):
    """Register ``opener(path, mode) -> file object`` for a scheme.

    Returns the previous opener (None if first registration) so tests
    and apps can restore.
    """
    scheme = scheme.lower().rstrip(":")
    prev = _REGISTRY.get(scheme)
    _REGISTRY[scheme] = opener
    _FSSPEC_NEGATIVE.pop(scheme, None)  # re-arm the fallback probe path
    return prev


def unregister_filesystem(scheme):
    _REGISTRY.pop(scheme.lower().rstrip(":"), None)


def is_supported(path):
    """True if :func:`open` can serve this path right now."""
    s = scheme_of(path)
    return s is None or _resolve_opener(s)[0] is not None


def ensure_supported(path):
    """Raise the canonical UnsupportedSchemeError (probe cause chained)
    for a path :func:`open` cannot serve; returns the path otherwise.
    Path consumers that want to fail EARLY (ctx.absolute_path) call this
    instead of duplicating — and drifting from — open()'s message."""
    s = scheme_of(path)
    if s is None:
        return path
    opener, probe_error = _resolve_opener(s)
    if opener is None:
        raise UnsupportedSchemeError(_unsupported_msg(s, path, probe_error)) \
            from probe_error
    return path


def clear_probe_cache():
    """Forget cached fsspec probe failures (e.g. after installing a
    protocol package mid-process)."""
    _FSSPEC_NEGATIVE.clear()


def local_part(path):
    """Strip a file:// prefix; other schemes are returned untouched."""
    path = os.fspath(path)
    if path.startswith("file://"):
        return path[len("file://"):]
    return path


#: schemes fsspec could NOT serve, with the probe error (cleared by an
#: explicit register_filesystem for the scheme): failed plugin imports
#: are not cached in sys.modules, so re-probing per path would redo the
#: whole import attempt in path-resolution loops.
_FSSPEC_NEGATIVE = {}


def _resolve_opener(scheme):
    """(opener, probe_error) for a scheme: explicit registration first,
    then a cached ``fsspec`` protocol fallback.

    fsspec ships in this image and brings protocol plugins
    (``memory://`` out of the box; ``hdfs://`` via pyarrow; ``gs://`` /
    ``s3://`` wherever the extras are installed) — the role Hadoop's
    FileSystem registry played for the reference's ``defaultFS`` paths.
    """
    opener = _REGISTRY.get(scheme)
    if opener is not None:
        return opener, None
    if scheme in _FSSPEC_NEGATIVE:
        return None, _FSSPEC_NEGATIVE[scheme]
    try:
        import fsspec
        fsspec.get_filesystem_class(scheme)  # raises for unknown schemes
    except Exception as e:  # noqa: BLE001 - surfaced via the raise below
        _FSSPEC_NEGATIVE[scheme] = e
        return None, e

    def opener(path, mode):
        import fsspec as _fsspec
        return _fsspec.open(path, mode).open()
    # setdefault: a concurrently registered EXPLICIT opener must win
    return _REGISTRY.setdefault(scheme, opener), None


def _unsupported_msg(s, path, probe_error):
    return (
        "no filesystem registered for {!r} paths ({!r}) and fsspec "
        "could not serve the scheme ({!r}); this framework bundles "
        "no remote-FS client (the reference used TF's gfile+Hadoop)."
        " Either install an fsspec protocol package (gcsfs/s3fs/...) "
        "— the failed probe is cached for this process, so afterwards "
        "call fs.clear_probe_cache() (or restart) — or register an "
        "opener once per process:\n"
        "    from tensorflowonspark_tpu_torch import fs\n"
        "    fs.register_filesystem({!r}, opener)  # opener(path, "
        "mode)".format(s, path, probe_error, s))


def open(path, mode="rb"):  # noqa: A001 - deliberate builtin shadow
    """Open a path through the registered filesystem for its scheme."""
    path = os.fspath(path)
    s = scheme_of(path)
    if s is None:
        return builtins.open(local_part(path), mode)
    opener, probe_error = _resolve_opener(s)
    if opener is None:
        raise UnsupportedSchemeError(_unsupported_msg(s, path, probe_error)) \
            from probe_error
    return opener(path, mode)
