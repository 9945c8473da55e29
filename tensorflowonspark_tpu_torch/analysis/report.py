"""Shared finding / exit-code report helper for the repo's lint gates.

A lint gate is a pure-python drift check that either agrees with the
tree or prints an actionable list and exits 1, and every gate renders
through this ONE helper: a gate that formats its failures differently
from its sibling is a gate operators learn to skim past. Pure python,
no third-party imports: a gate must be safe to run before anything
heavy is importable.
"""

import sys


class Finding(object):
    """One verified lint finding.

    ``rule`` names the check (``unguarded``, ``lock-order``, ...),
    ``path``/``line`` locate it, ``ident`` is the STABLE identity the
    baseline keys on — file-relative and line-free, so reformatting a
    file does not churn the baseline (``Class.method:attr`` for guard
    findings, ``Class:a->b->a`` for lock cycles, ...). ``message`` is
    the human sentence."""

    def __init__(self, rule, path, line, ident, message, lines=None):
        self.rule = str(rule)
        self.path = str(path)
        self.line = int(line or 0)
        self.ident = str(ident)
        self.message = str(message)
        #: every source line an inline suppression may sit on — a
        #: multi-site finding (e.g. cross-thread, which pairs a
        #: thread-root site with a public one) accepts a suppression
        #: at ANY of its sites; defaults to the anchor line
        self.lines = tuple(lines) if lines else (self.line,)

    @property
    def key(self):
        """Baseline identity: ``rule:path:ident`` (no line numbers)."""
        return "{}:{}:{}".format(self.rule, self.path, self.ident)

    def __repr__(self):
        return "Finding({}:{}: [{}] {})".format(
            self.path, self.line, self.rule, self.message)


def emit(gate, findings, ok_summary="", stale=(), notes=(),
         out=sys.stdout, err=sys.stderr):
    """Render a gate's verdict and return its exit code.

    ``findings``: NEW findings (suppressed/baselined ones are the
    caller's bookkeeping — pass what should fail the build).
    ``ok_summary``: the one green line (e.g. ``"81 families, code and
    docs agree"``). ``stale``: baseline keys that no longer match any
    finding — a warning, not a failure (the fix landed; the entry
    should be pruned). ``notes``: extra context lines printed either
    way. Exit code 0 when ``findings`` is empty, 1 otherwise."""
    for note in notes:
        print("{}: {}".format(gate, note), file=out)
    for key in stale:
        print("{} WARNING: stale baseline entry (no matching finding; "
              "prune it): {}".format(gate, key), file=err)
    if findings:
        print("{} FAILED ({} finding(s)):".format(gate, len(findings)),
              file=err)
        for f in findings:
            where = "{}:{}".format(f.path, f.line) if f.line else f.path
            print("  - {}: [{}] {}".format(where, f.rule, f.message),
                  file=err)
            print("      key: {}".format(f.key), file=err)
        return 1
    print("{}: {}".format(gate, ok_summary or "clean"), file=out)
    return 0
