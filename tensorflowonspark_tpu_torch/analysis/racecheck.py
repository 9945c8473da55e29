"""Driver for ``python -m tensorflowonspark_tpu_torch.analysis``: run
the three concurrency passes over a file tree (by default the port's
package), apply inline suppressions and the checked-in baseline, and
render the verdict through the shared report helper.

Workflow (the reference's docs/static_analysis.md has the long form):

- a NEW finding fails the build. Fix it, or — if it is provably
  benign (single-writer by construction, join-by-interpreter-exit,
  ...) — either suppress it inline::

      self._steps += 1  # tfos: unguarded(scheduler thread is the only writer)

  or add its ``key`` to ``analysis/baseline.json`` with a written
  ``reason``. Both demand the reason: an empty suppression reason is
  itself a finding, and a baseline entry without one fails the gate.
- a STALE baseline entry (the finding it matched is gone) is a
  warning: prune it with the fix that removed it.

Exit codes: 0 clean (modulo baseline), 1 findings, 2 usage/IO errors.
Stdlib only (``ast`` + ``json``); the whole package scans in well
under a second, so the gate is free as a test prerequisite.
"""

import argparse
import ast
import json
import os
import sys

from tensorflowonspark_tpu_torch.analysis import core, guards, lifecycle, \
    lockorder, report

#: finding rule -> the suppression tag that silences it
SUPPRESS_TAGS = {
    "unguarded": "unguarded",
    "cross-thread": "unguarded",
    "lock-order": "lock-order",
    "lock-self-nest": "lock-order",
    "thread-daemon": "daemon",
    "thread-name": "daemon",
    "thread-unjoined": "unjoined",
    "retriable-swallow": "swallow",
}

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


def iter_py_files(paths):
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def analyze_file(path, rel=None):
    """(findings, suppressed_count, bad_suppression_findings) for one
    file. ``rel`` overrides the path recorded on findings (the
    repo-relative form the baseline keys on)."""
    rel = rel if rel is not None else path
    with open(path) as f:
        source = f.read()
    tree = ast.parse(source, filename=path)
    marks = core.scan_suppressions(source)
    models = core.build_class_models(tree, rel)
    found = []
    found.extend(guards.check(models))
    found.extend(lockorder.check(models))
    found.extend(lifecycle.check(tree, rel))
    kept, suppressed, bad = [], 0, []
    for f in found:
        tag = SUPPRESS_TAGS.get(f.rule, f.rule)
        hit = None
        # a suppression counts on ANY of the finding's site lines (or
        # the line above each) — multi-site findings like cross-thread
        # accept it at whichever site the author annotates
        for site in f.lines:
            for line in (site, site - 1):
                for mtag, reason in marks.get(line, ()):
                    if mtag == tag:
                        hit = (line, reason)
        if hit is None:
            kept.append(f)
        elif not hit[1]:
            bad.append(report.Finding(
                "bad-suppression", rel, hit[0], f.ident,
                "suppression '# tfos: {}(...)' has an EMPTY reason — "
                "the grammar demands one (suppressing: {})".format(
                    tag, f.key)))
        else:
            suppressed += 1
    return kept, suppressed, bad


def load_baseline(path):
    """{key: reason} plus a list of malformed-entry findings."""
    with open(path) as f:
        doc = json.load(f)
    entries, bad = {}, []
    for entry in doc.get("entries", []):
        key = entry.get("key")
        reason = (entry.get("reason") or "").strip()
        if not key:
            continue
        if not reason:
            bad.append(report.Finding(
                "baseline-missing-reason", os.path.basename(path), 0,
                key, "baseline entry has no written reason: "
                "{}".format(key)))
        entries[key] = reason
    return entries, bad


def run(paths, baseline_path, emit_skeleton=False,
        out=sys.stdout, err=sys.stderr):
    findings, grammar_bad, baseline_bad = [], [], []
    suppressed = files = 0
    for path in iter_py_files(paths):
        rel = os.path.relpath(path, os.path.dirname(_PKG_ROOT)) \
            if os.path.isabs(path) else path
        files += 1
        kept, nsup, bad = analyze_file(path, rel=rel)
        findings.extend(kept)
        grammar_bad.extend(bad)
        suppressed += nsup
    baselined = 0
    stale = ()
    if baseline_path:
        try:
            entries, baseline_bad = load_baseline(baseline_path)
        except (OSError, ValueError) as e:
            print("racecheck: cannot read baseline {}: {}".format(
                baseline_path, e), file=err)
            return 2
        matched = {f.key for f in findings if f.key in entries}
        baselined = len([f for f in findings if f.key in entries])
        findings = [f for f in findings if f.key not in entries]
        stale = sorted(set(entries) - matched)
    # grammar violations (empty-reason suppressions) and malformed
    # baseline entries join AFTER the baseline filter: the
    # mandatory-reason rule must not itself be baselineable away
    findings.extend(grammar_bad)
    findings.extend(baseline_bad)
    if emit_skeleton:
        # grammar violations are not baselineable — fix the comment /
        # the entry, don't launder it through the skeleton
        baselineable = sorted(
            {f.key for f in findings
             if f.rule not in ("bad-suppression",
                               "baseline-missing-reason")})
        json.dump({"entries": [
            {"key": key, "reason": ""} for key in baselineable]},
            out, indent=2)
        out.write("\n")
        return 1 if findings else 0
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return report.emit(
        "racecheck", findings,
        ok_summary="{} file(s), {} finding(s) suppressed inline, {} "
                   "baselined, 0 new".format(files, suppressed,
                                             baselined),
        stale=stale, out=out, err=err)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="racecheck",
        description="Concurrency lint: guarded-attribute races, "
                    "lock-order cycles, thread-lifecycle rules.")
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to scan (default: the installed "
             "tensorflowonspark_tpu_torch package)")
    parser.add_argument(
        "--baseline", default=None,
        help="baseline JSON ('none' disables; default: the package's "
             "analysis/baseline.json when scanning the package, none "
             "for explicit paths)")
    parser.add_argument(
        "--emit-baseline", action="store_true",
        help="print a baseline-entry skeleton for the current NEW "
             "findings (reasons left empty — write them before "
             "committing)")
    args = parser.parse_args(argv)
    paths = args.paths or [_PKG_ROOT]
    if args.baseline is None:
        # only the IMPLICIT default may quietly not exist (a fresh
        # checkout before any baseline is written); an explicit
        # --baseline path that is missing is an IO error below — a CI
        # whose baseline file moved must fail loudly, not silently
        # lint baseline-less (use `--baseline none` to disable)
        baseline = DEFAULT_BASELINE if not args.paths else None
        if baseline and not os.path.exists(baseline):
            baseline = None
    elif args.baseline == "none":
        baseline = None
    else:
        baseline = args.baseline
    return run(paths, baseline, emit_skeleton=args.emit_baseline)


if __name__ == "__main__":
    sys.exit(main())
