"""Pass 2: lock-order audit.

Builds each class's lock-acquisition graph — an edge A->B for every
place B is acquired while A is held, from nested ``with`` statements
directly and from intra-class calls (a method that acquires B, called
under A, is an A->B edge at the call site; acquisition sets propagate
transitively to a fixpoint). Two findings:

- ``lock-order`` — a cycle (A-under-B in one method, B-under-A in
  another): the two-thread deadlock shape PRs 6 and 13 hardened by
  hand (supervisor-quiesce vs rolling-drain, controller vs engine
  ``_cv``). One finding per cycle, keyed on the canonical rotation so
  the baseline identity is stable.
- ``lock-self-nest`` — re-acquiring a non-reentrant ``Lock`` already
  held (directly, via a call chain, or via a
  ``Condition(self._lock)`` alias): not an ordering hazard but a
  guaranteed single-thread deadlock.

Suppress with ``# tfos: lock-order(<reason>)`` on the acquisition
site named in the finding (e.g. a ``Condition.wait`` that releases
the outer lock before the inner acquisition runs — the one shape the
AST cannot see).
"""

from tensorflowonspark_tpu_torch.analysis import core
from tensorflowonspark_tpu_torch.analysis.report import Finding


def _acquired_closure(cls):
    """{method: frozenset(locks)} — locks each method may acquire,
    directly or through intra-class calls, to a fixpoint."""
    acquired = {name: set(m.acquires) for name, m in cls.methods.items()}
    for _ in range(len(cls.methods) + 1):
        changed = False
        for name, method in cls.methods.items():
            for site in method.calls:
                if site.callee not in cls.methods:
                    continue
                before = len(acquired[name])
                acquired[name] |= acquired[site.callee]
                changed = changed or len(acquired[name]) > before
        if not changed:
            break
    return acquired


def _edges(cls):
    """{(outer, inner): (method, line)} — first witness per edge."""
    acquired = _acquired_closure(cls)
    edges = {}
    for name, method in cls.methods.items():
        for outer, inner, line in method.with_edges:
            edges.setdefault((outer, inner), (name, line))
        for site in method.calls:
            if site.callee not in cls.methods:
                continue
            held = cls.expand(site.locks)
            for outer in held:
                for inner in acquired[site.callee]:
                    edges.setdefault((outer, inner),
                                     (name, site.line))
    return edges


def _cycles(edges):
    """Canonicalized simple cycles in the edge dict (tiny graphs:
    lock counts per class are single digits, so a DFS over all
    simple paths is exact and cheap)."""
    adj = {}
    for (a, b) in edges:
        if a != b:
            adj.setdefault(a, set()).add(b)
    seen = set()
    cycles = []

    def dfs(start, node, path):
        for nxt in sorted(adj.get(node, ())):
            if nxt == start and len(path) > 1:
                rot = min(range(len(path)),
                          key=lambda i: path[i])
                canon = tuple(path[rot:] + path[:rot])
                if canon not in seen:
                    seen.add(canon)
                    cycles.append(list(canon))
            elif nxt not in path and nxt > start:
                # only walk nodes > start: each cycle is discovered
                # exactly once, from its smallest member
                dfs(start, nxt, path + [nxt])

    for start in sorted(adj):
        dfs(start, start, [start])
    return cycles


def check(models):
    findings = []
    for cls in models:
        edges = _edges(cls)
        for (a, b), (method, line) in sorted(edges.items()):
            if a == b and cls.locks.get(a) == "Lock":
                findings.append(Finding(
                    "lock-self-nest", cls.path, line,
                    "{}:{}".format(cls.name, a),
                    "non-reentrant Lock self.{} is re-acquired while "
                    "already held (via {}, line {}); threading.Lock "
                    "deadlocks on re-entry".format(a, method, line)))
        for cycle in _cycles(edges):
            path = cycle + [cycle[0]]
            witness = []
            for i in range(len(cycle)):
                method, line = edges[(path[i], path[i + 1])]
                witness.append("{} under {} at {}:{}".format(
                    path[i + 1], path[i], method, line))
            findings.append(Finding(
                "lock-order", cls.path,
                edges[(path[0], path[1])][1],
                "{}:{}".format(cls.name, "->".join(path)),
                "lock-order cycle in {}: {} — two threads taking "
                "these in opposite order deadlock".format(
                    cls.name, "; ".join(witness))))
    return findings
