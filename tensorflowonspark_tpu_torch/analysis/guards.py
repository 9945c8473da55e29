"""Pass 1: guarded-attribute race check.

Per class, two rules over the :mod:`core` model, both evaluated on
EFFECTIVE lock contexts — the locks held at the mutation site itself
plus every context its method can be entered under, propagated over
the intra-class call graph to a fixpoint. That is what makes the
``_apply_locked``-style convention (public method takes the lock,
private helpers mutate bare) analyzable instead of a false positive,
and a helper reachable from BOTH a locked and an unlocked path a
finding instead of a miss:

- ``unguarded`` — infer the guard set: an attribute CONSISTENTLY
  covered by some lock at one or more mutation sites (every effective
  context of that site holds it) is guarded by that lock; every other
  mutation of it that can execute without the guard — plain
  assignment, augmented assignment, an in-place mutator call
  (``self._x.pop(...)``), or any mutation in a method reachable from
  an unlocked context — is flagged. Mutations in
  ``__init__``/``__new__`` are construction, not concurrency, and are
  exempt on both sides of the inference.

- ``cross-thread`` — for classes that spawn their own threads
  (``Thread(target=self._loop)`` or a closure target), an attribute
  mutated lock-free both from a thread root and from any OTHER entry
  point (public method, another thread) is shared mutable state with
  no guard at all: the exact shape of the router-histogram /
  chaos-counter / compile-claim bugs the last four PRs fixed by hand.
  One finding per attribute.

Both rules suppress with ``# tfos: unguarded(<reason>)`` on (or one
line above) the mutation site, and baseline by the line-free identity
``Class.method:attr`` / ``Class:attr``.
"""

from tensorflowonspark_tpu_torch.analysis import core
from tensorflowonspark_tpu_torch.analysis.report import Finding


def _effective_sets(cls, contexts, method, mutation):
    """Every lock set ``mutation`` can execute under: its local locks
    joined with each entry context of its method. A closure's entry
    is unknowable from the definition site (it may run on any thread),
    so only its local locks count."""
    local = cls.expand(mutation.locks)
    if mutation.nested is not None:
        return {local}
    return {frozenset(entry | local)
            for entry in contexts[method.name]}


def _site_table(cls):
    """[(method, mutation, EFF set-of-frozensets)] for every
    non-construction mutation, plus the inferred guard map
    {attr: frozenset(locks)} — a lock guards an attr when SOME
    mutation site is covered by it in every effective context."""
    contexts = core.entry_contexts(cls)
    sites = []
    guards = {}
    for name, method in cls.methods.items():
        if name in core.CONSTRUCTION_METHODS:
            continue
        for m in method.mutations:
            eff = _effective_sets(cls, contexts, method, m)
            sites.append((method, m, eff))
            covered = frozenset.intersection(*eff) if eff else frozenset()
            if covered:
                guards.setdefault(m.attr, set()).update(covered)
    return sites, {attr: frozenset(locks)
                   for attr, locks in guards.items()}


def _mutation_roots(cls, roots, method, mutation):
    """Root tags for one mutation: a closure that is a Thread target
    roots its mutations on that thread, everything else inherits the
    enclosing method's reachability."""
    if mutation.nested is not None \
            and mutation.nested in method.thread_nested:
        return {"thread:{}.{}".format(method.name, mutation.nested)}
    return roots.get(method.name, set())


def check(models):
    """[:class:`Finding`] for a list of class models."""
    findings = []
    for cls in models:
        sites, guards = _site_table(cls)
        findings.extend(_check_unguarded(cls, sites, guards))
        findings.extend(_check_cross_thread(cls, sites, guards))
    return findings


def _check_unguarded(cls, sites, guards):
    if not guards:
        return []
    out = []
    seen = set()
    for method, m, eff in sites:
        guard = guards.get(m.attr)
        if guard is None:
            continue
        if not any(not (s & guard) for s in eff):
            continue  # every reachable context holds a guard lock
        # one finding PER SITE (same baseline key for every site of a
        # method+attr pair, so the baseline still blankets the method
        # while the inline suppression grammar stays exact: a comment
        # silences ITS line, not its siblings)
        site_id = (method.name, m.attr, m.line)
        if site_id in seen:
            continue
        seen.add(site_id)
        out.append(Finding(
            "unguarded", cls.path, m.line,
            "{}.{}:{}".format(cls.name, method.name, m.attr),
            "self.{} is guarded by {} elsewhere in {} but can be "
            "mutated without it at line {} ({})".format(
                m.attr, "/".join(sorted(guard)), cls.name, m.line,
                method.name)))
    out.sort(key=lambda f: f.line)
    return out


def _check_cross_thread(cls, sites, guards):
    if not cls.thread_targets and not any(
            m.thread_nested for m in cls.methods.values()):
        return []
    roots = core.method_roots(cls)
    by_attr = {}
    for method, m, eff in sites:
        if m.attr in guards:
            continue  # the unguarded rule owns inconsistencies
        if frozenset() not in eff:
            continue  # never reachable truly lock-free
        tags = _mutation_roots(cls, roots, method, m)
        rec = by_attr.setdefault(m.attr, {"tags": set(), "sites": []})
        rec["tags"] |= tags
        rec["sites"].append((method.name, m.line))
    findings = []
    for attr in sorted(by_attr):
        rec = by_attr[attr]
        threads = {t for t in rec["tags"] if t.startswith("thread:")}
        others = rec["tags"] - threads
        if not threads or not (others or len(threads) > 1):
            continue
        sites_sorted = sorted(set(rec["sites"]), key=lambda s: s[1])
        findings.append(Finding(
            "cross-thread", cls.path, sites_sorted[0][1],
            "{}:{}".format(cls.name, attr),
            "self.{} is mutated with no lock from {} AND {} "
            "(sites: {})".format(
                attr, ", ".join(sorted(threads)),
                ", ".join(sorted(others)) or "a second thread root",
                "; ".join("{}:{}".format(n, ln)
                          for n, ln in sites_sorted[:6])),
            # the finding is about the PAIR of roots, so a suppression
            # at ANY of its sites (the author asserting the attr's
            # discipline) silences it
            lines=[ln for _, ln in sites_sorted]))
    return findings
