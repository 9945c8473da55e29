"""The port's concurrency lint: AST-based static analysis as a gate.

A copy of the JAX package's ``analysis`` plane, so the port lints itself
with nothing of that package installed. Three passes, stdlib ``ast``
only:

1. **Guarded-attribute race check** (:mod:`guards`) — per class, infer
   the guard set (attributes mutated inside ``with self._lock`` /
   ``with self._cv`` / any ``threading.Lock|RLock|Condition`` attribute
   anywhere in the class) and flag every mutation, augmented assignment
   or read-modify-write of a guarded attribute outside that guard —
   including mutations in private methods reached only from unlocked
   contexts (intra-class call graph, lock state propagated to a
   fixpoint) — and CROSS-THREAD mutations: an attribute a class's own
   thread body (``Thread(target=self._loop)``) and any other entry point
   both mutate with no lock held anywhere.
2. **Lock-order audit** (:mod:`lockorder`) — the per-class
   lock-acquisition graph from nested ``with`` statements and
   intra-class call edges; a cycle is an error, and so is re-entering a
   non-reentrant ``Lock`` the caller already holds.
3. **Thread-lifecycle rules** (:mod:`lifecycle`) — every ``Thread(...)``
   passes ``daemon=`` and ``name=`` explicitly and is reachable from a
   ``join()`` (or registered as intentionally unjoined); every
   ``except`` that catches the serving retriable taxonomy (the port's
   ``serving.Retriable`` tree and the fleet's router-side members)
   re-raises or maps to a pinned HTTP kind.

Findings are suppressed inline with the ``# tfos: <rule>(<reason>)``
grammar (``unguarded`` / ``unjoined`` / ``daemon`` / ``lock-order`` /
``swallow``; the reason is MANDATORY) or baselined in
``analysis/baseline.json``, each entry with a written reason, so the
gate fails on NEW findings only. ``python -m
tensorflowonspark_tpu_torch.analysis`` runs the driver (:mod:`racecheck`)
over the port's package; :mod:`report` renders its verdict.
"""

from tensorflowonspark_tpu_torch.analysis.report import Finding, emit  # noqa: F401
