"""Shared AST plumbing for the concurrency passes.

Builds a per-class model — which attributes hold locks, which
synchronization primitives are exempt, every attribute MUTATION with
the set of locks held at that statement, every intra-class call site
with its lock context, every ``Thread(target=...)`` root — that
:mod:`guards` and :mod:`lockorder` analyze. Everything is syntactic
and intra-class by design: the codebase's locking discipline is
per-object (``self._lock`` guards ``self.*``), and the passes only
claim what the AST can prove, with the suppression grammar and the
baseline absorbing the judgement calls.

Lock-context tracking is ``with``-statement based (the package has no
manual ``.acquire()`` call sites — verified, and simpler to keep it
that way than to approximate flow-sensitivity). A
``threading.Condition(self._lock)`` ALIASES its underlying lock:
holding the condition holds the lock, which both the guard pass (a
``_cv`` block guards ``_lock``-guarded attrs) and the lock-order pass
(entering ``_cv`` while holding ``_lock`` is a self-acquisition of a
non-reentrant lock) need to know.

Nested functions (closures) are scanned with an EMPTY lock context:
a closure's body runs when it is called — often on another thread
entirely (``Thread(target=closure)``) — and the locks held at its
*definition* site prove nothing about its *call* sites. A closure
invoked inline under the lock is the false-positive shape the
``# tfos: unguarded(...)`` suppression exists for.
"""

import ast
import re

#: threading factories whose product is a lock for guard purposes
LOCK_FACTORIES = ("Lock", "RLock", "Condition")

#: factories whose product is internally synchronized — attributes
#: holding one are exempt from mutation analysis (calling
#: ``self._stop.clear()`` on an Event is not a data race)
SYNC_FACTORIES = LOCK_FACTORIES + (
    "Event", "Semaphore", "BoundedSemaphore", "Barrier", "Queue",
    "LifoQueue", "PriorityQueue", "SimpleQueue", "local")

#: method names that mutate their receiver in place — a call
#: ``self.X.append(...)`` is a mutation of ``X`` exactly as
#: ``self.X = ...`` is (dict/list/set/OrderedDict/deque vocabulary)
MUTATOR_METHODS = frozenset((
    "append", "extend", "insert", "remove", "clear", "update",
    "setdefault", "add", "discard", "pop", "popitem", "appendleft",
    "extendleft", "popleft", "move_to_end", "rotate", "sort",
    "reverse"))

#: the inline suppression grammar: ``# tfos: <tag>(<reason>)`` — one
#: per line, reason runs to the line's LAST closing paren (so reasons
#: may themselves mention ``stop()`` and friends)
SUPPRESS_RE = re.compile(
    r"#\s*tfos:\s*([a-z][a-z-]*)\((.*)\)\s*$")


def scan_suppressions(source):
    """{lineno: [(tag, reason), ...]} for every ``# tfos: tag(...)``
    comment in ``source`` (1-based line numbers, matching ast)."""
    out = {}
    for i, line in enumerate(source.splitlines(), start=1):
        hits = SUPPRESS_RE.findall(line)
        if hits:
            out[i] = [(tag, reason.strip()) for tag, reason in hits]
    return out


def call_name(node):
    """Trailing name of a Call's callee (``threading.Thread`` ->
    ``Thread``; ``Thread`` -> ``Thread``), else None."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def self_attr(node):
    """``attr`` when ``node`` is exactly ``self.<attr>``, else None."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _mutated_attr(target):
    """The ``self`` attribute a bind target mutates: ``self.X`` and
    ``self.X[...]`` both mutate ``X``; anything deeper
    (``self.a.b = v`` mutates another object) is out of scope."""
    if isinstance(target, ast.Subscript):
        return self_attr(target.value)
    return self_attr(target)


class Mutation(object):
    """One attribute mutation site: ``attr`` mutated at ``line`` with
    ``locks`` (frozenset of lock-attribute names) held, in the method
    whose record owns this. ``kind`` is assign/augassign/delete/call;
    ``nested`` names the enclosing closure (None for method-body
    statements) — closures that are Thread targets root their
    mutations on that thread."""

    __slots__ = ("attr", "line", "locks", "kind", "nested")

    def __init__(self, attr, line, locks, kind, nested=None):
        self.attr = attr
        self.line = line
        self.locks = locks
        self.kind = kind
        self.nested = nested


class CallSite(object):
    """Intra-class call ``self.<callee>(...)`` at ``line`` with
    ``locks`` held (``nested`` as in :class:`Mutation`)."""

    __slots__ = ("callee", "line", "locks", "nested")

    def __init__(self, callee, line, locks, nested=None):
        self.callee = callee
        self.line = line
        self.locks = locks
        self.nested = nested


class MethodModel(object):
    def __init__(self, name, node):
        self.name = name
        self.node = node
        self.mutations = []      # [Mutation]
        self.calls = []          # [CallSite]
        self.acquires = set()    # lock attrs acquired by with stmts
        self.with_edges = []     # [(outer_lock, inner_lock, line)]
        #: nested function names used as Thread targets in this method
        self.thread_nested = set()
        #: attributes on which ``.join(`` is called anywhere in here
        self.joined_attrs = set()

    @property
    def is_private(self):
        return self.name.startswith("_") and not self.name.startswith("__")

    @property
    def is_dunder(self):
        return self.name.startswith("__") and self.name.endswith("__")


class ClassModel(object):
    """Everything the passes need to know about one class."""

    def __init__(self, name, path):
        self.name = name
        self.path = path
        self.locks = {}        # lock attr -> factory name
        self.cv_alias = {}     # condition attr -> wrapped lock attr
        self.sync_attrs = set()
        self.methods = {}      # name -> MethodModel
        #: bound methods used as Thread targets anywhere in the class
        #: (``Thread(target=self._loop)``)
        self.thread_targets = set()

    def expand(self, locks):
        """Lock set closed over condition aliases: holding a
        ``Condition(self._lock)`` holds ``_lock`` too."""
        out = set(locks)
        for cv in locks:
            alias = self.cv_alias.get(cv)
            if alias is not None:
                out.add(alias)
        return frozenset(out)


def _thread_target_of(call):
    """(kind, name) for a ``Thread(...)``/``Timer(...)`` call's
    entry callable: ("method", attr) for ``target=self.X`` (Timer:
    the positional ``function`` or ``function=`` kwarg), ("local",
    name) for a local/closure callable, else (None, None)."""
    name = call_name(call)
    if name not in ("Thread", "Timer"):
        return None, None
    candidates = [kw.value for kw in call.keywords
                  if kw.arg in ("target", "function")]
    if name == "Timer" and len(call.args) >= 2:
        candidates.append(call.args[1])
    for value in candidates:
        attr = self_attr(value)
        if attr is not None:
            return "method", attr
        if isinstance(value, ast.Name):
            return "local", value.id
    return None, None


class _MethodScanner(object):
    """Walks one method body tracking the set of locks held at each
    statement (``with self._lock:`` pushes; leaving the block pops),
    recording mutations, intra-class calls, acquisition edges, and
    thread-target registrations into the method/class models."""

    def __init__(self, cls, method):
        self.cls = cls
        self.method = method

    def scan(self):
        for stmt in self.method.node.body:
            self._visit(stmt, frozenset(), None)

    # -- helpers ---------------------------------------------------------

    def _record_mutation(self, attr, line, held, kind, nested):
        if attr is None or attr in self.cls.sync_attrs \
                or attr in self.cls.locks:
            return
        self.method.mutations.append(
            Mutation(attr, line, held, kind, nested))

    def _visit_call(self, node, held, nested):
        # thread-target registration (Thread(target=self._loop) makes
        # _loop a thread root; Thread(target=closure) roots the
        # closure's mutations on that thread)
        kind, name = _thread_target_of(node)
        if kind == "method":
            self.cls.thread_targets.add(name)
        elif kind == "local":
            self.method.thread_nested.add(name)
        # mutator-method calls: self.X.append(...) mutates X
        func = node.func
        if isinstance(func, ast.Attribute):
            owner = self_attr(func.value)
            if owner is not None and func.attr in MUTATOR_METHODS:
                self._record_mutation(owner, node.lineno, held, "call",
                                      nested)
            if owner is not None and func.attr == "join":
                self.method.joined_attrs.add(owner)
            # intra-class call: self._helper(...)
            callee = self_attr(func)
            if callee is not None:
                self.method.calls.append(
                    CallSite(callee, node.lineno, held, nested))

    # -- the walk --------------------------------------------------------

    def _visit(self, node, held, nested):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = set()
            for item in node.items:
                lock = self_attr(item.context_expr)
                if lock is not None and lock in self.cls.locks:
                    acquired.add(lock)
                else:
                    self._visit(item.context_expr, held, nested)
            if acquired:
                inner = self.cls.expand(acquired)
                for outer_lock in self.cls.expand(held):
                    for lock in inner:
                        self.method.with_edges.append(
                            (outer_lock, lock, node.lineno))
                held = frozenset(held | inner)
                self.method.acquires.update(inner)
            for stmt in node.body:
                self._visit(stmt, held, nested)
            return
        if isinstance(node, ast.Assign):
            self._scan_assign_value(node, held, nested)
            for target in node.targets:
                self._bind_target(target, node.lineno, held, nested)
            self._visit(node.value, held, nested)
            return
        if isinstance(node, ast.AugAssign):
            self._record_mutation(_mutated_attr(node.target),
                                  node.lineno, held, "augassign", nested)
            self._visit(node.value, held, nested)
            return
        if isinstance(node, ast.Delete):
            for target in node.targets:
                self._record_mutation(_mutated_attr(target),
                                      node.lineno, held, "delete", nested)
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, held, nested)
            for child in ast.iter_child_nodes(node):
                self._visit(child, held, nested)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # closure body: lock context at the DEFINITION site proves
            # nothing about the call site (often another thread)
            for stmt in node.body:
                self._visit(stmt, frozenset(), node.name)
            return
        if isinstance(node, ast.Lambda):
            self._visit(node.body, frozenset(), nested)
            return
        if isinstance(node, ast.ClassDef):
            return  # nested classes are modeled separately
        for child in ast.iter_child_nodes(node):
            self._visit(child, held, nested)

    def _bind_target(self, target, line, held, nested):
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind_target(elt, line, held, nested)
            return
        self._record_mutation(_mutated_attr(target), line, held,
                              "assign", nested)
        # subscript targets carry expressions of their own
        # (self._x[self._key()] = v) that still need the walk
        for child in ast.iter_child_nodes(target):
            self._visit(child, held, nested)

    def _scan_assign_value(self, node, held, nested):
        """Factory detection on ``self.X = <Call>`` assignments: lock
        attrs, condition aliases, and sync-primitive exemptions."""
        if not isinstance(node.value, ast.Call):
            return
        name = call_name(node.value)
        targets = [self_attr(t) for t in node.targets]
        targets = [t for t in targets if t is not None]
        if not targets or name is None:
            return
        if name in LOCK_FACTORIES:
            for t in targets:
                self.cls.locks[t] = name
                self.cls.sync_attrs.add(t)
            if name == "Condition" and node.value.args:
                wrapped = self_attr(node.value.args[0])
                if wrapped is not None:
                    for t in targets:
                        self.cls.cv_alias[t] = wrapped
        elif name in SYNC_FACTORIES:
            for t in targets:
                self.cls.sync_attrs.add(t)


def build_class_models(tree, path):
    """[:class:`ClassModel`] for every class in ``tree`` (module AST).

    Two phases per class: first collect lock/sync attribute
    declarations from EVERY method (a lock declared in ``__init__``
    guards mutations in methods defined above it in the source), then
    scan method bodies with the full declaration picture."""
    models = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        cls = ClassModel(node.name, path)
        method_nodes = [
            n for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for mnode in method_nodes:
            cls.methods[mnode.name] = MethodModel(mnode.name, mnode)
        # phase 1: factory declarations (self.X = threading.Lock()...)
        for mnode in method_nodes:
            method = cls.methods[mnode.name]
            for sub in ast.walk(mnode):
                if isinstance(sub, ast.Assign):
                    _MethodScanner(cls, method)._scan_assign_value(
                        sub, frozenset(), None)
        # phase 2: the lock-context walk proper
        for mnode in method_nodes:
            _MethodScanner(cls, cls.methods[mnode.name]).scan()
        models.append(cls)
    return models


#: methods whose mutations are construction, not concurrency:
#: nothing else can hold the object yet
CONSTRUCTION_METHODS = frozenset(("__init__", "__new__"))


def entry_contexts(cls):
    """{method: set(frozenset(locks))} — every lock context a method
    can be ENTERED under, propagated over the intra-class call graph
    to a fixpoint.

    Roots: public methods, dunders, and private methods with no
    intra-class caller start at the empty context (external callers
    hold nothing we can prove). A private method that IS called
    intra-class inherits exactly its call sites' contexts — the
    ``_foo_locked``-style convention where the caller holds the lock.
    Closure-borne calls contribute the EMPTY context (the closure may
    run on any thread)."""
    contexts = {}
    called_privately = set()
    for method in cls.methods.values():
        for site in method.calls:
            if site.callee in cls.methods:
                called_privately.add(site.callee)
    for name, method in cls.methods.items():
        externally_reachable = (not method.is_private
                                or name in cls.thread_targets
                                or name not in called_privately)
        contexts[name] = {frozenset()} if externally_reachable else set()
    for _ in range(len(cls.methods) + 1):
        changed = False
        for name, method in cls.methods.items():
            for site in method.calls:
                if site.callee not in cls.methods:
                    continue
                site_locks = frozenset() if site.nested is not None \
                    else cls.expand(site.locks)
                for entry in list(contexts[name]):
                    ctx = frozenset(entry | site_locks)
                    if ctx not in contexts[site.callee]:
                        contexts[site.callee].add(ctx)
                        changed = True
        if not changed:
            break
    # a method somehow never rooted (unreachable private): analyze it
    # under the conservative empty context rather than skipping it
    for name in contexts:
        if not contexts[name]:
            contexts[name] = {frozenset()}
    return contexts


def method_roots(cls):
    """{method: set(root tags)} — which entry points can reach each
    method, over the same call graph. Tags: ``thread:<name>`` for
    Thread-target methods, ``public:<name>`` for everything
    externally reachable."""
    roots = {name: set() for name in cls.methods}
    for name, method in cls.methods.items():
        if name in cls.thread_targets:
            roots[name].add("thread:" + name)
        elif not method.is_private or not _has_intra_callers(cls, name):
            roots[name].add("public:" + name)
    for _ in range(len(cls.methods) + 1):
        changed = False
        for name, method in cls.methods.items():
            for site in method.calls:
                if site.callee not in cls.methods:
                    continue
                before = len(roots[site.callee])
                roots[site.callee] |= roots[name]
                changed = changed or len(roots[site.callee]) > before
        if not changed:
            break
    return roots


def _has_intra_callers(cls, name):
    for method in cls.methods.values():
        for site in method.calls:
            if site.callee == name:
                return True
    return False
