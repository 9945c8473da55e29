"""Pass 3: thread-lifecycle and retriable-taxonomy rules.

Module-wide (not per-class) rules:

- ``thread-daemon`` / ``thread-name`` — every ``threading.Thread(``
  construction must pass ``daemon=`` explicitly (the interpreter's
  default silently decides whether teardown hangs or the thread is
  killed mid-write; the choice must be visible at the spawn site) and
  ``name=`` (chaos/stuck-session triage attributes stacks by thread
  name; an unnamed ``Thread-7`` is unattributable).
- ``thread-unjoined`` — a spawned thread must be reachable from a
  ``join()`` (``self._thread = Thread(...)`` with ``self._thread.
  join(...)`` anywhere in the class; a local with a local join), be
  handed off (returned / passed into a tracking structure), or be
  registered as INTENTIONALLY unjoined with
  ``# tfos: unjoined(<reason>)`` on the spawn line — fire-and-forget
  must be a written decision, not an accident.
- ``retriable-swallow`` — an ``except`` naming the serving retriable
  taxonomy (``Retriable`` / ``Shed`` / ``Draining`` /
  ``EngineFailed`` / ``NoReplicaAvailable`` / ``ReplicaUnavailable``)
  must re-raise or map the error onward (a ``raise``, a ``return``,
  or a call into the pinned HTTP mapping surface — ``_send`` /
  ``_send_json`` / ``http_retriable`` / ...); silently eating a
  retriable turns backpressure into a hang. Suppress with
  ``# tfos: swallow(<reason>)``.
"""

import ast

from tensorflowonspark_tpu_torch.analysis.core import call_name, self_attr
from tensorflowonspark_tpu_torch.analysis.report import Finding

#: the serving retriable taxonomy (the port's serving.py Retriable tree
#: plus fleet.py's two router-side members) — an except naming one of
#: these is load-bearing error routing, not cleanup
RETRIABLE_TAXONOMY = frozenset((
    "Retriable", "Shed", "Draining", "EngineFailed",
    "NoReplicaAvailable", "ReplicaUnavailable"))

#: calls that count as "mapped to a pinned HTTP kind": the serving /
#: fleet handler reply surface and the status->exception translator
HTTP_MAPPERS = frozenset((
    "_send", "_send_json", "send_json", "send_error", "send_response",
    "http_retriable"))


def _qualname(stack):
    return ".".join(stack) or "<module>"


def _thread_label(call, ordinal):
    """Stable baseline identity for one Thread spawn: the literal
    ``name=`` when one exists (a ``"...".format(...)`` call counts —
    the format string is the identity), else the spawn's ordinal
    within its scope."""
    for kw in call.keywords:
        if kw.arg != "name":
            continue
        v = kw.value
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            return v.value
        if isinstance(v, ast.Call) \
                and isinstance(v.func, ast.Attribute) \
                and v.func.attr == "format" \
                and isinstance(v.func.value, ast.Constant) \
                and isinstance(v.func.value.value, str):
            return v.func.value.value
        if isinstance(v, ast.BinOp) \
                and isinstance(v.left, ast.Constant) \
                and isinstance(v.left.value, str):
            return v.left.value
    return "#{}".format(ordinal)


def _has_kw(call, name):
    return any(kw.arg == name for kw in call.keywords)


def _joined_in(scope_node, var=None, attr=None):
    """True when ``<var>.join(`` / ``self.<attr>.join(`` appears
    anywhere under ``scope_node`` — including through a one-hop local
    alias (``t = self._thread; ...; t.join()``, the snapshot idiom
    lock-discipline fixes themselves introduce)."""
    aliases = set()
    if attr is not None:
        for node in ast.walk(scope_node):
            if isinstance(node, ast.Assign) \
                    and self_attr(node.value) == attr:
                aliases.update(t.id for t in node.targets
                               if isinstance(t, ast.Name))
    for node in ast.walk(scope_node):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"):
            continue
        owner = node.func.value
        if isinstance(owner, ast.Name) \
                and (owner.id == var or owner.id in aliases):
            return True
        if attr is not None and self_attr(owner) == attr:
            return True
    return False


def _escapes(scope_node, var):
    """True when local ``var`` is returned or passed into a call —
    ownership handed off; tracking the join is the receiver's job."""
    for node in ast.walk(scope_node):
        if isinstance(node, ast.Return) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == var:
            return True
        if isinstance(node, ast.Call):
            for arg in list(node.args) + [kw.value
                                          for kw in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id == var:
                    return True
    return False


class _Walker(object):
    def __init__(self, path, parents):
        self.path = path
        self.parents = parents
        self.findings = []
        self._thread_ordinals = {}
        self._except_ordinals = {}

    # -- thread rules ----------------------------------------------------

    def _enclosing(self, node, kinds):
        cur = self.parents.get(node)
        while cur is not None and not isinstance(cur, kinds):
            cur = self.parents.get(cur)
        return cur

    def thread_call(self, call, stack):
        qual = _qualname(stack)
        ordinal = self._thread_ordinals.get(qual, 0) + 1
        self._thread_ordinals[qual] = ordinal
        label = _thread_label(call, ordinal)
        ident = "{}:thread:{}".format(qual, label)
        # Timer takes neither daemon= nor name= in its constructor —
        # the explicit choice is an attribute assignment on the bound
        # variable (timer.daemon = True) in the same scope
        var, attr = self._binding(call)
        scope = self._enclosing(
            call, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module))
        if not _has_kw(call, "daemon") and not self._attr_set(
                scope, "daemon", var=var, attr=attr):
            self.findings.append(Finding(
                "thread-daemon", self.path, call.lineno, ident,
                "Thread spawn in {} does not set daemon explicitly "
                "(the default silently decides whether teardown hangs "
                "or kills the thread mid-write)".format(qual)))
        if not _has_kw(call, "name") and not self._attr_set(
                scope, "name", var=var, attr=attr):
            self.findings.append(Finding(
                "thread-name", self.path, call.lineno, ident,
                "Thread spawn in {} is unnamed (name=\"tfos-...\" is "
                "how chaos/stuck-session triage attributes "
                "stacks)".format(qual)))
        self._check_join(call, qual, ident)

    def _binding(self, call):
        """(local_var, self_attr) the spawn is assigned to, either
        possibly None."""
        parent = self.parents.get(call)
        if isinstance(parent, ast.Assign) and parent.value is call \
                and len(parent.targets) == 1:
            target = parent.targets[0]
            attr = self_attr(target)
            if attr is not None:
                return None, attr
            if isinstance(target, ast.Name):
                return target.id, None
        return None, None

    @staticmethod
    def _attr_set(scope, field, var=None, attr=None):
        """True when ``<var>.<field> = ...`` / ``self.<attr>.<field>
        = ...`` appears under ``scope`` — the Timer idiom for daemon
        and name."""
        if scope is None or (var is None and attr is None):
            return False
        for node in ast.walk(scope):
            if not isinstance(node, ast.Assign):
                continue
            for target in node.targets:
                if not (isinstance(target, ast.Attribute)
                        and target.attr == field):
                    continue
                owner = target.value
                if var is not None and isinstance(owner, ast.Name) \
                        and owner.id == var:
                    return True
                if attr is not None and self_attr(owner) == attr:
                    return True
        return False

    def _check_join(self, call, qual, ident):
        parent = self.parents.get(call)
        func_scope = self._enclosing(
            call, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module))
        if isinstance(parent, ast.Assign) and parent.value is call:
            targets = parent.targets
            if len(targets) == 1:
                attr = self_attr(targets[0])
                if attr is not None:
                    cls_scope = self._enclosing(call, (ast.ClassDef,))
                    scope = cls_scope if cls_scope is not None \
                        else func_scope
                    if scope is not None \
                            and _joined_in(scope, attr=attr):
                        return
                elif isinstance(targets[0], ast.Name):
                    var = targets[0].id
                    if func_scope is not None and (
                            _joined_in(func_scope, var=var)
                            or _escapes(func_scope, var)):
                        return
        self.findings.append(Finding(
            "thread-unjoined", self.path, call.lineno, ident,
            "Thread spawned in {} is reachable from no join() and "
            "not registered as intentionally unjoined "
            "(# tfos: unjoined(<reason>))".format(qual)))

    # -- retriable-swallow -----------------------------------------------

    @staticmethod
    def _caught_taxonomy(type_node):
        names = []
        nodes = type_node.elts if isinstance(type_node, ast.Tuple) \
            else [type_node]
        for n in nodes:
            if isinstance(n, ast.Name):
                names.append(n.id)
            elif isinstance(n, ast.Attribute):
                names.append(n.attr)
        return sorted(set(names) & RETRIABLE_TAXONOMY)

    def except_handler(self, handler, stack):
        if handler.type is None:
            return
        caught = self._caught_taxonomy(handler.type)
        if not caught:
            return
        for node in ast.walk(handler):
            if isinstance(node, (ast.Raise, ast.Return)):
                return
            if isinstance(node, ast.Call) \
                    and call_name(node) in HTTP_MAPPERS:
                return
            # building an error body with a "kind" field IS the pinned
            # HTTP mapping, even when the actual send happens later
            if isinstance(node, ast.Dict) and any(
                    isinstance(k, ast.Constant) and k.value == "kind"
                    for k in node.keys):
                return
        qual = _qualname(stack)
        key = (qual, tuple(caught))
        ordinal = self._except_ordinals.get(key, 0) + 1
        self._except_ordinals[key] = ordinal
        self.findings.append(Finding(
            "retriable-swallow", self.path, handler.lineno,
            "{}:except:{}:#{}".format(qual, "+".join(caught), ordinal),
            "except {} in {} neither re-raises nor maps to an HTTP "
            "kind — swallowing a retriable turns backpressure into a "
            "hang".format("/".join(caught), qual)))

    # -- the walk --------------------------------------------------------

    def walk(self, node, stack):
        for child in ast.iter_child_nodes(node):
            pushed = None
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.ClassDef)):
                pushed = child.name
            if isinstance(child, ast.Call) \
                    and call_name(child) in ("Thread", "Timer"):
                self.thread_call(child, stack)
            if isinstance(child, ast.ExceptHandler):
                self.except_handler(child, stack)
            self.walk(child,
                      stack + [pushed] if pushed else stack)


def check(tree, path):
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    walker = _Walker(path, parents)
    walker.walk(tree, [])
    return walker.findings
