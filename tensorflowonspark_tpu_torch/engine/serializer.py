"""Closure/task serialization for the engine — the port's own pickler.

The reference ships task closures with ``cloudpickle``, as Spark does.
The port ships them with standard :mod:`pickle` extended through
``Pickler.reducer_override``, so it needs no package beyond the
standard library:

- A function that can be found again by name — its module is imported
  (and is not ``__main__``) and its qualified name leads back to the
  same object — goes by reference, as plain pickle sends it.
- Any other function (a closure, a lambda, a function defined inside
  another function, or one defined in the driver's ``__main__``) goes
  by value: its code object (``marshal``), name, defaults, keyword
  defaults, closure cells, ``__dict__`` and the module globals its code
  names, each pickled the same way, recursively. Driver and executors
  run the same interpreter, so ``marshal``'s format matches on both
  sides.
- A module goes by name and is imported where it is loaded.

By-value functions that came from one module share one globals dict on
the loading side (as with cloudpickle), filled with the globals each of
them names. That dict is a copy: a closure that must reach a module's
live state calls a module-level function that looks it up (node.py's
``_state()``), which travels by reference.

Payloads travel only over authkey-authenticated
``multiprocessing.connection`` channels between our own driver and
executors — the same trust model as Spark's closure plane.
"""

import builtins
import importlib
import io
import marshal
import pickle
import sys
import types


def dumps(obj):
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def loads(data):
    return pickle.loads(data)


def _lookup(module_name, qualname):
    """The object at ``module_name.qualname`` in the loaded modules, or
    None when the name leads nowhere."""
    module = sys.modules.get(module_name)
    if module is None or "<locals>" in qualname:
        return None
    obj = module
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def _by_reference(func):
    module_name = getattr(func, "__module__", None)
    if not module_name or module_name == "__main__":
        return False
    return _lookup(module_name, func.__qualname__) is func


def _global_names(code):
    """Every name ``code`` and the code objects nested in it may read
    from the module globals."""
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _global_names(const)
    return names


def _skeleton(code_bytes, base_globals, name, n_cells):
    """A function with the pickled code, the shared globals dict and
    empty closure cells; :func:`_fill` sets the rest once every part
    (which may refer back to this function) is loaded."""
    base_globals.setdefault("__builtins__", builtins)
    cells = tuple(types.CellType() for _ in range(n_cells))
    return types.FunctionType(marshal.loads(code_bytes), base_globals,
                              name, None, cells or None)


def _fill(func, state):
    func.__globals__.update(state["globals"])
    func.__defaults__ = state["defaults"]
    func.__kwdefaults__ = state["kwdefaults"]
    func.__qualname__ = state["qualname"]
    func.__module__ = state["module"]
    func.__doc__ = state["doc"]
    func.__dict__.update(state["dict"])
    for cell, value in zip(func.__closure__ or (), state["cells"]):
        if value is not _EMPTY_MARK:
            cell.cell_contents = value
    return func


class _EmptyMark(object):
    """Pickled in place of an empty closure cell (loads as the one
    module-level instance)."""

    def __reduce__(self):
        return "_EMPTY_MARK"


_EMPTY_MARK = _EmptyMark()


class _Pickler(pickle.Pickler):

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        #: id(module globals) -> the dict shared by every by-value
        #: function of that module in this payload (kept alive here so
        #: pickle's memo can key on it)
        self._base_globals = {}

    def reducer_override(self, obj):
        if isinstance(obj, types.FunctionType):
            if _by_reference(obj):
                return NotImplemented
            return self._function_by_value(obj)
        if isinstance(obj, types.ModuleType):
            if obj.__name__ == "__main__":
                raise pickle.PicklingError(
                    "cannot ship the __main__ module itself")
            return importlib.import_module, (obj.__name__,)
        return NotImplemented

    def _function_by_value(self, func):
        g = func.__globals__
        base = self._base_globals.get(id(g))
        if base is None:
            base = {"__name__": g.get("__name__"),
                    "__package__": g.get("__package__")}
            self._base_globals[id(g)] = base
        names = _global_names(func.__code__)
        used = {k: g[k] for k in names if k in g and k != "__builtins__"}
        cells = []
        for cell in func.__closure__ or ():
            try:
                cells.append(cell.cell_contents)
            except ValueError:  # a cell not assigned yet
                cells.append(_EMPTY_MARK)
        state = {"globals": used, "defaults": func.__defaults__,
                 "kwdefaults": func.__kwdefaults__,
                 "qualname": func.__qualname__, "module": func.__module__,
                 "doc": func.__doc__, "dict": dict(func.__dict__),
                 "cells": cells}
        args = (marshal.dumps(func.__code__), base, func.__name__,
                len(func.__closure__ or ()))
        # (callable, args, state, listitems, dictitems, state_setter):
        # the skeleton is memoized before its state is pickled, so a
        # function that reaches itself (recursion through a global or a
        # cell) loads as one object
        return _skeleton, args, state, None, None, _fill
