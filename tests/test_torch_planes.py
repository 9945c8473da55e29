"""The port's copies of the cluster and feed planes held against the
reference's own tests.

The cases of ``tests/test_frames.py``, ``test_shm.py``, ``test_fs.py``,
``test_manager.py``, ``test_reservation.py``, ``test_node_state.py``,
``test_engine.py``, ``test_datafeed.py``, ``test_remote_manager.py``,
``test_feed_zero_copy.py`` and ``test_scale.py`` (every case but the
slow ones) run against the port: each file is loaded
under a private name (``test_torch_qos.reference_cases``), every global
that names a module, class or function of the JAX package is replaced
by the port's object of the same name, the imports inside the cases'
bodies are pointed at the port, and the reference's fixtures
(``node_env``, the engine ``sc``) are rebound the same way. The cases
themselves are not copied: a change to a reference case changes what
the port is held to.
"""

import importlib
import inspect
import types

import pytest

import test_torch_qos

FILES = ("test_frames.py", "test_shm.py", "test_fs.py", "test_manager.py",
         "test_reservation.py", "test_node_state.py", "test_engine.py",
         "test_datafeed.py", "test_remote_manager.py",
         "test_feed_zero_copy.py", "test_scale.py")

BASE = "tensorflowonspark_tpu"


def _port_object(obj):
    """The port's counterpart of a JAX-package module, class or function
    (by module and name), or None for anything else."""
    if isinstance(obj, types.ModuleType):
        name = obj.__name__
        if name == BASE or name.startswith(BASE + "."):
            return importlib.import_module(BASE + "_torch" + name[len(BASE):])
        return None
    module = getattr(obj, "__module__", None) or ""
    if isinstance(obj, (type, types.FunctionType)) and (
            module == BASE or module.startswith(BASE + ".")):
        port = importlib.import_module(BASE + "_torch" + module[len(BASE):])
        return getattr(port, obj.__name__)
    return None


def _namespace(filename):
    """The rebound namespace of one reference file: the rebound cases
    share ``ns`` as their globals, so the overrides land in them."""
    ref, ns = test_torch_qos.reference_cases(filename, port_imports=True)
    for key, obj in vars(ref).items():
        port = _port_object(obj)
        if port is not None:
            ns[key] = port
    return ref, ns


NAMESPACES = {f: _namespace(f) for f in FILES}

#: ``test_manager.py``'s spawn target, rebound: a spawned child finds a
#: target by module and name, so it goes through this module's
#: ``_spawn_child``, which the child can import
_MANAGER_CHILD = NAMESPACES["test_manager.py"][1]["_child"]


def _spawn_child(*args):
    _MANAGER_CHILD(*args)


NAMESPACES["test_manager.py"][1]["_child"] = _spawn_child


def _is_slow(fn):
    return any(m.name == "slow" for m in getattr(fn, "pytestmark", []))


CASES = [(f, name) for f, (ref, _) in NAMESPACES.items()
         for name, fn in vars(ref).items()
         if name.startswith("test_") and inspect.isfunction(fn)
         and not _is_slow(fn)]


def _rebound_fixture(filename, name):
    """The reference fixture ``name`` of ``filename``, its body rebound
    to the port's namespace."""
    ref, ns = NAMESPACES[filename]
    raw = getattr(ref, name)._get_wrapped_function()
    return types.FunctionType(test_torch_qos.port_code(raw.__code__), ns,
                              raw.__name__, raw.__defaults__,
                              raw.__closure__)


@pytest.fixture
def node_env(tmp_path, monkeypatch):
    yield from _rebound_fixture("test_node_state.py", "node_env")(
        tmp_path, monkeypatch)


@pytest.fixture(scope="module")
def sc(tmp_path_factory):
    yield from _rebound_fixture("test_engine.py", "sc")(tmp_path_factory)


def test_every_reference_case_is_collected():
    assert len(CASES) == 89, len(CASES)


@pytest.mark.parametrize("filename,case", CASES,
                         ids=["{}::{}".format(f[:-3], c) for f, c in CASES])
def test_reference_plane_case_on_the_port(filename, case, request):
    fn = NAMESPACES[filename][1][case]
    kw = {name: request.getfixturevalue(name)
          for name in inspect.signature(fn).parameters}
    fn(**kw)
