"""The port's concurrency lint (``tensorflowonspark_tpu_torch/analysis``)
against the JAX package's.

The port keeps its own copy of the reference's stdlib-``ast`` analyzer
(guarded-attribute races, lock order, thread lifecycle, retriable
swallows) so that it lints itself with nothing of the JAX package
installed. Here:

- the reference's own 25 cases (``tests/test_analysis.py``: the fixture
  corpus, the suppression and baseline round trip, the units, the lock
  order and the self-check) run against the port's modules, rebound by
  ``test_torch_qos.reference_cases``; the self-check then lints the
  port's package against the port's baseline;
- parity: both analyzers give the same findings, file by file, over
  both packages and over ``tests/fixtures/racecheck_corpus/``;
- the retriable taxonomy names the port's own serving exceptions.
"""

import inspect
import os

import pytest
from test_torch_qos import reference_cases

from tensorflowonspark_tpu.analysis import racecheck as jax_racecheck
from tensorflowonspark_tpu_torch import fleet, serving
from tensorflowonspark_tpu_torch.analysis import core, guards, lifecycle, \
    lockorder, racecheck, report

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CORPUS = os.path.join(HERE, "fixtures", "racecheck_corpus")

REF, PORT = reference_cases("test_analysis.py", core=core, guards=guards,
                            lifecycle=lifecycle, lockorder=lockorder,
                            racecheck=racecheck, report=report)

#: (class, case) of every reference test, in file order
CASES = [(cls, name) for cls, obj in vars(REF).items()
         if cls.startswith("Test") and isinstance(obj, type)
         for name in vars(obj) if name.startswith("test_")]


def test_the_reference_has_25_cases():
    assert len(CASES) == 25


@pytest.mark.parametrize("cls,case", CASES,
                         ids=["{}.{}".format(*c) for c in CASES])
def test_reference_case_on_the_port(cls, case, request):
    """The reference's case, its module globals pointing at the port's
    analyzer."""
    fn = getattr(PORT[cls](), case)
    assert fn.__func__.__globals__["racecheck"] is racecheck
    kw = {name: request.getfixturevalue(name)
          for name in inspect.signature(fn).parameters}
    fn(**kw)


def _findings(mod, root):
    """Every finding (and grammar violation) of analyzer ``mod`` over the
    ``.py`` files under ``root``, keyed by file, with the suppression
    counts: what ``racecheck.run`` reports before the baseline."""
    got = {}
    for path in sorted(mod.iter_py_files([root])):
        rel = os.path.relpath(path, ROOT)
        kept, nsup, bad = mod.analyze_file(path, rel=rel)
        got[rel] = (sorted((f.rule, f.key, f.line) for f in kept),
                    sorted((f.rule, f.key, f.line) for f in bad), nsup)
    return got


@pytest.mark.parametrize("tree", ["tensorflowonspark_tpu",
                                  "tensorflowonspark_tpu_torch",
                                  "tests/fixtures/racecheck_corpus"])
def test_both_analyzers_agree(tree):
    """The port's analyzer and the reference's give the same findings,
    suppressions and grammar violations, file by file, over the JAX
    package, the port and the fixture corpus."""
    root = os.path.join(ROOT, tree)
    port, ref = _findings(racecheck, root), _findings(jax_racecheck, root)
    assert len(port) > 5
    assert port == ref


def test_retriable_taxonomy_names_the_ports_serving_exceptions():
    """Each name the retriable-swallow rule watches is a class of the
    port's serving plane, of its ``Retriable`` tree: four in
    ``serving.py``, the router's two in ``fleet.py``."""
    for name in lifecycle.RETRIABLE_TAXONOMY:
        cls = getattr(serving, name, None) or getattr(fleet, name)
        assert issubclass(cls, serving.Retriable), name
        assert cls.__module__.startswith("tensorflowonspark_tpu_torch.")
    assert {n for n in lifecycle.RETRIABLE_TAXONOMY
            if hasattr(serving, n)} == {"Retriable", "Shed", "Draining",
                                        "EngineFailed"}
