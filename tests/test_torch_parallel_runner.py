"""The port's ``parallel_runner`` (TFParallel's ``run``) on the CPU.

Mirrors the reference's ``tests/test_parity_modules.py`` cases (two
independent jobs return their values; a worker's error re-raises on the
driver), adds what the port's design promises (each job in a child
process forked from its executor, so the executor stays free of CUDA
and of any foreign module), and holds the port against the reference:
the same seeded ``fn`` through both packages' ``run`` gives equal
results from distinct worker processes, and a failing ``fn`` re-raises
its traceback on both drivers.
"""

import os

import pytest

from tensorflowonspark_tpu_torch import parallel_runner
from tensorflowonspark_tpu_torch.engine import Context


@pytest.fixture()
def sc(tmp_path):
    ctx = Context(num_executors=2, work_root=str(tmp_path / "engine"))
    yield ctx
    ctx.stop()


def test_parallel_runner(sc):
    def map_fn(args, index):
        import os as _os

        import torch

        return {"index": index, "pid": _os.getpid(),
                "parent": _os.getppid(),
                "value": float(torch.tensor(float(args["base"] + index))
                               ** 2)}

    results = parallel_runner.run(sc, map_fn, {"base": 3}, num_executors=2)
    results = sorted(results, key=lambda r: r["index"])
    assert [r["value"] for r in results] == [9.0, 16.0]

    def executor_state(it):
        import os as _os
        import sys as _sys

        list(it)
        torch = _sys.modules.get("torch")
        return [{"pid": _os.getpid(),
                 "cuda": bool(torch and torch.cuda.is_initialized()),
                 "foreign": sorted(m for m in _sys.modules
                                   if m.split(".")[0] in (
                                       "jax", "flax", "tensorflowonspark_tpu")
                                   and _sys.modules[m] is not None)}]

    # the census is pinned, one task per executor: from the shared task
    # pool one executor's handle may take both tasks while the other's is
    # slow to poll (under load), and the census then names one executor
    census = sc.run_job(sc.parallelize(range(2), 2), executor_state,
                        one_task_per_executor=True).get()
    executors = [e for part in census for e in part]
    assert len({e["pid"] for e in executors}) == 2
    # each job ran in a child forked from an executor, never in it
    assert {r["parent"] for r in results} <= {e["pid"] for e in executors}
    assert not {r["pid"] for r in results} & {e["pid"] for e in executors}
    assert all(not e["cuda"] and e["foreign"] == [] for e in executors)


def test_parallel_runner_error(sc):
    def boom(args, index):
        raise ValueError("worker boom %d" % index)

    with pytest.raises(Exception, match="boom"):
        parallel_runner.run(sc, boom, {}, num_executors=2)


def _seeded_fns():
    """(fn, failing): the same seeded job for both packages."""

    def fn(args, index):
        import os as _os

        import numpy as np

        rng = np.random.RandomState(args["seed"] + index)
        x = rng.randn(64, 16)
        return {"index": index, "pid": _os.getpid(),
                "sum": float(x.sum()), "norms": np.linalg.norm(
                    x, axis=1).round(12).tolist()}

    def failing(args, index):
        if index == 1:
            raise ValueError("seeded failure in worker %d" % index)
        return index

    return fn, failing


def test_parallel_runner_matches_the_reference(sc, tmp_path):
    from tensorflowonspark_tpu import parallel_runner as jparallel
    from tensorflowonspark_tpu.engine import Context as JaxContext

    fn, failing = _seeded_fns()
    jsc = JaxContext(num_executors=2, work_root=str(tmp_path / "jax-engine"))
    try:
        want = jparallel.run(jsc, fn, {"seed": 11}, num_executors=2)
        with pytest.raises(Exception) as jerr:
            jparallel.run(jsc, failing, {}, num_executors=2)
    finally:
        jsc.stop()
    got = parallel_runner.run(sc, fn, {"seed": 11}, num_executors=2)
    with pytest.raises(Exception) as err:
        parallel_runner.run(sc, failing, {}, num_executors=2)

    def key(rs):
        return sorted(({k: v for k, v in r.items() if k != "pid"}
                       for r in rs), key=lambda r: r["index"])

    assert key(got) == key(want)
    for rs in (got, want):
        assert len({r["pid"] for r in rs}) == 2
        assert all(r["pid"] != os.getpid() for r in rs)
    for e in (err.value, jerr.value):
        text = str(e)
        assert "Traceback" in text
        assert "ValueError: seeded failure in worker 1" in text
