"""Embarrassingly-parallel single-node runs (no cluster bootstrap) — the
port's copy of ``tensorflowonspark_tpu/parallel_runner.py``.

Reference: ``tensorflowonspark/TFParallel.py`` (SURVEY.md §2 "Parallel
single-node runner"): ``run(sc, map_fn, tf_args, num_executors)`` launches
N independent, non-communicating jobs via ``sc.parallelize(range(N), N)``
— e.g. sharded inference where each worker serves its slice alone.

Each task forks a child process that runs the user fn, so the child owns
the card exactly as a cluster trainer does while the executor process
itself never initialises CUDA (it forks every later trainer). The task
applies :func:`util.single_node_env` first; the fn, its args and its
result travel through the port's serializer, and a worker's traceback is
re-raised on the driver.
"""

import logging

logger = logging.getLogger(__name__)

#: seconds a task waits for its worker's result
RESULT_TIMEOUT = 2 * 3600


def run(sc, map_fn, tf_args, num_executors):
    """Run ``map_fn(args, worker_index)`` on N executors; returns results.

    Unlike the cluster path there is no NodeContext — the fn gets its
    ordinal and whatever it returns ships back to the driver.
    """

    def _task(index, iterator):
        for _ in iterator:
            pass
        import multiprocessing
        import queue as q_mod

        from tensorflowonspark_tpu_torch import util
        from tensorflowonspark_tpu_torch.engine import serializer

        util.single_node_env()
        payload = serializer.dumps((map_fn, tf_args, index))
        ctx = multiprocessing.get_context("fork")
        out = ctx.Queue()
        proc = ctx.Process(target=_child_main, args=(payload, out))
        proc.start()
        # get() BEFORE join(): a child whose queued result exceeds the pipe
        # buffer can't exit until it's read (the documented mp deadlock),
        # and a failed worker's real traceback is in the queue either way.
        try:
            ok, value = out.get(timeout=RESULT_TIMEOUT)
        except q_mod.Empty:
            proc.join(timeout=10)
            raise RuntimeError(
                "parallel worker {} produced no result (exitcode {})"
                .format(index, proc.exitcode))
        proc.join()
        if not ok:
            raise RuntimeError("parallel worker {} failed:\n{}".format(
                index, value))
        if proc.exitcode != 0:
            raise RuntimeError(
                "parallel worker {} exited with code {}".format(
                    index, proc.exitcode))
        yield serializer.loads(value)

    rdd = sc.parallelize(range(num_executors), num_executors)
    return rdd.mapPartitionsWithIndex(_task).collect()


def _child_main(payload, out):
    from tensorflowonspark_tpu_torch.engine import serializer

    map_fn, tf_args, index = serializer.loads(payload)
    try:
        out.put((True, serializer.dumps(map_fn(tf_args, index))))
    except BaseException:  # noqa: BLE001 - shipped to the driver, exit 1
        import traceback
        out.put((False, traceback.format_exc()))
        raise SystemExit(1)
