"""Executor process: connects back to the driver and runs tasks serially —
the port's copy of ``tensorflowonspark_tpu/engine/executor.py``.

The analog of a 1-core Spark executor + pyspark worker rolled into one
long-lived process. Serial task execution is a *feature* the cluster layer
relies on (as the reference relies on 1-task-slot executors): the node
bootstrap task spawns the trainer subprocess and returns, then feed /
shutdown tasks run on the same executor and find its state via module
globals (the reference's equivalent: executor_id file + TFManager reconnect,
SURVEY.md §3.2 ``_get_manager``).

Runs either spawned-by-driver (local mode) or standalone on a remote host:

    python -m tensorflowonspark_tpu_torch.engine.executor \
        --driver HOST:PORT --executor-id N --authkey-file F --work-dir D

This process must never initialize CUDA — the trainer it forks owns the
card, and a forked child cannot use a CUDA context its parent created.
Its own code is stdlib and numpy only; it never imports torch itself.
"""

import argparse
import logging
import os
import sys
import traceback
from multiprocessing.connection import Client as ConnClient

from tensorflowonspark_tpu_torch.engine import serializer

logger = logging.getLogger(__name__)

#: Set once at startup; read by the node runtime (node.py) to learn which
#: executor a task is running on. {"executor_id", "work_dir", "host"}
EXECUTOR_INFO = {}


def get_executor_info():
    return dict(EXECUTOR_INFO)


def run_task(func_bytes, payload_bytes):
    """Execute one task; returns a reply dict (never raises)."""
    try:
        func = serializer.loads(func_bytes)
        payload = serializer.loads(payload_bytes) if payload_bytes is not None else None
        value = func(iter(payload) if payload is not None else iter(()))
        if hasattr(value, "__next__") or (hasattr(value, "__iter__")
                                          and not isinstance(value, (list, tuple, dict, str, bytes))):
            value = list(value)
        return {"ok": True, "value": serializer.dumps(value)}
    except BaseException as e:  # noqa: BLE001 - must reach the driver
        tb = traceback.format_exc()
        logger.error("task failed:\n%s", tb)
        return {"ok": False, "error": "{}: {}".format(type(e).__name__, e),
                "traceback": tb}


def executor_main(driver_addr, executor_id, authkey, work_dir):
    os.makedirs(work_dir, exist_ok=True)
    os.chdir(work_dir)
    from tensorflowonspark_tpu_torch import util
    util.write_executor_id(executor_id)
    import multiprocessing
    multiprocessing.current_process().authkey = authkey

    host = util.get_ip_address()
    EXECUTOR_INFO.update(executor_id=executor_id, work_dir=work_dir, host=host)

    conn = ConnClient(tuple(driver_addr), authkey=authkey)
    conn.send({"type": "hello", "executor_id": executor_id, "host": host,
               "pid": os.getpid(), "work_dir": work_dir})
    logger.info("executor %d connected to driver %s", executor_id, driver_addr)

    while True:
        msg = conn.recv()
        mtype = msg.get("type")
        if mtype == "task":
            reply = run_task(msg["func"], msg.get("payload"))
            reply.update(type="result", job_id=msg["job_id"], task_id=msg["task_id"])
            conn.send(reply)
        elif mtype == "stop":
            logger.info("executor %d stopping", executor_id)
            conn.send({"type": "bye", "executor_id": executor_id})
            break
        else:
            logger.warning("executor %d: unknown message %r", executor_id, mtype)
    conn.close()


def main(argv=None):
    parser = argparse.ArgumentParser(description="tensorflowonspark_tpu_torch executor")
    parser.add_argument("--driver", required=True, help="driver HOST:PORT")
    parser.add_argument("--executor-id", type=int, required=True)
    parser.add_argument("--authkey-file", required=True,
                        help="file holding the cluster authkey bytes")
    parser.add_argument("--work-dir", required=True)
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(levelname)s exec[{}] %(name)s: %(message)s".format(
            args.executor_id))
    # kill -USR1 <executor pid> dumps every thread's stack to the log —
    # the first tool to reach for when a feed wedges on a remote host
    import faulthandler
    import signal as _signal
    faulthandler.register(_signal.SIGUSR1, file=sys.stderr)
    host, port = args.driver.rsplit(":", 1)
    with open(args.authkey_file, "rb") as f:
        authkey = f.read()
    executor_main((host, int(port)), args.executor_id, authkey, args.work_dir)


if __name__ == "__main__":
    # Run the *canonical* module's main: under ``python -m`` this file is
    # the __main__ module, a different object from
    # tensorflowonspark_tpu_torch.engine.executor — task closures importing the
    # latter must see the EXECUTOR_INFO this process populates.
    from tensorflowonspark_tpu_torch.engine.executor import main as _canonical_main

    _canonical_main()
