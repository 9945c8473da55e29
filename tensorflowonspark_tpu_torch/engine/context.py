"""Driver context: owns executors, schedules tasks, surfaces errors — the
port's copy of ``tensorflowonspark_tpu/engine/context.py``.

The Spark-role substrate (SURVEY.md §1 "load-bearing third-party
substrate"): process placement, task dispatch, and error aggregation for
the cluster layer above. Local mode spawns executor processes itself;
standalone mode (``spawn_local=False``) just listens and lets a launcher
start ``python -m tensorflowonspark_tpu_torch.engine.executor`` on each host —
the ``spark-submit``-shaped path.

Deliberate semantic carried over from Spark: a failed task fails the job
and the error (with the executor-side traceback) re-raises on the driver
when the job result is awaited — the reference's error-propagation story
(SURVEY.md §3.5) depends on exactly this.
"""

import logging
import os
import queue
import subprocess
import sys
import threading
import time
from multiprocessing.connection import Listener

from tensorflowonspark_tpu_torch.engine import serializer
from tensorflowonspark_tpu_torch.engine.rdd import RDD, _Partition

logger = logging.getLogger(__name__)

_STOP = object()


class TaskError(RuntimeError):
    """A task failed on an executor; message carries the remote traceback."""


class AsyncResult(object):
    """Handle to a running job (analog of Spark's ASyncRDDActions result)."""

    def __init__(self, num_tasks, fail_fast=True):
        self._results = [None] * num_tasks
        self._pending = num_tasks
        self._errors = []
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._fail_fast = fail_fast
        # ``fail_fast=False`` keeps run-every-task semantics for jobs whose
        # siblings matter even after one fails — cleanup/shutdown jobs
        # (EndFeed to executor k must still be delivered when executor j's
        # shutdown task raised).
        # Set on the FIRST failure, while other tasks may still be running:
        # the job is already lost (failed-task-fails-the-job), so waiters
        # must not keep blocking on tasks whose only remaining purpose is
        # to time out: a trainer wedged in a C-level device call would
        # otherwise make every later feed task burn its full 600s
        # feed_timeout before the driver heard about the first failure.
        self._failed = threading.Event()
        # _wake fires at either terminal event (all tasks resolved, or
        # first failure of a fail-fast job) so get() is one blocking wait,
        # not a poll — the bootstrap job is awaited for days at a time.
        self._wake = threading.Event()

    def _complete(self, task_id, value):
        with self._lock:
            self._results[task_id] = value
            self._pending -= 1
            if self._pending == 0:
                self._done.set()
                self._wake.set()

    def _fail(self, task_id, error):
        with self._lock:
            self._errors.append((task_id, error))
            self._pending -= 1
            if self._pending == 0:
                self._done.set()
        if self._fail_fast:
            self._failed.set()
        if self._fail_fast or self._done.is_set():
            self._wake.set()

    def done(self):
        return self._done.is_set()

    def successful(self):
        return self._done.is_set() and not self._errors

    def first_error(self):
        """(task_id, error) of the first failed task so far, else None —
        readable while other tasks are still running (fail-fast probes)."""
        with self._lock:
            return self._errors[0] if self._errors else None

    def get(self, timeout=None):
        """Block until the job completes OR its first task fails.

        Fail-fast is the Spark-parity contract: one failed task aborts the
        job, so the driver re-raises the moment the first error arrives
        rather than waiting out tasks that are already doomed (undispatched
        tasks of a failed job are skipped by the dispatch loop). Tasks
        still running when this raises are bounded by ``Context.stop``'s
        terminate-with-escalation."""
        if not self._wake.wait(timeout):
            raise TimeoutError(
                "job did not complete within {}s".format(timeout))
        if self._errors:
            task_id, error = self._errors[0]
            raise TaskError("task {} failed: {}".format(task_id, error))
        return list(self._results)


class _ExecutorHandle(object):
    """Driver-side mirror of one executor: its connection + dispatch thread."""

    def __init__(self, ctx, conn, meta):
        self.ctx = ctx
        self.conn = conn
        self.executor_id = meta["executor_id"]
        self.meta = meta
        self.own_queue = queue.Queue()
        self.alive = True
        self.conn_broken = False
        self.thread = threading.Thread(  # tfos: unjoined(daemon; exits when its executor connection closes — the engine has no per-handle teardown hook)
            target=self._loop, name="executor-handle-%d" % self.executor_id,
            daemon=True)
        self.thread.start()

    def _next_task(self):
        """Prefer pinned tasks, else pull from the shared pool."""
        while self.alive and not self.ctx._stopping.is_set():
            try:
                return self.own_queue.get(timeout=0.05)
            except queue.Empty:
                pass
            try:
                return self.ctx._shared_tasks.get(timeout=0.05)
            except queue.Empty:
                continue
        return _STOP

    def _loop(self):
        task = None
        try:
            while True:
                task = self._next_task()
                if task is _STOP:
                    break
                if task["result"]._failed.is_set():
                    # Job already lost: don't ship a task whose only
                    # possible outcome is burning its own timeout (e.g. a
                    # feed task pushing 600s into a ring nobody drains).
                    # Checked BEFORE the exclusion below, so an excluded
                    # executor drains a dead job's tasks instead of
                    # requeueing them forever (with every eligible
                    # sibling dead, nobody else ever would).
                    task["result"]._fail(
                        task["task_id"],
                        "job aborted: an earlier task already failed")
                    task = None
                    continue
                exclude = task.get("exclude")
                if exclude and self.executor_id in exclude:
                    # blacklisted for this job (supervision plane): hand
                    # the task back for an eligible sibling; the short
                    # sleep keeps an idle excluded executor from spinning
                    # on its own requeue
                    self.ctx._shared_tasks.put(task)
                    time.sleep(0.02)
                    task = None
                    continue
                self.conn.send({"type": "task", "job_id": task["job_id"],
                                "task_id": task["task_id"], "func": task["func"],
                                "payload": task["payload"]})
                reply = self.conn.recv()
                result = task["result"]
                if reply.get("ok"):
                    result._complete(task["task_id"],
                                     serializer.loads(reply["value"]))
                else:
                    self.ctx._saw_failure = True
                    result._fail(task["task_id"],
                                 reply.get("traceback") or reply.get("error"))
                task = None
        except (EOFError, OSError, BrokenPipeError) as e:
            logger.error("executor %d connection lost: %s", self.executor_id, e)
            self.ctx._saw_failure = True
            self.conn_broken = True
            if task is not None and task is not _STOP:
                task["result"]._fail(
                    task["task_id"],
                    "executor {} died while running task (connection lost: {})"
                    .format(self.executor_id, e))
            self.alive = False
            self.ctx._on_handle_dead(self)
        finally:
            self.alive = False

    def send_stop(self):
        self.own_queue.put(_STOP)

    def close(self):
        try:
            if not self.conn_broken:
                self.conn.send({"type": "stop"})
                # Only await the bye reply if our dispatch thread has exited:
                # a Connection must not be recv()'d from two threads, and a
                # still-alive thread may be blocked in recv on a long task.
                if not self.thread.is_alive() and self.conn.poll(5):
                    self.conn.recv()
        except (EOFError, OSError, BrokenPipeError):
            pass
        try:
            self.conn.close()
        except OSError:
            pass


class Context(object):
    """Driver entry point (the ``sc`` the cluster API takes).

    Args:
      num_executors: world size (fixed, like the reference's).
      spawn_local: spawn executor subprocesses on this host (local mode);
        False = standalone mode, wait for externally launched executors.
      executor_env: extra env vars for spawned executors.
      work_root: scratch root; each executor gets work_root/executor-N as
        its cwd (the executor-id persistence dir, SURVEY.md util row).
      host: address to listen on (default loopback — local mode).
    """

    def __init__(self, num_executors, spawn_local=True, executor_env=None,
                 work_root=None, host="127.0.0.1", app_name="tfos-tpu",
                 start_timeout=120):
        self.num_executors = num_executors
        self.app_name = app_name
        self.authkey = os.urandom(20)
        # Auto-generated work roots are cleaned up on a CLEAN stop();
        # any failure keeps them — executor.log is the post-mortem. A
        # user-passed work_root is never deleted (it's theirs), and
        # TFOS_KEEP_WORKDIR=1 keeps even auto roots (debug sessions).
        self._auto_work_root = work_root is None
        self._saw_failure = False
        self.work_root = work_root or os.path.join(
            os.getcwd(), ".tfos-{}-{}".format(app_name, os.getpid()))
        os.makedirs(self.work_root, exist_ok=True)
        # backlog: mp.Listener defaults to 1, and a pod-shaped fleet
        # connects all at once — overflowed SYNs leave clients half-open
        # (ESTAB on their side, nothing in our accept queue) wedged in
        # the authkey challenge recv forever (found by the 8-process
        # scale rehearsal; 5/8 or 7/8 would connect, never all)
        self._listener = Listener((host, 0), backlog=128,
                                  authkey=self.authkey)
        self.driver_addr = self._listener.address
        self._handles = {}
        self._procs = []
        self._shared_tasks = queue.Queue()
        self._stopping = threading.Event()
        self._job_counter = 0
        self._lock = threading.Lock()
        # tfos: unjoined(daemon; _accept_loop exits when stop() closes the listening socket)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               name="engine-accept", daemon=True)
        self._accept_thread.start()
        # Connection info lands on disk BEFORE we block waiting for
        # executors, so standalone-mode launchers can read it and start
        # `python -m tensorflowonspark_tpu_torch.engine.executor` on each host.
        self.authkey_file = self._write_connection_info()
        self._spawn_local = spawn_local
        self._executor_env = dict(executor_env or {})
        if spawn_local:
            self._spawn_local_executors(self._executor_env)
        self._await_executors(start_timeout)

    # -- bootstrap -------------------------------------------------------

    def _write_connection_info(self):
        """Write authkey (0600) + driver.info JSON; returns authkey path."""
        import json
        authkey_file = os.path.join(self.work_root, "authkey")
        fd = os.open(authkey_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "wb") as f:
            f.write(self.authkey)
        with open(os.path.join(self.work_root, "driver.info"), "w") as f:
            json.dump({"host": self.driver_addr[0], "port": self.driver_addr[1],
                       "authkey_file": authkey_file,
                       "num_executors": self.num_executors}, f)
        return authkey_file

    def _spawn_local_executors(self, executor_env):
        for i in range(self.num_executors):
            self._spawn_one(i, executor_env)
        logger.info("spawned %d local executors (logs under %s)",
                    self.num_executors, self.work_root)

    def _spawn_one(self, executor_id, executor_env=None):
        """Spawn one local executor process; returns the Popen handle."""
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env.update(executor_env if executor_env is not None
                   else self._executor_env)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        work_dir = os.path.join(self.work_root, "executor-%d" % executor_id)
        os.makedirs(work_dir, exist_ok=True)
        log_path = os.path.join(work_dir, "executor.log")
        logfh = open(log_path, "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "tensorflowonspark_tpu_torch.engine.executor",
             "--driver", "{}:{}".format(*self.driver_addr),
             "--executor-id", str(executor_id),
             "--authkey-file", self.authkey_file,
             "--work-dir", work_dir],
            env=env, stdout=logfh, stderr=subprocess.STDOUT)
        logfh.close()
        self._procs.append(proc)
        return proc

    def _accept_loop(self):
        while not self._stopping.is_set():
            try:
                conn = self._listener.accept()
            except Exception as e:  # noqa: BLE001 - incl. AuthenticationError
                if self._stopping.is_set():
                    break
                logger.warning("rejected executor connection: %s", e)
                continue
            try:
                hello = conn.recv()
            except (EOFError, OSError):
                conn.close()
                continue
            if hello.get("type") != "hello":
                conn.close()
                continue
            eid = hello.get("executor_id")
            with self._lock:
                old = self._handles.get(eid)
                if old is not None and old.alive:
                    logger.error(
                        "duplicate executor_id %s from %s rejected (already "
                        "registered and alive)", eid, hello.get("host"))
                    conn.close()
                    continue
            handle = _ExecutorHandle(self, conn, hello)
            with self._lock:
                self._handles[eid] = handle
            logger.info("executor %d registered from %s (pid %s)",
                        eid, hello.get("host"), hello.get("pid"))

    def _await_executors(self, timeout):
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                n = len(self._handles)
            if n >= self.num_executors:
                return
            for proc in self._procs:
                if proc.poll() is not None:
                    # before stop(): its clean-exit cleanup must not
                    # delete the very logs this error points at
                    self._saw_failure = True
                    self.stop()
                    raise RuntimeError(
                        "executor process exited with code {} during startup; "
                        "see logs under {}".format(proc.returncode, self.work_root))
            if time.monotonic() > deadline:
                self._saw_failure = True
                self.stop()
                raise TimeoutError(
                    "only {}/{} executors connected within {}s".format(
                        n, self.num_executors, timeout))
            time.sleep(0.05)

    # -- Spark-shaped API ------------------------------------------------

    @property
    def defaultParallelism(self):
        return self.num_executors

    def parallelize(self, data, num_slices=None):
        data = list(data)
        n = num_slices or self.num_executors
        n = max(1, min(n, len(data)) if data else 1)
        size, extra = divmod(len(data), n)
        parts, start = [], 0
        for i in range(n):
            end = start + size + (1 if i < extra else 0)
            parts.append(_Partition(data[start:end]))
            start = end
        return RDD(self, parts)

    def createDataFrame(self, data, schema=None, num_slices=None):
        """Rows -> DataFrame (see engine/dataframe.py for row/schema forms)."""
        from tensorflowonspark_tpu_torch.engine.dataframe import (
            create_dataframe)
        return create_dataframe(self, data, schema, num_slices)

    def union(self, rdds):
        out = rdds[0]
        for r in rdds[1:]:
            out = out.union(r)
        return out

    def run_job(self, rdd, func, one_task_per_executor=False,
                fail_fast=True, exclude=()):
        """Ship ``func`` over every partition; returns :class:`AsyncResult`.

        ``fail_fast=False`` opts a job out of abort-on-first-failure:
        every task still runs and ``get()`` waits for all of them
        (cleanup/shutdown jobs).

        ``exclude``: executor ids barred from running this job's tasks —
        the supervision plane's blacklist (a repeatedly failing executor
        keeps its process but receives no work). Pinned
        (one_task_per_executor) jobs simply skip excluded executors in
        the task->executor mapping; shared-pool tasks carry the set and
        an excluded executor that pulls one hands it back.

        Fail-fast abort scope (deliberately BEST-EFFORT): the first
        failure wakes ``get()`` immediately and marks the job failed, and
        the dispatch loop skips every not-yet-shipped task of that job —
        but tasks ALREADY shipped to an executor run to completion (or
        burn their own timeout) and their results are discarded. There is
        no in-flight cancel message: the executor protocol is
        send-task/await-reply over one connection, so a cancel could not
        be heard until the task finished anyway — preemption would need
        killing the executor process, which costs more than letting a
        doomed task drain (and the trainer-owned card makes process
        recycling expensive). Callers must therefore treat ``get()``
        raising as "job lost", not "cluster quiesced"; ``Context.stop``'s
        terminate-with-escalation is the hard bound on stragglers."""
        partitions = rdd._partitions
        exclude = frozenset(exclude or ())
        result = AsyncResult(len(partitions), fail_fast=fail_fast)
        with self._lock:
            self._job_counter += 1
            job_id = self._job_counter
            handles = {eid: h for eid, h in self._handles.items()
                       if h.alive and eid not in exclude}
        if not handles:
            raise RuntimeError(
                "no executors alive to run job" +
                (" (after excluding {})".format(sorted(exclude))
                 if exclude else ""))
        if one_task_per_executor and len(partitions) > len(handles):
            raise ValueError(
                "job needs {} executors but only {} are alive{}".format(
                    len(partitions), len(handles),
                    " and eligible" if exclude else ""))
        for task_id, part in enumerate(partitions):
            full = _compose(part.transform, func)
            task = {"job_id": job_id, "task_id": task_id,
                    "func": serializer.dumps(full),
                    "payload": serializer.dumps(part.payload),
                    "result": result, "exclude": exclude}
            if one_task_per_executor:
                executor_id = sorted(handles)[task_id]
                handles[executor_id].own_queue.put(task)
            else:
                self._shared_tasks.put(task)
        return result

    def executors_alive(self):
        with self._lock:
            return sorted(eid for eid, h in self._handles.items() if h.alive)

    def revive_executor(self, executor_id, timeout=60):
        """Respawn a dead local executor under its original id — the
        "capacity returns" half of the supervision plane's elastic
        resize (an ElasticResize regrow probe watches
        :meth:`executors_alive` recover). The replacement process
        reuses the executor's work dir and registers through the normal
        accept loop (the duplicate-id guard passes because the old
        handle is dead). Returns False if the executor is already
        alive; raises in standalone mode (the launcher owns process
        placement there) or when the replacement fails to register
        within ``timeout``."""
        executor_id = int(executor_id)
        with self._lock:
            handle = self._handles.get(executor_id)
            if handle is not None and handle.alive:
                return False
        if not self._spawn_local:
            raise NotImplementedError(
                "revive_executor requires local mode; standalone "
                "launchers must restart their own executor processes")
        if self._stopping.is_set():
            raise RuntimeError("context is stopping; not reviving")
        proc = self._spawn_one(executor_id)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                handle = self._handles.get(executor_id)
                if handle is not None and handle.alive:
                    logger.info("executor %d revived (pid %d)",
                                executor_id, proc.pid)
                    return True
            if proc.poll() is not None:
                raise RuntimeError(
                    "revived executor {} exited with code {} during "
                    "startup; see logs under {}".format(
                        executor_id, proc.returncode, self.work_root))
            time.sleep(0.05)
        raise TimeoutError(
            "revived executor {} did not register within {}s".format(
                executor_id, timeout))

    def _on_handle_dead(self, handle):
        """Reap a dead executor: fail its pinned tasks, and if no executors
        remain, fail everything in the shared pool — a job must never hang
        because its worker died (the docstring's failed-task-fails-the-job
        contract)."""
        with self._lock:
            if self._handles.get(handle.executor_id) is handle:
                del self._handles[handle.executor_id]
            any_alive = any(h.alive for h in self._handles.values())
        _drain_failing(handle.own_queue,
                       "executor {} died before running pinned task".format(
                           handle.executor_id))
        if not any_alive and not self._stopping.is_set():
            _drain_failing(self._shared_tasks, "no executors alive")

    def stop(self, timeout=15):
        """Stop executors and the listener; idempotent."""
        if self._stopping.is_set():
            return
        self._stopping.set()
        _drain_failing(self._shared_tasks, "driver stopping")
        with self._lock:
            handles = list(self._handles.values())
        for h in handles:
            h.send_stop()
        for h in handles:
            h.thread.join(timeout=5)
        for h in handles:
            h.close()
        try:
            self._listener.close()
        except OSError:
            pass
        deadline = time.monotonic() + timeout
        for proc in self._procs:
            left = max(0.1, deadline - time.monotonic())
            try:
                proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                logger.warning("killing unresponsive executor pid %s", proc.pid)
                self._saw_failure = True
                proc.kill()
                proc.wait(timeout=5)
            if proc.returncode not in (0, None):
                self._saw_failure = True
        if self._procs:
            # local executors shared this host: reap any shm feed rings
            # their processes left behind (SIGKILL skips atexit paths).
            # glob first — sweep_stale only loads/builds the native lib
            # at the unlink step, so a queue-only driver with nothing to
            # reap never pays a g++ build (or its failure) at shutdown
            import glob as _glob
            if _glob.glob("/dev/shm/tfos-*.*"):
                try:
                    from tensorflowonspark_tpu_torch import shm
                    shm.sweep_stale()
                except Exception:  # noqa: BLE001 - cleanup is best effort
                    logger.debug("stale ring sweep failed", exc_info=True)
        if (self._auto_work_root and not self._saw_failure
                and os.environ.get("TFOS_KEEP_WORKDIR") != "1"):
            # clean exit: the auto-generated scratch root (executor logs,
            # authkey, driver.info) has served its purpose — don't litter
            # the caller's cwd with one dir per run. Any failure above
            # keeps it: executor.log is the post-mortem.
            self._remove_engine_artifacts()
        elif self._saw_failure:
            logger.info("keeping work root %s (failures this session)",
                        self.work_root)

    def _remove_engine_artifacts(self):
        """Remove only what the engine itself created under work_root.

        Executors ``os.chdir`` into ``work_root/executor-N``, so user
        task files written with relative paths (without
        ``ctx.absolute_path``) land there — an ``shutil.rmtree`` of the
        whole root on a clean run silently destroyed them. The engine's
        own artifacts are precisely enumerable (authkey, driver.info,
        each executor's executor.log + persisted executor_id), so remove
        exactly those; directories are removed only once empty, and a
        root still holding user files survives intact.
        """
        from tensorflowonspark_tpu_torch.util import EXECUTOR_ID_FILE
        for name in ("authkey", "driver.info"):
            try:
                os.unlink(os.path.join(self.work_root, name))
            except OSError:
                pass
        for i in range(self.num_executors):
            exec_dir = os.path.join(self.work_root, "executor-%d" % i)
            for name in ("executor.log", EXECUTOR_ID_FILE):
                try:
                    os.unlink(os.path.join(exec_dir, name))
                except OSError:
                    pass
            try:
                os.rmdir(exec_dir)
            except OSError:
                pass  # user files present (or already gone): keep
        try:
            os.rmdir(self.work_root)
        except OSError:
            if os.path.isdir(self.work_root):
                logger.info("keeping work root %s (user task files present)",
                            self.work_root)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _drain_failing(q, reason):
    """Fail every task currently waiting in queue ``q`` with ``reason``."""
    while True:
        try:
            task = q.get_nowait()
        except queue.Empty:
            return
        if task is _STOP or not isinstance(task, dict):
            continue
        task["result"]._fail(task["task_id"], reason)


def _compose(transform, func):
    def full(raw_iter, _t=transform, _f=func):
        return _f(_t(raw_iter) if _t is not None else raw_iter)
    return full
