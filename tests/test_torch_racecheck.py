"""The concurrency lint over the port's threads.

The port's own analyzer (``tensorflowonspark_tpu_torch/analysis``, a
copy of the JAX package's, stdlib ``ast`` only; run as
``racecheck.run(paths, baseline)``) scans ``tensorflowonspark_tpu_torch/``
against the port's baseline,
``tensorflowonspark_tpu_torch/analysis/baseline.json``, where each
benign finding carries a written reason. A finding that is not in the
baseline fails; so does a baseline entry without a reason. The
streaming loop (``engine/streaming.py``) and the Spark adapter's job
thread (``engine/spark_adapter.py``, annotated ``# tfos:
unjoined(...)``) are covered like every other thread of the port, and
so is the decode scheduler's newer state: the KV job queue, the
speculative draft's cache, the fair scheduler and the drain latch, the
server's SIGTERM drain thread, the supervisor's monitor and the
autoscaler's control loop.
"""

import io
import json
import os

from tensorflowonspark_tpu_torch.analysis import racecheck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tensorflowonspark_tpu_torch")
BASELINE = os.path.join(PORT, "analysis", "baseline.json")


def _run(paths, baseline):
    out, err = io.StringIO(), io.StringIO()
    rc = racecheck.run(paths, baseline, out=out, err=err)
    return rc, out.getvalue() + err.getvalue()


def test_port_is_clean_against_its_baseline():
    rc, text = _run([PORT], BASELINE)
    assert rc == 0, text
    assert "0 new" in text and "10 baselined" in text, text


def test_every_baseline_entry_has_a_reason_and_still_matches():
    with open(BASELINE) as f:
        entries = json.load(f)["entries"]
    assert len(entries) == 10
    assert all(len(e["reason"].strip()) > 40 for e in entries)
    rc, text = _run([PORT], None)
    assert rc == 1
    for e in entries:
        assert e["key"] in text, e["key"]


def test_a_new_finding_fails(tmp_path):
    """A copy of the port's streaming loop with one more thread that is
    neither joined nor annotated is a new finding the baseline does not
    cover."""
    src = open(os.path.join(PORT, "engine", "streaming.py")).read()
    src += (
        "\n\ndef _leak():\n"
        "    t = threading.Thread(target=time.sleep, args=(1,),\n"
        "                         name='leak', daemon=True)\n"
        "    t.start()\n")
    bad = tmp_path / "tensorflowonspark_tpu_torch" / "engine"
    bad.mkdir(parents=True)
    (bad / "streaming.py").write_text(src)
    rc, text = _run([str(tmp_path / "tensorflowonspark_tpu_torch")],
                    BASELINE)
    assert rc == 1
    assert "thread-unjoined" in text, text


def _mutated_port(tmp_path, edits):
    """A copy of the port's ``serving.py`` with ``edits`` (old, new)
    applied, in a package directory of its own; returns its root."""
    src = open(os.path.join(PORT, "serving.py")).read()
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    root = tmp_path / "tensorflowonspark_tpu_torch"
    root.mkdir()
    (root / "serving.py").write_text(src)
    return str(root)


def test_kv_jobs_and_draft_cache_are_covered(tmp_path):
    """The scheduler-thread state the speculative and disaggregation
    planes added is inside the lint's view: a KV job queued without
    ``_cv``, and a draft cache rebound both on the scheduler thread and
    from a client's call, are each a new finding."""
    root = _mutated_port(tmp_path, [
        ("""            self._kv_jobs.append(job)
            self._cv.notify_all()""",
         """            self._cv.notify_all()
        self._kv_jobs.append(job)"""),
        ("""        cache = [{n: t.clone() for n, t in layer.items()}
                 for layer in self._cache]""",
         """        cache = [{n: t.clone() for n, t in layer.items()}
                 for layer in self._cache]
        self._draft_cache = list(self._draft_cache)"""),
        ("""            with self.timers.timed("draft_prefill"):""",
         """            self._draft_cache = list(self._draft_cache)
            with self.timers.timed("draft_prefill"):""")])
    rc, text = _run([root], BASELINE)
    assert rc == 1
    assert "DecodeEngine._kv_call:_kv_jobs" in text, text
    assert "DecodeEngine:_draft_cache" in text, text


def test_qos_scheduler_and_drain_latch_are_covered(tmp_path):
    """The QoS and lifecycle planes' scheduler state is inside the lint's
    view: the drain latch set before ``_cv`` is taken, and the fair
    scheduler rebound from a client's call while the scheduler thread
    rebinds it under ``_cv``, are each a new finding."""
    root = _mutated_port(tmp_path, [
        ("""        t_drain0 = time.monotonic()
        with self._cv:""",
         """        t_drain0 = time.monotonic()
        self._draining = True
        with self._cv:"""),
        ("""    def outstanding(self):""",
         """    def reset_fairness(self):
        self._qos_sched = qos.FairScheduler(self.qos_policy)

    def outstanding(self):"""),
        ("""                if not live:
                    self._qos_sched.forget(handle.tenant)""",
         """                if not live:
                    self._qos_sched = qos.FairScheduler(self.qos_policy)""")])
    rc, text = _run([root], BASELINE)
    assert rc == 1
    assert "DecodeEngine.drain:_draining" in text, text
    assert "DecodeEngine.reset_fairness:_qos_sched" in text, text
