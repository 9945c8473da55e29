"""The port's supervised-cluster observability and profiler hooks held
against the JAX package's.

- ``SupervisedCluster.metrics()`` on a real 2-executor supervised job:
  the reference's case (``tests/test_observability.py``) rebound to the
  port's engine, its map_fun's imports pointed at the port.
- ``tracing.metrics_hook`` publishing the goodput ratio beside
  throughput: the reference's case (``tests/test_goodput.py``) on both
  packages.
- The profiler hooks: ``start_profiler_server`` is idempotent, one
  endpoint a process returning its bound port (the reference's case
  patches jax's server; the port's contract is checked on its HTTP
  endpoint, whose ``/capture`` writes a ``torch.profiler`` Chrome
  trace); ``trace(log_dir)`` writes a Chrome trace naming the ops it
  saw; ``SummaryWriter`` writes event files where ``tensorboard``
  imports and is a no-op (never raising) where it does not.
- The reference's slow / chaos cases (a real stalled consumer's
  ``feeder_stall`` incident with its flight dump, the goodput ledger
  summing to wall across a stall and a kill, the straggler incident)
  are mirrored under the same marks on the port's ``Context``.
"""

import builtins
import inspect
import json
import os
import urllib.error
import urllib.request

import pytest

import test_torch_fleet
from tensorflowonspark_tpu import chaos as jchaos
from tensorflowonspark_tpu import goodput as jgoodput
from tensorflowonspark_tpu_torch import (chaos, cluster, goodput,
                                         metrics_report, supervisor,
                                         tracing)
from tensorflowonspark_tpu_torch.engine import Context


def _namespace(filename):
    return test_torch_fleet.port_namespace(
        filename, port_imports=True, cluster=cluster,
        supervisor=supervisor, goodput=goodput,
        metrics_report=metrics_report, Context=Context)


OBS_REF, OBS = _namespace("test_observability.py")
GOODPUT_REF, GOODPUT = _namespace("test_goodput.py")


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    monkeypatch.delenv(chaos.ENV_VAR, raising=False)
    chaos.disarm()
    jchaos.disarm()
    goodput.reset()
    jgoodput.reset()
    yield
    chaos.disarm()
    jchaos.disarm()
    goodput.reset()
    jgoodput.reset()


@pytest.fixture()
def fresh_profiler(monkeypatch):
    """This process's profiler endpoint, forgotten after the test (the
    server thread is a daemon; its socket closes here)."""
    monkeypatch.setattr(tracing, "_PROFILER_PORT", None)
    monkeypatch.setattr(tracing, "_PROFILER_SERVER", None)
    yield
    server = tracing._PROFILER_SERVER
    if server is not None:
        server.shutdown()
        server.server_close()


def test_supervised_cluster_metrics_two_executors(tmp_path):
    OBS["test_supervised_cluster_metrics_two_executors"](tmp_path)


def test_metrics_hook_emits_goodput_ratio_alongside_throughput():
    GOODPUT_REF.test_metrics_hook_emits_goodput_ratio_alongside_throughput()
    jgoodput.reset()
    GOODPUT["test_metrics_hook_emits_goodput_ratio_alongside_throughput"]()


def test_start_profiler_server_idempotent(fresh_profiler, tmp_path):
    """The reference's contract on the port's endpoint: the first call
    binds and returns the port; re-calls return the LIVE port without
    starting another server, even when they ask for a different one."""
    port = tracing.start_profiler_server(0, log_dir=str(tmp_path))
    assert isinstance(port, int) and port > 0
    server = tracing._PROFILER_SERVER
    assert tracing.start_profiler_server(0) == port
    assert tracing.start_profiler_server(1234) == port
    assert tracing._PROFILER_SERVER is server
    base = "http://127.0.0.1:%d" % port
    about = json.loads(urllib.request.urlopen(base + "/", timeout=10).read())
    assert about["pid"] == os.getpid() and about["log_dir"] == str(tmp_path)


def test_profiler_endpoint_captures_a_chrome_trace(fresh_profiler,
                                                   tmp_path):
    port = tracing.start_profiler_server(0, log_dir=str(tmp_path))
    base = "http://127.0.0.1:%d" % port
    got = json.loads(urllib.request.urlopen(base + "/capture?ms=50",
                                            timeout=60).read())
    assert got["ms"] == 50 and os.path.dirname(got["trace"]) == \
        str(tmp_path)
    with open(got["trace"]) as f:
        assert isinstance(json.load(f)["traceEvents"], list)
    for bad, code in (("/capture?ms=0", 400), ("/capture?ms=x", 400),
                      ("/capture?ms=600001", 400), ("/nope", 404)):
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + bad, timeout=10)
        assert err.value.code == code, bad


def test_trace_writes_a_chrome_trace_of_the_window(tmp_path):
    import torch

    x = torch.randn(32, 32)
    with tracing.trace(str(tmp_path / "t")) as tr:
        (x @ x).sum()
    assert os.path.dirname(tr.path) == str(tmp_path / "t")
    with open(tr.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names, sorted(names)[:20]


def test_summary_writer_without_tensorboard_is_a_noop(tmp_path,
                                                      monkeypatch):
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard") or \
                name.startswith("tensorboard"):
            raise ImportError("no tensorboard here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    writer = tracing.SummaryWriter(str(tmp_path / "tb"))
    assert writer.backend is None
    hook = tracing.metrics_hook(writer, every_steps=1, examples_per_step=4)
    hook(1, None, {"loss": 0.5})
    writer.text("note", "x", 1)
    writer.flush()
    writer.close()
    assert not os.path.exists(tmp_path / "tb")


def test_summary_writer_writes_event_files_where_tensorboard_imports(
        tmp_path):
    pytest.importorskip("tensorboard")
    writer = tracing.SummaryWriter(str(tmp_path / "tb"))
    assert writer.backend == "torch.utils.tensorboard"
    writer.scalar("train/loss", 0.5, 1)
    writer.close()
    assert [n for n in os.listdir(tmp_path / "tb") if "tfevents" in n]


def test_the_profiler_hooks_carry_the_references_names():
    from tensorflowonspark_tpu import tracing as jtracing

    for name in ("start_profiler_server", "trace", "SummaryWriter",
                 "metrics_hook"):
        assert hasattr(tracing, name) and hasattr(jtracing, name)
    assert list(inspect.signature(tracing.metrics_hook).parameters) == \
        list(inspect.signature(jtracing.metrics_hook).parameters)
    mine = {n for n in vars(tracing.SummaryWriter) if not n.startswith("_")}
    assert mine == {n for n in vars(jtracing.SummaryWriter)
                    if not n.startswith("_")}


# -- mirrors of the reference's slow / chaos cases -------------------------

@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_feeder_stall_incident_has_flight_dump(tmp_path):
    OBS["test_chaos_feeder_stall_incident_has_flight_dump"](tmp_path)


@pytest.mark.chaos
@pytest.mark.slow
def test_goodput_ledger_sums_to_wall_under_stall_kill_recovery(tmp_path):
    GOODPUT["test_goodput_ledger_sums_to_wall_under_stall_kill_recovery"](
        tmp_path)


@pytest.mark.chaos
@pytest.mark.slow
def test_straggler_incident_fires_under_injected_stall(tmp_path):
    GOODPUT["test_straggler_incident_fires_under_injected_stall"](tmp_path)
