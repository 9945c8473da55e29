"""The port's feed plane against the JAX package's, on the CPU.

- ``frames``: columnar chunks (positional, named, bare values), record
  lists and coalesced multi-frames encode to the SAME bytes in both
  packages, and each package decodes the other's frames.
- ``shm``: the port builds ``native/shm_ring.cpp`` into its own
  ``_build/`` (never the JAX package's library) and its ring moves the
  same frames, across the two packages' bindings too; two processes
  building at once leave one whole library.
- ``manager``: queues and kv, in process and from another process.
- ``DataFeed``: the same partitions through both packages' node feed
  helpers and ``DataFeed``, over the shm ring and over the queues, give
  equal numpy batches — bare records, ``input_mapping`` and
  ``pad_to_batch`` — and ``infeed.device_batches`` copies each batch out
  of the feed's reused staging buffer.
- ``tracing``: both registries render identical OpenMetrics text (and
  equal snapshots, merges and cluster renders) for the same updates.
- ``goodput``: both ledgers give the same account on a fake clock.
- ``chaos``: the same seeded plan fires at the same sites.
"""

import importlib
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu_torch import chaos, frames, goodput, infeed
from tensorflowonspark_tpu_torch import manager, shm, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("tensorflowonspark_tpu", "tensorflowonspark_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(pkg + "." + name)


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    for pkg in PKGS:
        monkeypatch.delenv(_mod(pkg, "chaos").ENV_VAR, raising=False)
        _mod(pkg, "chaos").disarm()
        _mod(pkg, "goodput").reset()
    yield
    for pkg in PKGS:
        _mod(pkg, "chaos").disarm()
        _mod(pkg, "goodput").reset()


# -- frames ------------------------------------------------------------------

def _objects(fr):
    rng = np.random.RandomState(0)
    rows = [(rng.randn(3, 2).astype(np.float32), np.int64(i))
            for i in range(5)]
    dicts = [{"x": rng.randint(0, 9, 4).astype(np.int32), "y": np.float64(i)}
             for i in range(4)]
    return [
        fr.ColumnarChunk.from_records(rows),
        fr.ColumnarChunk.from_records(dicts),
        fr.ColumnarChunk.from_records([np.arange(3) + i for i in range(6)]),
        [1, 2.5, "three", (4, 5)],
    ]


def _wire(bufs):
    return b"".join(bytes(memoryview(b).cast("B")) for b in bufs)


def _same_chunk(a, b):
    assert type(a).__name__ == type(b).__name__ == "ColumnarChunk"
    assert a.names == b.names and a.scalar == b.scalar
    assert len(a.cols) == len(b.cols)
    for x, y in zip(a.cols, b.cols):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("i", range(4),
                         ids=["tuples", "dicts", "bare", "record_list"])
def test_frames_byte_identical_and_cross_decode(i):
    jfr = _mod("tensorflowonspark_tpu", "frames")
    jobj, tobj = _objects(jfr)[i], _objects(frames)[i]
    jwire, twire = _wire(jfr.encode(jobj)), _wire(frames.encode(tobj))
    assert jwire == twire
    for got, want in ((frames.decode(memoryview(jwire)), tobj),
                      (jfr.decode(memoryview(twire)), jobj)):
        if isinstance(want, list):
            assert got == want
        else:
            _same_chunk(got, want)


def test_multi_frames_byte_identical_and_cross_decode():
    jfr = _mod("tensorflowonspark_tpu", "frames")
    jobjs, tobjs = _objects(jfr)[:3], _objects(frames)[:3]
    jwire = _wire(jfr.encode_multi(jobjs))
    assert jwire == _wire(frames.encode_multi(tobjs))
    got = frames.decode(memoryview(jwire))
    assert isinstance(got, frames.FrameList) and len(got) == 3
    for g, w in zip(got, tobjs):
        _same_chunk(g, w)
    # the port's own markers round-trip through its codec
    from tensorflowonspark_tpu_torch.marker import EndPartition
    back = frames.decode(memoryview(_wire(frames.encode_multi(
        [tobjs[0], EndPartition()]))))
    assert isinstance(back[1], EndPartition)


# -- shm ---------------------------------------------------------------------

def _ring_name(tag):
    return "/tfos-torchtest-{}.{}".format(tag, os.getpid())


def test_ring_builds_into_the_port_and_moves_frames_across_packages():
    jshm = _mod("tensorflowonspark_tpu", "shm")
    assert shm.available()
    path = shm.library_path()
    assert os.path.dirname(path) == os.path.join(
        ROOT, "tensorflowonspark_tpu_torch", "_build")
    assert os.path.isfile(path)
    assert os.path.realpath(shm._load()._name) == os.path.realpath(path)
    name = _ring_name("x")
    ring = shm.ShmRing.create(name, 64 << 20)
    try:
        reader = jshm.ShmRing.open(name)  # the reference's binding
        chunk = _objects(frames)[0]
        for _ in range(3):
            ring.write_obj(chunk, timeout=5.0)
            got = reader.read_obj(timeout=5.0)
            _same_chunk(got, chunk)
        ring.write_obj([7, 8], timeout=5.0)
        assert reader.read_obj(timeout=5.0) == [7, 8]
        assert ring.wait_drained(timeout=5.0) and ring.pending() == 0
        reader.close()
    finally:
        ring.unlink()
        ring.close()


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    build = str(tmp_path / "build")
    code = ("import sys; sys.path.insert(0, {root!r})\n"
            "from tensorflowonspark_tpu_torch import shm\n"
            "shm.BUILD_DIR = {build!r}\n"
            "shm._build(shm.library_path())\n").format(root=ROOT, build=build)
    procs = [subprocess.Popen([sys.executable, "-c", code]) for _ in range(2)]
    assert [p.wait(timeout=240) for p in procs] == [0, 0]
    left = os.listdir(build)
    assert len(left) == 1 and left[0].endswith(".so"), left
    check = ("import sys; sys.path.insert(0, {root!r})\n"
             "from tensorflowonspark_tpu_torch import shm\n"
             "shm.BUILD_DIR = {build!r}\n"
             "r = shm.ShmRing.create('/tfos-torchtest-b.%d' % __import__('os')"
             ".getpid(), 64 << 20)\n"
             "r.write(b'abc', timeout=1.0); assert r.read(timeout=1.0) == "
             "b'abc'\n"
             "assert shm._lib._name.startswith({build!r})\n"
             "r.unlink(); r.close(); print('OK')\n").format(root=ROOT,
                                                            build=build)
    out = subprocess.run([sys.executable, "-c", check], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr


# -- manager -----------------------------------------------------------------

def test_manager_queues_and_kv_in_process():
    mgr = manager.start(b"torchkey", ["input", "output", "error"])
    assert mgr.get("state") == "running"
    mgr.set("feed_transport", "queue")
    assert mgr.get("feed_transport") == "queue"
    q = mgr.get_queue("input")
    q.put([1, 2, 3])
    assert q.get(timeout=5) == [1, 2, 3]
    q.task_done()
    assert mgr.join_queue("input", 1.0)


def test_manager_connect_from_another_process():
    mgr = manager.start(b"torchkey2", ["input", "output", "error"])
    code = ("import multiprocessing, sys; sys.path.insert(0, {root!r})\n"
            "from tensorflowonspark_tpu_torch import manager\n"
            "multiprocessing.current_process().authkey = b'torchkey2'\n"
            "m = manager.connect({addr!r}, b'torchkey2')\n"
            "m.set('from_child', 42)\n"
            "m.get_queue('output').put(['done'])\n").format(
                root=ROOT, addr=tuple(mgr.address))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60)
    assert mgr.get("from_child") == 42
    assert mgr.get_queue("output").get(timeout=5) == ["done"]


# -- DataFeed, both packages, both transports --------------------------------

def _partitions(kind):
    rng = np.random.RandomState(3)
    if kind == "ints":
        return [list(range(i * 10, i * 10 + n))
                for i, n in enumerate((7, 10, 3))]
    if kind == "tuples":
        recs = [(rng.randn(4).astype(np.float32), np.int64(i))
                for i in range(19)]
        return [recs[:8], recs[8:13], recs[13:]]
    recs = [{"tokens": rng.randint(0, 50, 9).astype(np.int64),
             "w": np.float32(i)} for i in range(17)]
    return [recs[:9], recs[9:]]


def _feed(pkg, transport, kind, batch, mapping=None, pad=False):
    """Feed the partitions through ``pkg``'s node feed helpers (as a feed
    task does: chunk, put, join) on a thread, and consume them with
    ``pkg``'s DataFeed; returns the batches, copied."""
    mgr_mod, node = _mod(pkg, "manager"), _mod(pkg, "node")
    DataFeed = _mod(pkg, "datafeed").DataFeed
    EndFeed = _mod(pkg, "marker").EndFeed
    mgr = manager_start(mgr_mod)
    ring = None
    if transport == "shm":
        ring = _mod(pkg, "shm").ShmRing.create(_ring_name(kind + pkg[-5:]),
                                               64 << 20)
        mgr.set("shm_name", ring.name)
        node._state()["shm_ring"] = ring
    errors = []

    def feeder():
        try:
            for part in _partitions(kind):
                node._feed_partition(iter(part), mgr, "input", 60)
                assert node._join_feed(mgr, "input", 60)
            if ring is not None:
                ring.write_obj(EndFeed(), timeout=5.0)
            else:
                mgr.get_queue("input").put(EndFeed())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    try:
        feed = DataFeed(mgr, train_mode=True, input_mapping=mapping)
        out = []
        for b in feed.numpy_batches(batch, pad_to_batch=pad):
            out.append({k: np.array(v) for k, v in b.items()}
                       if isinstance(b, dict) else list(b))
        t.join(timeout=60)
        assert not errors, errors
        return out, feed.stats()
    finally:
        if ring is not None:
            node._state().pop("shm_ring", None)
            ring.unlink()
            ring.close()


def manager_start(mgr_mod):
    return mgr_mod.start(b"feedparity", ["input", "output", "error"])


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert sorted(x) == sorted(y)
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])
        else:
            assert len(x) == len(y)
            for r, s in zip(x, y):
                if isinstance(r, tuple):
                    for u, v in zip(r, s):
                        np.testing.assert_array_equal(u, v)
                else:
                    assert r == s


CASES = [("ints", 4, None, False), ("ints", 4, None, True),
         ("tuples", 3, {0: "x", 1: "y"}, False),
         ("tuples", 4, {0: "x", 1: "y"}, True),
         ("dicts", 4, {"tokens": "tokens", "w": "w"}, False),
         ("dicts", 4, {"w": "weight", "tokens": "tok"}, True)]


@pytest.mark.parametrize("transport", ["queue", "shm"])
@pytest.mark.parametrize("kind,batch,mapping,pad", CASES,
                         ids=["ints", "ints-pad", "tuples-mapped",
                              "tuples-mapped-pad", "dicts-mapped",
                              "dicts-renamed-pad"])
def test_datafeed_batches_equal_across_packages(transport, kind, batch,
                                                mapping, pad):
    want, jstats = _feed(PKGS[0], transport, kind, batch, mapping, pad)
    got, tstats = _feed(PKGS[1], transport, kind, batch, mapping, pad)
    _equal(got, want)
    n = sum(len(p) for p in _partitions(kind))
    assert tstats["records"] == jstats["records"] == n
    assert tstats["batches"] == jstats["batches"] == len(got)
    # batches never straddle a partition; padding fills short ones
    sizes = [len(b) if isinstance(b, list) else len(next(iter(b.values())))
             for b in got]
    assert sum(sizes) == n if not pad else all(s == batch for s in sizes)


def test_device_batches_copy_out_of_the_reused_staging_buffer():
    """The feed reuses one staging buffer per column (valid until the
    next ``next_batch``); ``infeed.device_batches`` copies each batch on
    its staging thread before pulling the next, so every yielded batch
    keeps its own rows."""
    got, stats = [], None

    def batches():
        nonlocal stats
        out, stats = _feed(PKGS[1], "shm", "dicts", 4,
                           {"tokens": "tokens", "w": "w"}, True)
        return out

    want = batches()
    assert stats["staging_reuse"] > 0  # the buffer really was reused

    class Reusing(object):
        """Yields every batch through ONE buffer, as the feed does."""

        def __iter__(self):
            buf = np.empty_like(want[0]["tokens"])
            for b in want:
                buf[...] = b["tokens"]
                yield {"tokens": buf}

    for b in infeed.device_batches(iter(Reusing()), device="cpu"):
        got.append(b["tokens"].clone())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w["tokens"])
    assert not torch.equal(got[0], got[-1])


# -- tracing -----------------------------------------------------------------

def _registry(tr):
    reg = tr.MetricsRegistry()
    c = reg.add_counters("tfos_feed", tr.Counters())
    t = reg.add_timers("tfos_feed_stage", tr.StageTimers())
    h = reg.histogram("tfos_serving_ttft_seconds")
    c.inc("records", 80)
    c.inc("chunks", 4)
    c.inc("batches", 10)
    c.gauge("queue_depth", 3)
    for i in range(7):
        t.add("ring_wait", 0.01 * (i + 1))
        t.add("gather", 0.002)
        h.observe(0.001 * 1.7 ** i)
    return reg


def test_registries_render_identical_openmetrics():
    jtr = _mod("tensorflowonspark_tpu", "tracing")
    jreg, treg = _registry(jtr), _registry(tracing)
    assert treg.render() == jreg.render()
    assert treg.snapshot() == jreg.snapshot()
    assert treg.render(extra_labels=(("executor", "0"),)) == \
        jreg.render(extra_labels=(("executor", "0"),))
    views = {0: {"metrics": treg.snapshot(), "train_step": 10,
                 "feed_hb": 10, "state": "running", "age": 0.5},
             1: {"metrics": treg.snapshot(), "train_step": 9,
                 "feed_hb": 9, "state": "running", "age": 0.25}}
    assert tracing.render_cluster(views, {"tfos_cluster_width": 2}) == \
        jtr.render_cluster(views, {"tfos_cluster_width": 2})
    assert tracing.merge_snapshots([v["metrics"] for v in views.values()]) \
        == jtr.merge_snapshots([v["metrics"] for v in views.values()])
    assert tracing.cluster_rollup(views) == jtr.cluster_rollup(views)
    assert tracing.OPENMETRICS_CONTENT_TYPE == jtr.OPENMETRICS_CONTENT_TYPE
    assert set(tracing.METRIC_FAMILIES) == set(jtr.METRIC_FAMILIES)
    for name, (kind, labels, _) in tracing.METRIC_FAMILIES.items():
        assert jtr.METRIC_FAMILIES[name][:2] == (kind, labels), name


def test_event_log_and_flight_recorder_match():
    jtr = _mod("tensorflowonspark_tpu", "tracing")
    docs = []
    for tr in (jtr, tracing):
        log = tr.EventLog(capacity=3)
        for i in range(5):
            log.record("event-%d" % i, n=i)
        fl = tr.FlightRecorder(capacity=4)
        for i in range(6):
            fl.span("step", 1.0 + i, 1.5 + i, trace=i)
        docs.append(([e["name"] for e in log.events()], log.dropped,
                     fl.dropped, len(fl.events())))
    assert docs[0] == docs[1]
    assert docs[1][:2] == (["event-2", "event-3", "event-4"], 2)


# -- goodput -----------------------------------------------------------------

class _Clock(object):
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _account(gp):
    clk = _Clock()
    led = gp.GoodputLedger(clock=clk, flight=False)
    for dt in (30.0, 0.5, 0.25, 0.5):
        with led.step_span():
            clk.t += dt
        with led.track("feed_wait"):
            clk.t += 0.125
    led.enter("checkpoint_save")
    clk.t += 2.0
    led.exit()
    clk.t += 1.0
    led.note_step(0.75)
    return led.report(), led.categories()


def test_goodput_ledgers_give_the_same_account():
    want = _account(_mod("tensorflowonspark_tpu", "goodput"))
    got = _account(goodput)
    assert got == want
    rep, cats = got
    assert cats["compile"] == 30.0 and rep["steps"] == 4
    assert rep["unaccounted_s"] == pytest.approx(0.0, abs=1e-9)


# -- chaos -------------------------------------------------------------------

def _fires(ch, spec, n=64):
    """What the armed plan does to each of ``n`` exchanges: "lost"
    (request side), "drop_response", "dup" or None."""
    ch.arm(spec)
    out = []
    try:
        for _ in range(n):
            try:
                out.append(ch.on_net("router", "replica-0",
                                     response_capable=True))
            except ch.NetPartitioned:
                out.append("lost")
    finally:
        ch.disarm()
    return out


@pytest.mark.parametrize("spec", ["net_drop=0.3,seed=7",
                                  "net_dup=0.5,seed=11",
                                  "net_drop=0.5,only=router:replica-0,seed=3"])
def test_chaos_seeded_plans_fire_at_the_same_sites(spec):
    jch = _mod("tensorflowonspark_tpu", "chaos")
    want = _fires(jch, spec)
    got = _fires(chaos, spec)
    assert got == want
    assert any(got) and not all(got)
    assert _fires(chaos, "net_drop=0.3,only=other:peer,seed=7") == [None] * 64


def test_chaos_specs_parse_alike():
    jch = _mod("tensorflowonspark_tpu", "chaos")
    spec = ("kill_trainer_at_batch=3,only=1;drop_heartbeats_for=2.5;"
            "stall_consumer_for=0.5")
    want = [(k, i.point, i.value, i.only)
            for k, i in sorted(jch.parse_spec(spec).items())]
    got = [(k, i.point, i.value, i.only)
           for k, i in sorted(chaos.parse_spec(spec).items())]
    assert got == want and len(got) == 3
    with pytest.raises(ValueError):
        chaos.parse_spec("no_such_point=1")
