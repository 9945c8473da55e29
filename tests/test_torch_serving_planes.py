"""The port's serving planes against the JAX reference: admission control
(deadline shedding and its estimate), drain and respawn, SIGTERM drain
through ``main()``, the dedup window, fencing and the control-epoch
fence, ``/healthz`` / ``/metrics`` / ``/debug/trace``, the constructor
and handle surface, the retry helpers, and the serving chaos sites.

Both engines serve the same flax weights (the port's through
``convert.from_flax``) on the CPU; where a check is a comparison, the
same state goes through both packages. Clocks are injected or EWMAs set
by hand — no test depends on how fast this machine runs.
"""

import http.client
import inspect
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import chaos as jchaos
from tensorflowonspark_tpu import serving as jserving
from tensorflowonspark_tpu.models.decoder import DecoderLM as JaxLM
from tensorflowonspark_tpu_torch import chaos, convert, serving, tracing
from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, H, NH, L, MAXLEN = 17, 32, 4, 2, 64


@pytest.fixture(scope="module")
def lm():
    train = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L,
                  max_len=MAXLEN)
    params = train.init(jax.random.PRNGKey(7),
                        jnp.zeros((2, MAXLEN), jnp.int32))["params"]
    dec = JaxLM(vocab=V, hidden=H, num_heads=NH, num_layers=L,
                max_len=MAXLEN, decode=True)
    return dec, params


@pytest.fixture(autouse=True)
def _disarm_chaos():
    yield
    chaos.disarm()
    jchaos.disarm()


def _port(params):
    m = DecoderLM(V, hidden=H, num_heads=NH, num_layers=L, max_len=MAXLEN)
    m.load_state_dict(convert.from_flax(jax.tree.map(np.asarray, params)))
    return m


def _req(port, method, path, body=None, headers=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    raw = None if body is None else json.dumps(body).encode()
    conn.request(method, path, body=raw, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    return resp.status, dict(resp.getheaders()), data


def _post(port, body, path="/v1/models/lm:generate", headers=None):
    status, hdrs, data = _req(port, "POST", path, body, headers)
    return status, hdrs, json.loads(data)


def _wait(predicate, timeout=60):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.005)


# -- surface: the reference's keywords and handle properties ---------------


def test_constructors_accept_the_reference_keywords(lm):
    # params/rng are JAX's (the port's module holds its weights and takes
    # a torch generator); model_dir-side device is the port's addition
    ref = set(inspect.signature(jserving.DecodeEngine).parameters) \
        - {"params", "rng"}
    assert ref <= set(inspect.signature(serving.DecodeEngine).parameters)
    ref = set(inspect.signature(jserving.ModelServer).parameters)
    assert ref <= set(inspect.signature(serving.ModelServer).parameters)
    _, params = lm
    counters, timers = tracing.Counters(), tracing.StageTimers()
    metrics, flight = tracing.MetricsRegistry(), tracing.FlightRecorder()
    eng = serving.DecodeEngine(
        _port(params), slots=1, counters=counters, timers=timers,
        metrics=metrics, flight=flight, replica_id="r-7",
        qos_policy={"weights": {"a": 2.0}}, device="cpu")
    with eng:
        assert eng.counters is counters and eng.metrics is metrics
        assert eng.flight is flight and eng.timers is timers
        assert eng.qos_policy.weight("a") == 2.0
        srv = serving.ModelServer(None, engine=eng, replica_id="srv-1",
                                  dedup_capacity=4, dedup_ttl_s=9.0)
        assert srv.replica_id == "srv-1"
        assert srv.healthz()[1]["dedup"]["capacity"] == 4


def test_handle_carries_identity_and_properties(lm):
    public = {n for n in dir(jserving.GenerationHandle)
              if not n.startswith("_")}
    assert public <= set(dir(serving.GenerationHandle))
    _, params = lm
    with serving.DecodeEngine(_port(params), slots=1, device="cpu") as eng:
        h = eng.submit([1, 2, 3], 4, session="conv-1", tenant="acme",
                       priority="high")
        assert h.result(120)[:3] == [1, 2, 3]
        assert (h.session, h.tenant, h.priority) == \
            ("conv-1", "acme", "high")
        assert isinstance(h.trace, int) and h.trace > 0
        assert len(h.generated) == 4 and h.latency > 0
        d = eng.submit([1], 2)
        assert (d.tenant, d.priority, d.session) == \
            ("default", "normal", None)
        d.result(120)
        hs = eng._submit_many([([4, 5], 2)], trace=123456)
        assert hs[0].trace == 123456
        hs[0].result(120)


# -- admission control -----------------------------------------------------


def _warm_state(eng, ch):
    """Two active slots held at a step boundary plus two queued requests,
    every EWMA set by hand — the same state on either engine."""
    ch.arm("stall_decode_for=1.5")
    with eng._cv:
        active = [eng.submit([1 + i, 2, 3, 4, 5, 6, 7, 8, 9, 1, 2, 3, 4],
                             20) for i in range(2)]
    _wait(lambda: all(h._decode_t0 is not None for h in active))
    with eng._cv:
        queued = [eng.submit([7, 7, 7, 7, 7, 7, 7, 7, 7], 12),
                  eng.submit([3, 4], 9)]
        eng._step_ewma, eng._prefill_ewma = 0.0123, 0.0456
        eng._tokens_round_ewma = None
    return active + queued


def _estimates(eng):
    prompts = [None, [1] * 5, [2] * 30, [3] * 50]
    with eng._cv:
        out = [eng._estimate_locked(mn, prompt=p, extra_requests=er,
                                    extra_tokens=et, extra_blocks=eb)
               for mn in (1, 7, 40) for p in prompts
               for er, et, eb in ((0, 0, 0), (1, 9, 2))]
        out.append(eng.estimate_admission(5))
    return out


def test_estimate_admission_agrees_given_the_same_ewmas(lm):
    dec, params = lm
    kw = dict(slots=2, kv_block_size=8, kv_blocks=12)
    results = []
    for eng, ch in ((jserving.DecodeEngine(dec, params, **kw), jchaos),
                    (serving.DecodeEngine(_port(params), device="cpu", **kw),
                     chaos)):
        with eng:
            handles = _warm_state(eng, ch)
            results.append(_estimates(eng))
            for h in handles:
                h.result(120)
    for want, got in zip(*results):
        for key in ("queue_wait_s", "service_s"):
            assert abs(got[key] - want[key]) <= 1e-9, (want, got)
    # block pressure floors some of them above the slot-math wait
    assert any(e["queue_wait_s"] > 0 for e in results[1])


def _shed_run(eng, ch, shed):
    with eng:
        handles = _warm_state(eng, ch)
        with eng._cv:
            est = eng._estimate_locked(8, prompt=[5, 6, 7])
            before = (eng.counters.get("shed"), len(eng._queue),
                      eng.counters.get("prefills"))
        deadline = 0.5 * (est["queue_wait_s"] + est["service_s"])
        with pytest.raises(shed) as err:
            eng._submit_many([([5, 6, 7], 8), ([5, 6, 8], 8)],
                             deadline_s=deadline)
        with eng._cv:
            after = (eng.counters.get("shed"), len(eng._queue),
                     eng.counters.get("prefills"))
        for h in handles:
            h.result(120)
        return before, after, err.value.retry_after


def test_infeasible_body_is_shed_whole_on_both_engines(lm):
    dec, params = lm
    kw = dict(slots=2, kv_block_size=8, kv_blocks=12)
    want = _shed_run(jserving.DecodeEngine(dec, params, **kw), jchaos,
                     jserving.Shed)
    got = _shed_run(serving.DecodeEngine(_port(params), device="cpu", **kw),
                    chaos, serving.Shed)
    assert got == want
    (shed0, queue0, prefills0), (shed1, queue1, prefills1), _ = got
    assert shed1 - shed0 == 2 and queue1 == queue0
    assert prefills1 == prefills0


def test_shed_over_http_is_503_with_retry_after(lm):
    _, params = lm
    eng = serving.DecodeEngine(_port(params), slots=2, device="cpu")
    with eng, serving.ModelServer(None, name="lm", port=0,
                                  engine=eng) as srv:
        port = srv.address[1]
        assert _post(port, {"prompt": [1, 2], "max_new_tokens": 4})[0] \
            == 200
        with eng._cv:
            eng._step_ewma, eng._prefill_ewma = 0.5, 0.5
        status, hdrs, body = _post(port, {"prompt": [[1, 2], [3, 4]],
                                          "max_new_tokens": 8,
                                          "deadline_s": 1.0})
        assert status == 503 and body["kind"] == "Shed"
        assert int(hdrs["Retry-After"]) >= 1
        assert eng.counters.get("shed") == 2
        assert eng.load_stats()["queue_depth"] == 0
        # a feasible deadline completes
        assert _post(port, {"prompt": [1, 2], "max_new_tokens": 2,
                            "deadline_s": 60.0})[0] == 200


# -- lifecycle ---------------------------------------------------------------


def test_drain_finishes_admitted_work_then_refuses(lm):
    _, params = lm
    eng = serving.DecodeEngine(_port(params), slots=2, device="cpu")
    handles = [eng.submit([1 + i, 2, 3], 6) for i in range(4)]
    assert eng.drain(timeout=120) is True
    assert all(len(h.result(1)) == 9 for h in handles)
    assert eng.healthy()["draining"] and eng.healthy()["stopping"]
    with pytest.raises(serving.Draining):
        eng.submit([1], 1)
    assert eng.outstanding() == 0
    assert eng.histograms["drain"].count == 1
    assert eng.drain() is True  # idempotent on a clean drain


def test_respawn_shares_the_series_after_a_scheduler_kill(lm):
    _, params = lm
    flight = tracing.FlightRecorder()
    eng = serving.DecodeEngine(_port(params), slots=2, replica_id="r-0",
                               flight=flight, device="cpu")
    srv = serving.ModelServer(None, name="lm", port=0, engine=eng)
    port = srv.start()[1]
    try:
        assert _post(port, {"prompt": [1, 2], "max_new_tokens": 3})[0] \
            == 200
        tokens = eng.counters.get("tokens")
        chaos.arm("kill_scheduler_at_step=1")
        status, hdrs, body = _post(port, {"prompt": [4, 5],
                                          "max_new_tokens": 8})
        assert status == 503 and body["kind"] == "EngineFailed"
        assert "Retry-After" in hdrs
        code, _, health = _req(port, "GET", "/healthz")
        assert code == 503
        assert json.loads(health)["engine"]["alive"] is False
        assert "SchedulerKilled" in repr(eng._broken)
        eng.stop()
        fresh = eng.respawn()
        assert fresh.counters is eng.counters and fresh.flight is flight
        assert fresh.metrics is eng.metrics and fresh.replica_id == "r-0"
        srv.attach_engine(fresh)
        assert _post(port, {"prompt": [4, 5], "max_new_tokens": 3})[0] \
            == 200
        # a deliberate respawn is not a restart: only the supervisor's
        # RestartEngine counts one (the reference's contract)
        assert eng.counters.get("engine_restarts") == 0
        assert fresh.counters.get("tokens") > tokens
        assert _req(port, "GET", "/healthz")[0] == 200
    finally:
        srv.stop()
        eng.stop()
        if srv.engine is not eng:
            srv.engine.stop()


def test_supervised_restart_counts_one_engine_restart(lm):
    """The same scheduler kill under ``Supervisor.watch(...,
    restart=RestartEngine())``: the supervisor stops the corpse,
    respawns it on the same counter series and re-arms the server, and
    that restart is the one ``engine_restarts`` counts."""
    from tensorflowonspark_tpu_torch import supervisor

    _, params = lm
    eng = serving.DecodeEngine(_port(params), slots=2, replica_id="r-0",
                               device="cpu")
    srv = serving.ModelServer(None, name="lm", port=0, engine=eng)
    port = srv.start()[1]
    sup = supervisor.Supervisor(
        config=supervisor.SupervisorConfig(poll_interval=0.05))
    try:
        sup.watch(eng, server=srv,
                  restart=supervisor.RestartEngine(backoff=0.05))
        chaos.arm("kill_scheduler_at_step=1")
        status, _, body = _post(port, {"prompt": [4, 5],
                                       "max_new_tokens": 8})
        assert status == 503 and body["kind"] == "EngineFailed"
        chaos.disarm()
        assert chaos.poll_until(
            lambda: srv.engine is not eng and srv._unhealthy is None,
            timeout=60)
        assert srv.engine.counters is eng.counters
        assert eng.counters.get("engine_restarts") == 1
        assert _post(port, {"prompt": [4, 5], "max_new_tokens": 3})[0] \
            == 200
        assert _req(port, "GET", "/healthz")[0] == 200
        assert [e["name"] for e in sup.events.events()
                if e["name"].startswith("engine_")] == \
            ["engine_dead", "engine_restarted"]
    finally:
        sup.stop()
        srv.stop()
        eng.stop()
        if srv.engine is not eng:
            srv.engine.stop()


def test_server_drain_turns_healthz_and_refuses_new_work(lm):
    _, params = lm
    eng = serving.DecodeEngine(_port(params), slots=2, device="cpu")
    srv = serving.ModelServer(None, name="lm", port=0, engine=eng)
    port = srv.start()[1]
    chaos.arm("stall_decode_for=1.0")
    results = []

    def client(i):
        results.append(_post(port, {"prompt": [1 + i, 2],
                                    "max_new_tokens": 5}))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    _wait(lambda: eng.outstanding() == 3)
    verdict = []
    drainer = threading.Thread(target=lambda: verdict.append(srv.drain(60)))
    drainer.start()
    _wait(lambda: srv._draining)
    code, body = srv.healthz()
    assert code == 503 and body["status"] == "draining"
    status, hdrs, out = _post(port, {"prompt": [9], "max_new_tokens": 1})
    assert status == 503 and out["kind"] == "Draining"
    assert hdrs["Retry-After"] == "5"
    for t in threads:
        t.join(60)
    drainer.join(60)
    assert verdict == [True]
    assert sorted(r[0] for r in results) == [200, 200, 200]


def test_sigterm_drains_the_cli_server(tmp_path):
    from tensorflowonspark_tpu_torch import export

    def apply_fn(variables, batch):
        return {"y": torch.as_tensor(batch["x"]) * variables["w"]}

    export_dir = str(tmp_path / "export")
    export.save_model(export_dir, apply_fn, {"w": torch.tensor(2.0)},
                      signature={"inputs": ["x"], "outputs": ["y"]})
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorflowonspark_tpu_torch.serving",
         "--model-dir", export_dir, "--host", "127.0.0.1", "--port", "0",
         "--device", "cpu"], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving"), (line, proc.stderr.read())
        port = int(line.rsplit(":", 1)[1].split("/")[0])
        status, _, body = _post(port, {"instances": [1.0, 2.5]},
                                path="/v1/models/model:predict")
        assert status == 200 and body["predictions"] == [2.0, 5.0]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "drained (zero loss)" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# -- dedup window and fencing ----------------------------------------------


def _dedup_script(mod):
    clock = [0.0]
    win = mod.DedupWindow(capacity=3, ttl_s=10.0, now=lambda: clock[0])
    out = []
    e1, own = win.begin("a")
    out.append(own)
    e1b, own = win.begin("a")
    out.append((own, e1b is e1, e1.done.is_set()))
    win.complete("a", e1, {"tokens": [1]})
    out.append(win.begin("a")[0].response)
    clock[0] = 5.0
    for rid in ("b", "c", "d"):
        out.append(win.begin(rid)[1])
    out.append(win.begin("a")[1])  # evicted by capacity: fresh again
    e_fail, _ = win.begin("e")
    win.fail("e", e_fail, RuntimeError("transient"))
    out.append((win.begin("e")[1], str(e_fail.error)))
    clock[0] = 100.0
    out.append(win.begin("b")[1])  # expired
    out.append(win.stats())
    return out


def test_dedup_window_matches_the_reference_under_an_injected_clock():
    assert _dedup_script(serving) == _dedup_script(jserving)


def test_dedup_joins_in_flight_and_replays_completed(lm):
    _, params = lm
    eng = serving.DecodeEngine(_port(params), slots=2, device="cpu")
    with eng, serving.ModelServer(None, name="lm", port=0,
                                  engine=eng) as srv:
        port = srv.address[1]
        chaos.arm("stall_decode_for=0.8")
        hdr = {"X-TFOS-Request-Id": "req-1"}
        payload = {"prompt": [1, 2, 3], "max_new_tokens": 6}
        results = []
        threads = [threading.Thread(target=lambda: results.append(
            _req(port, "POST", "/v1/models/lm:generate", payload, hdr)))
            for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert [r[0] for r in results] == [200, 200]
        assert results[0][2] == results[1][2]
        assert eng.counters.get("prefills") == 1
        assert eng.counters.get("dedup_joined") == 1
        third = _req(port, "POST", "/v1/models/lm:generate", payload, hdr)
        assert third[0] == 200 and third[2] == results[0][2]
        assert eng.counters.get("dedup_hits") == 1
        assert eng.counters.get("prefills") == 1
        dedup = srv.healthz()[1]["dedup"]
        assert (dedup["hits"], dedup["joined"]) == (1, 1)


def test_fence_control_fence_and_admin_routes(lm):
    _, params = lm
    eng = serving.DecodeEngine(_port(params), slots=1, device="cpu")
    with eng, serving.ModelServer(None, name="lm", port=0,
                                  engine=eng) as srv:
        port = srv.address[1]
        srv.fence("superseded by epoch 3")
        status, _, body = _post(port, {"prompt": [1], "max_new_tokens": 1})
        assert status == 410 and body["kind"] == "Fenced"
        code, health = srv.healthz()
        assert code == 503 and health["status"] == "fenced"
        with pytest.raises(serving.Fenced):
            srv.generate({"prompt": [1]})
        srv.unfence()
        assert _post(port, {"prompt": [1], "max_new_tokens": 1})[0] == 200
        assert _post(port, {"control_epoch": 5},
                     path="/admin/control_fence")[2] == {"control_epoch": 5}
        assert srv.control_epoch_floor() == 5
        status, _, body = _post(port, {"replica_id": "p", "min_epoch": 1},
                                path="/admin/ship_fence",
                                headers={"X-TFOS-Control-Epoch": "4"})
        assert status == 409 and body["kind"] == "ControlFenced"
        assert body["control_epoch"] == 5
        assert srv.admit_control_epoch(7) == (True, 7)
        assert _post(port, {}, path="/admin/nope")[0] == 404
        srv.register_admin("ping", lambda payload: {"pong": payload})
        assert _post(port, {"x": 1}, path="/admin/ping")[2] == \
            {"pong": {"x": 1}}
        assert _post(port, {}, path="/admin/ping",
                     headers={"X-TFOS-Control-Epoch": "x"})[0] == 400
        assert "tfos_control_admin_rejections_total 1" in srv.metrics_text()


# -- observability -----------------------------------------------------------


def _families(text):
    fams = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            fams.add(line.split()[2])
    return fams


def _traffic(srv, eng):
    for prompt in ([1, 2, 3], [4, 5, 6, 7, 8, 9, 1, 2, 3], [1, 2, 3]):
        srv.generate({"prompt": prompt, "max_new_tokens": 5,
                      "tenant": "alpha"})
    return srv.healthz(), srv.metrics_text()


def test_healthz_and_metrics_families_match_the_reference(lm):
    dec, params = lm
    kw = dict(slots=2, kv_block_size=8, replica_id="r-1")
    jeng = jserving.DecodeEngine(dec, params, **kw)
    jsrv = jserving.ModelServer(None, name="lm", engine=jeng)
    (jcode, jbody), jtext = _traffic(jsrv, jeng)
    jeng.stop()
    eng = serving.DecodeEngine(_port(params), device="cpu", **kw)
    with eng:
        srv = serving.ModelServer(None, name="lm", engine=eng)
        (code, body), text = _traffic(srv, eng)
    assert code == jcode == 200
    assert set(body) == set(jbody) | {"device"}
    assert set(body["engine"]) == set(jbody["engine"])
    assert set(body["dedup"]) == set(jbody["dedup"])
    assert set(body["counts"]) == set(jbody["counts"])
    assert _families(text) == _families(jtext)
    assert text.endswith("# EOF\n")


def test_metrics_parse_and_attribution_sums_to_request_wall(lm):
    _, params = lm
    flight = tracing.FlightRecorder()
    eng = serving.DecodeEngine(_port(params), slots=2, flight=flight,
                               device="cpu")
    with eng, serving.ModelServer(None, name="lm", port=0,
                                  engine=eng) as srv:
        port = srv.address[1]
        sent = tokens = 0
        for i in range(4):
            status, _, body = _post(port, {"prompt": [1 + i, 2],
                                           "max_new_tokens": 3 + i,
                                           "tenant": "t%d" % (i % 2)})
            assert status == 200
            sent += 1
            tokens += 3 + i
        status, hdrs, raw = _req(port, "GET", "/metrics")
        assert status == 200
        assert hdrs["Content-Type"] == serving.OPENMETRICS_CONTENT_TYPE
        values = {}
        for line in raw.decode().splitlines():
            if line.startswith("#") or not line:
                continue
            name, value = line.split(" # ")[0].rsplit(" ", 1)
            values[name] = float(value)
        assert values["tfos_serving_requests_completed_total"] == sent
        assert values["tfos_serving_tokens_total"] == tokens
        assert values['tfos_qos_tokens_total{tenant="t0"}'] + \
            values['tfos_qos_tokens_total{tenant="t1"}'] == tokens
        status, hdrs, raw = _req(port, "GET", "/debug/trace")
        doc = json.loads(raw)
        assert status == 200 and hdrs["X-TFOS-Trace-Dropped"] == "0"
        spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        requests = [e for e in spans if e["name"] == "request"]
        assert len(requests) == sent
        assert all(e["args"]["outcome"] == "finish" for e in requests)
        # every finished request's stages sum to its wall
        req_hist = eng.metrics.get_histogram("tfos_serving_request_seconds")
        stage_sum = sum(
            eng.metrics.get_histogram(
                "tfos_slo_attrib_{}_seconds".format(s)).snapshot()["sum"]
            for s in serving._ATTRIB_STAGES)
        assert stage_sum == pytest.approx(req_hist.snapshot()["sum"],
                                          rel=0.01)


def test_probes_and_kv_bytes_match_the_reference(lm):
    dec, params = lm
    for kw in (dict(slots=2, kv_block_size=8),
               dict(slots=2, kv_block_size=8, kv_dtype="int8"),
               dict(slots=2, kv_block_size=0)):
        jeng = jserving.DecodeEngine(dec, params, **kw)
        want = jeng.kv_cache_bytes()
        jeng.stop()
        with serving.DecodeEngine(_port(params), device="cpu",
                                  **kw) as eng:
            assert eng.kv_cache_bytes() == want
            assert eng.kv_cache_bytes() == sum(
                t.numel() * t.element_size() for layer in eng._cache
                for name, t in layer.items() if name != "cache_index")
            attn = eng.measure_attn(reps=2)
            dq = eng.measure_dequant(reps=2)
            stats = eng.compile_stats()
            if kw["kv_block_size"]:
                assert attn > 0 and eng.timers.counts()["attn"] == 2
            else:
                assert attn is None
            assert (dq is not None) == (kw.get("kv_dtype") == "int8")
            assert stats["decode_programs"] is None
            assert stats["buckets"] == len(eng.buckets)


# -- retry helpers -----------------------------------------------------------


def _retry_trace(mod, retry_after):
    sleeps, calls = [], []
    draws = iter([0.5, 0.25, 0.75, 0.1, 0.9, 0.3] * 4)

    def fn():
        calls.append(1)
        if len(calls) < 4:
            err = mod.http_retriable(503, retry_after)
            raise err
        return "ok"

    out = mod.retry_call(fn, attempts=5, base_delay=0.1, max_delay=2.0,
                         sleep=sleeps.append, rng=lambda: next(draws))
    return out, sleeps, len(calls)


@pytest.mark.parametrize("retry_after", [None, "0", "1", "7", "junk"])
def test_retry_helpers_match_the_reference(retry_after):
    assert _retry_trace(serving, retry_after) == \
        _retry_trace(jserving, retry_after)
    assert serving.http_retriable(200) is None
    assert math.isclose(serving.http_retriable(429).retry_after, 0.5)


# -- chaos sites -------------------------------------------------------------


def test_chaos_serving_points_parse_like_the_reference():
    spec = ("kill_scheduler_at_step=3,only=replica-1;stall_decode_for=0.5;"
            "disconnect_client_at_token=4;"
            "kill_serving_executor_at_request=2,only=r,fuse=/tmp/f")
    want = [(k, i.point, i.value, i.only, i.fuse)
            for k, i in sorted(jchaos.parse_spec(spec).items())]
    got = [(k, i.point, i.value, i.only, i.fuse)
           for k, i in sorted(chaos.parse_spec(spec).items())]
    assert got == want and len(got) == 4
    with pytest.raises(ValueError, match="fuse"):
        chaos.parse_spec("kill_serving_executor_at_request=2")


def test_chaos_disconnect_cancels_and_frees_the_slot(lm):
    _, params = lm
    with serving.DecodeEngine(_port(params), slots=1, kv_block_size=8,
                              device="cpu") as eng:
        chaos.arm("disconnect_client_at_token=3")
        h = eng.submit([1, 2, 3], 20)
        with pytest.raises(serving.Cancelled):
            h.result(60)
        assert len(h.generated) == 3
        _wait(lambda: eng.load_stats()["slot_occupancy"] == 0
              and eng._pool.live_refs() == {})
        assert eng.counters.get("cancelled") == 1
        assert len(eng.submit([1, 2, 3], 4).result(60)) == 7


def test_chaos_executor_kill_refuses_outside_an_executor(lm, monkeypatch):
    _, params = lm
    monkeypatch.delenv("TFOS_SERVING_EXECUTOR_ID", raising=False)
    with serving.DecodeEngine(_port(params), slots=1, replica_id="r-9",
                              device="cpu") as eng:
        chaos.arm("kill_serving_executor_at_request=1,only=r-9,fuse=" +
                  os.path.join(str(os.getpid()), "never"))
        with pytest.raises(RuntimeError, match="executor-hosted"):
            eng.submit([1, 2], 2)
        chaos.disarm()
        assert len(eng.submit([1, 2], 2).result(60)) == 4
