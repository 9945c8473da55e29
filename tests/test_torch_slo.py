"""The port's SLO plane against the JAX reference.

``tensorflowonspark_tpu_torch/slo.py`` is a copy of the reference's
``slo.py`` over the port's own ``qos`` and ``tracing``. The reference's
own unit cases (``tests/test_slo.py``: the spec grammar, ``SliSeries``,
the burn-rate alerts, critical-path attribution for plain, preempted,
hedged and two-stage requests, ``attribute_trace``, and ``SloMonitor`` /
``CanaryProber`` over its stand-in router and stub server) run against
BOTH modules; the pure results are also compared side by side.
"""

import http.server
import json
import threading

import pytest

import test_torch_qos
from tensorflowonspark_tpu import qos as jqos
from tensorflowonspark_tpu import slo as jslo
from tensorflowonspark_tpu_torch import qos, slo, tracing

# (the cases use the reference's chaos only for its poll_until helper)
REF, PORT = test_torch_qos.reference_cases(
    "test_slo.py", slo=slo, qos=qos, tracing=tracing)

PURE_CASES = (
    "test_spec_grammar_parses_fields_and_windows",
    "test_parse_specs_sources_and_duplicate_names",
    "test_latency_good_total_reads_bucket_bounds",
    "test_sli_series_window_deltas_and_partial_window_honesty",
    "test_sli_series_counter_reset_and_time_travel",
    "test_burn_alert_requires_both_windows_hot_then_clears_on_short",
    "test_burn_alert_short_spike_alone_does_not_page",
    "test_attribution_plain_request",
    "test_attribution_preempted_request_sums_to_wall",
    "test_attribution_hedged_request_overlap_is_hedge_wait",
    "test_attribution_two_stage_disagg_kv_ship",
    "test_attribution_clamps_strays_and_handles_degenerates",
    "test_attribute_trace_reads_chrome_trace_microseconds",
    "test_monitor_availability_burn_raises_and_forwards_incident",
    "test_monitor_latency_sli_sources_by_family",
    "test_monitor_metric_lines_render_openmetrics",
)


@pytest.mark.parametrize("case", PURE_CASES)
def test_reference_unit_case_on_both_modules(case):
    getattr(REF, case)()
    PORT[case]()


REJECTIONS = [
    ("kind=latency,family=tfos_x,objective=0.9,threshold=1",
     "missing name"),
    ("name=x,kind=weird,family=tfos_x,objective=0.9", "kind"),
    ("name=x,kind=latency,family=tfos_x,objective=0.9", "threshold"),
    ("name=x,kind=latency,family=nope,objective=0.9,threshold=1", "tfos_"),
    ("name=x,kind=availability,family=tfos_x,objective=1.5", "objective"),
    ("name=x,kind=availability,family=tfos_x,objective=0.9,bogus=1",
     "unknown spec fields"),
    ("name=x,kind=availability,family=tfos_x,objective=0.9,"
     "fast=600/60/10", "short window"),
    ("name=x,kind=availability,family=tfos_x,objective=0.9,"
     "fast=60/600", "short/long/burn"),
]


@pytest.mark.parametrize("text,match", REJECTIONS)
def test_spec_grammar_rejections_on_both_modules(text, match):
    REF.test_spec_grammar_rejections(text, match)
    PORT["test_spec_grammar_rejections"](text, match)
    msgs = []
    for mod in (jslo, slo):
        with pytest.raises(ValueError) as err:
            mod.SloSpec.parse(text)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


SPAN_SETS = [
    [("dispatch", 0.0, 10.0), ("upstream", 0.5, 9.8),
     ("request", 0.6, 9.7), ("queue", 0.6, 1.6), ("prefill", 1.6, 3.0),
     ("decode", 3.0, 9.5)],
    [("request", 0.0, 12.0), ("queue", 0.0, 1.0), ("prefill", 1.0, 2.0),
     ("decode", 2.0, 5.0), ("preempted", 5.0, 9.0),
     ("prefill", 9.0, 9.5), ("decode", 9.5, 12.0)],
    [("dispatch", 0.0, 5.0), ("upstream", 0.1, 4.0),
     ("upstream", 2.0, 4.5)],
    [("dispatch", 0.0, 8.0), ("upstream", 0.2, 2.0), ("kv.ship", 1.2, 1.9),
     ("upstream", 2.1, 7.8), ("request", 2.2, 7.7),
     ("prefill", 2.3, 2.5), ("decode", 2.5, 7.6)],
    [("dispatch", 1.0, 3.0), ("decode_step", 0.0, 10.0)],
    [("mystery", 0.0, 5.0)],
]


@pytest.mark.parametrize("spans", SPAN_SETS)
def test_attribution_reports_equal(spans):
    assert slo.attribute_intervals(spans) == \
        jslo.attribute_intervals(spans)


def _burn_run(mod):
    engine = mod.BurnRateAlerts(REF._FAST_SPEC)
    out = []
    good = total = 0
    t = 0.0
    for good_s, bad_s, secs in ((2, 0, 150), (0, 2, 60), (2, 0, 90),
                                (1, 1, 40)):
        for _ in range(secs):
            good += good_s
            total += good_s + bad_s
            engine.observe("avail", t, good, total)
            t += 1.0
        out.append(engine.evaluate(t))
    return out, engine.alerts_total()


def test_burn_rate_verdicts_equal():
    assert _burn_run(slo) == _burn_run(jslo)


def _monitor_lines(slo_mod, qos_mod, router):
    monitor = slo_mod.SloMonitor(router, specs=REF._FAST_SPEC)
    router.tallies[qos_mod.DEFAULT_TENANT] = [10, 10]
    monitor.sample(now=0.0)
    router.tallies[qos_mod.DEFAULT_TENANT] = [20, 22]
    lines = monitor.metric_lines(now=60.0)
    return lines, monitor.verdict(now=90.0)


def test_monitor_lines_and_verdict_equal():
    assert _monitor_lines(slo, qos, PORT["_FakeRouter"]()) == \
        _monitor_lines(jslo, jqos, REF._FakeRouter())


@pytest.fixture()
def stub_server():
    handler = REF._StubHandler
    handler.tokens = [3, 1, 4, 1]
    handler.fail_next = []
    handler.seen = []
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever,
                              name="slo-stub-http", daemon=True)
    thread.start()
    yield "http://127.0.0.1:%d/generate" % srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_canary_pins_expected_and_detects_drift(stub_server, pkg):
    case = "test_canary_pins_expected_and_detects_drift"
    (getattr(REF, case) if pkg == "jax" else PORT[case])(stub_server)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_canary_background_loop_and_monitor_drift_incident(stub_server,
                                                           pkg):
    case = "test_canary_background_loop_and_monitor_drift_incident"
    (getattr(REF, case) if pkg == "jax" else PORT[case])(stub_server)


def test_canary_probe_body_equal(stub_server):
    bodies = []
    for mod in (jslo, slo):
        REF._StubHandler.seen = []
        mod.CanaryProber(stub_server, [1, 2, 3], max_new_tokens=4) \
            .probe_once()
        bodies.append(json.dumps(REF._StubHandler.seen, sort_keys=True))
    assert bodies[0] == bodies[1]
