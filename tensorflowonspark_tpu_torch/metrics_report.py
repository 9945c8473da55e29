"""Shared metric-reading and report-formatting helpers — the port's
copy of ``tensorflowonspark_tpu/metrics_report.py``.

Everything here READS the observability plane
(``tracing.MetricsRegistry`` / ``Histogram`` / ``StageTimers``) — the
same objects ``GET /metrics`` exposes — so a printed number and a
scraped series can never drift: they are two views of one histogram.

Import discipline: pure python, no torch/numpy — safe in driver
processes that must not initialize a device backend.
"""


def median(values):
    """Middle element of ``values`` (upper median for even counts) —
    the bench's standard multi-rep reducer."""
    values = sorted(values)
    return values[len(values) // 2]


def quantiles_ms(hist, pcts=(50, 95, 99)):
    """{"p50_ms": ..., "p95_ms": ..., "p99_ms": ...} read from a
    ``tracing.Histogram`` (milliseconds, rounded; Nones when the
    histogram is empty)."""
    out = {}
    for p in pcts:
        q = hist.quantile(p / 100.0) if hist is not None else None
        out["p{:g}_ms".format(p)] = None if q is None \
            else round(q * 1e3, 3)
    return out


#: the serving histograms every latency report reads, in report order:
#: {report key: registry family}
SERVING_HISTOGRAMS = (
    ("latency", "tfos_serving_request_seconds"),
    ("ttft", "tfos_serving_ttft_seconds"),
    ("per_token", "tfos_serving_token_latency_seconds"),
    ("decode_step", "tfos_serving_decode_step_seconds"),
    ("queue_wait", "tfos_serving_queue_wait_seconds"),
)


def serving_quantiles(registry, pcts=(50, 95, 99)):
    """Per-histogram latency quantiles from a serving engine's
    registry: {latency, ttft, per_token, decode_step, queue_wait} ->
    quantile dicts. The block ``bench.py serving_decode`` publishes and
    ``scripts/profile_serving.py`` prints — read from the SAME
    histograms ``GET /metrics`` renders."""
    return {key: quantiles_ms(registry.get_histogram(family), pcts)
            for key, family in SERVING_HISTOGRAMS}


def stage_ms(timers):
    """{stage: mean ms per sample} from a ``tracing.StageTimers`` —
    the human-readable per-stage attribution every profile prints."""
    return timers.per_ms()


def stage_totals_s(timers):
    """{stage: total seconds, rounded} from a ``StageTimers``."""
    return {k: round(v, 3) for k, v in timers.snapshot().items()}


def format_stage_ms(timers):
    """One-line ``stage=ms`` rendering of :func:`stage_ms`, sorted by
    cost — the compact form the fed profiles log per run."""
    per = stage_ms(timers)
    return "  ".join("{}={}".format(k, per[k])
                     for k in sorted(per, key=per.get, reverse=True))


def format_goodput(report):
    """Multi-line rendering of a goodput report (``goodput.
    GoodputLedger.report`` or ``goodput.job_report`` shape): headline
    ratio, then the badput table sorted by cost with each category's
    share of wall time — what ``scripts/goodput_report.py`` prints and
    the bench's goodput leg logs."""
    wall = report.get("wall_s") or 0.0
    lines = ["goodput {:6.2%}  (productive {:.3f}s of {:.3f}s wall)"
             .format(report.get("goodput_ratio", 0.0),
                     report.get("productive_s", 0.0), wall)]
    badput = report.get("badput") or {}
    for category in sorted(badput, key=badput.get, reverse=True):
        seconds = badput[category]
        if not seconds:
            continue
        lines.append("  badput {:16s} {:9.3f}s  ({:5.1%})".format(
            category, seconds, seconds / wall if wall else 0.0))
    unacc = report.get("unaccounted_s")
    if unacc is not None:
        lines.append("  unaccounted {:+.3f}s ({:+.2%} of wall)".format(
            unacc, unacc / wall if wall else 0.0))
    return "\n".join(lines)


def format_slo_verdict(verdict):
    """Multi-line rendering of a ``GET /slo`` verdict document: one
    headline per spec (budget remaining + firing state), then the
    window/burn table — what ``scripts/slo_report.py`` prints and the
    bench's slo leg logs."""
    lines = []
    for spec in verdict.get("specs") or []:
        budget = spec.get("error_budget_remaining")
        lines.append(
            "slo {:16s} tenant={:12s} {}  budget {}".format(
                spec.get("slo", "?"), spec.get("tenant", "?"),
                "FIRING" if spec.get("firing") else "ok    ",
                "n/a" if budget is None
                else "{:7.2%}".format(budget)))
        for window in spec.get("windows") or []:
            lines.append(
                "    window {:>6g}s/{:>6g}s  burn {:>8s}/{:>8s}  "
                "(threshold {:g}x{})".format(
                    window.get("short_s", 0), window.get("long_s", 0),
                    _burn(window.get("short_burn")),
                    _burn(window.get("long_burn")),
                    window.get("threshold", 0),
                    ", firing" if window.get("firing") else ""))
    alerts = verdict.get("alerts_total") or {}
    if any(alerts.values()):
        lines.append("alerts raised: " + "  ".join(
            "{}={}".format(name, alerts[name])
            for name in sorted(alerts) if alerts[name]))
    return "\n".join(lines) if lines else "no SLO specs configured"


def _burn(value):
    return "-" if value is None else "{:.2f}x".format(value)


def format_canary(canary):
    """Canary summary block from a verdict's ``canary`` section (or
    ``None`` when no prober is attached)."""
    if not canary:
        return "canary: not attached"
    counters = canary.get("counters") or {}
    lines = ["canary: {} probes, {} failures, {} drift{}".format(
        counters.get("probes", 0), counters.get("failures", 0),
        counters.get("drift", 0),
        "" if canary.get("expected_pinned")
        else "  (expected tokens not pinned yet)")]
    history = canary.get("history") or []
    for record in history[-8:]:
        lines.append(
            "  probe ok={} status={} latency={:.1f}ms{}{}".format(
                record.get("ok"), record.get("status"),
                (record.get("latency_s") or 0.0) * 1e3,
                " DRIFT" if record.get("drift") else "",
                "" if not record.get("error")
                else " ({})".format(record["error"])))
    return "\n".join(lines)


def format_attribution(report):
    """Per-request critical-path table from an ``slo.attribute_trace``
    report: stage seconds sorted by cost with shares of wall — what
    ``scripts/explain_request.py`` prints for one trace id."""
    wall = report.get("wall_s") or 0.0
    lines = ["request wall {:.3f}s".format(wall)]
    stages = report.get("stages") or {}
    for stage in sorted(stages, key=stages.get, reverse=True):
        seconds = stages[stage]
        if not seconds:
            continue
        lines.append("  {:16s} {:9.3f}s  ({:5.1%})".format(
            stage, seconds, seconds / wall if wall else 0.0))
    unattributed = report.get("unattributed_s")
    if unattributed:
        lines.append("  {:16s} {:9.3f}s  ({:5.1%})".format(
            "unattributed", unattributed,
            unattributed / wall if wall else 0.0))
    return "\n".join(lines)


def format_straggler_table(rows):
    """Straggler table from per-executor skew rows
    ``[{executor, skew, step_ewma_s?}]`` (or a plain {executor: skew}
    dict), worst first."""
    if isinstance(rows, dict):
        rows = [{"executor": eid, "skew": skew}
                for eid, skew in rows.items()]
    if not rows:
        return "no step-time skew data (no executor has stepped yet)"
    lines = ["{:>10s} {:>8s} {:>14s}".format(
        "executor", "skew", "step_ewma_ms")]
    for row in sorted(rows, key=lambda r: -(r.get("skew") or 0)):
        ewma = row.get("step_ewma_s")
        lines.append("{:>10s} {:>8.2f} {:>14s}".format(
            str(row.get("executor")), float(row.get("skew") or 0.0),
            "-" if ewma is None else "{:.3f}".format(ewma * 1e3)))
    return "\n".join(lines)
