"""Metric exporters: Prometheus text format + JSON (counterpart:
``paddle_tpu/observability/export.py``, the port's own copy).

Three metric sources feed the exporters:
- the shared monitor registry (``monitor.py``): monotonic counters from
  the instrumented runtime (the serving engine's ``serving_*_total``, ...);
- a process-local gauge board (``publish``): last-value telemetry such as
  the StepTimer window rates and ``serving_batch_fill_ratio``;
- a summary board (``summary``/``observe``): windowed observation streams
  rendered as Prometheus summaries (p50/p95/p99 quantile series +
  ``_count``/``_sum``), the latency-SLO metric kind the serving engine
  reports per-request latencies through.

``prometheus_text()`` renders them in the text exposition format, so
``start_http_server(port)`` makes a training or serving process
scrapeable, with ``/healthz`` answering from the health registry
(``register_health``); JSON mirrors the same data.

Every lock is a ``_lockwatch`` lock under the reference's name (lock
order checked when ``PADDLE_TPU_LOCKWATCH`` is armed).
"""
import json
import re
import threading
import time

from .. import _lockwatch as lockwatch
from .. import monitor


__all__ = ["publish", "gauges", "set_gauge", "prometheus_text",
           "telemetry_dict",
           "write_json", "start_http_server", "register_collector",
           "unregister_collector", "summary", "summaries", "Summary",
           "register_health", "unregister_health", "health_dict",
           "escape_label_value", "format_labels",
           "PROM_PREFIX", "SUMMARY_QUANTILES", "DEFAULT_SUMMARY_WINDOW",
           "DEFAULT_MAX_LABEL_SETS"]

PROM_PREFIX = "paddle_tpu"

_gauges = {}
_gauges_lock = lockwatch.Lock(name="metrics.gauges")

# the quantile ladder every summary exports (Prometheus summary-type
# convention: one labeled series per quantile + _count/_sum)
SUMMARY_QUANTILES = (0.5, 0.95, 0.99)


DEFAULT_SUMMARY_WINDOW = 4096  # default behind the env knob


def _default_summary_window():
    """Percentile ring size: ``PADDLE_TPU_SUMMARY_WINDOW`` env override,
    else :data:`DEFAULT_SUMMARY_WINDOW`. Read per Summary construction
    so tests (and late env tweaks before a subsystem builds its boards)
    take effect."""
    import os
    try:
        w = int(os.environ.get("PADDLE_TPU_SUMMARY_WINDOW",
                               str(DEFAULT_SUMMARY_WINDOW)))
    except ValueError:
        w = DEFAULT_SUMMARY_WINDOW
    return max(1, w)


def escape_label_value(value):
    """Escape a Prometheus label VALUE per the text exposition format:
    backslash, double-quote, and newline must be escaped or the line is
    unparseable (a table name with a quote would silently corrupt the
    whole scrape)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


# -- label-cardinality guard ----------------------------------------------
# Per-metric bounded label-set registry: an unbounded label space (every
# distinct table id x op, or user-controlled strings leaking into a
# label) grows the counter registry and every scrape without limit. Past
# the cap, NEW label combinations collapse to a single __overflow__
# series; combinations seen before the cap keep exporting normally.
DEFAULT_MAX_LABEL_SETS = 1000


def _max_label_sets():
    import os
    try:
        return max(1, int(os.environ.get("PADDLE_TPU_MAX_LABEL_SETS",
                                         str(DEFAULT_MAX_LABEL_SETS))))
    except ValueError:
        return DEFAULT_MAX_LABEL_SETS


_label_sets = {}  # metric -> set of label suffixes already admitted
_label_sets_lock = lockwatch.Lock(name="metrics.label_sets")


def clear_label_sets():
    """Reset the per-metric label-set registry (tests)."""
    with _label_sets_lock:
        _label_sets.clear()


def format_labels(_metric=None, **labels):
    """Render a ``{key="value",...}`` label suffix with properly escaped
    values — the ONE way producers attach labels to a counter/collector
    metric name (``'ps_server_op_ns' + format_labels("ps_server_op_ns",
    table=t, op=op)``). Label names are sanitized to the Prometheus name
    alphabet.

    ``_metric`` (optional first positional) engages the per-metric
    label-cardinality guard: each metric admits at most
    ``PADDLE_TPU_MAX_LABEL_SETS`` (default 1000) distinct label
    combinations — an overflowing combination collapses to
    ``{<keys>="__overflow__"}`` and bumps
    ``metrics_label_overflow_total``, so a ``{table=,op=}``-style
    blowup degrades to one bounded series instead of growing the
    registry and every scrape without limit."""
    inner = ",".join(
        f'{_name_re.sub("_", str(k))}="{escape_label_value(v)}"'
        for k, v in labels.items())
    suffix = "{" + inner + "}"
    if _metric is not None and labels:
        with _label_sets_lock:
            seen = _label_sets.setdefault(str(_metric), set())
            if suffix not in seen:
                if len(seen) >= _max_label_sets():
                    monitor.stat_add("metrics_label_overflow_total", 1)
                    return ("{" + ",".join(
                        f'{_name_re.sub("_", str(k))}="__overflow__"'
                        for k in labels) + "}")
                seen.add(suffix)
    return suffix


def set_gauge(name, value):
    """Set one last-value gauge by its full (possibly labeled) name —
    the labeled-gauge seam :func:`publish` (prefix + plain keys) does
    not cover (``program_hbm_bytes{entry=,kind=}``,
    ``state_resident_bytes{category=}``)."""
    with _gauges_lock:
        _gauges[name] = float(value)


class Summary:
    """Windowed observation stream with quantile export — the metric kind
    for request latencies, where a counter/gauge can't answer "what is
    p99". Keeps the last ``window`` observations in a ring (O(1) observe,
    no allocation after warmup); quantiles are computed at scrape time
    over a snapshot, so the observe path stays cheap enough for
    per-request use. ``_count``/``_sum`` are lifetime monotonic.
    ``window`` defaults from the ``PADDLE_TPU_SUMMARY_WINDOW`` env var
    (else 4096) and is exported as a ``<name>_window`` gauge so a scrape
    knows how much history its percentiles describe."""

    __slots__ = ("name", "window", "_ring", "_n", "_count", "_sum", "_lock")

    def __init__(self, name, window=None):
        self.name = name
        self.window = int(window if window is not None
                          else _default_summary_window())
        self._ring = [0.0] * self.window
        self._n = 0          # lifetime observations (ring fills to window)
        self._count = 0
        self._sum = 0.0
        self._lock = lockwatch.Lock(name="metrics.summary")

    def observe(self, value):
        v = float(value)
        with self._lock:
            self._ring[self._n % self.window] = v
            self._n += 1
            self._count += 1
            self._sum += v

    def reset(self):
        """Empty the quantile window. ``_count``/``_sum`` stay lifetime-
        monotonic — Prometheus counter semantics: a mid-process scrape
        must never see them go backwards (rate()/increase() would read
        that as a process restart)."""
        with self._lock:
            self._n = 0

    def quantiles(self, qs=SUMMARY_QUANTILES):
        import numpy as _np
        with self._lock:
            n = min(self._n, self.window)
            data = list(self._ring[:n])
        if not data:
            return {q: float("nan") for q in qs}
        vals = _np.percentile(_np.asarray(data), [q * 100 for q in qs])
        return {q: float(v) for q, v in zip(qs, vals)}

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def snapshot(self):
        """JSON-ready view: quantiles keyed "p50"/"p95"/"p99" + lifetime
        count/sum. No-observation quantiles become None (json.dumps would
        otherwise emit the invalid-JSON literal ``NaN`` and break strict
        scrape consumers)."""
        out = {f"p{q * 100:g}": (None if v != v else v)
               for q, v in self.quantiles().items()}
        with self._lock:
            out["count"] = self._count
            out["sum"] = self._sum
        out["window"] = self.window
        return out


_summaries = {}
_summaries_lock = lockwatch.Lock(name="metrics.summaries")


def summary(name, window=None):
    """Get-or-create the named :class:`Summary` (shared board, like the
    monitor counter registry). ``window`` applies only at creation;
    default: ``PADDLE_TPU_SUMMARY_WINDOW`` env, else 4096."""
    with _summaries_lock:
        s = _summaries.get(name)
        if s is None:
            s = _summaries[name] = Summary(name, window=window)
        return s


def summaries():
    """name -> snapshot dict for every registered summary."""
    with _summaries_lock:
        items = list(_summaries.items())
    return {n: s.snapshot() for n, s in items}


def clear_summaries():
    """Reset every summary's quantile window IN PLACE — entries stay
    registered, so live handles (a serving engine caches its boards at
    init) keep exporting after a reset instead of observing into
    orphaned objects, and the monotonic ``_count``/``_sum`` series are
    preserved for scrape-side rate() math."""
    with _summaries_lock:
        for s in _summaries.values():
            s.reset()

# scrape-time collectors: name -> zero-arg fn returning {metric: value}.
# For subsystems whose counters live OUTSIDE the python monitor registry
# (the native PS server's per-table op latencies) — pulled fresh on every
# scrape instead of being pushed. Metric names may carry a Prometheus
# label suffix ('ps_server_op_ns{table="1000",op="pull_sparse"}'); values
# must be monotonic counters.
_collectors = {}
_collectors_lock = lockwatch.Lock(name="metrics.collectors")

_name_re = re.compile(r"[^a-zA-Z0-9_:]")


def register_collector(name, fn):
    with _collectors_lock:
        _collectors[name] = fn


def unregister_collector(name):
    with _collectors_lock:
        _collectors.pop(name, None)


_collector_errors = {}  # name -> lifetime count (keeps the series monotonic)


def collected():
    """Run all registered collectors; a broken collector is dropped from
    the scrape (never kills it) and reported as a *_collector_errors
    counter instead."""
    out = {}
    with _collectors_lock:
        items = list(_collectors.items())
    for name, fn in items:
        try:
            out.update(fn() or {})
        except Exception:
            _collector_errors[name] = _collector_errors.get(name, 0) + 1
    for name, count in _collector_errors.items():
        out[f"{name}_collector_errors"] = count
    return out


# readiness/health providers: name -> zero-arg fn returning a component
# snapshot dict with a "status" key ("ok" = serviceable; anything else
# degrades the process). Long-lived subsystems (a serving Engine)
# register for their lifetime; the shared HTTP server exposes the
# aggregate on /healthz (200 while every component is "ok", 503
# otherwise — the readiness-probe contract).
_health = {}
_health_lock = lockwatch.Lock(name="metrics.health")


def register_health(name, fn):
    with _health_lock:
        _health[name] = fn


def unregister_health(name):
    with _health_lock:
        _health.pop(name, None)


def health_dict():
    """Aggregate readiness snapshot: overall status + per-component
    snapshots. A provider that raises is reported as status "error"
    (and degrades the aggregate) instead of killing the probe."""
    with _health_lock:
        items = list(_health.items())
    comps = {}
    ok = True
    for name, fn in items:
        try:
            d = dict(fn() or {})
        except Exception as e:
            d = {"status": "error", "error": str(e)[:300]}
        comps[name] = d
        if d.get("status", "ok") != "ok":
            ok = False
    return {"status": "ok" if ok else "degraded", "time": time.time(),
            "components": comps}


def publish(prefix, values):
    """Publish last-value gauges (e.g. a StepTimer telemetry dict) under
    ``<prefix>_<key>``. Non-numeric / None values are skipped."""
    clean = {}
    for k, v in values.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        clean[f"{prefix}_{k}"] = float(v)
    with _gauges_lock:
        _gauges.update(clean)
    return clean


def gauges():
    with _gauges_lock:
        return dict(_gauges)


def clear_gauges():
    with _gauges_lock:
        _gauges.clear()


def _prom_name(name):
    # labels survive sanitization: only the name part (before '{') is
    # restricted to the Prometheus metric-name alphabet. Producers must
    # escape label VALUES via format_labels(); as a last line of defense
    # a raw newline that slipped into a label is escaped here — it is
    # the one character that corrupts neighbouring lines, not just this
    # sample's labels.
    if "{" in name:
        base, labels = name.split("{", 1)
        return _name_re.sub("_", base) + "{" + labels.replace("\n", "\\n")
    return _name_re.sub("_", name)


def prometheus_text(prefix=PROM_PREFIX):
    """Render counters + gauges + collector pulls in the Prometheus text
    exposition format."""
    lines = []
    typed = set()
    for name, value in sorted(monitor.stats().items()):
        mname = f"{prefix}_{_prom_name(name)}"
        base = mname.split("{", 1)[0]
        if base not in typed:  # one TYPE line per family, labels aside
            typed.add(base)
            lines.append(f"# TYPE {base} counter")
        lines.append(f"{mname} {value}")
    for name, value in sorted(collected().items()):
        mname = f"{prefix}_{_prom_name(name)}"
        base = mname.split("{", 1)[0]
        if base not in typed:  # one TYPE line per family, not per label set
            typed.add(base)
            lines.append(f"# TYPE {base} counter")
        lines.append(f"{mname} {value}")
    for name, value in sorted(gauges().items()):
        mname = f"{prefix}_{_prom_name(name)}"
        base = mname.split("{", 1)[0]
        if base not in typed:  # one TYPE line per family, not per label set
            typed.add(base)
            lines.append(f"# TYPE {base} gauge")
        lines.append(f"{mname} {value:.6g}")
    with _summaries_lock:
        summs = sorted(_summaries.items())
    for name, s in summs:
        mname = f"{prefix}_{_prom_name(name)}"
        lines.append(f"# TYPE {mname} summary")
        for q, v in s.quantiles().items():
            if v == v:  # skip NaN (no observations yet)
                lines.append(f'{mname}{{quantile="{q:g}"}} {v:.6g}')
        lines.append(f"{mname}_sum {s.sum:.6g}")
        lines.append(f"{mname}_count {s.count}")
        # ring size as a gauge: a scrape can tell how much history the
        # percentile series describes (and see config drift across ranks)
        lines.append(f"# TYPE {mname}_window gauge")
        lines.append(f"{mname}_window {s.window}")
    return "\n".join(lines) + "\n"


def telemetry_dict():
    """Counters + gauges + summaries + collector pulls as one JSON-ready
    dict."""
    return {"time": time.time(), "counters": monitor.stats(),
            "gauges": gauges(), "summaries": summaries(),
            "collected": collected()}


def write_json(path):
    data = telemetry_dict()
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    return data


def write_prometheus(path, prefix=PROM_PREFIX):
    text = prometheus_text(prefix)
    with open(path, "w") as f:
        f.write(text)
    return text


class _MetricsServer:
    def __init__(self, httpd, thread, port):
        self._httpd = httpd
        self._thread = thread
        self.port = port

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_http_server(port=0, addr="127.0.0.1"):
    """Serve ``/metrics`` (Prometheus text) + ``/telemetry.json`` from a
    daemon thread; returns a handle with ``.port`` and ``.stop()``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/metrics"):
                body = prometheus_text().encode()
                ctype = "text/plain; version=0.0.4"
            elif self.path.startswith("/telemetry"):
                body = json.dumps(telemetry_dict()).encode()
                ctype = "application/json"
            elif self.path.startswith("/healthz"):
                # readiness probe: 200 only while every registered
                # component reports "ok" — a load balancer drains this
                # replica the moment an engine closes or a worker dies
                h = health_dict()
                body = json.dumps(h).encode()
                code = 200 if h["status"] == "ok" else 503
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # no per-scrape stderr spam
            pass

    httpd = ThreadingHTTPServer((addr, port), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="paddle-tpu-torch-metrics")
    t.start()
    return _MetricsServer(httpd, t, httpd.server_address[1])
