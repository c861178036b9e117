"""``mx.obs`` — the live operational plane over the telemetry registry
(counterpart of ``mxnet_tpu.obs``, whose code this keeps: it is plain
Python).

Four pieces, each off by default and independently togglable:

  * EXPORTER (``obs.listen`` / ``MXNET_TPU_OBS_LISTEN=host:port``) — a
    stdlib ``http.server`` daemon thread serving

      - ``/metrics``: the whole telemetry registry in Prometheus text
        exposition format, under the reference's ``mxnet_tpu_`` prefix and
        labelled families, so one dashboard reads either package (timers
        as summaries whose quantiles come from the rotating 60 s window),
        plus SLO burn-rate gauges when ``obs.slo`` is armed;
      - ``/healthz``: per-model breaker state, batcher/engine thread
        liveness, stalls, KV-pool saturation and last-step age, aggregated
        from the health sources the serving layer registers — HTTP 503
        when any source reports unhealthy;
      - ``/varz``: every config knob with its effective value and
        ``config.source()`` provenance (override/env/default).

  * ACCESS LOG (``obs.access_log`` / ``MXNET_TPU_OBS_ACCESS_LOG=
    jsonl:<path>``) — exactly one JSONL record per serving/generation
    request, outcome ok|shed|deadline|breaker|error, request_id = the
    ``tracing.span`` trace_id so a slow request's line joins against the
    Chrome trace (schema below, validated by ``validate_access_record``).
    A writer thread drains a bounded queue; the serving threads only
    append a tuple.

  * SLO TRACKER (``obs.slo`` / ``MXNET_TPU_OBS_SLO``) — declared
    objectives (availability percent, windowed-p99 latency bound) with
    multi-window burn rates (5m/1h fast, 30m/6h slow — the SRE-workbook
    pairing) computed from the serving counters; surfaced on ``/metrics``
    and ``slo_status()``.

  * the windowed ``p50_1m``/``p99_1m`` quantiles themselves live in
    ``telemetry.Timer``.

Access-record schema (the reference's, plus ``flops``: the request's
share of the counted program's FLOPs, from ``mx.perf``)::

    {"event": "access", "ts": <unix s>, "request_id": <trace_id|null>,
     "model": <str>, "outcome": "ok|shed|deadline|breaker|error",
     "queue_ms": <float|null>, "dispatch_ms": <float|null>,
     "ttft_ms": <float|null>, "tokens": <int|null>, "bytes": <int|null>,
     "flops": <int|null>,
     "error": "<ExcType: message>" (only on outcome=error)}

Stdlib only, and it imports neither torch nor a kernel: an operator can
point the exporter at a process that looks dead.
"""
from __future__ import annotations

import json
import re
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import config as _config
from . import telemetry as _telemetry
from . import tracing as _tracing

__all__ = ["configure_listen", "configure_access_log", "configure_slo",
           "exporter_address", "render_prometheus", "healthz", "varz",
           "register_health_source", "unregister_health_source",
           "access_log_enabled", "access_log_path", "log_access",
           "flush_access_log", "validate_access_record", "OUTCOMES",
           "SLOTracker", "slo_tracker", "slo_status",
           "SLO_TOTAL_COUNTER", "SLO_ERROR_COUNTERS"]

#: the access-record outcome vocabulary (one terminal outcome per request)
OUTCOMES = ("ok", "shed", "deadline", "breaker", "error")


# ---------------------------------------------------- prometheus rendering
_PROM_PREFIX = "mxnet_tpu_"
_PROM_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")

#: registry families whose trailing dotted segment is a per-model series
#: (serving emits both the base counter and a ``<base>.<model>`` twin):
#: rendered as ONE family with a {model="..."} label so the exposition
#: never carries duplicate-family spellings of the same metric
_LABELED_FAMILIES = ("serving.shed_requests", "serving.deadline_exceeded",
                     "serving.breaker_open", "serving.breaker_state")

#: families whose trailing TWO dotted segments are ``<model>.<site>``
#: (mx.numerics' quantization-drift gauges); site names carry no dots,
#: so the split is on the LAST dot
_LABELED_FAMILIES_2 = ("quant.drift_ratio",)


def _prom_name(name):
    return _PROM_PREFIX + _PROM_BAD_CHARS.sub("_", name)


def _prom_labels(labels):
    if not labels:
        return ""
    parts = []
    for key in sorted(labels):
        val = str(labels[key])
        val = val.replace("\\", "\\\\").replace('"', '\\"')
        val = val.replace("\n", "\\n")
        parts.append('%s="%s"' % (key, val))
    return "{%s}" % ",".join(parts)


def _prom_value(value):
    try:
        value = float(value)
    except (TypeError, ValueError):
        return None
    if value != value:
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 2 ** 53:
        return str(int(value))
    return repr(value)


def _split_family(name):
    for base in _LABELED_FAMILIES_2:
        if name.startswith(base + ".") and len(name) > len(base) + 1:
            model, _, site = name[len(base) + 1:].rpartition(".")
            if model and site:
                return base, {"model": model, "site": site}
    for base in _LABELED_FAMILIES:
        if name.startswith(base + ".") and len(name) > len(base) + 1:
            return base, {"model": name[len(base) + 1:]}
    return name, None


def render_prometheus(snap=None):
    """Render a telemetry snapshot (default: a fresh one) as Prometheus
    text exposition format: counters/gauges one family each (per-model
    twins folded into a labeled family), timers as summaries whose
    quantile samples come from the two-epoch window (live latency) with
    the lifetime reservoir as fallback before the first windowed sample,
    plus the SLO burn-rate gauges when ``obs.slo`` is armed."""
    if snap is None:
        snap = _telemetry.snapshot()
    # family -> {"type": ..., "samples": [(suffix, labels, value)]};
    # keyed on the SANITIZED name so two registry spellings that collide
    # after sanitization merge into one family instead of duplicating it
    families = {}
    order = []

    def add(name, typ, value, labels=None, suffix=""):
        fam = _prom_name(name)
        entry = families.get(fam)
        if entry is None:
            entry = families[fam] = {"type": typ, "samples": []}
            order.append(fam)
        entry["samples"].append((suffix, labels, value))

    for name in sorted(snap.get("counters", ())):
        base, labels = _split_family(name)
        add(base, "counter", snap["counters"][name], labels)
    for name in sorted(snap.get("gauges", ())):
        base, labels = _split_family(name)
        add(base, "gauge", snap["gauges"][name], labels)
    for name in sorted(snap.get("timers", ())):
        st = snap["timers"][name]
        live = st.get("count_1m", 0) > 0
        add(name, "summary", st.get("p50_1m") if live else st.get("p50"),
            {"quantile": "0.5"})
        add(name, "summary", st.get("p99_1m") if live else st.get("p99"),
            {"quantile": "0.99"})
        add(name, "summary", st.get("total", 0.0), None, "_sum")
        add(name, "summary", st.get("count", 0), None, "_count")

    tracker = _slo_tick()
    if tracker is not None:
        status = tracker.status()
        if status.get("error_budget") is not None:
            add("slo.availability_target", "gauge",
                status["availability_target"])
            add("slo.error_budget", "gauge", status["error_budget"])
            add("slo.requests", "gauge", status["requests"])
            add("slo.errors", "gauge", status["errors"])
            for window in sorted(status["burn_rates"]):
                add("slo.burn_rate", "gauge",
                    status["burn_rates"][window], {"window": window})
            for speed, _fast, _slow, _thr in SLOTracker.ALERTS:
                add("slo.burn_alert", "gauge",
                    1 if speed in status["alerts"] else 0,
                    {"speed": speed})
        lat = status.get("latency")
        if lat is not None:
            add("slo.latency_target_ms", "gauge", lat["target_ms"],
                {"timer": lat["timer"]})
            add("slo.latency_p99_1m_ms", "gauge", lat["p99_1m"],
                {"timer": lat["timer"]})
            add("slo.latency_breach", "gauge", 1 if lat["breach"] else 0,
                {"timer": lat["timer"]})

    lines = []
    for fam in order:
        entry = families[fam]
        lines.append("# TYPE %s %s" % (fam, entry["type"]))
        for suffix, labels, value in entry["samples"]:
            val = _prom_value(value)
            if val is None:  # non-numeric gauge: not representable
                continue
            lines.append("%s%s%s %s"
                         % (fam, suffix, _prom_labels(labels), val))
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------ health plane
_HEALTH_LOCK = threading.Lock()
_HEALTH_SOURCES = {}  # guarded-by[writes]: _HEALTH_LOCK — name -> callable


def register_health_source(name, fn):
    """Register a health callable for ``/healthz``.  ``fn()`` returns a
    JSON-serializable dict; a ``"healthy": False`` entry (or a raised
    exception) marks the whole process unhealthy.  ``serving.Server``
    registers one per server around start()/stop()."""
    with _HEALTH_LOCK:
        _HEALTH_SOURCES[name] = fn


def unregister_health_source(name):
    with _HEALTH_LOCK:
        _HEALTH_SOURCES.pop(name, None)


def healthz():
    """Aggregate health: ``(ok, report)``.  The report carries every
    registered source's dict verbatim plus the tracing last-step age; a
    source that raises is itself reported unhealthy rather than taking
    the endpoint down."""
    report = {"healthy": True, "sources": {},
              "last_step_age_s": round(_tracing.last_step_age_s(), 3)}
    with _HEALTH_LOCK:
        items = list(_HEALTH_SOURCES.items())
    for name, fn in items:
        try:
            info = dict(fn() or {})
        except Exception as exc:  # noqa: BLE001 — a dead source IS a finding
            info = {"healthy": False,
                    "error": "%s: %s" % (type(exc).__name__, exc)}
        info.setdefault("healthy", True)
        report["sources"][name] = info
        if not info["healthy"]:
            report["healthy"] = False
    return report["healthy"], report


def varz():
    """Every registered knob: effective value + provenance."""
    out = {}
    for name, knob in sorted(_config.knobs().items()):
        out[name] = {"value": _config.get(name),
                     "source": _config.source(name),
                     "env": knob.env}
    return out


# --------------------------------------------------------------- exporter
_EXPORTER_LOCK = threading.Lock()
_SERVER = None         # guarded-by[writes]: _EXPORTER_LOCK
_SERVER_THREAD = None  # guarded-by[writes]: _EXPORTER_LOCK
_LISTEN_ADDR = None    # guarded-by[writes]: _EXPORTER_LOCK


class _Handler(BaseHTTPRequestHandler):
    server_version = "mx-obs/1"

    def log_message(self, *args):  # stdlib default spams stderr per scrape
        pass

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                _telemetry.counter("obs.scrapes").inc()
                code, ctype = 200, \
                    "text/plain; version=0.0.4; charset=utf-8"
                body = render_prometheus()
            elif path == "/healthz":
                ok, report = healthz()
                code, ctype = (200 if ok else 503), "application/json"
                body = json.dumps(report, default=str) + "\n"
            elif path == "/varz":
                code, ctype = 200, "application/json"
                body = json.dumps(varz(), default=str) + "\n"
            else:
                code, ctype = 404, "text/plain"
                body = "not found: %s\n" % path
        except Exception as exc:  # noqa: BLE001 — scrape must not kill thread
            code, ctype = 500, "text/plain"
            body = "%s: %s\n" % (type(exc).__name__, exc)
        payload = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        try:
            self.wfile.write(payload)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper went away mid-response


def _parse_listen(spec):
    spec = (spec or "").strip()
    if not spec:
        return None
    host, sep, port = spec.rpartition(":")
    if not sep:
        raise ValueError("obs.listen %r is not host:port" % (spec,))
    try:
        port = int(port)
    except ValueError:
        raise ValueError("obs.listen %r has a non-integer port" % (spec,))
    if not 0 <= port <= 65535:
        raise ValueError("obs.listen port %d out of range" % port)
    return (host or "127.0.0.1", port)


def configure_listen(spec):
    """(Re)configure the exporter from an ``obs.listen`` spec: ``host:port``
    starts (or rebinds) the daemon HTTP thread, empty/None stops it.
    Raises ValueError on a malformed spec and OSError when the address
    can't be bound — the knob hook reverts the override on either."""
    global _SERVER, _SERVER_THREAD, _LISTEN_ADDR
    addr = _parse_listen(spec)
    with _EXPORTER_LOCK:
        if addr == _LISTEN_ADDR and (_SERVER is not None) == \
                (addr is not None):
            return
        if _SERVER is not None:
            old = _SERVER
            _SERVER = None
            _SERVER_THREAD = None
            _LISTEN_ADDR = None
            old.shutdown()
            old.server_close()
        if addr is not None:
            srv = ThreadingHTTPServer(addr, _Handler)
            srv.daemon_threads = True
            thread = threading.Thread(target=srv.serve_forever,
                                      kwargs={"poll_interval": 0.1},
                                      name="mx-obs-exporter", daemon=True)
            _SERVER = srv
            _SERVER_THREAD = thread
            _LISTEN_ADDR = addr
            thread.start()


def exporter_address():
    """The exporter's bound ``(host, port)`` (the real port when
    ``obs.listen`` asked for port 0), or None when off."""
    with _EXPORTER_LOCK:
        if _SERVER is None:
            return None
        host, port = _SERVER.server_address[:2]
        return (host, port)


# ------------------------------------------------------------- access log
# The write path is ASYNCHRONOUS: ``log_access`` only builds the record
# dict and appends it to a thread-safe deque (sub-microsecond — this is
# what runs on the batcher/engine dispatch threads), and a daemon writer
# thread drains the queue to disk every _ACCESS_FLUSH_S.  JSON encoding
# and file IO never touch the serving hot path.  The queue is bounded:
# past _ACCESS_QUEUE_MAX pending records new ones are DROPPED and counted
# in ``obs.access_dropped`` (an access log must never become the
# backpressure).  Handles are rebound only under the lock, while
# log_access() reads the sink handle lock-free as the enabled flag (a
# stale read drops at most one record during reconfigure), hence [writes].
_ACCESS_LOCK = threading.Lock()
_ACCESS_SINK = None    # guarded-by[writes]: _ACCESS_LOCK
_ACCESS_PATH = None    # guarded-by[writes]: _ACCESS_LOCK
_ACCESS_THREAD = None  # guarded-by[writes]: _ACCESS_LOCK
_ACCESS_STOP = None    # guarded-by[writes]: _ACCESS_LOCK
_ACCESS_QUEUE = deque()     # thread-safe append/popleft, no lock needed
_ACCESS_QUEUE_MAX = 65536   # pending-record bound before drops start
_ACCESS_FLUSH_S = 0.05      # writer-thread drain cadence


#: printable ASCII minus ``"`` and ``\`` — strings matching this need no
#: JSON escaping, so the writer skips the (slow) json.dumps scan for the
#: identifier-shaped strings every record carries
_JSON_PLAIN = re.compile(r'^[ -!#-\[\]-~]*$')
#: quoted-literal cache for the low-cardinality strings (model names,
#: outcomes) that repeat on every record; bounded so a pathological
#: caller can't grow it without limit
_QUOTED = {}  # guarded-by: _ACCESS_LOCK — only the drain loop touches it


def _json_str(s):  # mxlint: holds(_ACCESS_LOCK)
    """JSON string literal, fast-pathing escape-free ASCII.  The writer
    thread competes for the GIL with the serving hot path, so every
    record serialized here is priced per-microsecond: alphanumeric
    strings (request ids) quote directly, repeated identifiers hit the
    cache, everything else falls back to the full escape scan."""
    if type(s) is not str:
        s = str(s)
    if s.isalnum():
        return '"%s"' % s
    q = _QUOTED.get(s)
    if q is None:
        q = '"%s"' % s if _JSON_PLAIN.match(s) else json.dumps(s)
        if len(_QUOTED) < 1024:
            _QUOTED[s] = q
    return q


def _drain_access_locked():  # mxlint: holds(_ACCESS_LOCK)
    """Serialize and write every queued record to the current sink (drop
    them if the sink is gone).  One flush per batch keeps the on-disk
    tail at most one drain cadence behind the live stream.  Records are
    %-formatted rather than json.dumps'd — ~4x cheaper, and this runs
    concurrently with live dispatch (see _json_str)."""
    sink = _ACCESS_SINK
    if sink is None:
        _ACCESS_QUEUE.clear()
        return
    lines = []
    while True:
        try:
            (ts, model, outcome, request_id, queue_ms, dispatch_ms,
             ttft_ms, tokens, nbytes, flops, error) = _ACCESS_QUEUE.popleft()
        except IndexError:
            break
        line = ('{"event":"access","ts":%.6f,"request_id":%s,'
                '"model":%s,"outcome":%s'
                % (ts,
                   _json_str(request_id) if request_id is not None
                   else "null",
                   _json_str(model), _json_str(outcome)))
        if queue_ms is not None:
            line += ',"queue_ms":%.3f' % float(queue_ms)
        if dispatch_ms is not None:
            line += ',"dispatch_ms":%.3f' % float(dispatch_ms)
        if ttft_ms is not None:
            line += ',"ttft_ms":%.3f' % float(ttft_ms)
        if tokens is not None:
            line += ',"tokens":%d' % tokens
        if nbytes is not None:
            line += ',"bytes":%d' % nbytes
        if flops is not None:
            line += ',"flops":%d' % flops
        if error is not None:
            line += ',"error":%s' % _json_str(error)
        lines.append(line)
    if lines:
        sink.write("}\n".join(lines) + "}\n")
        sink.flush()
        _telemetry.counter("obs.access_records").inc(len(lines))


def _access_writer(stop):
    while not stop.wait(_ACCESS_FLUSH_S):
        with _ACCESS_LOCK:
            _drain_access_locked()


def configure_access_log(spec):
    """(Re)configure the per-request JSONL access log from an
    ``obs.access_log`` spec: ``jsonl:<path>`` (bare path accepted), empty
    disables.  Rebinding stops the old writer thread, drains every
    pending record to the OLD sink, then opens the new one."""
    global _ACCESS_SINK, _ACCESS_PATH, _ACCESS_THREAD, _ACCESS_STOP
    spec = (spec or "").strip()
    path = None
    if spec:
        path = spec[len("jsonl:"):] if spec.startswith("jsonl:") else spec
        if not path:
            raise ValueError("obs.access_log %r names no path" % (spec,))
    with _ACCESS_LOCK:
        if path == _ACCESS_PATH and (_ACCESS_SINK is None) == \
                (path is None):
            return
        old_thread, old_stop = _ACCESS_THREAD, _ACCESS_STOP
        _ACCESS_THREAD = _ACCESS_STOP = None
        if old_stop is not None:
            old_stop.set()
    if old_thread is not None:
        old_thread.join(timeout=5.0)
    with _ACCESS_LOCK:
        _drain_access_locked()
        if _ACCESS_SINK is not None:
            try:
                _ACCESS_SINK.close()
            except Exception:  # noqa: BLE001 — best-effort close
                pass
            _ACCESS_SINK = None
        _ACCESS_PATH = path
        if path is not None:
            _ACCESS_SINK = open(path, "a")
            _ACCESS_STOP = threading.Event()
            _ACCESS_THREAD = threading.Thread(
                target=_access_writer, args=(_ACCESS_STOP,),
                name="mx-obs-access", daemon=True)
            _ACCESS_THREAD.start()


def access_log_enabled():
    """Whether the access log is on — serving/generation gate every
    per-record cost (trace-id lookup, record build) on this."""
    return _ACCESS_SINK is not None


def access_log_path():
    return _ACCESS_PATH


def flush_access_log():
    """Synchronously drain the pending queue and fsync the sink — call
    before reading the file (tests, shutdown hooks)."""
    import os as _os
    with _ACCESS_LOCK:
        if _ACCESS_SINK is None:
            return
        _drain_access_locked()
        _ACCESS_SINK.flush()
        try:
            _os.fsync(_ACCESS_SINK.fileno())
        except OSError:  # pragma: no cover — non-fsyncable sink
            pass


def log_access(model, outcome, request_id=None, queue_ms=None,
               dispatch_ms=None, ttft_ms=None, tokens=None,
               bytes=None, error=None, flops=None,  # noqa: A002
               _now=time.time, _qlen=_ACCESS_QUEUE.__len__,
               _qput=_ACCESS_QUEUE.append):
    """Enqueue one access record (no-op when the log is off).  One call
    per request terminal outcome — the serving/generation layers own the
    exactly-once discipline (a record is emitted where the future is
    resolved, under the same done-check).  Hot-path cost is one
    timestamp, one tuple and one deque append (the trailing underscore
    defaults pre-bind the globals — this runs on the dispatch threads);
    the record build, serialization and IO all happen on the writer
    thread.  _ACCESS_QUEUE is a module-lifetime singleton (configure
    drains it, never rebinds it), so the bound methods stay valid."""
    if _ACCESS_SINK is None:
        return
    if _qlen() >= _ACCESS_QUEUE_MAX:
        _telemetry.counter("obs.access_dropped").inc()
        return
    _qput((_now(), model, outcome, request_id, queue_ms, dispatch_ms,
           ttft_ms, tokens, bytes, flops, error))


_ACCESS_REQUIRED = {"event": str, "ts": (int, float), "model": str,
                    "outcome": str}
_ACCESS_OPTIONAL = {"request_id": str, "queue_ms": (int, float),
                    "dispatch_ms": (int, float), "ttft_ms": (int, float),
                    "tokens": int, "bytes": int, "flops": int, "error": str}


def validate_access_record(rec):
    """Validate one parsed access-log record against the documented
    schema; raises ValueError naming the offending field."""
    if not isinstance(rec, dict):
        raise ValueError("access record must be an object, got %r" % (rec,))
    for key, typ in _ACCESS_REQUIRED.items():
        if key not in rec:
            raise ValueError("access record missing required field %r" % key)
        if not isinstance(rec[key], typ) or isinstance(rec[key], bool):
            raise ValueError("field %r: expected %s, got %r"
                             % (key, typ, rec[key]))
    if rec["event"] != "access":
        raise ValueError("not an access record: event=%r" % (rec["event"],))
    if rec["outcome"] not in OUTCOMES:
        raise ValueError("outcome %r not in %r" % (rec["outcome"], OUTCOMES))
    for key, typ in _ACCESS_OPTIONAL.items():
        if rec.get(key) is not None and (not isinstance(rec[key], typ)
                                         or isinstance(rec[key], bool)):
            raise ValueError("field %r: expected %s or null, got %r"
                             % (key, typ, rec[key]))
    for key in ("queue_ms", "dispatch_ms", "ttft_ms", "tokens", "bytes",
                "flops"):
        if rec.get(key) is not None and rec[key] < 0:
            raise ValueError("field %r: negative %r" % (key, rec[key]))
    return rec


# ------------------------------------------------------------ SLO tracker
#: the availability denominator: every admitted serving/generation request
SLO_TOTAL_COUNTER = "serving.requests"
#: the availability numerator: request-terminal failures.  dispatch_errors
#: is per-BATCH (a lower bound on failed requests); the rest are
#: per-request.
SLO_ERROR_COUNTERS = ("serving.shed_requests", "serving.deadline_exceeded",
                      "serving.breaker_rejected", "serving.dispatch_errors")


class SLOTracker:
    """Multi-window multi-burn-rate SLO tracking over a ring of
    ``(ts, total, errors)`` counter samples.

    Burn rate over window W = (error rate across W) / (error budget),
    where budget = 1 - availability_target: burn 1.0 spends the budget
    exactly at the objective period's natural pace, burn 14.4 exhausts a
    30-day budget in ~50 hours.  Alerting uses the SRE-workbook pairing —
    page when BOTH fast windows (5m and 1h) burn > 14.4, ticket when both
    slow windows (30m and 6h) burn > 6 — so a single scrape blip can't
    page and a slow leak can't hide.

    Samples arrive from ``/metrics`` scrapes and ``slo_status()`` calls
    (resolution = scrape cadence); tests drive ``observe`` directly with
    explicit timestamps — the math is deterministic given the stream."""

    BURN_WINDOWS = (("5m", 300.0), ("30m", 1800.0),
                    ("1h", 3600.0), ("6h", 21600.0))
    #: (speed, short window, long window, burn threshold)
    ALERTS = (("fast", "5m", "1h", 14.4), ("slow", "30m", "6h", 6.0))
    MAX_POINTS = 8192  # ring bound: ~22h of 10s scrapes, covers 6h window

    def __init__(self, availability=None, latency_p99_ms=None,
                 latency_timer="serving.request_ms"):
        if availability is not None and not 0.0 < availability < 100.0:
            raise ValueError("availability %r must be in (0, 100) percent"
                             % (availability,))
        if latency_p99_ms is not None and latency_p99_ms <= 0:
            raise ValueError("latency_p99_ms %r must be > 0"
                             % (latency_p99_ms,))
        self.availability = availability
        self.latency_p99_ms = latency_p99_ms
        self.latency_timer = latency_timer
        self._lock = threading.Lock()
        # (monotonic ts, total, errors) samples
        self._points = deque(maxlen=self.MAX_POINTS)  # guarded-by: _lock

    @property
    def error_budget(self):
        if self.availability is None:
            return None
        return 1.0 - self.availability / 100.0

    def observe(self, total, errors, now=None):
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._points and now <= self._points[-1][0]:
                # scrapes race: keep the stream monotonic in time
                now = self._points[-1][0] + 1e-9
            self._points.append((now, int(total), int(errors)))

    def burn_rates(self, now=None):
        """``{window_label: burn_rate}`` — 0.0 for a window with no
        traffic (the no-requests state spends no budget)."""
        budget = self.error_budget
        if budget is None or budget <= 0.0:
            return {}
        with self._lock:
            pts = list(self._points)
        if not pts:
            return {label: 0.0 for label, _ in self.BURN_WINDOWS}
        t_now, total_now, err_now = pts[-1]
        if now is not None:
            t_now = max(t_now, now)
        out = {}
        for label, span in self.BURN_WINDOWS:
            cutoff = t_now - span
            base = pts[0]
            for p in pts:
                # latest sample at or before the window start: a young
                # stream falls back to its oldest sample (partial window)
                if p[0] <= cutoff:
                    base = p
                else:
                    break
            d_total = total_now - base[1]
            d_err = err_now - base[2]
            rate = (float(d_err) / d_total) if d_total > 0 else 0.0
            out[label] = rate / budget
        return out

    def alerts(self, burn=None, now=None):
        if burn is None:
            burn = self.burn_rates(now)
        fired = []
        for speed, short, long_, threshold in self.ALERTS:
            if burn.get(short, 0.0) > threshold \
                    and burn.get(long_, 0.0) > threshold:
                fired.append(speed)
        return fired

    def status(self, now=None):
        burn = self.burn_rates(now)
        with self._lock:
            last = self._points[-1] if self._points else (0.0, 0, 0)
        out = {"availability_target": self.availability,
               "error_budget": self.error_budget,
               "requests": last[1], "errors": last[2],
               "burn_rates": burn, "alerts": self.alerts(burn),
               "latency": None}
        if self.latency_p99_ms is not None:
            st = _telemetry.timer(self.latency_timer).stats()
            out["latency"] = {"timer": self.latency_timer,
                              "target_ms": self.latency_p99_ms,
                              "p99_1m": round(st["p99_1m"], 3),
                              "breach": st["p99_1m"] > self.latency_p99_ms}
        return out


_SLO_LOCK = threading.Lock()
_SLO = None       # guarded-by[writes]: _SLO_LOCK — armed SLOTracker | None
_SLO_SPEC = None  # guarded-by[writes]: _SLO_LOCK


def configure_slo(spec):
    """(Re)arm the SLO tracker from an ``obs.slo`` spec:
    ``availability=99.9,latency_p99_ms=50[,timer=serving.request_ms]``;
    empty disables.  Raises ValueError on unknown keys, unparsable
    numbers, or a spec with no objective at all."""
    global _SLO, _SLO_SPEC
    spec = (spec or "").strip()
    tracker = None
    if spec:
        kv = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError("obs.slo part %r is not key=value" % part)
            key, val = part.split("=", 1)
            kv[key.strip()] = val.strip()
        unknown = set(kv) - {"availability", "latency_p99_ms", "timer"}
        if unknown:
            raise ValueError("obs.slo: unknown objective(s) %s"
                             % ", ".join(sorted(unknown)))
        try:
            availability = (float(kv["availability"])
                            if "availability" in kv else None)
            latency = (float(kv["latency_p99_ms"])
                       if "latency_p99_ms" in kv else None)
        except ValueError:
            raise ValueError("obs.slo %r has a non-numeric objective"
                             % (spec,))
        if availability is None and latency is None:
            raise ValueError("obs.slo %r declares no objective" % (spec,))
        tracker = SLOTracker(
            availability=availability, latency_p99_ms=latency,
            latency_timer=kv.get("timer", "serving.request_ms"))
    with _SLO_LOCK:
        _SLO = tracker
        _SLO_SPEC = spec or None


def slo_tracker():
    return _SLO


def _registry_error_total():
    total = _telemetry.counter(SLO_TOTAL_COUNTER).value
    errors = sum(_telemetry.counter(name).value
                 for name in SLO_ERROR_COUNTERS)
    return total, errors


def _slo_tick(now=None):
    """Feed the armed tracker one sample from the live registry counters;
    returns the tracker (or None when ``obs.slo`` is off)."""
    tracker = _SLO
    if tracker is None:
        return None
    total, errors = _registry_error_total()
    tracker.observe(total, errors, now)
    return tracker


def slo_status():
    """The armed tracker's status dict (objectives, burn rates, fired
    alerts, windowed latency vs target), ticked against the live registry
    — or None when ``obs.slo`` is off."""
    tracker = _slo_tick()
    if tracker is None:
        return None
    return tracker.status()


# honor the MXNET_TPU_OBS_* env vars at import (the knobs' set() hooks
# handle runtime flips) — same contract as telemetry.configure_sink
try:
    configure_listen(_config.get("obs.listen"))
    configure_access_log(_config.get("obs.access_log"))
    configure_slo(_config.get("obs.slo"))
except KeyError:  # pragma: no cover — config stripped of the knobs
    pass
