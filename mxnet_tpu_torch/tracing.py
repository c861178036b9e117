"""``mx.tracing`` — causal spans, the Chrome-trace sink and the hang
watchdog (counterpart of ``mxnet_tpu.tracing``).

* SPANS — ``with tracing.span("module.step"): ...`` opens a timed span
  whose parent/child links ride a ``contextvars.ContextVar``, so causality
  survives thread hops: the prefetch workers run under the context
  captured when they started (``wrap_context``), and their spans carry
  the parent's ``trace_id``.  While an ``mx.profiler`` session runs,
  every span also enters ``torch.profiler.record_function`` (the
  reference's ``jax.profiler.TraceAnnotation``), so framework phases nest
  inside the profiler's own trace.
* CHROME SINK — ``MXNET_TPU_TRACE=chrome:<path>`` (the ``tracing.sink``
  knob) streams finished spans as Chrome trace events, one a line, so a
  killed job still leaves a file that ``load_trace`` reads.
  ``mxnet_tpu_torch.trace_merge`` lays this host plane beside the card's
  stream lanes from a ``torch.profiler`` export.
* FLIGHT RECORDER + WATCHDOG — a bounded ring of the last span and step
  events, and ``MXNET_TPU_WATCHDOG=<secs>``: a daemon thread that, when no
  train step completes within the deadline, writes every Python thread's
  stack, every OPEN span with its age, the ring, the card's memory and
  the telemetry snapshot to a timestamped JSON report, then lets the job
  run on.  Subsystems with their own liveness signal register stall
  probes the watchdog polls.

The formats (spans, reports) are the reference's, and each package's
readers and validators take the other's files.  With no sink, no
watchdog and no profiler session, ``span()`` returns a shared no-op.
"""
from __future__ import annotations

import contextvars
import json
import os
import sys
import threading
import time
import traceback
from collections import deque

from . import profiler as _profiler

__all__ = ["span", "current_span", "wrap_context", "configure_sink",
           "configure_watchdog", "configure_ring", "enabled", "sink_path",
           "open_spans", "ring_events", "record_event", "notify_step",
           "dump_watchdog_report", "load_trace", "validate_trace_events",
           "validate_watchdog_report", "register_stall_probe",
           "unregister_stall_probe", "check_stall_probes",
           "last_step_age_s", "Span"]

# ------------------------------------------------------------- span context
#: the active span for the calling context.  contextvars (not thread-local)
#: so explicit context capture (wrap_context / contextvars.copy_context)
#: carries parentage across the prefetch-thread and server-thread hops.
_CURRENT = contextvars.ContextVar("mxtpu_trace_span", default=None)

_ID_LOCK = threading.Lock()
_NEXT_ID = [1]


def _new_id():
    with _ID_LOCK:
        i = _NEXT_ID[0]
        _NEXT_ID[0] += 1
    return i


# perf_counter gives durations; this pair anchors them to the unix epoch so
# Chrome-trace timestamps are comparable across processes on one host.
_TS_BASE_UNIX = time.time()
_TS_BASE_PERF = time.perf_counter()


def _unix_from_perf(t_perf):
    return _TS_BASE_UNIX + (t_perf - _TS_BASE_PERF)


# open-span registry: span_id -> Span, for the watchdog's "where is every
# thread stuck" report.  Guarded by its own lock; entries exist only while
# tracing is active, so the hot path pays nothing when off.
_OPEN_LOCK = threading.Lock()
_OPEN = {}  # guarded-by: _OPEN_LOCK

# ------------------------------------------------------------ chrome sink
# Sink state is rebound only under _SINK_LOCK; the `_SINK is None` fast
# checks on the emit path read lock-free on purpose (a stale None just
# drops one event during reconfigure), hence [writes] mode.
_SINK_LOCK = threading.Lock()
_SINK = None          # guarded-by[writes]: _SINK_LOCK
_SINK_PATH = None     # guarded-by[writes]: _SINK_LOCK
# guarded-by[writes]: _SINK_LOCK — idents that already emitted thread_name
_SINK_THREADS = None


def configure_sink(spec):
    """(Re)configure the Chrome-trace span sink from ``chrome:<path>`` (a
    bare path is accepted as shorthand); empty/None disables.  Called by the
    ``tracing.sink`` knob's set() hook and at import from
    ``MXNET_TPU_TRACE``."""
    global _SINK, _SINK_PATH, _SINK_THREADS
    spec = (spec or "").strip()
    path = None
    if spec:
        path = spec[len("chrome:"):] if spec.startswith("chrome:") else spec
        if not path:
            raise ValueError("tracing sink %r names no path" % (spec,))
    with _SINK_LOCK:
        if path == _SINK_PATH and (_SINK is None) == (path is None):
            return
        if _SINK is not None:
            try:
                _SINK.write("%s\n]\n" % json.dumps(
                    {"ph": "M", "pid": os.getpid(), "tid": 0,
                     "name": "trace_end", "args": {}}))
                _SINK.close()
            except Exception:  # noqa: BLE001 — best-effort close
                pass
            _SINK = None
        _SINK_PATH = path
        _SINK_THREADS = set()
        if path is not None:
            _SINK = open(path, "w", buffering=1)
            _SINK.write("[\n")
            _write_event_locked({
                "ph": "M", "pid": os.getpid(), "tid": 0,
                "name": "process_name",
                "args": {"name": "mxnet_tpu_torch host (pid %d)"
                         % os.getpid()}})


def _write_event_locked(event):
    _SINK.write(json.dumps(event) + ",\n")


def _emit(event):
    """Append one Chrome trace event (no-op when the sink is off); lazily
    emits a thread_name metadata record the first time a thread appears."""
    if _SINK is None:
        return
    tid = event.get("tid")
    with _SINK_LOCK:
        if _SINK is None:
            return
        if tid is not None and tid not in _SINK_THREADS:
            _SINK_THREADS.add(tid)
            _write_event_locked({
                "ph": "M", "pid": os.getpid(), "tid": tid,
                "name": "thread_name",
                "args": {"name": threading.current_thread().name}})
        _write_event_locked(event)


def enabled():
    return _SINK is not None


def sink_path():
    return _SINK_PATH


def flush():
    """Force buffered span events to disk (fsync) — the sink's streaming
    line format is truncation-tolerant (load_trace), so a flushed partial
    trace from a preempted run is fully loadable."""
    with _SINK_LOCK:
        if _SINK is None:
            return
        _SINK.flush()
        try:
            os.fsync(_SINK.fileno())
        except OSError:  # pragma: no cover — non-fsyncable sink
            pass


# --------------------------------------------------------- flight recorder
_RING_LOCK = threading.Lock()
_RING = deque(maxlen=256)  # guarded-by: _RING_LOCK


def configure_ring(size):
    """Resize the flight-recorder ring (the ``tracing.ring_size`` knob);
    existing events are carried over up to the new bound."""
    global _RING
    size = max(1, int(size))
    with _RING_LOCK:
        if _RING.maxlen != size:
            _RING = deque(_RING, maxlen=size)


def record_event(kind, name, **fields):
    """Append one event to the flight-recorder ring (always cheap: one
    dict build and a lock-guarded deque append; callers gate on activity)."""
    rec = {"ts": round(time.time(), 6), "kind": kind, "name": name,
           "thread": threading.current_thread().name}
    rec.update(fields)
    with _RING_LOCK:
        _RING.append(rec)
    return rec


def ring_events():
    with _RING_LOCK:
        return list(_RING)


# ----------------------------------------------------------------- spans
class _NoopSpan:
    """Shared do-nothing span: the off-path cost of ``span()``."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class Span:
    """One timed causal span.  Use via ``tracing.span(name)``."""

    __slots__ = ("name", "cat", "args", "trace_id", "span_id", "parent_id",
                 "thread", "_t0", "_token", "_ann")

    def __init__(self, name, cat, args):
        self.name = name
        self.cat = cat
        self.args = args
        self.trace_id = None
        self.span_id = None
        self.parent_id = None
        self.thread = None
        self._token = None
        self._ann = None

    def __enter__(self):
        parent = _CURRENT.get()
        if parent is not None and parent.trace_id is not None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            self.trace_id = _new_id()
            self.parent_id = None
        self.span_id = _new_id()
        self.thread = threading.current_thread().name
        self._token = _CURRENT.set(self)
        with _OPEN_LOCK:
            _OPEN[self.span_id] = self
        # nest the framework phase inside the profiler's own trace
        self._ann = _profiler._range(self.name)
        self._t0 = time.perf_counter()
        return self

    def age_s(self):
        """Seconds since the span opened (watchdog report column)."""
        return time.perf_counter() - self._t0

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        if self._ann is not None:
            try:
                self._ann.__exit__(None, None, None)
            except Exception:  # noqa: BLE001
                pass
            self._ann = None
        with _OPEN_LOCK:
            _OPEN.pop(self.span_id, None)
        _CURRENT.reset(self._token)
        args = {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id}
        if self.args:
            args.update(self.args)
        if exc_type is not None:
            args["error"] = "%s: %s" % (exc_type.__name__, exc)
        _emit({"name": self.name, "cat": self.cat, "ph": "X",
               "ts": round(_unix_from_perf(self._t0) * 1e6, 3),
               "dur": round(dur * 1e6, 3), "pid": os.getpid(),
               "tid": threading.get_ident(), "args": args})
        if _WD_DEADLINE is not None:
            record_event("span", self.name, dur_ms=round(dur * 1e3, 4),
                         trace_id=self.trace_id, span_id=self.span_id,
                         parent_id=self.parent_id,
                         **({"error": args["error"]}
                            if exc_type is not None else {}))
        return False


def span(name, cat="host", **args):
    """Open a causal span.  Returns a shared no-op unless the Chrome sink,
    the watchdog, or a profiler session is active — the near-zero-overhead
    contract for instrumented hot paths."""
    if _SINK is None and _WD_DEADLINE is None \
            and not _profiler._STATE["running"]:
        return _NOOP
    return Span(name, cat, args)


def current_span():
    """The innermost active span for this context, or None."""
    return _CURRENT.get()


def open_spans():
    """Live spans as [{name, age_s, trace_id, span_id, parent_id, thread}],
    oldest first — the watchdog report's open-span table."""
    with _OPEN_LOCK:
        spans = sorted(_OPEN.values(), key=lambda s: -s.age_s())
    return [{"name": s.name, "age_s": round(s.age_s(), 4),
             "trace_id": s.trace_id, "span_id": s.span_id,
             "parent_id": s.parent_id, "thread": s.thread} for s in spans]


def wrap_context(fn):
    """Bind ``fn`` to the CALLER's context so spans it opens in another
    thread keep this trace's parentage.  The prefetchers wrap their
    workers with this, the image decode pool each job."""
    ctx = contextvars.copy_context()
    def bound(*a, **kw):
        return ctx.run(fn, *a, **kw)
    return bound


# -------------------------------------------------------------- watchdog
# Watchdog state is (re)armed only under _WD_LOCK; the hot-path
# `_WD_DEADLINE is not None` checks and the report writer read lock-free
# (worst case: one poll against a stale deadline), hence [writes] mode.
_WD_LOCK = threading.Lock()
_WD_DEADLINE = None     # guarded-by[writes]: _WD_LOCK — seconds, None=off
_WD_THREAD = None       # guarded-by[writes]: _WD_LOCK
_WD_STOP = None         # guarded-by[writes]: _WD_LOCK
_WD_REPORT_DIR = ""     # guarded-by[writes]: _WD_LOCK
# perf_counter of the last completed train step (any source); the watchdog
# measures hang age against this
_LAST_PROGRESS = [time.perf_counter()]

# stall probes: name -> fn(interval_s) -> dict|None.  Subsystems with their
# own liveness signal (a serving batcher's queue can stall while train
# steps keep completing) register here; the watchdog polls them
# alongside the step-age check and flight-records whatever dict a probe
# returns.  Probes must be fast, thread-safe, and never raise (exceptions
# are swallowed — the watchdog must not die).
_PROBE_LOCK = threading.Lock()
_STALL_PROBES = {}  # guarded-by: _PROBE_LOCK


def register_stall_probe(name, fn):
    """Register a watchdog stall probe.  ``fn(interval_s)`` is called from
    the watchdog thread each poll; it returns None while healthy, or a
    JSON-serializable dict describing the stall (the dict lands in the
    flight-recorder ring and the watchdog report's ``stalls`` section).
    Re-registering a name replaces the probe."""
    with _PROBE_LOCK:
        _STALL_PROBES[name] = fn


def unregister_stall_probe(name):
    with _PROBE_LOCK:
        _STALL_PROBES.pop(name, None)


def check_stall_probes(interval_s):
    """Run every registered stall probe against ``interval_s`` and return
    ``{name: info}`` for those reporting a stall.  Probe exceptions are
    swallowed (a broken probe must not take the watchdog down).  Public so
    tests and on-demand dumps can evaluate probes without a live
    watchdog."""
    with _PROBE_LOCK:
        probes = list(_STALL_PROBES.items())
    stalls = {}
    for name, fn in probes:
        try:
            info = fn(interval_s)
        except Exception:  # noqa: BLE001 — the watchdog must not die
            continue
        if info:
            stalls[name] = info
    return stalls


def last_step_age_s():
    """Seconds since the last completed train step (any source) — the
    watchdog's hang-age signal.  Measured from process start until the
    first step."""
    return time.perf_counter() - _LAST_PROGRESS[0]


def notify_step(source, step, wall_s, error=None):
    """Called by ``telemetry.step_scope`` on every completed train step —
    the watchdog's liveness signal.  A FAILING step still counts as
    progress (an exception loop is not a hang) but lands in the flight
    recorder with its error."""
    _LAST_PROGRESS[0] = time.perf_counter()
    if _WD_DEADLINE is not None or _SINK is not None:
        fields = {"source": source, "step": step,
                  "wall_ms": round(wall_s * 1e3, 4)}
        if error is not None:
            fields["error"] = error
        record_event("step_error" if error is not None else "step",
                     "%s.step" % source, **fields)


def configure_watchdog(seconds, report_dir=None):
    """(Re)arm the hang watchdog from the ``tracing.watchdog`` knob
    (``MXNET_TPU_WATCHDOG``): ``seconds`` > 0 starts a daemon thread that
    dumps a flight-recorder report whenever no train step completes for
    that long, then re-arms; 0/None stops it."""
    global _WD_DEADLINE, _WD_THREAD, _WD_STOP, _WD_REPORT_DIR
    seconds = float(seconds or 0)
    with _WD_LOCK:
        if report_dir is not None:
            _WD_REPORT_DIR = report_dir
        if _WD_STOP is not None:
            _WD_STOP.set()
            _WD_THREAD = None
            _WD_STOP = None
        if seconds <= 0:
            _WD_DEADLINE = None
            return
        _WD_DEADLINE = seconds
        _LAST_PROGRESS[0] = time.perf_counter()
        _WD_STOP = threading.Event()
        _WD_THREAD = threading.Thread(
            target=_watchdog_loop, args=(seconds, _WD_STOP),
            name="mxtpu-watchdog", daemon=True)
        _WD_THREAD.start()


def _watchdog_loop(deadline, stop):
    poll = max(0.02, min(deadline / 4.0, 1.0))
    last_seen = _LAST_PROGRESS[0]
    fires = 0               # consecutive reports with no progress between
    next_fire_age = deadline
    probe_next = {}         # per-probe refire backoff (perf_counter floor)
    while not stop.wait(poll):
        # subsystem stall probes run on their own liveness signal: a
        # serving-queue stall is a stall even while train steps complete
        now = time.perf_counter()
        stalls = {name: info
                  for name, info in check_stall_probes(deadline).items()
                  if probe_next.get(name, 0.0) <= now}
        for name, info in stalls.items():
            probe_next[name] = now + deadline * 4  # refire backoff
            record_event("stall", name, **info)
            from . import telemetry as _telemetry
            _telemetry.counter("tracing.stall_probe_fires").inc()
            try:
                path = dump_watchdog_report(stalls={name: info})
                print("mxnet_tpu_torch watchdog: stall probe %r fired — "
                      "flight-recorder report: %s" % (name, path),
                      file=sys.stderr)
            except Exception as exc:  # noqa: BLE001 — must not die
                print("mxnet_tpu_torch watchdog: stall report dump failed: %s"
                      % (exc,), file=sys.stderr)
        progress = _LAST_PROGRESS[0]
        if progress != last_seen:
            last_seen = progress
            fires = 0
            next_fire_age = deadline
        age = time.perf_counter() - progress
        if age < next_fire_age:
            continue
        try:
            path = dump_watchdog_report(stalled_s=age)
            print("mxnet_tpu_torch watchdog: no step completed in %.3fs "
                  "(deadline %.3fs) — flight-recorder report: %s"
                  % (age, deadline, path), file=sys.stderr)
        except Exception as exc:  # noqa: BLE001 — the watchdog must not die
            print("mxnet_tpu_torch watchdog: report dump failed: %s" % (exc,),
                  file=sys.stderr)
        from . import telemetry as _telemetry
        _telemetry.counter("tracing.watchdog_fires").inc()
        # exponential backoff while ONE stall persists (reports at 1x, 3x,
        # 7x, 15x... the deadline, capped at 8x spacing): a multi-hour hang
        # yields a handful of reports, not hundreds — and the job runs on
        fires += 1
        next_fire_age = age + deadline * min(2 ** fires, 8)


def _thread_stacks():
    """Every live Python thread with its current stack, as the watchdog
    freezes it into the report."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        t = by_ident.get(ident)
        out.append({
            "thread_id": ident,
            "name": t.name if t is not None else "<unknown>",
            "daemon": bool(t.daemon) if t is not None else None,
            "stack": [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)],
        })
    out.sort(key=lambda rec: rec["name"])
    return out


def dump_watchdog_report(stalled_s=None, path=None, stalls=None):
    """Write the flight-recorder report: thread stacks, open spans with
    ages, the event ring, the card's memory, and telemetry gauge/counter
    snapshots.  ``stalls`` ({probe_name: info}) attaches subsystem
    stall-probe findings.  Public so a debugger (or the nanguard's abort)
    can dump the same artifact on demand; returns the report path."""
    from . import telemetry as _telemetry
    snap = _telemetry.snapshot()
    if stalled_s is None:
        stalled_s = time.perf_counter() - _LAST_PROGRESS[0]
    report = {
        "event": "watchdog_report",
        "ts": round(time.time(), 6),
        "pid": os.getpid(),
        "deadline_s": _WD_DEADLINE,
        "last_step_age_s": round(stalled_s, 4),
        "threads": _thread_stacks(),
        "open_spans": open_spans(),
        "ring": ring_events(),
        "device_mem_bytes": _safe_device_memory(),
        "gauges": snap["gauges"],
        "counters": snap["counters"],
    }
    if stalls:
        report["stalls"] = stalls
    if path is None:
        stamp = time.strftime("%Y%m%d_%H%M%S") \
            + "_%03d" % int((time.time() % 1) * 1000)
        path = os.path.join(_WD_REPORT_DIR or ".",
                            "watchdog_report_%s.json" % stamp)
    with open(path, "w") as f:
        json.dump(report, f, indent=1, default=str)
    return path


def _safe_device_memory():
    """The card's memory from the watchdog thread: the runtime may be
    mid-hang, so any backend error degrades to null rather than killing
    the dump."""
    from . import telemetry as _telemetry
    try:
        return _telemetry.device_memory_bytes()
    except Exception:  # noqa: BLE001
        return None


# ------------------------------------------------------- trace (re)loading
def load_trace(path):
    """Parse a Chrome trace file into a list of event dicts.  Accepts the
    object form ({"traceEvents": [...]}), a complete JSON array, and this
    module's line-oriented array format EVEN WHEN TRUNCATED by a kill —
    half-written trailing lines are dropped."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
        if isinstance(doc, dict):
            return list(doc.get("traceEvents", []))
        if isinstance(doc, list):
            return [e for e in doc if isinstance(e, dict)]
    except ValueError:
        pass
    events = []
    for line in text.splitlines():
        line = line.strip().rstrip(",")
        if line in ("", "[", "]"):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue  # the killed job's half-written final line
        if isinstance(obj, dict):
            events.append(obj)
    return events


def validate_trace_events(events):
    """Validate span events from a chrome-sink trace: every complete ("X")
    event carries timing and span identity, and every parent_id resolves to
    a span_id present in the trace.  Returns the X events; raises
    ValueError naming the offence."""
    xs = [e for e in events if e.get("ph") == "X"]
    if not xs:
        raise ValueError("trace contains no span (ph=X) events")
    ids = set()
    for e in xs:
        for key in ("name", "ts", "dur", "pid", "tid"):
            if key not in e:
                raise ValueError("span event missing %r: %r" % (key, e))
        args = e.get("args", {})
        for key in ("trace_id", "span_id"):
            if not isinstance(args.get(key), int):
                raise ValueError("span %r missing %s" % (e.get("name"), key))
        ids.add(args["span_id"])
    for e in xs:
        parent = e.get("args", {}).get("parent_id")
        if parent is not None and parent not in ids:
            raise ValueError("span %r parent_id %s matches no span in the "
                             "trace" % (e.get("name"), parent))
    return xs


_REPORT_REQUIRED = {"event": str, "ts": (int, float),
                    "last_step_age_s": (int, float), "threads": list,
                    "open_spans": list, "ring": list, "gauges": dict,
                    "counters": dict}


def validate_watchdog_report(rec):
    """Validate one parsed watchdog report against the schema; raises
    ValueError naming the offending field."""
    if not isinstance(rec, dict):
        raise ValueError("report must be an object, got %r" % (rec,))
    for key, typ in _REPORT_REQUIRED.items():
        if key not in rec:
            raise ValueError("report missing required field %r" % (key,))
        if not isinstance(rec[key], typ):
            raise ValueError("field %r: expected %s, got %r"
                             % (key, typ, rec[key]))
    if rec["event"] != "watchdog_report":
        raise ValueError("not a watchdog report: event=%r" % (rec["event"],))
    if not rec["threads"]:
        raise ValueError("report carries no thread stacks")
    for t in rec["threads"]:
        if not isinstance(t, dict) or not t.get("stack"):
            raise ValueError("thread entry without a stack: %r" % (t,))
    for s in rec["open_spans"]:
        for key in ("name", "age_s", "trace_id", "span_id"):
            if key not in s:
                raise ValueError("open span missing %r: %r" % (key, s))
    return rec


# honor MXNET_TPU_TRACE / MXNET_TPU_WATCHDOG at import (the knobs' set()
# hooks handle runtime flips); telemetry imports this module at its own
# bottom, so any training-path import activates the env vars.
from . import telemetry as _telemetry_mod  # noqa: E402

_telemetry_mod._TRACING_STEP_HOOK = notify_step

from . import config as _config  # noqa: E402

configure_ring(_config.get("tracing.ring_size"))
configure_sink(_config.get("tracing.sink"))
configure_watchdog(_config.get("tracing.watchdog"),
                   report_dir=_config.get("tracing.watchdog_dir"))
