"""``mx.telemetry`` — the runtime metrics registry and the structured step
log (counterpart of ``mxnet_tpu.telemetry``).

* A thread-safe METRICS REGISTRY: ``counter(name)`` (monotonic, atomic
  increments), ``gauge(name)`` (last value) and ``timer(name)``
  (count/total/min/max/p50/p99 over a bounded reservoir, plus
  ``p50_1m``/``p99_1m`` over a rotating two-epoch window of the last
  minute).  Instruments are keyed by name in one process-wide registry,
  as in the reference: the serving path and the kernel router bump the
  same names (``kernels.paged_attention``, ``serving.tokens_generated``,
  ...) that the reference package reports.  A timer's unit is whatever
  its caller observes (the step scopes observe seconds, the serving path
  milliseconds).
* A STRUCTURED STEP LOG: one JSONL record a train step
  (``MXNET_TPU_TELEMETRY=jsonl:<path>``, the ``telemetry.sink`` knob),
  in the reference's schema (``validate_step_record``), so the
  reference's ``tools/telemetry_report.py`` reads it.  With the sink off
  ``step_scope`` builds no record: no counter snapshot, no memory query,
  no json.

Step-record schema::

    {"event": "step", "ts": <unix s>, "source": "module|spmd|gluon",
     "step": <1-based per-source index>, "path": "fused|eager|...",
     "wall_ms": <float>, "samples": <int|null>, "samples_per_s":
     <float|null>, "compiles": <fused_compiles delta>, "host_syncs":
     <host_syncs delta>, "mem_bytes": <device watermark|null>,
     "shape": <batch shape|null>, "mesh": {axis: size}|null,
     "flops": <float>, "mfu": <float> (only when an mx.perf program of
     the source ran in the step),
     "error": "<ExcType: message>" (only on steps whose body raised)}

``mem_bytes`` is ``torch.cuda.max_memory_allocated`` on a card (null on
the CPU); ``wall_ms`` is host time, since the card runs behind the host.
``profiler.dumps()`` renders the registry as its timer, gauge and counter
sections.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

__all__ = ["Counter", "Gauge", "Timer", "counter", "gauge", "timer",
           "snapshot", "reset", "reset_counters", "configure_sink",
           "enabled", "flush", "sink_path", "log_event", "step_scope",
           "device_memory_bytes", "validate_step_record", "STEP_SOURCES"]

# one structure lock guards the name->instrument maps; each instrument then
# carries its own lock so hot-path observations never contend on the
# registry.  _get_or_create reads the maps lock-free (double-checked
# locking: dict lookup is atomic, inserts happen under the lock), so only
# the writes are lock-checked.
_REGISTRY_LOCK = threading.Lock()
_COUNTERS = {}  # guarded-by[writes]: _REGISTRY_LOCK
_GAUGES = {}    # guarded-by[writes]: _REGISTRY_LOCK
_TIMERS = {}    # guarded-by[writes]: _REGISTRY_LOCK

STEP_SOURCES = ("module", "spmd", "gluon")

#: set by mx.tracing at import: called as hook(source, step, wall_s,
#: error=None) after EVERY train step (success or failure) — the hang
#: watchdog's liveness signal and the flight recorder's step feed.  A slot
#: rather than an import so telemetry never depends on tracing.
_TRACING_STEP_HOOK = None

#: set by mx.perf at import: called as hook(source, step, wall_s) after
#: every train step; returns extra step-record fields (flops/mfu) or
#: None.  Same slot-not-import contract as the tracing hook above.
_PERF_STEP_HOOK = None

#: the dispatch counters live on this registry (profiler.counters() reads
#: them back from here); listed so snapshots always carry all four even
#: before the first step.
DISPATCH_COUNTERS = ("fused_steps", "fused_compiles", "eager_steps",
                     "host_syncs")


class Counter:
    """Monotonic counter; ``inc`` is read-modify-write atomic under a lock
    (concurrent engine/io threads increment the same names)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0  # guarded-by: _lock
        self._lock = threading.Lock()

    def inc(self, delta=1):
        with self._lock:
            self._value += delta
            return self._value

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0


class Gauge:
    """Last-value instrument (queue depths, watermarks)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0  # guarded-by: _lock
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = value

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0


class Timer:
    """Duration histogram: exact count/total/min/max plus p50/p99 from a
    bounded reservoir of the most recent observations (the aggregate_stats
    table columns, extended with the percentiles monitor never had).

    Alongside the lifetime reservoir, a rotating TWO-EPOCH time window
    (``WINDOW_S``, default 60s, split into two half-window epochs) feeds the
    ``p50_1m``/``p99_1m`` keys of :meth:`stats`: observations land in the
    current epoch, and at most one timestamp compare per observation rotates
    current→previous when the half-window elapses.  The windowed quantiles
    merge both epochs, so they always cover between WINDOW_S/2 and WINDOW_S
    of recent history and a warmup burst ages out of them within a minute
    instead of polluting the quantiles for the life of the process."""

    __slots__ = ("name", "count", "total", "min", "max", "_samples",
                 "_win_start", "_win_cur", "_win_prev", "_lock")

    MAX_SAMPLES = 2048  # ring buffer bound: percentiles track the recent run
    WINDOW_S = 60.0     # two-epoch window span for the p50_1m/p99_1m keys

    def __init__(self, name):
        self.name = name
        self.count = 0      # guarded-by: _lock
        self.total = 0.0    # guarded-by: _lock
        self.min = None     # guarded-by: _lock
        self.max = None     # guarded-by: _lock
        self._samples = deque(maxlen=self.MAX_SAMPLES)  # guarded-by: _lock
        self._win_start = time.monotonic()  # guarded-by: _lock
        self._win_cur = deque(maxlen=self.MAX_SAMPLES)   # guarded-by: _lock
        self._win_prev = deque(maxlen=self.MAX_SAMPLES)  # guarded-by: _lock
        self._lock = threading.Lock()

    def _rotate_locked(self, now):  # mxlint: holds(_lock)
        half = self.WINDOW_S / 2.0
        lag = now - self._win_start
        if lag < half:
            return
        if lag >= 2.0 * half:
            # an idle gap swallowed both epochs: everything in the window
            # is stale, start fresh
            self._win_prev = deque(maxlen=self.MAX_SAMPLES)
            self._win_cur = deque(maxlen=self.MAX_SAMPLES)
            self._win_start = now
        else:
            self._win_prev = self._win_cur
            self._win_cur = deque(maxlen=self.MAX_SAMPLES)
            self._win_start += half

    def observe(self, seconds, now=None):
        seconds = float(seconds)
        if now is None:
            now = time.monotonic()
        with self._lock:
            self.count += 1
            self.total += seconds
            if self.min is None or seconds < self.min:
                self.min = seconds
            if self.max is None or seconds > self.max:
                self.max = seconds
            self._samples.append(seconds)
            self._rotate_locked(now)
            self._win_cur.append(seconds)

    class _Span:
        __slots__ = ("_timer", "_t0")

        def __init__(self, t):
            self._timer = t

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._timer.observe(time.perf_counter() - self._t0)

    def time(self):
        """``with telemetry.timer('phase').time(): ...``"""
        return Timer._Span(self)

    def percentile(self, p):
        # copy under the lock, sort OUTSIDE it: an O(n log n) sort inside
        # the lock stalls every in-flight timer.time() scope behind a
        # reader (the snapshot/observe contention the 8-thread stress test
        # in tests/test_telemetry.py exercises)
        with self._lock:
            samples = list(self._samples)
        samples.sort()
        if not samples:
            return None
        idx = max(0, min(len(samples) - 1,
                         int(round(p / 100.0 * (len(samples) - 1)))))
        return samples[idx]

    def stats(self, now=None):
        if now is None:
            now = time.monotonic()
        # one lock acquisition reads every field, so a concurrent observe()
        # or reset() can never tear the dict (count from before a reset,
        # total from after); sorting happens outside the lock on copies
        with self._lock:
            count, total = self.count, self.total
            mn, mx = self.min, self.max
            samples = list(self._samples)
            self._rotate_locked(now)
            win = list(self._win_cur) + list(self._win_prev)
        samples.sort()
        win.sort()

        def pct(vals, p):
            if not vals:
                return None
            i = max(0, min(len(vals) - 1,
                           int(round(p / 100.0 * (len(vals) - 1)))))
            return vals[i]

        return {"count": count, "total": total,
                "min": mn or 0.0, "max": mx or 0.0,
                "p50": pct(samples, 50) or 0.0,
                "p99": pct(samples, 99) or 0.0,
                "count_1m": len(win),
                "p50_1m": pct(win, 50) or 0.0,
                "p99_1m": pct(win, 99) or 0.0}

    def reset(self):
        with self._lock:
            self.count = 0
            self.total = 0.0
            self.min = None
            self.max = None
            self._samples.clear()
            self._win_start = time.monotonic()
            self._win_cur.clear()
            self._win_prev.clear()


def _get_or_create(table, cls, name):
    inst = table.get(name)
    if inst is None:
        with _REGISTRY_LOCK:
            inst = table.get(name)
            if inst is None:
                inst = table[name] = cls(name)
    return inst


def counter(name):
    return _get_or_create(_COUNTERS, Counter, name)


def gauge(name):
    return _get_or_create(_GAUGES, Gauge, name)


def timer(name):
    return _get_or_create(_TIMERS, Timer, name)


def snapshot():
    """Point-in-time view of the whole registry:
    ``{"counters": {name: int}, "gauges": {name: value},
    "timers": {name: {count,total,min,max,p50,p99,p50_1m,p99_1m}}}``."""
    with _REGISTRY_LOCK:
        counters = list(_COUNTERS.values())
        gauges = list(_GAUGES.values())
        timers = list(_TIMERS.values())
    out = {"counters": {c.name: c.value for c in counters},
           "gauges": {g.name: g.value for g in gauges},
           "timers": {t.name: t.stats() for t in timers}}
    for name in DISPATCH_COUNTERS:
        out["counters"].setdefault(name, 0)
    return out


def reset_counters():
    with _REGISTRY_LOCK:
        counters = list(_COUNTERS.values())
    for c in counters:
        c.reset()


def reset():
    """Zero every instrument (counters, gauges, timer histograms)."""
    with _REGISTRY_LOCK:
        instruments = (list(_COUNTERS.values()) + list(_GAUGES.values())
                       + list(_TIMERS.values()))
    for inst in instruments:
        inst.reset()


# --------------------------------------------------------------- step log
# Rebound only under _SINK_LOCK; the `_SINK is None` fast checks on the
# log_event/enabled paths read lock-free on purpose (a stale None just
# drops one record during reconfigure), hence [writes] mode.
_SINK_LOCK = threading.Lock()
# guarded-by[writes]: _SINK_LOCK — open line-buffered file, None when off
_SINK = None
_SINK_PATH = None   # guarded-by[writes]: _SINK_LOCK


def configure_sink(spec):
    """(Re)configure the JSONL step log from a sink spec: ``jsonl:<path>``
    (a bare path is accepted as shorthand), empty/None disables.  Called by
    the ``telemetry.sink`` knob's set() hook and at import from
    ``MXNET_TPU_TELEMETRY``."""
    global _SINK, _SINK_PATH
    spec = (spec or "").strip()
    path = None
    if spec:
        if spec.startswith("jsonl:"):
            path = spec[len("jsonl:"):]
        else:
            path = spec
        if not path:
            raise ValueError("telemetry sink %r names no path" % (spec,))
    with _SINK_LOCK:
        if path == _SINK_PATH and (_SINK is None) == (path is None):
            return
        if _SINK is not None:
            try:
                _SINK.close()
            except Exception:  # noqa: BLE001 — best-effort close
                pass
            _SINK = None
        _SINK_PATH = path
        if path is not None:
            _SINK = open(path, "a", buffering=1)


def enabled():
    """Whether the step log is on.  Instrumentation gates every per-record
    cost (counter snapshots, memory query, json encode) on this."""
    return _SINK is not None


def flush():
    """Force the JSONL sink to disk (fsync) — called by
    ``resilience.flush_sinks`` on preemption/abort so the log from a dying
    run ends at the truth, not one buffer short of it."""
    import os as _os
    with _SINK_LOCK:
        if _SINK is None:
            return
        _SINK.flush()
        try:
            _os.fsync(_SINK.fileno())
        except OSError:  # pragma: no cover — non-fsyncable sink
            pass


def sink_path():
    return _SINK_PATH


def log_event(event, **fields):
    """Append one structured record to the JSONL sink (no-op when off).
    ``monitor.Monitor`` and the step scopes route through here so a run's
    log interleaves steps and tensor stats in order."""
    sink = _SINK
    if sink is None:
        return
    rec = {"event": event, "ts": round(time.time(), 6)}
    rec.update(fields)
    line = json.dumps(rec, default=str)
    with _SINK_LOCK:
        if _SINK is not None:
            _SINK.write(line + "\n")


# -------------------------------------------------------------- step scope
class step_scope:
    """Instrument ONE train step: always observes ``<source>.step`` on the
    timer registry and bumps ``<source>.steps``; when the JSONL sink is on,
    additionally emits a step record with dispatch-counter deltas (path
    fused/eager, compile count, host syncs), throughput, and the device
    memory watermark.

    ``batch`` (a DataBatch) or explicit ``samples``/``shape`` supply the
    throughput denominator; ``mesh`` is the SPMD collective mesh as an
    {axis: size} dict; ``default_path`` labels steps that move no dispatch
    counter (gluon's per-param updater loop)."""

    __slots__ = ("source", "samples", "shape", "mesh", "default_path",
                 "_t0", "_before")

    def __init__(self, source, batch=None, samples=None, shape=None,
                 mesh=None, default_path=None):
        self.source = source
        self.samples = samples
        self.shape = shape
        self.mesh = mesh
        self.default_path = default_path
        if batch is not None and samples is None:
            try:
                d = batch.data[0]
                self.shape = tuple(int(s) for s in d.shape)
                self.samples = int(d.shape[0])
            except Exception:  # noqa: BLE001 — odd batch layouts stay null
                pass

    def __enter__(self):
        if _SINK is not None:
            self._before = (counter("fused_steps").value,
                            counter("eager_steps").value,
                            counter("fused_compiles").value,
                            counter("host_syncs").value,
                            counter("io.h2d_sync").value)
        else:
            self._before = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        timer(self.source + ".step").observe(dt)
        idx = counter(self.source + ".steps").inc()
        error = None
        if exc_type is not None:
            counter(self.source + ".step_errors").inc()
            error = "%s: %s" % (exc_type.__name__, exc)
        hook = _TRACING_STEP_HOOK
        if hook is not None:
            # watchdog liveness + flight recorder: failures included, so a
            # crash-looping job is distinguishable from a hung one
            hook(self.source, idx, dt, error=error)
        perf_hook = _PERF_STEP_HOOK
        # runs with the sink off too: the live perf.mfu gauges (and the
        # perf.profile cadence) do not depend on JSONL being written
        perf_fields = (perf_hook(self.source, idx, dt)
                       if perf_hook is not None else None)
        if self._before is None:
            return False
        # a FAILING step still leaves a JSONL record (with its error) — the
        # log from a crashed run must show the step that died, not end one
        # line before the truth
        fused_d = counter("fused_steps").value - self._before[0]
        eager_d = counter("eager_steps").value - self._before[1]
        if fused_d > 0:
            path = "fused"
        elif eager_d > 0:
            path = "eager"
        else:
            path = self.default_path or "unknown"
        samples = self.samples
        fields = dict(
            source=self.source,
            step=idx,
            path=path,
            wall_ms=round(dt * 1e3, 4),
            samples=samples,
            samples_per_s=round(samples / dt, 2)
            if samples and dt > 0 else None,
            compiles=counter("fused_compiles").value - self._before[2],
            host_syncs=counter("host_syncs").value - self._before[3],
            # caller-thread H2D transfers inside this step: non-zero in
            # steady state means batches are NOT arriving device-resident
            h2d_sync=counter("io.h2d_sync").value - self._before[4],
            mem_bytes=device_memory_bytes(),
            shape=list(self.shape) if self.shape else None,
            mesh=dict(self.mesh) if self.mesh else None,
        )
        if perf_fields:
            # achieved FLOPs and model-FLOPs utilization of this step, from
            # the mx.perf program registry
            fields.update(perf_fields)
        if error is not None:
            fields["error"] = error
        log_event("step", **fields)
        return False


def device_memory_bytes():
    """The card's allocator watermark in bytes
    (``torch.cuda.max_memory_allocated``, else ``memory_allocated``) once
    CUDA is initialized in this process, else None (a CPU run).  Never
    initializes CUDA itself, so the watchdog's thread may call it."""
    try:
        import torch
        if not torch.cuda.is_initialized():
            return None
        peak = int(torch.cuda.max_memory_allocated())
        return peak if peak else int(torch.cuda.memory_allocated())
    except Exception:  # noqa: BLE001 — no backend, no number
        return None


# ---------------------------------------------------------------- schema
_STEP_REQUIRED = {"event": str, "ts": (int, float), "source": str,
                  "step": int, "path": str, "wall_ms": (int, float),
                  "compiles": int, "host_syncs": int}
_STEP_OPTIONAL = {"samples": int, "samples_per_s": (int, float),
                  "mem_bytes": int, "shape": list, "mesh": dict,
                  "h2d_sync": int, "error": str,
                  "flops": (int, float), "mfu": (int, float)}


def validate_step_record(rec):
    """Validate one parsed JSONL step record against the documented schema;
    raises ValueError naming the offending field."""
    if not isinstance(rec, dict):
        raise ValueError("step record must be an object, got %r" % (rec,))
    for key, typ in _STEP_REQUIRED.items():
        if key not in rec:
            raise ValueError("step record missing required field %r" % key)
        if not isinstance(rec[key], typ) or isinstance(rec[key], bool):
            raise ValueError("field %r: expected %s, got %r"
                             % (key, typ, rec[key]))
    if rec["event"] != "step":
        raise ValueError("not a step record: event=%r" % (rec["event"],))
    if rec["step"] < 1:
        raise ValueError("step index must be >= 1, got %r" % (rec["step"],))
    for key, typ in _STEP_OPTIONAL.items():
        if rec.get(key) is not None and not isinstance(rec[key], typ):
            raise ValueError("field %r: expected %s or null, got %r"
                             % (key, typ, rec[key]))
    return rec


# honor MXNET_TPU_TELEMETRY at import (the knob's set() hook handles runtime
# flips); config never imports telemetry back at module scope, so no cycle
from . import config as _config  # noqa: E402

configure_sink(_config.get("telemetry.sink"))

# mx.tracing registers the step hook and honors MXNET_TPU_TRACE /
# MXNET_TPU_WATCHDOG at its import; pulling it in here means any
# training-path import (io, module and kvstore import telemetry) activates
# the tracing environment variables too
from . import tracing as _tracing  # noqa: E402,F401

# mx.perf installs the step hook and honors MXNET_TPU_PROFILE at import
from . import perf as _perf  # noqa: E402,F401
