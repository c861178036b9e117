"""``mx.profiler`` — the profiling facade over ``torch.profiler``
(counterpart of ``mxnet_tpu.profiler``).

Reference: ``src/profiler/profiler.h:251`` (per-thread event buffers,
the Chrome-trace dump, aggregate per-op statistics) and
``python/mxnet/profiler.py`` (``set_config`` / ``start`` / ``stop`` /
``dumps``, the scoped ``Domain`` / ``Task`` / ``Frame`` / ``Counter`` /
``Marker`` API).

* **Sessions** — ``start`` / ``stop`` (``pause`` / ``resume``,
  ``set_state``) run one ``torch.profiler.profile`` session: CPU activity
  always, CUDA activity when a card is present.  ``dump()`` exports the
  last session's Chrome trace to ``profiler.filename`` (the host events
  alone when no session ran); ``device_op_events()`` gives its CUDA
  kernels by name; ``dumps()`` renders the reference's sections, the
  DEVICE section built from those kernels.
* **Empty and partial sessions are reported** — a session on a card that
  recorded no CUDA activity bumps ``profiler.empty_sessions``, one that
  recorded fewer kernels than its host side launched bumps
  ``profiler.partial_sessions``, and ``dumps()`` says so beside the
  device table (late in a long process torch.profiler sessions can come
  back without some or all of their kernels).
* **Scoped events** — ``Task`` / ``Frame`` / ``Event`` / ``scope``
  record host events for the table and, while a session runs, enter
  ``torch.profiler.record_function`` (the reference's
  ``jax.profiler.TraceAnnotation``), so they nest in the trace.
* **Dispatch counters** — ``counter_increment`` / ``counters`` /
  ``reset_counters`` read and write the ``mx.telemetry`` registry
  (``fused_steps``, ``eager_steps``, ``fused_compiles``,
  ``host_syncs``).

``profiler.autostart`` (``MXNET_PROFILER_AUTOSTART``) starts a session
when this module is imported.
"""
from __future__ import annotations

import json
import threading
import time

__all__ = ["set_config", "start", "stop", "pause", "resume", "dump", "dumps",
           "set_state", "Domain", "Task", "Frame", "Event", "Counter",
           "Marker", "scope", "profiler_scope", "counters", "reset_counters",
           "counter_increment", "device_op_events"]

_CONFIG = {"profile_all": False, "filename": None, "aggregate_stats": True}
# session: the running torch.profiler.profile; last_session: the one
# stop() just finished (dump/dumps read it); cuda: whether the session
# asked for CUDA activity; device: {kernel name: [seconds]} of the last
# session; empty: the last CUDA session recorded no CUDA activity;
# launched / recorded: its host-side kernel launches and the kernels its
# device side recorded
_STATE = {"running": False, "session": None, "last_session": None,
          "cuda": False, "device": None, "empty": False, "launched": 0,
          "recorded": 0, "t0": None}

# the host-side calls that launch one kernel each
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                 "cuLaunchKernelEx")
_EVENTS = []
_EVENTS_LOCK = threading.Lock()


# ------------------------------------------------------- dispatch counters
def counter_increment(name, delta=1):
    """Bump a registry counter (created on first use)."""
    from . import telemetry
    telemetry.counter(name).inc(delta)


def counters():
    """Snapshot of the counter registry: steps run per path
    (``fused_steps`` / ``eager_steps``), step functions built
    (``fused_compiles``), host syncs, and every subsystem counter."""
    from . import telemetry
    return telemetry.snapshot()["counters"]


def reset_counters():
    from . import telemetry
    telemetry.reset_counters()


# ----------------------------------------------------------------- sessions
def set_config(**kwargs):
    """Accepts the reference's knobs (``profile_symbolic``,
    ``profile_imperative``, ``profile_memory``, ``profile_api``,
    ``aggregate_stats``, ``filename``, ...); ``filename`` is where
    :func:`dump` writes."""
    _CONFIG.update(kwargs)


def _filename():
    from . import config
    return _CONFIG.get("filename") or config.get("profiler.filename")


def set_state(state="stop", profile_process="worker"):
    if state == "run":
        start()
    else:
        stop()


def start(profile_process="worker"):
    """Open a ``torch.profiler`` session (CPU activity, and CUDA activity
    when a card is present).  A second start while one runs does
    nothing."""
    if _STATE["running"]:
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    session = profile(activities=acts)
    session.start()
    _STATE.update(running=True, session=session, last_session=None,
                  cuda=cuda, device=None, empty=False, launched=0,
                  recorded=0, t0=time.perf_counter())


def stop(profile_process="worker"):
    """Close the running session (after the card finishes its queued
    work) and keep it for :func:`dump`, :func:`dumps` and
    :func:`device_op_events`."""
    if not _STATE["running"]:
        return
    session, cuda = _STATE["session"], _STATE["cuda"]
    if cuda:
        import torch
        torch.cuda.synchronize()
    session.stop()
    _STATE.update(running=False, session=None, last_session=session)
    device, launched, recorded = _kernel_events(session.events()) \
        if cuda else ({}, 0, 0)
    empty = cuda and not device
    if empty:
        counter_increment("profiler.empty_sessions")
    elif recorded < launched:
        counter_increment("profiler.partial_sessions")
    _STATE.update(device=device, empty=empty, launched=launched,
                  recorded=recorded)


def pause(profile_process="worker"):
    stop()


def resume(profile_process="worker"):
    start()


def _kernel_events(events):
    """``({name: [seconds]}, launched, recorded)`` of a finished session's
    events: its CUDA-side events (kernels, copies and sets on the card's
    streams), the kernel launches its host side made, and the kernels
    (not copies or sets) its device side recorded."""
    from torch.autograd import DeviceType
    host = {ev.name for ev in events if ev.device_type == DeviceType.CPU}
    launched = sum(ev.name in _LAUNCH_CALLS for ev in events
                   if ev.device_type == DeviceType.CPU)
    out, recorded = {}, 0
    for ev in events:
        # the record_function ranges (spans, scopes) are mirrored onto the
        # GPU timeline under their host names; they are not device work
        if ev.device_type == DeviceType.CUDA and ev.name and \
                ev.name not in host:
            out.setdefault(ev.name, []).append(
                ev.time_range.elapsed_us() / 1e6)
            recorded += not ev.name.startswith(("Memcpy", "Memset"))
    return out, launched, recorded


def device_op_events():
    """``{kernel name: [durations in seconds]}`` of the last finished
    session's CUDA activity — the data the reference's aggregate stats
    collect from kernel timestamps.  Empty without a CUDA session, or
    when the session recorded no CUDA activity (:func:`empty_session`
    tells the two apart).  A session still running is not read."""
    return dict(_STATE["device"] or {})


def empty_session():
    """Whether the last finished session asked for CUDA activity and
    recorded none."""
    return bool(_STATE["empty"])


def session_kernels():
    """``(recorded, launched)``: the kernels the last finished session's
    device side recorded and the kernel launches its host side made."""
    return _STATE["recorded"], _STATE["launched"]


def _record(kind, name, t_start, t_end, args=None):
    with _EVENTS_LOCK:
        _EVENTS.append({"kind": kind, "name": name, "ts": t_start,
                        "dur": t_end - t_start, "args": args or {}})


def dump(finished=True, profile_process="worker"):
    """Write the last session's Chrome trace (``torch.profiler``'s
    export: host ops, the scoped events and spans as
    ``record_function`` ranges, and the card's kernels on their stream
    lanes) to ``profiler.filename``; without a finished session, the host
    events alone (reference: ``DumpProfile``,
    ``src/profiler/profiler.h:299``).  Returns the path."""
    path = _filename()
    session = _STATE["last_session"]
    if session is not None:
        session.export_chrome_trace(path)
        return path
    with _EVENTS_LOCK:
        events = list(_EVENTS)
    trace = {"traceEvents": [
        {"name": e["name"], "cat": e["kind"], "ph": "X",
         "ts": e["ts"] * 1e6, "dur": e["dur"] * 1e6, "pid": 0, "tid": 0,
         "args": e["args"]} for e in events]}
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def _stats_rows(samples):
    """name -> list[seconds] into aggregate rows."""
    return {name: {"count": len(durs), "total": sum(durs),
                   "min": min(durs), "max": max(durs)}
            for name, durs in samples.items()}


def _format_table(agg, title, sort_by, ascending):
    rows = sorted(agg.items(), key=lambda kv: kv[1][sort_by],
                  reverse=not ascending)
    lines = [title,
             "%-40s %8s %12s %12s %12s" % ("Name", "Calls", "Total(ms)",
                                           "Min(ms)", "Max(ms)")]
    for name, s in rows:
        lines.append("%-40s %8d %12.3f %12.3f %12.3f"
                     % (name[:40], s["count"], s["total"] * 1e3,
                        s["min"] * 1e3, s["max"] * 1e3))
    return lines


def _format_timer_table(timers, sort_by, ascending):
    order = sort_by if sort_by in ("count", "total", "min", "max") \
        else "total"
    rows = sorted(timers.items(), key=lambda kv: kv[1][order],
                  reverse=not ascending)
    lines = ["Telemetry timers",
             "%-32s %8s %11s %10s %10s %10s %10s"
             % ("Name", "Calls", "Total(ms)", "Min(ms)", "Max(ms)",
                "P50(ms)", "P99(ms)")]
    for name, s in rows:
        lines.append("%-32s %8d %11.3f %10.3f %10.3f %10.3f %10.3f"
                     % (name[:32], s["count"], s["total"] * 1e3,
                        s["min"] * 1e3, s["max"] * 1e3, s["p50"] * 1e3,
                        s["p99"] * 1e3))
    return lines


def dumps(reset=False, format="table", sort_by="total", ascending=False):
    """The aggregate statistics (reference: ``aggregate_stats.cc``):
    the DEVICE section (the last session's CUDA kernels by name; when
    that session recorded no CUDA activity, or fewer kernels than it
    launched, a line saying so with the ``profiler.empty_sessions`` /
    ``profiler.partial_sessions`` count), the host events (Task / Frame /
    scope), then the ``mx.telemetry`` registry — timers with
    percentiles, gauges and counters.  ``reset=True`` clears the host
    events and the registry."""
    from . import telemetry
    with _EVENTS_LOCK:
        events = list(_EVENTS)
        if reset:
            _EVENTS.clear()
    snap = telemetry.snapshot()
    if reset:
        telemetry.reset()
    lines = []
    dev = device_op_events()
    if dev:
        lines += _format_table(_stats_rows(dev),
                               "Device ops (from the CUDA trace)", sort_by,
                               ascending)
        if _STATE["recorded"] < _STATE["launched"]:
            lines.append(
                "partial: the session recorded %d of the %d kernels it "
                "launched (profiler.partial_sessions=%d)"
                % (_STATE["recorded"], _STATE["launched"],
                   snap["counters"].get("profiler.partial_sessions", 0)))
        lines.append("")
    elif _STATE["empty"]:
        lines += ["Device ops (from the CUDA trace)",
                  "not measured: the session recorded no CUDA activity "
                  "(profiler.empty_sessions=%d)"
                  % snap["counters"].get("profiler.empty_sessions", 0), ""]
    host = {}
    for e in events:
        host.setdefault(e["name"], []).append(e["dur"])
    lines += _format_table(_stats_rows(host) if host else {},
                           "Host events", sort_by, ascending)
    lines.append("")
    lines += _format_timer_table(snap["timers"], sort_by, ascending)
    lines.append("")
    lines.append("Gauges")
    for k in sorted(snap["gauges"]):
        lines.append("%-40s %12s" % (k, snap["gauges"][k]))
    if any(snap["counters"].values()):
        lines.append("")
        lines.append("Counters (dispatch + subsystem)")
        for k in sorted(snap["counters"]):
            lines.append("%-40s %12d" % (k, snap["counters"][k]))
    return "\n".join(lines)


# ----------------------------------------------------------- scoped events
def _range(name):
    """An entered ``torch.profiler.record_function`` while a session
    runs, else None."""
    if not _STATE["running"]:
        return None
    try:
        from torch.profiler import record_function
        rng = record_function(name)
        rng.__enter__()
        return rng
    except Exception:  # noqa: BLE001 — annotation is best-effort
        return None


class Domain:
    """Named grouping (reference: profiler.py Domain)."""

    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(self, name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)


class _Scoped:
    def __init__(self, domain, name):
        self.domain = domain
        self.name = "%s::%s" % (domain.name, name) if domain else name
        self._t0 = None
        self._ann = None

    def start(self):
        self._t0 = time.perf_counter()
        self._ann = _range(self.name)
        return self

    def stop(self):
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None
        if self._t0 is not None:
            _record(self.__class__.__name__.lower(), self.name, self._t0,
                    time.perf_counter())
            self._t0 = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class Task(_Scoped):
    pass


class Frame(_Scoped):
    pass


class Event(_Scoped):
    pass


class Counter:
    def __init__(self, domain, name, value=None):
        self.name = "%s::%s" % (domain.name, name) if domain else name
        self.value = value or 0
        self._lock = threading.Lock()

    def set_value(self, value):
        with self._lock:
            self.value = value
        self._record_value(value)

    def _record_value(self, value):
        t = time.perf_counter()
        _record("counter", self.name, t, t, {"value": value})

    def increment(self, delta=1):
        # read-modify-write under the lock: concurrent increments from
        # several threads must never lose updates
        with self._lock:
            self.value += delta
            value = self.value
        self._record_value(value)

    def decrement(self, delta=1):
        self.increment(-delta)


class Marker:
    def __init__(self, domain, name):
        self.name = "%s::%s" % (domain.name, name) if domain else name

    def mark(self, scope="process"):
        t = time.perf_counter()
        _record("marker", self.name, t, t)


class scope(_Scoped):
    """``with mx.profiler.scope('fwd'):`` convenience."""

    def __init__(self, name="mxnet_tpu"):
        super().__init__(None, name)


profiler_scope = scope


def _autostart():
    from . import config
    if config.get("profiler.autostart"):
        start()


_autostart()
