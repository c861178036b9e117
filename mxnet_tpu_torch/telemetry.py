"""Counters, gauges and timers (counterpart of ``mxnet_tpu.telemetry``,
without its exporters, JSONL sink or time windows).

Instruments live in one process-wide registry keyed by name, as in the
reference: the serving path and the kernel router bump the same names
(``kernels.paged_attention``, ``serving.tokens_generated``, ...) that the
reference package's telemetry reports.
"""
from __future__ import annotations

import threading
from collections import deque

__all__ = ["counter", "gauge", "timer", "snapshot", "reset"]

_REGISTRY_LOCK = threading.Lock()
_COUNTERS = {}
_GAUGES = {}
_TIMERS = {}


class Counter:
    """Monotonic counter; ``inc`` is atomic under a lock."""

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
    """Last-value instrument."""

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
    """Duration histogram: count/total/min/max plus p50/p99 over a bounded
    reservoir of the most recent observations.  Values are whatever unit
    the caller observes (the serving path observes milliseconds)."""

    __slots__ = ("name", "count", "total", "min", "max", "_samples",
                 "_lock")

    MAX_SAMPLES = 2048

    def __init__(self, name):
        self.name = name
        self.count = 0      # guarded-by: _lock
        self.total = 0.0    # guarded-by: _lock
        self.min = None     # guarded-by: _lock
        self.max = None     # guarded-by: _lock
        self._samples = deque(maxlen=self.MAX_SAMPLES)  # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(self, value):
        value = float(value)
        with self._lock:
            self.count += 1
            self.total += value
            if self.min is None or value < self.min:
                self.min = value
            if self.max is None or value > self.max:
                self.max = value
            self._samples.append(value)

    def stats(self):
        with self._lock:
            count, total = self.count, self.total
            mn, mx = self.min, self.max
            samples = sorted(self._samples)

        def pct(p):
            if not samples:
                return 0.0
            i = max(0, min(len(samples) - 1,
                           int(round(p / 100.0 * (len(samples) - 1)))))
            return samples[i]

        return {"count": count, "total": total, "min": mn or 0.0,
                "max": mx or 0.0, "p50": pct(50), "p99": pct(99)}

    def reset(self):
        with self._lock:
            self.count = 0
            self.total = 0.0
            self.min = None
            self.max = None
            self._samples.clear()


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
    """``{"counters": {name: int}, "gauges": {name: value},
    "timers": {name: stats}}``."""
    with _REGISTRY_LOCK:
        counters = list(_COUNTERS.values())
        gauges = list(_GAUGES.values())
        timers = list(_TIMERS.values())
    return {"counters": {c.name: c.value for c in counters},
            "gauges": {g.name: g.value for g in gauges},
            "timers": {t.name: t.stats() for t in timers}}


def reset():
    """Zero every instrument."""
    with _REGISTRY_LOCK:
        instruments = (list(_COUNTERS.values()) + list(_GAUGES.values())
                       + list(_TIMERS.values()))
    for inst in instruments:
        inst.reset()
