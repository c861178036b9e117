"""``mx.resilience``, the part the checkpoint, data and serving paths
call (counterpart of ``mxnet_tpu.resilience``): the atomic file writer,
the checkpoint schema and its corruption error, retry with exponential
backoff and seeded jitter (the ``resilience.retry_*`` knobs: 3 attempts
from 0.05 s by default), and the deterministic fault-injection harness
(``MXNET_TPU_FAULTS`` / the ``resilience.faults`` knob): ``kind:P``
injects with probability P at each opportunity of that kind from a
seeded RNG, ``kind:N@step=M`` on N opportunities from the M-th.  The
serving dispatch draws ``serving_dispatch`` (fail the batch) and
``serving_slow`` (delay it), and ``call_with_retry(inject_faults=True)``
draws its ``kind`` before each attempt.

The checkpoint manager, the nanguard and preemption saves are not
ported yet.
"""
from __future__ import annotations

import functools
import random as _pyrandom
import sys
import time
import zlib
from collections import namedtuple

from .base import MXNetError, atomic_write
from . import telemetry as _telemetry

__all__ = ["CheckpointCorruptError", "atomic_write", "CKPT_SCHEMA",
           "call_with_retry", "retry", "configure_retry", "InjectedFault",
           "FaultRule", "parse_faults", "configure_faults", "faults_active",
           "should_inject", "inject"]

#: schema version stamped into SPMDTrainer single-file checkpoints (the
#: reference's); a loader refuses a file of a newer schema
CKPT_SCHEMA = 1


class CheckpointCorruptError(MXNetError):
    """A checkpoint file is missing, truncated, not a checkpoint, or of a
    newer schema."""


class InjectedFault(OSError):
    """A deterministic fault from the ``MXNET_TPU_FAULTS`` harness.  An
    OSError, so the retry machinery treats it as the transient failure it
    simulates."""


# the policy; configure_retry refreshes it from the knobs
_RETRY = {"attempts": 3, "base_s": 0.05, "factor": 2.0, "max_s": 2.0,
          "jitter": 0.5, "rng": _pyrandom.Random(0)}


def configure_retry(attempts=None, base_s=None, seed=None):
    """Refresh the retry policy from the ``resilience.retry_attempts``,
    ``resilience.retry_base_s`` and ``resilience.fault_seed`` knobs (or
    the explicit arguments)."""
    from . import config
    _RETRY["attempts"] = max(1, int(
        config.get("resilience.retry_attempts")
        if attempts is None else attempts))
    _RETRY["base_s"] = float(config.get("resilience.retry_base_s")
                             if base_s is None else base_s)
    _RETRY["rng"] = _pyrandom.Random(
        config.get("resilience.fault_seed") if seed is None else seed)


def call_with_retry(fn, *args, kind="io", inject_faults=False, **kwargs):
    """``fn(*args, **kwargs)``, retried with exponential backoff and
    seeded jitter on ``OSError`` (InjectedFault included);
    ``StopIteration`` and other exceptions pass straight through.
    ``inject_faults=True`` draws a ``kind`` fault before each attempt,
    before the body runs.  Each retry bumps ``resilience.retries`` and
    ``resilience.retries.<kind>``."""
    attempts = _RETRY["attempts"]
    delay = _RETRY["base_s"]
    for attempt in range(1, attempts + 1):
        try:
            if inject_faults and _FAULTS:
                inject(kind)
            return fn(*args, **kwargs)
        except OSError as exc:
            if attempt >= attempts:
                raise
            _telemetry.counter("resilience.retries").inc()
            _telemetry.counter("resilience.retries.%s" % kind).inc()
            sleep = min(_RETRY["max_s"],
                        delay * (1.0 + _RETRY["jitter"]
                                 * _RETRY["rng"].random()))
            sys.stderr.write("[mxnet_tpu_torch.resilience] %s failed (%s: "
                             "%s); retry %d/%d in %.3fs\n"
                             % (kind, type(exc).__name__, exc, attempt,
                                attempts - 1, sleep))
            time.sleep(sleep)
            delay *= _RETRY["factor"]


def retry(kind="io", inject_faults=False):
    """Decorator form of :func:`call_with_retry`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return call_with_retry(fn, *args, kind=kind,
                                   inject_faults=inject_faults, **kwargs)
        return wrapper
    return deco


# ----------------------------------------------------------- fault harness
FaultRule = namedtuple("FaultRule", ["kind", "prob", "count", "at_step"])

_FAULTS = {}       # kind -> FaultRule; empty == harness off
_FAULT_RNGS = {}   # kind -> seeded random.Random (probability rules)
_FAULT_CALLS = {}  # kind -> opportunity counter


def parse_faults(spec):
    """Parse a fault spec: comma-separated ``kind:P`` (probability P in
    [0, 1] at each opportunity) or ``kind:N@step=M`` (exactly N
    opportunities from the M-th, 1-based) entries."""
    rules = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        if ":" not in entry:
            raise ValueError("fault entry %r is not kind:rule" % entry)
        kind, rule = entry.split(":", 1)
        kind = kind.strip()
        if "@" in rule:
            count_s, cond = rule.split("@", 1)
            if not cond.startswith("step="):
                raise ValueError("fault entry %r: expected @step=N" % entry)
            rules[kind] = FaultRule(kind, None, int(count_s),
                                    int(cond[len("step="):]))
        else:
            p = float(rule)
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    "fault entry %r: probability out of [0,1]" % entry)
            rules[kind] = FaultRule(kind, p, None, None)
    return rules


def configure_faults(spec=None, seed=None):
    """(Re)arm the harness from the ``resilience.faults`` /
    ``resilience.fault_seed`` knobs (or the arguments).  Resets every
    kind's RNG and opportunity counter, so two runs configured alike
    inject the same faults."""
    from . import config
    if spec is None:
        spec = config.get("resilience.faults")
    if seed is None:
        seed = int(config.get("resilience.fault_seed"))
    rules = parse_faults(spec)
    _FAULTS.clear()
    _FAULT_RNGS.clear()
    _FAULT_CALLS.clear()
    _FAULTS.update(rules)
    for kind in rules:
        _FAULT_RNGS[kind] = _pyrandom.Random(
            seed ^ zlib.crc32(kind.encode()))
    configure_retry(seed=seed)


def faults_active(kind=None):
    if kind is None:
        return bool(_FAULTS)
    return kind in _FAULTS


def should_inject(kind, step=None):
    """One injection draw for ``kind`` (advances its state); ``step``
    replaces the opportunity counter of an ``@step`` rule."""
    rule = _FAULTS.get(kind)
    if rule is None:
        return False
    _FAULT_CALLS[kind] = _FAULT_CALLS.get(kind, 0) + 1
    if rule.at_step is not None:
        n = step if step is not None else _FAULT_CALLS[kind]
        hit = rule.at_step <= n < rule.at_step + rule.count
    else:
        hit = _FAULT_RNGS[kind].random() < rule.prob
    if hit:
        _telemetry.counter("resilience.injected.%s" % kind).inc()
    return hit


def inject(kind, step=None):
    """Raise InjectedFault when this opportunity draws a ``kind`` fault;
    a no-op while the harness is off or the draw misses."""
    if _FAULTS and should_inject(kind, step=step):
        raise InjectedFault("injected %s fault (MXNET_TPU_FAULTS)" % kind)


# the knobs' environment variables arm the harness at import
configure_faults()
