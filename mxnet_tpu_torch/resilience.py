"""``mx.resilience``, the part the checkpoint and data paths call
(counterpart of ``mxnet_tpu.resilience``): the atomic file writer, the
checkpoint schema and its corruption error, and retry with exponential
backoff and seeded jitter (3 attempts from 0.05 s, the reference's
defaults).

The checkpoint manager, the nanguard, preemption saves, fault injection
and the retry knobs are not ported yet.
"""
from __future__ import annotations

import functools
import random as _pyrandom
import sys
import time

from .base import MXNetError, atomic_write
from . import telemetry as _telemetry

__all__ = ["CheckpointCorruptError", "atomic_write", "CKPT_SCHEMA",
           "call_with_retry", "retry"]

#: schema version stamped into SPMDTrainer single-file checkpoints (the
#: reference's); a loader refuses a file of a newer schema
CKPT_SCHEMA = 1


class CheckpointCorruptError(MXNetError):
    """A checkpoint file is missing, truncated, not a checkpoint, or of a
    newer schema."""


# the reference's policy at its knobs' defaults
_RETRY = {"attempts": 3, "base_s": 0.05, "factor": 2.0, "max_s": 2.0,
          "jitter": 0.5, "rng": _pyrandom.Random(0)}


def call_with_retry(fn, *args, kind="io", inject_faults=False, **kwargs):
    """``fn(*args, **kwargs)``, retried with exponential backoff and
    seeded jitter on ``OSError``; ``StopIteration`` and other exceptions
    pass straight through.  Each retry bumps ``resilience.retries`` and
    ``resilience.retries.<kind>``.  ``inject_faults`` is accepted for the
    reference's signature (no faults are injected here)."""
    attempts = _RETRY["attempts"]
    delay = _RETRY["base_s"]
    for attempt in range(1, attempts + 1):
        try:
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
