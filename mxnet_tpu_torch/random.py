"""Random number management (counterpart of ``mxnet_tpu.random``).

``mx.random.seed(s)`` seeds the process-wide state; every draw takes an
explicit ``torch.Generator`` derived from it (:func:`next_key`), so the
initializers and the data a caller makes are reproducible from the seed.
Generators are CPU generators: a value is drawn on the host and then
placed, so the same seed gives the same numbers on every device.

``trace_key_scope`` keeps the reference's per-call key scope, which
``functionalize`` opens around a forward: inside it :func:`next_key`
derives from the scope's generator instead of the global state.  No op
on the ported paths draws random numbers; the API is kept for the ones
that will.  The two packages' streams differ for the same seed: tests
make their inputs with numpy and carry weights across.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "next_key", "trace_key_scope"]


class _KeyState(threading.local):
    def __init__(self):
        self.seed_val = 0
        self.counter = 0
        self.trace_stack = []


_STATE = _KeyState()


def seed(seed_state):
    """Set the global seed (``mx.random.seed``) and restart its stream."""
    _STATE.seed_val = int(seed_state)
    _STATE.counter = 0


def _generator(value):
    return torch.Generator().manual_seed(value & (2 ** 63 - 1))


def next_key():
    """A fresh ``torch.Generator``: drawn from the innermost
    ``trace_key_scope`` generator inside one, else the next of the global
    seed's stream."""
    if _STATE.trace_stack:
        top = _STATE.trace_stack[-1]
        return _generator(int(torch.randint(2 ** 62, (1,), generator=top)))
    _STATE.counter += 1
    return _generator(_STATE.seed_val * 1_000_003 + _STATE.counter)


class trace_key_scope:
    """Push a generator for the duration of one functionalized call."""

    def __init__(self, key):
        self.key = key

    def __enter__(self):
        _STATE.trace_stack.append(self.key)
        return self

    def __exit__(self, *exc):
        _STATE.trace_stack.pop()
