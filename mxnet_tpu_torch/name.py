"""Automatic naming (counterpart of ``mxnet_tpu.name``): the counters that
give a top-level Block its prefix (``resnetv10_``, ``resnetv11_``, ...)."""
from __future__ import annotations

import threading

__all__ = ["NameManager"]


class _ClassProperty:
    def __init__(self, fget):
        self.fget = fget

    def __get__(self, obj, owner):
        return self.fget(owner)


class NameManager:
    """Hands out ``hint0``, ``hint1``, ... per hint (reference name.py:27)."""

    _state = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    @_ClassProperty
    def current(cls):
        if getattr(NameManager._state, "value", None) is None:
            NameManager._state.value = NameManager()
        return NameManager._state.value

    def get(self, name, hint):
        if name:
            return name
        count = self._counter.get(hint, 0)
        self._counter[hint] = count + 1
        return "%s%d" % (hint, count)

    def __enter__(self):
        self._old_manager = getattr(NameManager._state, "value", None)
        NameManager._state.value = self
        return self

    def __exit__(self, *exc):
        NameManager._state.value = self._old_manager
