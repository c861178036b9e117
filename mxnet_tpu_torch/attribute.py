"""Attribute scoping for symbols (counterpart of ``mxnet_tpu.attribute``;
reference ``python/mxnet/attribute.py``): ``AttrScope`` stamps its
attributes onto every Symbol node created inside it, Variables included
(read back with ``Symbol.attr`` / ``list_attr`` / ``attr_dict``); its
``ctx_group`` attribute is what ``bind(group2ctx=...)`` places by."""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]


class AttrScope:
    """Context manager whose string attributes annotate the Symbols
    created within; nested scopes merge, the inner winning."""

    _state = threading.local()

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("attributes must be strings (reference "
                                 "AttrScope contract)")
        self._attr = kwargs

    @classmethod
    def _stack(cls):
        if not hasattr(cls._state, "stack"):
            cls._state.stack = []
        return cls._state.stack

    @classmethod
    def current_attrs(cls):
        """The attributes of every entered scope, merged outer to
        inner."""
        merged = {}
        for scope in cls._stack():
            merged.update(scope._attr)
        return merged

    def get(self, attr=None):
        """This scope's attributes as defaults, ``attr`` winning
        (reference ``AttrScope.get``); the enclosing scopes are not
        read."""
        merged = dict(self._attr)
        if attr:
            merged.update(attr)
        return merged

    def __enter__(self):
        self._stack().append(self)
        return self

    def __exit__(self, *exc):
        self._stack().pop()


def current():
    """The attributes in force: every entered scope's, merged."""
    return AttrScope.current_attrs()
