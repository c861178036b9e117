"""``IntervalSampler`` (counterpart of
``mxnet_tpu.gluon.contrib.data.sampler``; reference
``gluon/contrib/data/sampler.py:25``)."""
from __future__ import annotations

from ...data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """Samples i, i+interval, i+2*interval, ... for each start i — the
    strided coverage order used by truncated-BPTT corpus sharding."""

    def __init__(self, length, interval, rollover=True):
        if interval > length:
            raise ValueError("interval %d > length %d" % (interval, length))
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        starts = range(self._interval) if self._rollover else [0]
        for i in starts:
            yield from range(i, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
