"""Samplers (counterpart of ``mxnet_tpu.gluon.data.sampler``; reference
``python/mxnet/gluon/data/sampler.py``).  ``RandomSampler`` draws its
permutations from its own CPU ``torch.Generator`` (``generator=``, else
one seeded from ``mx.random``'s stream when the sampler is made)."""
from __future__ import annotations

import torch

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    """Base sampler: an iterable of sample indices (reference:
    sampler.py:27)."""

    def __len__(self):
        raise NotImplementedError

    def __iter__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """``0, 1, ..., length - 1`` (reference: sampler.py:41)."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """``[0, length)`` in a new random order each pass, without
    replacement (reference: sampler.py:58)."""

    def __init__(self, length, generator=None):
        from ...random import next_key
        self._length = length
        self._gen = generator if generator is not None else next_key()

    def __iter__(self):
        return iter(int(i) for i in torch.randperm(self._length,
                                                   generator=self._gen))

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Mini-batches of a sampler's indices (reference: sampler.py:76);
    ``last_batch`` is ``keep``, ``discard`` or ``rollover`` (the short
    batch leads the next pass)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(
                    "last_batch must be one of 'keep', 'discard', or "
                    "'rollover', but got %s" % self._last_batch)

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) \
                // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        if self._last_batch == "rollover":
            return (len(self._prev) + len(self._sampler)) // self._batch_size
        raise ValueError(
            "last_batch must be one of 'keep', 'discard', or 'rollover', "
            "but got %s" % self._last_batch)
