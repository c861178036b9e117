"""``mx.executor_manager`` (reference ``python/mxnet/executor_manager.py``):
of the legacy multi-device executor helpers only ``_split_input_slice``,
the host-side batch partitioner reference scripts import, has a body."""
from __future__ import annotations

__all__ = ["_split_input_slice"]


def _split_input_slice(batch_size, work_load_list):
    """Slice a batch by per-device workloads (reference
    ``executor_manager.py:33``)."""
    total = sum(work_load_list)
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        end = batch_size if i == len(work_load_list) - 1 else \
            start + int(round(batch_size * w / total))
        if end <= start:
            raise ValueError("too many slices: batch_size %d cannot cover "
                             "workloads %r" % (batch_size, work_load_list))
        slices.append(slice(start, end))
        start = end
    return slices
