"""Process groups and host collectives over ``torch.distributed``
(counterpart of the rendezvous and collectives of
``mxnet_tpu.parallel``).

One process per device.  :func:`initialize` joins the group from
explicit arguments, else from the launcher's environment: the
reference's ``MXTPU_COORDINATOR`` / ``MXTPU_NUM_PROCESSES`` /
``MXTPU_PROCESS_ID`` (``python -m mxnet_tpu_torch.launch`` sets them),
else torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
``RANK``.  A rank runs on ``cuda:(local_rank % device_count)``, or on the
CPU when the caller asks for it (``device="cpu"``, or a ``with
mx.cpu():`` context around the call); with no card and no such request it
raises, as every entry point of the port does.

The backend follows one rule, printed once to stderr: ``nccl`` when every
rank on the host has a card of its own, else ``gloo``.  Every collective
here takes the tensor where it lies: gloo runs ``all_reduce``,
``broadcast`` and ``all_gather`` of CUDA tensors itself (the H100 run of
``chip_smoke.py --phase dist`` probes each), so this module stages
nothing through host memory.  Nothing is caught and retried: a collective
that fails raises.
"""
from __future__ import annotations

import datetime
import os
import sys

import numpy as _np
import torch
import torch.distributed as _dist

__all__ = ["initialize", "ensure_initialized", "barrier", "host_allreduce",
           "host_allgather", "rank", "world_size", "device", "backend",
           "all_reduce_", "all_gather", "broadcast_"]

# how long a collective waits for a peer before the group gives up
TIMEOUT_S = 600


class _Group:
    """This process's place in the group: set by :func:`initialize`."""

    def __init__(self):
        self.device = None
        self.local_world = 1


_GROUP = _Group()


def _env_int(*names):
    for n in names:
        if os.environ.get(n, "") != "":
            return int(os.environ[n])
    return None


def _coordinator():
    addr = os.environ.get("MXTPU_COORDINATOR")
    if addr:
        return addr
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return "%s:%s" % (os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"])
    return None


def _rank_device(requested, local_rank):
    """The device a rank runs on: the requested one (``"cpu"``, a
    Context, a ``torch.device``), else the CPU under a ``with mx.cpu():``
    context, else ``cuda:(local_rank % device_count)``."""
    from ..context import current_context, resolve_device
    from ..base import MXNetErrorNoDevice
    if requested is not None:
        return resolve_device(requested)
    if current_context().device_type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise MXNetErrorNoDevice(
            "parallel.initialize: no CUDA device is visible; pass "
            "device='cpu' (or call it under `with mx.cpu():`) to run the "
            "rank on the CPU")
    return torch.device("cuda", local_rank % n)


def _backend_for(dev, local_world):
    """``nccl`` when every rank on this host has a card of its own, else
    ``gloo``; returns ``(backend, why)``."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if dev.type == "cuda" and local_world <= n:
        return "nccl", "%d rank(s) on this host, %d CUDA device(s)" % (
            local_world, n)
    if dev.type == "cuda":
        return "gloo", ("%d ranks on this host share %d CUDA device(s)"
                        % (local_world, n))
    return "gloo", "ranks on the CPU"


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device=None):
    """Join the process group (the reference's rendezvous,
    ``jax.distributed.initialize``).  Arguments take precedence over the
    launcher's environment (module docstring).  Raises when the group is
    already initialized or the rendezvous is not named."""
    if _dist.is_initialized():
        raise RuntimeError("parallel.initialize: the process group is "
                           "already initialized")
    coordinator = coordinator_address or _coordinator()
    world = num_processes if num_processes is not None else _env_int(
        "MXTPU_NUM_PROCESSES", "WORLD_SIZE")
    rank_ = process_id if process_id is not None else _env_int(
        "MXTPU_PROCESS_ID", "RANK")
    if coordinator is None or world is None or rank_ is None:
        raise ValueError(
            "parallel.initialize: no rendezvous (coordinator %r, world "
            "size %r, rank %r); start the workers with `python -m "
            "mxnet_tpu_torch.launch -n N ...` or torchrun, or pass the "
            "three arguments" % (coordinator, world, rank_))
    local_rank = _env_int("LOCAL_RANK")
    local_world = _env_int("LOCAL_WORLD_SIZE")
    local_rank = int(rank_) if local_rank is None else local_rank
    local_world = int(world) if local_world is None else local_world
    dev = _rank_device(device, local_rank)
    backend_, why = _backend_for(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _GROUP.device, _GROUP.local_world = dev, local_world
    print("mxnet_tpu_torch.parallel: rank %d of %d on %s, backend %s (%s)"
          % (int(rank_), int(world), dev, backend_, why), file=sys.stderr,
          flush=True)
    _dist.init_process_group(
        backend_, init_method="tcp://" + coordinator,
        world_size=int(world), rank=int(rank_),
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def ensure_initialized():
    """Join the group iff a launcher named one and it is not joined yet:
    creating a ``dist_*`` kvstore alone bootstraps a worker, as in the
    reference."""
    if _dist.is_initialized():
        return
    if _coordinator() is not None:
        initialize()


def rank():
    return _dist.get_rank() if _dist.is_initialized() else 0


def world_size():
    return _dist.get_world_size() if _dist.is_initialized() else 1


def backend():
    """``"nccl"``, ``"gloo"``, or None outside a group."""
    return _dist.get_backend() if _dist.is_initialized() else None


def device():
    """The device :func:`initialize` gave this rank (None outside a
    group)."""
    return _GROUP.device if _dist.is_initialized() else None


# --------------------------------------------------------- the collectives
def all_reduce_(t, group=None):
    """Sum ``t`` over the group's ranks, in place; returns ``t``."""
    if _dist.is_initialized() and _dist.get_world_size(group) > 1:
        _dist.all_reduce(t, group=group)
    return t


def broadcast_(t, src=0, group=None):
    """``t`` from rank ``src`` (a global rank) on every rank, in place."""
    if _dist.is_initialized() and _dist.get_world_size(group) > 1:
        _dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t, group=None):
    """``[group size, *t.shape]``: every rank's ``t`` in group-rank
    order, on ``t``'s device."""
    if not _dist.is_initialized() or _dist.get_world_size(group) == 1:
        return t.unsqueeze(0)
    src = t.contiguous()
    parts = [torch.empty_like(src)
             for _ in range(_dist.get_world_size(group))]
    _dist.all_gather(parts, src, group=group)
    return torch.stack(parts)


def barrier(name="kvstore"):
    """Global barrier (reference ``KVStore::Barrier``), in a ``barrier``
    span."""
    if not _dist.is_initialized() or _dist.get_world_size() == 1:
        return
    from .. import tracing as _tracing
    with _tracing.span("barrier", cat="collective", name_arg=name):
        if _dist.get_backend() == "nccl":
            _dist.barrier(device_ids=[_GROUP.device.index])
        else:
            _dist.barrier()


def _as_tensor(val):
    """``(tensor, was_numpy)``; under nccl a host value goes to this
    rank's card for the collective."""
    is_np = not isinstance(val, torch.Tensor)
    t = torch.as_tensor(_np.asarray(val)) if is_np else val
    if is_np and _dist.is_initialized() and _dist.get_backend() == "nccl":
        t = t.to(_GROUP.device)
    return t, is_np


def host_allgather(val):
    """Stack a rank-local array over all ranks: ``[world, *shape]`` (the
    reference's ``host_allgather``), in an ``allgather`` span over
    several ranks.  numpy in, numpy out; a tensor comes back on its
    device."""
    t, is_np = _as_tensor(val)
    if world_size() == 1:
        out = all_gather(t)
    else:
        from .. import tracing as _tracing
        with _tracing.span("allgather", cat="collective"):
            out = all_gather(t)
    return out.cpu().numpy() if is_np else out


def host_allreduce(val):
    """Sum a rank-local array over all ranks, the rows added in rank order
    so the sum is the same on every rank and in every run (the reference's
    ``host_allreduce``: the dist_sync server-merge analog), in an
    ``allreduce`` span."""
    if world_size() == 1:
        return val
    from .. import tracing as _tracing
    with _tracing.span("allreduce", cat="collective"):
        t, is_np = _as_tensor(val)
        rows = host_allgather(t)
        total = rows[0].clone()
        for r in range(1, rows.shape[0]):
            total += rows[r]
    return total.cpu().numpy() if is_np else total
