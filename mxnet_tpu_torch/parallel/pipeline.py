"""Pipeline parallelism: GPipe-style microbatches over a mesh axis
(counterpart of ``mxnet_tpu.parallel.pipeline``).

Each rank of the ``pp`` axis holds one stage's parameters.  The
schedule is the reference's: ``n_micro + n_stage - 1`` ticks; at each
tick stage 0 takes microbatch ``t`` (clamped in the drain ticks, whose
outputs are never selected), every stage runs ``stage_fn`` and its
output moves one hop down the ring (:func:`collectives.ppermute`), and
microbatch ``j`` leaves the last stage at tick ``j + n_stage - 1``.  The
last stage's outputs reach every stage by the masked sum
(:func:`collectives.broadcast_last`), whose backward hands the cotangent
to the last stage only: the backward pipeline is autograd through the
ticks, each ``ppermute`` transposed to the reverse rotation.

Every stage runs the same operations at every tick (the input choice is
a ``torch.where`` on the stage index, not a branch), so every rank
calls the same collectives in the same order, forward and backward.

The reference calls :func:`pipeline_apply` inside ``shard_map``; here
the mesh's groups take its place, so it takes the ``mesh``.
``vary_axes`` is accepted for the reference's signature: it types the
carry for JAX's varying-axis checks and means nothing in PyTorch.
"""
from __future__ import annotations

import torch

from . import collectives as _coll

__all__ = ["pipeline_apply", "pipeline_sharded", "microbatch",
           "unmicrobatch"]


def microbatch(x, n_micro):
    """``[B, ...] -> [n_micro, B // n_micro, ...]``."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError("batch %d not divisible into %d microbatches"
                         % (b, n_micro))
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def unmicrobatch(x):
    """``[n_micro, mb, ...] -> [n_micro * mb, ...]``."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def pipeline_apply(stage_fn, stage_params, x, axis_name="pp",
                   vary_axes=None, *, mesh):
    """Run the microbatched ``x [n_micro, mb, ...]`` through the stages
    along ``axis_name`` of ``mesh``: ``stage_fn(stage_params, act) ->
    act`` is this rank's stage (activations keep one shape through the
    pipeline; only stage 0 reads ``x``).  Returns the last stage's
    outputs ``[n_micro, mb, ...]`` on every stage."""
    del vary_axes  # JAX's carry typing; nothing to type here
    n_micro = x.shape[0]
    n_stage = mesh.shape[axis_name]
    first = torch.tensor(mesh.axis_index(axis_name) == 0, device=x.device)
    act = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    outs = []
    for t in range(n_micro + n_stage - 1):
        x_t = x[min(t, n_micro - 1)]
        out = stage_fn(stage_params, torch.where(first, x_t.to(act.dtype),
                                                 act))
        outs.append(out)
        if t + 1 < n_micro + n_stage - 1:
            # one hop: this stage's output is the next stage's input (the
            # last tick's hop would go unread, so it is not taken)
            act = _coll.ppermute(out, mesh, axis_name, 1)
    y = torch.stack(outs[n_stage - 1:n_stage - 1 + n_micro])
    return _coll.broadcast_last(y, mesh, axis_name)


def pipeline_sharded(mesh, stage_fn, stacked_params, x, n_micro,
                     axis_name="pp"):
    """Whole-array wrapper: every leaf of ``stacked_params`` (a dict, or a
    tensor) has a leading stage axis of ``mesh.shape[axis_name]``, of
    which this rank takes its own stage; ``x`` is the whole ``[B, ...]``
    batch on every rank.  Returns the whole ``[B, ...]`` outputs on every
    rank; the gradients of ``stacked_params`` and ``x`` come back whole
    on every rank."""
    spec = (axis_name,)

    def mine(v):
        return _coll.shard(v, mesh, spec)[0]

    if isinstance(stacked_params, dict):
        params = {k: mine(v) for k, v in stacked_params.items()}
    else:
        params = mine(stacked_params)
    # only stage 0 reads x: its gradient is the sum over the stages
    xm = _coll.shard(microbatch(x, n_micro), mesh, (), sum_axes=spec)
    return unmicrobatch(pipeline_apply(stage_fn, params, xm,
                                       axis_name=axis_name, mesh=mesh))
