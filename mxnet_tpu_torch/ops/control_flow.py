"""Control flow: ``foreach``, ``while_loop`` and ``cond`` (counterpart of
``mxnet_tpu.ops.control_flow``; reference ``python/mxnet/ndarray/
contrib.py`` foreach :216, while_loop :340, cond :480), reached as
``mx.nd.contrib``.

The reference takes one of two paths by the recording flag, not by
``hybridize``: while ``autograd.record()`` is on it runs a Python loop
the tape sees; otherwise it runs its traced loop (``lax.scan``).  Both
are kept here, each a Python loop over ``mx.nd`` ops:

- recording: ``while_loop`` stops at the first false predicate, and its
  outputs have one row a step taken (none: an empty list);
- not recording: ``while_loop`` runs ``max_iterations`` steps, the loop
  variables frozen from the first false predicate on (no host read of
  the predicate), and its outputs have ``max_iterations`` rows, a dead
  step's row ``func`` of the frozen variables; ``cond`` returns a single
  output unwrapped.
"""
from __future__ import annotations

import torch

from .. import _tape

__all__ = ["foreach", "while_loop", "cond"]


def _nd():
    from ..ndarray.ndarray import NDArray
    return NDArray


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _stack(rows):
    """One NDArray a position of the per-step output lists."""
    from .registry import invoke
    return [invoke("stack", *[r[j] for r in rows], axis=0)
            for j in range(len(rows[0]))]


def foreach(body, data, init_states):
    """Run ``body(element, states) -> (outputs, states)`` over the leading
    axis of ``data``; returns the stacked outputs and the final states."""
    NDArray = _nd()
    single_data = isinstance(data, NDArray)
    single_state = isinstance(init_states, NDArray)
    datas = [data] if single_data else list(data)
    states = [init_states] if single_state else list(init_states)
    rows = []
    for i in range(datas[0].shape[0]):
        eles = [d[i] for d in datas]
        outs, states_out = body(eles[0] if single_data else eles,
                                states[0] if single_state else states)
        states = [states_out] if single_state else list(states_out)
        rows.append(_as_list(outs))
    stacked = _stack(rows)
    return (stacked[0] if len(stacked) == 1 else stacked,
            states[0] if single_state else states)


def _truth(pred):
    """A predicate (NDArray or Python value) as a 0-d bool tensor."""
    NDArray = _nd()
    if isinstance(pred, NDArray):
        return pred._data.to(torch.bool).reshape(())
    return torch.tensor(bool(pred))


def while_loop(cond_fn, func, loop_vars, max_iterations=None):
    """``func(*vars) -> (outputs, vars)`` while ``cond_fn(*vars)``, at most
    ``max_iterations`` times; returns the stacked outputs and the final
    variables (see the module doc for the two paths)."""
    NDArray = _nd()
    from ..ndarray.ndarray import _wrap
    single_var = isinstance(loop_vars, NDArray)
    lvars = [loop_vars] if single_var else list(loop_vars)
    if max_iterations is None:
        raise ValueError("max_iterations should be specified")
    rows = []
    if _tape.is_recording():
        while len(rows) < max_iterations and bool(_truth(cond_fn(*lvars))):
            step_out, lvars = func(*lvars)
            lvars = _as_list(lvars)
            rows.append(_as_list(step_out))
    else:
        alive = None
        for _ in range(int(max_iterations)):
            pred = _truth(cond_fn(*lvars)).to(lvars[0]._data.device)
            alive = pred if alive is None else alive & pred
            step_out, new_vars = func(*lvars)
            lvars = [_wrap(torch.where(alive, nv._data, v._data))
                     for nv, v in zip(_as_list(new_vars), lvars)]
            rows.append(_as_list(step_out))
    stacked = _stack(rows) if rows else []
    return (stacked[0] if len(stacked) == 1 else stacked,
            lvars[0] if single_var else lvars)


def cond(pred, then_func, else_func):
    """``then_func()`` if ``pred`` else ``else_func()``; not recording, a
    single output comes unwrapped."""
    NDArray = _nd()
    p = pred.asscalar() if isinstance(pred, NDArray) else pred
    out = then_func() if p else else_func()
    if _tape.is_recording():
        return out
    outs = _as_list(out)
    return outs[0] if len(outs) == 1 else outs
