"""The NDArray autograd tape (counterpart of ``mxnet_tpu._tape``), over
``torch.autograd``.

The reference records one node per op with its vjp closure and walks the
nodes back on ``backward()``.  Here PyTorch keeps the graph: an NDArray
marked with ``attach_grad`` holds its value as a leaf tensor that
requires grad, an op recorded under ``autograd.record()`` runs on those
tensors so its outputs carry PyTorch history, and ``backward()`` takes
the gradients of the marked leaves with ``torch.autograd.grad`` and
writes (``grad_req='write'``) or adds (``'add'``) them into each leaf's
grad buffer; ``'null'`` leaves get none.

Which NDArrays are on the tape is decided per array, never with a global
``torch.no_grad()``: an op records when recording is on, the op is
differentiable and an input is on the tape (a marked leaf or a recorded
output); outside ``record()`` the tape's arrays enter an op detached, so
its outputs carry no history.  Tensors that carry PyTorch history without
being on the tape (``parallel.SPMDTrainer``'s masters under
``functionalize``) pass through untouched either way.

A ``backward`` without ``retain_graph`` frees the graph it walked, as the
reference's freed nodes do: a second ``backward`` through any of its
nodes raises, even where PyTorch itself would not (an op that saved no
tensor).  Each freed node carries a flag in its ``metadata``.
"""
from __future__ import annotations

import threading
import weakref

import torch

__all__ = ["is_recording", "is_training", "set_recording", "set_training",
           "mark_variable", "record_tensor", "backward", "grad_arrays"]

_FREED = "mxnet_tape_freed"
# id(leaf tensor) -> (weak reference to it, weak reference to the NDArray
# it is the value of); kept off the tensor itself, so the tensor saves and
# loads as any other.  An entry goes when its tensor does.
_OWNERS = {}


def _owner(t):
    """The NDArray whose value leaf tensor ``t`` is, or None."""
    entry = _OWNERS.get(id(t))
    if entry is None or entry[0]() is not t:
        return None
    return entry[1]()


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_recording(flag):
    prev = _STATE.recording
    _STATE.recording = bool(flag)
    return prev


def set_training(flag):
    prev = _STATE.training
    _STATE.training = bool(flag)
    return prev


def mark_variable(arr, grad, grad_req="write"):
    """Make ``arr`` a leaf of the tape with grad buffer ``grad`` (None for
    ``grad_req='null'``); its value becomes a fresh leaf tensor, which
    cuts any history it had."""
    arr._grad = grad
    arr._grad_req = grad_req
    arr._on_tape = True
    arr._data = arr._data.detach()
    if grad_req != "null":
        record_tensor(arr)


def record_tensor(arr):
    """The tensor a recorded op takes for ``arr``: for a marked leaf
    (other than ``'null'``), its value as a leaf tensor that requires grad
    and knows its NDArray.  A value replaced since the marking
    (``Parameter.set_data``, a kvstore pull, an optimizer writing
    ``_data``) is made such a leaf again here."""
    t = arr._data
    if arr._grad_req is None or arr._grad_req == "null":
        return t
    if _owner(t) is not arr or not t.requires_grad:
        t = t.detach().requires_grad_(True)
        _OWNERS[id(t)] = (weakref.ref(t), weakref.ref(arr))
        weakref.finalize(t, _OWNERS.pop, id(t), None)
        arr._data = t
    return t


def _walk(heads):
    """The graph behind ``heads``: its nodes (grad_fns, leaves' own
    accumulators excluded) and the marked NDArrays among its leaves, in
    first-reached order.  Raises if a node was freed by an earlier
    backward."""
    nodes, leaves, seen = [], {}, set()
    stack = []
    for h in heads:
        if h._grad_req is not None:
            leaves[id(h)] = h
        fn = h._data.grad_fn
        if fn is not None:
            stack.append(fn)
    while stack:
        fn = stack.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        var = getattr(fn, "variable", None)
        if var is not None:  # AccumulateGrad: a leaf tensor
            arr = _owner(var)
            if arr is not None and arr._data is var:
                leaves.setdefault(id(arr), arr)
            nodes.append(fn)  # held so its id stays unique during the walk
            continue
        if fn.metadata.get(_FREED):
            raise RuntimeError(
                "graph for op %r already freed; pass retain_graph=True to "
                "backward() to backprop twice" % (fn.name(),))
        nodes.append(fn)
        stack.extend(nf for nf, _ in fn.next_functions if nf is not None)
    return nodes, list(leaves.values())


def _free(nodes):
    for fn in nodes:
        if getattr(fn, "variable", None) is None:
            fn.metadata[_FREED] = True


def _heads_and_grads(heads, head_grads):
    """The head tensors that carry history and their output gradients
    (ones where none is given, as the reference's)."""
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif len(head_grads) != len(heads):
        raise ValueError("head_grads length mismatch")
    outs, grads = [], []
    for h, hg in zip(heads, head_grads):
        if not (h._on_tape or h._recorded):
            raise ValueError(
                "cannot differentiate output: it is neither a marked "
                "variable nor the output of an op recorded inside "
                "autograd.record() (reference: mxnet.autograd same "
                "contract)")
        t = h._data
        if not t.requires_grad:
            # no history (a 'null' leaf, stop_gradient, an op recorded on
            # arrays off the tape): no grad
            continue
        g = hg._data if hasattr(hg, "_data") else hg
        g = torch.ones_like(t) if g is None else torch.as_tensor(
            g, device=t.device).to(t.dtype).expand_as(t)
        outs.append(t)
        grads.append(g)
    return outs, grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Reverse accumulation from ``heads`` into the grad buffers of every
    marked leaf they reach (``grad_req`` write or add).  ``train_mode`` is
    accepted as the reference's is: the forward already ran in its
    mode."""
    heads = list(heads)
    outs, grads = _heads_and_grads(heads, head_grads)
    nodes, leaves = _walk(heads)
    leaves = [a for a in leaves if a._grad is not None
              and a._grad_req in ("write", "add")
              and a._data.requires_grad]
    if outs and leaves:
        got = torch.autograd.grad(outs, [a._data for a in leaves], grads,
                                  retain_graph=retain_graph,
                                  allow_unused=True)
        with torch.no_grad():
            for arr, g in zip(leaves, got):
                if g is None:
                    continue
                buf = arr._grad
                if arr._grad_req == "add":
                    buf._data = buf._data + g.to(buf._data.dtype)
                else:
                    buf._data = g.detach().to(buf._data.dtype)
    if not retain_graph:
        _free(nodes)


def grad_arrays(heads, variables, head_grads=None, retain_graph=False,
                create_graph=False):
    """The gradients of ``heads`` with respect to ``variables`` (marked
    NDArrays) as tensors, None where a variable is not reached; the grad
    buffers are left alone.  With ``create_graph`` the results carry
    history, so they can be differentiated again."""
    heads = list(heads)
    outs, grads = _heads_and_grads(heads, head_grads)
    nodes, _ = _walk(heads)
    tensors = [record_tensor(v) for v in variables]
    res = [None] * len(tensors)
    want = [i for i, t in enumerate(tensors) if t.requires_grad]
    if outs and want:
        got = torch.autograd.grad(outs, [tensors[i] for i in want], grads,
                                  retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
        for i, g in zip(want, got):
            res[i] = g
    if not retain_graph:
        _free(nodes)
    return res
