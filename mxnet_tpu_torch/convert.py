"""Carry the reference package's weights into the port.

``params_from_reference`` takes the JAX parameter pytree as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``; tensors are taken as
they are) and returns a state dict
for the port's module (``TransformerLM.load_state_dict``), so both
packages compute from the same weights and their random generators never
have to agree.  ``params_to_reference`` is its inverse, so weights the
port has updated can be compared with the reference's.

``gluon_params_from_reference`` does the same for a Gluon Block: the
reference Block's parameters (trainable and aux) as ``{name: numpy}``
go onto the port's Block, matched by name; ``gluon_params_to_reference``
gives them back under the reference's names.  Every family of the model
zoo builds the reference's names, shapes and order (the zoo tests hold
them), so these two carry any of them, and ``save_parameters`` files
carry them too.
``symbol_params_from_reference`` / ``symbol_params_to_reference`` carry
a symbolic Module's ``(arg_params, aux_params)`` across, as numpy.
"""
from __future__ import annotations

import os

import numpy as _np
import torch

__all__ = ["params_from_reference", "params_to_reference",
           "gluon_params_from_reference", "gluon_params_to_reference",
           "symbol_params_from_reference", "symbol_params_to_reference"]


def _tensor(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = _np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: widen exactly, then narrow exactly
        return torch.from_numpy(a.astype(_np.float32)).to(torch.bfloat16)
    return torch.from_numpy(_np.ascontiguousarray(a))


def params_from_reference(np_tree):
    """Nested ``{"embed", "pos_embed", "final_norm", "layers": {...}}``
    numpy tree -> flat ``{"embed": t, ..., "layers.wqkv": t, ...}`` CPU
    tensors, layouts unchanged."""
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, prefix + key + ".")
            else:
                out[prefix + key] = _tensor(val)

    walk(np_tree, "")
    return out


def params_to_reference(state_dict):
    """Flat ``{"embed": t, ..., "layers.wqkv": t, ...}`` tensors (a
    ``state_dict``) -> the nested numpy tree of the reference, layouts
    unchanged.  bf16 and f16 tensors come out as float32 (numpy has no
    bf16; the widening is exact)."""
    out = {}
    for name, t in state_dict.items():
        t = t.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.numpy()
    return out


def _top_prefix(names):
    """The longest common prefix of ``names`` that ends in ``_`` (the
    reference Block's own prefix, e.g. ``resnetv10_``)."""
    common = os.path.commonprefix(list(names))
    return common[:common.rfind("_") + 1]


def _own_prefix(block, names):
    """What to strip from ``block``'s own parameter names: its prefix, or
    where a name does not start with it (a Sequential whose children were
    made outside its ``name_scope``) the names' longest common prefix
    ending in ``_``."""
    if all(n.startswith(block.prefix) for n in names):
        return block.prefix
    return _top_prefix(names)


def gluon_params_from_reference(block, np_params, prefix=None):
    """Set ``block``'s Parameters from the reference Block's
    ``{name: array}`` (``{n: p.data().asnumpy() for n, p in
    ref.collect_params().items()}``).

    The two packages count Block prefixes separately (``resnetv10_`` here,
    ``resnetv11_`` there), so names are matched after stripping each
    net's own top prefix: the port Block's ``prefix`` (or its names'
    longest common prefix ending in ``_`` where they do not start with
    it) and, for the reference's names, ``prefix`` or else their longest
    common prefix ending in ``_``.  A name or shape that does not pair up raises
    ``ValueError``.  Values keep each Parameter's dtype and device; a
    deferred Parameter keeps its value for its first forward."""
    ref_prefix = _top_prefix(np_params) if prefix is None else prefix
    params = block.collect_params()
    own = _own_prefix(block, list(params.keys()))
    ours = {n[len(own):]: p for n, p in params.items()}
    theirs = {n[len(ref_prefix):]: v for n, v in np_params.items()}
    if set(ours) != set(theirs):
        raise ValueError(
            "parameter names do not pair up: only in the port %s, only in "
            "the reference %s" % (sorted(set(ours) - set(theirs))[:8],
                                  sorted(set(theirs) - set(ours))[:8]))
    for name, p in ours.items():
        val = _tensor(theirs[name])
        if p.shape is not None and (len(p.shape) != val.dim() or any(
                s not in (0, v) for s, v in zip(p.shape, val.shape))):
            raise ValueError("shape of %s: port %s, reference %s"
                             % (name, p.shape, tuple(val.shape)))
        p.set_data(val)


def gluon_params_to_reference(block, prefix):
    """``block``'s Parameters as ``{reference name: numpy}``: the port
    Block's own top prefix (see :func:`gluon_params_from_reference`)
    replaced by the reference's ``prefix``, as copies; bf16 and f16
    values widen to float32."""
    out = {}
    params = block.collect_params()
    own = _own_prefix(block, list(params.keys()))
    for name, p in params.items():
        t = p.data()._data.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        # a copy: on the CPU ``numpy()`` shares the Parameter's storage,
        # which its optimizer updates in place
        out[prefix + name[len(own):]] = t.numpy().copy()
    return out


def _numpy_copy(v):
    t = getattr(v, "_data", v)
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        t = t.numpy()
    return _np.array(t, copy=True)


def symbol_params_from_reference(arg_params, aux_params, ctx=None):
    """The reference Module's ``(arg_params, aux_params)`` (NDArrays or
    numpy, ``{n: v.asnumpy()}``) as the port's NDArrays on ``ctx``
    (copies), ready for ``Module.init_params`` / ``set_params``."""
    from .ndarray.ndarray import array
    return ({n: array(_np.asarray(v), ctx=ctx)
             for n, v in arg_params.items()},
            {n: array(_np.asarray(v), ctx=ctx)
             for n, v in aux_params.items()})


def symbol_params_to_reference(arg_params, aux_params):
    """The port's ``(arg_params, aux_params)`` as ``{name: numpy}`` dicts:
    copies, not views (a view of a CPU tensor would follow the in-place
    updates of a later step); bf16 and f16 widen to float32."""
    return ({n: _numpy_copy(v) for n, v in arg_params.items()},
            {n: _numpy_copy(v) for n, v in aux_params.items()})
