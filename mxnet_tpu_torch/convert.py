"""Carry the reference package's weights into the port.

``params_from_reference`` takes the JAX parameter pytree as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``; tensors are taken as
they are) and returns a state dict
for the port's module (``TransformerLM.load_state_dict``), so both
packages compute from the same weights and their random generators never
have to agree.  ``params_to_reference`` is its inverse, so weights the
port has updated can be compared with the reference's.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["params_from_reference", "params_to_reference"]


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
