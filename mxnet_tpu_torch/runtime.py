"""``mx.runtime`` — runtime feature introspection and layer-stack tuning
(counterpart of ``mxnet_tpu.runtime``).

``Features`` / ``feature_list`` / ``is_enabled`` report what this build
can do, detected when asked: a CUDA device (``GPU``, ``CUDA``), cuDNN,
and the native record reader.  ``PALLAS`` is False: the port's kernels
are CUDA C++ (``ops/cuda_kernels.py``), not Pallas.  The names are the
reference's, so a script that asks for one gets an answer from either
package.

``scan_stack`` runs a layer body over stacked layer weights under the
knobs ``runtime.stack_mode`` and ``runtime.remat``.  PyTorch runs
eagerly, so ``'scan'`` and ``'unroll'`` run the same Python loop over
the layers: the knob is validated and kept (scripts set it, and
``stack_candidates`` is the reference's grid), but it changes nothing.
``runtime.remat`` wraps each layer in a checkpoint (``checkpoint_policy``).
While both knobs sit at their defaults, ``stack_tuning`` applies the
measured pick of ``autotune.search_stack`` (``autotune.stack_pick``), as
the reference does; an explicit knob always wins.
"""
from __future__ import annotations

import functools
from collections import namedtuple

import torch

from . import config as _config

__all__ = ["Feature", "Features", "feature_list", "is_enabled",
           "scan_stack", "stack_tuning", "stack_candidates",
           "checkpoint_policy"]

Feature = namedtuple("Feature", ["name", "enabled"])


def _have(mod):
    try:
        __import__(mod)
        return True
    except Exception:
        return False


def _detect():
    cuda = torch.cuda.is_available()
    return {
        "TPU": False,
        "CPU": True,
        "GPU": cuda,
        "PALLAS": False,
        "DIST_KVSTORE": True,         # dist_* over torch.distributed
        "INT64_TENSOR_SIZE": True,
        "SIGNAL_HANDLER": True,
        "OPENCV": False,
        "PIL": _have("PIL"),
        "BLAS_OPEN": False,
        "MKLDNN": False,
        "CUDA": cuda,
        "CUDNN": bool(torch.backends.cudnn.is_available()),
        "NATIVE_IO": _native_io_available(),
    }


def _native_io_available():
    """Whether a native (C++) record reader is loaded.  The port reads
    record files in Python (``io.py``) and builds no native library, so
    this is False until the data-pipeline slice brings one."""
    return False


class Features(dict):
    """Mapping name -> Feature (the reference's ``Features`` API)."""

    def __init__(self):
        super().__init__([(k, Feature(k, v)) for k, v in _detect().items()])

    def __repr__(self):
        return "[%s]" % ", ".join(
            "✔ %s" % k if v.enabled else "✖ %s" % k
            for k, v in sorted(self.items()))

    def is_enabled(self, feature_name):
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError("Feature %r does not exist" % (feature_name,))
        return self[feature_name].enabled


def feature_list():
    return list(Features().values())


def is_enabled(feature_name):
    return Features().is_enabled(feature_name)


# --------------------------------------------------------- program tuning
_MODES = ("scan", "unroll")
_REMATS = ("", "dots", "full")


def stack_candidates():
    """The (mode, remat) grid of the reference's stack tuning: every
    legal pair of the two knobs, 'unroll' with remat off only."""
    return (("scan", ""), ("scan", "dots"), ("scan", "full"),
            ("unroll", ""))


def stack_tuning():
    """The active ``(mode, remat)`` pair: the measured pick
    (``autotune.stack_pick``) while both knobs ``runtime.stack_mode`` and
    ``runtime.remat`` sit at their defaults, else the knobs; a bad value
    (from the environment: ``set`` refuses one) raises ValueError."""
    from . import autotune as _autotune
    pick = _autotune.stack_pick()
    if pick is not None:
        return pick
    mode = str(_config.get("runtime.stack_mode")).strip().lower()
    remat = str(_config.get("runtime.remat")).strip().lower()
    if mode not in _MODES:
        raise ValueError("runtime.stack_mode must be 'scan' or 'unroll', "
                         "got %r" % (mode,))
    if remat not in _REMATS:
        raise ValueError("runtime.remat must be '', 'dots' or 'full', "
                         "got %r" % (remat,))
    return mode, remat


_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_policy(name):
    """A remat name as a wrapper of a layer body ``fn(carry, x)``: ''
    -> None (no wrapper); 'full' -> ``torch.utils.checkpoint.checkpoint``
    (only the layer input is saved); 'dots' -> the same under a
    selective-checkpoint context that saves the matrix products' outputs
    (``aten.mm``/``bmm``/``addmm``) and recomputes the rest (the
    reference's ``dots_saveable``)."""
    if name not in _REMATS:
        raise ValueError("runtime.remat must be '', 'dots' or 'full', "
                         "got %r" % (name,))
    if not name:
        return None
    from torch.utils import checkpoint as _ckpt
    kwargs = {"use_reentrant": False}
    if name == "dots":
        kwargs["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_products)

    def wrap(body):
        @functools.wraps(body)
        def wrapped(carry, x):
            return _ckpt.checkpoint(body, carry, x, **kwargs)
        return wrapped
    return wrap


def scan_stack(body, carry, xs):
    """Run ``carry, y = body(carry, x)`` over the leading axis of ``xs``
    (a dict of tensors stacked over layers; ``x`` is its i-th slice) and
    return ``(carry, ys)``: the ``y``s stacked over layers, or None when
    ``body`` returns None.  ``runtime.remat`` wraps ``body`` as
    :func:`checkpoint_policy` says, and only where autograd records.
    ``runtime.stack_mode`` is validated; both modes run this loop."""
    _, remat = stack_tuning()
    wrap = checkpoint_policy(remat)
    if wrap is not None and torch.is_grad_enabled():
        body = wrap(body)
    n = next(iter(xs.values())).shape[0]
    ys = []
    for i in range(n):
        carry, y = body(carry, {k: v[i] for k, v in xs.items()})
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, torch.stack(ys)
