"""INT8 post-training quantization, the symbolic-era surface
(counterpart of ``mxnet_tpu.contrib.quantization``; reference
python/mxnet/contrib/quantization.py ``quantize_model``).

Quantized FullyConnected / Convolution nodes run as REAL int8: both
operands rounded onto the int8 grid, the product in int8 with exact
int32 accumulation (``ops.int8``), then rescaled to f32 (the
``_contrib_quantized_*`` ops).  Thresholds come from naive min/max or
KL-divergence (entropy) calibration.

The calibration core (``calib_thresholds``, ``_kl_threshold``) is numpy
on the host, a copy of the reference's, so both packages pick the same
thresholds from the same samples.  The deployment pipeline
(``mx.quantization``: calibrate -> export_quantized -> quantized
serving) reuses it.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["quantize_model", "calib_thresholds", "quantize", "dequantize",
           "QUANTIZABLE_OPS"]


def quantize(x, amax):
    """f32 -> the int8 grid, simulated in f32; symmetric per tensor."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    s = torch.tensor(127.0 / max(float(amax), 1e-12), dtype=torch.float32,
                     device=x.device)
    return torch.clamp(torch.round(x * s), -127, 127) / s


def dequantize(q, amax):
    return q  # simulated: the values are already on the f32 grid


# --------------------------------------------------------------- calibration

def _calib_fallback(reason):
    """Count a degenerate-histogram fallback to the naive amax
    (``quantization.calib_fallback[.<reason>]``)."""
    from .. import telemetry as _telemetry
    _telemetry.counter("quantization.calib_fallback").inc()
    _telemetry.counter("quantization.calib_fallback.%s" % reason).inc()


def _kl_threshold(hist, edges, num_quantized_bins=255):
    """KL-divergence threshold search (reference calibrate.cc, entropy
    mode): the clip range minimising KL(P||Q) between the histogram P and
    its int8-requantised image Q.  An all-zero or single-bin histogram
    has nothing to search: it returns the naive amax (``edges[-1]``) and
    counts ``quantization.calib_fallback``."""
    hist = hist.astype(_np.float64)
    if hist.sum() == 0:
        _calib_fallback("all_zero")
        return float(edges[-1])
    if (hist > 0).sum() <= 1:
        _calib_fallback("single_bin")
        return float(edges[-1])
    n = len(hist)
    best_kl, best_t = _np.inf, edges[-1]
    # candidate clip points from 1/8 of the range up
    for i in range(num_quantized_bins // 2, n + 1, max(1, n // 64)):
        p = hist[:i].copy()
        p[i - 1] += hist[i:].sum()  # the clipped mass joins the edge bin
        if p.sum() == 0:
            continue
        # quantise p into num_quantized_bins, then expand back
        factor = i / num_quantized_bins
        q = _np.zeros(i)
        for j in range(num_quantized_bins):
            lo = int(_np.floor(j * factor))
            hi = max(int(_np.floor((j + 1) * factor)), lo + 1)
            mass = hist[lo:min(hi, i)].sum()
            nz = (hist[lo:min(hi, i)] > 0).sum()
            if nz:
                q[lo:min(hi, i)] = _np.where(hist[lo:min(hi, i)] > 0,
                                             mass / nz, 0)
        p_n = p / p.sum()
        qs = q.sum()
        if qs == 0:
            continue
        q_n = q / qs
        mask = (p_n > 0) & (q_n > 0)
        kl = _np.sum(p_n[mask] * _np.log(p_n[mask] / q_n[mask]))
        if kl < best_kl:
            best_kl = kl
            best_t = edges[i] if i < len(edges) else edges[-1]
    return float(best_t)


def calib_thresholds(activations, mode="entropy", num_bins=4001):
    """Per-tensor ``|max|`` clip thresholds from collected activations:
    ``{name: samples}`` -> ``{name: float}``.  ``mode`` 'naive' (the
    observed max) or 'entropy' (KL, floored at the 99.99th percentile so
    no more than 0.01% of the observed mass is clipped)."""
    out = {}
    for name, arr in activations.items():
        a = _np.abs(_np.asarray(arr).ravel())
        # non-finite samples would break the histogram: drop them
        if a.size and not _np.isfinite(a).all():
            a = a[_np.isfinite(a)]
        if mode == "naive" or a.size == 0:
            out[name] = float(a.max()) if a.size else 1.0
            continue
        amax = float(a.max())
        if amax == 0:
            out[name] = 1.0
            continue
        hist, edges = _np.histogram(a, bins=num_bins, range=(0, amax))
        kl_t = _kl_threshold(hist, edges)
        floor = float(_np.percentile(a, 99.99))
        out[name] = max(kl_t, floor)
    return out


# ---------------------------------------------------------------- graph pass

QUANTIZABLE_OPS = {"FullyConnected", "Convolution"}

_QUANTIZED_OP = {"FullyConnected": "_contrib_quantized_fully_connected",
                 "Convolution": "_contrib_quantized_conv"}


def _input_key(x):
    return x.name if x.kind == "var" else "%s_output" % x.name


def _rewrite_nodes(sym, fn):
    """Bottom-up rebuild of the graph: ``fn(node, new_inputs)`` returns a
    replacement node or None (the node kept, over the rebuilt inputs).
    Shared subexpressions stay shared."""
    from ..symbol.symbol import Symbol, Group
    memo = {}

    def rebuild(node):
        if id(node) in memo:
            return memo[id(node)]
        if node.kind == "var":
            out = node
        else:
            new_inputs = [rebuild(x) if isinstance(x, Symbol) else x
                          for x in node.inputs]
            out = fn(node, new_inputs)
            if out is None:
                out = Symbol(node.kind, node.name, node.op,
                             dict(node.attrs), new_inputs, node.index)
                out._attr_map = dict(node._attr_map)
        memo[id(node)] = out
        return out

    heads = [rebuild(h) for h in sym._heads()]
    return heads[0] if len(heads) == 1 else Group(heads)


def _quantize_symbol(sym, thresholds, excluded_names):
    """Replace the quantizable ops by their REAL int8 versions (the
    quantize_graph_pass.cc analog): FullyConnected / Convolution become
    ``_contrib_quantized_*`` nodes carrying ``amax_data`` and
    ``amax_weight``.  A node whose weight has no threshold stays f32; a
    missing data threshold becomes ``amax_data=0``, the runtime range."""
    from ..symbol.symbol import Symbol

    def swap(node, new_inputs):
        if node.op not in _QUANTIZED_OP or node.name in excluded_names:
            return None
        keys = [_input_key(x) for x in new_inputs[:2]
                if isinstance(x, Symbol)]
        if len(keys) != 2 or not thresholds.get(keys[1]):
            return None
        attrs = dict(node.attrs)
        attrs["amax_data"] = float(thresholds.get(keys[0], 0.0))
        attrs["amax_weight"] = float(thresholds[keys[1]])
        out = Symbol(node.kind, node.name, _QUANTIZED_OP[node.op], attrs,
                     new_inputs, node.index)
        out._attr_map = dict(node._attr_map)
        return out

    return _rewrite_nodes(sym, swap)


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   ctx=None, excluded_sym_names=(), calib_mode="entropy",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", logger=None, **kwargs):
    """The reference's one-call PTQ entry point: collect the quantizable ops'
    input activations over ``calib_data`` (a DataIter), compute their
    thresholds, and return ``(quantized symbol, arg_params,
    aux_params)``.  With ``calib_mode='none'`` only the weights get
    thresholds (the activations take their runtime range).  The
    deployment pipeline is ``mx.quantization`` (``calibrate`` +
    ``export_quantized``)."""
    from ..symbol.symbol import _topo

    thresholds = {}
    for name, arr in arg_params.items():
        a = _np.abs(arr.asnumpy() if hasattr(arr, "asnumpy")
                    else _np.asarray(arr))
        thresholds[name] = float(a.max()) if a.size else 1.0

    if calib_mode != "none" and calib_data is not None:
        # tap every quantizable op's data input
        internals = sym.get_internals()
        want = []
        input_vars = []
        for node in _topo(sym):
            if node.kind == "op" and node.op in QUANTIZABLE_OPS:
                x = node.inputs[0]
                if hasattr(x, "kind"):
                    if x.kind != "var":
                        want.append("%s_output" % x.name)
                    else:
                        input_vars.append(x.name)
        want = sorted(set(want))
        input_vars = set(input_vars)
        taps = {}
        seen = 0
        mod_outputs = [internals[n] for n in want] if want else []
        if mod_outputs:
            from ..module import Module
            from ..symbol.symbol import Group
            mod = Module(Group(mod_outputs), data_names=data_names,
                         label_names=[], context=ctx)
            first = next(iter(calib_data))
            calib_data.reset()
            mod.bind([(n, tuple(d.shape)) for n, d in
                      zip(data_names, first.data)], for_training=False)
            mod.set_params(arg_params, aux_params, allow_missing=True)
            for batch in calib_data:
                mod.forward(batch, is_train=False)
                for name, out in zip(want, mod.get_outputs()):
                    taps.setdefault(name, []).append(out.asnumpy())
                for dname, d in zip(data_names, batch.data):
                    if dname in input_vars:
                        taps.setdefault(dname, []).append(d.asnumpy())
                seen += batch.data[0].shape[0]
                if num_calib_examples and seen >= num_calib_examples:
                    break
            calib_data.reset()
        elif input_vars:
            # quantizable ops fed by graph inputs alone: the batches are
            # the samples
            for batch in calib_data:
                for dname, d in zip(data_names, batch.data):
                    if dname in input_vars:
                        taps.setdefault(dname, []).append(d.asnumpy())
                seen += batch.data[0].shape[0]
                if num_calib_examples and seen >= num_calib_examples:
                    break
            calib_data.reset()
        acts = {k: _np.concatenate(v) for k, v in taps.items()}
        thresholds.update(calib_thresholds(acts, mode=calib_mode))

    qsym = _quantize_symbol(sym, thresholds, set(excluded_sym_names))
    return qsym, arg_params, aux_params


def _quantize_graph_pass(sym, thresholds=None, excluded_names=(), **_):
    """The ``QuantizeGraph`` graph pass (reference
    ``contrib/quantization.py:271``): ``_quantize_symbol`` with the
    pass's keyword arguments.  The pass registry it registers on
    (``symbol.subgraph``) is not ported yet, so it is called directly."""
    return _quantize_symbol(sym, thresholds or {}, set(excluded_names))
