"""``mx.quantization`` — int8 post-training quantization over the
one-shot deploy path (counterpart of ``mxnet_tpu.quantization``), and the
per-row int8 KV-page quantiser of the generation path.

  calibrate(block, batches)          # per-site activation thresholds
      -> Calibration                 #   (naive |max| or entropy KL)
  export_quantized(block, prefix,    # the graph, int8 weight payloads +
                   calibration)      #   per-channel scales (format v3)
  deploy.load_model(prefix, quantized=True)
  serving.Server.register(name, prefix, quantized=True)

* **Calibration** — representative batches run through the Block
  eagerly while the ``FullyConnected`` / ``Convolution`` registry ops are
  swapped for a RECORDING shim: each call site gets a name by execution
  order (``FullyConnected_0``, ``Convolution_1``, ...; one counter for
  both ops, as the reference), and its input's ``|x|`` samples (a strided
  subsample past ``_MAX_SAMPLES_PER_BATCH``, the reference's sampler) feed
  ``contrib.quantization.calib_thresholds``.  Host-side numpy, so the
  same samples give the reference's thresholds bit for bit.
* **Recoloring** — a site that is not excluded (by name or op type) runs
  int8: data per tensor at its calibrated amax, weights per OUTPUT
  channel, the product through ``ops.int8`` (``torch._int_mm`` on the
  card, exact int32 ``torch.mm`` on the CPU), then the f32 epilogue
  ``acc / (sx * sw)`` and the bias.  During ``calibrate`` and the
  guardrail the registry ops are swapped under a process lock (host-side
  steps, one at a time).  A loaded artifact is recolored ONCE, at load:
  the predictor's program replaces its own site nodes, so an int8 and an
  f32 model can share one server.
* **Guardrail** — ``export_quantized`` measures the recolored Block
  against f32 over the calibration batches (worst relative L2) and
  refuses to write anything past ``quant.error_budget``
  (:class:`QuantizationError`).
* **Format v3** — ``<prefix>-params.npz`` holds the quantized weights as
  int8 payloads with ``<name>::scale`` per-channel f32 scales; the
  manifest, the measured error and the excluded sites ride in
  ``<prefix>-meta.json``.  At load the int8 grid is re-derived from the
  dequantized view ``q * scale`` exactly as the reference's program does
  (``round`` snaps it back), so the int8 codes are the shipped ones.

Op order follows the reference for bitwise int8 codes: ``s = 127 /
max(amax, 1e-12)`` (a division between tensors: the card divides by a
Python scalar as a product with its reciprocal), then ``round(x * s)``
(half to even) and ``clip(-127, 127)``.

* **Stats twin** — the drift probe's program.  ``export_quantized``
  names the int8 sites in ``stats_sites`` (graph order) and writes
  ``<prefix>-stats.json`` (:data:`STATS_TWIN_FORMAT`): the port's
  counterpart of the reference's ``<prefix>-stats.stablehlo``.  It names
  the sites; :func:`stats_twin` builds, from the artifact's own graph,
  the float graph up to each site's input (its heads are the sites' data
  inputs, the ops f32 over the dequantized weights) and returns each
  input's runtime ``|max|``.  ``serving.Server`` runs it on every
  ``quant.drift_every``-th quantized dispatch and feeds
  ``numerics.update_quant_drift``.  An artifact with no twin file serves
  without sampling.

Knobs: ``quant.calib_mode``, ``quant.calib_bins``, ``quant.error_budget``.
"""
from __future__ import annotations

import json
import threading

import numpy as _np
import torch

from . import config as _config
from . import telemetry as _telemetry
from .ops.contrib import _f32, data_scale, quant_scale, to_int8

__all__ = ["Calibration", "QuantizationError", "calibrate",
           "export_quantized", "quantized_error", "load_quantized",
           "quantize_rows", "dequantize_rows", "quantize_weight_host",
           "stats_twin", "STATS_TWIN_FORMAT", "QUANTIZABLE_OPS",
           "SCALE_SUFFIX"]

#: op types the recolor transform understands
QUANTIZABLE_OPS = ("FullyConnected", "Convolution")

#: npz/meta key suffix of a quantized weight's per-channel scales
SCALE_SUFFIX = "::scale"

#: the ``format`` of a ``<prefix>-stats.json`` stats twin
STATS_TWIN_FORMAT = "mxnet_tpu_torch.stats_twin/1"

#: per-site cap on the |activation| samples kept a calibration batch (a
#: strided subsample, not a truncation)
_MAX_SAMPLES_PER_BATCH = 1 << 16

# the registry patch swaps shared Operator.fn slots: one transform at a
# time, process-wide (calibration and the guardrail are host-side steps)
_PATCH_LOCK = threading.RLock()


class QuantizationError(RuntimeError):
    """The quantize transform refuses: the quantized outputs diverged from
    f32 past the error budget, or the manifest does not fit the model."""


# ------------------------------------------------------------ KV pages

def quantize_rows(x):
    """Symmetric per-row int8 over the last axis: returns
    ``(q int8, scale f32 without the last axis)`` with
    ``q.float() * scale[..., None] ~= x``.  Scale is ``amax / 127`` so the
    dequantisation inside the paged kernel is a single multiply.  Both
    packages divide in f32 and round half to even, so the rows and scales
    are bitwise the reference's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_rows`: ``q int8 * scale -> dtype``."""
    return (q.float() * scale[..., None]).to(dtype)


# ------------------------------------------------------------ int8 helpers

def _to_int8_per_channel(w):
    """Symmetric per-OUTPUT-channel (axis 0) int8: ``(q int8, scale f32
    with singleton non-channel dims)``."""
    axes = tuple(range(1, w.dim()))
    amax = w.abs().amax(dim=axes, keepdim=True) if axes else w.abs()
    s = quant_scale(amax)
    return to_int8(w, s), s


def quantize_weight_host(w):
    """Host-side per-channel weight quantization for the v3 artifact:
    ``(q int8 ndarray, scale f32 ndarray)`` with ``q * scale ~= w`` (the
    scale keeps singleton non-channel dims).  numpy, the reference's."""
    w = _np.asarray(w, _np.float32)
    axes = tuple(range(1, w.ndim))
    amax = _np.max(_np.abs(w), axis=axes, keepdims=True) if axes \
        else _np.abs(w)
    scale = _np.maximum(amax, 1e-12) / 127.0
    q = _np.clip(_np.round(w / scale), -127, 127).astype(_np.int8)
    return q, scale.astype(_np.float32)


def _fc_int8(data, wq, sw, sx, bias=None, no_bias=False, flatten=True):
    """The int8 FullyConnected at data scale ``sx`` (None: from the
    tensor's range) over the prepared weight grid."""
    from .ops.int8 import int8_matmul
    x = data.reshape(data.shape[0], -1) if flatten else data
    if sx is None:
        sx = data_scale(x, 0.0)
    xq = to_int8(x, sx)
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), wq)
    acc = acc.reshape(tuple(xq.shape[:-1]) + (wq.shape[0],))
    # sw is [O, 1]; the output's channel is the last axis
    out = acc.to(torch.float32) / (sx * sw[:, 0])
    if bias is not None and not no_bias:
        out = out + bias
    return out


def _conv_int8(data, wq, sw, sx, bias=None, stride=None, dilate=None,
               pad=None, num_group=1, no_bias=False):
    """The int8 Convolution (N-C-first) at data scale ``sx`` (None: from
    the tensor's range) over the prepared weight grid."""
    from .ops.int8 import int8_conv
    ndim = data.dim() - 2
    if sx is None:
        sx = data_scale(data, 0.0)
    xq = to_int8(data, sx)
    acc = int8_conv(xq, wq, stride, pad if pad is not None else 0, dilate,
                    int(num_group))
    # sw is [O, 1, ..., 1]; the output's channel is axis 1
    out = acc.to(torch.float32) / (sx * sw.reshape((1, -1) + (1,) * ndim))
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * ndim)
    return out


# --------------------------------------------------------- recolored ops

def _q_fully_connected(data, weight, bias=None, amax_data=0.0,
                       num_hidden=None, no_bias=False, flatten=True, **_):
    """int8 FullyConnected: per-tensor data scale (a calibrated amax; <= 0
    takes the runtime range), per-channel weight scales, exact int32
    product, f32 epilogue."""
    wq, sw = _to_int8_per_channel(weight)
    x = data.reshape(data.shape[0], -1) if flatten else data
    return _fc_int8(data, wq, sw, data_scale(x, amax_data), bias, no_bias,
                    flatten)


def _q_convolution(data, weight, bias=None, amax_data=0.0, kernel=None,
                   stride=None, dilate=None, pad=None, num_filter=None,
                   num_group=1, no_bias=False, layout=None, **_):
    """int8 Convolution (N-C-first) with exact int32 accumulation and
    per-channel weight scales."""
    wq, sw = _to_int8_per_channel(weight)
    return _conv_int8(data, wq, sw, data_scale(data, amax_data), bias,
                      stride, dilate, pad, num_group, no_bias)


_RECOLOR_FN = {"FullyConnected": _q_fully_connected,
               "Convolution": _q_convolution}


class _RecoloredSite:
    """One site of a loaded int8 artifact, prepared once at load: the
    int8 weight grid and its per-channel scales (from the weight as the
    program sees it) and the data scale at the calibrated amax (None for
    a non-positive amax: the runtime range).  Called as the op it
    replaces (its weight input is ignored)."""

    __slots__ = ("name", "op", "wq", "sw", "sx")

    def __init__(self, name, op, weight, amax):
        self.name = name
        self.op = op
        self.wq, self.sw = _to_int8_per_channel(weight.to(torch.float32))
        self.sx = quant_scale(_f32(amax, weight)) if amax > 0 else None

    def __call__(self, data, weight=None, bias=None, num_hidden=None,
                 no_bias=False, flatten=True, kernel=None, stride=None,
                 dilate=None, pad=None, num_filter=None, num_group=1,
                 layout=None, **_):
        if self.op == "FullyConnected":
            return _fc_int8(data, self.wq, self.sw, self.sx, bias, no_bias,
                            flatten)
        return _conv_int8(data, self.wq, self.sw, self.sx, bias, stride,
                          dilate, pad, num_group, no_bias)


# ---------------------------------------------------------- op patching

class _SitePlan:
    """Shared state of one calibration or recolor pass: the execution-order
    site counter and the per-site records."""

    def __init__(self):
        self.index = 0
        self.records = []        # calibration: one dict a call
        self.sites_hit = []      # recolor: the sites that ran int8

    def begin_forward(self):
        self.index = 0

    def next_site(self, op):
        name = "%s_%d" % (op, self.index)
        self.index += 1
        return name


class _patched_ops:
    """Swap the FullyConnected / Convolution registry ``Operator.fn``
    slots for ``make_wrapper(op_name, orig_fn)`` shims (aliases share the
    Operator, so one swap covers every route), under a process lock."""

    def __init__(self, plan, make_wrapper):
        self._plan = plan
        self._make = make_wrapper
        self._saved = {}

    def __enter__(self):
        from .ops import registry as _registry
        _PATCH_LOCK.acquire()
        try:
            for op_name in QUANTIZABLE_OPS:
                op = _registry.get(op_name)
                self._saved[op_name] = (op, op.fn)
                op.fn = self._make(op_name, op.fn)
        except BaseException:
            self._restore()
            _PATCH_LOCK.release()
            raise
        return self._plan

    def __exit__(self, *exc):
        self._restore()
        _PATCH_LOCK.release()
        return False

    def _restore(self):
        for op, fn in self._saved.values():
            op.fn = fn
        self._saved.clear()


def _recording_patch(plan, weight_names):
    """Calibration shims: run the f32 op, and record the site's input
    ``|x|`` samples and the parameter that fed its weight."""

    def make(op_name, orig_fn):
        def recorded(data, weight, *args, **attrs):
            site = plan.next_site(op_name)
            flat = data.detach().abs().reshape(-1)
            if flat.numel() > _MAX_SAMPLES_PER_BATCH:
                flat = flat[::flat.numel() // _MAX_SAMPLES_PER_BATCH + 1]
            plan.records.append({
                "site": site, "op": op_name,
                "weight": weight_names.get(_tensor_key(weight)),
                "samples": flat.cpu().numpy(),
            })
            return orig_fn(data, weight, *args, **attrs)
        return recorded

    return make


def _recolor_patch(plan, thresholds, excluded):
    """Recolor shims: a site not excluded (by name or op type) that has a
    threshold runs int8 at its calibrated amax; the others run f32."""

    def make(op_name, orig_fn):
        qfn = _RECOLOR_FN[op_name]

        def recolored(data, weight, *args, **attrs):
            site = plan.next_site(op_name)
            if site in excluded or op_name in excluded \
                    or site not in thresholds:
                return orig_fn(data, weight, *args, **attrs)
            plan.sites_hit.append(site)
            attrs.pop("amax_data", None)
            return qfn(data, weight, *args,
                       amax_data=float(thresholds[site]), **attrs)
        return recolored

    return make


def _tensor_key(t):
    """A parameter tensor's identity across the registry's detached
    views: its storage address, shape and strides."""
    return (t.data_ptr(), tuple(t.shape), tuple(t.stride()))


# ------------------------------------------------------------ calibration

class Calibration:
    """The calibration manifest: per-site activation thresholds, the site
    -> weight-parameter map and provenance (mode, batch and sample
    counts).  ``to_dict`` / ``from_dict`` round-trip it through JSON (the
    v3 artifact embeds it); ``save`` / ``load`` write it alone.  The
    batches are kept for the guardrail and not serialized."""

    def __init__(self, mode, thresholds, sites, num_batches, num_samples,
                 batches=None):
        self.mode = mode
        self.thresholds = dict(thresholds)    # site -> activation amax
        self.sites = list(sites)              # [{name, op, weight}]
        self.num_batches = int(num_batches)
        self.num_samples = int(num_samples)
        self.batches = list(batches) if batches is not None else []

    def to_dict(self):
        return {"mode": self.mode,
                "thresholds": {k: float(v)
                               for k, v in self.thresholds.items()},
                "sites": self.sites,
                "num_batches": self.num_batches,
                "num_samples": self.num_samples}

    @classmethod
    def from_dict(cls, d):
        return cls(d.get("mode", "naive"), d.get("thresholds", {}),
                   d.get("sites", []), d.get("num_batches", 0),
                   d.get("num_samples", 0))

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        return path

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def __repr__(self):
        return ("Calibration(mode=%r, sites=%d, batches=%d, samples=%d)"
                % (self.mode, len(self.sites), self.num_batches,
                   self.num_samples))


def _as_host_batches(batches):
    """A DataIter, an iterable of arrays or one array -> host arrays."""
    from .deploy import _host_array
    from .ndarray.ndarray import NDArray
    from .io import DataIter
    out = []
    if isinstance(batches, DataIter):
        batches.reset()
        for b in batches:
            out.append(_host_array(b.data[0]))
        batches.reset()
        return out
    if isinstance(batches, (_np.ndarray, NDArray, torch.Tensor)):
        batches = [batches]
    return [_host_array(b) for b in batches]


def _block_device(block):
    """The device of the Block's initialized parameters (else the current
    context's)."""
    from .context import resolve_device
    for p in block.collect_params().values():
        if getattr(p, "_data", None) is not None:
            return p._data._data.device
    return resolve_device(None)


def _forward(block, batch, device):
    """One eager inference forward of a host batch on ``device``."""
    from .ndarray.ndarray import array
    from . import autograd
    with torch.no_grad(), autograd.predict_mode():
        return block(array(batch, ctx=device, dtype=batch.dtype))


def calibrate(block, batches, mode=None, bins=None):
    """Run representative ``batches`` through ``block`` and return the
    :class:`Calibration` manifest of per-site activation thresholds.

    ``batches``: a DataIter, an iterable of input arrays, or one array.
    ``mode``: 'naive' (observed |max|) or 'entropy' (the KL threshold
    search) — default the ``quant.calib_mode`` knob.  The thresholds go
    out as ``quantization.amax.<site>`` gauges; ``quantization.
    calib_batches`` / ``calib_tensors`` count the work."""
    from .contrib.quantization import calib_thresholds
    from .parallel.functional import functionalize

    if mode is None:
        mode = _config.get("quant.calib_mode")
    mode = str(mode).strip().lower()
    if mode not in ("naive", "entropy"):
        raise ValueError("calibration mode must be 'naive' or 'entropy', "
                         "got %r" % (mode,))
    if bins is None:
        bins = _config.get("quant.calib_bins")
    host_batches = _as_host_batches(batches)
    if not host_batches:
        raise ValueError("calibrate() needs at least one batch")

    # resolve deferred shapes outside the patch (a lazy initialization
    # must not consume site indices)
    device = _block_device(block)
    _forward(block, host_batches[0], device)
    device = _block_device(block)
    fn = functionalize(block)
    weight_names = {_tensor_key(v): n for n, v in fn.init_values().items()}

    plan = _SitePlan()
    acts = {}      # site -> [sample arrays]
    sites = {}     # site -> {name, op, weight}
    n_samples = 0
    with _patched_ops(plan, _recording_patch(plan, weight_names)):
        for b in host_batches:
            plan.begin_forward()
            plan.records = []
            _forward(block, b, device)
            for rec in plan.records:
                acts.setdefault(rec["site"], []).append(rec["samples"])
                sites.setdefault(rec["site"], {
                    "name": rec["site"], "op": rec["op"],
                    "weight": rec["weight"]})
                n_samples += rec["samples"].size
            _telemetry.counter("quantization.calib_batches").inc()
    if not sites:
        raise QuantizationError(
            "no quantizable op (%s) executed in the block's forward — "
            "nothing to calibrate" % (", ".join(QUANTIZABLE_OPS),))
    merged = {k: _np.concatenate(v) for k, v in acts.items()}
    thresholds = calib_thresholds(merged, mode=mode, num_bins=int(bins))
    for site, amax in thresholds.items():
        _telemetry.gauge("quantization.amax.%s" % site).set(float(amax))
    _telemetry.counter("quantization.calib_tensors").inc(len(thresholds))
    return Calibration(mode, thresholds,
                       [sites[k] for k in sorted(sites)],
                       len(host_batches), n_samples, batches=host_batches)


# --------------------------------------------------------- the transform

def _host(out):
    """A forward's (first) output on the host."""
    from .deploy import _host_array
    return _host_array(out[0] if isinstance(out, (list, tuple)) else out)


def quantized_error(block, calibration, excluded=(), batches=None):
    """Relative error of the recolored Block against f32 over the
    calibration batches: ``max_b ||q_b - f_b|| / ||f_b||`` (the number
    the export guardrail holds to ``quant.error_budget``)."""
    batches = calibration.batches if batches is None \
        else _as_host_batches(batches)
    if not batches:
        raise ValueError("no batches to evaluate: pass batches= or use a "
                         "Calibration produced by calibrate() in-process")
    device = _block_device(block)
    _forward(block, batches[0], device)
    device = _block_device(block)
    excluded = frozenset(excluded)
    fp32 = [_host(_forward(block, b, device)) for b in batches]
    worst = 0.0
    plan = _SitePlan()
    with _patched_ops(plan, _recolor_patch(plan, calibration.thresholds,
                                           excluded)):
        for b, f in zip(batches, fp32):
            plan.begin_forward()
            q = _host(_forward(block, b, device))
            denom = max(float(_np.linalg.norm(f)), 1e-12)
            worst = max(worst, float(_np.linalg.norm(q - f)) / denom)
    return worst


def graph_sites(graph):
    """The quantizable op nodes of a graph in evaluation order, named as
    the calibration names them: ``[(site name, node, weight var name)]``
    (the weight is None when it is not a graph variable)."""
    from .ops import registry as _registry
    from .symbol.symbol import _topo
    out = []
    index = 0
    for node in _topo(graph):
        if node.kind != "op":
            continue
        try:
            op = _registry.get(node.op).name
        except AttributeError:
            continue
        if op not in QUANTIZABLE_OPS:
            continue
        w = node.inputs[1] if len(node.inputs) > 1 else None
        wname = w.name if getattr(w, "kind", None) == "var" else None
        out.append(("%s_%d" % (op, index), node, wname))
        index += 1
    return out


def check_sites(graph, sites):
    """Refuse a manifest whose site -> weight map disagrees with the
    graph's evaluation order (a site would recolor the wrong op)."""
    by_name = {name: wname for name, _, wname in graph_sites(graph)}
    for s in sites:
        name, w = s.get("name"), s.get("weight")
        if name not in by_name:
            raise QuantizationError(
                "calibration site %r has no quantizable op in the graph "
                "(the graph has %d sites)" % (name, len(by_name)))
        if w is not None and by_name[name] != w:
            raise QuantizationError(
                "calibration site %r reads weight %r but the graph's %s "
                "reads %r: the graph's evaluation order differs from the "
                "calibrated forward's" % (name, w, name, by_name[name]))


def recolor_sites(graph, params, meta):
    """The int8 sites of a loaded v3 artifact, prepared once: ``{id(node):
    _RecoloredSite}`` for every site that is not excluded and has a
    threshold.  ``params`` maps names to the program's tensors (the
    quantized weights already as their dequantized views)."""
    cal = meta.get("calibration") or {}
    thresholds = cal.get("thresholds") or {}
    excluded = frozenset(meta.get("excluded") or ())
    check_sites(graph, cal.get("sites") or ())
    out = {}
    for name, node, wname in graph_sites(graph):
        op = name.rsplit("_", 1)[0]
        if name in excluded or op in excluded or name not in thresholds:
            continue
        if wname is None or wname not in params:
            raise QuantizationError(
                "site %s: its weight is not a parameter of the artifact"
                % (name,))
        out[id(node)] = _RecoloredSite(name, op, params[wname],
                                       float(thresholds[name]))
    return out


def export_quantized(block, prefix, calibration, excluded=(),
                     error_budget=None, dynamic_batch=True):
    """Quantize ``block`` under ``calibration`` and write a deploy FORMAT
    V3 artifact: the graph, the quantized weights as int8 payloads with
    ``<name>::scale`` companions, the manifest in the meta.  ``excluded``
    skips sites by name (``"Convolution_0"``) or op type
    (``"Convolution"``).

    The guardrail runs FIRST: if the recolored Block's relative error on
    the calibration batches exceeds ``error_budget`` (default the
    ``quant.error_budget`` knob), nothing is written and
    :class:`QuantizationError` is raised.  Returns the written paths."""
    from . import deploy as _deploy
    from .parallel.functional import functionalize

    if error_budget is None:
        error_budget = _config.get("quant.error_budget")
    error_budget = float(error_budget)
    excluded = frozenset(excluded)
    if not calibration.batches:
        raise QuantizationError(
            "calibration manifest carries no batches for the accuracy "
            "guardrail; produce it with calibrate() in-process")
    measured = quantized_error(block, calibration, excluded=excluded)
    if measured > error_budget:
        _telemetry.counter("quantization.guardrail_rejects").inc()
        raise QuantizationError(
            "quantized outputs diverged from fp32 by %.4f relative error "
            "on the calibration set, past the %.4f budget "
            "(quant.error_budget); refusing to emit. Raise the budget, "
            "exclude sensitive sites (excluded=...), or recalibrate with "
            "mode='entropy'." % (measured, error_budget))

    data0 = calibration.batches[0]
    device = _block_device(block)
    out0 = _forward(block, data0, device)
    fn = functionalize(block)
    names = list(fn.params)
    values = {n: v.detach().cpu().numpy()
              for n, v in fn.init_values().items()}
    graph, input_name = _deploy._trace(block)
    check_sites(graph, calibration.sites)

    # the site -> weight map decides which params ship as int8 payloads
    qweights = {}
    for site in calibration.sites:
        wname = site.get("weight")
        if wname is None or wname in qweights:
            continue
        if site["name"] in excluded or site["op"] in excluded:
            continue
        qweights[wname] = quantize_weight_host(values[wname])
    qnames = [n for n in names if n in qweights]
    scale_names = [n + SCALE_SUFFIX for n in qnames]
    arrays = {n: qweights[n][0] if n in qweights else values[n]
              for n in names}
    arrays.update({n + SCALE_SUFFIX: qweights[n][1] for n in qnames})

    out = _host(out0)
    dynamic = bool(dynamic_batch) and _deploy._batch_free(
        graph, input_name, data0.shape, out.shape)
    meta = _deploy._oneshot_meta(input_name, data0, out, dynamic,
                                 _deploy.QUANTIZED_FORMAT_VERSION)
    meta.update({
        "param_names": names + scale_names,
        "quantized": True,
        "quantized_params": qnames,
        "stats_sites": [name for name, _ in _twin_sites(
            graph, {"excluded": sorted(excluded),
                    "calibration": calibration.to_dict()})],
        "excluded": sorted(excluded),
        "measured_error": round(measured, 6),
        "error_budget": error_budget,
        "calibration": calibration.to_dict(),
    })
    paths = _deploy._write_oneshot(prefix, graph, meta, arrays)
    if meta["stats_sites"]:
        from .resilience import atomic_write
        stats_path = prefix + "-stats.json"
        with atomic_write(stats_path, "w") as f:
            json.dump({"format": STATS_TWIN_FORMAT,
                       "sites": meta["stats_sites"]}, f, indent=1)
        paths = list(paths) + [stats_path]
    _telemetry.counter("quantization.exports").inc()
    return paths


def _twin_sites(graph, meta):
    """The int8 sites of an artifact in graph order: ``[(name, node)]``
    for every site that is not excluded and has a threshold."""
    cal = meta.get("calibration") or {}
    thresholds = cal.get("thresholds") or {}
    excluded = frozenset(meta.get("excluded") or ())
    return [(name, node) for name, node, _ in graph_sites(graph)
            if name not in excluded and name.rsplit("_", 1)[0]
            not in excluded and name in thresholds]


def stats_twin(prefix, graph, meta):
    """The stats twin of a loaded v3 artifact, or None when the artifact
    ships none (``<prefix>-stats.json`` absent, or naming no site).
    Returns ``(sites, fn)``: ``fn(env) -> [S] f32`` evaluates the float
    graph up to each site's data input (``env`` maps the graph's
    variables, the input among them, to tensors: the predictor's
    dequantized params) and returns each input's ``|max|``, in
    ``sites`` order."""
    import os
    from .symbol.symbol import Group, _eval_symbol
    path = prefix + "-stats.json"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        twin = json.load(f)
    if twin.get("format") != STATS_TWIN_FORMAT:
        raise QuantizationError("%s: not a stats twin (format %r)"
                                % (path, twin.get("format")))
    by_name = dict(_twin_sites(graph, meta))
    sites = list(twin.get("sites") or ())
    missing = [s for s in sites if s not in by_name]
    if missing:
        raise QuantizationError("%s names sites the graph does not run "
                                "int8: %s" % (path, missing))
    if not sites:
        return None
    heads = Group([by_name[s].inputs[0] for s in sites])

    def fn(env):
        outs = _eval_symbol(heads, env, False)
        return torch.stack([o.float().abs().amax() for o in outs])
    return sites, fn


def load_quantized(prefix, device=None):
    """Reload a v3 quantized artifact (``deploy.load_model(prefix,
    quantized=True)``)."""
    from . import deploy as _deploy
    return _deploy.load_model(prefix, quantized=True, device=device)
