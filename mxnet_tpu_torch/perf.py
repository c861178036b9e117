"""``mx.perf`` — program cost attribution (counterpart of
``mxnet_tpu.perf``).

The reference asks XLA what a compiled program costs.  PyTorch runs
eagerly and compiles nothing, so here a program is counted once, on its
first call at a shape signature, by running that call under a counting
dispatch mode (:func:`cost_analysis`); that call is the real one, so
counting adds no launch and no host sync:

* FLOPs from ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention);
* bytes accessed as the sum of each op's input and output bytes (views
  and ``empty`` excluded): eager PyTorch's real traffic, and an upper
  bound on what a fused program would move;
* the hand-written kernels report their own cost: a launch through
  ``ctypes`` is invisible to a dispatch mode, so each wrapper of
  ``ops/cuda_kernels.py`` charges its analytic FLOPs and bytes (the
  formula of PERF.md's bound column) and hides its own ops, the plain
  version's on the CPU included.  The card and the CPU count the same
  work for the same call;
* an op-class table (:func:`classify_op`) and a roofline verdict
  (:func:`roofline`) against the card's peaks.

The registry (:func:`register_compiled`, :func:`programs`) holds one
record per ``(family, key)``.  :class:`PerfProgram` (:func:`wrap`) counts
at its first call per shape signature, then adds the recorded FLOPs to
its source's accumulator at every call (one dict add), and
``telemetry.step_scope`` pops the accumulator at step exit into the
``perf.mfu`` / ``perf.mfu.<source>`` gauges and the step record's
``flops`` / ``mfu`` fields.  The families: ``gluon`` (a hybridized
Block's call), ``module`` (``Executor.fused_step_fn``), ``spmd``
(``SPMDTrainer``'s dense and sparse steps), ``embedding``
(``ShardedEmbedding``), ``serving`` (each warmed one-shot bucket, each
prefill bucket and decode width of a generation engine) and ``kernels``
(``kernels.measure``).

``perf.profile=step:N`` runs one whole train step under a
``torch.profiler`` session every N steps, writes its Chrome trace under
``perf.profile_dir`` and folds it with the span trace
(``tracing.sink``) through ``trace_merge``.  A session that recorded no
CUDA activity on a card counts ``perf.empty_profiles`` and says so in
its ``meta.json``.

Peaks (:data:`PEAK_BF16_TFLOPS`, :data:`PEAK_HBM_GBPS`) are the data-sheet
figures of each card, keyed by ``torch.cuda.get_device_name()``, dense
(no sparsity), at the card's full power limit.  A card not in the table
warns once and takes :data:`DEFAULT_PEAK`; on a machine with no card the
peaks are the default's too, so a CPU MFU is finite but says nothing.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
import warnings

__all__ = [
    "PEAK_BF16_TFLOPS", "DEFAULT_PEAK", "PEAK_HBM_GBPS", "DEFAULT_HBM_GBPS",
    "OP_CLASSES", "classify_op", "hlo_op_classes", "device_kind",
    "peak_flops", "peak_bandwidth", "roofline", "register_compiled",
    "programs", "program", "reset", "export", "wrap", "PerfProgram",
    "configure_profile", "cost_analysis", "autotune",
]

# ----------------------------------------------------------- peak tables
#: dense bf16 tensor-core peak by device name (TFLOP/s; NVIDIA's data
#: sheets)
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,   # H100 SXM5
    "NVIDIA H100 PCIe": 756.0,
    "NVIDIA H100 NVL": 835.0,
    "NVIDIA H200": 989.0,
}
DEFAULT_PEAK = 989.0

#: HBM bandwidth by device name (GB/s)
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
    "NVIDIA H200": 4800.0,
}
DEFAULT_HBM_GBPS = 3350.0

# the peak of each compute dtype relative to dense bf16 on Hopper: f16
# runs at the bf16 rate, int8 and fp8 at twice it; f32 products in the
# port run as 3xTF32 (the hand kernels' f32-accurate tensor-core route,
# a third of TF32's 495 TFLOP/s), 'tf32' names TF32 itself, and f64 the
# 67 TFLOP/s of the FP64 tensor cores.  The basis stands beside every
# MFU number.
_DTYPE_PEAK_SCALE = {
    "bfloat16": 1.0, "float16": 1.0, "int8": 2.0, "float8_e4m3fn": 2.0,
    "float8_e5m2": 2.0, "tf32": 0.5, "float32": 0.5 / 3.0,
    "float64": 67.0 / 989.0,
}

_KIND_CACHE = [None]
_WARNED = set()


def device_kind(default=""):
    """``torch.cuda.get_device_name(0)``, cached; ``default`` without a
    card."""
    kind = _KIND_CACHE[0]
    if kind is None:
        kind = ""
        try:
            import torch
            if torch.cuda.is_available():
                kind = str(torch.cuda.get_device_name(0))
        except Exception:  # noqa: BLE001 — no usable card: generic peaks
            kind = ""
        _KIND_CACHE[0] = kind
    return kind or default


def _table(table, default, kind):
    if kind is None:
        kind = device_kind()
    if kind in table:
        return table[kind]
    if kind and kind not in _WARNED:
        _WARNED.add(kind)
        warnings.warn("mx.perf: no peak figures for %r; MFU and roofline "
                      "use the H100 SXM's (DEFAULT_PEAK)" % (kind,),
                      RuntimeWarning, stacklevel=3)
    return default


def peak_flops(kind=None, dtype="bfloat16"):
    """Peak FLOP/s of a device at a compute dtype (the bf16 peak scaled
    by the dtype's Hopper rate)."""
    tf = _table(PEAK_BF16_TFLOPS, DEFAULT_PEAK, kind)
    return tf * _DTYPE_PEAK_SCALE.get(str(dtype), 1.0) * 1e12


def peak_bandwidth(kind=None):
    """Peak HBM bandwidth of a device in bytes/s."""
    return _table(PEAK_HBM_GBPS, DEFAULT_HBM_GBPS, kind) * 1e9


# --------------------------------------------------------- op-class map
OP_CLASSES = ("matmul", "conv", "elementwise", "reduction", "collective",
              "copy", "other")

_ELEMENTWISE_OPS = frozenset((
    "add", "sub", "subtract", "mul", "multiply", "div", "divide", "maximum",
    "minimum", "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
    "sqrt", "rsqrt", "pow", "neg", "abs", "sign", "floor", "ceil", "round",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "clamp", "clamp_min",
    "clamp_max", "sigmoid", "relu", "gelu", "silu", "erf", "sin", "cos",
    "reciprocal", "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor",
    "logical_and", "logical_or", "logical_not", "isnan", "isinf",
    "isfinite", "fill", "zero", "threshold_backward", "gelu_backward",
    "silu_backward", "sigmoid_backward", "tanh_backward", "lerp", "addcmul",
    "addcdiv", "fmod", "remainder", "masked_fill", "leaky_relu",
    "hardtanh", "elu", "softplus", "mish", "nan_to_num",
))

# ordered substring rules for compound names (ATen op names and CUDA
# kernel names); the first hit wins (collectives before reductions)
_CLASS_SUBSTRINGS = (
    ("collective", ("all_reduce", "allreduce", "all_gather", "allgather",
                    "reduce_scatter", "all_to_all", "alltoall", "nccl",
                    "broadcast_", "c10d", "all-reduce", "all-gather",
                    "reduce-scatter", "all-to-all", "collective", "psum",
                    "ppermute")),
    ("conv", ("conv", "cudnn")),
    ("matmul", ("addmm", "bmm", "matmul", "gemm", "linear", "xmma",
                "cutlass", "wgmma", "flash", "attention", "paged_decode",
                "einsum", "dot")),
    ("reduction", ("reduce", "sum", "mean", "amax", "amin", "argmax",
                   "argmin", "softmax", "norm", "var", "std", "cumsum",
                   "sort", "topk", "max", "min", "prod", "logsumexp")),
    ("copy", ("copy", "transpose", "permute", "cat", "stack", "index",
              "gather", "scatter", "clone", "contiguous", "pad", "slice",
              "expand", "repeat", "memcpy", "memset", "flip", "roll",
              "embedding", "to_copy")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise",
                     "foreach", "fused_adam", "fused_sgd", "sgd", "adam",
                     "scale_bias_relu")),
)


def classify_op(name):
    """Map an ATen op name (``aten::mm``, ``aten.addmm.default``, ``mm``)
    or a CUDA kernel name to one of :data:`OP_CLASSES`."""
    n = str(name).strip().lower()
    for prefix in ("aten::", "aten.", "torch.ops.aten."):
        if n.startswith(prefix):
            n = n[len(prefix):]
    base = re.split(r"[.(<\s]", n, 1)[0].rstrip("_")
    if base in ("mm", "mv", "bmm", "addmm", "baddbmm", "addbmm",
                "_scaled_dot_product_flash_attention",
                "_scaled_dot_product_efficient_attention"):
        return "matmul"
    if base in _ELEMENTWISE_OPS:
        return "elementwise"
    for cls, keys in _CLASS_SUBSTRINGS:
        if any(k in n for k in keys):
            return cls
    return "other"


def hlo_op_classes(ops):
    """Counts per op class (:data:`OP_CLASSES`) of an op log: the reference
    counts an optimized HLO module's instructions, the port counts what
    ran.  ``ops`` is an iterable of op or kernel names (a
    :func:`cost_analysis` ``ops`` log), or a finished ``torch.profiler``
    session, whose CUDA kernels are counted (its host ops when it
    recorded none)."""
    names = ops
    if hasattr(ops, "events"):
        from torch.autograd import DeviceType
        events = ops.events()
        names = [ev.name for ev in events
                 if ev.device_type == DeviceType.CUDA]
        if not names:
            names = [ev.name for ev in events if ev.name.startswith("aten::")]
    counts = {}
    for op in names or ():
        cls = classify_op(op)
        counts[cls] = counts.get(cls, 0) + 1
    return counts


# -------------------------------------------------------------- roofline
def roofline(flops, bytes_accessed, kind=None, dtype="bfloat16"):
    """Compute- or bandwidth-bound: the program's arithmetic intensity
    (FLOPs per byte) against the card's ridge (peak FLOP/s over peak
    bytes/s)."""
    pf = peak_flops(kind, dtype)
    bw = peak_bandwidth(kind)
    device_ai = pf / bw
    ai = (float(flops) / float(bytes_accessed)) if bytes_accessed else None
    bound = "compute" if (ai is None or ai >= device_ai) else "bandwidth"
    return {
        "arithmetic_intensity": round(ai, 3) if ai is not None else None,
        "device_intensity": round(device_ai, 3),
        "bound": bound,
    }


# ------------------------------------------------------- cost analysis
class _Counter:
    """What one :func:`cost_analysis` run counted."""

    def __init__(self):
        self.flops = 0
        self.nbytes = 0
        self.ops = []
        self.kernel_flops = 0
        self.kernels = {}
        # > 0 while a hand kernel's wrapper runs: its own ops are not
        # counted (its charge stands for them)
        self.inside = 0

    def charge(self, name, flops, nbytes):
        """A hand kernel's analytic cost (``cuda_kernels._costed``)."""
        self.kernel_flops += int(flops)
        self.nbytes += int(nbytes)
        self.ops.append(name)
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)

    @contextlib.contextmanager
    def hidden(self):
        """What a kernel wrapper runs inside is not counted: its charge
        (:meth:`charge`) stands for it.  Other dispatch modes still see
        those ops."""
        self.inside += 1
        try:
            yield
        finally:
            self.inside -= 1


_NO_TRAFFIC = frozenset(("empty", "empty_like", "empty_strided",
                         "new_empty", "new_empty_strided", "detach",
                         "lift_fresh", "_unsafe_view", "alias", "view",
                         "_reshape_alias", "as_strided", "t", "expand",
                         "permute", "transpose", "unsqueeze", "squeeze",
                         "slice", "select", "split", "split_with_sizes",
                         "unbind", "view_as_real", "view_as_complex",
                         "unfold", "diagonal", "narrow", "set_",
                         "_local_scalar_dense", "record_stream",
                         "is_same_size", "sym_size", "sym_stride",
                         "sym_numel", "sym_storage_offset", "size",
                         "stride", "numel", "dim"))


def _tensor_bytes(x, seen):
    import torch
    total = 0
    if isinstance(x, torch.Tensor):
        key = id(x)
        if key not in seen:
            seen.add(key)
            total += x.numel() * x.element_size()
    elif isinstance(x, (list, tuple)):
        for y in x:
            total += _tensor_bytes(y, seen)
    elif isinstance(x, dict):
        for y in x.values():
            total += _tensor_bytes(y, seen)
    return total


# per op overload: (its short name, its FLOP formula or None, whether it
# has a composite decomposition); filled as ops are met
_OP_INFO = {}


def _op_info(func):
    info = _OP_INFO.get(func)
    if info is None:
        import torch
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func._overloadpacket)
        composite = formula is None and \
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd")
        info = _OP_INFO[func] = (func.__name__.split(".")[0], formula,
                                 composite)
    return info


def _cost_mode(counter):
    """One dispatch mode that counts each op's FLOPs (the formula
    ``torch.utils.flop_counter`` registers for it, where there is one) and
    its bytes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _CostMode(TorchDispatchMode):
        # the hand kernels' wrappers find the count through this
        mx_cost_counter = counter

        @classmethod
        def _should_skip_dynamo(cls):
            # the port compiles nothing: no torch.compile guard around
            # each op (it would import torch._dynamo, seconds a process)
            return False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if counter.inside:
                return func(*args, **kwargs)
            name, formula, composite = _op_info(func)
            if composite:
                # under inference mode a composite op (matmul, linear)
                # reaches the mode whole: count what it decomposes into
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            out = func(*args, **kwargs)
            if formula is not None:
                counter.flops += int(formula(*args, **kwargs, out_val=out))
            counter.ops.append(name)
            if name.rstrip("_") not in _NO_TRAFFIC and \
                    not getattr(func, "is_view", False):
                seen = set()
                counter.nbytes += _tensor_bytes(args, seen) + \
                    _tensor_bytes(kwargs, seen) + _tensor_bytes(out, seen)
            return out
    return _CostMode()


def cost_analysis(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once while counting its cost; returns
    ``(outputs, cost)`` with ``cost = {"flops", "bytes_accessed",
    "transcendentals", "ops", "kernels"}``: FLOPs by
    ``torch.utils.flop_counter`` plus the hand kernels' own, bytes as each
    op's inputs plus outputs, ``ops`` the op and kernel names in order,
    ``kernels`` the hand kernels' charges by wrapper.  The outputs are
    those of an uncounted run, bit for bit (the modes only watch)."""
    counter = _Counter()
    with _cost_mode(counter):
        out = fn(*args, **kwargs)
    flops = counter.flops + counter.kernel_flops
    return out, {"flops": float(flops),
                 "bytes_accessed": float(counter.nbytes),
                 "transcendentals": 0.0,
                 "ops": list(counter.ops),
                 "kernels": dict(counter.kernels)}


# -------------------------------------------------------------- registry
_REG_LOCK = threading.Lock()
_PROGRAMS = {}  # guarded-by[writes]: _REG_LOCK — (family, key) -> record

#: FLOPs dispatched through registered programs since the last step pop,
#: per step-log source: source -> [flops, flops / peak_flops]
_PENDING_LOCK = threading.Lock()
_PENDING = {}  # guarded-by: _PENDING_LOCK


def _dominant_dtype(args):
    """The compute dtype an MFU denominator assumes: bf16/f16 if any
    tensor argument carries it, else f32."""
    import torch
    stack = list(args)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.dtype in (torch.bfloat16, torch.float16):
                return str(x.dtype).replace("torch.", "")
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif hasattr(x, "_data"):   # an NDArray
            stack.append(x._data)
    return "float32"


def register_compiled(family, key, record, phases_ms=None, dtype=None):
    """Register one counted program: ``record`` is the cost dict of
    :func:`cost_analysis` (``flops``, ``bytes_accessed``, ``ops``).  The
    registry keeps, per ``(family, key)``: FLOPs, bytes, the op-class
    table, the roofline verdict and the peak it was judged against, and
    the counted run's wall time (``phases_ms``).  Returns the record."""
    from . import telemetry as _telemetry
    record = dict(record or {})
    flops = float(record.get("flops", 0.0) or 0.0)
    nbytes = float(record.get("bytes_accessed", 0.0) or 0.0)
    dtype = dtype or "float32"
    kind = device_kind()
    phases = {k: round(float(v), 3) for k, v in (phases_ms or {}).items()}
    if "run_ms" in phases:
        _telemetry.timer("perf.count_ms").observe(phases["run_ms"])
    peak = peak_flops(kind, dtype)
    rec = {
        "family": str(family),
        "key": str(key),
        "ts": round(time.time(), 3),
        "device_kind": kind,
        "dtype": dtype,
        "flops": flops,
        "bytes_accessed": nbytes,
        "transcendentals": float(record.get("transcendentals", 0.0) or 0.0),
        "memory": {},
        "phases_ms": phases,
        "op_classes": hlo_op_classes(record.get("ops") or ()),
        "kernels": dict(record.get("kernels") or {}),
        "roofline": roofline(flops, nbytes, kind, dtype),
        "peak_tflops": round(peak / 1e12, 3),
        "calls": 0,
        # private: the per-dispatch accumulation precomputes flops/peak so
        # the step-exit MFU is one divide (stripped from snapshots)
        "_flops_over_peak": flops / peak,
    }
    _telemetry.counter("perf.programs").inc()
    with _REG_LOCK:
        _PROGRAMS[(rec["family"], rec["key"])] = rec
    return rec


def _public(rec):
    return {k: v for k, v in rec.items() if not k.startswith("_")}


def programs(family=None):
    """Copies of the registered records (private fields stripped), oldest
    first."""
    with _REG_LOCK:
        recs = list(_PROGRAMS.values())
    recs.sort(key=lambda r: r["ts"])
    return [_public(r) for r in recs
            if family is None or r["family"] == family]


def program(family, key):
    """One registered record by ``(family, key)``, or None."""
    with _REG_LOCK:
        rec = _PROGRAMS.get((str(family), str(key)))
    return _public(rec) if rec is not None else None


def reset():
    """Forget every registered program and pending step attribution."""
    with _REG_LOCK:
        _PROGRAMS.clear()
    with _PENDING_LOCK:
        _PENDING.clear()


def export(path=None):
    """The registry as one JSON-serializable dict (written to ``path``
    when given), with the autotune state beside it."""
    out = {
        "event": "perf_programs",
        "ts": round(time.time(), 3),
        "device_kind": device_kind(),
        "default_peak_tflops": DEFAULT_PEAK,
        "programs": programs(),
        "autotune": autotune.export_entries(),
    }
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    return out


# -------------------------------------------------------- program wrapper
def shape_key(x):
    """The shape signature of ``x`` (a tensor, an NDArray, or lists,
    tuples and dicts of them): shapes, dtypes and device types; numbers
    by type only (a step count or a learning rate is not part of the
    shape)."""
    import torch

    def sig(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), str(x.dtype), x.device.type)
        if hasattr(x, "_data") and isinstance(getattr(x, "_data"),
                                              torch.Tensor):
            return sig(x._data)
        if isinstance(x, (list, tuple)):
            return tuple(sig(y) for y in x)
        if isinstance(x, dict):
            return tuple((k, sig(v)) for k, v in sorted(x.items()))
        if isinstance(x, (int, float, bool)):
            # a step count or a learning rate is not part of the shape
            return type(x).__name__
        if isinstance(x, (str, type(None))):
            return x
        shape = getattr(x, "shape", None)
        if shape is not None:
            return (tuple(shape), str(getattr(x, "dtype", "")))
        return type(x).__name__
    return sig(x)


def _signature(args, kwargs):
    return (shape_key(args), shape_key(kwargs))


class PerfProgram:
    """Registry-instrumented calls of one program.

    The first call at each shape signature runs under :func:`cost_analysis`
    (inside the ``span`` named at :func:`wrap`, when one is) and registers
    its record: the first signature under ``key``, later ones under
    ``key@<n>``.  Every call adds its signature's FLOPs to ``source``'s
    step accumulator (one dict add) when a source is named.  A program
    that runs at one shape only (``per_signature=False``: a serving
    bucket, a step its caller already caches by shape) is counted once
    and reads no signature afterwards.  ``signature`` (a callable of
    ``(args, kwargs)``) names the few arguments that decide a program's
    shape, where walking every argument would cost each call more."""

    __slots__ = ("fn", "family", "key", "source", "span", "span_args",
                 "per_signature", "signature", "dtype", "_records",
                 "_last")

    def __init__(self, fn, family, key, source=None, span=None,
                 span_args=None, per_signature=True, signature=None,
                 dtype=None):
        self.fn = fn
        self.family = family
        self.key = key
        self.source = source
        self.span = span
        self.span_args = dict(span_args or {})
        self.per_signature = per_signature
        self.signature = signature or _signature
        self.dtype = dtype
        self._records = {}
        self._last = None

    @property
    def record(self):
        """The record of the last signature called."""
        return self._last

    def _account(self, rec):
        rec["calls"] += 1
        src = self.source
        if src is None:
            return
        with _PENDING_LOCK:
            cur = _PENDING.get(src)
            if cur is None:
                _PENDING[src] = [rec["flops"], rec["_flops_over_peak"]]
            else:
                cur[0] += rec["flops"]
                cur[1] += rec["_flops_over_peak"]

    def _count(self, sig, args, kwargs):
        key = self.key if not self._records else \
            "%s@%d" % (self.key, len(self._records))
        t0 = time.perf_counter()
        if self.span is not None:
            from . import tracing as _tracing
            with _tracing.span(self.span, cat="perf", program=key,
                               **self.span_args):
                out, cost = cost_analysis(self.fn, *args, **kwargs)
        else:
            out, cost = cost_analysis(self.fn, *args, **kwargs)
        rec = register_compiled(
            self.family, key, cost,
            phases_ms={"run_ms": (time.perf_counter() - t0) * 1e3},
            dtype=self.dtype or _dominant_dtype((args, kwargs)))
        self._records[sig] = rec
        self._last = rec
        self._account(rec)
        return out

    def __call__(self, *args, **kwargs):
        if not self.per_signature:
            rec = self._last
            if rec is None:
                return self._count(None, args, kwargs)
            self._account(rec)
            return self.fn(*args, **kwargs)
        sig = self.signature(args, kwargs)
        rec = self._records.get(sig)
        if rec is None:
            return self._count(sig, args, kwargs)
        self._last = rec
        self._account(rec)
        return self.fn(*args, **kwargs)


def wrap(fn, family, key, source=None, span=None, per_signature=True,
         signature=None, dtype=None, **span_args):
    """Instrument one program for the registry.  ``source`` names the
    telemetry step-log source whose MFU its calls feed (module / spmd /
    gluon); None (serving, embedding, kernels) registers cost without step
    attribution.  ``span`` names a tracing span around the counted call
    (the generation engine's ``serving.compile``); ``per_signature=False``
    counts a one-shape program once; ``signature`` keys the counts by a
    cheaper signature than every argument's (:class:`PerfProgram`);
    ``dtype`` names the compute dtype of the MFU's peak (by default
    bf16/f16 when an argument carries it, else f32)."""
    return PerfProgram(fn, family, key, source=source, span=span,
                       span_args=span_args, per_signature=per_signature,
                       signature=signature, dtype=dtype)


# ------------------------------------------------------------- step hook
def _on_step(source, step_idx, wall_s):
    """``telemetry.step_scope``'s exit hook: pop the source's accumulator
    into the MFU gauges and the step record's ``flops`` / ``mfu``.  Cost:
    one dict pop; one divide and two gauge sets when a registered program
    ran in the step."""
    with _PENDING_LOCK:
        acc = _PENDING.pop(source, None)
    extra = None
    if acc is not None and wall_s > 0:
        from . import telemetry as _telemetry
        # 6 significant digits: a CPU MFU is ~1e-8 and must survive the
        # JSONL round trip
        mfu = float("%.6g" % (acc[1] / wall_s))
        _telemetry.gauge("perf.mfu").set(mfu)
        _telemetry.gauge("perf.mfu.%s" % source).set(mfu)
        extra = {"flops": round(acc[0], 1), "mfu": mfu}
    if _PROFILE["every"] > 0:
        _maybe_profile(source, step_idx)
    return extra


# --------------------------------------------- periodic device capture
# guarded-by: _PROFILE_LOCK — the lock-free ``every`` read on the step
# path tolerates staleness by one step during reconfigure
_PROFILE_LOCK = threading.Lock()
_PROFILE = {"every": 0, "count": 0, "active": None}


def configure_profile(spec):
    """(Re)configure ``perf.profile``: ``step:N`` profiles one whole train
    step every N steps; empty disables (a session already started for the
    next step is dropped)."""
    spec = (spec or "").strip()
    every = 0
    if spec:
        m = re.match(r"^step:(\d+)$", spec)
        if not m or int(m.group(1)) < 1:
            raise ValueError(
                "perf.profile spec %r: expected 'step:N' (N >= 1)"
                % (spec,))
        every = int(m.group(1))
    with _PROFILE_LOCK:
        _PROFILE["every"] = every
        _PROFILE["count"] = 0
        active = _PROFILE["active"]
        _PROFILE["active"] = None
    if active is not None:
        # a capture started for a step that will not run under this
        # cadence: stopped and dropped, never written
        try:
            active[0].stop()
        except Exception:  # noqa: BLE001 — a capture never kills the loop
            pass


def captures():
    """The capture directories written so far in this process."""
    with _PROFILE_LOCK:
        return list(_CAPTURES)


_CAPTURES = []  # guarded-by: _PROFILE_LOCK


def _maybe_profile(source, step_idx):
    """At step exit while armed: stop an active session (it covered the
    step that just finished) and write and fold it; every N completed
    steps start the next, so the FOLLOWING step runs whole under it."""
    from . import telemetry as _telemetry
    with _PROFILE_LOCK:
        every = _PROFILE["every"]
        active = _PROFILE["active"]
        if active is not None:
            _PROFILE["active"] = None
            _finish_capture(*active)
            _telemetry.counter("perf.profiles_captured").inc()
        if every <= 0:
            return
        _PROFILE["count"] += 1
        if _PROFILE["count"] % every != 0:
            return
        from . import config as _config
        base = (_config.get("perf.profile_dir") or "").strip() or "."
        out = os.path.join(base, "perf_step_%s_%d" % (source, step_idx + 1))
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(out, exist_ok=True)
            cuda = torch.cuda.is_available()
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            session = profile(activities=acts)
            session.start()
            _PROFILE["active"] = (session, out, cuda)
        except Exception:  # noqa: BLE001 — another profiler session
            _PROFILE["active"] = None   # is running: skip this slot


def _finish_capture(session, out, cuda):  # holds(_PROFILE_LOCK)
    """Stop ``session``, write its trace into ``out`` and fold it with the
    span trace."""
    from . import telemetry as _telemetry
    try:
        if cuda:
            import torch
            torch.cuda.synchronize()
        session.stop()
    except Exception:  # noqa: BLE001 — a capture never kills the loop
        return
    from .profiler import _kernel_events
    device, launched, recorded = _kernel_events(session.events()) \
        if cuda else ({}, 0, 0)
    empty = bool(cuda and not device)
    if empty:
        _telemetry.counter("perf.empty_profiles").inc()
    trace = os.path.join(out, "trace.json")
    meta = {"cuda": cuda, "empty": empty, "kernels_recorded": recorded,
            "kernel_launches": launched, "merged": None}
    try:
        session.export_chrome_trace(trace)
        meta["merged"] = _fold_device_trace(out, trace)
    except Exception as exc:  # noqa: BLE001 — evidence is optional
        meta["error"] = "%s: %s" % (type(exc).__name__, exc)
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump(meta, f)
    _CAPTURES.append(out)


def _fold_device_trace(out, trace):
    """Fold a finished capture with the span trace into
    ``<out>/merged.json``; the merge's stats (``out`` its path), or None
    without a span sink."""
    from . import trace_merge as _tm
    from . import tracing as _tracing
    _tracing.flush()
    host_path = _tracing.sink_path()
    if not host_path or not os.path.exists(host_path):
        return None
    stats = _tm.merge_files(host_path, trace,
                            os.path.join(out, "merged.json"), align="zero")
    return stats


# Install the step hook and honor MXNET_TPU_PROFILE at import.
# telemetry.py imports this module at its bottom (the tracing pattern),
# so any training-path import arms cost attribution; the hook is a slot
# on telemetry rather than an import so telemetry stays dependency-free.
from . import config as _config  # noqa: E402
from . import telemetry as _telemetry_mod  # noqa: E402

# mx.perf.autotune — the measured launch-parameter search rides on this
# module's namespace, as in the reference
from . import autotune  # noqa: E402,F401

_telemetry_mod._PERF_STEP_HOOK = _on_step

configure_profile(_config.get("perf.profile"))
