"""``mx.config`` — the typed runtime-knob registry (counterpart of
``mxnet_tpu.config``), cut down to the knobs the ported paths read: the
generation and one-shot serving paths, quantization (``quant.*``), the
fault-injection harness and retry policy (``resilience.*``), the kernel
tier, the 64-bit dtype policy, the
ResNet training path
(convolution layout, BatchNorm statistics, and the trainer options that
are not ported yet, which the trainer refuses instead of ignoring), the
engine and symbolic Module knobs, the layer-stack program knobs
(``runtime.stack_mode``, ``runtime.remat``) of ``runtime.scan_stack``,
and the data pipeline's (``io.*``).

Every knob has a type, a default, its environment variable and a
docstring.  ``get`` reads programmatic override > env var > default;
``set`` / ``unset`` override programmatically and bump :func:`epoch`.
The environment variable names are the reference package's, so one
launcher setting configures either package.
"""
from __future__ import annotations

import os
from collections import namedtuple

__all__ = ["register_knob", "get", "set", "unset", "describe", "epoch",
           "enable_x64", "Knob"]

Knob = namedtuple("Knob", ["name", "env", "type", "default", "doc"])

_KNOBS = {}
_OVERRIDES = {}
_ON_SET = {}  # knob name -> callback(value), fired after set()

# Bumped by every effective set()/unset(): caches that bake knob values in
# key on it so a knob change invalidates them instead of silently not
# applying.
_EPOCH = 0


def register_knob(name, env, type_, default, doc):
    """Declare a knob.  ``env`` is its environment variable; ``type_`` one
    of bool/int/float/str."""
    _KNOBS[name] = Knob(name, env, type_, default, doc)
    return _KNOBS[name]


def _parse(knob, raw):
    if knob.type is bool:
        return raw not in ("0", "false", "False", "")
    return knob.type(raw)


def get(name):
    """Current value: programmatic override > env var > default."""
    knob = _KNOBS[name]
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    raw = os.environ.get(knob.env)
    if raw is not None:
        return _parse(knob, raw)
    return knob.default


def set(name, value):  # noqa: A001 — reference-parity name
    global _EPOCH
    if name not in _KNOBS:
        raise KeyError("unknown knob %r (see mx.config.describe())" % name)
    knob = _KNOBS[name]
    parsed = _parse(knob, value) if isinstance(value, str) \
        else knob.type(value)
    changed = parsed != get(name)
    _OVERRIDES[name] = parsed
    if changed:
        _EPOCH += 1
    hook = _ON_SET.get(name)
    if hook is not None:
        hook(parsed)


def unset(name):
    """Drop a programmatic override so ``name`` falls back to its env var
    or default."""
    global _EPOCH
    if name not in _KNOBS:
        raise KeyError("unknown knob %r (see mx.config.describe())" % name)
    if name not in _OVERRIDES:
        return
    old = get(name)
    del _OVERRIDES[name]
    if get(name) != old:
        _EPOCH += 1


def epoch():
    return _EPOCH


def describe():
    """The knob table, generated from the registry."""
    lines = ["%-28s %-38s %-6s %-8s %s" % ("Knob", "Env var", "Type",
                                          "Default", "Doc")]
    for k in sorted(_KNOBS.values()):
        lines.append("%-28s %-38s %-6s %-8s %s"
                     % (k.name, k.env, k.type.__name__, k.default, k.doc))
    return "\n".join(lines)


# ----------------------------------------------------------- the registry
register_knob(
    "kernels.enabled", "MXNET_TPU_KERNELS", bool, True,
    "route through the hand-written CUDA kernel tier (mx.kernels): "
    "flash-attention forward and backward under every attention call, the "
    "paged decode kernel under every decode step, and the fused "
    "optimizer step (Adam, SGD) under Optimizer.update_multi_precision "
    "and SPMDTrainer. A CUDA tensor the kernel "
    "cannot take raises KernelUnsupportedError; a CPU tensor runs the "
    "kernel's plain PyTorch version. Off = the plain attention lowering "
    "everywhere, the only way to run it on the card.")
register_knob(
    "numpy.enable_x64", "MXTPU_ENABLE_X64", bool, False,
    "keep 64-bit dtypes: off (default), a float64/int64/uint64 that "
    "mx.nd.array and the creation functions are given becomes its 32-bit "
    "twin, as the reference canonicalizes them; on, they stay 64-bit.")
register_knob(
    "model_store.root", "MXNET_HOME", str, "",
    "root of the local pretrained-weight store (models live under "
    "<root>/models); empty = ~/.mxnet.  The reference's environment "
    "variable, read by gluon.model_zoo.model_store.")
register_knob(
    "conv.internal_layout", "MXTPU_CONV_LAYOUT", str, "native",
    "internal conv layout: native (NCHW) or NHWC (the input and weight "
    "of every 2-D convolution go channels_last in memory; the logical API "
    "stays NCHW).")
register_knob(
    "conv.weights_layout", "MXTPU_CONV_WEIGHTS_LAYOUT", str, "ref",
    "conv weight storage inside SPMDTrainer: ref (OIHW). HWIO is not "
    "ported; SPMDTrainer raises NotImplementedError under it.")
register_knob(
    "bn_two_pass_stats", "MXTPU_BN_TWO_PASS_STATS", bool, False,
    "BatchNorm training statistics: False (default) = single-pass "
    "moving-mean-shifted moments; True = the exact two-pass variance, for "
    "offset-heavy inputs whose |mean|/std exceeds ~3000 at cold start.")
register_knob(
    "resilience.nanguard", "MXNET_TPU_NANGUARD", str, "",
    "non-finite step guard of the fused train step ('skip' / 'abort'). "
    "Not ported; SPMDTrainer and Module raise NotImplementedError when it "
    "is set.")
register_knob(
    "numerics.capture", "MXNET_TPU_NUMERICS", str, "",
    "in-step tensor-statistics capture cadence ('step:N'). Not ported; "
    "SPMDTrainer and Module raise NotImplementedError when it is set.")
register_knob(
    "kvstore.grad_compress", "MXNET_TPU_GRAD_COMPRESS", str, "",
    "gradient-sync wire compression ('2bit'). Not ported; SPMDTrainer "
    "raises NotImplementedError when it is set.")
register_knob(
    "engine.type", "MXNET_ENGINE_TYPE", str, "ThreadedEnginePerDevice",
    "NaiveEngine selects the synchronous debug mode: every mx.nd op waits "
    "for its outputs (mx.engine.maybe_sync) and symbolic Modules run the "
    "stage-at-a-time eager step (mx.engine.fused_step_allowed).")
register_knob(
    "engine.bulk_size", "MXNET_ENGINE_BULK_SIZE", int, 15,
    "the reference's bulking segment size; kept for scripts that set it "
    "(PyTorch dispatches each op as it comes).")
register_knob(
    "module.fused_step", "MXTPU_MODULE_FUSED_STEP", str, "auto",
    "symbolic Module train step: auto (forward_backward + update run as "
    "one fused step, Executor.fused_step_fn, whose f32 parameters update "
    "in place through the optimizer's fused kernel when the kernel tier "
    "is on) or off (the stage-at-a-time eager step; NaiveEngine forces "
    "it too).")
register_knob(
    "quant.calib_mode", "MXNET_TPU_QUANT_CALIB_MODE", str, "entropy",
    "default mx.quantization calibration mode: 'entropy' (KL-divergence "
    "threshold search over activation histograms) or 'naive' (observed "
    "|max|). Degenerate histograms fall back to naive and count "
    "quantization.calib_fallback.")
register_knob(
    "quant.calib_bins", "MXNET_TPU_QUANT_CALIB_BINS", int, 4001,
    "histogram bins for entropy calibration; more bins = a finer KL "
    "threshold search, slower calibration.")
register_knob(
    "quant.error_budget", "MXNET_TPU_QUANT_ERROR_BUDGET", float, 0.05,
    "accuracy guardrail for int8 paths: max relative L2 error "
    "(||int8 - fp32|| / ||fp32||, worst calibration batch) an "
    "export_quantized artifact may show before the export refuses to "
    "emit (QuantizationError).")
register_knob(
    "quant.drift_every", "MXNET_TPU_QUANT_DRIFT_EVERY", int, 0,
    "quantization drift sampling of served int8 models. Not ported (it "
    "needs the numerics plane); Server.register(quantized=True) raises "
    "NotImplementedError when it is > 0.")
register_knob(
    "serving.max_batch", "MXNET_TPU_SERVING_MAX_BATCH", int, 32,
    "one-shot serving batch capacity: the batcher coalesces queued "
    "requests for one model up to this many rows before dispatch; also "
    "the top pad bucket, so it bounds the warmed shapes per model.")
register_knob(
    "serving.max_queue_delay_ms", "MXNET_TPU_SERVING_MAX_QUEUE_DELAY_MS",
    float, 2.0,
    "one-shot batching window in milliseconds: how long the batcher "
    "holds the oldest queued request waiting for co-batchable traffic "
    "before dispatching a partial batch. 0 dispatches immediately.")
register_knob(
    "resilience.faults", "MXNET_TPU_FAULTS", str, "",
    "deterministic fault-injection spec, e.g. "
    "'serving_dispatch:2@step=1,serving_slow:0.1' — kind:probability per "
    "opportunity, or kind:count@step=N (1-based). Kinds the port draws: "
    "serving_dispatch (fail a one-shot batch dispatch — feeds the circuit "
    "breaker), serving_slow (delay a dispatch), and any kind passed to "
    "resilience.call_with_retry(inject_faults=True).")
register_knob(
    "resilience.fault_seed", "MXNET_TPU_FAULT_SEED", int, 0,
    "seed for the fault-injection RNGs and retry jitter; two runs with "
    "the same spec and seed inject identical faults.")
register_knob(
    "resilience.retry_attempts", "MXNET_TPU_RETRY_ATTEMPTS", int, 3,
    "total attempts of resilience.call_with_retry on OSError (the "
    "serving batcher's restart budget too); retries bump "
    "resilience.retries[.<kind>].")
register_knob(
    "resilience.retry_base_s", "MXNET_TPU_RETRY_BASE_S", float, 0.05,
    "first retry backoff in seconds; doubles per attempt with seeded "
    "jitter, capped at 2s.")
register_knob(
    "serving.max_pending", "MXNET_TPU_SERVING_MAX_PENDING", int, 1024,
    "admission bound: submits past this many queued requests fail fast "
    "with ServerOverloadedError; <= 0 disables the bound.")
register_knob(
    "serving.default_deadline_ms", "MXNET_TPU_SERVING_DEFAULT_DEADLINE_MS",
    float, 0.0,
    "default per-request queue deadline in milliseconds: a request still "
    "queued past it completes with DeadlineExceededError and never "
    "prefills. 0 = no deadline.")
register_knob(
    "serving.breaker_threshold", "MXNET_TPU_SERVING_BREAKER_THRESHOLD",
    int, 5,
    "consecutive dispatch failures that open one model's circuit "
    "breaker; 0 disables the breaker.")
register_knob(
    "serving.breaker_cooldown_ms", "MXNET_TPU_SERVING_BREAKER_COOLDOWN_MS",
    float, 1000.0,
    "how long an open circuit breaker rejects before letting one probe "
    "dispatch through.")
register_knob(
    "serving.kv_page_size", "MXNET_TPU_SERVING_KV_PAGE_SIZE", int, 16,
    "tokens per KV-cache page: position t of a sequence lives at slot "
    "t %% page_size of page-table entry t // page_size. Fixed at export "
    "time; at serve time the artifact's own page size wins.")
register_knob(
    "serving.kv_pages", "MXNET_TPU_SERVING_KV_PAGES", int, 256,
    "device-resident KV page-pool capacity per generation model. "
    "Admission waits when the pool cannot cover a request's prompt + "
    "max_new_tokens (serving.kv_pool_exhausted counts the stalls).")
register_knob(
    "serving.decode_slots", "MXNET_TPU_SERVING_DECODE_SLOTS", int, 8,
    "decode-batch width: how many sequences one decode step advances "
    "together.")
register_knob(
    "serving.shared_prefix", "MXNET_TPU_SHARED_PREFIX", bool, True,
    "share full prompt-prefix KV pages between concurrent requests with "
    "a common prefix (refcounted, freed when the last reader exits).")


# transformer layer-stack program tuning (runtime.scan_stack)
register_knob(
    "runtime.stack_mode", "MXNET_TPU_STACK_MODE", str, "scan",
    "layer-stack program shape for runtime.scan_stack: 'scan' (default) "
    "or 'unroll'. PyTorch runs eagerly, so both run the same Python loop "
    "over the layers; the knob is validated and kept for scripts and "
    "for the tuning grid (runtime.stack_candidates).")
register_knob(
    "runtime.remat", "MXNET_TPU_REMAT", str, "",
    "recomputation around each layer of runtime.scan_stack: '' (default) "
    "saves every activation, no wrapper; 'dots' saves the matrix "
    "products' outputs (aten.mm/bmm/addmm) and recomputes the rest in the "
    "backward (a selective checkpoint); 'full' saves only the layer "
    "input (torch.utils.checkpoint around the layer body).")


def _apply_runtime_stack_mode(value):
    v = (value or "").strip().lower()
    if v not in ("scan", "unroll"):
        _OVERRIDES.pop("runtime.stack_mode", None)
        raise ValueError("runtime.stack_mode must be 'scan' or 'unroll', "
                         "got %r" % (value,))


def _apply_runtime_remat(value):
    v = (value or "").strip().lower()
    if v not in ("", "dots", "full"):
        _OVERRIDES.pop("runtime.remat", None)
        raise ValueError("runtime.remat must be '', 'dots' or 'full', "
                         "got %r" % (value,))


_ON_SET["runtime.stack_mode"] = _apply_runtime_stack_mode
_ON_SET["runtime.remat"] = _apply_runtime_remat


def _apply_quant_calib_mode(value):
    v = (value or "").strip().lower()
    if v not in ("naive", "entropy"):
        _OVERRIDES.pop("quant.calib_mode", None)
        raise ValueError("quant.calib_mode must be 'naive' or 'entropy', "
                         "got %r" % (value,))


def _apply_quant_drift_every(value):
    if int(value) < 0:
        _OVERRIDES.pop("quant.drift_every", None)
        raise ValueError("quant.drift_every must be >= 0, got %r"
                         % (value,))


def _apply_resilience_faults(_value):
    from . import resilience
    resilience.configure_faults()


def _apply_resilience_retry(_value):
    from . import resilience
    resilience.configure_retry()


_ON_SET["quant.calib_mode"] = _apply_quant_calib_mode
_ON_SET["quant.drift_every"] = _apply_quant_drift_every
_ON_SET["resilience.faults"] = _apply_resilience_faults
_ON_SET["resilience.fault_seed"] = _apply_resilience_faults
_ON_SET["resilience.retry_attempts"] = _apply_resilience_retry
_ON_SET["resilience.retry_base_s"] = _apply_resilience_retry


# data loading and the device prefetch ring (mx.io, mx.image,
# gluon.data)
register_knob(
    "io.device_prefetch", "MXNET_TPU_IO_DEVICE_PREFETCH", bool, True,
    "DevicePrefetcher staging: True (default) copies each batch to the "
    "consumer's CUDA device on the prefetch thread (through pinned host "
    "buffers, on a side stream, with an event the consumer's stream "
    "waits on), so the training loop receives device tensors and never "
    "blocks on the copy; False keeps the batches on the host (the A/B "
    "baseline).")
register_knob(
    "io.prefetch_depth", "MXNET_TPU_IO_PREFETCH_DEPTH", int, 2,
    "batches the background thread of DevicePrefetcher / PrefetchingIter "
    "keeps ahead of the consumer.")
register_knob(
    "io.decode_workers", "MXNET_TPU_IO_DECODE_WORKERS", int, 0,
    "thread-pool size for the per-sample decode and augmentation of "
    "mx.image.ImageIter (and io.ImageRecordIter): 0 or 1 decode serially "
    "on the batch thread; N > 1 maps a batch's samples over N threads.")
register_knob(
    "io.pad_buckets", "MXNET_TPU_IO_PAD_BUCKETS", str, "pow2",
    "DevicePrefetcher's padding of short batches: 'full' wrap-pads every "
    "batch to batch_size, 'pow2' (default) to the next power of two rows, "
    "'off' keeps each batch's own row count. DataBatch.pad counts the "
    "fill rows.")


def enable_x64(flag=True):
    """Programmatic x64 switch (pairs with the ``numpy.enable_x64``
    knob)."""
    set("numpy.enable_x64", bool(flag))


def _positive_int_knob(name):
    def apply(value):
        if int(value) <= 0:
            # reject at set() time and revert
            _OVERRIDES.pop(name, None)
            raise ValueError("%s must be a positive integer, got %r"
                             % (name, value))
    return apply


for _name in ("serving.kv_page_size", "serving.kv_pages",
              "serving.decode_slots", "io.prefetch_depth"):
    _ON_SET[_name] = _positive_int_knob(_name)
del _name
