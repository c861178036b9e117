"""``mx.config`` — the typed runtime-knob registry (counterpart of
``mxnet_tpu.config``), cut down to the knobs the ported paths read: the
generation-serving path, the kernel tier, the 64-bit dtype policy, the
ResNet training path
(convolution layout, BatchNorm statistics, and the trainer options that
are not ported yet, which the trainer refuses instead of ignoring), and
the engine and symbolic Module knobs.

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
    "quant.error_budget", "MXNET_TPU_QUANT_ERROR_BUDGET", float, 0.05,
    "accuracy guardrail for int8 paths: max relative error an int8 "
    "result may show against its full-precision counterpart.")
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
              "serving.decode_slots"):
    _ON_SET[_name] = _positive_int_knob(_name)
del _name
