"""``mx.config`` — the typed runtime-knob registry (counterpart of
``mxnet_tpu.config``), cut down to the knobs the ported paths read: the
generation and one-shot serving paths, quantization (``quant.*``), the
fault-tolerance knobs (``resilience.*``: the nanguard, preemption,
checkpoint cadence, fault injection and retry policy; ``elastic.*``),
the kernel tier, the 64-bit dtype policy, the
ResNet training path
(convolution layout, BatchNorm statistics), the observability knobs
(``numerics.capture``, ``telemetry.sink``, ``tracing.*``,
``profiler.*``), the serving and cost observability knobs (``obs.*``,
``perf.profile*``, ``perf.autotune*``), the
engine and symbolic Module knobs, the layer-stack program knobs
(``runtime.stack_mode``, ``runtime.remat``) of ``runtime.scan_stack``,
the data pipeline's (``io.*``), and the scale-out knobs (2-bit gradient
compression, ``kvstore.*``; the row-sparse embedding path,
``embedding.*``).

Every knob has a type, a default, its environment variable and a
docstring.  ``get`` reads programmatic override > env var > default;
``set`` / ``unset`` override programmatically and bump :func:`epoch`
(except the epoch-neutral knobs, ``_EPOCH_NEUTRAL``), and fire the
knob's on-set hook when the value changes.
The environment variable names are the reference package's, so one
launcher setting configures either package.

Reference knobs left out, as they have no meaning here yet:
``kernels.vmem_budget`` (the TPU's VMEM window; the Hopper kernels tile
through shared memory and take no such budget), ``xla.autotune`` and
``xla.memory_pool`` (XLA's own), and ``serving.compile_cache_dir`` (a
persistent compile cache waits for the serving shapes to run as CUDA
graphs).
"""
from __future__ import annotations

import os
from collections import namedtuple

__all__ = ["register_knob", "get", "set", "unset", "source", "knobs",
           "describe", "epoch", "enable_x64", "Knob"]

Knob = namedtuple("Knob", ["name", "env", "type", "default", "doc"])

_KNOBS = {}
_OVERRIDES = {}
_ON_SET = {}  # knob name -> callback(value), fired after set()

# Knobs that never bump the epoch: what they change is host-side state
# (the numerics capture is decided per step and keys nothing), so a toggle
# must not make the trainers and executors rebuild their steps.  Their
# hooks still fire.
_EPOCH_NEUTRAL = {"numerics.capture", "quant.drift_every",
                  "quant.drift_threshold", "obs.listen", "obs.access_log",
                  "obs.slo", "perf.profile", "perf.profile_dir"}

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


def source(name):
    """Where the current value of ``name`` comes from: ``'override'``
    (programmatic set()), ``'env'`` (its environment variable) or
    ``'default'``."""
    knob = _KNOBS[name]
    if name in _OVERRIDES:
        return "override"
    if os.environ.get(knob.env) is not None:
        return "env"
    return "default"


def knobs():
    """The registry: ``{name: Knob}``."""
    return dict(_KNOBS)


def set(name, value):  # noqa: A001 — reference-parity name
    global _EPOCH
    if name not in _KNOBS:
        raise KeyError("unknown knob %r (see mx.config.describe())" % name)
    knob = _KNOBS[name]
    parsed = _parse(knob, value) if isinstance(value, str) \
        else knob.type(value)
    changed = parsed != get(name)
    _OVERRIDES[name] = parsed
    if changed and name not in _EPOCH_NEUTRAL:
        _EPOCH += 1
    hook = _ON_SET.get(name)
    if hook is not None:
        hook(parsed)


def unset(name):
    """Drop a programmatic override so ``name`` falls back to its env var
    or default; bumps the epoch and fires the knob's hook only when the
    value changes."""
    global _EPOCH
    if name not in _KNOBS:
        raise KeyError("unknown knob %r (see mx.config.describe())" % name)
    if name not in _OVERRIDES:
        return
    old = get(name)
    del _OVERRIDES[name]
    new = get(name)
    if new == old:
        return
    if name not in _EPOCH_NEUTRAL:
        _EPOCH += 1
    hook = _ON_SET.get(name)
    if hook is not None:
        hook(new)


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
    "numerics.capture", "MXNET_TPU_NUMERICS", str, "",
    "in-step tensor-statistics capture cadence: 'step:N' makes each step "
    "seam (the Module's fused and eager steps, SPMDTrainer, gluon.Trainer, "
    "ShardedEmbedding) summarize its sites every Nth step (mx.numerics: "
    "amax/amin/rms/non-finite/bf16-saturation per site, stacked on the "
    "card into one [sites, 6] tensor and copied to pinned host memory "
    "behind a CUDA event; no host sync). Empty/'off' (default) disables: "
    "a step that captures nothing runs exactly the ops of a run without "
    "capture. Epoch-neutral.")
register_knob(
    "kvstore.grad_compress", "MXNET_TPU_GRAD_COMPRESS", str, "",
    "gradient-sync wire compression: '2bit' quantizes gradients to "
    "{-threshold, 0, +threshold} with an error-feedback residual and "
    "sends the packed codes (4 a byte) in (a) the dist kvstore's push and "
    "(b) SPMDTrainer's step on meshes with a 'dcn' axis. Telemetry: "
    "kvstore.compressed_bytes / kvstore.compression_ratio. Empty "
    "(default) disables.")
register_knob(
    "kvstore.grad_compression_threshold",
    "MXTPU_GRAD_COMPRESSION_THRESHOLD", float, 0.5,
    "threshold of the 2-bit gradient compression "
    "(kvstore.set_gradient_compression and kvstore.grad_compress).")
register_knob(
    "embedding.sharded", "MXNET_TPU_EMBEDDING_SHARDED", bool, True,
    "route trainable sparse-grad embedding tables "
    "(gluon.nn.Embedding(sparse_grad=True)) through SPMDTrainer's "
    "deduplicated row-sparse path (parallel/embedding.py): table sharded "
    "on the vocab axis over a multi-rank mesh, ids deduplicated per "
    "global batch, only touched rows of the table and optimizer state "
    "rewritten. False = dense table gradient and a full-table optimizer "
    "step. Read when a trainer is built.")
register_knob(
    "embedding.unique_size", "MXNET_TPU_EMBEDDING_UNIQUE_SIZE", int, 0,
    "static per-batch unique-id capacity of the deduplicated embedding "
    "lookup: 0 (default) = the batch's id count, always safe; a positive "
    "cap shrinks the gathered buffers, and ids beyond it are dropped.")
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
    "quantization drift sampling of served int8 models. Not ported yet "
    "(slice 15 part 2: the serving side; numerics.update_quant_drift is "
    "the host arithmetic); Server.register(quantized=True) raises "
    "NotImplementedError when it is > 0. Epoch-neutral.")
register_knob(
    "quant.drift_threshold", "MXNET_TPU_QUANT_DRIFT_THRESHOLD", float, 1.5,
    "drift alarm bound of numerics.update_quant_drift: a quantized site "
    "whose smoothed runtime-amax / calibrated-amax ratio exceeds this is "
    "counted drifted. Epoch-neutral.")
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
# fault tolerance (mx.resilience, mx.elastic)
register_knob(
    "resilience.nanguard", "MXNET_TPU_NANGUARD", str, "",
    "non-finite step guard: 'skip' drops the update of a step whose loss "
    "or gradients hold a NaN or an Inf (the parameters, optimizer state "
    "and BatchNorm statistics keep their values; <source>.nonfinite_steps "
    "counts such steps) and aborts with a checkpoint after "
    "nanguard_patience consecutive bad steps; 'abort' aborts on the first. "
    "The fused steps (SPMDTrainer, the Module's fused step) check on the "
    "card and skip inside the fused optimizer kernels, with no host sync; "
    "the eager loops (gluon.Trainer, the Module's eager step) check on the "
    "host. Empty (default) disables.")
register_knob(
    "resilience.nanguard_patience", "MXNET_TPU_NANGUARD_PATIENCE", int, 25,
    "consecutive non-finite steps tolerated under nanguard=skip before the "
    "run aborts with a checkpoint (abort mode always uses 1).")
register_knob(
    "resilience.on_preempt", "MXNET_TPU_ON_PREEMPT", str, "",
    "'save_and_exit' installs SIGTERM/SIGINT handlers: the training loops "
    "finish the step in flight, checkpoint, flush and exit 0 (a second "
    "signal ends the process at once). Empty (default) leaves the signals "
    "alone.")
register_knob(
    "resilience.ckpt_every_n_steps", "MXNET_TPU_CKPT_EVERY", int, 0,
    "CheckpointManager's default cadence: maybe_save() writes every N "
    "steps (0 = only explicit save() calls).")
register_knob(
    "resilience.ckpt_keep", "MXNET_TPU_CKPT_KEEP", int, 3,
    "CheckpointManager's retention: keep the newest K checkpoints, prune "
    "older ones (<= 0 keeps everything).")
register_knob(
    "resilience.faults", "MXNET_TPU_FAULTS", str, "",
    "deterministic fault-injection spec, e.g. "
    "'io:0.05,ckpt_write:1@step=3,nan:1@step=7' — kind:probability per "
    "opportunity, or kind:count@step=N (1-based). Kinds: io (batch fetch), "
    "kvstore (push/pull), ckpt_write (inside atomic_write), nan (poison a "
    "training batch), peer_preempt (a peer's preemption inside "
    "mx.elastic's cluster agreement), dcn_push (fail a dist kvstore hop), "
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


def _apply_quant_drift_threshold(value):
    if float(value) <= 0:
        _OVERRIDES.pop("quant.drift_threshold", None)
        raise ValueError("quant.drift_threshold must be > 0, got %r"
                         % (value,))


def _apply_resilience_faults(_value):
    from . import resilience
    resilience.configure_faults()


def _apply_resilience_retry(_value):
    from . import resilience
    resilience.configure_retry()


def _apply_resilience_nanguard(value):
    if (value or "").strip() not in ("", "skip", "abort"):
        # reject at set() time and revert: a typo must not leave training
        # unguarded until the next step
        _OVERRIDES.pop("resilience.nanguard", None)
        raise ValueError("resilience.nanguard must be '', 'skip' or "
                         "'abort', got %r" % (value,))


def _apply_resilience_preempt(value):
    from . import resilience
    resilience.configure_preemption(value)


# the profiler, the telemetry step log, the causal tracing and the hang
# watchdog (mx.profiler, mx.telemetry, mx.tracing)
register_knob(
    "profiler.autostart", "MXNET_PROFILER_AUTOSTART", bool, False,
    "start an mx.profiler session (torch.profiler) when mx.profiler is "
    "imported, mirroring MXNET_PROFILER_AUTOSTART.")
register_knob(
    "profiler.filename", "MXNET_PROFILER_FILENAME", str, "profile.json",
    "default Chrome-trace output path for mx.profiler.dump().")
register_knob(
    "telemetry.sink", "MXNET_TPU_TELEMETRY", str, "",
    "structured step-event log sink: 'jsonl:<path>' appends one JSON "
    "record per train step (Module/SPMDTrainer/gluon.Trainer) with wall "
    "time, dispatch path, compile/host-sync deltas, throughput and the "
    "card's memory watermark, in the reference's schema (its "
    "tools/telemetry_report.py reads it). Empty (default) disables the "
    "log; the metrics registry itself stays on.")
register_knob(
    "tracing.sink", "MXNET_TPU_TRACE", str, "",
    "causal span trace sink: 'chrome:<path>' streams framework spans "
    "(step/shard_batch/fused_dispatch/opt_update/prefetch/push/pull/"
    "allreduce, with contextvars parent/child links that survive thread "
    "hops) as Chrome trace events, one a line; merge with a "
    "torch.profiler export through mxnet_tpu_torch.trace_merge. Empty "
    "(default) disables: span() is a shared no-op when no sink, watchdog "
    "or profiler session is active.")
register_knob(
    "tracing.watchdog", "MXNET_TPU_WATCHDOG", float, 0.0,
    "hang-watchdog deadline in seconds: > 0 starts a daemon thread that, "
    "when no train step completes within the deadline, dumps thread "
    "stacks, open spans with ages, the flight-recorder event ring, the "
    "card's memory and gauge snapshots to a timestamped "
    "watchdog_report_*.json, then lets the job run on. 0 (default) "
    "disables.")
register_knob(
    "tracing.watchdog_dir", "MXNET_TPU_WATCHDOG_DIR", str, "",
    "directory for watchdog flight-recorder reports; empty (default) = "
    "the current working directory.")
register_knob(
    "tracing.ring_size", "MXNET_TPU_TRACE_RING", int, 256,
    "flight-recorder bound: how many recent span/step events the "
    "in-memory ring keeps for the watchdog report.")


def _apply_numerics_capture(value):
    from . import numerics
    try:
        numerics.configure(value)
    except ValueError:
        # reject at set() time and revert: a typo'd cadence must not
        # linger as the stored override
        _OVERRIDES.pop("numerics.capture", None)
        raise


def _apply_telemetry_sink(value):
    from . import telemetry
    telemetry.configure_sink(value)


def _apply_tracing_sink(value):
    from . import tracing
    tracing.configure_sink(value)


def _apply_tracing_watchdog(value):
    from . import tracing
    tracing.configure_watchdog(value, report_dir=get("tracing.watchdog_dir"))


def _apply_tracing_watchdog_dir(_value):
    # the directory must land even when only it changes: the nanguard
    # abort's on-demand report reads it without an armed deadline
    _apply_tracing_watchdog(get("tracing.watchdog"))


def _apply_tracing_ring(value):
    from . import tracing
    tracing.configure_ring(value)


# the operational plane: exporter, access log, SLOs (mx.obs)
register_knob(
    "obs.listen", "MXNET_TPU_OBS_LISTEN", str, "",
    "operational-plane exporter address as 'host:port' (port 0 binds an "
    "ephemeral port; obs.exporter_address() reports it): starts a daemon "
    "HTTP thread serving /metrics (Prometheus text rendered from the "
    "telemetry registry, plus SLO burn rates), /healthz (breaker states, "
    "batcher/engine liveness and stalls, KV-pool saturation, last-step "
    "age; non-200 when unhealthy), and /varz (effective knobs with "
    "provenance). Empty (default) disables: no thread, no socket.")
register_knob(
    "obs.access_log", "MXNET_TPU_OBS_ACCESS_LOG", str, "",
    "per-request access log sink: 'jsonl:<path>' appends one JSON record "
    "per serving/generation request (request_id = the span trace_id, "
    "model, queue_ms, dispatch_ms, ttft_ms, tokens, bytes, flops, outcome "
    "ok|shed|deadline|breaker|error) that joins against the tracing.sink "
    "Chrome trace on trace_id. Empty (default) disables: the serving hot "
    "path gains one predicate per request.")
register_knob(
    "obs.slo", "MXNET_TPU_OBS_SLO", str, "",
    "serving SLO objectives as 'key=value[,key=value...]': "
    "'availability=99.9' (percent of requests that must not end "
    "shed/deadline/breaker/error) and 'latency_p99_ms=50' (windowed p99 "
    "bound on the timer named by 'timer=', default serving.request_ms). "
    "Arms multi-window burn-rate tracking (5m/1h fast, 30m/6h slow) "
    "exposed on /metrics and obs.slo_status(). Empty (default) disables.")

# cost attribution and the measured launch-parameter search (mx.perf,
# mx.autotune)
register_knob(
    "perf.profile", "MXNET_TPU_PROFILE", str, "",
    "periodic device-trace capture: 'step:N' runs one whole train step "
    "under a torch.profiler session every N completed steps (written "
    "under perf.profile_dir, folded with the chrome span sink through "
    "trace_merge when tracing.sink is active). Empty (default) disables: "
    "the mx.perf step hook then costs one dict pop.")
register_knob(
    "perf.profile_dir", "MXNET_TPU_PROFILE_DIR", str, "",
    "directory for perf.profile step captures (one perf_step_<source>_<n>/ "
    "subdirectory per capture); empty (default) = the current working "
    "directory.")
register_knob(
    "perf.autotune", "MXNET_TPU_AUTOTUNE", str, "auto",
    "mx.autotune mode. 'auto' (default): apply persisted winners; on a "
    "cache miss keep each kernel's fixed launch rule and measure nothing. "
    "'measure': run the measured search on a miss (the card only) and "
    "write the winner through. 'off': no cache, the fixed rules.")
register_knob(
    "perf.autotune_cache", "MXNET_TPU_AUTOTUNE_CACHE", str, "",
    "path of the persisted tuning cache (JSON). Empty (default) = "
    "<model_store.root>/autotune.json, i.e. ~/.mxnet/autotune.json. "
    "Entries are keyed by family/site + device name + dominant dtype + a "
    "fingerprint of the knob values the kernels launch against.")


def _apply_obs_listen(value):
    from . import obs
    try:
        obs.configure_listen(value)
    except (ValueError, OSError):
        # reject at set() time and revert: a typo'd address or an
        # unbindable port must not linger as the override
        _OVERRIDES.pop("obs.listen", None)
        raise


def _apply_obs_access_log(value):
    from . import obs
    try:
        obs.configure_access_log(value)
    except ValueError:
        _OVERRIDES.pop("obs.access_log", None)
        raise


def _apply_obs_slo(value):
    from . import obs
    try:
        obs.configure_slo(value)
    except ValueError:
        _OVERRIDES.pop("obs.slo", None)
        raise


def _apply_perf_profile(value):
    from . import perf
    try:
        perf.configure_profile(value)
    except ValueError:
        _OVERRIDES.pop("perf.profile", None)
        raise


# the last accepted programmatic perf.autotune (None: no override)
_AUTOTUNE_OVERRIDE = [None]


def _apply_perf_autotune(value):
    v = (value or "").strip().lower()
    if v not in ("off", "auto", "measure"):
        # reject at set() time and revert to the value before the set
        if _AUTOTUNE_OVERRIDE[0] is None:
            _OVERRIDES.pop("perf.autotune", None)
        else:
            _OVERRIDES["perf.autotune"] = _AUTOTUNE_OVERRIDE[0]
        raise ValueError("perf.autotune must be 'off', 'auto' or "
                         "'measure', got %r" % (value,))
    _AUTOTUNE_OVERRIDE[0] = _OVERRIDES.get("perf.autotune")
    from . import autotune
    autotune.reset_memo()


def _apply_perf_autotune_cache(_value):
    from . import autotune
    autotune.reset_memo()


_ON_SET["obs.listen"] = _apply_obs_listen
_ON_SET["obs.access_log"] = _apply_obs_access_log
_ON_SET["obs.slo"] = _apply_obs_slo
_ON_SET["perf.profile"] = _apply_perf_profile
_ON_SET["perf.autotune"] = _apply_perf_autotune
_ON_SET["perf.autotune_cache"] = _apply_perf_autotune_cache
_ON_SET["numerics.capture"] = _apply_numerics_capture
_ON_SET["telemetry.sink"] = _apply_telemetry_sink
_ON_SET["tracing.sink"] = _apply_tracing_sink
_ON_SET["tracing.watchdog"] = _apply_tracing_watchdog
_ON_SET["tracing.watchdog_dir"] = _apply_tracing_watchdog_dir
_ON_SET["tracing.ring_size"] = _apply_tracing_ring
_ON_SET["quant.calib_mode"] = _apply_quant_calib_mode
_ON_SET["quant.drift_every"] = _apply_quant_drift_every
_ON_SET["quant.drift_threshold"] = _apply_quant_drift_threshold
_ON_SET["resilience.faults"] = _apply_resilience_faults
_ON_SET["resilience.fault_seed"] = _apply_resilience_faults
_ON_SET["resilience.retry_attempts"] = _apply_resilience_retry
_ON_SET["resilience.retry_base_s"] = _apply_resilience_retry
_ON_SET["resilience.nanguard"] = _apply_resilience_nanguard
_ON_SET["resilience.on_preempt"] = _apply_resilience_preempt

# multi-process elasticity (mx.elastic)
register_knob(
    "elastic.dir", "MXTPU_ELASTIC_DIR", str, "",
    "state directory of an elastic run (set by `python -m "
    "mxnet_tpu_torch.launch --elastic`): heartbeat leases, preemption "
    "flags and the coordinated checkpoints. Non-empty activates "
    "mx.elastic's per-step cluster preemption agreement.")
register_knob(
    "elastic.generation", "MXTPU_ELASTIC_GENERATION", int, 0,
    "restart generation of an elastic run (0 = first launch), exported by "
    "the elastic launcher.")
register_knob(
    "elastic.heartbeat_s", "MXTPU_ELASTIC_HEARTBEAT_S", float, 1.0,
    "heartbeat interval of the elastic lease loop; a peer whose lease goes "
    "stale for 5x this interval is declared lost "
    "(elastic.peer_lease_expired).")
register_knob(
    "elastic.on_peer_loss", "MXTPU_ELASTIC_ON_PEER_LOSS", str, "abort",
    "reaction when a peer's heartbeat lease expires: 'abort' (default) "
    "flushes and exits with code 75, so the elastic launcher re-forms the "
    "world (rescuing ranks blocked in a collective on the dead peer); "
    "'flag' only records it (HeartbeatMonitor.peer_lost).")


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


def _apply_kvstore_grad_compress(value):
    if (value or "").strip() not in ("", "2bit"):
        # reject at set() time and revert: a mistyped codec must not train
        # uncompressed while claiming otherwise
        _OVERRIDES.pop("kvstore.grad_compress", None)
        raise ValueError("kvstore.grad_compress must be '' or '2bit', "
                         "got %r" % (value,))


def _apply_embedding_unique_size(value):
    if int(value) < 0:
        _OVERRIDES.pop("embedding.unique_size", None)
        raise ValueError("embedding.unique_size must be >= 0, got %r"
                         % (value,))


_ON_SET["kvstore.grad_compress"] = _apply_kvstore_grad_compress
_ON_SET["embedding.unique_size"] = _apply_embedding_unique_size


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
