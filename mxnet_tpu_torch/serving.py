"""``mx.serving`` — the inference server (counterpart of
``mxnet_tpu.serving``): continuous batching of one-shot predicts over
``mx.deploy`` artifacts, and token-level generation.

Usage::

    srv = mx.serving.Server(max_batch=32, max_queue_delay_ms=2.0)
    srv.register("resnet", "/models/resnet50")       # params -> device
    srv.register("resnet8", "/models/r50_int8", quantized=True)
    srv.register("lm", "/models/lm", generate=True)
    srv.start()                                      # warm every bucket
    probs = srv.predict("resnet", images)            # any row count
    ids = srv.generate("lm", prompt, max_new_tokens=32)
    srv.stop()                                       # graceful drain

One-shot path (one batcher thread a server, under a restart supervisor)::

  submit(name, x) --> admission --> FIFO --> batcher: take the first request,
                      (bounded queue,        reap expired deadlines, coalesce
                       breaker state)        same-model requests until rows ==
                                             max_batch or max_queue_delay_ms
                                             elapses, concatenate, wrap-pad to
                                             the bucket, run the program,
                                             scatter rows -> caller futures

* **Buckets** — batches pad up to the shared ``io.pad_buckets`` set
  (``pow2`` by default) capped at ``max_batch``, so a small, fixed set of
  shapes serves every request size; each is warmed at :meth:`start`
  (``serving.compiles`` counts them: PyTorch runs eagerly, so a warm-up
  run stands where the reference compiles).
* **Rows** — each served row is its own batch-1 ``predict`` row: bitwise
  on the CPU (the predictor runs there a row at a time); on the card
  cuDNN and cuBLAS choose kernels by batch shape, so the f32 rows can
  differ in the last bits (``chip_smoke.py`` measures the gap).
* **Overload and deadlines** — submits past ``serving.max_pending`` shed
  (:class:`ServerOverloadedError`); a request queued past its
  ``deadline_ms`` completes with :class:`DeadlineExceededError` and is
  never dispatched; ``predict(timeout=...)`` cancels its queued request.
* **Breaker** — a per-model circuit breaker opens after
  ``serving.breaker_threshold`` consecutive dispatch failures, fails that
  model fast (:class:`CircuitOpenError`) while the others serve, and
  half-opens after the cooldown to probe with one batch.
* **Supervision** — a batcher crash fails every pending future with the
  causal exception, counts ``serving.batcher_crashes`` and restarts the
  loop under ``resilience.call_with_retry``'s budget; once it is spent,
  submits fail fast.
* **Multi-model** — an LRU table of at most ``max_models`` one-shot
  models; a quantized (int8, format v3) model sits beside an f32 one,
  its int8 sites recolored once at load.
* **Chaos** — the ``serving_dispatch`` (fail a batch) and
  ``serving_slow`` (delay it) kinds of the ``MXNET_TPU_FAULTS`` harness
  script every failure path.

Generation models (``register(..., generate=True)``) get their own
:class:`~mxnet_tpu_torch.generation.GenerationEngine`: a per-iteration
continuous-batching scheduler over a paged, device-resident KV cache,
with the same admission, deadline and breaker semantics.

Telemetry: ``serving.requests``, ``batch_dispatches``, ``compiles``,
``shed_requests[.model]``, ``deadline_exceeded[.model]``,
``breaker_open[.model]``, ``batcher_crashes``, ``quantized_dispatches``,
``drift_samples`` counters; ``serving.breaker_state.<model>``,
``serving.pending``, ``serving.flops_per_request.<model>`` and
``serving.bytes_per_request.<model>`` gauges; ``serving.queue_delay_ms``,
``batch_fill``, ``dispatch_ms``, ``request_ms``, ``drift_ms`` timers.

Observability (``mx.obs``, ``mx.tracing``, ``mx.perf``):

* **Spans** — ``serving.compile`` around each warm-up, ``serving.submit``
  around each submit (its ``trace_id`` is the request's id),
  ``serving.dispatch`` around each batch's run.
* **Cost** — each warmed ``(model, bucket)`` runs once under
  ``perf.cost_analysis`` and registers as ``serving/<model>/b<bucket>``;
  the largest bucket's per-row FLOPs and bytes set the
  ``serving.flops_per_request`` / ``bytes_per_request`` gauges and each
  ok access record's ``flops``.
* **Access log** — one ``obs.log_access`` record per request at its
  terminal outcome (ok / shed / deadline / breaker / error).
* **Health and stalls** — ``start`` registers :meth:`Server._health` on
  ``obs`` (``/healthz``) and :meth:`Server._stall_probe` on the watchdog;
  ``stop`` takes them off.  With the watchdog armed
  (``tracing.watchdog``), a batcher or engine whose queue waits past
  that deadline with no progress turns ``/healthz`` unhealthy
  (``batcher_stalled`` / ``engine_stalled:<model>``) until it moves.
* **Drift** — a quantized model whose artifact ships a stats twin
  (``quantization.stats_twin``) runs it on every
  ``quant.drift_every``-th dispatched batch and passes the site amaxes
  to ``numerics.update_quant_drift``; an artifact without one serves
  without sampling.

Not ported: a persistent compile cache (there is nothing to cache until
the shapes run as CUDA graphs).

Knobs: ``serving.max_batch``, ``serving.max_queue_delay_ms``,
``serving.max_pending``, ``serving.default_deadline_ms``,
``serving.breaker_threshold`` / ``serving.breaker_cooldown_ms`` and the
shared ``io.pad_buckets``.
"""
from __future__ import annotations

import logging
import threading
import time as _time
from collections import OrderedDict, deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout

import numpy as _np
import torch

from . import config as _config
from . import io as _io
from . import obs as _obs
from . import telemetry as _telemetry
from . import tracing as _tracing

__all__ = ["Server", "ServingError", "ServerOverloadedError",
           "DeadlineExceededError", "CircuitOpenError", "load_server"]

_LOG = logging.getLogger("mxnet_tpu_torch.serving")

#: the ``serving_slow`` fault's sleep: long enough to make shed and
#: deadline schedules deterministic, short enough for quick chaos tests
_SLOW_DISPATCH_S = 0.25


class ServingError(RuntimeError):
    """Serving lifecycle errors (stopped server, evicted or unknown model,
    dead batcher or engine)."""


class ServerOverloadedError(ServingError, OSError):
    """The pending queue is at ``serving.max_pending``: the request was
    shed instead of queued.  Retryable (OSError subclass)."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired while it was still queued: it was
    completed with this error and never dispatched."""


class CircuitOpenError(ServingError, OSError):
    """The model's circuit breaker is open after consecutive dispatch
    failures.  Retryable (OSError subclass): the breaker goes half-open
    after its cooldown and probes with a single dispatch."""


class _BatcherCrashError(OSError):
    """Internal: wraps a batcher-loop crash so
    ``resilience.call_with_retry`` (which retries OSError) drives the
    restart backoff and bounds the restart budget."""


def _access_outcome(exc):
    """The access-log outcome of a request-terminal exception."""
    if isinstance(exc, CircuitOpenError):
        return "breaker"
    if isinstance(exc, DeadlineExceededError):
        return "deadline"
    if isinstance(exc, ServerOverloadedError):
        return "shed"
    return "error"


def _err(exc):
    return "%s: %s" % (type(exc).__name__, exc)


class _Request:
    """One caller request: host rows, the future its output rows resolve,
    the submit time, an optional absolute deadline and the submit span's
    trace id (the access record's request id)."""

    __slots__ = ("model", "data", "rows", "future", "t_submit", "deadline",
                 "trace_id")

    def __init__(self, model, data, future, deadline_ms=0.0,
                 trace_id=None):
        self.model = model
        self.data = data
        self.rows = int(data.shape[0])
        self.future = future
        self.t_submit = _time.perf_counter()
        self.deadline = (self.t_submit + float(deadline_ms) * 1e-3) \
            if deadline_ms and deadline_ms > 0 else None
        self.trace_id = trace_id

    def expired(self, now=None):
        if self.deadline is None:
            return False
        return (now if now is not None else _time.perf_counter()) \
            >= self.deadline


_BREAKER_STATE_VALUE = {"closed": 0, "half_open": 1, "open": 2}


class _Breaker:
    """Per-model circuit breaker: ``closed`` -> ``open`` after
    ``threshold`` consecutive dispatch failures -> ``half_open`` once the
    cooldown elapses (ONE probe dispatch goes through) -> ``closed`` on
    probe success / back to ``open`` on probe failure.  ``threshold <= 0``
    disables the breaker."""

    __slots__ = ("model", "threshold", "cooldown_s", "state", "failures",
                 "opened_at", "_lock")

    def __init__(self, model, threshold, cooldown_s):
        self.model = model
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        # reads on the submit fast path are deliberately lock-free (a stale
        # read only delays a fast-fail by one dispatch)
        self.state = "closed"    # guarded-by[writes]: _lock
        self.failures = 0        # guarded-by[writes]: _lock
        self.opened_at = 0.0     # guarded-by[writes]: _lock
        self._lock = threading.Lock()

    def _set_state(self, state):  # holds(_lock)
        self.state = state
        _telemetry.gauge("serving.breaker_state.%s" % self.model).set(
            _BREAKER_STATE_VALUE[state])

    def cooldown_remaining_ms(self):
        return max(0.0, (self.cooldown_s
                         - (_time.perf_counter() - self.opened_at))) * 1e3

    def rejects_submit(self):
        """Fast-fail check on the submit path: only while OPEN and inside
        the cooldown."""
        if self.threshold <= 0 or self.state != "open":
            return False
        return _time.perf_counter() - self.opened_at < self.cooldown_s

    def allow_dispatch(self):
        """Dispatch-side gate: an open breaker whose cooldown elapsed turns
        half-open and lets this ONE dispatch through as the probe."""
        if self.threshold <= 0:
            return True
        with self._lock:
            if self.state != "open":
                return True
            if _time.perf_counter() - self.opened_at < self.cooldown_s:
                return False
            self._set_state("half_open")
        return True

    def record_success(self):
        if self.threshold <= 0:
            return
        with self._lock:
            self.failures = 0
            if self.state != "closed":
                self._set_state("closed")

    def record_failure(self):
        if self.threshold <= 0:
            return
        with self._lock:
            self.failures += 1
            if self.state == "half_open":
                opened = True
            else:
                opened = self.state == "closed" \
                    and self.failures >= self.threshold
            if opened:
                self.opened_at = _time.perf_counter()
                self._set_state("open")
        if opened:
            _telemetry.counter("serving.breaker_open").inc()
            _telemetry.counter("serving.breaker_open.%s" % self.model).inc()
            _LOG.warning(
                "serving: breaker for model %r OPEN after %d consecutive "
                "dispatch failure(s); failing fast for %.0fms",
                self.model, self.failures, self.cooldown_s * 1e3)


class _ModelEntry:
    """A registered one-shot model: the loaded predictor (params on the
    device), its buckets and warmed shapes, its breaker and its shed /
    deadline tallies."""

    __slots__ = ("name", "prefix", "predictor", "buckets", "warmed",
                 "item_shape", "in_dtype", "breaker", "shed",
                 "deadline_exceeded", "quantized", "cost_per_item",
                 "drift_call", "drift_sites", "drift_count", "drift_ewma")

    def __init__(self, name, prefix, predictor, buckets):
        self.name = name
        self.prefix = prefix
        self.predictor = predictor
        self.quantized = bool(predictor.quantized)
        self.buckets = tuple(buckets)
        self.warmed = set()
        shape = predictor.meta.get("input_shape") or []
        self.item_shape = tuple(int(s) for s in shape[1:])
        self.in_dtype = _np.dtype(predictor.meta.get("input_dtype",
                                                     "float32"))
        self.breaker = None   # assigned by Server.register
        self.shed = 0
        self.deadline_exceeded = 0
        # per-row cost of the largest warmed bucket (mx.perf)
        self.cost_per_item = None
        # the drift probe: the stats twin, loaded at first use (False: the
        # artifact ships none)
        self.drift_call = None
        self.drift_sites = tuple(predictor.meta.get("stats_sites") or ())
        self.drift_count = 0
        self.drift_ewma = {}

    @property
    def capacity(self):
        return self.buckets[-1]


class Server:
    """Continuous-batching inference server over ``mx.deploy`` artifacts.

    ``submit`` is thread-safe: requests from any number of caller threads
    coalesce into bucketed batches on the one batcher thread.  A request
    larger than the biggest bucket is split into chunks whose outputs are
    concatenated again.  ``device`` is where registered models live:
    ``cuda:0`` by default (raises without a GPU), ``"cpu"`` or
    ``mx.cpu()`` on request.  ``Server`` is a context manager (``with
    Server() as srv:`` starts and drains it)."""

    def __init__(self, max_batch=None, max_queue_delay_ms=None,
                 buckets=None, max_models=8, max_pending=None,
                 default_deadline_ms=None, breaker_threshold=None,
                 breaker_cooldown_ms=None, device=None):
        if max_batch is None:
            max_batch = _config.get("serving.max_batch")
        if max_queue_delay_ms is None:
            max_queue_delay_ms = _config.get("serving.max_queue_delay_ms")
        if buckets is None:
            buckets = _config.get("io.pad_buckets")
        if max_pending is None:
            max_pending = _config.get("serving.max_pending")
        if default_deadline_ms is None:
            default_deadline_ms = _config.get("serving.default_deadline_ms")
        if breaker_threshold is None:
            breaker_threshold = _config.get("serving.breaker_threshold")
        if breaker_cooldown_ms is None:
            breaker_cooldown_ms = _config.get("serving.breaker_cooldown_ms")
        self.max_batch = int(max_batch)
        self.max_queue_delay_ms = float(max_queue_delay_ms)
        self._bucket_policy = buckets
        self.max_models = int(max_models)
        self.max_pending = int(max_pending)
        self.default_deadline_ms = float(default_deadline_ms)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_ms = float(breaker_cooldown_ms)
        self.device = device
        self._models = OrderedDict()     # guarded-by: _cond — LRU order
        self._generation = {}            # guarded-by: _cond
        self._pending = deque()          # guarded-by: _cond
        self._cond = threading.Condition()
        # guarded-by[writes]: _cond — stop() joins outside the lock
        self._thread = None
        self._leaked_thread = None       # batcher that missed stop()'s join
        self._batcher_dead = None        # guarded-by: _cond
        self._started = False            # guarded-by: _cond
        self._stopping = False           # guarded-by: _cond
        self._last_dispatch_done = _time.perf_counter()  # guarded-by: _cond
        self._probe_name = "serving.server.%x" % id(self)

    # ------------------------------------------------------------ models
    def _policy_buckets(self, cap):
        sizes = _io.bucket_sizes(self._bucket_policy, cap)
        # at least one shape: policy 'off' serves the full bucket alone
        return sizes or (cap,)

    def register(self, name, prefix, quantized=False, generate=False):
        """Load the artifact at ``prefix`` under ``name``: params go to the
        server's device now; the bucket shapes are warmed now if the
        server is started (else at :meth:`start`).  Re-registering a name
        replaces the entry (and resets its breaker).  The one-shot table
        is LRU-bounded at ``max_models``: registering past it evicts the
        least recently used model.

        ``quantized=True`` registers an int8 (format v3) artifact of
        ``quantization.export_quantized``; the flag must match the
        artifact.  ``generate=True`` registers a generation artifact of
        ``deploy.export_generation`` under its own
        :class:`~mxnet_tpu_torch.generation.GenerationEngine` (outside the
        LRU table; drive it with :meth:`submit_generate` /
        :meth:`generate`)."""
        from . import deploy as _deploy
        if generate:
            if quantized:
                raise ServingError(
                    "model %r: generate=True with quantized=True is not "
                    "supported — KV quantisation is chosen at EXPORT time "
                    "(export_generation(..., kv_quantized=True))" % (name,))
            return self._register_generation(name, prefix)
        predictor = _deploy.load_model(prefix, quantized=quantized,
                                       device=self.device)
        if predictor._params is None:
            raise ServingError(
                "model %r: artifact %r was exported with "
                "include_params=False; serving needs shipped params"
                % (name, prefix))
        if predictor.dynamic_batch:
            buckets = self._policy_buckets(self.max_batch)
        else:
            # a fixed-batch artifact's one batch size is its bucket set
            buckets = (int(predictor.meta["input_shape"][0]),)
        entry = _ModelEntry(name, prefix, predictor, buckets)
        entry.breaker = _Breaker(name, self.breaker_threshold,
                                 self.breaker_cooldown_ms * 1e-3)
        with self._cond:
            self._models.pop(name, None)
            self._models[name] = entry
            evicted = []
            while len(self._models) > self.max_models:
                victim, _ = self._models.popitem(last=False)
                evicted.append(victim)
            started = self._started
        for victim in evicted:
            _telemetry.counter("serving.models_evicted").inc()
            _LOG.info("serving: evicted LRU model %r (max_models=%d)",
                      victim, self.max_models)
        if started:
            self._warm_entry(entry)
        return entry

    def _register_generation(self, name, prefix):
        from .deploy import load_generator
        from .generation import GenerationEngine
        predictor = load_generator(prefix, device=self.device)
        if not predictor.has_params:
            raise ServingError(
                "model %r: artifact %r was exported with "
                "include_params=False; serving needs shipped params"
                % (name, prefix))
        engine = GenerationEngine(
            name, predictor,
            breaker=_Breaker(name, self.breaker_threshold,
                             self.breaker_cooldown_ms * 1e-3),
            max_pending=self.max_pending,
            default_deadline_ms=self.default_deadline_ms)
        with self._cond:
            old = self._generation.pop(name, None)
            self._generation[name] = engine
            started = self._started
        if old is not None:
            old.stop(drain=False)
        if started:
            engine.start()
        return engine

    def unregister(self, name):
        with self._cond:
            self._models.pop(name, None)
            engine = self._generation.pop(name, None)
        if engine is not None:
            engine.stop(drain=False)

    def models(self):
        """Registered model names, least recently used first (one-shot
        models; generation models follow)."""
        with self._cond:
            return list(self._models) + list(self._generation)

    def _entry(self, name):
        with self._cond:
            entry = self._models.get(name)
            if entry is not None:
                self._models.move_to_end(name)  # LRU touch
            is_generation = entry is None and name in self._generation
        if is_generation:
            raise ServingError(
                "model %r is a GENERATION model (registered with "
                "generate=True): it serves token streams, not one-shot "
                "predicts — use submit_generate()/generate()" % (name,))
        if entry is None:
            raise ServingError(
                "unknown model %r (registered: %s — evicted models must "
                "be register()ed again)" % (name, self.models()))
        return entry

    def _engine(self, name):
        with self._cond:
            engine = self._generation.get(name)
            is_oneshot = engine is None and name in self._models
        if is_oneshot:
            raise ServingError(
                "model %r is a one-shot predict model: register a "
                "deploy.export_generation artifact with generate=True to "
                "generate — use submit()/predict() for it" % (name,))
        if engine is None:
            raise ServingError("unknown generation model %r (registered: "
                               "%s)" % (name, self.models()))
        return engine

    # ------------------------------------------------------------- warm-up
    def _warm_entry(self, entry):
        for bucket in entry.buckets:
            if bucket not in entry.warmed:
                self._warm(entry, bucket)

    def _warm(self, entry, bucket):
        """Run the program once at ``bucket`` rows (library handles, cuDNN
        algorithm choice, the allocator's pool): the port's counterpart of
        the reference's per-bucket compile.  The run is counted by
        ``perf.cost_analysis`` and registered as
        ``serving/<model>/b<bucket>``."""
        from . import perf as _perf
        pred = entry.predictor
        t0 = _time.perf_counter()
        x = torch.from_numpy(_np.zeros(
            (bucket,) + entry.item_shape, entry.in_dtype)).to(pred.device)
        with _tracing.span("serving.compile", cat="serving",
                           model=entry.name, bucket=bucket):
            _, cost = _perf.cost_analysis(pred.run, x)
            if pred.device.type == "cuda":
                torch.cuda.synchronize(pred.device)
        t1 = _time.perf_counter()
        entry.warmed.add(bucket)
        _telemetry.counter("serving.compiles").inc()
        _telemetry.timer("serving.compile_ms").observe((t1 - t0) * 1e3)
        rec = _perf.register_compiled(
            "serving", "%s/b%d" % (entry.name, bucket), cost,
            phases_ms={"run_ms": (t1 - t0) * 1e3},
            dtype="int8" if entry.quantized else str(entry.in_dtype))
        if rec["flops"] > 0:
            # per-request cost from the largest bucket warmed so far: its
            # amortization is what a full batch achieves
            prev = entry.cost_per_item
            if prev is None or bucket >= prev["bucket"]:
                entry.cost_per_item = {
                    "flops": rec["flops"] / bucket,
                    "bytes": rec["bytes_accessed"] / bucket,
                    "bucket": bucket}
                _telemetry.gauge(
                    "serving.flops_per_request.%s" % entry.name).set(
                    round(entry.cost_per_item["flops"], 1))
                _telemetry.gauge(
                    "serving.bytes_per_request.%s" % entry.name).set(
                    round(entry.cost_per_item["bytes"], 1))

    # ------------------------------------------------- quantization drift
    def _load_drift_twin(self, entry):
        """The artifact's stats twin as ``fn(x) -> [S]`` over the entry's
        staged params, or False when the artifact ships none."""
        from .quantization import stats_twin
        pred = entry.predictor
        twin = stats_twin(entry.prefix, pred._graph, pred.meta)
        if twin is None:
            return False
        sites, fn = twin
        entry.drift_sites = tuple(sites)

        def call(x):
            env = dict(pred._params)
            env[pred._input] = x
            with torch.inference_mode():
                return fn(env)
        return call

    def _maybe_sample_drift(self, entry, x):
        """Every ``quant.drift_every``-th quantized dispatch, run the
        dispatched batch ``x`` (a device tensor) through the artifact's
        stats twin and fold the per-site runtime amax into the drift EWMA
        (``quant.drift_ratio.<model>.<site>`` gauges, ``quant_drift``
        JSONL events past ``quant.drift_threshold``).  Off (0) by
        default: then this costs one knob read."""
        every = int(_config.get("quant.drift_every") or 0)
        if every <= 0 or not entry.drift_sites:
            return
        entry.drift_count += 1
        if entry.drift_count % every:
            return
        if entry.drift_call is None:
            entry.drift_call = self._load_drift_twin(entry)
        if entry.drift_call is False:
            return
        from . import numerics as _numerics
        t0 = _time.perf_counter()
        amaxes = entry.drift_call(x).cpu().numpy()
        _telemetry.counter("serving.drift_samples").inc()
        _telemetry.timer("serving.drift_ms").observe(
            (_time.perf_counter() - t0) * 1e3)
        cal = entry.predictor.meta.get("calibration") or {}
        _numerics.update_quant_drift(entry.name, entry.drift_sites, amaxes,
                                     cal.get("thresholds") or {},
                                     entry.drift_ewma)

    # --------------------------------------------------------- lifecycle
    def start(self):
        """Warm every registered ``(model, bucket)`` shape, start the
        generation engines and the supervised batcher.  Idempotent while
        running; restartable after :meth:`stop` — unless a previous
        batcher missed its join deadline and still runs, which raises
        instead of racing two batchers on one queue."""
        with self._cond:
            if self._started:
                return self
        if self._leaked_thread is not None:
            if self._leaked_thread.is_alive():
                raise ServingError(
                    "a previous batcher thread missed its stop() join "
                    "deadline and is still running; refusing to start a "
                    "second batcher over the same queue — wait for it to "
                    "exit (then start() again) or recreate the Server")
            self._leaked_thread = None
        with self._cond:
            entries = list(self._models.values())
            engines = list(self._generation.values())
        for entry in entries:
            self._warm_entry(entry)
        for engine in engines:
            engine.start()
        with self._cond:
            self._stopping = False
            self._batcher_dead = None
            self._started = True
            self._last_dispatch_done = _time.perf_counter()
            # wrap_context: dispatch spans keep the starter's trace
            # parentage across the thread hop
            self._thread = threading.Thread(
                target=_tracing.wrap_context(self._supervise), daemon=True,
                name="mx-serving-batcher")
        self._thread.start()
        _tracing.register_stall_probe(self._probe_name, self._stall_probe)
        _obs.register_health_source(self._probe_name, self._health)
        return self

    def stop(self, drain=True, timeout_s=30.0):
        """Stop the server.  New submits fail at once; with ``drain``
        (default) every queued request is dispatched before the batcher
        exits and every generation request runs to completion; with
        ``drain=False`` pending futures fail promptly with ServingError.
        A batcher that misses the join deadline is remembered, and a later
        :meth:`start` refuses while it is alive."""
        with self._cond:
            if not self._started:
                return
            self._stopping = True
            if not drain:
                abandoned = list(self._pending)
                self._pending.clear()
                _telemetry.gauge("serving.pending").set(0)
            else:
                abandoned = []
            self._cond.notify_all()
        for req in abandoned:
            if not req.future.done():
                req.future.set_exception(
                    ServingError("server stopped without drain"))
                _obs.log_access(req.model, "error", request_id=req.trace_id,
                                error="ServingError: server stopped "
                                "without drain")
        thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout_s)
            if thread.is_alive():
                _telemetry.counter("serving.stop_timeout").inc()
                self._leaked_thread = thread
                _LOG.warning(
                    "serving: batcher did not drain within %.1fs and was "
                    "leaked; start() will refuse until it exits",
                    timeout_s)
        _tracing.unregister_stall_probe(self._probe_name)
        _obs.unregister_health_source(self._probe_name)
        with self._cond:
            engines = list(self._generation.values())
        for engine in engines:
            engine.stop(drain=drain, timeout_s=timeout_s)
        with self._cond:
            self._started = False
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------ submit
    def _validate(self, entry, arr):
        if arr.ndim != len(entry.item_shape) + 1:
            raise ValueError(
                "model %r: request rank mismatch — exported signature is "
                "%s, got shape %s" % (entry.name,
                                      entry.predictor.signature(),
                                      tuple(arr.shape)))
        if tuple(arr.shape[1:]) != entry.item_shape:
            raise ValueError(
                "model %r: request item shape %s does not match the "
                "exported signature %s" % (entry.name, tuple(arr.shape),
                                           entry.predictor.signature()))
        if arr.dtype != entry.in_dtype:
            raise ValueError(
                "model %r: request dtype %s does not match the exported "
                "dtype %s" % (entry.name, arr.dtype, entry.in_dtype))
        if arr.shape[0] < 1:
            raise ValueError("model %r: empty request" % (entry.name,))

    def submit(self, name, data, deadline_ms=None):
        """Enqueue one request (any row count) for one-shot model
        ``name``; returns a ``concurrent.futures.Future`` resolving to the
        host numpy output rows of exactly the submitted rows.

        ``deadline_ms`` (default the ``serving.default_deadline_ms`` knob;
        0 = none) bounds the time in queue: a request still queued past it
        completes with :class:`DeadlineExceededError` and is never
        dispatched.  Raises :class:`ServerOverloadedError` at
        ``serving.max_pending`` and :class:`CircuitOpenError` while the
        model's breaker is open."""
        with _tracing.span("serving.submit", cat="serving",
                           model=name) as sp:
            # the submit span's trace id rides the request so its access
            # record joins the Chrome trace (None while tracing is off)
            return self._submit(name, data, deadline_ms, sp.trace_id)

    def _submit(self, name, data, deadline_ms, trace_id):
        from .ndarray.ndarray import NDArray
        entry = self._entry(name)
        if isinstance(data, NDArray):
            arr = data.asnumpy()
        elif isinstance(data, torch.Tensor):
            arr = data.detach().cpu().numpy()
        else:
            arr = _np.asarray(data)
        self._validate(entry, arr)
        _telemetry.counter("serving.requests").inc()
        breaker = entry.breaker
        if breaker is not None and breaker.rejects_submit():
            _telemetry.counter("serving.breaker_rejected").inc()
            _obs.log_access(name, "breaker", request_id=trace_id)
            raise CircuitOpenError(
                "model %r circuit breaker is OPEN after %d consecutive "
                "dispatch failure(s); failing fast for %.0fms more — other "
                "models keep serving, retry after the cooldown"
                % (name, breaker.failures, breaker.cooldown_remaining_ms()))
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline_ms = float(deadline_ms or 0.0)
        cap = entry.capacity
        if arr.shape[0] <= cap:
            req = _Request(name, arr, Future(), deadline_ms,
                           trace_id=trace_id)
            fut = self._enqueue(req)
            fut._mx_requests = (req,)
            return fut
        # oversized: cap-row chunks, concatenated again (each admitted
        # chunk gets its own access record, all under the submit's id)
        chunks = [arr[i:i + cap] for i in range(0, arr.shape[0], cap)]
        _telemetry.counter("serving.request_chunks").inc(len(chunks))
        reqs = [_Request(name, c, Future(), deadline_ms, trace_id=trace_id)
                for c in chunks]
        enqueued = []
        try:
            for r in reqs:
                self._enqueue(r)
                enqueued.append(r)
        except BaseException:
            # admission failed part-way: unwind the queued siblings
            self._cancel_queued(enqueued, ServingError(
                "sibling chunk was rejected; oversized request aborted"))
            raise
        futures = [r.future for r in reqs]
        combined = Future()
        remaining = [len(futures)]
        lock = threading.Lock()

        def _one_done(_f):
            with lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if not last or combined.done():
                return
            try:
                combined.set_result(_np.concatenate(
                    [f.result() for f in futures], axis=0))
            except BaseException as exc:  # noqa: BLE001
                combined.set_exception(exc)

        for f in futures:
            f.add_done_callback(_one_done)
        combined._mx_requests = tuple(reqs)
        return combined

    def _enqueue(self, req):
        shed = False
        with self._cond:
            if self._batcher_dead is not None:
                exc = self._batcher_dead
                raise ServingError(
                    "batcher thread crashed (%s: %s) and exhausted its "
                    "restart budget (resilience.retry_attempts); submit() "
                    "rejected — recreate the Server"
                    % (type(exc).__name__, exc))
            if self._stopping or not self._started:
                raise ServingError(
                    "server is %s; submit() rejected"
                    % ("stopping" if self._stopping else "not started"))
            if self.max_pending > 0 \
                    and len(self._pending) >= self.max_pending:
                entry = self._models.get(req.model)
                if entry is not None:
                    entry.shed += 1
                shed = True
            else:
                self._pending.append(req)
                _telemetry.gauge("serving.pending").set(len(self._pending))
                self._cond.notify_all()
        if shed:
            _telemetry.counter("serving.shed_requests").inc()
            _telemetry.counter("serving.shed_requests.%s" % req.model).inc()
            _obs.log_access(req.model, "shed", request_id=req.trace_id)
            raise ServerOverloadedError(
                "server overloaded: %d request(s) already pending "
                "(serving.max_pending=%d); request shed — back off and "
                "retry" % (self.max_pending, self.max_pending))
        return req.future

    def _cancel_queued(self, reqs, exc):
        """Remove still-queued requests and fail their futures with
        ``exc`` (a request already in a forming batch completes).  Returns
        the cancelled ones."""
        removed = []
        with self._cond:
            for req in reqs:
                try:
                    self._pending.remove(req)
                except ValueError:
                    continue
                removed.append(req)
            if removed:
                _telemetry.gauge("serving.pending").set(len(self._pending))
        outcome = _access_outcome(exc)
        for req in removed:
            if not req.future.done():
                req.future.set_exception(exc)
                if _obs.access_log_enabled():
                    _obs.log_access(
                        req.model, outcome, request_id=req.trace_id,
                        queue_ms=(_time.perf_counter() - req.t_submit)
                        * 1e3,
                        error=_err(exc) if outcome == "error" else None)
        return removed

    def predict(self, name, data, timeout=None, deadline_ms=None):
        """Synchronous ``submit(...).result(timeout)``.  On timeout the
        queued request is CANCELLED (never dispatched) and the call
        raises :class:`DeadlineExceededError`."""
        fut = self.submit(name, data, deadline_ms=deadline_ms)
        try:
            return fut.result(timeout)
        except _FutureTimeout:
            reqs = getattr(fut, "_mx_requests", ())
            cancelled = self._cancel_queued(reqs, DeadlineExceededError(
                "predict(%r) timed out after %.3fs; queued request "
                "cancelled before dispatch" % (name, timeout)))
            for req in cancelled:
                self._count_deadline_exceeded(req.model)
            raise DeadlineExceededError(
                "predict(%r) timed out after %.3fs (%d queued chunk(s) "
                "cancelled undispatched)"
                % (name, timeout, len(cancelled))) from None

    # -------------------------------------------------------- generation
    def submit_generate(self, name, prompt, max_new_tokens, eos_id=None,
                        deadline_ms=None, temperature=0.0, top_k=0,
                        top_p=1.0, seed=None):
        """Enqueue one prompt on generation model ``name``; returns a
        Future resolving to the generated token ids (np.int32, EOS
        included when hit).  ``temperature`` > 0 samples with optional
        ``top_k`` / ``top_p`` under a per-request ``seed``: a fixed seed
        replays one stream.  ``deadline_ms`` bounds QUEUE time."""
        with _tracing.span("serving.submit", cat="serving", model=name):
            return self._engine(name).submit(
                prompt, max_new_tokens, eos_id=eos_id,
                deadline_ms=deadline_ms, temperature=temperature,
                top_k=top_k, top_p=top_p, seed=seed)

    def generate(self, name, prompt, max_new_tokens, eos_id=None,
                 timeout=None, deadline_ms=None, temperature=0.0,
                 top_k=0, top_p=1.0, seed=None):
        """Synchronous ``submit_generate(...).result(timeout)``."""
        fut = self.submit_generate(name, prompt, max_new_tokens,
                                   eos_id=eos_id, deadline_ms=deadline_ms,
                                   temperature=temperature, top_k=top_k,
                                   top_p=top_p, seed=seed)
        try:
            return fut.result(timeout)
        except _FutureTimeout:
            raise DeadlineExceededError(
                "generate(%r) timed out after %.3fs (the sequence keeps "
                "decoding)" % (name, timeout)) from None

    def _count_deadline_exceeded(self, model):
        _telemetry.counter("serving.deadline_exceeded").inc()
        _telemetry.counter("serving.deadline_exceeded.%s" % model).inc()
        with self._cond:
            entry = self._models.get(model)
            if entry is not None:
                entry.deadline_exceeded += 1

    # ----------------------------------------------------------- batcher
    def _take_fitting(self, model, budget):  # holds(_cond)
        """Pop the first queued request for ``model`` with rows <=
        ``budget``; the expired requests met on the way come back second
        (the caller completes them typed, undispatched)."""
        now = _time.perf_counter()
        take = None
        dead = []
        for req in self._pending:
            if req.expired(now):
                dead.append(req)
                continue
            if take is None and req.model == model and req.rows <= budget:
                take = req
        for req in dead:
            self._pending.remove(req)
        if take is not None:
            self._pending.remove(take)
        if dead or take is not None:
            _telemetry.gauge("serving.pending").set(len(self._pending))
        return take, dead

    def _expire(self, reqs, reason="expired in queue before dispatch"):
        """Complete deadline-expired requests with the typed error; they
        never reach the program."""
        for req in reqs:
            self._count_deadline_exceeded(req.model)
            if not req.future.done():
                queued_ms = (_time.perf_counter() - req.t_submit) * 1e3
                req.future.set_exception(DeadlineExceededError(
                    "request for model %r %s (queued %.1fms, deadline "
                    "passed)" % (req.model, reason, queued_ms)))
                _obs.log_access(req.model, "deadline",
                                request_id=req.trace_id, queue_ms=queued_ms)

    def _supervise(self):
        """The batcher thread: ``_loop`` under the ``resilience`` retry
        budget.  Each crash fails the pending futures with the causal
        exception and restarts the loop after backoff; once the budget is
        spent the server is marked dead and submits fail fast."""
        from . import resilience as _resilience
        try:
            _resilience.call_with_retry(self._run_batcher,
                                        kind="serving_batcher")
        except BaseException as exc:  # noqa: BLE001 — budget exhausted
            cause = exc.__cause__ if exc.__cause__ is not None else exc
            with self._cond:
                self._batcher_dead = cause
                pending = list(self._pending)
                self._pending.clear()
                _telemetry.gauge("serving.pending").set(0)
                self._cond.notify_all()
            for req in pending:
                if not req.future.done():
                    req.future.set_exception(cause)
                    _obs.log_access(req.model, "error",
                                    request_id=req.trace_id,
                                    error=_err(cause))
            _LOG.error(
                "serving: batcher crashed and exhausted its restart "
                "budget (%s: %s); all submits now fail fast — recreate "
                "the Server", type(cause).__name__, cause)

    def _run_batcher(self):
        """One supervised batcher incarnation: a clean ``_loop`` return
        (stop) ends the thread; a crash fails every pending future with
        the causal exception, counts ``serving.batcher_crashes`` and
        re-raises as a retryable wrapper."""
        try:
            self._loop()
        except BaseException as exc:  # noqa: BLE001 — supervised crash
            _telemetry.counter("serving.batcher_crashes").inc()
            with self._cond:
                pending = list(self._pending)
                self._pending.clear()
                _telemetry.gauge("serving.pending").set(0)
            for req in pending:
                if req is not None and not req.future.done():
                    req.future.set_exception(exc)
                    _obs.log_access(req.model, "error",
                                    request_id=req.trace_id, error=_err(exc))
            _LOG.warning(
                "serving: batcher thread crashed (%s: %s); %d pending "
                "future(s) failed with the causal exception; restarting "
                "under the resilience retry budget",
                type(exc).__name__, exc, len(pending))
            raise _BatcherCrashError(
                "serving batcher crashed: %s: %s"
                % (type(exc).__name__, exc)) from exc

    def _loop(self):
        while True:
            with self._cond:
                while not self._pending:
                    if self._stopping:
                        return
                    self._cond.wait(timeout=0.05)
                first = self._pending.popleft()
                _telemetry.gauge("serving.pending").set(len(self._pending))
                entry = self._models.get(first.model)
            if entry is None:  # evicted with requests in flight
                exc = ServingError(
                    "model %r was evicted while queued" % (first.model,))
                first.future.set_exception(exc)
                _obs.log_access(first.model, "error",
                                request_id=first.trace_id, error=_err(exc))
                continue
            if first.expired():
                self._expire([first])
                continue
            batch = [first]
            rows = first.rows
            cap = entry.capacity
            deadline = first.t_submit + self.max_queue_delay_ms * 1e-3
            while rows < cap:
                with self._cond:
                    req, expired = self._take_fitting(first.model,
                                                      cap - rows)
                    wait = None
                    if req is None:
                        remaining = deadline - _time.perf_counter()
                        if remaining <= 0 or self._stopping:
                            wait = 0.0
                        else:
                            wait = min(remaining, 0.005)
                if expired:
                    self._expire(expired)
                if req is not None:
                    batch.append(req)
                    rows += req.rows
                    continue
                if wait == 0.0:
                    break
                with self._cond:
                    self._cond.wait(timeout=wait)
            # what expired while the window was open completes typed
            now = _time.perf_counter()
            dead = [r for r in batch if r.expired(now)]
            if dead:
                self._expire(dead)
                batch = [r for r in batch if not r.expired(now)]
                if not batch:
                    continue
                rows = sum(r.rows for r in batch)
            self._dispatch(entry, batch, rows)

    def _dispatch(self, entry, batch, rows):
        from . import resilience as _resilience
        t0 = _time.perf_counter()
        bucket = _io.pick_bucket(entry.buckets, rows) or entry.capacity
        for req in batch:
            _telemetry.timer("serving.queue_delay_ms").observe(
                (t0 - req.t_submit) * 1e3)
        breaker = entry.breaker
        if breaker is not None and not breaker.allow_dispatch():
            # open breaker inside its cooldown: fail the batch fast
            _telemetry.counter("serving.breaker_rejected").inc(len(batch))
            exc = CircuitOpenError(
                "model %r circuit breaker is OPEN (%d consecutive "
                "dispatch failure(s)); batch failed fast, retry after "
                "the cooldown" % (entry.name, breaker.failures))
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(exc)
                    _obs.log_access(req.model, "breaker",
                                    request_id=req.trace_id,
                                    queue_ms=(t0 - req.t_submit) * 1e3)
            with self._cond:
                self._last_dispatch_done = _time.perf_counter()
            return
        try:
            if _resilience.faults_active("serving_slow") \
                    and _resilience.should_inject("serving_slow"):
                _time.sleep(_SLOW_DISPATCH_S)
            _resilience.inject("serving_dispatch")
            cat = batch[0].data if len(batch) == 1 else \
                _np.concatenate([req.data for req in batch], axis=0)
            padded = _io.pad_rows_to(cat, bucket) if bucket > rows else cat
            pred = entry.predictor
            if bucket not in entry.warmed:
                # a fixed-batch artifact or a bucket registered late
                self._warm(entry, bucket)
            with _tracing.span("serving.dispatch", cat="serving",
                               model=entry.name, requests=len(batch),
                               rows=rows, bucket=bucket):
                x = torch.from_numpy(_np.ascontiguousarray(padded)).to(
                    pred.device)
                host = pred.run(x).cpu().numpy()
        except BaseException as exc:  # noqa: BLE001 — fail the batch's
            # futures (and feed the breaker), never the batcher thread
            _telemetry.counter("serving.dispatch_errors").inc()
            if breaker is not None:
                breaker.record_failure()
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(exc)
                    _obs.log_access(req.model, "error",
                                    request_id=req.trace_id,
                                    queue_ms=(t0 - req.t_submit) * 1e3,
                                    error=_err(exc))
            with self._cond:
                self._last_dispatch_done = _time.perf_counter()
            return
        if breaker is not None:
            breaker.record_success()
        t1 = _time.perf_counter()
        access_on = _obs.access_log_enabled()
        if access_on:
            row_nbytes = host.nbytes // max(1, host.shape[0])
            cost = entry.cost_per_item
        ofs = 0
        for req in batch:
            if not req.future.done():
                req.future.set_result(host[ofs:ofs + req.rows])
                if access_on:
                    _obs.log_access(
                        req.model, "ok", request_id=req.trace_id,
                        queue_ms=(t0 - req.t_submit) * 1e3,
                        dispatch_ms=(t1 - t0) * 1e3,
                        bytes=req.rows * row_nbytes,
                        flops=int(req.rows * cost["flops"])
                        if cost is not None else None)
            ofs += req.rows
            _telemetry.timer("serving.request_ms").observe(
                (t1 - req.t_submit) * 1e3)
        _telemetry.counter("serving.batch_dispatches").inc()
        if entry.quantized:
            _telemetry.counter("serving.quantized_dispatches").inc()
            try:
                self._maybe_sample_drift(entry, x)
            except Exception as exc:  # noqa: BLE001 — the probe is
                # observability; it never fails a served batch
                _LOG.warning("serving: drift probe failed for %r: %s",
                             entry.name, _err(exc))
        _telemetry.timer("serving.batch_fill").observe(rows / bucket)
        _telemetry.timer("serving.dispatch_ms").observe((t1 - t0) * 1e3)
        with self._cond:
            self._last_dispatch_done = t1

    # ---------------------------------------------------------- watchdog
    def _stall_probe(self, interval_s):
        """The watchdog's stall probe (``tracing.register_stall_probe``):
        when the queue is not empty but no dispatch has completed within
        ``interval_s``, a snapshot of the open requests, the breakers and
        the batcher's liveness; None while it moves."""
        now = _time.perf_counter()
        with self._cond:
            if not self._pending:
                return None
            stalled_s = now - self._last_dispatch_done
            if stalled_s < interval_s:
                return None
            open_reqs = [
                {"model": r.model, "rows": r.rows,
                 "queued_s": round(now - r.t_submit, 4),
                 "deadline_in_s": round(r.deadline - now, 4)
                 if r.deadline is not None else None}
                for r in list(self._pending)[:16]]
            pending = len(self._pending)
            breakers = {name: e.breaker.state if e.breaker is not None
                        else "closed"
                        for name, e in self._models.items()}
            thread = self._thread
        return {"pending": pending,
                "since_last_dispatch_s": round(stalled_s, 4),
                "batcher_alive": bool(thread is not None
                                      and thread.is_alive()),
                "open_requests": open_reqs,
                "breakers": breakers}

    # ------------------------------------------------------------ health
    def _health(self):
        """``mx.obs``'s health source (``/healthz``, registered at
        :meth:`start`): batcher liveness, per-model breaker state,
        per-engine liveness and KV-pool saturation (reported, not counted
        as unhealthy), and, while the watchdog is armed
        (``tracing.watchdog``), a batcher or engine stalled past its
        deadline (the stall probes' view)."""
        with self._cond:
            breakers = {name: e.breaker.state if e.breaker is not None
                        else "closed"
                        for name, e in self._models.items()}
            batcher_dead = self._batcher_dead
            started = self._started
            thread = self._thread
            pending = len(self._pending)
            engines = dict(self._generation)
        reasons = []
        if batcher_dead is not None:
            reasons.append("batcher_dead")
        batcher_alive = bool(thread is not None and thread.is_alive())
        if started and not batcher_alive:
            reasons.append("batcher_thread_dead")
        stall_s = float(_config.get("tracing.watchdog") or 0.0)
        if started and stall_s > 0 and self._stall_probe(stall_s):
            reasons.append("batcher_stalled")
        for name, state in breakers.items():
            if state == "open":
                reasons.append("breaker_open:%s" % name)
        generation = {}
        for name, eng in engines.items():
            st = eng.stats()
            if started and not st["engine_alive"]:
                reasons.append("engine_dead:%s" % name)
            if started and stall_s > 0 and eng._stall_probe(stall_s):
                reasons.append("engine_stalled:%s" % name)
            if st["breaker"] == "open":
                reasons.append("breaker_open:%s" % name)
            generation[name] = {
                "engine_alive": st["engine_alive"],
                "breaker": st["breaker"],
                "queued": st["queued"],
                "active": st["active"],
                "kv_pages": st["kv_pages"],
                "kv_pages_free": st["kv_pages_free"],
                "kv_saturated": st["kv_pages_free"] == 0,
            }
        return {"healthy": not reasons, "reasons": reasons,
                "started": started, "pending": pending,
                "batcher_alive": batcher_alive, "breakers": breakers,
                "generation": generation}

    # ------------------------------------------------------------- stats
    def stats(self):
        """Serving-slice snapshot of the telemetry registry (names starting
        with ``serving.``) plus live state: models, queue depth, breaker
        states, batcher liveness, each engine's state."""
        snap = _telemetry.snapshot()
        with self._cond:
            breakers = {name: e.breaker.state if e.breaker is not None
                        else "closed"
                        for name, e in self._models.items()}
            quantized = {name: e.quantized
                         for name, e in self._models.items()}
            pending = len(self._pending)
            thread = self._thread
            engines = dict(self._generation)
        return {
            "counters": {k: v for k, v in snap["counters"].items()
                         if k.startswith("serving.")},
            "gauges": {k: v for k, v in snap["gauges"].items()
                       if k.startswith("serving.")},
            "timers": {k: v for k, v in snap["timers"].items()
                       if k.startswith("serving.")},
            "generation": {n: e.stats() for n, e in engines.items()},
            "models": self.models(),
            "quantized": quantized,
            "pending": pending,
            "breakers": breakers,
            "batcher_alive": bool(thread is not None and thread.is_alive()),
        }


def load_server(prefixes, **kwargs):
    """Build, register and start a server from ``{name: prefix}``.
    All-or-nothing: if a ``register()`` (or the ``start()``) raises, the
    models registered so far are unregistered before the exception
    propagates."""
    srv = Server(**kwargs)
    registered = []
    try:
        for name, prefix in dict(prefixes).items():
            srv.register(name, prefix)
            registered.append(name)
        return srv.start()
    except BaseException:
        for name in registered:
            try:
                srv.unregister(name)
            except Exception:  # noqa: BLE001 — unwind is best-effort
                pass
        raise
