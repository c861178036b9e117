"""``mx.serving`` — the generation surface of the inference server
(counterpart of ``mxnet_tpu.serving``).

Usage::

    srv = mx.serving.Server()
    srv.register("lm", "/models/lm", generate=True)   # weights -> device
    srv.start()
    ids = srv.generate("lm", prompt, max_new_tokens=32)
    srv.stop()

Each generation model gets its own
:class:`~mxnet_tpu_torch.generation.GenerationEngine`: a per-iteration
continuous-batching scheduler over a paged, device-resident KV cache.
Fault tolerance follows the reference: submits past
``serving.max_pending`` shed (:class:`ServerOverloadedError`), requests
whose queue deadline lapses fail with :class:`DeadlineExceededError`
and never prefill, and a per-model circuit breaker fails a broken model
fast (:class:`CircuitOpenError`).

The one-shot predict path (``register(generate=False)``, ``submit``
and its batcher) is ported in a later slice.
"""
from __future__ import annotations

import logging
import threading
import time as _time
from concurrent.futures import TimeoutError as _FutureTimeout

from . import config as _config
from . import telemetry as _telemetry

__all__ = ["Server", "ServingError", "ServerOverloadedError",
           "DeadlineExceededError", "CircuitOpenError"]

_LOG = logging.getLogger("mxnet_tpu_torch.serving")

_ONE_SHOT = ("one-shot predict serving (register(generate=False), "
             "submit and the batcher) is not ported yet: it comes "
             "with the slice that ports mxnet_tpu.deploy's one-shot "
             "artifacts; register generation models with generate=True")


class ServingError(RuntimeError):
    """Serving lifecycle errors (stopped server, unknown model, dead
    engine)."""


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


class Server:
    """Continuous-batching generation server over
    :func:`mxnet_tpu_torch.deploy.export_generation` artifacts.

    ``device`` is where registered models live: ``cuda:0`` by default
    (raises without a GPU), ``"cpu"`` or ``mx.cpu()`` on request.
    ``Server`` is a context manager (``with Server() as srv:`` starts and
    drains it)."""

    def __init__(self, max_pending=None, default_deadline_ms=None,
                 breaker_threshold=None, breaker_cooldown_ms=None,
                 device=None):
        if max_pending is None:
            max_pending = _config.get("serving.max_pending")
        if default_deadline_ms is None:
            default_deadline_ms = _config.get("serving.default_deadline_ms")
        if breaker_threshold is None:
            breaker_threshold = _config.get("serving.breaker_threshold")
        if breaker_cooldown_ms is None:
            breaker_cooldown_ms = _config.get("serving.breaker_cooldown_ms")
        self.max_pending = int(max_pending)
        self.default_deadline_ms = float(default_deadline_ms)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_ms = float(breaker_cooldown_ms)
        self.device = device
        self._generation = {}            # guarded-by: _cond
        self._cond = threading.Condition()
        self._started = False            # guarded-by: _cond

    # ------------------------------------------------------------ models
    def register(self, name, prefix, quantized=False, generate=False):
        """Load the generation artifact at ``prefix`` under ``name`` (its
        weights go to the server's device now) and give it a
        :class:`~mxnet_tpu_torch.generation.GenerationEngine`, started now
        if the server is running.  Re-registering a name replaces the
        engine.  ``generate=False`` (one-shot predict models) raises
        NotImplementedError in this slice.  KV quantisation is chosen at
        export (``export_generation(..., kv_quantized=True)``), so
        ``quantized=True`` is refused."""
        if not generate:
            raise NotImplementedError(_ONE_SHOT)
        if quantized:
            raise ServingError(
                "model %r: generate=True with quantized=True is not "
                "supported — KV quantisation is chosen at EXPORT time "
                "(export_generation(..., kv_quantized=True))" % (name,))
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

    def models(self):
        with self._cond:
            return list(self._generation)

    def _engine(self, name):
        with self._cond:
            engine = self._generation.get(name)
        if engine is None:
            raise ServingError("unknown generation model %r (registered: "
                               "%s)" % (name, self.models()))
        return engine

    # --------------------------------------------------------- lifecycle
    def start(self):
        """Start every registered engine (allocates their page pools).
        Idempotent while running; restartable after :meth:`stop`."""
        with self._cond:
            if self._started:
                return self
            engines = list(self._generation.values())
        for engine in engines:
            engine.start()
        with self._cond:
            self._started = True
        return self

    def stop(self, drain=True, timeout_s=30.0):
        """Stop the server: with ``drain`` (default) every accepted request
        runs to completion; with ``drain=False`` pending and in-flight
        requests fail promptly with ServingError."""
        with self._cond:
            if not self._started:
                return
            engines = list(self._generation.values())
        for engine in engines:
            engine.stop(drain=drain, timeout_s=timeout_s)
        with self._cond:
            self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------ submit
    def submit(self, name, data, deadline_ms=None):
        """One-shot predict: not ported yet.  A generation model is
        refused with ServingError, as in the reference."""
        with self._cond:
            is_generation = name in self._generation
        if is_generation:
            raise ServingError(
                "model %r is a GENERATION model (registered with "
                "generate=True): use submit_generate()/generate()"
                % (name,))
        raise NotImplementedError(_ONE_SHOT)

    def submit_generate(self, name, prompt, max_new_tokens, eos_id=None,
                        deadline_ms=None, temperature=0.0, top_k=0,
                        top_p=1.0, seed=None):
        """Enqueue one prompt on generation model ``name``; returns a
        Future resolving to the generated token ids (np.int32, EOS
        included when hit).  ``temperature`` > 0 samples with optional
        ``top_k`` / ``top_p`` under a per-request ``seed``: a fixed seed
        replays one stream.  ``deadline_ms`` bounds QUEUE time."""
        return self._engine(name).submit(
            prompt, max_new_tokens, eos_id=eos_id, deadline_ms=deadline_ms,
            temperature=temperature, top_k=top_k, top_p=top_p, seed=seed)

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

    # ------------------------------------------------------------- stats
    def stats(self):
        """Serving-slice snapshot of the telemetry registry (names starting
        with ``serving.``) plus each engine's live state."""
        snap = _telemetry.snapshot()
        with self._cond:
            engines = dict(self._generation)
        return {
            "counters": {k: v for k, v in snap["counters"].items()
                         if k.startswith("serving.")},
            "gauges": {k: v for k, v in snap["gauges"].items()
                       if k.startswith("serving.")},
            "timers": {k: v for k, v in snap["timers"].items()
                       if k.startswith("serving.")},
            "generation": {n: e.stats() for n, e in engines.items()},
            "models": list(engines),
        }
