"""Generation engine — token-level continuous batching over a paged,
device-resident KV cache (counterpart of ``mxnet_tpu.generation``).

One :class:`GenerationEngine` thread per generation model:

  submit ──► admission check ──► FIFO ──► engine loop, per iteration:
             (bounded queue,              1. harvest expired deadlines
              breaker state)              2. admit queue head into a free
                                             decode slot IF the page pool
                                             covers prompt+max_new pages
                                             (head-of-line wait otherwise:
                                             serving.kv_pool_exhausted)
                                          3. PREFILL each new request
                                             (B=1, at its prompt bucket)
                                             → first token (TTFT)
                                          4. one DECODE step for all
                                             active slots (B=slots, at the
                                             page-table width bucket)
                                          5. finished sequences (EOS /
                                             max_new) resolve futures,
                                             pages recycle immediately

* **Paged KV memory** — position ``t`` of a sequence lives at slot
  ``t % page_size`` of page ``table[t // page_size]``; pages come from a
  shared free list and return to it the iteration their sequence ends.
* **In-place pool** — every prefill/decode call updates the pool in
  place (the reference donates it).  A failed dispatch may leave it
  half-written, so the engine fails every in-flight sequence with the
  causal error, rebuilds the pool zeroed, feeds the breaker and keeps
  serving.
* **Shared-prefix pages** (``serving.shared_prefix``) — full prompt-prefix
  pages are content-keyed at submit; concurrent requests with a common
  prefix map to the SAME physical pages, refcounted and freed when the
  last reader exits.  Causal attention makes a prefix position's K/V a
  function of the tokens before it only, so the shared bytes are the
  same whichever sharer wrote them.
* **Sampling** — per-request temperature / top-k / top-p with a
  per-request seed folded by position: one seed, one stream, whatever
  else is in flight.  Greedy (temperature 0) is the default.
* **Admission** — sheds past ``serving.max_pending``
  (ServerOverloadedError); queued requests whose deadline lapses complete
  with DeadlineExceededError and never prefill; an open breaker fails
  fast (CircuitOpenError).

* **Supervision** — an engine-loop crash fails the queued and in-flight
  requests with the causal exception, counts ``serving.batcher_crashes``
  and restarts the loop under ``resilience.call_with_retry``'s budget
  (the ``resilience.retry_*`` knobs); once it is spent the engine is dead
  and submits fail fast.

* **Observability** — each prompt bucket's prefill and each decode
  width's step is an ``mx.perf`` program (``serving/<model>/prefill-s<S>``,
  ``serving/<model>/decode-w<W>``): its first call runs inside a
  ``serving.compile`` span under ``perf.cost_analysis``, the port's
  counterpart of the reference's per-bucket compile, and registers one
  record; each prefill and decode step runs in a ``serving.dispatch``
  span.  ``start`` registers :meth:`GenerationEngine._stall_probe` on
  the watchdog (work waiting, no loop iteration within the deadline:
  queue, slots, KV-pool occupancy, the oldest request's age); ``stop``
  takes it off.  Every request leaves one ``obs.log_access`` record at
  its terminal outcome, its id the enclosing ``serving.submit`` span's
  trace id, an ok record carrying its share of the programs' FLOPs.

Telemetry: ``serving.tokens_generated[.model]``, ``serving.requests``,
``serving.kv_pool_exhausted[.model]``, ``serving.prefix_hits`` counters;
``serving.kv_pages_in_use.<model>`` gauge; ``serving.prefill_ms``,
``serving.decode_step_ms``, ``serving.ttft_ms``,
``serving.generate_request_ms`` timers (milliseconds).
"""
from __future__ import annotations

import contextlib
import logging
import math as _math
import threading
import time as _time
from collections import deque
from concurrent.futures import Future

import numpy as _np

from . import config as _config
from . import obs as _obs
from . import telemetry as _telemetry
from . import tracing as _tracing
from .deploy import pick_bucket
from .serving import (CircuitOpenError, DeadlineExceededError,
                      ServerOverloadedError, ServingError, _access_outcome,
                      _err)

__all__ = ["GenerationEngine"]

_LOG = logging.getLogger("mxnet_tpu_torch.generation")


class _EngineCrashError(OSError):
    """Internal: wraps an engine-loop crash so
    ``resilience.call_with_retry`` drives the restart backoff."""


class _GenRequest:
    """One generation request: prompt + budget + the future its token
    stream resolves, stamped for TTFT / deadline accounting."""

    __slots__ = ("prompt", "plen", "max_new", "eos_id", "future",
                 "t_submit", "deadline", "need", "stall_counted",
                 "temperature", "top_k", "top_p", "key_words",
                 "prefix_keys", "trace_id")

    def __init__(self, prompt, max_new, eos_id, deadline_ms, need,
                 temperature=0.0, top_k=0, top_p=1.0, seed=0,
                 prefix_keys=(), trace_id=None):
        self.prompt = prompt
        self.plen = int(prompt.shape[0])
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.future = Future()
        self.t_submit = _time.perf_counter()
        self.deadline = (self.t_submit + float(deadline_ms) * 1e-3) \
            if deadline_ms and deadline_ms > 0 else None
        self.need = int(need)          # pages for prompt + max_new
        self.stall_counted = False     # kv_pool_exhausted counted once
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        s = int(seed) & 0xFFFFFFFFFFFFFFFF
        self.key_words = (s >> 32, s & 0xFFFFFFFF)
        # content keys of the FULL prompt-prefix pages, page 0 first:
        # key i covers tokens [0, (i+1)*page_size)
        self.prefix_keys = tuple(prefix_keys)
        self.trace_id = trace_id

    def expired(self, now):
        return self.deadline is not None and now >= self.deadline


class _Slot:
    """One active decode slot (engine-thread-only state).  The leading
    ``len(prefix_keys)`` pages are owned by the shared-prefix map and are
    released through ``_release_pages_locked``, never freed directly."""

    __slots__ = ("req", "pages", "pos", "tokens", "ttft_ms",
                 "prefix_keys", "flops")

    def __init__(self, req, pages, prefix_keys=()):
        self.req = req
        self.pages = pages
        self.pos = req.plen      # tokens already in the cache
        self.tokens = []
        self.ttft_ms = None
        self.prefix_keys = tuple(prefix_keys)
        self.flops = 0.0         # its share of the programs' FLOPs


class GenerationEngine:
    """Per-model continuous-batching generation scheduler (one thread),
    owned by :class:`mxnet_tpu_torch.serving.Server` (``register(...,
    generate=True)``); drives a
    :class:`mxnet_tpu_torch.deploy.GenerationPredictor` over a shared
    page pool."""

    def __init__(self, name, predictor, breaker=None, num_pages=None,
                 decode_slots=None, max_pending=None,
                 default_deadline_ms=None):
        self.name = name
        self.predictor = predictor
        self.breaker = breaker
        self.num_pages = int(num_pages if num_pages is not None
                             else _config.get("serving.kv_pages"))
        self.decode_slots = int(decode_slots if decode_slots is not None
                                else _config.get("serving.decode_slots"))
        if predictor.decode_batch is not None:
            # the artifact pinned its decode batch at export
            self.decode_slots = predictor.decode_batch
        self.max_pending = int(max_pending if max_pending is not None
                               else _config.get("serving.max_pending"))
        self.default_deadline_ms = float(
            default_deadline_ms if default_deadline_ms is not None
            else _config.get("serving.default_deadline_ms"))
        psz = predictor.page_size
        # a single request may never need more pages than the pool holds
        self.max_need = min(self.num_pages,
                            _math.ceil(predictor.max_context / psz))
        if self.max_need < 1:
            raise ServingError(
                "model %r: serving.kv_pages=%d cannot hold one page"
                % (name, self.num_pages))
        self._share = bool(_config.get("serving.shared_prefix"))
        # cross-thread state (submit side vs engine thread)
        self._queue = deque()            # guarded-by: _cond
        self._free = list(range(self.num_pages))  # guarded-by: _cond
        # shared-prefix map: content key -> [page_id, refcount, populated]
        self._prefix = {}                # guarded-by: _cond
        self._cond = threading.Condition()
        self._started = False            # guarded-by: _cond
        self._stopping = False           # guarded-by: _cond
        self._abort = False              # guarded-by: _cond
        self._dead = None                # guarded-by: _cond — crash exc
        # guarded-by[writes]: _cond — stop() joins outside the lock
        self._thread = None
        # engine-thread-only state: the pool and the decode slots
        self._slots = [None] * self.decode_slots
        self._kv = None       # page-pool tuple (2 tensors, 4 when int8)
        # mx.perf programs by prompt bucket / decode width
        self._prefill = {}
        self._decode = {}
        self._last_iteration = _time.perf_counter()  # guarded-by: _cond
        self._probe_name = "serving.generate.%s.%x" % (name, id(self))
        # test hook: while an Event is set here the loop waits on it at
        # the top of each iteration (:meth:`_held`)
        self._gate = None

    # --------------------------------------------------------- lifecycle
    def start(self):
        with self._cond:
            if self._started:
                return self
        self._kv = self.predictor.make_kv(self.num_pages)
        with self._cond:
            self._stopping = False
            self._abort = False
            self._dead = None
            self._started = True
            self._last_iteration = _time.perf_counter()
            self._thread = threading.Thread(
                target=_tracing.wrap_context(self._supervise), daemon=True,
                name="mx-serving-generate-%s" % self.name)
        self._thread.start()
        # KV-pool occupancy, loop liveness and the oldest request's age
        # land in the watchdog's hang report
        _tracing.register_stall_probe(self._probe_name, self._stall_probe)
        return self

    def stop(self, drain=True, timeout_s=30.0):
        """Stop the engine.  With ``drain`` (default) queued requests
        prefill and every in-flight sequence runs to completion; with
        ``drain=False`` queued AND active sequences fail promptly."""
        with self._cond:
            if not self._started:
                return
            self._stopping = True
            self._abort = self._abort or not drain
            self._cond.notify_all()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=timeout_s)
            if thread.is_alive():
                _telemetry.counter("serving.stop_timeout").inc()
                _LOG.warning("serving: generation engine %r did not "
                             "drain within %.1fs", self.name, timeout_s)
        _tracing.unregister_stall_probe(self._probe_name)
        with self._cond:
            self._started = False
            self._thread = None

    @contextlib.contextmanager
    def _held(self):
        """Test hook: hold the engine loop (it waits at the top of its next
        iteration) until the block exits: a stall the watchdog, the stall
        probe and ``/healthz`` can see."""
        gate = threading.Event()
        self._gate = gate
        try:
            yield self
        finally:
            self._gate = None
            gate.set()

    def _program(self, kind, size):
        """The mx.perf program of one prompt bucket (``kind`` 'prefill') or
        decode width ('decode')."""
        table = self._prefill if kind == "prefill" else self._decode
        prog = table.get(size)
        if prog is None:
            from . import perf as _perf
            gp = self.predictor
            if kind == "prefill":
                fn, label = gp.prefill_fn(size), "prefill-s%d" % size
            else:
                fn, label = gp.decode_fn(size), "decode-w%d" % size
            prog = table[size] = _perf.wrap(
                fn, "serving", "%s/%s" % (self.name, label),
                span="serving.compile", per_signature=False,
                model=self.name)
        return prog

    # ------------------------------------------------------------ submit
    def submit(self, prompt, max_new_tokens, eos_id=None,
               deadline_ms=None, temperature=0.0, top_k=0, top_p=1.0,
               seed=None):
        """Enqueue one prompt; returns a Future resolving to the
        generated token ids (np.int32, EOS included when hit).
        ``temperature`` > 0 samples with optional ``top_k`` / ``top_p``
        under a per-request ``seed`` (fresh entropy when None) and needs
        an artifact exported with ``sampling=True``."""
        gp = self.predictor
        prompt = _np.asarray(prompt, _np.int32).reshape(-1)
        plen = int(prompt.shape[0])
        max_new = int(max_new_tokens)
        if plen < 1 or max_new < 1:
            raise ValueError(
                "model %r: need a non-empty prompt and max_new_tokens "
                ">= 1" % (self.name,))
        temperature = float(temperature)
        if temperature > 0.0 and not gp.sampling:
            raise ValueError(
                "model %r: temperature=%g needs an artifact exported with "
                "sampling=True" % (self.name, temperature))
        if seed is None:
            seed = _time.time_ns() if temperature > 0.0 else 0
        if plen + max_new > gp.max_context:
            raise ValueError(
                "model %r: prompt (%d) + max_new_tokens (%d) exceeds the "
                "artifact's max_context %d"
                % (self.name, plen, max_new, gp.max_context))
        gp.prefill_bucket(plen)   # raises if no bucket fits
        need = _math.ceil((plen + max_new) / gp.page_size)
        if need > self.max_need:
            raise ValueError(
                "model %r: request needs %d KV pages but the pool holds "
                "%d (serving.kv_pages) — shorten the request or grow the "
                "pool" % (self.name, need, self.num_pages))
        _telemetry.counter("serving.requests").inc()
        # the enclosing serving.submit span's trace id (None when tracing
        # is off) rides the request so its access record joins the trace
        sp = _tracing.current_span()
        trace_id = sp.trace_id if sp is not None else None
        breaker = self.breaker
        if breaker is not None and breaker.rejects_submit():
            _telemetry.counter("serving.breaker_rejected").inc()
            _obs.log_access(self.name, "breaker", request_id=trace_id)
            raise CircuitOpenError(
                "model %r circuit breaker is OPEN after %d consecutive "
                "dispatch failure(s); failing fast for %.0fms more"
                % (self.name, breaker.failures,
                   breaker.cooldown_remaining_ms()))
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        prefix_keys = ()
        if self._share:
            # equal keys mean byte-equal pages: a page's K/V depends on
            # the tokens up to its end only (causal attention)
            psz = gp.page_size
            prefix_keys = tuple(
                (i, prompt[:(i + 1) * psz].tobytes())
                for i in range(plen // psz))
        req = _GenRequest(prompt, max_new, eos_id,
                          float(deadline_ms or 0.0), need,
                          temperature=temperature, top_k=top_k,
                          top_p=top_p, seed=seed, prefix_keys=prefix_keys,
                          trace_id=trace_id)
        with self._cond:
            if self._dead is not None:
                exc = self._dead
                raise ServingError(
                    "generation engine for model %r crashed (%s: %s); "
                    "submit rejected" % (self.name, type(exc).__name__,
                                         exc))
            if self._stopping or not self._started:
                raise ServingError(
                    "generation engine for model %r is %s; submit "
                    "rejected" % (self.name, "stopping" if self._stopping
                                  else "not started"))
            shed = self.max_pending > 0 \
                and len(self._queue) >= self.max_pending
            if not shed:
                self._queue.append(req)
                self._cond.notify_all()
        if shed:
            _telemetry.counter("serving.shed_requests").inc()
            _telemetry.counter(
                "serving.shed_requests.%s" % self.name).inc()
            _obs.log_access(self.name, "shed", request_id=trace_id)
            raise ServerOverloadedError(
                "generation queue for model %r is at serving.max_pending"
                "=%d; request shed — back off and retry"
                % (self.name, self.max_pending))
        return req.future

    # ----------------------------------------------------------- the loop
    def _supervise(self):
        """The engine thread: ``_loop`` under the ``resilience`` retry
        budget; once it is spent the engine is marked dead, its queue
        fails with the causal exception and submits fail fast."""
        from . import resilience as _resilience
        try:
            _resilience.call_with_retry(self._run_engine,
                                        kind="serving_batcher")
        except BaseException as exc:  # noqa: BLE001 — budget exhausted
            cause = exc.__cause__ if exc.__cause__ is not None else exc
            with self._cond:
                self._dead = cause
                queued = list(self._queue)
                self._queue.clear()
                self._cond.notify_all()
            self._fail_all(queued, cause)
            _LOG.error(
                "serving: generation engine %r crashed and exhausted its "
                "restart budget (%s: %s); submits now fail fast",
                self.name, type(cause).__name__, cause)

    def _run_engine(self):
        """One supervised incarnation of the loop: a crash fails every
        queued and in-flight request with the causal exception (the pool
        is rebuilt zeroed), counts ``serving.batcher_crashes`` and
        re-raises as a retryable wrapper."""
        try:
            self._loop()
        except BaseException as exc:  # noqa: BLE001 — supervised crash
            _telemetry.counter("serving.batcher_crashes").inc()
            with self._cond:
                queued = list(self._queue)
                self._queue.clear()
            self._fail_all(queued, exc)
            self._fail_active(exc)
            _LOG.warning(
                "serving: generation engine %r crashed (%s: %s); "
                "restarting under the resilience retry budget",
                self.name, type(exc).__name__, exc)
            raise _EngineCrashError(
                "generation engine crashed: %s: %s"
                % (type(exc).__name__, exc)) from exc

    def _active(self):
        return [s for s in self._slots if s is not None]

    def _fail_all(self, reqs, exc):
        outcome = _access_outcome(exc)
        err = _err(exc) if outcome == "error" else None
        for req in reqs:
            if not req.future.done():
                req.future.set_exception(exc)
                if _obs.access_log_enabled():
                    _obs.log_access(
                        self.name, outcome, request_id=req.trace_id,
                        queue_ms=(_time.perf_counter() - req.t_submit)
                        * 1e3, error=err)

    def _fail_active(self, exc):
        """Fail every in-flight sequence, recycle its pages and rebuild the
        pool zeroed (a failed call may have left it half-written)."""
        released = []
        outcome = _access_outcome(exc)
        err = _err(exc) if outcome == "error" else None
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            self._slots[i] = None
            released.append(slot)
            if not slot.req.future.done():
                slot.req.future.set_exception(exc)
                if _obs.access_log_enabled():
                    _obs.log_access(
                        self.name, outcome, request_id=slot.req.trace_id,
                        ttft_ms=slot.ttft_ms, tokens=len(slot.tokens),
                        error=err)
        with self._cond:
            for slot in released:
                self._release_pages_locked(slot)
            # the rebuilt pool is zeroed, so any surviving shared-prefix
            # entries are stale — drop them and recycle their pages
            for entry in self._prefix.values():
                self._free.append(entry[0])
            self._prefix.clear()
            self._cond.notify_all()
        self._gauge_pages()
        self._kv = self.predictor.make_kv(self.num_pages)

    def _release_pages_locked(self, slot):  # holds(_cond)
        """Return a slot's pages to the free list: shared-prefix pages
        decref and hit the free list only when the LAST reader exits; the
        trailing private pages free unconditionally."""
        for key in slot.prefix_keys:
            entry = self._prefix.get(key)
            if entry is None:      # pool rebuild cleared the map already
                continue
            entry[1] -= 1
            if entry[1] <= 0:
                del self._prefix[key]
                self._free.append(entry[0])
        self._free.extend(slot.pages[len(slot.prefix_keys):])
        self._cond.notify_all()

    def _gauge_pages(self):
        with self._cond:
            in_use = self.num_pages - len(self._free)
        _telemetry.gauge(
            "serving.kv_pages_in_use.%s" % self.name).set(in_use)

    def _harvest_expired_locked(self, now):  # holds(_cond)
        dead = [r for r in self._queue if r.expired(now)]
        for req in dead:
            self._queue.remove(req)
        return dead

    def _admit_locked(self):  # holds(_cond)
        """Pop queue-head requests into free slots while the page pool
        covers them.  FIFO: a head request the pool cannot cover BLOCKS
        later ones and counts one ``serving.kv_pool_exhausted`` per stall
        episode."""
        admitted = []
        free_slots = [i for i, s in enumerate(self._slots) if s is None]
        while self._queue and free_slots:
            req = self._queue[0]
            # keys already in the map are shared pages this request reuses
            # (a sharer holding key i also holds 0..i-1)
            shared = []
            for key in req.prefix_keys:
                entry = self._prefix.get(key)
                if entry is None:
                    break
                shared.append((key, entry))
            if req.need - len(shared) > len(self._free):
                if not req.stall_counted:
                    req.stall_counted = True
                    _telemetry.counter("serving.kv_pool_exhausted").inc()
                    _telemetry.counter(
                        "serving.kv_pool_exhausted.%s" % self.name).inc()
                break
            self._queue.popleft()
            pages = []
            for key, entry in shared:
                entry[1] += 1
                pages.append(entry[0])
            # the remaining FULL-prefix pages are fresh: register them so
            # later requests with the same prompt prefix share them
            for key in req.prefix_keys[len(shared):]:
                page = self._free.pop()
                self._prefix[key] = [page, 1, False]
                pages.append(page)
            while len(pages) < req.need:
                pages.append(self._free.pop())
            if shared:
                _telemetry.counter("serving.prefix_hits").inc()
                _telemetry.counter(
                    "serving.prefix_hits.%s" % self.name).inc()
                _telemetry.counter(
                    "serving.prefix_pages_shared").inc(len(shared))
            self._slots[free_slots.pop(0)] = _Slot(
                req, pages, prefix_keys=req.prefix_keys)
            admitted.append(req)
        return admitted

    def _loop(self):
        while True:
            gate = self._gate
            if gate is not None:
                gate.wait()
            now = _time.perf_counter()
            queued = None
            abort = False
            with self._cond:
                self._last_iteration = now
                expired = self._harvest_expired_locked(now)
                admitted = self._admit_locked()
                active = self._active()
                if not admitted and not active:
                    if self._stopping and (self._abort
                                           or not self._queue):
                        queued = list(self._queue)
                        self._queue.clear()
                        abort = self._abort
                    else:
                        self._cond.wait(timeout=0.05)
            self._expire(expired)
            if queued is not None:
                if abort:
                    self._fail_all(queued, ServingError(
                        "generation engine stopped without drain"))
                return
            if not admitted and not active:
                continue
            with self._cond:
                abort = self._abort
            if abort:
                with self._cond:
                    queued = list(self._queue)
                    self._queue.clear()
                exc = ServingError("generation engine stopped without "
                                   "drain")
                self._fail_all(queued, exc)
                self._fail_active(exc)
                return
            self._gauge_pages()
            ok = True
            for req in admitted:
                if not self._dispatch_prefill(req):
                    ok = False
                    break
            if ok and self._active():
                self._dispatch_decode()

    def _expire(self, reqs):
        for req in reqs:
            _telemetry.counter("serving.deadline_exceeded").inc()
            _telemetry.counter(
                "serving.deadline_exceeded.%s" % self.name).inc()
            if not req.future.done():
                queued_ms = (_time.perf_counter() - req.t_submit) * 1e3
                req.future.set_exception(DeadlineExceededError(
                    "generation request for model %r expired in queue "
                    "before prefill (queued %.1fms, deadline passed)"
                    % (self.name, queued_ms)))
                _obs.log_access(self.name, "deadline",
                                request_id=req.trace_id, queue_ms=queued_ms)

    def _dispatch_failed(self, exc):
        """A failed call may have left the pool half-written: every
        in-flight sequence fails with the causal error and the breaker
        records the failure.  Returns False for the caller to bail."""
        _telemetry.counter("serving.dispatch_errors").inc()
        _LOG.warning("serving: generation dispatch for model %r failed "
                     "(%s: %s)", self.name, type(exc).__name__, exc)
        if self.breaker is not None:
            self.breaker.record_failure()
        self._fail_active(exc)
        return False

    def _dispatch_prefill(self, req):
        """Run one admitted request's prompt through its bucket's prefill:
        seeds the shared pool (only this request's pages are written, so
        in-flight sequences are untouched — the mid-flight JOIN) and
        produces the first token (TTFT)."""
        gp = self.predictor
        slot_idx = next(i for i, s in enumerate(self._slots)
                        if s is not None and s.req is req)
        slot = self._slots[slot_idx]
        breaker = self.breaker
        if breaker is not None and not breaker.allow_dispatch():
            self._slots[slot_idx] = None
            with self._cond:
                self._release_pages_locked(slot)
            if not req.future.done():
                req.future.set_exception(CircuitOpenError(
                    "model %r circuit breaker is OPEN; prefill failed "
                    "fast, retry after the cooldown" % (self.name,)))
                _obs.log_access(
                    self.name, "breaker", request_id=req.trace_id,
                    queue_ms=(_time.perf_counter() - req.t_submit) * 1e3)
            return True   # engine itself is fine
        s_bucket = gp.prefill_bucket(req.plen)
        w_s = _math.ceil(s_bucket / gp.page_size)
        sentinel = self.num_pages
        tokens = _np.zeros((1, s_bucket), _np.int32)
        tokens[0, :req.plen] = req.prompt
        table = _np.full((1, w_s), sentinel, _np.int32)
        k = min(w_s, len(slot.pages))
        table[0, :k] = slot.pages[:k]
        # shared-prefix pages another request already POPULATED must not
        # be rewritten while others read them: sentinel them so this
        # prefill's writes drop.  Decided at dispatch time: if the
        # registering request died before its prefill, this one writes.
        write_table = table
        if slot.prefix_keys:
            with self._cond:
                populated = [bool(self._prefix[key][2])
                             for key in slot.prefix_keys
                             if key in self._prefix]
            if any(populated):
                write_table = table.copy()
                for i, done in enumerate(populated):
                    if done and i < w_s:
                        write_table[0, i] = sentinel
        temp, tk, tp, keys = self._sample_arrays([(0, slot)], 1)
        t0 = _time.perf_counter()
        prog = self._program("prefill", s_bucket)
        try:
            with _tracing.span("serving.dispatch", cat="serving",
                               model=self.name, program="prefill",
                               bucket=s_bucket):
                self._kv, nxt = prog(
                    self._kv, tokens, _np.asarray([req.plen], _np.int32),
                    write_table, temp, tk, tp, keys)
                first = int(nxt[0])
        except Exception as exc:  # noqa: BLE001 — pool state is suspect
            return self._dispatch_failed(exc)
        slot.flops += prog.record["flops"]
        if slot.prefix_keys:
            with self._cond:
                for key in slot.prefix_keys:
                    entry = self._prefix.get(key)
                    if entry is not None:
                        entry[2] = True
        t1 = _time.perf_counter()
        if breaker is not None:
            breaker.record_success()
        slot.tokens.append(first)
        slot.ttft_ms = (t1 - req.t_submit) * 1e3
        _telemetry.timer("serving.prefill_ms").observe((t1 - t0) * 1e3)
        _telemetry.timer("serving.ttft_ms").observe(slot.ttft_ms)
        self._count_tokens(1)
        self._maybe_finish(slot_idx)
        return True

    def _dispatch_decode(self):
        """One decode iteration for every active slot.  The page-table
        width buckets to the widest need among active sequences; inactive
        slots ride along on the all-sentinel row (writes drop, output
        ignored), so sequences EXIT and JOIN mid-flight at fixed shapes."""
        gp = self.predictor
        B = self.decode_slots
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None]
        breaker = self.breaker
        if breaker is not None and not breaker.allow_dispatch():
            exc = CircuitOpenError(
                "model %r circuit breaker is OPEN; in-flight decode "
                "failed fast, retry after the cooldown" % (self.name,))
            for i, _ in active:
                self._slots[i] = None
            for _, s in active:
                if not s.req.future.done():
                    s.req.future.set_exception(exc)
                    _obs.log_access(
                        self.name, "breaker", request_id=s.req.trace_id,
                        ttft_ms=s.ttft_ms, tokens=len(s.tokens))
            with self._cond:
                for _, s in active:
                    self._release_pages_locked(s)
            self._gauge_pages()
            return
        width = pick_bucket(gp.decode_widths,
                            max(len(s.pages) for _, s in active))
        sentinel = self.num_pages
        token_ids = _np.zeros((B,), _np.int32)
        positions = _np.zeros((B,), _np.int32)
        table = _np.full((B, width), sentinel, _np.int32)
        for i, s in active:
            token_ids[i] = s.tokens[-1]
            positions[i] = s.pos
            k = min(width, len(s.pages))
            table[i, :k] = s.pages[:k]
        temp, tk, tp, keys = self._sample_arrays(active, B)
        t0 = _time.perf_counter()
        prog = self._program("decode", width)
        try:
            with _tracing.span("serving.dispatch", cat="serving",
                               model=self.name, program="decode",
                               width=width, active=len(active)):
                self._kv, nxt = prog(
                    self._kv, token_ids, positions, table, temp, tk, tp,
                    keys)
                nxt = nxt.cpu().numpy()
        except Exception as exc:  # noqa: BLE001 — pool state is suspect
            self._dispatch_failed(exc)
            return
        share = prog.record["flops"] / B
        t1 = _time.perf_counter()
        if breaker is not None:
            breaker.record_success()
        _telemetry.timer("serving.decode_step_ms").observe(
            (t1 - t0) * 1e3)
        self._count_tokens(len(active))
        for i, s in active:
            s.tokens.append(int(nxt[i]))
            s.pos += 1
            s.flops += share
            self._maybe_finish(i)

    def _sample_arrays(self, active, B):
        """Per-row sampling operands: active rows carry their request's
        controls and key words; padding rows ride greedy."""
        temp = _np.zeros((B,), _np.float32)
        tk = _np.zeros((B,), _np.int32)
        tp = _np.ones((B,), _np.float32)
        keys = _np.zeros((B, 2), _np.uint32)
        for i, s in active:
            req = s.req
            temp[i] = req.temperature
            tk[i] = req.top_k
            tp[i] = req.top_p
            keys[i] = req.key_words
        return temp, tk, tp, keys

    def _count_tokens(self, n):
        _telemetry.counter("serving.tokens_generated").inc(n)
        _telemetry.counter(
            "serving.tokens_generated.%s" % self.name).inc(n)

    def _maybe_finish(self, slot_idx):
        """Mid-flight EXIT: resolve the future and recycle the pages the
        same iteration the sequence hits EOS or its token budget."""
        slot = self._slots[slot_idx]
        req = slot.req
        done = len(slot.tokens) >= req.max_new or (
            req.eos_id is not None
            and slot.tokens[-1] == int(req.eos_id))
        if not done:
            return
        self._slots[slot_idx] = None
        with self._cond:
            self._release_pages_locked(slot)
        self._gauge_pages()
        wall_ms = (_time.perf_counter() - req.t_submit) * 1e3
        _telemetry.timer("serving.generate_request_ms").observe(wall_ms)
        if not req.future.done():
            req.future.set_result(_np.asarray(slot.tokens, _np.int32))
            if _obs.access_log_enabled():
                _obs.log_access(
                    self.name, "ok", request_id=req.trace_id,
                    dispatch_ms=wall_ms, ttft_ms=slot.ttft_ms,
                    tokens=len(slot.tokens), bytes=len(slot.tokens) * 4,
                    flops=int(slot.flops))

    # ---------------------------------------------------------- watchdog
    def _stall_probe(self, interval_s):
        """The watchdog's stall probe (registered at :meth:`start`): the
        engine is wedged when work waits but the loop has not turned over
        within ``interval_s``; None while it moves."""
        now = _time.perf_counter()
        with self._cond:
            queued = len(self._queue)
            free = len(self._free)
            last_iter = self._last_iteration
            thread = self._thread
            oldest_q = min((r.t_submit for r in self._queue),
                           default=None)
        # advisory cross-thread read of the engine-owned slot table (as
        # stats() reads it)
        active = self._active()
        if queued == 0 and not active:
            return None
        if now - last_iter < interval_s:
            return None
        ages = [now - s.req.t_submit for s in active]
        if oldest_q is not None:
            ages.append(now - oldest_q)
        return {
            "model": self.name,
            "queued": queued,
            "active": len(active),
            "kv_pages": self.num_pages,
            "kv_pages_free": free,
            "since_last_iteration_s": round(now - last_iter, 3),
            "engine_alive": bool(thread is not None
                                 and thread.is_alive()),
            "oldest_request_age_s": round(max(ages), 3) if ages else 0.0,
        }

    # ------------------------------------------------------------- stats
    def stats(self):
        with self._cond:
            queued = len(self._queue)
            free = len(self._free)
            thread = self._thread
            prefix_entries = len(self._prefix)
            prefix_shared = sum(
                max(0, e[1] - 1) for e in self._prefix.values())
        return {
            "queued": queued,
            "active": len(self._active()),
            "decode_slots": self.decode_slots,
            "shared_prefix": self._share,
            "prefix_entries": prefix_entries,
            "prefix_pages_shared": prefix_shared,
            "kv_pages": self.num_pages,
            "kv_pages_free": free,
            "page_size": self.predictor.page_size,
            "max_context": self.predictor.max_context,
            "prompt_buckets": list(self.predictor.prompt_buckets),
            "decode_widths": list(self.predictor.decode_widths),
            "engine_alive": bool(thread is not None
                                 and thread.is_alive()),
            "breaker": self.breaker.state
            if self.breaker is not None else "closed",
        }
