"""``mx.numerics`` — in-step tensor statistics, the nanguard's forensics,
and the quantization drift arithmetic (counterpart of
``mxnet_tpu.numerics``).

The reference answers "are the numbers right?" inside its one-program
steps: taps summarize tensors at trace time and the statistics ride out
of the compiled step as a side output.  The port's steps are eager, so a
tap summarizes the tensor on the card as the step passes it:

  * **statistics** — :func:`summarize` reduces a tensor to the six
    :data:`STAT_FIELDS` (amax/amin/rms over the finite values, the
    non-finite count, the fractions above bf16's largest finite value and
    of subnormals, read from the bit pattern so subnormals count on the
    card too) as a (6,) f32 tensor on the tensor's device;
  * **the cadence knob** — ``numerics.capture = off | step:N``
    (``MXNET_TPU_NUMERICS``).  Each step seam asks :func:`should_capture`
    once a step; a step that captures nothing runs no code of this module
    beyond that question, so it launches exactly the kernels of a run
    with capture off.  The knob is epoch-neutral;
  * **collection** — :func:`collect` opens a collector that :func:`tap`
    (inside models: the TransformerLM's ``layer_out`` stack) and
    :func:`record` (the seams' ``out`` / ``loss`` / ``grad.*`` /
    ``update.*``) fill, in first-tap site order;
  * **no host sync** — :func:`publish` stacks a step's sites into one
    ``[sites, 6]`` tensor on the card, copies it to pinned host memory
    without blocking and records a CUDA event; :func:`poll` reads only
    the entries whose event has completed (the ``resilience.watch_streak``
    pattern), blocking only past 64 pending entries;
  * **nanguard forensics** — seams park a replay of the step's batch with
    :func:`hold_replay` while the nanguard is armed; when the guard
    aborts, :func:`run_forensics` runs it once with every site
    summarized, on copies of the state (nothing of the run changes), and
    names the FIRST non-finite site in the ``nanguard_forensics`` JSONL
    event, the flight recorder and the
    ``numerics.first_nonfinite_site.<source>`` gauge;
  * **quantization drift** — :func:`update_quant_drift`, the host EWMA of
    runtime amax over the calibration thresholds.  Its serving wiring
    (``quant.drift_every``) is not ported yet.
"""
from __future__ import annotations

import contextlib
import logging
import threading
from collections import OrderedDict

_LOG = logging.getLogger("mxnet_tpu_torch.numerics")

__all__ = ["STAT_FIELDS", "summarize", "stats_dict", "configure",
           "capture_every", "capture_active", "should_capture",
           "capture_token", "collect", "collecting", "tap", "record",
           "tap_stacked", "expand_stats", "publish", "poll", "latest",
           "add_listener", "remove_listener", "hold_replay", "drop_replay",
           "first_nonfinite", "run_forensics", "forensics_records",
           "update_quant_drift", "reset"]

#: Per-site summary statistics, in field order of the (6,) float32
#: vector :func:`summarize` produces.  ``amax``/``amin``/``rms`` are
#: computed over the FINITE |x| mass (a single inf must not wipe out the
#: magnitude picture), ``nonfinite`` counts NaN/inf elements, and the
#: bf16 fractions measure how much of the tensor sits outside bf16's
#: representable magnitude band.
STAT_FIELDS = ("amax", "amin", "rms", "nonfinite",
               "bf16_overflow", "bf16_underflow")

# bf16 shares float32's exponent range, so true overflow is rare; the
# actionable band is "would round to inf when cast" (> bf16 max finite)
# and "would flush toward zero" (a subnormal magnitude)
_BF16_MAX = 3.3895313892515355e38
_TINY_BITS = 0x00800000  # bit pattern of the smallest normal f32

_LOCK = threading.RLock()
_COUNTS = {}                    # guarded-by: _LOCK — per-source step counter
_PENDING = {}                   # guarded-by: _LOCK — source -> [entries]
_PENDING_MAX = 64               # same bound as resilience's streak queue
_LATEST = {}                    # guarded-by: _LOCK — source -> (step, stats)
_LISTENERS = []                 # guarded-by: _LOCK — fn(source, step, stats)
_REPLAY = {}                    # guarded-by: _LOCK — source -> closure
_FORENSICS = []                 # guarded-by: _LOCK — records, newest last
_FORENSICS_MAX = 16
# site -> monotonic first-tap sequence number: the order sites are first
# tapped in, kept for the process lifetime (a site keeps its first rank)
_SITE_ORDER = {}                # guarded-by: _LOCK
_SITE_SEQ = [0]                 # guarded-by: _LOCK

_TLS = threading.local()        # .collectors: stack of OrderedDicts


# --------------------------------------------------------------- summarize
def summarize(x):
    """(6,) float32 summary of ``x`` (:data:`STAT_FIELDS` order) on its
    device; never syncs.  Subnormal magnitudes count as zero in
    ``amax``/``amin``/``rms`` (the reference's devices flush them) and in
    ``bf16_underflow``.  ``amax``, ``amin``, ``nonfinite`` and the two
    fractions are exact (the fractions are int64 counts divided in f64,
    rounded once to f32), so the card and the CPU agree bit for bit;
    ``rms`` is an f32 sum, equal up to summation order."""
    import torch
    x = getattr(x, "_data", x)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    x = x.detach()
    xf = x.float().reshape(-1)
    n = xf.numel()
    if n == 0:
        return torch.zeros(len(STAT_FIELDS), dtype=torch.float32,
                           device=xf.device)
    notfin = ~torch.isfinite(xf)
    # subnormal magnitudes, read from the bit pattern: a float compare
    # against a subnormal flushes on devices that flush them.  The
    # magnitudes read them as zero, as the reference's devices do
    bits = xf.view(torch.int32) & 0x7FFFFFFF
    sub = (bits > 0) & (bits < _TINY_BITS)
    mag = xf.abs().masked_fill(sub, 0.0)
    absx = mag.masked_fill(notfin, 0.0)
    amax = absx.amax()
    amin = mag.masked_fill(notfin, float("inf")).amin().nan_to_num(
        posinf=0.0)
    # IEEE divisions on every device (the card divides by a Python scalar
    # through its reciprocal)
    n32 = torch.full((), float(n), dtype=torch.float32, device=xf.device)
    n64 = torch.full((), float(n), dtype=torch.float64, device=xf.device)
    rms = torch.sqrt((absx * absx).sum() / n32)
    nonfinite = notfin.sum().float()
    counts = torch.stack([(absx > _BF16_MAX).sum(), sub.sum()])
    fracs = (counts.double() / n64).float()
    return torch.cat([torch.stack([amax, amin, rms, nonfinite]), fracs])


def stats_dict(vec):
    """Host-side view of one (6,) stats vector as a plain dict of floats,
    keyed by :data:`STAT_FIELDS`."""
    import numpy as _np
    v = _np.asarray(_host(vec), dtype=_np.float64).reshape(-1)
    return {f: float(v[i]) for i, f in enumerate(STAT_FIELDS)}


def _host(v):
    """A stats value as numpy (a tensor copied to the host)."""
    import numpy as _np
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return _np.asarray(v)


# --------------------------------------------------------------- the knob
def configure(spec):
    """Validate a ``numerics.capture`` spec: ``''``/``'off'`` disables,
    ``'step:N'`` captures every Nth step per source.  Raises ValueError
    on anything else (the config hook reverts the knob).  Returns the
    parsed cadence."""
    spec = (spec or "").strip().lower()
    if spec in ("", "off", "0"):
        return 0
    if spec.startswith("step:"):
        try:
            every = int(spec[5:])
        except ValueError:
            raise ValueError(
                "numerics.capture: bad cadence %r — want step:<int>"
                % (spec,))
        if every < 1:
            raise ValueError(
                "numerics.capture: cadence must be >= 1, got %d" % every)
        return every
    raise ValueError(
        "numerics.capture: unrecognized spec %r — want 'off' or "
        "'step:N'" % (spec,))


def capture_every():
    """Current cadence N (0 = capture off), read from the knob each call
    so ``MXNET_TPU_NUMERICS`` works without a set(); a bad environment
    spec (the only unvalidated path) degrades to off with one warning."""
    from . import config as _config
    spec = _config.get("numerics.capture")
    if not spec:
        return 0
    try:
        return configure(spec)
    except ValueError:
        if not _TLS.__dict__.get("warned_spec"):
            _TLS.warned_spec = True
            _LOG.warning(
                "numerics: ignoring bad MXNET_TPU_NUMERICS spec %r "
                "(want 'off' or 'step:N')", spec)
        return 0


def capture_active():
    """True when the capture knob is on (any cadence)."""
    return capture_every() > 0


def should_capture(source):
    """One call a step a seam: True when THIS step summarizes its sites.
    Advances the per-source step counter only while capture is on, so
    ``step:N`` means every Nth step of the capture era, its first
    included."""
    every = capture_every()
    if every <= 0:
        return False
    with _LOCK:
        n = _COUNTS.get(source, 0)
        _COUNTS[source] = n + 1
        return n % every == 0


def capture_token(instrument):
    """The reference's program-cache key element for a variant: ``()``
    off, ``("numerics",)`` on.  The port's steps are not programs, so it
    keys nothing here; kept for the reference's API."""
    return ("numerics",) if instrument else ()


# ------------------------------------------------------------ tap registry
def _collectors():
    stack = getattr(_TLS, "collectors", None)
    if stack is None:
        stack = _TLS.collectors = []
    return stack


@contextlib.contextmanager
def collect():
    """Open a tap collector for the current thread; yields an OrderedDict
    that :func:`tap` calls (in this thread) fill with ``site -> (6,)
    stats`` entries, in tap order."""
    stack = _collectors()
    sink = OrderedDict()
    stack.append(sink)
    try:
        yield sink
    finally:
        stack.pop()


def collecting():
    """True when a :func:`collect` context is open on this thread."""
    return bool(_collectors())


def _register_site(sink, site):
    if site in sink:
        k = 2
        while "%s#%d" % (site, k) in sink:
            k += 1
        site = "%s#%d" % (site, k)
    with _LOCK:
        if site not in _SITE_ORDER:
            _SITE_ORDER[site] = _SITE_SEQ[0]
            _SITE_SEQ[0] += 1
    return site


def _inexact(x):
    x = getattr(x, "_data", x)
    return getattr(x, "is_floating_point", lambda: False)()


def tap(site, x):
    """Record summary stats for ``x`` under ``site`` in the ambient
    collector (no-op without one) and return ``x`` unchanged — taps drop
    into expressions.  Integer tensors (ids, masks) are skipped."""
    stack = _collectors()
    if not stack or not _inexact(x):
        return x
    sink = stack[-1]
    sink[_register_site(sink, site)] = summarize(x)
    return x


def record(sink, site, x):
    """Seam-side tap into an EXPLICIT stats mapping (per-parameter grads
    and updates, the output and the loss): registers ``site`` in the
    global order and stores ``summarize(x)`` in ``sink``."""
    sink[_register_site(sink, site)] = summarize(x)


def tap_stacked(site, stacked):
    """Record an already-stacked ``(L, 6)`` per-layer stats tensor (the
    ys of ``runtime.scan_stack``) under ``site``; the host side expands
    it to ``site[i]`` entries.  No-op without a collector."""
    stack = _collectors()
    if not stack:
        return
    sink = stack[-1]
    site = _register_site(sink, site)
    sink[site] = stacked
    # pre-register the expanded names so their order is stable
    with _LOCK:
        for i in range(int(stacked.shape[0])):
            name = "%s[%d]" % (site, i)
            if name not in _SITE_ORDER:
                _SITE_ORDER[name] = _SITE_SEQ[0]
                _SITE_SEQ[0] += 1


def _ordered(stats):
    with _LOCK:
        order = dict(_SITE_ORDER)
    return sorted(stats, key=lambda s: order.get(s, 1 << 30))


def _rows(stats):
    """``(names, values)`` of a stats mapping in site order, stacked
    ``(L, 6)`` entries expanded to ``site[i]``."""
    names, values = [], []
    for site in _ordered(stats):
        v = stats[site]
        if len(v.shape) == 2 and v.shape[-1] == len(STAT_FIELDS):
            names += ["%s[%d]" % (site, i) for i in range(v.shape[0])]
        else:
            names.append(site)
            v = v.reshape(1, -1)
        values.append(v)
    return names, values


def expand_stats(stats):
    """Host-side: flatten a stats mapping to ``site -> (6,) numpy``,
    expanding stacked ``(L, 6)`` entries to ``site[i]`` (copies device
    tensors to the host)."""
    import numpy as _np
    names, values = _rows(stats)
    out = OrderedDict()
    rows = _np.concatenate([_np.asarray(_host(v), _np.float32)
                            for v in values]) if values else []
    for name, row in zip(names, rows):
        out[name] = row
    return out


# ----------------------------------------------------- async stats fetch
class _Entry:
    """One published step: its site names, the host copy of its stacked
    ``[sites, 6]`` stats, and the CUDA event after the copy (None when
    the stats were on the host already)."""

    __slots__ = ("step", "names", "host", "event")

    def __init__(self, step, names, host, event):
        self.step, self.names, self.host, self.event = \
            step, names, host, event


def _stage(step, stats):
    import torch
    names, values = _rows(stats)
    stacked = torch.cat([v.reshape(-1, len(STAT_FIELDS)).float()
                         for v in values])
    if stacked.is_cuda:
        host = torch.empty(stacked.shape, dtype=stacked.dtype,
                           pin_memory=True)
        host.copy_(stacked, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(stacked.device))
    else:
        host, event = stacked.clone(), None
    return _Entry(int(step), names, host, event)


def publish(source, step, stats):
    """Queue a step's stats: one stacked ``[sites, 6]`` tensor, one
    non-blocking copy to pinned host memory and a CUDA event.  Never
    blocks on the card unless more than 64 entries are pending."""
    if not stats:
        return
    entry = _stage(step, stats)
    with _LOCK:
        q = _PENDING.setdefault(source, [])
        q.append(entry)
        overflow = len(q) > _PENDING_MAX
    poll(source, block=overflow)


def poll(source=None, block=False):
    """Drain pending stats whose copy has completed (``event.query()``);
    with ``block=True`` wait for everything.  Each drained step lands in
    :func:`latest`, fires the listeners and (sink on) emits a
    ``numerics`` JSONL event.  Returns the number of steps drained."""
    from . import telemetry as _telemetry
    with _LOCK:
        sources = [source] if source is not None else list(_PENDING)
    drained = 0
    for src in sources:
        while True:
            with _LOCK:
                q = _PENDING.get(src)
                if not q:
                    break
                entry = q[0]
                if entry.event is not None:
                    if block:
                        entry.event.synchronize()
                    elif not entry.event.query():
                        break
                q.pop(0)
            vals = entry.host.numpy()
            host = OrderedDict(zip(entry.names, vals))
            with _LOCK:
                _LATEST[src] = (entry.step, host)
                listeners = list(_LISTENERS)
            drained += 1
            if _telemetry.enabled():
                worst = max((float(v[3]) for v in host.values()),
                            default=0.0)
                _telemetry.log_event(
                    "numerics", source=src, step=entry.step,
                    sites=len(host), nonfinite=worst,
                    stats={s: stats_dict(v) for s, v in host.items()})
            for fn in listeners:
                try:
                    fn(src, entry.step, host)
                except Exception:  # noqa: BLE001 — listeners are best-effort
                    _LOG.exception("numerics listener failed")
    return drained


def latest(source):
    """Most recent drained ``(step, {site: (6,) numpy})`` for ``source``,
    or None.  Call :func:`poll` first for freshness."""
    with _LOCK:
        return _LATEST.get(source)


def add_listener(fn):
    """Register ``fn(source, step, host_stats)`` to fire on every drained
    step."""
    with _LOCK:
        _LISTENERS.append(fn)


def remove_listener(fn):
    with _LOCK:
        try:
            _LISTENERS.remove(fn)
        except ValueError:
            pass


# -------------------------------------------------- nanguard forensics
def hold_replay(source, fn):
    """Park a zero-arg closure that re-runs the seam's last batch with
    every site summarized and returns its stats mapping.  Seams refresh
    it each step while the nanguard is armed; the guard's abort consumes
    it through :func:`run_forensics`.  One closure a step — no tensor is
    copied until the replay runs."""
    with _LOCK:
        _REPLAY[source] = fn


def drop_replay(source):
    with _LOCK:
        _REPLAY.pop(source, None)


def first_nonfinite(host_stats):
    """First site (in tap order) whose non-finite count is > 0, or
    None."""
    for site in _ordered(host_stats):
        if float(host_stats[site][3]) > 0:
            return site
    return None


def run_forensics(source):
    """The nanguard's abort path: consume the held replay of ``source``,
    run it once, and report the first non-finite site.  Returns the
    forensics record (None without a held replay).  The record is kept
    in :func:`forensics_records`, emitted as a ``nanguard_forensics``
    JSONL event and a flight-recorder ring event, and the site name lands
    on the ``numerics.first_nonfinite_site.<source>`` gauge."""
    from . import telemetry as _telemetry
    with _LOCK:
        fn = _REPLAY.pop(source, None)
    if fn is None:
        return None
    try:
        stats = fn()
    except Exception:  # noqa: BLE001 — the replay re-runs the very batch
        # that blew up; a crash here must not mask the nanguard abort
        _LOG.exception("numerics: forensics replay for %r failed", source)
        return None
    host = expand_stats(stats or {})
    site = first_nonfinite(host)
    bad = [s for s in host if float(host[s][3]) > 0]
    record = {
        "source": source,
        "first_nonfinite_site": site,
        "nonfinite_sites": bad,
        "sites": len(host),
        "stats": {s: stats_dict(host[s]) for s in bad} or
                 {s: stats_dict(v) for s, v in host.items()},
    }
    with _LOCK:
        _FORENSICS.append(record)
        del _FORENSICS[:-_FORENSICS_MAX]
    _telemetry.gauge(
        "numerics.first_nonfinite_site.%s" % source).set(site or "none")
    if _telemetry.enabled():
        _telemetry.log_event("nanguard_forensics", **record)
    try:
        from . import tracing as _tracing
        _tracing.record_event(
            "numerics", "nanguard_forensics", source=source,
            first_nonfinite_site=site, nonfinite_sites=len(bad))
    except Exception:  # noqa: BLE001 — forensics must not break the abort
        pass
    _LOG.error(
        "numerics: nanguard forensics for %r — first non-finite site: "
        "%s (%d/%d sites non-finite)", source, site, len(bad), len(host))
    return record


def forensics_records():
    """Recent forensics records, oldest first (bounded ring)."""
    with _LOCK:
        return list(_FORENSICS)


# ---------------------------------------------------- quantization drift
def update_quant_drift(model, sites, amaxes, thresholds, ewma,
                       alpha=0.2, threshold_ratio=None):
    """Fold one stats-twin sample into the per-site drift EWMA.

    ``sites`` names the twin's output order, ``amaxes`` is the host
    (S,) runtime-amax sample, ``thresholds`` the calibration manifest
    (site -> calibrated amax), ``ewma`` the caller-owned mutable state
    dict (site -> smoothed ratio).  Sets the
    ``quant.drift_ratio.<model>.<site>`` gauges and, past
    ``threshold_ratio`` (default: the ``quant.drift_threshold`` knob),
    emits one ``quant_drift`` JSONL event per newly-drifted site.
    Returns the list of currently-drifted site names."""
    import numpy as _np
    from . import config as _config
    from . import telemetry as _telemetry
    if threshold_ratio is None:
        threshold_ratio = float(_config.get("quant.drift_threshold"))
    vals = _np.asarray(amaxes, dtype=_np.float64).reshape(-1)
    drifted = []
    for site, amax in zip(sites, vals):
        cal = float(thresholds.get(site, 0.0) or 0.0)
        if cal <= 0.0:
            continue
        ratio = float(amax) / cal
        prev = ewma.get(site)
        sm = ratio if prev is None else alpha * ratio + (1 - alpha) * prev
        was_drifted = prev is not None and prev > threshold_ratio
        ewma[site] = sm
        _telemetry.gauge(
            "quant.drift_ratio.%s.%s" % (model, site)).set(round(sm, 6))
        if sm > threshold_ratio:
            drifted.append(site)
            if not was_drifted:
                _telemetry.counter("quant.drift_trips").inc()
                if _telemetry.enabled():
                    _telemetry.log_event(
                        "quant_drift", model=model, site=site,
                        ratio=round(sm, 6), sample=round(float(amax), 6),
                        calibrated=round(cal, 6),
                        threshold=threshold_ratio)
                _LOG.warning(
                    "numerics: quantization drift on %s/%s — runtime "
                    "amax EWMA %.4g is %.2fx the calibrated %.4g",
                    model, site, sm * cal, sm, cal)
    return drifted


# ------------------------------------------------------------------ reset
def reset():
    """Test hook: forget counters, queues, replays, forensics and site
    order (the capture cadence itself lives on the config knob)."""
    with _LOCK:
        _COUNTS.clear()
        _PENDING.clear()
        _LATEST.clear()
        _LISTENERS[:] = []
        _REPLAY.clear()
        _FORENSICS[:] = []
        _SITE_ORDER.clear()
        _SITE_SEQ[0] = 0
