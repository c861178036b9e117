"""``mx.autotune`` (also ``mx.perf.autotune``) — a measured search over
the launch parameters the Hopper kernels take at run time (counterpart of
``mxnet_tpu.autotune``).

The reference searches the Pallas tier's block sizes per program site and
may route a site to the XLA lowering where that measures faster.  Here a
site's candidates are only the kernel's own configurations, the
parameters each kernel already takes when it launches:

* ``search_paged`` — K4's keys per split (``csrc/paged_attn.cu``), over
  multiples of ``cuda_kernels.PAGED_SPLIT_KEYS`` at a decode site's
  ``(B*H, context)``; ``paged_pick`` hands the winner to
  ``kernels.paged_attention_pool``.  The default stays the fixed rule
  ``cuda_kernels.paged_splits``;
* ``search_fused`` — K1's and K3's elements a block (the ``LaunchTable``
  chunk; ``csrc/sgd_step.cu``, ``csrc/adam_step.cu``) for one tensor list,
  keyed by the list's shapes; ``fused_step_pick`` hands the entry's chunk
  to the launch table an optimizer makes for a list of those shapes
  (``Optimizer._table_of``), once, when it makes the table.  The
  reference gates ``kernels.fused_step_enabled`` on its pick; here no pick
  decides a route, so the predicate reads none;
* ``search_attention`` — K2f takes no launch parameter (its tiles are
  compiled in), so its space has one point: the entry records that
  point's time and parity.  No attention dispatch reads it
  (``attention_pick`` is there for a caller that asks);
* ``search_stack`` / ``search_step`` — knob assignments
  (``runtime.stack_mode`` x ``runtime.remat``, or any), measured on any
  device; ``runtime.stack_tuning`` reads ``stack_pick`` while both knobs
  sit at their defaults.

No pick reaches a plain version: the tier-off knob (``kernels.enabled``)
stays the only way to run one on CUDA tensors.  The search times the
plain version, and the one PyTorch call that computes the same function
where there is one, and writes them into the entry beside the winner for
the record; they never win.  A candidate's time counts only after its
output meets the kernel's contract against the plain version (bitwise for
K1 and K3; per row for K4, as ``chip_smoke.py`` holds it).  A candidate
replaces the fixed rule only when it is faster by more than the spread of
both timings (max - min over the repeats): a gain inside the noise keeps
the fixed rule, and the entry records the fastest candidate beside it.

Modes (``perf.autotune``): ``auto`` (default) applies persisted winners
and, on a miss, keeps the fixed rule and measures nothing (a search
launches kernels, and a step must not gain any while every knob sits at
its default); ``measure`` searches on a miss, on the card only (a kernel
search on the CPU raises with the reason; ``search_stack`` and
``search_step`` run anywhere); ``off`` reads no cache.

The cache (``perf.autotune_cache``, else ``<model_store.root>/
autotune.json``) is JSON at ``CACHE_VERSION``, written atomically
(``resilience.atomic_write``); a corrupt or foreign file warns once, counts
``autotune.cache_invalid`` and reads as empty.  A key holds the family,
the site, the device name, the dominant dtype and
:func:`config_fingerprint`.  Applied picks are memoized per
``config.epoch()``; every recorded winner bumps :func:`generation`.

Telemetry: ``autotune.search``, ``autotune.measure``,
``autotune.cache_hit`` / ``cache_miss`` / ``cache_invalid``,
``autotune.applied``.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time

from . import config as _config
from . import telemetry as _telemetry

__all__ = ["enabled", "mode", "cache_path", "config_fingerprint",
           "generation", "reset", "lookup", "record", "attention_pick",
           "paged_pick", "fused_step_pick", "stack_pick",
           "search_attention", "search_paged", "search_fused",
           "search_step", "search_stack",
           "export_entries", "CACHE_VERSION"]

CACHE_VERSION = 1

_MISS = object()  # negative-lookup memo sentinel

_LOCK = threading.RLock()
_ENTRIES = [None]   # guarded-by: _LOCK — loaded disk entries (or None)
_LOADED_PATH = [None]  # guarded-by: _LOCK — path _ENTRIES came from
_PICKS = {}         # guarded-by: _LOCK — key -> applied pick | _MISS
_PICK_EPOCH = [None]  # guarded-by: _LOCK — config epoch _PICKS is valid for
_GENERATION = [0]   # guarded-by[writes]: _LOCK — bumped per recorded winner
_WARNED = set()     # guarded-by: _LOCK — one-shot warning dedup
# the hot path's shortcut: (config epoch, families with entries) once the
# cache was read under that epoch; a pick of a family absent from it is
# None at the cost of two compares
_FAST = [None]      # guarded-by[writes]: _LOCK

#: the searches' timing: median of this many timed calls after a warm-up
REPEATS = 5
#: at most this many candidates a site
MAX_CANDIDATES = 8


# ------------------------------------------------------------ knob surface
def mode():
    """The ``perf.autotune`` mode: 'off' | 'auto' | 'measure'."""
    return (_config.get("perf.autotune") or "").strip().lower() or "auto"


def enabled():
    return mode() != "off"


def cache_path():
    """The cache file: ``perf.autotune_cache``, or
    ``<model_store.root>/autotune.json`` (~/.mxnet by default)."""
    p = _config.get("perf.autotune_cache")
    if p:
        return os.path.expanduser(p)
    root = _config.get("model_store.root") or "~/.mxnet"
    return os.path.join(os.path.expanduser(root), "autotune.json")


def config_fingerprint():
    """The knob values the kernels launch against, rendered into the
    persisted key: whether the kernel tier is on (a pick never applies to
    a plain version)."""
    return "kernels=%d" % int(bool(_config.get("kernels.enabled")))


def generation():
    """Monotonic count of winners recorded (or state resets) in this
    process."""
    return _GENERATION[0]


def reset_memo():
    """Drop the applied picks (a knob that decides what they are
    changed); the disk entries stay loaded."""
    with _LOCK:
        _PICKS.clear()
        _PICK_EPOCH[0] = None
        _FAST[0] = None


def reset():
    """Forget in-memory picks and the loaded cache: the next lookup reads
    the disk again, as a fresh process would.  The file is untouched."""
    with _LOCK:
        _ENTRIES[0] = None
        _LOADED_PATH[0] = None
        _WARNED.clear()
        _GENERATION[0] += 1
        reset_memo()


# ----------------------------------------------------------- cache backend
def _warn_once(tag, msg):
    with _LOCK:
        if tag in _WARNED:
            return
        _WARNED.add(tag)
    import warnings
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _load_entries():
    """Disk entries of the current cache path (memoized).  A corrupt,
    unreadable or wrong-schema file counts ``autotune.cache_invalid`` and
    reads as empty."""
    with _LOCK:
        path = cache_path()
        if _ENTRIES[0] is not None and _LOADED_PATH[0] == path:
            return _ENTRIES[0]
        entries = {}
        try:
            with open(path) as f:
                raw = json.load(f)
            if (not isinstance(raw, dict)
                    or raw.get("version") != CACHE_VERSION
                    or not isinstance(raw.get("entries"), dict)):
                raise ValueError("unrecognized tuning-cache schema")
            entries = {k: v for k, v in raw["entries"].items()
                       if isinstance(k, str) and isinstance(v, dict)}
        except FileNotFoundError:
            pass
        except Exception as exc:  # noqa: BLE001 — a corrupt file reads
            # as an empty one: tuning is an optimization, never a crash
            _telemetry.counter("autotune.cache_invalid").inc()
            _warn_once("load:%s" % path,
                       "ignoring corrupt autotune cache %s (%s); the "
                       "fixed launch rules apply" % (path, exc))
            entries = {}
        _ENTRIES[0] = entries
        _LOADED_PATH[0] = path
        return entries


def _write_entries(entries):
    """Atomic write-through; an unwritable location warns, and the winner
    still applies in this process."""
    from . import resilience as _resilience
    path = cache_path()
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with _resilience.atomic_write(path, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": entries},
                      f, indent=1, sort_keys=True)
    except OSError as exc:
        _warn_once("write:%s" % path,
                   "cannot persist autotune cache to %s (%s); winners "
                   "apply in this process only" % (path, exc))


def _device_kind():
    from . import perf as _perf
    return _perf.device_kind() or "cpu"


def _key(family, site, dtype):
    return "|".join((family, site, _device_kind(), str(dtype),
                     config_fingerprint()))


def _check_epoch_locked():  # holds(_LOCK)
    ep = _config.epoch()
    if _PICK_EPOCH[0] != ep:
        # a knob changed: drop the memo and consult the cache again under
        # the new fingerprint
        _PICKS.clear()
        _PICK_EPOCH[0] = ep


def lookup(family, site, dtype):
    """The cached winner of a site, or None.  Hits are memoized per config
    epoch and counted ``autotune.cache_hit`` + ``applied`` once; misses
    memoize a negative."""
    with _LOCK:
        _check_epoch_locked()
        key = _key(family, site, dtype)
        pick = _PICKS.get(key)
        if pick is _MISS:
            return None
        if pick is not None:
            return pick
        entry = _load_entries().get(key)
        if entry is not None:
            _telemetry.counter("autotune.cache_hit").inc()
            _telemetry.counter("autotune.applied").inc()
            _PICKS[key] = entry
            return entry
        _telemetry.counter("autotune.cache_miss").inc()
        _PICKS[key] = _MISS
        return None


def record(family, site, dtype, entry):
    """Persist one searched winner (write-through) and apply it in this
    process: the memo updates and :func:`generation` bumps."""
    with _LOCK:
        _check_epoch_locked()
        key = _key(family, site, dtype)
        entries = dict(_load_entries())
        entries[key] = entry
        _ENTRIES[0] = entries
        _write_entries(entries)
        _PICKS[key] = entry
        _FAST[0] = None
        _GENERATION[0] += 1
        _telemetry.counter("autotune.search").inc()
    return entry


def _absent(family):
    """True when no entry of ``family`` can apply: the cheap test every
    pick makes first (the cache is read once per config epoch)."""
    fast = _FAST[0]
    ep = _config.epoch()
    if fast is None or fast[0] != ep:
        with _LOCK:
            if mode() == "off":
                fams = frozenset()
            else:
                fams = frozenset(k.split("|", 1)[0]
                                 for k in _load_entries())
            fast = _FAST[0] = (ep, fams, mode())
    return family not in fast[1] and fast[2] != "measure"


def export_entries():
    """The autotune state as one JSON-serializable dict."""
    with _LOCK:
        applied = {k: v for k, v in _PICKS.items() if v is not _MISS}
        return {
            "generation": _GENERATION[0],
            "mode": mode(),
            "path": cache_path(),
            "entries": dict(_load_entries()),
            "applied": applied,
        }


# ------------------------------------------------------------ measurement
def _require_card(what):
    if not _card():
        raise RuntimeError(
            "mx.autotune: %s measures a CUDA kernel and this machine has no "
            "CUDA device; the fixed launch rule applies here" % what)


def _synth(shape, dtype, seed=0, device="cuda"):
    """A seeded, well-conditioned operand (numpy draws, so the same seed
    gives the same data on any machine)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return t.to(device=device, dtype=getattr(torch, str(dtype)))


#: back-to-back calls a timed repeat holds, and the device-side wait
#: queued ahead of them (cycles of ``torch.cuda._sleep``, about 30 ms)
CALLS = 10
_LEAD_CYCLES = 50_000_000


def _measure_ms(fn, repeats=None, calls=None, spread=False):
    """Median device time of one warmed ``fn()`` call in ms: CUDA events
    around ``calls`` back-to-back calls queued behind a device-side wait,
    so the host has queued them all before the card starts and the span
    is the card's work, not the host's launch overhead (a decode step's
    kernel is shorter than its wrapper's host path).  With ``spread``,
    ``(median, max - min)`` over the repeats.  Counts one
    ``autotune.measure``."""
    import torch
    repeats = repeats or REPEATS
    calls = calls or CALLS
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_LEAD_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    _telemetry.counter("autotune.measure").inc()
    times.sort()
    if spread:
        return times[len(times) // 2], times[-1] - times[0]
    return times[len(times) // 2]


def _over_fixed(times, spreads, fixed):
    """The candidate to apply from measured ``times`` (label -> ms) and
    their ``spreads``: the fastest, where it beats the fixed rule's by
    more than the larger spread of the two; else the fixed rule's own
    label (when it was timed) or the fastest."""
    if not times:
        return None
    best = min(times, key=times.get)
    fixed = str(fixed)
    if fixed not in times or best == fixed:
        return best
    gain = times[fixed] - times[best]
    return best if gain > max(spreads[best], spreads[fixed]) else fixed


def _row_rel_err(o, po):
    """Max over rows of max|o - po| / max|po| in the row."""
    o = o.float().reshape(-1, o.shape[-1])
    po = po.float().reshape(-1, po.shape[-1])
    err = (o - po).abs().amax(dim=-1)
    ref = po.abs().amax(dim=-1).clamp_min(1e-30)
    return float((err / ref).max())


#: the per-row contracts the card holds K2f and K4 to against their plain
#: versions (chip_smoke.py ROW_REL_TOL, F32_ROW_REL_TOL,
#: PAGED_F32_ROW_REL_TOL)
ROW_TOL = {"bfloat16": 2.0 ** -5, "float32": 2.0 ** -12}


# --------------------------------------------------- attention site search
def _attention_site(q_shape, kv_shape, causal):
    B, H, Sq, D = q_shape
    return "attn/b%d/h%d/q%d/kv%d/d%d/causal=%d" % (
        B, H, Sq, kv_shape[2], D, int(causal))


def search_attention(q_shape, kv_shape, dtype, causal, scale=None):
    """K2f at one site: its one configuration (the kernel takes no launch
    parameter) timed and held against the plain version; the entry also
    records the plain version's and ``scaled_dot_product_attention``'s
    times.  Persists and returns the entry."""
    _require_card("search_attention")
    import torch.nn.functional as F
    from .ops import cuda_kernels as _ck
    site = _attention_site(q_shape, kv_shape, causal)
    q = _synth(q_shape, dtype, 0)
    k = _synth(kv_shape, dtype, 1)
    v = _synth(kv_shape, dtype, 2)
    o, _ = _ck.flash_attention(q, k, v, causal=causal, scale=scale)
    po, _ = _ck.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    err = _row_rel_err(o, po)
    tol = ROW_TOL.get(str(dtype), ROW_TOL["float32"])
    entry = {"impl": "flash", "site": site, "causal": bool(causal),
             "candidates": {}, "parity": err <= tol, "row_rel_err": err,
             "tol": tol}
    if err <= tol:
        ms = _measure_ms(lambda: _ck.flash_attention(q, k, v, causal=causal,
                                                     scale=scale))
        entry["candidates"]["flash"] = ms
        entry["best_ms"] = ms
    else:
        entry["reason"] = "the one configuration failed its contract"
    entry["plain_ms"] = _measure_ms(lambda: _ck.flash_attention_plain(
        q, k, v, causal=causal, scale=scale), repeats=1, calls=1)
    entry["library_ms"] = _measure_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=scale))
    entry["library"] = "scaled_dot_product_attention"
    return record("attention", site, dtype, entry)


def attention_pick(q_shape, kv_shape, dtype, causal, scale=None):
    """The pick of one attention site: None (K2f as it is) or the
    recorded entry.  ``measure`` searches a miss on the card."""
    if _absent("attention"):
        return None
    site = _attention_site(tuple(q_shape), tuple(kv_shape), causal)
    pick = lookup("attention", site, str(dtype))
    if pick is None and mode() == "measure" and _card():
        pick = search_attention(tuple(q_shape), tuple(kv_shape), dtype,
                                causal, scale)
    return pick


# ------------------------------------------------- paged-attention search
def _card():
    import torch
    return torch.cuda.is_available()


def _paged_site(bh, kctx, d, quantized):
    return "paged/bh%d/k%d/d%d/quant=%d" % (bh, kctx, d, int(quantized))


def _paged_candidates(bh, kctx, fixed):
    from .ops import cuda_kernels as _ck
    most = -(-kctx // _ck.PAGED_SPLIT_KEYS) * _ck.PAGED_SPLIT_KEYS
    cands = []
    per = _ck.PAGED_SPLIT_KEYS
    while per <= most:
        cands.append(per)
        per *= 2
    if most not in cands:
        cands.append(most)
    if fixed not in cands:
        cands.append(fixed)
    cands = sorted(set(cands))
    while len(cands) > MAX_CANDIDATES:
        # drop the smallest split that is not the fixed rule's
        drop = next(c for c in cands if c != fixed)
        cands.remove(drop)
    return cands


def _paged_inputs(B, H, D, pages, psz, dtype, quantized, seed=1):
    """A decode site's operands: one sequence a row of ``pages`` pages of
    ``psz`` slots through a shuffled page table, ragged lengths (one full,
    one a single key), a pool in ``dtype`` or int8 with f32 scales."""
    import numpy as np
    import torch
    from .quantization import quantize_rows
    rng = np.random.RandomState(seed)
    P = B * pages
    kp = torch.from_numpy(rng.standard_normal((P, psz, H, D))
                          .astype(np.float32)).cuda()
    vp = torch.from_numpy(rng.standard_normal((P, psz, H, D))
                          .astype(np.float32)).cuda()
    q = torch.from_numpy(rng.standard_normal((B, H, 1, D))
                         .astype(np.float32)).cuda().to(getattr(torch,
                                                                str(dtype)))
    table = torch.from_numpy(rng.permutation(P).reshape(B, pages)
                             .astype(np.int32)).cuda()
    lens = rng.randint(1, pages * psz + 1, (B,)).astype(np.int32)
    lens[0] = pages * psz
    if B > 1:
        lens[-1] = 1
    lens = torch.from_numpy(lens).cuda()
    kw = {}
    if quantized:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
        kw = {"k_scale_pool": ks, "v_scale_pool": vs}
    else:
        kp, vp = kp.to(q.dtype), vp.to(q.dtype)
    return q, kp, vp, table, lens, kw


def search_paged(q_shape, kv_shape, dtype, quantized, scale=None,
                 page_size=16):
    """K4's keys per split at one decode site: ``q_shape`` ``(B, H, 1, D)``,
    ``kv_shape`` ``(B, H, K, D)`` with ``K`` the context (pages x
    ``page_size``).  Each candidate (multiples of PAGED_SPLIT_KEYS, the
    fixed rule's among them) is held against the plain version per row
    and timed; the fastest that holds wins.  Persists and returns the
    entry (``keys_per_split``, ``candidates``, ``fixed``, ``plain_ms``,
    ``library_ms``)."""
    _require_card("search_paged")
    import torch
    import torch.nn.functional as F
    from .ops import cuda_kernels as _ck
    B, H, _, D = q_shape
    K = int(kv_shape[2])
    pages = -(-K // page_size)
    kctx = pages * page_size
    site = _paged_site(B * H, kctx, D, quantized)
    q, kp, vp, table, lens, kw = _paged_inputs(B, H, D, pages, page_size,
                                               dtype, quantized)
    plain = _ck.paged_attention_pool_plain(q, kp, vp, table, lens,
                                           scale=scale, **kw)
    tol = ROW_TOL.get(str(dtype), ROW_TOL["float32"])
    if str(dtype) == "float32":
        tol = 2.0 ** -16
        ref = _ck.paged_attention_pool_plain(q, kp, vp.abs(), table, lens,
                                             scale=scale, **kw)
    fixed = _ck.paged_splits(B * H, kctx)[0]
    cands, spreads, errs = {}, {}, {}
    for per in _paged_candidates(B * H, kctx, fixed):
        def call(per=per):
            return _ck.paged_attention_pool(q, kp, vp, table, lens,
                                            scale=scale, keys_per_split=per,
                                            **kw)
        o = call()
        if str(dtype) == "float32":
            err = float(((o - plain).abs().reshape(-1, D).amax(-1)
                         / ref.abs().reshape(-1, D).amax(-1)
                         .clamp_min(1e-30)).max())
        else:
            err = _row_rel_err(o, plain)
        errs[str(per)] = err
        if err > tol:
            continue
        cands[str(per)], spreads[str(per)] = _measure_ms(call, spread=True)
    best = _over_fixed(cands, spreads, fixed)
    entry = {"impl": "paged", "site": site, "quantized": bool(quantized),
             "candidates": cands, "spreads": spreads, "row_rel_err": errs,
             "tol": tol, "fixed": fixed, "fixed_ms": cands.get(str(fixed)),
             "context": kctx, "page_size": page_size}
    if best is not None:
        entry.update(keys_per_split=int(best), best_ms=cands[best],
                     fastest=int(min(cands, key=cands.get)))
    else:
        entry["reason"] = "no candidate met the contract"
    entry["plain_ms"] = _measure_ms(lambda: _ck.paged_attention_pool_plain(
        q, kp, vp, table, lens, scale=scale, **kw), repeats=1, calls=1)
    if not quantized:
        kc = _ck.gather_pages(kp, table)
        vc = _ck.gather_pages(vp, table)
        valid = (torch.arange(kctx, device=q.device)[None, :]
                 < lens[:, None])[:, None, None, :]
        entry["library_ms"] = _measure_ms(
            lambda: F.scaled_dot_product_attention(q, kc, vc,
                                                   attn_mask=valid,
                                                   scale=scale))
        entry["library"] = "scaled_dot_product_attention (gathered, mask)"
    else:
        entry["library_ms"] = None
    return record("paged", site, dtype, entry)


def paged_pick(q_shape, kctx, dtype, quantized):
    """K4's keys per split at a decode site (``q_shape`` ``(B, H, 1, D)``,
    ``kctx`` keys of context), or None for the fixed rule.  ``measure``
    searches a miss on the card."""
    if _absent("paged"):
        return None
    B, H, _, D = q_shape
    site = _paged_site(B * H, int(kctx), D, quantized)
    pick = lookup("paged", site, str(dtype))
    if pick is None and mode() == "measure" and _card():
        pick = search_paged(tuple(q_shape), (B, H, int(kctx), D), dtype,
                            quantized)
    if not pick:
        return None
    return pick.get("keys_per_split")


# -------------------------------------------------- fused-update search
#: the chunks (elements a block) the K1/K3 search tries; the fixed rule,
#: 8192, among them
FUSED_CHUNKS = (2048, 4096, 8192, 16384, 32768, 65536)
_FUSED_SHAPE = ((256, 128),)   # the reference's representative block


def _fused_site(kind, shapes):
    """The site of one tensor list: the kind, the tensor count, the
    elements and a digest of the shapes in order."""
    import zlib
    shapes = [tuple(int(d) for d in sh) for sh in shapes]
    n = sum(math.prod(sh) for sh in shapes)
    digest = zlib.crc32(repr(shapes).encode()) & 0xFFFFFFFF
    return "fused/%s/n%d/e%d/%08x" % (kind, len(shapes), n, digest)


def _fused_kind(optimizer):
    name = type(optimizer).__name__.lower()
    if name == "sgd":
        return "sgd/mom" if getattr(optimizer, "momentum", 0.0) else "sgd"
    if name == "adam":
        return "adam"
    return None


def _fused_tensors(shapes, grad_dtype, out_dtype, kind, seed=0,
                   device="cuda"):
    """Seeded masters, grads, states and casts of ``shapes`` for one fused
    update (drawn on the device)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    gdt = getattr(torch, str(grad_dtype))
    odt = getattr(torch, str(out_dtype)) if out_dtype else None

    def draw(shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale
    ws = [draw(s) for s in shapes]
    gs = [draw(s, 0.1).to(gdt) for s in shapes]
    if kind == "adam":
        st = ([draw(s, 0.01) for s in shapes],
              [draw(s, 0.01).abs() for s in shapes])
    elif kind == "sgd/mom":
        st = ([draw(s, 0.01) for s in shapes],)
    else:
        st = ([None] * len(shapes),)
    outs = [torch.empty(s, dtype=odt, device=device) if odt is not None
            and odt != torch.float32 else None for s in shapes]
    return ws, gs, st, outs


def search_fused(optimizer, shapes=None, grad_dtype="float32",
                 out_dtype="bfloat16"):
    """K1 (SGD) or K3 (Adam) over ``shapes`` (a list of tensor shapes;
    default the reference's one representative block) at each chunk of
    FUSED_CHUNKS: each candidate's update (masters, states, casts) must
    equal the plain version's bit for bit before its time counts.  The
    entry also records the plain version's time and the fused
    ``torch.optim`` step's on the same tensors.  The site is the list's
    (:func:`_fused_site`): the entry's ``chunk`` applies to a list of
    exactly these shapes.  Persists and returns the entry."""
    _require_card("search_fused")
    import torch
    from .ops import cuda_kernels as _ck
    kind = _fused_kind(optimizer)
    if kind is None:
        raise ValueError("mx.autotune: no fused kernel for %s"
                         % type(optimizer).__name__)
    shapes = [tuple(s) for s in (shapes or _FUSED_SHAPE)]
    site = _fused_site(kind, shapes)
    lr, wd = 0.01, 1e-4
    ws, gs, st, outs = _fused_tensors(shapes, grad_dtype, out_dtype, kind)
    n = len(ws)
    lrs, wds = [lr] * n, [wd] * n
    b1, b2, eps = (getattr(optimizer, "beta1", 0.9),
                   getattr(optimizer, "beta2", 0.999),
                   getattr(optimizer, "epsilon", 1e-8))
    mom = float(getattr(optimizer, "momentum", 0.0) or 0.0)

    def clones():
        return ([w.clone() for w in ws],
                [[x.clone() if x is not None else None for x in col]
                 for col in st],
                [o.clone() if o is not None else None for o in outs])

    def run(fn, w, s, o, table=None):
        if kind == "adam":
            return fn(w, gs, s[0], s[1], lrs, wds, b1, b2, eps, outs=o,
                      **({"table": table} if table is not None else {}))
        return fn(w, gs, s[0], lrs, wds, mom, outs=o,
                  **({"table": table} if table is not None else {}))

    kernel = (_ck.fused_adam_step_multi if kind == "adam"
              else _ck.fused_sgd_step_multi)
    plain_fn = (_ck.fused_adam_step_multi_plain if kind == "adam"
                else _ck.fused_sgd_step_multi_plain)
    pw, ps, po = clones()
    run(plain_fn, pw, ps, po)
    want = pw + [x for col in ps for x in col if x is not None] + \
        [x for x in po if x is not None]
    cands, spreads, same = {}, {}, {}
    for chunk in FUSED_CHUNKS:
        table = _ck.LaunchTable(chunk=chunk)
        kw_, ks_, ko_ = clones()
        run(kernel, kw_, ks_, ko_, table)
        got = kw_ + [x for col in ks_ for x in col if x is not None] + \
            [x for x in ko_ if x is not None]
        ok = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                 for a, b in zip(got, want))
        same[str(chunk)] = ok
        if not ok:
            continue
        tw, ts, to = clones()
        cands[str(chunk)], spreads[str(chunk)] = _measure_ms(
            lambda tw=tw, ts=ts, to=to, table=table:
            run(kernel, tw, ts, to, table), spread=True)
    fixed = (_ck.ADAM_LAYOUT if kind == "adam" else _ck.SGD_LAYOUT).chunk
    best = _over_fixed(cands, spreads, fixed)
    entry = {"impl": "fused", "site": site, "kernel": (
        "adam_step" if kind == "adam" else "sgd_step"),
        "tensors": n, "elements": int(sum(w.numel() for w in ws)),
        "candidates": cands, "spreads": spreads, "bitwise": same,
        "fixed": fixed, "fixed_ms": cands.get(str(fixed)),
        "grad_dtype": str(grad_dtype), "out_dtype": str(out_dtype)}
    if best is not None:
        entry.update(chunk=int(best), best_ms=cands[best],
                     fastest=int(min(cands, key=cands.get)))
    else:
        entry["reason"] = "no candidate matched the plain version"
    tw, ts, to = clones()
    entry["plain_ms"] = _measure_ms(lambda: run(plain_fn, tw, ts, to),
                                    repeats=1, calls=1)
    params = [w.clone() for w in ws]
    for p, g in zip(params, gs):
        p.grad = g.float()
    if kind == "adam":
        opt = torch.optim.Adam(params, lr=lr, weight_decay=wd,
                               betas=(b1, b2), eps=eps, fused=True)
    else:
        opt = torch.optim.SGD(params, lr=lr, weight_decay=wd,
                              momentum=mom, fused=True)
    entry["library_ms"] = _measure_ms(opt.step)
    entry["library"] = "torch.optim.%s(fused=True).step" % (
        "Adam" if kind == "adam" else "SGD")
    return record("fused_step", site, "float32", entry)


def fused_step_pick(optimizer, shapes):
    """The measured chunk of ``optimizer``'s fused kernel over a tensor
    list of ``shapes``, or None (the fixed rule).  Never routes away from
    the kernel.  ``measure`` searches a miss on the card over those
    shapes.  ``Optimizer._table_of`` calls it once a list, when it makes
    the list's launch table."""
    if _absent("fused_step"):
        return None
    kind = _fused_kind(optimizer)
    if kind is None:
        return None
    pick = lookup("fused_step", _fused_site(kind, shapes), "float32")
    if pick is None and mode() == "measure" and _card():
        pick = search_fused(optimizer, shapes)
    if not pick or not pick.get("chunk"):
        return None
    return int(pick["chunk"])


# ------------------------------------------------- knob-space step search
def _measure_call_ms(fn, args, repeats=None):
    """Median host-clock ms of ``fn(*args)`` after a warm-up, ending each
    call in a device synchronize when there is a card."""
    import torch
    sync = torch.cuda.synchronize if torch.cuda.is_available() else \
        (lambda: None)
    repeats = repeats or 3
    fn(*args)
    sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    _telemetry.counter("autotune.measure").inc()
    times.sort()
    return times[len(times) // 2]


def search_step(site, make_fn, args, space, family="step", dtype="-"):
    """A measured search over knob assignments for one step: for each
    candidate ``{knob: value}``, set the knobs, build ``make_fn()``, time
    it on ``args``, then put every knob back as it was (override, env or
    default).  Persists the winner with its knob dict."""
    knobs = sorted({k for cand in space for k in cand})
    saved = {k: (_config.source(k), _config.get(k)) for k in knobs}
    results = {}
    best_label, best_ms, best_knobs = None, None, None
    try:
        for cand in space:
            for k in knobs:
                _config.set(k, cand.get(k, saved[k][1]))
            label = "/".join("%s=%s" % (k.split(".")[-1], cand[k])
                             for k in sorted(cand))
            fn = make_fn()
            ms = _measure_call_ms(fn, args)
            results[label] = round(ms, 4)
            if best_ms is None or ms < best_ms:
                best_label, best_ms, best_knobs = label, ms, dict(cand)
    finally:
        for name, (src, val) in saved.items():
            if src == "override":
                _config.set(name, val)
            else:
                _config.unset(name)
    entry = {"impl": best_label, "knobs": best_knobs,
             "best_ms": round(best_ms, 4), "candidates": results,
             "site": site}
    return record(family, site, dtype, entry)


def search_stack(make_fn, args, site="default", dtype="-"):
    """The ``runtime.stack_mode`` x ``runtime.remat`` sweep of one step;
    ``runtime.stack_tuning`` applies the winner while both knobs sit at
    their defaults."""
    from . import runtime as _runtime
    space = [{"runtime.stack_mode": m, "runtime.remat": r}
             for m, r in _runtime.stack_candidates()]
    return search_step(site, make_fn, args, space, family="stack",
                       dtype=dtype)


def stack_pick():
    """The persisted ``(mode, remat)`` winner of the layer stack, or None.
    Consulted only while both runtime knobs sit at their defaults: an
    explicit knob always wins."""
    if _absent("stack"):
        return None
    if (_config.source("runtime.stack_mode") != "default"
            or _config.source("runtime.remat") != "default"):
        return None
    pick = lookup("stack", "default", "-")
    if not pick:
        return None
    knobs = pick.get("knobs") or {}
    m = knobs.get("runtime.stack_mode")
    r = knobs.get("runtime.remat")
    if m not in ("scan", "unroll") or r not in ("", "dots", "full"):
        return None
    return m, r
