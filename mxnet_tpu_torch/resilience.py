"""``mx.resilience`` — fault-tolerant training (counterpart of
``mxnet_tpu.resilience``).

* **Atomic checkpoints** — ``atomic_write`` (the one writer of the
  package) publishes through a same-directory temp file,
  fsync, ``os.replace`` and a directory fsync, with the ``ckpt_write``
  fault drawn after the content is written and before anything is
  published; ``write_manifest`` / ``verify_checkpoint`` add the
  reference's CRC32 + size + schema sidecar (``<file>.manifest.json``),
  so either package verifies the other's files.
* **CheckpointManager** — ``maybe_save`` every N steps, retention of the
  newest K, ``latest()``, and ``restore`` that falls back past a corrupt
  newest file (``resilience.ckpt_saves`` / ``ckpt_fallbacks``).
* **Preemption** — ``resilience.on_preempt=save_and_exit`` installs
  SIGTERM/SIGINT handlers that only set a flag; the training loops
  (``SPMDTrainer.step``, ``gluon.Trainer.step``, ``Module.fit``) finish
  the step in flight, checkpoint, flush and exit 0 (``exit_on_preempt``).
  ``request_preempt`` raises the same flag from code (``mx.elastic``'s
  cluster agreement).
* **Non-finite step guard** — ``resilience.nanguard=skip|abort``.  The
  fused steps (``SPMDTrainer``, the Module's ``Executor`` step) reduce
  the loss and every gradient to one int32 *skip word* on the card
  (``skip_word``: one multi-tensor pass of
  ``torch._amp_foreach_non_finite_check_and_unscale_`` at scale 1.0,
  which leaves every finite value as it was).  The fused optimizer
  kernels K1 (``csrc/sgd_step.cu``) and K3 (``csrc/adam_step.cu``) read
  the word and return before their first store when it is set, and the
  step's other in-place writes (BatchNorm statistics, the unfused
  optimizer route, the row-sparse tables, the 2-bit residuals) select
  the old value with ``torch.where``: a bad step changes nothing, with no
  host read and no copy of the old state.  The consecutive-bad-step
  streak stays on the card; ``watch_streak`` records a CUDA event after
  each step and a non-blocking copy of the streak to pinned memory, and
  reads only the entries whose event has completed (it blocks only past
  64 pending entries).  After ``nanguard_patience`` bad steps (1 under
  ``abort``) the next step's ``maybe_abort_nonfinite`` checkpoints the
  last good state, flushes and raises ``NonFiniteStepError``.  The
  eager loops (``gluon.Trainer``, the Module's eager route) check on the
  host, one sync a step, as the reference's do.
* **Retry and fault injection** — ``call_with_retry`` / ``retry``
  (exponential backoff with seeded jitter; ``resilience.retries[.kind]``)
  wrap the batch fetch (``io``), kvstore push/pull (``kvstore``), the
  dist kvstore's hops (``dcn_push``) and checkpoint writes
  (``ckpt_write``).  ``MXNET_TPU_FAULTS`` (``kind:P`` with probability P
  at each opportunity, ``kind:N@step=M`` on N opportunities from the
  M-th) drives every path: ``nan`` poisons a training batch
  (``poison_batch``), ``peer_preempt`` is ``mx.elastic``'s, and
  ``serving_dispatch`` / ``serving_slow`` the one-shot server's.

The abort runs the reference's steps in its order: the numerics
forensics replay of the failing batch (``numerics.run_forensics``: the
first non-finite site), the watchdog flight-recorder dump
(``tracing.dump_watchdog_report``, whose ring then holds the forensics
event), the checkpoint, and ``flush_sinks`` (the telemetry and tracing
sinks, then the standard streams); ``NonFiniteStepError`` names the
report.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import random as _pyrandom
import re
import signal
import sys
import tempfile
import threading
import time
import zlib
from collections import namedtuple

from .base import MXNetError
from . import telemetry as _telemetry

__all__ = [
    "CheckpointCorruptError", "NonFiniteStepError", "InjectedFault",
    "atomic_write", "write_manifest", "verify_checkpoint", "manifest_path",
    "CheckpointManager", "CKPT_SCHEMA", "MANIFEST_SCHEMA",
    "configure_preemption", "preempt_requested", "request_preempt",
    "clear_preempt", "exit_on_preempt", "flush_sinks",
    "nanguard_mode", "all_finite", "skip_word", "guarded_streak",
    "select_tree", "watch_streak", "poll_streaks",
    "report_nonfinite", "note_finite", "maybe_abort_nonfinite",
    "nonfinite_stats", "reset_nanguard",
    "call_with_retry", "retry", "configure_retry",
    "configure_faults", "parse_faults", "should_inject", "inject",
    "faults_active", "poison_batch", "FaultRule",
]

#: schema version stamped into SPMDTrainer single-file checkpoints (the
#: reference's); a loader refuses a file of a newer schema
CKPT_SCHEMA = 1
#: schema version of the manifest sidecar (the reference's)
MANIFEST_SCHEMA = 1


class CheckpointCorruptError(MXNetError):
    """A checkpoint file is missing, truncated, fails its CRC, is not a
    checkpoint, or is of a newer schema.  ``CheckpointManager.restore``
    falls back past it."""


class NonFiniteStepError(MXNetError):
    """Raised by the nanguard's abort path after K consecutive
    non-finite steps, once the last good state is checkpointed (when a
    manager is attached)."""


class InjectedFault(OSError):
    """A deterministic fault from the ``MXNET_TPU_FAULTS`` harness.  An
    OSError, so the retry machinery treats it as the transient failure it
    simulates."""


def _log(msg, *args):
    sys.stderr.write("[mxnet_tpu_torch.resilience] " + (msg % args) + "\n")


# ========================================================= atomic write
@contextlib.contextmanager
def atomic_write(path, mode="wb"):
    """Write ``path`` atomically: the bytes go to a temporary file in the
    same directory, are flushed and fsynced, and only then renamed over
    ``path``, with a directory fsync making the rename durable.  The
    ``ckpt_write`` fault is drawn after the content is written and before
    anything is published.  A crash or a
    fault at any point leaves the previous file whole and no temp file
    behind."""
    if mode not in ("wb", "w"):
        raise ValueError("atomic_write takes mode 'wb' or 'w', got %r"
                         % (mode,))
    path = os.fspath(path)
    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.",
                               dir=dirname)
    try:
        with os.fdopen(fd, mode) as f:
            yield f
            inject("ckpt_write")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    try:
        dfd = os.open(dirname, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # a file system without directory fsync
        pass


# ============================================================ manifests
def manifest_path(path):
    return os.fspath(path) + ".manifest.json"


def _crc32_file(path):
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc & 0xFFFFFFFF, size


def write_manifest(path, step=None, world=None):
    """Write the sidecar ``<path>.manifest.json`` (CRC32, size, schema,
    and the optional ``step`` and ``world`` stamp, e.g.
    ``{"process_count": 2, "mesh": {"dp": 2}}``) of an already published
    checkpoint file; returns the manifest."""
    crc, size = _crc32_file(path)
    man = {"schema": MANIFEST_SCHEMA, "file": os.path.basename(path),
           "size": size, "crc32": crc, "ts": round(time.time(), 3)}
    if step is not None:
        man["step"] = int(step)
    if world is not None:
        man["world"] = dict(world)
    with atomic_write(manifest_path(path), "w") as f:
        json.dump(man, f)
    return man


def verify_checkpoint(path, require_manifest=False):
    """Check ``path`` against its sidecar; returns the manifest, or None
    when there is none and ``require_manifest`` is False.  Raises
    CheckpointCorruptError on a missing file, a size or CRC mismatch, an
    unreadable manifest or one of a newer schema."""
    path = os.fspath(path)
    if not os.path.exists(path):
        raise CheckpointCorruptError("checkpoint missing: %s" % path)
    mp = manifest_path(path)
    if not os.path.exists(mp):
        if require_manifest:
            raise CheckpointCorruptError(
                "checkpoint %s has no manifest sidecar" % path)
        return None
    try:
        with open(mp) as f:
            man = json.load(f)
    except (OSError, ValueError) as exc:
        raise CheckpointCorruptError(
            "unreadable manifest %s (%s)" % (mp, exc)) from exc
    if not isinstance(man, dict) or "crc32" not in man or "size" not in man:
        raise CheckpointCorruptError("malformed manifest %s" % mp)
    if int(man.get("schema", 0)) > MANIFEST_SCHEMA:
        raise CheckpointCorruptError(
            "manifest %s written by a newer schema (%s > %s)"
            % (mp, man.get("schema"), MANIFEST_SCHEMA))
    crc, size = _crc32_file(path)
    if size != int(man["size"]) or crc != int(man["crc32"]):
        raise CheckpointCorruptError(
            "checkpoint %s fails its integrity check (size %d vs %s, crc %d "
            "vs %s): truncated or corrupt" % (path, size, man["size"], crc,
                                              man["crc32"]))
    return man


# ======================================================= CheckpointManager
class CheckpointManager:
    """Periodic, retained, verified checkpoints in one directory.

    ``saver`` / ``loader`` take a path (``trainer.save_checkpoint`` /
    ``trainer.load_checkpoint``)::

        mgr = CheckpointManager(dir, every_n_steps=100, keep=3)
        resumed = trainer.attach_checkpoint_manager(mgr)  # None: cold
        ...

    ``restore`` walks from the newest checkpoint down, skipping any whose
    manifest or content fails (CheckpointCorruptError)."""

    def __init__(self, directory, every_n_steps=None, keep=None,
                 prefix="ckpt"):
        from . import config
        self.directory = os.path.abspath(os.fspath(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.every_n_steps = int(
            config.get("resilience.ckpt_every_n_steps")
            if every_n_steps is None else every_n_steps)
        self.keep = int(config.get("resilience.ckpt_keep")
                        if keep is None else keep)
        self.prefix = prefix
        self._pat = re.compile(r"^%s-(\d+)\.ckpt$" % re.escape(prefix))

    def path_for(self, step):
        return os.path.join(self.directory,
                            "%s-%08d.ckpt" % (self.prefix, int(step)))

    def checkpoints(self):
        """``[(step, path)]``, ascending."""
        out = []
        for fname in os.listdir(self.directory):
            m = self._pat.match(fname)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, fname)))
        return sorted(out)

    def latest(self):
        """``(step, path)`` of the newest checkpoint that verifies, or
        None."""
        for step, path in reversed(self.checkpoints()):
            try:
                verify_checkpoint(path)
            except CheckpointCorruptError:
                continue
            return step, path
        return None

    def save(self, step, saver):
        """``saver(path_for(step))`` and its manifest, retried as
        checkpoint I/O; then prunes past the retention bound."""
        path = self.path_for(step)

        def write():
            saver(path)
            write_manifest(path, step=step)

        call_with_retry(write, kind="ckpt_write")
        _telemetry.counter("resilience.ckpt_saves").inc()
        self._prune()
        return path

    def due(self, step):
        """Whether ``step`` lands on the every-N cadence (0: never)."""
        n = self.every_n_steps
        return n > 0 and step > 0 and step % n == 0

    def maybe_save(self, step, saver):
        """:meth:`save` when :meth:`due`; the path or None."""
        return self.save(step, saver) if self.due(step) else None

    def restore(self, loader):
        """Load the newest good checkpoint, falling back past corrupt
        ones; the restored step, or None when nothing loaded."""
        for step, path in reversed(self.checkpoints()):
            try:
                verify_checkpoint(path)
                loader(path)
            except CheckpointCorruptError as exc:
                _telemetry.counter("resilience.ckpt_fallbacks").inc()
                _log("checkpoint %s unusable (%s); falling back", path, exc)
                continue
            return step
        return None

    def _prune(self):
        cks = self.checkpoints()
        if self.keep <= 0 or len(cks) <= self.keep:
            return
        for _, path in cks[:-self.keep]:
            for victim in (path, manifest_path(path)):
                try:
                    os.unlink(victim)
                except OSError:
                    pass


# ============================================================ preemption
_PREEMPT = {"signum": None, "mode": "", "installed": False, "prev": {}}


def configure_preemption(mode=None):
    """(Un)install the SIGTERM/SIGINT handlers: ``''`` (off) or
    ``'save_and_exit'``; None reads the ``resilience.on_preempt`` knob,
    whose hook calls this.  Turning it off forgets a pending request."""
    from . import config
    if mode is None:
        mode = config.get("resilience.on_preempt")
    mode = (mode or "").strip()
    if mode not in ("", "save_and_exit"):
        raise ValueError("resilience.on_preempt must be '' or "
                         "'save_and_exit', got %r" % (mode,))
    _PREEMPT["mode"] = mode
    want = bool(mode)
    if want == _PREEMPT["installed"]:
        return
    if threading.current_thread() is not threading.main_thread():
        _log("preemption handlers need the main thread; not installed")
        return
    if want:
        for sig in (signal.SIGTERM, signal.SIGINT):
            _PREEMPT["prev"][sig] = signal.signal(sig, _on_preempt_signal)
        _PREEMPT["installed"] = True
    else:
        for sig, prev in _PREEMPT["prev"].items():
            signal.signal(sig, prev)
        _PREEMPT["prev"].clear()
        _PREEMPT["installed"] = False
        _PREEMPT["signum"] = None


def _on_preempt_signal(signum, frame):
    if _PREEMPT["signum"] is not None:
        # a second signal: stop waiting for the step in flight
        if signum == signal.SIGINT:
            raise KeyboardInterrupt
        raise SystemExit(128 + signum)
    _PREEMPT["signum"] = signum
    _telemetry.counter("resilience.preemptions").inc()
    _log("received signal %d: will checkpoint and exit after the step in "
         "flight", signum)


def preempt_requested():
    """Has a preemption been requested (a signal, or
    :func:`request_preempt`)?"""
    return _PREEMPT["signum"] is not None


def request_preempt(signum=signal.SIGTERM):
    """Request a preemption from code, as a SIGTERM would (``mx.elastic``
    when a peer was preempted, and the ``peer_preempt`` fault)."""
    if _PREEMPT["signum"] is None:
        _PREEMPT["signum"] = int(signum)
        _telemetry.counter("resilience.preemptions").inc()


def clear_preempt():
    """Forget a pending request."""
    _PREEMPT["signum"] = None


def exit_on_preempt(save_fn=None, logger=None):
    """Finish a preemption: ``save_fn()`` (the caller's checkpoint),
    flush, and ``SystemExit(0)``.  Returns False when none is pending."""
    if not preempt_requested():
        return False
    if save_fn is not None:
        try:
            save_fn()
        except Exception as exc:  # noqa: BLE001 — exit anyway, but loudly
            _log("preemption checkpoint failed: %s: %s",
                 type(exc).__name__, exc)
    flush_sinks()
    msg = ("preemption (signal %s): checkpoint written, exiting cleanly"
           % _PREEMPT["signum"])
    if logger is not None:
        logger.info(msg)
    else:
        _log("%s", msg)
    raise SystemExit(0)


def flush_sinks():
    """Flush what a preempted or aborting process must not lose: the
    telemetry JSONL and tracing Chrome sinks (to disk, fsync), then the
    standard streams."""
    from . import telemetry, tracing
    for mod in (telemetry, tracing):
        try:
            mod.flush()
        except Exception:  # noqa: BLE001 — flushing is best-effort
            pass
    for stream in (sys.stdout, sys.stderr):
        try:
            stream.flush()
        except (OSError, ValueError):
            pass


# ======================================================= non-finite guard
_NAN_LOCK = threading.Lock()
_NAN_STATE = {}   # source -> {"streak": int, "total": int}
_NAN_ABORT = {}   # source -> streak that crossed the threshold


def nanguard_mode():
    """``''`` (off), ``'skip'`` or ``'abort'``, from the
    ``resilience.nanguard`` knob."""
    from . import config
    mode = str(config.get("resilience.nanguard")).strip().lower()
    if mode in ("", "off", "0", "false"):
        return ""
    if mode not in ("skip", "abort"):
        raise ValueError("MXNET_TPU_NANGUARD must be skip or abort, got %r"
                         % mode)
    return mode


def _nan_threshold(mode):
    if mode == "abort":
        return 1
    from . import config
    return max(1, int(config.get("resilience.nanguard_patience")))


def _leaves(tree):
    """The tensors of a tree of dicts, lists, tuples, NDArrays and
    tensors."""
    import torch
    if tree is None:
        return []
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    data = getattr(tree, "_data", tree)
    return [data] if isinstance(data, torch.Tensor) else []


_ONES = {}  # device -> the 1.0 scale the finite check multiplies by
# the dtypes the fused multi-tensor check takes on every device (CUDA's
# has no bf16)
_AMP_DTYPES = ("float16", "float32", "float64")


def skip_word(*trees):
    """The skip word of the floating tensors of ``trees``: a 0-d int32
    tensor on their device, 1 when any value is NaN or infinite, else 0.
    One pass of ``torch._amp_foreach_non_finite_check_and_unscale_`` over
    each f16/f32/f64 group at scale 1.0, which leaves every finite value's
    bits as they were; a bf16 tensor takes ``isfinite`` and ``all``.  No
    host sync."""
    import torch
    groups = {}
    for t in _leaves(trees):
        if t.is_floating_point() and t.numel():
            groups.setdefault((t.device, t.dtype), []).append(t.detach())
    if not groups:
        return torch.zeros((), dtype=torch.int32)
    devices = {d for d, _ in groups}
    if len(devices) != 1:
        raise ValueError("skip_word: tensors on several devices %s"
                         % sorted(map(str, devices)))
    dev = devices.pop()
    one = _ONES.get(dev)
    if one is None:
        one = _ONES[dev] = torch.ones(1, dtype=torch.float32, device=dev)
    found = torch.zeros(1, dtype=torch.float32, device=dev)
    for (_, dtype), ts in groups.items():
        if str(dtype).split(".")[-1] in _AMP_DTYPES:
            torch._amp_foreach_non_finite_check_and_unscale_(ts, found, one)
        else:
            for t in ts:
                found.add_(torch.isfinite(t).all().logical_not())
    return (found != 0).to(torch.int32).reshape(())


def all_finite(*trees):
    """0-d bool tensor: are all floating values of ``trees`` finite?
    (On their device, no host sync.)"""
    return skip_word(*trees) == 0


def guarded_streak(finite, streak, source=None):
    """The consecutive-bad-step streak after a step: 0 when ``finite`` (a
    0-d bool tensor), else ``streak + 1`` (int32 on the card, no host
    sync).  ``source`` is accepted for the reference's signature."""
    import torch
    return torch.where(finite, torch.zeros_like(streak), streak + 1)


def select_tree(finite, new, old):
    """``new`` where the step was finite, ``old`` otherwise, leaf by leaf
    (``finite`` a 0-d bool tensor): the on-card skip for updates written
    out of place."""
    import torch
    if new is None:
        return None
    if isinstance(new, dict):
        return {k: select_tree(finite, v, old[k]) for k, v in new.items()}
    if isinstance(new, (list, tuple)):
        return type(new)(select_tree(finite, n, o) for n, o in zip(new, old))
    return torch.where(finite, new, old)


# each source's streak observations not read yet: (event, pinned copy)
_STREAK_PENDING = {}
_STREAK_PENDING_MAX = 64
_STREAK_DRAIN_LOCK = threading.Lock()
# sources read at a fixed lag: how many newest entries stay unread
_STREAK_LAG = {}


def watch_streak(source, streak, lag=0):
    """Queue a guarded step's streak (the 0-d int32 tensor it returned)
    for the host: a CUDA event recorded after the step and a non-blocking
    copy to pinned memory, read once the event has completed.  Drains the
    completed entries; blocks only past 64 pending ones.

    ``lag > 0`` reads at a fixed lag instead: every entry but the newest
    ``lag`` is read, waiting for it if need be, and none of those is read
    early.  Ranks that step together then see a crossing at the same step,
    whatever their timing on the card (the multi-rank trainer's abort
    runs collectives)."""
    import torch
    if streak.is_cuda:
        host = torch.empty((), dtype=streak.dtype, pin_memory=True)
        host.copy_(streak, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(streak.device))
    else:
        host, event = streak.detach().clone(), None
    q = _STREAK_PENDING.setdefault(source, [])
    q.append((event, host))
    if lag:
        _STREAK_LAG[source] = int(lag)
    else:
        _STREAK_LAG.pop(source, None)
    poll_streaks(source, block=len(q) > _STREAK_PENDING_MAX)


def poll_streaks(source=None, block=False):
    """Read the pending streak observations of ``source`` (every source by
    default) whose step has completed on the card, in step order; with
    ``block`` wait for the rest too.  A positive streak is reported
    (:func:`report_nonfinite`), a zero one resets the host's count.  A
    source watched at a lag is read, blocking, down to its ``lag`` newest
    entries unless ``block``."""
    sources = [source] if source is not None else list(_STREAK_PENDING)
    for src in sources:
        q = _STREAK_PENDING.get(src)
        keep = 0 if block else _STREAK_LAG.get(src, 0)
        while q and len(q) > keep:
            with _STREAK_DRAIN_LOCK:
                if len(q) <= keep:
                    break
                event, host = q[0]
                if event is not None:
                    if block or keep:
                        event.synchronize()
                    elif not event.query():
                        break
                v = int(host)
                q.pop(0)
            if v > 0:
                report_nonfinite(src, streak=v)
            else:
                note_finite(src)


def report_nonfinite(source, streak=None):
    """Record one non-finite step of ``source``: bump
    ``<source>.nonfinite_steps`` and arm the abort once the streak
    reaches the mode's threshold.  The eager loops pass no ``streak`` and
    it is counted here."""
    with _NAN_LOCK:
        st = _NAN_STATE.setdefault(source, {"streak": 0, "total": 0})
        st["streak"] = int(streak) if streak is not None \
            else st["streak"] + 1
        st["total"] += 1
        cur = st["streak"]
    _telemetry.counter("%s.nonfinite_steps" % source).inc()
    mode = nanguard_mode()
    if mode and cur >= _nan_threshold(mode):
        _NAN_ABORT[source] = cur
    _log("non-finite step on %s (consecutive: %d)", source, cur)


def note_finite(source):
    """Reset the host's streak of ``source`` after a finite step."""
    st = _NAN_STATE.get(source)
    if st is not None and st["streak"]:
        with _NAN_LOCK:
            st["streak"] = 0


def nonfinite_stats(source=None):
    with _NAN_LOCK:
        if source is not None:
            return dict(_NAN_STATE.get(source, {"streak": 0, "total": 0}))
        return {k: dict(v) for k, v in _NAN_STATE.items()}


def reset_nanguard():
    with _NAN_LOCK:
        _NAN_STATE.clear()
        _NAN_ABORT.clear()
    _STREAK_PENDING.clear()
    _STREAK_LAG.clear()


def maybe_abort_nonfinite(source, save_fn=None):
    """Checked once a step by the training loops: drains the completed
    streak observations (no sync) and, when ``source`` has crossed its
    threshold, runs the numerics forensics replay, dumps the watchdog's
    flight-recorder report, checkpoints through ``save_fn``, flushes and
    raises NonFiniteStepError.  The device reports asynchronously, so the abort
    lands within a step or two of the crossing."""
    if _STREAK_PENDING.get(source):
        poll_streaks(source)
    if source not in _NAN_ABORT:
        return
    streak = _NAN_ABORT.pop(source)
    try:
        # the root-cause pass first, so the nanguard_forensics ring event
        # (the first non-finite site) lands in the flight-recorder report
        from . import numerics as _numerics
        _numerics.run_forensics(source)
    except Exception as exc:  # noqa: BLE001 — forensics must not mask abort
        _log("nanguard forensics failed: %s: %s", type(exc).__name__, exc)
    report = None
    try:
        from . import tracing
        report = tracing.dump_watchdog_report()
    except Exception as exc:  # noqa: BLE001 — the abort must not be lost
        _log("flight-recorder dump failed: %s: %s", type(exc).__name__, exc)
    if save_fn is not None:
        try:
            save_fn()
        except Exception as exc:  # noqa: BLE001 — the abort must not be lost
            _log("abort checkpoint failed: %s: %s", type(exc).__name__, exc)
    flush_sinks()
    raise NonFiniteStepError(
        "%d consecutive non-finite steps on %s (nanguard=%s): the "
        "parameters were not updated by the bad steps%s"
        % (streak, source, nanguard_mode() or "abort",
           "; flight recorder: %s" % report if report else ""))


# ================================================ retry / backoff / jitter
_RETRY = {"attempts": 3, "base_s": 0.05, "factor": 2.0, "max_s": 2.0,
          "jitter": 0.5, "rng": _pyrandom.Random(0)}


def configure_retry(attempts=None, base_s=None, seed=None):
    """Refresh the retry policy from the ``resilience.retry_attempts``,
    ``resilience.retry_base_s`` and ``resilience.fault_seed`` knobs (or
    the explicit arguments)."""
    from . import config
    _RETRY["attempts"] = max(1, int(
        config.get("resilience.retry_attempts")
        if attempts is None else attempts))
    _RETRY["base_s"] = float(config.get("resilience.retry_base_s")
                             if base_s is None else base_s)
    _RETRY["rng"] = _pyrandom.Random(
        config.get("resilience.fault_seed") if seed is None else seed)


def call_with_retry(fn, *args, kind="io", inject_faults=False, **kwargs):
    """``fn(*args, **kwargs)``, retried with exponential backoff and
    seeded jitter on ``OSError`` (InjectedFault included);
    ``StopIteration`` and other exceptions pass straight through.
    ``inject_faults=True`` draws a ``kind`` fault before each attempt,
    before the body runs.  Each retry bumps ``resilience.retries`` and
    ``resilience.retries.<kind>``."""
    attempts = _RETRY["attempts"]
    delay = _RETRY["base_s"]
    for attempt in range(1, attempts + 1):
        try:
            if inject_faults and _FAULTS:
                inject(kind)
            return fn(*args, **kwargs)
        except OSError as exc:
            if attempt >= attempts:
                raise
            _telemetry.counter("resilience.retries").inc()
            _telemetry.counter("resilience.retries.%s" % kind).inc()
            sleep = min(_RETRY["max_s"],
                        delay * (1.0 + _RETRY["jitter"]
                                 * _RETRY["rng"].random()))
            _log("%s failed (%s: %s); retry %d/%d in %.3fs", kind,
                 type(exc).__name__, exc, attempt, attempts - 1, sleep)
            time.sleep(sleep)
            delay *= _RETRY["factor"]


def retry(kind="io", inject_faults=False):
    """Decorator form of :func:`call_with_retry`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return call_with_retry(fn, *args, kind=kind,
                                   inject_faults=inject_faults, **kwargs)
        return wrapper
    return deco


# ----------------------------------------------------------- fault harness
FaultRule = namedtuple("FaultRule", ["kind", "prob", "count", "at_step"])

_FAULTS = {}       # kind -> FaultRule; empty == harness off
_FAULT_RNGS = {}   # kind -> seeded random.Random (probability rules)
_FAULT_CALLS = {}  # kind -> opportunity counter


def parse_faults(spec):
    """Parse a fault spec: comma-separated ``kind:P`` (probability P in
    [0, 1] at each opportunity) or ``kind:N@step=M`` (exactly N
    opportunities from the M-th, 1-based; a caller that passes ``step``,
    as the trainers do for ``nan``, counts in training steps)."""
    rules = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        if ":" not in entry:
            raise ValueError("fault entry %r is not kind:rule" % entry)
        kind, rule = entry.split(":", 1)
        kind = kind.strip()
        if "@" in rule:
            count_s, cond = rule.split("@", 1)
            if not cond.startswith("step="):
                raise ValueError("fault entry %r: expected @step=N" % entry)
            rules[kind] = FaultRule(kind, None, int(count_s),
                                    int(cond[len("step="):]))
        else:
            p = float(rule)
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    "fault entry %r: probability out of [0,1]" % entry)
            rules[kind] = FaultRule(kind, p, None, None)
    return rules


def configure_faults(spec=None, seed=None):
    """(Re)arm the harness from the ``resilience.faults`` /
    ``resilience.fault_seed`` knobs (or the arguments).  Resets every
    kind's RNG and opportunity counter, so two runs configured alike
    inject the same faults."""
    from . import config
    if spec is None:
        spec = config.get("resilience.faults")
    if seed is None:
        seed = int(config.get("resilience.fault_seed"))
    rules = parse_faults(spec)
    _FAULTS.clear()
    _FAULT_RNGS.clear()
    _FAULT_CALLS.clear()
    _FAULTS.update(rules)
    for kind in rules:
        _FAULT_RNGS[kind] = _pyrandom.Random(
            seed ^ zlib.crc32(kind.encode()))
    configure_retry(seed=seed)


def faults_active(kind=None):
    if kind is None:
        return bool(_FAULTS)
    return kind in _FAULTS


def should_inject(kind, step=None):
    """One injection draw for ``kind`` (advances its state); ``step``
    replaces the opportunity counter of an ``@step`` rule."""
    rule = _FAULTS.get(kind)
    if rule is None:
        return False
    _FAULT_CALLS[kind] = _FAULT_CALLS.get(kind, 0) + 1
    if rule.at_step is not None:
        n = step if step is not None else _FAULT_CALLS[kind]
        hit = rule.at_step <= n < rule.at_step + rule.count
    else:
        hit = _FAULT_RNGS[kind].random() < rule.prob
    if hit:
        _telemetry.counter("resilience.injected.%s" % kind).inc()
    return hit


def inject(kind, step=None):
    """Raise InjectedFault when this opportunity draws a ``kind`` fault;
    a no-op while the harness is off or the draw misses."""
    if _FAULTS and should_inject(kind, step=step):
        raise InjectedFault("injected %s fault (MXNET_TPU_FAULTS)" % kind)


def poison_batch(data):
    """The ``nan`` fault: a float batch (tensor, NDArray or numpy array)
    times NaN, of the same kind, so the loss and every gradient go
    non-finite; an integer batch (token ids) passes through untouched."""
    import numpy as np
    import torch
    t = getattr(data, "_data", data)
    if isinstance(t, torch.Tensor):
        if not t.is_floating_point():
            _log("nan fault on a %s batch: skipped", t.dtype)
            return data
        out = t * float("nan")
        if t is data:
            return out
        from .ndarray.ndarray import _wrap
        return _wrap(out)
    arr = np.asarray(data)
    if not np.issubdtype(arr.dtype, np.inexact):
        _log("nan fault on a %s batch: skipped", arr.dtype)
        return data
    return arr * np.nan


# the knobs' environment variables arm the harness and the handlers at
# import
configure_faults()
from . import config as _config  # noqa: E402
if _config.get("resilience.on_preempt"):
    configure_preemption()
