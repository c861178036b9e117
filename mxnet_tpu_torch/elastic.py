"""``mx.elastic`` — preemption-tolerant multi-process training
(counterpart of ``mxnet_tpu.elastic``).

Every process is a worker holding its share of the world, so elasticity
is a protocol over the ``torch.distributed`` group:

* **Heartbeat leases** — each rank renews a lease file in the elastic
  state directory (``elastic.dir``, ``MXTPU_ELASTIC_DIR``, exported by
  ``python -m mxnet_tpu_torch.launch --elastic``); a peer whose lease is
  older than 5 heartbeat intervals is lost.  By default the rank then
  exits with ``ABORT_EXIT_CODE`` (75) so the launcher re-forms the
  world: a rank blocked in a collective on a dead peer has no other way
  out.
* **Cluster preemption agreement** — a SIGTERM on any rank (or the
  ``peer_preempt`` fault) must make every rank finish the step in
  flight, write one coordinated checkpoint and exit 0 at the same step.
  Each step every rank adds its local flag in one host all-reduce
  (``parallel.host_allreduce``); a non-zero sum preempts every rank.
* **Coordinated checkpoints** — rank 0 writes, every rank waits at a
  barrier across the write, the manifest carries the world's stamp
  (``process_count`` and the mesh), and ``restore`` refuses a snapshot
  without it and checks that every rank resumed the same step.

Inactive (no ``elastic.dir``) all of it is a no-op.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

from . import config as _config
from . import resilience as _resilience
from . import telemetry as _telemetry

__all__ = ["ABORT_EXIT_CODE", "active", "state_dir", "generation",
           "announce_preempt", "preempt_announced", "clear_flags",
           "cluster_preempt_requested", "maybe_cluster_preempt",
           "HeartbeatMonitor", "ensure_heartbeat", "stop_heartbeat",
           "CoordinatedCheckpointManager", "coordinate"]

#: the exit code the elastic launcher reads as "the world broke: re-form
#: it", apart from 0 (done, or preempted with a checkpoint) and failures
ABORT_EXIT_CODE = 75


def _log(msg, *args):
    sys.stderr.write("[mxnet_tpu_torch.elastic] " + (msg % args) + "\n")


def active():
    """Whether this process is part of an elastic run (``elastic.dir``
    is set)."""
    return bool(_config.get("elastic.dir"))


def state_dir():
    """The elastic state directory (created on first use)."""
    d = _config.get("elastic.dir")
    if not d:
        raise ValueError("elastic.dir is not set (start the workers with "
                         "`python -m mxnet_tpu_torch.launch --elastic` or "
                         "export MXTPU_ELASTIC_DIR)")
    os.makedirs(d, exist_ok=True)
    return d


def generation():
    """The restart generation of this elastic run (0: the first
    launch)."""
    return int(_config.get("elastic.generation"))


def _rank_world():
    from .parallel import dist
    return dist.rank(), dist.world_size()


# ======================================================= preemption flags
def _flag_path(rank):
    return os.path.join(state_dir(), "preempt-r%d" % int(rank))


def announce_preempt(step=None):
    """Drop this rank's preemption flag: the launcher restarts a
    generation that ends with one.  Idempotent; returns its path."""
    rank, _ = _rank_world()
    path = _flag_path(rank)
    if os.path.exists(path):
        return path
    payload = {"rank": rank, "generation": generation(),
               "ts": round(time.time(), 3)}
    if step is not None:
        payload["step"] = int(step)
    with _resilience.atomic_write(path, "w") as f:
        json.dump(payload, f)
    _telemetry.counter("elastic.preempt_announced").inc()
    return path


def preempt_announced():
    """Whether any rank has dropped a preemption flag."""
    d = _config.get("elastic.dir")
    if not d or not os.path.isdir(d):
        return False
    return any(name.startswith("preempt-r") for name in os.listdir(d))


def clear_flags(directory=None):
    """Remove the preemption flags (the launcher does it between
    generations)."""
    d = directory or _config.get("elastic.dir")
    if not d or not os.path.isdir(d):
        return
    for name in os.listdir(d):
        if name.startswith("preempt-r"):
            try:
                os.unlink(os.path.join(d, name))
            except OSError:
                pass


# ================================================== cluster preempt agree
def cluster_preempt_requested(step=None):
    """One round of the per-step agreement: each rank adds its local flag
    (a delivered signal, or a ``peer_preempt`` fault drawn at ``step``)
    in one host all-reduce, and a non-zero sum raises the preemption
    request on every rank.  Returns whether the world preempts."""
    import numpy as np
    local = _resilience.preempt_requested()
    if not local and _resilience.faults_active("peer_preempt"):
        if _resilience.should_inject("peer_preempt", step=step):
            _log("injected peer_preempt at step %s", step)
            _resilience.request_preempt()
            local = True
    _, world = _rank_world()
    if world > 1:
        from .parallel import host_allreduce
        total = int(host_allreduce(np.int32(bool(local))))
    else:
        total = int(bool(local))
    if total and not local:
        # a peer was preempted: this rank checkpoints and exits with it
        _resilience.request_preempt()
    return bool(total)


def maybe_cluster_preempt(step=None):
    """The training loops' per-step hook: a no-op unless elastic is
    active; else keep the heartbeat alive and run the agreement, dropping
    this rank's flag when the world preempts.  Returns True when the
    caller should checkpoint and exit (``resilience.exit_on_preempt``)."""
    if not active():
        return False
    ensure_heartbeat()
    if cluster_preempt_requested(step=step):
        announce_preempt(step=step)
        return True
    return False


# ======================================================== heartbeat/lease
class HeartbeatMonitor:
    """This rank's lease writer and its peers' lease watcher.

    Every ``interval_s`` a thread renews ``hb-r<rank>`` in ``directory``
    and reads the peers' leases; a peer it has seen whose lease is older
    than ``lease_factor`` intervals is lost (``elastic.peer_lease_expired``).
    ``elastic.on_peer_loss=abort`` then exits with ABORT_EXIT_CODE;
    ``flag`` records it for :meth:`peer_lost`."""

    def __init__(self, directory, rank, world, interval_s=None,
                 lease_factor=5):
        self.directory = os.fspath(directory)
        self.rank = int(rank)
        self.world = int(world)
        self.interval_s = float(
            _config.get("elastic.heartbeat_s")
            if interval_s is None else interval_s)
        self.lease_s = self.interval_s * float(lease_factor)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None          # guarded-by[writes]: _lock
        self._peer_lost = {}         # guarded-by: _lock — rank -> age_s

    def _path(self, rank):
        return os.path.join(self.directory, "hb-r%d" % int(rank))

    def start(self):
        with self._lock:
            if self._thread is not None:
                return self
            self._beat()
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="mxnet-elastic-heartbeat",
                daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=self.interval_s * 2 + 1.0)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self._beat()
                self.scan()
            except OSError as exc:
                _log("heartbeat I/O error: %s", exc)

    def _beat(self):
        # the lease is the file's mtime: a replace publishes and renews
        # it at once, so a crashed writer never leaves half a lease
        path = self._path(self.rank)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write("%d %.3f\n" % (self.rank, time.time()))
        os.replace(tmp, path)

    def scan(self):
        """Read the peers' leases once; a peer with no lease yet has not
        reached its first beat and is not late."""
        now = time.time()
        for peer in range(self.world):
            if peer == self.rank:
                continue
            with self._lock:
                if peer in self._peer_lost:
                    continue
            try:
                age = now - os.stat(self._path(peer)).st_mtime
            except OSError:
                continue
            if age > self.lease_s:
                self._expire(peer, age)

    def _expire(self, peer, age):
        with self._lock:
            self._peer_lost[peer] = float(age)
        _telemetry.counter("elastic.peer_lease_expired").inc()
        _log("peer rank %d lease expired (%.1fs > %.1fs)", peer, age,
             self.lease_s)
        if _config.get("elastic.on_peer_loss") == "abort":
            # a rank blocked in a collective on the dead peer cannot act
            # on a flag: exiting is the only rescue
            _resilience.flush_sinks()
            os._exit(ABORT_EXIT_CODE)

    def peer_lost(self):
        """``{rank: lease age in s}`` of the peers declared lost."""
        with self._lock:
            return dict(self._peer_lost)


_HB_LOCK = threading.Lock()
_HB = None  # guarded-by[writes]: _HB_LOCK — the process's HeartbeatMonitor


def ensure_heartbeat():
    """Start the process's heartbeat monitor (idempotent; a no-op when
    elastic is inactive or the world has one process)."""
    global _HB
    if not active():
        return None
    if _HB is not None:
        return _HB
    rank, world = _rank_world()
    if world == 1:
        return None
    with _HB_LOCK:
        if _HB is None:
            _HB = HeartbeatMonitor(state_dir(), rank, world).start()
    return _HB


def stop_heartbeat():
    """Stop and forget the process's monitor."""
    global _HB
    with _HB_LOCK:
        hb, _HB = _HB, None
    if hb is not None:
        hb.stop()


# ============================================ coordinated checkpointing
class CoordinatedCheckpointManager(_resilience.CheckpointManager):
    """A CheckpointManager for several processes: rank 0 writes, every
    rank waits at a barrier.

    ``save`` publishes one snapshot a step: rank 0 runs the saver and
    stamps the manifest with the world (:meth:`world_stamp`), then every
    rank holds a barrier, so none advances (or exits on a preemption)
    before the snapshot is durable; every rank must call it.
    ``restore`` needs a manifest with the stamp (an unstamped file is a
    torn or uncoordinated write and is skipped), and ends with an
    all-reduce that checks every rank resumed the same step.
    ``write_mode='all'`` makes every rank write (private directories);
    the default ``'rank0'`` suits the single-file format on a shared
    file system."""

    def __init__(self, directory, every_n_steps=None, keep=None,
                 prefix="ckpt", mesh=None, write_mode="rank0"):
        super().__init__(directory, every_n_steps=every_n_steps,
                         keep=keep, prefix=prefix)
        if write_mode not in ("rank0", "all"):
            raise ValueError("write_mode must be 'rank0' or 'all', got %r"
                             % (write_mode,))
        self.mesh = mesh
        self.write_mode = write_mode

    def world_stamp(self):
        _, world = _rank_world()
        stamp = {"process_count": world}
        if self.mesh is not None:
            stamp["mesh"] = {name: int(self.mesh.shape[name])
                             for name in self.mesh.axis_names}
        return stamp

    def save(self, step, saver):
        from .parallel import barrier
        rank, _ = _rank_world()
        path = self.path_for(step)
        writes = self.write_mode == "all" or rank == 0
        if writes:
            def write():
                saver(path)
                _resilience.write_manifest(path, step=step,
                                           world=self.world_stamp())

            _resilience.call_with_retry(write, kind="ckpt_write")
            _telemetry.counter("resilience.ckpt_saves").inc()
        # nobody proceeds (or exits on a preemption) before the snapshot
        # is published
        barrier("elastic-ckpt-%d" % int(step))
        if writes:
            self._prune()
        return path

    def restore(self, loader):
        import numpy as np
        rank, world = _rank_world()
        restored = None
        for step, path in reversed(self.checkpoints()):
            try:
                man = _resilience.verify_checkpoint(path,
                                                    require_manifest=True)
                if "world" not in man:
                    raise _resilience.CheckpointCorruptError(
                        "manifest %s has no world stamp: a torn or "
                        "uncoordinated write"
                        % _resilience.manifest_path(path))
                loader(path)
            except _resilience.CheckpointCorruptError as exc:
                _telemetry.counter("resilience.ckpt_fallbacks").inc()
                _log("checkpoint %s unusable (%s); falling back", path, exc)
                continue
            restored = (step, man)
            break
        if world > 1:
            from .parallel import host_allreduce
            # a rank resuming another step (or none) would fork the world
            here = -1 if restored is None else int(restored[0])
            total = int(host_allreduce(np.int64(here)))
            if total != here * world:
                raise _resilience.CheckpointCorruptError(
                    "ranks disagree on the restore step (rank %d restored "
                    "%s; the sum over the ranks is %d)" % (rank, here,
                                                          total))
        if restored is None:
            return None
        step, man = restored
        stamped = man["world"].get("process_count")
        if stamped != world:
            _log("restoring a snapshot of %s processes into a world of %d "
                 "(an elastic re-form)", stamped, world)
        return step


def coordinate(manager, mesh=None):
    """``manager`` under the coordinated protocol (same directory,
    cadence, retention and prefix); itself when it already is one."""
    if isinstance(manager, CoordinatedCheckpointManager):
        if mesh is not None and manager.mesh is None:
            manager.mesh = mesh
        return manager
    return CoordinatedCheckpointManager(
        manager.directory, every_n_steps=manager.every_n_steps,
        keep=manager.keep, prefix=manager.prefix, mesh=mesh)
