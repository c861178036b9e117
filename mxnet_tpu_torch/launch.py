"""Local multi-process launcher (counterpart of ``tools/launch.py``'s
``launch_local``).

Starts N copies of a command on this host with the rendezvous
environment the workers' :func:`mxnet_tpu_torch.parallel.initialize`
reads: ``MXTPU_COORDINATOR`` (``127.0.0.1:<free port>``),
``MXTPU_NUM_PROCESSES``, ``MXTPU_PROCESS_ID``, and torchrun's
``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``.  The first worker that exits
non-zero (or is killed) ends the job: the survivors get SIGTERM, then
SIGKILL after ``grace_s``, so no rank is left waiting in a collective for
a dead peer.  Run::

    python -m mxnet_tpu_torch.launch -n 2 python train.py ...

``--elastic`` (:func:`launch_elastic`) runs generations of the world:
a generation that ends with a rank's preemption flag in the elastic
state directory (``mx.elastic``'s coordinated preemption) or with a
non-zero exit (a rank killed mid-step, or a heartbeat abort, exit code
75) is started again, up to ``--max-restarts`` times, and its workers
resume from the newest coordinated checkpoint::

    python -m mxnet_tpu_torch.launch -n 2 --elastic --max-restarts 2 \
        python train.py ...
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["launch_local", "launch_elastic"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(num_workers, command, extra_env=None, poll_interval=0.2,
                 grace_s=10.0):
    """Run ``command`` (a list) as ``num_workers`` local ranks; returns 0
    iff every worker exited 0."""
    coordinator = "127.0.0.1:%d" % _free_port()
    procs = []
    for rank in range(num_workers):
        env = dict(os.environ)
        env.update(extra_env or {})
        env.update({"MXTPU_COORDINATOR": coordinator,
                    "MXTPU_NUM_PROCESSES": str(num_workers),
                    "MXTPU_PROCESS_ID": str(rank),
                    "LOCAL_RANK": str(rank),
                    "LOCAL_WORLD_SIZE": str(num_workers)})
        procs.append(subprocess.Popen(command, env=env))
    rc = 0
    try:
        live = list(procs)
        while live and rc == 0:
            time.sleep(poll_interval)
            live = [p for p in live if p.poll() is None]
            if any(p.returncode not in (None, 0) for p in procs):
                rc = 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc


def launch_elastic(num_workers, command, max_restarts=1, elastic_dir=None,
                   extra_env=None):
    """Generations of :func:`launch_local` with ``MXTPU_ELASTIC_DIR`` and
    ``MXTPU_ELASTIC_GENERATION`` exported.  Before each generation the
    previous one's preemption flags and leases are removed; a generation
    that ends with a ``preempt-r*`` flag or a non-zero exit is restarted
    while the budget of ``max_restarts`` lasts.  Returns 0 when a
    generation ran to completion, else the last generation's exit code
    (1 when it was preempted)."""
    import tempfile
    if elastic_dir is None:
        elastic_dir = tempfile.mkdtemp(prefix="mxnet-elastic-")
    os.makedirs(elastic_dir, exist_ok=True)
    rc = 1
    for gen in range(max_restarts + 1):
        for name in os.listdir(elastic_dir):
            if name.startswith(("preempt-r", "hb-r")):
                try:
                    os.unlink(os.path.join(elastic_dir, name))
                except OSError:
                    pass
        env = dict(extra_env or {})
        env["MXTPU_ELASTIC_DIR"] = elastic_dir
        env["MXTPU_ELASTIC_GENERATION"] = str(gen)
        rc = launch_local(num_workers, command, extra_env=env)
        preempted = any(n.startswith("preempt-r")
                        for n in os.listdir(elastic_dir))
        if rc == 0 and not preempted:
            return 0
        what = "was preempted" if preempted else "failed (rc=%d)" % rc
        if gen >= max_restarts:
            sys.stderr.write("launch: generation %d %s and the restart "
                             "budget (%d) is spent\n"
                             % (gen, what, max_restarts))
            return rc if rc != 0 else 1
        sys.stderr.write("launch: generation %d %s; re-forming the world "
                         "(generation %d)\n" % (gen, what, gen + 1))
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", "--num-workers", type=int, required=True,
                    help="number of local ranks")
    ap.add_argument("--elastic", action="store_true",
                    help="restart the world after a coordinated "
                    "preemption or a failed rank (launch_elastic)")
    ap.add_argument("--max-restarts", type=int, default=1,
                    help="restart budget of --elastic (default 1)")
    ap.add_argument("--elastic-dir", default=None,
                    help="elastic state directory (default: a new temp "
                    "directory): leases, preemption flags, coordinated "
                    "checkpoints")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="the command each rank runs")
    args = ap.parse_args(argv)
    if args.num_workers < 1 or not args.command:
        ap.error("need -n >= 1 and a command")
    if args.elastic:
        return launch_elastic(args.num_workers, args.command,
                              max_restarts=args.max_restarts,
                              elastic_dir=args.elastic_dir)
    return launch_local(args.num_workers, args.command)


if __name__ == "__main__":
    sys.exit(main())
