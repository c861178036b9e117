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
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["launch_local"]


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", "--num-workers", type=int, required=True,
                    help="number of local ranks")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="the command each rank runs")
    args = ap.parse_args(argv)
    if args.num_workers < 1 or not args.command:
        ap.error("need -n >= 1 and a command")
    return launch_local(args.num_workers, args.command)


if __name__ == "__main__":
    sys.exit(main())
