"""``mx.kvstore_server`` (counterpart of ``mxnet_tpu.kvstore_server``).

The reference's server process blocked a ``DMLC_ROLE=server`` process in
the ps-lite server loop.  Here there are no server processes: dist_sync
is a collective among the workers, so every launched process is a
worker.  :func:`_init_kvstore_server_module` keeps old launch scripts
working: a process started with the server or scheduler role exits
cleanly (at import of the package) instead of waiting for pushes that
never come.
"""
from __future__ import annotations

import os
import sys

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer:
    def __init__(self, kvstore):
        self.kvstore = kvstore

    def run(self):
        """Nothing to serve: the merge happens in the workers'
        collective."""
        return


def _init_kvstore_server_module():
    role = os.environ.get("DMLC_ROLE", "")
    if role in ("server", "scheduler"):
        print("mxnet_tpu_torch: role %r is obsolete (dist_sync is a "
              "collective among the workers); exiting cleanly" % role,
              file=sys.stderr)
        sys.exit(0)
