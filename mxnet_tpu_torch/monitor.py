"""``mx.monitor`` — tap outputs and weights during training (counterpart
of ``mxnet_tpu.monitor``).

Reference: ``python/mxnet/monitor.py`` ``Monitor`` — installs an executor
monitor callback (``graph_executor.cc:1410`` ``monitor_callback_``),
collects per-tensor stats every ``interval`` batches, printed by
``toc_print``; ``toc`` also emits ``monitor`` events to the telemetry
step log.  On the Module's fused step a Monitor sees the outputs (fired
through its callback after the step) and the parameters (``toc`` reads
the written-back ``arg_dict``); a raw callback puts the Module on the
eager step, whose forward fires it on the outputs.
"""
from __future__ import annotations

import logging
import re

import numpy as _np

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def stat_func(x):
                return _np.abs(x.asnumpy()).mean()
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def install(self, exe):
        """Install this monitor's callback on ``exe``.  Reinstalling on
        an executor this monitor already watches is a no-op (the
        reference appended forever, so a bind/install loop leaked every
        superseded executor through ``self.exes`` and ``toc`` kept
        reporting their stale params)."""
        exe.set_monitor_callback(self._stat_helper)
        if not any(e is exe for e in self.exes):
            self.exes.append(exe)

    def uninstall(self, exe):
        """Detach from ``exe``: clears its callback (when it is still
        ours) and drops it from the stat sweep.  Unknown executors are
        ignored."""
        # bound-method EQUALITY, not identity: each `self._stat_helper`
        # access builds a fresh bound-method object
        if getattr(exe, "_monitor", None) == self._stat_helper:
            exe.set_monitor_callback(None)
        self.exes = [e for e in self.exes if e is not exe]

    def uninstall_all(self):
        """Detach from every installed executor."""
        for exe in list(self.exes):
            self.uninstall(exe)

    def _stat_helper(self, name, arr):
        if not self.activated or not self.re_prog.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(arr)))

    def tic(self):
        # stats collect on forward via the installed executor callback
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        if not self.activated:
            return []
        for exe in self.exes:
            for name, array in exe.arg_dict.items():
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        from . import telemetry as _telemetry
        emit = _telemetry.enabled()
        for n, k, v_list in self.queue:
            res.append((n, k, str(v_list)))
            if emit:
                try:
                    stat = float(v_list)
                except (TypeError, ValueError):
                    stat = str(v_list)
                _telemetry.log_event("monitor", step=int(n), name=k,
                                     stat=stat)
        self.queue = []
        return res

    def toc_print(self):
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k, v)
