"""Training callbacks (counterpart of ``mxnet_tpu.callback``; reference:
python/mxnet/callback.py — Speedometer prints samples/sec; used by a Gluon
loop or Module.fit; ``do_checkpoint`` saves a Module's epochs)."""
from __future__ import annotations

import logging
import time
from collections import namedtuple

__all__ = ["BatchEndParam", "Speedometer", "LogValidationMetricsCallback",
           "ProgressBar", "do_checkpoint", "module_checkpoint"]

BatchEndParam = namedtuple("BatchEndParam",
                           ["epoch", "nbatch", "eval_metric", "locals"])


class Speedometer:
    """Log samples/sec every `frequent` batches (reference callback.py
    Speedometer)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / \
                    (time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec" \
                        % (param.epoch, count, speed)
                    msg += "".join("\t%s=%f" % nv for nv in name_value)
                    logging.info(msg)
                else:
                    logging.info(
                        "Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                        param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def do_checkpoint(prefix, period=1):
    """Epoch-end callback writing ``prefix-symbol.json`` and
    ``prefix-NNNN.params`` every ``period`` epochs (reference
    ``callback.py`` ``do_checkpoint``); ``Module.fit`` calls it."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


module_checkpoint = do_checkpoint


class LogValidationMetricsCallback:
    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)


class ProgressBar:
    def __init__(self, total, length=80):
        self.total = total
        self.length = length

    def __call__(self, param):
        count = param.nbatch
        filled = int(round(self.length * count / float(self.total)))
        percents = round(100.0 * count / float(self.total), 1)
        bar = "=" * filled + "-" * (self.length - filled)
        print("[%s] %s%%" % (bar, percents))
