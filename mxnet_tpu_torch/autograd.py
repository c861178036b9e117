"""Autograd mode scopes (counterpart of ``mxnet_tpu.autograd``, its
recording/training state only).

``record`` / ``pause`` / ``train_mode`` / ``predict_mode`` set the two
flags layers read: ``is_training`` (BatchNorm uses batch statistics and
updates its moving ones) and ``is_recording``.  Gradients are PyTorch's:
a tensor that requires grad carries its history through every op whether
or not a scope records, and the trainer differentiates its functionalized
step with ``torch.autograd``.  The reference's tape (``_tape.py``:
``mark_variables``, ``backward``, ``grad``, ``Function``) is not ported.
"""
from __future__ import annotations

import threading

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_recording(flag):
    prev = _STATE.recording
    _STATE.recording = bool(flag)
    return prev


def set_training(flag):
    prev = _STATE.training
    _STATE.training = bool(flag)
    return prev


class _RecordingStateScope:
    """Set (recording, training) for a block; ``None`` leaves a flag as
    it is."""

    def __init__(self, is_record, train_mode_):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode_
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)

    def __exit__(self, *exc):
        if self._enter_is_record is not None:
            set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode=True):
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)
