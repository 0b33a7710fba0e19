"""Recording and training-mode scopes (the port of ``mxnet_tpu/autograd.py``'s
flags).

Two thread-local flags, as in the JAX package: *recording* (build the
graph for a backward pass) and *training* (BatchNorm and the fused
norm-relu-conv use batch statistics and update their running stats).
Recording maps onto ``torch.set_grad_enabled``: a Gluon block runs with
gradients enabled only inside ``record()``.  The backward pass itself is
torch's (``loss.backward()`` / ``torch.autograd.grad``).
"""
from __future__ import annotations

import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training"]

_tls = threading.local()


def _state():
    if not hasattr(_tls, "recording"):
        _tls.recording = False
        _tls.training = False
    return _tls


def is_recording() -> bool:
    return _state().recording


def is_training() -> bool:
    return _state().training


def set_recording(flag: bool) -> bool:
    s = _state()
    prev, s.recording = s.recording, bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    s = _state()
    prev, s.training = s.training, bool(flag)
    return prev


class _Scope:
    def __init__(self, recording, training):
        self._rec = recording
        self._train = training

    def __enter__(self):
        s = _state()
        self._prev = (s.recording, s.training, torch.is_grad_enabled())
        if self._rec is not None:
            s.recording = self._rec
            torch.set_grad_enabled(self._rec)
        if self._train is not None:
            s.training = self._train
        return self

    def __exit__(self, *exc):
        s = _state()
        s.recording, s.training, grad = self._prev
        torch.set_grad_enabled(grad)


def record(train_mode: bool = True) -> _Scope:  # noqa: A002 - mxnet API name
    """Scope in which ops build the graph for backward (ref:
    autograd.record); training mode unless ``train_mode=False``."""
    return _Scope(recording=True, training=train_mode)


def pause(train_mode: bool = False) -> _Scope:  # noqa: A002
    """Scope that stops recording (and, by default, training mode)."""
    return _Scope(recording=False, training=train_mode)


def train_mode() -> _Scope:
    return _Scope(recording=None, training=True)


def predict_mode() -> _Scope:
    return _Scope(recording=None, training=False)
