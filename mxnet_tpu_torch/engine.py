"""Execution semantics (the port of ``mxnet_tpu/engine.py``).

PyTorch's CUDA stream is the engine: an op returns once its kernels are
queued, and reading a value waits for them.  This module supplies what
MXNet exposes to users:

- ``waitall()`` — a barrier on every card's queued work
  (``torch.cuda.synchronize``); ``NDArray.wait_to_read`` waits for one
  array;
- ``set_bulk_size``/``bulk`` — API-parity scopes that record the size
  and change nothing: eager PyTorch has no op bulking to tune, and a
  captured step (``graphs.StepGraph``) is the port's whole-graph form;
- ``MXNET_ENGINE_TYPE=NaiveEngine`` (read at import, or
  ``set_naive(True)``): synchronous dispatch, MXNet's race-bisect
  debugging mode — every ``nd`` dispatch waits for its kernels on the
  card.  Off, the dispatch pays one global read for it.
"""
from __future__ import annotations

import torch

__all__ = ["waitall", "set_bulk_size", "bulk", "set_naive", "is_naive"]

_bulk_size = 0


def waitall():
    """Block until every queued kernel on every card has finished."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _wait(t):
    """NaiveEngine's wait after a dispatch whose first output is ``t``."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def set_naive(flag):
    """Turn synchronous dispatch (NaiveEngine) on or off."""
    from .ndarray import ndarray as _nd
    _nd._NAIVE = _wait if flag else None


def is_naive():
    from .ndarray import ndarray as _nd
    return _nd._NAIVE is not None


def set_bulk_size(size: int) -> int:
    """Record ``size``; returns the previous one."""
    global _bulk_size
    prev, _bulk_size = _bulk_size, int(size)
    return prev


class bulk:
    """``with mx.engine.bulk(size):`` — ``set_bulk_size`` for a scope."""

    def __init__(self, size: int):
        self.size = size

    def __enter__(self):
        self._prev = set_bulk_size(self.size)

    def __exit__(self, *exc):
        set_bulk_size(self._prev)
