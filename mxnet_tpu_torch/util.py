"""mx.util (the port of ``mxnet_tpu/util.py``; ref: python/mxnet/util.py
— env helpers, np-array mode queries, misc utilities used across
reference scripts).

The port has no ``mx.np``/``mx.npx`` yet (ROADMAP A14's second half),
so the numpy-semantics flag that ``npx.set_np()`` flips in the JAX
package is kept here: ``use_np`` sets it around a call and restores
the enclosing mode, and ``is_np_array`` reads it.
"""
from __future__ import annotations

import functools
import os
import threading

__all__ = ["makedirs", "getenv", "setenv", "is_np_array", "is_np_shape",
           "use_np", "set_module"]

_np_mode = threading.local()


def makedirs(d):
    """ref: util.makedirs (exist_ok semantics)."""
    os.makedirs(os.path.expanduser(d), exist_ok=True)


def getenv(name):
    """ref: MXGetEnv — read a config knob (registry-aware)."""
    from . import config
    if name in config.KNOBS:
        return config.get(name)
    return os.environ.get(name)


def setenv(name, value):
    """ref: MXSetEnv."""
    os.environ[name] = str(value)


def is_np_array():
    """True inside a ``use_np`` call on this thread."""
    return getattr(_np_mode, "on", False)


def is_np_shape():
    return is_np_array()


def use_np(func_or_cls):
    """Decorator form of npx.set_np scoping (ref: util.use_np): the flag
    is on during the call and the enclosing mode comes back after it.
    A class passes through unchanged, as in the JAX package."""
    if isinstance(func_or_cls, type):
        return func_or_cls

    @functools.wraps(func_or_cls)
    def _wrapped(*args, **kwargs):
        was = is_np_array()
        _np_mode.on = True
        try:
            return func_or_cls(*args, **kwargs)
        finally:
            _np_mode.on = was
    return _wrapped


def set_module(module):
    """ref: util.set_module — decorator fixing __module__ for docs."""
    def deco(obj):
        if module is not None:
            obj.__module__ = module
        return obj
    return deco
