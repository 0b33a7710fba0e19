"""mx.util (the port of ``mxnet_tpu/util.py``; ref: python/mxnet/util.py
— env helpers, np-array mode queries, misc utilities used across
reference scripts).

``is_np_array`` reads ``npx``'s process-wide flag, which ``use_np``
sets around a call and restores after it, as in the JAX package.
"""
from __future__ import annotations

import functools
import os

__all__ = ["makedirs", "getenv", "setenv", "is_np_array", "is_np_shape",
           "use_np", "set_module"]


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
    """True while ``npx.set_np()`` holds (or inside a ``use_np`` call)."""
    from . import numpy_extension as npx
    return npx.is_np_array()


def is_np_shape():
    return is_np_array()


def use_np(func_or_cls):
    """Decorator form of npx.set_np scoping (ref: util.use_np): the flag
    is on during the call and the enclosing mode comes back after it.
    A class passes through unchanged, as in the JAX package."""
    if isinstance(func_or_cls, type):
        return func_or_cls

    from . import numpy_extension as npx

    @functools.wraps(func_or_cls)
    def _wrapped(*args, **kwargs):
        was = npx.is_np_array()
        npx.set_np()
        try:
            return func_or_cls(*args, **kwargs)
        finally:
            if not was:     # the enclosing mode comes back
                npx.reset_np()
    return _wrapped


def set_module(module):
    """ref: util.set_module — decorator fixing __module__ for docs."""
    def deco(obj):
        if module is not None:
            obj.__module__ = module
        return obj
    return deco
