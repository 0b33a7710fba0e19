"""``mx.attribute`` / ``mx.AttrScope`` — attribute scopes for symbol
composition (the port of ``mxnet_tpu/attribute.py``, a copy: the port
imports nothing of the JAX package).

``with mx.AttrScope(lr_mult='0.1', ctx_group='dev1'):`` attaches
attribute metadata to every symbol made inside the scope.  It lands in
each node's ``__meta__`` (never passed to the op), where ``Symbol.attr``
and ``Module._attr_mults`` (the lr/wd multipliers) read it.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current_attrs"]

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def current_attrs() -> dict:
    """The merged attributes of every active scope (inner wins)."""
    out: dict = {}
    for scope in _stack():
        out.update(scope._attrs)
    return out


class AttrScope:
    """Values must be strings: they serialise into the symbol json."""

    def __init__(self, **attrs):
        for k, v in attrs.items():
            if not isinstance(v, str):
                raise ValueError(
                    f"AttrScope only accepts string values; got "
                    f"{k}={v!r} (stringify it — attributes are stored as "
                    f"strings in the graph json)")
        self._attrs = dict(attrs)

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
