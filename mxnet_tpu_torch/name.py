"""``mx.name`` — naming scopes for symbol composition (the port of
``mxnet_tpu/name.py``, a copy: the port imports nothing of the JAX
package).

``NameManager`` gives anonymous symbols ``op0``, ``op1``, ...;
``Prefix`` prepends a scope prefix (``with mx.name.Prefix('resnet_'):``
in classic model definitions).  ``symbol`` asks the active manager for
every node name.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = [NameManager()]
    return _tls.stack


def current() -> "NameManager":
    return _stack()[-1]


class NameManager:
    """Counts the anonymous names of each op type."""

    def __init__(self):
        self._counts = {}

    def get(self, name, hint):
        """Explicit ``name`` wins; otherwise ``hint`` + a running count."""
        if name is not None:
            return name
        i = self._counts.get(hint, 0)
        self._counts[hint] = i + 1
        return f"{hint}{i}"

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()


class Prefix(NameManager):
    """Prepends ``prefix`` to every name it gives."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
