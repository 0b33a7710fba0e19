"""`mx.model` — checkpoint helpers for the symbolic stack (the port of
``mxnet_tpu/model.py``).

ref: python/mxnet/model.py — the 1.x scripts' `mx.model.save_checkpoint` /
`load_checkpoint` artifact layout (prefix-symbol.json +
prefix-NNNN.params with 'arg:'/'aux:' key prefixes), readable by either
package.  The legacy FeedForward class is not carried over: its fit
ergonomics live in `mx.mod.Module.fit`.
"""
from .module import load_checkpoint, save_checkpoint  # noqa: F401

__all__ = ["save_checkpoint", "load_checkpoint"]
