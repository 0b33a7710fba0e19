"""Op registry (the port of ``mxnet_tpu/ops/registry.py``).

An op is a plain function ``fn(*tensors, **params) -> tensor | tuple``
on ``torch.Tensor``s; its gradient is torch autograd's.  ``OPS`` maps
every registered name and alias to its function; ``OP_META`` holds the
dispatch metadata of each name:

- ``has_training`` — the op's behaviour depends on training mode (it
  takes a ``training`` parameter and reads ``autograd.is_training()``
  when it is None);
- ``needs_rng`` — the op draws random numbers (from ``random``'s
  per-device generator).

Eager PyTorch dispatches each call directly, so the JAX registry's jit
cache (``compiled``, ``split_dynamic``, ``params_key``) has no
counterpart here.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict

__all__ = ["OPS", "OP_META", "register_op", "alias_op", "get_op",
           "CONTRIB_SHORT_NAMES"]

OPS: Dict[str, Callable] = {}
OP_META: Dict[str, dict] = {}

# The contrib ops that also get short names in ``nd.contrib`` (those
# not ported yet get theirs when their op modules come).
CONTRIB_SHORT_NAMES = (
    "interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
    "box_nms", "box_iou", "MultiBoxPrior", "MultiBoxTarget",
    "MultiBoxDetection", "div_sqrt_dim", "multi_head_attention",
    "quantize_v2", "dequantize",
)


def register_op(name, fn: Callable = None, aliases=(),
                needs_rng: bool = False):
    """Register ``fn`` under ``name`` and ``aliases``; usable as a
    decorator."""

    def _do(f):
        try:
            has_training = "training" in inspect.signature(f).parameters
        except (TypeError, ValueError):
            has_training = False
        meta = {"has_training": has_training, "needs_rng": needs_rng}
        for n in (name, *aliases):
            OPS[n] = f
            OP_META[n] = meta
        return f

    if fn is None:
        return _do
    return _do(fn)


def alias_op(new_name: str, existing: str):
    OPS[new_name] = OPS[existing]
    OP_META[new_name] = OP_META[existing]


def get_op(name: str) -> Callable:
    try:
        return OPS[name]
    except KeyError:
        raise ValueError(f"unknown operator '{name}'") from None
