"""Custom-operator escape hatch (the port of ``mxnet_tpu/operator.py``).

ref: python/mxnet/operator.py — class CustomOp / CustomOpProp +
operator.register; src/operator/custom/custom.cc.  Users subclass CustomOp
(forward/backward over NDArrays), describe shapes/types in a CustomOpProp,
register under a name, and call ``mx.nd.Custom(..., op_type=name)``.

The custom body runs eagerly in Python with recording paused, as the
reference's custom ops run on the engine's Python thread.  Its outputs
are made on the inputs' device.  Under ``autograd.record()`` the call is
one torch autograd node (``_CustomNode``) whose backward is the user's
``backward``.  Inside a captured graph (a hybridized block, a training
step, a CUDA graph capture) a custom op raises, as the JAX package's
raises under tracing: its Python body cannot be recorded (register an op
in ``ops/registry.py`` for that).
"""
from __future__ import annotations

import torch

from . import autograd as _autograd
from .ndarray.ndarray import NDArray, _wrap

__all__ = ["CustomOp", "CustomOpProp", "register", "get"]

_REGISTRY = {}


class CustomOp:
    """ref: operator.CustomOp — override forward() and backward()."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """ref: CustomOp.assign — honour the write/inplace/add/null
        request; ``src`` lands on ``dst``'s device."""
        if req == "null":
            return
        val = src._data if isinstance(src, NDArray) else torch.as_tensor(src)
        val = val.to(dst._data.device)
        if req in ("write", "inplace", None):
            dst._data = val
        elif req == "add":
            dst._data = dst._data + val
        else:
            raise ValueError(f"unknown req {req!r}")


class CustomOpProp:
    """ref: operator.CustomOpProp — shapes/dtypes/arity metadata."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, shapes, dtypes):
        raise NotImplementedError


def register(name):
    """ref: mx.operator.register — decorator over a CustomOpProp class."""

    def _reg(prop_cls):
        _REGISTRY[name] = prop_cls
        return prop_cls

    return _reg


def get(name):
    return _REGISTRY[name]


def _zeros(shape, dtype, device):
    from . import ndarray as nd
    return nd.zeros(tuple(shape), ctx=device, dtype=dtype)


def _run_forward(op, inputs, out_shapes, out_types, device):
    outs = [_zeros(s, t, device) for s, t in zip(out_shapes, out_types)]
    with _autograd.pause(train_mode=_autograd.is_training()):
        op.forward(_autograd.is_training(), ["write"] * len(outs),
                   list(inputs), outs, [])
    return outs


class _CustomNode(torch.autograd.Function):
    """One autograd node for a recorded custom-op call: the forward is
    the user's ``forward``, the backward the user's ``backward`` (the
    inputs and outputs saved as tensors, so no reference cycle holds
    them)."""

    @staticmethod
    def forward(ctx, op, inputs, shapes_types, *tensors):
        out_shapes, out_types, device = shapes_types
        outs = _run_forward(op, inputs, out_shapes, out_types, device)
        ctx.op, ctx.n_in = op, len(tensors)
        out_t = tuple(o._data for o in outs)
        ctx.save_for_backward(*tensors, *out_t)
        return out_t

    @staticmethod
    def backward(ctx, *cts):
        saved = ctx.saved_tensors
        ins = [NDArray(t.detach()) for t in saved[:ctx.n_in]]
        outs = [NDArray(t.detach()) for t in saved[ctx.n_in:]]
        in_grads = [_zeros(a.shape, a.dtype, a._data.device) for a in ins]
        out_grads = [NDArray(torch.zeros_like(o._data) if c is None else c)
                     for c, o in zip(cts, outs)]
        with _autograd.pause():
            ctx.op.backward(["write"] * len(in_grads), out_grads, ins,
                            outs, in_grads, [])
        grads = tuple(g._data if need else None
                      for g, need in zip(in_grads, ctx.needs_input_grad[3:]))
        return (None, None, None) + grads


def invoke_custom(*inputs, op_type, **kwargs):
    """Run a registered custom op (the ``nd.Custom`` entry point)."""
    if op_type not in _REGISTRY:
        raise ValueError(
            f"custom op {op_type!r} is not registered "
            f"(known: {sorted(_REGISTRY)})")
    from .parallel.functional import running_eagerly
    tensors = [a._data for a in inputs]
    if running_eagerly() or (any(t.is_cuda for t in tensors) and
                             torch.cuda.is_current_stream_capturing()):
        raise TypeError(
            f"custom op {op_type!r} cannot run inside a captured graph (a "
            f"hybridized block, a training step or a CUDA graph capture): "
            f"its Python body executes eagerly (register a real op in "
            f"ops/registry.py for a capturable kernel)")
    prop = _REGISTRY[op_type](**kwargs)
    in_shapes = [list(a.shape) for a in inputs]
    _, out_shapes, _ = prop.infer_shape(in_shapes)
    in_types = [a.dtype for a in inputs]
    _, out_types, _ = prop.infer_type(in_types)
    # reference contract: create_operator receives the INPUT shapes/dtypes
    op = prop.create_operator(None, in_shapes, in_types)
    device = tensors[0].device if tensors else None
    if _autograd.is_recording() and any(t.requires_grad for t in tensors):
        with torch.enable_grad():
            res = _CustomNode.apply(op, list(inputs),
                                    (out_shapes, out_types, device),
                                    *tensors)
        outs = [_wrap(t) for t in res]
    else:
        outs = _run_forward(op, inputs, out_shapes, out_types, device)
    return outs if len(outs) > 1 else outs[0]
