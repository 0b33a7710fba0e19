"""Recording, training mode and backward on NDArrays (the port of
``mxnet_tpu/autograd.py``).

Two thread-local flags, as in the JAX package: *recording* (build the
graph for a backward pass) and *training* (BatchNorm, Dropout and the
fused norm-relu-conv use batch statistics and update their running
stats).  Recording maps onto ``torch.set_grad_enabled``: ops and Gluon
blocks build torch's autograd graph only inside ``record()``.

Torch autograd is the tape.  The JAX package replays a list of VJP
closures and then clears it; the port keeps that contract with an epoch
count: an NDArray an op produced while recording carries the epoch it
was made in, and ``backward`` (without ``retain_graph``) and every fresh
``record()`` scope start a new one.  A head from an earlier epoch has no
graph any more, so a second ``backward`` from it does nothing, as in
the JAX package (where torch would raise).

An array marked for gradients (``attach_grad``, ``mark_variables``, a
Gluon ``Parameter``) is a torch leaf with a hook that, once the leaf's
gradient is complete, writes it into the array's ``grad`` buffer —
replacing it (``grad_req='write'``) or adding to it (``'add'``) — and
clears torch's own ``.grad``.
"""
from __future__ import annotations

import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]

_tls = threading.local()


def _state():
    s = _tls.__dict__
    if "recording" not in s:
        _tls.recording = False
        _tls.training = False
        _tls.epoch = 0
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


def current_epoch() -> int:
    """The recording epoch that NDArrays made now are stamped with."""
    return _state().epoch


class _Scope:
    def __init__(self, recording, training):
        self._rec = recording
        self._train = training

    def __enter__(self):
        s = _state()
        self._prev = (s.recording, s.training, torch.is_grad_enabled())
        if self._rec is not None:
            if self._rec and not s.recording:
                s.epoch += 1           # a fresh recording session
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
    """Scope in which ops build the graph for backward; training mode
    unless ``train_mode=False``."""
    return _Scope(recording=True, training=train_mode)


def pause(train_mode: bool = False) -> _Scope:  # noqa: A002
    """Scope that stops recording (and, by default, training mode)."""
    return _Scope(recording=False, training=train_mode)


def train_mode() -> _Scope:
    return _Scope(recording=None, training=True)


def predict_mode() -> _Scope:
    return _Scope(recording=None, training=False)


# ---------------------------------------------------------- grad buffers --
def _grad_sink(owner):
    """The post-accumulate hook of ``owner``'s leaf: move torch's
    ``.grad`` into ``owner.grad`` by its ``grad_req``."""
    ref = weakref.ref(owner)

    def hook(leaf):
        nd = ref()
        g, leaf.grad = leaf.grad, None
        if nd is None or nd._data is not leaf or nd._grad_req == "null":
            return
        g = g.to(leaf.dtype)
        if nd._grad is None:
            from .ndarray.ndarray import NDArray
            nd._grad = NDArray(g)
        elif nd._grad_req == "add":
            nd._grad._data = nd._grad._data + g
        else:
            nd._grad._data = g
    return hook


def attach(nd, tensor, grad_req):
    """Make ``tensor`` the data of ``nd``, a leaf that records its
    gradient into ``nd.grad`` by ``grad_req``.  An integer array carries
    no gradient (its ``grad`` stays zeros), as in the JAX package."""
    nd._grad_req = grad_req
    if grad_req == "null" or not tensor.is_floating_point():
        nd._data = tensor
        return
    leaf = tensor.detach().requires_grad_(True)
    leaf.register_post_accumulate_grad_hook(_grad_sink(nd))
    nd._data = leaf


def mark_variables(variables, gradients, grad_reqs="write"):
    """Give each variable an external gradient buffer: a later backward
    writes (or adds) the variable's gradient into that NDArray."""
    from .ndarray.ndarray import NDArray

    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        attach(v, v._data, req)
        v._grad = g


def _heads(heads, head_grads):
    """The torch tensors and seeds of the heads that still have a graph
    (or are leaves themselves); ones seed a head without a gradient."""
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    epoch = _state().epoch
    tensors, seeds = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad or (t.grad_fn is not None
                                   and h._epoch != epoch):
            continue
        tensors.append(t)
        seeds.append(torch.ones_like(t) if hg is None else
                     hg._data.to(t.dtype))
    return tensors, seeds


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True):  # noqa: ARG001 - API parity
    """Backward from ``heads`` (seeded with ``head_grads``, ones where
    None): each marked array's gradient lands in its ``grad``.  Without
    ``retain_graph`` the recorded graph is spent, as the JAX package
    clears its tape."""
    tensors, seeds = _heads(heads, head_grads)
    if tensors:
        torch.autograd.backward(tensors, seeds, retain_graph=retain_graph)
    if not retain_graph:
        _state().epoch += 1


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode: bool = True):  # noqa: ARG001
    """The gradients of ``heads`` with respect to ``variables``, as new
    NDArrays; no ``grad`` buffer changes.  ``create_graph`` records the
    gradients' own graph (the JAX package raises for it)."""
    from .ndarray.ndarray import NDArray, _wrap

    if isinstance(variables, NDArray):
        variables = [variables]
    tensors, seeds = _heads(heads, head_grads)
    keep = bool(retain_graph) or create_graph
    inputs = [v._data for v in variables]
    got = torch.autograd.grad(tensors, inputs, seeds, retain_graph=keep,
                              create_graph=create_graph,
                              allow_unused=True) if tensors else \
        [None] * len(inputs)
    if not keep:
        _state().epoch += 1
    return [_wrap(torch.zeros_like(x) if g is None else g)
            for g, x in zip(got, inputs)]


# ------------------------------------------------------------- Function --
class _Bridge(torch.autograd.Function):
    """Runs a user ``Function``'s forward and backward on NDArrays inside
    one torch autograd node."""

    @staticmethod
    def forward(ctx, fn, args, positions, *tensors):
        from .ndarray.ndarray import NDArray

        inputs = list(args)
        for i, t in zip(positions, tensors):
            inputs[i] = NDArray(t)
        with pause(train_mode=is_training()):
            outs = fn.forward(*inputs)
        ctx.fn, ctx.saved, ctx.n_in = fn, fn._saved, len(tensors)
        fn._single = not isinstance(outs, tuple)
        outs = (outs,) if fn._single else outs
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray.ndarray import NDArray

        fn = ctx.fn
        prev, fn._saved = fn._saved, ctx.saved
        try:
            with pause():
                grads = fn.backward(*[NDArray(c) for c in cts])
        finally:
            fn._saved = prev
        grads = tuple(grads) if isinstance(grads, (tuple, list)) \
            else (grads,)
        if len(grads) != ctx.n_in:
            raise ValueError(f"{type(fn).__name__}.backward returned "
                             f"{len(grads)} gradients for {ctx.n_in} "
                             f"array inputs")
        return (None, None, None) + tuple(
            g._data if isinstance(g, NDArray) else torch.as_tensor(g)
            for g in grads)


class Function:
    """User-defined differentiable function: subclass, implement
    ``forward(*inputs)`` and ``backward(*output_grads)`` (one gradient
    per NDArray input, in order) on NDArrays, then call the instance.
    ``forward`` runs with recording paused (training mode kept);
    recorded, the call is one torch autograd node whose backward is
    yours, with ``saved_tensors`` as they were at that call::

        class sigmoid(autograd.Function):
            def forward(self, x):
                y = nd.sigmoid(x)
                self.save_for_backward(y)
                return y
            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y)
    """

    def __init__(self):
        self._saved = ()
        self._single = True

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray, _wrap

        positions = tuple(i for i, a in enumerate(inputs)
                          if isinstance(a, NDArray))
        with torch.set_grad_enabled(is_recording()):
            outs = _Bridge.apply(self, inputs, positions,
                                 *[inputs[i]._data for i in positions])
        outs = tuple(_wrap(o) for o in outs)
        return outs[0] if self._single else outs
