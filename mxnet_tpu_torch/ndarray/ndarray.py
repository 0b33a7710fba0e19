"""NDArray: the user-facing array (the port of
``mxnet_tpu/ndarray/ndarray.py``).

An NDArray wraps a ``torch.Tensor`` (``_data``); its context is the
tensor's device.  It is a wrapper and not a tensor subclass, because
MXNet's methods and torch's collide under the same names (``size``,
``reshape``'s special codes, ``max(axis=)``, ``grad``, ``T``).  Ops
return as soon as their kernels are queued; ``asnumpy()`` is the sync
point.

``invoke`` dispatches a registered op: one dict lookup, the tensors
unwrapped, one call, the results wrapped.  Inside ``autograd.record()``
torch builds the graph; outside it the op runs with gradients off, so
arrays marked for gradients (parameters among them) record nothing.

Writes rebind, as in the JAX package: ``x[i] = v``, ``x += y`` and
``out=`` give ``x`` a new tensor and never write into the old one, so
an array made from ``x`` earlier (a reshape, a slice) does not see the
write.  (In MXNet such views do see it.)  An optimizer's update is the
exception: it writes into the weight's own storage
(``optimizer._writeback``), so a parameter keeps its tensor.

Dtypes follow the JAX package, which runs without 64-bit types: an op
result or a new array of int64 is int32 and of float64 is float32.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd as _autograd
from .. import storage as _storage
from ..base import dtype_np, dtype_torch
from ..context import context_of, resolve_device
from ..ops.registry import OPS

__all__ = ["NDArray", "invoke"]

# what ``torch.no_grad()`` sets, without a context manager per op
_set_grad = torch._C._set_grad_enabled
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32}
_KEEP_NONE = ("a_min", "a_max")


def _wrap(t):
    """``t`` as an NDArray: 64-bit dtypes narrowed, and stamped with the
    recording epoch when it carries a graph."""
    narrow = _NARROW.get(t.dtype)
    if narrow is not None:
        t = t.to(narrow)
    nd = NDArray(t)
    if t.grad_fn is not None:
        nd._epoch = _autograd.current_epoch()
    return nd


def _wrap_all(res):
    if isinstance(res, torch.Tensor):
        return _wrap(res)
    if isinstance(res, (tuple, list)):
        return type(res)(_wrap_all(r) for r in res)
    return res


def _raw(a):
    """An op argument that is not an NDArray: numpy arrays become
    tensors, anything else passes as is."""
    return tensor_from_numpy(a) if isinstance(a, np.ndarray) else a


def tensor_from_numpy(a):
    """A CPU tensor of numpy array ``a``, 64-bit dtypes narrowed as JAX
    narrows them; a bfloat16 array (the ``ml_dtypes`` type, or its
    two-byte raw form as ``np.load`` returns it) keeps its bits."""
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    elif not a.flags.c_contiguous:
        a = a.copy()
    if a.dtype.itemsize == 2 and (a.dtype.kind == "V"
                                  or a.dtype.name == "bfloat16"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# Set by ``profiler.set_state("run")``: None keeps the dispatch free of
# any profiler cost but this read.
_PROF = None


def invoke(op_name: str, *args, out=None, **kwargs):
    """Dispatch registered op ``op_name`` on NDArrays (and scalars); a
    span per call while the profiler records."""
    fn = OPS.get(op_name)
    if fn is None:
        raise ValueError(f"unknown operator '{op_name}'")
    prof = _PROF
    if prof is not None and prof.ACTIVE:
        t0 = prof._now_us()
    else:
        prof = None
    raw = [a._data if isinstance(a, NDArray) else _raw(a) for a in args]
    if kwargs:
        kwargs = {k: v for k, v in kwargs.items()
                  if v is not None or k in _KEEP_NONE}
    if torch.is_grad_enabled() and not getattr(_autograd._tls, "recording",
                                               False):
        _set_grad(False)
        try:
            res = fn(*raw, **kwargs)
        finally:
            _set_grad(True)
    else:
        res = fn(*raw, **kwargs)
    if isinstance(res, tuple):
        res = tuple(_wrap(r) for r in res)
        first = res[0]
    else:
        res = first = _wrap(res)
    if out is not None:
        if first._epoch is None:
            out._rebind(first._data)
        else:   # recorded: ``out`` must hold the tensor the graph knows
            out._data, out._epoch = first._data, first._epoch
        res = (out,) + res[1:] if isinstance(res, tuple) else out
    if prof is not None:
        if prof.want_sync() and first._data.is_cuda:
            torch.cuda.synchronize(first._data.device)
        prof.record_span(op_name, t0, prof._now_us())
    return res


class NDArray:
    """A dense array on a device."""

    __slots__ = ("_data", "_grad", "_grad_req", "_epoch", "__weakref__")
    __array_priority__ = 100.0

    def __init__(self, data, ctx=None):
        if not isinstance(data, torch.Tensor):
            data = tensor_from_numpy(np.asarray(data))
        if ctx is not None:
            data = data.to(resolve_device(ctx))
        self._data = data
        self._grad = None
        self._grad_req = "null"
        self._epoch = None
        _storage.on_create(self)      # the storage manager's accounting

    # ------------------------------------------------------------ basics --
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def dtype(self):
        return dtype_np(self._data.dtype)

    @property
    def context(self):
        return context_of(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return invoke("transpose", self)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of 0-d NDArray")
        return self.shape[0]

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    # -------------------------------------------------------------- sync --
    def wait_to_read(self):
        """Block until the kernels that write this array have run."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def asnumpy(self) -> np.ndarray:
        """A numpy copy (waits for the device); bfloat16 comes back as
        ``ml_dtypes.bfloat16``, as the JAX package returns it."""
        t = self._data.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(dtype_np("bfloat16"))
        return t.numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("the array is not scalar-sized")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # ----------------------------------------------------------- autograd --
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Mark for gradients: ``grad`` starts at zeros, and a backward
        writes (``'write'``) or adds (``'add'``) the gradient into it."""
        _autograd.attach(self, self._data, grad_req)
        self._grad = NDArray(torch.zeros_like(self._data)) \
            if grad_req != "null" else None

    @property
    def grad(self):
        return self._grad

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _autograd.backward([self], [out_grad] if out_grad is not None
                           else None, retain_graph=retain_graph,
                           train_mode=train_mode)

    def _rebind(self, t):
        """Give this array the new tensor ``t`` (an array marked for
        gradients stays marked, on ``t``)."""
        if self._grad_req != "null":
            _autograd.attach(self, t, self._grad_req)
        else:
            self._data = t

    # ------------------------------------------------------------- moves --
    def copy(self):
        return NDArray(self._data.detach().clone())

    def copyto(self, other):
        """Into NDArray ``other`` (rebinding it) or onto a context."""
        if isinstance(other, NDArray):
            other._rebind(self._data.detach().to(other._data.device,
                                                 copy=True))
            return other
        return NDArray(self._data.detach().to(resolve_device(other),
                                              copy=True))

    def as_in_context(self, ctx):
        dev = resolve_device(ctx)
        if dev == self._data.device:
            return self
        return NDArray(self._data.detach().to(dev))

    as_in_ctx = as_in_context

    def astype(self, dtype, copy=True):
        return invoke("cast", self, dtype=dtype)

    # ----------------------------------------------------------- indexing --
    def __getitem__(self, key):
        key = _index(key)
        if _autograd.is_recording() or not torch.is_grad_enabled():
            return _wrap(self._data[key])
        with torch.no_grad():
            return _wrap(self._data[key])

    def __setitem__(self, key, value):
        if _autograd.is_recording():
            raise RuntimeError(
                "in-place item assignment is not supported inside "
                "autograd.record(); use nd.where / masked ops instead")
        v = value._data if isinstance(value, NDArray) else value
        if isinstance(v, np.ndarray):
            v = tensor_from_numpy(v)
        with torch.no_grad():
            new = self._data.detach().clone()
            new[_index(key)] = v
        self._rebind(new)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ---------------------------------------------------------- operators --
    def __add__(self, o):
        return invoke("add", self, o)

    def __radd__(self, o):
        return invoke("add", o, self)

    def __sub__(self, o):
        return invoke("subtract", self, o)

    def __rsub__(self, o):
        return invoke("subtract", o, self)

    def __mul__(self, o):
        return invoke("multiply", self, o)

    def __rmul__(self, o):
        return invoke("multiply", o, self)

    def __truediv__(self, o):
        return invoke("divide", self, o)

    def __rtruediv__(self, o):
        return invoke("divide", o, self)

    def __mod__(self, o):
        return invoke("mod", self, o)

    def __pow__(self, o):
        return invoke("power", self, o)

    def __rpow__(self, o):
        return invoke("power", o, self)

    def __neg__(self):
        return invoke("negative", self)

    def __abs__(self):
        return invoke("abs", self)

    def __matmul__(self, o):
        return invoke("dot", self, o)

    def __eq__(self, o):
        return invoke("equal", self, o)

    def __ne__(self, o):
        return invoke("not_equal", self, o)

    def __gt__(self, o):
        return invoke("greater", self, o)

    def __ge__(self, o):
        return invoke("greater_equal", self, o)

    def __lt__(self, o):
        return invoke("lesser", self, o)

    def __le__(self, o):
        return invoke("lesser_equal", self, o)

    def __hash__(self):
        return id(self)

    def __iadd__(self, o):
        self._rebind((self + o)._data)
        return self

    def __isub__(self, o):
        self._rebind((self - o)._data)
        return self

    def __imul__(self, o):
        self._rebind((self * o)._data)
        return self

    def __itruediv__(self, o):
        self._rebind((self / o)._data)
        return self

    # ------------------------------------------------------ method sugar --
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return invoke("reshape", self, shape=shape, **kwargs)

    def reshape_like(self, other):
        return invoke("reshape_like", self, other)

    def sum(self, axis=None, keepdims=False):
        return invoke("sum", self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return invoke("mean", self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return invoke("max", self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return invoke("min", self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return invoke("prod", self, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None):
        return invoke("argmax", self, axis=axis)

    def argmin(self, axis=None):
        return invoke("argmin", self, axis=axis)

    def norm(self, ord=2, axis=None, keepdims=False):
        return invoke("norm", self, ord=ord, axis=axis, keepdims=keepdims)

    def transpose(self, axes=None):
        return invoke("transpose", self, axes=axes)

    def swapaxes(self, dim1, dim2):
        return invoke("swapaxes", self, dim1=dim1, dim2=dim2)

    def expand_dims(self, axis):
        return invoke("expand_dims", self, axis=axis)

    def squeeze(self, axis=None):
        return invoke("squeeze", self, axis=axis)

    def flatten(self):
        return invoke("flatten", self)

    def flip(self, axis):
        return invoke("flip", self, axis=axis)

    def tile(self, reps):
        return invoke("tile", self, reps=reps)

    def repeat(self, repeats, axis=None):
        return invoke("repeat", self, repeats=repeats, axis=axis)

    def clip(self, a_min=None, a_max=None):
        return invoke("clip", self, a_min=a_min, a_max=a_max)

    def abs(self):
        return invoke("abs", self)

    def sqrt(self):
        return invoke("sqrt", self)

    def square(self):
        return invoke("square", self)

    def exp(self):
        return invoke("exp", self)

    def log(self):
        return invoke("log", self)

    def relu(self):
        return invoke("relu", self)

    def sigmoid(self):
        return invoke("sigmoid", self)

    def tanh(self):
        return invoke("tanh", self)

    def softmax(self, axis=-1):
        return invoke("softmax", self, axis=axis)

    def log_softmax(self, axis=-1):
        return invoke("log_softmax", self, axis=axis)

    def slice_axis(self, axis, begin, end):
        return invoke("slice_axis", self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return invoke("take", self, indices, axis=axis, mode=mode)

    def one_hot(self, depth, **kwargs):
        return invoke("one_hot", self, depth=depth, **kwargs)

    def broadcast_to(self, shape):
        return invoke("broadcast_to", self, shape=shape)

    def broadcast_like(self, other):
        return invoke("broadcast_like", self, other)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke("split", self, num_outputs=num_outputs, axis=axis,
                      squeeze_axis=squeeze_axis)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return invoke("topk", self, axis=axis, k=k, ret_typ=ret_typ,
                      is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return invoke("sort", self, axis=axis, is_ascend=is_ascend)

    def argsort(self, axis=-1, is_ascend=True):
        return invoke("argsort", self, axis=axis, is_ascend=is_ascend)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return invoke("dot", self, other, transpose_a=transpose_a,
                      transpose_b=transpose_b)

    def tostype(self, stype):
        if stype != "default":
            raise NotImplementedError(
                f"storage type {stype!r}: the port has dense arrays only")
        return self

    def zeros_like(self):
        return invoke("zeros_like", self)

    def ones_like(self):
        return invoke("ones_like", self)


def _index(key):
    """An index with NDArrays unwrapped (float indices as int64)."""
    if isinstance(key, NDArray):
        d = key._data
        return d.long() if d.is_floating_point() or d.dtype == torch.int32 \
            else d
    if isinstance(key, tuple):
        return tuple(_index(k) for k in key)
    return key


def as_tensor(value, dtype=None, device=None):
    """A new tensor of ``value`` (an NDArray, tensor, numpy array, list
    or scalar) on ``device`` with ``mx.nd.array``'s dtype rules: lists
    and scalars float32 unless ``dtype`` says, 64-bit types narrowed.
    It never shares memory with ``value``."""
    if isinstance(value, (NDArray, torch.Tensor)):
        t = getattr(value, "_data", value).detach()
        src = t.data_ptr()
    else:
        a = np.asarray(value, dtype=None if dtype is not None or isinstance(
            value, np.ndarray) else np.float32)
        src = a.ctypes.data
        t = tensor_from_numpy(a)
    if dtype is not None:
        t = t.to(dtype_torch(dtype))
    t = t.to(_NARROW.get(t.dtype, t.dtype))
    if device is not None:
        t = t.to(device)
    return t.clone() if t.data_ptr() == src else t
