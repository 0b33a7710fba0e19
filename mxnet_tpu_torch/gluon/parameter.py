"""Gluon Parameter / ParameterDict (the port of
``mxnet_tpu/gluon/parameter.py``).

A ``Parameter`` owns one NDArray on one device, as in the JAX package.
Its name is prefix-scoped (``resnetv10_stage1_conv0_weight``); a shape
with a 0 is a wildcard that the owning layer fills at its first forward
(deferred initialisation).  A trainable parameter's array is marked for
gradients (``grad_req`` ``'write'`` or ``'add'``): its tensor is a leaf
with ``requires_grad``, and a backward inside ``autograd.record()``
leaves its gradient in ``grad()``.  Running statistics are created with
``differentiable=False``.

``data()`` is the NDArray (under ``npx.set_np()`` the same object
retyped as ``mx.np.ndarray``, so the autograd hook that holds it
stays); ``tensor()`` is its ``torch.Tensor``, what the blocks'
``hybrid_forward`` and the port's training steps take.  A parameter
made with ``grad_stype="row_sparse"`` (``Embedding(sparse_grad=True)``)
hands out its gradient as a ``sparse.RowSparseNDArray``: the rows of
the dense gradient with a nonzero entry.

``set_data`` writes in place; ``initialize(force_reinit=True)``,
``cast``, ``reset_ctx`` and a ``grad_req`` change give the parameter a
new tensor (a hybridized block then drops its graphs).  ``Constant`` is
a parameter with a fixed value and no gradient.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd as _autograd
from .. import initializer as init_mod
from ..base import MXNetError, dtype_torch
from ..context import context_of, resolve_device
from .. import numpy_extension as _npx
from ..ndarray.ndarray import NDArray, tensor_from_numpy
from ..numpy import ndarray as _np_ndarray

__all__ = ["Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """Raised when ``data()`` is read before the shape is known."""


def _as_tensor(data):
    if isinstance(data, NDArray):
        return data._data.detach()
    if isinstance(data, torch.Tensor):
        return data.detach()
    return tensor_from_numpy(np.array(data))


class Parameter:
    """A weight, bias or state tensor of a Block."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self._stype = stype
        self._grad_stype = grad_stype
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._nd = None
        self._deferred_init = None  # (initializer, device, default_init)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req {req!r}: 'write', 'add' or 'null'")
        self._grad_req = req
        if self._nd is not None:
            self._adopt(self._nd._data)

    @property
    def _data(self):
        """The tensor itself, or None before initialisation; a training
        step assigns other tensors here for the span of a forward."""
        return None if self._nd is None else self._nd._data

    @_data.setter
    def _data(self, tensor):
        if self._nd is None:
            self._nd = NDArray(tensor)
        else:
            self._nd._data = tensor

    def _adopt(self, tensor):
        """Make ``tensor`` this parameter's data, marked for gradients by
        ``grad_req``; ``grad()`` starts at zeros."""
        if self._nd is None:
            self._nd = NDArray(tensor)
        self._nd._grad = None
        _autograd.attach(self._nd, tensor, self._grad_req)

    # ----------------------------------------------------------------- init --
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate and fill on ``ctx`` (None: the current context);
        defer while the shape has a wildcard and ``allow_deferred_init``
        is set."""
        if self._nd is not None and not force_reinit:
            return
        if default_init is None:
            default_init = init_mod.Uniform()
        device = resolve_device(ctx)
        if self.shape is None or any(s == 0 for s in self.shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, device, default_init)
                return
            raise ValueError(
                f"cannot initialize parameter '{self.name}' with unknown "
                f"shape {self.shape}; set allow_deferred_init=True or give "
                f"a full shape")
        self._finish_init(init, device, default_init)

    def _finish_init(self, init, device, default_init):
        chosen = init if init is not None else (
            self.init if self.init is not None else default_init)
        value = init_mod.create(chosen)(self.name, self.shape, self.dtype)
        self._adopt(value.to(device))
        self._deferred_init = None

    def _finish_deferred_init(self):
        """Called by the owning layer at its first forward, once
        ``infer_shape`` has filled the wildcards."""
        if self._deferred_init is None:
            raise DeferredInitializationError(
                f"parameter '{self.name}' was not initialize()d")
        self._finish_init(*self._deferred_init)

    # ----------------------------------------------------------------- data --
    def data(self, ctx=None):
        """The NDArray; raises while deferred or uninitialised."""
        if self._nd is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"parameter '{self.name}' deferred-init pending: run a "
                    f"forward pass (or pass in_units/in_channels) before "
                    f"accessing data()")
            raise RuntimeError(f"parameter '{self.name}' has not been "
                               f"initialized; call .initialize() first")
        want = _np_ndarray if _npx.is_np_array() else NDArray
        if type(self._nd) is not want:
            self._nd.__class__ = want     # in place: hooks hold the object
        return self._nd

    def tensor(self):
        """The data as a ``torch.Tensor`` (the leaf itself)."""
        return self.data()._data

    def list_data(self):
        return [self.data()]

    def set_data(self, data):
        """Replace the values (an NDArray, tensor or numpy array), cast
        to this parameter's dtype, in place; the shape must match."""
        arr = _as_tensor(data)
        if self._nd is None:
            device = self._deferred_init[1] if self._deferred_init \
                else arr.device
            self.shape = tuple(arr.shape)
            self._adopt(arr.to(device=device, dtype=dtype_torch(self.dtype),
                               copy=True))
            self._deferred_init = None
            return
        if tuple(arr.shape) != self.shape:
            raise ValueError(f"shape mismatch for '{self.name}': "
                             f"{tuple(arr.shape)} vs {self.shape}")
        with torch.no_grad():
            self._nd._data.copy_(arr)

    def grad(self, ctx=None):
        """The gradient NDArray the last backward left (zeros before
        one)."""
        if self._grad_req == "null":
            raise RuntimeError(f"parameter '{self.name}' has "
                               f"grad_req='null'")
        g = self._dense_grad()
        if self._grad_stype == "row_sparse":
            from .. import sparse
            return sparse.cast_storage(g, "row_sparse")
        return g

    def _dense_grad(self):
        """The dense gradient buffer, whatever ``grad_stype`` says."""
        d = self.data()
        if d._grad is None:
            d._grad = NDArray(torch.zeros_like(d._data))
        return d._grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        if self._nd is not None and self._nd._grad is not None:
            g = self._nd._grad
            g._data = torch.zeros_like(g._data)

    def list_ctx(self):
        """The context the data lives on (none before initialisation)."""
        return [] if self._nd is None else [context_of(self._nd._data
                                                       .device)]

    def reset_ctx(self, ctx):
        """Move the data (or a pending deferred initialisation) to
        ``ctx``; the gradient starts again at zeros."""
        device = resolve_device(ctx)
        if self._nd is not None:
            if self._nd._data.device != device:
                self._adopt(self._nd._data.detach().to(device))
        elif self._deferred_init is not None:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, device, default_init)

    def cast(self, dtype):
        """Change the dtype (``net.cast("bfloat16")``: bf16 compute, with
        f32 master weights kept by the optimizer)."""
        self.dtype = dtype
        if self._nd is not None:
            self._adopt(self._nd._data.detach().to(dtype_torch(dtype)))

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, " \
               f"dtype={self.dtype})"


class Constant(Parameter):
    """A parameter holding a fixed value (``grad_req='null'``)."""

    def __init__(self, name, value):
        if not isinstance(value, np.ndarray):
            value = np.asarray(value.asnumpy() if isinstance(value, NDArray)
                               else value)
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype.name,
                         init=init_mod.Constant(0))

    def _finish_init(self, init, device, default_init):
        self._adopt(tensor_from_numpy(self.value).to(device))
        self._deferred_init = None


class ParameterDict:
    """Prefix-scoped parameter registry."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __iter__(self):
        return iter(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __len__(self):
        return len(self._params)

    def __contains__(self, k):
        return k in self._params

    def __getitem__(self, k):
        return self._params[k]

    def get(self, name, **kwargs):
        """Create or retrieve ``prefix + name``."""
        full = self._prefix + name
        if full in self._params:
            return self._params[full]
        if self._shared is not None and full in self._shared:
            self._params[full] = self._shared[full]
            return self._params[full]
        p = Parameter(full, **kwargs)
        self._params[full] = p
        return p

    def get_constant(self, name, value=None):
        """Create or retrieve the ``Constant`` ``prefix + name``."""
        full = self._prefix + name
        if full not in self._params:
            self._params[full] = Constant(full, value)
        return self._params[full]

    def update(self, other):
        """Add ``other``'s parameters; a name held by another parameter
        raises."""
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(f"duplicate parameter name '{k}'")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self._params.values():
            p.initialize(init=None, ctx=ctx, default_init=init,
                         force_reinit=force_reinit)

    def reset_ctx(self, ctx):
        for p in self._params.values():
            p.reset_ctx(ctx)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def setattr(self, name, value):
        for p in self._params.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Every parameter by its full name (less ``strip_prefix``), in
        ``nd.save``'s container."""
        from .. import ndarray as nd
        d = {}
        for name, p in self._params.items():
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            d[name] = p.data()
        nd.save(filename, d)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from .. import ndarray as nd
        loaded = nd.load(filename, ctx="cpu")
        if restore_prefix:
            loaded = {restore_prefix + k: v for k, v in loaded.items()}
        for name, p in self._params.items():
            if name in loaded:
                p.set_data(loaded[name])
            elif not allow_missing:
                raise ValueError(f"parameter '{name}' missing in file "
                                 f"{filename}")
        if not ignore_extra:
            extra = set(loaded) - set(self._params)
            if extra:
                raise ValueError(f"file {filename} has extra parameters "
                                 f"{sorted(extra)}")

    def __repr__(self):
        body = "\n".join(f"  {p!r}" for p in self._params.values())
        return f"ParameterDict '{self._prefix}' (\n{body}\n)"
