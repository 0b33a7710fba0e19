"""Gluon Parameter / ParameterDict (the port of
``mxnet_tpu/gluon/parameter.py``).

A ``Parameter`` owns one tensor on one device.  Its name is prefix-scoped
(``resnetv10_stage1_conv0_weight``); a shape with a 0 is a wildcard that
the owning layer fills at its first forward (deferred initialisation).
A trainable parameter's tensor is a leaf with ``requires_grad``, so a
backward inside ``autograd.record()`` leaves its gradient in ``grad()``;
running statistics are created with ``differentiable=False``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import initializer as init_mod
from ..base import dtype_torch
from ..context import resolve_device

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError"]


class DeferredInitializationError(RuntimeError):
    """Raised when ``data()`` is read before the shape is known."""


def _as_tensor(data):
    if isinstance(data, torch.Tensor):
        return data.detach()
    return torch.from_numpy(np.array(data))


def _write_not_add(leaf):
    """A gradient hook that drops the leaf's old gradient just before
    the new one is accumulated into it."""
    def hook(grad):
        leaf.grad = None
        return grad
    return hook


class Parameter:
    """A weight, bias or state tensor of a Block."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._data = None
        self._deferred_init = None  # (initializer, device, default_init)

    @property
    def grad_req(self):
        return self._grad_req

    def _adopt(self, tensor):
        """Make ``tensor`` this parameter's data: a leaf that records its
        gradient unless ``grad_req`` is "null".  With "write" (the
        default) each backward replaces the gradient, as in the JAX
        package, where torch would add to it."""
        self._data = tensor.requires_grad_(self._grad_req != "null")
        if self._grad_req == "write":
            self._data.register_hook(_write_not_add(self._data))

    # ----------------------------------------------------------------- init --
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate and fill on ``ctx`` (None: the card); defer while the
        shape has a wildcard and ``allow_deferred_init`` is set."""
        if self._data is not None and not force_reinit:
            return
        if default_init is None:
            default_init = init_mod.Uniform()
        device = resolve_device("cuda" if ctx is None else ctx)
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
        """The tensor; raises while deferred or uninitialised."""
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"parameter '{self.name}' deferred-init pending: run a "
                    f"forward pass (or pass in_units/in_channels) before "
                    f"accessing data()")
            raise RuntimeError(f"parameter '{self.name}' has not been "
                               f"initialized; call .initialize() first")
        return self._data

    def set_data(self, data):
        """Replace the values (a tensor or numpy array), cast to this
        parameter's dtype and device; the shape must match."""
        arr = _as_tensor(data)
        if self._data is None:
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
            self._data.copy_(arr)

    def grad(self, ctx=None):
        """The gradient left by the last backward (zeros before one)."""
        d = self.data(ctx)
        if self._grad_req == "null":
            raise RuntimeError(f"parameter '{self.name}' has "
                               f"grad_req='null'")
        return d.grad if d.grad is not None else torch.zeros_like(d)

    def cast(self, dtype):
        """Change the dtype (``net.cast("bfloat16")``: bf16 compute, with
        f32 master weights kept by the optimizer)."""
        self.dtype = dtype
        if self._data is not None:
            self._adopt(self._data.detach().to(dtype_torch(dtype)))

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, " \
               f"dtype={self.dtype})"


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

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self._params.values():
            p.initialize(init=None, ctx=ctx, default_init=init,
                         force_reinit=force_reinit)

    def __repr__(self):
        body = "\n".join(f"  {p!r}" for p in self._params.values())
        return f"ParameterDict '{self._prefix}' (\n{body}\n)"
