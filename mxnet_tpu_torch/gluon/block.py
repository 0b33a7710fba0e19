"""Gluon Block / HybridBlock as ``torch.nn.Module``s (the port of
``mxnet_tpu/gluon/block.py``).

A Block registers its child blocks as torch submodules and its
``Parameter``s in a prefix-scoped ``ParameterDict``: parameter names are
the JAX package's (``resnetv10_stage1_conv0_weight``), built by the same
name scopes.  ``collect_params``, ``initialize`` and ``cast`` walk the
tree.  A ``HybridBlock``'s ``forward`` gathers its own parameters'
tensors and calls ``hybrid_forward(F, x, *args, **params)`` with ``F``
the port's op namespace (``mxnet_tpu_torch.ops``); a parameter whose
shape is still a wildcard is sized by the layer's ``infer_shape`` at
the first forward.

Calling a block builds the autograd graph only inside
``autograd.record()``, as in the JAX package.  A block takes tensors or
NDArrays: NDArray inputs are unwrapped, and the outputs come back as
NDArrays only when NDArrays went in, so the training steps, the
captured graphs and the server keep passing tensors.

``save_parameters``/``load_parameters`` use structural names
(``0.weight``, ``features.3.body.1.gamma``) in ``nd.save``'s container,
so a file written by either package loads in the other;
``params_from_jax`` copies a JAX block's parameters in by full name.

``hybridize()`` is accepted and does nothing here: the blocks always run
eagerly.  The captured-graph counterpart (a CUDA graph of the step) is
later work.
"""
from __future__ import annotations

import threading

import torch

from .. import autograd as _autograd
from .. import ops as _ops
from ..ndarray.ndarray import NDArray, _wrap_all
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "params_from_jax"]

_naming = threading.local()


def _scope_stack():
    if not hasattr(_naming, "stack"):
        _naming.stack = [({}, "")]  # (per-scope counters, prefix so far)
    return _naming.stack


def _make_prefix(explicit, hint):
    """A block's prefix inside the enclosing name scope: ``explicit``,
    or ``hint`` plus the scope's running count of that hint."""
    counters, cur = _scope_stack()[-1]
    if explicit is not None:
        return cur + explicit
    idx = counters.get(hint, 0)
    counters[hint] = idx + 1
    return f"{cur}{hint}{idx}_"


class _NameScope:
    def __init__(self, block):
        self._block = block

    def __enter__(self):
        _scope_stack().append((self._block._scope_counters,
                               self._block._prefix))
        return self

    def __exit__(self, *exc):
        _scope_stack().pop()


class Block(torch.nn.Module):
    """Base container: child blocks and prefix-scoped parameters."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix = _make_prefix(prefix, self._alias())
        self._scope_counters = {}
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params = {}

    def _alias(self):
        return type(self).__name__.lower()

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is not None:
                reg[name] = value
                self._params._params[value.name] = value
        super().__setattr__(name, value)

    @property
    def _children(self):
        return self._modules

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix

    @property
    def params(self):
        return self._params

    def name_scope(self):
        return _NameScope(self)

    def collect_params(self):
        """This block's and its descendants' parameters."""
        out = ParameterDict(self._params.prefix)

        def _add(block):
            out._params.update(block._params.items())
            for c in block._children.values():
                if c is not None:
                    _add(c)
        _add(self)
        return out

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialise every parameter on ``ctx`` (None: the card)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)
        return self

    def cast(self, dtype):
        for p in self.collect_params().values():
            p.cast(dtype)
        return self

    def hybridize(self, active=True, **kwargs):
        """Accepted for API parity; the port runs blocks eagerly."""
        for c in self._children.values():
            if c is not None:
                c.hybridize(active, **kwargs)

    def __call__(self, *args):
        wrap = any(isinstance(a, NDArray) for a in args)
        if wrap:
            args = tuple(a._data if isinstance(a, NDArray) else a
                         for a in args)
        with torch.set_grad_enabled(_autograd.is_recording()):
            out = super().__call__(*args)
        return _wrap_all(out) if wrap else out

    # ---------------------------------------------------------------- save --
    def _collect_params_with_prefix(self, prefix=""):
        """Parameters by structural name (``features.0.weight``),
        independent of the name scopes."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            if child is not None:
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Every parameter by structural name, in ``nd.save``'s
        container."""
        from .. import ndarray as nd
        nd.save(filename, {k: p.data() for k, p in
                           self._collect_params_with_prefix().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Set parameters from a ``save_parameters`` file (either
        package's); values are cast to each parameter's dtype."""
        from .. import ndarray as nd
        loaded = nd.load(filename, ctx="cpu")
        by_key = self._collect_params_with_prefix()
        for key, p in by_key.items():
            if key in loaded:
                if p._nd is None:
                    p.initialize(ctx=ctx)
                p.set_data(loaded[key])
            elif not allow_missing:
                raise ValueError(f"missing parameter '{key}' in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(by_key)
            if extra:
                raise ValueError(f"extra parameters in {filename}: "
                                 f"{sorted(extra)}")

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A block written as ``hybrid_forward(F, x, *args, **params)``."""

    def infer_shape(self, *args):
        """Layer hook: fill the wildcard (0) dims of own parameters from
        the inputs of the first forward."""
        raise DeferredInitializationError(
            f"{type(self).__name__} cannot infer parameter shapes; "
            f"initialize with fully-specified shapes")

    def _ensure_init(self, *args):
        if any(p._deferred_init is not None
               for p in self._reg_params.values()):
            self.infer_shape(*args)
            for p in self._reg_params.values():
                if p._deferred_init is not None:
                    p._finish_deferred_init()

    def forward(self, x, *args):
        try:
            params = {k: p.tensor() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._ensure_init(x, *args)
            params = {k: p.tensor() for k, p in self._reg_params.items()}
        return self.hybrid_forward(_ops, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def params_from_jax(block, arrays):
    """Copy a JAX block's parameters into ``block``: ``arrays`` maps the
    JAX block's ``collect_params()`` names to numpy arrays, and must
    hold exactly this block's names (build both blocks with the same
    ``prefix``).  Values are cast to each parameter's dtype and device;
    a deferred parameter takes the array's shape."""
    params = block.collect_params()
    if set(params.keys()) != set(arrays):
        raise ValueError(
            f"parameter names differ: only in the port "
            f"{sorted(set(params.keys()) - set(arrays))}, only in the JAX "
            f"block {sorted(set(arrays) - set(params.keys()))}")
    for name, p in params.items():
        value = arrays[name]
        known = p.shape or ()
        if len(known) != value.ndim or any(
                s not in (0, v) for s, v in zip(known, value.shape)):
            raise ValueError(f"shape of {name}: port {p.shape}, JAX "
                             f"{tuple(value.shape)}")
        p.set_data(value)
