"""``mx.nd`` — the imperative array API (the port of
``mxnet_tpu/ndarray/__init__.py``).

Creation functions, ``save``/``load`` and a wrapper per registered op,
generated from ``ops.registry.OPS`` (``nd.relu(x)`` is
``invoke("relu", x)``); ``nd.linalg`` holds the ``linalg_*`` ops under
their short names and ``nd.contrib`` the ``_contrib_*`` ones;
``nd.random`` draws ``uniform``, ``normal``, ``randn``, ``randint``,
``bernoulli``, ``exponential``, ``gamma``, ``poisson``, ``multinomial``
and ``shuffle`` from the port's seeded per-device generators
(``random.generator``), as do the registry's samplers
(``ops/random_ops.py``: ``nd.uniform``, ``nd.normal``, ``nd.randint``,
``nd.shuffle``, ``nd.sample_*``...); ``nd.Custom`` runs a registered
custom operator (``operator``).

New arrays land on ``ctx`` or, without one, on the current context
(``with mx.cpu():``), which outside any scope is the card.  As in the
JAX package, Python lists become float32 and float64/int64 numpy
arrays float32/int32.
"""
from __future__ import annotations

import sys
import types

import numpy as _np
import torch

from .. import random as _random
from ..base import dtype_torch
from ..context import Context, cpu, current_context, gpu, resolve_device
from ..engine import waitall
from ..ops import random_ops as _ro
from ..ops.registry import CONTRIB_SHORT_NAMES, OPS
from .ndarray import (_NARROW, NDArray, as_tensor, invoke,
                      tensor_from_numpy)

__all__ = ["NDArray", "invoke", "array", "empty", "zeros", "ones", "full",
           "zeros_like", "ones_like", "arange", "linspace", "eye",
           "waitall", "save", "load", "concat", "stack", "add_n",
           "ElementWiseSum", "random", "Custom",
           "contrib", "linalg", "Context", "cpu", "gpu", "current_context"]


# ----------------------------------------------------------- creation -------
def array(source_array, ctx=None, dtype=None):
    """A new array on ``ctx`` of ``source_array`` (an NDArray, numpy
    array, list or scalar); lists default to float32."""
    return NDArray(as_tensor(source_array, dtype, resolve_device(ctx)))


def _creation(shape, ctx, dtype, fill):
    if isinstance(shape, int):
        shape = (shape,)
    dt = dtype_torch(dtype if dtype is not None else "float32")
    dt = _NARROW.get(dt, dt)
    dev = resolve_device(ctx)
    if fill is None:
        return NDArray(torch.empty(shape, dtype=dt, device=dev))
    return NDArray(torch.full(tuple(shape), fill, dtype=dt, device=dev))


def empty(shape, ctx=None, dtype=None):
    return _creation(shape, ctx, dtype, None)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return _creation(shape, ctx, dtype, 0)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return _creation(shape, ctx, dtype, 1)


def full(shape, val, ctx=None, dtype=None):
    return _creation(shape, ctx, dtype, val)


def zeros_like(other):
    return invoke("zeros_like", other)


def ones_like(other):
    return invoke("ones_like", other)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    return invoke("_arange", start=start, stop=stop, step=step,
                  repeat=repeat, dtype=dtype, ctx=resolve_device(ctx))


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    dev = resolve_device(ctx)
    if endpoint:
        data = torch.linspace(start, stop, num, dtype=torch.float64)
    else:
        data = torch.linspace(start, stop, num + 1,
                              dtype=torch.float64)[:num]
    return NDArray(data.to(dtype_torch(dtype)).to(dev))


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    data = _np.eye(N, M if M else N, k, dtype=_np.float32)
    return NDArray(as_tensor(data, dtype, resolve_device(ctx)))


# ------------------------------------------------------------ save/load -----
_LIST_KEY = "__list__:"


def _to_numpy(nd):
    """The array for an ``.npz`` entry: bfloat16 as its raw two-byte
    form, which is how ``np.savez`` stores the JAX package's
    ``ml_dtypes`` bfloat16 arrays."""
    t = nd._data.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_np.dtype("V2"))
    return t.numpy()


def save(fname: str, data):
    """Arrays to a numpy ``.npz`` file: a dict by its keys, a list (or
    one array) by position; the JAX package's container, readable by
    either package."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        payload = {k: _to_numpy(v) for k, v in data.items()}
    else:
        payload = {f"{_LIST_KEY}{i}": _to_numpy(v)
                   for i, v in enumerate(data)}
    with open(fname, "wb") as f:
        _np.savez(f, **payload)


def load(fname: str, ctx=None):
    """A list or dict of arrays as ``save`` wrote it (or the JAX package
    did), on ``ctx`` (None: the current context); two-byte raw entries
    are bfloat16."""
    dev = resolve_device(ctx)
    with _np.load(fname) as z:
        arrays = {k: NDArray(tensor_from_numpy(z[k]).to(dev))
                  for k in z.files}
    if arrays and all(k.startswith(_LIST_KEY) for k in arrays):
        keys = sorted(arrays, key=lambda s: int(s[len(_LIST_KEY):]))
        return [arrays[k] for k in keys]
    return arrays


# ---------------------------------------------------- generated wrappers ----
_this = sys.modules[__name__]


def _make_wrapper(op_name: str):
    def wrapper(*args, **kwargs):
        return invoke(op_name, *args, **kwargs)

    wrapper.__name__ = wrapper.__qualname__ = op_name
    wrapper.__doc__ = (OPS[op_name].__doc__ or "") + "\n(generated wrapper)"
    return wrapper


for _name in list(OPS):
    if not hasattr(_this, _name):
        setattr(_this, _name, _make_wrapper(_name))


def concat(*data, dim=1):
    return invoke("concat", *data, dim=dim)


def stack(*data, axis=0):
    return invoke("stack", *data, axis=axis)


def add_n(*data):
    out = data[0]
    for d in data[1:]:
        out = out + d
    return out


ElementWiseSum = add_n


def __getattr__(name):
    """Ops registered after this module was imported still get a
    wrapper at first use."""
    if name in OPS:
        w = _make_wrapper(name)
        setattr(_this, name, w)
        return w
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# ------------------------------------------------------------ namespaces ----
def _namespace(name, pairs):
    mod = types.ModuleType(f"{__name__}.{name}")
    for short, op in pairs:
        setattr(mod, short, _make_wrapper(op))
    sys.modules[mod.__name__] = mod
    return mod


contrib = _namespace(
    "contrib", [(n[len("_contrib_"):], n) for n in OPS
                if n.startswith("_contrib_")]
    + [(n, n) for n in CONTRIB_SHORT_NAMES if n in OPS])
linalg = _namespace("linalg", [(n[len("linalg_"):], n) for n in OPS
                               if n.startswith("linalg_")])


# --------------------------------------------------------------- random -----
random = types.ModuleType(f"{__name__}.random")


def _draw(make, shape, ctx, dtype, out):
    """``make(shape, generator, device)`` on ``ctx`` (None: the current
    context) from that device's seeded stream; into ``out`` if given."""
    if isinstance(shape, int):
        shape = (shape,)
    dev = resolve_device(ctx)
    data = make(tuple(shape), _random.generator(dev), dev)
    res = NDArray(data.to(_NARROW.get(data.dtype, data.dtype)))
    if out is not None:
        out._rebind(res._data)
        return out
    return res


def _uniform(low=0.0, high=1.0, shape=(), ctx=None, dtype="float32",
             out=None):
    return _draw(lambda s, g, d: low + (high - low) * torch.rand(
        s, generator=g, device=d, dtype=dtype_torch(dtype)),
        shape, ctx, dtype, out)


def _normal(loc=0.0, scale=1.0, shape=(), ctx=None, dtype="float32",
            out=None):
    return _draw(lambda s, g, d: loc + scale * torch.randn(
        s, generator=g, device=d, dtype=dtype_torch(dtype)),
        shape, ctx, dtype, out)


def _randint(low=0, high=2, shape=(), ctx=None, dtype="int32", out=None):
    return _draw(lambda s, g, d: torch.randint(
        low, high, s, generator=g, device=d, dtype=dtype_torch(dtype)),
        shape, ctx, dtype, out)


def _bernoulli(p=0.5, shape=(), ctx=None, dtype="float32", out=None):
    """1 with probability ``p``, else 0, in ``dtype``."""
    return _draw(lambda s, g, d: (torch.rand(s, generator=g, device=d)
                                  < p).to(dtype_torch(dtype)),
                 shape, ctx, dtype, out)


def _exponential(scale=1.0, shape=(), ctx=None, dtype="float32", out=None):
    """Exponential draws of mean ``scale``."""
    return _draw(lambda s, g, d: (scale * _ro._exponential(s, d, g))
                 .to(dtype_torch(dtype)), shape, ctx, dtype, out)


def _gamma(alpha=1.0, beta=1.0, shape=(), ctx=None, dtype="float32",
           out=None):
    """Gamma draws of shape ``alpha`` and scale ``beta``."""
    return _draw(lambda s, g, d: (beta * _ro._gamma(
        torch.full(s, float(alpha), device=d), d, g)).to(dtype_torch(dtype)),
        shape, ctx, dtype, out)


def _poisson(lam=1.0, shape=(), ctx=None, dtype="float32", out=None):
    """Poisson counts of rate ``lam``, in ``dtype``."""
    return _draw(lambda s, g, d: _ro._poisson(
        torch.full(s, float(lam), device=d), d, g).to(dtype_torch(dtype)),
        shape, ctx, dtype, out)


def _randn(*shape, **kwargs):
    return _normal(shape=shape, **kwargs)


def _multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """The registry's ``_sample_multinomial``: ``shape=None`` squeezes
    the draw axis, an explicit ``shape=1`` keeps it."""
    return invoke("_sample_multinomial", data, shape=shape,
                  get_prob=get_prob, dtype=dtype)


def _shuffle(data):
    """The registry's ``_shuffle``: ``data`` permuted along axis 0."""
    return invoke("_shuffle", data)


random.uniform = _uniform
random.normal = _normal
random.randn = _randn
random.randint = _randint
random.bernoulli = _bernoulli
random.exponential = _exponential
random.gamma = _gamma
random.poisson = _poisson
random.multinomial = _multinomial
random.shuffle = _shuffle
random.seed = _random.seed
sys.modules[random.__name__] = random


def Custom(*inputs, op_type, **kwargs):
    """Run a registered custom operator (ref: mx.nd.Custom ->
    src/operator/custom/custom.cc; see ``operator``)."""
    from ..operator import invoke_custom
    return invoke_custom(*inputs, op_type=op_type, **kwargs)
