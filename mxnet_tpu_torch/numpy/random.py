"""``mx.np.random`` (the port of ``mxnet_tpu/numpy/random.py``; ref:
python/mxnet/numpy/random.py): numpy-style sampling from the port's
seeded per-device generators (``random.generator``), on the current
context.

The draws are not the JAX package's (its threefry keys; ROADMAP,
"Deliberate divergences"): they hold by shape, dtype, support and
moments.  The parameterisations are the JAX package's:
``gamma(shape, scale)``, ``exponential(scale)``, and ``choice``'s
``p`` and ``replace``."""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import dtype_torch
from ..context import current_context

__all__ = ["seed", "uniform", "normal", "randn", "rand", "randint",
           "choice", "shuffle", "permutation", "beta", "gamma",
           "exponential", "multinomial"]


def seed(s):
    _random.seed(s)


def _dev(ctx=None):
    if ctx is None:
        return current_context().device
    from ..context import resolve_device
    return resolve_device(ctx)


def _gen(dev):
    return _random.generator(dev)


def _wrap(t):
    from . import _wrap as wrap
    return wrap(t)


def _shape(size):
    if size is None:
        return ()
    return (size,) if isinstance(size, int) else tuple(size)


def _tensor(x, dev):
    from ..ndarray.ndarray import NDArray
    if isinstance(x, NDArray):
        return x._data
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def uniform(low=0.0, high=1.0, size=None, dtype="float32", ctx=None):
    dev = _dev(ctx)
    u = torch.rand(_shape(size), generator=_gen(dev), device=dev,
                   dtype=dtype_torch(dtype))
    return _wrap(u * (high - low) + low)


def normal(loc=0.0, scale=1.0, size=None, dtype="float32", ctx=None):
    dev = _dev(ctx)
    z = torch.randn(_shape(size), generator=_gen(dev), device=dev,
                    dtype=dtype_torch(dtype))
    return _wrap(z * scale + loc)


def randn(*shape):
    return normal(size=shape or None)


def rand(*shape):
    return uniform(size=shape or None)


def randint(low, high=None, size=None, dtype="int32", ctx=None):
    if high is None:
        low, high = 0, low
    dev = _dev(ctx)
    return _wrap(torch.randint(low, high, _shape(size), generator=_gen(dev),
                               device=dev, dtype=dtype_torch(dtype)))


def choice(a, size=None, replace=True, p=None, ctx=None):
    from ..ndarray.ndarray import NDArray
    dev = _dev(ctx)
    arr = a._data if isinstance(a, NDArray) else torch.as_tensor(a)
    if arr.dim() == 0:
        arr = torch.arange(int(arr), device=dev)
    arr = arr.to(dev)
    n = arr.shape[0]
    shape = _shape(size)
    k = 1
    for s in shape:
        k *= s
    gen = _gen(dev)
    if p is None and not replace:
        idx = torch.randperm(n, generator=gen, device=dev)[:k]
    elif p is None:
        idx = torch.randint(0, n, (k,), generator=gen, device=dev)
    else:
        probs = _tensor(p, dev).to(torch.float32)
        idx = torch.multinomial(probs, k, replacement=replace,
                                generator=gen)
    return _wrap(arr[idx].reshape(shape + tuple(arr.shape[1:])))


def permutation(x):
    from ..ndarray.ndarray import NDArray
    dev = _dev()
    if isinstance(x, int):
        return _wrap(torch.randperm(x, generator=_gen(dev), device=dev))
    t = x._data if isinstance(x, NDArray) else torch.as_tensor(x)
    perm = torch.randperm(t.shape[0], generator=_gen(t.device),
                          device=t.device)
    return _wrap(t[perm])


def shuffle(x):
    """In place along axis 0 (numpy's semantics): ``x`` gets the
    shuffled tensor."""
    t = x._data
    perm = torch.randperm(t.shape[0], generator=_gen(t.device),
                          device=t.device)
    x._rebind(t.detach()[perm])


def _std_gamma(alpha, shape, dev):
    a = _tensor(alpha, dev).to(torch.float32)
    a = torch.broadcast_to(a, shape if shape else a.shape).contiguous()
    return torch._standard_gamma(a, generator=_gen(dev))


def beta(a, b, size=None, dtype="float32", ctx=None):
    dev = _dev(ctx)
    shape = _shape(size)
    x = _std_gamma(a, shape, dev)
    y = _std_gamma(b, shape, dev)
    return _wrap((x / (x + y)).to(dtype_torch(dtype)))


def gamma(shape, scale=1.0, size=None, dtype="float32", ctx=None):
    dev = _dev(ctx)
    g = _std_gamma(shape, _shape(size), dev)
    return _wrap((g * scale).to(dtype_torch(dtype)))


def exponential(scale=1.0, size=None, dtype="float32", ctx=None):
    dev = _dev(ctx)
    e = torch.empty(_shape(size), device=dev).exponential_(
        1.0, generator=_gen(dev))
    return _wrap((e * scale).to(dtype_torch(dtype)))


def multinomial(n, pvals, size=None):
    dev = _dev()
    pv = _tensor(pvals, dev).to(torch.float32)
    shape = _shape(size)
    k = 1
    for s in shape:
        k *= s
    draws = torch.multinomial(pv.expand(k, -1), n, replacement=True,
                              generator=_gen(pv.device))
    counts = torch.zeros(k, pv.shape[-1], dtype=torch.int32,
                         device=pv.device)
    counts.scatter_add_(1, draws, torch.ones_like(draws, dtype=torch.int32))
    return _wrap(counts.reshape(shape + (pv.shape[-1],)))
