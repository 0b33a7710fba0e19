"""``mx.np`` — the numpy-semantics frontend (the port of
``mxnet_tpu/numpy/__init__.py``; ref: python/mxnet/numpy/multiarray.py).

``mx.np.ndarray`` subclasses the port's ``NDArray`` (the same tensor,
autograd and context machinery) with numpy's surface.  The module's
functions are one table, ``_IMPL``, from each numpy name to a torch
body with numpy's semantics where torch's function of the same name
means something else: ``std``/``var`` with ``ddof=0``, ``median`` the
mean of the two middle values, ``split`` by sections or indices,
``take`` flattening when ``axis`` is None, ``repeat`` as
``repeat_interleave``, ``mod`` following the divisor's sign and
``fmod`` the dividend's, the ``nan*`` reductions torch lacks.  Dtypes
are the JAX package's, which runs without 64-bit types: an index
result (``argmax``, ``argsort``, ``nonzero``, ``unique``,
``searchsorted``, ``bincount``...) is int32 and a float result
float32.

Torch's autograd is the tape: inside ``autograd.record()`` a body
builds torch's graph like any op; outside it the body runs with
gradients off.  The data-dependent names (``nonzero``, ``unique``,
``argwhere``, ``flatnonzero``, ``extract``...) read sizes on the host
and raise inside a captured graph, as ``jnp`` raises under ``jit``.

The names are exactly the JAX package's: its delegation lists less
what its ``jax.numpy`` lacks (``may_share_memory``, ``shares_memory``,
``ascontiguousarray``).  Use with ``mx.npx.set_np()``, which makes
Gluon blocks hand out ``mx.np`` arrays, or call the functions directly.
"""
from __future__ import annotations

import builtins
import math
import sys
import threading

import numpy as _onp
import torch
import torch.nn.functional as _F

from .. import autograd as _autograd
from ..base import dtype_np, dtype_torch
from ..context import current_context
from ..ndarray.ndarray import (NDArray, _NARROW, _wrap as _nd_wrap,
                               as_tensor, invoke,  # noqa: F401
                               tensor_from_numpy)

pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
newaxis = None

float16 = _onp.float16
float32 = _onp.float32
float64 = _onp.float64
int8 = _onp.int8
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
bool_ = _onp.bool_
try:
    import ml_dtypes as _ml_dtypes
    bfloat16 = _ml_dtypes.bfloat16
except ImportError:        # the dtype rules take torch's as well
    bfloat16 = torch.bfloat16


class ndarray(NDArray):
    """``mx.np.ndarray``: the port's NDArray with numpy's surface
    (``.T``, ``item()``, ``tolist()``, numpy-signature reductions).
    Layout-compatible with NDArray, so ``npx.set_np`` retypes parameter
    arrays in place (the autograd hooks hold the object)."""

    __slots__ = ()

    def item(self):
        if self.size != 1:
            raise ValueError("can only convert an array of size 1 to a "
                             "Python scalar")
        return self._data.detach().reshape(()).item()

    def tolist(self):
        return self.asnumpy().tolist()

    def as_nd_ndarray(self):
        """Back to the legacy frontend type."""
        return NDArray(self._data)

    def mean(self, axis=None, dtype=None, keepdims=False):
        return mean(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def sum(self, axis=None, dtype=None, keepdims=False):
        return sum(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def std(self, axis=None, keepdims=False):
        return std(self, axis=axis, keepdims=keepdims)

    def var(self, axis=None, keepdims=False):
        return var(self, axis=axis, keepdims=keepdims)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return NDArray.transpose(self, axes or None)

    def copy(self):
        return type(self)(self._data.detach().clone())

    def __repr__(self):
        return repr(self.asnumpy())


# ------------------------------------------------------------- plumbing ---
_tls = threading.local()


def _dev():
    """The device of the call's first array, else the current context's."""
    dev = getattr(_tls, "device", None)
    return dev if dev is not None else current_context().device


def _wrap(t):
    """``t`` as an ``mx.np.ndarray``, 64-bit dtypes narrowed."""
    return _nd_wrap(t, ndarray)


def _unwrap(x):
    return x._data if isinstance(x, NDArray) else x


def _wrap_out(out):
    if isinstance(out, torch.Tensor):
        return _wrap(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap_out(o) for o in out)
    return out


def _t(x, dtype=None):
    """An array argument as a tensor on the call's device (numpy arrays,
    lists and scalars by numpy's rules, 64-bit types narrowed)."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    if isinstance(x, (list, tuple)) and any(
            isinstance(v, (NDArray, torch.Tensor)) for v in x):
        return torch.stack([_t(v) for v in x]) if dtype is None else \
            torch.stack([_t(v) for v in x]).to(dtype)
    t = tensor_from_numpy(_onp.asarray(x)).to(_dev())
    return t if dtype is None else t.to(dtype)


def _pair(a, b):
    """Two operands as tensors; a Python scalar takes the other's kind
    (numpy's weak scalars)."""
    if not isinstance(a, (torch.Tensor, NDArray)) and _onp.isscalar(a) \
            and isinstance(b, (torch.Tensor, NDArray)):
        b = _t(b)
        return _scalar_like(a, b), b
    if not isinstance(b, (torch.Tensor, NDArray)) and _onp.isscalar(b) \
            and isinstance(a, (torch.Tensor, NDArray)):
        a = _t(a)
        return a, _scalar_like(b, a)
    return _t(a), _t(b)


def _scalar_like(s, t):
    """Python scalar ``s`` as a 0-d tensor that does not widen ``t``."""
    if isinstance(s, builtins.bool):
        return torch.tensor(s, device=t.device)
    if isinstance(s, builtins.int) and not t.is_floating_point() \
            and t.dtype != torch.bool:
        return torch.tensor(s, dtype=t.dtype, device=t.device)
    if t.is_floating_point():
        return torch.tensor(s, dtype=t.dtype, device=t.device)
    return torch.tensor(s, dtype=torch.float32, device=t.device)


def _float(t):
    """Integer and bool tensors as float32 (jnp's promotion for means,
    roots and transcendental functions)."""
    return t if t.is_floating_point() or t.is_complex() else \
        t.to(torch.float32)


def _dims(a, axis):
    if axis is None:
        return tuple(range(a.dim()))
    if isinstance(axis, (tuple, list)):
        return tuple(sorted(d % builtins.max(a.dim(), 1) for d in axis))
    return (axis % builtins.max(a.dim(), 1),)


def _over(a, axis, keepdims, fn):
    """Reduce ``a`` over ``axis`` (None: all) with ``fn``, which reduces
    the last dimension of its argument."""
    dims = _dims(a, axis) if a.dim() else ()
    keep = [d for d in range(a.dim()) if d not in dims]
    x = a.permute(keep + list(dims)).reshape(
        [a.shape[d] for d in keep] + [-1])
    out = fn(x)
    if keepdims:
        out = out.reshape([1 if d in dims else a.shape[d]
                           for d in range(a.dim())])
    return out


def _axis_flat(a, axis):
    """``(a, axis)`` with ``a`` flattened when ``axis`` is None."""
    return (a.reshape(-1), 0) if axis is None else (a, axis)


def _check_concrete(name):
    """Data-dependent sizes are read on the host: not inside a graph."""
    from ..parallel.functional import check_concrete
    check_concrete(
        f"np.{name} has a data-dependent output size, read on the host: "
        f"it cannot run inside a captured graph or a hybridized body "
        f"(keep it outside, as jnp under jit)")


def _index_dtype(t):
    return t.to(torch.int32)


# ---------------------------------------------------------------- factory --
def array(object, dtype=None, ctx=None):
    """A new array, never sharing memory with ``object``: ``nd.array``'s
    dtype rules (lists and scalars float32 unless ``dtype`` says, 64-bit
    types narrowed), as in the JAX package."""
    dev = current_context().device if ctx is None else _ctx_device(ctx)
    return _wrap(as_tensor(object, dtype, dev))


def _ctx_device(ctx):
    from ..context import resolve_device
    return resolve_device(ctx)


def _creation_device(ctx):
    return current_context().device if ctx is None else _ctx_device(ctx)


def _shape(shape):
    return (shape,) if isinstance(shape, builtins.int) else tuple(shape)


def zeros(shape, dtype="float32", ctx=None):
    return _wrap(torch.zeros(_shape(shape), dtype=dtype_torch(dtype),
                             device=_creation_device(ctx)))


def ones(shape, dtype="float32", ctx=None):
    return _wrap(torch.ones(_shape(shape), dtype=dtype_torch(dtype),
                            device=_creation_device(ctx)))


def full(shape, fill_value, dtype=None, ctx=None):
    dev = _creation_device(ctx)
    if isinstance(fill_value, (NDArray, torch.Tensor)):
        v = _t(fill_value)
        return _wrap(torch.broadcast_to(v, _shape(shape)).to(
            dtype_torch(dtype) if dtype else v.dtype).clone().to(dev))
    t = torch.full(_shape(shape), fill_value, device=dev)
    return _wrap(t if dtype is None else t.to(dtype_torch(dtype)))


def empty(shape, dtype="float32", ctx=None):
    return zeros(shape, dtype, ctx)


def _like(a, dtype, fill):
    t = _t(a)
    dt = dtype_torch(dtype) if dtype is not None else t.dtype
    return _wrap(torch.full(t.shape, fill, dtype=dt, device=t.device))


def zeros_like(a, dtype=None):
    return _like(a, dtype, 0)


def ones_like(a, dtype=None):
    return _like(a, dtype, 1)


def full_like(a, fill_value, dtype=None):
    return _like(a, dtype, fill_value)


def arange(start, stop=None, step=1, dtype=None, ctx=None):
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, device=_creation_device(ctx))
    return _wrap(t if dtype is None else t.to(dtype_torch(dtype)))


def linspace(start, stop, num=50, endpoint=True, dtype=None, ctx=None):
    dev = _creation_device(ctx)
    if endpoint:
        t = torch.linspace(start, stop, num, dtype=torch.float64)
    else:
        t = torch.linspace(start, stop, num + 1, dtype=torch.float64)[:num]
    t = t.to(dtype_torch(dtype) if dtype else torch.float32)
    return _wrap(t.to(dev))


def eye(N, M=None, k=0, dtype="float32", ctx=None):
    t = torch.ones(N, N if M is None else M, dtype=dtype_torch(dtype),
                   device=_creation_device(ctx))
    return _wrap(torch.triu(torch.tril(t, k), k))


def identity(n, dtype="float32", ctx=None):
    return eye(n, dtype=dtype, ctx=ctx)


# ----------------------------------------------------- elementwise bodies --
def _unary(fn, to_float=False):
    def body(x, *args, **kwargs):
        x = _t(x)
        return fn(_float(x) if to_float else x)
    return body


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _round(a, decimals=0, out=None):
    a = _t(a)
    if not a.is_floating_point():
        return a.clone()
    return torch.round(a, decimals=decimals)


def _binary(fn, to_float=False):
    def body(x1, x2, *args, **kwargs):
        a, b = _pair(x1, x2)
        if to_float:
            a, b = _float(a), _float(b)
        return fn(a, b)
    return body


def _true_divide(a, b):
    if not (a.is_floating_point() or b.is_floating_point()):
        a, b = _float(a), _float(b)
    return torch.true_divide(a, b)


def _floor_divide(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _power(a, b):
    return torch.pow(a, b)


def _logaddexp(a, b):
    return torch.logaddexp(a, b)


def _lcm(a, b):
    return torch.lcm(a, b)


def _bool_op(fn):
    def body(a, b):
        return fn(a.bool() if a.dtype != torch.bool else a,
                  b.bool() if b.dtype != torch.bool else b)
    return body


# ----------------------------------------------------------- shape bodies --
def _reshape(a, newshape=None, order="C", *, shape=None):
    s = shape if shape is not None else newshape
    return _t(a).reshape(_shape(s))


def _expand_dims(a, axis):
    a = _t(a)
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    nd = a.dim() + len(axes)
    for ax in sorted(x % nd for x in axes):
        a = a.unsqueeze(ax)
    return a


def _squeeze(a, axis=None):
    a = _t(a)
    if axis is None:
        return a.squeeze()
    axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    for ax in axes:
        if a.shape[ax] != 1:
            raise ValueError(f"cannot select an axis to squeeze out which "
                             f"has size not equal to one (axis {ax})")
    return a.squeeze(axes)


def _flip(m, axis=None):
    m = _t(m)
    dims = tuple(range(m.dim())) if axis is None else (
        tuple(axis) if isinstance(axis, (tuple, list)) else (axis,))
    return torch.flip(m, dims)


def _roll(a, shift, axis=None):
    a = _t(a)
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, axis)


def _tile(A, reps):
    return torch.tile(_t(A), (reps,) if isinstance(reps, builtins.int)
                      else tuple(reps))


def _repeat(a, repeats, axis=None):
    a = _t(a)
    if isinstance(repeats, (NDArray, torch.Tensor, list, tuple,
                            _onp.ndarray)):
        repeats = _t(repeats).long()
    if axis is None:
        return torch.repeat_interleave(a.reshape(-1), repeats)
    return torch.repeat_interleave(a, repeats, dim=axis)


def _atleast(fn):
    def body(*arys):
        outs = [fn(_t(a)) for a in arys]
        return outs[0] if len(outs) == 1 else outs
    return body


def _transpose(a, axes=None):
    a = _t(a)
    if axes is None:
        axes = tuple(reversed(range(a.dim())))
    return a.permute(tuple(axes))


def _moveaxis(a, source, destination):
    return torch.movedim(_t(a), source, destination)


def _swapaxes(a, axis1, axis2):
    return torch.swapaxes(_t(a), axis1, axis2)


def _broadcast_to(array, shape):
    return torch.broadcast_to(_t(array), _shape(shape))


def _ravel(a, order="C"):
    return _t(a).reshape(-1)


def _rot90(m, k=1, axes=(0, 1)):
    return torch.rot90(_t(m), k, list(axes))


# ------------------------------------------------------------ other bodies --
def _where(condition, x=None, y=None):
    c = _t(condition)
    if x is None and y is None:
        return _nonzero(c)
    x, y = _pair(x, y)
    return torch.where(c.bool(), x, y)


def _clip(a, a_min=None, a_max=None, *, min=None, max=None):
    a = _t(a)
    lo = a_min if a_min is not None else min
    hi = a_max if a_max is not None else max
    out = a
    if lo is not None:
        out = torch.maximum(out, _scalar_like(lo, a) if _onp.isscalar(lo)
                            else _t(lo))
    if hi is not None:
        out = torch.minimum(out, _scalar_like(hi, a) if _onp.isscalar(hi)
                            else _t(hi))
    return out


def _tril(m, k=0):
    return torch.tril(_t(m), k)


def _triu(m, k=0):
    return torch.triu(_t(m), k)


def _diag(v, k=0):
    return torch.diag(_t(v), k)


def _trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    d = torch.diagonal(_t(a), offset, axis1, axis2)
    return d.sum(-1) if dtype is None else d.sum(-1).to(dtype_torch(dtype))


def _sort(a, axis=-1, kind=None, order=None, *, stable=True,
          descending=False):
    a, axis = _axis_flat(_t(a), axis)
    return torch.sort(a, dim=axis, stable=True, descending=descending).values


def _argsort(a, axis=-1, kind=None, order=None, *, stable=True,
             descending=False):
    a, axis = _axis_flat(_t(a), axis)
    return _index_dtype(torch.argsort(a, dim=axis, stable=True,
                                      descending=descending))


def _searchsorted(a, v, side="left", sorter=None, *, method=None):
    a = _t(a)
    if sorter is not None:
        a = a[_t(sorter).long()]
    v = _t(v).to(a.dtype)
    return _index_dtype(torch.searchsorted(a.contiguous(), v.contiguous(),
                                           side=side))


def _first_index(inverse, n):
    """The first position of each unique value (``unique``'s
    ``return_index``)."""
    pos = torch.arange(inverse.numel(), device=inverse.device)
    first = torch.full((n,), inverse.numel(), dtype=pos.dtype,
                       device=inverse.device)
    return first.scatter_reduce(0, inverse.reshape(-1), pos, "amin")


def _unique(ar, return_index=False, return_inverse=False,
            return_counts=False, axis=None, *, equal_nan=True, size=None,
            fill_value=None, sorted=True):
    _check_concrete("unique")
    a = _t(ar)
    if axis is None:
        a = a.reshape(-1)
        vals, inv, counts = torch.unique(a, sorted=True, return_inverse=True,
                                         return_counts=True)
    else:
        vals, inv, counts = torch.unique(a, sorted=True, return_inverse=True,
                                         return_counts=True, dim=axis)
    outs = [vals]
    if return_index:
        outs.append(_index_dtype(_first_index(inv, vals.shape[
            0 if axis is None else axis])))
    if return_inverse:
        outs.append(_index_dtype(inv.reshape(_t(ar).shape) if axis is None
                                 else inv))
    if return_counts:
        outs.append(_index_dtype(counts))
    return outs[0] if len(outs) == 1 else tuple(outs)


def _cum(fn, nan_to=None):
    def body(a, axis=None, dtype=None, out=None):
        a, axis = _axis_flat(_t(a), axis)
        if nan_to is not None and a.is_floating_point():
            a = torch.where(torch.isnan(a), torch.full_like(a, nan_to), a)
        if dtype is not None:
            a = a.to(dtype_torch(dtype))
        elif a.dtype == torch.bool:
            a = a.to(torch.int32)
        out = fn(a, dim=axis)
        return out if a.dtype != torch.int32 and dtype is None \
            else out.to(a.dtype)
    return body


def _diff(a, n=1, axis=-1, prepend=None, append=None):
    a = _t(a)
    kw = {}
    if prepend is not None:
        p = _t(prepend).to(a.dtype)
        if p.dim() == 0:
            shape = list(a.shape)
            shape[axis] = 1
            p = p.expand(shape)
        kw["prepend"] = p
    if append is not None:
        q = _t(append).to(a.dtype)
        if q.dim() == 0:
            shape = list(a.shape)
            shape[axis] = 1
            q = q.expand(shape)
        kw["append"] = q
    if a.dtype == torch.bool:
        out = a
        for _ in range(n):
            out = torch.diff(out, dim=axis, **kw)
            kw = {}
        return out
    return torch.diff(a, n=n, dim=axis, **kw)


def _ediff1d(ary, to_end=None, to_begin=None):
    a = _t(ary).reshape(-1)
    parts = [a[1:] - a[:-1]]
    if to_begin is not None:
        parts.insert(0, _t(to_begin).reshape(-1).to(a.dtype))
    if to_end is not None:
        parts.append(_t(to_end).reshape(-1).to(a.dtype))
    return torch.cat(parts)


def _nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    x = _t(x)
    if not x.is_floating_point():
        return x.clone()
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def _real(val):
    v = _t(val)
    return v.real if v.is_complex() else v


def _imag(val):
    v = _t(val)
    return v.imag if v.is_complex() else torch.zeros_like(v)


def _interp(x, xp, fp, left=None, right=None, period=None):
    x, xp, fp = _float(_t(x)), _float(_t(xp)), _float(_t(fp))
    xp, fp = xp.to(x.dtype), fp.to(x.dtype)
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       side="right"), 1, xp.numel() - 1)
    x0, x1, y0, y1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    w = torch.where(dx == 0, torch.zeros_like(dx), (x - x0) / dx)
    out = y0 + w * (y1 - y0)
    lo = fp[0] if left is None else torch.tensor(left, dtype=out.dtype,
                                                 device=out.device)
    hi = fp[-1] if right is None else torch.tensor(right, dtype=out.dtype,
                                                   device=out.device)
    out = torch.where(x < xp[0], lo, out)
    return torch.where(x > xp[-1], hi, out)


def _norm_index(idx, n):
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


def _take(a, indices, axis=None, out=None, mode=None, *, unique_indices=False,
          indices_are_sorted=False, fill_value=None):
    a, axis = _axis_flat(_t(a), axis)
    axis %= a.dim()
    idx = _t(indices)
    n = a.shape[axis]
    flat = _norm_index(idx.reshape(-1), n)
    if mode == "clip":
        flat = flat.clamp(0, n - 1)
    elif mode == "wrap":
        flat = flat % n
    out = torch.index_select(a, axis, flat)
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def _take_along_axis(arr, indices, axis, mode=None, fill_value=None):
    arr = _t(arr)
    idx = _t(indices)
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    return torch.take_along_dim(arr, _norm_index(idx, arr.shape[axis]),
                                dim=axis)


def _nonzero(a, *, size=None, fill_value=None):
    _check_concrete("nonzero")
    a = _t(a)
    if a.dim() == 0:
        a = a.reshape(1)
    return tuple(_index_dtype(i) for i in torch.nonzero(a, as_tuple=True))


def _count_nonzero(a, axis=None, keepdims=False):
    a = _t(a)
    return _index_dtype(_over(a != 0, axis, keepdims,
                              lambda x: x.sum(-1)))


def _isclose_t(a, b, rtol, atol, equal_nan):
    a, b = _pair(a, b)
    if not a.is_floating_point():
        a = _float(a)
    if not b.is_floating_point():
        b = _float(b)
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.isclose(a.to(dt), b.to(dt), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def _isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _isclose_t(a, b, rtol, atol, equal_nan)


def _allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _isclose_t(a, b, rtol, atol, equal_nan).all()


def _array_equal(a1, a2, equal_nan=False):
    a, b = _t(a1), _t(a2)
    if a.shape != b.shape:
        return torch.tensor(False, device=a.device)
    eq = a == b
    if equal_nan and a.is_floating_point():
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    return eq.all()


def _histogram(a, bins=10, range=None, weights=None, density=None):
    a = _float(_t(a)).reshape(-1)
    if isinstance(bins, builtins.int):
        lo, hi = (a.min(), a.max()) if range is None else \
            (torch.tensor(range[0], dtype=a.dtype, device=a.device),
             torch.tensor(range[1], dtype=a.dtype, device=a.device))
        hi = torch.where(hi == lo, hi + 0.5, hi)
        lo = torch.where(hi - 0.5 == lo, lo - 0.5, lo) if range is None \
            else lo
        edges = lo + (hi - lo) * torch.linspace(0, 1, bins + 1,
                                                device=a.device)
    else:
        edges = _float(_t(bins)).to(a.dtype)
    nb = edges.numel() - 1
    idx = torch.searchsorted(edges.contiguous(), a, side="right") - 1
    idx = torch.where(a == edges[-1], torch.full_like(idx, nb - 1), idx)
    inside = (idx >= 0) & (idx < nb)
    w = torch.ones_like(a) if weights is None else \
        _float(_t(weights)).reshape(-1).to(a.dtype)
    counts = torch.zeros(nb, dtype=a.dtype, device=a.device).index_add_(
        0, idx.clamp(0, nb - 1), torch.where(inside, w, torch.zeros_like(w)))
    if density:
        counts = counts / (counts.sum() * torch.diff(edges))
    return counts, edges


def _bincount(x, weights=None, minlength=0, *, length=None):
    x = _t(x).long()
    n = length if length is not None else builtins.max(
        minlength, int(x.max()) + 1 if x.numel() else 0)
    if weights is None:
        out = torch.zeros(n, dtype=torch.int64, device=x.device)
        out.index_add_(0, x.clamp(0, n - 1), torch.ones_like(x))
        return _index_dtype(out)
    w = _t(weights)
    w = _float(w)
    return torch.zeros(n, dtype=w.dtype, device=x.device).index_add_(
        0, x.clamp(0, n - 1), w)


def _pad_pairs(pad_width, ndim):
    pw = _onp.asarray(pad_width, dtype=_onp.int64)
    return _onp.broadcast_to(pw, (ndim, 2)) if pw.ndim < 2 or \
        pw.shape[0] == 1 else pw


def _pad(array, pad_width, mode="constant", constant_values=0, **kwargs):
    a = _t(array)
    pairs = _pad_pairs(pad_width, a.dim())
    if mode == "constant":
        flat = []
        for lo, hi in reversed(pairs.tolist()):
            flat += [lo, hi]
        return _F.pad(a, flat, value=float(constant_values)
                      if a.is_floating_point() else int(constant_values))
    if mode not in ("edge", "reflect", "symmetric", "wrap"):
        raise NotImplementedError(f"np.pad mode {mode!r}")
    for ax, (lo, hi) in enumerate(pairs.tolist()):
        if lo or hi:
            idx = _onp.pad(_onp.arange(a.shape[ax]), (lo, hi), mode=mode)
            a = torch.index_select(a, ax, torch.as_tensor(idx,
                                                          device=a.device))
    return a


def _insert(arr, obj, values, axis=None):
    a, axis = _axis_flat(_t(arr), axis)
    axis %= a.dim()
    n = a.shape[axis]
    scalar = isinstance(obj, (builtins.int, _onp.integer))
    pos = _onp.insert(_onp.arange(n), obj, -1)
    k = int((pos == -1).sum())
    v = _t(values).to(a.dtype)
    if scalar and v.dim() > 0:
        v = v.reshape((1,) * (a.dim() - v.dim()) + tuple(v.shape))
        v = torch.movedim(v, 0, axis)
    shape = list(a.shape)
    shape[axis] = k if not scalar or v.dim() == 0 else v.shape[axis]
    if scalar and v.dim() > 0 and v.shape[axis] != 1:
        pos = _onp.insert(_onp.arange(n), [obj] * v.shape[axis], -1)
    v = torch.broadcast_to(v, shape)
    src = torch.as_tensor(_onp.where(pos < 0, 0, pos), device=a.device)
    out = torch.index_select(a, axis, src)
    slots = torch.as_tensor(_onp.nonzero(pos < 0)[0], device=a.device)
    return out.index_copy(axis, slots, v)


def _delete(arr, obj, axis=None):
    a, axis = _axis_flat(_t(arr), axis)
    keep = _onp.ones(a.shape[axis], bool)
    if isinstance(obj, (NDArray, torch.Tensor)):
        obj = _t(obj).cpu().numpy()
    keep[_onp.asarray(obj)] = False
    return torch.index_select(a, axis, torch.as_tensor(
        _onp.nonzero(keep)[0], device=a.device))


def _flatnonzero(a, *, size=None, fill_value=None):
    _check_concrete("flatnonzero")
    return _index_dtype(torch.nonzero(_t(a).reshape(-1)).reshape(-1))


def _tensordot(a, b, axes=2):
    a, b = _t(a), _t(b)
    if isinstance(axes, (list, tuple)):
        axes = tuple(tuple(x) if isinstance(x, (list, tuple)) else (x,)
                     for x in axes)
    return torch.tensordot(a, b, dims=axes)


def _dot(a, b):
    a, b = _pair(a, b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() == 1 or a.dim() == 1 and b.dim() == 1:
        return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))


def _inner(a, b):
    a, b = _pair(a, b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 1]))


def _outer(a, b, out=None):
    a, b = _pair(a, b)
    return torch.outer(a.reshape(-1), b.reshape(-1))


def _vdot(a, b):
    a, b = _pair(a, b)
    return (a.reshape(-1).conj() * b.reshape(-1)).sum()


def _cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    a, b = _pair(a, b)
    if axis is not None:
        axisa = axisb = axisc = axis
    a, b = torch.movedim(a, axisa, -1), torch.movedim(b, axisb, -1)
    a, b = torch.broadcast_tensors(a, b)
    return torch.movedim(torch.linalg.cross(a, b, dim=-1), -1, axisc) \
        if a.shape[-1] == 3 else a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _einsum(subscripts, *operands, **kwargs):
    return torch.einsum(subscripts, *[_t(o) for o in operands])


def _average(a, axis=None, weights=None, returned=False, keepdims=False):
    a = _float(_t(a))
    if weights is None:
        avg = _over(a, axis, keepdims, lambda x: x.mean(-1))
        if returned:
            cnt = a.numel() / builtins.max(avg.numel(), 1)
            return avg, torch.full_like(avg, cnt)
        return avg
    w = _float(_t(weights)).to(a.dtype)
    if w.shape != a.shape:
        shape = [1] * a.dim()
        shape[axis] = -1
        w = torch.broadcast_to(w.reshape(shape), a.shape)
    scl = _over(w, axis, keepdims, lambda x: x.sum(-1))
    avg = _over(a * w, axis, keepdims, lambda x: x.sum(-1)) / scl
    return (avg, scl) if returned else avg


# ---------------------------------------------------------- reductions ----
def _reduce(fn, *, to_float=False):
    def body(a, axis=None, dtype=None, out=None, keepdims=False,
             initial=None, where=None):
        a = _t(a)
        if dtype is not None:
            a = a.to(dtype_torch(dtype))
        elif to_float:
            a = _float(a)
        res = _over(a, axis, keepdims, fn)
        if initial is not None:
            res = fn(torch.stack([res, torch.full_like(res, initial)], -1))
        return res
    return body


def _moment(ddof_default=0, nan=False, root=False):
    def body(a, axis=None, dtype=None, out=None, ddof=ddof_default,
             keepdims=False, *, where=None, correction=None):
        a = _float(_t(a))
        if dtype is not None:
            a = a.to(dtype_torch(dtype))
        if correction is not None:
            ddof = correction

        def fn(x):
            if nan:
                mask = ~torch.isnan(x)
                n = mask.sum(-1, keepdim=True).to(x.dtype)
                xs = torch.where(mask, x, torch.zeros_like(x))
                mu = xs.sum(-1, keepdim=True) / n
                sq = torch.where(mask, (x - mu) ** 2, torch.zeros_like(x))
                v = sq.sum(-1) / (n.squeeze(-1) - ddof)
            else:
                v = torch.var(x, dim=-1, correction=ddof)
            return torch.sqrt(v) if root else v
        return _over(a, axis, keepdims, fn)
    return body


def _arg(fn, nan_fill=None):
    def body(a, axis=None, out=None, keepdims=False):
        a = _t(a)
        if nan_fill is not None and a.is_floating_point():
            a = torch.where(torch.isnan(a), torch.full_like(a, nan_fill), a)
        if a.dtype == torch.bool:
            a = a.to(torch.int32)
        if axis is None:
            res = fn(a.reshape(-1), dim=0)
            if keepdims:
                res = res.reshape([1] * a.dim())
        else:
            res = fn(a, dim=axis, keepdim=keepdims)
        return _index_dtype(res)
    return body


def _nan_extreme(fn, fill):
    def body(a, axis=None, out=None, keepdims=False, initial=None,
             where=None):
        a = _t(a)
        if not a.is_floating_point():
            return _over(a, axis, keepdims, lambda x: fn(x, -1))

        def red(x):
            nanv = torch.isnan(x)
            m = fn(torch.where(nanv, torch.full_like(x, fill), x), -1)
            return torch.where(nanv.all(-1), torch.full_like(m, math.nan), m)
        return _over(a, axis, keepdims, red)
    return body


def _quantile_body(scale):
    def body(a, q, axis=None, out=None, overwrite_input=False,
             method="linear", keepdims=False, *, interpolation=None):
        a = _float(_t(a))
        qt = _float(_t(q)).to(a.dtype) / scale
        how = interpolation or method
        res = _over(a, axis, keepdims,
                    lambda x: torch.quantile(x, qt, dim=-1,
                                             interpolation=how))
        return res
    return body


def _median(a, axis=None, out=None, overwrite_input=False, keepdims=False):
    a = _float(_t(a))
    return _over(a, axis, keepdims,
                 lambda x: torch.quantile(x, 0.5, dim=-1))


def _ptp(a, axis=None, out=None, keepdims=False):
    a = _t(a)
    return _over(a, axis, keepdims,
                 lambda x: torch.amax(x, -1) - torch.amin(x, -1))


def _nanprod(a, axis=None, dtype=None, out=None, keepdims=False,
             initial=None, where=None):
    a = _t(a)
    if a.is_floating_point():
        a = torch.where(torch.isnan(a), torch.ones_like(a), a)
    return _over(a, axis, keepdims, lambda x: torch.prod(x, -1))


def _nansum(a, axis=None, dtype=None, out=None, keepdims=False,
            initial=None, where=None):
    a = _t(a)
    if a.is_floating_point():
        a = torch.where(torch.isnan(a), torch.zeros_like(a), a)
    res = _over(a, axis, keepdims, lambda x: torch.sum(x, -1))
    return res if a.is_floating_point() else res.to(torch.int32)


def _nanmean(a, axis=None, dtype=None, out=None, keepdims=False,
             where=None):
    a = _float(_t(a))
    return _over(a, axis, keepdims, lambda x: torch.nanmean(x, -1))


# ------------------------------------------------------- concat bodies ----
def _seq(arrays):
    return [_t(a) for a in arrays]


def _concatenate(arrays, axis=0, out=None, dtype=None):
    ts = _seq(arrays)
    if axis is None:
        ts = [t.reshape(-1) for t in ts]
        axis = 0
    out = torch.cat(ts, dim=axis)
    return out if dtype is None else out.to(dtype_torch(dtype))


def _stack(arrays, axis=0, out=None, dtype=None):
    out = torch.stack(_seq(arrays), dim=axis)
    return out if dtype is None else out.to(dtype_torch(dtype))


def _split_sections(ary, indices_or_sections, axis, equal):
    a = _t(ary)
    ios = indices_or_sections
    if isinstance(ios, (builtins.int, _onp.integer)):
        if equal and a.shape[axis] % ios:
            raise ValueError("array split does not result in an equal "
                             "division")
        return list(torch.tensor_split(a, builtins.int(ios), dim=axis))
    idx = [builtins.int(i) for i in (ios.asnumpy() if isinstance(
        ios, NDArray) else ios)]
    return list(torch.tensor_split(a, idx, dim=axis))


def _split(ary, indices_or_sections, axis=0):
    return _split_sections(ary, indices_or_sections, axis, True)


def _array_split(ary, indices_or_sections, axis=0):
    return _split_sections(ary, indices_or_sections, axis, False)


def _vsplit(ary, indices_or_sections):
    return _split_sections(ary, indices_or_sections, 0, True)


def _hsplit(ary, indices_or_sections):
    a = _t(ary)
    return _split_sections(a, indices_or_sections, 1 if a.dim() > 1 else 0,
                           True)


def _dsplit(ary, indices_or_sections):
    return _split_sections(ary, indices_or_sections, 2, True)


def _seq_fn(fn):
    def body(tup, *args, **kwargs):
        return fn(_seq(tup))
    return body


# -------------------------------------------------------- extra bodies ----
def _logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
              axis=0):
    lin = linspace(start, stop, num, endpoint=endpoint)._data
    return torch.pow(torch.tensor(base, dtype=torch.float32,
                                  device=lin.device), lin).to(
        dtype_torch(dtype) if dtype else torch.float32)


def _indices(dimensions, dtype=None, sparse=False):
    dev = _dev()
    grids = torch.meshgrid(*[torch.arange(d, device=dev)
                             for d in dimensions], indexing="ij")
    out = torch.stack(grids) if grids else torch.zeros(
        (0,), dtype=torch.int64, device=dev)
    return out.to(dtype_torch(dtype) if dtype else torch.int32)


def _tri(N, M=None, k=0, dtype=None):
    t = torch.ones(N, N if M is None else M, device=_dev())
    return torch.tril(t, k).to(dtype_torch(dtype) if dtype
                               else torch.float32)


def _diagonal(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_t(a), offset, axis1, axis2)


def _heaviside(x1, x2):
    a, b = _pair(x1, x2)
    a, b = _float(a), _float(b)
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.heaviside(a.to(dt), b.to(dt))


def _angle(z, deg=False):
    z = _float(_t(z))
    out = torch.angle(z)
    return out * (180.0 / math.pi) if deg else out


def _unwrap_phase(p, discont=None, axis=-1, *, period=2 * math.pi):
    p = _float(_t(p))
    x = torch.movedim(p, axis, -1)
    dd = x[..., 1:] - x[..., :-1]
    half = period / 2
    if discont is None:
        discont = half
    ddmod = torch.remainder(dd + half, period) - half
    ddmod = torch.where((ddmod == -half) & (dd > 0),
                        torch.full_like(ddmod, half), ddmod)
    corr = torch.where(dd.abs() < discont, torch.zeros_like(dd), ddmod - dd)
    out = torch.cat([x[..., :1], x[..., 1:] + torch.cumsum(corr, -1)], -1)
    return torch.movedim(out, -1, axis)


def _digitize(x, bins, right=False):
    x, b = _t(x), _t(bins)
    b = b.to(torch.promote_types(x.dtype, b.dtype))
    x = x.to(b.dtype)
    if b.numel() > 1 and bool(b[-1] < b[0]):
        rb = torch.flip(b, (0,))
        return _index_dtype(b.numel() - torch.searchsorted(
            rb.contiguous(), x.contiguous(), side="left" if right
            else "right"))
    return _index_dtype(torch.searchsorted(
        b.contiguous(), x.contiguous(), side="left" if right else "right"))


def _partition(a, kth, axis=-1, kind=None, order=None):
    return torch.sort(_t(a), dim=axis, stable=True).values


def _argpartition(a, kth, axis=-1, kind=None, order=None):
    return _index_dtype(torch.argsort(_t(a), dim=axis, stable=True))


def _lexsort(keys, axis=-1):
    ks = [_t(k) for k in keys] if isinstance(keys, (list, tuple)) \
        else list(_t(keys).unbind(0))
    idx = torch.arange(ks[0].shape[axis], device=ks[0].device)
    for k in ks:
        order = torch.argsort(k[idx], stable=True)
        idx = idx[order]
    return _index_dtype(idx)


def _set_unique(a):
    return torch.unique(_t(a).reshape(-1), sorted=True)


def _union1d(ar1, ar2):
    _check_concrete("union1d")
    return torch.unique(torch.cat([_t(ar1).reshape(-1),
                                   _t(ar2).reshape(-1)]), sorted=True)


def _intersect1d(ar1, ar2, assume_unique=False, return_indices=False):
    _check_concrete("intersect1d")
    a, b = _set_unique(ar1), _set_unique(ar2)
    out = a[torch.isin(a, b)]
    if not return_indices:
        return out
    fa, fb = _t(ar1).reshape(-1), _t(ar2).reshape(-1)
    ia = torch.stack([(fa == v).nonzero()[0, 0] for v in out]) if \
        out.numel() else torch.zeros(0, dtype=torch.int64, device=a.device)
    ib = torch.stack([(fb == v).nonzero()[0, 0] for v in out]) if \
        out.numel() else torch.zeros(0, dtype=torch.int64, device=a.device)
    return out, _index_dtype(ia), _index_dtype(ib)


def _setdiff1d(ar1, ar2, assume_unique=False):
    _check_concrete("setdiff1d")
    a = _set_unique(ar1)
    return a[~torch.isin(a, _t(ar2).reshape(-1))]


def _setxor1d(ar1, ar2, assume_unique=False):
    _check_concrete("setxor1d")
    a, b = _set_unique(ar1), _set_unique(ar2)
    both = torch.cat([a[~torch.isin(a, b)], b[~torch.isin(b, a)]])
    return torch.sort(both).values


def _isin(element, test_elements, assume_unique=False, invert=False):
    e_, t_ = _t(element), _t(test_elements)
    return torch.isin(e_, t_.reshape(-1).to(e_.dtype), invert=invert)


def _broadcast_arrays(*args):
    return list(torch.broadcast_tensors(*[_t(a) for a in args]))


def _append(arr, values, axis=None):
    a, v = _t(arr), _t(values)
    dt = torch.promote_types(a.dtype, v.dtype)
    if axis is None:
        return torch.cat([a.reshape(-1).to(dt), v.reshape(-1).to(dt)])
    return torch.cat([a.to(dt), v.to(dt)], dim=axis)


def _resize(a, new_shape):
    a = _t(a).reshape(-1)
    shape = _shape(new_shape)
    n = math.prod(shape)
    reps = -(-n // builtins.max(a.numel(), 1))
    return a.repeat(reps)[:n].reshape(shape)


def _trim_zeros(filt, trim="fb"):
    _check_concrete("trim_zeros")
    f = _t(filt)
    nz = torch.nonzero(f != 0).reshape(-1)
    if nz.numel() == 0:
        return f[:0]
    lo = int(nz[0]) if "f" in trim.lower() else 0
    hi = int(nz[-1]) + 1 if "b" in trim.lower() else f.numel()
    return f[lo:hi]


def _gradient(f, *varargs, axis=None, edge_order=1):
    f = _float(_t(f))
    dims = list(range(f.dim())) if axis is None else (
        list(axis) if isinstance(axis, (tuple, list)) else [axis])
    spacing = varargs[0] if len(varargs) == 1 else (
        list(varargs) if varargs else 1.0)
    outs = torch.gradient(f, spacing=spacing, dim=dims,
                          edge_order=edge_order)
    return outs[0] if len(outs) == 1 else list(outs)


def _spacing(x):
    x = _float(_t(x))
    inf_ = torch.full_like(x, math.inf)
    return torch.where(x < 0, torch.nextafter(x, -inf_) - x,
                       torch.nextafter(x, inf_) - x)


def _frexp(x):
    m, ex = torch.frexp(_float(_t(x)))
    return m, ex.to(torch.int32)


def _modf(x, out=None):
    x = _float(_t(x))
    i = torch.trunc(x)
    return x - i, i


def _ldexp(x1, x2):
    a, b = _t(x1), _t(x2)
    return torch.ldexp(_float(a), b)


def _invert(x):
    x = _t(x)
    return torch.logical_not(x) if x.dtype == torch.bool else \
        torch.bitwise_not(x)


def _argwhere(a, *, size=None, fill_value=None):
    _check_concrete("argwhere")
    a = _t(a)
    if a.dim() == 0:
        a = a.reshape(1)[: 1 if bool(a) else 0]
        return _index_dtype(torch.zeros((a.numel(), 0), dtype=torch.int64,
                                        device=a.device))
    return _index_dtype(torch.argwhere(a))


def _extract(condition, arr, *, size=None, fill_value=0):
    _check_concrete("extract")
    return _t(arr).reshape(-1)[_t(condition).reshape(-1).bool()]


def _choose(a, choices, out=None, mode="raise"):
    idx = _t(a).long()
    n = len(choices)
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = idx % n
    cs = torch.broadcast_tensors(idx, *[_t(c) for c in choices])
    return torch.gather(torch.stack(cs[1:]), 0,
                        cs[0].unsqueeze(0)).squeeze(0)


def _compress(condition, a, axis=None, *, size=None, fill_value=0):
    _check_concrete("compress")
    a, axis = _axis_flat(_t(a), axis)
    c = _t(condition).reshape(-1).bool()
    keep = torch.nonzero(c).reshape(-1)
    return torch.index_select(a, axis, keep[keep < a.shape[axis]])


def _select(condlist, choicelist, default=0):
    conds = [_t(c).bool() for c in condlist]
    choices = [_t(c) for c in choicelist]
    dt = choices[0].dtype
    for c in choices[1:]:
        dt = torch.promote_types(dt, c.dtype)
    out = torch.broadcast_to(_scalar_like(default, choices[0]) if
                             _onp.isscalar(default) else _t(default),
                             torch.broadcast_shapes(
                                 *[c.shape for c in conds + choices])
                             ).to(dt)
    for c, v in reversed(list(zip(conds, choices))):
        out = torch.where(c, v.to(dt), out)
    return out


def _float_power(x1, x2):
    a, b = _pair(x1, x2)
    return torch.float_power(a, b).to(torch.float32)


def _divmod(x1, x2):
    a, b = _pair(x1, x2)
    return torch.div(a, b, rounding_mode="floor"), torch.remainder(a, b)


def _cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
         aweights=None, *, dtype=None):
    x = _float(_t(m))
    if x.dim() == 1:
        x = x.unsqueeze(0)
    if not rowvar and x.shape[0] != 1:
        x = x.T
    if y is not None:
        yy = _float(_t(y))
        if yy.dim() == 1:
            yy = yy.unsqueeze(0)
        if not rowvar and yy.shape[0] != 1:
            yy = yy.T
        x = torch.cat([x, yy], 0)
    corr = ddof if ddof is not None else (0 if bias else 1)
    out = torch.cov(x, correction=corr,
                    fweights=None if fweights is None else _t(fweights),
                    aweights=None if aweights is None else _t(aweights))
    return out


def _corrcoef(x, y=None, rowvar=True, *, dtype=None):
    c = _cov(x, y, rowvar)
    if c.dim() == 0:
        return c / c
    d = torch.sqrt(torch.diagonal(c))
    out = c / d[:, None] / d[None, :]
    return out.clamp(-1, 1)


def _conv_full(a, v):
    a, v = _float(a), _float(v).to(_float(a).dtype)
    n, m = a.numel(), v.numel()
    out = _F.conv1d(a.reshape(1, 1, n), v.flip(0).reshape(1, 1, m),
                    padding=m - 1)
    return out.reshape(-1)


def _convolve(a, v, mode="full", *, precision=None,
              preferred_element_type=None):
    a, v = _t(a).reshape(-1), _t(v).reshape(-1)
    if v.numel() > a.numel():
        a, v = v, a
    full_ = _conv_full(a, v)
    n, m = a.numel(), v.numel()
    if mode == "full":
        return full_
    if mode == "same":
        start = (m - 1) // 2
        return full_[start:start + n]
    return full_[m - 1:n]


def _correlate(a, v, mode="valid", *, precision=None,
               preferred_element_type=None):
    a, v = _t(a).reshape(-1), _t(v).reshape(-1)
    swap = v.numel() > a.numel()
    if swap:
        a, v = v, a
    full_ = _conv_full(a, v.flip(0))
    n, m = a.numel(), v.numel()
    if mode == "full":
        out = full_
    elif mode == "same":
        start = m // 2
        out = full_[start:start + n]
    else:
        out = full_[m - 1:n]
    return out.flip(0) if swap else out


def _empty_like(prototype, dtype=None, shape=None):
    t = _t(prototype)
    return torch.zeros(_shape(shape) if shape is not None else t.shape,
                       dtype=dtype_torch(dtype) if dtype else t.dtype,
                       device=t.device)


def _copy(a, order=None):
    return _t(a).clone()


def _rollaxis(a, axis, start=0):
    a = _t(a)
    n = a.dim()
    axis %= n
    if start < 0:
        start += n
    if axis < start:
        start -= 1
    if axis == start:
        return a
    return torch.movedim(a, axis, start)


def _block_depth(x):
    return 1 + _block_depth(x[0]) if isinstance(x, list) else 0


def _block_ndim(x):
    if isinstance(x, list):
        return builtins.max(_block_ndim(e) for e in x)
    return _t(x).dim()


def _block(arrays):
    depth = _block_depth(arrays)
    ndim = builtins.max(depth, _block_ndim(arrays))

    def build(x, level):
        if not isinstance(x, list):
            t = _t(x)
            return t.reshape((1,) * (ndim - t.dim()) + tuple(t.shape))
        return torch.cat([build(e, level + 1) for e in x],
                         dim=-(depth - level))
    return build(arrays, 0)


def _apply_along_axis(func1d, axis, arr, *args, **kwargs):
    a = _t(arr)
    x = torch.movedim(a, axis, -1)
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1])
    outs = [_unwrap(func1d(_wrap(r), *args, **kwargs)) for r in rows]
    outs = [_t(o) for o in outs]
    res = torch.stack(outs).reshape(lead + outs[0].shape)
    if outs[0].dim() == 0:
        return res
    return torch.movedim(res, -1, axis) if outs[0].dim() == 1 else res


def _apply_over_axes(func, a, axes):
    val = _t(a)
    for ax in (axes if isinstance(axes, (list, tuple)) else [axes]):
        res = _t(_unwrap(func(_wrap(val), ax)))
        val = res if res.dim() == val.dim() else res.unsqueeze(ax)
    return val


def _tri_indices(fn):
    def body(n, k=0, m=None):
        ij = fn(n, n if m is None else m, k, device=_dev())
        return tuple(_index_dtype(r) for r in ij)
    return body


def _tri_indices_from(fn):
    def body(arr, k=0):
        s = _t(arr).shape
        ij = fn(s[-2], s[-1], k, device=_dev())
        return tuple(_index_dtype(r) for r in ij)
    return body


def _diag_indices(n, ndim=2):
    i = torch.arange(n, dtype=torch.int32, device=_dev())
    return (i,) * ndim


def _diag_indices_from(arr):
    a = _t(arr)
    return _diag_indices(a.shape[0], a.dim())


def _unravel_index(indices, shape):
    idx = _t(indices).long()
    return tuple(_index_dtype(i) for i in torch.unravel_index(
        idx, _shape(shape)))


def _ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    ids = [_t(i).long() for i in multi_index]
    out = torch.zeros_like(ids[0])
    for i, d in zip(ids, dims):
        if mode == "clip":
            i = i.clamp(0, d - 1)
        elif mode == "wrap":
            i = i % d
        out = out * d + i
    return _index_dtype(out)


def _ix_(*args):
    n = len(args)
    outs = []
    for k, a in enumerate(args):
        t = _t(a)
        if t.dtype == torch.bool:
            t = torch.nonzero(t).reshape(-1)
        shape = [1] * n
        shape[k] = -1
        outs.append(t.to(_NARROW.get(t.dtype, t.dtype)).reshape(shape))
    return tuple(outs)


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _packbits(a, axis=None, bitorder="big"):
    a, axis = _axis_flat(_t(a), axis)
    x = torch.movedim((a != 0).to(torch.uint8), axis, -1)
    pad = (-x.shape[-1]) % 8
    if pad:
        x = _F.pad(x, (0, pad))
    x = x.reshape(x.shape[:-1] + (-1, 8)).to(torch.int32)
    w = torch.tensor(_BIT_WEIGHTS if bitorder == "big" else
                     _BIT_WEIGHTS[::-1], dtype=torch.int32, device=x.device)
    return torch.movedim((x * w).sum(-1).to(torch.uint8), -1, axis)


def _unpackbits(a, axis=None, count=None, bitorder="big"):
    a, axis = _axis_flat(_t(a), axis)
    sh = torch.arange(7, -1, -1, device=a.device) if bitorder == "big" \
        else torch.arange(8, device=a.device)
    x = torch.movedim(a.to(torch.int32), axis, -1)
    bits = ((x.unsqueeze(-1) >> sh) & 1).to(torch.uint8)
    bits = bits.reshape(x.shape[:-1] + (-1,))
    if count is not None:
        bits = bits[..., :count]
    return torch.movedim(bits, -1, axis)


def _poly(seq_of_zeros):
    z = _float(_t(seq_of_zeros)).reshape(-1)
    out = torch.ones(1, dtype=z.dtype, device=z.device)
    for r in z:
        out = _conv_full(out, torch.stack([torch.ones_like(r), -r]))
    return out


def _poly_align(a1, a2):
    a, b = _t(a1).reshape(-1), _t(a2).reshape(-1)
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    n = builtins.max(a.numel(), b.numel())
    return _F.pad(a, (n - a.numel(), 0)), _F.pad(b, (n - b.numel(), 0))


def _polyadd(a1, a2):
    a, b = _poly_align(a1, a2)
    return a + b


def _polysub(a1, a2):
    a, b = _poly_align(a1, a2)
    return a - b


def _polymul(a1, a2, *, trim_leading_zeros=False):
    a, b = _t(a1).reshape(-1), _t(a2).reshape(-1)
    return _conv_full(a, b)


def _polyder(p, m=1):
    p = _float(_t(p))
    for _ in range(m):
        n = p.numel() - 1
        p = p[:-1] * torch.arange(n, 0, -1, dtype=p.dtype, device=p.device)
    return p


def _polyint(p, m=1, k=None):
    p = _float(_t(p))
    ks = [0.0] * m if k is None else (list(k) if isinstance(
        k, (list, tuple)) else [k] * m)
    for i in range(m):
        n = p.numel()
        p = torch.cat([p / torch.arange(n, 0, -1, dtype=p.dtype,
                                        device=p.device),
                       torch.tensor([ks[i]], dtype=p.dtype,
                                    device=p.device)])
    return p


def _polyval(p, x, *, unroll=16):
    p, x = _t(p), _t(x)
    dt = torch.promote_types(p.dtype, x.dtype)
    out = torch.zeros_like(x, dtype=dt)
    for c in p.to(dt):
        out = out * x + c
    return out


def _polyfit(x, y, deg, rcond=None, full=False, w=None, cov=False):
    x, y = _float(_t(x)), _float(_t(y))
    y = y.to(x.dtype)
    van = torch.stack([x ** (deg - i) for i in range(deg + 1)], -1)
    rhs = y
    if w is not None:
        ww = _float(_t(w)).to(x.dtype)
        van = van * ww[:, None]
        rhs = rhs * (ww if rhs.dim() == 1 else ww[:, None])
    scale = torch.sqrt((van * van).sum(0))
    sol = torch.linalg.pinv(van / scale) @ rhs
    return (sol.T / scale).T


def _vectorize(pyfunc, *, excluded=frozenset(), signature=None):
    def vec(*args, **kwargs):
        ts = torch.broadcast_tensors(*[_t(a) for a in args])
        flat = [t.reshape(-1) for t in ts]
        outs = [_t(_unwrap(pyfunc(*[_wrap(f[i]) for f in flat], **kwargs)))
                for i in range(flat[0].numel())]
        return _wrap(torch.stack(outs).reshape(ts[0].shape))
    return vec


def _meshgrid(*xi, copy=True, sparse=False, indexing="xy"):
    grids = torch.meshgrid(*[_t(x) for x in xi], indexing=indexing)
    return [g.clone() for g in grids]


# -------------------------------------------------------- the name table --
_UNARY = [
    "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "cbrt",
    "square", "abs", "absolute", "sign", "negative", "reciprocal",
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh",
    "tanh", "arcsinh", "arccosh", "arctanh", "degrees", "radians",
    "floor", "ceil", "rint", "trunc", "fix", "logical_not",
    "isnan", "isinf", "isfinite", "isneginf", "isposinf",
]
_BINARY = [
    "add", "subtract", "multiply", "divide", "true_divide", "floor_divide",
    "power", "mod", "remainder", "fmod", "maximum", "minimum", "hypot",
    "arctan2", "copysign", "logaddexp", "equal", "not_equal", "greater",
    "greater_equal", "less", "less_equal", "logical_and", "logical_or",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor",
    "left_shift", "right_shift", "gcd", "lcm",
]
_SHAPE = [
    "reshape", "ravel", "moveaxis", "swapaxes", "expand_dims", "squeeze",
    "broadcast_to", "flip", "fliplr", "flipud", "roll", "rot90", "tile",
    "repeat", "atleast_1d", "atleast_2d", "atleast_3d",
]
_OTHER = [
    "where", "clip", "tril", "triu", "diag", "trace", "sort", "argsort",
    "searchsorted", "unique", "cumsum", "cumprod", "diff", "ediff1d",
    "nan_to_num", "around", "round", "real", "imag", "interp",
    "take", "take_along_axis", "nonzero", "count_nonzero", "allclose",
    "array_equal", "isclose", "histogram", "bincount", "pad", "insert",
    "delete", "flatnonzero", "tensordot", "dot", "matmul", "inner",
    "outer", "vdot", "kron", "cross", "einsum", "average",
]
_REDUCE = [
    "sum", "prod", "mean", "std", "var", "max", "min", "amax", "amin",
    "argmax", "argmin", "all", "any", "nansum", "nanprod", "nanmean",
    "nanmax", "nanmin", "median", "percentile", "quantile", "ptp",
]
_CONCAT = ["concatenate", "stack", "vstack", "hstack", "dstack",
           "column_stack", "split", "array_split", "vsplit", "hsplit",
           "dsplit"]
_EXTRA = [
    "logspace", "indices", "tri", "diagonal", "positive", "heaviside",
    "angle", "conj", "conjugate", "unwrap", "sinc", "nanstd", "nanvar",
    "nanargmax", "nanargmin", "nancumsum", "nancumprod",
    "digitize", "partition", "argpartition", "lexsort", "union1d",
    "intersect1d", "setdiff1d", "setxor1d", "isin", "broadcast_arrays",
    "append", "resize", "trim_zeros", "gradient", "iscomplex", "isreal",
    "iscomplexobj", "isrealobj", "nextafter", "spacing", "ldexp", "frexp",
    "modf", "deg2rad", "rad2deg", "invert", "argwhere", "extract",
    "choose", "compress", "select", "signbit",
    "float_power", "divmod", "cov", "corrcoef", "convolve", "correlate",
    "empty_like", "copy", "rollaxis", "block",
    "apply_along_axis", "apply_over_axes", "triu_indices", "tril_indices",
    "triu_indices_from", "tril_indices_from", "diag_indices",
    "diag_indices_from", "unravel_index", "ravel_multi_index", "ix_",
    "packbits", "unpackbits", "poly", "polyadd",
    "polyder", "polyfit", "polyint", "polymul", "polysub", "polyval",
]
_PASSTHROUGH = ["float16", "float64", "uint16", "uint32", "uint64",
                "int16", "complex64", "complex128", "promote_types",
                "can_cast", "vectorize"]

_IMPL = {
    # unary
    "exp": _unary(torch.exp, True), "expm1": _unary(torch.expm1, True),
    "log": _unary(torch.log, True), "log2": _unary(torch.log2, True),
    "log10": _unary(torch.log10, True), "log1p": _unary(torch.log1p, True),
    "sqrt": _unary(torch.sqrt, True), "cbrt": _unary(_cbrt, True),
    "square": _unary(torch.square), "abs": _unary(torch.abs),
    "absolute": _unary(torch.abs), "sign": _unary(torch.sign),
    "negative": _unary(torch.negative),
    "reciprocal": _unary(torch.reciprocal),
    "sin": _unary(torch.sin, True), "cos": _unary(torch.cos, True),
    "tan": _unary(torch.tan, True), "arcsin": _unary(torch.asin, True),
    "arccos": _unary(torch.acos, True), "arctan": _unary(torch.atan, True),
    "sinh": _unary(torch.sinh, True), "cosh": _unary(torch.cosh, True),
    "tanh": _unary(torch.tanh, True), "arcsinh": _unary(torch.asinh, True),
    "arccosh": _unary(torch.acosh, True),
    "arctanh": _unary(torch.atanh, True),
    "degrees": _unary(torch.rad2deg, True),
    "radians": _unary(torch.deg2rad, True),
    "floor": _unary(torch.floor), "ceil": _unary(torch.ceil),
    "rint": _unary(torch.round), "trunc": _unary(torch.trunc),
    "fix": _unary(torch.trunc), "logical_not": _unary(torch.logical_not),
    "isnan": _unary(torch.isnan), "isinf": _unary(torch.isinf),
    "isfinite": _unary(torch.isfinite), "isneginf": _unary(torch.isneginf),
    "isposinf": _unary(torch.isposinf),
    # binary
    "add": _binary(torch.add), "subtract": _binary(torch.subtract),
    "multiply": _binary(torch.multiply), "divide": _binary(_true_divide),
    "true_divide": _binary(_true_divide),
    "floor_divide": _binary(_floor_divide), "power": _binary(_power),
    "mod": _binary(torch.remainder), "remainder": _binary(torch.remainder),
    "fmod": _binary(torch.fmod), "maximum": _binary(torch.maximum),
    "minimum": _binary(torch.minimum), "hypot": _binary(torch.hypot, True),
    "arctan2": _binary(torch.atan2, True),
    "copysign": _binary(torch.copysign, True),
    "logaddexp": _binary(_logaddexp, True), "equal": _binary(torch.eq),
    "not_equal": _binary(torch.ne), "greater": _binary(torch.gt),
    "greater_equal": _binary(torch.ge), "less": _binary(torch.lt),
    "less_equal": _binary(torch.le),
    "logical_and": _binary(_bool_op(torch.logical_and)),
    "logical_or": _binary(_bool_op(torch.logical_or)),
    "logical_xor": _binary(_bool_op(torch.logical_xor)),
    "bitwise_and": _binary(torch.bitwise_and),
    "bitwise_or": _binary(torch.bitwise_or),
    "bitwise_xor": _binary(torch.bitwise_xor),
    "left_shift": _binary(torch.bitwise_left_shift),
    "right_shift": _binary(torch.bitwise_right_shift),
    "gcd": _binary(torch.gcd), "lcm": _binary(_lcm),
    # shape
    "reshape": _reshape, "ravel": _ravel, "moveaxis": _moveaxis,
    "swapaxes": _swapaxes, "expand_dims": _expand_dims,
    "squeeze": _squeeze, "broadcast_to": _broadcast_to, "flip": _flip,
    "fliplr": lambda m: torch.flip(_t(m), (1,)),
    "flipud": lambda m: torch.flip(_t(m), (0,)), "roll": _roll,
    "rot90": _rot90, "tile": _tile, "repeat": _repeat,
    "atleast_1d": _atleast(torch.atleast_1d),
    "atleast_2d": _atleast(torch.atleast_2d),
    "atleast_3d": _atleast(torch.atleast_3d),
    # other
    "where": _where, "clip": _clip, "tril": _tril, "triu": _triu,
    "diag": _diag, "trace": _trace, "sort": _sort, "argsort": _argsort,
    "searchsorted": _searchsorted, "unique": _unique,
    "cumsum": _cum(torch.cumsum), "cumprod": _cum(torch.cumprod),
    "diff": _diff, "ediff1d": _ediff1d, "nan_to_num": _nan_to_num,
    "around": _round, "round": _round, "real": _real, "imag": _imag,
    "interp": _interp, "take": _take, "take_along_axis": _take_along_axis,
    "nonzero": _nonzero, "count_nonzero": _count_nonzero,
    "allclose": _allclose, "array_equal": _array_equal,
    "isclose": _isclose, "histogram": _histogram, "bincount": _bincount,
    "pad": _pad, "insert": _insert, "delete": _delete,
    "flatnonzero": _flatnonzero, "tensordot": _tensordot, "dot": _dot,
    "matmul": lambda a, b: torch.matmul(*_pair(a, b)), "inner": _inner,
    "outer": _outer, "vdot": _vdot,
    "kron": lambda a, b: torch.kron(*_pair(a, b)), "cross": _cross,
    "einsum": _einsum, "average": _average,
    # reductions
    "sum": _reduce(lambda x: torch.sum(x, -1)),
    "prod": _reduce(lambda x: torch.prod(x, -1)),
    "mean": _reduce(lambda x: torch.mean(x, -1), to_float=True),
    "std": _moment(root=True), "var": _moment(),
    "max": _reduce(lambda x: torch.amax(x, -1)),
    "min": _reduce(lambda x: torch.amin(x, -1)),
    "amax": _reduce(lambda x: torch.amax(x, -1)),
    "amin": _reduce(lambda x: torch.amin(x, -1)),
    "argmax": _arg(torch.argmax), "argmin": _arg(torch.argmin),
    "all": _reduce(lambda x: torch.all(x, -1)),
    "any": _reduce(lambda x: torch.any(x, -1)),
    "nansum": _nansum, "nanprod": _nanprod, "nanmean": _nanmean,
    "nanmax": _nan_extreme(torch.amax, -math.inf),
    "nanmin": _nan_extreme(torch.amin, math.inf),
    "median": _median, "percentile": _quantile_body(100.0),
    "quantile": _quantile_body(1.0), "ptp": _ptp,
    # concatenation and splits
    "concatenate": _concatenate, "stack": _stack,
    "vstack": _seq_fn(torch.vstack), "hstack": _seq_fn(torch.hstack),
    "dstack": _seq_fn(torch.dstack),
    "column_stack": _seq_fn(torch.column_stack), "split": _split,
    "array_split": _array_split, "vsplit": _vsplit, "hsplit": _hsplit,
    "dsplit": _dsplit,
    # the long tail
    "logspace": _logspace, "indices": _indices, "tri": _tri,
    "diagonal": _diagonal, "positive": lambda x: +_t(x),
    "heaviside": _heaviside, "angle": _angle,
    "conj": lambda x: _t(x).conj(), "conjugate": lambda x: _t(x).conj(),
    "unwrap": _unwrap_phase, "sinc": _unary(torch.sinc, True),
    "nanstd": _moment(nan=True, root=True), "nanvar": _moment(nan=True),
    "nanargmax": _arg(torch.argmax, -math.inf),
    "nanargmin": _arg(torch.argmin, math.inf),
    "nancumsum": _cum(torch.cumsum, 0.0),
    "nancumprod": _cum(torch.cumprod, 1.0),
    "digitize": _digitize, "partition": _partition,
    "argpartition": _argpartition, "lexsort": _lexsort,
    "union1d": _union1d, "intersect1d": _intersect1d,
    "setdiff1d": _setdiff1d, "setxor1d": _setxor1d, "isin": _isin,
    "broadcast_arrays": _broadcast_arrays, "append": _append,
    "resize": _resize, "trim_zeros": _trim_zeros, "gradient": _gradient,
    "iscomplex": lambda x: torch.zeros_like(_t(x), dtype=torch.bool)
    if not _t(x).is_complex() else _t(x).imag != 0,
    "isreal": lambda x: torch.ones_like(_t(x), dtype=torch.bool)
    if not _t(x).is_complex() else _t(x).imag == 0,
    "iscomplexobj": lambda x: _t(x).is_complex(),
    "isrealobj": lambda x: not _t(x).is_complex(),
    "nextafter": _binary(torch.nextafter, True), "spacing": _spacing,
    "ldexp": _ldexp, "frexp": _frexp, "modf": _modf,
    "deg2rad": _unary(torch.deg2rad, True),
    "rad2deg": _unary(torch.rad2deg, True), "invert": _invert,
    "argwhere": _argwhere, "extract": _extract, "choose": _choose,
    "compress": _compress, "select": _select,
    "signbit": _unary(torch.signbit), "float_power": _float_power,
    "divmod": _divmod, "cov": _cov, "corrcoef": _corrcoef,
    "convolve": _convolve, "correlate": _correlate,
    "empty_like": _empty_like, "copy": _copy, "rollaxis": _rollaxis,
    "block": _block, "apply_along_axis": _apply_along_axis,
    "apply_over_axes": _apply_over_axes,
    "triu_indices": _tri_indices(torch.triu_indices),
    "tril_indices": _tri_indices(torch.tril_indices),
    "triu_indices_from": _tri_indices_from(torch.triu_indices),
    "tril_indices_from": _tri_indices_from(torch.tril_indices),
    "diag_indices": _diag_indices, "diag_indices_from": _diag_indices_from,
    "unravel_index": _unravel_index,
    "ravel_multi_index": _ravel_multi_index, "ix_": _ix_,
    "packbits": _packbits, "unpackbits": _unpackbits, "poly": _poly,
    "polyadd": _polyadd, "polyder": _polyder, "polyfit": _polyfit,
    "polyint": _polyint, "polymul": _polymul, "polysub": _polysub,
    "polyval": _polyval,
    # called by the module-level names below
    "transpose": _transpose, "meshgrid": _meshgrid,
}

_this = sys.modules[__name__]


def _first_device(args, kwargs):
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, NDArray):
            return a._data.device
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (list, tuple)):
            for x in a:
                if isinstance(x, NDArray):
                    return x._data.device
    return None


def _dispatch(name, body=None):
    """The public function ``name``: ``body`` (``_IMPL[name]``) run on the
    device of its first array argument, with gradients off unless
    recording, its tensors wrapped as ``mx.np.ndarray``."""
    body = _IMPL[name] if body is None else body

    def fn(*args, **kwargs):
        prev = getattr(_tls, "device", None)
        _tls.device = _first_device(args, kwargs)
        try:
            if torch.is_grad_enabled() and not _autograd.is_recording():
                with torch.no_grad():
                    out = body(*args, **kwargs)
            else:
                out = body(*args, **kwargs)
        finally:
            _tls.device = prev
        return _wrap_out(out)

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = f"numpy-semantics ``{name}`` on torch tensors"
    return fn


for _n in (_UNARY + _BINARY + _SHAPE + _OTHER + _REDUCE + _CONCAT + _EXTRA
           + ["transpose", "meshgrid"]):
    setattr(_this, _n, _dispatch(_n))

uint16 = _onp.uint16
uint32 = _onp.uint32
uint64 = _onp.uint64
int16 = _onp.int16
complex64 = _onp.complex64
complex128 = _onp.complex128
can_cast = _onp.can_cast


def promote_types(type1, type2):
    """The promoted dtype by the JAX package's rules (no 64-bit types:
    int32 with float32 is float32)."""
    t = torch.promote_types(dtype_torch(type1), dtype_torch(type2))
    return dtype_np(_NARROW.get(t, t))
vectorize = _vectorize


def asnumpy(a):
    return a.asnumpy() if isinstance(a, NDArray) else _onp.asarray(a)


def shape(a):
    return tuple(_unwrap(a).shape) if isinstance(
        a, (NDArray, torch.Tensor)) else _onp.shape(a)


def ndim(a):
    return _unwrap(a).dim() if isinstance(a, (NDArray, torch.Tensor)) \
        else _onp.ndim(a)


def size(a):
    return builtins.int(_unwrap(a).numel()) if isinstance(
        a, (NDArray, torch.Tensor)) else builtins.int(_onp.size(a))


def result_type(*args):
    dts = [a.dtype if isinstance(a, NDArray) else a for a in args]
    r = _onp.result_type(*dts)
    return {_onp.dtype(_onp.int64): _onp.dtype(_onp.int32),
            _onp.dtype(_onp.float64): _onp.dtype(_onp.float32)}.get(r, r)


from . import linalg  # noqa: E402,F401  (mx.np.linalg)
from . import random  # noqa: E402,F401  (mx.np.random)


def asarray(a, dtype=None):
    if isinstance(a, NDArray) and dtype is None:
        return a if isinstance(a, ndarray) else ndarray(a._data)
    return array(a, dtype=dtype)


__all__ = (["ndarray", "array", "asarray", "zeros", "ones", "full",
            "empty", "zeros_like", "ones_like", "full_like", "arange",
            "linspace", "eye", "identity", "meshgrid", "transpose",
            "asnumpy", "shape", "ndim", "size", "result_type", "random",
            "linalg", "pi", "e", "inf", "nan", "newaxis"]
           + _UNARY + _BINARY + _SHAPE + _OTHER + _REDUCE + _CONCAT
           + _EXTRA + _PASSTHROUGH)
