"""Sparse storage: ``row_sparse`` and ``csr`` (the port of
``mxnet_tpu/sparse.py``; ref: python/mxnet/ndarray/sparse.py,
src/operator/tensor/cast_storage-inl.h, dot-inl.h,
sparse_retain-inl.h, src/operator/optimizer_op.cc's lazy updates).

The payloads are dense tensors: row_sparse as ``(indices[k],
values[k, *row])``, csr as ``(indptr, indices, data)``, indices int32
as in the JAX package.  Every operation is a gather, an ``index_add_``
(a segment sum) or a row scatter on the arrays' device.  Construction
from dense (``cast_storage``) reads the number of stored rows or
entries on the host, so it is eager only: inside a captured graph or a
hybridized body it raises, as the JAX package raises on a tracer.

The lazy updates (``sgd_update``, ``sgd_mom_update``, ``adam_update``,
``adagrad_update``) touch only the gradient's rows: weight decay and
momentum leave the other rows alone.  The optimizers whose
``supports_sparse`` is true (SGD, Adam, AdaGrad) take them for a
row_sparse gradient and write the rows into the weight in place.
"""
from __future__ import annotations

import numpy as np
import torch

from .context import current_context, resolve_device
from .ndarray.ndarray import SPARSE_TYPES, NDArray, tensor_from_numpy
from .parallel.functional import check_concrete

__all__ = ["RowSparseNDArray", "CSRNDArray", "BaseSparseNDArray",
           "cast_storage", "row_sparse_array", "csr_matrix", "zeros",
           "retain", "dot", "add", "elemwise_add",
           "sgd_update", "sgd_mom_update", "adam_update", "adagrad_update"]


def _check_concrete():
    check_concrete(
        "sparse storage construction is data-dependent (nnz) and "
        "eager-only; inside a captured graph or a hybridized body keep "
        "dense storage")


def _tensor(x, device, dtype=None):
    """An NDArray, tensor, numpy array or list as a tensor on ``device``."""
    if isinstance(x, NDArray):
        t = x._data
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        t = tensor_from_numpy(np.asarray(x))
    t = t.detach().to(device)
    return t if dtype is None else t.to(dtype)


def _device(ctx, *likes):
    if ctx is not None:
        return resolve_device(ctx)
    for x in likes:
        if isinstance(x, NDArray):
            return x._data.device
        if isinstance(x, torch.Tensor):
            return x.device
    return current_context().device


class BaseSparseNDArray:
    """The surface the two storage classes share."""

    @property
    def context(self):
        from .context import context_of
        return context_of(self._data.device)

    ctx = context

    @property
    def dtype(self):
        return NDArray(self._data[:0]).dtype

    @property
    def ndim(self):
        return len(self.shape)

    def astype(self, dtype):
        from .base import dtype_torch
        out = self.copy()
        out._data = self._data.to(dtype_torch(dtype))
        return out

    def asnumpy(self):
        return self.tostype("default").asnumpy()

    def todense(self):
        return self.tostype("default")

    def __repr__(self):
        return (f"\n<{type(self).__name__} {self.shape} "
                f"nnz={self._data.shape[0]}>")


class RowSparseNDArray(BaseSparseNDArray):
    """``indices``: the stored row ids, sorted and unique (int32, shape
    ``(k,)``); ``data``: those k rows, shape ``(k,) + shape[1:]``."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape, ctx=None):
        dev = _device(ctx, data, indices)
        self._data = _tensor(data, dev)
        self._indices = _tensor(indices, dev, torch.int32)
        self.shape = tuple(shape)

    @property
    def data(self):
        return NDArray(self._data)

    @property
    def indices(self):
        return NDArray(self._indices)

    def copy(self):
        return RowSparseNDArray(self._data.clone(), self._indices.clone(),
                                self.shape)

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            dense = torch.zeros(self.shape, dtype=self._data.dtype,
                                device=self._data.device)
            dense[self._indices.long()] = self._data
            return NDArray(dense)
        raise ValueError(f"cannot cast row_sparse to {stype!r}")

    def __add__(self, other):
        return add(self, other)

    __radd__ = __add__

    def __mul__(self, scalar):
        if isinstance(scalar, (int, float)):
            return RowSparseNDArray(self._data * scalar, self._indices,
                                    self.shape)
        return NotImplemented

    __rmul__ = __mul__


class CSRNDArray(BaseSparseNDArray):
    """A 2-D compressed-sparse-row array."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape, ctx=None):
        dev = _device(ctx, data, indices, indptr)
        self._data = _tensor(data, dev)
        self._indices = _tensor(indices, dev, torch.int32)
        self._indptr = _tensor(indptr, dev, torch.int32)
        self.shape = tuple(shape)
        if len(self.shape) != 2:
            raise ValueError("csr storage is 2-D")

    @property
    def data(self):
        return NDArray(self._data)

    @property
    def indices(self):
        return NDArray(self._indices)

    @property
    def indptr(self):
        return NDArray(self._indptr)

    def copy(self):
        return CSRNDArray(self._data.clone(), self._indices.clone(),
                          self._indptr.clone(), self.shape)

    def _row_ids(self):
        """One row id per stored entry (int64)."""
        counts = (self._indptr[1:] - self._indptr[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(self.shape[0], device=self._data.device), counts,
            output_size=self._data.shape[0])

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            dense = torch.zeros(self.shape, dtype=self._data.dtype,
                                device=self._data.device)
            dense[self._row_ids(), self._indices.long()] = self._data
            return NDArray(dense)
        if stype == "row_sparse":
            return cast_storage(self.tostype("default"), "row_sparse")
        raise ValueError(f"cannot cast csr to {stype!r}")

    def __getitem__(self, key):
        """Row slices stay csr: ``csr[a:b]`` and ``csr[i]`` re-base
        indptr and take the covered entries."""
        if isinstance(key, int):
            if key < 0:
                key += self.shape[0]
            if not 0 <= key < self.shape[0]:
                raise IndexError(f"row {key} out of range {self.shape[0]}")
            key = slice(key, key + 1)
        if not isinstance(key, slice):
            raise TypeError("csr supports int/slice row indexing only")
        if key.step not in (None, 1):
            raise ValueError("csr row slicing requires step 1")
        a, b, _ = key.indices(self.shape[0])
        b = max(a, b)
        _check_concrete()
        lo, hi = int(self._indptr[a]), int(self._indptr[b])
        return CSRNDArray(self._data[lo:hi], self._indices[lo:hi],
                          self._indptr[a:b + 1] - lo, (b - a, self.shape[1]))


SPARSE_TYPES.update((RowSparseNDArray, CSRNDArray))


# ------------------------------------------------------------ construction --
def cast_storage(arr, stype):
    """``arr`` (an NDArray, or a sparse array) in storage ``stype``."""
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    if not isinstance(arr, NDArray):
        arr = NDArray(_tensor(arr, current_context().device))
    if stype == "default":
        return arr
    _check_concrete()
    d = arr._data.detach()
    if stype == "row_sparse":
        # only the per-row occupancy crosses to the host; the kept rows
        # are a gather on the array's device
        mask = (d != 0).reshape(d.shape[0], -1).any(1) if d.dim() > 1 \
            else d != 0
        idx = torch.nonzero(mask).reshape(-1)
        return RowSparseNDArray(d[idx], idx.to(torch.int32), d.shape)
    if stype == "csr":
        if d.dim() != 2:
            raise ValueError("csr storage is 2-D")
        mask = d != 0
        indptr = torch.cat([torch.zeros(1, dtype=torch.int64,
                                        device=d.device),
                            torch.cumsum(mask.sum(1), 0)])
        rows, cols = torch.nonzero(mask, as_tuple=True)
        return CSRNDArray(d[rows, cols], cols.to(torch.int32),
                          indptr.to(torch.int32), d.shape)
    raise ValueError(f"unknown storage type {stype!r}")


def row_sparse_array(arg, shape=None, ctx=None, dtype=None):
    """From ``(data, indices)`` or from a dense array."""
    from .base import dtype_torch
    dt = None if dtype is None else dtype_torch(dtype)
    if isinstance(arg, tuple) and len(arg) == 2:
        data, indices = arg
        dev = _device(ctx, data, indices)
        data = _tensor(data, dev, dt)
        indices = _tensor(indices, dev, torch.int32)
        if shape is None:
            shape = (int(indices.max()) + 1,) + tuple(data.shape[1:])
        return RowSparseNDArray(data, indices, shape)
    dev = _device(ctx, arg)
    return cast_storage(NDArray(_tensor(arg, dev, dt)), "row_sparse")


def csr_matrix(arg, shape=None, ctx=None, dtype=None):
    """From ``(data, indices, indptr)`` or from a dense array."""
    from .base import dtype_torch
    dt = None if dtype is None else dtype_torch(dtype)
    if isinstance(arg, tuple) and len(arg) == 3:
        data, indices, indptr = arg
        dev = _device(ctx, data, indices, indptr)
        return CSRNDArray(_tensor(data, dev, dt), _tensor(indices, dev),
                          _tensor(indptr, dev), shape)
    dev = _device(ctx, arg)
    return cast_storage(NDArray(_tensor(arg, dev, dt)), "csr")


def zeros(stype, shape, ctx=None, dtype="float32"):
    """An empty sparse array (or dense zeros for ``"default"``)."""
    from .base import dtype_torch
    dt = dtype_torch(dtype)
    dev = resolve_device(ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + tuple(shape[1:]), dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev), shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int32, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int32,
                                      device=dev), shape)
    return NDArray(torch.zeros(tuple(shape), dtype=dt, device=dev))


# ------------------------------------------------------------------- ops ----
def retain(rsp, indices):
    """Keep only the requested rows."""
    if not isinstance(rsp, RowSparseNDArray):
        raise TypeError("retain takes a RowSparseNDArray")
    want = _tensor(indices, rsp._data.device, torch.int32)
    _check_concrete()
    keep = torch.nonzero(torch.isin(rsp._indices, want)).reshape(-1)
    return RowSparseNDArray(rsp._data[keep], rsp._indices[keep], rsp.shape)


def _dense_of(x, device):
    return x._data if isinstance(x, NDArray) else _tensor(x, device)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse products (the reference's dispatch table): csr × dense and
    csrᵀ × dense (segment sums over the stored entries), dense × csr and
    dense × csrᵀ (the same, transposed), dense × rsp and dense × rspᵀ,
    and rspᵀ × dense (the embedding gradient's contraction).  A dense
    lhs with a sparse rhs gives a dense result."""
    if transpose_a and transpose_b:
        raise ValueError("sparse dot supports at most one transposed side")
    if isinstance(lhs, NDArray) and isinstance(rhs, BaseSparseNDArray):
        if transpose_a:
            raise NotImplementedError("dense-lhs sparse dot with "
                                      "transpose_a is not in the reference "
                                      "dispatch table either")
        dense = lhs._data
        if isinstance(rhs, CSRNDArray):
            out = dot(rhs, NDArray(dense.T), transpose_a=not transpose_b)
            return NDArray(out._data.T)
        if rhs._data.dim() != 2:
            raise NotImplementedError("dense×rsp dot supports 2-D values")
        if dense.shape[-1] != rhs.shape[1 if transpose_b else 0]:
            raise ValueError(f"dot shape mismatch: dense {tuple(dense.shape)}"
                             f" × rsp{'ᵀ' if transpose_b else ''} "
                             f"{rhs.shape}")
        idx = rhs._indices.long()
        if transpose_b:
            out = torch.zeros((dense.shape[0], rhs.shape[0]),
                              dtype=rhs._data.dtype, device=dense.device)
            out[:, idx] = dense @ rhs._data.T
            return NDArray(out.to(dense.dtype))
        return NDArray((dense[:, idx] @ rhs._data).to(dense.dtype))
    if transpose_b:
        raise NotImplementedError("transpose_b requires a dense lhs with a "
                                  "sparse rhs (reference dispatch table)")
    if isinstance(lhs, CSRNDArray):
        dense = _dense_of(rhs, lhs._data.device)
        vec = dense.dim() == 1
        if vec:
            dense = dense[:, None]
        rows = lhs._row_ids()
        cols = lhs._indices.long()
        vals = lhs._data[:, None].to(dense.dtype)
        if not transpose_a:
            # out[i, :] = Σ_j csr[i, j] · dense[j, :]
            out = torch.zeros((lhs.shape[0], dense.shape[1]),
                              dtype=dense.dtype, device=dense.device)
            out.index_add_(0, rows, dense[cols] * vals)
        else:
            # out[j, :] = Σ_i csr[i, j] · dense[i, :]
            out = torch.zeros((lhs.shape[1], dense.shape[1]),
                              dtype=dense.dtype, device=dense.device)
            out.index_add_(0, cols, dense[rows] * vals)
        return NDArray(out[:, 0] if vec else out)
    if isinstance(lhs, RowSparseNDArray) and transpose_a:
        if lhs._data.dim() != 2:
            raise NotImplementedError("rsp dot supports 2-D values")
        dense = _dense_of(rhs, lhs._data.device)
        return NDArray(lhs._data.T @ dense[lhs._indices.long()])
    raise TypeError(f"unsupported sparse dot operands "
                    f"{type(lhs).__name__}, {type(rhs).__name__}")


def add(a, b):
    """rsp + rsp -> rsp (the union of rows, overlaps summed); rsp + dense
    -> dense."""
    if isinstance(a, RowSparseNDArray) and isinstance(b, RowSparseNDArray):
        if a.shape != b.shape:
            raise ValueError(f"add: shapes {a.shape} and {b.shape}")
        _check_concrete()
        union, inv = torch.unique(torch.cat([a._indices, b._indices]),
                                  sorted=True, return_inverse=True)
        dt = torch.promote_types(a._data.dtype, b._data.dtype)
        out = torch.zeros((union.shape[0],) + tuple(a._data.shape[1:]),
                          dtype=dt, device=a._data.device)
        out.index_add_(0, inv, torch.cat([a._data.to(dt), b._data.to(dt)]))
        return RowSparseNDArray(out, union.to(torch.int32), a.shape)
    if isinstance(a, RowSparseNDArray) and isinstance(b, NDArray):
        return NDArray(b._data.index_add(0, a._indices.long(),
                                         a._data.to(b._data.dtype)))
    if isinstance(b, RowSparseNDArray) and isinstance(a, NDArray):
        return add(b, a)
    raise TypeError("unsupported sparse add operands")


elemwise_add = add


# ------------------------------------------------- lazy optimizer updates ---
def _rows(weight, grad, rescale_grad, clip_gradient):
    """The gradient's row ids and rows in the weight's dtype, rescaled
    and clipped."""
    if not isinstance(grad, RowSparseNDArray):
        raise TypeError("a lazy update takes a RowSparseNDArray gradient")
    g = grad._data.to(weight._data.dtype) * rescale_grad
    if clip_gradient is not None:
        g = g.clamp(-clip_gradient, clip_gradient)
    return grad._indices.long(), g


def _put_rows(t, idx, rows):
    """``t`` with ``rows`` written at ``idx``: a new tensor."""
    return t.detach().index_copy(0, idx, rows)


def _set_rows(state, idx, rows):
    """Write ``rows`` into the state array's own tensor at ``idx``."""
    with torch.no_grad():
        state._data.index_copy_(0, idx, rows)


def _sgd_rows(weight, grad, lr, wd, rescale_grad, clip_gradient):
    idx, g = _rows(weight, grad, rescale_grad, clip_gradient)
    w = weight._data.detach()[idx]
    return idx, w - lr * (g + wd * w)


def _sgd_mom_rows(weight, grad, mom, lr, momentum, wd, rescale_grad,
                  clip_gradient):
    idx, g = _rows(weight, grad, rescale_grad, clip_gradient)
    w = weight._data.detach()[idx]
    m = momentum * mom._data[idx] - lr * (g + wd * w)
    _set_rows(mom, idx, m)
    return idx, w + m


def _adam_rows(weight, grad, mean, var, t, lr, beta1, beta2, epsilon, wd,
               rescale_grad, clip_gradient):
    idx, g = _rows(weight, grad, rescale_grad, clip_gradient)
    w = weight._data.detach()[idx]
    g = g + wd * w
    m = beta1 * mean._data[idx] + (1 - beta1) * g
    v = beta2 * var._data[idx] + (1 - beta2) * g * g
    lr_t = lr * np.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
    _set_rows(mean, idx, m)
    _set_rows(var, idx, v)
    return idx, w - lr_t * m / (torch.sqrt(v) + epsilon)


def _adagrad_rows(weight, grad, history, lr, epsilon, wd, rescale_grad,
                  clip_gradient):
    idx, g = _rows(weight, grad, rescale_grad, clip_gradient)
    w = weight._data.detach()[idx]
    g = g + wd * w
    h = history._data[idx] + g * g
    _set_rows(history, idx, h)
    return idx, w - lr * g / (torch.sqrt(h) + epsilon)


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=None):
    """Lazy SGD: the new weight; rows outside the gradient are the
    weight's (weight decay applies to the gradient's rows only)."""
    idx, rows = _sgd_rows(weight, grad, lr, wd, rescale_grad, clip_gradient)
    return NDArray(_put_rows(weight._data, idx, rows))


def sgd_mom_update(weight, grad, mom, lr, momentum=0.9, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """Lazy momentum SGD: the new weight; ``mom``'s rows of the gradient
    are written in place, the others keep their values."""
    idx, rows = _sgd_mom_rows(weight, grad, mom, lr, momentum, wd,
                              rescale_grad, clip_gradient)
    return NDArray(_put_rows(weight._data, idx, rows))


def adam_update(weight, grad, mean, var, t, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=None,
                lazy_update=True):
    """Lazy Adam (the bias correction folded into the step size)."""
    idx, rows = _adam_rows(weight, grad, mean, var, t, lr, beta1, beta2,
                           epsilon, wd, rescale_grad, clip_gradient)
    return NDArray(_put_rows(weight._data, idx, rows))


def adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=None):
    """Lazy AdaGrad."""
    idx, rows = _adagrad_rows(weight, grad, history, lr, epsilon, wd,
                              rescale_grad, clip_gradient)
    return NDArray(_put_rows(weight._data, idx, rows))
