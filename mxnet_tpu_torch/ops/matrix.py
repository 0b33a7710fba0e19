"""Matrix, shape and indexing ops (the port of
``mxnet_tpu/ops/matrix.py``).

Indices handed to torch (``take``, ``pick``, ``one_hot``,
``Embedding``, ``gather_nd``) are cast to int64 at the op; out-of-range
indices clip, as the JAX ops clip them (``take`` can wrap instead, and
``one_hot`` gives a row of zeros, as ``jax.nn.one_hot`` does).
"""
from __future__ import annotations

import torch

from ..base import dtype_torch
from .registry import register_op

__all__ = ["pick", "Embedding", "gather_nd"]


# ------------------------------------------------------------------- dot ----
@register_op("dot")
def _dot(a, b, transpose_a=False, transpose_b=False):
    """Contract the last axis of ``a`` with the first of ``b``
    (``transpose_a`` moves ``a``'s first axis last, ``transpose_b``
    ``b``'s last axis first)."""
    if transpose_a and a.dim() > 1:
        a = torch.movedim(a, 0, -1)
    if transpose_b and b.dim() > 1:
        b = torch.movedim(b, -1, 0)
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=1)


def _t(x, flag):
    return x.transpose(-1, -2) if flag else x


@register_op("batch_dot")
def _batch_dot(a, b, transpose_a=False, transpose_b=False):
    return torch.matmul(_t(a, transpose_a), _t(b, transpose_b))


@register_op("linalg_gemm2")
def _linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0,
                  axis=-2):
    return alpha * torch.matmul(_t(a, transpose_a), _t(b, transpose_b))


@register_op("linalg_gemm")
def _linalg_gemm(a, b, c, transpose_a=False, transpose_b=False, alpha=1.0,
                 beta=1.0, axis=-2):
    return alpha * torch.matmul(_t(a, transpose_a), _t(b, transpose_b)) \
        + beta * c


@register_op("linalg_potrf")
def _potrf(a):
    return torch.linalg.cholesky(a)


def _solve_triangular(a, b, lower, trans):
    if trans:
        a, lower = a.transpose(-1, -2), not lower
    return torch.linalg.solve_triangular(a, b, upper=not lower)


@register_op("linalg_trsm")
def _trsm(a, b, transpose=False, rightside=False, lower=True, alpha=1.0):
    if rightside:
        # X A = alpha B  <=>  A^T X^T = alpha B^T
        out = _solve_triangular(a.transpose(-1, -2),
                                (alpha * b).transpose(-1, -2),
                                not lower, transpose)
        return out.transpose(-1, -2)
    return _solve_triangular(a, alpha * b, lower, transpose)


@register_op("linalg_syrk")
def _syrk(a, transpose=False, alpha=1.0):
    at = a.transpose(-1, -2)
    return alpha * (torch.matmul(at, a) if transpose else torch.matmul(a, at))


@register_op("linalg_extractdiag")
def _extractdiag(a, offset=0):
    return torch.diagonal(a, offset=offset, dim1=-2, dim2=-1)


@register_op("linalg_sumlogdiag")
def _sumlogdiag(a):
    return torch.sum(torch.log(torch.diagonal(a, dim1=-2, dim2=-1)), dim=-1)


# ----------------------------------------------------------------- shape ----
@register_op("reshape", aliases=("Reshape",))
def _reshape(x, shape=None, reverse=False):
    """The reference's special codes: 0 copies a dim, -1 infers one, -2
    copies the rest, -3 merges two, -4 splits one into the next two."""
    if shape is None:
        return x
    shape = list(shape)
    src = list(x.shape)
    if reverse:
        src, shape = src[::-1], shape[::-1]
    out = []
    i = j = 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i]); i += 1
        elif s == -1:
            out.append(-1); i += 1
        elif s == -2:
            out.extend(src[i:]); i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1]); i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b]); i += 1; j += 2
        else:
            out.append(s); i += 1
        j += 1
    if reverse:
        out = out[::-1]
    if -1 in out:
        known = 1
        for s in out:
            if s != -1:
                known *= s
        out[out.index(-1)] = x.numel() // known if known else 0
    return x.reshape(out)


@register_op("reshape_like")
def _reshape_like(x, y):
    return x.reshape(y.shape)


@register_op("shape_array")
def _shape_array(x):
    return torch.tensor(x.shape, dtype=torch.int32, device=x.device)


@register_op("size_array")
def _size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int32, device=x.device)


@register_op("transpose")
def _transpose(x, axes=None):
    if axes is None or len(axes) == 0:
        axes = tuple(reversed(range(x.dim())))
    return x.permute(*axes)


@register_op("swapaxes", aliases=("SwapAxis",))
def _swapaxes(x, dim1=0, dim2=0):
    return x.transpose(dim1, dim2)


@register_op("expand_dims")
def _expand_dims(x, axis=0):
    return x.unsqueeze(axis)


@register_op("squeeze")
def _squeeze(x, axis=None):
    return x.squeeze() if axis is None else x.squeeze(axis)


@register_op("flatten", aliases=("Flatten",))
def _flatten(x):
    return x.reshape(x.shape[0], -1)


@register_op("broadcast_to")
def _broadcast_to(x, shape=None):
    tgt = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return torch.broadcast_to(x, tgt)


@register_op("broadcast_like")
def _broadcast_like(x, y):
    return torch.broadcast_to(x, y.shape)


@register_op("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(x, axis=(), size=()):
    if isinstance(axis, int):
        axis = (axis,)
    if isinstance(size, int):
        size = (size,)
    tgt = list(x.shape)
    for a, s in zip(axis, size):
        tgt[a] = s
    return torch.broadcast_to(x, tgt)


@register_op("tile")
def _tile(x, reps=()):
    return torch.tile(x, tuple(reps))


@register_op("repeat")
def _repeat(x, repeats=1, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@register_op("flip", aliases=("reverse",))
def _flip(x, axis=()):
    if axis is None:
        axis = tuple(range(x.dim()))
    elif isinstance(axis, int):
        axis = (axis,)
    return torch.flip(x, dims=tuple(axis)) if axis else x.clone()


def _pad_index(n, before, after, mode, device):
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)                       # reflect, edge not repeated
    i = torch.remainder(i, period) if period else torch.zeros_like(i)
    return torch.where(i >= n, period - i, i)


@register_op("pad", aliases=("Pad",))
def _pad(x, mode="constant", pad_width=(), constant_value=0.0):
    """``pad_width`` is the flattened (before, after) list per axis,
    from axis 0, as in the reference."""
    pw = list(pad_width)
    pairs = [(pw[i], pw[i + 1]) for i in range(0, len(pw), 2)]
    pairs += [(0, 0)] * (x.dim() - len(pairs))
    if mode == "constant":
        flat = []
        for before, after in reversed(pairs):
            flat += [before, after]
        return torch.nn.functional.pad(x, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError(f"unknown pad mode {mode!r}")
    for ax, (before, after) in enumerate(pairs):
        if before or after:
            x = x.index_select(ax, _pad_index(x.shape[ax], before, after,
                                              mode, x.device))
    return x


@register_op("concat", aliases=("Concat", "concatenate"))
def _concat(*xs, dim=1, num_args=None):
    return torch.cat(xs, dim=dim)


@register_op("stack")
def _stack(*xs, axis=0, num_args=None):
    return torch.stack(xs, dim=axis)


def _outputs(outs, axis, squeeze_axis):
    if squeeze_axis:
        outs = [o.squeeze(axis) for o in outs]
    return tuple(outs) if len(outs) > 1 else outs[0]


@register_op("split", aliases=("SliceChannel",))
def _split(x, num_outputs=1, axis=1, squeeze_axis=False):
    if x.shape[axis] % num_outputs:
        raise ValueError(f"split: axis {axis} of length {x.shape[axis]} "
                         f"does not divide into {num_outputs} sections")
    return _outputs(torch.split(x, x.shape[axis] // num_outputs, dim=axis),
                    axis, squeeze_axis)


@register_op("split_v2")
def _split_v2(x, indices=(), axis=0, squeeze_axis=False, sections=0):
    if sections:
        return _split(x, sections, axis, squeeze_axis)
    return _outputs(torch.tensor_split(x, list(indices), dim=axis), axis,
                    squeeze_axis)


def _slice_dim(x, dim, begin, end, step):
    """``x[..., begin:end:step, ...]`` on ``dim``; a negative step goes
    through an index (torch's slices take positive steps only)."""
    if step is None or step > 0:
        sl = [slice(None)] * x.dim()
        sl[dim] = slice(begin, end, step)
        return x[tuple(sl)]
    idx = list(range(*slice(begin, end, step).indices(x.shape[dim])))
    return x.index_select(dim, torch.tensor(idx, dtype=torch.long,
                                            device=x.device))


@register_op("slice")
def _slice(x, begin=(), end=(), step=()):
    step = list(step) if step else [None] * len(begin)
    for d, (b, e, s) in enumerate(zip(begin, end, step)):
        x = _slice_dim(x, d, b, e, s)
    return x


@register_op("slice_axis")
def _slice_axis(x, axis=0, begin=0, end=None):
    return _slice_dim(x, axis, begin, end, None)


@register_op("slice_like")
def _slice_like(x, y, axes=()):
    sl = [slice(None)] * x.dim()
    if not axes:
        axes = range(min(x.dim(), y.dim()))
    for a in axes:
        sl[a] = slice(0, y.shape[a])
    return x[tuple(sl)]


# -------------------------------------------------------------- indexing ----
@register_op("take")
def _take(a, indices, axis=0, mode="clip"):
    axis = axis % a.dim()
    n = a.shape[axis]
    idx = indices.long()
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register_op("Embedding", aliases=("embedding",))
def Embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False):
    """Rows of ``weight`` at the integer ``data``, the indices clipped
    into ``[0, input_dim)`` as the JAX op clips them."""
    idx = data.long().clamp(0, weight.shape[0] - 1)
    return torch.nn.functional.embedding(idx, weight)


@register_op("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data[..., index, ...]`` along ``axis``, one entry per row; the
    index is clipped into range, as the JAX op clips it."""
    if mode != "clip":
        raise ValueError(f"pick: mode {mode!r} is not ported (clip only)")
    idx = index.long().clamp(0, data.shape[axis] - 1).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


@register_op("gather_nd")
def gather_nd(data, indices):
    """``data[indices[0], ..., indices[M-1]]``: ``indices`` of shape
    ``(M, ...)`` index the first M dims of ``data``.  Negative indices
    count from the end and out-of-range ones clamp, as JAX's gather
    treats them."""
    idx = indices.long()
    parts = []
    for i in range(idx.shape[0]):
        n = data.shape[i]
        parts.append(torch.where(idx[i] < 0, idx[i] + n, idx[i])
                     .clamp(0, n - 1))
    return data[tuple(parts)]


@register_op("scatter_nd")
def _scatter_nd(data, indices, shape=None):
    idx = indices.long()
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data)


@register_op("one_hot")
def _one_hot(indices, depth=0, on_value=1.0, off_value=0.0,
             dtype="float32"):
    cols = torch.arange(depth, device=indices.device)
    oh = (indices.long().unsqueeze(-1) == cols).to(dtype_torch(dtype))
    return oh * on_value + (1.0 - oh) * off_value


@register_op("diag")
def _diag(x, k=0, axis1=0, axis2=1):
    if x.dim() == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=axis1, dim2=axis2)


@register_op("depth_to_space")
def _depth_to_space(x, block_size=1):
    b, c, h, w = x.shape
    bs = block_size
    y = x.reshape(b, bs, bs, c // (bs * bs), h, w)
    y = y.permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, c // (bs * bs), h * bs, w * bs)


@register_op("space_to_depth")
def _space_to_depth(x, block_size=1):
    b, c, h, w = x.shape
    bs = block_size
    y = x.reshape(b, c, h // bs, bs, w // bs, bs)
    y = y.permute(0, 3, 5, 1, 2, 4)
    return y.reshape(b, c * bs * bs, h // bs, w // bs)


@register_op("meshgrid_like")
def _arange_like(x, axis=0, start=0.0, step=1.0):
    n = x.shape[axis]
    return start + step * torch.arange(n, dtype=torch.float32,
                                       device=x.device)


@register_op("masked_fill")
def _masked_fill(x, mask, value=0.0):
    return torch.where(mask != 0, torch.full((), value, dtype=x.dtype,
                                             device=x.device), x)
