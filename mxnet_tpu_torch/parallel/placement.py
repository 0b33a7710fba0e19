"""Sharded leaves: what a rank holds of a parameter that ``ShardingRules``
split over the mesh, and how the forward uses it.

A ``TrainStep``/``EvalStep`` with ``rules=`` keeps, of each leaf whose
``PartitionSpec`` splits it over an axis of size > 1, only this rank's
block (``Placement.local``); the leaf tensor carries its ``Placement``
as ``t._placement``.  Inside the forward such a leaf is used in one of
two ways, and neither changes what the net computes (GSPMD's rule: a
layout moves values, it never alters them):

- **where used, gathered** (``full``): the blocks all-gathered into the
  whole parameter at the point of use — ``Parameter.tensor()`` does this
  for every layer that does not take blocks.  The gradient comes back as
  this rank's block: summed over the axes that split the batch (``dp``,
  ``fsdp``: a reduce-scatter), taken as it is over the others (their
  ranks hold the same rows, so the same gradient).  Inside
  ``regathering()`` an autograd graph does not keep the gathered copy
  for the backward: it keeps the block and gathers again when the
  backward needs the value (ZeRO-3's "free after use").
- **by its block** (``linear``, ``embedding``): the layers that own such
  leaves take them as blocks (``HybridBlock._takes_blocks``) and call
  these themselves; the registry's ops never see a block.  A ``Dense``
  whose weight is split over a non-batch axis multiplies by its block —
  column-parallel for ``(axis, None)`` (the outputs' blocks gathered),
  row-parallel for ``(None, axis)`` (the partial products summed) — and
  an ``Embedding`` split on its feature dim looks rows up in its block.
  ``PipelineStack`` and ``MoEFFN`` take their blocks of the stacked
  leaves the same way.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch

from . import mesh as _mesh

__all__ = ["Placement", "placement_of", "place", "full", "regathering",
           "linear", "embedding", "split_axis", "batch_split", "gather_rows"]


def _entry_axes(mesh, entry):
    """The axes of size > 1 of one spec entry, major first."""
    names = entry if isinstance(entry, (tuple, list)) else (entry,)
    return tuple(a for a in names
                 if isinstance(a, str) and mesh.shape.get(a, 1) > 1)


class Placement:
    """How one leaf of ``shape`` lies over ``mesh`` under ``spec``."""

    def __init__(self, mesh, spec, shape):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.split = {d: _entry_axes(mesh, e)
                      for d, e in enumerate(self.spec)
                      if _entry_axes(mesh, e)}

    @property
    def axes(self):
        """Every axis that splits the leaf."""
        return tuple(a for d in sorted(self.split) for a in self.split[d])

    def __repr__(self):
        return f"Placement({self.spec}, {self.shape})"

    def local(self, full_value):
        """This rank's block of the whole value."""
        x = full_value
        for d, axes in self.split.items():
            for a in axes:                      # major first
                x = _mesh._block(self.mesh, a, x, d)
        return x

    def gather(self, local):
        """The whole value from every rank's block (not differentiable)."""
        x = local
        for d, axes in self.split.items():
            for a in reversed(axes):            # minor first
                x = _mesh._raw_gather(self.mesh, a, x, d)
        return x

    def grad_block(self, g):
        """This rank's block of the gradient of the whole value: summed
        over the batch axes that split the leaf, as it is over the
        others."""
        for d, axes in self.split.items():
            for a in axes:
                if a in _mesh.BATCH_AXES:
                    g = _mesh._raw_psum(self.mesh, a, g)
                g = _mesh._block(self.mesh, a, g, d)
        return g.contiguous()


def placement_of(t):
    """The ``Placement`` a leaf carries, or None for a whole tensor."""
    return getattr(t, "_placement", None) if t is not None else None


def place(t, placement):
    """Mark ``t`` (a rank's block) as held under ``placement``."""
    t._placement = placement
    return t


# ------------------------------------------------------- gather at use --
_tls = threading.local()
_gathered = {}            # storage pointer -> (local, placement)
_lock = threading.Lock()


def _forget(ptr):
    with _lock:
        _gathered.pop(ptr, None)


class _Full(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, placement, leaf=True):
        ctx.placement = placement
        out = placement.gather(local)
        if leaf and getattr(_tls, "depth", 0):
            ptr = out.untyped_storage().data_ptr()
            with _lock:
                _gathered[ptr] = (local.detach(), placement)
            weakref.finalize(out, _forget, ptr)
        return out

    @staticmethod
    def backward(ctx, g):
        return ctx.placement.grad_block(g), None, None


def full(t):
    """The whole value of a leaf (gathered where it is used, with its
    gradient returned as this rank's block); other tensors as they are."""
    p = placement_of(t)
    if p is None:
        return t
    if not torch.is_grad_enabled() or not t.requires_grad:
        return p.gather(t)
    return _Full.apply(t, p)


def _pack(x):
    with _lock:
        hit = _gathered.get(x.untyped_storage().data_ptr())
    if hit is None:
        return x
    local, placement = hit
    return ("regather", local, placement, tuple(x.shape), x.stride(),
            x.storage_offset())


def _unpack(saved):
    if isinstance(saved, tuple):
        _, local, placement, size, stride, offset = saved
        return placement.gather(local).as_strided(size, stride, offset)
    return saved


@contextlib.contextmanager
def regathering():
    """Inside, a gathered leaf that the autograd graph saves for the
    backward is saved as its block and gathered again when used."""
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
            yield
    finally:
        _tls.depth -= 1


def batch_split():
    """``(mesh, axes)`` inside a step whose batch is split over ranks and
    whose ops see the global batch (the f32 ``TrainStep``'s
    ``ops.nn.stats_over``, an ``EvalStep`` over such a mesh); else None."""
    from ..ops import nn as _nn
    mesh = _mesh.current_mesh()
    if _nn._STATS_OVER is None or mesh is None:
        return None
    axes = tuple(a for a in _mesh.BATCH_AXES if mesh.shape.get(a, 1) > 1)
    return (mesh, axes) if axes else None


def gather_rows(x, mesh, axes):
    """Every batch rank's rows of ``x`` in the global batch's order, and
    the ``Placement`` that takes this rank's rows back; the gradient of
    the gathered rows is summed over the ranks, this rank's kept."""
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    where = Placement(mesh, (axes,) + (None,) * (x.dim() - 1),
                      (x.shape[0] * n,) + tuple(x.shape[1:]))
    if torch.is_grad_enabled() and x.requires_grad:
        return _Full.apply(x, where, False), where
    return where.gather(x), where


# ------------------------------------------------------ use by its block --
def split_axis(placement, dim):
    """The one non-batch axis that splits ``dim`` and no other dim, or
    None."""
    if placement is None or set(placement.split) != {dim}:
        return None
    axes = placement.split[dim]
    if len(axes) != 1 or axes[0] in _mesh.BATCH_AXES:
        return None
    return axes[0]


def linear(x, weight, bias=None):
    """``x @ weight.T + bias`` with a sharded ``weight``: by its block
    where it is split over one non-batch axis, by rows (column-parallel)
    or by columns (row-parallel); gathered where used otherwise."""
    pw = placement_of(weight)
    col, row = split_axis(pw, 0), split_axis(pw, 1)
    if col is not None:
        y = torch.matmul(_mesh.copy_to(x, col), weight.t())
        if bias is not None:
            b = bias if split_axis(placement_of(bias), 0) == col \
                else _mesh.scatter_to(full(bias), col, 0)
            y = y + b
        return _mesh.gather_from(y, col, -1)
    if row is not None:
        y = _mesh.reduce_from(torch.matmul(_mesh.scatter_to(x, row, -1),
                                           weight.t()), row)
        return y if bias is None else y + full(bias)
    y = torch.matmul(x, full(weight).t())
    return y if bias is None else y + full(bias)


def embedding(data, weight):
    """Rows of a sharded embedding table at the integer ``data`` (clipped
    into the table, as the ``Embedding`` op clips): looked up in the
    block where the feature dim is split over one non-batch axis (the
    features gathered after), gathered where used otherwise."""
    idx = data.long().clamp(0, placement_of(weight).shape[0] - 1)
    axis = split_axis(placement_of(weight), 1)
    if axis is None:
        return torch.nn.functional.embedding(idx, full(weight))
    return _mesh.gather_from(torch.nn.functional.embedding(idx, weight),
                             axis, -1)
