"""Device mesh management (the port of ``mxnet_tpu/parallel/mesh.py``).

A mesh names the axes of parallelism over the world's ranks, one card
each (``distributed``: one process per card):

    dp    data parallel (batch sharded; gradients all-reduced)
    fsdp  ZeRO-style parameter sharding on top of dp traffic
    tp    tensor parallel
    pp    pipeline parallel
    sp    sequence/context parallel
    ep    expert parallel

``make_mesh(dp=2)`` lays the ranks out as the JAX package lays out its
devices (the same axis order, ``-1`` inference and errors).  A mesh's
``devices`` are ranks, ``shape`` and ``axis_names`` are as in JAX, and
each axis has its process group (``group(axis)``: the ranks that share
this rank's coordinates on every other axis), taken from a
``torch.distributed.device_mesh.DeviceMesh`` over the world where an
axis spans less than the world.

``shard_map(f, mesh=..., in_specs=..., out_specs=...)`` runs ``f`` on
this rank's local shard: each process already holds its shard (the
multi-process semantics of the JAX package, where each process feeds
its local data), so the inputs pass through and the collectives inside
``f`` are named by axis (``psum``, ``pmean``, ``all_gather``,
``all_to_all``, ``ppermute``, ``axis_index``, ``axis_size``) and run
over that axis's group, whichever axis it is.

The model-parallel layers keep GSPMD's meaning (a layout changes where
values live, never what they are) with four differentiable crossings
between a value every rank of an axis holds alike ("replicated") and
one each rank holds part of, Megatron's f/g pairs:

- ``copy_to(x, axis)``: identity; the backward sums the gradient over
  the axis (a replicated value entering a computation split over it);
- ``reduce_from(x, axis)``: the sum over the axis; the backward passes
  the (replicated) gradient through;
- ``scatter_to(x, axis, dim)``: this rank's block of ``dim``; the
  backward gathers the blocks' gradients;
- ``gather_from(x, axis, dim)``: the blocks concatenated along ``dim``;
  the backward takes this rank's block of the gradient — not a sum over
  the axis, as the consumers downstream are replicated.

Each is the identity on an axis of size 1.
"""
from __future__ import annotations

import functools
import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import distributed as _dist

__all__ = ["AXES", "Mesh", "PartitionSpec", "NamedSharding", "make_mesh",
           "current_mesh", "default_mesh", "MeshScope", "replicated",
           "named_sharding", "shard_map", "validate_specs", "psum", "pmean",
           "all_gather", "all_to_all", "ppermute", "axis_index", "axis_size",
           "all_to_all_grad", "copy_to", "reduce_from", "scatter_to",
           "gather_from", "BATCH_AXES"]

# Canonical axis order: collectives that ride adjacent devices (tp, sp)
# go last, as in the JAX package.
AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

#: the axes that split the batch (the rest see the same rows)
BATCH_AXES = ("dp", "fsdp")

_tls = threading.local()


class PartitionSpec(tuple):
    """A spec per array dimension: an axis name, a tuple of names, or
    None (replicated along that dimension), as ``jax.sharding.
    PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding:
    """``(mesh, spec)``: how an array lies over a mesh."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) \
            and other.mesh is self.mesh and other.spec == self.spec

    def __hash__(self):
        return hash((id(self.mesh), self.spec))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


class Mesh:
    """Ranks laid out on named axes."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, self.devices.shape))
        self._groups = {}
        self._device_mesh = None

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({dict(self.shape)})"

    def covers_world(self):
        """Whether the mesh's devices are exactly this world's ranks."""
        return sorted(int(d) for d in self.devices.flat) == \
            list(range(_dist.num_workers()))

    def coords(self, rank=None):
        """This rank's coordinate on each axis."""
        rank = _dist.rank() if rank is None else rank
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self!r}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` over the same ranks (made at first use: every
        rank must ask for it, as it makes the axes' process groups)."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            kind = "cuda" if _dist.backend() == "nccl" else "cpu"
            self._device_mesh = DeviceMesh(
                kind, self.devices.tolist(), mesh_dim_names=self.axis_names)
        return self._device_mesh

    def on_groups(self, groups):
        """The same mesh with ``groups`` (axis -> process group) as the
        groups of those axes: collectives over it run in those groups
        (e.g. a second group over the same ranks, so two threads' steps
        never share one)."""
        other = Mesh(self.devices, self.axis_names)
        other._groups = dict(groups)
        return other

    def group(self, axis):
        """The process group of ``axis`` for this rank, or None where a
        collective over it has nothing to do (no process group, or an
        axis of size 1 in a larger world).  An axis over the whole world
        is the world's group, even a world of one: its collectives are
        real ones."""
        if axis in self._groups:
            return self._groups[axis]
        if not _dist.is_initialized():
            return None
        from torch import distributed as dist
        if self.shape[axis] == _dist.num_workers():
            return dist.group.WORLD
        if self.shape[axis] == 1:
            return None
        if axis not in self._groups:
            self._groups[axis] = self.device_mesh.get_group(axis)
        return self._groups[axis]


def _spec_axis_names(specs):
    """Every axis name in a pytree of specs."""
    out = []

    def walk(s):
        if isinstance(s, PartitionSpec):
            for entry in s:
                names = entry if isinstance(entry, tuple) else (entry,)
                out.extend(n for n in names if isinstance(n, str))
        elif isinstance(s, (tuple, list)):
            for x in s:
                walk(x)
        elif isinstance(s, dict):
            for x in s.values():
                walk(x)
    walk(specs)
    return out


def validate_specs(mesh, in_specs=None, out_specs=None):
    """Raise ``ValueError`` naming the axis when an in/out spec names a
    mesh axis that does not exist."""
    axes = set(getattr(mesh, "axis_names", ()) or ())
    if not axes:
        return
    for role, specs in (("in_specs", in_specs), ("out_specs", out_specs)):
        for name in _spec_axis_names(specs):
            if name not in axes:
                raise ValueError(
                    f"shard_map {role} names axis {name!r}, which is "
                    f"not one of the mesh axes {tuple(sorted(axes))} — "
                    f"a typo'd axis would otherwise fail deep inside "
                    f"jax (or silently change the partitioning)")


def shard_map(f=None, *, mesh=None, in_specs=None, out_specs=None, **kw):
    """``f`` on this rank's local shard, its collectives named by axis
    over ``mesh`` (the current mesh when None).  Curries when ``f`` is
    None; ``check_vma``/``check_rep`` are accepted and ignored."""
    if mesh is not None:
        validate_specs(mesh, in_specs, out_specs)
    if f is None:
        return lambda g: shard_map(g, mesh=mesh, in_specs=in_specs,
                                   out_specs=out_specs, **kw)

    @functools.wraps(f)
    def run(*args, **kwargs):
        m = mesh if mesh is not None else default_mesh()
        with MeshScope(m):
            return f(*args, **kwargs)
    return run


class MeshScope:
    """``with MeshScope(mesh):`` makes it the framework-current mesh."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _tls.stack.pop()


def current_mesh():
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1]
    return None


def make_mesh(axes=None, devices=None, **axis_sizes):
    """Build a named-axis mesh, e.g. ``make_mesh(dp=2)``.

    Axis sizes must multiply to the device count (the world's ranks, or
    ``devices``); one axis may be given as -1 (inferred).  With no
    sizes every device goes onto one ``dp`` axis — KVStore ``device``
    over every card of the run."""
    if axes:
        axis_sizes = dict(axes, **axis_sizes)
    devices = list(devices if devices is not None
                   else range(_dist.num_workers()))
    n = len(devices)
    if not axis_sizes:
        axis_sizes = {"dp": n}
    ordered = OrderedDict()
    for name in AXES:
        if name in axis_sizes:
            ordered[name] = axis_sizes.pop(name)
    for name, size in axis_sizes.items():  # user-defined extra axes
        ordered[name] = size
    infer = [k for k, v in ordered.items() if v == -1]
    if len(infer) > 1:
        raise ValueError("at most one axis size may be -1")
    known = int(np.prod([v for v in ordered.values() if v != -1]))
    if infer:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        ordered[infer[0]] = n // known
        known = n
    if known != n:
        raise ValueError(f"mesh axes {dict(ordered)} need {known} devices, "
                         f"have {n}")
    arr = np.asarray(devices).reshape(tuple(ordered.values()))
    return Mesh(arr, tuple(ordered.keys()))


def default_mesh():
    """Current mesh, or an all-``dp`` mesh over every rank."""
    m = current_mesh()
    if m is None:
        m = make_mesh()
    return m


def replicated(mesh):
    return NamedSharding(mesh, PartitionSpec())


def named_sharding(mesh, *spec):
    return NamedSharding(mesh, PartitionSpec(*spec))


# ------------------------------------------------- collectives by axis --
def _axis(axis_name):
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError(f"collective over axis {axis_name!r} outside a "
                           f"shard_map or MeshScope")
    if axis_name not in mesh.shape:
        raise ValueError(f"axis {axis_name!r} is not one of the mesh axes "
                         f"{tuple(mesh.axis_names)}")
    return mesh, mesh.shape[axis_name], mesh.group(axis_name)


def axis_size(axis_name):
    return _axis(axis_name)[1]


def axis_index(axis_name):
    """This rank's coordinate on ``axis_name``."""
    mesh = _axis(axis_name)[0]
    return mesh.coords()[axis_name]


def psum(x, axis_name):
    """The sum of ``x`` over ``axis_name`` (a new tensor)."""
    group = _axis(axis_name)[2]
    return x.clone() if group is None \
        else _dist.all_reduce_(x.clone(), group)


def pmean(x, axis_name):
    n = axis_size(axis_name)
    return psum(x, axis_name) / n


def all_gather(x, axis_name, axis=0):
    """Every rank's ``x`` stacked on a new dimension ``axis``."""
    group = _axis(axis_name)[2]
    out = x.unsqueeze(0).clone() if group is None \
        else _dist.all_gather_into(x, group)
    return out.movedim(0, axis)


def all_to_all(x, axis_name):
    """Row j of ``x`` (leading dim = the axis size) to rank j; the rows
    received, in rank order (``lax.all_to_all(x, axis, 0, 0,
    tiled=True)`` on a ``(n, ...)`` array)."""
    group = _axis(axis_name)[2]
    return x.clone() if group is None else _dist.all_to_all(x, group)


def _group_of(mesh, axis):
    return mesh.group(axis) if axis in mesh.shape else None


def _raw_psum(mesh, axis, x):
    group = _group_of(mesh, axis)
    return x if group is None else _dist.all_reduce_(x.clone(), group)


def _raw_gather(mesh, axis, x, dim):
    group = _group_of(mesh, axis)
    if group is None:
        return x
    parts = _dist.all_gather_into(x.contiguous(), group)
    return torch.cat(list(parts.unbind(0)), dim=dim)


def _block(mesh, axis, x, dim):
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split over mesh axis {axis!r} of size {n}")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.coords()[axis] * size, size)


def _raw_ppermute(mesh, axis, x, perm):
    """This rank's share of one permutation: its value sent to each
    ``dst`` of a ``(me, dst)`` pair, the value of the ``src`` of a
    ``(src, me)`` pair received (zeros where no pair ends here)."""
    me = mesh.coords()[axis] if axis in mesh.shape else 0
    sends = [d for s, d in perm if s == me and d != me]
    recvs = [s for s, d in perm if d == me and s != me]
    out = x.clone() if (me, me) in perm else torch.zeros_like(x)
    if sends or recvs:
        group = _group_of(mesh, axis)
        if group is None:
            raise ValueError(f"ppermute pairs {perm} name ranks of axis "
                             f"{axis!r}, which has size 1 here")
        buf = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
               for _ in recvs]
        _dist.send_recv([(x.contiguous(), d) for d in sends],
                        list(zip(buf, recvs)), group)
        for b in buf:
            out = b
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _raw_psum(ctx.mesh, ctx.axis, g), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _raw_psum(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _block(mesh, axis, x, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _raw_gather(ctx.mesh, ctx.axis, g, ctx.dim), None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _raw_gather(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        return (_block(ctx.mesh, ctx.axis, g, ctx.dim).contiguous(), None,
                None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _raw_ppermute(mesh, axis, x, perm)

    @staticmethod
    def backward(ctx, g):
        back = tuple((d, s) for s, d in ctx.perm)
        return (_raw_ppermute(ctx.mesh, ctx.axis, g.contiguous(), back),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _dist.all_to_all(x, _group_of(mesh, axis))

    @staticmethod
    def backward(ctx, g):
        # row j came from rank j: its gradient goes back the same way
        return (_dist.all_to_all(g.contiguous(),
                                 _group_of(ctx.mesh, ctx.axis)), None, None)


def _split(axis):
    mesh = _axis(axis)[0]
    return mesh, mesh.shape[axis] > 1


def copy_to(x, axis):
    """``x`` as it is; its gradient summed over ``axis``."""
    mesh, split = _split(axis)
    return _CopyTo.apply(x, mesh, axis) if split else x


def reduce_from(x, axis):
    """The sum of ``x`` over ``axis``; its gradient passed through."""
    mesh, split = _split(axis)
    return _ReduceFrom.apply(x, mesh, axis) if split else x


def scatter_to(x, axis, dim):
    """This rank's block of ``dim`` (which must split evenly); the
    gradients of the blocks gathered back."""
    mesh, split = _split(axis)
    return _ScatterTo.apply(x, mesh, axis, dim) if split else x


def gather_from(x, axis, dim):
    """Every rank's ``x`` concatenated along ``dim`` in axis order; the
    gradient of this rank's block passed back."""
    mesh, split = _split(axis)
    return _GatherFrom.apply(x, mesh, axis, dim) if split else x


def ppermute(x, axis, perm):
    """``lax.ppermute``: for each ``(src, dst)`` of ``perm`` (coordinates
    on ``axis``) rank ``dst`` receives ``src``'s ``x`` (point to point),
    zeros where no pair ends; the gradient goes back by the inverse
    permutation."""
    mesh = _axis(axis)[0]
    perm = tuple((int(s), int(d)) for s, d in perm)
    return _PPermute.apply(x, mesh, axis, perm)


def all_to_all_grad(x, axis):
    """``all_to_all`` with its gradient (the same exchange backwards)."""
    mesh, split = _split(axis)
    return _AllToAll.apply(x, mesh, axis) if split else x
