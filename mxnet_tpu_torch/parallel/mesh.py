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
``all_to_all``, ``axis_index``) and run over that axis's group.  It
serves the dp axis; a spec that names another axis of size > 1 raises
``NotImplementedError`` (model parallelism is ROADMAP A15b).
"""
from __future__ import annotations

import functools
import threading
from collections import OrderedDict

import numpy as np

from .. import distributed as _dist

__all__ = ["AXES", "Mesh", "PartitionSpec", "NamedSharding", "make_mesh",
           "current_mesh", "default_mesh", "MeshScope", "replicated",
           "named_sharding", "shard_map", "validate_specs", "psum", "pmean",
           "all_gather", "all_to_all", "axis_index", "axis_size"]

# Canonical axis order: collectives that ride adjacent devices (tp, sp)
# go last, as in the JAX package.
AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

#: the axes this port runs collectives over (the rest are ROADMAP A15b)
DATA_AXES = ("dp",)

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

    def group(self, axis):
        """The process group of ``axis`` for this rank, or None where a
        collective over it has nothing to do (no process group, or an
        axis of size 1 in a larger world).  An axis over the whole world
        is the world's group, even a world of one: its collectives are
        real ones."""
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


def model_parallel_axes(mesh, names=None):
    """The axes of size > 1 among ``names`` (default: all of the mesh's)
    that this port does not run yet."""
    names = mesh.axis_names if names is None else names
    return {a: mesh.shape[a] for a in names
            if a in mesh.shape and a not in DATA_AXES and mesh.shape[a] > 1}


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
        extra = model_parallel_axes(
            m, set(_spec_axis_names(in_specs))
            | set(_spec_axis_names(out_specs)))
        if extra:
            raise NotImplementedError(
                f"shard_map over model-parallel axes {extra}: the port "
                f"runs the dp axis only; tp/fsdp/pp/sp/ep are ROADMAP "
                f"A15b")
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
