"""Pipeline parallelism (the port of ``mxnet_tpu/parallel/pipeline.py``):
a GPipe microbatch schedule over the ``pp`` mesh axis.

Stage parameters are stacked along a leading dim of size P placed on
``pp`` (stage i's slice on pp-rank i).  The schedule is the JAX one, tick
by tick: every rank applies its stage to its current microbatch and
``ppermute``s the activation to the next rank (point to point); the
warm-up and cool-down bubbles are masked compute, GPipe's cost of
(P-1)/(M+P-1).  Every rank runs the same operations in the same order
(the selects are on tensors, not on the rank), so the backward's
permutations pair up on every rank.

Every stage maps activations of one shape to the same shape (the
transformer-block case); the batch splits into ``microbatches`` equal
microbatches.
"""
from __future__ import annotations

import inspect
import re

import torch

from .. import autograd as _autograd
from .. import initializer as init_mod
from ..gluon.block import Block
from ..ndarray import NDArray
from . import mesh as _mesh
from .functional import functional_call
from .placement import full, placement_of, split_axis
from .sharding import ShardingRules

__all__ = ["gpipe", "PipelineStack"]


def _stage_slice(leaf, axis):
    """This rank's stage of a stacked leaf: its block where a step holds
    it split on ``axis``, else its row of the whole stack."""
    if split_axis(placement_of(leaf), 0) == axis:
        return leaf[0]
    return _mesh.scatter_to(full(leaf), axis, 0)[0]


def gpipe(stage_apply, stacked_params, x, mesh=None, axis="pp",
          batch_axis="dp", microbatches=None):
    """Run ``x`` through P pipelined stages.

    ``stage_apply(params_slice, act) -> act'`` keeps the shape (a third
    parameter, if it takes one, gets the tick).  ``stacked_params``: a
    dict of leaves with leading dim P (a step's blocks on ``axis``, or
    whole stacks).  ``x``: this rank's ``(B, ...)`` batch, split into M
    microbatches along dim 0.  Returns ``(B, ...)``, the same on every
    rank of ``axis``."""
    mesh = mesh if mesh is not None else _mesh.current_mesh()
    if mesh is None:
        raise ValueError("gpipe needs a mesh: pass mesh= or enter a MeshScope")
    P = mesh.shape[axis]
    for name, leaf in stacked_params.items():
        where = placement_of(leaf)
        shape = where.shape if where is not None else tuple(leaf.shape)
        if len(shape) < 1 or shape[0] != P:
            raise ValueError(
                f"gpipe: stacked param [{name!r}] has leading dim "
                f"{tuple(shape[:1])} but mesh axis {axis!r} has size {P}; "
                f"every stacked leaf must have leading dim == number of "
                f"pipeline stages == mesh.shape[{axis!r}]")
    M = microbatches if microbatches is not None else P
    B = x.shape[0]
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    takes_tick = len(inspect.signature(stage_apply).parameters) >= 3
    with _mesh.MeshScope(mesh):
        rank = mesh.coords()[axis] if axis in mesh.shape else 0
        me = {n: _stage_slice(leaf, axis)
              for n, leaf in stacked_params.items()}
        # only the first stage reads x: its gradient is summed over pp
        xm = _mesh.copy_to(x, axis).reshape((M, B // M) + tuple(x.shape[1:]))
        first = torch.full((), rank == 0, device=x.device)
        last = torch.full((), rank == P - 1, device=x.device)
        recv = torch.zeros(xm.shape[1:], dtype=xm.dtype, device=xm.device)
        none = torch.zeros_like(recv)
        send = [(p, p + 1) for p in range(P - 1)]
        outs = [None] * M
        T = M + P - 1
        for t in range(T):
            my_in = torch.where(first, xm[min(t, M - 1)], recv)
            y = stage_apply(me, my_in, t) if takes_tick \
                else stage_apply(me, my_in)
            if P > 1 and t < T - 1:
                recv = _mesh.ppermute(y, axis, send)
            w = t - (P - 1)
            if w >= 0:
                outs[w] = torch.where(last, y, none)
        # only the last rank holds the outputs: their sum over pp
        out = _mesh.reduce_from(torch.stack(outs), axis)
    return out.reshape((B,) + tuple(out.shape[2:]))


class PipelineStack(Block):
    """A Gluon pipeline of ``num_stages`` stages of one structure
    (GPipe over ``pp``).

    Built from a factory of one stage; owns stacked parameters
    (leading dim ``num_stages``, the factory's stage and further
    draws of each parameter's initializer) so each stage's slice
    lands on its pp rank — pass ``stack.sharding_rules()`` to
    ``TrainStep``."""

    def __init__(self, stage_factory, num_stages, microbatches=None,
                 axis="pp", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.num_stages = num_stages
        self.microbatches = microbatches
        self.axis = axis
        with self.name_scope():
            self.template = stage_factory()
        self.template.initialize()
        stacked_names = []
        for name, p in sorted(self.template.collect_params().items()):
            if p._deferred_init is not None:
                raise ValueError(
                    f"pipeline stages need fully-specified shapes; "
                    f"parameter '{name}' has deferred init "
                    f"(pass in_units/in_channels)")
            first = p.local_tensor().detach()
            initializer = init_mod.create(
                p.init if p.init is not None else "uniform")
            draws = [first] + [
                initializer(p.name, p.shape, p.dtype).to(first.device)
                for _ in range(num_stages - 1)]
            arr = torch.stack(draws)
            p.shape = tuple(arr.shape)
            p._adopt(arr)
            stacked_names.append(name)
        self._stacked_names = stacked_names

    def sharding_rules(self):
        """Leading stage dim of every stacked param -> the pp axis."""
        return ShardingRules(
            rules=[(re.escape(n), (self.axis,))
                   for n in self._stacked_names])

    def forward(self, x):
        names = self._stacked_names
        plist = [self.template.collect_params()[n] for n in names]
        template = self.template
        training = _autograd.is_training()

        def stage_apply(params_slice, act):
            out, _ = functional_call(template, plist,
                                     [params_slice[n] for n in names],
                                     (act,), training)
            return out

        stacked = {n: p.local_tensor() for n, p in zip(names, plist)}
        xv = x._data if isinstance(x, NDArray) else x
        out = gpipe(stage_apply, stacked, xv, axis=self.axis,
                    microbatches=self.microbatches)
        return NDArray(out) if isinstance(x, NDArray) else out
