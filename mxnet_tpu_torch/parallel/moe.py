"""Mixture-of-Experts with expert parallelism over the ``ep`` mesh axis
(the port of ``mxnet_tpu/parallel/moe.py``).

The layer is the GShard formulation, as in the JAX package: top-k gating,
capacity-bounded one-hot dispatch/combine tensors (``ops.moe``, which
also registers the op ``moe_ffn`` on whole weights), stacked expert
weights with leading dim E placed on ``ep`` (``MoEFFN.sharding_rules``).
Where a step holds the expert leaves in blocks, each rank runs its own
experts on the tokens every rank of ``ep`` holds alike (the batch splits
over ``dp``/``fsdp`` only) and the experts' combined outputs are summed
over ``ep`` (``reduce_from``).  Inside a step that splits the batch over
ranks (the f32 ``TrainStep``, an ``EvalStep``) the tokens are routed as
the global batch (``batch_split``): every rank gathers the batch's
tokens, routes them with the global capacity, and keeps its own rows.
The tokens enter through ``copy_to`` (their gradient summed over every
rank's experts) and the combine weights through ``scatter_to`` (each
rank's experts' columns, their gradients gathered back).
"""
from __future__ import annotations

import re

import torch

from ..gluon.block import HybridBlock
from ..ops.moe import experts, moe_dispatch, moe_ffn as _moe_ffn_whole, route
from . import mesh as _mesh
from .placement import (batch_split, full, gather_rows, placement_of,
                        split_axis)
from .sharding import ShardingRules

__all__ = ["moe_dispatch", "moe_ffn", "MoEFFN"]


def moe_ffn(tokens, gate_w, w1, b1, w2, b2, num_experts=1, capacity=1,
            k=2, act="gelu", group_size=0):
    """The registry's ``moe_ffn`` on a step's leaves: the expert leaves
    by their blocks where they are split on ``ep``, every leaf gathered
    where used otherwise, and the tokens routed as the global batch
    inside a step that splits the batch over ranks."""
    kw = dict(num_experts=num_experts, capacity=capacity, k=k, act=act,
              group_size=group_size)
    split = batch_split()
    if split is None:
        return _by_block(tokens, gate_w, w1, b1, w2, b2, **kw)
    # the global batch's tokens, routed together as JAX routes them
    whole, rows = gather_rows(tokens, *split)
    out, aux = _by_block(whole, gate_w, w1, b1, w2, b2, **kw)
    return rows.local(out), aux


def _by_block(tokens, gate_w, w1, b1, w2, b2, num_experts, capacity, k,
              act, group_size):
    axis = split_axis(placement_of(w1), 0)
    if axis is None:
        return _moe_ffn_whole(tokens, full(gate_w),
                              *[full(x) for x in (w1, b1, w2, b2)],
                              num_experts=num_experts, capacity=capacity,
                              k=k, act=act, group_size=group_size)
    n, d = tokens.shape
    tg, dispatch, combine, aux = route(tokens, full(gate_w), num_experts,
                                       capacity, k, group_size)
    # this rank's experts on the tokens every rank of the axis holds
    e_loc = w1.shape[0]
    e0 = _mesh.axis_index(axis) * e_loc
    tg_in = _mesh.copy_to(tg, axis)
    # this rank's experts' columns; their gradients gathered back
    combine = _mesh.scatter_to(combine, axis, 2)
    dispatch = dispatch[:, :, e0:e0 + e_loc]
    w = [x if split_axis(placement_of(x), 0) == axis
         else _mesh.scatter_to(full(x), axis, 0) for x in (w1, b1, w2, b2)]
    exp_in = torch.einsum("gnec,gnd->gecd", dispatch.to(tokens.dtype), tg_in)
    out_e = experts(exp_in, *w, act)
    out = torch.einsum("gnec,gecd->gnd", combine.to(tokens.dtype), out_e)
    out = _mesh.reduce_from(out, axis)
    return out.reshape(-1, d)[:n], aux


class MoEFFN(HybridBlock):
    """Top-k gated expert FFN (GShard/Switch style).

    ``forward(x: (B, S, C) | (N, C)) -> (out, aux_loss)``; add
    ``aux_loss_weight * aux_loss`` to the training loss for load
    balance.  The stacked expert weights (leading dim E) go on
    ``ep`` by ``sharding_rules()``."""

    _takes_blocks = ("w1", "b1", "w2", "b2")

    def __init__(self, units, hidden_size, num_experts, k=2,
                 capacity_factor=1.25, activation="gelu", ep_axis="ep",
                 group_size=4096, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._hidden = hidden_size
        self._e = num_experts
        self._k = k
        self._cf = capacity_factor
        self._act = activation
        self._gs = group_size
        self.ep_axis = ep_axis
        self.gate_weight = self.params.get(
            "gate_weight", shape=(units, num_experts), init="xavier")
        self.w1 = self.params.get(
            "expert_w1", shape=(num_experts, units, hidden_size),
            init="xavier")
        self.b1 = self.params.get(
            "expert_b1", shape=(num_experts, hidden_size), init="zeros")
        self.w2 = self.params.get(
            "expert_w2", shape=(num_experts, hidden_size, units),
            init="xavier")
        self.b2 = self.params.get(
            "expert_b2", shape=(num_experts, units), init="zeros")

    def sharding_rules(self):
        return ShardingRules(rules=[
            (re.escape(p.name), (self.ep_axis,))
            for p in (self.w1, self.b1, self.w2, self.b2)])

    def infer_shape(self, *args):
        pass

    def hybrid_forward(self, F, x, gate_weight, w1, b1, w2, b2):
        shape = x.shape
        tokens = x.reshape(-1, shape[-1])                   # (N, C)
        n = tokens.shape[0]
        split = batch_split()
        if split is not None:       # routed as the global batch
            for axis in split[1]:
                n *= split[0].shape[axis]
        gs = self._gs if self._gs and self._gs < n else n
        capacity = max(1, int(self._cf * gs * self._k / self._e))
        # the expert leaves come as a step's blocks (``_takes_blocks``)
        out, aux = moe_ffn(tokens, gate_weight, w1, b1, w2, b2,
                           num_experts=self._e, capacity=capacity,
                           k=self._k, act=self._act, group_size=gs)
        return out.reshape(shape), aux
