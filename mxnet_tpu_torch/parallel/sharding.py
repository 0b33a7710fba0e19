"""Parameter / activation sharding rules (the port of
``mxnet_tpu/parallel/sharding.py``: pure name -> spec logic, whole).

A rule is ``(regex, spec)`` where spec is a tuple over the parameter's
dims; each entry is a mesh-axis name, a tuple of axis names, or None.
The first matching rule whose sharding divides the shape wins;
otherwise replicate.  ``TrainStep``/``EvalStep`` hold each leaf the
rules shard as this rank's block (``placement``).
"""
from __future__ import annotations

import re

from .mesh import NamedSharding, PartitionSpec

__all__ = ["ShardingRules", "tp_dense_rules", "fsdp_rules",
           "causal_lm_tp_rules", "param_sharding", "batch_spec",
           "logical_to_sharding", "shards_any"]


def _axis_size(mesh, entry):
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for e in entry:
            n *= mesh.shape.get(e, 1)
        return n
    return mesh.shape.get(entry, 1)


def _spec_fits(mesh, spec, shape):
    if len(spec) > len(shape):
        return False
    for dim, entry in zip(shape, spec):
        sz = _axis_size(mesh, entry)
        if sz > 1 and dim % sz != 0:
            return False
    return True


def _drop_missing_axes(mesh, spec):
    """Remove axis names the mesh doesn't have (so one rule set serves
    meshes with and without, e.g., a 'tp' axis)."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(e for e in entry if e in mesh.shape)
            out.append(kept if kept else None)
        else:
            out.append(entry if entry in mesh.shape else None)
    return tuple(out)


class ShardingRules:
    """Ordered (regex, spec) list -> PartitionSpec per parameter."""

    def __init__(self, rules=(), default=()):
        self.rules = [(re.compile(p), tuple(s)) for p, s in rules]
        self.default = tuple(default)

    def __add__(self, other):
        r = ShardingRules()
        r.rules = self.rules + other.rules
        r.default = other.default or self.default
        return r

    def spec_for(self, name, shape, mesh):
        for pat, spec in self.rules:
            if pat.search(name):
                spec = _drop_missing_axes(mesh, spec)
                if _spec_fits(mesh, spec, shape):
                    return PartitionSpec(*spec)
        spec = _drop_missing_axes(mesh, self.default)
        if self.default and _spec_fits(mesh, spec, shape):
            return PartitionSpec(*spec)
        return PartitionSpec()


def tp_dense_rules():
    """Megatron-style rules for the stock Gluon layers: alternate
    column/row sharding of Dense kernels inside attention/FFN blocks;
    embeddings sharded on the embedding dim.  Dense kernel layout is
    (units, in_units), so 'units' is dim 0."""
    return ShardingRules(rules=[
        # attention QKV + FFN-in: shard output features (column parallel)
        (r"(query|key|value|qkv|ffn_?1|inter|fc1|gate|up)\w*_(weight)$", ("tp", None)),
        (r"(query|key|value|qkv|ffn_?1|inter|fc1|gate|up)\w*_(bias)$", ("tp",)),
        # attention out-proj + FFN-out: shard input features (row parallel)
        (r"(proj|out|ffn_?2|fc2|down)\w*_(weight)$", (None, "tp")),
        # embeddings: shard embedding dim
        (r"embedding\w*_weight$", (None, "tp")),
        # conv kernels (O, I, kH, kW): shard output channels
        (r"conv\w*_weight$", ("tp", None, None, None)),
    ])


def causal_lm_tp_rules(axis="tp"):
    """Megatron column/row rules for the functional causal LM's flat
    param dict (stacked ``[n_layers, ...]`` leaves): QKV and FFN-in
    column-sharded, the attention output projection and FFN-out
    row-sharded; biases of row-parallel layers, embeddings and norms
    replicate."""
    return ShardingRules(rules=[
        (r"^wqkv$", (None, None, axis)),   # [L, d, 3d] column (by head)
        (r"^bqkv$", (None, axis)),         # [L, 3d]    rides its columns
        (r"^wo$",   (None, axis, None)),   # [L, d, d]  row
        (r"^w1$",   (None, None, axis)),   # [L, d, ff] column
        (r"^b1$",   (None, axis)),         # [L, ff]    rides its columns
        (r"^w2$",   (None, axis, None)),   # [L, ff, d] row
    ])


def fsdp_rules():
    """ZeRO-3-ish: shard every parameter's largest dim over 'fsdp'."""

    class _FSDP(ShardingRules):
        def spec_for(self, name, shape, mesh):
            ax = mesh.shape.get("fsdp", 1)
            if ax <= 1 or not shape:
                return PartitionSpec()
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for i in order:
                if shape[i] % ax == 0 and shape[i] >= ax:
                    spec = [None] * len(shape)
                    spec[i] = "fsdp"
                    return PartitionSpec(*spec)
            return PartitionSpec()

    return _FSDP()


def param_sharding(names, shapes, mesh, rules=None):
    """NamedSharding per parameter name."""
    rules = rules or ShardingRules()
    return [NamedSharding(mesh, rules.spec_for(n, s, mesh))
            for n, s in zip(names, shapes)]


def shards_any(sharding):
    """Whether a NamedSharding splits its array over an axis of size > 1."""
    return any(_axis_size(sharding.mesh, e) > 1 for e in sharding.spec)


def batch_spec(mesh, extra_axes=("dp", "fsdp")):
    """PartitionSpec for a leading-batch-dim tensor: batch over dp (and
    fsdp, which contributes data-parallel replicas in ZeRO style)."""
    axes = tuple(a for a in extra_axes if mesh.shape.get(a, 1) > 1)
    if not axes:
        return PartitionSpec()
    return PartitionSpec(axes if len(axes) > 1 else axes[0])


def logical_to_sharding(mesh, spec):
    spec = _drop_missing_axes(mesh, tuple(spec))
    return NamedSharding(mesh, PartitionSpec(*spec))
