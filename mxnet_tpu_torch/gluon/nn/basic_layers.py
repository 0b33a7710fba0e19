"""Basic layers (the port of ``mxnet_tpu/gluon/nn/basic_layers.py``):
the containers, ``Dense``, ``Dropout``, the norms, ``Embedding``,
``Flatten``, ``Identity`` and the lambdas."""
from __future__ import annotations

import math

from ... import autograd as _autograd
from ...ndarray.ndarray import NDArray, _wrap_all
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "SyncBatchNorm", "InstanceNorm", "LayerNorm",
           "GroupNorm", "RMSNorm", "Embedding", "Flatten", "Lambda",
           "HybridLambda", "Identity"]


class Sequential(Block):
    """Children run in the order they were added (a plain Block: it
    runs eagerly; ``hybridize`` reaches its children)."""

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x, *args):
        for b in self._children.values():
            x = b(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        vals = list(self._children.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            for b in vals[key]:
                net.add(b)
            return net
        return vals[key]

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(HybridBlock):
    """Children run in the order they were added."""

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x, *args):
        for b in self._children.values():
            x = b(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        return list(self._children.values())[key]

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """``FullyConnected``; weight ``(units, in_units)``."""

    _takes_blocks = ("weight", "bias")

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        self.weight = self.params.get("weight", shape=(units, in_units),
                                      init=weight_initializer, dtype=dtype,
                                      allow_deferred_init=True)
        self.bias = (self.params.get("bias", shape=(units,),
                                     init=bias_initializer, dtype=dtype,
                                     allow_deferred_init=True)
                     if use_bias else None)

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        if getattr(weight, "_placement", None) is not None or \
                getattr(bias, "_placement", None) is not None:
            # a model-parallel step's blocks: multiply by the block
            from ...parallel.placement import linear
            out = linear(x.reshape(x.shape[0], -1) if self._flatten else x,
                         weight, bias)
        else:
            out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   no_bias=bias is None,
                                   flatten=self._flatten)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out


class Dropout(HybridBlock):
    """``Dropout`` op (inverted, training mode only)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)

    def infer_shape(self, *args):
        pass

    def hybrid_forward(self, F, x):
        if self._rate == 0:
            return x
        return F.Dropout(x, p=self._rate, axes=self._axes)


class BatchNorm(HybridBlock):
    """``BatchNorm`` op; in training mode the new running statistics are
    written back to the ``running_mean``/``running_var`` parameters."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._momentum = momentum
        self._eps = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = self.params.get("gamma", shape=(in_channels,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True,
                                     differentiable=scale)
        self.beta = self.params.get("beta", shape=(in_channels,),
                                    init=beta_initializer,
                                    allow_deferred_init=True,
                                    differentiable=center)
        self.running_mean = self.params.get(
            "running_mean", shape=(in_channels,),
            init=running_mean_initializer, allow_deferred_init=True,
            differentiable=False)
        self.running_var = self.params.get(
            "running_var", shape=(in_channels,),
            init=running_variance_initializer, allow_deferred_init=True,
            differentiable=False)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        out, new_mm, new_mv = F.BatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._eps,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis)
        if _autograd.is_training() and not self._use_global_stats:
            self.running_mean._data = new_mm.detach()
            self.running_var._data = new_mv.detach()
        return out


class SyncBatchNorm(BatchNorm):
    """BatchNorm with statistics over every device's batch.  The port's
    ``BatchNorm`` already takes them over every rank's batch inside a
    data-parallel ``TrainStep`` (``ops.nn.stats_over``), so this is
    BatchNorm (``num_devices`` is accepted)."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        kwargs.setdefault("epsilon", 1e-5)
        super().__init__(in_channels=in_channels, **kwargs)


class InstanceNorm(HybridBlock):
    """``InstanceNorm`` op over each sample's channel (axis 1)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._eps = epsilon
        self.gamma = self.params.get("gamma", shape=(in_channels,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True,
                                     differentiable=scale)
        self.beta = self.params.get("beta", shape=(in_channels,),
                                    init=beta_initializer,
                                    allow_deferred_init=True,
                                    differentiable=center)

    def infer_shape(self, x, *args):
        self.gamma.shape = (x.shape[1],)
        self.beta.shape = (x.shape[1],)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._eps)


class LayerNorm(HybridBlock):
    """``LayerNorm`` op over ``axis``; ``gamma`` and ``beta``."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._eps = epsilon
        self.gamma = self.params.get("gamma", shape=(in_channels,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True,
                                     differentiable=scale)
        self.beta = self.params.get("beta", shape=(in_channels,),
                                    init=beta_initializer,
                                    allow_deferred_init=True,
                                    differentiable=center)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._eps)


class GroupNorm(HybridBlock):
    """``GroupNorm`` op: ``num_groups`` groups of the channels (axis
    1)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._groups = num_groups
        self._eps = epsilon
        self.gamma = self.params.get("gamma", shape=(in_channels,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True,
                                     differentiable=scale)
        self.beta = self.params.get("beta", shape=(in_channels,),
                                    init=beta_initializer,
                                    allow_deferred_init=True,
                                    differentiable=center)

    def infer_shape(self, x, *args):
        self.gamma.shape = (x.shape[1],)
        self.beta.shape = (x.shape[1],)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._groups,
                           eps=self._eps)


class RMSNorm(HybridBlock):
    """``RMSNorm`` op over ``axis``; ``gamma``."""

    def __init__(self, axis=-1, epsilon=1e-6, in_channels=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._eps = epsilon
        self.gamma = self.params.get("gamma", shape=(in_channels,),
                                     init="ones", allow_deferred_init=True)

    def infer_shape(self, x, *args):
        self.gamma.shape = (x.shape[self._axis],)

    def hybrid_forward(self, F, x, gamma):
        return F.RMSNorm(x, gamma, axis=self._axis, eps=self._eps)


class Embedding(HybridBlock):
    """``Embedding`` op; weight ``(input_dim, output_dim)``.  With
    ``sparse_grad=True`` the weight's gradient is handed out row_sparse
    (``Parameter.grad``), which ``gluon.Trainer`` applies lazily."""

    _takes_blocks = ("weight",)

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim),
            init=weight_initializer, dtype=dtype,
            grad_stype="row_sparse" if sparse_grad else "default")

    def infer_shape(self, *args):
        pass

    def hybrid_forward(self, F, x, weight):
        if getattr(weight, "_placement", None) is not None:
            # a model-parallel step's block: look up in the block
            from ...parallel.placement import embedding
            return embedding(x, weight)
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class Flatten(HybridBlock):
    """``(N, ...)`` -> ``(N, prod(...))``."""

    def infer_shape(self, *args):
        pass

    def hybrid_forward(self, F, x):
        return F.flatten(x)


class Identity(HybridBlock):
    def infer_shape(self, *args):
        pass

    def hybrid_forward(self, F, x):
        return x


class Lambda(Block):
    """A function of NDArrays as a block (a name: the ``nd`` function).
    It sees NDArrays; the block returns tensors for tensors."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as ndmod
            function = getattr(ndmod, function)
        self._func = function

    def forward(self, *args):
        out = self._func(*_wrap_all(args))
        if isinstance(out, NDArray):
            return out._data
        if isinstance(out, (tuple, list)):
            return type(out)(o._data if isinstance(o, NDArray) else o
                             for o in out)
        return out


class HybridLambda(HybridBlock):
    """``function(F, *args)`` on tensors as a block (a name: the op)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            fname = function
            function = lambda F, *args: getattr(F, fname)(*args)  # noqa: E731
        self._func = function

    def infer_shape(self, *args):
        pass

    def hybrid_forward(self, F, *args):
        return self._func(F, *args)
