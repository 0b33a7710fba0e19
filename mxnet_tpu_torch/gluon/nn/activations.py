"""Activation layers (the port of ``mxnet_tpu/gluon/nn/activations.py``):
``Activation``, ``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU``
and ``Swish`` (``SiLU``)."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
           "Swish", "SiLU"]


class Activation(HybridBlock):
    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._act_type = activation

    def _alias(self):
        return self._act_type if hasattr(self, "_act_type") else "activation"

    def infer_shape(self, *args):
        pass

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class _Stateless(HybridBlock):
    def infer_shape(self, *args):
        pass


class LeakyReLU(_Stateless):
    """``x`` where positive, ``alpha * x`` elsewhere."""

    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with a learned slope ``alpha`` per channel."""

    def __init__(self, alpha_initializer="zeros", in_channels=1, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self.alpha = self.params.get("alpha", shape=(in_channels,),
                                     init=alpha_initializer)

    def infer_shape(self, *args):
        pass

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(_Stateless):
    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(_Stateless):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(_Stateless):
    """Exact GELU, or its tanh approximation with ``approximate``."""

    def __init__(self, approximate=False, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._approx = approximate

    def hybrid_forward(self, F, x):
        if self._approx:
            return F.gelu_tanh(x)
        return F.LeakyReLU(x, act_type="gelu")


class Swish(_Stateless):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        if self._beta == 1.0:
            return F.silu(x)
        return x * F.sigmoid(self._beta * x)


SiLU = Swish
