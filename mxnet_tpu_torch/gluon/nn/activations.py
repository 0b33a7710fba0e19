"""Activation layer (the port of ``mxnet_tpu/gluon/nn/activations.py``'s
``Activation``)."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation"]


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
