"""The fused norm -> relu -> conv layer (the port of
``mxnet_tpu/gluon/nn/fused.py``).

``NormReluConv2D`` folds BatchNorm(+residual)+ReLU into the following
convolution through ``ops.norm_relu_conv`` (the hand-written kernels on
the card), so the normalised activation never reaches device memory.
NHWC only, 1x1/3x3, stride 1 or 2.  The weight is HWIO, unlike
``Conv2D``'s OHWI: this layer is a performance variant with its own
parameter layout, as in the JAX package.
"""
from __future__ import annotations

from ... import autograd as _autograd
from ..block import HybridBlock

__all__ = ["NormReluConv2D"]


class NormReluConv2D(HybridBlock):
    """``out = conv(relu(bn(x) [+ residual]), weight)`` in one fused op.

    Owns the BN affine terms and running statistics of its input
    channels and the conv weight producing ``channels`` outputs.  An
    optional second call argument is the residual, added after the
    affine and before the relu."""

    def __init__(self, channels, kernel_size, strides=1, in_channels=0,
                 momentum=0.9, epsilon=1e-5, relu=True,
                 weight_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if kernel_size not in (1, 3):
            raise ValueError("NormReluConv2D supports kernel_size 1 or 3")
        if strides not in (1, 2):
            raise ValueError("NormReluConv2D supports strides 1 or 2")
        self._channels = channels
        self._k = kernel_size
        self._strides = strides
        self._momentum = momentum
        self._eps = epsilon
        self._relu = relu
        self.weight = self.params.get(
            "weight", shape=(kernel_size, kernel_size, in_channels, channels),
            init=weight_initializer, allow_deferred_init=True)
        self.gamma = self.params.get("gamma", shape=(in_channels,),
                                     init="ones", allow_deferred_init=True)
        self.beta = self.params.get("beta", shape=(in_channels,),
                                    init="zeros", allow_deferred_init=True)
        self.running_mean = self.params.get(
            "running_mean", shape=(in_channels,), init="zeros",
            allow_deferred_init=True, differentiable=False)
        self.running_var = self.params.get(
            "running_var", shape=(in_channels,), init="ones",
            allow_deferred_init=True, differentiable=False)

    def infer_shape(self, x, *args):
        ci = x.shape[-1]
        self.weight.shape = (self._k, self._k, ci, self._channels)
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = (ci,)

    def hybrid_forward(self, F, x, *args, **params):
        residual = args[0] if args else None
        out, new_mm, new_mv = F.FusedNormReluConv(
            x, params["weight"], params["gamma"], params["beta"],
            params["running_mean"], params["running_var"],
            residual=residual, eps=self._eps, momentum=self._momentum,
            relu=self._relu, stride=self._strides)
        if _autograd.is_training():
            self.running_mean._data = new_mm.detach()
            self.running_var._data = new_mv.detach()
        return out

    def extra_repr(self):
        return (f"{self._k}x{self._k}, channels={self._channels}, "
                f"strides={self._strides}")
