"""Convolution and pooling layers (the port of
``mxnet_tpu/gluon/nn/conv_layers.py``'s ``Conv2D``, ``MaxPool2D`` and
``GlobalAvgPool2D``).  ``layout="NHWC"`` keeps the JAX package's
channel-last convention: ``OHWI`` conv weights."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class Conv2D(HybridBlock):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        kernel_size = _tup(kernel_size, 2)
        self._channels = channels
        self._kwargs = {
            "kernel": kernel_size, "stride": _tup(strides, 2),
            "dilate": _tup(dilation, 2), "pad": _tup(padding, 2),
            "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        self._act_type = activation
        self._chan_last = layout[-1] == "C"
        cin = in_channels // groups if in_channels else 0
        wshape = (channels,) + kernel_size + (cin,) if self._chan_last \
            else (channels, cin) + kernel_size
        self.weight = self.params.get("weight", shape=wshape,
                                      init=weight_initializer,
                                      allow_deferred_init=True)
        self.bias = (self.params.get("bias", shape=(channels,),
                                     init=bias_initializer,
                                     allow_deferred_init=True)
                     if use_bias else None)

    def infer_shape(self, x, *args):
        c = x.shape[-1] if self._chan_last else x.shape[1]
        w = list(self.weight.shape)
        w[-1 if self._chan_last else 1] = c // self._kwargs["num_group"]
        self.weight.shape = tuple(w)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, **self._kwargs)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool=False,
                 pool_type="max", layout="NCHW", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kwargs = {
            "kernel": pool_size,
            "stride": pool_size if strides is None else strides,
            "pad": padding, "pool_type": pool_type,
            "global_pool": global_pool, "layout": layout}

    def infer_shape(self, *args):
        pass

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", **kwargs):
        super().__init__(_tup(pool_size, 2),
                         None if strides is None else _tup(strides, 2),
                         _tup(padding, 2), False, "max", layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, "avg", layout,
                         **kwargs)
