"""Post-training INT8 quantization with calibration (the port of
``mxnet_tpu/contrib/quantization.py``).

ref: python/mxnet/contrib/quantization.py — quantize_model / quantize_net +
calibrate.cc (min/max collectors).  The flow for gluon:

    qnet = quantize_net(net, calib_data=loader)     # swaps Dense/Conv2D
    out = qnet(x)                                   # int8 GEMMs

Calibration wraps every Dense/Conv2D in a range collector, runs the
calibration batches, then swaps in quantized layers whose activations
quantize with the calibrated ranges (``calib_mode='naive'``: min/max over
the batches, the reference's naive collector).

Each quantized layer's int8 weight comes from the JAX package's numpy
arithmetic (``_q8``), so it equals the JAX package's bit for bit, and
it (with the f32 bias) becomes a tensor on the wrapped layer's device
once, when the layer is made: a forward copies nothing from the host,
so a hybridized quantized net is captured whole on the card.  The
products are ``ops/quantization.py``'s, exact in int32.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ops as F
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray.ndarray import NDArray

__all__ = ["quantize_net", "QuantizedDense", "QuantizedConv2D"]


class _RangeCollector(HybridBlock):
    """Wraps a layer; records min/max of its input during calibration."""

    def __init__(self, inner, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.inner = inner
        self.min_v = None
        self.max_v = None

    def forward(self, x):
        mn, mx = (float(v) for v in torch.aminmax(x.detach().float()))
        self.min_v = mn if self.min_v is None else min(self.min_v, mn)
        self.max_v = mx if self.max_v is None else max(self.max_v, mx)
        return self.inner(x)


def _q8(w):
    amax = float(np.abs(w).max()) or 1e-10
    scale = 127.0 / amax
    return np.clip(np.round(w * scale), -127, 127).astype(np.int8), amax


def _quantize_input(x, amax):
    """The activation as int8 at the calibrated range (round half to
    even, as the JAX package's ``F.round``)."""
    scale = 127.0 / amax
    return torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)


class _Quantized(HybridBlock):
    def __init__(self, layer, min_act, max_act, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        device = layer.weight.data()._data.device
        wq, self._wmax = _q8(layer.weight.data().asnumpy())
        self._wq = torch.from_numpy(wq).to(device)
        self._amax = max(abs(min_act), abs(max_act)) or 1e-10
        self._bias = (layer.bias.data()._data.detach().float().clone()
                      if layer.bias is not None else None)
        self._act_type = getattr(layer, "_act_type", None)

    def _activate(self, out):
        return F.Activation(out, act_type=self._act_type) \
            if self._act_type else out


class QuantizedDense(_Quantized):
    """int8 Dense with calibrated activation range (ref:
    quantized_fully_connected.cc)."""

    def __init__(self, dense, min_act, max_act, prefix=None, params=None):
        super().__init__(dense, min_act, max_act, prefix=prefix,
                         params=params)
        self._flatten = getattr(dense, "_flatten", True)

    def forward(self, x):
        out = F.quantized_fully_connected(
            _quantize_input(x, self._amax), self._wq, self._bias,
            -self._amax, self._amax, -self._wmax, self._wmax,
            no_bias=self._bias is None, flatten=self._flatten)
        return self._activate(out)


class QuantizedConv2D(_Quantized):
    """int8 Conv2D with calibrated activation range (ref:
    quantized_conv.cc)."""

    def __init__(self, conv, min_act, max_act, prefix=None, params=None):
        super().__init__(conv, min_act, max_act, prefix=prefix,
                         params=params)
        self._kwargs = dict(conv._kwargs)

    def forward(self, x):
        kw = self._kwargs
        out = F.quantized_conv(
            _quantize_input(x, self._amax), self._wq, self._bias,
            -self._amax, self._amax, -self._wmax, self._wmax,
            kernel=kw["kernel"], stride=kw["stride"], pad=kw["pad"],
            num_filter=kw["num_filter"], num_group=kw["num_group"],
            no_bias=self._bias is None, layout=kw.get("layout"),
            dilate=kw.get("dilate"))
        return self._activate(out)


def _walk_swap(block, make):
    for name, child in list(block._children.items()):
        repl = make(child)
        if repl is not None:
            block._children[name] = repl
            # other references to the child (a list of layers) follow too
            for attr, val in list(vars(block).items()):
                if isinstance(val, list) and any(v is child for v in val):
                    val[:] = [repl if v is child else v for v in val]
        else:
            _walk_swap(child, make)


def _any_active(b):
    if getattr(b, "_active", False):
        return True
    return any(_any_active(c) for c in b._children.values())


def quantize_net(net, calib_data=None, calib_mode="naive",
                 quantized_dtype="int8", exclude_layers=()):
    """Swap Dense/Conv2D layers for int8 versions, calibrating activation
    ranges over ``calib_data`` (an iterable of input batches or
    (data, label) tuples).  Returns the same net object, modified in place
    (ref: quantize_net; the reference rewrites the symbol graph — here the
    block tree is rewritten).

    Hybridization is suspended during calibration (collectors read
    concrete values) and restored afterwards: a hybridized ``net`` comes
    back hybridized, its graphs dropped, and captures anew at its next
    call.  A calibration batch that raises unwraps the collectors and
    restores hybridization before the error propagates."""
    assert quantized_dtype == "int8", "int8 is the quantized type"
    if calib_data is None:
        raise ValueError("calib_data is required (naive min/max calibration)")
    was_active = _any_active(net)
    net.hybridize(False)

    # 1) wrap targets in range collectors
    def wrap(child):
        if isinstance(child, (nn.Dense, nn.Conv2D)) and \
                child.name not in exclude_layers:
            return _RangeCollector(child)
        return None

    _walk_swap(net, wrap)

    # 2) run calibration batches; if anything throws, unwrap the
    # collectors and restore hybridization so the caller's net survives
    try:
        for batch in calib_data:
            x = batch[0] if isinstance(batch, (tuple, list)) else batch
            if not isinstance(x, (NDArray, torch.Tensor)):
                from .. import ndarray as nd
                x = nd.array(x, ctx=_device_of(net))
            net(x)
    except Exception:
        _walk_swap(net, lambda c: c.inner
                   if isinstance(c, _RangeCollector) else None)
        if was_active:
            net.hybridize(True)
        raise

    # 3) swap collectors for quantized layers
    def swap(child):
        if isinstance(child, _RangeCollector):
            if child.min_v is None:
                return child.inner      # never exercised: keep float
            inner = child.inner
            if isinstance(inner, nn.Conv2D):
                return QuantizedConv2D(inner, child.min_v, child.max_v)
            return QuantizedDense(inner, child.min_v, child.max_v)
        return None

    _walk_swap(net, swap)
    if was_active:
        net.hybridize(True)
    return net


def _device_of(net):
    for p in net.collect_params().values():
        if p._nd is not None:
            return p._nd._data.device
    return None
