"""ResNet V1 (the port of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``'s
``BasicBlockV1``, ``BottleneckV1``, ``ResNetV1`` and ``get_resnet``).

``fused=True`` (NHWC only) folds each block's inner BN+ReLU pairs into
the next conv through ``nn.NormReluConv2D``: in a bottleneck, bn1+relu
into the 3x3 and bn2+relu into the closing 1x1 — the hand-written
kernels on the card.  ``fused=False`` is the plain Conv2D/BatchNorm
stack (cuDNN convs on the card), the yardstick.  The V2 (pre-activation)
classes are not ported yet.

``params_from_jax(net, arrays)`` loads a JAX net's parameters (name ->
numpy) into a port net of the same configuration.
"""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "get_resnet", "params_from_jax"]


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout)


def _bn_axis(layout):
    return -1 if layout[-1] == "C" else 1


class BasicBlockV1(HybridBlock):
    """Two 3x3 convs; ``fused=True`` folds bn1+relu into the second."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", fused=False, **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self._fused = fused
        if fused:
            assert layout == "NHWC", "fused resnet blocks need NHWC"
            self.conv1 = _conv3x3(channels, stride, in_channels, layout)
            self.f2 = nn.NormReluConv2D(channels, 3, in_channels=channels)
            self.bn2 = nn.BatchNorm(axis=ax)
        else:
            self.body = nn.HybridSequential(prefix="")
            self.body.add(_conv3x3(channels, stride, in_channels, layout))
            self.body.add(nn.BatchNorm(axis=ax))
            self.body.add(nn.Activation("relu"))
            self.body.add(_conv3x3(channels, 1, channels, layout))
            self.body.add(nn.BatchNorm(axis=ax))
        self.downsample = _downsample(channels, stride, in_channels, layout,
                                      ax) if downsample else None

    def forward(self, x):
        from .... import ops as F
        residual = x
        x = self.bn2(self.f2(self.conv1(x))) if self._fused else self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BottleneckV1(HybridBlock):
    """1x1 -> 3x3 -> 1x1 (the ResNet-50 block); ``fused=True`` folds
    bn1+relu into the 3x3 and bn2+relu into the closing 1x1."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", fused=False, **kwargs):
        super().__init__(**kwargs)
        ax = _bn_axis(layout)
        self._fused = fused
        if fused:
            assert layout == "NHWC", "fused resnet blocks need NHWC"
            self.conv1 = nn.Conv2D(channels // 4, kernel_size=1,
                                   strides=stride, use_bias=False,
                                   layout=layout)
            self.f2 = nn.NormReluConv2D(channels // 4, 3,
                                        in_channels=channels // 4)
            self.f3 = nn.NormReluConv2D(channels, 1,
                                        in_channels=channels // 4)
            self.bn3 = nn.BatchNorm(axis=ax)
        else:
            self.body = nn.HybridSequential(prefix="")
            self.body.add(nn.Conv2D(channels // 4, kernel_size=1,
                                    strides=stride, use_bias=False,
                                    layout=layout))
            self.body.add(nn.BatchNorm(axis=ax))
            self.body.add(nn.Activation("relu"))
            self.body.add(_conv3x3(channels // 4, 1, channels // 4, layout))
            self.body.add(nn.BatchNorm(axis=ax))
            self.body.add(nn.Activation("relu"))
            self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                    use_bias=False, layout=layout))
            self.body.add(nn.BatchNorm(axis=ax))
        self.downsample = _downsample(channels, stride, in_channels, layout,
                                      ax) if downsample else None

    def forward(self, x):
        from .... import ops as F
        residual = x
        if self._fused:
            x = self.bn3(self.f3(self.f2(self.conv1(x))))
        else:
            x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


def _downsample(channels, stride, in_channels, layout, ax):
    ds = nn.HybridSequential(prefix="")
    ds.add(nn.Conv2D(channels, kernel_size=1, strides=stride,
                     use_bias=False, in_channels=in_channels, layout=layout))
    ds.add(nn.BatchNorm(axis=ax))
    return ds


class ResNetV1(HybridBlock):
    """Stem (7x7/2 conv, BN, ReLU, 3x3/2 max pool, or a 3x3 conv with
    ``thumbnail``), four stages of ``block``, global average pool,
    dense classifier."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", fused=False, **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        self._layout = layout
        ax = _bn_axis(layout)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, layout=layout))
                self.features.add(nn.BatchNorm(axis=ax))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels=channels[i], layout=layout, fused=fused))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.output = nn.Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels=0, layout="NCHW", fused=False):
        kw = {"fused": fused} if fused else {}
        layer = nn.HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, layout=layout,
                            prefix="", **kw))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                layout=layout, prefix="", **kw))
        return layer

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_BLOCKS = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}


def get_resnet(version, num_layers, **kwargs):
    """A ResNet of the given depth; version 1 only (V2 is not ported)."""
    if version != 1:
        raise NotImplementedError("the port has ResNet V1 only; V2 "
                                  "(pre-activation) is not ported yet")
    if num_layers not in resnet_spec:
        raise ValueError(f"invalid depth {num_layers}")
    block_type, layers, channels = resnet_spec[num_layers]
    return ResNetV1(_BLOCKS[block_type], layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def _strip(names):
    """Names without their common net prefix (up to the last ``_`` that
    all of them share)."""
    names = list(names)
    first, last = min(names), max(names)
    i = 0
    while i < min(len(first), len(last)) and first[i] == last[i]:
        i += 1
    cut = first[:i].rfind("_") + 1
    return {n[cut:]: n for n in names}


def params_from_jax(net, arrays):
    """Copy a JAX net's parameters into ``net`` (a port net of the same
    configuration): ``arrays`` maps the JAX net's ``collect_params()``
    names to numpy arrays.  Names are matched with each net's own prefix
    stripped (``resnetv10_stage1_conv0_weight`` ->
    ``stage1_conv0_weight``); every name must match one to one, and
    every shape must match the port parameter's known dims.  Values are
    cast to each port parameter's dtype and device; a deferred parameter
    takes the array's shape and initialises from it."""
    params = net.collect_params()
    ours, theirs = _strip(params.keys()), _strip(arrays.keys())
    if set(ours) != set(theirs):
        raise ValueError(f"parameter names differ: only in the port "
                         f"{sorted(set(ours) - set(theirs))}, only in the "
                         f"JAX net {sorted(set(theirs) - set(ours))}")
    for key, name in ours.items():
        p, value = params[name], arrays[theirs[key]]
        known = p.shape or ()
        if len(known) != value.ndim or any(
                s not in (0, v) for s, v in zip(known, value.shape)):
            raise ValueError(f"shape of {name}: port {p.shape}, JAX "
                             f"{tuple(value.shape)}")
        if p._data is not None and tuple(p._data.shape) != value.shape:
            raise ValueError(f"shape of {name}: port "
                             f"{tuple(p._data.shape)}, JAX {value.shape}")
        p.set_data(value)
