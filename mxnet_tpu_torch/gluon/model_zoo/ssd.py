"""SSD detectors (the port of ``mxnet_tpu/gluon/model_zoo/ssd.py``;
BASELINE config 5): a ResNet v1 backbone in NCHW (not fused, as in the
JAX package), extra down-sampling blocks, a 3x3 class and box predictor
per scale, and the multibox ops (``ops/multibox.py``).

``SSD.forward`` gives ``(cls_pred (B, C+1, A), loc_pred (B, A*4),
anchor (1, A, 4))``; ``targets`` is ``MultiBoxTarget`` and ``detect``
decodes with ``MultiBoxDetection``.  Every shape is fixed and the
anchors are made on the device, so a training step of forward,
``MultiBoxTarget``, ``SSDMultiBoxLoss``, backward and update is one
captured graph on the card.  Parameter names and shapes are the JAX
package's (``params_from_jax`` copies a JAX SSD's in).
"""
from __future__ import annotations

import torch

from ... import ops as F
from ...ndarray.ndarray import NDArray, invoke
from .. import nn
from ..block import HybridBlock
from ..loss import Loss
from .vision.resnet import get_resnet

__all__ = ["SSD", "SSDMultiBoxLoss", "ssd_512_resnet50_v1",
           "ssd_300_resnet34_v1"]


class _PredictorHead(HybridBlock):
    """A 3x3 conv predictor of one scale: ``(B, A*K, H, W)`` ->
    ``(B, H*W*A*K)`` in anchor-major order."""

    def __init__(self, num_anchors, channels_per_anchor, in_channels,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._n = num_anchors * channels_per_anchor
        with self.name_scope():
            self.conv = nn.Conv2D(self._n, kernel_size=3, padding=1,
                                  in_channels=in_channels)

    def forward(self, x):
        y = self.conv(x).permute(0, 2, 3, 1)
        return y.reshape(y.shape[0], -1)


def _op(name, *args, **kwargs):
    """Op ``name`` on tensors, or through ``nd`` on NDArrays (NDArrays
    back)."""
    if any(isinstance(a, NDArray) for a in args):
        return invoke(name, *args, **kwargs)
    return F.OPS[name](*args, **kwargs)


def _down_block(channels, stride, in_channels):
    """An extra feature block: 1x1 squeeze, then a 3x3 at ``stride``."""
    blk = nn.HybridSequential()
    blk.add(nn.Conv2D(channels // 2, 1, use_bias=False,
                      in_channels=in_channels),
            nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(channels, 3, strides=stride, padding=1, use_bias=False,
                      in_channels=channels // 2),
            nn.BatchNorm(), nn.Activation("relu"))
    return blk


class SSD(HybridBlock):
    """A single-shot detector over multi-scale feature maps."""

    def __init__(self, backbone_features, num_classes, sizes, ratios,
                 extra_channels=(512, 256, 256, 256),
                 backbone_out_channels=2048, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert len(sizes) == len(ratios)
        self.num_classes = num_classes
        self._sizes = sizes
        self._ratios = ratios
        num_scales = len(sizes)
        with self.name_scope():
            self.features = backbone_features
            self.extras = nn.HybridSequential()
            in_ch = backbone_out_channels
            for i, ch in enumerate(extra_channels):
                if i >= num_scales - 1:
                    break
                self.extras.add(_down_block(ch, 2, in_ch))
                in_ch = ch
            self.cls_heads = nn.HybridSequential()
            self.loc_heads = nn.HybridSequential()
            chans = [backbone_out_channels] + list(
                extra_channels[:num_scales - 1])
            for i in range(num_scales):
                a = len(sizes[i]) + len(ratios[i]) - 1
                self.cls_heads.add(_PredictorHead(
                    a, num_classes + 1, in_channels=chans[i]))
                self.loc_heads.add(_PredictorHead(a, 4, in_channels=chans[i]))

    def forward(self, x):
        feats = [self.features(x)]
        for blk in self.extras._children.values():
            feats.append(blk(feats[-1]))
        cls_preds, loc_preds, anchors = [], [], []
        heads = zip(self.cls_heads._children.values(),
                    self.loc_heads._children.values())
        for i, (feat, (cls_head, loc_head)) in enumerate(zip(feats, heads)):
            cls_preds.append(cls_head(feat))      # (B, H*W*A*(C+1))
            loc_preds.append(loc_head(feat))      # (B, H*W*A*4)
            anchors.append(F.MultiBoxPrior(
                feat, sizes=self._sizes[i], ratios=self._ratios[i],
                clip=True))
        cls_pred = torch.cat(cls_preds, dim=1)
        cls_pred = cls_pred.reshape(cls_pred.shape[0], -1,
                                    self.num_classes + 1).transpose(1, 2)
        return cls_pred, torch.cat(loc_preds, dim=1), torch.cat(anchors, 1)

    def targets(self, anchor, label, cls_pred, overlap_threshold=0.5,
                negative_mining_ratio=3.0):
        """``MultiBoxTarget``: ``(box_target, box_mask, cls_target)``;
        ``label (B, M, 5)`` rows ``[cls_id, x1, y1, x2, y2]``, ``cls_id
        < 0`` pads."""
        return _op("MultiBoxTarget", anchor, label, cls_pred,
                   overlap_threshold=overlap_threshold,
                   negative_mining_ratio=negative_mining_ratio,
                   negative_mining_thresh=0.5)

    def detect(self, cls_pred, loc_pred, anchor, nms_threshold=0.45,
               threshold=0.01, nms_topk=400):
        """Decode and NMS: ``(B, A, 6)`` rows ``[cls_id, score, x1, y1,
        x2, y2]``."""
        probs = _op("softmax", cls_pred, axis=1)
        return _op("MultiBoxDetection", probs, loc_pred, anchor,
                   nms_threshold=nms_threshold, threshold=threshold,
                   nms_topk=nms_topk)


class SSDMultiBoxLoss(Loss):
    """Softmax cross-entropy over the anchors that hard-negative mining
    kept (``cls_target`` -1 is ignored), plus ``lambd`` times smooth-L1
    on the masked box offsets, each averaged per image."""

    def __init__(self, lambd=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._lambd = lambd

    def hybrid_forward(self, F, cls_pred, loc_pred, cls_target, box_target,
                       box_mask):
        lp = F.log_softmax(cls_pred, axis=1)
        tgt = torch.clamp(cls_target, min=0.0).to(torch.int32)
        picked = -F.pick(lp.transpose(1, 2), tgt, axis=-1)      # (B, A)
        keep = (cls_target >= 0).to(lp.dtype)
        n_valid = torch.clamp(keep.sum(dim=1), min=1.0)
        cls_loss = (picked * keep).sum(dim=1) / n_valid
        loc_l = F.smooth_l1((loc_pred - box_target) * box_mask, scalar=1.0)
        n_pos = torch.clamp(box_mask.sum(dim=1), min=1.0)
        return cls_loss + self._lambd * (loc_l.sum(dim=1) / n_pos)


def _resnet_backbone(num_layers):
    """A ResNet v1's features without the global pool (and the
    classifier)."""
    net = get_resnet(1, num_layers)
    feats = nn.HybridSequential()
    for b in list(net.features._children.values())[:-1]:
        feats.add(b)
    return feats


# normalized anchor scales 0.07..0.9 with sqrt intermediate sizes (the
# canonical SSD schedule)
_SIZES = [[.07, .1025], [.15, .2121], [.3, .3674], [.45, .5196],
          [.6, .6708], [.75, .8216], [.9, .9721]]
_RATIOS = [[1, 2, .5]] + [[1, 2, .5, 3, 1. / 3]] * 3 + [[1, 2, .5]] * 3


def ssd_512_resnet50_v1(classes=20, **kwargs):
    """SSD-512 on ResNet-50 v1 (BASELINE config 5)."""
    return SSD(_resnet_backbone(50), classes, _SIZES, _RATIOS,
               extra_channels=(512, 512, 256, 256, 256, 256),
               backbone_out_channels=2048, **kwargs)


def ssd_300_resnet34_v1(classes=20, **kwargs):
    """The smaller SSD-300 on ResNet-34 v1."""
    return SSD(_resnet_backbone(34), classes, _SIZES[:6], _RATIOS[:6],
               extra_channels=(512, 256, 256, 256, 256),
               backbone_out_channels=512, **kwargs)
