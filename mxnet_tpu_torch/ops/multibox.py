"""SSD detection ops (the port of ``mxnet_tpu/ops/multibox.py``):
``MultiBoxPrior``, ``box_iou``, ``box_nms``, ``MultiBoxTarget``,
``MultiBoxDetection``, ``ROIPooling`` and ``Proposal``, with their
aliases.  Boxes are corner format ``(xmin, ymin, xmax, ymax)``.

Every op keeps the JAX package's fixed shapes and never reads a device
value on the host, so ``MultiBoxPrior`` and ``MultiBoxTarget`` run
inside a captured training step: constants are filled on the device
(``torch.full``), never copied from the host.  Two rules of the JAX
ops on the CPU are kept exactly:

- **the last write wins** where ``MultiBoxTarget`` scatters with
  repeated indices (every padding row of ``label`` has its best anchor
  at 0, and two boxes may share one): the row kept for an anchor is the
  largest row index that names it, found with ``scatter_reduce``
  ``"amax"`` (deterministic on the card, where ``index_put_`` with
  duplicates is not) and then gathered;
- **sorts are stable**, as ``jnp.argsort``: the hard-negative rank and
  the NMS order break ties by index (``torch.argsort(stable=True)``),
  and ``Proposal``'s top-k is a stable descending sort, as
  ``lax.top_k`` orders ties.

Greedy NMS is a loop over ``min(topk, n)`` candidates of masked device
ops, batched over images.
"""
from __future__ import annotations

import math

import torch

from .registry import register_op

__all__ = ["MultiBoxPrior", "box_iou_matrix", "box_iou", "box_nms",
           "MultiBoxTarget", "MultiBoxDetection", "ROIPooling", "Proposal"]

_F32 = torch.float32


def _const(values, device, dtype=_F32):
    """A device tensor of Python numbers, filled on the device (no host
    copy, so it may be made inside a capture)."""
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device)
                        for v in values])


@register_op("MultiBoxPrior", aliases=("multibox_prior",
                                       "_contrib_MultiBoxPrior"))
def MultiBoxPrior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                  steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchors of a ``(N, C, H, W)`` feature map: ``(1, H*W*A, 4)`` in
    float32 with ``A = len(sizes) + len(ratios) - 1``, ordered
    ``(sizes[0], ratios[*])`` then ``(sizes[1:], ratios[0])``."""
    h, w, dev = data.shape[2], data.shape[3], data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=_F32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(w, dtype=_F32, device=dev) + offsets[1]) * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    centers = torch.stack([cxg, cyg], dim=-1).reshape(-1, 2)
    half = []
    for i, s in enumerate(sizes):
        for j, r in enumerate(ratios):
            if i > 0 and j > 0:
                continue
            sr = math.sqrt(r)
            half += [s * sr / 2, s / sr / 2]
    half_wh = _const(half, dev).reshape(-1, 2)                  # (A, 2)
    cs = centers[:, None, :].expand(-1, half_wh.shape[0], -1)
    anchors = torch.cat([cs - half_wh[None], cs + half_wh[None]], dim=-1)
    anchors = anchors.reshape(1, -1, 4)
    return torch.clamp(anchors, 0.0, 1.0) if clip else anchors


def box_iou_matrix(a, b):
    """IoU of ``(..., Na, 4)`` against ``(..., Nb, 4)`` corner boxes:
    ``(..., Na, Nb)``."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) \
        * torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) \
        * torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


@register_op("box_iou", aliases=("_contrib_box_iou",))
def box_iou(lhs, rhs, format="corner"):
    if format == "center":
        def c2c(x):
            cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
            return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                cy + h / 2], dim=-1)
        lhs, rhs = c2c(lhs), c2c(rhs)
    return box_iou_matrix(lhs, rhs)


def _nms(boxes, scores, iou_thresh, topk):
    """Greedy NMS of ``(B, N, 4)`` boxes by ``(B, N)`` scores (``-inf``
    never kept): the keep mask ``(B, N)``."""
    n = boxes.shape[1]
    order = torch.argsort(-scores, dim=1, stable=True)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    iou = box_iou_matrix(boxes_s, boxes_s)                       # (B, N, N)
    keep = torch.gather(scores, 1, order) > -math.inf
    later = torch.arange(n, device=boxes.device)
    for i in range(n if topk <= 0 else min(topk, n)):
        sup = (iou[:, i] > iou_thresh) & (later > i) & keep[:, i:i + 1]
        keep = keep & ~sup
    return torch.zeros_like(keep).scatter(1, order, keep)


@register_op("box_nms", aliases=("_contrib_box_nms",))
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """``(B, N, K)`` rows ``[id, score, x1, y1, x2, y2, ...]``; the
    suppressed rows get score (and id) -1."""
    scores = data[..., score_index]
    boxes = data[..., coord_start:coord_start + 4]
    invalid = scores < valid_thresh
    if id_index >= 0 and background_id >= 0:
        invalid = invalid | (data[..., id_index] == background_id)
    s = torch.where(invalid, torch.full((), -math.inf, dtype=scores.dtype,
                                        device=scores.device), scores)
    if id_index >= 0 and not force_suppress:
        # class-aware: offset boxes by class id so classes never overlap
        boxes = boxes + data[..., id_index:id_index + 1] * 4.0
    dead = ~_nms(boxes, s, overlap_thresh, topk)
    minus = torch.full((), -1.0, dtype=data.dtype, device=data.device)
    out = data.clone()
    out[..., score_index] = torch.where(dead, minus, scores)
    if id_index >= 0:
        out[..., id_index] = torch.where(dead, minus, data[..., id_index])
    return out


def _centers(boxes):
    """Widths, heights and centres of ``(..., 4)`` corner boxes."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return w, h, (boxes[..., 0] + boxes[..., 2]) / 2, \
        (boxes[..., 1] + boxes[..., 3]) / 2


@register_op("MultiBoxTarget", aliases=("multibox_target",
                                        "_contrib_MultiBoxTarget"))
def MultiBoxTarget(anchor, label, cls_pred, overlap_threshold=0.5,
                   ignore_label=-1.0, negative_mining_ratio=-1.0,
                   negative_mining_thresh=0.5, minimum_negative_samples=0,
                   variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor to ground-truth matching and box target encoding.

    ``anchor (1, A, 4)``; ``label (B, M, 5)`` rows ``[cls, x1, y1, x2,
    y2]`` (``cls < 0`` pads); ``cls_pred (B, C+1, A)``.  Returns
    ``(box_target (B, A*4), box_mask (B, A*4), cls_target (B, A))``.
    Hard negatives rank by ``1 - cls_pred[:, 0]`` on the raw
    predictions, as the JAX op ranks them."""
    anchors = anchor[0]                                          # (A, 4)
    dev = anchors.device
    b, m = label.shape[0], label.shape[1]
    a = anchors.shape[0]
    gt_valid = label[..., 0] >= 0                                # (B, M)
    gt_boxes = label[..., 1:5]
    iou = box_iou_matrix(anchors[None], gt_boxes)                # (B, A, M)
    iou = torch.where(gt_valid[:, None, :], iou, torch.zeros_like(iou))
    best_iou = iou.amax(dim=2)                                   # (B, A)
    best_gt = torch.argmax(iou, dim=2)      # the first of equal maxima
    best_anchor = torch.argmax(iou, dim=1)                       # (B, M)
    # each gt claims its best anchor; of the rows naming one anchor the
    # last is kept (the JAX scatter's rule)
    rows = torch.arange(m, device=dev).expand(b, m)
    last = torch.full((b, a), -1, dtype=torch.int64, device=dev) \
        .scatter_reduce(1, best_anchor, rows, "amax", include_self=True)
    claimed = last >= 0
    last = last.clamp(min=0)
    forced = claimed & torch.gather(gt_valid, 1, last)
    pos = forced | (best_iou >= overlap_threshold)
    gt_idx = torch.where(forced, last, best_gt)
    matched = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    zero = torch.zeros((), dtype=label.dtype, device=dev)
    cls_target = torch.where(
        pos, torch.gather(label[..., 0], 1, gt_idx) + 1.0, zero)
    if negative_mining_ratio > 0:
        neg_scores = 1.0 - cls_pred.detach()[:, 0]               # (B, A)
        num_pos = pos.sum(dim=1, dtype=torch.int32)
        max_neg = torch.clamp((num_pos * negative_mining_ratio)
                              .to(torch.int32), min=minimum_negative_samples)
        ranked = -torch.where(pos, torch.full(
            (), -math.inf, dtype=neg_scores.dtype, device=dev), neg_scores)
        order = torch.argsort(ranked, dim=1, stable=True)
        neg_rank = torch.argsort(order, dim=1, stable=True)
        keep_neg = ~pos & (neg_rank < max_neg[:, None])
        cls_target = torch.where(~pos & ~keep_neg, torch.full(
            (), ignore_label, dtype=cls_target.dtype, device=dev),
            cls_target)
    var = _const(variances, dev)
    aw, ah, acx, acy = _centers(anchors)
    gw, gh, gcx, gcy = _centers(matched)
    gw, gh = torch.clamp(gw, min=1e-8), torch.clamp(gh, min=1e-8)
    aw, ah = torch.clamp(aw, min=1e-8), torch.clamp(ah, min=1e-8)
    bt = torch.stack([(gcx - acx) / aw / var[0], (gcy - acy) / ah / var[1],
                      torch.log(gw / aw) / var[2],
                      torch.log(gh / ah) / var[3]], dim=-1)      # (B, A, 4)
    mask = pos[..., None].to(_F32).expand(-1, -1, 4)
    return (bt * mask).reshape(b, -1), mask.reshape(b, -1), cls_target


@register_op("MultiBoxDetection", aliases=("multibox_detection",
                                           "_contrib_MultiBoxDetection"))
def MultiBoxDetection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                      background_id=0, nms_threshold=0.5,
                      force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                      nms_topk=-1):
    """Decode and per-class NMS.  ``cls_prob (B, C+1, A)``, ``loc_pred
    (B, A*4)``, ``anchor (1, A, 4)``; output ``(B, A, 6)`` rows
    ``[cls_id, score, x1, y1, x2, y2]``."""
    anchors = anchor[0]
    var = _const(variances, anchors.device)
    aw, ah, acx, acy = _centers(anchors)
    # bf16 predictions decode in f32, as JAX promotes them by ``var``
    loc = loc_pred.reshape(loc_pred.shape[0], -1, 4).to(
        torch.promote_types(loc_pred.dtype, _F32))
    cx = loc[..., 0] * var[0] * aw + acx
    cy = loc[..., 1] * var[1] * ah + acy
    w = torch.exp(loc[..., 2] * var[2]) * aw / 2
    h = torch.exp(loc[..., 3] * var[3]) * ah / 2
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1)
    score = fg.amax(dim=1)
    cls_id = torch.argmax(fg, dim=1).to(boxes.dtype)
    live = score > threshold
    minus = torch.full((), -1.0, dtype=boxes.dtype, device=boxes.device)
    det = torch.cat([torch.where(live, cls_id, minus)[..., None],
                     torch.where(live, score.to(boxes.dtype),
                                 minus)[..., None], boxes], dim=-1)
    return box_nms(det, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   background_id=-1, force_suppress=force_suppress)


@register_op("ROIPooling", aliases=("roi_pooling",))
def ROIPooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """Max pooling of each ROI ``[batch_idx, x1, y1, x2, y2]`` (scaled
    by ``spatial_scale`` and rounded) into ``pooled_size`` bins:
    ``(R, C, ph, pw)``."""
    ph, pw = pooled_size
    _, _, ih, iw = data.shape
    dev = data.device
    img = data[rois[:, 0].to(torch.int64)]                       # (R, C, H, W)
    x1, y1, x2, y2 = (torch.round(rois[:, k] * spatial_scale)
                      .to(torch.int64)[:, None] for k in (1, 2, 3, 4))
    h = torch.clamp(y2 - y1 + 1, min=1)
    w = torch.clamp(x2 - x1 + 1, min=1)
    ys = torch.arange(ih, device=dev)[None]
    xs = torch.arange(iw, device=dev)[None]
    minus = torch.full((), -1, dtype=torch.int64, device=dev)
    ybin = torch.where((ys >= y1) & (ys <= y2),
                       torch.div((ys - y1) * ph, h, rounding_mode="floor"),
                       minus)
    xbin = torch.where((xs >= x1) & (xs <= x2),
                       torch.div((xs - x1) * pw, w, rounding_mode="floor"),
                       minus)
    yoh = ybin[..., None] == torch.arange(ph, device=dev)        # (R, H, ph)
    xoh = xbin[..., None] == torch.arange(pw, device=dev)        # (R, W, pw)
    sel = yoh[:, None, :, None, :, None] & xoh[:, None, None, :, None, :]
    neg = torch.full((), -1e30, dtype=data.dtype, device=dev)
    expanded = torch.where(sel, img[..., None, None], neg)
    return expanded.amax(dim=(2, 3))


@register_op("Proposal", aliases=("_contrib_Proposal", "proposal"))
def Proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """RPN proposals (Faster-RCNN): fixed shapes, no data-dependent
    filtering; proposals below the minimum size or suppressed score
    ``-inf``, and the fixed top-k pads with the best survivors.

    ``cls_prob (N, 2A, H, W)``, ``bbox_pred (N, 4A, H, W)``, ``im_info
    (N, 3)`` rows ``[height, width, scale]``.  Returns rois ``(N*post,
    5)`` rows ``[batch_idx, x1, y1, x2, y2]`` (and scores ``(N*post,
    1)`` with ``output_score``)."""
    if iou_loss:
        raise NotImplementedError(
            "Proposal(iou_loss=True) — the IoU-loss corner-offset box "
            "decoding is not implemented; the default ctr/size transform "
            "is (fail loudly rather than decode with the wrong transform)")
    a = len(scales) * len(ratios)
    n, _, h, w = cls_prob.shape
    dev = cls_prob.device
    base = []
    cx = cy = (feature_stride - 1) / 2.0
    for r in ratios:
        size = feature_stride * feature_stride
        size_r = round(math.sqrt(size / r))
        ws0, hs0 = size_r, round(size_r * r)
        for s in scales:
            ws, hs = ws0 * s, hs0 * s
            base += [cx - (ws - 1) / 2, cy - (hs - 1) / 2,
                     cx + (ws - 1) / 2, cy + (hs - 1) / 2]
    base = _const(base, dev).reshape(a, 4)
    sx = torch.arange(w, dtype=_F32, device=dev) * feature_stride
    sy = torch.arange(h, dtype=_F32, device=dev) * feature_stride
    shift = torch.stack(torch.meshgrid(sx, sy, indexing="xy"), -1)  # (H, W, 2)
    shift = shift.repeat(1, 1, 2).reshape(h * w, 1, 4)
    anchors = (base[None] + shift).reshape(-1, 4)                # (H*W*A, 4)
    fg = cls_prob[:, a:].permute(0, 2, 3, 1).reshape(n, -1)
    d = bbox_pred.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2) \
        .reshape(n, -1, 4)
    widths = anchors[:, 2] - anchors[:, 0] + 1.0
    heights = anchors[:, 3] - anchors[:, 1] + 1.0
    ctr_x = anchors[:, 0] + 0.5 * (widths - 1)
    ctr_y = anchors[:, 1] + 0.5 * (heights - 1)
    pcx = d[..., 0] * widths + ctr_x
    pcy = d[..., 1] * heights + ctr_y
    pw_ = torch.exp(d[..., 2]) * widths
    ph_ = torch.exp(d[..., 3]) * heights
    boxes = torch.stack([pcx - 0.5 * (pw_ - 1), pcy - 0.5 * (ph_ - 1),
                         pcx + 0.5 * (pw_ - 1), pcy + 0.5 * (ph_ - 1)], -1)
    hi = torch.stack([im_info[:, 1] - 1, im_info[:, 0] - 1,
                      im_info[:, 1] - 1, im_info[:, 0] - 1], -1)[:, None]
    boxes = torch.minimum(torch.clamp(boxes, min=0.0), hi)
    min_size = (rpn_min_size * im_info[:, 2])[:, None]
    keep = ((boxes[..., 2] - boxes[..., 0] + 1 >= min_size)
            & (boxes[..., 3] - boxes[..., 1] + 1 >= min_size))
    ninf = torch.full((), -math.inf, dtype=fg.dtype, device=dev)
    s = torch.where(keep, fg, ninf)

    def top(v, k):
        idx = torch.argsort(v, dim=1, descending=True, stable=True)[:, :k]
        return torch.gather(v, 1, idx), idx

    k_pre = min(rpn_pre_nms_top_n, s.shape[1])
    top_s, top_i = top(s, k_pre)
    top_b = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    s2 = torch.where(_nms(top_b, top_s, threshold, -1), top_s, ninf)
    k_post = min(rpn_post_nms_top_n, s2.shape[1])
    out_s, out_i = top(s2, k_post)
    out_b = torch.gather(top_b, 1, out_i[..., None].expand(-1, -1, 4))
    pad = rpn_post_nms_top_n - k_post
    if pad:
        out_b = torch.nn.functional.pad(out_b, (0, 0, 0, pad))
        out_s = torch.nn.functional.pad(out_s, (0, pad), value=-math.inf)
    batch_idx = torch.arange(n, dtype=_F32, device=dev) \
        .repeat_interleave(rpn_post_nms_top_n)[:, None]
    rois = torch.cat([batch_idx, out_b.reshape(-1, 4)], dim=1)
    if output_score:
        return rois, out_s.reshape(-1, 1)
    return rois
