"""Port parity: the SSD detection ops of ``mxnet_tpu_torch``
(``ops/multibox.py``, all 18 registered names) against the JAX
package's, on the CPU.

- ``MultiBoxPrior`` (sizes, ratios, clip, steps, offsets), ``box_iou``
  (corner and center), ``box_nms`` (class-aware, forced, background id,
  top-k), ``MultiBoxDetection``, ``ROIPooling`` and ``Proposal``: within
  1e-6 (float32, the same arithmetic), the ids and suppression flags
  exactly.
- ``MultiBoxTarget`` on the traps of the JAX op's rules, as named
  cases: padding rows (whose all-zero IoU column names anchor 0),
  repeated best anchors (two boxes that claim one anchor: the last row
  wins), tied scores (hard-negative ranks break ties by index, as the
  stable ``jnp.argsort`` does), bf16 ``cls_pred`` and a batch drawn as
  ``bench_ssd`` draws its labels: ``cls_target`` and ``box_mask``
  equal, ``box_target`` within 1e-6.
"""
import gc

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import OPS as JOPS
from mxnet_tpu_torch.bench import ssd_labels
from mxnet_tpu_torch.ops.registry import OPS as TOPS

TOL = dict(rtol=1e-6, atol=1e-6)
NAMES = ["MultiBoxPrior", "multibox_prior", "_contrib_MultiBoxPrior",
         "box_iou", "_contrib_box_iou", "box_nms", "_contrib_box_nms",
         "MultiBoxTarget", "multibox_target", "_contrib_MultiBoxTarget",
         "MultiBoxDetection", "multibox_detection",
         "_contrib_MultiBoxDetection", "ROIPooling", "roi_pooling",
         "Proposal", "_contrib_Proposal", "proposal"]


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    yield
    gc.collect()


def _run(op, arrays, dtypes=None, **kw):
    """``nd.<op>`` in both packages on the same numpy inputs (cast to
    ``dtypes`` where given): the JAX results, then the port's."""
    out = []
    for pkg in (jmx, tmx):
        def go():
            args = [pkg.nd.array(a) for a in arrays]
            if dtypes:
                args = [a.astype(d) if d else a for a, d in zip(args, dtypes)]
            res = getattr(pkg.nd, op)(*args, **kw)
            res = res if isinstance(res, (tuple, list)) else [res]
            return [r.astype("float32").asnumpy() for r in res]
        if pkg is tmx:
            with tmx.cpu():
                out.append(go())
        else:
            out.append(go())
    return out


def test_every_name_is_ported():
    assert set(NAMES) <= set(JOPS) and set(NAMES) <= set(TOPS)
    assert {JOPS[n].__module__ for n in NAMES} == {"mxnet_tpu.ops.multibox"}
    for short in ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
                  "box_nms", "box_iou"):
        assert hasattr(tmx.nd.contrib, short)


PRIORS = {
    "defaults": dict(),
    "sizes_ratios": dict(sizes=(0.2, 0.272), ratios=(1, 2, 0.5)),
    "clip": dict(sizes=(0.75, 0.9), ratios=(1, 3, 1 / 3.), clip=True),
    "steps_offsets": dict(sizes=(0.3,), ratios=(1, 2), steps=(0.1, 0.125),
                          offsets=(0.25, 0.75)),
}


@pytest.mark.parametrize("case", sorted(PRIORS))
def test_multibox_prior_matches_jax(case):
    x = np.zeros((2, 3, 5, 7), np.float32)
    want, got = _run("MultiBoxPrior", [x], **PRIORS[case])
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], **TOL)


def _boxes(n, seed, batch=None):
    rng = np.random.RandomState(seed)
    shape = (n,) if batch is None else (batch, n)
    x1, y1 = rng.uniform(0, 0.7, shape), rng.uniform(0, 0.7, shape)
    w, h = rng.uniform(0.05, 0.3, shape), rng.uniform(0.05, 0.3, shape)
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_matches_jax(fmt):
    want, got = _run("box_iou", [_boxes(6, 1, 2), _boxes(5, 2, 2)],
                     format=fmt)
    np.testing.assert_allclose(got[0], want[0], **TOL)


def _dets(b, n, seed, classes=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, classes, (b, n, 1)).astype(np.float32)
    scores = rng.rand(b, n, 1).astype(np.float32)
    scores[0, :4, 0] = 0.5                      # ties, broken by index
    boxes = _boxes(n, seed + 1, b)
    boxes[:, 1::2] = boxes[:, 0::2] + 0.01      # overlapping pairs
    return np.concatenate([ids, scores, boxes], -1)


NMS = {
    "class_aware": dict(overlap_thresh=0.5, id_index=0),
    "force_suppress": dict(overlap_thresh=0.3, id_index=0,
                           force_suppress=True),
    "background": dict(id_index=0, background_id=1, valid_thresh=0.2),
    "topk": dict(overlap_thresh=0.4, topk=5),
    "no_ids": dict(overlap_thresh=0.5),
}


@pytest.mark.parametrize("case", sorted(NMS))
def test_box_nms_matches_jax(case):
    want, got = _run("box_nms", [_dets(2, 16, 3)], **NMS[case])
    np.testing.assert_allclose(got[0], want[0], **TOL)


def _anchors(h=8, w=8):
    x = np.zeros((1, 3, h, w), np.float32)
    return _run("MultiBoxPrior", [x], sizes=(0.2, 0.272),
                ratios=(1, 2, 0.5), clip=True)[0][0]


def _target_case(name):
    rng = np.random.RandomState(5)
    anchor = _anchors()
    a = anchor.shape[1]
    b, classes = 4, 5
    label = ssd_labels(rng, b, classes=classes)
    cls_pred = rng.randn(b, classes + 1, a).astype(np.float32)
    dtype = None
    if name == "repeated_best_anchor":
        # two boxes claim one anchor (the same box twice, and a box
        # inside it), so the scatter sees the anchor twice
        label[:, 1] = label[:, 0]
        label[:, 2] = label[:, 0] + np.array([1, 0, 0, -0.001, -0.001],
                                             np.float32)
        label[:, 3:] = -1.0
    elif name == "padding_first":
        # a valid box whose best anchor is 0, behind padding rows
        label[:, :] = -1.0
        box = anchor[0, 0]
        label[:, 2] = [3, *box]
        label[:, 5] = [1, 0.4, 0.4, 0.8, 0.8]
    elif name == "tied_scores":
        cls_pred[:, 0] = np.round(cls_pred[:, 0] * 2) / 2     # many ties
    elif name == "bf16":
        dtype = "bfloat16"
    elif name == "all_padding":
        label[1] = -1.0
    return anchor, label, cls_pred, dtype


TARGETS = ["bench_labels", "repeated_best_anchor", "padding_first",
           "tied_scores", "bf16", "all_padding"]


@pytest.mark.parametrize("mining", [3.0, -1.0], ids=["mining", "no_mining"])
@pytest.mark.parametrize("case", TARGETS)
def test_multibox_target_matches_jax(case, mining):
    anchor, label, cls_pred, dtype = _target_case(case)
    want, got = _run("MultiBoxTarget", [anchor, label, cls_pred],
                     dtypes=[None, None, dtype], overlap_threshold=0.5,
                     negative_mining_ratio=mining,
                     negative_mining_thresh=0.5)
    bt, bm, ct = got
    np.testing.assert_array_equal(ct, want[2])
    np.testing.assert_array_equal(bm, want[1])
    np.testing.assert_allclose(bt, want[0], **TOL)
    assert bt.shape == (4, anchor.shape[1] * 4) and ct.shape == (
        4, anchor.shape[1])
    if mining > 0:
        assert (ct == -1).any() and (ct > 0).any()


def test_multibox_target_last_row_wins():
    """Two valid rows that claim one anchor: it takes the later row's
    class, as the JAX scatter leaves it."""
    anchor, label, cls_pred, _ = _target_case("repeated_best_anchor")
    _, got = _run("MultiBoxTarget", [anchor, label, cls_pred])
    ct = got[2]
    box = torch.from_numpy(label[0, :3, 1:5])
    from mxnet_tpu_torch.ops.multibox import box_iou_matrix
    iou = box_iou_matrix(torch.from_numpy(anchor[0]), box)
    best = int(iou[:, 0].argmax())
    assert int(iou[:, 2].argmax()) == best
    assert ct[0, best] == label[0, 2, 0] + 1


DETECT = {
    "defaults": dict(),
    "topk": dict(nms_topk=20, nms_threshold=0.45, threshold=0.05),
    "force": dict(force_suppress=True, clip=False),
}


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(DETECT))
def test_multibox_detection_matches_jax(case, dtype):
    rng = np.random.RandomState(7)
    anchor = _anchors(4, 4)
    a = anchor.shape[1]
    logits = rng.randn(2, 4, a).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rng.randn(2, a * 4) * 0.5).astype(np.float32)
    want, got = _run("MultiBoxDetection", [prob, loc, anchor],
                     dtypes=[dtype, dtype, None], **DETECT[case])
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert (got[0][..., 0] >= 0).any()


def test_roi_pooling_matches_jax():
    rng = np.random.RandomState(8)
    data = rng.randn(2, 3, 12, 10).astype(np.float32)
    rois = np.array([[0, 0, 0, 9, 11], [1, 2.4, 3.5, 7.6, 9.1],
                     [0, 4, 4, 4, 4], [1, 1, 2, 20, 30]], np.float32)
    want, got = _run("ROIPooling", [data, rois], pooled_size=(3, 2),
                     spatial_scale=1.0)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    scaled = rois * np.array([1, 2, 2, 2, 2], np.float32)
    want, got = _run("ROIPooling", [data, scaled], pooled_size=(2, 2),
                     spatial_scale=0.5)
    np.testing.assert_allclose(got[0], want[0], **TOL)


@pytest.mark.parametrize("output_score", [False, True])
def test_proposal_matches_jax(output_score):
    rng = np.random.RandomState(9)
    a, h, w = 6, 4, 5
    cls_prob = rng.rand(2, 2 * a, h, w).astype(np.float32)
    cls_prob[:, a:a + 2] = 0.5                       # tied scores
    bbox = (rng.randn(2, 4 * a, h, w) * 0.2).astype(np.float32)
    im_info = np.array([[64, 80, 1.0], [60, 70, 0.5]], np.float32)
    kw = dict(rpn_pre_nms_top_n=50, rpn_post_nms_top_n=30, threshold=0.7,
              rpn_min_size=4, scales=(2, 4), ratios=(0.5, 1, 2),
              feature_stride=16, output_score=output_score)
    want, got = _run("Proposal", [cls_prob, bbox, im_info], **kw)
    assert len(got) == len(want) == (2 if output_score else 1)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, **TOL)
