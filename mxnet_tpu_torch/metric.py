"""Evaluation metrics (the port of ``mxnet_tpu/metric.py``): the
registry (``register``, ``create``), ``EvalMetric``,
``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``, ``F1``,
``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``,
``NegativeLogLikelihood``, ``Perplexity`` (the language model's),
``PearsonCorrelation``, ``Loss``, ``Torch``, ``Caffe``,
``CustomMetric``, ``VOCMApMetric`` and ``VOC07MApMetric`` (the
detector's) and ``np``.

Metrics accumulate on the host in float64, in numpy: ``update`` reads
its arrays (NDArrays, tensors or numpy arrays) to the host, a sync
point.
"""
from __future__ import annotations

import numpy as _np
import torch

from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy", "F1",
           "MAE", "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
           "Perplexity", "PearsonCorrelation", "Loss", "Torch", "Caffe",
           "CustomMetric", "VOCMApMetric", "VOC07MApMetric", "create", "np"]

_REGISTRY = {}


def register(klass, *names):
    for n in names or (klass.__name__.lower(),):
        _REGISTRY[n] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric from a name, a callable, a list (composite) or a metric."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        c = CompositeEvalMetric()
        for m in metric:
            c.add(create(m, *args, **kwargs))
        return c
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    name = metric.lower()
    if name not in _REGISTRY:
        raise ValueError(f"unknown metric '{metric}'")
    return _REGISTRY[name](*args, **kwargs)


def _to_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return _np.asarray(x)


class EvalMetric:
    """Base metric: ``sum_metric / num_inst`` since the last ``reset``."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together."""

    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class Accuracy(EvalMetric):
    """The share of argmax predictions equal to their labels."""

    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_np(pred)
            label = _to_np(label)
            if pred.ndim > label.ndim:
                pred = _np.argmax(pred, axis=self.axis)
            pred = pred.astype(_np.int64).ravel()
            label = label.astype(_np.int64).ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


class TopKAccuracy(EvalMetric):
    """The share of labels among the ``top_k`` scores."""

    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_np(pred)
            label = _to_np(label).astype(_np.int64)
            argsorted = _np.argsort(pred, axis=-1)[:, ::-1][:, :self.top_k]
            correct = (argsorted == label.reshape(-1, 1)).any(axis=1)
            self.sum_metric += correct.sum()
            self.num_inst += len(label)


class F1(EvalMetric):
    """Binary F1 over every update."""

    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self.tp = self.fp = self.fn = 0

    def reset(self):
        super().reset()
        if hasattr(self, "tp"):
            self.reset_stats()
        else:
            self.reset_stats()

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_np(pred)
            label = _to_np(label).ravel().astype(_np.int64)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = _np.argmax(pred, axis=-1)
            else:
                pred = (pred.ravel() > 0.5).astype(_np.int64)
            pred = pred.ravel()
            self.tp += int(((pred == 1) & (label == 1)).sum())
            self.fp += int(((pred == 1) & (label == 0)).sum())
            self.fn += int(((pred == 0) & (label == 1)).sum())
            self.num_inst += 1

    def get(self):
        prec = self.tp / max(self.tp + self.fp, 1)
        rec = self.tp / max(self.tp + self.fn, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return self.name, f1


class MAE(EvalMetric):
    """Mean absolute error, averaged per update."""

    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label)
            pred = _to_np(pred)
            self.sum_metric += _np.abs(label - pred.reshape(label.shape)).mean()
            self.num_inst += 1


class MSE(EvalMetric):
    """Mean squared error, averaged per update."""

    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label)
            pred = _to_np(pred)
            self.sum_metric += ((label - pred.reshape(label.shape)) ** 2).mean()
            self.num_inst += 1


class RMSE(MSE):
    """Root of the mean of the updates' mean squared errors."""

    def __init__(self, name="rmse", **kwargs):
        super().__init__(name=name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(_np.sqrt(self.sum_metric / self.num_inst))


class CrossEntropy(EvalMetric):
    """Mean of ``-log(p[label] + eps)``."""

    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype(_np.int64)
            pred = _to_np(pred)
            prob = pred[_np.arange(label.shape[0]), label]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


class NegativeLogLikelihood(CrossEntropy):
    """``CrossEntropy`` under its other name."""

    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


class Perplexity(EvalMetric):
    """``exp`` of the mean ``-log p[label]`` (the language model's
    metric)."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_np(label).ravel().astype(_np.int64)
            pred = _to_np(pred).reshape(-1, _to_np(pred).shape[-1])
            prob = pred[_np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                prob = _np.where(ignore, 1.0, prob)
                num = (~ignore).sum()
            else:
                num = label.shape[0]
            self.sum_metric += -_np.log(_np.maximum(prob, 1e-30)).sum()
            self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(_np.exp(self.sum_metric / self.num_inst))


class PearsonCorrelation(EvalMetric):
    """Pearson correlation of every label and prediction seen."""

    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)
        self._labels = []
        self._preds = []

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self._labels.append(_to_np(label).ravel())
            self._preds.append(_to_np(pred).ravel())
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return self.name, float("nan")
        l = _np.concatenate(self._labels)
        p = _np.concatenate(self._preds)
        return self.name, float(_np.corrcoef(l, p)[0, 1])


class Loss(EvalMetric):
    """Mean of the raw loss values."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _as_list(preds):
            v = _to_np(pred)
            self.sum_metric += v.sum()
            self.num_inst += v.size


class Torch(Loss):
    """``Loss`` under the name ``torch``."""

    def __init__(self, name="torch", **kwargs):
        super().__init__(name=name, **kwargs)


class Caffe(Loss):
    """``Loss`` under the name ``caffe``."""

    def __init__(self, name="caffe", **kwargs):
        super().__init__(name=name, **kwargs)


class CustomMetric(EvalMetric):
    """``feval(label, pred)`` as a metric: a value, or ``(sum, count)``."""

    def __init__(self, feval, name="custom", allow_extra_outputs=False, **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            v = self._feval(_to_np(label), _to_np(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += v
                self.num_inst += 1


class VOCMApMetric(EvalMetric):
    """PASCAL-VOC mean average precision over detection outputs
    (BASELINE config 5's quality bar).

    update(labels, preds):
      preds:  (B, N, 6) rows ``[cls_id, score, x1, y1, x2, y2]``
              (MultiBoxDetection output; cls_id < 0 is padding/background)
      labels: (B, M, 5+) rows ``[cls, x1, y1, x2, y2, (difficult)]``
              (cls < 0 is padding; difficult boxes are excluded)

    AP per class is area under the interpolated precision-recall curve
    (VOC2010+ all-points); see VOC07MApMetric for 11-point interpolation.
    """

    def __init__(self, iou_thresh=0.5, class_names=None, name="mAP",
                 **kwargs):
        self.iou_thresh = iou_thresh
        self.class_names = class_names
        super().__init__(name, **kwargs)

    def reset(self):
        self._scores = {}   # cls -> list of detection scores
        self._match = {}    # cls -> list of 1 (tp) / 0 (fp), same order
        self._npos = {}     # cls -> number of non-difficult gt boxes
        self.num_inst = 0
        self.sum_metric = 0.0

    @staticmethod
    def _iou(box, boxes):
        """IoU of one (4,) box against (K, 4) corner boxes."""
        ix1 = _np.maximum(box[0], boxes[:, 0])
        iy1 = _np.maximum(box[1], boxes[:, 1])
        ix2 = _np.minimum(box[2], boxes[:, 2])
        iy2 = _np.minimum(box[3], boxes[:, 3])
        iw = _np.maximum(ix2 - ix1, 0.0)
        ih = _np.maximum(iy2 - iy1, 0.0)
        inter = iw * ih
        a = (box[2] - box[0]) * (box[3] - box[1])
        b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        return inter / _np.maximum(a + b - inter, 1e-12)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            lab, det = _to_np(label), _to_np(pred)
            for b in range(det.shape[0]):
                self._update_image(lab[b], det[b])
        self.num_inst = 1  # aggregate metric: get() recomputes from state

    def _update_image(self, lab, det):
        gt = lab[lab[:, 0] >= 0]
        difficult = (gt[:, 5] > 0 if gt.shape[1] > 5
                     else _np.zeros(len(gt), bool))
        dets = det[det[:, 0] >= 0]
        classes = set(gt[:, 0].astype(int)) | set(dets[:, 0].astype(int))
        for c in classes:
            gmask = gt[:, 0].astype(int) == c
            gboxes = gt[gmask, 1:5]
            gdiff = difficult[gmask]
            self._npos[c] = self._npos.get(c, 0) + int((~gdiff).sum())
            dmask = dets[:, 0].astype(int) == c
            d = dets[dmask]
            if len(d) == 0:
                continue
            order = _np.argsort(-d[:, 1])
            d = d[order]
            used = _np.zeros(len(gboxes), bool)
            sc = self._scores.setdefault(c, [])
            mt = self._match.setdefault(c, [])
            for row in d:
                if len(gboxes) == 0:
                    sc.append(float(row[1]))
                    mt.append(0)
                    continue
                ious = self._iou(row[2:6], gboxes)
                j = int(ious.argmax())
                if ious[j] >= self.iou_thresh and gdiff[j]:
                    continue  # difficult match: neither tp nor fp (VOC rule)
                hit = ious[j] >= self.iou_thresh and not used[j]
                sc.append(float(row[1]))
                mt.append(1 if hit else 0)
                if hit:
                    used[j] = True

    def _average_precision(self, rec, prec):
        """All-points interpolated AUC (VOC2010+)."""
        mrec = _np.concatenate([[0.0], rec, [1.0]])
        mpre = _np.concatenate([[0.0], prec, [0.0]])
        mpre = _np.maximum.accumulate(mpre[::-1])[::-1]  # precision envelope
        idx = _np.where(mrec[1:] != mrec[:-1])[0]
        return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())

    def get(self):
        aps, names = [], []
        for c in sorted(self._npos):
            npos = self._npos[c]
            if npos == 0:
                continue
            scores = _np.asarray(self._scores.get(c, []), _np.float64)
            match = _np.asarray(self._match.get(c, []), _np.float64)
            if len(scores) == 0:
                ap = 0.0
            else:
                order = _np.argsort(-scores)
                tp = _np.cumsum(match[order])
                fp = _np.cumsum(1.0 - match[order])
                rec = tp / npos
                prec = tp / _np.maximum(tp + fp, 1e-12)
                ap = self._average_precision(rec, prec)
            aps.append(ap)
            names.append(self.class_names[c] if self.class_names
                         else f"class{c}")
        mean = float(_np.mean(aps)) if aps else float("nan")
        return names + [self.name], aps + [mean]

    def get_map(self):
        """The scalar mAP (last entry of get())."""
        return self.get()[1][-1]


class VOC07MApMetric(VOCMApMetric):
    """11-point interpolated AP (the VOC2007 protocol)."""

    def _average_precision(self, rec, prec):
        ap = 0.0
        for t in _np.arange(0.0, 1.1, 0.1):
            p = prec[rec >= t].max() if (rec >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)


def np_metric(numpy_feval, name="custom", allow_extra_outputs=False):
    """A numpy ``feval`` as a ``CustomMetric``."""
    return CustomMetric(numpy_feval, name, allow_extra_outputs)


np = np_metric  # noqa: F811 - reference exports `mx.metric.np`

for _k in ["accuracy", "acc"]:
    _REGISTRY[_k] = Accuracy
_REGISTRY["top_k_accuracy"] = TopKAccuracy
_REGISTRY["top_k_acc"] = TopKAccuracy
_REGISTRY["f1"] = F1
_REGISTRY["mae"] = MAE
_REGISTRY["mse"] = MSE
_REGISTRY["rmse"] = RMSE
_REGISTRY["ce"] = CrossEntropy
_REGISTRY["cross-entropy"] = CrossEntropy
_REGISTRY["nll_loss"] = NegativeLogLikelihood
_REGISTRY["perplexity"] = Perplexity
_REGISTRY["pearsonr"] = PearsonCorrelation
_REGISTRY["loss"] = Loss
_REGISTRY["composite"] = CompositeEvalMetric
_REGISTRY["map"] = VOCMApMetric
_REGISTRY["vocmapmetric"] = VOCMApMetric
_REGISTRY["voc07mapmetric"] = VOC07MApMetric
