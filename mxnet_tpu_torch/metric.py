"""Evaluation metrics (the port of ``mxnet_tpu/metric.py``'s
``EvalMetric`` and ``Accuracy``; the other metrics come with the Module
API).  Metrics accumulate on the host in float64: ``update``
reads its arrays with ``asnumpy()``, a sync point."""
from __future__ import annotations

import numpy as _np

from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy"]


def _to_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class EvalMetric:
    """Base metric: ``sum_metric / num_inst`` over the updates since the
    last ``reset``."""

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
        return list(zip(_as_list(name), _as_list(value)))


class Accuracy(EvalMetric):
    """The share of predictions (argmax over ``axis`` of scores) equal
    to their labels."""

    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred, label = _to_np(pred), _to_np(label)
            if pred.ndim > label.ndim:
                pred = _np.argmax(pred, axis=self.axis)
            pred = pred.astype(_np.int64).ravel()
            label = label.astype(_np.int64).ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)
