"""Port parity: ``metric`` of ``mxnet_tpu_torch`` against the JAX
package's ``mxnet_tpu/metric.py``, on the CPU.

Every metric class and the registry: the same updates (NDArrays of each
package from the same numpy arrays; torch tensors and numpy arrays into
the port too) give the same ``get()`` and ``get_name_value()`` within
1e-12 (both accumulate in float64 on the host), across two updates and
a ``reset``; ``create`` resolves the same names to the same classes;
``CompositeEvalMetric``, ``CustomMetric`` and ``np`` wrap as the JAX
ones do; ``VOCMApMetric`` and ``VOC07MApMetric`` on detections with
padding, difficult boxes and misses.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-12, atol=1e-12)


def _probs(n, k, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, k).astype(np.float32) + 0.05
    return x / x.sum(1, keepdims=True)


def _labels(n, k, seed):
    return np.random.RandomState(seed).randint(0, k, n).astype(np.float32)


def _regression(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(6, 1).astype(np.float32), rng.randn(6).astype(
        np.float32)


CASES = {
    "accuracy": (lambda m: m.Accuracy(),
                 lambda s: (_labels(8, 4, s), _probs(8, 4, s + 1))),
    "top_k": (lambda m: m.TopKAccuracy(top_k=2),
              lambda s: (_labels(8, 5, s), _probs(8, 5, s + 1))),
    "f1_binary": (lambda m: m.F1(),
                  lambda s: (_labels(10, 2, s), _probs(10, 2, s + 1))),
    "f1_scores": (lambda m: m.F1(),
                  lambda s: (_labels(10, 2, s),
                             np.random.RandomState(s).rand(10)
                             .astype(np.float32))),
    "mae": (lambda m: m.MAE(), lambda s: _regression(s)[::-1]),
    "mse": (lambda m: m.MSE(), lambda s: _regression(s)[::-1]),
    "rmse": (lambda m: m.RMSE(), lambda s: _regression(s)[::-1]),
    "cross_entropy": (lambda m: m.CrossEntropy(),
                      lambda s: (_labels(8, 4, s), _probs(8, 4, s + 1))),
    "nll": (lambda m: m.NegativeLogLikelihood(),
            lambda s: (_labels(8, 4, s), _probs(8, 4, s + 1))),
    "perplexity": (lambda m: m.Perplexity(),
                   lambda s: (_labels(12, 6, s).reshape(3, 4),
                              _probs(12, 6, s + 1).reshape(3, 4, 6))),
    "perplexity_ignore": (lambda m: m.Perplexity(ignore_label=0),
                          lambda s: (_labels(12, 6, s),
                                     _probs(12, 6, s + 1))),
    "pearsonr": (lambda m: m.PearsonCorrelation(),
                 lambda s: _regression(s)[::-1]),
    "loss": (lambda m: m.Loss(), lambda s: (None, _regression(s)[1])),
    "torch": (lambda m: m.Torch(), lambda s: (None, _regression(s)[1])),
    "caffe": (lambda m: m.Caffe(), lambda s: (None, _regression(s)[1])),
    "custom": (lambda m: m.CustomMetric(
        lambda l, p: float(np.abs(l - p.argmax(1)).sum()), name="dist"),
        lambda s: (_labels(8, 4, s), _probs(8, 4, s + 1))),
    "custom_pair": (lambda m: m.CustomMetric(
        lambda l, p: (float((l == p.argmax(1)).sum()), len(l))),
        lambda s: (_labels(8, 4, s), _probs(8, 4, s + 1))),
    "np": (lambda m: m.np(lambda l, p: float(p.max()), name="peak"),
           lambda s: (_labels(8, 4, s), _probs(8, 4, s + 1))),
    "composite": (lambda m: m.create(["acc", "ce", "top_k_accuracy"]),
                  lambda s: (_labels(8, 4, s), _probs(8, 4, s + 1))),
    "created": (lambda m: m.create("perplexity", ignore_label=None),
                lambda s: (_labels(8, 4, s), _probs(8, 4, s + 1))),
}


def _feed(pkg, metric, labels, preds, how):
    def conv(a):
        if a is None:
            return None
        if how == "nd":
            return pkg.nd.array(a)
        if how == "torch":
            return torch.from_numpy(a)
        return a
    metric.update([conv(labels)], [conv(preds)])


def _same(got, want):
    (gn, gv), (wn, wv) = got, want
    assert gn == wn
    np.testing.assert_allclose(np.asarray(gv, np.float64),
                               np.asarray(wv, np.float64), **TOL)


@pytest.mark.parametrize("how", ["nd", "torch", "numpy"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax(case, how):
    make, data = CASES[case]
    jm, tm = make(jmx.metric), make(tmx.metric)
    assert type(tm).__name__ == type(jm).__name__
    with tmx.cpu():
        for seed in (0, 10):
            labels, preds = data(seed)
            _feed(jmx, jm, labels, preds, "nd")
            _feed(tmx, tm, labels, preds, how)
            _same(tm.get(), jm.get())
        assert tm.get_name_value() == pytest.approx(jm.get_name_value())
        assert str(tm) == str(jm)
        jm.reset()
        tm.reset()
        labels, preds = data(20)
        _feed(jmx, jm, labels, preds, "nd")
        _feed(tmx, tm, labels, preds, how)
        _same(tm.get(), jm.get())


def test_registry_names_match_jax():
    names = ["accuracy", "acc", "top_k_accuracy", "top_k_acc", "f1", "mae",
             "mse", "rmse", "ce", "cross-entropy", "nll_loss", "perplexity",
             "pearsonr", "loss", "composite", "map", "vocmapmetric",
             "voc07mapmetric"]
    for n in names:
        assert type(tmx.metric.create(n)).__name__ == \
            type(jmx.metric.create(n)).__name__, n
    assert sorted(tmx.metric._REGISTRY) == sorted(jmx.metric._REGISTRY)
    assert tmx.metric.__all__ == jmx.metric.__all__
    with pytest.raises(ValueError, match="unknown metric"):
        tmx.metric.create("nope")
    m = tmx.metric.Accuracy()
    assert tmx.metric.create(m) is m

    class Mine(tmx.metric.EvalMetric):
        pass
    tmx.metric.register(Mine, "mine")
    assert isinstance(tmx.metric.create("mine", "x"), Mine)


def _detections():
    """Two images: detections with padding rows, a duplicate, a miss and
    a difficult ground truth."""
    labels = np.full((2, 4, 6), -1.0, np.float32)
    labels[0, 0] = [0, 0.1, 0.1, 0.4, 0.4, 0]
    labels[0, 1] = [1, 0.5, 0.5, 0.9, 0.9, 0]
    labels[0, 2] = [1, 0.0, 0.6, 0.2, 0.9, 1]          # difficult
    labels[1, 0] = [2, 0.2, 0.2, 0.6, 0.7, 0]
    labels[1, 1] = [0, 0.6, 0.1, 0.9, 0.3, 0]
    preds = np.full((2, 6, 6), -1.0, np.float32)
    preds[0, 0] = [0, 0.9, 0.12, 0.1, 0.41, 0.38]
    preds[0, 1] = [0, 0.6, 0.1, 0.12, 0.4, 0.4]        # duplicate
    preds[0, 2] = [1, 0.8, 0.5, 0.52, 0.88, 0.9]
    preds[0, 3] = [1, 0.7, 0.0, 0.62, 0.21, 0.88]      # the difficult one
    preds[1, 0] = [2, 0.3, 0.25, 0.2, 0.6, 0.65]
    preds[1, 1] = [0, 0.95, 0.0, 0.0, 0.2, 0.2]        # a miss
    preds[1, 2] = [1, 0.4, 0.3, 0.3, 0.5, 0.5]         # no such class
    return labels, preds


@pytest.mark.parametrize("cls", ["VOCMApMetric", "VOC07MApMetric"])
def test_voc_map_matches_jax(cls):
    labels, preds = _detections()
    names = ["a", "b", "c"]
    jm = getattr(jmx.metric, cls)(class_names=names)
    tm = getattr(tmx.metric, cls)(class_names=names)
    with tmx.cpu():
        for how in ("nd", "torch"):
            _feed(jmx, jm, labels, preds, "nd")
            _feed(tmx, tm, labels, preds, how)
            _same(tm.get(), jm.get())
        assert tm.get_map() == pytest.approx(jm.get_map(), abs=1e-12)
        assert 0 < tm.get_map() < 1
        tm.reset()
        jm.reset()
        _feed(tmx, tm, labels[:1], preds[:1], "nd")
        _feed(jmx, jm, labels[:1], preds[:1], "nd")
        _same(tm.get(), jm.get())
