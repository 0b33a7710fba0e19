"""The port's ``gluon.contrib`` (``mxnet_tpu_torch/gluon/contrib``)
against the JAX package's: ``Estimator.fit``/``evaluate`` with the event
handlers, and ``gluon.contrib.nn``.

Both packages fit the same Dense net from the same parameters over the
same batches (Adam, f32): the parameters after every epoch agree within
1e-5, the logged metrics within 1e-5, the handlers' event order and the
``batches=`` cut are the same, and the checkpoints the port writes load
into the JAX net.  ``HybridConcurrent`` gives JAX's output (f32, within
1e-5: the same convolutions summed in another order) from the same
parameters; the vision zoo's concatenating blocks are made from it.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.contrib import estimator as jest
from mxnet_tpu.gluon.contrib import nn as jcnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.contrib import estimator as tmod
from mxnet_tpu_torch.gluon.contrib import nn as tcnn

TOL = dict(rtol=1e-5, atol=1e-5)


class _Recorder:
    """A handler of each event, recording the order it saw them in."""

    def __init__(self, mod, log):
        base = mod.EventHandler
        self.handler = type("Rec", (base,), {
            ev: (lambda ev: lambda self, est: log.append(
                (ev, est.current_epoch, est.current_batch)))(ev)
            for ev in ("train_begin", "train_end", "epoch_begin",
                       "epoch_end", "batch_begin", "batch_end")})()


def _data(n=96):
    rng = np.random.RandomState(0)
    w = rng.randn(8, 3).astype(np.float32)
    x = rng.randn(n, 8).astype(np.float32)
    y = (x @ w).argmax(1).astype(np.float32)
    return x, y


def _batches(mx, x, y, bs=32):
    return [(mx.nd.array(x[i:i + bs]), mx.nd.array(y[i:i + bs]))
            for i in range(0, len(x), bs)]


def _fit(mx, mod, epochs=2, batches=None, handlers=(), w0=None):
    x, y = _data()
    net = mx.gluon.nn.Dense(3, in_units=8)
    net.initialize()
    if w0 is not None:
        net.weight.set_data(mx.nd.array(w0[0]))
        net.bias.set_data(mx.nd.array(w0[1]))
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.05})
    est = mod.Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                        trainer=trainer)
    log = []
    est.fit(_batches(mx, x, y), val_data=_batches(mx, x, y), epochs=epochs,
            batches=batches,
            event_handlers=[_Recorder(mod, log).handler, *handlers])
    return est, net, log


def _start():
    rng = np.random.RandomState(1)
    return (rng.randn(3, 8).astype(np.float32) * 0.3,
            np.zeros(3, np.float32))


@pytest.mark.parametrize("batches", [None, 2])
def test_fit_as_jax(batches):
    w0 = _start()
    jest_, jnet, jlog = _fit(jmx, jest, batches=batches, w0=w0)
    with tmx.cpu():
        test_, tnet, tlog = _fit(tmx, tmod, batches=batches, w0=w0)
    assert tlog == jlog
    per_epoch = 3 if batches is None else batches
    assert sum(1 for e in tlog if e[0] == "batch_end") == 2 * per_epoch
    np.testing.assert_allclose(tnet.weight.data().asnumpy(),
                               jnet.weight.data().asnumpy(), **TOL)
    np.testing.assert_allclose(tnet.bias.data().asnumpy(),
                               jnet.bias.data().asnumpy(), **TOL)
    tv, jv = dict(test_.metric_values()), dict(jest_.metric_values())
    assert tv.keys() == jv.keys()
    for k in tv:
        np.testing.assert_allclose(tv[k], jv[k], err_msg=k, **TOL)


def test_evaluate_as_jax():
    w0 = _start()
    jest_, _, _ = _fit(jmx, jest, epochs=1, w0=w0)
    with tmx.cpu():
        test_, _, _ = _fit(tmx, tmod, epochs=1, w0=w0)
        x, y = _data()
        got = test_.evaluate(_batches(tmx, x, y, bs=16))
    want = jest_.evaluate(_batches(jmx, x, y, bs=16))
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               **TOL)


def test_fit_and_handlers(tmp_path, caplog):
    """``tests/test_gluon.py``'s estimator case on the port: fit
    converges, logs, checkpoints (every epoch and the best), and the
    checkpoint loads into the JAX package's net (256 samples, as
    there)."""
    x, y = _data(256)
    tmx.random.seed(0)
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(3, in_units=8)
        net.initialize(tmx.init.Xavier())
        trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 0.05})
        est = tmod.Estimator(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             trainer=trainer)
        loader = _batches(tmx, x, y)
        with caplog.at_level(logging.INFO,
                             logger="mxnet_tpu_torch.estimator"):
            est.fit(loader, val_data=loader, epochs=4, event_handlers=[
                tmod.LoggingHandler(log_interval=2),
                tmod.CheckpointHandler(str(tmp_path), monitor="val_loss",
                                       save_best=True),
                tmod.EarlyStoppingHandler("val_accuracy", mode="max",
                                          patience=10)])
    assert dict(est.metric_values())["accuracy"] > 0.8
    assert (tmp_path / "model-0003.params").exists()
    assert (tmp_path / "model-best.params").exists()
    assert any("epoch 3" in r.message for r in caplog.records)
    assert any("batch 2" in r.message for r in caplog.records)
    jnet = jmx.gluon.nn.Dense(3, in_units=8)
    jnet.load_parameters(str(tmp_path / "model-0003.params"))
    np.testing.assert_array_equal(jnet.weight.data().asnumpy(),
                                  net.weight.data().asnumpy())


def test_early_stopping():
    x = np.random.RandomState(0).randn(64, 4).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 2, 64).astype(np.float32)
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(2, in_units=4)
        net.initialize()
        est = tmod.Estimator(
            net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
            trainer=tmx.gluon.Trainer(net.collect_params(), "sgd",
                                      {"learning_rate": 0.0}))
        loader = _batches(tmx, x, y, bs=16)
        est.fit(loader, val_data=loader, epochs=50, event_handlers=[
            tmod.EarlyStoppingHandler("val_loss", patience=1)])
    assert est.current_epoch < 10


def test_loss_must_be_a_gluon_loss():
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(2, in_units=4)
        with pytest.raises(ValueError, match="gluon.loss.Loss"):
            tmod.Estimator(net, lambda a, b: a)


def _concurrent(mx, mod, cls):
    blk = getattr(mod, cls)(axis=1, prefix="cc_")
    with blk.name_scope():
        blk.add(mx.gluon.nn.Conv2D(4, 1, in_channels=3),
                mx.gluon.nn.Conv2D(2, 3, padding=1, in_channels=3))
        blk.add(mx.gluon.nn.Activation("relu"))
    return blk


@pytest.mark.parametrize("cls", ["HybridConcurrent", "Concurrent"])
@pytest.mark.parametrize("hybridize", [False, True])
def test_concurrent_as_jax(cls, hybridize):
    x = np.random.RandomState(2).randn(2, 3, 5, 5).astype(np.float32)
    jmx.random.seed(0)
    jblk = _concurrent(jmx, jcnn, cls)
    jblk.initialize(jmx.init.Xavier())
    with tmx.cpu():
        tblk = _concurrent(tmx, tcnn, cls)
        tblk.initialize(ctx=tmx.cpu())
        tmx.gluon.params_from_jax(tblk, {k: p.data().asnumpy() for k, p in
                                         jblk.collect_params().items()})
        if hybridize:
            tblk.hybridize()
        got = tblk(tmx.nd.array(x)).asnumpy()
    want = jblk(jmx.nd.array(x)).asnumpy()
    assert got.shape == want.shape == (2, 9, 5, 5)
    np.testing.assert_allclose(got, want, **TOL)


def test_contrib_nn_names_and_the_zoo():
    assert tcnn.SyncBatchNorm is tmx.gluon.nn.SyncBatchNorm
    assert set(tcnn.__all__) == set(jcnn.__all__)
    from mxnet_tpu_torch.gluon.model_zoo.vision import inception, squeezenet
    assert squeezenet.HybridConcurrent is tcnn.HybridConcurrent
    assert issubclass(inception._Concurrent, tcnn.HybridConcurrent)
    blk = inception._make_B("b_")
    assert list(blk._children) == ["branch1", "branch2", "branch3"]
