"""``gluon.Trainer`` and the optimizers of the port against the JAX
package's, on the Gluon MLP of ``examples/train_mnist_mlp.py``.

- The example's own ``_run`` body runs on both packages (the port on
  ``mx.cpu()``) over the same seeded MNIST-shaped batches from the same
  initial parameters, eager and hybridized (``--hybridize``): 3
  training steps, the losses of every step and the final parameters
  equal within rtol/atol 1e-4.
- An MLP 784 -> 32 -> 10 takes 3 ``Trainer.step``s under SGD with
  momentum, NAG, Adam, AdamW, RMSProp, AdaGrad and LAMB, and 5 under
  Adamax, Nadam, LARS, AdaDelta, Ftrl, Signum and signSGD: losses and
  parameters within 1e-4 of the JAX package's.  SGLD draws its noise
  from the port's generator: its deterministic part (the update with
  the noise, drawn again from the same generator state, taken off)
  equals the JAX formula within 1e-6, and its noise, the port's and the
  JAX package's alike, is standard normal (mean within 5 standard
  errors of 0, standard deviation within 3% of 1 over 20000 draws).
- ``save_parameters`` written by either package loads in the other, and
  ``save_states``/``load_states`` round-trip (and cross the packages).
"""
import argparse
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
IN_UNITS = {128: 784, 64: 128, 10: 64}     # the example's Dense widths


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_mnist_mlp", os.path.join(ROOT, "examples",
                                        "train_mnist_mlp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batches(n, batch, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, 1, 28, 28).astype(np.float32),
             rng.randint(0, 10, batch).astype(np.int32)) for _ in range(n)]


def _run_example(pkg, batches, start=None, hybridize=False):
    """``_run`` of the example with ``pkg`` as ``mx``: returns the loss
    of every step, the initial and the final parameters (in layer
    order).  With ``start``, the net's parameters are set from it when
    the Trainer is made, i.e. after ``initialize``."""
    example = _example()
    seen = {"losses": []}

    class Trainer(pkg.gluon.Trainer):
        def __init__(self, params, *args, **kwargs):
            plist = list(params.values())
            if start is not None:
                for p, v in zip(plist, start):
                    p.set_data(v)
            seen["start"] = [p.data().asnumpy() for p in plist]
            seen["params"] = plist
            super().__init__(params, *args, **kwargs)

    class Loss(pkg.gluon.loss.SoftmaxCrossEntropyLoss):
        def __call__(self, *args):
            out = super().__call__(*args)
            if pkg.autograd.is_recording():
                seen["losses"].append(out.asnumpy())
            return out

    def Dense(units, **kwargs):        # sized now, so set_data can run
        return pkg.gluon.nn.Dense(units, in_units=IN_UNITS[units], **kwargs)

    example.mx = pkg
    example.autograd = pkg.autograd
    example.gluon = types.SimpleNamespace(
        nn=types.SimpleNamespace(
            HybridSequential=pkg.gluon.nn.HybridSequential, Dense=Dense),
        Trainer=Trainer,
        loss=types.SimpleNamespace(SoftmaxCrossEntropyLoss=Loss))
    data = [(pkg.nd.array(x), pkg.nd.array(y, dtype="int32"))
            for x, y in batches]
    args = argparse.Namespace(epochs=1, lr=0.1, hybridize=hybridize)
    example._run(args, data, data[:1])
    return (seen["losses"], seen["start"],
            [p.data().asnumpy() for p in seen["params"]])


@pytest.mark.parametrize("hybridize", [False, True])
def test_example_run_matches_jax(capsys, hybridize):
    batches = _batches(3, 64)
    j_losses, j_start, j_end = _run_example(jmx, batches,
                                            hybridize=hybridize)
    with tmx.cpu():
        t_losses, t_start, t_end = _run_example(tmx, batches, start=j_start,
                                                hybridize=hybridize)
    assert "epoch 0: train_acc=" in capsys.readouterr().out
    assert len(t_losses) == len(j_losses) == 3
    for t, j in zip(t_losses, j_losses):
        np.testing.assert_allclose(t, j, **TOL)
    assert [p.shape for p in t_end] == [(128, 784), (128,), (64, 128),
                                        (64,), (10, 64), (10,)]
    for t, j in zip(t_end, j_end):
        np.testing.assert_allclose(t, j, **TOL)
    assert not np.allclose(t_end[0], j_start[0])


# ------------------------------------------------------ the small MLP ---
def _mlp(pkg, prefix="mlp_"):
    net = pkg.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(32, activation="relu", in_units=784),
                pkg.gluon.nn.Dense(10, in_units=32))
    return net


def _start(seed=1):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for s in ((32, 784), (32,), (10, 32), (10,))]


def _train(pkg, optimizer, params, steps, batches, trainer=None, net=None):
    if net is None:
        net = _mlp(pkg)
        net.initialize()
        for p, v in zip(net.collect_params().values(), params):
            p.set_data(v)
    if trainer is None:
        trainer = pkg.gluon.Trainer(net.collect_params(), optimizer[0],
                                    dict(optimizer[1]))
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for x, y in batches[:steps]:
        data = pkg.nd.array(x.reshape(len(x), -1))
        label = pkg.nd.array(y, dtype="int32")
        with pkg.autograd.record():
            loss = loss_fn(net(data), label)
        loss.backward()
        trainer.step(len(x))
        losses.append(loss.asnumpy())
    return net, trainer, losses


OPTIMIZERS = {
    "sgd_momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 1e-3}),
    "nag": ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    "adam": ("adam", {"learning_rate": 0.01, "wd": 1e-3}),
    "adamw": ("adamw", {"learning_rate": 0.01, "wd": 1e-2}),
    "rmsprop": ("rmsprop", {"learning_rate": 0.01, "centered": True}),
    "adagrad": ("adagrad", {"learning_rate": 0.1, "clip_gradient": 0.05}),
    "lamb": ("lamb", {"learning_rate": 0.01, "wd": 1e-2}),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_trainer_steps_match_jax(name):
    batches = _batches(3, 16, seed=2)
    start = _start()
    jnet, _, j_losses = _train(jmx, OPTIMIZERS[name], start, 3, batches)
    with tmx.cpu():
        tnet, _, t_losses = _train(tmx, OPTIMIZERS[name], start, 3, batches)
    for t, j in zip(t_losses, j_losses):
        np.testing.assert_allclose(t, j, **TOL)
    for (kt, t), (kj, j) in zip(tnet.collect_params().items(),
                                jnet.collect_params().items()):
        assert kt == kj
        np.testing.assert_allclose(t.data().asnumpy(), j.data().asnumpy(),
                                   **TOL, err_msg=kt)


NEW_OPTIMIZERS = {
    "adamax": ("adamax", {"learning_rate": 0.01, "wd": 1e-3}),
    "nadam": ("nadam", {"learning_rate": 0.01, "wd": 1e-3}),
    "lars": ("lars", {"learning_rate": 0.1, "momentum": 0.9, "eta": 0.01,
                      "wd": 1e-3}),
    "adadelta": ("adadelta", {"wd": 1e-3, "clip_gradient": 0.05}),
    "ftrl": ("ftrl", {"learning_rate": 0.1, "lamda1": 1e-3, "wd": 1e-3}),
    "signum": ("signum", {"learning_rate": 0.01, "wd": 1e-3,
                          "wd_lh": 1e-2}),
    "signsgd": ("signum", {"learning_rate": 0.01, "momentum": 0.0}),
}


@pytest.mark.parametrize("name", sorted(NEW_OPTIMIZERS))
def test_more_optimizers_match_jax_over_five_steps(name):
    batches = _batches(5, 16, seed=12)
    start = _start(seed=13)
    jnet, _, j_losses = _train(jmx, NEW_OPTIMIZERS[name], start, 5, batches)
    with tmx.cpu():
        tnet, trainer, t_losses = _train(tmx, NEW_OPTIMIZERS[name], start, 5,
                                         batches)
    assert type(trainer.optimizer).__name__.lower() == \
        NEW_OPTIMIZERS[name][0]
    for t, j in zip(t_losses, j_losses):
        np.testing.assert_allclose(t, j, **TOL)
    for (kt, t), (kj, j) in zip(tnet.collect_params().items(),
                                jnet.collect_params().items()):
        np.testing.assert_allclose(t.data().asnumpy(), j.data().asnumpy(),
                                   **TOL, err_msg=kt)
    assert not np.allclose(tnet.collect_params()[
        "mlp_dense0_weight"].data().asnumpy(), start[0])


def _sgld_noise(pkg, w0, g, lr, wd, seed):
    """One SGLD step of ``pkg`` from ``w0`` with gradient ``g``: the new
    weight and its standardised noise ``(w1 - drift) / sqrt(lr)``."""
    opt = pkg.optimizer.create("sgld", learning_rate=lr, wd=wd)
    pkg.random.seed(seed)
    w = pkg.nd.array(w0)
    opt.update(0, w, pkg.nd.array(g), opt.create_state(0, w))
    w1 = w.asnumpy().astype(np.float64)
    drift = w0 - lr / 2 * (g + wd * w0)
    return w1, (w1 - drift) / np.sqrt(lr)


def test_sgld_noise_is_standard_normal_around_the_jax_drift():
    rng = np.random.RandomState(14)
    w0 = rng.randn(200, 100).astype(np.float32)
    g = rng.randn(200, 100).astype(np.float32)
    lr, wd = 1e-2, 1e-3
    _, jnoise = _sgld_noise(jmx, w0, g, lr, wd, seed=1)
    with tmx.cpu():
        w1, noise = _sgld_noise(tmx, w0, g, lr, wd, seed=1)
        tmx.random.seed(1)
        again = tmx.random.generator("cpu")
        drawn = torch.randn(w0.shape, generator=again).numpy()
        trainer = tmx.gluon.Trainer(_mlp(tmx).collect_params(), "sgld",
                                    {"learning_rate": lr})
    assert type(trainer.optimizer).__name__ == "SGLD"
    np.testing.assert_allclose(w1 - np.sqrt(lr) * drawn,
                               w0 - lr / 2 * (g + wd * w0),
                               rtol=1e-6, atol=1e-6)
    for z in (noise, jnoise):
        assert abs(z.mean()) < 5 / np.sqrt(z.size)
        assert abs(z.std() - 1) < 0.03
    assert not np.allclose(noise, jnoise)


def test_params_from_jax_by_full_name():
    jnet = _mlp(jmx, prefix="copy_")
    jnet.initialize()
    with tmx.cpu():
        tnet = _mlp(tmx, prefix="copy_")
        tnet.initialize()
        tmx.gluon.params_from_jax(tnet, {k: p.data().asnumpy() for k, p in
                                         jnet.collect_params().items()})
        x = np.random.RandomState(4).rand(3, 784).astype(np.float32)
        np.testing.assert_allclose(tnet(tmx.nd.array(x)).asnumpy(),
                                   jnet(jmx.nd.array(x)).asnumpy(), **TOL)
        with pytest.raises(ValueError, match="names differ"):
            tmx.gluon.params_from_jax(tnet, {"other_weight": x})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_parameters_across_packages(tmp_path, writer):
    """Structural names (``0.weight``...): a file from either package
    loads in the other, whatever the name scopes."""
    f = str(tmp_path / "mlp.params")
    start = _start(seed=5)
    jnet = _mlp(jmx, prefix="a_")
    jnet.initialize()
    with tmx.cpu():
        tnet = _mlp(tmx, prefix="b_")
        tnet.initialize()
        src, dst = (jnet, tnet) if writer == "jax" else (tnet, jnet)
        for p, v in zip(src.collect_params().values(), start):
            p.set_data(v)
        src.save_parameters(f)
        dst.load_parameters(f)
    with np.load(f) as z:
        assert sorted(z.files) == ["0.bias", "0.weight", "1.bias",
                                   "1.weight"]
    for p, v in zip(dst.collect_params().values(), start):
        np.testing.assert_array_equal(p.data().asnumpy(), v)


@pytest.mark.parametrize("opt", ["sgd_momentum", "adam"])
def test_save_and_load_states(tmp_path, opt):
    """States saved after 2 steps and loaded into a fresh Trainer give
    the same third step as an uninterrupted run; the JAX package's
    Trainer loads the port's states file, and the other way round."""
    batches = _batches(3, 16, seed=3)
    start = _start(seed=6)
    f = str(tmp_path / "trainer.states")
    with tmx.cpu():
        full_net, _, full = _train(tmx, OPTIMIZERS[opt], start, 3, batches)
        net, trainer, _ = _train(tmx, OPTIMIZERS[opt], start, 2, batches)
        trainer.save_states(f)
        mid = [p.data().asnumpy() for p in net.collect_params().values()]
        fresh = tmx.gluon.Trainer(net.collect_params(), OPTIMIZERS[opt][0],
                                  dict(OPTIMIZERS[opt][1]))
        fresh.load_states(f)
        assert fresh.optimizer.num_update == 2
        _, _, third = _train(tmx, None, None, 1, batches[2:], trainer=fresh,
                             net=net)
    np.testing.assert_allclose(third[0], full[2], rtol=1e-6, atol=1e-6)
    for p, q in zip(net.collect_params().values(),
                    full_net.collect_params().values()):
        np.testing.assert_allclose(p.data().asnumpy(), q.data().asnumpy(),
                                   rtol=1e-6, atol=1e-6)
    # the JAX package's Trainer resumes from the port's file, and the
    # port's from the JAX one's
    jnet = _mlp(jmx)
    jnet.initialize()
    for p, v in zip(jnet.collect_params().values(), mid):
        p.set_data(v)
    jtrainer = jmx.gluon.Trainer(jnet.collect_params(), OPTIMIZERS[opt][0],
                                 dict(OPTIMIZERS[opt][1]))
    jtrainer.load_states(f)
    _, _, jthird = _train(jmx, None, None, 1, batches[2:], trainer=jtrainer,
                          net=jnet)
    np.testing.assert_allclose(jthird[0], full[2], **TOL)
    jf = str(tmp_path / "jax.states")
    jtrainer.save_states(jf)
    with tmx.cpu():
        back = tmx.gluon.Trainer(net.collect_params(), OPTIMIZERS[opt][0],
                                 dict(OPTIMIZERS[opt][1]))
        back.load_states(jf)
        assert back.optimizer.num_update == 3


def test_trainer_refuses_distributed_stores():
    with tmx.cpu():
        net = _mlp(tmx, prefix="kv_")
        net.initialize()
        for kv in ("dist_sync", "dist_async", "nccl"):
            with pytest.raises(NotImplementedError, match="one card"):
                tmx.gluon.Trainer(net.collect_params(), "sgd", kvstore=kv)
        with pytest.raises(NotImplementedError):
            tmx.gluon.Trainer(net.collect_params(), "sgd",
                              update_on_kvstore=True)
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.5}, kvstore=None)
        assert tr.learning_rate == 0.5
        tr.set_learning_rate(0.25)
        assert tr.optimizer.lr == 0.25


def test_gluon_utils_match_jax():
    rng = np.random.RandomState(8)
    x = rng.rand(6, 4).astype(np.float32)
    with tmx.cpu():
        parts = tmx.gluon.utils.split_data(tmx.nd.array(x), 3)
        loaded = tmx.gluon.utils.split_and_load(x, [tmx.cpu()])
        grads = [tmx.nd.array(x), tmx.nd.array(2 * x)]
        norm = tmx.gluon.utils.clip_global_norm(grads, 1.0)
    jparts = jmx.gluon.utils.split_data(jmx.nd.array(x), 3)
    jgrads = [jmx.nd.array(x), jmx.nd.array(2 * x)]
    jnorm = jmx.gluon.utils.clip_global_norm(jgrads, 1.0)
    for p, q in zip(parts, jparts):
        np.testing.assert_array_equal(p.asnumpy(), q.asnumpy())
    np.testing.assert_array_equal(loaded[0].asnumpy(), x)
    assert norm == pytest.approx(jnorm, rel=1e-5)
    for g, h in zip(grads, jgrads):
        np.testing.assert_allclose(g.asnumpy(), h.asnumpy(), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="evenly"):
        tmx.gluon.utils.split_data(tmx.nd.array(x, ctx="cpu"), 4)


LOSSES = {
    "L2Loss": ([(4, 3), (4, 3)], {}),
    "L1Loss": ([(4, 3), (4, 3)], {"weight": 0.5}),
    "SigmoidBinaryCrossEntropyLoss": ([(4, 3), (4, 3)], {}),
    "SigmoidBCELoss": ([(4, 3), (4, 3)], {"from_sigmoid": True}),
    "KLDivLoss": ([(4, 3), (4, 3)], {"from_logits": False}),
    "HuberLoss": ([(4, 3), (4, 3)], {"rho": 0.5}),
    "HingeLoss": ([(4, 3), (4, 3)], {"margin": 1.5}),
    "SquaredHingeLoss": ([(4, 3), (4, 3)], {}),
    "LogisticLoss": ([(4, 3), (4, 3)], {"label_format": "binary"}),
    "TripletLoss": ([(4, 3), (4, 3), (4, 3)], {"margin": 0.5}),
    "CosineEmbeddingLoss": ([(4, 3), (4, 3), (4,)], {"margin": 0.2}),
    "PoissonNLLLoss": ([(4, 3), (4, 3)], {"compute_full": True}),
    "SoftmaxCrossEntropyLoss": ([(4, 3), (4, 3)], {"sparse_label": False}),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    """Each Gluon loss, value and input gradients, with a sample
    weight, against the JAX package's (rtol/atol 1e-4)."""
    shapes, kw = LOSSES[name]
    rng = np.random.RandomState(len(name))
    arrays = [rng.uniform(0.05, 0.95, s).astype(np.float32) for s in shapes]
    if name in ("CosineEmbeddingLoss",):
        arrays[2] = np.array([1, -1, 1, -1], np.float32)
    if name in ("HingeLoss", "SquaredHingeLoss"):
        arrays[1] = np.sign(arrays[1] - 0.5).astype(np.float32)
    if name == "PoissonNLLLoss":
        arrays[1] = rng.randint(0, 4, shapes[1]).astype(np.float32)
    sw = rng.uniform(0.5, 1.5, (4, 1)).astype(np.float32)
    results = []
    for pkg in (jmx, tmx):
        with tmx.cpu():
            xs = [pkg.nd.array(a) for a in arrays]
            xs[0].attach_grad()
            loss_fn = getattr(pkg.gluon.loss, name)(**kw)
            extra = () if name in ("CosineEmbeddingLoss", "TripletLoss",
                                   "PoissonNLLLoss") else \
                (pkg.nd.array(sw),)
            with pkg.autograd.record():
                out = loss_fn(*xs, *extra)
            out.backward()
            results.append((out.asnumpy(), xs[0].grad.asnumpy()))
    (jo, jg), (to, tg) = results
    assert to.shape == jo.shape
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)


def test_example_run_as_written_on_the_port(capsys):
    """``_run`` with the port's own gluon (deferred shapes, Xavier
    init), three epochs: it trains and reports as the example does."""
    example = _example()
    example.mx, example.autograd, example.gluon = (tmx, tmx.autograd,
                                                   tmx.gluon)
    with tmx.cpu():
        data = [(tmx.nd.array(x), tmx.nd.array(y, dtype="int32"))
                for x, y in _batches(2, 32, seed=9)]
        example._run(argparse.Namespace(epochs=3, lr=0.1, hybridize=True),
                     data, data[:1])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("epoch ")]
    assert [ln.split(":")[0] for ln in lines] == ["epoch 0", "epoch 1",
                                                  "epoch 2"]
