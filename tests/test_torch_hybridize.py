"""Port parity: ``HybridBlock.hybridize()`` of ``mxnet_tpu_torch.gluon``
against the JAX package's hybridized blocks (its CachedOp), on the CPU,
where the port runs the same bodies its card captures, uncaptured.

Against the JAX hybridized block, parameters copied across with
``params_from_jax``:

- a Dense MLP: outputs within 2e-5 and weight gradients within rtol
  2e-4 / atol 2e-5 (the JAX package's own ``test_hybridize_*``
  tolerances), with ``grad_req`` ``"write"`` and ``"add"``;
- Conv2D + BatchNorm under ``record()``: outputs, gradients and the
  running statistics after three calls within rtol 1e-4 / atol 1e-5
  (one f32 conv and its batch statistics, summed in another order);
- the small fused ``ResNetV1`` of ``test_torch_resnet`` (the JAX side's
  fused kernels in interpret mode): outputs within 1e-3, gradients and
  running statistics within 2e-3 (the whole-net tolerances there);
- deferred shapes sized by a hybridized first call.

Inside the port, hybridized against eager from the same parameters and
generator state: BatchNorm and Dropout, ``hybridize(active=False)``, a
cast after the first call (the block drops its unit and makes a new
one), a rebound parameter, ``TrainStep`` over a hybridized net (its
eager body: the same losses and weights), and ``create_graph=True``
through a hybridized block (raises).  All within 1e-6 (the same ops in
the same order).

Card-only cases (``gpu`` marker) hold captured graphs against eager
calls: outputs, gradients and running statistics, new dropout masks on
every replay (and the eager draws from the same generator state),
``graph_count()``, the fused kernels' launches under replay, recapture
after a rebound parameter, and ``TrainStep(capture=True)`` over a
hybridized net, which nests no capture.
"""
import gc

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon, optimizer, parallel
from mxnet_tpu_torch.gluon import params_from_jax
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.ops import fused_conv as tfc
from test_torch_resnet import SMALL, pair

MLP_OUT_TOL = dict(rtol=2e-5, atol=2e-5)
MLP_GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
NET_TOL = dict(rtol=1e-3, atol=1e-3)
NET_GRAD_TOL = dict(rtol=2e-3, atol=2e-3)
SAME = dict(rtol=1e-6, atol=1e-6)
gpu = pytest.mark.gpu


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    """Collect this module's cyclic garbage (JAX-side arrays among it)
    before the next module runs in the same worker."""
    yield
    gc.collect()


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _mlp(pkg, in_units=16, prefix="h_"):
    net = pkg.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=in_units),
                pkg.gluon.nn.Dense(4, in_units=8 if in_units else 0))
    return net


def _arrays(block):
    return {k: p.data().asnumpy() for k, p in block.collect_params().items()}


def _grads(block):
    return {k: p.grad().asnumpy() for k, p in block.collect_params().items()
            if p.grad_req != "null"}


def _record_sq(pkg, net, x):
    """``out = net(x)`` and a backward of ``sum(out**2)`` under
    ``record()``; returns out."""
    with pkg.autograd.record():
        out = net(x)
        loss = (out * out).sum()
    loss.backward()
    return out.asnumpy()


# ------------------------------------------------------ against the JAX --
@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_hybridized_mlp_matches_jax(grad_req):
    xs = [_x((4, 16), seed=s) for s in (1, 2)]
    jnet = _mlp(jmx)
    jnet.initialize()
    with tmx.cpu():
        tnet = _mlp(tmx)
        tnet.initialize()
        params_from_jax(tnet, _arrays(jnet))
    for net in (jnet, tnet):
        net.hybridize()
        net.collect_params().setattr("grad_req", grad_req)
    for x in xs:
        jo = _record_sq(jmx, jnet, jmx.nd.array(x))
        with tmx.cpu():
            to = _record_sq(tmx, tnet, tmx.nd.array(x))
        np.testing.assert_allclose(to, jo, **MLP_OUT_TOL)
    jg, tg = _grads(jnet), _grads(tnet)
    assert set(jg) == set(tg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], **MLP_GRAD_TOL, err_msg=k)
    with tmx.cpu():                     # predict mode, not recording
        to = tnet(tmx.nd.array(xs[0])).asnumpy()
    np.testing.assert_allclose(to, jnet(jmx.nd.array(xs[0])).asnumpy(),
                               **MLP_OUT_TOL)


def _conv_bn(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="cb_")
    with net.name_scope():
        # no conv bias: BatchNorm's batch mean cancels it, so its
        # gradient is zero up to rounding noise
        net.add(pkg.gluon.nn.Conv2D(4, 3, padding=1, in_channels=3,
                                    use_bias=False),
                pkg.gluon.nn.BatchNorm(in_channels=4),
                pkg.gluon.nn.Activation("relu"))
    return net


def test_hybridized_conv_batchnorm_running_stats_match_jax():
    jnet = _conv_bn(jmx)
    jnet.initialize()
    with tmx.cpu():
        tnet = _conv_bn(tmx)
        tnet.initialize()
        params_from_jax(tnet, _arrays(jnet))
    jnet.hybridize()
    tnet.hybridize()
    for s in range(3):
        x = _x((2, 3, 8, 8), seed=10 + s)
        jo = _record_sq(jmx, jnet, jmx.nd.array(x))
        with tmx.cpu():
            to = _record_sq(tmx, tnet, tmx.nd.array(x))
        np.testing.assert_allclose(to, jo, **LAYER_TOL)
    jp, tp = _arrays(jnet), _arrays(tnet)
    for k in ("cb_batchnorm0_running_mean", "cb_batchnorm0_running_var"):
        np.testing.assert_allclose(tp[k], jp[k], **LAYER_TOL, err_msg=k)
    assert not np.allclose(tp["cb_batchnorm0_running_mean"], 0)
    jg, tg = _grads(jnet), _grads(tnet)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], **LAYER_TOL, err_msg=k)


def test_hybridized_small_fused_resnet_matches_jax():
    x = _x((2, 64, 64, 3), seed=5)
    jnet = jres.ResNetV1(jres.BottleneckV1, **SMALL, fused=True)
    tnet = tres.ResNetV1(tres.BottleneckV1, **SMALL, fused=True)
    pair(jnet, tnet, x)
    jnet.hybridize()
    tnet.hybridize()
    jo = _record_sq(jmx, jnet, jmx.nd.array(x))
    with tmx.cpu():
        to = _record_sq(tmx, tnet, tmx.nd.array(x))
    np.testing.assert_allclose(to, jo, **NET_TOL)
    tp = tnet.collect_params()
    ours = tres._strip(tp.keys())
    jp = jnet.collect_params()
    theirs = tres._strip(jp.keys())
    assert set(ours) == set(theirs)
    for key in ours:
        p, q = tp[ours[key]], jp[theirs[key]]
        got, want = (p.grad(), q.grad()) if p.grad_req != "null" \
            else (p.data(), q.data())
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                   **NET_GRAD_TOL, err_msg=key)


def test_deferred_shapes_sized_by_a_hybridized_first_call():
    x = _x((3, 12), seed=7)
    jnet = _mlp(jmx, in_units=0, prefix="d_")
    jnet.initialize()
    jnet.hybridize()
    jnet(jmx.nd.array(x))
    with tmx.cpu():
        tnet = _mlp(tmx, in_units=0, prefix="d_")
        tnet.initialize()
        tnet.hybridize()
        tnet(tmx.nd.array(x))
        assert tnet.graph_count() == 0
        shapes = {k: p.shape for k, p in tnet.collect_params().items()}
        assert shapes == {k: p.shape for k, p in
                          jnet.collect_params().items()}
        assert all(p.tensor().shape == p.shape
                   for p in tnet.collect_params().values())
        params_from_jax(tnet, _arrays(jnet))
        to = tnet(tmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(to, jnet(jmx.nd.array(x)).asnumpy(),
                               **MLP_OUT_TOL)


# ------------------------------------------------------- inside the port --
def _bn_dropout(prefix="bd_"):
    net = gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        inner = gluon.nn.HybridSequential()
        inner.add(gluon.nn.Dense(16, activation="relu", in_units=12),
                  gluon.nn.BatchNorm(in_channels=16))
        net.add(inner, gluon.nn.Dropout(0.3), gluon.nn.Dense(5, in_units=16))
    return net


def _port_run(net, calls, dtype=torch.float32):
    """``calls`` recorded calls with backward, then one predict call;
    returns outputs, gradients and every parameter, from random seed
    0."""
    tmx.random.seed(0)
    got = []
    for s in range(calls):
        x = tmx.nd.array(_x((6, 12), seed=20 + s)).astype(
            str(dtype).split(".")[-1])
        got.append(_record_sq(tmx, net, x))
    got.append(net(tmx.nd.array(_x((6, 12), seed=30))
                   .astype(str(dtype).split(".")[-1])).asnumpy())
    got += [p.grad().asnumpy() for p in net.collect_params().values()
            if p.grad_req != "null"]
    got += [p.data().asnumpy() for p in net.collect_params().values()]
    return got


def _port_pair():
    with tmx.cpu():
        eager, hyb = _bn_dropout("e_"), _bn_dropout("y_")
        eager.initialize()
        hyb.initialize()
        for p, q in zip(eager.collect_params().values(),
                        hyb.collect_params().values()):
            q.set_data(p.data())
    return eager, hyb


def _assert_same(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        np.testing.assert_allclose(np.asarray(u, np.float64),
                                   np.asarray(v, np.float64), **SAME)


@pytest.mark.parametrize("case", ["hybridized", "inactive", "cast"])
def test_hybridized_equals_eager_in_the_port(case):
    eager, hyb = _port_pair()
    hyb.hybridize()
    with tmx.cpu():
        if case == "inactive":
            hyb.hybridize(active=False)
            assert not hyb._active and hyb._cached is None
        if case == "cast":
            _port_run(eager, 1)
            _port_run(hyb, 1)
            first = hyb._cached
            assert first is not None
            eager.cast("bfloat16")
            hyb.cast("bfloat16")
        dtype = torch.bfloat16 if case == "cast" else torch.float32
        want = _port_run(eager, 3, dtype)
        got = _port_run(hyb, 3, dtype)
    _assert_same(got, want)
    assert hyb.graph_count() == 0              # the CPU captures nothing
    inner = hyb[0]
    assert inner._active == (case != "inactive")
    assert inner._cached is None               # ran inside its parent
    if case == "cast":
        assert hyb._cached is not first
        assert all(p.tensor().dtype == torch.bfloat16
                   for p in hyb.collect_params().values())
    elif case == "hybridized":
        assert hyb._cached is not None


def test_rebinding_drops_the_unit_and_set_data_keeps_it():
    with tmx.cpu():
        net = _mlp(tmx)
        net.initialize()
        net.hybridize()
        x = tmx.nd.array(_x((2, 16), seed=3))
        net(x)
        unit = net._cached
        w = net[0].weight
        w.set_data(np.full(w.shape, 0.01, np.float32))
        out = net(x).asnumpy()
        assert net._cached is unit
        w._data = torch.zeros(w.shape)          # rebinding
        out0 = net(x).asnumpy()
        assert net._cached is not unit
        net.hybridize(active=False)
        np.testing.assert_allclose(out0, net(x).asnumpy(), **SAME)
    assert not np.allclose(out, out0)


def test_train_step_over_a_hybridized_net_runs_its_eager_body():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(8, 12).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 5, 8).astype(np.int32))
    runs = []
    for hybridize in (False, True):
        tmx.random.seed(0)
        eager, net = _port_pair()
        if hybridize:
            net.hybridize()
        step = parallel.TrainStep(
            net, gluon.loss.SoftmaxCrossEntropyLoss(),
            optimizer.create("sgd", learning_rate=0.1, momentum=0.9),
            capture=None)
        losses = [float(step(x, y)) for _ in range(3)]
        runs.append((losses, [t.detach().clone()
                              for t in step.params.values()]))
        assert net.graph_count() == 0 and net._cached is None
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_create_graph_through_a_hybridized_block_raises():
    with tmx.cpu():
        net = _mlp(tmx)
        net.initialize()
        net.hybridize()
        x = tmx.nd.array(_x((2, 16), seed=8))
        x.attach_grad()
        with tag.record():
            y = net(x).sum()
        with pytest.raises(RuntimeError, match="differentiates once"):
            tag.grad(y, [x], create_graph=True)
        with tag.record():
            y = net(x).sum()
        (g,) = tag.grad(y, [x])                # once is fine
        net.hybridize(active=False)
        with tag.record():
            y = net(x).sum()
        (want,) = tag.grad(y, [x])
    np.testing.assert_allclose(g.asnumpy(), want.asnumpy(), **SAME)


# ------------------------------------------------------------ on the card --
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")


def _card_pair(build, size=None):
    """Two nets from ``build`` on the card with the same parameters
    (deferred shapes sized by a forward of ``size`` first)."""
    tmx.initializer.seed(0)
    eager, hyb = build(), build()
    for net in (eager, hyb):
        net.initialize(ctx=tmx.gpu(0))
        if size is not None:
            with tag.pause():
                net(tmx.nd.array(size, ctx=tmx.gpu(0)))
    for p, q in zip(eager.collect_params().values(),
                    hyb.collect_params().values()):
        q.set_data(p.data())
    return eager, hyb


def _card_calls(net, xs, modes):
    """Each ``(x, mode)``: ``"record"`` (forward and backward of
    sum(out**2)), ``"train"`` (train mode, not recording) or
    ``"predict"``; returns outputs, then gradients and parameters."""
    tmx.random.seed(0)
    got = []
    for x, mode in zip(xs, modes):
        xd = tmx.nd.array(x, ctx=tmx.gpu(0))
        if mode == "record":
            with tag.record():
                out = net(xd)
                loss = (out * out).sum()
            loss.backward()
        elif mode == "train":
            with tag.train_mode():
                out = net(xd)
        else:
            out = net(xd)
        got.append(out._data.detach().cpu())
    params = list(net.collect_params().values())
    got += [p.grad()._data.cpu() for p in params if p.grad_req != "null"]
    got += [p.tensor().detach().cpu() for p in params]
    return got


def _assert_close(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **tol)


@gpu
def test_card_hybridized_mlp_matches_eager():
    _needs_card()
    with tmx.gpu(0):
        eager, hyb = _card_pair(lambda: _bn_dropout())
        hyb.hybridize()
        xs = [_x((6, 12), seed=s) for s in range(7)]
        modes = ["record"] * 4 + ["train", "predict", "record"]
        want = _card_calls(eager, xs, modes)
        got = _card_calls(hyb, xs, modes)
    _assert_close(got, want, dict(rtol=1e-5, atol=1e-6))
    assert hyb.graph_count() == 3   # record+train, train, predict
    assert hyb[0]._cached is None


@gpu
def test_card_second_recorded_call_before_the_backward_matches_eager():
    """Two recorded calls of one signature, then one backward: the
    second runs eagerly (the replay would overwrite the first's saved
    activations), and the gradients equal the eager block's."""
    _needs_card()
    with tmx.gpu(0):
        eager, hyb = _card_pair(lambda: _mlp(tmx))
        hyb.hybridize()
        x1, x2 = (tmx.nd.array(_x((4, 16), seed=s), ctx=tmx.gpu(0))
                  for s in (1, 2))
        grads = []
        for net in (eager, hyb):
            for _ in range(3):              # hyb: warm up, then capture
                with tag.record():
                    a, b = net(x1), net(x2)
                    loss = (a * a).sum() + (b * b).sum()
                loss.backward()
            grads.append([p.grad()._data.cpu()
                          for p in net.collect_params().values()])
        assert hyb.graph_count() == 1
    _assert_close(grads[1], grads[0], dict(rtol=1e-5, atol=1e-6))


@gpu
def test_card_replays_draw_new_dropout_masks_as_eager_calls_do():
    _needs_card()
    with tmx.gpu(0):
        x = tmx.nd.ones((64, 256), ctx=tmx.gpu(0))
        runs = []
        for hybridize in (False, True):
            net = gluon.nn.Dropout(0.5)
            if hybridize:
                net.hybridize()
            tmx.random.seed(3)
            with tag.train_mode():
                runs.append([net(x)._data.clone() for _ in range(4)])
        assert net.graph_count() == 1
    eager, hyb = runs
    assert all(torch.equal(a, b) for a, b in zip(eager, hyb))
    assert not any(torch.equal(hyb[i], hyb[i + 1]) for i in range(3))


def _small_fused():
    return tres.ResNetV1(tres.BottleneckV1, **SMALL, fused=True)


@gpu
def test_card_small_fused_net_matches_eager_and_counts_launches():
    _needs_card()
    x = _x((4, 64, 64, 3), seed=9)
    with tmx.gpu(0):
        eager, hyb = _card_pair(_small_fused, size=x[:1])
        hyb.hybridize()
        counts = []
        results = []
        for net in (eager, hyb):
            tfc.norm_relu_conv.launches = dict.fromkeys(("fwd", "dx",
                                                         "dw"), 0)
            results.append(_card_calls(net, [x] * 3, ["record"] * 3))
            counts.append(dict(tfc.norm_relu_conv.launches))
    _assert_close(results[1], results[0], dict(rtol=1e-4, atol=1e-5))
    assert counts[0] == counts[1] and counts[0]["fwd"] > 0
    assert hyb.graph_count() == 1


@gpu
def test_card_rebound_parameter_forces_a_recapture():
    _needs_card()
    with tmx.gpu(0):
        net = _mlp(tmx)
        net.initialize(ctx=tmx.gpu(0))
        net.hybridize()
        x = tmx.nd.array(_x((2, 16), seed=3), ctx=tmx.gpu(0))
        for _ in range(2):
            net(x)
        unit = net._cached
        assert net.graph_count() == 1
        net[0].weight.initialize(force_reinit=True, ctx=tmx.gpu(0),
                                 init=tmx.init.Constant(0.5))
        got = [net(x).asnumpy() for _ in range(2)]
        assert net._cached is not unit and net.graph_count() == 1
        net.hybridize(active=False)
        want = net(x).asnumpy()
    for g in got:
        np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)


@gpu
def test_card_train_step_over_a_hybridized_net_nests_no_capture():
    _needs_card()
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(8, 12).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 5, 8).astype(np.int32)).cuda()
    runs = []
    with tmx.gpu(0):
        for hybridize in (False, True):
            tmx.random.seed(0)
            _, net = _card_pair(lambda: _bn_dropout())
            if hybridize:
                net.hybridize()
            step = parallel.TrainStep(
                net, gluon.loss.SoftmaxCrossEntropyLoss(),
                optimizer.create("sgd", learning_rate=0.1, momentum=0.9))
            losses = [float(step(x, y)) for _ in range(3)]
            assert step.graph_count() == 1
            assert net.graph_count() == 0 and net._cached is None
            runs.append((losses, [t.detach().clone()
                                  for t in step.params.values()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
