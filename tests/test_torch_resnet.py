"""Port parity: the ResNet v1 layers and nets of ``mxnet_tpu_torch.gluon``
against the JAX package's, on the CPU in float32.

- ``Conv2D`` (NHWC with OHWI weights, and NCHW), ``BatchNorm`` in
  training and predict mode with its running statistics, the pooling
  layers, ``Dense`` and ``NormReluConv2D`` (the JAX side's Pallas
  kernels in interpret mode) against their JAX layers, parameters copied
  across with ``params_from_jax``; gradients where the layer trains;
- a small ``ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 32, 64, 128, 256])``
  fused and unfused, forward against the JAX net;
- inside the port, the fused net against the unfused one with the
  parameters mapped block by block;
- the softmax cross-entropy loss and op, and the initializers.

Tolerances: 1e-5 for single layers (the same f32 arithmetic in another
order), 2e-4 forward / 2e-3 gradients for the fused layer (the JAX fused
kernel tests' tolerances), 1e-3 for whole nets (a dozen layers of f32
convs and batch statistics).
"""
import gc
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.gluon.model_zoo.vision import params_from_jax

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-3, atol=1e-3)
SMALL = dict(layers=[1, 1, 1, 1], channels=[8, 32, 64, 128, 256],
             classes=10, layout="NHWC")


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    """Collect this module's cyclic garbage (JAX-side arrays among it)
    before the next module runs in the same worker, so that module's
    memory accounting does not see it freed mid-test."""
    yield
    gc.collect()


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def jax_arrays(block):
    return {k: p.data().asnumpy() for k, p in block.collect_params().items()}


def pair(jblock, tblock, x):
    """Initialise both, size deferred params with one forward, copy the
    JAX parameters (randomised first) into the port block."""
    jblock.initialize()
    tblock.initialize(ctx="cpu")
    with jag.pause():
        jblock(mx.nd.array(x))
    with tag.pause():
        tblock(torch.from_numpy(x))
    rng = np.random.RandomState(42)
    for p in jblock.collect_params().values():
        if p.name.endswith("running_var"):
            p.set_data(mx.nd.array(rng.rand(*p.shape).astype(np.float32)
                                   + 0.5))
        else:
            p.set_data(mx.nd.array(0.3 * rng.randn(*p.shape)
                                   .astype(np.float32)))
    params_from_jax(tblock, jax_arrays(jblock))


def run_both(jblock, tblock, x, train, *extra):
    """Forward (and backward of sum(out**2) when ``train``) on both
    sides; returns (jax out, port out, jax x-grad, port x-grad)."""
    jx = mx.nd.array(x)
    jextra = [mx.nd.array(e) for e in extra]
    tx = torch.from_numpy(x).requires_grad_(train)
    textra = [torch.from_numpy(e) for e in extra]
    if train:
        jx.attach_grad()
        with jag.record():
            jo = jblock(jx, *jextra)
            (jo * jo).sum().backward()
        with tag.record():
            to = tblock(tx, *textra)
            (to * to).sum().backward()
        return jo.asnumpy(), to.detach().numpy(), jx.grad.asnumpy(), \
            tx.grad.numpy()
    with jag.pause():
        jo = jblock(jx, *jextra)
    with tag.pause():
        to = tblock(tx, *textra)
    return jo.asnumpy(), to.numpy(), None, None


def assert_params_close(jblock, tblock, tol, names=None):
    tparams = tblock.collect_params()
    ours = tres._strip(tparams.keys())
    theirs = tres._strip(jblock.collect_params().keys())
    for key in names or ours:
        np.testing.assert_allclose(
            tparams[ours[key]].data().detach().numpy(),
            jblock.collect_params()[theirs[key]].data().asnumpy(), **tol,
            err_msg=key)


# ----------------------------------------------------------------- layers --
@pytest.mark.parametrize("layout,stride,bias", [("NHWC", 1, False),
                                                ("NHWC", 2, True),
                                                ("NCHW", 2, True)])
def test_conv2d_matches_jax(layout, stride, bias):
    shape = (2, 9, 9, 5) if layout == "NHWC" else (2, 5, 9, 9)
    x = _x(shape)
    kw = dict(strides=stride, padding=1, use_bias=bias, layout=layout)
    j, t = jnn.Conv2D(6, 3, **kw), tnn.Conv2D(6, 3, **kw)
    pair(j, t, x)
    jw = j.weight.data().asnumpy()
    assert jw.shape == ((6, 3, 3, 5) if layout == "NHWC" else (6, 5, 3, 3))
    jo, to, jg, tg = run_both(j, t, x, True)
    np.testing.assert_allclose(to, jo, **LAYER_TOL)
    np.testing.assert_allclose(tg, jg, **LAYER_TOL)
    np.testing.assert_allclose(t.weight.grad().numpy(),
                               j.weight.grad().asnumpy(), rtol=1e-4,
                               atol=1e-4)


def test_batchnorm_train_eval_and_running_stats_match_jax():
    x = 3.0 + 2.0 * _x((4, 5, 5, 6), seed=1)
    j, t = jnn.BatchNorm(axis=-1), tnn.BatchNorm(axis=-1)
    pair(j, t, x)
    for _ in range(2):                  # two training steps of the stats
        jo, to, jg, tg = run_both(j, t, x, True)
        np.testing.assert_allclose(to, jo, **LAYER_TOL)
        np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t.gamma.grad().numpy(),
                               j.gamma.grad().asnumpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(t.beta.grad().numpy(),
                               j.beta.grad().asnumpy(), rtol=1e-4,
                               atol=1e-4)
    assert_params_close(j, t, LAYER_TOL, ["running_mean", "running_var"])
    jo, to, _, _ = run_both(j, t, x, False)      # predict: running stats
    np.testing.assert_allclose(to, jo, **LAYER_TOL)


def test_pooling_and_dense_match_jax():
    x = _x((2, 9, 9, 4), seed=2)
    for j, t in ((jnn.MaxPool2D(3, 2, 1, layout="NHWC"),
                  tnn.MaxPool2D(3, 2, 1, layout="NHWC")),
                 (jnn.GlobalAvgPool2D(layout="NHWC"),
                  tnn.GlobalAvgPool2D(layout="NHWC"))):
        jo, to, _, _ = run_both(j, t, x, False)
        assert to.shape == jo.shape
        np.testing.assert_allclose(to, jo, **LAYER_TOL)
    j, t = jnn.Dense(7), tnn.Dense(7)
    pair(j, t, x)
    jo, to, jg, tg = run_both(j, t, x, True)
    np.testing.assert_allclose(to, jo, **LAYER_TOL)
    np.testing.assert_allclose(tg, jg, **LAYER_TOL)
    np.testing.assert_allclose(t.weight.grad().numpy(),
                               j.weight.grad().asnumpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("k,stride,res_on", [(3, 1, False), (1, 1, True),
                                             (3, 2, False)])
def test_norm_relu_conv2d_matches_jax(k, stride, res_on):
    x = _x((2, 8, 8, 8), seed=3)
    extra = (_x((2, 8, 8, 8), seed=4),) if res_on else ()
    j = jnn.NormReluConv2D(16, k, strides=stride)
    t = tnn.NormReluConv2D(16, k, strides=stride)
    pair(j, t, x)
    jo, to, jg, tg = run_both(j, t, x, True, *extra)
    np.testing.assert_allclose(to, jo, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tg, jg, rtol=2e-3, atol=2e-3)
    for name in ("weight", "gamma", "beta"):
        np.testing.assert_allclose(getattr(t, name).grad().numpy(),
                                   getattr(j, name).grad().asnumpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=name)
    assert_params_close(j, t, dict(rtol=1e-5, atol=1e-5),
                        ["running_mean", "running_var"])
    jo, to, _, _ = run_both(j, t, x, False, *extra)
    np.testing.assert_allclose(to, jo, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sparse", [True, False])
def test_softmax_cross_entropy_matches_jax(sparse):
    """``gluon.loss.SoftmaxCrossEntropyLoss`` (sparse and dense labels)
    and ``ops.softmax_cross_entropy`` against the JAX package's."""
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu import nd as jnd
    from mxnet_tpu_torch import gluon as tgluon
    from mxnet_tpu_torch.ops import softmax_cross_entropy

    rng = np.random.RandomState(7)
    pred = (3 * rng.randn(6, 10)).astype(np.float32)
    idx = rng.randint(0, 10, 6)
    label = idx.astype(np.int32) if sparse \
        else np.eye(10, dtype=np.float32)[idx]
    jl = jgluon.loss.SoftmaxCrossEntropyLoss(sparse_label=sparse)(
        mx.nd.array(pred), mx.nd.array(label)).asnumpy()
    tl = tgluon.loss.SoftmaxCrossEntropyLoss(sparse_label=sparse)(
        torch.from_numpy(pred), torch.from_numpy(label)).numpy()
    assert tl.shape == (6,)
    np.testing.assert_allclose(tl, jl, **LAYER_TOL)
    if sparse:
        jt = jnd.softmax_cross_entropy(mx.nd.array(pred),
                                       mx.nd.array(label)).asnumpy()
        tt = softmax_cross_entropy(torch.from_numpy(pred),
                                   torch.from_numpy(label)).numpy()
        np.testing.assert_allclose(tt, jt, **LAYER_TOL)


def test_initializers_draw_from_the_seeded_generator():
    """``Uniform`` (the default) within its scale, ``Xavier`` within
    ``sqrt(3 / fan_avg)``, the same values after ``seed`` again, and the
    name-suffix dispatch (gamma ones, beta zeros)."""
    from mxnet_tpu_torch import initializer

    initializer.seed(5)
    a = initializer.create(None)("conv0_weight", (64, 3, 3, 32))
    x = initializer.Xavier()("dense0_weight", (10, 20), "bfloat16")
    initializer.seed(5)
    assert torch.equal(a, initializer.Uniform()("w", (64, 3, 3, 32)))
    assert float(a.abs().max()) <= 0.07 and float(a.std()) > 0.03
    assert x.dtype == torch.bfloat16
    assert float(x.float().abs().max()) <= (3 / 15) ** 0.5
    assert torch.equal(initializer.create("ones")("bn_gamma", (3,)),
                       torch.ones(3))
    assert torch.equal(initializer.Xavier()("bn_beta", (3,)), torch.zeros(3))
    with pytest.raises(ValueError):
        initializer.create("nope")


def test_layer_names_match_jax():
    j = jres.ResNetV1(jres.BottleneckV1, **SMALL, fused=True)
    t = tres.ResNetV1(tres.BottleneckV1, **SMALL, fused=True)
    assert set(tres._strip(j.collect_params().keys())) == \
        set(tres._strip(t.collect_params().keys()))


# ------------------------------------------------------------------- nets --
def small_pair(fused, x):
    j = jres.ResNetV1(jres.BottleneckV1, **SMALL, fused=fused)
    t = tres.ResNetV1(tres.BottleneckV1, **SMALL, fused=fused)
    pair(j, t, x)
    return j, t


@pytest.mark.parametrize("fused", [False, True])
def test_small_resnet_forward_matches_jax(fused):
    x = _x((4, 64, 64, 3), seed=5)
    j, t = small_pair(fused, x)
    for train in ((False, True) if not fused else (True,)):
        with jag.train_mode() if train else jag.predict_mode():
            with tag.train_mode() if train else tag.predict_mode():
                jo, to, _, _ = run_both(j, t, x, False)
        assert to.shape == (4, 10)
        np.testing.assert_allclose(to, jo, **NET_TOL)


def map_unfused_to_fused(plain, fused):
    """Copy an unfused net's parameters into the fused net of the same
    configuration (BottleneckV1: body = conv, bn, relu, conv3x3, bn,
    relu, conv1x1, bn; fused = conv1, f2, f3, bn3)."""
    def copy(dst, src, transpose=None):
        v = src.data().detach()
        dst.set_data(v.permute(*transpose) if transpose else v)

    def bn(dst, src):
        for name in ("gamma", "beta", "running_mean", "running_var"):
            copy(getattr(dst, name), getattr(src, name))

    for st in range(1, 5):
        for pb, fb in zip(plain.features[3 + st], fused.features[3 + st]):
            body = pb.body
            copy(fb.conv1.weight, body[0].weight)
            bn(fb.f2, body[1])
            copy(fb.f2.weight, body[3].weight, (1, 2, 3, 0))   # OHWI->HWIO
            bn(fb.f3, body[4])
            copy(fb.f3.weight, body[6].weight, (1, 2, 3, 0))
            bn(fb.bn3, body[7])
            if pb.downsample is not None:
                copy(fb.downsample[0].weight, pb.downsample[0].weight)
                bn(fb.downsample[1], pb.downsample[1])
    copy(fused.features[0].weight, plain.features[0].weight)
    bn(fused.features[1], plain.features[1])
    copy(fused.output.weight, plain.output.weight)
    copy(fused.output.bias, plain.output.bias)


def test_fused_resnet_matches_unfused_in_the_port():
    x = torch.from_numpy(_x((4, 64, 64, 3), seed=6))
    nets = []
    for fused in (False, True):
        net = tres.ResNetV1(tres.BottleneckV1, **SMALL, fused=fused)
        net.initialize(ctx="cpu")
        with tag.pause():
            net(x[:1])
        nets.append(net)
    plain, fused = nets
    map_unfused_to_fused(plain, fused)
    outs = []
    for net in (plain, fused):
        xg = x.clone().requires_grad_()
        with tag.record():
            out = net(xg)
            (out * out).sum().backward()
        outs.append((out.detach(), xg.grad))
    np.testing.assert_allclose(outs[1][0].numpy(), outs[0][0].numpy(),
                               **NET_TOL)
    np.testing.assert_allclose(outs[1][1].numpy(), outs[0][1].numpy(),
                               **NET_TOL)
    np.testing.assert_allclose(
        fused.features[4][0].f2.running_mean.data().numpy(),
        plain.features[4][0].body[1].running_mean.data().numpy(),
        rtol=1e-5, atol=1e-5)
