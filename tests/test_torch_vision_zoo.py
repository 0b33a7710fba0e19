"""Port parity: the rest of ``gluon.model_zoo.vision`` of
``mxnet_tpu_torch`` (ResNet V2, VGG, AlexNet, DenseNet, SqueezeNet,
MobileNet V1/V2, Inception V3 and ``get_model``) against the JAX
package's, on the CPU in float32.

- Every name of ``get_model`` builds the JAX net's parameter names and
  shapes (a size left to the first forward is 0 in both alike);
- each family's forward in predict mode on small inputs (ResNet V2's
  bottleneck runs in the training case below; the nets'
  published widths where the input allows it: a 10-class head; DenseNet
  at a small growth rate, since its final 7x7 pool needs 224x224
  inputs; Inception V3's A-E blocks at small spatial sizes, since the
  whole net needs 299x299), the same random parameters set by name in
  both (``_pair``: the JAX block hybridized), within 1e-4 of the
  output's scale (dozens of
  f32 layers summed in another order; random weights grow VGG's logits
  to ~1e5);
- small ResNet V2 nets of either block (the published stem and stage
  structure at narrow widths) in training mode under ``record()``: the
  output, the input's gradient and every parameter's within 1e-4 of
  each one's scale.
"""
import gc

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import params_from_jax

TOL = 1e-4          # of each compared array's largest magnitude
NAMES = ["resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
         "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
         "resnet101_v2", "resnet152_v2", "vgg11", "vgg13", "vgg16", "vgg19",
         "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "alexnet",
         "densenet121", "densenet161", "densenet169", "densenet201",
         "squeezenet1.0", "squeezenet1.1", "mobilenet1.0", "mobilenet0.75",
         "mobilenet0.5", "mobilenet0.25", "mobilenetv2_1.0",
         "mobilenetv2_0.75", "mobilenetv2_0.5", "mobilenetv2_0.25",
         "inceptionv3"]


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    yield
    gc.collect()


@pytest.mark.parametrize("name", NAMES)
def test_get_model_names_match_jax(name):
    j = jmx.gluon.model_zoo.vision.get_model(name, prefix="m_")
    t = tmx.gluon.model_zoo.vision.get_model(name, prefix="m_")
    jp, tp = j.collect_params(), t.collect_params()
    assert list(tp.keys()) == list(jp.keys())
    for k in jp.keys():
        assert tuple(tp[k].shape or ()) == tuple(jp[k].shape or ()), k


def test_get_model_unknown_name():
    with pytest.raises(ValueError, match="not in the zoo"):
        tmx.gluon.model_zoo.vision.get_model("resnet9_v3")
    with pytest.raises(RuntimeError, match="pretrained"):
        tmx.gluon.model_zoo.vision.resnet18_v2(pretrained=True)


def _values(block, seed=1):
    """Random values, by name, for every parameter of ``block``."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in block.collect_params().items():
        if name.endswith("running_var"):
            v = rng.rand(*p.shape) + 0.5
        elif name.endswith("gamma"):
            v = 1 + 0.1 * rng.randn(*p.shape)
        else:
            v = 0.1 * rng.randn(*p.shape)
        out[name] = v.astype(np.float32)
    return out


def _scoped(pkg, make):
    """``make(pkg)`` inside a fresh name scope: blocks made outside any
    parent's scope are named from counters that run per thread, so
    whatever the process built before would shift their names."""
    outer = pkg.gluon.nn.HybridSequential(prefix="t_")
    with outer.name_scope():
        return make(pkg)


def _pair(make, x):
    """The port's block sized by one forward, random values for its
    parameters set in it and, by name, in the JAX block, which is then
    hybridized.  The JAX block is neither initialized nor sized by a
    forward of its own: ``set_data`` gives every parameter its shape and
    value, where its initializers and an eager forward would compile a
    program for each shape and op; hybridized, it compiles one."""
    with tmx.cpu():
        tblk = _scoped(tmx, make)
        tblk.initialize()
        tblk(tmx.nd.array(x))
    values = _values(tblk)
    jblk = _scoped(jmx, make)
    jparams = jblk.collect_params()
    assert sorted(jparams.keys()) == sorted(values)
    for name, v in values.items():
        jparams[name].set_data(v)
    params_from_jax(tblk, values)
    jblk.hybridize()
    return jblk, tblk


def _close(got, want):
    """Equal within ``TOL`` of ``want``'s largest magnitude."""
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=TOL)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _zoo(name, **kw):
    return lambda pkg: pkg.gluon.model_zoo.vision.get_model(
        name, classes=10, prefix="m_", **kw)


def _densenet(pkg):
    return pkg.gluon.model_zoo.vision.DenseNet(
        16, 8, [2, 2, 2, 2], classes=10, prefix="m_")


FORWARD = {
    "resnet18_v2": (_zoo("resnet18_v2"), (2, 3, 32, 32)),
    "resnet18_v2_thumbnail": (_zoo("resnet18_v2", thumbnail=True),
                              (2, 3, 16, 16)),
    "vgg11_bn": (_zoo("vgg11_bn"), (1, 3, 32, 32)),
    "alexnet": (_zoo("alexnet"), (1, 3, 64, 64)),
    "densenet_small": (_densenet, (1, 3, 224, 224)),
    "squeezenet1.0": (_zoo("squeezenet1.0"), (1, 3, 64, 64)),
    "squeezenet1.1": (_zoo("squeezenet1.1"), (1, 3, 64, 64)),
    "mobilenet0.25": (_zoo("mobilenet0.25"), (2, 3, 32, 32)),
    "mobilenetv2_0.25": (_zoo("mobilenetv2_0.25"), (2, 3, 32, 32)),
}


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_forward_matches_jax(case):
    make, shape = FORWARD[case]
    x = _x(shape, 3)
    jblk, tblk = _pair(make, x)
    want = jblk(jmx.nd.array(x)).asnumpy()
    with tmx.cpu():
        got = tblk(tmx.nd.array(x)).asnumpy()
    assert got.shape == (shape[0], 10)
    _close(got, want)


def _inception_block(letter):
    def make(pkg):
        inc = pkg.gluon.model_zoo.vision.inception
        return {"A": lambda: inc._make_A(32, "A1_"), "B": lambda: inc._make_B(
            "B_"), "C": lambda: inc._make_C(128, "C1_"),
            "D": lambda: inc._make_D("D_"), "E": lambda: inc._make_E(
                "E1_")}[letter]()
    return make


INCEPTION = {"A": (1, 192, 9, 9), "B": (1, 288, 9, 9), "C": (1, 768, 7, 7),
             "D": (1, 768, 9, 9), "E": (1, 1280, 5, 5)}


@pytest.mark.parametrize("letter", sorted(INCEPTION))
def test_inception_blocks_match_jax(letter):
    x = _x(INCEPTION[letter], 4)
    jblk, tblk = _pair(_inception_block(letter), x)
    want = jblk(jmx.nd.array(x)).asnumpy()
    with tmx.cpu():
        got = tblk(tmx.nd.array(x)).asnumpy()
    _close(got, want)


def _train_run(pkg, blk, x):
    xd = pkg.nd.array(x)
    xd.attach_grad()
    with pkg.autograd.record():
        out = blk(xd)
        loss = (out * out).sum()
    loss.backward()
    return [out.asnumpy(), xd.grad.asnumpy()] + [
        p.grad().asnumpy() for p in blk.collect_params().values()
        if p.grad_req != "null"]


@pytest.mark.parametrize("block", ["BasicBlockV2", "BottleneckV2"])
def test_resnet_v2_training_matches_jax(block):
    def make(pkg):
        v = pkg.gluon.model_zoo.vision
        return v.ResNetV2(getattr(v, block), [1, 1, 1, 1],
                          [8, 16, 32, 64, 128], classes=10, thumbnail=True,
                          prefix="m_")
    x = _x((4, 3, 16, 16), 5)
    jblk, tblk = _pair(make, x)
    want = _train_run(jmx, jblk, x)
    with tmx.cpu():
        got = _train_run(tmx, tblk, x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
