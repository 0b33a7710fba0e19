"""Port parity: ``gluon.model_zoo.ssd`` (``SSD``, ``SSDMultiBoxLoss``,
``ssd_512_resnet50_v1``, ``ssd_300_resnet34_v1``; BASELINE config 5)
of ``mxnet_tpu_torch`` against the JAX package's, on the CPU in
float32, on the small SSD of ``tests/test_ssd.py`` (three scales over a
two-conv backbone, 64x64 inputs, 1344 anchors).

- The forward contract: ``cls_pred (B, C+1, A)``, ``loc_pred (B,
  A*4)``, ``anchor (1, A, 4)`` clipped to [0, 1], each within 1e-5 of
  the JAX net's (the same random parameters set by name in both;
  the JAX net hybridized, see ``_pair``);
- ``targets`` equal, and ``SSDMultiBoxLoss`` with the gradients of
  every parameter under ``record()`` within 1e-5;
- one ``parallel.TrainStep`` step of ``bench_ssd``'s recipe
  (``MultiBoxTarget`` inside the loss, SGD 1e-3 / 0.9 / 5e-4): the
  loss, the parameters and the running statistics within 1e-5;
- ``detect`` within 1e-5;
- ``ssd_512_resnet50_v1`` and ``ssd_300_resnet34_v1`` have the JAX
  nets' parameter names and shapes.
"""
import gc
import re

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu_torch import parallel as tparallel
from mxnet_tpu_torch.bench import ssd_labels, ssd_loss_fn
from mxnet_tpu_torch.gluon import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
B, CLASSES = 2, 3


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    yield
    gc.collect()


def _tiny_ssd(pkg):
    """``tests/test_ssd.py``'s ``_tiny_ssd`` in either package, inside a
    fresh name scope: its heads are named from counters that run per
    thread, so whatever the process built before would shift them."""
    outer = pkg.gluon.nn.HybridSequential(prefix="t_")
    with outer.name_scope():
        return _tiny_ssd_body(pkg)


def _tiny_ssd_body(pkg):
    nn = pkg.gluon.nn
    backbone = nn.HybridSequential(prefix="bb_")
    backbone.add(nn.Conv2D(16, 3, strides=2, padding=1, in_channels=3),
                 nn.Activation("relu"),
                 nn.Conv2D(32, 3, strides=2, padding=1, in_channels=16),
                 nn.Activation("relu"))
    sizes = [[.2, .272], [.37, .447], [.54, .619]]
    ratios = [[1, 2, .5]] * 3
    return pkg.gluon.model_zoo.ssd.SSD(
        backbone, CLASSES, sizes, ratios, extra_channels=(32, 32),
        backbone_out_channels=32, prefix="ssd_")


def _pair(seed=1):
    """The port's net sized by one forward, random values for its
    parameters set in it and, by name, in the JAX net, which is then
    hybridized.  The JAX net is neither initialized nor sized by a
    forward of its own: ``set_data`` gives every parameter its shape and
    value, where its initializers and an eager forward would compile a
    program for each shape and op; hybridized, it compiles one."""
    with tmx.cpu():
        tnet = _tiny_ssd(tmx)
        tnet.initialize()
        tnet(tmx.nd.array(_image()))
    rng = np.random.RandomState(seed)
    values = {}
    for name, p in tnet.collect_params().items():
        v = rng.rand(*p.shape) + 0.5 if name.endswith("running_var") \
            else 0.2 * rng.randn(*p.shape)
        values[name] = v.astype(np.float32)
    jnet = _tiny_ssd(jmx)
    jparams = jnet.collect_params()
    assert sorted(jparams.keys()) == sorted(values)
    for name, v in values.items():
        jparams[name].set_data(v)
    params_from_jax(tnet, values)
    jnet.hybridize()
    return jnet, tnet


def _image(seed=0):
    return np.random.RandomState(seed).randn(B, 3, 64, 64).astype(np.float32)


def _label(seed=3):
    """``bench_ssd``'s labels for ``CLASSES`` classes."""
    return ssd_labels(np.random.RandomState(seed), B, classes=CLASSES)


def _np(outs):
    return [o.asnumpy() for o in outs]


def test_forward_contract_matches_jax():
    jnet, tnet = _pair()
    x = _image()
    want = _np(jnet(jmx.nd.array(x)))
    with tmx.cpu():
        got = _np(tnet(tmx.nd.array(x)))
    a = (16 * 16 + 8 * 8 + 4 * 4) * 4
    assert got[0].shape == (B, CLASSES + 1, a)
    assert got[1].shape == (B, a * 4) and got[2].shape == (1, a, 4)
    assert got[2].min() >= 0.0 and got[2].max() <= 1.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


class _JaxTargetsAndLoss(jmx.gluon.HybridBlock):
    """The JAX net's forward, ``targets`` and ``SSDMultiBoxLoss`` as one
    block, hybridized in ``_loss_and_grads``: one compiled program where
    an eager call would compile each op of ``MultiBoxTarget`` on its
    own."""

    def __init__(self, net):
        super().__init__(prefix="")
        self.net = net
        self.loss = jmx.gluon.model_zoo.ssd.SSDMultiBoxLoss()

    def hybrid_forward(self, F, x, label):
        cls_pred, loc_pred, anchor = self.net(x)
        bt, bm, ct = self.net.targets(anchor, label, cls_pred)
        return self.loss(cls_pred, loc_pred, ct, bt, bm), bt, bm, ct


def _loss_and_grads(pkg, net, x, label):
    if pkg is jmx:
        whole = _JaxTargetsAndLoss(net)
        whole.hybridize()
    else:
        loss_blk = pkg.gluon.model_zoo.ssd.SSDMultiBoxLoss()

        def whole(x, label):
            cls_pred, loc_pred, anchor = net(x)
            bt, bm, ct = net.targets(anchor, label, cls_pred)
            return loss_blk(cls_pred, loc_pred, ct, bt, bm), bt, bm, ct
    with pkg.autograd.record():
        loss, bt, bm, ct = whole(pkg.nd.array(x), pkg.nd.array(label))
        total = loss.sum()
    total.backward()
    return [loss.asnumpy(), bt.asnumpy(), bm.asnumpy(), ct.asnumpy()], {
        k: p.grad().asnumpy() for k, p in net.collect_params().items()
        if p.grad_req != "null"}


def test_targets_loss_and_gradients_match_jax():
    jnet, tnet = _pair()
    x, label = _image(4), _label()
    want, jg = _loss_and_grads(jmx, jnet, x, label)
    with tmx.cpu():
        got, tg = _loss_and_grads(tmx, tnet, x, label)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, **TOL)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **TOL)


def _jax_bench_loss():
    """``bench_ssd``'s loss in the JAX package (``ssd_loss_fn`` is the
    port's)."""
    box_loss = jmx.gluon.model_zoo.ssd.SSDMultiBoxLoss()

    def loss_fn(out, label):
        cls_pred, loc_pred, anchor = out
        bt, bm, ct = jmx.nd.MultiBoxTarget(
            anchor, label, cls_pred, overlap_threshold=0.5,
            negative_mining_ratio=3.0, negative_mining_thresh=0.5)
        return box_loss(cls_pred, loc_pred, ct, bt, bm)
    return loss_fn


SGD = dict(learning_rate=1e-3, momentum=0.9, wd=5e-4)


def test_train_step_matches_jax():
    jnet, tnet = _pair()
    x, label = _image(5), _label(6)
    mesh = jparallel.make_mesh(dp=1, devices=jax.devices()[:1])
    jstep = jparallel.TrainStep(jnet, _jax_bench_loss(),
                                jmx.optimizer.create("sgd", **SGD), mesh=mesh)
    tstep = tparallel.TrainStep(tnet, ssd_loss_fn(),
                                tmx.optimizer.create("sgd", **SGD))
    jl = [float(jstep(jmx.nd.array(x), jmx.nd.array(label)).asnumpy())
          for _ in range(2)]
    tl = [float(tstep(torch.from_numpy(x), torch.from_numpy(label)))
          for _ in range(2)]
    np.testing.assert_allclose(tl, jl, **TOL)
    jstep.sync_params_to_net()
    tstep.sync_params_to_net()
    jp = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    for k, p in tnet.collect_params().items():
        np.testing.assert_allclose(p.tensor().detach().numpy(), jp[k],
                                   err_msg=k, **TOL)


def test_detect_matches_jax():
    jnet, tnet = _pair()
    x = _image(7)
    want = jnet.detect(*jnet(jmx.nd.array(x)), nms_topk=50).asnumpy()
    with tmx.cpu():
        got = tnet.detect(*tnet(tmx.nd.array(x)), nms_topk=50).asnumpy()
    assert got.shape == (B, (16 * 16 + 8 * 8 + 4 * 4) * 4, 6)
    np.testing.assert_allclose(got, want, **TOL)


def _backbone_blind(name):
    """A parameter name with the backbone ResNet's running block count
    (``resnetv1N_``, which depends on the nets built before in the
    process) taken out."""
    return re.sub(r"^resnetv1\d+_", "resnetv1_", name)


@pytest.mark.parametrize("name", ["ssd_512_resnet50_v1",
                                  "ssd_300_resnet34_v1"])
def test_zoo_nets_have_the_jax_names_and_shapes(name):
    j = getattr(jmx.gluon.model_zoo.ssd, name)(classes=20, prefix="s_")
    t = getattr(tmx.gluon.model_zoo.ssd, name)(classes=20, prefix="s_")
    jp, tp = j.collect_params(), t.collect_params()
    assert [_backbone_blind(k) for k in tp.keys()] == \
        [_backbone_blind(k) for k in jp.keys()]
    for k, q in zip(jp.keys(), tp.keys()):
        assert tuple(tp[q].shape or ()) == tuple(jp[k].shape or ()), k
    assert len(t.cls_heads) == len(j._sizes) == len(t._sizes)


def test_bench_ssd_line_on_the_cpu(capsys):
    """``python -m mxnet_tpu_torch.bench ssd --device cpu``: one line with
    ``bench.py``'s metric name and keys (``bench_ssd``'s CPU size)."""
    import json

    from mxnet_tpu_torch import bench

    assert bench.main(["ssd", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "ssd512_train_throughput"
    assert line["unit"] == "img/s/cpu" and line["value"] > 0
    # value rounded to 0.01, vs_baseline from the unrounded value
    assert line["vs_baseline"] == pytest.approx(line["value"] / 40.0,
                                                abs=0.01 / 40 + 1e-4)
    assert (line["batch"], line["image"], line["steps"]) == (2, 128, 1)
    assert np.isfinite(line["first_loss"]) and np.isfinite(
        line["last_loss"])
