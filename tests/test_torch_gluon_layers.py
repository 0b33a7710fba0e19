"""Port parity: the Gluon surface of ``mxnet_tpu_torch`` beyond the
ResNet and MLP layers, against the JAX package's, on the CPU.

- Every layer of ``gluon.nn`` that the ResNet and BERT slices did not
  bring (``Conv1D``/``3D``, the three transposed convs, the 1-D and 3-D
  pools and the 2-D average pool, the global pools, ``ReflectionPad2D``,
  ``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU``, ``Swish``,
  ``InstanceNorm``, ``GroupNorm``, ``RMSNorm``, ``SyncBatchNorm``,
  ``Flatten``, ``Identity``, ``Lambda``, ``HybridLambda`` and the plain
  ``Sequential``): the forward under ``record()`` and the gradients of
  ``sum(out**2)`` for the input and every parameter, parameters copied
  across with ``params_from_jax``, within rtol/atol 1e-5 (one layer of
  f32 arithmetic in another order).
- ``gluon.loss.CTCLoss`` (NTC and TNC layouts): the loss and the
  gradient of the scores within 1e-5.
- The initializers: ``Constant``, ``LSTMBias`` and ``Bilinear`` draw
  nothing and equal the JAX arrays exactly; ``Normal``, ``MSRAPrelu``
  and ``Orthogonal`` draw from the port's seeded generator, so they are
  held to their statistics (mean within 5 standard errors of 0,
  standard deviation within 3% of the target; ``W W^T = scale**2 I``
  within 1e-5), as the JAX arrays are.
- ``Block.summary`` prints the JAX table character for character, with
  and without an input; forward hooks and pre-hooks fire on eager calls
  as in the JAX package, and detach; a hybridized block's fire when its
  body runs in Python (the JAX package: while tracing).
- ``Parameter.list_data``/``list_grad``/``list_ctx``/``reset_ctx``,
  ``ParameterDict.get_constant``/``update``/``reset_ctx``,
  ``collect_params(select)`` and ``gluon.Constant`` in a block, against
  the JAX package's.
"""
import gc

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    """Collect this module's cyclic garbage (JAX-side arrays among it)
    before the next module runs in the same worker."""
    yield
    gc.collect()


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------- layers --
LAYERS = {
    "conv1d": (lambda nn: nn.Conv1D(4, 3, padding=1, in_channels=3,
                                    prefix="l_"), (2, 3, 10)),
    "conv1d_nwc_strided": (lambda nn: nn.Conv1D(4, 3, strides=2,
                                                layout="NWC", in_channels=3,
                                                prefix="l_"), (2, 9, 3)),
    "conv3d": (lambda nn: nn.Conv3D(4, 3, padding=1, in_channels=2,
                                    prefix="l_"), (2, 2, 4, 5, 5)),
    "conv1d_transpose": (lambda nn: nn.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, in_channels=3,
        prefix="l_"), (2, 3, 7)),
    "conv2d_transpose": (lambda nn: nn.Conv2DTranspose(
        4, 3, strides=2, padding=1, in_channels=3, prefix="l_"),
        (2, 3, 5, 5)),
    "conv3d_transpose": (lambda nn: nn.Conv3DTranspose(
        2, 2, strides=2, in_channels=2, use_bias=False, prefix="l_"),
        (1, 2, 3, 4, 4)),
    "maxpool1d": (lambda nn: nn.MaxPool1D(3, 2, 1, prefix="l_"), (2, 3, 10)),
    "maxpool3d": (lambda nn: nn.MaxPool3D(2, prefix="l_"), (2, 2, 4, 6, 6)),
    "avgpool1d": (lambda nn: nn.AvgPool1D(3, 2, 1, prefix="l_"), (2, 3, 10)),
    "avgpool2d_ceil": (lambda nn: nn.AvgPool2D(
        3, 2, 1, ceil_mode=True, count_include_pad=False, prefix="l_"),
        (2, 3, 8, 8)),
    "avgpool3d": (lambda nn: nn.AvgPool3D(2, prefix="l_"), (1, 2, 4, 4, 6)),
    "globalmaxpool1d": (lambda nn: nn.GlobalMaxPool1D(prefix="l_"),
                        (2, 3, 7)),
    "globalmaxpool2d": (lambda nn: nn.GlobalMaxPool2D(prefix="l_"),
                        (2, 3, 5, 6)),
    "globalmaxpool3d": (lambda nn: nn.GlobalMaxPool3D(prefix="l_"),
                        (2, 2, 3, 4, 5)),
    "globalavgpool1d": (lambda nn: nn.GlobalAvgPool1D(prefix="l_"),
                        (2, 3, 7)),
    "globalavgpool3d": (lambda nn: nn.GlobalAvgPool3D(prefix="l_"),
                        (2, 2, 3, 4, 5)),
    "reflectionpad2d": (lambda nn: nn.ReflectionPad2D(2, prefix="l_"),
                        (2, 3, 6, 6)),
    "leakyrelu": (lambda nn: nn.LeakyReLU(0.1, prefix="l_"), (4, 6)),
    "prelu": (lambda nn: nn.PReLU(prefix="l_"), (4, 6)),
    "elu": (lambda nn: nn.ELU(0.5, prefix="l_"), (4, 6)),
    "selu": (lambda nn: nn.SELU(prefix="l_"), (4, 6)),
    "gelu": (lambda nn: nn.GELU(prefix="l_"), (4, 6)),
    "gelu_tanh": (lambda nn: nn.GELU(approximate=True, prefix="l_"),
                  (4, 6)),
    "swish": (lambda nn: nn.Swish(prefix="l_"), (4, 6)),
    "swish_beta": (lambda nn: nn.Swish(beta=2.0, prefix="l_"), (4, 6)),
    "instancenorm": (lambda nn: nn.InstanceNorm(in_channels=3, scale=True,
                                                prefix="l_"),
                     (2, 3, 5, 5)),
    "groupnorm": (lambda nn: nn.GroupNorm(2, in_channels=4, prefix="l_"),
                  (2, 4, 3, 3)),
    "rmsnorm": (lambda nn: nn.RMSNorm(in_channels=6, prefix="l_"),
                (2, 5, 6)),
    "syncbatchnorm": (lambda nn: nn.SyncBatchNorm(in_channels=3,
                                                  prefix="l_"),
                      (4, 3, 4, 4)),
    "flatten": (lambda nn: nn.Flatten(prefix="l_"), (2, 3, 4, 5)),
    "identity": (lambda nn: nn.Identity(prefix="l_"), (2, 3)),
    "lambda_name": (lambda nn: nn.Lambda("tanh", prefix="l_"), (3, 4)),
    "lambda_fn": (lambda nn: nn.Lambda(lambda x: x * 2 + 1, prefix="l_"),
                  (3, 4)),
    "hybridlambda_name": (lambda nn: nn.HybridLambda("tanh", prefix="l_"),
                          (3, 4)),
    "hybridlambda_fn": (lambda nn: nn.HybridLambda(
        lambda F, x: F.relu(x) * 3, prefix="l_"), (3, 4)),
}


def _randomize(block, seed=1):
    rng = np.random.RandomState(seed)
    for p in block.collect_params().values():
        if p.name.endswith("running_var"):
            v = rng.rand(*p.shape) + 0.5
        else:
            v = 0.5 * rng.randn(*p.shape)
        p.set_data(v.astype(np.float32))


def _forward_backward(pkg, block, x):
    xd = pkg.nd.array(x)
    xd.attach_grad()
    with pkg.autograd.record():
        out = block(xd)
        loss = (out * out).sum()
    loss.backward()
    grads = [p.grad().asnumpy() for p in block.collect_params().values()
             if p.grad_req != "null"]
    stats = [p.data().asnumpy() for p in block.collect_params().values()
             if p.grad_req == "null"]
    return [out.asnumpy(), xd.grad.asnumpy()] + grads + stats


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_and_gradients_match_jax(name):
    make, shape = LAYERS[name]
    x = _x(shape, seed=2)
    jblk = make(jmx.gluon.nn)
    jblk.initialize()
    _randomize(jblk)
    with tmx.cpu():
        tblk = make(tmx.gluon.nn)
        tblk.initialize()
        params_from_jax(tblk, {k: p.data().asnumpy()
                               for k, p in jblk.collect_params().items()})
        got = _forward_backward(tmx, tblk, x)
    want = _forward_backward(jmx, jblk, x)
    assert len(got) == len(want)
    assert got[0].shape == want[0].shape
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"{name} leaf {i}")


def test_sequential_runs_its_children_and_slices():
    x = _x((3, 5), seed=3)
    outs = []
    for pkg in (jmx, tmx):
        with tmx.cpu():
            net = pkg.gluon.nn.Sequential(prefix="s_")
            with net.name_scope():
                net.add(pkg.gluon.nn.Dense(4, activation="relu",
                                           in_units=5),
                        pkg.gluon.nn.Dense(2, in_units=4))
            net.initialize()
            if pkg is tmx:
                params_from_jax(net, arrays)
                net.hybridize()
                assert net[0]._active and net[1]._active
            else:
                arrays = {k: p.data().asnumpy()
                          for k, p in net.collect_params().items()}
            head = net[:1]
            assert type(head) is pkg.gluon.nn.Sequential and len(head) == 1
            outs.append((net(pkg.nd.array(x)).asnumpy(),
                         head(pkg.nd.array(x)).asnumpy()))
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_ctc_loss_matches_jax(layout):
    rng = np.random.RandomState(4)
    pred = rng.randn(2, 6, 5).astype(np.float32)       # N, T, C
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2).copy()
    label = np.array([[1, 2, 0], [3, 3, 4]], np.float32)
    res = []
    for pkg in (jmx, tmx):
        with tmx.cpu():
            loss_fn = pkg.gluon.loss.CTCLoss(layout=layout)
            p = pkg.nd.array(pred)
            p.attach_grad()
            with pkg.autograd.record():
                loss = loss_fn(p, pkg.nd.array(label))
            loss.backward()
            res.append((loss.asnumpy(), p.grad.asnumpy()))
    assert res[1][0].shape == (2,)
    for a, b in zip(res[1], res[0]):
        np.testing.assert_allclose(a, b, **TOL)


# -------------------------------------------------------- initializers --
@pytest.mark.parametrize("make,name,shape", [
    (lambda i: i.Constant(0.5), "fc_weight", (3, 4)),
    (lambda i: i.Constant(-2.0), "fc_bias", (5,)),
    (lambda i: i.LSTMBias(1.5), "lstm_i2h_bias", (16,)),
    (lambda i: i.Bilinear(), "up_weight", (2, 1, 4, 4)),
    (lambda i: i.Bilinear(), "up_weight", (1, 1, 3, 5))])
def test_initializers_that_draw_nothing_equal_jax(make, name, shape):
    want = np.asarray(make(jmx.init)(name, shape))
    got = make(tmx.init)(name, shape).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _std_ok(a, target):
    a = np.asarray(a, np.float64).ravel()
    assert abs(a.mean()) < 5 * target / np.sqrt(a.size)
    assert abs(a.std() / target - 1) < 0.03


def test_drawing_initializers_have_their_statistics():
    shape = (200, 150)
    for pkg in (jmx, tmx):
        pkg.random.seed(5)
        _std_ok(pkg.init.Normal(0.5).init_array(shape), 0.5)
        # gaussian Xavier, fan avg: sqrt(2 / (1 + 0.25**2) / 175)
        _std_ok(pkg.init.MSRAPrelu().init_array(shape),
                np.sqrt(2 / (1 + 0.25 ** 2) / 175.0))
        for rand_type in ("uniform", "normal"):
            w = np.asarray(pkg.init.Orthogonal(
                scale=1.5, rand_type=rand_type).init_array((6, 4, 3)),
                np.float64).reshape(6, 12)
            np.testing.assert_allclose(w @ w.T, 2.25 * np.eye(6),
                                       atol=1e-5)
            w = np.asarray(pkg.init.Orthogonal().init_array((12, 5)),
                           np.float64)
            np.testing.assert_allclose(w.T @ w, 1.414 ** 2 * np.eye(5),
                                       atol=1e-5)
    tmx.random.seed(5)
    a = tmx.init.Normal(0.5).init_array((4, 4))
    tmx.random.seed(5)
    assert torch.equal(a, tmx.init.Normal(0.5).init_array((4, 4)))
    assert tmx.init.create("normal").sigma == 0.01


def test_parameters_take_the_new_initializers():
    for pkg in (jmx, tmx):
        with tmx.cpu():
            net = pkg.gluon.nn.Dense(3, in_units=4, prefix="i_",
                                     weight_initializer=pkg.init.Constant(2))
            net.initialize(init=pkg.init.Normal(1.0))
            assert np.all(net.weight.data().asnumpy() == 2)
            assert np.all(net.bias.data().asnumpy() == 0)


# ------------------------------------------------------ summary, hooks --
def _summary_net(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="s_")
    with net.name_scope():
        inner = pkg.gluon.nn.HybridSequential()
        inner.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=6),
                  pkg.gluon.nn.BatchNorm(in_channels=8))
        net.add(inner, pkg.gluon.nn.Dropout(0.5),
                pkg.gluon.nn.Dense(3, in_units=8))
    return net


@pytest.mark.parametrize("with_input", [True, False])
def test_summary_prints_the_jax_table(capsys, with_input):
    x = _x((2, 6), seed=6)
    text = []
    for pkg in (jmx, tmx):
        with tmx.cpu():
            net = _summary_net(pkg)
            net.initialize()
            net.hybridize()
            net.summary(*((pkg.nd.array(x),) if with_input else ()))
        text.append(capsys.readouterr().out)
    assert "Total params:" in text[1] and "s_dense0" in text[1]
    assert text[1] == text[0]
    assert ("Output Shape" in text[1]) == with_input


def test_forward_hooks_fire_on_eager_calls_as_in_jax():
    """Eager calls fire both hooks in both packages, and a detached hook
    stays quiet.  A hybridized block's hooks fire when its body runs in
    Python: in the JAX package while its program is traced (the first
    call of a signature), in the port on every CPU call (the card: its
    warm-up and capture)."""
    x = _x((2, 6), seed=7)
    seen = {}
    for pkg in (jmx, tmx):
        with tmx.cpu():
            net = _summary_net(pkg)
            net.initialize()
            log = seen[pkg] = []
            h1 = net.register_forward_pre_hook(
                lambda blk, args: log.append(("pre", len(args))))
            h2 = net.register_forward_hook(
                lambda blk, args, out: log.append(("post",
                                                   tuple(out.shape))))
            xd = pkg.nd.array(x)
            net(xd)
            net.hybridize()
            for _ in range(2):
                net(xd)
                log.append("|")
            net.hybridize(active=False)
            net(xd)
            h1.detach()
            h2.remove()
            net(xd)
    fired = [("pre", 1), ("post", (2, 3))]
    assert seen[jmx] == fired * 2 + ["|", "|"] + fired
    assert seen[tmx] == fired * 2 + ["|"] + fired + ["|"] + fired


# ----------------------------------------------------------- parameters --
def test_parameter_and_parameter_dict_methods_match_jax():
    res = []
    for pkg in (jmx, tmx):
        with tmx.cpu():
            d = pkg.gluon.ParameterDict("pd_")
            w = d.get("w", shape=(2, 3))
            c = d.get_constant("c", np.array([[1.0, 2.0, 3.0]], np.float32))
            assert d.get_constant("c") is c
            assert isinstance(c, pkg.gluon.Constant)
            d.initialize(init=pkg.init.One())
            other = pkg.gluon.ParameterDict("o_")
            other.get("v", shape=(4,))
            d.update(other)
            assert sorted(d.keys()) == ["o_v", "pd_c", "pd_w"]
            with pytest.raises(ValueError, match="duplicate"):
                d.update({"pd_w": pkg.gluon.Parameter("pd_w")})
            d.update({"pd_w": w})                 # the same one: fine
            d.reset_ctx(pkg.cpu())
            w.reset_ctx(pkg.cpu())
            assert len(w.list_data()) == 1 and len(w.list_grad()) == 1
            assert len(w.list_ctx()) == 1
            assert pkg.gluon.Parameter("fresh").list_ctx() == []
            assert c.grad_req == "null"
            net = _summary_net(pkg)
            assert sorted(net.collect_params("dense.*weight").keys()) == \
                ["s_dense0_weight", "s_dense1_weight"]
            res.append((w.list_data()[0].asnumpy(),
                        w.list_grad()[0].asnumpy(),
                        c.data().asnumpy(), str(w.list_ctx()[0])))
    assert res[1][3] == "cpu(0)"
    for a, b in zip(res[1][:3], res[0][:3]):
        np.testing.assert_array_equal(a, b)


def _scaled_block(pkg):
    class Scaled(pkg.gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.scale = self.params.get_constant(
                "scale", np.array([1.0, -2.0, 0.5], np.float32))
            with self.name_scope():
                self.dense = pkg.gluon.nn.Dense(3, in_units=4)

        def hybrid_forward(self, F, x, scale):
            return F.broadcast_mul(self.dense(x), scale)
    return Scaled(prefix="k_")


def test_constant_in_a_block_matches_jax():
    x = _x((2, 4), seed=8)
    jblk = _scaled_block(jmx)
    jblk.initialize()
    with tmx.cpu():
        tblk = _scaled_block(tmx)
        tblk.initialize()
        params_from_jax(tblk, {k: p.data().asnumpy()
                               for k, p in jblk.collect_params().items()})
        got = _forward_backward(tmx, tblk, x)
        tblk.hybridize()
        hyb = _forward_backward(tmx, tblk, x)
    want = _forward_backward(jmx, jblk, x)
    for a, b, c in zip(got, want, hyb):
        np.testing.assert_allclose(a, b, **TOL)
        np.testing.assert_allclose(c, b, **TOL)
    assert tblk.scale.grad_req == "null"
