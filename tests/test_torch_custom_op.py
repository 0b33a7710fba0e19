"""The port's custom operators (``mxnet_tpu_torch/operator.py``,
``nd.Custom``) against the JAX package's, with the same op classes
registered in both packages.

- ``scaled_square`` (the JAX package's test op): forward and gradient
  equal to JAX's (f32, rtol 1e-6);
- MXNet's ``custom_softmax`` example (numpy forward and backward,
  ``need_top_grad=False``) under a Gluon ``Dense``: outputs within 1e-6
  of JAX's, the weight's gradient within 1e-6 of the built-in
  ``softmax`` + cross-entropy's, and three SGD steps of each net landing
  within 1e-6 of each other;
- ``assign`` honours ``write``, ``inplace``, ``add`` and ``null``;
- outputs are made on the inputs' device; inside a hybridized block the
  op raises, as the JAX package's raises under tracing.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = 1e-6


def _register(mx):
    op = mx.operator

    @op.register("scaled_square_t")
    class ScaledSquareProp(op.CustomOpProp):
        def __init__(self, scale=2.0):
            super().__init__(need_top_grad=True)
            self._scale = float(scale)

        def create_operator(self, ctx, shapes, dtypes):
            outer = self

            class ScaledSquare(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0]
                    self.assign(out_data[0], req[0], x * x * outer._scale)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    x = in_data[0]
                    self.assign(in_grad[0], req[0],
                                out_grad[0] * 2.0 * outer._scale * x)

            return ScaledSquare()

    class Softmax(op.CustomOp):
        """MXNet's example/numpy-ops/custom_softmax.py."""

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1).reshape((x.shape[0], 1)))
            y /= y.sum(axis=1).reshape((x.shape[0], 1))
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))

    @op.register("softmax_t")
    class SoftmaxProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            data_shape = in_shape[0]
            label_shape = (in_shape[0][0],)
            return [data_shape, label_shape], [data_shape], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    @op.register("req_t")
    class ReqProp(op.CustomOpProp):
        """Writes ``in + 1`` into a ones output by the request ``req``."""

        def __init__(self, req="write"):
            super().__init__()
            self._req = req

        def create_operator(self, ctx, shapes, dtypes):
            outer = self

            class Req(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    out_data[0][:] = 1.0
                    self.assign(out_data[0], outer._req, in_data[0] + 1.0)

            return Req()


_register(jmx)
_register(tmx)


def test_forward_and_gradient_as_jax():
    x = np.array([1.0, 2.0, 3.0], np.float32)
    res = {}
    for name, mx, ctx in (("jax", jmx, None), ("port", tmx, tmx.cpu())):
        with (ctx or _null()):
            a = mx.nd.array(x)
            out = mx.nd.Custom(a, op_type="scaled_square_t", scale=3.0)
            a.attach_grad()
            with mx.autograd.record():
                y = mx.nd.Custom(a, op_type="scaled_square_t")
                loss = y.sum()
            loss.backward()
            res[name] = (out.asnumpy(), a.grad.asnumpy())
    np.testing.assert_allclose(res["port"][0], [3, 12, 27], rtol=TOL)
    for got, want in zip(res["port"], res["jax"]):
        np.testing.assert_allclose(got, want, rtol=TOL)


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _softmax_net(mx, w0):
    net = mx.gluon.nn.Dense(5, in_units=8)
    net.initialize()
    net.weight.set_data(mx.nd.array(w0))
    net.bias.set_data(mx.nd.zeros((5,)))
    return net


def _step_loss(mx, net, x, y, custom):
    if custom:
        return mx.nd.Custom(net(x), y, op_type="softmax_t")
    return mx.gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y).sum()


def test_custom_softmax_trains_as_the_builtin():
    rng = np.random.RandomState(0)
    w0 = (rng.randn(5, 8) * 0.3).astype(np.float32)
    xs = [rng.randn(16, 8).astype(np.float32) for _ in range(3)]
    ys = [rng.randint(0, 5, 16).astype(np.float32) for _ in range(3)]
    with tmx.cpu():
        jnet = _softmax_net(jmx, w0)
        jout = jmx.nd.Custom(jnet(jmx.nd.array(xs[0])),
                             jmx.nd.array(ys[0]), op_type="softmax_t")
        nets, grads = {}, {}
        for custom in (True, False):
            net = _softmax_net(tmx, w0)
            tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.5})
            for i, (x, y) in enumerate(zip(xs, ys)):
                with tmx.autograd.record():
                    out = _step_loss(tmx, net, tmx.nd.array(x),
                                     tmx.nd.array(y), custom)
                out.backward()
                if i == 0:
                    grads[custom] = net.weight.grad().asnumpy().copy()
                    if custom:
                        np.testing.assert_allclose(out.asnumpy(),
                                                   jout.asnumpy(), atol=TOL)
                tr.step(1)
            nets[custom] = net.weight.data().asnumpy()
    np.testing.assert_allclose(grads[True], grads[False], atol=TOL)
    np.testing.assert_allclose(nets[True], nets[False], atol=TOL)
    assert np.abs(nets[True] - w0).max() > 1e-3        # it trained


@pytest.mark.parametrize("req,want", [("write", 3.0), ("inplace", 3.0),
                                      ("add", 4.0), ("null", 1.0)])
def test_assign_requests(req, want):
    with tmx.cpu():
        out = tmx.nd.Custom(tmx.nd.full((2,), 2.0), op_type="req_t",
                            req=req)
    jout = jmx.nd.Custom(jmx.nd.full((2,), 2.0), op_type="req_t", req=req)
    np.testing.assert_array_equal(out.asnumpy(), [want, want])
    np.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())


def test_outputs_on_the_inputs_device():
    with tmx.cpu():
        x = tmx.nd.ones((3,))
        out = tmx.nd.Custom(x, op_type="scaled_square_t")
    assert out._data.device == x._data.device


def test_unknown_op():
    with pytest.raises(ValueError, match="not registered"):
        with tmx.cpu():
            tmx.nd.Custom(tmx.nd.ones((2,)), op_type="nope")


def test_raises_inside_a_hybridized_block():
    class Blk(tmx.gluon.HybridBlock):
        def forward(self, x):
            return tmx.nd.Custom(tmx.nd.NDArray(x),
                                 op_type="scaled_square_t")._data

    with tmx.cpu():
        blk = Blk()
        blk(tmx.nd.ones((2,)))                       # eager: runs
        blk.hybridize()
        with pytest.raises(TypeError, match="captured graph"):
            blk(tmx.nd.ones((2,)))
