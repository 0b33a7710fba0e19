"""Autograd on NDArrays in the port against the JAX package: the same
user code (each scenario below takes the package as its argument) runs
on both, the port on the CPU, and every array it returns must agree
(float32, rtol/atol 1e-5/1e-6).

The JAX package replays and then clears a tape; the port runs torch
autograd and keeps the same contract: a second ``backward`` without
``retain_graph`` does nothing, as does one from a head recorded before
the current ``record()`` session (``test_spent_graph``).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


def _both(scenario):
    want = scenario(jmx)
    with tmx.cpu():
        got = scenario(tmx)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g, w)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg=f"result {k}")
    return got


def _x(mx, values=(1.0, -2.0, 3.0), **kw):
    x = mx.nd.array(list(values))
    x.attach_grad(**kw)
    return x


def test_attach_grad_and_chain_rule():
    def s(mx):
        x = _x(mx)
        zero = x.grad.asnumpy()
        with mx.autograd.record():
            y = mx.nd.exp(x) * x
            z = (y * y).sum()
        z.backward()
        return [zero, z.asnumpy(), x.grad.asnumpy()]
    _both(s)


def test_backward_non_scalar_heads_and_head_grads():
    def s(mx):
        x = _x(mx)
        with mx.autograd.record():
            y = 3 * x * x
        y.backward()
        ones = x.grad.asnumpy()
        with mx.autograd.record():
            y = 3 * x * x
            w = mx.nd.sin(x)
        mx.autograd.backward([y, w], [mx.nd.array([1.0, 10.0, 100.0]),
                                      mx.nd.array([2.0, 2.0, 2.0])])
        return [ones, x.grad.asnumpy()]
    _both(s)


def test_grad_req_add_and_write():
    def s(mx):
        a, w = _x(mx, grad_req="add"), _x(mx)
        for k in range(3):
            with mx.autograd.record():
                y = (k + 2) * a * a + (k + 2) * w
            y.backward()
        return [a.grad.asnumpy(), w.grad.asnumpy()]
    _both(s)


def test_autograd_grad_leaves_buffers_alone():
    def s(mx):
        x, y = _x(mx), _x(mx, (0.5, 0.25, -1.0))
        with mx.autograd.record():
            z = (x * y * y).sum()
        gx, gy = mx.autograd.grad(z, [x, y])
        return [gx.asnumpy(), gy.asnumpy(), x.grad.asnumpy(),
                y.grad.asnumpy()]
    _both(s)


def test_mark_variables():
    def s(mx):
        x = mx.nd.array([1.0, 2.0])
        g = mx.nd.zeros((2,))
        mx.autograd.mark_variables([x], [g], grad_reqs="add")
        for _ in range(2):
            with mx.autograd.record():
                y = (x * x * x).sum()
            y.backward()
        return [g.asnumpy(), x.grad.asnumpy()]
    got = _both(s)
    np.testing.assert_allclose(got[0], [6.0, 24.0])


def test_function():
    def s(mx):
        class Sigmoid(mx.autograd.Function):
            def forward(self, x):
                y = 1 / (1 + mx.nd.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y) * 2      # twice the true gradient

        f = Sigmoid()
        x = _x(mx)
        with mx.autograd.record():
            a = f(x)
            b = f(x * 2)                          # other saved tensors
            z = (a * b).sum()
        z.backward()
        return [a.asnumpy(), x.grad.asnumpy()]
    _both(s)


def test_pause_and_flags():
    def s(mx):
        x = _x(mx)
        flags = []
        with mx.autograd.record():
            flags += [mx.autograd.is_recording(), mx.autograd.is_training()]
            y = x * x
            with mx.autograd.pause():
                flags += [mx.autograd.is_recording(),
                          mx.autograd.is_training()]
                c = x * 5               # not recorded: a constant
            z = (y * c).sum()
        with mx.autograd.record(train_mode=False):
            flags.append(mx.autograd.is_training())
        with mx.autograd.train_mode():
            flags.append(mx.autograd.is_training())
        z.backward()
        return [np.array(flags), x.grad.asnumpy()]
    _both(s)


def test_detach_and_stop_gradient():
    def s(mx):
        x = _x(mx)
        with mx.autograd.record():
            z = (x.detach() * x + mx.nd.stop_gradient(x) * x).sum()
        z.backward()
        return [x.grad.asnumpy()]
    _both(s)


def test_multi_output_op_and_indexing():
    def s(mx):
        x = mx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
        x.attach_grad()
        with mx.autograd.record():
            a, b = mx.nd.split(x, num_outputs=2, axis=1)
            z = (a * 2).sum() + (b[1] * b[1]).sum() + x[2, 3]
        z.backward()
        return [x.grad.asnumpy()]
    _both(s)


def test_integer_inputs_carry_no_gradient():
    def s(mx):
        w = mx.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3))
        idx = mx.nd.array(np.array([3, 0, 3], np.int32), dtype="int32")
        w.attach_grad()
        idx.attach_grad()
        with mx.autograd.record():
            z = (mx.nd.take(w, idx) * 2).sum()
        z.backward()
        return [w.grad.asnumpy(), idx.grad.asnumpy()]
    _both(s)


def test_spent_graph():
    """A second backward does nothing (the JAX package's tape was
    cleared; torch would raise), retain_graph keeps it, and a head from
    an earlier ``record()`` session has no graph either."""
    def s(mx):
        x = _x(mx, grad_req="add")
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward()
        y.backward()
        once = x.grad.asnumpy()
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()
        thrice = x.grad.asnumpy()
        with mx.autograd.record():
            old = (x * 10).sum()
        with mx.autograd.record():
            new = (x * 100).sum()
        old.backward()
        after_old = x.grad.asnumpy()
        new.backward()
        return [once, thrice, after_old, x.grad.asnumpy()]
    got = _both(s)
    np.testing.assert_allclose(got[0], [2.0, -4.0, 6.0])
    np.testing.assert_allclose(got[1], [6.0, -12.0, 18.0])


def test_outside_record_builds_no_graph():
    with tmx.cpu():
        x = _x(tmx)
        y = x * x
        assert not y._data.requires_grad
        y.backward()                    # nothing recorded: a no-op
        assert not x.grad.asnumpy().any()
        with tmx.autograd.record():
            z = x * x
        assert z._data.requires_grad


def test_blocks_take_and_return_ndarrays():
    """A Gluon block called on NDArrays returns NDArrays (recorded
    inside ``record()``); called on tensors it returns tensors."""
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(3, in_units=4)
        net.initialize()
        x = tmx.nd.ones((2, 4))
        with tmx.autograd.record():
            out = net(x)
        assert isinstance(out, tmx.nd.NDArray) and out._data.requires_grad
        out.backward()
        np.testing.assert_allclose(net.weight.grad().asnumpy(),
                                   np.full((3, 4), 2.0, np.float32))
        assert isinstance(net(torch.ones(2, 4)), torch.Tensor)
        assert net.weight.data().grad is net.weight.grad()
        assert net.weight.tensor() is net.weight.data()._data


@pytest.mark.parametrize("req", ["write", "add"])
def test_parameter_grad_req(req):
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        net.weight.grad_req = req
        for _ in range(2):
            with tmx.autograd.record():
                y = net(tmx.nd.ones((1, 3)))
            y.backward()
    want = 2.0 if req == "add" else 1.0
    np.testing.assert_allclose(net.weight.grad().asnumpy(),
                               np.full((2, 3), want, np.float32))
