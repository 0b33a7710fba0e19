"""The port's control-flow ops (``mxnet_tpu_torch/ops/control_flow.py``)
against the JAX package's ``foreach``, ``while_loop`` and ``cond``, on
the same seeded f32 inputs: every result the JAX one's bits (bodies of
single roundings — products, sums of two, maxima — so that XLA's fused
multiply-adds and reduction orders do not enter; predicates 0-d, as
``lax`` wants them), eager and inside a hybridized block (where the
port takes the graph form: masked ``while_loop`` steps, both ``cond``
branches and a select), in the NDArray and the raw-array
calling conventions; ``foreach`` over an ``LSTMCell`` the bits of
``cell.unroll``.  The graph form's limits raise: ``while_loop`` without
``max_iterations``, ``cond`` branches of other shapes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.ops import control_flow as jcf
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import control_flow as tcf


def _data(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _same(got, want):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    want = want.asnumpy() if hasattr(want, "asnumpy") else np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _foreach_case(mx, cf, x, s0):
    def body(x_t, states):
        s, = states
        out = x_t * s
        return [out, out.max(axis=-1)], [s + x_t]
    return cf.foreach(body, mx.nd.array(x), [mx.nd.array(s0)])


def test_foreach_ndarrays_multi_output():
    x, s0 = _data(0, 5, 3, 4), _data(1, 3, 4)
    (jo, js), (jf,) = _foreach_case(jmx, jcf, x, s0)
    with tmx.cpu():
        (to, ts), (tf,) = _foreach_case(tmx, tcf, x, s0)
    _same(to, jo)
    _same(ts, js)
    _same(tf, jf)


def test_foreach_raw_arrays_and_list_data():
    a, b, s0 = _data(2, 4, 3), _data(3, 4, 3), _data(4, 3)

    def body(xs, s):
        return xs[0] * s, s + xs[1]

    jo, js = jcf.foreach(body, [jnp.asarray(a), jnp.asarray(b)],
                         jnp.asarray(s0))
    to, ts = tcf.foreach(body, [torch.from_numpy(a), torch.from_numpy(b)],
                         torch.from_numpy(s0))
    _same(to.numpy(), jo)
    _same(ts.numpy(), js)


def _loop_vars(mx):
    return [mx.nd.array(np.zeros((), np.float32)),
            mx.nd.array(_data(5, 2, 3)), mx.nd.array(_data(14, 2, 3))]


def _cond(i, s, t):
    return i < 4


def _func(i, s, t):
    return [i + 1, s * 1.5, t + s]


@pytest.mark.parametrize("max_iterations", [None, 2, 4, 9])
def test_while_loop_eager(max_iterations):
    """The predicate read on the host each iteration; ``max_iterations``
    caps the trip count (2 stops early, 4 and 9 let the loop end)."""
    jout = jcf.while_loop(_cond, _func, _loop_vars(jmx), max_iterations)
    with tmx.cpu():
        tout = tcf.while_loop(_cond, _func, _loop_vars(tmx), max_iterations)
    assert len(tout) == len(jout) == 3
    for t, j in zip(tout, jout):
        _same(t, j)


class _TLoop(tmx.gluon.HybridBlock):
    def __init__(self, max_iterations, **kw):
        super().__init__(**kw)
        self.max_iterations = max_iterations

    def forward(self, i, s, t):
        return tuple(tcf.while_loop(lambda i, s, t: i < 4,
                                    lambda i, s, t: (i + 1, s * 1.5, t + s),
                                    [i, s, t], self.max_iterations))


class _JLoop(jmx.gluon.HybridBlock):
    def __init__(self, max_iterations, **kw):
        super().__init__(**kw)
        self.max_iterations = max_iterations

    def forward(self, i, s, t):
        return tuple(jcf.while_loop(_cond, _func, [i, s, t],
                                    self.max_iterations))


@pytest.mark.parametrize("max_iterations", [2, 9])
def test_while_loop_hybridized(max_iterations):
    """The graph form: exactly ``max_iterations`` masked steps, the
    final values those of JAX's ``lax.while_loop`` (and of the eager
    loop)."""
    jblk = _JLoop(max_iterations)
    jblk.hybridize()
    jout = jblk(*_loop_vars(jmx))
    with tmx.cpu():
        blk = _TLoop(max_iterations)
        blk.hybridize()
        tout = blk(*_loop_vars(tmx))
        eager = tcf.while_loop(_cond, _func, _loop_vars(tmx), max_iterations)
    for t, j, e in zip(tout, jout, eager):
        _same(t, j)
        _same(t, e)


def test_while_loop_without_bound_raises_in_a_graph():
    with tmx.cpu():
        blk = _TLoop(None)
        blk.hybridize()
        with pytest.raises(RuntimeError, match="max_iterations"):
            blk(*_loop_vars(tmx))


def _branches(mx):
    return (lambda a, b: a * b, lambda a, b: a - b)


@pytest.mark.parametrize("flag", [0.0, 1.0])
def test_cond_eager(flag):
    a, b = _data(6, 3, 4), _data(7, 3, 4)
    jt, je = _branches(jmx)
    jout = jcf.cond(jmx.nd.array(np.float32(flag)), jt, je,
                    (jmx.nd.array(a), jmx.nd.array(b)))
    with tmx.cpu():
        tt, te = _branches(tmx)
        tout = tcf.cond(tmx.nd.array(np.float32(flag)), tt, te,
                        (tmx.nd.array(a), tmx.nd.array(b)))
    _same(tout, jout)


class _TCond(tmx.gluon.HybridBlock):
    def forward(self, p, a, b):
        t, e = _branches(tmx)
        return tcf.cond(p, t, e, (a, b))


class _JCond(jmx.gluon.HybridBlock):
    def forward(self, p, a, b):
        t, e = _branches(jmx)
        return jcf.cond(p, t, e, (a, b))


@pytest.mark.parametrize("flag", [0.0, 1.0])
def test_cond_hybridized(flag):
    """The graph form: both branches, then a select."""
    a, b = _data(8, 3, 4), _data(9, 3, 4)
    jblk = _JCond()
    jblk.hybridize()
    jout = jblk(*[jmx.nd.array(v) for v in (np.float32(flag), a, b)])
    with tmx.cpu():
        blk = _TCond()
        blk.hybridize()
        tout = blk(*[tmx.nd.array(v) for v in (np.float32(flag), a, b)])
    _same(tout, jout)


def test_cond_branch_shapes_must_match_in_a_graph():
    class Bad(tmx.gluon.HybridBlock):
        def forward(self, p, a):
            return tcf.cond(p, lambda a: a, lambda a: a.sum(0), (a,))

    with tmx.cpu():
        blk = Bad()
        blk.hybridize()
        with pytest.raises(ValueError, match="same structure and shapes"):
            blk(tmx.nd.array(np.float32(1.0)), tmx.nd.array(_data(10, 3, 4)))


class _Scan(tmx.gluon.HybridBlock):
    def __init__(self, hidden, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.cell = tmx.gluon.rnn.LSTMCell(hidden, input_size=6)

    def forward(self, x, h, c):
        outs, states = tcf.foreach(lambda x_t, s: self.cell(x_t, s), x,
                                   [h, c])
        return (outs, *states)


@pytest.mark.parametrize("hybridize", [False, True])
def test_foreach_over_lstm_cell_is_unroll(hybridize):
    """``foreach`` over an LSTMCell: the outputs and final states the
    bits of ``cell.unroll`` on the same inputs (f32)."""
    x, h, c = _data(11, 7, 4, 6), _data(12, 4, 5), _data(13, 4, 5)
    with tmx.cpu():
        tmx.random.seed(0)
        blk = _Scan(5)
        blk.initialize(ctx=tmx.cpu())
        if hybridize:
            blk.hybridize()
        args = [tmx.nd.array(v) for v in (x, h, c)]
        outs, hf, cf = blk(*args)
        want, (hw, cw) = blk.cell.unroll(7, args[0], begin_state=args[1:],
                                         layout="TNC", merge_outputs=True)
    _same(outs, want)
    _same(hf, hw)
    _same(cf, cw)


def test_foreach_marker_is_registered():
    from mxnet_tpu_torch.ops.registry import OPS
    x = torch.ones(2)
    assert OPS["_foreach_marker"](x) is x
