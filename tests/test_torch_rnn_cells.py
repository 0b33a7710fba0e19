"""``mx.rnn`` of the port (``mxnet_tpu_torch/rnn.py``, the legacy
symbolic cells) against the JAX package's, on the CPU.

The cases of ``tests/test_rnn_cells.py``, each built in both packages
inside fresh name scopes: the unrolled graphs list the same arguments,
infer the same shapes and serialise to the same json, and bound over
the same seeded parameters they give the same outputs (rtol/atol 1e-5;
1e-4 for the fused ``RNN`` op against the explicit unroll, as in the
reference's test).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import symbol as jsym
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import symbol as tsym

T, N, C, H = 5, 4, 6, 8
TOL = dict(rtol=1e-5, atol=1e-5)
PKGS = ((jmx, jsym, jnd), (tmx, tsym, tnd))


@pytest.fixture(autouse=True)
def _fresh_scopes():
    with jmx.name.NameManager(), tmx.name.NameManager(), tmx.cpu():
        yield


def _x(seed=0):
    return np.random.RandomState(seed).randn(N, T, C).astype(np.float32)


def both(build):
    return [build(mx, S) for mx, S, _ in PKGS]


def _eval(pkg, outs, shapes, seed=1, is_train=False):
    """Bind ``outs`` over seeded parameters (data from ``_x``)."""
    _, S, nd = pkg
    arg, _, _ = outs.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    vals = {}
    for n, s in zip(outs.list_arguments(), arg):
        vals[n] = _x() if n == "data" else \
            (rng.randn(*s) * 0.2).astype(np.float32)
    ex = outs.bind(args={k: nd.array(v) for k, v in vals.items()},
                   grad_req="null")
    return [o.asnumpy() for o in ex.forward(is_train=is_train)]


def _same_graph_and_values(j, t, shapes, **kw):
    assert t.list_arguments() == j.list_arguments()
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)
    assert t.tojson() == j.tojson()
    for a, b in zip(_eval(PKGS[0], j, shapes, **kw),
                    _eval(PKGS[1], t, shapes, **kw)):
        np.testing.assert_allclose(b, a, **TOL)


def test_lstm_cell_unroll_shapes_and_training():
    def build(mx, S):
        cell = mx.rnn.LSTMCell(num_hidden=H, prefix="lstm_")
        outs, states = cell.unroll(T, S.Variable("data"), layout="NTC",
                                   merge_outputs=True)
        head = S.SoftmaxOutput(
            S.FullyConnected(S.Flatten(
                S.slice_axis(outs, axis=1, begin=T - 1, end=T)),
                name="fc", num_hidden=2),
            name="softmax", normalization="batch")
        return head, len(states)
    (j, jn), (t, tn) = both(build)
    assert tn == jn == 2
    a, o, _ = t.infer_shape(data=(N, T, C))
    shapes = dict(zip(t.list_arguments(), a))
    assert shapes["lstm_i2h_weight"] == (4 * H, C)
    assert shapes["lstm_h2h_weight"] == (4 * H, H)
    assert o == [(N, 2)]
    _same_graph_and_values(j, t, {"data": (N, T, C)})
    x = _x()
    y = (x.mean(axis=(1, 2)) > 0).astype(np.float32)
    it = tmx.io.NDArrayIter(x, y, batch_size=N)
    mod = tmx.mod.Module(t, context=tmx.cpu())
    mod.fit(it, optimizer="adam",
            optimizer_params=(("learning_rate", 0.05),), num_epoch=20)
    assert mod.score(it, "acc")[0][1] == 1.0


def test_fused_vs_cell_parity():
    """FusedRNNCell (the RNN op) and the explicit LSTMCell unroll give
    the same sequence from the cuDNN-packed weights, in the port as in
    the JAX package."""
    rng = np.random.RandomState(3)
    x = rng.randn(N, T, C).astype(np.float32)
    i2h_w = rng.randn(4 * H, C).astype(np.float32) * 0.3
    h2h_w = rng.randn(4 * H, H).astype(np.float32) * 0.3
    i2h_b = rng.randn(4 * H).astype(np.float32) * 0.1
    h2h_b = rng.randn(4 * H).astype(np.float32) * 0.1
    packed = np.concatenate([i2h_w.ravel(), h2h_w.ravel(),
                             i2h_b.ravel(), h2h_b.ravel()])
    results = []
    for mx, S, nd in PKGS:
        cell = mx.rnn.LSTMCell(num_hidden=H, prefix="lstm_")
        outs, _ = cell.unroll(T, S.Variable("data"), layout="NTC",
                              merge_outputs=True)
        cell_out = outs.bind(args={"data": nd.array(x),
                                   "lstm_i2h_weight": nd.array(i2h_w),
                                   "lstm_i2h_bias": nd.array(i2h_b),
                                   "lstm_h2h_weight": nd.array(h2h_w),
                                   "lstm_h2h_bias": nd.array(h2h_b)},
                             grad_req="null").forward()[0].asnumpy()
        fused = mx.rnn.FusedRNNCell(num_hidden=H, mode="lstm", prefix="f_")
        assert fused.param_size(C) == packed.size
        fo, _ = fused.unroll(T, S.Variable("data"), layout="NTC")
        fused_out = fo.bind(args={"data": nd.array(x),
                                  "f_parameters": nd.array(packed)},
                            grad_req="null").forward()[0].asnumpy()
        np.testing.assert_allclose(fused_out, cell_out, rtol=1e-4,
                                   atol=1e-5)
        results.append((cell_out, fused_out, fo.tojson()))
    (jc, jf, jj), (tc, tf, tj) = results
    np.testing.assert_allclose(tc, jc, **TOL)
    np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=1e-5)
    assert tj == jj


@pytest.mark.parametrize("kind", ["GRUCell", "RNNCell"])
def test_gru_and_vanilla_cells(kind):
    def build(mx, S):
        cell = getattr(mx.rnn, kind)(H, prefix="c_")
        outs, states = cell.unroll(T, S.Variable("data"), layout="NTC",
                                   merge_outputs=True)
        return outs, len(states)
    (j, jn), (t, tn) = both(build)
    assert tn == jn == 1
    assert t.infer_shape(data=(N, T, C))[1] == [(N, T, H)]
    _same_graph_and_values(j, t, {"data": (N, T, C)})


def test_sequential_stack_with_dropout():
    def build(mx, S):
        stack = mx.rnn.SequentialRNNCell([mx.rnn.GRUCell(H, prefix="g0_"),
                                          mx.rnn.DropoutCell(0.5),
                                          mx.rnn.GRUCell(H, prefix="g1_")])
        return stack.unroll(T, S.Variable("data"), layout="NTC",
                            merge_outputs=True)[0]
    j, t = both(build)
    assert t.infer_shape(data=(N, T, C))[1] == [(N, T, H)]
    args = t.list_arguments()
    assert "g0_i2h_weight" in args and "g1_i2h_weight" in args
    _same_graph_and_values(j, t, {"data": (N, T, C)})
    o1 = _eval(PKGS[1], t, {"data": (N, T, C)})[0]
    o2 = _eval(PKGS[1], t, {"data": (N, T, C)})[0]
    np.testing.assert_array_equal(o1, o2)      # identity at inference


def test_flat_state_list_through_stack():
    def build(mx, S):
        stack = mx.rnn.SequentialRNNCell([mx.rnn.LSTMCell(H, prefix="l0_"),
                                          mx.rnn.DropoutCell(0.0),
                                          mx.rnn.LSTMCell(H, prefix="l1_")])
        begin = [S.Variable(f"s{i}") for i in range(4)]
        outs, states = stack.unroll(T, S.Variable("data"),
                                    begin_state=begin, layout="NTC",
                                    merge_outputs=True)
        return stack, begin, outs, len(states)
    (_, _, jo, jn), (stack, begin, t, tn) = both(build)
    assert stack.num_states == 4 and tn == jn == 4
    shapes = {"data": (N, T, C)}
    shapes.update({f"s{i}": (N, H) for i in range(4)})
    assert t.infer_shape(**shapes)[1] == [(N, T, H)]
    _same_graph_and_values(jo, t, shapes)
    with pytest.raises(ValueError, match="flat state list"):
        stack.unroll(T, tsym.Variable("data"), begin_state=begin[:3])
    steps, _ = tmx.rnn.DropoutCell(0.5).unroll(T, tsym.Variable("x"),
                                               layout="NTC",
                                               merge_outputs=False)
    assert isinstance(steps, list) and len(steps) == T


def test_default_prefixes_never_collide():
    def build(mx, S):
        stack = mx.rnn.SequentialRNNCell([mx.rnn.LSTMCell(H),
                                          mx.rnn.LSTMCell(H)])
        return stack.unroll(3, S.Variable("data"), layout="NTC",
                            merge_outputs=True)[0]
    j, t = both(build)
    args = t.list_arguments()
    assert args == j.list_arguments()
    i2h = [a for a in args if a.endswith("i2h_weight")]
    assert len(i2h) == 2 and len(set(i2h)) == 2, i2h
    shapes = dict(zip(args, t.infer_shape(data=(N, 3, C))[0]))
    assert shapes[i2h[0]] == (4 * H, C) and shapes[i2h[1]] == (4 * H, H)
    dup = tmx.rnn.SequentialRNNCell([tmx.rnn.LSTMCell(H, prefix="same_"),
                                     tmx.rnn.LSTMCell(H, prefix="same_")])
    douts, _ = dup.unroll(3, tsym.Variable("data"), layout="NTC",
                          merge_outputs=True)
    with pytest.raises(ValueError, match="duplicate variable name"):
        douts.infer_shape(data=(N, 3, C))


def test_tnc_layout_and_step_lists():
    def build(mx, S):
        cell = mx.rnn.RNNCell(H, prefix="r_")
        outs, _ = cell.unroll(T, S.Variable("data"), layout="TNC",
                              merge_outputs=True)
        cell.reset()
        steps, _ = cell.unroll(T, S.Variable("data"), layout="NTC",
                               merge_outputs=False)
        return outs, steps
    (jo, js), (to, ts) = both(build)
    assert to.infer_shape(data=(T, N, C))[1] == [(T, N, H)]
    assert to.tojson() == jo.tojson()
    assert len(ts) == T
    assert ts[0].infer_shape(data=(N, T, C))[1] == [(N, H)]
    _same_graph_and_values(js[-1], ts[-1], {"data": (N, T, C)})
