"""Port parity: the ``RNN`` op, the sequence ops and ``gluon.rnn`` of
``mxnet_tpu_torch`` against the JAX package's, on the CPU in float32.

- ``nd.RNN`` for every mode (``lstm``, ``gru``, ``rnn_tanh``,
  ``rnn_relu``) x one and two directions x one and two layers, the
  states given in half of these and omitted in the rest: the outputs
  and final states, and under ``record()`` the gradients of the data,
  the states and the packed parameter for one random weighting of
  every output, against ``jax.vjp`` of the JAX op, within 1e-5
  (``rnn_param_size`` equal); ``lstm_state_clip`` clips ``c_n`` alone;
  the plain per-step version (``ops.rnn.rnn_reference``) equals the op.
- ``p > 0`` in training, held by its invariants (the draws are torch's,
  not threefry's): every element between layers is 0 or ``x / (1 -
  p)``, about ``1 - p`` of them kept, the output the second layer's of
  that masked input, fresh masks on each call and the same ones after
  ``random.seed``.
- ``SequenceMask``/``SequenceLast``/``SequenceReverse`` with and
  without lengths, on axis 0 and 1, exactly.
- Every cell of ``gluon.rnn`` one step, and ``unroll`` in TNC and NTC,
  as step lists and merged, with and without ``valid_length`` (every
  pair of these in four runs); the stacked, residual and bidirectional
  cells; each fused layer (NTC, bidirectional), with and without
  states; each with the same random parameters set by name in both
  (``_compare``: the JAX block hybridized), gradients of the inputs and
  parameters within 1e-5.  ``ZoneoutCell`` by its invariants;
  ``cast("bfloat16")`` makes bf16 zero states.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import rnn as jrnn
from mxnet_tpu_torch.gluon import params_from_jax
from mxnet_tpu_torch.ops import rnn as trnn

TOL = dict(rtol=1e-5, atol=1e-5)
T, N, C, H = 5, 3, 4, 6


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    yield
    gc.collect()


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)) \
        .astype(np.float32)


# ---------------------------------------------------------------- the op --
def _op_run(pkg, mode, layers, bidir, states, arrays, cts, **kw):
    """``nd.RNN`` under ``record()``: outputs, then the gradients of the
    data, the parameter and the given states for ``sum(out * ct)``."""
    nd = pkg.nd
    data, params = nd.array(arrays["data"]), nd.array(arrays["params"])
    ins = [data, params]
    if states:
        ins += [nd.array(arrays["h0"])]
        if mode == "lstm":
            ins += [nd.array(arrays["c0"])]
    for a in ins:
        a.attach_grad()
    with pkg.autograd.record():
        outs = nd.RNN(*ins, state_size=H, num_layers=layers,
                      bidirectional=bidir, mode=mode, **kw)
        loss = sum((o * nd.array(c)).sum() for o, c in zip(outs, cts))
    loss.backward()
    return [o.asnumpy() for o in outs] + [a.grad.asnumpy() for a in ins]


def _op_arrays(mode, layers, bidir, seed=0):
    dirs = 2 if bidir else 1
    size = jrnn.rnn_param_size(mode, C, H, layers, bidir)
    return {"data": _x((T, N, C), seed), "params": _x((size,), seed + 1,
                                                      0.3),
            "h0": _x((layers * dirs, N, H), seed + 2),
            "c0": _x((layers * dirs, N, H), seed + 3)}


def _cotangents(mode, layers, bidir, seed=9):
    dirs = 2 if bidir else 1
    shapes = [(T, N, dirs * H)] + [(layers * dirs, N, H)] * (
        2 if mode == "lstm" else 1)
    return [_x(s, seed + i) for i, s in enumerate(shapes)]


def _jax_op_run(mode, layers, bidir, states, arrays, cts, **kw):
    """``_op_run``'s outputs and gradients from the JAX op itself: one
    ``jax.vjp`` of ``mxnet_tpu.ops.rnn``'s ``RNN``, jitted (one compiled
    program, where ``nd.RNN`` under the JAX package's ``record()``
    compiles each op on its own)."""
    names = ["data", "params"]
    if states:
        names += ["h0", "c0"] if mode == "lstm" else ["h0"]

    def outs_and_grads(ins, cts):
        outs, vjp = jax.vjp(lambda *a: jrnn._rnn(
            *a, state_size=H, num_layers=layers, bidirectional=bidir,
            mode=mode, training=True, **kw), *ins)
        return outs, vjp(tuple(cts))
    outs, grads = jax.jit(outs_and_grads)(
        [jnp.asarray(arrays[n]) for n in names],
        [jnp.asarray(c) for c in cts])
    return [np.asarray(o) for o in outs] + [np.asarray(g) for g in grads]


MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
# every mode x one and two directions x one and two layers, the states
# given in half of them: each mode, direction count and depth runs both
# with its states and with zeros
OP_CASES = [pytest.param(
    mode, bidir, layers, (layers + bidir) % 2 == 1,
    id=f"{mode}-{'bi' if bidir else 'uni'}-{layers}-"
       f"{'states' if (layers + bidir) % 2 else 'zeros'}")
    for mode in MODES for bidir in (False, True) for layers in (1, 2)]


@pytest.mark.parametrize("mode,bidir,layers,states", OP_CASES)
def test_rnn_op_matches_jax(mode, bidir, layers, states):
    arrays = _op_arrays(mode, layers, bidir)
    cts = _cotangents(mode, layers, bidir)
    want = _jax_op_run(mode, layers, bidir, states, arrays, cts)
    with tmx.cpu():
        got = _op_run(tmx, mode, layers, bidir, states, arrays, cts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_rnn_param_size_matches_jax(mode):
    for layers in (1, 2, 3):
        for bidir in (False, True):
            for c in (1, 7, 650):
                assert trnn.rnn_param_size(mode, c, 11, layers, bidir) == \
                    jrnn.rnn_param_size(mode, c, 11, layers, bidir)


def test_rnn_lstm_state_clip_matches_jax():
    arrays = _op_arrays("lstm", 2, False, seed=4)
    arrays["c0"] *= 4.0
    cts = _cotangents("lstm", 2, False)
    kw = dict(lstm_state_clip_min=-0.5, lstm_state_clip_max=0.25)
    want = _jax_op_run("lstm", 2, False, True, arrays, cts, **kw)
    with tmx.cpu():
        got = _op_run(tmx, "lstm", 2, False, True, arrays, cts, **kw)
        plain = _op_run(tmx, "lstm", 2, False, True, arrays, cts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert got[2].min() >= -0.5 and got[2].max() <= 0.25
    np.testing.assert_array_equal(got[0], plain[0])    # out unclipped
    np.testing.assert_array_equal(got[1], plain[1])
    assert not np.array_equal(got[2], plain[2])


@pytest.mark.parametrize("bidir", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_reference_equals_op(mode, bidir):
    arrays = _op_arrays(mode, 2, bidir, seed=6)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    args = (t["data"], t["params"], t["h0"],
            t["c0"] if mode == "lstm" else None)
    kw = dict(state_size=H, num_layers=2, bidirectional=bidir, mode=mode)
    got = trnn.rnn_reference(*args, **kw)
    want = trnn.RNN(*args, training=False, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


# --------------------------------------------------------------- dropout --
def _single_layer(params, mode, layer, dirs, input_size):
    """The packed vector of layer ``layer`` alone (one layer)."""
    cells = trnn._unpack(params, mode, input_size, H, 2, dirs)
    mine = cells[layer * dirs:(layer + 1) * dirs]
    return torch.cat([w.reshape(-1) for c in mine for w in c[:2]]
                     + [b for c in mine for b in c[2:]])


def test_rnn_dropout_between_layers_invariants(monkeypatch):
    p = 0.5
    arrays = _op_arrays("lstm", 2, False, seed=11)
    data = torch.from_numpy(arrays["data"]).repeat(4, 8, 1)   # 20 x 24
    params = torch.from_numpy(arrays["params"])
    seen = []
    real = trnn.Dropout

    def spy(x, **kw):
        out = real(x, **kw)
        seen.append((x, out))
        return out

    monkeypatch.setattr(trnn, "Dropout", spy)
    kw = dict(state_size=H, num_layers=2, mode="lstm", p=p, training=True)
    tmx.random.seed(3)
    out, h_n, c_n = trnn.RNN(data, params, **kw)
    second = trnn.RNN(data, params, **kw)[0]
    tmx.random.seed(3)
    again = trnn.RNN(data, params, **kw)[0]
    assert len(seen) == 3
    x, masked = seen[0]
    kept = masked != 0
    torch.testing.assert_close(masked[kept], (x / (1 - p))[kept], rtol=0,
                               atol=0)
    share = kept.float().mean().item()
    assert abs(share - (1 - p)) < 5 * np.sqrt(p * (1 - p) / x.numel())
    # the output is layer 1's of the masked input, from layer 0's states
    l1 = _single_layer(params, "lstm", 1, 1, C)
    ref = trnn.RNN(masked, l1, state_size=H, num_layers=1, mode="lstm",
                   training=True)
    torch.testing.assert_close(out, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(h_n[1:], ref[1], rtol=0, atol=0)
    assert not torch.equal(seen[0][1], seen[1][1])
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    assert not torch.equal(second, out)
    # no dropout after the last layer, nor in predict mode
    tmx.random.seed(3)
    trnn.RNN(data, params, **{**kw, "training": False})
    assert len(seen) == 3


# ---------------------------------------------------------- sequence ops --
# SequenceReverse reverses axis 0 in both packages, whatever ``axis``
SEQ_CASES = [(op, axis) for op in ("SequenceMask", "SequenceLast",
                                   "SequenceReverse")
             for axis in ((0,) if op == "SequenceReverse" else (0, 1))]


@pytest.mark.parametrize("lengths", [False, True], ids=["all", "lengths"])
@pytest.mark.parametrize("op,axis", SEQ_CASES)
def test_sequence_ops_match_jax(op, axis, lengths):
    shape = (6, 4, 3) if axis == 0 else (4, 6, 3)
    x = _x(shape, 2)
    lens = np.array([6, 1, 3, 4], np.float32)
    kw = dict(axis=axis)
    if op == "SequenceMask":
        kw["value"] = -2.5

    def run(pkg):
        args = [pkg.nd.array(x)]
        if lengths:
            args.append(pkg.nd.array(lens))
        return getattr(pkg.nd, op)(*args, use_sequence_length=lengths,
                                   **kw).asnumpy()
    want = run(jmx)
    with tmx.cpu():
        got = run(tmx)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alias,name", [
    ("sequence_mask", "SequenceMask"), ("sequence_last", "SequenceLast"),
    ("sequence_reverse", "SequenceReverse")])
def test_sequence_aliases(alias, name):
    from mxnet_tpu_torch.ops.registry import OPS
    from mxnet_tpu.ops.registry import OPS as JOPS
    assert alias in JOPS and OPS[alias] is OPS[name]


# ---------------------------------------------------------------- gluon --
def _values(block, seed=1):
    """Random values, by name, for every parameter of ``block``."""
    rng = np.random.RandomState(seed)
    return {k: (0.4 * rng.randn(*p.shape)).astype(np.float32)
            for k, p in block.collect_params().items()}


def _grads(block):
    return [p.grad().asnumpy() for p in block.collect_params().values()]


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _flat(v)]
    return [x]


def _compare(make, x, fn, states=None):
    """Build ``make(pkg)`` in both packages: the port's sized by one call
    of ``fn(pkg, block, x_nd, state_nds)``, random values for its
    parameters set in it and, by name, in the JAX block (not
    initialized: ``set_data`` gives each parameter its shape and value,
    where its initializers would compile a program for each shape),
    which is then hybridized.  Run
    ``fn`` under ``record()`` in both and compare outputs and
    gradients."""
    def inputs(pkg):
        xs = [pkg.nd.array(v) for v in (x if isinstance(x, list) else [x])]
        sts = None if states is None else [pkg.nd.array(s) for s in states]
        return xs, sts

    def call(pkg, blk, xs, sts):
        return fn(pkg, blk, xs if isinstance(x, list) else xs[0], sts)

    def run(pkg, blk):
        xs, sts = inputs(pkg)
        for a in xs + (sts or []):
            a.attach_grad()
        with pkg.autograd.record():
            out = _flat(call(pkg, blk, xs, sts))
            loss = sum(((o * 1.5) + o * o).sum() for o in out)
        loss.backward()
        return [o.asnumpy() for o in out] + [
            a.grad.asnumpy() for a in xs + (sts or [])] + _grads(blk)

    with tmx.cpu():
        tblk = make(tmx)
        tblk.initialize()
        call(tmx, tblk, *inputs(tmx))
    values = _values(tblk)
    jblk = make(jmx)
    jparams = jblk.collect_params()
    assert sorted(jparams.keys()) == sorted(values)
    for k, v in values.items():
        jparams[k].set_data(v)
    params_from_jax(tblk, values)
    jblk.hybridize()
    want = run(jmx, jblk)
    with tmx.cpu():
        got = run(tmx, tblk)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


CELLS = {
    "rnn_tanh": lambda pkg: pkg.gluon.rnn.RNNCell(H, prefix="c_"),
    "rnn_relu": lambda pkg: pkg.gluon.rnn.RNNCell(H, activation="relu",
                                                  prefix="c_"),
    "lstm": lambda pkg: pkg.gluon.rnn.LSTMCell(H, prefix="c_"),
    "gru": lambda pkg: pkg.gluon.rnn.GRUCell(H, prefix="c_"),
}


def _n_states(name):
    return 2 if name == "lstm" else 1


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_step_matches_jax(name):
    states = [_x((N, H), 5 + i) for i in range(_n_states(name))]
    _compare(CELLS[name], _x((N, C), 3),
             lambda pkg, blk, x, st: blk(x, st), states)


# layout, merged outputs and ``valid_length``: every pair of their
# values once in four runs, two for each cell
UNROLL_CASES = [pytest.param(
    name, layout, merge, valid,
    id=f"{name}-{layout}-{'merged' if merge else 'steps'}-"
       f"{'valid' if valid else 'full'}")
    for name, layout, merge, valid in [
        ("lstm", "TNC", False, False), ("lstm", "TNC", True, True),
        ("gru", "NTC", False, True), ("gru", "NTC", True, False)]]


@pytest.mark.parametrize("name,layout,merge,valid", UNROLL_CASES)
def test_cell_unroll_matches_jax(name, layout, merge, valid):
    shape = (T, N, C) if layout == "TNC" else (N, T, C)
    lens = np.array([5, 2, 4], np.float32)

    def fn(pkg, blk, x, st):
        if not valid or pkg is tmx:
            vl = pkg.nd.array(lens) if valid else None
            return blk.unroll(T, x, layout=layout, merge_outputs=merge,
                              valid_length=vl)
        # the JAX package's unroll hands valid_length to nd.SequenceMask
        # by keyword, which its invoke passes on as an NDArray (it
        # raises); the same mask, by position
        outs, states = blk.unroll(T, x, layout=layout)
        m = pkg.nd.SequenceMask(pkg.nd.stack(*outs, axis=0),
                                pkg.nd.array(lens), use_sequence_length=True)
        outs = [m[t] for t in range(T)]
        if merge:
            outs = pkg.nd.stack(*outs, axis=layout.find("T"))
        return outs, states
    _compare(CELLS[name], _x(shape, 3), fn)


def test_cell_unroll_step_list_and_begin_state_match_jax():
    def fn(pkg, blk, xs, st):
        return blk.unroll(T, xs, begin_state=st, layout="NTC",
                          merge_outputs=True)
    _compare(CELLS["lstm"], [_x((N, C), 20 + t) for t in range(T)], fn,
             [_x((N, H), 30), _x((N, H), 31)])


def _stack(pkg):
    rnn = pkg.gluon.rnn
    seq = rnn.SequentialRNNCell(prefix="s_")
    with seq.name_scope():
        seq.add(rnn.LSTMCell(H, input_size=C))
        seq.add(rnn.ResidualCell(rnn.GRUCell(H, input_size=H)))
        seq.add(rnn.DropoutCell(0.0))
        seq.add(rnn.RNNCell(H, input_size=H))
    return seq


def _bidirectional(pkg):
    rnn = pkg.gluon.rnn
    return rnn.BidirectionalCell(rnn.LSTMCell(H, input_size=C, prefix="l_"),
                                 rnn.GRUCell(H, input_size=C, prefix="r_"),
                                 prefix="b_")


@pytest.mark.parametrize("name,layout", [("stack", "TNC"),
                                         ("bidirectional", "NTC")])
def test_modifier_cells_unroll_match_jax(name, layout):
    make = _stack if name == "stack" else _bidirectional
    shape = (T, N, C) if layout == "TNC" else (N, T, C)
    _compare(make, _x(shape, 4), lambda pkg, blk, x, st: blk.unroll(
        T, x, layout=layout, merge_outputs=True))


def test_stack_state_info_and_begin_state():
    with tmx.cpu():
        seq = _stack(tmx)
        assert [i["shape"] for i in seq.state_info(3)] == \
            [i["shape"] for i in _stack(jmx).state_info(3)]
        st = seq.begin_state(3)
        assert len(seq) == 4 and isinstance(seq[1], tmx.gluon.rnn
                                            .ResidualCell)
        assert [s.shape for s in st] == [(3, H)] * 4


def test_zoneout_cell_invariants():
    z = 0.5
    with tmx.cpu():
        base = tmx.gluon.rnn.LSTMCell(H, input_size=C, prefix="z_")
        cell = tmx.gluon.rnn.ZoneoutCell(base, zoneout_outputs=z,
                                         zoneout_states=z)
        cell.initialize()
        x = tmx.nd.array(_x((64, C), 7))
        st = [tmx.nd.array(_x((64, H), 8)), tmx.nd.array(_x((64, H), 9))]
        plain_out, plain_st = base(x, st)
        with tmx.autograd.predict_mode():
            out, nst = cell(x, st)
        np.testing.assert_array_equal(out.asnumpy(), plain_out.asnumpy())
        with tmx.autograd.train_mode():
            cell.reset()
            cell._prev_output = None
            out, nst = cell(x, st)
        o, p = out.asnumpy(), plain_out.asnumpy()
        fresh = o == p
        assert np.all(fresh | (o == 0))          # the previous output: 0
        assert abs(fresh.mean() - (1 - z)) < 0.1
        for new, old, pl in zip(nst, st, plain_st):
            n, ol, pl = new.asnumpy(), old.asnumpy(), pl.asnumpy()
            assert np.all((n == pl) | (n == ol))
            assert abs((n == pl).mean() - (1 - z)) < 0.1


def test_nd_random_bernoulli_invariants():
    """``nd.random.bernoulli`` (which ``ZoneoutCell`` draws with): 0 or 1
    in the dtype asked for, about ``p`` of them 1, the same draws after
    ``random.seed``."""
    with tmx.cpu():
        tmx.random.seed(5)
        a = tmx.nd.random.bernoulli(p=0.3, shape=(200, 50))
        b = tmx.nd.random.bernoulli(p=0.3, shape=(200, 50))
        tmx.random.seed(5)
        again = tmx.nd.random.bernoulli(p=0.3, shape=(200, 50))
        half = tmx.nd.random.bernoulli(shape=(4,), dtype="bfloat16")
    v = a.asnumpy()
    assert a.dtype == np.float32 and set(np.unique(v)) <= {0.0, 1.0}
    assert abs(v.mean() - 0.3) < 5 * np.sqrt(0.3 * 0.7 / v.size)
    assert not np.array_equal(v, b.asnumpy())
    np.testing.assert_array_equal(v, again.asnumpy())
    assert half._data.dtype == torch.bfloat16
    assert jmx.nd.random.bernoulli(p=0.3, shape=(2, 3)).shape == (2, 3)


LAYERS = {
    "lstm": lambda pkg: pkg.gluon.rnn.LSTM(H, 2, prefix="r_"),
    "gru_ntc": lambda pkg: pkg.gluon.rnn.GRU(H, 1, layout="NTC",
                                             prefix="r_"),
    "rnn_relu_bi": lambda pkg: pkg.gluon.rnn.RNN(H, 2, bidirectional=True,
                                                 prefix="r_"),
    "rnn_tanh": lambda pkg: pkg.gluon.rnn.RNN(H, 1, activation="tanh",
                                              input_size=C, prefix="r_"),
    "lstm_bi_ntc": lambda pkg: pkg.gluon.rnn.LSTM(
        H, 1, layout="NTC", bidirectional=True, prefix="r_"),
}


def _layer_states(name):
    layers, dirs = {"lstm": (2, 1), "gru_ntc": (1, 1),
                    "rnn_relu_bi": (2, 2), "rnn_tanh": (1, 1),
                    "lstm_bi_ntc": (1, 2)}[name]
    n = 2 if name.startswith("lstm") else 1
    return [_x((layers * dirs, N, H), 40 + i) for i in range(n)]


# each layer once, the states given to every other one
@pytest.mark.parametrize("name,states", [
    pytest.param(name, i % 2 == 0,
                 id=f"{name}-{'states' if i % 2 == 0 else 'zeros'}")
    for i, name in enumerate(sorted(LAYERS))])
def test_fused_layer_matches_jax(name, states):
    shape = (N, T, C) if "ntc" in name else (T, N, C)

    def fn(pkg, blk, x, st):
        return blk(x, st) if st is not None else blk(x)
    _compare(LAYERS[name], _x(shape, 12), fn,
             _layer_states(name) if states else None)


def test_fused_layer_contract_and_cast():
    with tmx.cpu():
        lstm = tmx.gluon.rnn.LSTM(H, 2, input_size=C)
        lstm.initialize()
        assert lstm.parameters.shape == (trnn.rnn_param_size(
            "lstm", C, H, 2, False),)
        st = lstm.begin_state(N)
        assert [s.shape for s in st] == [(2, N, H)] * 2
        assert [i["shape"] for i in lstm.state_info(N)] == \
            [i["shape"] for i in jmx.gluon.rnn.LSTM(H, 2).state_info(N)]
        x = tmx.nd.array(_x((T, N, C)))
        out = lstm(x)
        assert isinstance(out, tmx.nd.NDArray) and out.shape == (T, N, H)
        out2, st2 = lstm(x, st)
        np.testing.assert_array_equal(out.asnumpy(), out2.asnumpy())
        assert len(st2) == 2 and st2[0].shape == (2, N, H)
        assert repr(lstm) == repr(jmx.gluon.rnn.LSTM(H, 2, input_size=C))
        lstm.cast("bfloat16")
        assert [s._data.dtype for s in lstm.begin_state(N)] == \
            [torch.bfloat16] * 2
        y = lstm(x.astype("bfloat16"))
        assert y._data.dtype == torch.bfloat16
        lstm.hybridize()
        np.testing.assert_array_equal(
            lstm(x.astype("bfloat16")).asnumpy(), y.asnumpy())
