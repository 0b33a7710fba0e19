"""``mx.np``'s factories, ``linalg`` and ``random``, and ``mx.npx``, of
the port against the JAX package's: the factories' values and dtypes,
``linalg`` (1e-3; the factorisations by what they reconstruct),
``np.random`` by invariants (its draws are the port's own generators',
not threefry's: ROADMAP, "Deliberate divergences"), autograd through
np functions (1e-5), the npx ops, ``set_np``/``reset_np``/``use_np``,
``npx.save``/``load``, Gluon blocks under ``set_np`` (ROADMAP C12) and
a 2-layer, 64-unit flash BERT under ``set_np`` against the JAX one.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import np as jnp_
from mxnet_tpu import npx as jnpx
from mxnet_tpu_torch import np as tnp_
from mxnet_tpu_torch import npx as tnpx
from test_torch_numpy import (A, C3, I, IDX, M, SM, SQ, V, W5, A3, A6,
                              _same, _values)


@pytest.fixture(autouse=True)
def _cpu_and_reset():
    """On the host; ``set_np`` and AMP off again in both packages after
    each test (both are process-wide)."""
    with tmx.cpu():
        yield
    jnpx.reset_np()
    tnpx.reset_np()
    jmx.amp._deinit_for_tests()
    tmx.amp._deinit_for_tests()


def test_factories_and_dtype_rules():
    for fn, args, kw in [("zeros", ((2, 3),), {}), ("ones", ((4,),), {}),
                         ("full", ((2, 2), 7.0), {}),
                         ("full", ((2,), 3), {}), ("empty", ((2,),), {}),
                         ("arange", (5,), {}), ("arange", (0.0, 1.0, 0.25),
                                                {}),
                         ("arange", (2, 9, 3), {"dtype": "float32"}),
                         ("linspace", (0, 1, 5), {}),
                         ("linspace", (0, 1, 4), {"endpoint": False}),
                         ("eye", (3,), {"k": 1}), ("identity", (3,), {}),
                         ("array", ([1, 2, 3],), {}),
                         ("array", ([1.5, 2.0],), {}),
                         ("asarray", (A,), {})]:
        _same(_values(getattr(tnp_, fn)(*args, **kw)),
              _values(getattr(jnp_, fn)(*args, **kw)), 1e-6, fn)
    for fn in ("zeros_like", "ones_like"):
        _same(_values(getattr(tnp_, fn)(tnp_.array(I))),
              _values(getattr(jnp_, fn)(jnp_.array(I))), 0, fn)
    _same(_values(tnp_.full_like(tnp_.array(A), 2.5)),
          _values(jnp_.full_like(jnp_.array(A), 2.5)), 0, "full_like")
    x = tnp_.array(A)
    assert tnp_.shape(x) == jnp_.shape(jnp_.array(A)) == (4, 5)
    assert tnp_.ndim(x) == 2 and tnp_.size(x) == 20
    onp.testing.assert_array_equal(tnp_.asnumpy(x), A)
    assert tnp_.result_type(x, 1.0) == jnp_.result_type(jnp_.array(A), 1.0)
    assert (tnp_.pi, tnp_.e, tnp_.newaxis) == (jnp_.pi, jnp_.e, None)


LINALG = {
    "norm": lambda a: ((a(A),), {}),
    "norm#axis": lambda a: ((a(A),), {"axis": 1}),
    "svd": lambda a: ((a(SQ @ SQ.T + 4 * onp.eye(4, dtype=onp.float32)),),
                      {"compute_uv": False}),
    "cholesky": lambda a: ((a(SQ @ SQ.T + 4 * onp.eye(4,
                                                     dtype=onp.float32)),),
                           {}),
    "inv": lambda a: ((a(SQ + 4 * onp.eye(4, dtype=onp.float32)),), {}),
    "pinv": lambda a: ((a(A),), {}),
    "det": lambda a: ((a(SQ),), {}),
    "slogdet": lambda a: ((a(SQ),), {}),
    "eigvalsh": lambda a: ((a(SQ + SQ.T),), {}),
    "solve": lambda a: ((a(SQ + 4 * onp.eye(4, dtype=onp.float32)),
                         a(C3)), {}),
    "lstsq": lambda a: ((a(A6.T), a(V)), {}),
    "matrix_rank": lambda a: ((a(A),), {}),
    "matrix_power": lambda a: ((a(SQ), 3), {}),
    "tensorinv": lambda a: ((a((SQ + 4 * onp.eye(4, dtype=onp.float32))
                               .reshape(2, 2, 2, 2)),), {"ind": 2}),
    "tensorsolve": lambda a: ((a((SQ + 4 * onp.eye(4, dtype=onp.float32))
                                 .reshape(2, 2, 2, 2)),
                               a(SM)), {}),
    "multi_dot": lambda a: (([a(A), a(M), a(M.T)],), {}),
}


@pytest.mark.parametrize("case", sorted(LINALG))
def test_linalg_matches_jax(case):
    name = case.split("#")[0]
    jargs, jkw = LINALG[case](jnp_.array)
    targs, tkw = LINALG[case](tnp_.array)
    want = _values(getattr(jnp_.linalg, name)(*jargs, **jkw))
    got = _values(getattr(tnp_.linalg, name)(*targs, **tkw))
    _same(got, want, 1e-3, case)


def test_linalg_factorisations_by_reconstruction():
    """eigh, qr and the full svd by what they reconstruct (their signs
    and bases are free)."""
    s = SQ + SQ.T
    w, v = tnp_.linalg.eigh(tnp_.array(s))
    onp.testing.assert_allclose((v.asnumpy() * w.asnumpy()) @ v.asnumpy().T,
                                s, atol=1e-4)
    onp.testing.assert_allclose(w.asnumpy(), onp.asarray(
        jnp_.linalg.eigh(jnp_.array(s))[0]._data), atol=1e-4)
    q, r = tnp_.linalg.qr(tnp_.array(A))
    onp.testing.assert_allclose(q.asnumpy() @ r.asnumpy(), A, atol=1e-5)
    u, sv, vh = tnp_.linalg.svd(tnp_.array(A))
    assert u.shape == (4, 4) and vh.shape == (5, 5)
    onp.testing.assert_allclose((u.asnumpy()[:, :4] * sv.asnumpy())
                                @ vh.asnumpy()[:4], A, atol=1e-5)


def test_np_random_invariants():
    """The port's draws hold by shape, dtype, support and moments (the
    JAX package draws other numbers from its threefry keys)."""
    tnp_.random.seed(0)
    r = tnp_.random
    n = 200_000
    u = r.uniform(-1.0, 3.0, size=(n,))
    assert u.shape == (n,) and u.dtype == onp.float32
    assert float(u.min().item()) >= -1.0 and float(u.max().item()) < 3.0
    assert abs(float(u.mean().item()) - 1.0) < 0.02
    z = r.normal(3.0, 0.5, size=(n,))
    assert abs(float(z.mean().item()) - 3.0) < 0.01
    assert abs(float(z.std().item()) - 0.5) < 0.01
    assert r.randn(3, 2).shape == (3, 2) and r.rand(4).shape == (4,)
    i = r.randint(2, 9, size=(1000,))
    assert i.dtype == onp.int32 and i.min().item() >= 2 and \
        i.max().item() < 9
    g = r.gamma(2.0, 3.0, size=(n,))             # mean k*theta, var k*theta^2
    assert abs(float(g.mean().item()) - 6.0) < 0.1
    assert abs(float(g.var().item()) - 18.0) < 0.6
    e = r.exponential(2.0, size=(n,))
    assert float(e.min().item()) >= 0 and abs(float(e.mean().item())
                                              - 2.0) < 0.03
    b = r.beta(2.0, 5.0, size=(n,))
    assert abs(float(b.mean().item()) - 2.0 / 7.0) < 0.005
    c = r.choice(5, size=(n,), p=[0.1, 0.0, 0.2, 0.3, 0.4])
    counts = onp.bincount(c.asnumpy(), minlength=5) / n
    onp.testing.assert_allclose(counts, [0.1, 0.0, 0.2, 0.3, 0.4], atol=0.01)
    c2 = r.choice(tnp_.array(V), size=(6,), replace=False)
    assert sorted(c2.tolist()) == sorted(V.tolist())
    perm = r.permutation(10)
    assert sorted(perm.tolist()) == list(range(10))
    x = tnp_.array(onp.arange(8, dtype=onp.float32))
    r.shuffle(x)
    assert sorted(x.tolist()) == list(range(8))
    m = r.multinomial(20, [0.2, 0.3, 0.5], size=(4,))
    assert m.shape == (4, 3) and (m.sum(axis=1).asnumpy() == 20).all()
    assert m.dtype == onp.asarray(jnp_.random.multinomial(
        20, jnp_.array([0.2, 0.3, 0.5]))._data).dtype
    for fn in ("uniform", "normal", "gamma", "beta", "choice"):
        assert fn in jnp_.random.__all__ and fn in tnp_.random.__all__
    tnp_.random.seed(5)
    a1 = r.uniform(size=(4,)).asnumpy()
    tnp_.random.seed(5)
    onp.testing.assert_array_equal(r.uniform(size=(4,)).asnumpy(), a1)


def test_autograd_through_np_functions():
    """np functions are torch ops: recorded, they differentiate like the
    JAX package's (1e-5)."""
    grads = []
    for mx, np_ in ((jmx, jnp_), (tmx, tnp_)):
        x = np_.array(A)
        x.attach_grad()
        with mx.autograd.record():
            y = np_.sum(np_.tanh(x) * np_.exp(x)) + np_.mean(
                np_.take(x, np_.array(IDX), axis=1) ** 2)
            y = y + np_.std(np_.reshape(x, (5, 4)), axis=0).sum()
        y.backward()
        grads.append(x.grad.asnumpy())
    onp.testing.assert_allclose(grads[1], grads[0], rtol=1e-5, atol=1e-5)
    x = tnp_.array(onp.ones((2, 3), onp.float32))
    x.attach_grad()
    with tmx.autograd.record():
        y = (x.transpose() * 2).sum()
    y.backward()
    onp.testing.assert_array_equal(x.grad.asnumpy(), 2 * onp.ones((2, 3)))


def test_ndarray_methods_and_interop():
    x = tnp_.array(A)
    assert isinstance(x, tnp_.ndarray) and isinstance(x, tmx.nd.NDArray)
    assert x.sum().item() == pytest.approx(float(A.sum()), rel=1e-5)
    assert x.mean(axis=0).shape == (5,)
    assert tnp_.array([3.0]).item() == 3.0
    assert x.tolist() == A.tolist()
    assert type(x.as_nd_ndarray()) is tmx.nd.NDArray
    for got in (x + x, x * 2, x[1:3, ::2], x.T, x.reshape(5, 4),
                x.astype("float16"), tmx.nd.softmax(x, axis=-1)):
        assert isinstance(got, tnp_.ndarray), type(got)
    onp.testing.assert_array_equal(x.transpose(1, 0).asnumpy(), A.T)
    assert type(tmx.nd.array([1.0]) * 2) is tmx.nd.NDArray
    assert type(x.copy()) is tnp_.ndarray


NPX_CASES = {
    "softmax": (lambda a: ((a(A),), {"axis": -1}), 1e-6),
    "log_softmax": (lambda a: ((a(A),), {"axis": 0}), 1e-6),
    "relu": (lambda a: ((a(A),), {}), 0),
    "sigmoid": (lambda a: ((a(A),), {}), 1e-6),
    "gelu": (lambda a: ((a(A),), {}), 1e-5),
    "activation": (lambda a: ((a(A),), {"act_type": "tanh"}), 1e-6),
    "one_hot": (lambda a: ((a(onp.array([0, 2], onp.int32)),),
                           {"depth": 3}), 0),
    "erf": (lambda a: ((a(A),), {}), 1e-6),
    "topk": (lambda a: ((a(A),), {"k": 2, "ret_typ": "value"}), 0),
    "fully_connected": (lambda a: ((a(A), a(M.T), a(V[:3])),
                                   {"num_hidden": 3}), 1e-5),
    "layer_norm": (lambda a: ((a(A), a(W5), a(W5 * 0.5)), {}), 1e-5),
    "leaky_relu": (lambda a: ((a(A),), {"slope": 0.1}), 1e-6),
    "pick": (lambda a: ((a(A), a(onp.array([0, 1, 4, 2], onp.float32))),
                        {"axis": 1}), 0),
    "sequence_mask": (lambda a: ((a(A3), a(onp.array([1, 2, 1],
                                                     onp.float32))),
                                 {"use_sequence_length": True}), 0),
}


@pytest.mark.parametrize("case", sorted(NPX_CASES))
def test_npx_ops_match_jax(case):
    build, tol = NPX_CASES[case]
    jargs, jkw = build(jnp_.array)
    targs, tkw = build(tnp_.array)
    want = getattr(jnpx, case)(*jargs, **jkw)
    got = getattr(tnpx, case)(*targs, **tkw)
    assert isinstance(got, tnp_.ndarray)
    _same(_values(got), _values(want), tol, case)


def test_npx_names_and_mode_switches(tmp_path):
    assert set(tnpx.__all__) == set(jnpx.__all__)
    assert not tnpx.is_np_array() and not tmx.util.is_np_array()
    tnpx.set_np()
    assert tnpx.is_np_array() and tnpx.is_np_shape() and \
        tmx.util.is_np_array()
    tnpx.reset_np()
    assert not tnpx.is_np_array()

    @tmx.util.use_np
    def inside():
        return tnpx.is_np_array()

    assert inside() and not tnpx.is_np_array()
    tnpx.set_np()
    assert inside() and tnpx.is_np_array()   # the enclosing mode stays
    tnpx.reset_np()
    f = str(tmp_path / "arrs.npz")
    tnpx.save(f, {"a": tnp_.array(A), "i": tnp_.array(I)})
    back = tnpx.load(f)
    assert isinstance(back["a"], tnp_.ndarray)
    onp.testing.assert_array_equal(back["a"].asnumpy(), A)
    jback = jnpx.load(f)                       # the JAX package reads it
    onp.testing.assert_array_equal(onp.asarray(jback["i"]._data), I)
    tnpx.save(f, [tnp_.array(V)])
    assert isinstance(tnpx.load(f)[0], tnp_.ndarray)
    tnpx.waitall()


def _dense_pair():
    """A Dense(3, in_units=2) in each package with the same weights."""
    with jmx.gluon.nn.HybridSequential(prefix="c12_").name_scope():
        jnet = jmx.gluon.nn.Dense(3, in_units=2)
    with tmx.gluon.nn.HybridSequential(prefix="c12_").name_scope():
        tnet = tmx.gluon.nn.Dense(3, in_units=2)
    jnet.initialize()
    tnet.initialize()
    w = onp.random.RandomState(3).randn(3, 2).astype(onp.float32)
    b = onp.array([0.1, -0.2, 0.3], onp.float32)
    jnet.weight.set_data(jmx.nd.array(w))
    jnet.bias.set_data(jmx.nd.array(b))
    tnet.weight.set_data(w)
    tnet.bias.set_data(b)
    return jnet, tnet


def test_set_np_block_outputs_c12():
    """ROADMAP C12: under ``npx.set_np()`` the JAX package's hybridized
    block returns a legacy NDArray, its eager block ``mx.np.ndarray``;
    the port returns ``mx.np.ndarray`` from both, as MXNet does.  The
    values agree (1e-6)."""
    jnet, tnet = _dense_pair()
    x = onp.ones((1, 2), onp.float32)
    jnpx.set_np()
    tnpx.set_np()
    je = jnet(jmx.np.array(x))
    te = tnet(tmx.np.array(x))
    jnet.hybridize()
    tnet.hybridize()
    jh = jnet(jmx.np.array(x))
    th = tnet(tmx.np.array(x))
    assert isinstance(je, jmx.np.ndarray) and isinstance(te, tmx.np.ndarray)
    assert type(jh) is jmx.nd.NDArray            # the JAX package's defect
    assert isinstance(th, tmx.np.ndarray)        # the port: MXNet's type
    assert isinstance(tnet(tmx.nd.ones((1, 2))), tmx.np.ndarray)
    assert isinstance(tnet.weight.data(), tmx.np.ndarray)
    for got, want in ((te, je), (th, jh)):
        onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                    rtol=1e-6, atol=1e-6)
    tnpx.reset_np()
    jnpx.reset_np()
    assert type(tnet(tmx.nd.ones((1, 2)))) is tmx.nd.NDArray
    assert type(tnet.weight.data()) is tmx.nd.NDArray


def test_retype_keeps_the_gradient_hook():
    """``Parameter.data()``'s retype is in place: the leaf stays in the
    graph and its gradient still lands in ``grad()``."""
    _, tnet = _dense_pair()
    leaf = tnet.weight.tensor()
    tnpx.set_np()
    x = tnp_.array(onp.ones((2, 2), onp.float32))
    with tmx.autograd.record():
        y = tnet(x).sum()
    y.backward()
    assert tnet.weight.tensor() is leaf
    onp.testing.assert_allclose(tnet.weight.grad().asnumpy(),
                                onp.full((3, 2), 2.0), rtol=1e-6)


BERT_KW = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
               num_heads=4, max_length=32, dropout=0.0,
               attention_impl="flash")


def test_flash_bert_under_set_np_matches_jax():
    """A 2-layer, 64-unit flash BERT under ``set_np`` in both packages
    from the same parameters (``params_from_jax``), inputs built with
    ``mx.np``: every output ``mx.np.ndarray`` in the port, outputs and
    every parameter's gradient within 1e-4 of the JAX package's (the
    JAX side's hybridized flash through its interpret-mode kernels)."""
    from mxnet_tpu.gluon.model_zoo.bert import BERTModel as JBERT
    from mxnet_tpu_torch.gluon.block import params_from_jax
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel as TBERT
    rng = onp.random.RandomState(11)
    tok = rng.randint(0, 100, (2, 16)).astype(onp.int32)
    typ = rng.randint(0, 2, (2, 16)).astype(onp.int32)
    pos = onp.tile(onp.arange(4, dtype=onp.int32) * 3, (2, 1))
    with jmx.gluon.nn.HybridSequential(prefix="npbert_").name_scope():
        jnet = JBERT(**BERT_KW)
    with tmx.gluon.nn.HybridSequential(prefix="npbert_").name_scope():
        tnet = TBERT(**BERT_KW)
    jnet.initialize(jmx.init.Normal(0.02))
    jnet(jmx.nd.array(tok), jmx.nd.array(typ), None, jmx.nd.array(pos))
    arrays = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet.initialize()
    params_from_jax(tnet, arrays)
    jnet.hybridize()
    tnet.hybridize()
    jnpx.set_np()
    tnpx.set_np()
    outs, grads = [], []
    for mx, np_, net in ((jmx, jnp_, jnet), (tmx, tnp_, tnet)):
        with mx.autograd.record():
            out = net(np_.array(tok), np_.array(typ), None, np_.array(pos))
            loss = sum(np_.sum(o * o) for o in out if o is not None)
        loss.backward()
        outs.append([o for o in out if o is not None])
        grads.append({k: p.grad().asnumpy() for k, p in
                      net.collect_params().items() if p.grad_req != "null"})
    assert all(isinstance(o, tnp_.ndarray) for o in outs[1])
    for t, j in zip(outs[1], outs[0]):
        onp.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-4,
                                    atol=1e-4)
    assert grads[1].keys() == grads[0].keys()
    for k in grads[0]:
        onp.testing.assert_allclose(grads[1][k], grads[0][k], rtol=1e-4,
                                    atol=1e-4, err_msg=k)


def test_data_dependent_names_raise_in_a_hybridized_body():
    """nonzero, unique and the like read sizes on the host: inside a
    hybridized body they raise (as jnp raises under jit); eagerly they
    work."""

    class NonZero(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return tnp_.nonzero(tnp_.ndarray(x))[0]._data

    blk = NonZero()
    x = tmx.nd.array(onp.array([0.0, 2.0, 0.0, 3.0], onp.float32))
    onp.testing.assert_array_equal(blk(x).asnumpy(), [1, 3])
    blk.hybridize()
    with pytest.raises(TypeError, match="data-dependent"):
        blk(x)


@pytest.mark.gpu
def test_np_on_the_card():
    """np functions on card arrays give card arrays, the host's values
    (1e-5), and ``set_np`` blocks on the card return ``mx.np.ndarray``."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = tnp_.array(A, ctx=tmx.gpu())
    for name, args in (("median", ()), ("std", ()), ("cumsum", (1,)),
                       ("argsort", (1,)), ("unique", ())):
        got = getattr(tnp_, name)(x, *args)
        assert got._data.is_cuda, name
        want = getattr(tnp_, name)(tnp_.array(A), *args)
        onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(),
                                    rtol=1e-5, atol=1e-5, err_msg=name)
    net = tmx.gluon.nn.Dense(3, in_units=5)
    net.initialize(ctx=tmx.gpu())
    net.hybridize()
    tnpx.set_np()
    out = net(x)
    assert isinstance(out, tnp_.ndarray) and out._data.is_cuda
