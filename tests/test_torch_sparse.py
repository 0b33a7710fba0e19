"""``mxnet_tpu_torch.sparse`` against the JAX package's ``sparse``: the
cases of ``tests/test_sparse.py`` that use no KVStore object, each run
through both packages on the same seeded numpy inputs (storage,
indices and values compared; the tolerance per test), plus
``Embedding(sparse_grad=True)`` trained by ``gluon.Trainer`` in both
packages (SGD, Adam, AdaGrad) and ``cast_storage`` raising inside a
hybridized body.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import sparse as jsp
from mxnet_tpu_torch import sparse as tsp

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rand_sparse(shape, density, rng):
    d = rng.randn(*shape).astype(np.float32)
    d[rng.rand(*shape) > density] = 0.0
    return d


def _both(d):
    return jmx.nd.array(d), tmx.nd.array(d)


def _same_rsp(j, t):
    assert t.stype == j.stype == "row_sparse" and t.shape == j.shape
    np.testing.assert_array_equal(t._indices.numpy(), np.asarray(j._indices))
    assert t._indices.dtype == torch.int32
    np.testing.assert_allclose(t._data.numpy(), np.asarray(j._data), **TOL)


def test_cast_storage_roundtrip_rsp():
    rng = np.random.RandomState(0)
    d = _rand_sparse((10, 4), 0.3, rng)
    d[3] = 0
    j, t = _both(d)
    _same_rsp(jsp.cast_storage(j, "row_sparse"),
              tsp.cast_storage(t, "row_sparse"))
    rsp = t.tostype("row_sparse")
    assert 3 not in rsp._indices.tolist()
    np.testing.assert_array_equal(rsp.asnumpy(), d)
    np.testing.assert_array_equal(rsp.tostype("default").asnumpy(), d)


def test_cast_storage_roundtrip_csr():
    rng = np.random.RandomState(1)
    d = _rand_sparse((7, 9), 0.25, rng)
    j, t = _both(d)
    jc, tc = jsp.cast_storage(j, "csr"), tsp.cast_storage(t, "csr")
    assert tc.stype == "csr"
    for name in ("_indptr", "_indices"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
        assert getattr(tc, name).dtype == torch.int32
    np.testing.assert_array_equal(tc._data.numpy(), np.asarray(jc._data))
    np.testing.assert_array_equal(tc.asnumpy(), d)
    _same_rsp(jc.tostype("row_sparse"), tc.tostype("row_sparse"))


def test_construction_helpers_and_zeros():
    args = (np.ones((2, 3), np.float32), np.array([1, 4]))
    np.testing.assert_array_equal(
        tsp.row_sparse_array(args, shape=(6, 3)).asnumpy(),
        jsp.row_sparse_array(args, shape=(6, 3)).asnumpy())
    cargs = (np.array([1.0, 2.0], np.float32), np.array([0, 2]),
             np.array([0, 1, 2]))
    np.testing.assert_array_equal(
        tsp.csr_matrix(cargs, shape=(2, 3)).asnumpy(),
        jsp.csr_matrix(cargs, shape=(2, 3)).asnumpy())
    z = tsp.zeros("row_sparse", (5, 2))
    assert z.asnumpy().sum() == 0 and z._data.shape[0] == 0
    assert tsp.zeros("csr", (4, 4)).asnumpy().sum() == 0
    assert tsp.zeros("default", (2, 2)).shape == (2, 2)


@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("vector", [False, True])
def test_csr_dot(transpose_a, vector):
    """csr × dense and csrᵀ × dense, matrix and vector, within 1e-5."""
    rng = np.random.RandomState(2)
    d = _rand_sparse((6, 8), 0.3, rng)
    rows = 6 if transpose_a else 8
    rhs = rng.randn(rows).astype(np.float32) if vector else \
        rng.randn(rows, 5).astype(np.float32)
    jd, td = _both(d)
    jr, tr = _both(rhs)
    want = jsp.dot(jsp.cast_storage(jd, "csr"), jr,
                   transpose_a=transpose_a).asnumpy()
    got = tsp.dot(tsp.cast_storage(td, "csr"), tr,
                  transpose_a=transpose_a).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rsp_dot_transpose_and_dense_lhs_branches():
    rng = np.random.RandomState(3)
    d = _rand_sparse((6, 4), 0.5, rng)
    rhs = rng.randn(6, 3).astype(np.float32)
    jd, td = _both(d)
    np.testing.assert_allclose(
        tsp.dot(tsp.cast_storage(td, "row_sparse"), tmx.nd.array(rhs),
                transpose_a=True).asnumpy(),
        jsp.dot(jsp.cast_storage(jd, "row_sparse"), jmx.nd.array(rhs),
                transpose_a=True).asnumpy(), rtol=1e-5, atol=1e-5)
    sp = np.array([[0, 1, 0, 2], [0, 0, 0, 0], [3, 0, 4, 0], [0, 0, 0, 5]],
                  np.float32)
    dn = rng.randn(3, 4).astype(np.float32)
    js, ts = _both(sp)
    for stype in ("csr", "row_sparse"):
        for tb in (False, True):
            want = jsp.dot(jmx.nd.array(dn), jsp.cast_storage(js, stype),
                           transpose_b=tb).asnumpy()
            got = tsp.dot(tmx.nd.array(dn), tsp.cast_storage(ts, stype),
                          transpose_b=tb).asnumpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    csr = tsp.cast_storage(ts, "csr")
    with pytest.raises(ValueError):
        tsp.dot(csr, tmx.nd.array(dn), transpose_a=True, transpose_b=True)
    with pytest.raises(NotImplementedError):
        tsp.dot(csr, tmx.nd.array(dn.T), transpose_b=True)


def test_retain_and_add():
    rng = np.random.RandomState(4)
    d = _rand_sparse((8, 3), 0.9, rng)
    jd, td = _both(d)
    _same_rsp(jsp.retain(jsp.cast_storage(jd, "row_sparse"),
                         np.array([0, 3, 7])),
              tsp.retain(tsp.cast_storage(td, "row_sparse"),
                         np.array([0, 3, 7])))
    rng = np.random.RandomState(5)
    a = _rand_sparse((6, 2), 0.4, rng)
    b = _rand_sparse((6, 2), 0.4, rng)
    ja, ta = _both(a)
    jb, tb = _both(b)
    jra, tra = jsp.cast_storage(ja, "row_sparse"), \
        tsp.cast_storage(ta, "row_sparse")
    jrb, trb = jsp.cast_storage(jb, "row_sparse"), \
        tsp.cast_storage(tb, "row_sparse")
    _same_rsp(jra + jrb, tra + trb)
    dense = tra + tmx.nd.array(b)
    assert type(dense) is tmx.nd.NDArray
    np.testing.assert_allclose(dense.asnumpy(), (jra + jmx.nd.array(b))
                               .asnumpy(), rtol=1e-6)
    _same_rsp(jra * 2.0, tra * 2.0)


def test_csr_row_slicing():
    d = np.array([[0, 1, 0, 2], [0, 0, 0, 0], [3, 0, 4, 0], [0, 0, 0, 5]],
                 np.float32)
    jc = jsp.cast_storage(jmx.nd.array(d), "csr")
    tc = tsp.cast_storage(tmx.nd.array(d), "csr")
    for key in (slice(1, 3), 2, -1, slice(0, 0)):
        j, t = jc[key], tc[key]
        assert t.stype == "csr" and t.shape == j.shape
        np.testing.assert_array_equal(t._indptr.numpy(),
                                      np.asarray(j._indptr))
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    with pytest.raises(ValueError):
        tc[0:4:2]
    with pytest.raises(IndexError):
        tc[7]


@pytest.mark.parametrize("opt_name,kw", [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
    ("adagrad", {"learning_rate": 0.1}),
])
def test_lazy_update_matches_jax(opt_name, kw):
    """Three lazy updates with wd 0.01 through each package's optimizer:
    the port's weight and states within 1e-5 of the JAX package's,
    untouched rows the start's bits."""
    rng = np.random.RandomState(6)
    w0 = rng.randn(10, 4).astype(np.float32)
    g = np.zeros_like(w0)
    rows = [1, 5, 6]
    for r in rows:
        g[r] = rng.randn(4)
    out = {}
    for name, mx, sp in (("jax", jmx, jsp), ("port", tmx, tsp)):
        o = mx.optimizer.create(opt_name, wd=0.01, **kw)
        assert o.supports_sparse
        w = mx.nd.array(w0.copy())
        st = o.create_state(0, w)
        for _ in range(3):
            o.update(0, w, sp.cast_storage(mx.nd.array(g), "row_sparse"), st)
        states = [] if st is None else (list(st) if isinstance(st, tuple)
                                        else [st])
        out[name] = (w.asnumpy(), [s.asnumpy() for s in states])
    (jw, js), (tw, ts) = out["jax"], out["port"]
    np.testing.assert_allclose(tw, jw, **TOL)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, **TOL)
    untouched = [i for i in range(10) if i not in rows]
    np.testing.assert_array_equal(tw[untouched], w0[untouched])


def test_rsp_nd_values_and_functional_updates():
    """N-D row values through cast, add and the four functional lazy
    updates, against the JAX package's (1e-5)."""
    rng = np.random.RandomState(3)
    dense = rng.randn(8, 2, 3).astype(np.float32)
    dense[[0, 2, 5]] = 0.0
    w0 = rng.randn(8, 2, 3).astype(np.float32)
    jr = jsp.cast_storage(jmx.nd.array(dense), "row_sparse")
    tr = tsp.cast_storage(tmx.nd.array(dense), "row_sparse")
    _same_rsp(jr, tr)
    _same_rsp(jsp.add(jr, jr), tsp.add(tr, tr))
    z = np.zeros_like(w0)
    cases = [("sgd_update", dict(lr=0.1, wd=0.01), 0),
             ("sgd_mom_update", dict(lr=0.1, momentum=0.9, wd=0.01), 1),
             ("adagrad_update", dict(lr=0.1, wd=0.01), 1),
             ("adam_update", dict(t=2, lr=0.01, wd=0.01), 2)]
    for fn, kw, n_states in cases:
        outs = []
        for mx, sp, r in ((jmx, jsp, jr), (tmx, tsp, tr)):
            states = [mx.nd.array(z.copy() + 0.1) for _ in range(n_states)]
            w = getattr(sp, fn)(mx.nd.array(w0), r, *states, **kw)
            outs.append([w.asnumpy()] + [s.asnumpy() for s in states])
        for a, b in zip(outs[1], outs[0]):
            np.testing.assert_allclose(a, b, **TOL, err_msg=fn)


def test_clip_gradient_and_dense_only_optimizer():
    rng = np.random.RandomState(8)
    w0 = rng.randn(6, 3).astype(np.float32)
    g = np.zeros_like(w0)
    g[2] = [100.0, -100.0, 0.5]
    got = []
    for mx, sp in ((jmx, jsp), (tmx, tsp)):
        o = mx.optimizer.create("sgd", learning_rate=1.0, clip_gradient=1.0)
        w = mx.nd.array(w0.copy())
        o.update(0, w, sp.cast_storage(mx.nd.array(g), "row_sparse"),
                 o.create_state(0, w))
        got.append(w.asnumpy())
    np.testing.assert_allclose(got[1], got[0], rtol=1e-6, atol=1e-7)
    gr = tsp.cast_storage(tmx.nd.array(np.ones((4, 2), np.float32)),
                          "row_sparse")
    w = tmx.nd.array(np.ones((4, 2), np.float32))
    o = tmx.optimizer.create("nag", learning_rate=0.1, momentum=0.9)
    assert not o.supports_sparse
    with pytest.raises(TypeError, match="sparse storage"):
        o.update(0, w, gr, o.create_state(0, w))


def _emb_pair(sparse_grad, seed_w):
    """An Embedding(20, 4) in each package with the same weight."""
    j = jmx.gluon.nn.Embedding(20, 4, sparse_grad=sparse_grad, prefix="e_")
    t = tmx.gluon.nn.Embedding(20, 4, sparse_grad=sparse_grad, prefix="e_")
    j.initialize()
    t.initialize()
    w = np.random.RandomState(seed_w).randn(20, 4).astype(np.float32)
    j.weight.set_data(jmx.nd.array(w))
    t.weight.set_data(w)
    return j, t, w


@pytest.mark.parametrize("opt_name,kw", [
    ("sgd", {"learning_rate": 0.5, "wd": 0.01}),
    ("adam", {"learning_rate": 0.05, "wd": 0.01}),
    ("adagrad", {"learning_rate": 0.5, "wd": 0.01}),
])
def test_embedding_sparse_grad_trainer_matches_jax(opt_name, kw):
    """``Embedding(sparse_grad=True)`` under ``gluon.Trainer`` (the local
    store) for 3 steps in both packages: the row_sparse gradient's rows
    the same (the rows with a nonzero entry), the weights within 1e-5,
    rows never looked up the start's bits."""
    jemb, temb, w0 = _emb_pair(True, 7)
    x = np.array([[1, 3], [3, 7]], np.int32)
    jtr = jmx.gluon.Trainer(jemb.collect_params(), opt_name, dict(kw),
                            kvstore=None)
    ttr = tmx.gluon.Trainer(temb.collect_params(), opt_name, dict(kw),
                            kvstore=None)
    for _ in range(3):
        for mx, emb, tr in ((jmx, jemb, jtr), (tmx, temb, ttr)):
            with mx.autograd.record():
                loss = (emb(mx.nd.array(x)) ** 2).sum()
            loss.backward()
            tr.step(1)
    jg, tg = jemb.weight.grad(), temb.weight.grad()
    _same_rsp(jg, tg)
    assert sorted(tg._indices.tolist()) == [1, 3, 7]
    got = temb.weight.data().asnumpy()
    np.testing.assert_allclose(got, jemb.weight.data().asnumpy(), **TOL)
    untouched = [i for i in range(20) if i not in (1, 3, 7)]
    np.testing.assert_array_equal(got[untouched], w0[untouched])


def test_sparse_grad_dense_only_optimizer_uses_dense_buffer():
    """LAMB has no lazy update: the Trainer hands it the dense gradient,
    in both packages, to the same weights (1e-5)."""
    jemb, temb, _ = _emb_pair(True, 9)
    x = np.array([1, 2], np.int32)
    outs = []
    for mx, emb in ((jmx, jemb), (tmx, temb)):
        tr = mx.gluon.Trainer(emb.collect_params(), "lamb",
                              {"learning_rate": 0.01}, kvstore=None)
        with mx.autograd.record():
            ((emb(mx.nd.array(x)) ** 2).sum()).backward()
        tr.step(1)
        outs.append(emb.weight.data().asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_cast_storage_inside_a_hybridized_body_raises():
    """Construction from dense reads nnz on the host: inside a
    hybridized block's body it raises, as the JAX package raises on a
    tracer; eagerly it works."""

    class ToRsp(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return tsp.cast_storage(tmx.nd.NDArray(x), "row_sparse").data \
                ._data

    blk = ToRsp()
    x = tmx.nd.array(np.ones((3, 2), np.float32))
    assert blk(x).shape == (3, 2)
    blk.hybridize()
    with pytest.raises(TypeError, match="eager-only"):
        blk(x)
    assert tmx.nd.sparse is tsp


@pytest.mark.gpu
def test_lazy_update_and_csr_dot_on_the_card():
    """The lazy momentum SGD and the csr product on card tensors: the
    host's results (1e-6), untouched rows the start's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(12)
    w0 = rng.randn(50, 8).astype(np.float32)
    g = np.zeros_like(w0)
    g[[3, 9, 40]] = rng.randn(3, 8)
    out = []
    for ctx in (tmx.cpu(), tmx.gpu()):
        with ctx:
            o = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                     wd=0.01)
            w = tmx.nd.array(w0)
            st = o.create_state(0, w)
            for _ in range(2):
                o.update(0, w, tsp.cast_storage(tmx.nd.array(g),
                                                "row_sparse"), st)
            d = _rand_sparse((6, 50), 0.2, rng)
            csr = tsp.cast_storage(tmx.nd.array(d), "csr")
            out.append((w.asnumpy(), tsp.dot(csr, w).asnumpy(), d))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6, atol=1e-6)
    keep = [i for i in range(50) if i not in (3, 9, 40)]
    np.testing.assert_array_equal(out[1][0][keep], w0[keep])
    np.testing.assert_allclose(out[1][1], out[1][2] @ out[1][0], rtol=1e-5,
                               atol=1e-5)
