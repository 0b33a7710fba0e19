"""The port's samplers (``mxnet_tpu_torch/ops/random_ops.py`` and
``nd.random``) against the JAX package's.

The two packages draw from different generators (threefry keys in JAX,
torch's per-device generators in the port: the declared divergence of
``random``), so the same seed gives other numbers.  Each sampler is
held to the JAX package by what does not depend on the stream: every
registered name and alias, the shape and dtype of each call, and the
distribution's invariants — support, and mean and variance within 6
standard errors of the parameterisation's (the JAX one: ``beta`` the
gamma's scale, ``lam`` the exponential's rate, the negative binomials
as gamma-Poisson mixtures) — on 20000 draws per call; plus
reproducibility under ``mx.random.seed``.
"""
import inspect

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops.registry import OPS as JOPS
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops.registry import OPS as TOPS

N = 20000
SIGMAS = 6.0


def _module_names(ops, module):
    return sorted(n for n, f in ops.items()
                  if inspect.getmodule(f).__name__ == module)


JNAMES = _module_names(JOPS, "mxnet_tpu.ops.random_ops")


def _groups(ops, names):
    """The names partitioned by the function they reach."""
    by_fn = {}
    for n in names:
        by_fn.setdefault(id(ops[n]), set()).add(n)
    return sorted(sorted(g) for g in by_fn.values())


def test_every_name_and_alias():
    assert len(JNAMES) == 33
    tnames = _module_names(TOPS, "mxnet_tpu_torch.ops.random_ops")
    assert tnames == JNAMES
    assert _groups(TOPS, tnames) == _groups(JOPS, JNAMES)
    for n in ("uniform", "normal", "randint", "shuffle"):
        assert callable(getattr(tmx.nd, n))


def _rows(nd, *vals):
    return [nd.array(np.asarray(v, np.float32)) for v in vals]


# canonical name -> (positional row parameters, kwargs, per-row
# (mean, variance) of each output row, support check)
def _uniform_mv(lo, hi):
    return (lo + hi) / 2, (hi - lo) ** 2 / 12


CASES = {
    "_random_uniform": ((), dict(low=2.0, high=5.0),
                        [_uniform_mv(2.0, 5.0)],
                        lambda x: (x >= 2).all() and (x < 5).all()),
    "_random_normal": ((), dict(loc=1.5, scale=2.0), [(1.5, 4.0)], None),
    "_random_gamma": ((), dict(alpha=3.0, beta=2.0), [(6.0, 12.0)],
                      lambda x: (x > 0).all()),
    "_random_exponential": ((), dict(lam=4.0), [(0.25, 1 / 16)],
                            lambda x: (x >= 0).all()),
    "_random_poisson": ((), dict(lam=3.0), [(3.0, 3.0)],
                        lambda x: (x >= 0).all() and (x == np.round(x)).all()),
    "_random_negative_binomial": ((), dict(k=4, p=0.4), [(6.0, 15.0)],
                                  lambda x: (x >= 0).all()
                                  and (x == np.round(x)).all()),
    "_random_generalized_negative_binomial": (
        (), dict(mu=2.0, alpha=0.5), [(2.0, 4.0)],
        lambda x: (x >= 0).all() and (x == np.round(x)).all()),
    "_random_randint": ((), dict(low=-3, high=9), [(2.5, (12 ** 2 - 1) / 12)],
                        lambda x: (x >= -3).all() and (x < 9).all()),
    "_sample_uniform": (([0.0, 10.0], [1.0, 20.0]), {},
                        [_uniform_mv(0.0, 1.0), _uniform_mv(10.0, 20.0)],
                        None),
    "_sample_normal": (([-5.0, 5.0], [1.0, 3.0]), {},
                       [(-5.0, 1.0), (5.0, 9.0)], None),
    "_sample_gamma": (([2.0, 8.0], [1.0, 0.5]), {},
                      [(2.0, 2.0), (4.0, 2.0)], lambda x: (x > 0).all()),
    "_sample_exponential": (([0.5, 4.0],), {},
                            [(2.0, 4.0), (0.25, 1 / 16)],
                            lambda x: (x >= 0).all()),
    "_sample_poisson": (([0.5, 4.0],), {}, [(0.5, 0.5), (4.0, 4.0)],
                        lambda x: (x == np.round(x)).all()),
}


def _canonical(name):
    fn = JOPS[name]
    return next(n for n in CASES if JOPS[n] is fn) \
        if any(JOPS[n] is fn for n in CASES) else None


def _call(mx, name, shape, dtype=None):
    canon = _canonical(name)
    rows, kw, _, _ = CASES[canon]
    kw = dict(kw, shape=shape)
    if dtype is not None:
        kw["dtype"] = dtype
    return mx.nd.invoke(name, *_rows(mx.nd, *rows), **kw)


SHAPED = [n for n in JNAMES if _canonical(n) is not None]


_JAX_DRAWS = {}


def _jax_draw(name):
    """JAX's draw of ``name``'s function at shape (3, 4), once per
    function (its aliases share it)."""
    fn = id(JOPS[name])
    if fn not in _JAX_DRAWS:
        _JAX_DRAWS[fn] = _call(jmx, name, (3, 4))
    return _JAX_DRAWS[fn]


@pytest.mark.parametrize("name", SHAPED)
def test_shape_and_dtype_as_jax(name):
    """Every name gives JAX's shape and dtype, by default and when the
    dtype is named; an int shape is a 1-D draw."""
    want = _jax_draw(name)
    with tmx.cpu():
        got = _call(tmx, name, (3, 4))
        named = _call(tmx, name, (3, 4), str(want.dtype))
        flat = _call(tmx, name, 5)
    assert got.shape == named.shape == want.shape, name
    assert str(got.dtype) == str(named.dtype) == str(want.dtype), name
    assert flat.shape == want.shape[:-2] + (5,), name


def _hold_moments(x, mean, var, what):
    n = x.size
    m = x.mean()
    v = x.var()
    m4 = ((x - m) ** 4).mean()
    se_m = np.sqrt(var / n)
    se_v = np.sqrt(max(m4 - v * v, 1e-12) / n)
    assert abs(m - mean) <= SIGMAS * se_m, (what, m, mean, se_m)
    assert abs(v - var) <= SIGMAS * se_v, (what, v, var, se_v)


@pytest.mark.parametrize("canon", sorted(CASES))
def test_invariants(canon):
    rows, kw, moments, support = CASES[canon]
    tmx.random.seed(3)
    with tmx.cpu():
        x = tmx.nd.invoke(canon, *_rows(tmx.nd, *rows), shape=(N,), **kw)
    x = x.asnumpy().astype(np.float64).reshape(len(moments), N)
    for i, (mean, var) in enumerate(moments):
        _hold_moments(x[i], mean, var, f"{canon} row {i}")
    if support is not None:
        assert support(x), canon


def _probs(nd):
    return nd.array(np.array([[0.0, 0.1, 0.9], [1.0, 0.0, 0.0],
                              [0.2, 0.3, 0.5]], np.float32))


def test_multinomial_as_jax():
    tmx.random.seed(0)
    for shape in (None, 1, 4, (3, 5)):
        kw = {} if shape is None else dict(shape=shape)
        want = jmx.nd.invoke("_sample_multinomial", _probs(jmx.nd), **kw)
        with tmx.cpu():
            got = tmx.nd.invoke("_sample_multinomial", _probs(tmx.nd), **kw)
        assert got.shape == want.shape and str(got.dtype) == str(want.dtype)
    with tmx.cpu():
        d, lp = tmx.nd.invoke("_sample_multinomial", _probs(tmx.nd),
                              shape=N, get_prob=True)
        probs = _probs(tmx.nd).asnumpy()
    jd, jlp = jmx.nd.invoke("_sample_multinomial", _probs(jmx.nd), shape=4,
                            get_prob=True)
    assert str(lp.dtype) == str(jlp.dtype) == "float32"
    dv = d.asnumpy()
    np.testing.assert_allclose(
        lp.asnumpy(), np.log(np.maximum(probs, 1e-30))[
            np.arange(3)[:, None], dv.astype(int)], rtol=1e-6)
    assert dv[0].min() >= 1 and set(np.unique(dv[1])) == {0}
    for k in range(3):          # a Bernoulli count per class, row 2
        hit = (dv[2] == k).astype(np.float64)
        p = probs[2, k]
        _hold_moments(hit, p, p * (1 - p), f"class {k}")


def test_shuffle_is_a_permutation():
    tmx.random.seed(0)
    with tmx.cpu():
        data = tmx.nd.array(np.arange(24, dtype=np.float32).reshape(12, 2))
        a = tmx.nd.shuffle(data).asnumpy()
        b = tmx.nd.random.shuffle(data).asnumpy()
    want = jmx.nd.shuffle(jmx.nd.array(np.arange(24, dtype=np.float32)
                                       .reshape(12, 2)))
    assert a.shape == b.shape == want.shape
    for x in (a, b):
        assert sorted(x[:, 0]) == list(range(0, 24, 2))
        np.testing.assert_array_equal(x[:, 1], x[:, 0] + 1)   # rows whole


def test_seed_reproduces_the_bits():
    def draws():
        with tmx.cpu():
            return [tmx.nd.invoke(n, *_rows(tmx.nd, *CASES[n][0]),
                                  shape=(64,), **CASES[n][1]).asnumpy()
                    for n in sorted(CASES)] + \
                [tmx.nd.random.exponential(2.0, shape=(8,)).asnumpy(),
                 tmx.nd.shuffle(tmx.nd.arange(16)).asnumpy()]

    tmx.random.seed(7)
    a, a2 = draws(), draws()
    tmx.random.seed(7)
    b = draws()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not all(np.array_equal(x, y) for x, y in zip(a, a2))


ND_RANDOM = {
    "exponential": (dict(scale=2.0), (2.0, 4.0), lambda x: (x >= 0).all()),
    "gamma": (dict(alpha=3.0, beta=0.5), (1.5, 0.75), lambda x: (x > 0).all()),
    "poisson": (dict(lam=5.0), (5.0, 5.0),
                lambda x: (x == np.round(x)).all()),
    "normal": (dict(loc=-1.0, scale=0.5), (-1.0, 0.25), None),
    "uniform": (dict(low=-2.0, high=2.0), _uniform_mv(-2.0, 2.0),
                lambda x: (x >= -2).all() and (x < 2).all()),
}


@pytest.mark.parametrize("fn", sorted(ND_RANDOM))
def test_nd_random_functions(fn):
    kw, (mean, var), support = ND_RANDOM[fn]
    want = getattr(jmx.nd.random, fn)(shape=(3, 2), **kw)
    tmx.random.seed(5)
    with tmx.cpu():
        got = getattr(tmx.nd.random, fn)(shape=(3, 2), **kw)
        x = getattr(tmx.nd.random, fn)(shape=(N,), **kw).asnumpy()
    assert got.shape == want.shape and str(got.dtype) == str(want.dtype)
    _hold_moments(x.astype(np.float64), mean, var, fn)
    if support is not None:
        assert support(x)


def test_randn_and_multinomial_wrappers():
    with tmx.cpu():
        r = tmx.nd.random.randn(3, 4)
        m = tmx.nd.random.multinomial(_probs(tmx.nd), shape=6)
    assert r.shape == jmx.nd.random.randn(3, 4).shape == (3, 4)
    assert m.shape == jmx.nd.random.multinomial(_probs(jmx.nd),
                                                shape=6).shape
    assert str(m.dtype) == "int32"


def test_samplers_draw_where_their_arrays_are():
    """A ``_sample_*`` op draws on its parameters' device from that
    device's generator; a ``_random_*`` op on its ``ctx``."""
    from mxnet_tpu_torch import random as trandom
    gen = trandom.generator("cpu")
    with tmx.cpu():
        before = gen.get_state()
        lam = tmx.nd.array(np.ones(4, np.float32))
        tmx.nd.invoke("_sample_poisson", lam, shape=(3,))
        assert not torch.equal(before, gen.get_state())
        out = tmx.nd.invoke("_random_normal", shape=(2,), ctx=tmx.cpu())
    assert out._data.device.type == "cpu"
