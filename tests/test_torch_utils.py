"""The port's small utility modules against the JAX package's: ``util``
and ``log`` (copies), ``runtime`` (the same feature keys, the port's own
values) and ``test_utils`` (the same tolerances, random arrays and
verdicts, on the caller's device).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import test_utils as ttu
from mxnet_tpu import test_utils as jtu


def test_util_module(tmp_path):
    d = str(tmp_path / "a" / "b" / "c")
    tmx.util.makedirs(d)
    tmx.util.makedirs(d)                          # idempotent
    assert os.path.isdir(d)
    assert tmx.util.getenv("MXNET_ENGINE_TYPE") == \
        jmx.util.getenv("MXNET_ENGINE_TYPE") == "ThreadedEnginePerDevice"
    tmx.util.setenv("MXNET_TEST_DUMMY_PORT", "42")
    assert os.environ.pop("MXNET_TEST_DUMMY_PORT") == "42"
    assert tmx.util.is_np_array() is False

    @tmx.util.use_np
    def inside():
        return tmx.util.is_np_array(), tmx.util.is_np_shape()

    assert inside() == (True, True)
    assert tmx.util.is_np_array() is False
    assert set(tmx.util.__all__) == set(jmx.util.__all__)
    assert tmx.util.set_module("x.y")(inside).__module__ == "x.y"


def test_log_module(tmp_path):
    f = str(tmp_path / "t.log")
    lg = tmx.log.get_logger("mxtpu_torch_test_logger", filename=f,
                            level=tmx.log.INFO)
    assert tmx.log.get_logger("mxtpu_torch_test_logger") is lg
    assert len(lg.handlers) == 1 and lg.propagate is False
    lg.info("hello-from-port")
    lg.handlers[0].flush()
    assert "hello-from-port" in open(f).read()
    assert (tmx.log.DEBUG, tmx.log.INFO, tmx.log.WARNING, tmx.log.ERROR) == \
        (jmx.log.DEBUG, jmx.log.INFO, jmx.log.WARNING, jmx.log.ERROR)


def test_runtime_features():
    from mxnet_tpu_torch.base import load_native_lib
    feats = tmx.runtime.Features()
    assert list(feats) == list(jmx.runtime.Features())
    assert feats.is_enabled("CPU") and feats.is_enabled("INT8")
    assert feats.is_enabled("CUDA") == torch.cuda.is_available()
    for off in ("TPU", "PALLAS", "DIST_KVSTORE"):
        assert not feats.is_enabled(off), off
    assert feats.is_enabled("ONNX") == jmx.runtime.Features().is_enabled(
        "ONNX")
    assert feats.is_enabled("RECORDIO_NATIVE") == \
        (load_native_lib("librecordio") is not None)
    with pytest.raises(RuntimeError, match="unknown feature"):
        feats.is_enabled("WARP_DRIVE")
    assert [f.name for f in tmx.runtime.feature_list()] == list(feats)
    assert "CUDA" in repr(feats)


@pytest.mark.parametrize("dtype", ["float64", "float32", "float16",
                                   "bfloat16", "int32"])
def test_default_tols_as_jax(dtype):
    assert ttu.default_tols(dtype) == jtu.default_tols(dtype)


def test_rand_ndarray_as_jax():
    with tmx.cpu():
        got = ttu.rand_ndarray((3, 4), low=-2, high=3, seed=5)
    want = jtu.rand_ndarray((3, 4), low=-2, high=3, seed=5)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert got._data.device.type == "cpu"


def test_assert_almost_equal():
    with tmx.cpu():
        a = tmx.nd.array(np.ones(4, np.float32))
        ttu.assert_almost_equal(a, a + 1e-6)
        ttu.assert_almost_equal(a.astype("bfloat16"), a + 1e-2)
        with pytest.raises(AssertionError):
            ttu.assert_almost_equal(a, a + 1e-2)
        ttu.assert_almost_equal(np.arange(3), np.arange(3))
        with pytest.raises(AssertionError):
            ttu.assert_almost_equal(np.arange(3), np.arange(1, 4))


@pytest.mark.parametrize("op,shapes,kw", [
    ("FullyConnected", ((4, 6), (3, 6), (3,)), dict(num_hidden=3)),
    ("dot", ((3, 5), (5, 4)), {}),
    ("tanh", ((3, 4),), {}),
    ("softmax", ((2, 5),), dict(axis=-1)),
])
def test_check_numeric_gradient_and_consistency(op, shapes, kw):
    rng = np.random.RandomState(0)
    inputs = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    with tmx.cpu():
        ttu.check_numeric_gradient(op, inputs, kw)
        ttu.check_consistency(op, inputs, kw)
    jtu.check_numeric_gradient(op, inputs, kw)


def test_check_numeric_gradient_catches_a_wrong_backward():
    class Twice(tmx.autograd.Function):
        def forward(self, x):
            return x * 2

        def backward(self, dy):
            return dy * 3                        # wrong on purpose

    x = np.random.RandomState(1).randn(5).astype(np.float32)
    with tmx.cpu():
        with pytest.raises(AssertionError, match="numeric gradient"):
            ttu.check_numeric_gradient(lambda a: Twice()(a), [x])
        ttu.check_numeric_gradient(lambda a: a * 2, [x])


def test_check_consistency_catches_a_dtype_dependent_op():
    def dt_dependent(a):
        return a * (2.0 if str(a.dtype) == "float32" else 3.0)

    x = np.ones((2, 2), np.float32)
    with tmx.cpu():
        with pytest.raises(AssertionError, match="inconsistent"):
            ttu.check_consistency(dt_dependent, [x])


def test_naive_engine_waits_after_each_dispatch(monkeypatch):
    """MXNET_ENGINE_TYPE=NaiveEngine (the knob is wired, read at import as
    the JAX package reads it): each ``nd`` dispatch calls the engine's
    wait once, on its first output; with the knob unset the dispatch
    calls nothing.  A host tensor needs no wait."""
    from mxnet_tpu import config as jconfig
    from mxnet_tpu_torch import config, engine
    from mxnet_tpu_torch.ndarray import ndarray as ndmod
    assert config.KNOBS["MXNET_ENGINE_TYPE"].wired
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert config.naive_engine() and jconfig.naive_engine()
    monkeypatch.delenv("MXNET_ENGINE_TYPE")
    assert not config.naive_engine() and not engine.is_naive()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail(
        "a host tensor was synchronised"))
    seen = []
    with tmx.cpu():
        x = tmx.nd.ones((2, 3))
        engine.set_naive(True)
        try:
            assert engine.is_naive()
            wait = ndmod._NAIVE
            monkeypatch.setattr(ndmod, "_NAIVE",
                                lambda t: (seen.append(t), wait(t)))
            y = x + 1
            z = tmx.nd.relu(y)
        finally:
            engine.set_naive(False)
        assert seen[0] is y._data and seen[1] is z._data and len(seen) == 2
        assert not engine.is_naive() and ndmod._NAIVE is None
        (x * 2).asnumpy()
    assert len(seen) == 2


def test_naive_engine_from_the_environment():
    """A process started with the knob set dispatches synchronously."""
    import subprocess
    import sys
    env = dict(os.environ, MXNET_ENGINE_TYPE="NaiveEngine")
    out = subprocess.run(
        [sys.executable, "-c", "import mxnet_tpu_torch as mx; "
         "print(mx.engine.is_naive())"], env=env, capture_output=True,
        text=True, timeout=120, cwd=os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    assert out.stdout.strip().splitlines()[-1] == "True", out.stderr[-2000:]


@pytest.mark.gpu
def test_naive_engine_on_the_card():
    """On the card NaiveEngine leaves no kernel queued after a dispatch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mxnet_tpu_torch import engine
    x = tmx.nd.ones((4096, 4096), ctx=tmx.gpu())
    engine.set_naive(True)
    try:
        y = tmx.nd.dot(x, x)
        assert torch.cuda.current_stream().query()
    finally:
        engine.set_naive(False)
    assert float(y[0, 0].asscalar()) == 4096.0
