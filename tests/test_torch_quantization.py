"""The port's int8 ops (``mxnet_tpu_torch/ops/quantization.py``) and
``contrib.quantization.quantize_net`` against the JAX package's, on the
same seeded inputs and parameters.

The int8 products accumulate in int32 in both packages and are exact,
so integer results are equal and the dequantized f32 results agree to
within 1e-6 of their scale (the scale product may round differently by
an ulp); quantized arrays and ranges are equal.  ``quantize_net``'s int8
weights equal the JAX package's bit for bit (the same numpy ``_q8``),
and the four cases of the JAX package's ``quantize_net`` tests run on
both packages from the same parameters: the JAX assertions hold on the
port, and the port's outputs are held to the JAX net's.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jq
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.ops import quantization as tops

REL = 1e-6


def _close(got, want, rel=REL):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    want = want.asnumpy() if hasattr(want, "asnumpy") else np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _q(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _both(op, *args, **kw):
    """``op`` through each package's ``nd.invoke`` (None passes)."""
    jargs = [jmx.nd.array(a) if isinstance(a, np.ndarray) else a
             for a in args]
    want = jmx.nd.invoke(op, *jargs, **kw)
    with tmx.cpu():
        targs = [tmx.nd.array(a) if isinstance(a, np.ndarray) else a
                 for a in args]
        got = tmx.nd.invoke(op, *targs, **kw)
    return got, want


def test_int8_matmul_is_exact():
    rng = np.random.RandomState(0)
    a, b = _q(rng, 5, 147), _q(rng, 9, 147)
    got = tops.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


@pytest.mark.parametrize("calib", [None, (-1.5, 2.5)])
def test_quantize_v2_and_dequantize(calib):
    x = np.random.RandomState(1).randn(4, 7).astype(np.float32)
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])
    got, want = _both("quantize_v2", x, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
        assert str(g.dtype) == str(w.dtype)
    rng = got[1].asnumpy(), got[2].asnumpy()
    dq, jdq = _both("dequantize", got[0].asnumpy(), rng[0], rng[1])
    _close(dq, jdq)


@pytest.mark.parametrize("bias", ["none", "f32", "int8"])
@pytest.mark.parametrize("flatten", [True, False])
def test_quantized_fully_connected(bias, flatten):
    rng = np.random.RandomState(2)
    x = _q(rng, 3, 2, 12)
    w = _q(rng, 6, 24 if flatten else 12)
    b = {"none": None, "f32": rng.randn(6).astype(np.float32),
         "int8": _q(rng, 6)}[bias]
    kw = dict(no_bias=b is None, flatten=flatten)
    if bias == "int8":
        kw.update(min_bias=-0.5, max_bias=0.5)
    got, want = _both("quantized_fully_connected", x, w, b, -2.0, 2.0, -0.3,
                      0.3, **kw)
    _close(got, want)


def test_quantized_matmul():
    rng = np.random.RandomState(3)
    a, b = _q(rng, 2, 5, 16), _q(rng, 16, 8)
    got, want = _both("quantized_matmul", a, b, 0.01, 0.02)
    _close(got, want)


CONV_CASES = {
    "3x3 pad": dict(kernel=(3, 3), pad=(1, 1)),
    "stride 2, no pad": dict(kernel=(3, 3), stride=(2, 2)),
    "dilated": dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2)),
    "7x7 stem, K=147": dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3)),
    "groups 2": dict(kernel=(3, 3), pad=(1, 1), num_group=2),
    "1x1 NHWC bias": dict(kernel=(1, 1), layout="NHWC", no_bias=False),
    "3x3 NHWC stride 2": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                              layout="NHWC"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_quantized_conv(case):
    kw = dict(CONV_CASES[case])
    rng = np.random.RandomState(4)
    nhwc = kw.get("layout") == "NHWC"
    g = kw.get("num_group", 1)
    cin, cout, k = 6, 4, kw["kernel"]
    x = _q(rng, 2, 10, 9, cin) if nhwc else _q(rng, 2, cin, 10, 9)
    w = _q(rng, cout, *k, cin // g) if nhwc else _q(rng, cout, cin // g, *k)
    b = rng.randn(cout).astype(np.float32) if not kw.get("no_bias", True) \
        else None
    kw.setdefault("no_bias", True)
    got, want = _both("quantized_conv", x, w, b, -1.7, 1.7, -0.4, 0.4,
                      num_filter=cout, **kw)
    _close(got, want)


# ---------------------------------------------------------- quantize_net --
def _copy_params(jnet, tnet):
    tmx.gluon.params_from_jax(tnet, {k: v.data().asnumpy() for k, v in
                                     jnet.collect_params().items()})


def _build(mx, make, prefix):
    net = mx.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        make(mx, net)
    return net


def _pair(make, prefix, init_seed=0):
    jmx.random.seed(init_seed)
    jnet = _build(jmx, make, prefix)
    jnet.initialize(jmx.init.Xavier())
    with tmx.cpu():
        tnet = _build(tmx, make, prefix)
        tnet.initialize(ctx=tmx.cpu())
    return jnet, tnet


def _walk(b, out):
    out.append(b)
    for c in b._children.values():
        _walk(c, out)
    return out


def _same_int8_weights(jnet, tnet):
    jl = [b for b in _walk(jnet, []) if hasattr(b, "_wq")]
    tl = [b for b in _walk(tnet, []) if hasattr(b, "_wq")]
    assert [type(b).__name__ for b in jl] == [type(b).__name__ for b in tl]
    assert jl
    for j, t in zip(jl, tl):
        np.testing.assert_array_equal(t._wq.cpu().numpy(), j._wq)
        assert t._wmax == j._wmax and t._amax == pytest.approx(j._amax,
                                                                rel=1e-6)


def _conv_dense(mx, net):
    net.add(mx.gluon.nn.Conv2D(8, 3, padding=1, in_channels=3,
                               activation="relu"),
            mx.gluon.nn.GlobalAvgPool2D(), mx.gluon.nn.Flatten(),
            mx.gluon.nn.Dense(5, in_units=8))


def test_quantize_net_calibrated():
    """``test_quantize_net_calibrated`` on both packages."""
    jnet, tnet = _pair(_conv_dense, "qa_")
    _copy_params(jnet, tnet)
    rng = np.random.RandomState(1)
    calib = [rng.randn(4, 3, 12, 12).astype(np.float32) for _ in range(3)]
    test = rng.randn(16, 3, 12, 12).astype(np.float32)
    ref = jnet(jmx.nd.array(test)).asnumpy()
    jq.quantize_net(jnet, calib_data=calib)
    with tmx.cpu():
        tq.quantize_net(tnet, calib_data=calib)
        got = tnet(tmx.nd.array(test)).asnumpy()
    kinds = [type(c).__name__ for c in tnet._children.values()]
    assert "QuantizedConv2D" in kinds and "QuantizedDense" in kinds
    _same_int8_weights(jnet, tnet)
    _close(got, jnet(jmx.nd.array(test)).asnumpy(), rel=1e-5)
    assert (got.argmax(1) == ref.argmax(1)).mean() >= 0.8
    assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9) < 0.2


def _dilated(mx, net):
    net.add(mx.gluon.nn.Conv2D(8, 3, padding=2, dilation=2, in_channels=3),
            mx.gluon.nn.GlobalAvgPool2D(), mx.gluon.nn.Flatten(),
            mx.gluon.nn.Dense(6, in_units=8, activation="relu"))


def test_quantize_net_dense_activation_and_dilated_conv():
    jnet, tnet = _pair(_dilated, "qb_")
    _copy_params(jnet, tnet)
    rng = np.random.RandomState(2)
    calib = [rng.randn(4, 3, 12, 12).astype(np.float32) for _ in range(3)]
    test = rng.randn(8, 3, 12, 12).astype(np.float32)
    ref = jnet(jmx.nd.array(test)).asnumpy()
    jq.quantize_net(jnet, calib_data=calib)
    with tmx.cpu():
        tq.quantize_net(tnet, calib_data=calib)
        got = tnet(tmx.nd.array(test)).asnumpy()
    _same_int8_weights(jnet, tnet)
    assert got.shape == ref.shape and (got >= 0).all()
    _close(got, jnet(jmx.nd.array(test)).asnumpy(), rel=1e-5)
    assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9) < 0.25


def _one_dense(mx, net):
    net.add(mx.gluon.nn.Dense(4, in_units=6))


def test_quantize_net_on_hybridized_net():
    """After hybridize() and a forward, the quantized net runs the new
    layers (hybridized again), not the old float graph."""
    jnet, tnet = _pair(_one_dense, "qc_")
    _copy_params(jnet, tnet)
    rng = np.random.RandomState(3)
    x = rng.randn(5, 6).astype(np.float32)
    calib = [rng.randn(4, 6).astype(np.float32) for _ in range(2)]
    jnet.hybridize()
    jnet(jmx.nd.array(x))
    jq.quantize_net(jnet, calib_data=calib)
    with tmx.cpu():
        tnet.hybridize()
        tnet(tmx.nd.array(x))
        tq.quantize_net(tnet, calib_data=calib)
        assert [type(c).__name__ for c in tnet._children.values()] == \
            ["QuantizedDense"]
        assert tnet._active
        got = tnet(tmx.nd.array(x)).asnumpy()
        q = next(iter(tnet._children.values()))
        manual = q.forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, manual, atol=1e-6)
    _same_int8_weights(jnet, tnet)
    _close(got, jnet(jmx.nd.array(x)).asnumpy(), rel=1e-5)


def test_quantize_net_survives_calibration_failure():
    _, tnet = _pair(_one_dense, "qd_")
    with tmx.cpu():
        tnet.hybridize()
        x = tmx.nd.array(np.ones((2, 6), np.float32))
        tnet(x)
        with pytest.raises(Exception):
            tq.quantize_net(tnet, calib_data=[np.ones((2, 3), np.float32)])
        assert [type(c).__name__ for c in tnet._children.values()] == \
            ["Dense"]
        assert tnet._active
        assert tnet(x).shape == (2, 4)


def test_int8_weights_live_on_the_layer_device():
    _, tnet = _pair(_one_dense, "qe_")
    with tmx.cpu():
        tq.quantize_net(tnet, calib_data=[np.ones((2, 6), np.float32)])
    q = next(iter(tnet._children.values()))
    assert isinstance(q._wq, torch.Tensor) and q._wq.dtype == torch.int8
    assert q._wq.device.type == "cpu"
    assert isinstance(q._bias, torch.Tensor)
