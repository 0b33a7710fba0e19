"""``mx.nd`` of the port against the JAX package's: creation and dtypes,
arithmetic with scalars and broadcasting, indexing and ``__setitem__``,
``out=``, ``save``/``load`` across the two packages (float32 and
bfloat16), contexts, and ``nd.FusedNormReluConv`` on the card.

The port runs on the CPU here (``with mx.cpu():`` or ``ctx=mx.cpu()``);
tolerances: float32 rtol/atol 1e-5/1e-6 (elementwise), bfloat16 1e-2.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.ops import fused_conv

gpu = pytest.mark.gpu
CPU = mx.cpu()


def _same(got, want, rtol=1e-5, atol=1e-6):
    got = got.asnumpy() if hasattr(got, "asnumpy") else got
    want = want.asnumpy() if hasattr(want, "asnumpy") else want
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=rtol, atol=atol)


def _pair(a, dtype=None):
    return (nd.array(a, ctx=CPU, dtype=dtype),
            jmx.nd.array(a, dtype=dtype))


# ------------------------------------------------------------- creation --
@pytest.mark.parametrize("source", [
    [[1, 2], [3, 4]], np.arange(6, dtype=np.float64).reshape(2, 3),
    np.arange(6, dtype=np.int64).reshape(3, 2), np.float32(2.5),
    np.array([1, 0, 1], np.uint8)], ids=["list", "f64", "i64", "scalar",
                                         "u8"])
def test_array_dtype_rules(source):
    """Lists are float32, float64 numpy float32, int64 int32 (JAX without
    64-bit types), other dtypes kept."""
    t, j = _pair(source)
    _same(t, j)
    assert t.context == CPU


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16",
                                   "int32", "uint8", "int64"])
def test_creation_functions(dtype):
    with mx.cpu():
        ours = [nd.zeros((2, 3), dtype=dtype), nd.ones((2, 3), dtype=dtype),
                nd.full((2,), 7, dtype=dtype), nd.empty((2, 2), dtype=dtype)]
    theirs = [jmx.nd.zeros((2, 3), dtype=dtype),
              jmx.nd.ones((2, 3), dtype=dtype),
              jmx.nd.full((2,), 7, dtype=dtype),
              jmx.nd.empty((2, 2), dtype=dtype)]
    for t, j in zip(ours[:3], theirs[:3]):
        _same(t, j)
    assert ours[3].dtype == theirs[3].dtype and ours[3].shape == (2, 2)


def test_ranges_and_eye():
    with mx.cpu():
        _same(nd.arange(1, 7, 1.5, repeat=2), jmx.nd.arange(1, 7, 1.5,
                                                            repeat=2))
        _same(nd.arange(5), jmx.nd.arange(5))
        _same(nd.linspace(0, 1, 7), jmx.nd.linspace(0, 1, 7))
        _same(nd.linspace(-2, 3, 5, endpoint=False),
              jmx.nd.linspace(-2, 3, 5, endpoint=False))
        _same(nd.eye(3, 4, 1), jmx.nd.eye(3, 4, 1))
        _same(nd.zeros_like(nd.ones((2, 2))), jmx.nd.zeros((2, 2)))


def test_array_copies_its_source():
    src = np.arange(4, dtype=np.float32)
    t = nd.array(src, ctx=CPU)
    u = nd.array(t, ctx=CPU)
    src[0] = 9
    t[1] = 7
    assert t.asnumpy()[0] == 0 and u.asnumpy()[1] == 1


# ----------------------------------------------------------- arithmetic --
_OPS = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
        "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
        "pow": lambda a, b: a ** b, "mod": lambda a, b: a % b,
        "gt": lambda a, b: a > b, "le": lambda a, b: a <= b,
        "eq": lambda a, b: a == b, "ne": lambda a, b: a != b}


@pytest.mark.parametrize("op,kind", [
    (op, kind) for op in sorted(_OPS)
    for kind in ("broadcast", "scalar_right", "scalar_left",
                 "int_float_scalar", "int_int")
    if (op, kind) != ("mod", "scalar_left")])   # neither has __rmod__
def test_operator_dtypes_and_values(op, kind):
    """``x op y`` for arrays that broadcast, a Python scalar on either
    side, and integer arrays: the JAX package's values and dtypes (its
    weak typing of Python scalars)."""
    rng = np.random.RandomState(3)
    a = rng.uniform(0.5, 2, (3, 4)).astype(np.float32)
    b = rng.uniform(0.5, 2, (1, 4)).astype(np.float32)
    ia = rng.randint(1, 5, (3, 4)).astype(np.int32)
    ib = rng.randint(1, 5, (1, 4)).astype(np.int32)
    f = _OPS[op]
    if kind == "broadcast":
        (ta, ja), (tb, jb) = _pair(a), _pair(b)
        _same(f(ta, tb), f(ja, jb))
    elif kind == "scalar_right":
        (ta, ja) = _pair(a)
        _same(f(ta, 1.5), f(ja, 1.5))
    elif kind == "scalar_left":
        (ta, ja) = _pair(a)
        _same(f(1.5, ta), f(1.5, ja))
    elif kind == "int_float_scalar":
        (ta, ja) = _pair(ia)
        _same(f(ta, 2.5), f(ja, 2.5))
    else:
        (ta, ja), (tb, jb) = _pair(ia), _pair(ib)
        _same(f(ta, tb), f(ja, jb))


def test_inplace_ops_rebind():
    """``+=`` and friends give the array a new tensor: an earlier view
    keeps the old values (the JAX package's semantics; in MXNet the view
    would see the write)."""
    (t, j) = _pair([1.0, 2.0, 3.0, 4.0])
    tv, jv = t.reshape((2, 2)), j.reshape((2, 2))
    t += 1
    j += 1
    t *= 2
    j *= 2
    t -= 0.5
    j -= 0.5
    t /= 4
    j /= 4
    _same(t, j)
    _same(tv, jv)
    np.testing.assert_array_equal(tv.asnumpy().ravel(), [1, 2, 3, 4])


def test_methods_match_jax():
    rng = np.random.RandomState(5)
    a = rng.uniform(-2, 2, (2, 3, 4)).astype(np.float32)
    t, j = _pair(a)
    for f in (lambda x: x.sum(axis=1), lambda x: x.mean(),
              lambda x: x.max(axis=(0, 2), keepdims=True),
              lambda x: x.min(axis=0), lambda x: x.argmax(axis=2),
              lambda x: x.norm(axis=1), lambda x: x.T,
              lambda x: x.transpose((1, 0, 2)), lambda x: x.flatten(),
              lambda x: x.reshape((-3, 0)), lambda x: x.expand_dims(1),
              lambda x: x.clip(-1, 1), lambda x: x.softmax(),
              lambda x: x.log_softmax(axis=0), lambda x: x.abs().sqrt(),
              lambda x: x.topk(k=2), lambda x: x.sort(is_ascend=False),
              lambda x: x.tile((1, 2, 1)), lambda x: x.astype("int32"),
              lambda x: x.slice_axis(2, 1, 3), lambda x: x.flip(1),
              lambda x: x.swapaxes(0, 2), lambda x: x.zeros_like(),
              lambda x: x.split(2, axis=2)[1], lambda x: -x,
              lambda x: x.reshape((6, 4)).dot(x.reshape((4, 6)))):
        _same(f(t), f(j), rtol=1e-4, atol=1e-5)
    assert t.size == 24 and t.ndim == 3 and len(t) == 2
    assert float(t[0, 0, 0]) == pytest.approx(float(a[0, 0, 0]))
    with pytest.raises(ValueError, match="ambiguous"):
        bool(t)


# ------------------------------------------------------------- indexing --
def test_getitem_matches_jax():
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    t, j = _pair(a)
    ti, ji = _pair(np.array([1, 0, 1], np.int32))
    for key in (1, (0, 2), (slice(None), 1), (Ellipsis, -1),
                (slice(0, 2), slice(1, None), slice(None, None, 2))):
        _same(t[key], j[key])
    _same(t[ti], j[ji])
    _same(t[1, ti], j[1, ji])
    assert [r.shape for r in t] == [(3, 4), (3, 4)]


def test_setitem_matches_jax():
    a = np.zeros((3, 4), np.float32)
    t, j = _pair(a)
    view = t[0]
    for key, value in ((0, 1.0), ((1, 2), 99.0),
                       ((2, slice(1, 3)), np.array([5, 6], np.float32))):
        t[key] = value
        j[key] = value
    t[(slice(0, 1), slice(None))] = nd.array([[7, 7, 7, 7]], ctx=CPU)
    j[(slice(0, 1), slice(None))] = jmx.nd.array([[7, 7, 7, 7]])
    _same(t, j)
    assert view.asnumpy().sum() == 0       # rebinding: the view is unchanged
    t[:] = 5
    j[:] = 5
    _same(t, j)
    t.attach_grad()
    with autograd.record(), pytest.raises(RuntimeError, match="in-place"):
        t[0] = 1.0


def test_out_argument():
    rng = np.random.RandomState(7)
    a, b = (rng.rand(2, 3).astype(np.float32) for _ in range(2))
    (ta, ja), (tb, jb) = _pair(a), _pair(b)
    to, jo = nd.zeros((2, 3), ctx=CPU), jmx.nd.zeros((2, 3))
    assert nd.add(ta, tb, out=to) is to
    jmx.nd.add(ja, jb, out=jo)
    _same(to, jo)
    nd.relu(ta - 0.5, out=to)
    jmx.nd.relu(ja - 0.5, out=jo)
    _same(to, jo)
    # out= inside record is the array the graph knows
    ta.attach_grad()
    ja.attach_grad()
    with autograd.record():
        nd.square(ta, out=to)
    with jmx.autograd.record():
        jmx.nd.square(ja, out=jo)
    to.backward()
    jo.backward()
    _same(ta.grad, ja.grad)


def test_random_draws():
    with mx.cpu():
        nd.random.seed(3)
        u = nd.random.uniform(-1, 2, shape=(1000,))
        n = nd.random.normal(1.0, 0.5, shape=(2, 500))
        r = nd.random.randint(0, 5, shape=(1000,))
        nd.random.seed(3)
        u2 = nd.random.uniform(-1, 2, shape=(1000,))
    assert u.dtype == np.float32 and r.dtype == np.int32
    un = u.asnumpy()
    assert un.min() >= -1 and un.max() < 2 and abs(un.mean() - 0.5) < 0.15
    assert abs(n.asnumpy().mean() - 1.0) < 0.1
    assert set(np.unique(r.asnumpy())) == set(range(5))
    np.testing.assert_array_equal(un, u2.asnumpy())


def test_linalg_and_contrib_namespaces():
    rng = np.random.RandomState(2)
    a = rng.rand(2, 3, 4).astype(np.float32)
    b = rng.rand(2, 4, 5).astype(np.float32)
    (ta, ja), (tb, jb) = _pair(a), _pair(b)
    _same(nd.linalg.gemm2(ta, tb, alpha=2.0),
          jmx.nd.linalg.gemm2(ja, jb, alpha=2.0), rtol=1e-4, atol=1e-5)
    assert set(n for n in dir(nd.linalg) if not n.startswith("_")) == \
        {"gemm", "gemm2", "potrf", "trsm", "syrk", "extractdiag",
         "sumlogdiag"}
    contrib = {n for n in dir(nd.contrib) if not n.startswith("_")}
    assert contrib == {"div_sqrt_dim", "interleaved_matmul_selfatt_qk",
                       "interleaved_matmul_selfatt_valatt",
                       "multi_head_attention",       # the attention ops
                       "MultiBoxPrior", "MultiBoxTarget",
                       "MultiBoxDetection", "Proposal", "box_iou",
                       "box_nms",                    # the multibox ops
                       "quantize_v2", "dequantize"}  # the int8 ops
    assert contrib <= set(dir(jmx.nd.contrib))
    _same(nd.add_n(ta, ta, ta), jmx.nd.add_n(ja, ja, ja))
    _same(nd.concat(ta, ta, dim=2), jmx.nd.concat(ja, ja, dim=2))
    _same(nd.stack(ta, ta, axis=1), jmx.nd.stack(ja, ja, axis=1))
    with pytest.raises(ValueError, match="unknown operator"):
        nd.invoke("no_such_op", ta)


# ------------------------------------------------------------ save/load --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("layout", ["dict", "list"])
def test_save_load_across_packages(tmp_path, dtype, layout):
    """A file either package writes loads in the port with the same
    values and dtype; the two packages write the same entries (bfloat16
    as its raw two-byte form)."""
    rng = np.random.RandomState(11)
    arrays = [rng.uniform(-3, 3, (3, 4)).astype(np.float32),
              rng.uniform(-3, 3, (5,)).astype(np.float32)]
    tarr = [nd.array(a, ctx=CPU, dtype=dtype) for a in arrays]
    jarr = [jmx.nd.array(a, dtype=dtype) for a in arrays]
    if layout == "dict":
        tarr, jarr = dict(zip("ab", tarr)), dict(zip("ab", jarr))
    tf, jf = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    nd.save(tf, tarr)
    jmx.nd.save(jf, jarr)
    with np.load(tf) as zt, np.load(jf) as zj:
        assert zt.files == zj.files
        for k in zt.files:
            assert zt[k].dtype == zj[k].dtype
            assert zt[k].tobytes() == zj[k].tobytes()
    for f in (tf, jf):
        got = nd.load(f, ctx=CPU)
        want = tarr
        items = zip(got.values(), want.values()) if layout == "dict" \
            else zip(got, want)
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in items:
            _same(g, w, rtol=0, atol=0)
    if dtype != "bfloat16":
        loaded = jmx.nd.load(tf)
        items = zip(loaded.values(), jarr.values()) if layout == "dict" \
            else zip(loaded, jarr)
        for g, w in items:
            _same(g, w, rtol=0, atol=0)


def test_jax_package_cannot_load_bfloat16_files(tmp_path):
    """The reference defect the port does not copy: ``np.savez`` stores
    the JAX package's ``ml_dtypes`` bfloat16 as two-byte raw entries,
    which its own ``nd.load`` rejects; the port reads them as bfloat16
    (``test_save_load_across_packages``)."""
    f = str(tmp_path / "bf16.npz")
    jmx.nd.save(f, {"w": jmx.nd.array([1.5, -2.0], dtype="bfloat16")})
    with pytest.raises(TypeError):
        jmx.nd.load(f)
    got = nd.load(f, ctx=CPU)["w"]
    assert got.dtype == jmx.base.dtype_np("bfloat16")
    np.testing.assert_array_equal(got.asnumpy().astype(np.float32),
                                  [1.5, -2.0])


# ------------------------------------------------------------- contexts --
def test_contexts_and_scopes():
    assert mx.cpu() == torch.device("cpu") and mx.cpu(0) == mx.Context("cpu")
    assert repr(mx.cpu()) == "cpu(0)"
    with mx.cpu() as c:
        assert mx.current_context() == c
        x = nd.ones((2,))
        assert x.context == mx.cpu() and x.ctx == c
    assert mx.resolve_device(mx.cpu()) == torch.device("cpu")
    assert nd.ones((1,), ctx="cpu").as_in_context(mx.cpu()).context == c
    if torch.cuda.is_available():
        return
    assert mx.num_gpus() == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.gpu(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.current_context()
    mx.engine.waitall()
    with mx.engine.bulk(16):
        assert mx.engine.set_bulk_size(16) == 16


def test_package_exports():
    for name in ("nd", "autograd", "gluon", "init", "Context", "gpu", "cpu",
                 "engine", "num_gpus", "gpu_memory_info", "metric",
                 "optimizer", "random", "current_context"):
        assert hasattr(mx, name), name
    assert mx.init.Xavier is mx.initializer.Xavier
    assert mx.gluon.Trainer and mx.gluon.utils.split_and_load
    assert callable(mx.engine.waitall)


# ------------------------------------------------------------- the card --
def _fused_inputs(dev, n, hw, c, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.rand(*shape, generator=gen) * scale + shift)

    return [nd.array(r(n, hw, hw, c, scale=2, shift=-1), ctx=dev,
                     dtype=dtype),
            nd.array(r(3, 3, c, c, scale=0.2, shift=-0.1), ctx=dev,
                     dtype=dtype),
            nd.array(r(c, shift=0.5), ctx=dev),
            nd.array(r(c, scale=0.4, shift=-0.2), ctx=dev),
            nd.zeros((c,), ctx=dev), nd.ones((c,), ctx=dev)]


@gpu
def test_fused_op_through_nd_on_card(monkeypatch):
    """``nd.FusedNormReluConv`` on card arrays, forward and backward
    under ``record()``, goes through the CUDA kernels (launch counts
    1/1/1) and never through a plain version; its results agree with
    the same op on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran for card tensors")

    x, w, g, b, mm, mv = _fused_inputs(mx.gpu(0), 4, 14, 64, "bfloat16")
    host = [nd.array(a, ctx=CPU) for a in (x, w, g, b, mm, mv)]
    with monkeypatch.context() as m:
        m.setattr(fused_conv, "_BODIES", {True: (refuse,) * 3,
                                          False: fused_conv._BODIES[False]})
        m.setattr(fused_conv, "norm_relu_conv_reference", refuse)
        for k in fused_conv.norm_relu_conv.launches:
            fused_conv.norm_relu_conv.launches[k] = 0
        for a in (x, w, g, b):
            a.attach_grad()
        with autograd.record():
            out, new_mm, new_mv = nd.FusedNormReluConv(x, w, g, b, mm, mv)
        out.backward()
        torch.cuda.synchronize()
        assert fused_conv.norm_relu_conv.launches == {"fwd": 1, "dx": 1,
                                                      "dw": 1}
    for a in host[:4]:
        a.attach_grad()
    with autograd.record():
        want = nd.FusedNormReluConv(*host)
    want[0].backward()
    np.testing.assert_allclose(out.astype("float32").asnumpy(),
                               want[0].astype("float32").asnumpy(),
                               rtol=1e-2, atol=5e-2)
    for got, ref in ((new_mm, want[1]), (new_mv, want[2])):
        np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=1e-4,
                                   atol=1e-4)
    for a, h in zip((x, g, b), (host[0], host[2], host[3])):
        scale = np.abs(h.grad.astype("float32").asnumpy()).max()
        np.testing.assert_allclose(a.grad.astype("float32").asnumpy(),
                                   h.grad.astype("float32").asnumpy(),
                                   rtol=2e-2, atol=2e-2 * scale)


@gpu
def test_kernels_launch_from_a_thread_without_cuda_work():
    """A fused-conv launch from a thread that has done no CUDA work (no
    context current on it) runs: the wrappers bind the card's context
    first (the kernels' own runtime would fail the launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import threading

    x, w, g, b, _, _ = _fused_inputs(mx.gpu(0), 2, 8, 64, "bfloat16")
    errors, outs = [], []

    def run():
        try:
            outs.append(fused_conv.norm_relu_conv(x._data, g._data, b._data,
                                                  w._data))
            torch.cuda.synchronize()
        except Exception as exc:        # reported below, in the test
            errors.append(exc)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    want = fused_conv.norm_relu_conv(x._data, g._data, b._data, w._data)
    assert torch.equal(outs[0], want)
