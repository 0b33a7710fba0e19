"""``mxnet_tpu_torch.onnx`` against the JAX package's ``onnx``: the cases
of ``tests/test_onnx.py`` (export, re-import with the port's evaluator,
parity with the block's own forward), and both ways across the
packages — the port's file read by the JAX importer and the JAX
package's file read by the port's — each giving the exporter's
outputs (the tolerance per test).  An op with no translator raises
``NotImplementedError`` naming it, the hand-written kernels' ops among
them.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon, nd


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _roundtrip(net, x_np, tmp_path, atol=1e-4):
    path = str(tmp_path / "m.onnx")
    tmx.onnx.export_model(net, nd.array(x_np), path)
    ref = net(nd.array(x_np)).asnumpy()
    got = tmx.onnx.import_to_function(path)(x_np)[0]
    assert isinstance(got, torch.Tensor)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=1e-4)
    return path, ref


def _mlp(mx, prefix):
    with mx.gluon.nn.HybridSequential(prefix=prefix).name_scope():
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(32, in_units=16, activation="relu"),
                mx.gluon.nn.Dense(10, in_units=32))
    return net


def _convnet(mx, prefix):
    with mx.gluon.nn.HybridSequential(prefix=prefix).name_scope():
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Conv2D(8, 3, padding=1, in_channels=3,
                                   activation="relu"),
                mx.gluon.nn.MaxPool2D(2, 2),
                mx.gluon.nn.Conv2D(16, 3, padding=1, in_channels=8),
                mx.gluon.nn.GlobalAvgPool2D(),
                mx.gluon.nn.Flatten(),
                mx.gluon.nn.Dense(5, in_units=16))
    return net


def test_export_mlp(tmp_path):
    tmx.random.seed(0)
    net = _mlp(tmx, "omlp_")
    net.initialize(tmx.init.Xavier())
    x = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    _roundtrip(net, x, tmp_path)


def test_export_convnet(tmp_path):
    tmx.random.seed(0)
    net = _convnet(tmx, "oconv_")
    net.initialize(tmx.init.Xavier())
    x = np.random.RandomState(1).randn(2, 3, 16, 16).astype(np.float32)
    _roundtrip(net, x, tmp_path)


def test_export_batchnorm_inference(tmp_path):
    tmx.random.seed(0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(4, 3, padding=1, in_channels=3),
            gluon.nn.BatchNorm(in_channels=4),
            gluon.nn.Activation("relu"))
    net.initialize(tmx.init.Xavier())
    with tmx.autograd.record():     # running statistics away from 0 / 1
        net(nd.array(np.random.RandomState(2).randn(8, 3, 8, 8)
                     .astype(np.float32)))
    x = np.random.RandomState(3).randn(2, 3, 8, 8).astype(np.float32)
    _roundtrip(net, x, tmp_path)


def test_export_resnet18(tmp_path):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
    tmx.random.seed(0)
    net = resnet18_v1()
    net.initialize(tmx.init.Xavier())
    x = np.random.RandomState(4).randn(1, 3, 32, 32).astype(np.float32)
    path, ref = _roundtrip(net, x, tmp_path, atol=1e-3)
    got = np.asarray(jmx.onnx.import_to_function(path)(x)[0])
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-4)


def test_export_file_is_parseable(tmp_path):
    net = gluon.nn.Dense(4, in_units=3)
    net.initialize()
    path = str(tmp_path / "m.onnx")
    tmx.onnx.export_model(net, nd.array(np.ones((2, 3), np.float32)), path)
    for pkg in (tmx, jmx):
        nodes, inits, ins, outs = pkg.onnx.parse_model(path)
        assert ins == ["data"] and outs == ["output"]
        assert any(op in ("MatMul", "Gemm") for op, *_ in nodes)
        assert len(inits) >= 2
        assert set(inits) >= {p.name for p in net.collect_params().values()}


def test_export_unsupported_op_message(tmp_path):
    """An op with no translator fails with its name."""
    with pytest.raises(NotImplementedError, match="sort"):
        tmx.onnx.export_function(lambda x: torch.sort(x).values,
                                 (torch.ones(4),), str(tmp_path / "x.onnx"))


def test_reduce_max_uses_axes_attribute(tmp_path):
    """opset 13: ReduceMax carries axes as an attribute, not an input."""
    path = str(tmp_path / "r.onnx")
    x = np.random.RandomState(6).randn(3, 5).astype(np.float32)
    tmx.onnx.export_function(lambda t: torch.amax(t, dim=1), (x,), path)
    nodes, _, _, _ = tmx.onnx.parse_model(path)
    rmax = [n for n in nodes if n[0] == "ReduceMax"]
    assert rmax, [n[0] for n in nodes]
    op, ins, outs, attrs = rmax[0]
    assert len(ins) == 1 and attrs.get("axes") == [1]
    for pkg in (tmx, jmx):
        got = np.asarray(pkg.onnx.import_to_function(path)(x)[0])
        np.testing.assert_allclose(got, x.max(1), atol=1e-6)


def test_export_function_plain(tmp_path):
    path = str(tmp_path / "f.onnx")
    x = np.random.RandomState(5).randn(3, 4).astype(np.float32)
    tmx.onnx.export_function(
        lambda t: torch.tanh(t) * 2.0 + t.sum(dim=1, keepdim=True), (x,),
        path)
    want = np.tanh(x) * 2 + x.sum(1, keepdims=True)
    for pkg in (tmx, jmx):
        got = np.asarray(pkg.onnx.import_to_function(path)(x)[0])
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_import_handles_omitted_optional_inputs(tmp_path):
    """An empty input name (ONNX's omitted optional input) keeps the later
    inputs in position: Clip(x, '', max) clips from above only."""
    from mxnet_tpu_torch.onnx import proto
    from mxnet_tpu_torch.onnx.export import _node, _tensor, _value_info
    nodes = proto.field_bytes(1, _node(
        "Clip", ["data", "", "himax"], ["output"], "clip0", {}))
    graph = (nodes + proto.field_str(2, "t")
             + proto.field_bytes(5, _tensor("himax",
                                            np.asarray(2.0, np.float32)))
             + proto.field_bytes(11, _value_info("data", (4,),
                                                 torch.float32))
             + proto.field_bytes(12, _value_info("output", (4,),
                                                 torch.float32)))
    model = (proto.field_varint(1, 8) + proto.field_bytes(7, graph)
             + proto.field_bytes(8, proto.field_str(1, "")
                                 + proto.field_varint(2, 13)))
    p = str(tmp_path / "clip.onnx")
    with open(p, "wb") as f:
        f.write(model)
    x = np.array([-5.0, 0.5, 3.0, 10.0], np.float32)
    for pkg in (tmx, jmx):
        got = np.asarray(pkg.onnx.import_to_function(p)(x)[0])
        np.testing.assert_allclose(got, np.minimum(x, 2.0))


def test_export_bfloat16_roundtrip(tmp_path):
    """A bf16 net exports bf16 initializers (ONNX dtype 16); both
    importers read them back (3e-2, bf16's precision)."""
    import ml_dtypes
    tmx.random.seed(0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(8, in_units=4, activation="relu"),
            gluon.nn.Dense(3, in_units=8))
    net.initialize(tmx.init.Xavier())
    net.cast("bfloat16")
    x = np.random.RandomState(2).randn(2, 4).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    path = str(tmp_path / "bf16.onnx")
    tmx.onnx.export_model(net, xb, path)
    _, inits, _, _ = tmx.onnx.parse_model(path)
    assert all(inits[p.name].dtype == torch.bfloat16
               for p in net.collect_params().values())
    ref = net(xb).float().numpy()
    got = tmx.onnx.import_to_function(path)(xb)[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=3e-2,
                               rtol=3e-2)
    jgot = np.asarray(jmx.onnx.import_to_function(path)(
        x.astype(ml_dtypes.bfloat16))[0]).astype(np.float32)
    np.testing.assert_allclose(jgot, ref, atol=3e-2, rtol=3e-2)


def test_symbol_to_onnx_roundtrip(tmp_path):
    """Symbol -> SymbolBlock -> ONNX export -> import."""
    sym = tmx.sym
    sym.reset_auto_names()
    d = sym.Variable("data")
    s = sym.FullyConnected(sym.Activation(
        sym.FullyConnected(d, name="fc1", num_hidden=8), act_type="relu"),
        name="fc2", num_hidden=3)
    blk = gluon.SymbolBlock(s, [d])
    blk.initialize()
    x = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    _roundtrip(blk, x, tmp_path)


@pytest.mark.parametrize("make", [_mlp, _convnet], ids=["mlp", "convnet"])
def test_files_cross_the_packages(make, tmp_path):
    """The same network in both packages (the port's parameters copied
    into the JAX block): the port's file read by the JAX importer gives
    the port's forward, the JAX package's file read by the port's
    importer gives the JAX forward (1e-4)."""
    rng = np.random.RandomState(9)
    x = rng.randn(2, 3, 16, 16).astype(np.float32) if make is _convnet \
        else rng.randn(4, 16).astype(np.float32)
    tnet = make(tmx, "cross_")
    jnet = make(jmx, "cross_")
    tnet.initialize(tmx.init.Xavier())
    tnet(nd.array(x))
    jnet.initialize()
    for name, p in tnet.collect_params().items():
        jnet.collect_params()[name].set_data(jmx.nd.array(
            p.data().asnumpy()))
    tpath, jpath = str(tmp_path / "t.onnx"), str(tmp_path / "j.onnx")
    tmx.onnx.export_model(tnet, nd.array(x), tpath)
    jmx.onnx.export_model(jnet, jmx.nd.array(x), jpath)
    tref = tnet(nd.array(x)).asnumpy()
    jref = jnet(jmx.nd.array(x)).asnumpy()
    got_j = np.asarray(jmx.onnx.import_to_function(tpath)(x)[0])
    got_t = tmx.onnx.import_to_function(jpath)(torch.from_numpy(x))[0]
    np.testing.assert_allclose(got_j, tref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_t.numpy(), jref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tref, jref, rtol=1e-4, atol=1e-4)


class _FusedUnit(gluon.HybridBlock):
    """One fused norm-relu-conv call (the hand-written kernel's op)."""

    def hybrid_forward(self, F, x, scale, shift, w):
        return F.norm_relu_conv(x, scale, shift, w)


class _FlashUnit(gluon.HybridBlock):
    def hybrid_forward(self, F, q, k, v):
        return F.flash_attention(q, k, v, heads=2)


def test_hand_written_kernel_ops_raise(tmp_path):
    """The fused-conv and flash kernels' ``mxnet_tpu_torch::`` ops have no
    ONNX form: the export names them (the JAX exporter raises on
    ``pallas_call``)."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 4, 4, 8).astype(np.float32))
    args = (x, torch.ones(8), torch.zeros(8),
            torch.from_numpy(rng.randn(3, 3, 8, 8).astype(np.float32)))
    with pytest.raises(NotImplementedError, match="mxnet_tpu_torch"):
        tmx.onnx.export_function(lambda *a: _FusedUnit()(*a), args,
                                 str(tmp_path / "f.onnx"))
    q = torch.from_numpy(rng.randn(1, 8, 16).astype(np.float32))
    with pytest.raises(NotImplementedError, match="mxnet_tpu_torch"):
        tmx.onnx.export_function(lambda a, b, c: _FlashUnit()(a, b, c),
                                 (q, q, q), str(tmp_path / "a.onnx"))


@pytest.mark.gpu
def test_export_and_import_on_the_card(tmp_path):
    """Exported from card tensors, the imported function runs on the
    card (its initializers copied there) and gives the block's outputs
    (1e-4: both run the same cuBLAS products)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    net = _mlp(tmx, "ogpu_")
    net.initialize(tmx.init.Xavier(), ctx=tmx.gpu())
    x = torch.randn(4, 16, device="cuda")
    path = str(tmp_path / "g.onnx")
    tmx.onnx.export_model(net, x, path)
    got = tmx.onnx.import_to_function(path)(x)[0]
    assert got.is_cuda
    torch.testing.assert_close(got, net(x), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_numpy_inputs_follow_the_context_and_read_nothing_back(tmp_path):
    """Numpy inputs go to ``current_context()``'s card, so the imported
    function runs there; the shape initializers stay on the host, so a
    call on card tensors (once the initializers are there) makes no
    synchronizing copy.  1e-4: the same cuBLAS/cuDNN products."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with tmx.gpu():
        net = _convnet(tmx, "onp_gpu_")
        net.initialize(tmx.init.Xavier(), ctx=tmx.gpu())
        x = np.random.RandomState(13).rand(2, 3, 8, 8).astype(np.float32)
        path = str(tmp_path / "c.onnx")
        tmx.onnx.export_model(net, nd.array(x), path)
        fn = tmx.onnx.import_to_function(path)
        got = fn(x)[0]
        assert got.is_cuda
        xc = torch.from_numpy(x).cuda()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = fn(xc)[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = net(xc)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(again, want, rtol=1e-4, atol=1e-4)


def test_numpy_inputs_use_the_context_device(tmp_path):
    """Under ``with cpu()`` numpy inputs and a call with no inputs at
    all run on the CPU (exact: the same ops).  The shape, axes and pads
    initializers stay host tensors: on ``meta`` tensors, which hold no
    values to read back, the graph still runs to the right shapes."""
    path = str(tmp_path / "r.onnx")
    x = np.random.RandomState(14).randn(2, 3, 4).astype(np.float32)
    tmx.onnx.export_function(
        lambda t: t.reshape(6, 4).sum(dim=0, keepdim=True), (x,), path)
    nodes, inits, _, _ = tmx.onnx.parse_model(path)
    assert any(op == "Reshape" for op, *_ in nodes)
    fn = tmx.onnx.import_to_function(path)
    got = fn(x)[0]
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(
        got.numpy(), torch.from_numpy(x).reshape(6, 4).sum(0, True).numpy())
    assert fn(torch.empty(2, 3, 4, device="meta"))[0].shape == (1, 4)
    const = str(tmp_path / "k.onnx")
    tmx.onnx.export_function(lambda: torch.ones(2, 2) * 3.0, (), const)
    out = tmx.onnx.import_to_function(const)()[0]
    assert out.device.type == "cpu" and float(out.sum()) == 12.0
    net = _convnet(tmx, "onp_meta_")
    net.initialize(tmx.init.Xavier())
    conv = str(tmp_path / "c.onnx")
    xi = np.random.RandomState(15).rand(2, 3, 8, 8).astype(np.float32)
    tmx.onnx.export_model(net, nd.array(xi), conv)
    ops = {op for op, *_ in tmx.onnx.parse_model(conv)[0]}
    assert ops & {"Pad", "Reshape", "Flatten"}, ops
    meta = tmx.onnx.import_to_function(conv)(
        torch.empty(2, 3, 8, 8, device="meta"))[0]
    assert meta.shape == (2, 5)
