"""Int8 serving of the port (``mxnet_tpu_torch.amp.quantize``,
``serving.module_apply(quantize="int8")``, an int8 ``ServingFleet``) on
the CPU: the int8 cases of ``tests/test_quantize.py`` against the port,
plus parity with the JAX package.

- ``quantize_weight`` payloads and scales equal the JAX package's bit
  for bit (round half to even on both sides), for list and dict
  containers of ``Int8Quantizer``, NaN channels (their scale stays NaN)
  and all-zero channels (scale 1);
- the int8 ``module_apply`` is within 5e-3 of the f32 one and of the JAX
  package's int8 ``module_apply``; its graphs are one per padded
  signature (the census of the bucket grid);
- an int8 fleet ingests f32 snapshots through its quantizer and still
  refuses genuine drift.
"""
import numpy as np
import pytest
import torch

try:
    import mxnet_tpu as jmx
    from mxnet_tpu import amp as jamp
except ImportError:          # the card's machine has no JAX
    jmx = jamp = None
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import amp, graphs, serving

pytestmark = pytest.mark.fleet


@pytest.fixture(autouse=True)
def _fresh_scopes():
    if jmx is None:
        with mx.name.NameManager():
            yield
        return
    with jmx.name.NameManager(), mx.name.NameManager(), mx.cpu():
        yield


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _weights(seed=5):
    rng = np.random.RandomState(seed)
    w = rng.randn(16, 8).astype(np.float32)
    w[3] *= 50                                   # one hot channel
    w[5] = 0.0                                   # an all-zero channel
    w[7, 2] = np.nan                             # a NaN channel
    # values exactly half a step from two payloads: round half to even
    w[9] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 127.0, 3.5],
                    np.float32)
    return w


# ------------------------------------------------------- int8 weight PTQ --
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_quantize_weight_matches_jax_bit_for_bit(axis):
    w = _weights()
    q, s = amp.quantize_weight(w, axis=axis)
    jq, js = jamp.quantize_weight(w, axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))
    back = amp.dequantize_weight(q, s, axis=axis).numpy()
    jback = np.asarray(jamp.dequantize_weight(jq, js, axis=axis))
    np.testing.assert_array_equal(_bits(back), _bits(jback))


def test_quantize_weight_nan_and_zero_channels():
    q, s = amp.quantize_weight(_weights(), axis=0)
    assert np.isnan(s[7].item())                 # NaN stays NaN
    assert s[5].item() == 1.0                    # zero channel: exact
    assert (q[5] == 0).all() and (q[7] == 0).all()
    assert not np.isfinite(amp.dequantize_weight(q, s)[7].numpy()).all()


def test_quantize_weight_per_channel_roundtrip():
    rng = np.random.RandomState(5)
    w = rng.randn(16, 8).astype(np.float32)
    w[3] *= 50
    q, s = amp.quantize_weight(w, axis=0)
    assert q.dtype == torch.int8 and tuple(s.shape) == (16,)
    back = amp.dequantize_weight(q, s, axis=0).numpy()
    half = np.abs(w).max(axis=1, keepdims=True) / 127 / 2
    assert np.all(np.abs(back - w) <= half + 1e-7)


def test_quantize_weight_of_a_bfloat16_snapshot_leaf():
    """A two-byte ``V2`` leaf (how snapshots hold bfloat16) quantizes as
    the bfloat16 tensor it stores."""
    t = torch.randn(6, 4).to(torch.bfloat16)
    raw = t.view(torch.int16).numpy().view("V2")
    q, s = amp.quantize_weight(raw, axis=0)
    q2, s2 = amp.quantize_weight(t, axis=0)
    assert torch.equal(q, q2) and torch.equal(s, s2)


@pytest.mark.parametrize("kind", ["list", "dict"])
def test_int8_quantizer_containers_match_jax_bit_for_bit(kind):
    rng = np.random.RandomState(6)
    w1 = rng.randn(6, 16).astype(np.float32)
    w1[:, 3] = np.nan
    w1[:, 4] = 0.0
    leaves = [w1, np.zeros(16, np.float32),
              rng.randn(16, 4).astype(np.float32)]
    params = leaves if kind == "list" else dict(zip("abc", leaves))
    got = amp.Int8Quantizer(axis=1).quantize(params)
    want = jamp.Int8Quantizer(axis=1).quantize(params)
    if kind == "list":
        assert [str(p.dtype) for p in got] == [
            "torch.int8", "torch.float32", "torch.float32", "torch.int8",
            "torch.float32"]
        pairs = list(zip(got, want))
    else:
        assert sorted(got) == sorted(want) == ["a", "a::scale", "b", "c",
                                               "c::scale"]
        pairs = [(got[k], want[k]) for k in sorted(got)]
    for g, w in pairs:
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(np.asarray(w)))


def test_int8_quantizer_list_and_dict_containers():
    rng = np.random.RandomState(6)
    plist = [torch.from_numpy(rng.randn(6, 16).astype(np.float32)),
             torch.zeros(16)]
    quant = amp.Int8Quantizer(axis=1)
    qp = quant.quantize(plist)
    assert [str(p.dtype) for p in qp] == ["torch.int8", "torch.float32",
                                          "torch.float32"]
    back = quant.dequantize(qp)
    assert len(back) == 2
    assert float((back[0] - plist[0]).abs().max()) < 0.05
    pdict = {"w": plist[0], "b": plist[1]}
    qd = quant.quantize(pdict)
    assert sorted(qd) == ["b", "w", "w::scale"]
    assert qd["w"].dtype == torch.int8
    # re-quantizing the quantized container is a loud error, not drift
    with pytest.raises(ValueError, match="already"):
        quant.quantize(qd)
    with pytest.raises(ValueError, match="full-precision"):
        quant.quantize(qp)
    # deterministic: the ingest transform always lands on the same leaves
    qp2 = quant.quantize(plist)
    for a, b in zip(qp, qp2):
        assert torch.equal(a, b)


# ------------------------------------------------- int8 module_apply --
def _bound_modules(batch=8):
    """The same bound module in both packages, the port's parameters
    copied by name from the JAX module's."""
    mods = []
    for pkg in (jmx, mx):
        S = pkg.sym
        data = S.Variable("data")
        fc = S.FullyConnected(data, num_hidden=32, name="fc")
        act = S.Activation(fc, act_type="relu", name="relu")
        fc2 = S.FullyConnected(act, num_hidden=4, name="fc2")
        out = S.SoftmaxOutput(fc2, name="softmax")
        mod = pkg.mod.Module(out, context=pkg.cpu())
        mod.bind([("data", (batch, 6))], [("softmax_label", (batch,))],
                 for_training=False)
        mods.append(mod)
    jmod, tmod = mods
    jmx.random.seed(0)
    jmod.init_params(jmx.init.Xavier(magnitude=2.0))
    arg, aux = jmod.get_params()
    tmod.init_params(arg_params={k: v.asnumpy() for k, v in arg.items()},
                     aux_params={k: v.asnumpy() for k, v in aux.items()})
    return jmod, tmod


def test_int8_module_apply_matches_f32_within_tolerance():
    jmod, mod = _bound_modules()
    f32 = serving.module_apply(mod)
    q8 = serving.module_apply(mod, quantize="int8")
    x = np.random.RandomState(2).randn(8, 6).astype(np.float32)
    a, b = f32(x).numpy(), q8(x).numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=5e-3)
    jb = np.asarray(jmx.serving.module_apply(jmod, quantize="int8")(x))
    np.testing.assert_allclose(b, jb, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="quantize"):
        serving.module_apply(mod, quantize="int4")


def test_int8_module_apply_weight_inputs_are_a_quarter():
    _jmod, mod = _bound_modules()
    q8 = serving.module_apply(mod, quantize="int8")
    args = q8.params["args"]
    assert args["fc_weight"].dtype == torch.int8
    assert args["fc_bias"].dtype == torch.float32
    f32 = sum(a._data.numel() * 4 for n, a in mod._exec.arg_dict.items()
              if n not in ("data", "softmax_label"))
    assert q8.weight_bytes < 0.5 * f32


def test_int8_serving_grid_census_equals_graph_count():
    """Feeding the ENTIRE bucket grid (twice) through an int8 captured
    function sees exactly the census of signatures (on the CPU the
    function runs eagerly: its body counts them)."""
    spec = serving.BucketSpec(batch=(1, 2, 4), length=(8, 16))
    quant = amp.Int8Quantizer(axis=1)
    rng = np.random.RandomState(7)
    params = [rng.randn(32, 64).astype(np.float32) / 8,
              np.zeros(64, np.float32),
              rng.randn(64, 16).astype(np.float32) / 8,
              np.zeros(16, np.float32)]
    qp = quant.quantize(params)
    seen = set()

    def fwd(p, x):
        x = torch.as_tensor(x)
        seen.add((tuple(x.shape), x.dtype))
        return torch.tanh(x @ p[0] + p[1]) @ p[2] + p[3]

    qfn = graphs.captured(quant.wrap(fwd))
    grid = [(b, L) for b in spec.batch for L in spec.length]
    for _ in range(2):
        for b, L in grid:
            out = qfn(qp, np.zeros((b, L, 32), np.float32))
            assert tuple(out.shape) == (b, L, 16)
    assert len(seen) == len(grid) == 6
    assert qfn.graph_count() == 0            # the CPU captures nothing


# ------------------------------------------------ fleet re-quantize ingest --
def _int8_fleet(n=2):
    rng = np.random.RandomState(8)
    params = [rng.randn(6, 16).astype(np.float32) / 4,
              np.zeros(16, np.float32),
              rng.randn(16, 4).astype(np.float32) / 4,
              np.zeros(4, np.float32)]
    quant = amp.Int8Quantizer(axis=1)

    def fwd(p, x):
        x = torch.as_tensor(x)
        return torch.clamp(x @ p[0] + p[1], min=0.0) @ p[2] + p[3]

    qfn = graphs.captured(quant.wrap(fwd))
    fleet = serving.ServingFleet.replicated(
        qfn, quant.quantize(params), n, quantizer=quant.quantize,
        buckets=(1, 2, 4), sample=np.ones((6,), np.float32),
        max_delay=0.002, name="Int8Fleet")
    return fleet, params, quant


def test_f32_snapshot_streams_into_int8_fleet():
    """A rolling update from an f32 training job into an int8 fleet
    re-quantizes through the fleet's quantizer instead of tripping the
    dtype-drift rejection."""
    fleet, params, quant = _int8_fleet()
    with fleet:
        x = np.ones((6,), np.float32)
        before = np.asarray(fleet(x, timeout=5))
        updater = serving.WeightUpdater(fleet)
        new = [p * 2.0 for p in params]          # f32 leaves, f32 count
        assert updater.update(new) == 2
        assert updater.applied == 1
        after = np.asarray(fleet(x, timeout=5))
        # the swap actually landed: outputs track the doubled weights
        assert np.abs(after - before).max() > 1e-3
        ref = [r.numpy() for r in quant.dequantize(quant.quantize(new))]
        want = np.maximum(x @ ref[0] + ref[1], 0.0) @ ref[2] + ref[3]
        np.testing.assert_allclose(after, want, atol=1e-5)
        # served representation is still the quantized one
        assert fleet.replicas[0].apply.params[0].dtype == torch.int8


def test_int8_fleet_still_rejects_genuine_drift():
    fleet, params, _ = _int8_fleet()
    with fleet:
        updater = serving.WeightUpdater(fleet)
        bad_shape = [np.zeros((7, 16), np.float32)] + [
            np.asarray(p) for p in params[1:]]
        with pytest.raises(serving.SnapshotRejectedError):
            updater.update(bad_shape)
        bad_count = [np.asarray(p) for p in params[:-1]]
        with pytest.raises(serving.SnapshotRejectedError):
            updater.update(bad_count)
        assert updater.applied == 0 and updater.skipped == 2
        # fleet still serves the original weights at full capacity
        assert fleet.ready()
        assert np.isfinite(
            np.asarray(fleet(np.ones((6,), np.float32), timeout=5))).all()


def test_dtype_drift_without_quantizer_still_rejects():
    """A fleet WITHOUT a quantizer treats dtype drift as a rejection,
    not something to coerce."""
    rng = np.random.RandomState(9)
    params = [rng.randn(6, 4).astype(np.float32)]
    fn = graphs.captured(lambda p, x: torch.as_tensor(x)
                         @ torch.as_tensor(p[0]))
    fleet = serving.ServingFleet.replicated(
        fn, params, 2, buckets=(1, 2), sample=np.ones((6,), np.float32),
        max_delay=0.002, name="F32Fleet")
    with fleet:
        updater = serving.WeightUpdater(fleet)
        with pytest.raises(serving.SnapshotRejectedError, match="dtype"):
            updater.update([params[0].astype(np.float64)])


# ------------------------------------------------------------- on the card --
@pytest.mark.gpu
def test_card_int8_fleet_shares_graphs_and_takes_f32_snapshots():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    rng = np.random.RandomState(8)
    params = [rng.randn(6, 16).astype(np.float32) / 4,
              np.zeros(16, np.float32)]
    quant = amp.Int8Quantizer(axis=1)

    def fwd(p, x):
        return x @ p[0] + p[1]

    qfn = graphs.captured(quant.wrap(fwd))
    qp = [t.cuda() for t in quant.quantize(params)]
    fleet = serving.ServingFleet.replicated(
        qfn, qp, 2, quantizer=quant.quantize, buckets=(1, 2, 4),
        sample=np.ones((6,), np.float32), max_delay=0.002,
        name="CardInt8Fleet")
    with fleet:
        assert qfn.graph_count() == fleet.grid_census
        serving.WeightUpdater(fleet).update([p * 2.0 for p in params])
        for i in range(24):
            fleet(np.full((6,), float(i), np.float32), timeout=10)
        assert qfn.graph_count() == fleet.grid_census
        assert fleet.replicas[0].apply.params[0].is_cuda
