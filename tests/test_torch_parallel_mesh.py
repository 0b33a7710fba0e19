"""Port parity: ``parallel.make_mesh``, ``validate_specs``, the sharding
rules and the quantizers against the JAX package's, on the CPU.

- ``make_mesh``: the axis order, ``-1`` inference and every error, word
  for word, for the same sizes over the same number of devices (the
  port's devices are ranks: ``devices=range(n)``); ``validate_specs``'s
  error text;
- ``ShardingRules.spec_for`` (``tp_dense_rules``, ``causal_lm_tp_rules``,
  ``fsdp_rules``, a default), ``param_sharding`` and ``batch_spec``: the
  same specs for the same names, shapes and axis sizes;
- ``quantize_chunked``/``dequantize_chunked`` and ``cast_bf16`` with
  nearest rounding bit for bit, a NaN chunk keeping its NaN scale, the
  stochastic forms unbiased within a few standard errors, and
  ``reduce_gradients``/``all_reduce_activations`` in a world of one;
- ``shard_map``, ``MeshScope`` and ``default_mesh`` in a world of one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import parallel as jparallel
from mxnet_tpu.parallel import quantize as jq
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.parallel import quantize as tq
from mxnet_tpu_torch.parallel.mesh import PartitionSpec

SIZES = [dict(dp=8), dict(dp=2, tp=4), dict(tp=4, dp=-1),
         dict(sp=2, pp=2, dp=2), dict(ep=2, fsdp=2, custom=2),
         dict(dp=-1, tp=-1), dict(dp=3), dict(tp=3, dp=-1), dict(dp=16),
         dict()]


def _both(fn_j, fn_t):
    out = []
    for fn in (fn_j, fn_t):
        try:
            out.append(("ok", fn()))
        except Exception as exc:   # noqa: BLE001 — the error is the result
            out.append((type(exc).__name__, str(exc)))
    return out


@pytest.mark.parametrize("sizes", SIZES, ids=str)
def test_make_mesh_matches_jax(sizes):
    (jk, jv), (tk, tv) = _both(
        lambda: jparallel.make_mesh(devices=jax.devices()[:8], **sizes),
        lambda: parallel.make_mesh(devices=range(8), **sizes))
    assert jk == tk
    if jk == "ok":
        assert tuple(jv.axis_names) == tv.axis_names
        assert dict(jv.shape) == dict(tv.shape)
        assert [d.id for d in jv.devices.flat] == list(tv.devices.flat)
    else:
        assert jv == tv


def test_make_mesh_axes_dict_and_default():
    m = parallel.make_mesh({"tp": 2}, devices=range(4), dp=-1)
    assert m.axis_names == ("dp", "tp") and dict(m.shape) == {"dp": 2,
                                                             "tp": 2}
    one = parallel.make_mesh()
    assert dict(one.shape) == {"dp": 1}
    assert parallel.default_mesh().axis_names == ("dp",)
    with parallel.MeshScope(m):
        assert parallel.current_mesh() is m
        assert parallel.default_mesh() is m
    assert parallel.current_mesh() is None


@pytest.mark.parametrize("specs", [
    (PartitionSpec("dp"), PartitionSpec()),
    (PartitionSpec(("dp", "tq")), None),
    (None, (PartitionSpec(None, "xx"),)),
    ((PartitionSpec("tp"), PartitionSpec("dp", None)), PartitionSpec("tp")),
])
def test_validate_specs_matches_jax(specs):
    from jax.sharding import PartitionSpec as P

    def to_jax(s):
        if isinstance(s, PartitionSpec):
            return P(*s)
        if isinstance(s, tuple):
            return tuple(to_jax(x) for x in s)
        return s
    jm = jparallel.make_mesh(dp=2, tp=4, devices=jax.devices()[:8])
    tm = parallel.make_mesh(dp=2, tp=4, devices=range(8))
    (jk, jv), (tk, tv) = _both(
        lambda: jparallel.validate_specs(jm, to_jax(specs[0]),
                                         to_jax(specs[1])),
        lambda: parallel.validate_specs(tm, *specs))
    assert (jk, jv) == (tk, tv)


NAMES_SHAPES = [
    ("bert0_query_weight", (64, 32)), ("bert0_query_bias", (64,)),
    ("bert0_proj_weight", (32, 64)), ("bert0_query_weight", (63, 32)),
    ("bert0_word_embedding_weight", (100, 32)),
    ("resnet_conv0_weight", (64, 3, 7, 7)), ("net_ffn1_weight", (128, 32)),
    ("net_ffn_2_weight", (32, 128)), ("net_dense0_bias", (10,)),
    ("wqkv", (2, 32, 96)), ("bqkv", (2, 96)), ("wo", (2, 32, 32)),
    ("w1", (2, 32, 64)), ("b1", (2, 64)), ("w2", (2, 64, 32)),
    ("b2", (2, 32)), ("scalar", ()), ("odd", (7, 5)),
]
MESHES = [dict(dp=8), dict(dp=2, tp=4), dict(dp=2, fsdp=4),
          dict(fsdp=2, tp=2, dp=2), dict(tp=8)]


def _rules(pkg):
    return {"tp_dense": pkg.tp_dense_rules(),
            "causal_lm": pkg.causal_lm_tp_rules(),
            "fsdp": pkg.fsdp_rules(),
            "default": pkg.ShardingRules(
                rules=[(r"bias$", (None,))], default=("fsdp", None)),
            "sum": pkg.tp_dense_rules() + pkg.fsdp_rules(),
            "empty": pkg.ShardingRules()}


@pytest.mark.parametrize("sizes", MESHES, ids=str)
@pytest.mark.parametrize("rules", sorted(_rules(parallel)))
def test_spec_for_and_param_sharding_match_jax(sizes, rules):
    jm = jparallel.make_mesh(devices=jax.devices()[:8], **sizes)
    tm = parallel.make_mesh(devices=range(8), **sizes)
    jr, tr = _rules(jparallel)[rules], _rules(parallel)[rules]
    for name, shape in NAMES_SHAPES:
        assert tuple(tr.spec_for(name, shape, tm)) == \
            tuple(jr.spec_for(name, shape, jm)), (name, shape)
    names = [n for n, _ in NAMES_SHAPES]
    shapes = [s for _, s in NAMES_SHAPES]
    js = jparallel.param_sharding(names, shapes, jm, jr)
    ts = parallel.param_sharding(names, shapes, tm, tr)
    assert [tuple(s.spec) for s in ts] == [tuple(s.spec) for s in js]
    assert all(s.mesh is tm for s in ts)


@pytest.mark.parametrize("sizes", MESHES + [dict(pp=8)], ids=str)
def test_batch_spec_matches_jax(sizes):
    jm = jparallel.make_mesh(devices=jax.devices()[:8], **sizes)
    tm = parallel.make_mesh(devices=range(8), **sizes)
    for extra in (("dp", "fsdp"), ("dp",), ("fsdp", "dp"), ("tp",)):
        assert tuple(parallel.batch_spec(tm, extra)) == \
            tuple(jparallel.batch_spec(jm, extra))


# ------------------------------------------------------------ quantize --
def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)) \
        .astype(np.float32)


@pytest.mark.parametrize("shape,chunk", [((1000,), 256), ((3, 37), 16),
                                         ((4, 300), 256), ((5,), 256),
                                         ((2, 8, 64), 64)])
def test_quantize_nearest_bit_for_bit(shape, chunk):
    x = _x(shape, seed=len(shape), scale=3.0)
    x.reshape(-1)[0] = 0.0
    jqv, jsv = jq.quantize_chunked(jnp.asarray(x), chunk)
    tqv, tsv = tq.quantize_chunked(torch.from_numpy(x), chunk)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))
    length = shape[-1]
    np.testing.assert_array_equal(
        tq.dequantize_chunked(tqv, tsv, length).numpy(),
        np.asarray(jq.dequantize_chunked(jqv, jsv, length)))


def test_quantize_zero_chunk_and_nan_scale():
    x = np.zeros((2, 512), np.float32)
    x[1, 300] = np.nan
    x[1, 10] = 5.0
    q, s = tq.quantize_chunked(torch.from_numpy(x), 256)
    js = np.asarray(jq.quantize_chunked(jnp.asarray(x), 256)[1])
    assert s[0].tolist() == [1.0, 1.0]            # zero chunks: scale 1
    assert np.isnan(s[1, 1].item()) and np.isnan(js[1, 1])
    assert s[1, 0].item() == js[1, 0]
    out = tq.dequantize_chunked(q, s, 512)
    assert torch.isnan(out[1, 256:]).all() and torch.isfinite(out[1, :256]).all()


def test_cast_bf16_nearest_and_stochastic():
    x = _x((4096,), seed=3)
    want = np.asarray(jq.cast_bf16(jnp.asarray(x)).astype(jnp.float32))
    got = tq.cast_bf16(torch.from_numpy(x)).float().numpy()
    np.testing.assert_array_equal(got, want)
    # stochastic: exact values stay put, the mean of many draws is x
    gen = torch.Generator().manual_seed(0)
    exact = torch.tensor([1.0, -2.5, 0.0, 3.0])
    assert torch.equal(tq.cast_bf16(exact, gen).float(), exact)
    v = torch.full((200_000,), 1.0 + 2.0 ** -10)
    draws = tq.cast_bf16(v, gen).float()
    assert set(draws.unique().tolist()) == {1.0, 1.0078125}
    assert abs(draws.mean().item() - v[0].item()) < 5e-5
    neg = tq.cast_bf16(-v, gen).float()
    assert abs(neg.mean().item() + v[0].item()) < 5e-5


def test_stochastic_quantize_is_unbiased():
    x = torch.from_numpy(_x((64, 256), seed=4))
    gen = torch.Generator().manual_seed(1)
    acc = torch.zeros_like(x)
    for _ in range(200):
        q, s = tq.quantize_chunked(x, 256, gen)
        acc += tq.dequantize_chunked(q, s, 256)
    scale = x.abs().amax(dim=1, keepdim=True) / 127
    err = (acc / 200 - x).abs() / scale
    assert err.mean().item() < 0.05       # nearest would be ~0.25


@pytest.mark.parametrize("mode", ("f32", "bf16", "int8"))
def test_reduce_gradients_world_of_one(mode):
    leaves = [_x((37,), 1), _x((5, 70), 2)]
    tm = parallel.make_mesh()
    with parallel.MeshScope(tm):
        got = tq.reduce_gradients([torch.from_numpy(x) for x in leaves],
                                  "dp", 1, mode=mode)
    jm = jparallel.make_mesh(dp=1, devices=jax.devices()[:1])
    from jax.sharding import PartitionSpec as P
    f = jax.jit(jparallel.shard_map(
        lambda *ls: tuple(jq.reduce_gradients(list(ls), "dp", 1,
                                              mode=mode)),
        mesh=jm, in_specs=(P(), P()), out_specs=(P(), P()),
        check_vma=False))
    want = f(*[jnp.asarray(x) for x in leaves])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="mode"):
        tq.reduce_gradients([torch.zeros(3)], "dp", 1, mode="fp8")
    with pytest.raises(ValueError, match="reduce"):
        tq.reduce_gradients([torch.zeros(3)], "dp", 1, reduce="max")


def test_all_reduce_activations_world_of_one():
    x = torch.from_numpy(_x((6, 37), 5))
    with parallel.MeshScope(parallel.make_mesh(tp=1)):
        assert torch.equal(tq.all_reduce_activations(x, "tp", 1, "f32"), x)
        q8 = tq.all_reduce_activations(x, "tp", 1, "int8")
    jm = jparallel.make_mesh(tp=1, devices=jax.devices()[:1])
    from jax.sharding import PartitionSpec as P
    f = jax.jit(jparallel.shard_map(
        lambda a: jq.all_reduce_activations(a, "tp", 1, "int8"), mesh=jm,
        in_specs=P(), out_specs=P(), check_vma=False))
    np.testing.assert_array_equal(q8.numpy(),
                                  np.asarray(f(jnp.asarray(x.numpy()))))
    with pytest.raises(ValueError, match="mode"):
        tq.all_reduce_activations(x, "tp", 1, "bf16")


def test_shard_map_runs_on_the_local_shard():
    mesh = parallel.make_mesh()
    calls = []

    def body(x):
        calls.append(parallel.current_mesh())
        return parallel.mesh.psum(x, "dp"), parallel.mesh.axis_index("dp")
    f = parallel.shard_map(body, mesh=mesh, in_specs=PartitionSpec("dp"),
                           out_specs=(PartitionSpec(), PartitionSpec()))
    out, idx = f(torch.arange(4.0))
    assert torch.equal(out, torch.arange(4.0)) and idx == 0
    assert calls == [mesh]
    with pytest.raises(ValueError, match="names axis 'xp'"):
        parallel.shard_map(body, mesh=mesh, in_specs=PartitionSpec("xp"))
    curried = parallel.shard_map(mesh=mesh, in_specs=PartitionSpec("dp"),
                                 out_specs=PartitionSpec())
    assert torch.equal(curried(lambda x: x * 2)(torch.ones(2)),
                       torch.full((2,), 2.0))
    with pytest.raises(RuntimeError, match="outside"):
        parallel.mesh.psum(torch.ones(1), "dp")


def test_device_prefetcher_sharding_and_transfer_hooks_match_jax():
    """``DevicePrefetcher(sharding=...)`` places each batch as the rank's
    shard (a world of one: the whole batch) and calls the transfer hooks
    once per leaf it copies, as the JAX feed does for its mesh."""
    import mxnet_tpu_torch as tmx
    from jax.sharding import NamedSharding, PartitionSpec as P
    src = [(np.full((4, 3), i, np.float32), np.arange(4, dtype=np.int32))
           for i in range(3)]
    jmesh = jparallel.make_mesh(dp=1, devices=jax.devices()[:1])
    tmesh = parallel.make_mesh()
    out = {}
    for name, pkg, sharding in (
            ("jax", jparallel, NamedSharding(jmesh, P("dp"))),
            ("port", parallel, parallel.named_sharding(tmesh, "dp"))):
        seen = []
        hook = pkg.add_transfer_hook(lambda leaf, sh: seen.append(sh))
        try:
            with pkg.DevicePrefetcher(src, sharding=sharding) as feed:
                got = [tuple(np.asarray(getattr(x, "asnumpy", lambda: x)())
                             for x in b) for b in feed]
        finally:
            pkg.remove_transfer_hook(hook)
        out[name] = got, len(seen), all(s is sharding for s in seen)
    assert out["port"][1:] == out["jax"][1:] == (6, True)
    for (ta, tb), (ja, jb) in zip(out["port"][0], out["jax"][0]):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
    with tmx.cpu():
        step = parallel.TrainStep(tmx.gluon.nn.Dense(2, in_units=3),
                                  tmx.gluon.loss.L2Loss(),
                                  tmx.optimizer.create("sgd"))
    assert step.data_sharding.mesh is step.mesh
    assert tuple(step.data_sharding.spec) == ()
