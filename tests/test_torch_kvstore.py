"""Port parity: ``mx.kv`` (``kvstore.create``, ``KVStore``) and
``gluon.Trainer``'s store paths against the JAX package's, on the CPU.

In one process, every case of ``tests/test_parallel.py``'s kvstore
tests and ``tests/test_sparse.py``'s row_sparse store tests runs through
both packages and the results agree exactly: push/pull aggregation,
``update_on_kvstore`` (string keys with their own update counts), 2-bit
compression with its residual, the pull-count error, ``pushpull``,
``broadcast``, a custom updater, ``row_sparse_pull`` and the lazy
row_sparse server update, the optimizer states saved and loaded, the
Trainer's allreduce, ``update_on_kvstore`` and compression paths (a
sparse-gradient embedding among them), and ``create``'s errors.  The
2-bit wire format (``_pack_2bit``) and its decoded sum
(``_unpack_sum_2bit``) are bit-equal to the JAX functions.

One gang of two gloo ranks (this file as a script through the port's
launcher) runs ``tests/dist_worker.py``'s assertions on the port (dist
init broadcast, push/pull sums, dist ``update_on_kvstore``, the
collective helpers, a data-parallel ``TrainStep`` ending alike on both
ranks, the row_sparse dist push), a compressed dist push over two
rounds (the residual carried) against the JAX functions on the same
per-rank gradients, and a ``Trainer`` on a dist store —
allreduce and ``update_on_kvstore`` — against one JAX process stepping
on the sum of the two ranks' losses.
"""
import os
import sys

import numpy as np
import pytest

ROUNDS = 2
THRESHOLD = 0.4


def trainer_batches():
    rng = np.random.RandomState(21)
    return [(rng.randn(8, 6).astype(np.float32),
             rng.randint(0, 3, (8,)).astype(np.int32)) for _ in range(3)]


def trainer_net(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="tnet_")
    with net.name_scope():
        net.add(nn.Dense(5, activation="relu", in_units=6, prefix="a_"),
                nn.Dense(3, in_units=5, prefix="b_"))
    return net


def set_trainer_params(pkg, net):
    rng = np.random.RandomState(4)
    for _name, p in sorted(net.collect_params().items()):
        p.set_data(pkg.nd.array((0.3 * rng.randn(*p.shape))
                                .astype(np.float32)))


def compressed_grads(rank):
    rng = np.random.RandomState(30 + rank)
    return [rng.randn(7, 5).astype(np.float32) * 0.5 for _ in range(ROUNDS)]


# ------------------------------------------------------------ the worker --
def dist_worker_assertions(mx, n, r):
    """``tests/dist_worker.py``'s checks, on the port."""
    from mxnet_tpu_torch import distributed, gluon, parallel, sparse
    from mxnet_tpu_torch.gluon import nn as gnn

    kv = mx.kv.create("dist_sync")
    assert kv.rank == r and kv.num_workers == n
    kv.init(3, mx.nd.ones((4,)) * (r + 7))
    kv.push(3, mx.nd.ones((4,)) * (r + 1))
    out = mx.nd.zeros((4,))
    kv.pull(3, out=out)
    np.testing.assert_allclose(out.asnumpy(),
                               np.full((4,), n * (n + 1) / 2.0, np.float32))
    kv.init(9, mx.nd.ones((2,)) * (r + 7))
    out9 = mx.nd.zeros((2,))
    kv.pull(9, out=out9)
    np.testing.assert_allclose(out9.asnumpy(), np.full((2,), 7.0))

    kv2 = mx.kv.create("dist_sync_device")
    kv2.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5))
    w0 = np.ones((4,), np.float32)
    kv2.init(0, mx.nd.array(w0))
    kv2.push(0, mx.nd.ones((4,)))
    outw = mx.nd.zeros((4,))
    kv2.pull(0, out=outw)
    np.testing.assert_allclose(outw.asnumpy(), w0 - 0.5 * n)

    s = distributed.all_sum(np.full((3,), float(r + 1), np.float32))
    np.testing.assert_allclose(np.asarray(s),
                               np.full((3,), n * (n + 1) / 2.0))
    b = distributed.broadcast(np.full((2,), float(r), np.float32), root=1)
    np.testing.assert_allclose(np.asarray(b), np.full((2,), 1.0))
    g = distributed.all_gather(np.full((2,), float(r), np.float32))
    np.testing.assert_allclose(np.asarray(g), [[0.0, 0.0], [1.0, 1.0]])
    distributed.barrier()
    distributed.barrier("named", timeout=30)
    import torch
    mesh = parallel.make_mesh(dp=n)
    group = mesh.device_mesh.get_group("dp")      # the DeviceMesh's group
    t = torch.ones(2)
    torch.distributed.all_reduce(t, group=group)
    np.testing.assert_array_equal(t.numpy(), np.full((2,), float(n)))
    assert mesh.coords() == {"dp": r}

    mx.random.seed(42)
    net = gnn.HybridSequential()
    net.add(gnn.Dense(16, activation="relu", in_units=8),
            gnn.Dense(4, in_units=16))
    net.initialize(ctx="cpu")
    step = parallel.TrainStep(
        net, gluon.loss.SoftmaxCrossEntropyLoss(),
        mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9),
        mesh=parallel.make_mesh(dp=n))
    rng = np.random.RandomState(100 + r)
    for _ in range(3):
        loss = step(rng.randn(2, 8).astype(np.float32),
                    rng.randint(0, 4, (2,)).astype(np.int32))
        assert np.isfinite(float(loss))
    step.sync_params_to_net()
    flat = np.concatenate([p.data().asnumpy().ravel()
                           for p in net.collect_params().values()])
    ref = distributed.broadcast(flat, root=0)
    np.testing.assert_array_equal(np.asarray(ref), flat)

    kv3 = mx.kv.create("dist_sync")
    kv3.set_optimizer(mx.optimizer.create("sgd", learning_rate=1.0))
    w0 = np.zeros((n + 2, 3), np.float32)
    kv3.init("emb", mx.nd.array(w0))
    g_rsp = sparse.row_sparse_array(
        (np.full((1, 3), 1.0, np.float32), np.array([r], np.int32)),
        shape=(n + 2, 3))
    kv3.push("emb", g_rsp)
    expect = w0.copy()
    expect[:n] -= 1.0
    np.testing.assert_allclose(kv3.pull("emb").asnumpy(), expect)


def worker(outdir):
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, distributed, gluon

    r, n = distributed.rank(), distributed.num_workers()
    assert n == 2 and distributed.backend() == "gloo"
    res = {}
    with mx.cpu():
        dist_worker_assertions(mx, n, r)
        kv = mx.kv.create("dist_sync")
        kv.set_gradient_compression({"type": "2bit",
                                     "threshold": THRESHOLD})
        kv.init("c", mx.nd.zeros((7, 5)))
        for i, gr in enumerate(compressed_grads(r)):
            kv.push("c", mx.nd.array(gr))
            res[f"compressed/{i}"] = kv.pull("c").asnumpy()
        for label, kw in (("allreduce", {}),
                          ("server", {"update_on_kvstore": True})):
            net = trainer_net(mx)
            net.initialize(ctx="cpu")
            set_trainer_params(mx, net)
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.2, "momentum": 0.9},
                               kvstore="dist_sync_device", **kw)
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            for x, y in trainer_batches():
                x, y = x[r * 4:(r + 1) * 4], y[r * 4:(r + 1) * 4]
                with autograd.record():
                    loss = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
                loss.backward()
                tr.step(4)
            for k, p in net.collect_params().items():
                res[f"trainer/{label}/{k}"] = p.data().asnumpy()
    assert torch.distributed.is_initialized()
    np.savez(os.path.join(outdir, f"rank{r}.npz"), **res)
    print(f"worker {r}/{n} OK", flush=True)


if __name__ == "__main__":
    worker(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------- the JAX side ---
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu.kvstore import kvstore as jkv  # noqa: E402
from mxnet_tpu_torch.kvstore import kvstore as tkv  # noqa: E402
from test_torch_dp_step import (finish_gang, kill_gang,  # noqa: E402
                                start_gang)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(x)


def case_push_pull_aggregate(mx):
    kv = mx.kv.create("device")
    kv.init(3, mx.nd.ones((2, 3)))
    kv.push(3, [mx.nd.ones((2, 3)) * i for i in range(4)])
    out = mx.nd.zeros((2, 3))
    kv.pull(3, out=out)
    return [out]


def case_update_on_kvstore(mx):
    kv = mx.kv.create("device")
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5))
    kv.init(0, mx.nd.array(np.ones((4,), np.float32)))
    kv.push(0, mx.nd.array(np.full((4,), 2.0, np.float32)))
    out = mx.nd.zeros((4,))
    kv.pull(0, out=out)
    return [out]


def case_gradient_compression(mx):
    kv = mx.kv.create("device")
    kv.set_gradient_compression({"type": "2bit", "threshold": 1.0})
    kv.init(0, mx.nd.zeros((4,)))
    outs = []
    for _ in range(3):
        kv.push(0, mx.nd.array(np.array([2.0, 0.3, -1.5, 0.0], np.float32)))
        out = mx.nd.zeros((4,))
        kv.pull(0, out=out)
        outs.append(out)
    return outs + [kv._residuals["0"]]


def case_string_keys_distinct_state(mx):
    kv = mx.kv.create("local")
    opt = mx.optimizer.create("adam", learning_rate=0.1)
    kv.set_optimizer(opt)
    kv.init(["weight", "bias"], [mx.nd.ones((2,)), mx.nd.ones((2,))])
    for _ in range(2):
        kv.push(["weight", "bias"], [mx.nd.ones((2,)), mx.nd.ones((2,))])
    iw, ib = kv._key_index["weight"], kv._key_index["bias"]
    return [np.array([iw, ib, opt._index_update_count[iw],
                      opt._index_update_count[ib]]),
            kv.pull("weight"), kv.pull("bias")]


def case_pull_mismatch_raises(mx):
    kv = mx.kv.create("local")
    kv.init([0, 1, 2], [mx.nd.ones((2,))] * 3)
    try:
        kv.pull([0, 1, 2], out=[mx.nd.zeros((2,)), mx.nd.zeros((2,))])
    except ValueError as exc:
        return [np.array(str(exc))]
    return [np.array("no error")]


def case_pushpull_broadcast_updater(mx):
    kv = mx.kv.create("local")
    kv.init("a", mx.nd.ones((3,)))
    v = mx.nd.array(np.array([1.0, 2.0, 3.0], np.float32))
    kv.pushpull("a", v)
    out = mx.nd.zeros((3,))
    kv.broadcast("b", mx.nd.ones((3,)) * 4, out=out)
    kv2 = mx.kv.create("local")
    seen = []
    kv2._set_updater(lambda k, recv, stored: seen.append(
        (k, recv.asnumpy().copy(), stored.asnumpy().copy())))
    kv2.init(5, mx.nd.ones((2,)))
    kv2.push(5, mx.nd.ones((2,)) * 3)
    multi = [mx.nd.zeros((3,)), mx.nd.zeros((3,))]
    kv.pull("a", out=multi)
    return [v, out, np.array(seen[0][0]), seen[0][1], seen[0][2]] + multi


def case_row_sparse_pull_row_ids(mx):
    kv = mx.kv.create("local")
    w = np.arange(20, dtype=np.float32).reshape(5, 4)
    kv.init("w", mx.nd.array(w))
    out = kv.row_sparse_pull("w", row_ids=mx.nd.array(
        np.array([3, 1, 3], np.int32), dtype="int32"))
    tgt = mx.nd.array(np.full((5, 4), -1.0, np.float32))
    kv.row_sparse_pull("w", out=tgt, row_ids=mx.nd.array(
        np.array([0], np.int32), dtype="int32"))
    return [np.array(out.stype), np.asarray(_np(out.indices)),
            np.asarray(_np(out.data)), tgt]


def case_rsp_push_lazy_server_update(mx):
    kv = mx.kv.create("local")
    w0 = np.ones((6, 3), np.float32)
    kv.init("0", mx.nd.array(w0))
    kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5))
    g = mx.nd.sparse.row_sparse_array(
        (np.full((2, 3), 2.0, np.float32), np.array([1, 4], np.int32)),
        shape=(6, 3))
    kv.push("0", g)
    first = kv.pull("0").asnumpy()
    g2 = mx.nd.sparse.row_sparse_array(
        (np.ones((1, 3), np.float32), np.array([4], np.int32)), shape=(6, 3))
    kv.push("0", [g, g2])
    kv2 = mx.kv.create("local")
    kv2.init("s", mx.nd.array(np.zeros((6, 3), np.float32)))
    kv2.push("s", g)                   # no optimizer: only pushed rows
    return [first, kv.pull("0"), kv2.pull("s")]


def case_save_load_optimizer_states(mx, tmp):
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.create("adam", learning_rate=0.1))
    kv.init(0, mx.nd.ones((3,)))
    kv.push(0, mx.nd.ones((3,)) * 2)
    fname = os.path.join(tmp, f"states-{mx.__name__}")
    kv.save_optimizer_states(fname)
    saved = [s.asnumpy().copy() for s in tkv._flatten(kv._opt_states["0"])] \
        if mx is tmx else [s.asnumpy().copy()
                           for s in jkv._flatten(kv._opt_states["0"])]
    kv.push(0, mx.nd.ones((3,)))
    kv.load_optimizer_states(fname)
    flat = tkv._flatten if mx is tmx else jkv._flatten
    return saved + [s for s in flat(kv._opt_states["0"])]


def case_trainer_store_paths(mx):
    outs = []
    for kw in ({"kvstore": "device"},
               {"kvstore": "device", "update_on_kvstore": True},
               {"kvstore": mx.kv.create("local"), "update_on_kvstore": True,
                "compression_params": {"type": "2bit", "threshold": 0.05}},
               {"kvstore": None}):
        net = trainer_net(mx)
        net.initialize(**({"ctx": "cpu"} if mx is tmx else {}))
        set_trainer_params(mx, net)
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.2, "momentum": 0.9}, **kw)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        for x, y in trainer_batches():
            with mx.autograd.record():
                loss = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
            loss.backward()
            tr.step(8)
        outs += [p.data() for _k, p in
                 sorted(net.collect_params().items())]
    return outs


def case_trainer_sparse_grad_paths(mx):
    emb = mx.gluon.nn.Embedding(10, 3, sparse_grad=True, prefix="emb_")
    emb.initialize(**({"ctx": "cpu"} if mx is tmx else {}))
    emb.weight.set_data(mx.nd.array(
        np.arange(30, dtype=np.float32).reshape(10, 3) / 10))
    x = mx.nd.array(np.array([1, 2], np.int32), dtype="int32")
    tr = mx.gluon.Trainer(emb.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore="device",
                          update_on_kvstore=True)
    with mx.autograd.record():
        loss = (emb(x) ** 2).sum()
    loss.backward()
    tr.step(1)
    after_server = emb.weight.data().asnumpy().copy()
    tr2 = mx.gluon.Trainer(emb.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore="device")
    with mx.autograd.record():
        loss = (emb(x) ** 2).sum()
    loss.backward()
    tr2.allreduce_grads()
    tr2.update(1)
    return [after_server, emb.weight.data()]


CASES = [case_push_pull_aggregate, case_update_on_kvstore,
         case_gradient_compression, case_string_keys_distinct_state,
         case_pull_mismatch_raises, case_pushpull_broadcast_updater,
         case_row_sparse_pull_row_ids, case_rsp_push_lazy_server_update,
         case_trainer_store_paths, case_trainer_sparse_grad_paths]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_case_matches_jax(case):
    want = _np(case(jmx))
    with tmx.cpu():
        got = _np(case(tmx))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.dtype.kind in "fc":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


def test_save_load_optimizer_states_matches_jax(tmp_path):
    want = _np(case_save_load_optimizer_states(jmx, str(tmp_path)))
    with tmx.cpu():
        got = _np(case_save_load_optimizer_states(tmx, str(tmp_path)))
    n = len(want) // 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    for a, b in zip(got[:n], got[n:]):
        np.testing.assert_array_equal(a, b)       # loaded = saved


def test_create_errors_match_jax():
    for name, exc in (("bogus", ValueError), ("horovod", NotImplementedError),
                      ("byteps", NotImplementedError),
                      ("dist_sync", RuntimeError),
                      ("dist_async_device", RuntimeError)):
        with pytest.raises(exc):
            jmx.kv.create(name)
        with pytest.raises(exc):
            tmx.kv.create(name)
    with pytest.raises(TypeError):
        tmx.kv.create(3)
    for name in ("local", "device", "nccl", "LOCAL"):
        assert tmx.kv.create(name).type == jmx.kv.create(name).type
    kv = tmx.kv.create("device")
    assert (kv.rank, kv.num_workers) == (0, 1)
    assert kv.is_capable("optimizer") and not kv.is_capable("x")
    with tmx.cpu(), pytest.raises(ValueError, match="compression"):
        kv.set_gradient_compression({"type": "1bit"})
        kv.init(0, tmx.nd.zeros((2,)))


@pytest.mark.parametrize("shape", [(7,), (4, 5), (3, 3, 3), (1,), (64,)])
def test_2bit_wire_format_bit_equal(shape):
    rng = np.random.RandomState(len(shape))
    thr = 0.5
    qs, packs_t, packs_j = [], [], []
    res_t = torch.zeros(shape)
    res_j = jnp.zeros(shape)
    for p in range(3):
        g = rng.randn(*shape).astype(np.float32)
        tq, res_t = tkv._quant_2bit(torch.from_numpy(g), res_t, thr)
        jq, res_j = jkv._quant_2bit(jnp.asarray(g), res_j, thr)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))
        packs_t.append(tkv._pack_2bit(tq))
        packs_j.append(jkv._pack_2bit(jq))
        np.testing.assert_array_equal(packs_t[-1].numpy(),
                                      np.asarray(packs_j[-1]))
        assert packs_t[-1].dtype == torch.uint8
        qs.append(tq)
    got = tkv._unpack_sum_2bit(torch.stack(packs_t), thr, shape,
                               torch.float32)
    want = jkv._unpack_sum_2bit(jnp.stack(packs_j),
                                jnp.asarray(thr, jnp.float32), shape,
                                "float32")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), sum(qs).numpy())


# --------------------------------------------------------------- the gang --
@pytest.fixture(scope="module", autouse=True)
def _gang_started(tmp_path_factory):
    """The gang starts with the module's first test, so it runs beside
    the one-process cases."""
    outdir = str(tmp_path_factory.mktemp("kvstore"))
    proc = start_gang(os.path.abspath(__file__), outdir)
    yield proc, outdir
    if proc.poll() is None:
        kill_gang(proc)


@pytest.fixture(scope="module")
def gang(_gang_started):
    proc, outdir = _gang_started
    return finish_gang(proc, outdir), outdir


def test_dist_worker_assertions_on_two_ranks(gang):
    ranks, outdir = gang
    log = open(os.path.join(outdir, "gang.log")).read()
    for r in range(2):
        assert f"worker {r}/2 OK" in log


def test_dist_compressed_push_matches_jax(gang):
    ranks, _ = gang
    residual = [jnp.zeros((7, 5)) for _ in range(2)]
    grads = [compressed_grads(r) for r in range(2)]
    for i in range(ROUNDS):
        packs = []
        for r in range(2):
            q, residual[r] = jkv._quant_2bit(jnp.asarray(grads[r][i]),
                                             residual[r], THRESHOLD)
            packs.append(jkv._pack_2bit(q))
        want = np.asarray(jkv._unpack_sum_2bit(
            jnp.stack(packs), jnp.asarray(THRESHOLD, jnp.float32), (7, 5),
            "float32"))
        for res in ranks:
            np.testing.assert_array_equal(res[f"compressed/{i}"], want)


@pytest.mark.parametrize("label,kw", [("allreduce", {}),
                                      ("server", {"update_on_kvstore": True})])
def test_dist_trainer_matches_jax_on_the_summed_loss(gang, label, kw):
    """Two ranks stepping a dist store equal one JAX process stepping on
    the sum of the two ranks' losses (the gradients summed) with the
    same batch size per step."""
    ranks, _ = gang
    net = trainer_net(jmx)
    net.initialize()
    set_trainer_params(jmx, net)
    tr = jmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.2, "momentum": 0.9},
                           kvstore="device", **kw)
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    for x, y in trainer_batches():
        with jmx.autograd.record():
            loss = sum(loss_fn(net(jmx.nd.array(x[r * 4:(r + 1) * 4])),
                               jmx.nd.array(y[r * 4:(r + 1) * 4]))
                       for r in range(2))
        loss.backward()
        tr.step(4)
    for k, p in net.collect_params().items():
        for res in ranks:
            np.testing.assert_allclose(res[f"trainer/{label}/{k}"],
                                       p.data().asnumpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(ranks[0][f"trainer/{label}/{k}"],
                                      ranks[1][f"trainer/{label}/{k}"])
