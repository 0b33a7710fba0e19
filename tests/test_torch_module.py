"""``mx.mod`` of the port (``mxnet_tpu_torch/module.py``: ``Module``,
``BucketingModule``, the fit loop, checkpoints, ``mx.model``,
``mx.callback``, ``mx.mon``) on the CPU.

- Against the JAX package: a short ``Module.fit`` (3 batches of an MLP
  with ``Dropout(p=0)``, SGD with momentum and Adam) from the same
  parameters ends on the JAX Module's parameters and optimizer state
  within rtol/atol 1e-5; a checkpoint written by either package loads
  in the other (``Module.load``, ``mx.model.load_checkpoint``,
  ``gluon.SymbolBlock``) and predicts the same within 1e-5.
- The cases of ``tests/test_module.py`` (fit and score, the manual
  loop, checkpoints, params, regression, bucketing and its subset
  isolation, callbacks, re-binding, the monitor, lr multipliers,
  inference-only binding), with their thresholds.
- The ``Module.fit`` fault cases of ``tests/test_fault.py`` (bad-batch
  budgets, SIGTERM snapshots and bit-exact resume, double preemption,
  late signals, pruning) and the heartbeat of ``tests/test_elastic.py``.
- Every write into a bound array is in place: the tensors the
  executor (and on the card its graphs) reads keep their identity
  through ``init_params``, ``set_params``, ``update`` and a resumed fit.
"""
import os
import signal
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import elastic, nd
from mxnet_tpu_torch import symbol as sym

TOL = dict(rtol=1e-5, atol=1e-5)
chaos = pytest.mark.chaos
mx = tmx


@pytest.fixture(autouse=True)
def _fresh_scopes():
    with jmx.name.NameManager(), tmx.name.NameManager(), tmx.cpu():
        yield


def _cls_problem(n=512, d=10, k=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, k).astype(np.float32)
    y = (X @ W).argmax(axis=1).astype(np.float32)
    return X, y


def _mlp_sym(S=sym, dropout=None):
    data = S.Variable("data")
    net = S.FullyConnected(data, name="fc1", num_hidden=32)
    net = S.Activation(net, name="relu1", act_type="relu")
    if dropout is not None:
        net = S.Dropout(net, p=dropout, name="drop")
    net = S.FullyConnected(net, name="fc2", num_hidden=3)
    return S.SoftmaxOutput(net, name="softmax", normalization="batch")


# ------------------------------------------------------ against the JAX --
def _start_params(seed=5):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": (rng.randn(32, 10) * 0.3).astype(np.float32),
            "fc1_bias": (rng.randn(32) * 0.1).astype(np.float32),
            "fc2_weight": (rng.randn(3, 32) * 0.3).astype(np.float32),
            "fc2_bias": np.zeros(3, np.float32)}


def _fit(pkg, optimizer, params, X, y):
    """3 batches of 16 through ``Module.fit`` in package ``pkg``."""
    S = pkg.symbol
    mod = pkg.mod.Module(_mlp_sym(S, dropout=0.0),
                         context=pkg.cpu())
    it = pkg.io.NDArrayIter(X, y, batch_size=16)
    opt_params = (("learning_rate", 0.1), ("momentum", 0.9),
                  ("wd", 1e-4)) if optimizer == "sgd" else \
        (("learning_rate", 0.02),)
    mod.fit(it, optimizer=optimizer, optimizer_params=opt_params,
            arg_params={k: pkg.nd.array(v) for k, v in params.items()},
            num_epoch=1)
    arg, _ = mod.get_params()
    states = {}
    for n, st in mod._opt_states.items():
        for i, s in enumerate(st if isinstance(st, (tuple, list)) else
                              [st]):
            if s is not None:
                states[f"{n}.{i}"] = s.asnumpy()
    return {k: v.asnumpy() for k, v in arg.items()}, states


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_fit_matches_jax_after_3_batches(optimizer):
    X, y = _cls_problem(n=48)
    params = _start_params()
    j_arg, j_st = _fit(jmx, optimizer, params, X, y)
    t_arg, t_st = _fit(tmx, optimizer, params, X, y)
    assert sorted(t_arg) == sorted(j_arg) == sorted(params)
    for k in j_arg:
        np.testing.assert_allclose(t_arg[k], j_arg[k], **TOL, err_msg=k)
        assert not np.allclose(t_arg[k], params[k])
    assert sorted(t_st) == sorted(j_st)
    for k in j_st:
        np.testing.assert_allclose(t_st[k], j_st[k], **TOL, err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_cross_loads(writer, tmp_path):
    """A checkpoint written by one package: the other's Module.load,
    model.load_checkpoint and SymbolBlock predict what the writer's
    Module predicts."""
    X, y = _cls_problem(n=64)
    params = _start_params(seed=7)
    src, dst = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    prefix = str(tmp_path / "m")
    mod = src.mod.Module(_mlp_sym(src.symbol), context=src.cpu())
    mod.bind([("data", (32, 10))], [("softmax_label", (32,))],
             for_training=False)
    mod.init_params(arg_params={k: src.nd.array(v)
                                for k, v in params.items()})
    mod.save_checkpoint(prefix, 3)
    want = mod.predict(src.io.NDArrayIter(X, y, batch_size=32)).asnumpy()

    m2 = dst.mod.Module.load(prefix, 3, context=dst.cpu())
    m2.bind([("data", (32, 10))], [("softmax_label", (32,))],
            for_training=False)
    m2.init_params()
    got = m2.predict(dst.io.NDArrayIter(X, y, batch_size=32)).asnumpy()
    np.testing.assert_allclose(got, want, **TOL)
    symb, arg, aux = dst.model.load_checkpoint(prefix, 3)
    assert symb.tojson() == mod.symbol.tojson()
    assert set(arg) == set(params) and aux == {}
    blk = dst.gluon.SymbolBlock(symb, ["data"], params={**arg, **aux})
    np.testing.assert_allclose(blk(dst.nd.array(X[:32])).asnumpy(),
                               want[:32], **TOL)


# ------------------------------------------------ the reference's cases --
def test_fit_converges_and_scores():
    X, y = _cls_problem()
    train = mx.io.NDArrayIter(X, y, batch_size=32, shuffle=True)
    val = mx.io.NDArrayIter(X[:128], y[:128], batch_size=32)
    mod = mx.mod.Module(_mlp_sym(), context=mx.cpu())
    mod.fit(train, optimizer="adam",
            optimizer_params=(("learning_rate", 0.02),),
            eval_metric="acc", num_epoch=20)
    name, acc = mod.score(val, "acc")[0]
    assert name == "accuracy" and acc > 0.95, (name, acc)
    preds = mod.predict(val).asnumpy()
    assert preds.shape == (128, 3)
    np.testing.assert_allclose(preds.sum(axis=1), 1.0, rtol=1e-5)


def test_forward_backward_update_manual_loop():
    X, y = _cls_problem(n=64)
    it = mx.io.NDArrayIter(X, y, batch_size=16)
    mod = mx.mod.Module(_mlp_sym(), context=mx.cpu())
    mod.bind([(d.name, d.shape) for d in it.provide_data],
             [(d.name, d.shape) for d in it.provide_label])
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.5),))
    losses = []
    metric = mx.metric.create("ce")
    for _ in range(15):
        it.reset()
        metric.reset()
        for batch in it:
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            mod.update_metric(metric, batch.label)
        losses.append(metric.get()[1])
    assert losses[-1] < 0.5 * losses[0], losses


def test_bound_arrays_are_written_in_place(tmp_path):
    """init_params, set_params, update and a resumed fit write into the
    tensors the executor was bound with; rebinding one is seen."""
    X, y = _cls_problem(n=64)
    it = mx.io.NDArrayIter(X, y, batch_size=16)
    mod = mx.mod.Module(_mlp_sym(), context=mx.cpu())
    mod.bind([("data", (16, 10))], [("softmax_label", (16,))])
    ex = mod._exec
    held = {n: a._data for n, a in ex.arg_dict.items()}
    mod.init_params(initializer=mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.1), ("momentum", 0.9)))
    for batch in it:
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    arg, aux = mod.get_params()
    mod.set_params({k: v * 0 + 1 for k, v in arg.items()}, aux)
    assert all(ex.arg_dict[n]._data is t for n, t in held.items())
    assert float(ex.arg_dict["fc1_weight"].asnumpy().min()) == 1.0
    ex._check_held()
    before = ex._held
    ex.arg_dict["fc2_bias"] = nd.zeros((3,))
    ex._check_held()
    assert ex._held is not before


def _inference_pair():
    """The same module bound at batch 8 for inference in both packages,
    the port's parameters copied by name from the JAX module's."""
    mods = []
    for pkg in (jmx, tmx):
        m = pkg.mod.Module(_mlp_sym(pkg.sym), context=pkg.cpu())
        m.bind([("data", (8, 10))], [("softmax_label", (8,))],
               for_training=False)
        mods.append(m)
    jmod, tmod = mods
    jmx.random.seed(0)
    jmod.init_params(jmx.init.Xavier(magnitude=2.0))
    arg, aux = jmod.get_params()
    tmod.init_params(arg_params={k: v.asnumpy() for k, v in arg.items()},
                     aux_params={k: v.asnumpy() for k, v in aux.items()})
    return jmod, tmod


def test_inference_batches_keep_one_array_per_signature():
    """Batches of 1, 2, 4, 1, 2, 4 through a module bound at 8 match the
    JAX Module; a signature fed before is written into the array it got
    the first time (same object, same storage), and nothing the graphs
    read is rebound: the executor's held set never drops."""
    jmod, tmod = _inference_pair()
    ex = tmod._exec
    rng = np.random.RandomState(7)
    first, held = {}, None
    for b in (1, 2, 4, 1, 2, 4):
        x = rng.randn(b, 10).astype(np.float32)
        y = np.zeros((b,), np.float32)
        for pkg, m in ((jmx, jmod), (tmx, tmod)):
            m.forward(pkg.io.DataBatch(data=[pkg.nd.array(x)],
                                       label=[pkg.nd.array(y)]),
                      is_train=False)
        np.testing.assert_allclose(tmod.get_outputs()[0].asnumpy(),
                                   jmod.get_outputs()[0].asnumpy(),
                                   rtol=1e-5, atol=1e-6)
        data = ex.arg_dict["data"]
        np.testing.assert_array_equal(data.asnumpy(), x)
        if b in first:
            arr, ptr = first[b]
            assert data is arr and data._data.data_ptr() == ptr
            assert ex._held is held
        else:
            first[b] = (data, data._data.data_ptr())
            held = ex._held
    assert len(ex._fed["data"]) == 4        # the bound array + 3 batches


def test_rebound_parameter_still_drops_the_training_graphs():
    """A training step fed at the bound signature keeps its arrays; a
    parameter the caller rebinds drops every graph, as before."""
    X, y = _cls_problem(n=32)
    mod = mx.mod.Module(_mlp_sym(), context=mx.cpu())
    mod.bind([("data", (16, 10))], [("softmax_label", (16,))])
    mod.init_params(initializer=mx.init.Xavier())
    ex = mod._exec
    batch = mx.io.DataBatch(data=[nd.array(X[:16])],
                            label=[nd.array(y[:16])])
    mod.forward(batch, is_train=True)
    mod.backward()
    held = ex._held
    mod.forward(batch, is_train=True)
    mod.backward()
    assert ex._held is held
    ex.arg_dict["fc1_weight"] = nd.zeros((32, 10))
    mod.forward(batch, is_train=True)
    assert ex._held is not held and ex._pairs == {}


@pytest.mark.gpu
def test_card_inference_grid_and_training_recapture():
    """On the card: one inference graph per fed signature, none dropped
    by switching between them; a rebound parameter drops the training
    pair, and the next steps capture it again."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    X, y = _cls_problem(n=64)
    with mx.gpu(0):
        mod = mx.mod.Module(_mlp_sym(), context=mx.gpu(0))
        mod.bind([("data", (16, 10))], [("softmax_label", (16,))])
        mod.init_params(initializer=mx.init.Xavier())
        ex = mod._exec
        for b in (1, 2, 4, 1, 2, 4):
            mod.forward(mx.io.DataBatch(
                data=[nd.array(X[:b], ctx=mx.gpu(0))],
                label=[nd.array(y[:b], ctx=mx.gpu(0))]), is_train=False)
        assert ex.graph_count() == 3
        batch = mx.io.DataBatch(data=[nd.array(X[:16], ctx=mx.gpu(0))],
                                label=[nd.array(y[:16], ctx=mx.gpu(0))])
        for _ in range(3):
            mod.forward(batch, is_train=True)
            mod.backward()
        assert ex.graph_count() == 4
        ex.arg_dict["fc1_weight"] = nd.zeros((32, 10), ctx=mx.gpu(0))
        for _ in range(3):
            mod.forward(batch, is_train=True)
            mod.backward()
        assert ex.graph_count() == 1        # the pair, captured again


def test_checkpoint_roundtrip(tmp_path):
    X, y = _cls_problem(n=128)
    it = mx.io.NDArrayIter(X, y, batch_size=32)
    mod = mx.mod.Module(_mlp_sym(), context=mx.cpu())
    mod.fit(it, optimizer="adam", optimizer_params=(("learning_rate", 0.02),),
            num_epoch=3)
    prefix = str(tmp_path / "m")
    mod.save_checkpoint(prefix, 3)
    m2 = mx.mod.Module.load(prefix, 3, context=mx.cpu())
    m2.bind_and_restore([("data", (32, 10))], [("softmax_label", (32,))])
    np.testing.assert_allclose(m2.predict(it).asnumpy(),
                               mod.predict(it).asnumpy(), rtol=1e-5)
    symb, arg, aux = mx.model.load_checkpoint(prefix, 3)
    assert set(arg) == {"fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"}
    assert symb.list_arguments() == mod.symbol.list_arguments()
    m3 = mx.mod.Module.load(prefix, 3, context=mx.cpu())
    m3.bind([("data", (32, 10))], [("softmax_label", (32,))],
            for_training=False)
    m3.init_params()
    got, _ = m3.get_params()
    np.testing.assert_allclose(got["fc1_weight"].asnumpy(),
                               arg["fc1_weight"].asnumpy())


def test_get_set_params():
    mod = mx.mod.Module(_mlp_sym(), context=mx.cpu())
    mod.bind([("data", (4, 10))], [("softmax_label", (4,))])
    mod.init_params()
    arg, aux = mod.get_params()
    mod.set_params({k: v * 0 + 7.0 for k, v in arg.items()}, aux)
    got, _ = mod.get_params()
    np.testing.assert_allclose(got["fc1_weight"].asnumpy(), 7.0)
    arg3, _ = mod.get_params()
    mod.set_params({k: v * 0 for k, v in arg3.items()}, aux)
    np.testing.assert_allclose(arg3["fc1_weight"].asnumpy(), 7.0)
    with pytest.raises(ValueError, match="does not match"):
        mod.set_params({"fc1_weight": nd.zeros((2, 2))}, aux,
                       allow_missing=True)


def test_regression_module():
    rng = np.random.RandomState(0)
    X = rng.randn(256, 6).astype(np.float32)
    w = rng.randn(6).astype(np.float32)
    y = (X @ w).astype(np.float32).reshape(-1, 1)
    it = mx.io.NDArrayIter(X, y, batch_size=32, label_name="lro_label")
    net = sym.FullyConnected(sym.Variable("data"), name="fc", num_hidden=1)
    net = sym.LinearRegressionOutput(net, name="lro", grad_scale=1.0 / 32)
    mod = mx.mod.Module(net, label_names=("lro_label",), context=mx.cpu())
    mod.fit(it, optimizer="adam", optimizer_params=(("learning_rate", 0.05),),
            eval_metric="mse", num_epoch=25)
    name, mse = mod.score(it, "mse")[0]
    assert mse < 0.05, mse


class _ListIter:
    """Bucketed batches; provide_data/label describe the DEFAULT bucket."""

    def __init__(self, batches, default_len, n=16):
        self.batches = batches
        self.provide_data = [mx.io.DataDesc("data", (n, default_len),
                                            np.float32)]
        self.provide_label = [mx.io.DataDesc("softmax_label", (n,),
                                             np.float32)]

    def __iter__(self):
        return iter(self.batches)

    def reset(self):
        pass


def test_bucketing_module():
    VOCAB, DIM = 20, 16

    def sym_gen(seq_len):
        emb = sym.Embedding(sym.Variable("data"), name="emb",
                            input_dim=VOCAB, output_dim=DIM)
        fc = sym.FullyConnected(sym.mean(emb, axis=1), name="fc",
                                num_hidden=2)
        out = sym.SoftmaxOutput(fc, name="softmax", normalization="batch")
        return out, ("data",), ("softmax_label",)

    rng = np.random.RandomState(0)
    batches = []
    for _ in range(30):
        L = int(rng.choice([4, 8, 12]))
        x = rng.randint(0, VOCAB, (16, L)).astype(np.float32)
        yv = (x.mean(axis=1) > (VOCAB - 1) / 2).astype(np.float32)
        batches.append(mx.io.DataBatch(data=[nd.array(x)],
                                       label=[nd.array(yv)], bucket_key=L))
    bm = mx.mod.BucketingModule(sym_gen, default_bucket_key=12,
                                context=mx.cpu())
    bm.fit(_ListIter(batches, 12), optimizer="adam",
           optimizer_params=(("learning_rate", 0.05),), num_epoch=15)
    name, acc = bm.score(_ListIter(batches, 12), "acc")[0]
    assert acc > 0.9, (name, acc)
    w_def = bm._buckets[12]._exec.arg_dict["fc_weight"]
    assert len(bm._buckets) == 3
    for k, m in bm._buckets.items():
        assert m._exec.arg_dict["fc_weight"] is w_def, k
    arg, _ = bm.get_params()
    assert set(arg) == {"emb_weight", "fc_weight", "fc_bias"}

    def bad_gen(seq_len):
        emb = sym.Embedding(sym.Variable("data"), name="emb",
                            input_dim=VOCAB, output_dim=DIM)
        h = sym.FullyConnected(sym.mean(emb, axis=1),
                               name=f"extra{seq_len}", num_hidden=4)
        out = sym.SoftmaxOutput(sym.FullyConnected(h, name="fc",
                                                   num_hidden=2),
                                name="softmax")
        return out, ("data",), ("softmax_label",)

    bm2 = mx.mod.BucketingModule(bad_gen, default_bucket_key=12,
                                 context=mx.cpu())
    bm2.bind([("data", (16, 12))], [("softmax_label", (16,))])
    with pytest.raises(ValueError, match="absent from the default bucket"):
        bm2.switch_bucket(8, [("data", (16, 8))], [("softmax_label", (16,))])


def test_bucketing_subset_bucket_update_isolation():
    """A bucket without a default-bucket layer must not re-apply that
    layer's stale gradient on update."""
    VOCAB, DIM = 12, 8

    def sym_gen(L):
        e = sym.Embedding(sym.Variable("data"), name="emb", input_dim=VOCAB,
                          output_dim=DIM)
        h = sym.mean(e, axis=1)
        if L >= 10:
            h = sym.Activation(sym.FullyConnected(h, name="proj",
                                                  num_hidden=DIM),
                               act_type="relu")
        f = sym.FullyConnected(h, name="fc", num_hidden=2)
        out = sym.SoftmaxOutput(f, name="softmax", normalization="batch")
        return out, ("data",), ("softmax_label",)

    rng = np.random.RandomState(0)
    bm = mx.mod.BucketingModule(sym_gen, default_bucket_key=10,
                                context=mx.cpu())
    bm.bind([("data", (8, 10))], [("softmax_label", (8,))])
    bm.init_params()
    bm.init_optimizer(optimizer="sgd",
                      optimizer_params=(("learning_rate", 0.5),
                                        ("momentum", 0.9)))

    def batch(L):
        x = rng.randint(0, VOCAB, (8, L)).astype(np.float32)
        yv = (x.mean(1) > 5.5).astype(np.float32)
        return mx.io.DataBatch([nd.array(x)], [nd.array(yv)], bucket_key=L)

    bm.forward(batch(10), is_train=True)
    bm.backward()
    bm.update()
    frozen = bm.get_params()[0]["proj_weight"].asnumpy().copy()
    for _ in range(5):
        bm.forward(batch(6), is_train=True)
        bm.backward()
        bm.update()
    np.testing.assert_array_equal(
        bm.get_params()[0]["proj_weight"].asnumpy(), frozen)
    bm2 = mx.mod.BucketingModule(sym_gen, default_bucket_key=10)
    with pytest.raises(RuntimeError, match="bind"):
        bm2.forward(batch(10))


def test_fit_with_classic_callbacks(tmp_path):
    X, y = _cls_problem(n=64)
    it = mx.io.NDArrayIter(X, y, batch_size=16)
    mod = mx.mod.Module(_mlp_sym(), context=mx.cpu())
    prefix = str(tmp_path / "cb")
    mod.fit(it, optimizer="sgd", num_epoch=2,
            batch_end_callback=mx.callback.Speedometer(16, frequent=2),
            epoch_end_callback=mx.callback.do_checkpoint(prefix))
    for epoch in (1, 2):
        symb, arg, aux = mx.model.load_checkpoint(prefix, epoch)
        assert set(arg) == {"fc1_weight", "fc1_bias", "fc2_weight",
                            "fc2_bias"}


def test_force_rebind_preserves_params_and_monitor():
    X, y = _cls_problem(n=32)
    out = sym.SoftmaxOutput(sym.FullyConnected(sym.Variable("data"),
                                               name="fc", num_hidden=2),
                            name="softmax")
    mod = mx.mod.Module(out, context=mx.cpu())
    mod.bind([("data", (16, 10))], [("softmax_label", (16,))])
    mod.init_params(initializer=mx.init.Xavier())
    w0 = mod.get_params()[0]["fc_weight"].asnumpy().copy()
    mon = mx.mon.Monitor(1, pattern="fc.*")
    mod.install_monitor(mon)
    mod.bind([("data", (8, 10))], [("softmax_label", (8,))],
             force_rebind=True)
    np.testing.assert_array_equal(mod.get_params()[0]["fc_weight"].asnumpy(),
                                  w0)
    b = mx.io.DataBatch([nd.array(X[:8])], [nd.array(y[:8])])
    mon.tic()
    mod.forward(b, is_train=False)
    stats = {n: float(v) for _, n, v in mon.toc()}
    assert stats["fc_weight"] > 0 and np.isfinite(stats["fc_output"])


def test_monitor():
    X, y = _cls_problem(n=32)
    it = mx.io.NDArrayIter(X, y, batch_size=16)
    mod = mx.mod.Module(_mlp_sym(), context=mx.cpu())
    mod.bind([(d.name, d.shape) for d in it.provide_data],
             [(d.name, d.shape) for d in it.provide_label])
    mod.init_params()
    mon = mx.mon.Monitor(interval=2, pattern="fc.*")
    mod.install_monitor(mon)
    collected = []
    for batch in it:
        mon.tic()
        mod.forward(batch, is_train=False)
        collected.append(mon.toc())
    assert collected[0] and collected[1] == []
    names = {n for _, n, _ in collected[0]}
    assert {"fc1_output", "fc2_output", "fc1_weight"} <= names
    assert "data" not in names
    assert all(np.isfinite(v) for _, _, v in collected[0])


def test_lr_mult_from_symbol_attrs():
    f1 = sym.FullyConnected(sym.Variable("data"), name="fc1", num_hidden=8,
                            attr={"lr_mult": "0.0"})
    a1 = sym.Activation(f1, name="r", act_type="relu")
    out = sym.SoftmaxOutput(sym.FullyConnected(a1, name="fc2", num_hidden=2),
                            name="softmax", normalization="batch")
    X, y = _cls_problem(n=64)
    it = mx.io.NDArrayIter(X, y, batch_size=16)
    mod = mx.mod.Module(out, context=mx.cpu())
    mod.bind([(d.name, d.shape) for d in it.provide_data],
             [(d.name, d.shape) for d in it.provide_label])
    mod.init_params()
    before = mod.get_params()[0]
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.5),))
    for batch in it:
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    after = mod.get_params()[0]
    np.testing.assert_array_equal(after["fc1_weight"].asnumpy(),
                                  before["fc1_weight"].asnumpy())
    assert not np.array_equal(after["fc2_weight"].asnumpy(),
                              before["fc2_weight"].asnumpy())
    lrm, _ = mx.mod.Module._attr_mults(out)
    assert lrm == {"fc1_weight": 0.0, "fc1_bias": 0.0}


def test_bind_without_labels_for_inference():
    net = sym.FullyConnected(sym.Variable("data"), name="fc", num_hidden=4)
    mod = mx.mod.Module(net, label_names=(), context=mx.cpu())
    mod.bind([("data", (2, 3))], for_training=False)
    mod.init_params()
    mod.forward(mx.io.DataBatch(data=[nd.array(np.ones((2, 3), np.float32))],
                                label=None))
    assert mod.get_outputs()[0].shape == (2, 4)


# ------------------------------------------------- fit's fault handling --
def _thread_names():
    return [t.name for t in threading.enumerate()]


def _fit_sym():
    fc = sym.FullyConnected(sym.Variable("data"), num_hidden=4, name="fc")
    return sym.SoftmaxOutput(fc, name="softmax")


def _fit_iter(n=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n * 16, 8).astype(np.float32)
    Y = rng.randint(0, 4, (n * 16,)).astype(np.float32)
    return mx.io.NDArrayIter(X, Y, batch_size=16, label_name="softmax_label")


class _FlakyIter(mx.io.DataIter):
    """Wraps an iterator; raises on the given (0-based) batch indices."""

    def __init__(self, base, bad_at):
        super().__init__(base.batch_size)
        self._base = base
        self._bad_at = set(bad_at)
        self._i = 0

    @property
    def provide_data(self):
        return self._base.provide_data

    @property
    def provide_label(self):
        return self._base.provide_label

    def reset(self):
        self._base.reset()
        self._i = 0

    def next(self):
        i, self._i = self._i, self._i + 1
        batch = self._base.next()       # consume even when poisoned
        if i in self._bad_at:
            raise ValueError(f"decode failure at batch {i}")
        return batch


@chaos
def test_fit_bad_batch_budget_continues():
    mx.random.seed(3)
    mod = mx.mod.Module(_fit_sym(), context=mx.cpu())
    seen = []
    mod.fit(_FlakyIter(_fit_iter(), bad_at={2, 4}), optimizer="sgd",
            optimizer_params=(("learning_rate", 0.1),), eval_metric="acc",
            num_epoch=1, bad_batch_budget=2,
            batch_end_callback=lambda p: seen.append(p.nbatch))
    assert len(seen) == 4


@chaos
def test_fit_bad_batch_budget_exhausted_raises():
    mod = mx.mod.Module(_fit_sym(), context=mx.cpu())
    with pytest.raises(ValueError, match="decode failure"):
        mod.fit(_FlakyIter(_fit_iter(), bad_at={1, 2}), optimizer="sgd",
                eval_metric="acc", num_epoch=1, bad_batch_budget=1)


@chaos
def test_fit_bad_batch_budget_with_prefetch_rewraps():
    mod = mx.mod.Module(_fit_sym(), context=mx.cpu())
    seen = []
    mod.fit(_FlakyIter(_fit_iter(), bad_at={2}), optimizer="sgd",
            eval_metric="acc", num_epoch=1, prefetch=2, bad_batch_budget=1,
            batch_end_callback=lambda p: seen.append(p.nbatch))
    assert len(seen) == 5
    assert "PrefetchingIter-producer" not in _thread_names()


def _train_fit(prefix, resume=False, kill_at=None, num_epoch=2):
    mx.random.seed(3)
    mx.init.seed(3)
    mod = mx.mod.Module(_fit_sym(), context=mx.cpu())
    seen = []

    def cb(p):
        seen.append((p.epoch, p.nbatch))
        if kill_at is not None and (p.epoch, p.nbatch) == kill_at:
            signal.raise_signal(signal.SIGTERM)

    mod.fit(_fit_iter(n=8), optimizer="sgd",
            optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)),
            eval_metric="acc", num_epoch=num_epoch, batch_end_callback=cb,
            checkpoint_prefix=prefix, resume=resume)
    return mod, seen


def _states(mod):
    return {n: st.asnumpy() for n, st in mod._opt_states.items()}


@chaos
def test_fit_sigterm_snapshots_and_resumes_bit_exact(tmp_path):
    ref_mod, _ = _train_fit(str(tmp_path / "ref"))
    ref_arg, _ = ref_mod.get_params()
    prefix = str(tmp_path / "ck")
    _, seen1 = _train_fit(prefix, kill_at=(1, 2))
    assert seen1[-1] == (1, 2)
    assert os.path.exists(prefix + "-resume.json")
    mod2, seen2 = _train_fit(prefix, resume=True)
    assert seen2[0] == (1, 3)
    arg2, _ = mod2.get_params()
    for k in ref_arg:
        np.testing.assert_array_equal(ref_arg[k].asnumpy(),
                                      arg2[k].asnumpy())
    ref_st, st2 = _states(ref_mod), _states(mod2)
    for k in ref_st:
        np.testing.assert_array_equal(ref_st[k], st2[k])
    assert mod2._optimizer.num_update == ref_mod._optimizer.num_update
    assert not os.path.exists(prefix + "-resume.json")


@chaos
def test_fit_resume_without_snapshot_trains_from_scratch(tmp_path):
    _, seen = _train_fit(str(tmp_path / "fresh"), resume=True, num_epoch=1)
    assert seen[0] == (0, 0)


def test_fit_resume_requires_prefix():
    mod = mx.mod.Module(_fit_sym(), context=mx.cpu())
    with pytest.raises(ValueError, match="checkpoint_prefix"):
        mod.fit(_fit_iter(), optimizer="sgd", eval_metric="acc",
                num_epoch=1, resume=True)


@chaos
def test_fit_double_preemption_same_epoch(tmp_path):
    ref_arg, _ = _train_fit(str(tmp_path / "ref"))[0].get_params()
    prefix = str(tmp_path / "ck")
    _train_fit(prefix, kill_at=(1, 1))
    _, seen = _train_fit(prefix, resume=True, kill_at=(1, 4))
    assert seen[0] == (1, 2) and seen[-1] == (1, 4)
    mod3, seen3 = _train_fit(prefix, resume=True)
    assert seen3[0] == (1, 5)
    arg3, _ = mod3.get_params()
    for k in ref_arg:
        np.testing.assert_array_equal(ref_arg[k].asnumpy(),
                                      arg3[k].asnumpy())


@chaos
def test_fit_signal_after_final_batch_completes_and_clears_marker(tmp_path):
    prefix = str(tmp_path / "ck")
    mod = mx.mod.Module(_fit_sym(), context=mx.cpu())
    mod.fit(_fit_iter(n=4), optimizer="sgd", eval_metric="acc", num_epoch=1,
            checkpoint_prefix=prefix,
            epoch_end_callback=lambda *a: signal.raise_signal(signal.SIGTERM))
    assert not os.path.exists(prefix + "-resume.json")
    _, seen = _train_fit(prefix, resume=True, num_epoch=1)
    assert seen[0] == (0, 0)


@chaos
def test_fit_resume_fast_forwards_past_deterministic_bad_batch(tmp_path):
    def train(prefix, resume=False, kill_at=None):
        mx.random.seed(3)
        mx.init.seed(3)
        mod = mx.mod.Module(_fit_sym(), context=mx.cpu())

        def cb(p):
            if kill_at and (p.epoch, p.nbatch) == kill_at:
                signal.raise_signal(signal.SIGTERM)

        mod.fit(_FlakyIter(_fit_iter(n=8), bad_at={1}), optimizer="sgd",
                optimizer_params=(("learning_rate", 0.1),),
                eval_metric="acc", num_epoch=2, batch_end_callback=cb,
                bad_batch_budget=2, checkpoint_prefix=prefix, resume=resume)
        return mod

    ref_arg, _ = train(str(tmp_path / "ref")).get_params()
    prefix = str(tmp_path / "ck")
    train(prefix, kill_at=(0, 4))
    arg, _ = train(prefix, resume=True).get_params()
    for k in ref_arg:
        np.testing.assert_array_equal(ref_arg[k].asnumpy(), arg[k].asnumpy())


@chaos
def test_prune_spares_neighbouring_user_files(tmp_path):
    prefix = str(tmp_path / "model")
    bystanders = ["model-notes.txt", "model-norm_stats.json",
                  "model-new-0000.params"]
    for n in bystanders:
        with open(str(tmp_path / n), "w") as f:
            f.write("precious")
    mod = mx.mod.Module(_fit_sym(), context=mx.cpu())

    def cb(p):
        if (p.epoch, p.nbatch) == (0, 2):
            signal.raise_signal(signal.SIGTERM)

    mod.fit(_fit_iter(n=4), optimizer="sgd", eval_metric="acc", num_epoch=1,
            batch_end_callback=cb, checkpoint_prefix=prefix)
    mx.mod.Module(_fit_sym(), context=mx.cpu()).fit(
        _fit_iter(n=4), optimizer="sgd", eval_metric="acc", num_epoch=1,
        checkpoint_prefix=prefix, resume=True)
    left = sorted(os.listdir(tmp_path))
    for n in bystanders:
        assert n in left
    assert not any("-n00" in n or "resume.json" in n for n in left)


def test_module_fit_heartbeat_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv(elastic.HEARTBEAT_ENV, str(tmp_path))
    monkeypatch.setenv("DMLC_ATTEMPT", "1")
    out = sym.FullyConnected(sym.Variable("data"), num_hidden=2, name="fc")
    net = sym.SoftmaxOutput(out, name="softmax")
    x = np.random.RandomState(0).randn(12, 3).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 2, (12,)).astype(np.float32)
    it = mx.io.NDArrayIter(x, y, batch_size=4)
    mx.mod.Module(net).fit(it, num_epoch=2)
    rec = elastic.read_heartbeats(tmp_path)[0]
    assert rec["global_step"] == 6
    assert rec["attempt"] == 1 and rec["phase"] == "train"
    val = mx.io.NDArrayIter(x[:4], y[:4], batch_size=4)
    mx.mod.Module(net).fit(it, eval_data=val, num_epoch=1)
    assert elastic.read_heartbeats(tmp_path)[0]["phase"] == "eval"
    hb = elastic.Heartbeat(str(tmp_path), rank=0, attempt=1)
    mx.callback.do_heartbeat(hb)(None)
    assert elastic.read_heartbeats(tmp_path)[0]["phase"] == "train"
