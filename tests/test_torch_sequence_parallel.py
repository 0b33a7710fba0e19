"""Port parity: sequence parallelism — ``ring_attention``,
``ulysses_attention`` (``parallel.sequence``, the registered ops) and
BERT with ``attention_impl="ring"``/``"ulysses"`` on an ``sp=2`` mesh of
two gloo ranks on the CPU, against the JAX package's on an ``sp=2`` mesh
of two of the virtual CPU devices.

One gang of two port workers (this file run as a script through the
port's launcher) is started once for the module.  Held:

- each op, causal and not, on seeded ``(B, S, H*D)`` projections: the
  output and the gradients of q, k and v (for a seeded cotangent)
  within 2e-5 of JAX's, the same on both ranks;
- attention dropout by its invariants (the port draws from torch
  streams, not threefry keys): off in eval (two calls equal), on in
  training (two calls differ, and differ from eval);
- BERT (units 32, 4 heads, dropout 0) trained three steps through
  ``TrainStep(mesh=make_mesh(sp=2))`` as ``tests/test_sequence_parallel.py``
  trains it, but with SGD (momentum 0.9) where that test takes Adam:
  the key projection's bias has a zero gradient (it shifts a query's
  scores alike), so its gradient is rounding noise, which Adam's
  per-element normalisation turns into full-size steps of either sign
  — losses and parameters within 2e-5 of the JAX step's, for ring and
  for Ulysses;
- the errors (heads that do not divide over sp, an unknown impl) as
  JAX's.
"""
import os
import sys

import numpy as np
import pytest

TOL = 2e-5
B, S, H, D = 2, 16, 4, 8
STEPS = 3
BERT = dict(vocab_size=50, units=32, hidden_size=64, num_layers=2,
            num_heads=4, max_length=32, dropout=0.0)
BB, BS, BM = 4, 16, 4


def qkv_inputs():
    rng = np.random.RandomState(21)
    return [rng.randn(B, S, H * D).astype(np.float32) for _ in range(4)]


def bert_batches():
    rng = np.random.RandomState(3)
    data = (rng.randint(0, 50, (BB, BS)).astype(np.int32),
            rng.randint(0, 2, (BB, BS)).astype(np.int32), None,
            rng.randint(0, BS, (BB, BM)).astype(np.int32))
    lab = (rng.randint(0, 50, (BB, BM)).astype(np.int32),
           np.ones((BB, BM), np.float32),
           rng.randint(0, 2, (BB,)).astype(np.int32))
    return [(data, lab)] * STEPS


def build_bert(pkg, impl):
    from importlib import import_module
    zoo = import_module(pkg.__name__ + ".gluon.model_zoo.bert")
    return zoo.BERTModel(**BERT, attention_impl=impl, prefix="bert_")


def loss_and_opt(pkg):
    from importlib import import_module
    zoo = import_module(pkg.__name__ + ".gluon.model_zoo.bert")
    ploss = zoo.BERTPretrainLoss()
    return (lambda out, lab: ploss(out[3], out[2], *lab),
            pkg.optimizer.create("sgd", learning_rate=0.05, momentum=0.9))


# ------------------------------------------------------------ the worker --
def worker(outdir):
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import distributed, ops, parallel
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import \
        params_from_jax

    r = distributed.rank()
    assert distributed.num_workers() == 2
    res = {}
    mesh = parallel.make_mesh(sp=2)
    q, k, v, ct = (torch.from_numpy(a) for a in qkv_inputs())
    with tmx.cpu():
        for impl in ("ring", "ulysses"):
            for causal in (False, True):
                ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
                out = parallel.sp_attention(*ins, H, impl=impl, mesh=mesh,
                                            causal=causal)
                grads = torch.autograd.grad((out * ct).sum(), ins)
                key = f"{impl}/{int(causal)}"
                res[f"{key}/out"] = out.detach().numpy()
                for name, g in zip("qkv", grads):
                    res[f"{key}/d{name}"] = g.numpy()
        with parallel.MeshScope(mesh):
            e1 = ops.ring_attention(q, k, v, heads=H, dropout=0.5)
            e2 = ops.ring_attention(q, k, v, heads=H, dropout=0.5)
            with tmx.autograd.record(train_mode=True):
                t1 = ops.ring_attention(q, k, v, heads=H, dropout=0.5)
                t2 = ops.ring_attention(q, k, v, heads=H, dropout=0.5)
        res["dropout"] = np.array([torch.equal(e1, e2),
                                   not torch.allclose(t1, t2),
                                   not torch.allclose(t1, e1)])
        values = dict(np.load(os.path.join(outdir, "inputs.npz")))
        for impl in ("ring", "ulysses"):
            tmx.random.seed(0)
            net = build_bert(tmx, impl)
            net.initialize(ctx="cpu")
            params_from_jax(net, values)
            step = parallel.TrainStep(net, *loss_and_opt(tmx), mesh=mesh)
            res[f"bert_{impl}/losses"] = np.array(
                [float(step(d, l)) for d, l in bert_batches()])
            for name, t in step.params.items():
                res[f"bert_{impl}/p/{name}"] = t.detach().numpy()
    np.savez(os.path.join(outdir, f"rank{r}.npz"), **res)
    print(f"rank {r} done", flush=True)


if __name__ == "__main__":
    worker(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------- the JAX side ---
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import parallel as jparallel  # noqa: E402
from mxnet_tpu.parallel import sequence as jseq  # noqa: E402
from test_torch_dp_step import (finish_gang, kill_gang,  # noqa: E402
                                random_params, start_gang)


def jmesh():
    return jparallel.make_mesh(sp=2, devices=jax.devices()[:2])


def jax_ops():
    q, k, v, ct = (jnp.asarray(a) for a in qkv_inputs())
    out = {}
    mesh = jmesh()
    for impl in ("ring", "ulysses"):
        for causal in (False, True):
            def f(q, k, v):
                return jseq.sp_attention(q, k, v, H, impl=impl, mesh=mesh,
                                         causal=causal)
            o, vjp = jax.vjp(jax.jit(f), q, k, v)
            key = f"{impl}/{int(causal)}"
            out[f"{key}/out"] = np.asarray(o)
            for name, g in zip("qkv", vjp(ct)):
                out[f"{key}/d{name}"] = np.asarray(g)
    return out


def jax_bert(values, impl):
    jmx.random.seed(0)
    net = build_bert(jmx, impl)
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(values[k]))
    step = jparallel.TrainStep(net, *loss_and_opt(jmx), mesh=jmesh())
    losses = []
    for d, l in bert_batches():
        d = tuple(None if x is None else jmx.nd.array(x) for x in d)
        l = tuple(jmx.nd.array(x) for x in l)
        losses.append(float(np.asarray(step(d, l)._data)))
    return np.array(losses), {k: np.asarray(v, np.float32)
                              for k, v in step.params.items()}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("sequence_parallel"))
    net = build_bert(jmx, "dense")
    net.initialize()
    values = random_params(net, seed=4)
    np.savez(os.path.join(outdir, "inputs.npz"), **values)
    proc = start_gang(os.path.abspath(__file__), outdir)
    try:
        jax_side = jax_ops()
        for impl in ("ring", "ulysses"):
            jax_side[f"bert_{impl}"] = jax_bert(values, impl)
    except BaseException:
        kill_gang(proc)
        raise
    return finish_gang(proc, outdir), jax_side


# ------------------------------------------------------------- the tests --
@pytest.mark.parametrize("impl", ("ring", "ulysses"))
@pytest.mark.parametrize("causal", (0, 1))
@pytest.mark.parametrize("leaf", ("out", "dq", "dk", "dv"))
def test_op_matches_jax(gang, impl, causal, leaf):
    ranks, jax_side = gang
    key = f"{impl}/{causal}/{leaf}"
    for res in ranks:
        np.testing.assert_allclose(res[key], jax_side[key], rtol=TOL,
                                   atol=TOL)
    np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


def test_ring_dropout_invariants(gang):
    ranks, _ = gang
    for res in ranks:
        assert res["dropout"].all(), res["dropout"]


@pytest.mark.parametrize("impl", ("ring", "ulysses"))
def test_bert_trains_as_jax(gang, impl):
    ranks, jax_side = gang
    jl, jp = jax_side[f"bert_{impl}"]
    for res in ranks:
        np.testing.assert_allclose(res[f"bert_{impl}/losses"], jl,
                                   rtol=TOL, atol=TOL)
        for k, v in jp.items():
            np.testing.assert_allclose(res[f"bert_{impl}/p/{k}"], v,
                                       rtol=TOL, atol=TOL, err_msg=k)
    assert jl[-1] < jl[0]


def _message(fn):
    try:
        fn()
    except Exception as exc:   # noqa: BLE001 — the error is the result
        return type(exc), str(exc)
    return None, None


def test_errors_as_jax():
    import torch

    from mxnet_tpu_torch import parallel
    q = np.zeros((1, 4, 12), np.float32)
    tm = parallel.make_mesh(sp=2, devices=[0, 1])
    jt, jm = _message(lambda: jseq.ulysses_attention(
        jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), 3, mesh=jmesh()))
    t = torch.from_numpy(q)
    tt, tmsg = _message(lambda: parallel.ulysses_attention(t, t, t, 3,
                                                           mesh=tm))
    assert jt is ValueError and (tt, tmsg) == (jt, jm)
    jt, jm = _message(lambda: jseq.sp_attention(q, q, q, 3, impl="tree"))
    tt, tmsg = _message(lambda: parallel.sp_attention(t, t, t, 3,
                                                      impl="tree"))
    assert jt is ValueError and (tt, tmsg) == (jt, jm)
    jt, jm = _message(lambda: jseq.ring_attention(q, q, q, 3))
    tt, tmsg = _message(lambda: parallel.ring_attention(t, t, t, 3))
    assert jt is ValueError and (tt, tmsg) == (jt, jm)
