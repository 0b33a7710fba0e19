"""Port parity: mixture-of-experts — ``moe_dispatch``, the ``moe_ffn`` op
and ``MoEFFN`` (``parallel.moe``) against the JAX package's, and
expert-parallel training on an ``ep=2`` mesh of two gloo ranks on the
CPU against the JAX step on an ``ep=2`` mesh of two of the virtual CPU
devices.

- ``moe_dispatch`` on seeded logits with no top-k ties (k = 1 and 2, a
  capacity that drops tokens, with and without a ``valid`` mask):
  dispatch bit for bit, combine and the aux loss within 1e-6;
- ``MoEFFN`` (two groups, so a padded tail group too) with the JAX
  layer's parameters: the output, the aux loss and every parameter's
  gradient of ``mean(out**2) + 0.01 * aux`` within 2e-5;
- ``moe_ffn`` in the op namespaces (``nd``, ``sym``, ``F``);
- one gang of two port workers (this file run as a script through the
  port's launcher, started once for the module) trains a ``MoEFFN``
  under a ``Dense`` head, as ``tests/test_moe.py`` trains it, through
  ``TrainStep(mesh=make_mesh(ep=2), rules=net.moe.sharding_rules())``
  for three steps (Adam 1e-2): losses and parameters within 2e-5 of the
  JAX step's, each rank holding half the experts of each expert leaf
  and of its optimizer state.
"""
import os
import sys

import numpy as np
import pytest

TOL = 2e-5
STEPS = 3


def net_of(pkg):
    class Net(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.moe = pkg.parallel.MoEFFN(units=16, hidden_size=32,
                                               num_experts=4, k=2,
                                               prefix="moe_")
                self.out = pkg.gluon.nn.Dense(4, in_units=16, prefix="out_")

        def forward(self, x):
            h, aux = self.moe(x)
            return self.out(h.reshape((-1, 4, 16)).mean(axis=1)), aux
    return Net(prefix="net_")


def batches():
    rng = np.random.RandomState(2)
    return [(rng.randn(8, 4, 16).astype(np.float32),
             rng.randint(0, 4, (8,)).astype(np.int32))
            for _ in range(STEPS)]


def loss_fn(pkg):
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss(out, lab):
        logits, aux = out
        return ce(logits, lab).mean() + 0.01 * aux
    return loss


# ------------------------------------------------------------ the worker --
def worker(outdir):
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import distributed, parallel
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import \
        params_from_jax

    r = distributed.rank()
    assert distributed.num_workers() == 2
    res = {}
    values = dict(np.load(os.path.join(outdir, "inputs.npz")))
    with tmx.cpu():
        tmx.random.seed(0)
        net = net_of(tmx)
        net.initialize(ctx="cpu")
        params_from_jax(net, values)
        step = parallel.TrainStep(
            net, loss_fn(tmx), tmx.optimizer.create("adam",
                                                    learning_rate=1e-2),
            mesh=parallel.make_mesh(ep=2), rules=net.moe.sharding_rules())
        res["losses"] = np.array([float(step(x, y)) for x, y in batches()])
        for name, t in step.params.items():
            res[f"p/{name}"] = t.detach().numpy()
        for i, t in zip(step._train_idx, step._train):
            st = step._states[step._train_idx.index(i)]
            res[f"local/{step._names[i]}"] = np.array(t.shape)
            res[f"state/{step._names[i]}"] = np.array(st[0].shape)
    np.savez(os.path.join(outdir, f"rank{r}.npz"), **res)
    print(f"rank {r} done", flush=True)


if __name__ == "__main__":
    worker(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------- the JAX side ---
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu import parallel as jparallel  # noqa: E402
from mxnet_tpu.parallel.moe import moe_dispatch as jdispatch  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import \
    params_from_jax  # noqa: E402
from test_torch_dp_step import (finish_gang, kill_gang,  # noqa: E402
                                random_params, start_gang)


def jax_train(values):
    jmx.random.seed(0)
    net = net_of(jmx)
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(values[k]))
    mesh = jparallel.make_mesh(ep=2, devices=jax.devices()[:2])
    step = jparallel.TrainStep(
        net, loss_fn(jmx), jmx.optimizer.create("adam", learning_rate=1e-2),
        mesh=mesh, rules=net.moe.sharding_rules())
    losses = [float(np.asarray(step(jmx.nd.array(x), jmx.nd.array(y))._data))
              for x, y in batches()]
    return np.array(losses), {k: np.asarray(v, np.float32)
                              for k, v in step.params.items()}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("moe"))
    net = net_of(jmx)
    net.initialize()
    values = random_params(net, seed=6)
    np.savez(os.path.join(outdir, "inputs.npz"), **values)
    proc = start_gang(os.path.abspath(__file__), outdir)
    try:
        jax_side = jax_train(values)
    except BaseException:
        kill_gang(proc)
        raise
    return finish_gang(proc, outdir), jax_side


# ------------------------------------------------------------- the tests --
def _logits(n=24, e=4, seed=0):
    return np.random.RandomState(seed).randn(n, e).astype(np.float32)


@pytest.mark.parametrize("k", (1, 2))
@pytest.mark.parametrize("masked", (False, True))
def test_moe_dispatch_matches_jax(k, masked):
    logits = _logits(seed=k)
    srt = np.sort(logits, axis=1)
    assert (np.diff(srt, axis=1) > 1e-3).all()          # no top-k ties
    valid = np.arange(24) % 5 != 3 if masked else None
    jd, jc, ja = jdispatch(jnp.asarray(logits), 4, 5, k=k,
                           valid=None if valid is None
                           else jnp.asarray(valid))
    td, tc, ta = tmx.parallel.moe_dispatch(
        torch.from_numpy(logits), 4, 5, k=k,
        valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert np.asarray(jd).sum() < 24 * k          # the capacity drops some
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_moe_ffn_forward_and_grads_match_jax():
    jmx.random.seed(0)
    jl = jmx.parallel.MoEFFN(units=16, hidden_size=32, num_experts=4, k=2,
                             group_size=24, prefix="moe_")
    jl.initialize()
    values = random_params(jl, seed=8)
    with tmx.cpu():
        tl = tmx.parallel.MoEFFN(units=16, hidden_size=32, num_experts=4,
                                 k=2, group_size=24, prefix="moe_")
        tl.initialize(ctx="cpu")
        params_from_jax(tl, values)
        x = np.random.RandomState(1).randn(5, 8, 16).astype(np.float32)
        with jmx.autograd.record():
            jo, ja = jl(jmx.nd.array(x))
            jloss = (jo ** 2).mean() + 0.01 * ja
        jloss.backward()
        with tmx.autograd.record():
            to, ta = tl(tmx.nd.array(x))
            tloss = (to ** 2).mean() + 0.01 * ta
        tloss.backward()
    np.testing.assert_allclose(to.asnumpy(), jo.asnumpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(ta.asnumpy()), float(ja.asnumpy()),
                               rtol=TOL)
    jp, tp = jl.collect_params(), tl.collect_params()
    assert sorted(jp.keys()) == sorted(tp.keys())
    for name in jp.keys():
        np.testing.assert_allclose(tp[name].grad().asnumpy(),
                                   jp[name].grad().asnumpy(), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_moe_ffn_is_a_registered_op():
    assert tmx.nd.moe_ffn is not None and tmx.sym.moe_ffn is not None
    assert tmx.ops.moe_ffn is tmx.ops.registry.OPS["moe_ffn"]


def test_ep_training_matches_jax(gang):
    ranks, (jl, jp) = gang
    for res in ranks:
        np.testing.assert_allclose(res["losses"], jl, rtol=TOL, atol=TOL)
        for k, v in jp.items():
            np.testing.assert_allclose(res[f"p/{k}"], v, rtol=TOL, atol=TOL,
                                       err_msg=k)


def test_each_rank_holds_half_the_experts(gang):
    ranks, (_, jp) = gang
    experts = [k for k in jp if "expert" in k]
    assert len(experts) == 4
    for res in ranks:
        for k, v in jp.items():
            want = ((v.shape[0] // 2,) + v.shape[1:]) if k in experts \
                else v.shape
            assert tuple(res[f"local/{k}"]) == want, k
            assert tuple(res[f"state/{k}"]) == want, k
