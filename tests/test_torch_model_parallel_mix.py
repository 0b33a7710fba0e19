"""Port parity: data parallelism mixed with each model-parallel axis — the
port's ``TrainStep(mesh=make_mesh(dp=2, <axis>=2), rules=...)`` on four
gloo ranks on the CPU against the JAX package's step over the same mesh
of four of the virtual CPU devices.

One gang of four port workers (this file run as a script through the
port's launcher) is started once for the module; each rank takes the
rows of its ``dp`` coordinate, so the two ranks of each other axis see
the same rows, and every axis's collectives run over a subgroup of the
world (the mesh's ``DeviceMesh`` groups).  Three steps each, losses and
parameters within 2e-5 of JAX's:

- ``dp x tp``: the two-layer BERT under ``tp_dense_rules()`` and its
  layers' names (``test_torch_model_parallel.py``'s), LAMB, masked-LM
  weights that differ between the dp halves;
- ``dp x sp``: the same BERT with ``attention_impl="ring"``, SGD;
- ``dp x pp``: ``PipelineStack`` of two ``Dense(16, tanh)`` stages
  (``test_torch_pipeline.py``'s), Adam;
- ``dp x ep``: ``MoEFFN`` under a ``Dense`` head (``test_torch_moe.py``'s),
  Adam.
"""
import os
import sys

import numpy as np
import pytest

TOL = 2e-5
STEPS = 3
AXES = ("tp", "sp", "pp", "ep")


def batches(axis):
    rng = np.random.RandomState({"tp": 31, "sp": 32, "pp": 33, "ep": 34}[axis])
    out = []
    for _ in range(STEPS):
        if axis in ("tp", "sp"):
            w = np.ones((4, 4), np.float32)
            w[2:, 1:] = 0.0
            out.append(((rng.randint(0, 100, (4, 16)).astype(np.int32),
                         rng.randint(0, 2, (4, 16)).astype(np.int32), None,
                         rng.randint(0, 16, (4, 4)).astype(np.int32)),
                        (rng.randint(0, 100, (4, 4)).astype(np.int32), w,
                         rng.randint(0, 2, (4,)).astype(np.int32))))
        elif axis == "pp":
            out.append((rng.randn(16, 16).astype(np.float32),
                        rng.randn(16, 16).astype(np.float32)))
        else:
            out.append((rng.randn(8, 4, 16).astype(np.float32),
                        rng.randint(0, 4, (8,)).astype(np.int32)))
    return out


BERT = dict(vocab_size=100, units=32, hidden_size=64, num_layers=2,
            num_heads=4, max_length=32, dropout=0.0)
BERT_LAYER_RULES = [
    (r"attentioncell\d+_dense0_weight$", ("tp", None)),
    (r"attentioncell\d+_dense0_bias$", ("tp",)),
    (r"attentioncell\d+_dense1_weight$", (None, "tp")),
    (r"bertlayer\d+_dense0_weight$", ("tp", None)),
    (r"bertlayer\d+_dense0_bias$", ("tp",)),
    (r"bertlayer\d+_dense1_weight$", (None, "tp"))]


def build(pkg, axis):
    """``(net, loss, optimizer, rules)`` of an axis's run, each net under
    a prefix of its own."""
    from importlib import import_module
    if axis in ("tp", "sp"):
        zoo = import_module(pkg.__name__ + ".gluon.model_zoo.bert")
        net = zoo.BERTModel(**BERT, prefix="bert_",
                            attention_impl="dense" if axis == "tp"
                            else "ring")
        ploss = zoo.BERTPretrainLoss()

        def loss(out, lab):
            return ploss(out[3], out[2], *lab)
        if axis == "tp":
            return (net, loss, pkg.optimizer.create(
                "lamb", learning_rate=1e-3, wd=0.01),
                pkg.parallel.tp_dense_rules()
                + pkg.parallel.ShardingRules(BERT_LAYER_RULES))
        return net, loss, pkg.optimizer.create(
            "sgd", learning_rate=0.05, momentum=0.9), None
    adam = pkg.optimizer.create("adam", learning_rate=1e-2)
    nn = pkg.gluon.nn
    if axis == "pp":
        stack = pkg.parallel.PipelineStack(
            lambda: nn.Dense(16, activation="tanh", in_units=16,
                             prefix="dense0_"),
            num_stages=2, microbatches=4, prefix="pipe_")
        return (stack, lambda out, lab: ((out - lab) ** 2).mean(), adam,
                stack.sharding_rules())

    class Net(pkg.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.moe = pkg.parallel.MoEFFN(units=16, hidden_size=32,
                                               num_experts=4, k=2,
                                               prefix="moe_")
                self.out = nn.Dense(4, in_units=16, prefix="out_")

        def forward(self, x):
            h, aux = self.moe(x)
            return self.out(h.reshape((-1, 4, 16)).mean(axis=1)), aux
    net = Net(prefix="net_")
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()

    def moe_loss(out, lab):
        logits, aux = out
        return ce(logits, lab).mean() + 0.01 * aux
    return net, moe_loss, adam, net.moe.sharding_rules()


def rows(x, i, n):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(rows(v, i, n) for v in x)
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


# ------------------------------------------------------------ the worker --
def worker(outdir):
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import distributed, parallel
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import \
        params_from_jax

    r = distributed.rank()
    assert distributed.num_workers() == 4
    inputs = dict(np.load(os.path.join(outdir, "inputs.npz")))
    res = {}
    with tmx.cpu():
        for axis in AXES:
            tmx.random.seed(2)
            net, loss, opt, rules = build(tmx, axis)
            if axis != "pp":
                net.initialize(ctx="cpu")
            params_from_jax(net, {k[3:]: v for k, v in inputs.items()
                                  if k.startswith(axis + "/")})
            mesh = parallel.make_mesh(dp=2, **{axis: 2})
            step = parallel.TrainStep(net, loss, opt, mesh=mesh, rules=rules)
            i = mesh.coords()["dp"]
            res[f"{axis}/losses"] = np.array([
                float(step(rows(d, i, 2), rows(l, i, 2)))
                for d, l in batches(axis)])
            res[f"{axis}/sharded"] = np.array(sum(
                getattr(t, "_placement", None) is not None
                for t in step._train))
            for k, v in step.params.items():
                res[f"{axis}/p/{k}"] = v.detach().numpy()
    np.savez(os.path.join(outdir, f"rank{r}.npz"), **res)
    print(f"rank {r} done", flush=True)


if __name__ == "__main__":
    worker(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------- the JAX side ---
import jax  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import parallel as jparallel  # noqa: E402
from test_torch_dp_step import (finish_gang, kill_gang,  # noqa: E402
                                random_params, start_gang)


def jnd(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(jnd(v) for v in x)
    return jmx.nd.array(x)


def jax_run(axis):
    """The JAX step over ``dp=2 x axis=2``: its starting values, losses
    and final parameters."""
    jmx.random.seed(2)
    net, loss, opt, rules = build(jmx, axis)
    if axis != "pp":
        net.initialize()
    values = random_params(net, seed=len(axis) + 40)
    mesh = jparallel.make_mesh(dp=2, **{axis: 2}, devices=jax.devices()[:4])
    step = jparallel.TrainStep(net, loss, opt, mesh=mesh, rules=rules)
    losses = [float(np.asarray(step(jnd(d), jnd(l))._data))
              for d, l in batches(axis)]
    return values, np.array(losses), {k: np.asarray(v, np.float32)
                                      for k, v in step.params.items()}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("model_parallel_mix"))
    jax_side = {axis: jax_run(axis) for axis in AXES}
    np.savez(os.path.join(outdir, "inputs.npz"), **{
        f"{axis}/{k}": v for axis in AXES
        for k, v in jax_side[axis][0].items()})
    proc = start_gang(os.path.abspath(__file__), outdir, n=4)
    return finish_gang(proc, outdir, n=4), jax_side


@pytest.mark.parametrize("axis", AXES)
def test_dp_mix_matches_jax(gang, axis):
    ranks, jax_side = gang
    _, jl, jp = jax_side[axis]
    for res in ranks:
        np.testing.assert_allclose(res[f"{axis}/losses"], jl, rtol=TOL,
                                   atol=TOL)
        for k, v in jp.items():
            np.testing.assert_allclose(res[f"{axis}/p/{k}"], v, rtol=TOL,
                                       atol=TOL, err_msg=k)
        assert int(res[f"{axis}/sharded"]) > 0 or axis == "sp"
