"""Port parity: pipeline parallelism — ``gpipe`` and ``PipelineStack``
(``parallel.pipeline``) on a ``pp=2`` mesh of two gloo ranks on the CPU,
against the JAX package's on a ``pp=2`` mesh of two of the virtual CPU
devices.

One gang of two port workers (this file run as a script through the
port's launcher) is started once for the module.  Held:

- ``gpipe`` of two tanh stages over whole stacked parameters, with 4
  and 8 microbatches: the output and the gradients of the stacked
  weights, biases and the input within 2e-5 of JAX's, the same on both
  ranks;
- ``PipelineStack`` of two ``Dense(16, tanh)`` stages: its eager
  forward under a ``MeshScope``, and three ``TrainStep(rules=
  stack.sharding_rules())`` steps (MSE, Adam 1e-2): losses and
  parameters within 2e-5 of the JAX step's; each stacked leaf placed
  ``("pp", ...)`` and held as its stage (leading dim 1) on each rank;
- the errors for a stacked leaf whose leading dim is not the stage
  count and a batch that does not split into the microbatches, as
  JAX's.
"""
import os
import sys

import numpy as np
import pytest

TOL = 2e-5
P, D, B = 2, 8, 16
STEPS = 3


def gpipe_inputs():
    rng = np.random.RandomState(0)
    return {"w": (rng.randn(P, D, D) * 0.3).astype(np.float32),
            "b": (rng.randn(P, D) * 0.1).astype(np.float32),
            "x": rng.randn(B, D).astype(np.float32),
            "ct": rng.randn(B, D).astype(np.float32)}


def stack_batches():
    rng = np.random.RandomState(3)
    return [(rng.randn(B, 16).astype(np.float32),
             rng.randn(B, 16).astype(np.float32)) for _ in range(STEPS)]


def build_stack(pkg):
    nn = pkg.gluon.nn
    return pkg.parallel.PipelineStack(
        lambda: nn.Dense(16, activation="tanh", in_units=16,
                         prefix="dense0_"),
        num_stages=P, microbatches=4, prefix="pipe_")


def mse(out, lab):
    return ((out - lab) ** 2).mean()


# ------------------------------------------------------------ the worker --
def worker(outdir):
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import distributed, parallel
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import \
        params_from_jax

    r = distributed.rank()
    assert distributed.num_workers() == 2
    res = {}
    mesh = parallel.make_mesh(pp=2)
    g = {k: torch.from_numpy(v) for k, v in gpipe_inputs().items()}

    def stage(p, a):
        return torch.tanh(a @ p["w"] + p["b"])
    with tmx.cpu():
        for m in (4, 8):
            w, b, x = (g[k].clone().requires_grad_(True) for k in "wbx")
            out = parallel.gpipe(stage, {"w": w, "b": b}, x, mesh=mesh,
                                 microbatches=m)
            grads = torch.autograd.grad((out * g["ct"]).sum(), (w, b, x))
            res[f"gpipe{m}/out"] = out.detach().numpy()
            for k, gr in zip("wbx", grads):
                res[f"gpipe{m}/d{k}"] = gr.numpy()
        values = dict(np.load(os.path.join(outdir, "inputs.npz")))
        tmx.random.seed(1)
        stack = build_stack(tmx)
        params_from_jax(stack, values)
        x0 = torch.from_numpy(stack_batches()[0][0])
        with parallel.MeshScope(mesh):
            res["stack/eager"] = stack(x0).detach().numpy()
        step = parallel.TrainStep(
            stack, mse, tmx.optimizer.create("adam", learning_rate=1e-2),
            mesh=mesh, rules=stack.sharding_rules())
        res["stack/losses"] = np.array([float(step(x, y))
                                        for x, y in stack_batches()])
        for name, t in step.params.items():
            res[f"stack/p/{name}"] = t.detach().numpy()
        for i, t in zip(step._train_idx, step._train):
            res[f"stack/local/{step._names[i]}"] = np.array(t.shape)
            res[f"stack/spec/{step._names[i]}"] = np.array(
                [str(e) for e in step._param_shardings[i].spec])
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
from mxnet_tpu.parallel.pipeline import gpipe as jgpipe  # noqa: E402
from test_torch_dp_step import (finish_gang, kill_gang,  # noqa: E402
                                start_gang)


def jmesh():
    return jparallel.make_mesh(pp=2, devices=jax.devices()[:2])


def jax_gpipe():
    g = {k: jnp.asarray(v) for k, v in gpipe_inputs().items()}
    mesh = jmesh()
    out = {}

    def stage(p, a):
        return jnp.tanh(a @ p["w"] + p["b"])
    for m in (4, 8):
        def f(w, b, x):
            return jgpipe(stage, {"w": w, "b": b}, x, mesh=mesh,
                          microbatches=m)
        o, vjp = jax.vjp(jax.jit(f), g["w"], g["b"], g["x"])
        out[f"gpipe{m}/out"] = np.asarray(o)
        for k, gr in zip("wbx", vjp(g["ct"])):
            out[f"gpipe{m}/d{k}"] = np.asarray(gr)
    return out


def jax_stack():
    """The JAX stack (its parameters, the eager forward, three steps)."""
    jmx.random.seed(1)
    stack = build_stack(jmx)
    rng = np.random.RandomState(7)
    values = {}
    for name, p in stack.collect_params().items():
        values[name] = (0.3 * rng.randn(*p.shape)).astype(np.float32)
        p.set_data(jmx.nd.array(values[name]))
    x0 = jmx.nd.array(stack_batches()[0][0])
    with jparallel.MeshScope(jmesh()):
        eager = stack(x0).asnumpy()
    step = jparallel.TrainStep(
        stack, mse, jmx.optimizer.create("adam", learning_rate=1e-2),
        mesh=jmesh(), rules=stack.sharding_rules())
    losses = [float(np.asarray(step(jmx.nd.array(x), jmx.nd.array(y))._data))
              for x, y in stack_batches()]
    params = {k: np.asarray(v, np.float32) for k, v in step.params.items()}
    return values, eager, np.array(losses), params


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("pipeline"))
    values, eager, losses, params = jax_stack()
    np.savez(os.path.join(outdir, "inputs.npz"), **values)
    proc = start_gang(os.path.abspath(__file__), outdir)
    try:
        jax_side = jax_gpipe()
        jax_side.update({"stack/eager": eager, "stack/losses": losses,
                         "stack/params": params})
    except BaseException:
        kill_gang(proc)
        raise
    return finish_gang(proc, outdir), jax_side


# ------------------------------------------------------------- the tests --
@pytest.mark.parametrize("m", (4, 8))
@pytest.mark.parametrize("leaf", ("out", "dw", "db", "dx"))
def test_gpipe_matches_jax(gang, m, leaf):
    ranks, jax_side = gang
    key = f"gpipe{m}/{leaf}"
    for res in ranks:
        np.testing.assert_allclose(res[key], jax_side[key], rtol=TOL,
                                   atol=TOL)
    np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


def test_pipeline_stack_eager_forward(gang):
    ranks, jax_side = gang
    for res in ranks:
        np.testing.assert_allclose(res["stack/eager"], jax_side["stack/eager"],
                                   rtol=TOL, atol=TOL)


def test_pipeline_stack_trains_as_jax(gang):
    ranks, jax_side = gang
    jp = jax_side["stack/params"]
    for res in ranks:
        np.testing.assert_allclose(res["stack/losses"],
                                   jax_side["stack/losses"], rtol=TOL,
                                   atol=TOL)
        for k, v in jp.items():
            np.testing.assert_allclose(res[f"stack/p/{k}"], v, rtol=TOL,
                                       atol=TOL, err_msg=k)


def test_pipeline_stack_leaves_on_pp(gang):
    ranks, jax_side = gang
    names = sorted(jax_side["stack/params"])
    assert len(names) == 2
    for res in ranks:
        for k in names:
            assert str(res[f"stack/spec/{k}"][0]) == "pp", k
            whole = jax_side["stack/params"][k].shape
            assert tuple(res[f"stack/local/{k}"]) == (1,) + whole[1:], k


def _message(fn):
    try:
        fn()
    except Exception as exc:   # noqa: BLE001 — the error is the result
        return type(exc), str(exc)
    return None, None


def test_errors_as_jax():
    import torch

    from mxnet_tpu_torch import parallel
    tm = parallel.make_mesh(pp=2, devices=[0, 1])

    def stage(p, a):
        return a
    w3 = np.zeros((3, 4, 4), np.float32)
    w2 = np.zeros((2, 4, 4), np.float32)
    x = np.zeros((6, 4), np.float32)
    for w, m in ((w3, 2), (w2, 4)):
        jt, jm = _message(lambda: jgpipe(stage, {"w": jnp.asarray(w)},
                                         jnp.asarray(x), mesh=jmesh(),
                                         microbatches=m))
        tt, tmsg = _message(lambda: parallel.gpipe(
            stage, {"w": torch.from_numpy(w)}, torch.from_numpy(x),
            mesh=tm, microbatches=m))
        assert jt is ValueError and (tt, tmsg) == (jt, jm)
