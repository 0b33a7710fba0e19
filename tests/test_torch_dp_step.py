"""Port parity: data parallelism — the port's ``TrainStep(mesh=
make_mesh(dp=2))`` on two gloo ranks on the CPU against the JAX
package's ``TrainStep`` on a ``dp=2`` mesh of two of the virtual CPU
devices, fed the global batch.

One gang of two port workers (this file run as a script through
``python -m mxnet_tpu_torch.launch -n 2 --platform cpu``) is started once
for the module; each rank takes its half of every seeded batch, with the
JAX nets' parameters carried over by name (``params_from_jax``).  For
each of an MLP, a two-block fused-conv net with batch norm (NHWC, the
JAX side's Pallas kernels in interpret mode, the port's plain versions)
and a two-layer BERT (units 32, the flash op, dropout 0; every masked
position weighted 1), and in f32 the same BERT with rank 1's rows
weighing 2 masked positions of 8 (``bertw``: the masked-LM weighted mean
is the global batch's, as the JAX step takes it):

- ``grad_reduce="f32"``: losses, parameters and running statistics
  after three steps within 2e-5 of the JAX step's, bit-equal across the
  ranks (sync-BN: the statistics are the global batch's on both sides);
- ``"bf16"``/``"int8"``: the trajectory gates of ``tests/
  test_quantize.py`` (2e-3 and 1e-2 relative), against the port's own
  f32 losses where the net has no batch norm, and for the batch-norm
  net against the same explicit path with its exchange moving f32 (the
  explicit path's statistics are per shard, by design, as JAX's); two
  int8 runs from one seed bit-identical; ranks bit-equal;
- ``skip_nonfinite`` under int8: a NaN in rank 1's batch skips the step
  on both ranks and leaves the parameters as they were.

Also ``reduce_gradients`` with nearest rounding (``key=None``) on per-rank
leaves against the JAX function inside ``shard_map`` over dp=2: int8
within 1e-6 of each leaf's scale, bf16 and f32 exactly; the ``TrainStep``
error for a bad mode; a loss written to reduce the batch itself, which
stays per rank (the mean of the ranks' values, not JAX's global one: a
stated divergence); and the meshes and rules the port once refused (a
``tp`` axis, a rule over ``tp`` or ``dp``) running, placing the leaves
and giving the replicated run's values.

On the card (``gpu``): a gang of max(2, cards) ranks (gloo when they
share one card, NCCL when each has its own) trains the MLP in f32 and
int8 on the card, every rank the same bits and the f32 run within 1e-5
of one process on the global batch; and a world of one over NCCL
captures its step, collectives included, with the eager step's bits.
"""
import contextlib
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
MODES = ("f32", "bf16", "int8", "int8-again")
MLP_B, FUSED_B, BERT_B = 16, 8, 4
S, M, VOCAB = 16, 4, 100
BERT = dict(vocab_size=VOCAB, units=32, hidden_size=64, num_layers=2,
            num_heads=4, max_length=32, dropout=0.0)
SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
LAMB = dict(learning_rate=1e-3, wd=0.01)
F32_TOL = 2e-5
GATES = {"bf16": 2e-3, "int8": 1e-2}
LEAVES = ((37,), (5, 70), (300,), (2, 3, 4))


# ------------------------------------------------------------- the nets --
def mlp(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(32, activation="relu", in_units=16, prefix="fc1_"),
                nn.Dense(10, in_units=32, prefix="fc2_"))
    return net


def fused(pkg):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="fused_")
    with net.name_scope():
        net.add(nn.NormReluConv2D(8, 3, in_channels=8, prefix="b1_"),
                nn.NormReluConv2D(8, 3, in_channels=8, prefix="b2_"),
                nn.BatchNorm(axis=3, in_channels=8, prefix="bn_"),
                nn.Flatten(),
                nn.Dense(5, in_units=6 * 6 * 8, prefix="fc_"))
    return net


def bert(pkg):
    from importlib import import_module
    zoo = import_module(pkg.__name__ + ".gluon.model_zoo.bert")
    return zoo.BERTModel(**BERT, attention_impl="flash", prefix="bert_")


def batches(name):
    """The seeded global batches of a net: ``[(data, label)] * STEPS``
    (``bertw``: BERT's, the rows of rank 1 weighing only their first
    masked position)."""
    if name == "bertw":
        out = []
        for data, (labels, weights, nsp) in batches("bert"):
            weights = weights.copy()
            weights[BERT_B // 2:, 1:] = 0.0
            out.append((data, (labels, weights, nsp)))
        return out
    rng = np.random.RandomState({"mlp": 1, "fused": 2, "bert": 3}[name])
    out = []
    for _ in range(STEPS):
        if name == "mlp":
            out.append((rng.randn(MLP_B, 16).astype(np.float32),
                        rng.randint(0, 10, (MLP_B,)).astype(np.int32)))
        elif name == "fused":
            out.append((rng.randn(FUSED_B, 6, 6, 8).astype(np.float32),
                        rng.randint(0, 5, (FUSED_B,)).astype(np.int32)))
        else:
            data = (rng.randint(0, VOCAB, (BERT_B, S)).astype(np.int32),
                    rng.randint(0, 2, (BERT_B, S)).astype(np.int32), None,
                    rng.randint(0, S, (BERT_B, M)).astype(np.int32))
            label = (rng.randint(0, VOCAB, (BERT_B, M)).astype(np.int32),
                     np.ones((BERT_B, M), np.float32),
                     rng.randint(0, 2, (BERT_B,)).astype(np.int32))
            out.append((data, label))
    return out


def own_scalar_loss(pkg):
    """A loss that reduces the batch to a scalar itself: the CE summed
    over the rows, divided by the rows' labels plus one, summed."""
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss(out, label):
        den = (label.float() if hasattr(label, "float")     # a tensor
               else label.astype("float32")) + 1.0          # an NDArray
        return ce(out, label).sum() / den.sum()
    return loss


def loss_and_opt(pkg, name):
    if name in ("bert", "bertw"):
        from importlib import import_module
        zoo = import_module(pkg.__name__ + ".gluon.model_zoo.bert")
        ploss = zoo.BERTPretrainLoss()

        def loss(out, label):
            return ploss(out[3], out[2], *label)
        return loss, pkg.optimizer.create("lamb", **LAMB)
    return (pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
            pkg.optimizer.create("sgd", **SGD))


def shard(x, rank, n):
    """Rank ``rank``'s rows of a batch leaf (or tuple of leaves)."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(shard(v, rank, n) for v in x)
    b = x.shape[0] // n
    return x[rank * b:(rank + 1) * b]


def random_params(net, seed):
    """Seeded values for every parameter of a JAX net (gammas near 1,
    running variances positive)."""
    import mxnet_tpu as jmx
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in net.collect_params().items():
        v = 0.2 * rng.randn(*p.shape)
        if name.endswith(("gamma", "running_var")):
            v = 1.0 + np.abs(v) if "var" in name else 1.0 + v
        p.set_data(jmx.nd.array(v.astype(np.float32)))
        out[name] = v.astype(np.float32)
    return out


def poisoned(data, lab):
    """A NaN in the batch: in the data, or in BERT's (float) masked-LM
    weights, its token ids being integers."""
    if isinstance(data, tuple):
        weights = lab[1].copy()
        weights[0, 0] = np.nan
        return data, (lab[0], weights, lab[2])
    data = data.copy()
    data.reshape(-1)[3] = np.nan
    return data, lab


@contextlib.contextmanager
def f32_wire():
    """The explicit path's exchange moving f32 whatever mode it is asked
    for: the yardstick of the compressed modes on a batch-norm net."""
    from mxnet_tpu_torch.parallel import quantize
    exchange = quantize.reduce_gradients

    def plain(grads, axis_name, n_dev, mode="int8", key=None,
              reduce="mean", chunk=quantize.DEFAULT_CHUNK):
        return exchange(grads, axis_name, n_dev, mode="f32", reduce=reduce)
    quantize.reduce_gradients = plain
    try:
        yield
    finally:
        quantize.reduce_gradients = exchange


# ------------------------------------------------------------ the worker --
def worker(outdir):
    """One rank of the gang: every run of every net on this rank's
    shards, written to ``rank<r>.npz``."""
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import distributed, parallel
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import \
        params_from_jax

    r, n = distributed.rank(), distributed.num_workers()
    assert n == 2 and distributed.backend() == "gloo"
    inputs = dict(np.load(os.path.join(outdir, "inputs.npz")))
    res = {}
    with tmx.cpu():
        for name in ("mlp", "fused", "bert", "bertw"):
            src = "bert" if name == "bertw" else name
            arrays = {k[len(src) + 1:]: v for k, v in inputs.items()
                      if k.startswith(src + "/")}
            feed = batches(name)
            runs = [(m, m.split("-")[0], False) for m in MODES] \
                + [("skip", "int8", True)] \
                + ([("f32-wire", "bf16", False)] if name == "fused" else [])
            if name == "bertw":
                runs = [("f32", "f32", False)]
            for label, mode, skip in runs:
                tmx.random.seed(5)
                net = (mlp if name == "mlp" else fused if name == "fused"
                       else bert)(tmx)
                pre = len(src) + 1
                net.initialize(ctx="cpu")
                params_from_jax(net, arrays)
                loss, opt = loss_and_opt(tmx, name)
                step = parallel.TrainStep(net, loss, opt,
                                          mesh=parallel.make_mesh(dp=2),
                                          grad_reduce=mode,
                                          skip_nonfinite=skip)
                losses = []
                wire = f32_wire() if label == "f32-wire" \
                    else contextlib.nullcontext()
                with wire:
                    for i, (data, lab) in enumerate(feed):
                        data, lab = shard(data, r, n), shard(lab, r, n)
                        if skip and i == 1 and r == 1:
                            data, lab = poisoned(data, lab)
                        if skip and i == 1:
                            before = {k: v.detach().clone()
                                      for k, v in step.params.items()}
                        losses.append(float(step(data, lab)))
                        if skip and i == 1:
                            res[f"{name}/skip/same"] = np.array(all(
                                torch.equal(before[k], v)
                                for k, v in step.params.items()))
                res[f"{name}/{label}/losses"] = np.array(losses)
                if skip:
                    res[f"{name}/skip/skipped"] = np.array(
                        step.skipped_steps)
                for k, v in step.params.items():
                    res[f"{name}/{label}/p/{k[pre:]}"] = \
                        v.detach().float().numpy()
        moved_runs(tmx, parallel, params_from_jax, inputs, r, n, res)
        key_leaves = sorted(k for k in inputs if k.startswith("leaves/"))
        mine = [torch.from_numpy(inputs[k][r]) for k in key_leaves]
        with parallel.MeshScope(parallel.make_mesh(dp=2)):
            for mode in ("f32", "bf16", "int8"):
                out = parallel.reduce_gradients(mine, "dp", 2, mode=mode,
                                                key=None)
                for k, o in zip(key_leaves, out):
                    res[f"reduce/{mode}/{k}"] = o.float().numpy()
    np.savez(os.path.join(outdir, f"rank{r}.npz"), **res)
    print(f"rank {r} done", flush=True)


def moved_runs(tmx, parallel, params_from_jax, inputs, r, n, res):
    """The MLP's f32 runs that once raised: a mesh with a ``tp`` axis
    (no rules, then a rule splitting ``fc1_weight`` over ``tp``), a rule
    splitting it over ``dp``; and the loss that reduces the batch itself
    (``own``); plus ``EvalStep`` and ``shard_map`` over the tp mesh."""
    import torch
    arrays = {k[4:]: v for k, v in inputs.items() if k.startswith("mlp/")}
    tp_rule = parallel.ShardingRules([(r"fc1_weight$", ("tp", None))])
    dp_rule = parallel.ShardingRules([(r"fc1_weight$", ("dp", None))])
    runs = (("tp-mesh", dict(mesh=parallel.make_mesh(dp=1, tp=2)), False),
            ("tp-rule", dict(mesh=parallel.make_mesh(dp=1, tp=2),
                             rules=tp_rule), False),
            ("dp-rule", dict(mesh=parallel.make_mesh(dp=2), rules=dp_rule),
             True),
            ("own", dict(mesh=parallel.make_mesh(dp=2)), True))
    for label, kw, split in runs:
        tmx.random.seed(5)
        net = mlp(tmx)
        net.initialize(ctx="cpu")
        params_from_jax(net, arrays)
        loss, opt = loss_and_opt(tmx, "mlp")
        if label == "own":
            loss = own_scalar_loss(tmx)
        step = parallel.TrainStep(net, loss, opt, **kw)
        losses = []
        for data, lab in batches("mlp"):
            if split:
                data, lab = shard(data, r, n), shard(lab, r, n)
            losses.append(float(step(data, lab)))
        res[f"moved/{label}/losses"] = np.array(losses)
        res[f"moved/{label}/shape"] = np.array(
            step._train[step._train_idx.index(
                step._names.index("mlp_fc1_weight"))].shape)
        res[f"moved/{label}/state_shape"] = np.array(
            step._states[step._train_idx.index(
                step._names.index("mlp_fc1_weight"))][0].shape)
        for k, v in step.params.items():
            res[f"moved/{label}/p/{k[4:]}"] = v.detach().float().numpy()
        if label == "tp-rule":
            x = batches("mlp")[0][0]
            res["moved/eval"] = parallel.EvalStep(net, **kw)(x).numpy()
            spec = parallel.mesh.PartitionSpec
            res["moved/shard_map"] = np.array(parallel.shard_map(
                lambda v: v + parallel.mesh.axis_index("tp"),
                mesh=kw["mesh"], in_specs=(spec("tp"),),
                out_specs=spec())(torch.zeros(())))


def card_worker(outdir):
    """One rank of the card gang: the MLP in f32 and int8 on this rank's
    card, written to ``card<r>.npz``."""
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import distributed, parallel

    r, n = distributed.rank(), distributed.num_workers()
    res = {"backend": np.array(distributed.backend()),
           "card": np.array(distributed.device().index)}
    for mode in ("f32", "int8"):
        tmx.random.seed(5)
        net = mlp(tmx)
        net.initialize(ctx=tmx.gpu(distributed.device().index))
        loss, opt = loss_and_opt(tmx, "mlp")
        step = parallel.TrainStep(net, loss, opt, grad_reduce=mode)
        for data, lab in batches("mlp"):
            b = MLP_B // n
            step(data[r * b:(r + 1) * b], lab[r * b:(r + 1) * b])
        for k, v in step.params.items():
            res[f"{mode}/{k}"] = v.detach().cpu().numpy()
        res[f"{mode}/graphs"] = np.array(step.graph_count())
    net = mlp(tmx)
    net.initialize(ctx=tmx.gpu(distributed.device().index))
    try:    # gloo's collectives go through the host: no capture
        parallel.TrainStep(net, *loss_and_opt(tmx, "mlp"),
                           capture=True)(*batches("mlp")[0])
        res["capture_true"] = np.array("ok")
    except ValueError as exc:
        res["capture_true"] = np.array(str(exc))
    torch.cuda.synchronize()
    np.savez(os.path.join(outdir, f"card{r}.npz"), **res)


if __name__ == "__main__":
    (card_worker if sys.argv[2:] == ["card"] else worker)(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------- the JAX side ---
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import parallel as jparallel  # noqa: E402


def start_gang(script, outdir, n=2, timeout=300, platform="cpu",
               extra=()):
    """``script outdir *extra`` on ``n`` ranks through the port's
    launcher (gloo ranks on the CPU by default), in a session of its own
    so ``kill_gang`` reaches the ranks too; returns the Popen (its
    output goes to ``outdir/gang.log``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env.setdefault("OMP_NUM_THREADS", "2")     # the ranks share the cores
    log = open(os.path.join(outdir, "gang.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(n),
         "--platform", platform, sys.executable, script, outdir, *extra],
        env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
        start_new_session=True)
    proc.timeout, proc.log = timeout, log
    return proc


def kill_gang(proc):
    """Kill a gang's whole process group: the launcher and its ranks
    (plain children of the launcher's supervisor, which a kill of the
    launcher alone would leave running)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def finish_gang(proc, outdir, n=2):
    """Wait for the gang; its per-rank results."""
    try:
        rc = proc.wait(timeout=proc.timeout)
    except subprocess.TimeoutExpired:
        kill_gang(proc)
        rc = "timeout"
    proc.log.close()
    text = open(os.path.join(outdir, "gang.log")).read()
    assert rc == 0, (rc, text[-3000:])
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz")))
            for r in range(n)]


def jax_net(name):
    net = {"mlp": mlp, "fused": fused, "bert": bert}[name](jmx)
    net.initialize()
    return net


def jax_run(name, values, mode):
    """The JAX step on dp=2 over the global batches: losses and the
    final parameters by name (prefix stripped)."""
    jmx.random.seed(5)
    net = jax_net("bert" if name == "bertw" else name)
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(values[k]))
    loss, opt = loss_and_opt(jmx, name)
    mesh = jparallel.make_mesh(dp=2, devices=jax.devices()[:2])
    step = jparallel.TrainStep(net, loss, opt, mesh=mesh, grad_reduce=mode)
    losses = []
    for data, lab in batches(name):
        if isinstance(data, tuple):
            data = tuple(None if d is None else jmx.nd.array(d)
                         for d in data)
            lab = tuple(jmx.nd.array(x) for x in lab)
        losses.append(float(np.asarray(step(data, lab)._data)))
    pre = len("bert" if name == "bertw" else name) + 1
    params = {k[pre:]: np.asarray(v, np.float32)
              for k, v in step.params.items()}
    return np.array(losses), params


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("dp_step"))
    inputs = {}
    for name in ("mlp", "fused", "bert"):
        net = jax_net(name)
        for k, v in random_params(net, seed=len(name)).items():
            inputs[f"{name}/{k}"] = v
    rng = np.random.RandomState(9)
    for i, shape in enumerate(LEAVES):
        inputs[f"leaves/{i}"] = rng.randn(2, *shape).astype(np.float32)
    np.savez(os.path.join(outdir, "inputs.npz"), **inputs)
    proc = start_gang(os.path.abspath(__file__), outdir)
    jax_side = {}
    try:
        for name in ("mlp", "fused", "bert", "bertw"):
            src = "bert" if name == "bertw" else name
            values = {k[len(src) + 1:]: v for k, v in inputs.items()
                      if k.startswith(src + "/")}
            jax_side[name, "f32"] = jax_run(name, values, "f32")
        jax_side["own"] = jax_own_losses(values_of(inputs, "mlp"))
        jax_side["reduce"] = jax_reduce(inputs)
    finally:
        ranks = finish_gang(proc, outdir)
    return ranks, jax_side


def values_of(inputs, name):
    return {k[len(name) + 1:]: v for k, v in inputs.items()
            if k.startswith(name + "/")}


def jax_own_losses(values):
    """``own_scalar_loss`` at the MLP's first parameters on the JAX side:
    over the global batch (the JAX step's value) and over each rank's
    rows (what each port rank takes)."""
    net = jax_net("mlp")
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(values[k]))
    loss = own_scalar_loss(jmx)
    x, y = batches("mlp")[0]

    def at(rows):
        return float(np.asarray(loss(net(jmx.nd.array(x[rows])),
                                     jmx.nd.array(y[rows]))._data))
    b = MLP_B // 2
    return at(slice(None)), [at(slice(0, b)), at(slice(b, None))]


def jax_reduce(inputs):
    """JAX's ``reduce_gradients`` with ``key=None`` inside ``shard_map``
    over dp=2, on the same per-device leaves."""
    from jax.sharding import PartitionSpec as P
    from mxnet_tpu.parallel import quantize as jq
    mesh = jparallel.make_mesh(dp=2, devices=jax.devices()[:2])
    keys = sorted(k for k in inputs if k.startswith("leaves/"))
    out = {}
    for mode in ("f32", "bf16", "int8"):
        def inner(*leaves):
            red = jq.reduce_gradients([x[0] for x in leaves], "dp", 2,
                                      mode=mode, key=None)
            return tuple(x[None] for x in red)

        f = jax.jit(jparallel.shard_map(
            inner, mesh=mesh, in_specs=tuple(P("dp") for _ in keys),
            out_specs=tuple(P("dp") for _ in keys), check_vma=False))
        res = f(*[jnp.asarray(inputs[k]) for k in keys])
        for k, v in zip(keys, res):
            out[mode, k] = np.asarray(v.astype(jnp.float32))
    return out


# ------------------------------------------------------------- the tests --
NETS = ("mlp", "fused", "bert")


@pytest.mark.parametrize("name", NETS + ("bertw",))
def test_f32_matches_jax_dp2(gang, name):
    ranks, jax_side = gang
    jl, jp = jax_side[name, "f32"]
    for res in ranks:
        np.testing.assert_allclose(res[f"{name}/f32/losses"], jl,
                                   rtol=F32_TOL, atol=F32_TOL)
        for k, v in jp.items():
            np.testing.assert_allclose(res[f"{name}/f32/p/{k}"], v,
                                       rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("mode", MODES + ("skip",))
def test_ranks_bit_equal(gang, name, mode):
    ranks, _ = gang
    keys = [k for k in ranks[0] if k.startswith(f"{name}/{mode}/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_fused_running_statistics_move(gang):
    ranks, jax_side = gang
    stats = [k for k in jax_side["fused", "f32"][1] if "running" in k]
    assert len(stats) == 6
    for k in stats:
        assert not np.allclose(ranks[0][f"fused/f32/p/{k}"],
                               1.0 if "var" in k else 0.0)


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("mode", ("bf16", "int8"))
def test_trajectory_gates(gang, name, mode):
    ranks, jax_side = gang
    got = ranks[0][f"{name}/{mode}/losses"]
    ref = ranks[0][f"{name}/f32-wire/losses" if name == "fused"
                   else f"{name}/f32/losses"]
    assert np.all(np.isfinite(got))
    rel = np.abs(got - ref) / np.abs(ref)
    assert np.all(rel < GATES[mode]), (got, ref)


@pytest.mark.parametrize("name", NETS)
def test_int8_deterministic_under_one_seed(gang, name):
    ranks, _ = gang
    for k in ranks[0]:
        if k.startswith(f"{name}/int8/"):
            again = k.replace("/int8/", "/int8-again/")
            np.testing.assert_array_equal(ranks[0][k], ranks[0][again])


@pytest.mark.parametrize("name", NETS)
def test_skip_nonfinite_under_int8(gang, name):
    ranks, _ = gang
    for res in ranks:
        losses = res[f"{name}/skip/losses"]
        assert np.isnan(losses[1]) and np.isfinite(losses[[0, 2]]).all()
        assert int(res[f"{name}/skip/skipped"]) == 1
        assert bool(res[f"{name}/skip/same"])


@pytest.mark.parametrize("mode", ("f32", "bf16", "int8"))
def test_reduce_gradients_nearest_matches_jax(gang, mode):
    ranks, jax_side = gang
    for i, shape in enumerate(LEAVES):
        key = f"leaves/{i}"
        want = jax_side["reduce"][mode, key][0]
        for res in ranks:
            got = res[f"reduce/{mode}/{key}"]
            assert got.shape == shape
            if mode == "int8":
                scale = np.abs(want).max() / 127.0
                assert np.abs(got - want).max() <= 1e-6 * scale + 0.0, key
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)


# ----------------------------------------------------------- the errors --
def _port_step(**kw):
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import parallel
    with tmx.cpu():
        net = mlp(tmx)
        net.initialize(ctx="cpu")
        loss, opt = loss_and_opt(tmx, "mlp")
        return parallel.TrainStep(net, loss, opt, **kw)


def _jax_step(**kw):
    net = jax_net("mlp")
    loss, opt = loss_and_opt(jmx, "mlp")
    return jparallel.TrainStep(net, loss, opt, **kw)


def _message(fn):
    try:
        fn()
    except Exception as exc:   # noqa: BLE001 — the error is the result
        return type(exc), str(exc)
    return None, None


def test_bad_mode_raises_as_jax():
    from mxnet_tpu_torch import parallel
    jt, jm = _message(lambda: _jax_step(grad_reduce="fp8"))
    tt, tm = _message(lambda: _port_step(grad_reduce="fp8"))
    assert jt is ValueError and (tt, tm) == (jt, jm)
    mesh_j = jparallel.make_mesh(tp=2, devices=jax.devices()[:2])
    mesh_t = parallel.make_mesh(tp=2, devices=[0, 1])
    jt, jm = _message(lambda: _jax_step(mesh=mesh_j, grad_reduce="int8"))
    tt, tm = _message(lambda: _port_step(mesh=mesh_t, grad_reduce="int8"))
    assert jt is ValueError and (tt, tm) == (jt, jm)


def test_model_parallel_mesh_and_rules_raise(gang):
    """Once refused, now run: a ``tp`` mesh without rules and with a rule
    splitting ``fc1_weight`` by rows over ``tp`` train the MLP on the
    whole batch to the replicated dp run's values (and JAX's), the
    rule's leaf and its optimizer state held as one half per rank;
    ``EvalStep`` and ``shard_map`` run over the same mesh.  In a world of
    one (no gang) the rule over ``dp`` replicates and runs."""
    import torch
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import parallel
    ranks, jax_side = gang
    jl, jp = jax_side["mlp", "f32"]
    for r, res in enumerate(ranks):
        for label in ("tp-mesh", "tp-rule"):
            np.testing.assert_allclose(res[f"moved/{label}/losses"], jl,
                                       rtol=F32_TOL, atol=F32_TOL)
            for k, v in jp.items():
                np.testing.assert_allclose(res[f"moved/{label}/p/{k}"], v,
                                           rtol=F32_TOL, atol=F32_TOL,
                                           err_msg=k)
        assert tuple(res["moved/tp-mesh/shape"]) == (32, 16)
        assert tuple(res["moved/tp-rule/shape"]) == (16, 16)
        assert tuple(res["moved/tp-rule/state_shape"]) == (16, 16)
        assert float(res["moved/shard_map"]) == r
        np.testing.assert_array_equal(res["moved/eval"], ranks[0]["moved/eval"])
    rules = parallel.ShardingRules([(r"fc1_weight$", ("dp", None))])
    step = _port_step(rules=rules)
    with tmx.cpu():
        # dp has size 1 in a world of one: the rule replicates, and runs
        loss = step(torch.zeros((4, 16)), torch.zeros((4,), dtype=torch.int32))
    assert torch.isfinite(loss)


def test_sharding_rule_over_a_real_axis_raises(gang):
    """Once refused, now run: a rule splitting ``fc1_weight`` over ``dp``
    (which also splits the batch) holds it as a half per rank, gathered
    where used with its gradient summed over dp by the gather's
    backward, and trains to the JAX dp=2 step's values."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel.step import _placements
    import torch
    mesh = parallel.make_mesh(dp=2, devices=[0, 1])
    rules = parallel.ShardingRules([(r"w$", ("dp", None))])
    _, where = _placements(mesh, rules, ["net_w", "net_b"],
                           [torch.zeros(4, 3), torch.zeros(3)])
    assert where[0].spec == ("dp", None) and where[0].shape == (4, 3)
    assert where[1] is None
    ranks, jax_side = gang
    jl, jp = jax_side["mlp", "f32"]
    for res in ranks:
        assert tuple(res["moved/dp-rule/shape"]) == (16, 16)
        np.testing.assert_allclose(res["moved/dp-rule/losses"], jl,
                                   rtol=F32_TOL, atol=F32_TOL)
        for k, v in jp.items():
            np.testing.assert_allclose(res[f"moved/dp-rule/p/{k}"], v,
                                       rtol=F32_TOL, atol=F32_TOL, err_msg=k)


def test_a_loss_that_reduces_itself_stays_per_rank(gang):
    """A stated divergence: a loss that reduces the batch to a scalar
    itself is taken per rank and averaged over the ranks, where the JAX
    step takes it over the global batch (BERTPretrainLoss is not such a
    loss: see ``bertw``)."""
    ranks, jax_side = gang
    whole, per_rank = jax_side["own"]
    for res in ranks:
        first = res["moved/own/losses"][0]
        np.testing.assert_allclose(first, np.mean(per_rank), rtol=F32_TOL)
        assert abs(first - whole) > 100 * F32_TOL * abs(whole)


# ------------------------------------------------------------ on the card --
gpu = pytest.mark.gpu


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch


@gpu
def test_card_gang_trains_the_mlp_alike(tmp_path):
    torch = _card()
    cards = torch.cuda.device_count()
    n = max(2, cards)
    proc = start_gang(os.path.abspath(__file__), str(tmp_path), n=n,
                      platform="gpu", extra=("card",))
    rc = proc.wait(timeout=proc.timeout)
    proc.log.close()
    assert rc == 0, open(tmp_path / "gang.log").read()[-3000:]
    ranks = [dict(np.load(tmp_path / f"card{r}.npz")) for r in range(n)]
    want = "nccl" if cards >= 2 else "gloo"
    for r, res in enumerate(ranks):
        assert str(res["backend"]) == want
        assert int(res["card"]) == r % cards
        # NCCL's collectives are captured in the step's graph; gloo's
        # run eagerly, and capture=True raises
        assert int(res["f32/graphs"]) == int(res["int8/graphs"]) \
            == (1 if want == "nccl" else 0)
        assert (str(res["capture_true"]) == "ok") == (want == "nccl")
        for k in res:
            if k not in ("card",):
                np.testing.assert_array_equal(res[k], ranks[0][k],
                                              err_msg=k)
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import parallel
    tmx.random.seed(5)
    net = mlp(tmx)
    net.initialize(ctx=tmx.gpu(0))
    loss, opt = loss_and_opt(tmx, "mlp")
    step = parallel.TrainStep(net, loss, opt)
    for data, lab in batches("mlp"):
        step(data, lab)
    for k, v in step.params.items():
        np.testing.assert_allclose(ranks[0][f"f32/{k}"],
                                   v.detach().cpu().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@gpu
def test_card_world_of_one_captures_its_nccl_collectives():
    torch = _card()
    import socket

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import distributed, parallel
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    distributed.init(coordinator=f"127.0.0.1:{port}", num_processes=1,
                     process_id=0)
    try:
        assert distributed.backend() == "nccl"
        out = {}
        for capture in (None, False):
            tmx.random.seed(5)
            net = fused(tmx)
            net.initialize(ctx=tmx.gpu(0))
            loss, opt = loss_and_opt(tmx, "fused")
            step = parallel.TrainStep(net, loss, opt, capture=capture)
            losses = [float(step(d, lab)) for d, lab in batches("fused")]
            out[capture] = (losses, [v.detach().clone() for v in
                                     step.params.values()],
                            step.graph_count())
        assert out[None][2] == 1 and out[False][2] == 0
        assert out[None][0] == out[False][0]
        for a, b in zip(out[None][1], out[False][1]):
            assert torch.equal(a, b)
    finally:
        distributed.shutdown()
