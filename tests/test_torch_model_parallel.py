"""Port parity: sharded parameters in ``TrainStep``/``EvalStep`` — the
port's steps over ``tp=2`` and ``fsdp=2`` meshes of two gloo ranks on
the CPU against the JAX package's steps over the same meshes on two of
the virtual CPU devices.

One gang of two port workers (this file run as a script through
``python -m mxnet_tpu_torch.launch -n 2 --platform cpu``) is started once
for the module, with the JAX nets' seeded parameters carried across by
name (``params_from_jax``; every block built under a prefix of its own,
so its names do not depend on what the process built before).  Each run takes three steps:

- an MLP under the rules of ``tests/test_parallel.py``'s tp case
  (column-parallel ``dense0``, row-parallel ``dense1``), Adam;
- a two-layer BERT (units 32, 4 heads, dropout 0, LAMB) under
  ``tp_dense_rules()`` plus its layers' own names (the fused QKV and
  FFN-in column-parallel, the output projection and FFN-out
  row-parallel: Gluon names those layers ``dense0``/``dense1``, which
  ``tp_dense_rules()`` alone does not match — it splits only the
  embeddings), with dense attention and with the flash op (its plain
  version here), both held against JAX's dense run;
- the MLP and the BERT under ``fsdp_rules()`` (the batch split over
  fsdp; the BERT's masked-LM weights differ per rank);
- the tp MLP, the tp BERT and the fsdp BERT again with SGD and momentum:
  Adam and LAMB cancel a constant scale on a leaf's gradient, SGD's
  update is linear in it, so a gradient ``n`` times too large (a missed
  ``1/n`` share, a sum too many) shows only here.

A Dense whose leaves are split over ``fsdp`` or over ``dp`` gets a
non-finite gradient in one rank's block only (``sqrt(0 * y)``: a finite
loss whose gradient is NaN on half the outputs); under
``skip_nonfinite=True`` every rank skips the step.

Losses and parameters within 2e-5 of JAX's after three steps; every rank
the same values; each rank holding half of each sharded leaf and of its
optimizer state; under tp the ``Dense`` matmuls take the blocks (the
shapes that reach ``torch.matmul``); ``EvalStep(mesh=, rules=)``'s
outputs against JAX's.
"""
import os
import sys

import numpy as np
import pytest

STEPS = 3
TOL = 2e-5
MLP_B, BERT_B, S, M, VOCAB = 16, 4, 16, 4, 100
BERT = dict(vocab_size=VOCAB, units=32, hidden_size=64, num_layers=2,
            num_heads=4, max_length=32, dropout=0.0)
MLP_RULES = [(r"dense0_weight", ("tp", None)), (r"dense0_bias", ("tp",)),
             (r"dense1_weight", (None, "tp"))]
BERT_LAYER_RULES = [
    (r"attentioncell\d+_dense0_weight$", ("tp", None)),   # fused QKV
    (r"attentioncell\d+_dense0_bias$", ("tp",)),
    (r"attentioncell\d+_dense1_weight$", (None, "tp")),   # output proj
    (r"bertlayer\d+_dense0_weight$", ("tp", None)),       # FFN-in
    (r"bertlayer\d+_dense0_bias$", ("tp",)),
    (r"bertlayer\d+_dense1_weight$", (None, "tp")),       # FFN-out
]
#: run -> (net, mesh axis, rules, attention, SGD in place of Adam/LAMB)
RUNS = {"mlp_tp": ("mlp", "tp", "mlp", None, False),
        "bert_tp": ("bert", "tp", "bert", "dense", False),
        "bert_tp_flash": ("bert", "tp", "bert", "flash", False),
        "mlp_fsdp": ("mlp", "fsdp", "fsdp", None, False),
        "bert_fsdp": ("bert", "fsdp", "fsdp", "dense", False),
        "mlp_tp_sgd": ("mlp", "tp", "mlp", None, True),
        "bert_tp_sgd": ("bert", "tp", "bert", "dense", True),
        "bert_fsdp_sgd": ("bert", "fsdp", "fsdp", "dense", True)}
#: the JAX run each port run is held against
JAX_RUN = {r: r for r in RUNS}
JAX_RUN["bert_tp_flash"] = "bert_tp"
#: mesh axis -> the rules that split the skip net's leaves over it
SKIP_AXES = ("fsdp", "dp")


def rules_of(pkg, kind):
    P = pkg.parallel
    if kind == "mlp":
        return P.ShardingRules(MLP_RULES)
    if kind == "bert":
        return P.tp_dense_rules() + P.ShardingRules(BERT_LAYER_RULES)
    return P.fsdp_rules()


def build(pkg, name, impl="dense"):
    """The net, under a prefix of its own."""
    if name == "mlp":
        nn = pkg.gluon.nn
        net = nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(nn.Dense(32, activation="relu", in_units=16,
                             prefix="dense0_"),
                    nn.Dense(10, in_units=32, prefix="dense1_"))
        return net
    from importlib import import_module
    zoo = import_module(pkg.__name__ + ".gluon.model_zoo.bert")
    return zoo.BERTModel(**BERT, attention_impl=impl, prefix="bert_")


def batches(name):
    """Seeded global batches ``[(data, label)] * STEPS``; BERT's masked-LM
    weights differ between the two halves of the batch."""
    rng = np.random.RandomState({"mlp": 11, "bert": 12}[name])
    out = []
    for _ in range(STEPS):
        if name == "mlp":
            out.append((rng.randn(MLP_B, 16).astype(np.float32),
                        rng.randint(0, 10, (MLP_B,)).astype(np.int32)))
            continue
        w = np.ones((BERT_B, M), np.float32)
        w[BERT_B // 2:, 1:] = 0.0
        out.append(((rng.randint(0, VOCAB, (BERT_B, S)).astype(np.int32),
                     rng.randint(0, 2, (BERT_B, S)).astype(np.int32), None,
                     rng.randint(0, S, (BERT_B, M)).astype(np.int32)),
                    (rng.randint(0, VOCAB, (BERT_B, M)).astype(np.int32), w,
                     rng.randint(0, 2, (BERT_B,)).astype(np.int32))))
    return out


def loss_and_opt(pkg, name, sgd=False):
    if sgd:
        opt = pkg.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
        if name == "mlp":
            return pkg.gluon.loss.SoftmaxCrossEntropyLoss(), opt
        return loss_and_opt(pkg, name)[0], opt
    if name == "bert":
        from importlib import import_module
        zoo = import_module(pkg.__name__ + ".gluon.model_zoo.bert")
        ploss = zoo.BERTPretrainLoss()
        return (lambda out, lab: ploss(out[3], out[2], *lab),
                pkg.optimizer.create("lamb", learning_rate=1e-3, wd=0.01))
    return (pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
            pkg.optimizer.create("adam", learning_rate=1e-2))


def rows(x, rank, n):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(rows(v, rank, n) for v in x)
    b = x.shape[0] // n
    return x[rank * b:(rank + 1) * b]


# ------------------------------------------------------------ the worker --
def worker(outdir):
    """One rank: every run on its rows (all rows under tp), written to
    ``rank<r>.npz``."""
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import distributed, parallel
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import \
        params_from_jax

    r, n = distributed.rank(), distributed.num_workers()
    assert n == 2 and distributed.backend() == "gloo"
    inputs = dict(np.load(os.path.join(outdir, "inputs.npz")))
    res = {}
    real_matmul = torch.matmul
    with tmx.cpu():
        for run, (name, axis, kind, impl, sgd) in RUNS.items():
            values = {k[len(name) + 1:]: v for k, v in inputs.items()
                      if k.startswith(name + "/")}
            tmx.random.seed(5)
            net = build(tmx, name, impl)
            net.initialize(ctx="cpu")
            params_from_jax(net, values)
            loss, opt = loss_and_opt(tmx, name, sgd)
            mesh = parallel.make_mesh(**{axis: 2})
            step = parallel.TrainStep(net, loss, opt, mesh=mesh,
                                      rules=rules_of(tmx, kind))
            seen = []

            def spy(a, b, **kw):
                if b.dim() == 2:
                    seen.append(tuple(b.shape))
                return real_matmul(a, b, **kw)
            losses = []
            for i, (data, lab) in enumerate(batches(name)):
                if axis == "fsdp":
                    data, lab = rows(data, r, n), rows(lab, r, n)
                torch.matmul = spy if i == 0 else real_matmul
                try:
                    losses.append(float(step(data, lab)))
                finally:
                    torch.matmul = real_matmul
            res[f"{run}/losses"] = np.array(losses)
            res[f"{run}/matmul"] = np.array(sorted(set(seen)))
            for k, t in zip(step._train_idx, step._train):
                nm = step._names[k][len(name) + 1:]
                res[f"{run}/local/{nm}"] = np.array(t.shape)
                st = step._states[step._train_idx.index(k)]
                res[f"{run}/state/{nm}"] = np.array(st[0].shape)
            for k, v in step.params.items():
                res[f"{run}/p/{k[len(name) + 1:]}"] = v.detach().numpy()
            if run in ("mlp_tp", "bert_tp"):
                data = batches(name)[0][0]
                ev = parallel.EvalStep(net, mesh=mesh,
                                       rules=rules_of(tmx, kind))
                out = ev(*data) if isinstance(data, tuple) else ev(data)
                for j, o in enumerate(out if isinstance(out, tuple)
                                      else (out,)):
                    res[f"{run}/eval/{j}"] = o.numpy()
        for axis in SKIP_AXES:
            res.update(skip_run(tmx, axis, r, n))
    np.savez(os.path.join(outdir, f"rank{r}.npz"), **res)
    print(f"rank {r} done", flush=True)


def skip_run(tmx, axis, r, n):
    """One step whose gradient is NaN in rank 1's block of every leaf
    only, under ``skip_nonfinite=True``: what each rank did."""
    import torch

    from mxnet_tpu_torch import parallel

    tmx.random.seed(6)
    net = tmx.gluon.nn.Dense(8, in_units=4, prefix=f"skip{axis}_")
    net.initialize(ctx="cpu")
    before = {k: p.data().asnumpy().copy()
              for k, p in net.collect_params().items()}
    rules = parallel.fsdp_rules() if axis == "fsdp" else \
        parallel.ShardingRules([(r"weight$", ("dp", None)),
                                (r"bias$", ("dp",))])

    def loss(out, lab):
        # finite (sqrt(0) = 0); the gradient of outputs 4..7 is NaN
        # (inf * 0), and those are rank 1's rows of both leaves
        return ((out[:, :4] - lab) ** 2).mean(1) \
            + torch.sqrt(out[:, 4:] * 0).sum(1)
    step = parallel.TrainStep(
        net, loss, tmx.optimizer.create("sgd", learning_rate=0.1),
        mesh=parallel.make_mesh(**{axis: 2}), rules=rules,
        skip_nonfinite=True)
    rng = np.random.RandomState(7)
    data = rng.randn(8, 4).astype(np.float32)
    lab = rng.randn(8, 4).astype(np.float32)
    out = float(step(rows(data, r, n), rows(lab, r, n)))
    held = {k[len(f"skip{axis}_"):]: tuple(t.shape)
            for k, t in zip(step._names, step._train)}
    moved = max(float(np.abs(v.detach().numpy() - before[k]).max())
                for k, v in step.params.items())
    return {f"skip_{axis}/loss": np.array(out),
            f"skip_{axis}/skipped": np.array(step.skipped_steps),
            f"skip_{axis}/t": np.array(int(step._t)),
            f"skip_{axis}/moved": np.array(moved),
            f"skip_{axis}/held": np.array([held["weight"][0],
                                           held["bias"][0]])}


if __name__ == "__main__":
    worker(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------- the JAX side ---
import jax  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
from mxnet_tpu import parallel as jparallel  # noqa: E402
from test_torch_dp_step import (finish_gang, kill_gang,  # noqa: E402
                                random_params, start_gang)


def jmesh(axis):
    return jparallel.make_mesh(**{axis: 2}, devices=jax.devices()[:2])


def jnd(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(jnd(v) for v in x)
    return jmx.nd.array(x)


def jax_run(run, values):
    """The JAX step over the global batches: losses and the final
    parameters by name (prefix stripped), and the EvalStep's outputs."""
    name, axis, kind, _, sgd = RUNS[run]
    jmx.random.seed(5)
    net = build(jmx, name)
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(values[k[len(name) + 1:]]))
    evals = []
    if axis == "tp" and not sgd:
        # before the step, whose first call donates the net's arrays
        ev = jparallel.EvalStep(net, mesh=jmesh(axis),
                                rules=rules_of(jmx, kind))
        data = jnd(batches(name)[0][0])
        out = ev(*data) if isinstance(data, tuple) else ev(data)
        evals = [np.asarray(o._data if hasattr(o, "_data") else o)
                 for o in (out if isinstance(out, (tuple, list))
                           else (out,))]
    loss, opt = loss_and_opt(jmx, name, sgd)
    step = jparallel.TrainStep(net, loss, opt, mesh=jmesh(axis),
                               rules=rules_of(jmx, kind))
    losses = [float(np.asarray(step(jnd(d), jnd(l))._data))
              for d, l in batches(name)]
    params = {k[len(name) + 1:]: np.asarray(v, np.float32)
              for k, v in step.params.items()}
    return np.array(losses), params, evals


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("model_parallel"))
    inputs = {}
    for name in ("mlp", "bert"):
        net = build(jmx, name)
        net.initialize()
        for k, v in random_params(net, seed=len(name)).items():
            inputs[f"{name}/{k[len(name) + 1:]}"] = v
    np.savez(os.path.join(outdir, "inputs.npz"), **inputs)
    proc = start_gang(os.path.abspath(__file__), outdir)
    jax_side = {}
    try:
        for run in sorted(set(JAX_RUN.values())):
            name = RUNS[run][0]
            jax_side[run] = jax_run(run, {
                k[len(name) + 1:]: v for k, v in inputs.items()
                if k.startswith(name + "/")})
    except BaseException:
        kill_gang(proc)
        raise
    return finish_gang(proc, outdir), jax_side


# ------------------------------------------------------------- the tests --
@pytest.mark.parametrize("run", sorted(RUNS))
def test_matches_jax(gang, run):
    ranks, jax_side = gang
    jl, jp, _ = jax_side[JAX_RUN[run]]
    for res in ranks:
        np.testing.assert_allclose(res[f"{run}/losses"], jl, rtol=TOL,
                                   atol=TOL)
        for k, v in jp.items():
            np.testing.assert_allclose(res[f"{run}/p/{k}"], v, rtol=TOL,
                                       atol=TOL, err_msg=k)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_ranks_hold_the_same_values(gang, run):
    ranks, _ = gang
    keys = [k for k in ranks[0] if k.startswith(f"{run}/p/")
            or k.startswith(f"{run}/losses")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_each_rank_holds_its_half(gang, run):
    """A sharded leaf and its first optimizer state are half the whole
    on every rank, along the dim its spec names; the rest are whole."""
    ranks, jax_side = gang
    _, jp, _ = jax_side[JAX_RUN[run]]
    name, axis, kind, _, _ = RUNS[run]
    mesh = jparallel.make_mesh(**{axis: 2}, devices=jax.devices()[:2])
    rules = rules_of(jmx, kind)
    split = 0
    for k, whole in jp.items():
        if f"{run}/local/{k}" not in ranks[0]:
            continue                      # not trainable
        spec = rules.spec_for(f"{name}_{k}", whole.shape, mesh)
        want = list(whole.shape)
        for d, e in enumerate(spec):
            if e is not None:
                want[d] //= 2
        split += want != list(whole.shape)
        for res in ranks:
            assert list(res[f"{run}/local/{k}"]) == want, k
            assert list(res[f"{run}/state/{k}"]) == want, k
    assert split >= (3 if name == "mlp" else 8)


@pytest.mark.parametrize("run", ("mlp_tp", "bert_tp", "bert_tp_flash"))
def test_tp_dense_multiplies_by_its_block(gang, run):
    """Under tp the split Dense layers' matmuls take the blocks: the
    transposed weights reaching ``torch.matmul`` are the halves, and no
    whole split weight appears."""
    ranks, _ = gang
    seen = {tuple(s) for s in ranks[0][f"{run}/matmul"]}
    if run == "mlp_tp":
        assert (16, 16) in seen and (16, 10) in seen
        assert (16, 32) not in seen and (32, 10) not in seen
    else:
        # QKV (96, 32) -> (32, 48); FFN-in (64, 32) -> (32, 32);
        # out proj (32, 32) -> (16, 32); FFN-out (32, 64) -> (32, 32)
        assert {(32, 48), (32, 32), (16, 32)} <= seen
        assert (32, 96) not in seen and (64, 32) not in seen


@pytest.mark.parametrize("run", ("mlp_tp", "bert_tp"))
def test_eval_step_matches_jax(gang, run):
    ranks, jax_side = gang
    evals = jax_side[run][2]
    assert evals
    for res in ranks:
        for j, want in enumerate(evals):
            np.testing.assert_allclose(res[f"{run}/eval/{j}"], want,
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("axis", SKIP_AXES)
def test_a_nonfinite_block_on_one_rank_skips_every_rank(gang, axis):
    """Each rank holds half of each leaf, and only rank 1's half of the
    gradient is NaN: every rank skips the step and keeps its values."""
    ranks, _ = gang
    for res in ranks:
        assert list(res[f"skip_{axis}/held"]) == [4, 4]
        assert np.isfinite(res[f"skip_{axis}/loss"])
        assert int(res[f"skip_{axis}/skipped"]) == 1
        assert int(res[f"skip_{axis}/t"]) == 0
        assert float(res[f"skip_{axis}/moved"]) == 0.0
