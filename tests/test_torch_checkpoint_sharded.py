"""Port parity: checkpoints of sharded ``TrainStep``s — the v1.1 one-file
format gathered over the mesh, and the port's own per-rank v2 format —
on two gloo ranks on the CPU, against the JAX package on two of the
virtual CPU devices.

One gang of two port workers (this file run as a script through
``python -m mxnet_tpu_torch.launch -n 2 --platform cpu``) is started
once for the module, with the JAX nets' seeded parameters carried
across by name (``params_from_jax``; every block under a prefix of its
own).  Each run (an MLP and a two-layer BERT, over ``tp=2`` under the
Megatron rules of ``tests/test_torch_model_parallel.py`` and over
``fsdp=2`` under ``fsdp_rules()``) takes SAVE_AT steps, saves v1.1
(every rank; rank 0 writes the gathered file) and v2 (each rank its
blocks, ``async_save=True``), and takes the rest of its STEPS steps —
the uninterrupted trajectory.  Then:

- v1.1: the port's file has the JAX package's file's entry names,
  shapes and values (within 2e-5); it resumes into tp=2, into fsdp=2
  (in the gang) and into a world of one (this process) on the
  uninterrupted losses within 2e-5; the JAX package resumes from the
  port's file, and the port from the JAX package's, on the JAX
  package's losses;
- v2: the port's counterparts of ``tests/test_checkpoint.py``'s four
  v2 cases on tp=2 — kill and resume (the JAX package's loss
  trajectory the yardstick, rtol 1e-5), the placements kept (the same
  blocks, the same tensors), the remap across Gluon's name counters,
  the state-slot mismatch — and the cross-layout loads tp=2 -> fsdp=2
  and tp=2 -> a world of one; a damaged rank file, or one of another
  save (of the same step or a later one) planted beside the manifest,
  raises ``CheckpointCorruptError``.

On the card (``gpu``): the v2 round trip of a captured step.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest

STEPS, SAVE_AT = 6, 4
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
#: run -> (net, mesh axis)
RUNS = {"mlp_tp": ("mlp", "tp"), "bert_tp": ("bert", "tp"),
        "mlp_fsdp": ("mlp", "fsdp"), "bert_fsdp": ("bert", "fsdp")}
TP_RUNS = ("mlp_tp", "bert_tp")
WIDE = 11           # Dense layers of the counter-order net (dense9 < dense10)


def rules_of(pkg, name, axis):
    P = pkg.parallel
    if axis == "fsdp":
        return P.fsdp_rules()
    if name == "mlp":
        return P.ShardingRules(MLP_RULES)
    return P.tp_dense_rules() + P.ShardingRules(BERT_LAYER_RULES)


def build(pkg, name):
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
    return zoo.BERTModel(**BERT, attention_impl="dense", prefix="bert_")


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


def loss_and_opt(pkg, name):
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


def values_of(inputs, name):
    return {k[len(name) + 1:]: v for k, v in inputs.items()
            if k.startswith(name + "/")}


# ------------------------------------------------------- the port's side --
def port_step(tmx, name, axis, values, scale=1.0):
    """A port TrainStep for ``name`` over ``axis`` (None: a world of one)
    from ``values`` (times ``scale``: a fresh step's own start)."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import \
        params_from_jax

    tmx.random.seed(5)
    net = build(tmx, name)
    net.initialize(ctx="cpu")
    params_from_jax(net, {k: v * scale for k, v in values.items()})
    loss, opt = loss_and_opt(tmx, name)
    kw = {} if axis is None else dict(
        mesh=parallel.make_mesh(**{axis: 2}), rules=rules_of(tmx, name, axis))
    return parallel.TrainStep(net, loss, opt, **kw)


def feed(axis, data, lab, r, n):
    return (rows(data, r, n), rows(lab, r, n)) if axis == "fsdp" \
        else (data, lab)


def resumed(step, name, axis, load, r=0, n=1):
    """Build ``step`` on the first batch, ``load`` into it, and take the
    steps after SAVE_AT: their losses."""
    bs = batches(name)
    step(*feed(axis, *bs[0], r, n))
    load(step)
    return [float(step(*feed(axis, d, l, r, n))) for d, l in bs[SAVE_AT:]]


def wide_net(tmx):
    """WIDE + 1 Dense layers named by Gluon's counters."""
    nn = tmx.gluon.nn
    net = nn.HybridSequential()
    for _ in range(WIDE):
        net.add(nn.Dense(6, in_units=6, activation="relu"))
    net.add(nn.Dense(4, in_units=6))
    net.initialize(ctx="cpu")
    return net


def wide_step(tmx, net, momentum=0.9):
    from mxnet_tpu_torch import parallel

    return parallel.TrainStep(
        net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
        tmx.optimizer.create("sgd", learning_rate=0.1, momentum=momentum),
        mesh=parallel.make_mesh(tp=2),
        rules=parallel.ShardingRules([(r"dense\d+_weight$", (None, "tp"))]))


def worker(outdir):
    """One rank: every run, its saves and the gang's resumes, written to
    ``rank<r>.npz``."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import distributed
    from mxnet_tpu_torch.parallel import checkpoint as ck

    r, n = distributed.rank(), distributed.num_workers()
    assert n == 2 and distributed.backend() == "gloo"
    inputs = dict(np.load(os.path.join(outdir, "inputs.npz")))
    res = {}
    with tmx.cpu():
        for run, (name, axis) in RUNS.items():
            values = values_of(inputs, name)
            step = port_step(tmx, name, axis, values)
            v1, v2 = (os.path.join(outdir, f"{run}.npz"),
                      os.path.join(outdir, f"{run}-v2"))
            losses = []
            for i, (data, lab) in enumerate(batches(name)):
                if i == SAVE_AT:
                    ck.save_train_step(step, v1)
                    ck.save_train_step_sharded(
                        step, v2, async_save=True).wait_until_finished()
                    if run == "mlp_tp":     # another save of the same step
                        ck.save_train_step_sharded(step, v2 + "-twin",
                                                   async_save=False)
                losses.append(float(step(*feed(axis, data, lab, r, n))))
            if run == "mlp_tp":             # a save of a later step
                ck.save_train_step_sharded(step, v2 + "-late",
                                           async_save=False)
            res[f"{run}/losses"] = np.array(losses)
            res[f"{run}/blocks"] = np.array(
                [t.numel() for t in step._train])
            # kill and resume from v2, the same layout: the placements
            # and the step's tensors kept
            fresh = port_step(tmx, name, axis, values, scale=0.5)
            held = []

            def load_v2(s):
                held.append([id(t) for t in s._train])
                ck.load_train_step_sharded(s, v2)
                held.append([id(t) for t in s._train])
            res[f"{run}/v2/{axis}"] = np.array(resumed(
                fresh, name, axis, load_v2, r, n))
            res[f"{run}/v2/same_tensors"] = np.array(held[0] == held[1])
            res[f"{run}/v2/placed"] = np.array(
                [getattr(t, "_placement", None) is not None
                 for t in fresh._train])
            res[f"{run}/v2/block_shapes"] = np.array(
                [t.numel() for t in fresh._train])
            if run not in TP_RUNS:
                continue
            for into in ("tp", "fsdp"):
                res[f"{run}/v1/{into}"] = np.array(resumed(
                    port_step(tmx, name, into, values, scale=0.5), name,
                    into, lambda s: ck.load_train_step(s, v1), r, n))
            res[f"{run}/v2/fsdp"] = np.array(resumed(
                port_step(tmx, name, "fsdp", values, scale=0.5), name,
                "fsdp", lambda s: ck.load_train_step_sharded(s, v2), r, n))
        res.update(counter_orders(tmx, outdir))
        res.update(state_slots(tmx, outdir))
    np.savez(os.path.join(outdir, f"rank{r}.npz"), **res)
    print(f"rank {r} done", flush=True)


def counter_orders(tmx, outdir):
    """v2 across Gluon's name counters: saved by a net whose layers are
    dense0..dense11, loaded by one whose layers are dense12..dense23 (in
    lexicographic order dense10 < dense9): the natural-order remap puts
    every block in its slot."""
    from mxnet_tpu_torch.parallel import checkpoint as ck

    d = os.path.join(outdir, "wide-v2")
    rng = np.random.RandomState(0)
    bs = [(rng.randn(8, 6).astype(np.float32),
           rng.randint(0, 4, (8,)).astype(np.int32)) for _ in range(6)]
    tmx.random.seed(5)
    a = wide_step(tmx, wide_net(tmx))
    for x, y in bs[:3]:
        a(x, y)
    ck.save_train_step_sharded(a, d, async_save=False)
    ref = [float(a(x, y)) for x, y in bs[3:]]
    tmx.random.seed(77)
    b = wide_step(tmx, wide_net(tmx))
    b(*bs[0])
    ck.load_train_step_sharded(b, d)
    got = [float(b(x, y)) for x, y in bs[3:]]
    return {"wide/ref": np.array(ref), "wide/got": np.array(got),
            "wide/names": np.array([a._names[0], b._names[0]])}


def state_slots(tmx, outdir):
    """A v2 directory of a step with no momentum (0 state slots) into
    one with momentum: the JAX package's ValueError."""
    from mxnet_tpu_torch.parallel import checkpoint as ck

    d = os.path.join(outdir, "slots-v2")
    x = np.ones((8, 6), np.float32)
    y = np.zeros((8,), np.int32)
    a = wide_step(tmx, wide_net(tmx), momentum=0.0)
    a(x, y)
    ck.save_train_step_sharded(a, d, async_save=False)
    b = wide_step(tmx, wide_net(tmx), momentum=0.9)
    b(x, y)
    try:
        ck.load_train_step_sharded(b, d)
        msg = ""
    except ValueError as exc:
        msg = str(exc)
    return {"slots/error": np.array(msg)}


if __name__ == "__main__":
    worker(sys.argv[1])
    sys.exit(0)


# ------------------------------------------------------- the JAX side ---
import jax  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu import parallel as jparallel  # noqa: E402
from mxnet_tpu.parallel import checkpoint as jck  # noqa: E402
from mxnet_tpu_torch.parallel import checkpoint as ck  # noqa: E402
from test_torch_dp_step import (finish_gang, kill_gang,  # noqa: E402
                                random_params, start_gang)


def jnd(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(jnd(v) for v in x)
    return jmx.nd.array(x)


def jax_step(name, axis, values):
    jmx.random.seed(5)
    net = build(jmx, name)
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(values[k[len(name) + 1:]]))
    loss, opt = loss_and_opt(jmx, name)
    mesh = jparallel.make_mesh(**{axis: 2}, devices=jax.devices()[:2])
    return jparallel.TrainStep(net, loss, opt, mesh=mesh,
                               rules=rules_of(jmx, name, axis))


def jloss(step, data, lab):
    return float(np.asarray(step(jnd(data), jnd(lab))._data))


def jax_run(run, values, outdir):
    """The JAX step's trajectory with its v1.1 file saved after SAVE_AT
    steps; for a tp run also its resume from the port's file."""
    name, axis = RUNS[run]
    step = jax_step(name, axis, values)
    losses = []
    for i, (d, l) in enumerate(batches(name)):
        if i == SAVE_AT:
            jck.save_train_step(step, os.path.join(outdir, f"{run}-jax.npz"))
        losses.append(jloss(step, d, l))
    return np.array(losses)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("ckpt_sharded"))
    inputs = {}
    for name in ("mlp", "bert"):
        net = build(jmx, name)
        net.initialize()
        for k, v in random_params(net, seed=len(name)).items():
            inputs[f"{name}/{k[len(name) + 1:]}"] = v
    np.savez(os.path.join(outdir, "inputs.npz"), **inputs)
    proc = start_gang(os.path.abspath(__file__), outdir)
    try:
        jax_side = {run: jax_run(run, values_of(inputs, RUNS[run][0]),
                                 outdir) for run in RUNS}
    except BaseException:
        kill_gang(proc)
        raise
    return finish_gang(proc, outdir), jax_side, inputs, outdir


# ------------------------------------------------------------- the tests --
@pytest.mark.parametrize("run", sorted(RUNS))
def test_uninterrupted_runs_match_jax(gang, run):
    ranks, jax_side, _, _ = gang
    for res in ranks:
        np.testing.assert_allclose(res[f"{run}/losses"], jax_side[run],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_v1_file_is_the_jax_packages(gang, run):
    """The gathered one-file snapshot of the sharded step: the JAX
    package's entries, shapes and values, and its manifest's names."""
    _, _, _, outdir = gang
    port = np.load(os.path.join(outdir, f"{run}.npz"))
    ours = ck.verify_checkpoint(os.path.join(outdir, f"{run}.npz"))
    theirs = jck.verify_checkpoint(os.path.join(outdir, f"{run}-jax.npz"))
    with np.load(os.path.join(outdir, f"{run}-jax.npz")) as jz:
        assert sorted(port.files) == sorted(jz.files)
        for k in jz.files:
            if k == "__manifest__":
                continue
            assert port[k].shape == jz[k].shape, k
            np.testing.assert_allclose(port[k], jz[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
    for key in ("train_names", "aux_names", "optimizer", "num_update",
                "state_counts", "format"):
        assert ours[key] == theirs[key], key
    assert ours["num_update"] == SAVE_AT


@pytest.mark.parametrize("into", ("tp", "fsdp"))
@pytest.mark.parametrize("run", TP_RUNS)
def test_v1_file_resumes_in_the_gang(gang, run, into):
    ranks, _, _, _ = gang
    for res in ranks:
        np.testing.assert_allclose(res[f"{run}/v1/{into}"],
                                   res[f"{run}/losses"][SAVE_AT:],
                                   rtol=TOL, atol=TOL)


def world_of_one(name, values, load):
    with tmx.cpu():
        return resumed(port_step(tmx, name, None, values, scale=0.5), name,
                       None, load)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_v1_file_resumes_in_a_world_of_one(gang, run):
    ranks, _, inputs, outdir = gang
    name = RUNS[run][0]
    got = world_of_one(name, values_of(inputs, name), lambda s:
                       ck.load_train_step(s, os.path.join(outdir,
                                                          f"{run}.npz")))
    np.testing.assert_allclose(got, ranks[0][f"{run}/losses"][SAVE_AT:],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("run", TP_RUNS)
def test_each_package_loads_the_others_file(gang, run):
    """The JAX package resumes from the port's file of the tp step, the
    port from the JAX package's: both on the JAX package's losses."""
    _, jax_side, inputs, outdir = gang
    name, axis = RUNS[run]
    values = values_of(inputs, name)
    js = jax_step(name, axis, {k: 0.5 * v for k, v in values.items()})
    bs = batches(name)
    jloss(js, *bs[0])
    jck.load_train_step(js, os.path.join(outdir, f"{run}.npz"))
    theirs = [jloss(js, d, l) for d, l in bs[SAVE_AT:]]
    np.testing.assert_allclose(theirs, jax_side[run][SAVE_AT:], rtol=TOL,
                               atol=TOL)
    ours = world_of_one(name, values, lambda s: ck.load_train_step(
        s, os.path.join(outdir, f"{run}-jax.npz")))
    np.testing.assert_allclose(ours, jax_side[run][SAVE_AT:], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_v2_kill_and_resume(gang, run):
    """Killed after SAVE_AT steps, resumed from v2 in the same layout:
    the uninterrupted losses (the same code: exactly) and the JAX
    package's trajectory (rtol 1e-5)."""
    ranks, jax_side, _, _ = gang
    axis = RUNS[run][1]
    for res in ranks:
        got = res[f"{run}/v2/{axis}"]
        np.testing.assert_array_equal(got, res[f"{run}/losses"][SAVE_AT:])
        np.testing.assert_allclose(got, jax_side[run][SAVE_AT:], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_v2_keeps_the_placements(gang, run):
    """After a v2 load the step holds the same tensors, its sharded
    leaves still blocks with their placements."""
    ranks, _, _, outdir = gang
    for res in ranks:
        assert bool(res[f"{run}/v2/same_tensors"])
        placed = res[f"{run}/v2/placed"]
        assert placed.any()
        np.testing.assert_array_equal(res[f"{run}/v2/block_shapes"],
                                      res[f"{run}/blocks"])
    files = sorted(os.listdir(os.path.join(outdir, f"{run}-v2")))
    assert files == ["rank-0-of-2.npz", "rank-1-of-2.npz"]


def test_v2_rank_files_hold_blocks_only(gang):
    """Each rank file holds that rank's blocks: a split leaf is half of
    the whole in each, and the two halves make the v1.1 file's; a
    replicated entry is written once, by rank 0."""
    _, _, _, outdir = gang
    v1 = np.load(os.path.join(outdir, "mlp_tp.npz"))
    r0 = np.load(os.path.join(outdir, "mlp_tp-v2", "rank-0-of-2.npz"))
    r1 = np.load(os.path.join(outdir, "mlp_tp-v2", "rank-1-of-2.npz"))
    man = json.load(open(os.path.join(outdir, "mlp_tp-v2")
                            + ".manifest.json"))
    halves = whole = 0
    for k, ent in man["layout"]["entries"].items():
        if ent["spec"] is None or not any(ent["spec"]):
            np.testing.assert_array_equal(r0[k], v1[k])
            assert k not in r1.files, k
            assert [r for r, _ in ent["blocks"]] == [0], k
            whole += 1
            continue
        assert [r for r, _ in ent["blocks"]] == [0, 1], k
        d = [i for i, e in enumerate(ent["spec"]) if e][0]
        np.testing.assert_array_equal(np.concatenate([r0[k], r1[k]], d),
                                      v1[k])
        halves += 1
    assert halves >= 3 and whole >= 1


def test_v2_remaps_across_counter_orders(gang):
    ranks, _, _, _ = gang
    for res in ranks:
        a, b = res["wide/names"]
        assert a != b                           # other counters
        np.testing.assert_allclose(res["wide/got"], res["wide/ref"],
                                   rtol=1e-5, atol=1e-6)


def test_v2_state_slot_mismatch_raises(gang):
    ranks, _, _, _ = gang
    for res in ranks:
        assert "optimizer state slots" in str(res["slots/error"])


@pytest.mark.parametrize("run", TP_RUNS)
def test_v2_tp_loads_into_fsdp(gang, run):
    ranks, _, _, _ = gang
    for res in ranks:
        np.testing.assert_allclose(res[f"{run}/v2/fsdp"],
                                   res[f"{run}/losses"][SAVE_AT:],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("run", TP_RUNS)
def test_v2_tp_loads_into_a_world_of_one(gang, run):
    ranks, _, inputs, outdir = gang
    name = RUNS[run][0]
    got = world_of_one(name, values_of(inputs, name), lambda s:
                       ck.load_train_step_sharded(
                           s, os.path.join(outdir, f"{run}-v2")))
    np.testing.assert_allclose(got, ranks[0][f"{run}/losses"][SAVE_AT:],
                               rtol=TOL, atol=TOL)


def test_v2_damaged_rank_file_raises(gang, tmp_path):
    """One flipped bit in rank 1's file: the load raises
    CheckpointCorruptError and leaves the step as it was."""
    _, _, inputs, outdir = gang
    d = str(tmp_path / "bad")
    shutil.copytree(os.path.join(outdir, "mlp_tp-v2"), d)
    shutil.copy(os.path.join(outdir, "mlp_tp-v2") + ".manifest.json",
                d + ".manifest.json")
    f = os.path.join(d, "rank-1-of-2.npz")
    z = dict(np.load(f))
    key = max((k for k in z if k.startswith("p.")), key=lambda k: z[k].size)
    z[key] = z[key].copy()
    z[key].reshape(-1).view(np.uint8)[5] ^= 4
    np.savez(f, **z)
    with tmx.cpu():
        step = port_step(tmx, "mlp", None, values_of(inputs, "mlp"))
        x, y = batches("mlp")[0]
        step(x, y)
        before = [t.detach().clone() for t in step._train]
        with pytest.raises(ck.CheckpointCorruptError, match="crc32"):
            ck.load_train_step_sharded(step, d)
        for a, b in zip(before, step._train):
            assert torch.equal(a, b)


@pytest.mark.parametrize("other", ("twin", "late"))
def test_v2_rank_file_of_another_save_raises(gang, tmp_path, other):
    """Rank 1's file of another save planted beside the directory's
    manifest — of the same step (``twin``) or of a later one (``late``),
    as a re-save cut short would leave it: the load raises
    CheckpointCorruptError and leaves the step as it was."""
    _, _, inputs, outdir = gang
    src = os.path.join(outdir, "mlp_tp-v2")
    d = str(tmp_path / "mixed")
    shutil.copytree(src, d)
    shutil.copy(src + ".manifest.json", d + ".manifest.json")
    shutil.copy(os.path.join(f"{src}-{other}", "rank-1-of-2.npz"),
                os.path.join(d, "rank-1-of-2.npz"))
    with tmx.cpu():
        step = port_step(tmx, "mlp", None, values_of(inputs, "mlp"))
        step(*batches("mlp")[0])
        before = [t.detach().clone() for t in step._train]
        what = "save_id" if other == "twin" else "num_update"
        with pytest.raises(ck.CheckpointCorruptError,
                           match=f"another save: its {what}"):
            ck.load_train_step_sharded(step, d)
        for a, b in zip(before, step._train):
            assert torch.equal(a, b)


def test_v2_directory_without_its_manifest_is_refused(gang, tmp_path):
    """A re-save cut before its manifest was committed leaves none: the
    load refuses the directory."""
    _, _, inputs, outdir = gang
    d = str(tmp_path / "cut")
    shutil.copytree(os.path.join(outdir, "mlp_tp-v2-late"), d)
    with tmx.cpu():
        step = port_step(tmx, "mlp", None, values_of(inputs, "mlp"))
        step(*batches("mlp")[0])
        with pytest.raises(ValueError, match="missing .*manifest.json"):
            ck.load_train_step_sharded(step, d)


def v2_round_trip(device, d):
    """A world-of-one step on ``device`` saved as v2 after SAVE_AT steps
    and loaded in place into a second step built on the first batch:
    the uninterrupted losses, the resumed ones, and whether the second
    step kept its tensors."""
    from mxnet_tpu_torch import parallel

    rng = np.random.RandomState(0)
    bs = [(torch.from_numpy(rng.randn(MLP_B, 16).astype(np.float32))
           .to(device), torch.from_numpy(rng.randint(0, 10, (MLP_B,))
                                         .astype(np.int32)).to(device))
          for _ in range(STEPS)]
    ctx = tmx.cpu() if device == "cpu" else tmx.gpu(0)

    def step_of(scale):
        tmx.random.seed(5)
        net = build(tmx, "mlp")
        net.initialize(ctx=ctx)
        for p in net.collect_params().values():
            p.set_data(p.data() * scale)
        loss, opt = loss_and_opt(tmx, "mlp")
        return parallel.TrainStep(net, loss, opt)

    a, ref = step_of(1.0), []
    for i, (x, y) in enumerate(bs):
        if i == SAVE_AT:
            ck.save_train_step_sharded(a, d).wait_until_finished()
        ref.append(float(a(x, y)))
    b = step_of(0.5)
    b(*bs[0])
    held = [t.data_ptr() for t in b._train]
    ck.load_train_step_sharded(b, d)
    kept = held == [t.data_ptr() for t in b._train]
    return ref[SAVE_AT:], [float(b(x, y)) for x, y in bs[SAVE_AT:]], kept, \
        (a.graph_count(), b.graph_count())


def test_v2_round_trip_in_place_in_a_world_of_one(tmp_path):
    with tmx.cpu():
        ref, got, kept, _ = v2_round_trip("cpu", str(tmp_path / "v2"))
    assert got == ref and kept


@pytest.mark.gpu
def test_v2_round_trip_of_a_captured_step_on_the_card(tmp_path):
    """On the card: the same round trip between two captured steps (one
    graph each, the second's tensors written in place)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    ref, got, kept, graphs = v2_round_trip("cuda", str(tmp_path / "v2"))
    assert got == ref and kept and graphs == (1, 1)
