"""Port parity: the steps that the card captures as CUDA graphs, run
eagerly on the CPU against the JAX package.

On the card ``TrainStep``, ``EvalStep`` and the ``GenerationServer``'s
steps are captured (``mxnet_tpu_torch.graphs``); on the CPU the same
step bodies run eagerly, and that body is what these tests hold:

- ``functional_opt.multi_update`` (``torch._foreach_*``) equals the
  per-tensor ``pure_update`` bit for bit — SGD with and without momentum,
  clipping and rescale; LAMB with both trust-ratio bounds and without
  bias correction; f32 weights and bf16 weights with f32 masters — and
  matches the JAX ``functional_opt`` at ``test_torch_lamb``'s
  tolerances (rtol 1e-5, atol 1e-6);
- five steps of a small ResNet (SGD) and of the 2-layer BERT (units 32,
  LAMB with bias correction) track the JAX ``TrainStep`` under a
  ``FactorScheduler``: the step count and the learning rate live on the
  device and advance (losses and parameters within 1e-3 and 1e-4, the
  tolerances of ``test_torch_train_step`` and ``test_torch_lamb``);
- ``skip_nonfinite``: a NaN batch leaves every parameter, optimizer
  state, running statistic and ``t`` as they were (the branch-free
  select);
- ``EvalStep`` outputs match the JAX ``EvalStep``;
- the flash op's seed from device memory equals the int seed, and two
  successive calls draw other masks (the same again after a reseed);
- ``census()`` equals the JAX server's; greedy rows stay the argmax with
  both sampling arms computed;
- ``python -m mxnet_tpu_torch.bench llm --device cpu`` prints
  ``bench.py``'s metric name;
- the port's ``lr_scheduler`` copy gives the JAX package's rates.

Card-only cases (``gpu`` marker): the captured tiny ResNet step equals
the eager one bit for bit over three steps, a server's
``graph_count()`` equals its ``census()`` after ``start()``, and the
kernels' launch counters advance on replay.
"""
import contextlib
import gc
import importlib
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.parallel import functional_opt as jfo
from mxnet_tpu.serving import BucketSpec as JBucketSpec
from mxnet_tpu.serving import GenerationServer as JGenerationServer
from mxnet_tpu.serving import generate as jgen
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import bench as tbench
from mxnet_tpu_torch import gluon, graphs, lr_scheduler, optimizer, parallel
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch import ops
from mxnet_tpu_torch.gluon.model_zoo import causal_lm as tlm
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.parallel import functional_opt as tfo
from mxnet_tpu_torch.serving import BucketSpec, GenerationServer
from mxnet_tpu_torch.serving import generate as tgen
from test_torch_bert import batch as bert_batch
from test_torch_bert import jax_arrays, jax_net, port_net
from test_torch_generate import JCFG, JP, TCFG, TP
from test_torch_lamb import _jax_loss_fn, _port_loss_fn
from test_torch_resnet import SMALL, map_unfused_to_fused
from test_torch_train_step import _batch, _port_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=1e-3)
LAMB_TOL = dict(rtol=1e-5, atol=1e-6)
gpu = pytest.mark.gpu

# the module (the attribute ``ops.flash_attention`` is the (B, S, H*D) op)
tfa = importlib.import_module("mxnet_tpu_torch.ops.flash_attention")


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    """Collect this module's cyclic garbage (JAX-side arrays among it)
    before the next module runs in the same worker."""
    yield
    gc.collect()


# ------------------------------------------------------ multi-tensor opt --
OPTS = [("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-4)),
        ("sgd", dict(learning_rate=0.1, wd=1e-4, clip_gradient=0.5,
                     rescale_grad=0.5)),
        ("lamb", dict(learning_rate=1e-3, wd=0.01)),
        ("lamb", dict(learning_rate=1e-3, wd=0.01, lower_bound=0.5,
                      upper_bound=2.0)),
        ("lamb", dict(learning_rate=1e-3, wd=0.01, bias_correction=False))]
SHAPES = [(7, 5), (3,), (4, 2, 3)]
LR_MULTS, WD_MULTS = [1.0, 2.0, 1.0], [1.0, 0.0, 1.0]


def _weights(rng, dtype):
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dtype)
            for s in SHAPES]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", OPTS)
def test_multi_update_equals_the_per_tensor_update(name, kw, dtype):
    """Three steps over three weights with per-weight lr/wd multipliers,
    ``t`` and the learning rate as 0-d tensors: weights and every state
    (bf16: the f32 master among them) bit for bit the per-tensor ones."""
    rng = np.random.RandomState(0)
    dt = getattr(torch, dtype)
    opt = optimizer.create(name, **kw)
    w0 = _weights(rng, dt)
    wa, wb = [w.clone() for w in w0], [w.clone() for w in w0]
    sa = [tfo.state_template(opt, w) for w in wa]
    sb = [tfo.state_template(opt, w) for w in wb]
    for t in range(1, 4):
        gs = _weights(rng, dt)
        lr = 0.1 * t
        with torch.no_grad():
            for k in range(3):
                tfo.pure_update(opt, wa[k], gs[k], sa[k], t,
                                lr * LR_MULTS[k], opt.wd * WD_MULTS[k])
            tfo.multi_update(opt, wb, gs, sb, torch.tensor(t),
                             torch.tensor(lr), LR_MULTS, WD_MULTS)
    for a, b in zip(wa, wb):
        assert a.dtype == dt and torch.equal(a, b)
    for a, b in zip(sa, sb):
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    if dtype == "bfloat16":
        assert all(torch.equal(w, s[-1].to(dt)) for w, s in zip(wb, sb))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", OPTS)
def test_multi_update_matches_jax_functional_opt(name, kw, dtype):
    rng = np.random.RandomState(1)
    w0 = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(3)]
    jopt = mx.optimizer.create(name, **kw)
    topt = optimizer.create(name, **kw)
    jw = [jnp.asarray(w).astype(dtype) for w in w0]
    js = [jfo.state_template(jopt, w) for w in jw]
    # copies: jnp.asarray aliases a 64-byte-aligned array on the CPU,
    # and the in-place updates would then move the reference's too
    tw = [torch.tensor(w, dtype=getattr(torch, dtype)) for w in w0]
    ts = [tfo.state_template(topt, w) for w in tw]
    for t, gs in enumerate(grads, 1):
        for k in range(3):
            jw[k], js[k] = jfo.pure_update(
                jopt, jw[k], jnp.asarray(gs[k]).astype(dtype), js[k],
                jnp.int32(t), 0.1 * LR_MULTS[k], jopt.wd * WD_MULTS[k])
        with torch.no_grad():
            tfo.multi_update(topt, tw, [torch.from_numpy(g).to(tw[0].dtype)
                                        for g in gs], ts,
                             torch.tensor(t, dtype=torch.int32),
                             torch.tensor(0.1), LR_MULTS, WD_MULTS)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   **LAMB_TOL)
    for sa, sb in zip(ts, js):
        for a, b in zip(sa, sb):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b.astype(jnp.float32)),
                                       **LAMB_TOL)


@pytest.mark.parametrize("name", ["sgd", "lamb"])
def test_multi_update_keeps_everything_where_not_finite(name):
    opt = optimizer.create(name, **dict(OPTS[0 if name == "sgd" else 2][1]))
    rng = np.random.RandomState(2)
    ws = _weights(rng, torch.bfloat16)
    states = [tfo.state_template(opt, w) for w in ws]
    with torch.no_grad():      # one finite step first: non-zero states
        tfo.multi_update(opt, ws, _weights(rng, torch.bfloat16), states,
                         torch.tensor(1), torch.tensor(0.1), LR_MULTS,
                         WD_MULTS, finite=torch.tensor(True))
    before = [w.clone() for w in ws] + [s.clone() for st in states
                                        for s in st]
    bad = _weights(rng, torch.bfloat16)
    bad[1][0] = float("nan")
    with torch.no_grad():
        tfo.multi_update(opt, ws, bad, states, torch.tensor(2),
                         torch.tensor(0.1), LR_MULTS, WD_MULTS,
                         finite=torch.tensor(False))
    after = ws + [s for st in states for s in st]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


# ------------------------------------------------------------ lr schedule --
@pytest.mark.parametrize("make", [
    lambda m: m.FactorScheduler(step=3, factor=0.5, base_lr=0.1,
                                warmup_steps=2, warmup_begin_lr=0.01),
    lambda m: m.MultiFactorScheduler(step=[2, 5], factor=0.1, base_lr=1.0),
    lambda m: m.PolyScheduler(max_update=9, base_lr=0.2, pwr=2,
                              final_lr=0.01, warmup_steps=1),
    lambda m: m.CosineScheduler(max_update=8, base_lr=0.3, final_lr=0.0,
                                warmup_steps=2, warmup_mode="constant",
                                warmup_begin_lr=0.05)])
def test_lr_scheduler_copy_gives_the_jax_package_rates(make):
    js, ts = make(jsched), make(lr_scheduler)
    assert [ts(n) for n in range(12)] == [js(n) for n in range(12)]
    assert lr_scheduler.__file__ != jsched.__file__


# ------------------------------------------------------ train step + JAX --
def _factor():
    return dict(step=2, factor=0.5, base_lr=0.1)


def _jax_resnet(x, seed):
    """The small JAX ResNet with non-trivial BatchNorm parameters (as
    ``test_torch_train_step`` sets them)."""
    from mxnet_tpu import autograd as jag
    from mxnet_tpu.gluon.model_zoo.vision import resnet as jres

    jnet = jres.ResNetV1(jres.BottleneckV1, **SMALL)
    jnet.initialize()
    with jag.pause():
        jnet(mx.nd.array(x[:1]))
    rng = np.random.RandomState(seed)
    for p in jnet.collect_params().values():
        if p.name.endswith(("gamma", "running_var")):
            p.set_data(mx.nd.array(rng.rand(*p.shape).astype(np.float32)
                                   + 0.5))
        elif p.name.endswith(("beta", "running_mean")):
            p.set_data(mx.nd.array(0.1 * rng.randn(*p.shape)
                                   .astype(np.float32)))
    return jnet


def test_five_resnet_steps_track_jax_with_a_factor_scheduler():
    x, y = _batch(n=4, hw=64, seed=5)
    from mxnet_tpu import gluon as jgluon

    jnet = _jax_resnet(x, seed=1)
    plain = _port_net(False, x)
    tres.params_from_jax(plain, {k: p.data().asnumpy() for k, p in
                                 jnet.collect_params().items()})
    fused = _port_net(True, x)
    map_unfused_to_fused(plain, fused)
    sgd = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
    mesh = jparallel.make_mesh(dp=1, devices=jax.devices()[:1])
    jstep = jparallel.TrainStep(
        jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), mx.optimizer.create(
            "sgd", lr_scheduler=jsched.FactorScheduler(**_factor()), **sgd),
        mesh=mesh)
    tstep = parallel.TrainStep(
        fused, gluon.loss.SoftmaxCrossEntropyLoss(), optimizer.create(
            "sgd", lr_scheduler=lr_scheduler.FactorScheduler(**_factor()),
            **sgd))
    jl, tl, lrs = [], [], []
    for _ in range(5):
        jl.append(float(jstep(x, y).asnumpy()))
        tl.append(float(tstep(x, y)))
        lrs.append(float(tstep._lr))
    np.testing.assert_allclose(tl, jl, **TOL)
    assert lrs == [float(np.float32(v)) for v in (0.1, 0.05, 0.05, 0.025,
                                                  0.025)]
    assert int(tstep._t) == 5 and tstep.optimizer.num_update == 5
    assert tstep.graph_count() == 0          # the CPU runs the body eagerly
    jstep.sync_params_to_net()
    ref = _port_net(False, x)
    tres.params_from_jax(ref, {k: p.data().asnumpy() for k, p in
                               jnet.collect_params().items()})
    ref_fused = _port_net(True, x)
    map_unfused_to_fused(ref, ref_fused)
    tstep.sync_params_to_net()
    want, got = ref_fused.collect_params(), fused.collect_params()
    for a, b in zip(sorted(tres._strip(got.keys()).items()),
                    sorted(tres._strip(want.keys()).items())):
        np.testing.assert_allclose(got[a[1]].tensor().detach().numpy(),
                                   want[b[1]].tensor().detach().numpy(),
                                   **TOL, err_msg=a[0])


def test_five_bert_steps_track_jax_with_a_factor_scheduler():
    data, labels = bert_batch(seed=12, b=4)
    jnet = jax_net("flash", seed=13)
    tnet = port_net("flash", jnet)
    lamb = dict(learning_rate=1e-3, wd=0.01, bias_correction=True)
    sched = dict(step=2, factor=0.5, base_lr=1e-3)
    mesh = jparallel.make_mesh(dp=1, devices=jax.devices()[:1])
    jstep = jparallel.TrainStep(jnet, _jax_loss_fn(), mx.optimizer.create(
        "lamb", lr_scheduler=jsched.FactorScheduler(**sched), **lamb),
        mesh=mesh)
    tstep = parallel.TrainStep(tnet, _port_loss_fn(), optimizer.create(
        "lamb", lr_scheduler=lr_scheduler.FactorScheduler(**sched), **lamb))
    jl, tl, ts = [], [], []
    for _ in range(5):
        jl.append(float(jstep(data, labels).asnumpy()))
        tl.append(float(tstep(list(data), list(labels))))
        ts.append(int(tstep._t))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    assert ts == [1, 2, 3, 4, 5]
    assert float(tstep._lr) == float(np.float32(2.5e-4))
    jstep.sync_params_to_net()
    tstep.sync_params_to_net()
    want = {k: jax_arrays(jnet)[n] for k, n in
            tres._strip(jax_arrays(jnet)).items()}
    got = {k: p.tensor().detach().numpy()
           for k, p in tnet.collect_params().items()}
    got = {k: got[n] for k, n in tres._strip(got).items()}
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["sgd", "lamb"])
def test_skip_nonfinite_leaves_every_leaf_and_t_unchanged(name):
    x, y = _batch(n=2, hw=32, seed=6)
    net = _port_net(True, x, dtype="bfloat16")
    kw = dict(OPTS[0 if name == "sgd" else 2][1])
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              optimizer.create(name, **kw),
                              skip_nonfinite=True, nonfinite_budget=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    step(xb, y)

    def leaves():
        return ([t.detach().clone() for t in step._train + step._aux]
                + [s.clone() for st in step._states for s in st]
                + [step._t.clone()])
    before = leaves()
    bad = xb.clone()
    bad[1, 3, 3, 0] = float("inf")
    loss = step(bad, y)
    assert not np.isfinite(float(loss))
    assert step.skipped_steps == 1 and step.optimizer.num_update == 1
    assert all(torch.equal(a, b) for a, b in zip(before, leaves()))
    assert int(step._t) == 1
    step(xb, y)
    assert int(step._t) == 2 and step.consecutive_skips == 0


def test_eval_step_matches_the_jax_eval_step():
    x, _ = _batch(n=3, hw=32, seed=7)
    jnet = _jax_resnet(x, seed=8)
    plain = _port_net(False, x)
    tres.params_from_jax(plain, {k: p.data().asnumpy() for k, p in
                                 jnet.collect_params().items()})
    fused = _port_net(True, x)
    map_unfused_to_fused(plain, fused)
    mesh = jparallel.make_mesh(dp=1, devices=jax.devices()[:1])
    want = jparallel.EvalStep(jnet, mesh=mesh)(mx.nd.array(x)).asnumpy()
    ev = parallel.EvalStep(fused)
    got = ev(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(ev(torch.from_numpy(x)), got)
    assert ev.graph_count() == 0
    with pytest.raises(NotImplementedError, match="mesh"):
        parallel.EvalStep(fused, mesh=object())

    # BERT: the four outputs in the net's structure
    data, _ = bert_batch(seed=14, b=2)
    jb = jax_net("dense", seed=15)
    tb = port_net("dense", jb)
    jout = jparallel.EvalStep(jb, mesh=mesh)(*data)
    tout = parallel.EvalStep(tb)(*data)
    assert isinstance(tout, tuple) and len(tout) == len(jout) == 4
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), b.asnumpy(), rtol=1e-4,
                                   atol=1e-4)


def test_capture_needs_the_card():
    x, y = _batch(n=2, hw=32, seed=9)
    net = _port_net(False, x)
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              optimizer.create("sgd", learning_rate=0.1),
                              capture=True)
    with pytest.raises(ValueError, match="CUDA graph needs the card"):
        step(x, y)
    with pytest.raises(ValueError, match="capture=True needs the card"):
        GenerationServer(TP, TCFG, device="cpu", capture=True)
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.StepGraph("cpu")
    eager = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                               optimizer.create("sgd", learning_rate=0.1),
                               capture=False)
    assert np.isfinite(float(eager(x, y))) and eager.graph_count() == 0


def test_launch_counts_name_every_kernel():
    counts = graphs.launch_counts()
    assert set(counts) == {"flash_attention_fwd", "flash_attention_dq",
                           "flash_attention_dkv", "fused_conv_fwd",
                           "fused_conv_dx", "fused_conv_dw",
                           "paged_decode_attention"}
    graphs._add_launches({"fused_conv_dx": 3, "paged_decode_attention": 2})
    after = graphs.launch_counts()
    graphs._add_launches({"fused_conv_dx": 3, "paged_decode_attention": 2},
                         -1)
    assert after["fused_conv_dx"] == counts["fused_conv_dx"] + 3
    assert after["paged_decode_attention"] == \
        counts["paged_decode_attention"] + 2
    assert graphs.launch_counts() == counts


# ------------------------------------------------------- flash device seed --
def _qkv(seed, shape=(3, 32, 8)):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            .requires_grad_(True) for _ in range(3)]


def test_flash_seed_from_a_tensor_equals_the_int_seed():
    outs = []
    for seed in (7, torch.tensor(7, dtype=torch.int32)):
        q, k, v = _qkv(16)
        o = tfa.flash_attention(q, k, v, dropout=0.25, seed=seed)
        o.sum().backward()
        outs.append([o.detach(), q.grad, k.grad, v.grad])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    big = tfa.flash_attention(*_qkv(16), dropout=0.25, seed=2 ** 31 + 9)
    wrapped = tfa.flash_attention(*_qkv(16), dropout=0.25, seed=torch.tensor(
        -(2 ** 31) + 9, dtype=torch.int32))
    assert torch.equal(big, wrapped)
    with pytest.raises(TypeError, match="int32"):
        tfa.seed_tensor(torch.tensor(7), torch.device("cpu"))


def test_flash_op_draws_new_masks_per_call_and_repeats_after_a_reseed():
    b, s, h, d = 2, 32, 3, 8
    rng = np.random.RandomState(17)
    q, k, v = (torch.from_numpy(rng.randn(b, s, h * d).astype(np.float32))
               for _ in range(3))

    def two_calls():
        with tag.train_mode():
            return [ops.flash_attention(q, k, v, heads=h, dropout=0.25)
                    for _ in range(2)]
    trandom.seed(4)
    first = two_calls()
    assert not torch.equal(*first)
    trandom.seed(4)
    again = two_calls()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    trandom.seed(4)
    seeds = [int(trandom.next_seed_tensor("cpu")) for _ in range(3)]
    assert seeds[0] == trandom._first_draw(4) and len(set(seeds)) == 3
    assert all(-2 ** 31 <= x < 2 ** 31 for x in seeds)


# ------------------------------------------------------------------ serving --
def test_census_equals_the_jax_servers():
    geo = dict(n_slots=2, n_pages=17, page_size=4, max_new_tokens=4)
    buckets = dict(batch=(1, 2), length=(4, 8))
    js = JGenerationServer(JP, JCFG, buckets=JBucketSpec(**buckets),
                           attention_impl="jnp", name="CensusJax", **geo)
    ts = GenerationServer(TP, TCFG, buckets=BucketSpec(**buckets),
                          device="cpu", name="CensusTorch", **geo)
    for srv in (js, ts):
        srv.start()
    try:
        assert ts.census() == js.census() == 5
        assert ts.graph_count() == 0            # eager on the CPU
    finally:
        for srv in (js, ts):
            assert srv.drain(30)


def test_all_greedy_and_mixed_batches_equal_jax_with_both_arms_computed():
    """An all-greedy batch (which no longer skips the noise) and a mixed
    one: the port's tokens are the JAX server's, the greedy rows the
    argmax."""
    rng = np.random.RandomState(18)
    logits = (2.0 * rng.randn(8, 48)).astype(np.float32)
    seeds = rng.randint(0, 2 ** 31, 8).astype(np.int64)
    positions = rng.randint(0, 64, 8).astype(np.int32)
    topks = np.asarray([0, 5] * 4, np.int32)
    for temps in (np.zeros(8, np.float32),
                  np.asarray([0, 0.7, 0, 1.0, 0, 1.3, 0, 0.5], np.float32)):
        ref = np.asarray(jgen._sample_tokens(*(jnp.asarray(a) for a in (
            logits, seeds.astype(np.uint32), positions, temps, topks))))
        out = tgen._sample_tokens(*(torch.from_numpy(a) for a in (
            logits, seeds, positions, temps, topks))).numpy()
        np.testing.assert_array_equal(out, ref)
        greedy = temps == 0
        np.testing.assert_array_equal(out[greedy],
                                      logits.argmax(-1)[greedy])


def test_port_bench_prints_the_bench_metric_names():
    spec = importlib.util.spec_from_file_location(
        "repo_bench", os.path.join(REPO, "bench.py"))
    rbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rbench)
    out = io.StringIO()
    cfg = tlm.CausalLMConfig(vocab_size=48, n_layers=2, n_heads=2,
                             head_dim=8, d_ff=32)
    with contextlib.redirect_stdout(out):
        rc = tbench.main(["llm", "--device", "cpu"], config=cfg,
                         n_requests=4)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["metric"] == rbench._METRIC_NAMES["llm"]
    assert tbench.METRIC_NAMES == rbench._METRIC_NAMES    # all five
    assert line["unit"] == "tokens/s/cpu" and line["device"] == "cpu"
    assert line["sequences"] == 4 and line["census"] == 7
    assert line["value"] > 0 and line["graphs"] == 0


# -------------------------------------------------------------- on the card --
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")


@gpu
def test_captured_resnet_step_equals_the_eager_step_bit_for_bit():
    _needs_card()
    x, y = _batch(n=4, hw=64, seed=19)
    results = []
    for capture in (False, None):
        from mxnet_tpu_torch import initializer
        initializer.seed(0)
        net = tres.ResNetV1(tres.BottleneckV1, **SMALL, fused=True)
        net.initialize(ctx="cuda")
        net.cast("bfloat16")
        xb = torch.from_numpy(x).cuda().to(torch.bfloat16)
        with tag.pause():
            net(xb[:1])
        step = parallel.TrainStep(
            net, gluon.loss.SoftmaxCrossEntropyLoss(),
            optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                             wd=1e-4), capture=capture)
        losses = [float(step(xb, torch.from_numpy(y).cuda()))
                  for _ in range(3)]
        results.append((losses, [t.detach().clone() for t in
                                 step._train + step._aux]))
        assert step.graph_count() == (1 if capture is None else 0)
    assert results[0][0] == results[1][0]
    assert all(torch.equal(a, b) for a, b in zip(results[0][1],
                                                 results[1][1]))


@gpu
def test_server_graph_count_equals_census_after_start():
    _needs_card()
    cfg = tlm.CausalLMConfig(vocab_size=64, n_layers=2, n_heads=2,
                             head_dim=64, d_ff=64)
    params = tlm.init_causal_lm(cfg, torch.Generator().manual_seed(0),
                                device="cuda")
    srv = GenerationServer(params, cfg, buckets=BucketSpec(batch=(1, 2),
                                                           length=(8, 16)),
                           n_slots=4, n_pages=33, page_size=16,
                           max_new_tokens=4, device="cuda",
                           name="TorchCardCensus")
    srv.start()
    try:
        assert srv.graph_count() == srv.census() == 5
        from mxnet_tpu_torch.ops.paged_attention import \
            paged_decode_attention
        before = paged_decode_attention.launches
        out = srv.submit(np.arange(1, 6, dtype=np.int32)).result(timeout=60)
        assert len(out) == 4
        assert paged_decode_attention.launches - before >= 3 * cfg.n_layers
        assert srv.graph_count() == srv.census()
    finally:
        assert srv.drain(30)


@gpu
def test_captured_flash_step_counts_launches_and_draws_new_masks():
    _needs_card()
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTModel,
                                                      BERTPretrainLoss)
    trandom.seed(0)
    net = BERTModel(vocab_size=100, units=128, hidden_size=256,
                    num_layers=2, num_heads=2, max_length=64, dropout=0.1,
                    attention_impl="flash")
    net.initialize(ctx="cuda")
    data, labels = bert_batch(seed=20, b=2)
    blk = BERTPretrainLoss()
    step = parallel.TrainStep(
        net, lambda out, lab: blk(out[3].float(), out[2].float(), *lab),
        optimizer.create("lamb", learning_rate=0.0, wd=0.0))
    before = dict(tfa.flash_attention.launches)
    losses = [float(step(list(data), list(labels))) for _ in range(3)]
    launched = {k: tfa.flash_attention.launches[k] - before[k]
                for k in before}
    assert launched == dict.fromkeys(("fwd", "dq", "dkv"), 2 * 3)
    assert step.graph_count() == 1 and len(set(losses)) == 3


# ---------------------------------------------------------- owned streams --
class _FakeStream:
    def __init__(self, ptr):
        self.cuda_stream, self.device = ptr, torch.device("cuda", 0)


def _fake_streams(monkeypatch):
    """``graphs``'s stream bookkeeping on the CPU: streams made by a
    counter, device syncs counted, the module's lists fresh."""
    made, syncs = [], []

    def create(device):
        made.append(_FakeStream(0x1000 + len(made)))
        return made[-1]
    monkeypatch.setattr(graphs, "_create_stream", create)
    monkeypatch.setattr(graphs, "_idle", {})
    monkeypatch.setattr(graphs, "_released", [])
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: syncs.append(device))
    return made, syncs


def test_owned_streams_have_no_cap_and_are_reused_after_a_sync(
        monkeypatch):
    """More streams than torch's pool of 32 holds, every one distinct;
    streams given back are handed out again only after one device sync,
    and the paged kernel's launch plans made on them are dropped then."""
    from mxnet_tpu_torch.ops import paged_attention as tpa
    made, syncs = _fake_streams(monkeypatch)
    held = [graphs.owned_stream("cuda:0") for _ in range(40)]
    assert len({s.cuda_stream for s in held}) == 40 and not syncs
    monkeypatch.setattr(tpa, "_PLANS", {("shapes", 0, held[3].cuda_stream):
                                        "plan", ("shapes", 0, 1): "other"})
    for s in held[:4]:
        graphs.release_stream(s.device, s)
    again = [graphs.owned_stream("cuda:0") for _ in range(5)]
    assert len(syncs) == 1 and syncs[0] == torch.device("cuda", 0)
    assert {id(s) for s in again[:4]} == {id(s) for s in held[:4]}
    assert again[4] is made[-1] and len(made) == 41
    assert tpa._PLANS == {("shapes", 0, 1): "other"}


def test_a_freed_step_graph_gives_its_stream_back(monkeypatch):
    """A ``StepGraph`` holds its stream while it lives; freeing it gives
    the stream back (no CUDA call in the finaliser), and the next graph
    takes it after the sync."""
    made, syncs = _fake_streams(monkeypatch)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    g = graphs.StepGraph("cuda:0")
    first = g.stream
    assert graphs.StepGraph("cuda:0").stream is not first  # g still lives
    del g
    gc.collect()
    assert [s for _, s in graphs._released][-1] is first and not syncs
    assert graphs.StepGraph("cuda:0").stream in made[:2]
    assert len(syncs) == 1


@gpu
def test_graph_cache_captures_more_graphs_than_the_stream_pool_holds():
    """40 keys in one cache (torch's pool has 32 streams a priority):
    each graph on a stream of its own, each replay its key's result
    through a cuBLAS product; a new cache after the first is freed
    reuses the freed graphs' streams."""
    _needs_card()
    rng = np.random.RandomState(23)
    w = torch.from_numpy(rng.randn(256, 256).astype(np.float32)).cuda()
    x = torch.zeros(64, 256, device="cuda")
    cache = graphs.GraphCache("cuda")
    for rep in range(2):
        for k in range(40):
            x.fill_(float(k))
            out = cache.run(k, lambda k=k: (x @ w) * (k + 1))
            ref = (torch.full((64, 256), float(k), device="cuda") @ w) \
                * (k + 1)
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)
    streams = {g.stream.cuda_stream for g, _ in cache.held.values()}
    assert len(cache) == 40 and len(streams) == 40
    del cache
    gc.collect()
    second = graphs.GraphCache("cuda")
    second.run("again", lambda: x @ w)
    (g, _), = second.held.values()
    assert g.stream.cuda_stream in streams
