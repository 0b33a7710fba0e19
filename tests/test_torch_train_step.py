"""Port parity: ``mxnet_tpu_torch.parallel.TrainStep`` against the JAX
package's ``TrainStep`` — the training slice as a whole, on the CPU.

The small ``ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 32, 64, 128, 256])``
takes three SGD steps (lr 0.1, momentum 0.9, wd 1e-4) on the same seeded
batch on both sides in float32: the JAX step with ``fused=False`` (which
keeps Pallas out of its jit) on a one-device mesh, the port's with
``fused=True`` — its norm-relu-conv op, whose kernels' plain versions
run on the CPU — with the JAX parameters mapped into the fused layout.
The losses and the final parameters (running statistics included) agree
within 1e-3: f32 convs and batch statistics summed in another order,
through three updates.

Also: a bf16-cast step keeps f32 master weights and bf16 parameters;
``skip_nonfinite``; and the entry points raise without a card unless
given the CPU.

The update rules the JAX step has beyond SGD and LAMB (NAG, Adam, AdamW,
LARS, RMSProp plain and centred, AdaGrad, Signum): each, as the step's
``multi_update`` and as the per-tensor ``pure_update``, takes three
steps over three weights (per-weight lr/wd multipliers) against the
JAX ``pure_update``: f32 weights and every state within rtol 1e-5 /
atol 1e-6; bf16 weights with f32 masters: the masters and states
within the same, the bf16 weights within one bf16 rounding step
(2**-7 relative) of the JAX ones, each the master rounded.
``loss_reduce`` ``"sum"`` and ``"none"``: three SGD steps of an MLP
against the JAX step, losses and parameters within 1e-4.  On the card
(``gpu``): each rule's captured ``TrainStep`` against ``pure_update`` on
the host from the same gradients.
"""
import gc
import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.parallel import functional_opt as jfo
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import context, gluon, optimizer, parallel
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.parallel import functional_opt as tfo
from test_torch_resnet import SMALL, map_unfused_to_fused

TOL = dict(rtol=1e-3, atol=1e-3)
SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    """Collect this module's cyclic garbage (JAX-side arrays among it)
    before the next module runs in the same worker, so that module's
    memory accounting does not see it freed mid-test."""
    yield
    gc.collect()


def _batch(n=4, hw=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, hw, hw, 3).astype(np.float32),
            rng.randint(0, 10, (n,)).astype(np.int32))


def _port_net(fused, x, dtype=None):
    net = tres.ResNetV1(tres.BottleneckV1, **SMALL, fused=fused)
    net.initialize(ctx="cpu")
    if dtype:
        net.cast(dtype)
    with tag.pause():
        net(torch.from_numpy(x[:1]).to(getattr(torch, dtype or "float32")))
    return net


def _step(net):
    return parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              optimizer.create("sgd", **SGD))


def test_three_steps_match_the_jax_train_step():
    x, y = _batch()
    jnet = jres.ResNetV1(jres.BottleneckV1, **SMALL)
    jnet.initialize()
    with jag.pause():
        jnet(mx.nd.array(x[:1]))
    rng = np.random.RandomState(1)
    for p in jnet.collect_params().values():    # non-trivial BN params
        if p.name.endswith(("gamma", "running_var")):
            p.set_data(mx.nd.array(rng.rand(*p.shape).astype(np.float32)
                                   + 0.5))
        elif p.name.endswith(("beta", "running_mean")):
            p.set_data(mx.nd.array(0.1 * rng.randn(*p.shape)
                                   .astype(np.float32)))
    plain = _port_net(False, x)
    tres.params_from_jax(plain, {k: p.data().asnumpy() for k, p in
                                 jnet.collect_params().items()})
    fused = _port_net(True, x)
    map_unfused_to_fused(plain, fused)

    mesh = jparallel.make_mesh(dp=1, devices=jax.devices()[:1])
    jstep = jparallel.TrainStep(
        jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
        mx.optimizer.create("sgd", **SGD), mesh=mesh)
    tstep = _step(fused)
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(jstep(x, y).asnumpy()))
        tl.append(float(tstep(x, y)))
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]

    # final params: the JAX step's back into an unfused port net, that
    # net mapped into the fused layout, against the port step's
    jstep.sync_params_to_net()
    ref = _port_net(False, x)
    tres.params_from_jax(ref, {k: p.data().asnumpy() for k, p in
                               jnet.collect_params().items()})
    ref_fused = _port_net(True, x)
    map_unfused_to_fused(ref, ref_fused)
    tstep.sync_params_to_net()
    want = ref_fused.collect_params()
    got = fused.collect_params()
    for a, b in zip(sorted(tres._strip(got.keys()).items()),
                    sorted(tres._strip(want.keys()).items())):
        assert a[0] == b[0]
        np.testing.assert_allclose(got[a[1]].tensor().detach().numpy(),
                                   want[b[1]].tensor().detach().numpy(),
                                   **TOL, err_msg=a[0])


def test_bf16_step_keeps_f32_masters_and_bf16_params():
    x, y = _batch(n=2, hw=32, seed=2)
    net = _port_net(True, x, dtype="bfloat16")
    step = _step(net)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    losses = [float(step(xb, y)) for _ in range(2)]
    assert all(np.isfinite(losses))
    for t, s in zip(step._train, step._states):
        assert t.dtype == torch.bfloat16
        assert s[-1].dtype == torch.float32          # the master weight
        assert torch.equal(t, s[-1].to(torch.bfloat16))
    assert all(t.dtype == torch.bfloat16 for t in step._aux)
    step.sync_params_to_net()
    assert net.output.weight.tensor().dtype == torch.bfloat16


def test_skip_nonfinite_leaves_state_and_aborts_after_budget():
    x, y = _batch(n=2, hw=32, seed=3)
    net = _port_net(False, x)
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              optimizer.create("sgd", **SGD),
                              skip_nonfinite=True, nonfinite_budget=2)
    step(x, y)
    before = {k: v.detach().clone() for k, v in step.params.items()}
    bad = x.copy()
    bad[0, 0, 0, 0] = np.nan
    loss = step(bad, y)
    assert not np.isfinite(float(loss)) and step.skipped_steps == 1
    for k, v in step.params.items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(parallel.NonFiniteAbortError):
        step(bad, y)
    step(x, y)
    assert step.consecutive_skips == 0


# ---------------------------------------------------------- update rules --
RULES = [("nag", dict(learning_rate=0.1, momentum=0.9, wd=1e-4)),
         ("adam", dict(learning_rate=1e-2, wd=1e-3)),
         ("adamw", dict(learning_rate=1e-2, wd=1e-2, clip_gradient=1.0)),
         ("lars", dict(learning_rate=0.1, momentum=0.9, eta=0.01,
                       wd=1e-4)),
         ("rmsprop", dict(learning_rate=1e-3, wd=1e-4)),
         ("rmsprop", dict(learning_rate=1e-3, centered=True,
                          rescale_grad=0.5)),
         ("adagrad", dict(learning_rate=0.1, wd=1e-4, clip_gradient=0.5)),
         ("signum", dict(learning_rate=0.01, wd=1e-4, wd_lh=0.01))]
RULE_IDS = ["nag", "adam", "adamw", "lars", "rmsprop", "rmsprop_centered",
            "adagrad", "signum"]
SHAPES = [(7, 5), (3,), (4, 2, 3)]
LR_MULTS, WD_MULTS = [1.0, 2.0, 1.0], [1.0, 0.0, 1.0]
RULE_TOL = dict(rtol=1e-5, atol=1e-6)


def _rule_steps(topt, tw, ts, grads, form):
    """Three port updates of weights ``tw`` (states ``ts``) in place."""
    lr = topt.lr
    for t, gs in enumerate(grads, 1):
        gs = [torch.from_numpy(g).to(tw[0].dtype) for g in gs]
        with torch.no_grad():
            if form == "multi":
                tfo.multi_update(topt, tw, gs, ts,
                                 torch.tensor(t, dtype=torch.int32),
                                 torch.tensor(lr), LR_MULTS, WD_MULTS)
            else:
                for k in range(len(tw)):
                    tfo.pure_update(topt, tw[k], gs[k], ts[k], t,
                                    lr * LR_MULTS[k], topt.wd * WD_MULTS[k])


@pytest.mark.parametrize("form", ["multi", "pure"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", RULES, ids=RULE_IDS)
def test_update_rules_match_jax_pure_update(name, kw, dtype, form):
    rng = np.random.RandomState(3)
    w0 = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(3)]
    jopt = mx.optimizer.create(name, **kw)
    topt = optimizer.create(name, **kw)
    jw = [jnp.asarray(w).astype(dtype) for w in w0]
    js = [jfo.state_template(jopt, w) for w in jw]
    # copies: the port updates in place, and jnp.asarray may alias w0
    tw = [torch.tensor(w, dtype=getattr(torch, dtype)) for w in w0]
    ts = [tfo.state_template(topt, w) for w in tw]
    assert [len(s) for s in ts] == [len(s) for s in js]
    for t, gs in enumerate(grads, 1):
        for k in range(3):
            jw[k], js[k] = jfo.pure_update(
                jopt, jw[k], jnp.asarray(gs[k]).astype(dtype), js[k],
                jnp.int32(t), jopt.lr * LR_MULTS[k], jopt.wd * WD_MULTS[k])
    _rule_steps(topt, tw, ts, grads, form)
    for sa, sb in zip(ts, js):
        for a, b in zip(sa, sb):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b.astype(jnp.float32)),
                                       **RULE_TOL)
    for a, b in zip(tw, jw):
        want = np.asarray(b.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), want, **RULE_TOL)
        else:
            np.testing.assert_allclose(a.float().numpy(), want,
                                       rtol=2 ** -7, atol=1e-6)
    if dtype == "bfloat16":
        assert all(w.dtype == torch.bfloat16 and torch.equal(
            w, s[-1].to(torch.bfloat16)) for w, s in zip(tw, ts))
    assert not np.allclose(tw[0].float().numpy(), w0[0])


def _mlp_pair():
    jnet = jgluon.nn.HybridSequential(prefix="r_")
    with jnet.name_scope():
        jnet.add(jgluon.nn.Dense(16, activation="relu", in_units=12),
                 jgluon.nn.Dense(5, in_units=16))
    jnet.initialize()
    tnet = gluon.nn.HybridSequential(prefix="r_")
    with tnet.name_scope():
        tnet.add(gluon.nn.Dense(16, activation="relu", in_units=12),
                 gluon.nn.Dense(5, in_units=16))
    tnet.initialize(ctx="cpu")
    gluon.params_from_jax(tnet, {k: p.data().asnumpy() for k, p in
                                 jnet.collect_params().items()})
    return jnet, tnet


@pytest.mark.parametrize("reduce", ["sum", "none"])
def test_loss_reduce_matches_the_jax_train_step(reduce):
    rng = np.random.RandomState(5)
    x = rng.randn(8, 12).astype(np.float32)
    y = rng.randint(0, 5, 8).astype(np.int32)
    jnet, tnet = _mlp_pair()
    mesh = jparallel.make_mesh(dp=1, devices=jax.devices()[:1])
    jstep = jparallel.TrainStep(jnet, jgluon.loss.SoftmaxCrossEntropyLoss(),
                                mx.optimizer.create("sgd", **SGD), mesh=mesh,
                                loss_reduce=reduce, donate_batch=False)
    tstep = parallel.TrainStep(tnet, gluon.loss.SoftmaxCrossEntropyLoss(),
                               optimizer.create("sgd", **SGD),
                               loss_reduce=reduce, donate_batch=True)
    jl = [float(jstep(x, y).asnumpy()) for _ in range(3)]
    tl = [float(tstep(x, y)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    jstep.sync_params_to_net()
    tstep.sync_params_to_net()
    for (k, p), q in zip(tnet.collect_params().items(),
                         jnet.collect_params().values()):
        np.testing.assert_allclose(p.tensor().detach().numpy(),
                                   q.data().asnumpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    with pytest.raises(ValueError, match="loss_reduce"):
        parallel.TrainStep(tnet, gluon.loss.SoftmaxCrossEntropyLoss(),
                           optimizer.create("sgd"), loss_reduce="max")


def test_entry_points_need_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default context is valid here")
    net = tres.resnet50_v1(layout="NHWC", fused=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net.initialize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        context.gpu(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        context.current_context()
    assert context.cpu() == torch.device("cpu")
    net.initialize(ctx=context.cpu())
    assert len(net.collect_params()) == 267


def test_resnet50_v1_names_and_fused_layers():
    """Full-width ResNet-50 v1 with ``fused=True``: 16 bottlenecks, each
    with two NormReluConv2D layers (the 32 launches of each kernel per
    step), and the JAX net's parameter names."""
    t = tres.resnet50_v1(layout="NHWC", fused=True)
    j = jres.resnet50_v1(layout="NHWC", fused=True)
    assert set(tres._strip(t.collect_params().keys())) == \
        set(tres._strip(j.collect_params().keys()))
    fused = [m for m in t.modules() if isinstance(m, gluon.nn.NormReluConv2D)]
    assert len(fused) == 32
    assert {m._k for m in fused} == {1, 3}


@pytest.mark.gpu
def test_card_train_step_matches_cpu_train_step():
    """The small fused net's TrainStep on the card (the kernels) against
    the same on the CPU (their plain versions), float32: three losses
    within 1e-3, and every fused layer launched each kernel once per
    step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    from mxnet_tpu_torch.ops.fused_conv import norm_relu_conv

    x, y = _batch(seed=4)
    cpu_net = _port_net(True, x)
    card_net = tres.ResNetV1(tres.BottleneckV1, **SMALL, fused=True)
    card_net.initialize(ctx="cuda")
    with tag.pause():
        card_net(torch.from_numpy(x[:1]).cuda())
    src = cpu_net.collect_params()
    dst = card_net.collect_params()
    for a, b in zip(sorted(tres._strip(src.keys()).items()),
                    sorted(tres._strip(dst.keys()).items())):
        dst[b[1]].set_data(src[a[1]].data())
    before = dict(norm_relu_conv.launches)
    losses = {}
    for label, net in (("cpu", cpu_net), ("cuda", card_net)):
        step = _step(net)
        losses[label] = [float(step(x, y)) for _ in range(3)]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], **TOL)
    for k in ("fwd", "dx", "dw"):
        assert norm_relu_conv.launches[k] - before[k] == 8 * 3


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw", RULES, ids=RULE_IDS)
def test_card_train_step_rules_match_pure_update_on_the_host(name, kw):
    """Each rule in a captured bf16 TrainStep on the card, three steps
    of an MLP: the step's f32 masters against ``pure_update`` on the host
    fed the same gradients (each step's, computed on the card from the
    step's own weights), within rtol 1e-5 / atol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(8, 12).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 5, 8).astype(np.int32)).cuda()
    _, net = _mlp_pair()
    for p in net.collect_params().values():
        p.reset_ctx("cuda")
    net.cast("bfloat16")
    opt = optimizer.create(name, **kw)
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              opt)
    host_opt = optimizer.create(name, **kw)
    host_w = host_s = None
    for t in range(1, 4):
        if host_w is None:
            step._build((x.bfloat16(),), x.device)
            host_w = [w.detach().cpu().clone() for w in step._train]
            host_s = [tfo.state_template(host_opt, w) for w in host_w]
        # the step's weights as fresh leaves: an autograd node made for
        # the step's own leaves on this stream must not reach its capture
        leaves = [w.detach().clone().requires_grad_(True)
                  for w in step._train]
        tensors = [None] * len(step._plist)
        for i, w in zip(step._train_idx, leaves):
            tensors[i] = w
        for i, a in zip(step._aux_idx, step._aux):
            tensors[i] = a.clone()
        with tag.record(train_mode=True):
            out, _ = parallel.functional_call(net, step._plist, tensors,
                                              (x.bfloat16(),), True)
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(out, y).mean()
        grads = torch.autograd.grad(loss.float(), leaves)
        with torch.no_grad():
            for k, (w, g) in enumerate(zip(host_w, grads)):
                tfo.pure_update(host_opt, w, g.cpu(), host_s[k], t,
                                host_opt.lr, host_opt.wd)
        step(x.bfloat16(), y)
    assert step.graph_count() == 1
    for k, (a, b) in enumerate(zip(step._states, host_s)):
        for u, v in zip(a, b):
            torch.testing.assert_close(u.cpu(), v, rtol=1e-5, atol=1e-6)
