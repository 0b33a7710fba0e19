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
"""
import gc
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import context, gluon, optimizer, parallel
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
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
        np.testing.assert_allclose(got[a[1]].data().detach().numpy(),
                                   want[b[1]].data().detach().numpy(),
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
    assert net.output.weight.data().dtype == torch.bfloat16


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
