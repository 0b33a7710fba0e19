"""Port parity: LAMB and the tuple-batch ``TrainStep`` against the JAX
package, on the CPU.

- ``parallel.functional_opt.pure_update`` with LAMB over three steps
  (the step count ``t`` driving the bias correction) against the JAX
  ``pure_update``: f32 weights, and bf16 weights with f32 masters (the
  master the last state element), with weight decay and the optional
  trust-ratio bounds; weights and state within rtol 1e-5, atol 1e-6;
- three ``TrainStep``s of the 2-layer BERT (``test_torch_bert``'s) with
  tuple data ``(tokens, token_types, None, masked_positions)`` and tuple
  labels ``(mlm_labels, mlm_weights, nsp_labels)``, LAMB (lr 1e-3, wd
  0.01), dense and flash, against the JAX ``TrainStep`` from the same
  parameters: the three losses and the final parameters within 1e-4.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.parallel import functional_opt as jfo
from mxnet_tpu_torch import gluon, optimizer, parallel
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.parallel import functional_opt as tfo
from test_torch_bert import batch, jax_arrays, jax_net, port_net

LAMB = dict(learning_rate=1e-3, wd=0.01)


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    """Collect this module's cyclic garbage (JAX-side arrays among it)
    before the next module runs in the same worker."""
    yield
    gc.collect()


@pytest.mark.parametrize("dtype,bounds", [("float32", {}),
                                          ("float32", dict(lower_bound=0.5,
                                                           upper_bound=2.0)),
                                          ("bfloat16", {})])
def test_lamb_pure_update_matches_jax(dtype, bounds):
    rng = np.random.RandomState(0)
    w0 = rng.randn(40, 24).astype(np.float32)
    grads = [rng.randn(40, 24).astype(np.float32) for _ in range(3)]
    jopt = mx.optimizer.create("lamb", **LAMB, **bounds)
    topt = optimizer.create("lamb", **LAMB, **bounds)
    jw = jnp.asarray(w0).astype(dtype)
    jstate = jfo.state_template(jopt, jw)
    tw = torch.from_numpy(w0).to(getattr(torch, dtype))
    tstate = tfo.state_template(topt, tw)
    assert len(tstate) == len(jstate) == (3 if dtype == "bfloat16" else 2)
    for t, g in enumerate(grads, 1):
        jw, jstate = jfo.pure_update(jopt, jw, jnp.asarray(g).astype(dtype),
                                     jstate, jnp.int32(t), 1e-3, 0.01)
        with torch.no_grad():
            tfo.pure_update(topt, tw, torch.from_numpy(g).to(tw.dtype),
                            tstate, t, 1e-3, 0.01)
    for a, b in zip(tstate, jstate):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.float().numpy(),
                               np.asarray(jw.astype(jnp.float32)),
                               rtol=1e-5, atol=1e-6)
    if dtype == "bfloat16":
        assert tw.dtype == torch.bfloat16
        assert torch.equal(tw, tstate[-1].to(torch.bfloat16))


def _jax_loss_fn():
    blk = jbert.BERTPretrainLoss()

    def fn(out, labels):
        return blk(out[3], out[2], *labels)
    return fn


def _port_loss_fn():
    blk = tbert.BERTPretrainLoss()

    def fn(out, labels):
        return blk(out[3], out[2], *labels)
    return fn


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_three_bert_steps_match_the_jax_train_step(impl):
    data, labels = batch(seed=10, b=4)
    jnet = jax_net(impl, seed=11)
    tnet = port_net(impl, jnet)
    mesh = jparallel.make_mesh(dp=1, devices=jax.devices()[:1])
    jstep = jparallel.TrainStep(jnet, _jax_loss_fn(),
                                mx.optimizer.create("lamb", **LAMB),
                                mesh=mesh)
    tstep = parallel.TrainStep(tnet, _port_loss_fn(),
                               optimizer.create("lamb", **LAMB))
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(jstep(data, labels).asnumpy()))
        tl.append(float(tstep(list(data), list(labels))))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    assert tl[-1] < tl[0]
    jstep.sync_params_to_net()
    tstep.sync_params_to_net()
    want = jax_arrays(jnet)
    got = {k: p.data().detach().numpy()
           for k, p in tnet.collect_params().items()}
    want = {k: want[n] for k, n in tres._strip(want).items()}
    got = {k: got[n] for k, n in tres._strip(got).items()}
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_step_passes_none_leaves_and_slices_every_leaf_to_build():
    """A deferred net is built by the step's batch-1 pass: every tensor
    leaf of the data tuple is sliced, ``None`` reaches the net as it is;
    a one-element label tuple reaches the loss unwrapped."""
    seen = []

    class TwoInputs(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.dense = gluon.nn.Dense(3, flatten=False)  # deferred

        def forward(self, x, nothing, y):
            seen.append([None if a is None else tuple(a.shape)
                         for a in (x, nothing, y)])
            return self.dense(x) + y

    net = TwoInputs()
    net.initialize(ctx="cpu")
    rng = np.random.RandomState(0)
    data = [rng.randn(4, 5).astype(np.float32), None,
            rng.randn(4, 3).astype(np.float32)]
    label = (rng.randn(4, 3).astype(np.float32),)
    step = parallel.TrainStep(net, lambda out, y: ((out - y) ** 2).mean(),
                              optimizer.create("lamb", **LAMB))
    losses = [float(step(data, label)) for _ in range(3)]
    assert seen[0] == [(1, 5), None, (1, 3)]
    assert seen[1:] == [[(4, 5), None, (4, 3)]] * 3
    assert net.dense.weight.shape == (3, 5)
    assert losses[-1] < losses[0]
