"""Port parity: ``mxnet_tpu_torch.gluon.model_zoo.bert`` against the JAX
package's BERT, on the CPU.

A 2-layer BERT (units 32, 4 heads, hidden 64, vocab 100, S 16, 4
masked positions, dropout 0) is built on both sides, the JAX net's
parameters (randomised) carried over with ``params_from_jax``, and the
same seeded batch run through both with ``attention_impl`` "dense" and
"flash" (the JAX flash op runs its Pallas kernels in interpret mode, the
port's its kernels' plain versions).  In f32 the four outputs, the
pretraining loss and the gradient of every parameter — the tied
``word_embed.weight`` among them, which gets both its uses — agree
within 1e-4 (f32 sums taken in another order).  A bf16-cast forward
agrees within the bf16 tolerance of ``test_flash_bf16`` (5e-2).

Also the layers BERT adds (LayerNorm, Embedding, Dropout, TruncNorm,
gather_nd, the exact GELU) against their JAX counterparts, the mask
semantics of the ops, and the errors the flash path raises.
"""
import gc

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.ndarray import invoke
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import initializer, ops
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

SMALL = dict(vocab_size=100, units=32, hidden_size=64, num_layers=2,
             num_heads=4, max_length=32, dropout=0.0)
B, S, M = 2, 16, 4
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    """Collect this module's cyclic garbage (JAX-side arrays among it)
    before the next module runs in the same worker."""
    yield
    gc.collect()


def batch(seed=0, b=B):
    rng = np.random.RandomState(seed)
    data = (rng.randint(0, SMALL["vocab_size"], (b, S)).astype(np.int32),
            rng.randint(0, 2, (b, S)).astype(np.int32),
            None,
            rng.randint(0, S, (b, M)).astype(np.int32))
    labels = (rng.randint(0, SMALL["vocab_size"], (b, M)).astype(np.int32),
              (rng.rand(b, M) < 0.8).astype(np.float32),
              rng.randint(0, 2, (b,)).astype(np.int32))
    return data, labels


def jax_net(impl, seed=3):
    net = jbert.BERTModel(**SMALL, attention_impl=impl)
    net.initialize()
    rng = np.random.RandomState(seed)
    for p in net.collect_params().values():
        base = 1.0 if p.name.endswith("gamma") else 0.0
        p.set_data(mx.nd.array((base + 0.2 * rng.randn(*p.shape))
                               .astype(np.float32)))
    return net


def jax_arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def port_net(impl, jnet, dtype=None):
    net = tbert.BERTModel(**SMALL, attention_impl=impl)
    net.initialize(ctx="cpu")
    tbert.params_from_jax(net, jax_arrays(jnet))
    if dtype:
        net.cast(dtype)
    return net


def jloss(out, labels):
    return jbert.BERTPretrainLoss()(out[3], out[2],
                                    *(mx.nd.array(x) for x in labels))


def tloss(out, labels):
    return tbert.BERTPretrainLoss()(out[3], out[2],
                                    *(torch.from_numpy(x) for x in labels))


def run_jax(net, data, labels):
    args = [None if x is None else mx.nd.array(x) for x in data]
    with jag.record():
        out = net(*args)
        loss = jloss(out, labels)
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()}
    return [o.asnumpy() for o in out], float(loss.asnumpy()), grads


def run_port(net, data, labels):
    args = [None if x is None else torch.from_numpy(x) for x in data]
    with tag.record():
        out = net(*args)
        loss = tloss(out, labels)
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()}
    return ([o.detach().float().numpy() for o in out], float(loss.detach()),
            grads)


def by_stripped(d):
    return {k: d[n] for k, n in tres._strip(d.keys()).items()}


# ------------------------------------------------------------------ model --
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_outputs_loss_and_gradients_match_jax(impl):
    data, labels = batch()
    jnet = jax_net(impl)
    tnet = port_net(impl, jnet)
    jo, jl, jg = run_jax(jnet, data, labels)
    to, tl, tg = run_port(tnet, data, labels)
    assert len(to) == len(jo) == 4
    shapes = [(B, S, 32), (B, 32), (B, 2), (B, M, 100)]
    for a, b, shape in zip(to, jo, shapes):
        assert a.shape == b.shape == shape
        np.testing.assert_allclose(a, b, **F32)
    np.testing.assert_allclose(tl, jl, **F32)
    jg, tg = by_stripped(jg), by_stripped(tg)
    assert set(jg) == set(tg) and len(tg) == 38
    for k in tg:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **F32)
    # the tied decoder: the embedding's gradient has rows the embedding
    # lookups never touched, from the MLM projection alone
    used = np.unique(data[0])
    free = np.setdiff1d(np.arange(SMALL["vocab_size"]), used)
    assert np.abs(tg["embedding0_weight"][free]).max() > 0


def test_flash_matches_dense_in_the_port():
    data, labels = batch(seed=1)
    jnet = jax_net("dense", seed=4)
    outs = {impl: run_port(port_net(impl, jnet), data, labels)
            for impl in ("dense", "flash")}
    (do, dl, dg), (fo, fl, fg) = outs["dense"], outs["flash"]
    for a, b in zip(fo, do):
        np.testing.assert_allclose(a, b, **F32)
    np.testing.assert_allclose(fl, dl, **F32)
    dg, fg = by_stripped(dg), by_stripped(fg)
    assert set(dg) == set(fg)
    for k in dg:
        np.testing.assert_allclose(fg[k], dg[k], err_msg=k, **F32)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_bf16_forward_matches_jax(impl):
    data, labels = batch(seed=2)
    jnet = jax_net(impl, seed=5)
    tnet = port_net(impl, jnet, dtype="bfloat16")
    jnet.cast("bfloat16")
    jargs = [None if x is None else mx.nd.array(x) for x in data]
    targs = [None if x is None else torch.from_numpy(x) for x in data]
    with jag.pause():
        jo = jnet(*jargs)
        jl = float(jloss(jo, labels).astype("float32").asnumpy())
    with tag.pause():
        to = tnet(*targs)
        tl = float(tloss(to, labels).float())
    for a, b in zip(to, jo):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(),
                                   b.astype("float32").asnumpy(), **BF16)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)


def test_valid_length_masks_keys_as_jax_does():
    data, _ = batch(seed=6)
    vl = np.array([S, 9], np.int32)
    data = (data[0], data[1], vl, data[3])
    jnet = jax_net("dense", seed=6)
    tnet = port_net("dense", jnet)
    with jag.pause():
        jo = jnet(*[mx.nd.array(x) for x in data])
    with tag.pause():
        to = tnet(*[torch.from_numpy(x) for x in data])
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), b.asnumpy(), **F32)


def test_flash_with_valid_length_raises_as_jax_does():
    data, _ = batch()
    vl = np.full((B,), S, np.int32)
    jnet = jax_net("flash")
    tnet = port_net("flash", jnet)
    with pytest.raises(ValueError, match="does not support valid_length"):
        with jag.pause():
            jnet(mx.nd.array(data[0]), mx.nd.array(data[1]),
                 mx.nd.array(vl))
    with pytest.raises(ValueError, match="does not support valid_length"):
        with tag.pause():
            tnet(torch.from_numpy(data[0]), torch.from_numpy(data[1]),
                 torch.from_numpy(vl))


def test_attention_impls_and_zoo():
    with pytest.raises(ValueError, match="unknown attention_impl"):
        tbert.BERTModel(**SMALL, attention_impl="sparse")
    for impl in ("ring", "ulysses"):
        # they build, and run over a mesh's sp axis
        # (tests/test_torch_sequence_parallel.py); outside one they
        # raise as the JAX ops do
        net = tbert.BERTModel(**SMALL, attention_impl=impl)
        net.initialize(ctx="cpu")
        tok = torch.zeros((1, 4), dtype=torch.int32)
        with pytest.raises(ValueError, match="needs a mesh"):
            with tag.pause():
                net(tok, tok)
    t = tbert.bert_12_768_12(vocab_size=30522)
    j = jbert.bert_12_768_12(vocab_size=30522)
    assert set(tres._strip(t.collect_params().keys())) == \
        set(tres._strip(j.collect_params().keys()))
    shapes = {k: p.shape for k, p in t.collect_params().items()}
    assert sum(int(np.prod(s)) for s in shapes.values()) == 110106428
    assert len(tbert.bert_24_1024_16().encoder.layers) == 24


# ----------------------------------------------------------------- layers --
def _layer_pair(jlayer, tlayer, x):
    jlayer.initialize()
    tlayer.initialize(ctx="cpu")
    with jag.pause():
        jlayer(mx.nd.array(x))
    with tag.pause():
        tlayer(torch.from_numpy(x))
    rng = np.random.RandomState(7)
    arrays = {}
    for k, p in jlayer.collect_params().items():
        p.set_data(mx.nd.array((1.0 + 0.3 * rng.randn(*p.shape))
                               .astype(p.data().dtype)))
        arrays[k] = p.data().asnumpy()
    tres.params_from_jax(tlayer, arrays)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    x = (np.random.RandomState(0).randn(3, 5, 24) * 2 + 1).astype(np.float32)
    j, t = jnn.LayerNorm(epsilon=1e-12), tnn.LayerNorm(epsilon=1e-12)
    _layer_pair(j, t, x)
    if dtype == "bfloat16":
        j.cast(dtype)
        t.cast(dtype)
    jx = mx.nd.array(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    jx.attach_grad()
    with jag.record():
        jo = j(jx)
        (jo * jo).sum().backward()
    with tag.record():
        to = t(tx)
        (to * to).sum().backward()
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(to.detach().float().numpy(),
                               jo.astype("float32").asnumpy(), **tol)
    if dtype == "float32":
        np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                                   rtol=1e-3, atol=1e-3)
        for name in ("gamma", "beta"):
            np.testing.assert_allclose(
                getattr(t, name).grad().asnumpy(),
                getattr(j, name).grad().asnumpy(), rtol=1e-3, atol=1e-3)


def test_embedding_clips_indices_and_gather_nd_matches_jax():
    w = np.random.RandomState(1).randn(10, 4).astype(np.float32)
    idx = np.array([[0, 3, 9], [12, -2, 5]], np.int32)
    j = invoke("Embedding", mx.nd.array(idx), mx.nd.array(w)).asnumpy()
    t = ops.Embedding(torch.from_numpy(idx), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(t, j)
    data = np.random.RandomState(2).randn(3, 6, 4).astype(np.float32)
    gi = np.array([[0, 2, 1, 2], [5, 0, 3, -1]], np.int32)
    j = invoke("gather_nd", mx.nd.array(data), mx.nd.array(gi)).asnumpy()
    t = ops.gather_nd(torch.from_numpy(data), torch.from_numpy(gi)).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("act", ["gelu", "tanh"])
def test_activations_match_jax(act):
    x = np.linspace(-6, 6, 97).astype(np.float32)
    j = invoke("Activation", mx.nd.array(x), act_type=act).asnumpy()
    t = ops.Activation(torch.from_numpy(x), act_type=act).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    # the exact erf form, not the tanh approximation
    if act == "gelu":
        approx = torch.nn.functional.gelu(torch.from_numpy(x),
                                          approximate="tanh").numpy()
        assert np.abs(approx - j).max() > 1e-4


def test_dropout_is_inverted_train_only_and_seeded():
    x = torch.ones(4000)
    with tag.pause():
        assert torch.equal(ops.Dropout(x, p=0.3), x)
    trandom.seed(11)
    with tag.train_mode():
        a = ops.Dropout(x, p=0.3)
    trandom.seed(11)
    with tag.train_mode():
        b = ops.Dropout(x, p=0.3)
        c = ops.Dropout(x, p=0.3)
    assert torch.equal(a, b) and not torch.equal(b, c)
    kept = a[a != 0]
    assert torch.allclose(kept, torch.full_like(kept, 1 / 0.7))
    assert abs(float((a == 0).float().mean()) - 0.3) < 0.03
    d = tnn.Dropout(0.5, axes=(1,))
    with tag.train_mode():
        y = d(torch.ones(3, 7))
    assert all(len(set(row.tolist())) == 1 for row in y)


def test_trunc_norm_is_truncated_and_seeded():
    trandom.seed(5)
    a = initializer.TruncNorm(stdev=0.02).init_array((20000,))
    trandom.seed(5)
    b = initializer.TruncNorm(stdev=0.02).init_array((20000,))
    assert torch.equal(a, b)
    assert float(a.abs().max()) <= 0.04 + 1e-7
    # the std of a normal truncated at +-2 sigma: 0.8796 sigma
    assert abs(float(a.std()) - 0.02 * 0.8796) < 0.02 * 0.02
    assert abs(float(a.mean())) < 0.02 * 0.02
