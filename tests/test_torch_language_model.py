"""Port parity: ``gluon.model_zoo.language_model`` (``RNNModel``,
``rnn_lm``; BASELINE config 3) of ``mxnet_tpu_torch`` against the JAX
package's, on the CPU in float32.

- Each mode (``lstm``, ``gru``, ``rnn_tanh``, ``rnn_relu``), with and
  without ``tie_weights``: the logits in predict mode, with and without
  carried states, parameters copied across by ``params_from_jax``,
  within 1e-5; under ``record()`` at dropout 0 the gradient of every
  parameter within 1e-5 — with tied weights the embedding's gradient
  sums both of its uses.
- Three ``parallel.TrainStep`` steps of ``bench_lstm``'s recipe at a
  small size (SGD at 20 / batch, softmax cross-entropy over ``(-1,
  vocab)``, time-major int32 ids) at dropout 0, tied and untied: the
  JAX step's losses and parameters within 1e-4 (three steps of SGD at
  a large rate).
- Dropout 0.5 in a training step, held by invariants: finite losses,
  another loss than at dropout 0, and two steps from the same
  parameters and seed the same.
- The word-language-model example's corpus trained a few steps through
  ``gluon.Trainer`` lowers the perplexity (``metric.Perplexity``).
"""
import gc

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import parallel as jparallel
from mxnet_tpu_torch import parallel as tparallel
from mxnet_tpu_torch.gluon import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
V, E, T, N = 30, 8, 6, 4
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    yield
    gc.collect()


def _pair(mode, tie, dropout=0.0, layers=2, seed=1):
    jnet = jmx.gluon.model_zoo.language_model.rnn_lm(
        mode=mode, vocab_size=V, embed_size=E, hidden_size=E,
        num_layers=layers, dropout=dropout, tie_weights=tie, prefix="lm_")
    # every shape is known, so set_data alone gives each parameter its
    # value (the initializers would compile a program for each shape)
    rng = np.random.RandomState(seed)
    for p in jnet.collect_params().values():
        assert p.shape and all(p.shape), p.name
        p.set_data((0.3 * rng.randn(*p.shape)).astype(np.float32))
    with tmx.cpu():
        tnet = tmx.gluon.model_zoo.language_model.rnn_lm(
            mode=mode, vocab_size=V, embed_size=E, hidden_size=E,
            num_layers=layers, dropout=dropout, tie_weights=tie,
            prefix="lm_")
        tnet.initialize()
    params_from_jax(tnet, {k: p.data().asnumpy()
                           for k, p in jnet.collect_params().items()})
    return jnet, tnet


def _ids(seed=2, shape=(T, N)):
    return np.random.RandomState(seed).randint(0, V, shape).astype(np.int32)


def _forward(pkg, net, x, states):
    xs = pkg.nd.array(x, dtype="int32")
    if states is None:
        return [net(xs).asnumpy()]
    st = [pkg.nd.array(s) for s in states]
    logits, new = net(xs, st)
    return [logits.asnumpy()] + [s.asnumpy() for s in new]


@pytest.mark.parametrize("carry", [False, True], ids=["zeros", "carry"])
@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_model_forward_matches_jax(mode, tie, carry):
    jnet, tnet = _pair(mode, tie, dropout=0.5)
    states = None
    if carry:
        rng = np.random.RandomState(3)
        states = [rng.randn(2, N, E).astype(np.float32)
                  for _ in range(2 if mode == "lstm" else 1)]
    x = _ids()
    want = _forward(jmx, jnet, x, states)
    with tmx.cpu():
        got = _forward(tmx, tnet, x, states)
    assert got[0].shape == (T, N, V)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def _grads(pkg, net, x, y):
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    with pkg.autograd.record():
        out = net(pkg.nd.array(x, dtype="int32"))
        loss = ce(out.reshape((-1, V)), pkg.nd.array(y.reshape(-1),
                                                     dtype="int32")).mean()
    loss.backward()
    return {k: p.grad().asnumpy() for k, p in net.collect_params().items()}


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_model_gradients_match_jax(mode, tie):
    jnet, tnet = _pair(mode, tie)
    x, y = _ids(4), _ids(5)
    want = _grads(jmx, jnet, x, y)
    with tmx.cpu():
        got = _grads(tmx, tnet, x, y)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    if tie:
        emb = [k for k in got if k.endswith("embedding0_weight")][0]
        assert np.abs(got[emb]).sum() > 0 and not any(
            "dense" in k for k in got)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_hybridized_model_matches_eager(tie):
    """``hybridize()`` runs the model as one unit over aliases of its
    parameters: the tied decoder reads the live embedding there too, so
    the logits and every gradient equal the eager call's."""
    _, tnet = _pair("lstm", tie)
    x, y = _ids(4), _ids(5)
    with tmx.cpu():
        eager = _grads(tmx, tnet, x, y)
        want = tnet(tmx.nd.array(x, dtype="int32")).asnumpy()
        tnet.hybridize()
        for p in tnet.collect_params().values():
            p.zero_grad()
        got = _grads(tmx, tnet, x, y)
        logits = tnet(tmx.nd.array(x, dtype="int32")).asnumpy()
    np.testing.assert_array_equal(logits, want)
    for k in eager:
        np.testing.assert_allclose(got[k], eager[k], err_msg=k, **TOL)


def _lm_loss(pkg):
    ce = pkg.gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(out, label):
        return ce(out.reshape((-1, V)), label.reshape((-1,)))
    return loss_fn


SGD = dict(learning_rate=20.0 / N)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_train_step_matches_jax(tie):
    """``bench_lstm``'s step, small: three steps of the JAX
    ``TrainStep`` and the port's from the same parameters."""
    jnet, tnet = _pair("lstm", tie)
    x, y = _ids(6), _ids(7)
    mesh = jparallel.make_mesh(dp=1, devices=jax.devices()[:1])
    jstep = jparallel.TrainStep(jnet, _lm_loss(jmx),
                                jmx.optimizer.create("sgd", **SGD), mesh=mesh)
    tstep = tparallel.TrainStep(tnet, _lm_loss(tmx),
                                tmx.optimizer.create("sgd", **SGD))
    jl = [float(jstep(jmx.nd.array(x, dtype="int32"),
                      jmx.nd.array(y, dtype="int32")).asnumpy())
          for _ in range(3)]
    tl = [float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    assert tl[2] < tl[0]
    jstep.sync_params_to_net()
    tstep.sync_params_to_net()
    jp = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    for k, p in tnet.collect_params().items():
        np.testing.assert_allclose(p.tensor().detach().numpy(), jp[k],
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_train_step_dropout_invariants():
    _, plain = _pair("lstm", False, dropout=0.0)
    _, drop = _pair("lstm", False, dropout=0.5)
    x, y = torch.from_numpy(_ids(6)), torch.from_numpy(_ids(7))
    losses = {}
    for name, net in (("plain", plain), ("drop", drop)):
        tmx.random.seed(11)
        step = tparallel.TrainStep(net, _lm_loss(tmx),
                                   tmx.optimizer.create("sgd", **SGD))
        losses[name] = float(step(x, y))
    _, again = _pair("lstm", False, dropout=0.5)
    tmx.random.seed(11)
    step = tparallel.TrainStep(again, _lm_loss(tmx),
                               tmx.optimizer.create("sgd", **SGD))
    assert np.isfinite(losses["drop"])
    assert losses["drop"] != losses["plain"]
    assert float(step(x, y)) == losses["drop"]


def test_trainer_lowers_perplexity():
    """The example's loop in small: ``gluon.Trainer`` with
    ``clip_global_norm`` on a corpus with structure."""
    toks = np.arange(T * N * 12) % V                     # a cyclic corpus
    data = toks.reshape(N, -1).T.astype(np.int32)        # (steps, N)
    with tmx.cpu():
        net = tmx.gluon.model_zoo.language_model.rnn_lm(
            vocab_size=V, embed_size=16, hidden_size=16, num_layers=1,
            dropout=0.0)
        net.initialize(tmx.init.Xavier())
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 10.0})
        ce = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        ppl = []
        for epoch in range(6):
            metric = tmx.metric.Perplexity()
            for i in range(0, data.shape[0] - T - 1, T):
                x = tmx.nd.array(data[i:i + T], dtype="int32")
                y = tmx.nd.array(data[i + 1:i + T + 1], dtype="int32")
                with tmx.autograd.record():
                    out = net(x)
                    loss = ce(out.reshape((-1, V)), y.reshape((-1,)))
                loss.backward()
                grads = [p.grad() for p in net.collect_params().values()]
                tmx.gluon.utils.clip_global_norm(grads, 0.25 * T * N)
                trainer.step(T * N)
                metric.update(y.reshape((-1,)),
                              tmx.nd.softmax(out.reshape((-1, V))))
            ppl.append(metric.get()[1])
    assert np.isfinite(ppl).all() and ppl[-1] < ppl[0] / 2, ppl


def test_bench_lstm_line_on_the_cpu(capsys):
    """``python -m mxnet_tpu_torch.bench lstm --device cpu``: one line with
    ``bench.py``'s metric name and keys, at ``bench_lstm``'s widths."""
    import json

    from mxnet_tpu_torch import bench

    assert bench.main(["lstm", "--device", "cpu", "--steps", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "lstm_lm_train_throughput"
    assert line["unit"] == "tokens/s/cpu" and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 30000.0,
                                                abs=1e-4)
    assert (line["batch"], line["bptt"], line["graphs"]) == (8, 35, 0)
    assert np.isfinite(line["last_loss"])
