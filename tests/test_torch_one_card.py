"""Card-only checks of the one-card extras (samplers, int8 products,
custom operators, test utilities), held against their plain PyTorch
versions; the parity tests against the JAX package are in
``test_torch_random_ops.py``, ``test_torch_quantization.py``,
``test_torch_custom_op.py`` and ``test_torch_utils.py``.  This file
imports nothing of JAX.  Each test carries the ``gpu`` marker and skips
without a card; on the card: ``python -m pytest -m gpu
tests/test_torch_one_card.py``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")


SAMPLES = {
    "_random_uniform": ((), dict(low=2.0, high=5.0)),
    "_random_normal": ((), dict(loc=1.5, scale=2.0)),
    "_random_gamma": ((), dict(alpha=3.0, beta=2.0)),
    "_random_exponential": ((), dict(lam=4.0)),
    "_random_poisson": ((), dict(lam=3.0)),
    "_random_negative_binomial": ((), dict(k=4, p=0.4)),
    "_random_generalized_negative_binomial": ((), dict(mu=2.0, alpha=0.5)),
    "_random_randint": ((), dict(low=-3, high=9)),
    "_sample_uniform": (([0.0, 10.0], [1.0, 20.0]), {}),
    "_sample_normal": (([-5.0, 5.0], [1.0, 3.0]), {}),
    "_sample_gamma": (([2.0, 8.0], [1.0, 0.5]), {}),
    "_sample_exponential": (([0.5, 4.0],), {}),
    "_sample_poisson": (([0.5, 4.0],), {}),
}


@pytest.mark.gpu
def test_card_draws_come_from_the_card_generator():
    _card()
    from mxnet_tpu_torch import random as trandom
    gen = trandom.generator("cuda")
    host = trandom.generator("cpu").get_state()
    before = gen.get_state()
    with tmx.gpu():
        for name, (rows, kw) in sorted(SAMPLES.items()):
            args = [tmx.nd.array(np.asarray(r, np.float32)) for r in rows]
            kw = dict(kw, shape=(8,))
            if not rows:
                kw["ctx"] = tmx.gpu()
            out = tmx.nd.invoke(name, *args, **kw)
            assert out._data.is_cuda, name
        probs = tmx.nd.array(np.array([[0.2, 0.8]], np.float32))
        assert tmx.nd.invoke("_sample_multinomial", probs,
                             shape=4)._data.is_cuda
        assert tmx.nd.shuffle(tmx.nd.arange(8))._data.is_cuda
    assert not torch.equal(before, gen.get_state())
    assert torch.equal(host, trandom.generator("cpu").get_state())


@pytest.mark.gpu
def test_card_products_take_the_int8_gemm():
    _card()
    from mxnet_tpu_torch.ops import quantization as tops
    rng = np.random.RandomState(5)
    for m, k, n in ((1, 147, 64), (64, 576, 64), (17, 8, 8)):
        a = rng.randint(-127, 128, (m, k)).astype(np.int8)
        b = rng.randint(-127, 128, (n, k)).astype(np.int8)
        before = tops.int8_matmul.launches
        got = tops.int8_matmul(torch.from_numpy(a).cuda(),
                               torch.from_numpy(b).cuda())
        assert tops.int8_matmul.launches == before + 1
        np.testing.assert_array_equal(
            got.cpu().numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


@pytest.mark.gpu
def test_card_custom_op_outputs_stay_on_the_card():
    _card()
    op = tmx.operator

    @op.register("card_double")
    class DoubleProp(op.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            class Double(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * 2)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * 2)
            return Double()

    x = tmx.nd.array(np.ones((4, 5), np.float32), ctx=tmx.gpu())
    x.attach_grad()
    with tmx.autograd.record():
        out = tmx.nd.Custom(x, op_type="card_double")
    out.backward()
    assert out._data.is_cuda and x.grad._data.is_cuda
    np.testing.assert_array_equal(x.grad.asnumpy(), np.full((4, 5), 2.0))


@pytest.mark.gpu
def test_card_test_utilities():
    _card()
    from mxnet_tpu_torch import test_utils as ttu
    with tmx.gpu():
        assert ttu.rand_ndarray((3, 4), seed=0)._data.is_cuda
        rng = np.random.RandomState(0)
        ttu.check_numeric_gradient("FullyConnected",
                                   [rng.randn(4, 6).astype(np.float32),
                                    rng.randn(3, 6).astype(np.float32),
                                    rng.randn(3).astype(np.float32)],
                                   dict(num_hidden=3))
