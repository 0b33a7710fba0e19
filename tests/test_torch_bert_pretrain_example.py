"""``examples/bert_pretrain.py`` as written, through the port, on a gang
of two gloo ranks on the CPU at ``tests/test_examples.py``'s size
(``--layers 1 --units 64 --heads 4 --batch-size 2 --seq-len 32
--num-steps 2``).

Each rank (this file run as a script through ``python -m
mxnet_tpu_torch.launch -n 2 --platform cpu``) loads the port as
``mxnet_tpu`` and puts a stand-in module named ``jax`` into
``sys.modules``, whose one member ``devices()`` gives the gang's ranks:
the example's only JAX line, ``n_dev = len(jax.devices())``, then makes
``make_mesh(dp=n_dev)`` span the gang.  Both stay in the worker.  The
example prints its ``tokens/s`` line, its losses (every call of its
``TrainStep``, recorded) are finite, and both ranks end with the same
parameters.

``--attention flash`` as written stops at the first forward in both
packages, with the same ``ValueError``: the example always passes a
``valid_length``, and the flash attention takes no key-padding mask
(``BERTSelfAttention``, both packages; ROADMAP C14).  The gang holds the
port to that text, and this process the JAX package's block.
"""
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--layers", "1", "--units", "64", "--heads", "4", "--batch-size",
        "2", "--seq-len", "32", "--num-steps", "2"]
ATTENTION = ("dense",)
FLASH_REFUSAL = "attention_impl='flash' does not support valid_length masks"


def worker(outdir):
    """One rank: the example as written under each attention; its
    losses and parameters to ``rank<r>.npz``."""
    import runpy
    import types

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import distributed, parallel

    for name, mod in list(sys.modules.items()):
        if name == "mxnet_tpu_torch" or name.startswith("mxnet_tpu_torch."):
            sys.modules["mxnet_tpu" + name[len("mxnet_tpu_torch"):]] = mod
    stand_in = types.ModuleType("jax")
    stand_in.devices = lambda: list(range(distributed.num_workers()))
    sys.modules["jax"] = stand_in
    steps, losses = [], []
    real = parallel.TrainStep

    class Recorded(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            steps.append(self)

        def __call__(self, *a, **kw):
            out = super().__call__(*a, **kw)
            losses[-1].append(float(out.asnumpy()))
            return out
    parallel.TrainStep = Recorded
    res = {}
    try:
        for impl in ATTENTION:
            losses.append([])
            sys.argv = ["bert_pretrain.py", *ARGS, "--attention", impl]
            with mx.cpu():
                runpy.run_path(os.path.join(REPO, "examples",
                                            "bert_pretrain.py"),
                               run_name="__main__")
            step = steps[-1]
            res[f"{impl}/losses"] = np.array(losses[-1])
            res[f"{impl}/mesh"] = np.array(list(step.mesh.shape.items()))
            for k, v in step.params.items():
                res[f"{impl}/p/{k.split('_', 1)[1]}"] = \
                    v.detach().float().numpy()
        sys.argv = ["bert_pretrain.py", *ARGS, "--attention", "flash"]
        try:
            with mx.cpu():
                runpy.run_path(os.path.join(REPO, "examples",
                                            "bert_pretrain.py"),
                               run_name="__main__")
            res["flash/error"] = np.array("")
        except ValueError as exc:
            res["flash/error"] = np.array(str(exc))
    finally:
        parallel.TrainStep = real
    np.savez(os.path.join(outdir, f"rank{distributed.rank()}.npz"), **res)
    print(f"rank {distributed.rank()} done", flush=True)


if __name__ == "__main__":
    worker(sys.argv[1])
    sys.exit(0)


from test_torch_dp_step import finish_gang, start_gang  # noqa: E402


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("bert_pretrain"))
    proc = start_gang(os.path.abspath(__file__), outdir)
    ranks = finish_gang(proc, outdir)
    return ranks, open(os.path.join(outdir, "gang.log")).read()


def test_example_prints_its_throughput_line(gang):
    _, log = gang
    for impl in ATTENTION:
        assert log.count(f"attention={impl})") == 2      # one a rank
    assert "tokens/s/chip (2 device(s)" in log


@pytest.mark.parametrize("impl", ATTENTION)
def test_losses_are_finite_on_a_dp_mesh_over_the_gang(gang, impl):
    ranks, _ = gang
    for res in ranks:
        losses = res[f"{impl}/losses"]
        assert len(losses) == 3                  # the first call + 2 steps
        assert np.isfinite(losses).all()
        assert [tuple(r) for r in res[f"{impl}/mesh"]] == [("dp", "2")]
    np.testing.assert_array_equal(ranks[0][f"{impl}/losses"],
                                  ranks[1][f"{impl}/losses"])


@pytest.mark.parametrize("impl", ATTENTION)
def test_both_ranks_hold_the_same_parameters(gang, impl):
    ranks, _ = gang
    keys = [k for k in ranks[0] if k.startswith(f"{impl}/p/")]
    assert len(keys) > 10
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_flash_as_written_stops_with_the_jax_packages_error(gang):
    """``--attention flash`` as written: the port's ranks refuse the
    example's ``valid_length`` with the JAX package's ``ValueError``,
    which the JAX package's BERT raises for the same call."""
    import mxnet_tpu as jmx
    from mxnet_tpu.gluon.model_zoo.bert import BERTModel

    ranks, _ = gang
    for res in ranks:
        assert FLASH_REFUSAL in str(res["flash/error"])
    net = BERTModel(vocab_size=100, units=64, hidden_size=256, num_layers=1,
                    num_heads=4, max_length=32, attention_impl="flash")
    net.initialize()
    tok = jmx.nd.array(np.zeros((2, 32), np.int32))
    with pytest.raises(ValueError, match=FLASH_REFUSAL):
        net(tok, tok, jmx.nd.array(np.full((2,), 32, np.int32)))
