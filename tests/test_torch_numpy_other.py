"""``mx.np``'s ``_OTHER`` and ``_EXTRA`` names of the port against the
JAX package's, on ``test_torch_numpy.py``'s case table (values within
the case's tolerance, shapes and dtypes equal), and ``partition`` /
``argpartition`` by what numpy guarantees.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import np as jnp_
from mxnet_tpu import npx as jnpx
from mxnet_tpu_torch import np as tnp_
from mxnet_tpu_torch import npx as tnpx
from test_torch_numpy import CASES, OTHER_NAMES, PARTITION, V7, run_case


@pytest.fixture(autouse=True)
def _cpu_and_reset():
    with tmx.cpu():
        yield
    jnpx.reset_np()
    tnpx.reset_np()
    jmx.amp._deinit_for_tests()
    tmx.amp._deinit_for_tests()


@pytest.mark.parametrize("case", sorted(
    c for c in CASES if c.split("#")[0] in OTHER_NAMES))
def test_delegated_name_matches_jax(case):
    run_case(case)


@pytest.mark.parametrize("name", PARTITION)
def test_partition_kth_and_sides(name):
    """The kth element in place, no larger element before it and no
    smaller one after, as numpy guarantees (the order within the sides
    is unspecified)."""
    k = 3
    got = getattr(tnp_, name)(tnp_.array(V7), k)
    want = getattr(jnp_, name)(jnp_.array(V7), k)
    vals = got.asnumpy() if name == "partition" else V7[got.asnumpy()]
    jvals = onp.asarray(want._data) if name == "partition" \
        else V7[onp.asarray(want._data)]
    assert got.dtype == onp.asarray(want._data).dtype
    assert vals[k] == jvals[k] == onp.sort(V7)[k]
    assert (vals[:k] <= vals[k]).all() and (vals[k + 1:] >= vals[k]).all()
    assert sorted(vals.tolist()) == sorted(V7.tolist())
