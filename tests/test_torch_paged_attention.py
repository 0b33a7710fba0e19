"""Port parity: ``mxnet_tpu_torch.ops.paged_attention`` against the JAX
package's paged decode attention.

The same numpy inputs (seeded) go through the JAX jnp path, the Pallas
kernel in interpret mode, and the port's plain PyTorch version on the
CPU.  Ragged lengths include 0 (an inactive slot), 1, a page edge and a
full table.  Tolerance: atol = rtol = 1e-5 in float32 — the two sides
sum the same terms in a different order.

The CUDA kernel itself runs only on the card: the ``gpu``-marked tests
skip here and run with ``python -m pytest -m gpu tests/test_torch_*.py``
on a machine with one.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mxnet_tpu.ops.paged_attention import (
    dense_decode_attention as jax_dense,
    paged_decode_attention as jax_paged)
from mxnet_tpu.ops.pallas.paged_attention import \
    paged_decode_attention_pallas
from mxnet_tpu_torch.ops import paged_attention as tpa

TOL = dict(rtol=1e-5, atol=1e-5)
gpu = pytest.mark.gpu


def _fixture(seed=0, lengths=(11, 5, 0, 1, 4, 12), pages_per_seq=3, page=4,
             heads=2, d=8, extra_pages=2):
    """q, pools, page tables of distinct pages (page 0 = sink), lengths."""
    rng = np.random.RandomState(seed)
    lengths = np.asarray(lengths, np.int32)
    slots = len(lengths)
    n_pages = 1 + slots * pages_per_seq + extra_pages
    q = rng.randn(slots, heads, d).astype(np.float32)
    kp = rng.randn(n_pages, page, heads, d).astype(np.float32)
    vp = rng.randn(n_pages, page, heads, d).astype(np.float32)
    tables = np.zeros((slots, pages_per_seq), np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for s in range(slots):
        for j in range(-(-int(lengths[s]) // page)):
            tables[s, j] = free.pop()
    return q, kp, vp, tables, lengths


def _jax(fn, *arrays, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), **kw))


def _port(*arrays):
    return tpa.paged_decode_attention(*(torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("seed,lengths", [
    (0, (11, 5, 0, 1, 4, 12)),
    (1, (12, 12, 12)),
    (2, (0, 0, 3)),
    (3, (7, 8, 9, 1, 2, 6, 10, 4)),
])
def test_plain_matches_jax_jnp(seed, lengths):
    """Every slot, inactive ones included: both plain paths give an
    inactive slot uniform weights over its masked context."""
    args = _fixture(seed, lengths)
    ref = _jax(jax_paged, *args, impl="jnp")
    out = _port(*args).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.all(np.isfinite(out))


@pytest.mark.parametrize("seed,lengths", [
    (0, (11, 5, 0, 1, 4, 12)),
    (4, (3, 0, 12, 8)),
])
def test_plain_matches_pallas_interpret_on_active_slots(seed, lengths):
    """The TPU kernel (Pallas interpreter) against the port's plain
    version.  Active slots only: a length-0 slot is zeros from the
    kernel and uniform weights from the plain version."""
    args = _fixture(seed, lengths)
    ref = _jax(paged_decode_attention_pallas, *args, interpret=True)
    out = _port(*args).numpy()
    act = args[-1] > 0
    np.testing.assert_allclose(out[act], ref[act], **TOL)
    assert np.all(ref[~act] == 0.0)


def test_dense_decode_attention_parity():
    q, kp, vp, tables, lengths = _fixture(5)
    slots, P = tables.shape
    ctx = P * kp.shape[1]
    kc = kp[tables].reshape(slots, ctx, *kp.shape[2:])
    vc = vp[tables].reshape(slots, ctx, *vp.shape[2:])
    ref = _jax(jax_dense, q, kc, vc, lengths)
    out = tpa.dense_decode_attention(
        *(torch.from_numpy(a) for a in (q, kc, vc, lengths))).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    # and the paged plain version agrees with the dense one
    paged = _port(q, kp, vp, tables, lengths).numpy()
    np.testing.assert_allclose(paged, out, **TOL)


def test_out_of_range_page_ids_clamp_like_jax():
    """JAX clamps an out-of-range gather index; the port clamps it too
    instead of raising, so both read the same (last) page."""
    q, kp, vp, tables, lengths = _fixture(6, (5, 9))
    tables = tables.copy()
    tables[1, 2] = kp.shape[0] + 7          # masked by length, still read
    tables[0, 1] = kp.shape[0] + 1          # inside the valid context
    ref = _jax(jax_paged, q, kp, vp, tables, lengths, impl="jnp")
    out = _port(q, kp, vp, tables, lengths).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_cpu_wrapper_runs_plain_and_launches_nothing():
    before = tpa.paged_decode_attention.launches
    args = _fixture(7)
    out = _port(*args)
    ref = tpa.paged_decode_attention_reference(
        *(torch.from_numpy(a) for a in args))
    assert torch.equal(out, ref)
    assert tpa.paged_decode_attention.launches == before


def test_wrapper_refuses_other_devices():
    """Neither CPU nor CUDA: the wrapper raises instead of guessing."""
    args = [torch.from_numpy(a).to("meta") for a in _fixture(8)]
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tpa.paged_decode_attention(*args)


def test_scale_is_float32_rounded():
    for d in (8, 16, 64, 80):
        ref = np.asarray(1.0 / jnp.sqrt(jnp.asarray(d, jnp.float32)))
        assert np.float32(tpa._scale(d)) == ref


# ------------------------------------------------------------ on the card --
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")


@gpu
@pytest.mark.parametrize("lengths,page,d", [
    ((11, 5, 0, 1, 4, 12), 4, 8),
    ((0, 1, 63, 64, 65, 128), 64, 64),
    ((2048, 1, 0, 777, 1024, 64), 64, 128),
])
def test_kernel_matches_plain_on_card(lengths, page, d):
    _need_card()
    pps = -(-max(lengths) // page)
    args = _fixture(9, lengths, pages_per_seq=pps, page=page, heads=4, d=d)
    dev = [torch.from_numpy(a).cuda() for a in args]
    before = tpa.paged_decode_attention.launches
    out = tpa.paged_decode_attention(*dev)
    ref = tpa.paged_decode_attention_reference(*dev)
    torch.cuda.synchronize()
    assert tpa.paged_decode_attention.launches == before + 1
    act = dev[-1] > 0
    torch.testing.assert_close(out[act], ref[act], rtol=1e-4, atol=1e-5)
    assert bool((out[~act] == 0).all())


@gpu
def test_kernel_raises_on_what_it_does_not_take():
    _need_card()
    q, kp, vp, tables, lengths = (torch.from_numpy(a).cuda()
                                  for a in _fixture(10))
    with pytest.raises(TypeError):
        tpa.paged_decode_attention(q.double(), kp, vp, tables, lengths)
    with pytest.raises(TypeError):
        tpa.paged_decode_attention(q, kp, vp, tables.long(), lengths)
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(q, kp.transpose(0, 1), vp, tables,
                                   lengths)
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(q.cpu(), kp, vp, tables, lengths)
