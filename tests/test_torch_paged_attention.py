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
    """Not all on the CPU nor all on one CUDA device: the wrapper raises
    instead of guessing.  ``meta`` tensors alone are a shape inference's
    trace and get the plain version's shape (nothing runs)."""
    host = [torch.from_numpy(a) for a in _fixture(8)]
    args = [t.to("meta") for t in host]
    assert tpa.paged_decode_attention(*args).shape == args[0].shape
    args[1] = host[1]
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tpa.paged_decode_attention(*args)


def test_launch_plan_is_not_made_inside_a_capture(monkeypatch):
    """A captured graph bakes a plan's workspace and counters in, so the
    plan of the capturing stream is made before the capture: asked for a
    new one while a capture runs, the wrapper raises before it allocates
    anything."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    args = [torch.from_numpy(a) for a in _fixture(9)]
    n = len(tpa._PLANS)
    with pytest.raises(RuntimeError, match="before a capture"):
        tpa._plan(*args, device=0, stream=-1)
    assert len(tpa._PLANS) == n


def test_scale_is_float32_rounded():
    for d in (8, 16, 64, 80):
        ref = np.asarray(1.0 / jnp.sqrt(jnp.asarray(d, jnp.float32)))
        assert np.float32(tpa._scale(d)) == ref


# ------------------------------------------- the kernel's split and merge --
def _split_merge(q, kp, vp, tables, lengths, part, fault=None):
    """The CUDA kernel's arithmetic in numpy f32, on the partition the
    wrapper gives it: each split of ``part.span`` positions of a slot
    yields a partial (m, l, acc) per head, and the partials are merged in
    split order; a slot of length 0 gets zeros, as from the kernel.
    ``fault`` breaks the merge on purpose: ``"drop"`` leaves out a slot's
    last split, ``"wrong_m"`` scales acc by the first split's m instead of
    the common maximum."""
    slots, heads, d = q.shape
    n_pages, page = kp.shape[:2]
    ctx = tables.shape[1] * page
    scale = np.float32(tpa._scale(d))
    out = np.zeros_like(q)
    for s in range(slots):
        n = int(np.clip(lengths[s], 0, ctx))
        if n == 0:
            continue
        parts = []
        for k in range(-(-n // part.span)):
            pos = np.arange(k * part.span, min((k + 1) * part.span, n))
            pages = np.clip(tables[s, pos // page], 0, n_pages - 1)
            keys, vals = kp[pages, pos % page], vp[pages, pos % page]
            sc = np.einsum("hd,thd->ht", q[s] * scale, keys)
            m = sc.max(axis=1)
            p = np.exp(sc - m[:, None])
            parts.append((m, p.sum(axis=1), np.einsum("ht,thd->hd", p, vals)))
        if fault == "drop" and len(parts) > 1:
            parts = parts[:-1]
        top = np.max([m for m, _, _ in parts], axis=0)
        l = np.zeros(heads, np.float32)
        acc = np.zeros((heads, d), np.float32)
        for m, lk, ak in parts:
            e = np.exp(m - top)
            l += lk * e
            acc += ak * (np.exp(m - parts[0][0]) if fault == "wrong_m"
                         else e)[:, None]
        out[s] = acc / l[:, None]
    return out


# Lengths that end on a split boundary (32, 64), one before and one after
# it, 0, 1 and the full context; pages_per_seq 10 is no multiple of a
# split's 4 pages.
SPLIT_LENGTHS = (32, 31, 33, 64, 63, 65, 0, 1, 80)
SPLIT_CASES = {
    # name: (fixture kwargs, lengths, sms) -> at the kernel's own stage
    # size, 4 positions a stage and splits of 8 stages: span 32, 3 splits
    "narrow": (dict(pages_per_seq=10, page=8, heads=8, d=128),
               SPLIT_LENGTHS, 3),
    # heads in two chunks (8 + 4 of D = 128), span 32, 2 splits
    "chunked": (dict(pages_per_seq=10, page=4, heads=12, d=128),
                (32, 31, 33, 0, 1, 40), 2),
}


def _split_case(name, bad_ids=False):
    kw, lengths, sms = SPLIT_CASES[name]
    args = _fixture(11, lengths, **kw)
    if bad_ids:
        tables = args[3].copy()
        tables[0, 1] = args[1].shape[0] + 3     # inside slot 0's context
        tables[2, 0] = args[1].shape[0] + 9
        args = (*args[:3], tables, args[4])
    q, kp, _, tables, _ = args
    part = tpa._partition(q.shape[0], q.shape[1], q.shape[2], kp.shape[1],
                          tables.shape[1], sms)
    return args, part


@pytest.mark.parametrize("name,bad_ids", [("narrow", False),
                                          ("narrow", True),
                                          ("chunked", False)])
@pytest.mark.parametrize("oracle", ["jnp", "pallas"])
def test_split_merge_matches_jax(name, bad_ids, oracle):
    """The kernel's per-split partials and their in-order merge, on the
    wrapper's own partition, against the JAX jnp path (active slots) and
    the Pallas kernel in interpret mode (every slot: zeros at length 0).
    Out-of-range page ids are clamped."""
    args, part = _split_case(name, bad_ids)
    assert part.n_split > 1 and part.span % part.stage_positions == 0
    out = _split_merge(*args, part)
    act = args[-1] > 0
    if oracle == "jnp":
        ref = _jax(jax_paged, *args, impl="jnp")
        np.testing.assert_allclose(out[act], ref[act], rtol=1e-4, atol=1e-5)
    else:
        ref = _jax(paged_decode_attention_pallas, *args, interpret=True)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    assert np.all(out[~act] == 0.0)


@pytest.mark.parametrize("fault", ["drop", "wrong_m"])
def test_split_merge_check_catches_a_broken_merge(fault):
    """The cases above are strong enough: a merge that drops a split or
    scales acc by the wrong m disagrees with the JAX jnp path."""
    args, part = _split_case("narrow")
    bad = _split_merge(*args, part, fault=fault)
    ref = _jax(jax_paged, *args, impl="jnp")
    act = args[-1] > 0
    assert not np.allclose(bad[act], ref[act], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("slots,heads,d,page,pps,sms", [
    (64, 8, 64, 64, 2, 132),       # the serving config
    (64, 8, 64, 64, 32, 132),      # long
    (64, 8, 64, 64, 256, 132),     # few-long
    (6, 4, 8, 4, 3, 132),          # the card tests' small shapes
    (6, 4, 128, 64, 32, 132),
    (5, 12, 128, 16, 5, 4),        # two head chunks, 8 + 4
    (1000, 8, 64, 64, 2, 132),     # many slots
    (3, 1, 4, 1, 7, 1),            # page 1, D 4, one SM
])
def test_partition_fits_the_kernel(slots, heads, d, page, pps, sms):
    """What the kernel checks, from static shapes only: stages within
    their bytes, splits of whole stages that cover the context, one full
    slot spread over every SM (a split of ctx / sms positions, rounded up
    to whole stages) unless splits reach their least length of
    _MIN_STAGES stages, a block per (slot, split, head chunk), a workspace
    for every partial."""
    p = tpa._partition(slots, heads, d, page, pps, sms)
    ctx = pps * page
    hc = p.heads_per_chunk
    assert 1 <= hc <= heads and hc * d <= tpa._ROW_FLOATS
    if hc < min(heads, tpa._ROW_FLOATS // d):     # cut for short contexts
        assert hc * d * 4 >= tpa._MIN_ROW_BYTES
        assert slots * -(-heads // (2 * hc)) * p.n_split < sms
    assert p.head_chunks == -(-heads // hc)
    assert 2 * p.stage_positions * hc * d * 4 <= tpa._STAGE_BYTES
    assert p.span % p.stage_positions == 0
    assert p.n_split * p.span >= ctx > (p.n_split - 1) * p.span
    tc, least = p.stage_positions, tpa._MIN_STAGES * p.stage_positions
    assert p.span >= min(least, -(-ctx // tc) * tc)
    assert p.span <= max(least, -(-ctx // sms) + tc - 1)
    assert p.blocks == slots * p.head_chunks * p.n_split
    assert p.ws_floats == (slots * p.n_split * heads * (d + 2)
                           if p.n_split > 1 else 0)
    assert p.counters == slots * p.head_chunks


def test_partition_of_the_serving_config():
    """64 slots of at most 2 pages x 64: whole-head splits would give 128
    blocks for 132 SMs, so the heads go in chunks of 2 (512-byte rows) and
    each (slot, chunk) is one block over the whole context: 256 blocks,
    no merge."""
    p = tpa._partition(64, 8, 64, 64, 2, 132)
    assert (p.heads_per_chunk, p.head_chunks, p.n_split, p.blocks) == (
        2, 4, 1, 256)
    assert p.ws_floats == 0


# ------------------------------------------------------------ on the card --
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")


@gpu
@pytest.mark.parametrize("lengths,page,d", [
    ((11, 5, 0, 1, 4, 12), 4, 8),
    ((0, 1, 63, 64, 65, 128), 64, 64),
    ((2048, 1, 0, 777, 1024, 64), 64, 128),
    # few long slots among idle ones
    ((1024, 0, 0, 1000) + (0,) * 12, 16, 64),
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


@gpu
@pytest.mark.parametrize("heads,d", [(12, 128), (32, 128)])
def test_kernel_takes_heads_in_chunks_on_card(heads, d):
    """H x D over 1024 floats: the kernel copies the heads' rows in
    chunks, row by row."""
    _need_card()
    lengths = (16, 400, 3, 0, 77, 512)
    args = _fixture(3, lengths, pages_per_seq=32, page=16, heads=heads, d=d)
    dev = [torch.from_numpy(a).cuda() for a in args]
    out = tpa.paged_decode_attention(*dev)
    ref = tpa.paged_decode_attention_reference(*dev)
    act = dev[-1] > 0
    torch.testing.assert_close(out[act], ref[act], rtol=1e-4, atol=1e-5)
    assert bool((out[~act] == 0).all())


@gpu
def test_kernel_takes_many_slots_on_card():
    """600 slots, a few long among idle ones: one grid takes them all."""
    _need_card()
    lengths = np.zeros(600, np.int32)
    lengths[[3, 511, 512, 599]] = (600, 517, 64, 1)
    args = _fixture(14, lengths, pages_per_seq=10, page=64, heads=4, d=8)
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
def test_kernel_repeats_its_bits_on_card():
    """Splits merged in order, no float atomics: two launches give the
    same bits."""
    _need_card()
    lengths = (2048, 1, 0, 777, 1024, 64)
    args = _fixture(12, lengths, pages_per_seq=32, page=64, heads=4, d=128)
    dev = [torch.from_numpy(a).cuda() for a in args]
    first = tpa.paged_decode_attention(*dev)
    second = tpa.paged_decode_attention(*dev)
    assert torch.equal(first, second)


@gpu
def test_kernel_launch_does_not_sync_on_card():
    """The wrapper reads neither lengths nor tables on the host: a call
    under ``set_sync_debug_mode("error")`` raises nothing."""
    _need_card()
    args = _fixture(13, (0, 1, 63, 64, 65, 128), pages_per_seq=2, page=64,
                    heads=4, d=64)
    dev = [torch.from_numpy(a).cuda() for a in args]
    tpa.paged_decode_attention(*dev)          # plan and workspace made
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tpa.paged_decode_attention(*dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
