"""Port parity: ``mxnet_tpu_torch.serving.generate`` against the JAX
package's LLM serving, on the CPU — the slice as a whole.

- the prefill and decode steps against the JAX programs on identical
  pools, tables and tokens (pools within float32 tolerance, greedy
  tokens equal);
- ``PageAllocator`` cases;
- the JAX ``GenerationServer(attention_impl="jnp")`` and the port's on
  ``device="cpu"`` return IDENTICAL greedy tokens for the same params
  and prompts, also under a pool small enough to force preemption;
- seeded sampling: the port's threefry bits equal ``jax.random``'s bit
  for bit, ``_sample_tokens`` returns ``jax.random.categorical``'s
  tokens, and the two servers return the same tokens for seeded
  ``temperature > 0`` requests, with and without preemption; the same
  seed gives the same tokens whatever the slot or batch mix, and the
  draws follow ``softmax(_scaled_masked)`` within a total-variation
  bound;
- the port imports neither ``jax`` nor ``mxnet_tpu``.

Weights are drawn with std 0.3 so that, at every greedy decision
compared, the top two logits differ by more than 1e-3 (asserted):
float32 sums taken in another order cannot flip a token.
"""
import gc
import ast
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mxnet_tpu.gluon.model_zoo import causal_lm as jlm
from mxnet_tpu.serving import BucketSpec as JBucketSpec
from mxnet_tpu.serving import GenerationServer as JGenerationServer
from mxnet_tpu.serving import generate as jgen
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch.gluon.model_zoo import causal_lm as tlm
from mxnet_tpu_torch.serving import (BucketSpec, DeadlineExceededError,
                                     GenerationServer, PageAllocator,
                                     PoolExhaustedError, RejectedError,
                                     ServerClosedError)
from mxnet_tpu_torch.serving import generate as tgen

CFG = dict(vocab_size=48, n_layers=2, n_heads=2, head_dim=8, d_ff=32)
JCFG, TCFG = jlm.CausalLMConfig(**CFG), tlm.CausalLMConfig(**CFG)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
GAP = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
gpu = pytest.mark.gpu


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    """Collect this module's cyclic garbage (JAX-side arrays among it)
    before the next module runs in the same worker, so that module's
    memory accounting does not see it freed mid-test."""
    yield
    gc.collect()


def loud_params(seed=3, std=0.3):
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in jlm.init_causal_lm(JCFG, seed).items():
        shape = np.asarray(v).shape
        if k in ("embed", "wqkv", "wo", "w1", "w2"):
            out[k] = (std * rng.randn(*shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


NP = loud_params()
JP = {k: jnp.asarray(v) for k, v in NP.items()}
TP = tlm.params_from_jax(NP, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_gap(logits, rows=None):
    """Top-2 logit gap above ``GAP`` at every compared row."""
    lg = np.asarray(logits, np.float64)
    if rows is not None:
        lg = lg[rows]
    top2 = np.sort(lg, axis=-1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    assert gap.min() > GAP, f"near-tie: top-2 gap {gap.min():.2e}"


def assert_greedy_decisions_separated(prompt, out):
    """Teacher-forced: the full forward over prompt + output has a
    top-2 gap above ``GAP`` at every position that chose a token."""
    full = np.concatenate([prompt, out]).astype(np.int32)[None]
    lg = tlm.sequence_logits(TP, TCFG, _t(full))[0].numpy()
    assert_gap(lg[len(prompt) - 1:len(full[0]) - 1])


# -------------------------------------------------------------- allocator --
def test_allocator_alloc_extend_free():
    a = PageAllocator(9, 4)
    assert a.allocatable == 8 and a.free_count() == 8
    assert a.pages_for(1) == 1 and a.pages_for(4) == 1
    assert a.pages_for(5) == 2 and a.pages_for(0) == 0
    p1 = a.alloc(3)
    assert len(p1) == 3 and 0 not in p1       # page 0 is the sink
    p2 = a.alloc(5)
    assert a.free_count() == 0
    assert set(p1) | set(p2) == set(range(1, 9))
    a.free(p2)
    assert a.free_count() == 5


def test_allocator_exhaustion_is_all_or_nothing():
    a = PageAllocator(5, 2)
    a.alloc(2)
    before = a.free_count()
    with pytest.raises(PoolExhaustedError):
        a.alloc(3)
    assert a.free_count() == before


def test_allocator_fragmentation_reuse():
    a = PageAllocator(9, 4)
    held = [a.alloc(2) for _ in range(4)]
    assert a.free_count() == 0
    a.free(held[0])
    a.free(held[2])
    again = a.alloc(4)
    assert sorted(again) == sorted(held[0] + held[2])


def test_allocator_refcounts_and_double_free():
    a = PageAllocator(6, 2)
    p = a.alloc(2)
    a.share(p[:1])
    assert a.refcount(p[0]) == 2 and a.shared_pages() == 1
    assert a.free(p) == [p[1]]                 # p[0] still has a holder
    assert a.free(p[:1]) == [p[0]]
    with pytest.raises(ValueError):
        a.free(p[:1])                          # double free
    with pytest.raises(ValueError):
        a.share([p[1]])                        # not live
    assert a.free_count() == a.allocatable and a.live_pages() == 0


@pytest.mark.parametrize("n_pages,page_size", [(1, 4), (4, 0)])
def test_allocator_validation(n_pages, page_size):
    with pytest.raises(ValueError):
        PageAllocator(n_pages, page_size)


def test_allocator_matches_jax_allocator_sequence():
    """The same alloc/free script hands out the same page ids."""
    ja, ta = jgen.PageAllocator(11, 4), PageAllocator(11, 4)
    script = [("a", 3), ("a", 2), ("f", 0), ("a", 4), ("f", 1), ("a", 1)]
    jheld, theld = [], []
    for op, n in script:
        if op == "a":
            jheld.append(ja.alloc(n))
            theld.append(ta.alloc(n))
        else:
            ja.free(jheld[n])
            ta.free(theld[n])
        assert jheld == theld and ja.free_count() == ta.free_count()


# --------------------------------------------------------- step parity --
def _pools(seed, n_pages=12, page=4):
    rng = np.random.RandomState(seed)
    shape = (CFG["n_layers"], n_pages, page, CFG["n_heads"],
             CFG["head_dim"])
    return (0.5 * rng.randn(*shape)).astype(np.float32), \
        (0.5 * rng.randn(*shape)).astype(np.float32)


def test_prefill_then_decode_steps_match_jax():
    """Prefill a batch into the pools, then two decode steps, on both
    sides from the same state: pools allclose after every step (sink
    page 0 excluded — duplicate padded writes land there in any order),
    greedy tokens equal with every decision's gap asserted."""
    page = 4
    kp, vp = _pools(0)
    rng = np.random.RandomState(1)
    b, L = 3, 8
    tokens = rng.randint(0, 48, size=(b, L)).astype(np.int32)
    lengths = np.asarray([8, 5, 2], np.int32)
    active = np.asarray([True, True, False])
    tables = np.asarray([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    seeds = np.asarray([1, 2, 3], np.uint32)
    temps = np.zeros((b,), np.float32)
    topks = np.zeros((b,), np.int32)

    jpre = jgen.build_prefill_step(JCFG, page)
    tpre = tgen.build_prefill_step(TCFG, page)
    jfirst, jk, jv = jpre(JP, jnp.asarray(kp), jnp.asarray(vp),
                          *(jnp.asarray(a) for a in (
                              tokens, lengths, active, tables, seeds,
                              temps, topks)))
    tk, tv = _t(kp.copy()), _t(vp.copy())
    tfirst, tk2, tv2 = tpre(TP, tk, tv, *(_t(a) for a in (
        tokens, lengths, active, tables, seeds.astype(np.int64), temps,
        topks)))
    assert tk2 is tk and tv2 is tv             # updated in place
    logits, _, _ = tlm.prefill_forward(TP, TCFG, _t(tokens), _t(lengths))
    assert_gap(logits.numpy(), active)
    np.testing.assert_array_equal(tfirst.numpy()[active],
                                  np.asarray(jfirst)[active])
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               **POOL_TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                               **POOL_TOL)

    jdec = jgen.build_decode_step(JCFG, page, attention_impl="jnp")
    tdec = tgen.build_decode_step(TCFG, page)
    cur = np.asarray(jfirst).astype(np.int32)
    cur_len = lengths.copy()
    zeros = np.zeros((b,), np.int32)
    for _ in range(2):
        kc, vc = tk.clone(), tv.clone()
        lg = tgen.decode_logits(TP, TCFG, page, kc, vc, _t(cur),
                                _t(cur_len), _t(active), _t(tables))
        assert_gap(lg.numpy(), active)
        jn, jk, jv = jdec(JP, jk, jv, *(jnp.asarray(a) for a in (
            cur, cur_len, active, tables, zeros, zeros, seeds, temps,
            topks)))
        tn, _, _ = tdec(TP, tk, tv, *(_t(a) for a in (
            cur, cur_len, active, tables, zeros, zeros,
            seeds.astype(np.int64), temps, topks)))
        np.testing.assert_array_equal(tn.numpy()[active],
                                      np.asarray(jn)[active])
        np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                                   **POOL_TOL)
        np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                                   **POOL_TOL)
        cur = np.asarray(jn).astype(np.int32)
        cur_len = cur_len + active


def test_paged_decode_step_matches_dense_decode_step():
    """The paged step against the dense max-length-cache reference, on
    a cache holding the same K/V."""
    page, P, S = 4, 3, 3
    ctx = P * page
    rng = np.random.RandomState(2)
    kp, vp = _pools(3)
    tables = np.asarray([[1, 2, 3], [4, 5, 6], [7, 0, 0]], np.int32)
    lengths = np.asarray([9, 4, 2], np.int32)
    active = np.asarray([True, True, True])
    kd = kp[:, tables].reshape(CFG["n_layers"], S, ctx, 2, 8).copy()
    vd = vp[:, tables].reshape(CFG["n_layers"], S, ctx, 2, 8).copy()
    tokens = rng.randint(0, 48, size=S).astype(np.int32)
    seeds = np.arange(S, dtype=np.int64)
    temps = np.zeros((S,), np.float32)
    topks = np.zeros((S,), np.int32)
    zeros = np.zeros((S,), np.int32)
    pn, _, _ = tgen.build_decode_step(TCFG, page)(
        TP, _t(kp), _t(vp), *(_t(a) for a in (
            tokens, lengths, active, tables, zeros, zeros, seeds, temps,
            topks)))
    kdt, vdt = _t(kd), _t(vd)
    dn, _, _ = tgen.build_dense_decode_step(TCFG, ctx)(
        TP, kdt, vdt, *(_t(a) for a in (tokens, lengths, active, seeds,
                                        temps, topks)))
    np.testing.assert_array_equal(pn.numpy(), dn.numpy())


def test_decode_step_cow_lanes_copy_pages_in_place():
    page = 4
    kp, vp = _pools(4)
    k, v = _t(kp.copy()), _t(vp.copy())
    S = 2
    src = np.asarray([3, 0], np.int32)
    dst = np.asarray([5, 0], np.int32)
    tgen.build_decode_step(TCFG, page)(
        TP, k, v, *(_t(a) for a in (
            np.zeros(S, np.int32), np.zeros(S, np.int32),
            np.zeros(S, bool), np.zeros((S, 2), np.int32), src, dst,
            np.zeros(S, np.int64), np.zeros(S, np.float32),
            np.zeros(S, np.int32))))
    np.testing.assert_array_equal(k.numpy()[:, 5], kp[:, 3])
    np.testing.assert_array_equal(v.numpy()[:, 5], vp[:, 3])
    np.testing.assert_array_equal(k.numpy()[:, 1:5], kp[:, 1:5])


# ------------------------------------------------------- server parity --
def _servers(buckets, **kw):
    name = f"TorchParity-{time.monotonic_ns()}"
    js = JGenerationServer(JP, JCFG, buckets=JBucketSpec(**buckets),
                           attention_impl="jnp", name=name + "-jax", **kw)
    ts = GenerationServer(TP, TCFG, buckets=BucketSpec(**buckets),
                          device="cpu", name=name + "-torch", **kw)
    return js, ts


def _serve(srv, prompts, **kw):
    srv.start()
    try:
        reqs = [srv.submit(p, **kw) for p in prompts]
        return [r.result(timeout=120) for r in reqs]
    finally:
        assert srv.drain(60)


def test_generation_server_greedy_tokens_match_jax():
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 48, size=int(rng.randint(1, 9)))
               .astype(np.int32) for _ in range(6)]
    js, ts = _servers(dict(batch=(1, 2), length=(8,)), n_slots=2,
                      n_pages=17, page_size=4, max_new_tokens=6, seed=0)
    jout = _serve(js, prompts)
    tout = _serve(ts, prompts)
    for p, a, b in zip(prompts, jout, tout):
        assert b.dtype == np.int32 and len(b) == 6
        np.testing.assert_array_equal(b, a)
        assert_greedy_decisions_separated(p, b)
    st = ts.stats
    assert st["completed"] == 6 and st["failed"] == 0
    assert st["free_pages"] == ts.alloc.allocatable


def test_generation_server_greedy_tokens_match_jax_under_preemption():
    """Two sequences that each fit the pool alone but not together: the
    port preempts (tokens kept, resumed by re-prefill + replay) and
    still returns the JAX server's tokens exactly."""
    prompts = [np.asarray([1, 2, 3, 4], np.int32),
               np.asarray([5, 6, 7, 8], np.int32)]
    js, ts = _servers(dict(batch=(1,), length=(4,)), n_slots=2, n_pages=8,
                      page_size=4, max_new_tokens=24, seed=0)
    jout = _serve(js, prompts, max_new_tokens=24)
    with tfault.inject("generate.evict", RuntimeError("probe"),
                       after_n=10 ** 9) as h:      # count, never raise
        tout = _serve(ts, prompts, max_new_tokens=24)
    assert h.calls >= 1 and ts.stats["preempted"] >= 1
    assert ts.stats["resumes"] >= 1
    for p, a, b in zip(prompts, jout, tout):
        assert len(b) == 24
        np.testing.assert_array_equal(b, a)
        assert_greedy_decisions_separated(p, b)
    assert ts.alloc.free_count() == ts.alloc.allocatable


# -------------------------------------------------------------- sampling --
def test_scaled_masked_matches_jax():
    rng = np.random.RandomState(8)
    logits = rng.randn(5, 16).astype(np.float32)
    temps = np.asarray([0.0, 0.5, 1.0, 2.0, 1.0], np.float32)
    topks = np.asarray([0, 3, 0, 16, 1], np.int32)
    ref = np.asarray(jgen._scaled_masked(*(jnp.asarray(a) for a in (
        logits, temps, topks))))
    out = tgen._scaled_masked(_t(logits), _t(temps), _t(topks)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


SEEDS = np.asarray([0, 1, 7, 1234, 99991, 2 ** 31 - 1, 2 ** 31,
                    2 ** 32 - 1], np.uint32)
POSITIONS = np.asarray([0, 1, 5, 63, 64, 1000, 2 ** 20, 2 ** 31 - 1],
                       np.int32)


def test_threefry_bits_equal_jax_bit_for_bit():
    """``fold_in(PRNGKey(seed), position)`` then ``bits(key, (vocab,))``
    and ``uniform(key, minval=tiny)``: the port's int64 arithmetic gives
    JAX's values exactly, every seed x position pair."""
    import jax

    seeds = np.repeat(SEEDS, len(POSITIONS))
    positions = np.tile(POSITIONS, len(SEEDS))
    vocab = 53
    keys = jgen._position_keys(jnp.asarray(seeds), jnp.asarray(positions))
    jbits = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (vocab,), jnp.uint32))(keys))
    tkeys = tgen._position_keys(_t(seeds.astype(np.int64)), _t(positions))
    np.testing.assert_array_equal(np.asarray(keys).astype(np.int64),
                                  np.stack([k.numpy() for k in tkeys], 1))
    tbits = tgen._random_bits(tkeys, vocab).numpy()
    np.testing.assert_array_equal(tbits, jbits.astype(np.int64))
    tiny = np.finfo(np.float32).tiny
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (vocab,), jnp.float32, minval=tiny, maxval=1.0))(keys))
    np.testing.assert_array_equal(tgen._uniform(_t(tbits)).numpy(), ju)


def test_sample_tokens_equal_jax_categorical():
    """4096 rows of random logits, seeds, positions, temperatures and
    top-k: the port's tokens are ``jax.random.categorical``'s.  The two
    ``log``s of the Gumbel noise may differ in the last place (f32), so
    a row may differ only where its top two noisy logits lie within
    1e-5 of each other; no such row occurs with these seeds."""
    rng = np.random.RandomState(12)
    rows, vocab = 4096, 48
    logits = (2.0 * rng.randn(rows, vocab)).astype(np.float32)
    seeds = rng.randint(0, 2 ** 32, rows, dtype=np.int64).astype(np.uint32)
    positions = rng.randint(0, 4096, rows).astype(np.int32)
    temps = rng.choice([0.0, 0.3, 0.7, 1.0, 1.5], rows).astype(np.float32)
    topks = rng.choice([0, 1, 5, 20], rows).astype(np.int32)
    ref = np.asarray(jgen._sample_tokens(*(jnp.asarray(a) for a in (
        logits, seeds, positions, temps, topks))))
    out = tgen._sample_tokens(_t(logits), _t(seeds.astype(np.int64)),
                              _t(positions), _t(temps), _t(topks)).numpy()
    differ = np.flatnonzero(out != ref)
    if differ.size:
        noisy = (tgen._scaled_masked(_t(logits), _t(temps), _t(topks))
                 + tgen._gumbel_noise(_t(seeds.astype(np.int64)),
                                      _t(positions), vocab)).numpy()
        gap = np.abs(noisy[differ, out[differ]] - noisy[differ, ref[differ]])
        assert gap.max() <= 1e-5, (differ, gap)
    assert differ.size == 0, f"near-tie rows {differ.tolist()}"
    assert (temps > 0).sum() > 3000


@pytest.mark.parametrize("preempt", [False, True])
def test_generation_server_seeded_sampling_matches_jax(preempt):
    """Seeded ``temperature > 0`` requests (with and without top-k) on
    the JAX server and the port's return the same tokens; with a pool
    too small for both sequences the port preempts and resumes and still
    returns them."""
    prompts = [np.asarray([1, 2, 3, 4], np.int32),
               np.asarray([5, 6, 7], np.int32),
               np.asarray([8, 9], np.int32)]
    kws = [dict(temperature=1.0, seed=11), dict(temperature=0.7, top_k=5),
           dict(temperature=1.3, seed=2 ** 31 + 5)]
    if preempt:
        geo = dict(n_slots=2, n_pages=8, page_size=4, max_new_tokens=20)
        buckets = dict(batch=(1,), length=(4,))
    else:
        geo = dict(n_slots=2, n_pages=17, page_size=4, max_new_tokens=8)
        buckets = dict(batch=(1, 2), length=(8,))
    outs = []
    for srv in _servers(buckets, seed=3, **geo):
        srv.start()
        try:
            reqs = [srv.submit(p, **kw) for p, kw in zip(prompts, kws)]
            outs.append([r.result(timeout=120) for r in reqs])
        finally:
            assert srv.drain(60)
    for a, b in zip(*outs):
        assert len(b) == geo["max_new_tokens"]
        np.testing.assert_array_equal(b, a)
    if preempt:
        assert srv.stats["preempted"] >= 1 and srv.stats["resumes"] >= 1


def _tv(draws, p):
    emp = np.bincount(draws, minlength=p.shape[0]) / len(draws)
    return 0.5 * np.abs(emp - p).sum()


@pytest.mark.parametrize("temp,topk,vary", [
    (1.0, 0, "seed"), (0.7, 0, "position"), (1.5, 5, "seed")])
def test_sampling_follows_scaled_masked_softmax(temp, topk, vary):
    """20000 draws of one logits row, the noise varied over seeds or
    over positions: total variation to ``softmax(_scaled_masked)``
    below 0.03 (the sampling error alone is about 0.01 at this size),
    and nothing outside the top-k is ever drawn."""
    n, vocab = 20000, 16
    row = np.random.RandomState(9).randn(vocab).astype(np.float32)
    logits = _t(np.tile(row, (n, 1)))
    ids = torch.arange(n, dtype=torch.int64)
    seeds = ids if vary == "seed" else torch.full((n,), 77)
    positions = torch.full((n,), 5) if vary == "seed" else ids
    temps = torch.full((n,), temp)
    topks = torch.full((n,), topk, dtype=torch.int32)
    draws = tgen._sample_tokens(logits, seeds, positions, temps,
                                topks).numpy()
    p = torch.softmax(tgen._scaled_masked(logits[:1], temps[:1],
                                          topks[:1]), -1)[0].numpy()
    assert _tv(draws, p) < 0.03
    if topk:
        allowed = set(np.argsort(-row)[:topk].tolist())
        assert set(draws.tolist()) <= allowed


def test_sampling_noise_is_a_function_of_seed_position_vocab_only():
    seeds = torch.tensor([5, 9, 5, 1 << 31], dtype=torch.int64)
    positions = torch.tensor([3, 3, 3, 4000], dtype=torch.int64)
    a = tgen._gumbel_noise(seeds, positions, 32)
    assert torch.equal(a[0], a[2])             # same (seed, pos), any row
    assert not torch.equal(a[0], a[1])
    b = tgen._gumbel_noise(seeds.flip(0), positions.flip(0), 32)
    assert torch.equal(a, b.flip(0))           # row order does not matter
    assert torch.isfinite(a).all()


def test_greedy_rows_ignore_the_noise():
    logits = _t(np.random.RandomState(10).randn(4, 16).astype(np.float32))
    out = tgen._sample_tokens(logits, torch.arange(4), torch.arange(4),
                              torch.zeros(4), torch.zeros(4, dtype=torch.int32))
    assert torch.equal(out, logits.argmax(-1).to(torch.int32))


def test_seeded_sampling_is_independent_of_slot_and_batch_mix():
    """The same (prompt, seed) sampled alone on a 1-slot server and amid
    other traffic on a 4-slot server gives the same tokens."""
    prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    kw = dict(temperature=1.0, top_k=0, seed=1234, max_new_tokens=6)

    def run(n_slots, others):
        srv = GenerationServer(
            TP, TCFG, buckets=BucketSpec(batch=(1, 2), length=(8,)),
            n_slots=n_slots, n_pages=33, page_size=4, max_new_tokens=6,
            device="cpu", name=f"TorchSeed-{time.monotonic_ns()}").start()
        try:
            reqs = [srv.submit(np.asarray([7 + i, 2], np.int32),
                               temperature=0.8, max_new_tokens=6)
                    for i in range(others)]
            mine = srv.submit(prompt, **kw)
            reqs += [srv.submit(np.asarray([9, 9, i], np.int32),
                                max_new_tokens=5) for i in range(others)]
            out = mine.result(timeout=60)
            for r in reqs:
                r.result(timeout=60)
            return out
        finally:
            assert srv.drain(30)

    alone = run(1, 0)
    mixed = run(4, 3)
    np.testing.assert_array_equal(alone, mixed)


# ------------------------------------------------------ server lifecycle --
def _small_server(**kw):
    kw.setdefault("buckets", BucketSpec(batch=(1, 2), length=(8,)))
    kw.setdefault("n_slots", 2)
    kw.setdefault("n_pages", 17)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_new_tokens", 4)
    return GenerationServer(TP, TCFG, device="cpu",
                            name=f"TorchLife-{time.monotonic_ns()}", **kw)


def test_slot_arrays_are_staged_in_one_buffer_per_step():
    """The scheduler's slot arrays are views of the decode step's one
    host staging buffer; an upload copies all of them into the device
    views the step reads.  The CPU captures no graph."""
    srv = _small_server()
    staged = srv._decode_in
    assert np.shares_memory(srv._tokens, staged.host["tokens"])
    assert np.shares_memory(srv._tables, staged.host["tables"])
    srv._tokens[:] = [3, 4]
    srv._tables[1, :2] = [5, 6]
    srv._seeds[0] = 2 ** 40 + 1
    srv._active[1] = True
    staged.upload()
    assert staged.dev["tokens"].tolist() == [3, 4]
    assert staged.dev["tables"][1, :2].tolist() == [5, 6]
    assert staged.dev["seeds"][0].item() == 2 ** 40 + 1
    assert staged.dev["active"].tolist() == [False, True]
    assert staged.dev["cow"].dtype == torch.int32
    assert srv.census() == 3 and srv.graph_count() == 0


def test_server_rejects_unservable_prompts_and_drains():
    srv = _small_server().start()
    try:
        with pytest.raises(RejectedError):
            srv.submit(np.arange(9, dtype=np.int32))        # > bucket
        with pytest.raises(ValueError):
            srv.submit(np.asarray([1.5, 2.0]))               # not ints
        reqs = [srv.submit(np.asarray([i + 1, 2], np.int32))
                for i in range(5)]
    finally:
        assert srv.drain(30)
    assert all(r.done() for r in reqs)
    assert all(len(r.result(0)) == 4 for r in reqs)
    with pytest.raises(ServerClosedError):
        srv.submit(np.asarray([1], np.int32))
    assert srv.stats["rejected"] == 2          # ValueErrors are not sheds


def test_decode_fault_fails_seated_requests_and_server_recovers():
    srv = _small_server(max_new_tokens=3).start()
    try:
        with tfault.inject("generate.decode", RuntimeError("boom"),
                           times=1):
            r = srv.submit(np.asarray([1, 2, 3], np.int32))
            with pytest.raises(RuntimeError, match="boom"):
                r.result(timeout=60)
        ok = srv.submit(np.asarray([4, 5], np.int32)).result(timeout=60)
        assert len(ok) == 3
        assert srv.stats["failed"] == 1
        assert srv.healthz()["last_error"]["type"] == "RuntimeError"
    finally:
        assert srv.drain(30)
    assert srv.alloc.free_count() == srv.alloc.allocatable


def test_prefill_fault_fails_the_group_only():
    srv = _small_server().start()
    try:
        with tfault.inject("generate.prefill", RuntimeError("pf"),
                           times=1):
            bad = srv.submit(np.asarray([1, 2], np.int32))
            with pytest.raises(RuntimeError, match="pf"):
                bad.result(timeout=60)
        good = srv.submit(np.asarray([3], np.int32)).result(timeout=60)
        assert len(good) == 4
    finally:
        assert srv.drain(30)


def test_deadline_expires_in_queue_without_device_work():
    srv = _small_server(n_slots=1, max_new_tokens=8).start()
    try:
        first = srv.submit(np.asarray([1, 2], np.int32))
        late = srv.submit(np.asarray([3, 4], np.int32), deadline=1e-4)
        with pytest.raises(DeadlineExceededError):
            late.result(timeout=60)
        assert len(first.result(timeout=60)) == 8
    finally:
        assert srv.drain(30)


def test_default_device_constructor_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationServer(TP, TCFG, name="TorchNoCard")


def test_profiler_records_prefill_and_decode_spans(tmp_path):
    """With the port's profiler running, the server's prefill/decode
    spans and counter series land in the dumped Chrome trace."""
    import json

    from mxnet_tpu_torch import profiler

    out = tmp_path / "trace.json"
    profiler.set_config(filename=str(out), profile_sync=True)
    profiler.start()
    try:
        srv = _small_server(max_new_tokens=3).start()
        try:
            srv.submit(np.asarray([1, 2], np.int32)).result(timeout=60)
        finally:
            assert srv.drain(30)
        profiler.dump()
    finally:
        profiler.stop()
        profiler.set_config()
    events = json.loads(out.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert f"{srv._name}.prefill" in names and f"{srv._name}.decode" in names
    assert f"{srv._name}::tokens_out" in names
    spans = [e for e in events if e["ph"] == "X"]
    assert all(e["dur"] >= 0 for e in spans)


# ------------------------------------------------------------- isolation --
def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, importlib, pkgutil\n"
        "import mxnet_tpu_torch as m\n"
        "for info in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'mxnet_tpu' or n.startswith('mxnet_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _port_sources():
    """Every Python source of the port, and ``chip_smoke.py``."""
    yield os.path.join(REPO, "chip_smoke.py")
    for d, dirs, files in os.walk(os.path.join(REPO, "mxnet_tpu_torch")):
        dirs[:] = [x for x in dirs if x != "_build"]      # build output
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_port_sources_import_no_jax_statically():
    found = []
    sources = list(_port_sources())
    for mod in ("gluon/nn/fused.py", "parallel/step.py",
                "gluon/model_zoo/vision/resnet.py", "ops/fused_conv.py"):
        assert os.path.join(REPO, "mxnet_tpu_torch", mod) in sources
    for path in sources:
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"):
                    found.append((path, n))
    assert not found, found


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory (no package beside it) or without a card,
    chip_smoke.py exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    src = os.path.join(REPO, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(src, encoding="utf-8").read())
    for script, cwd in ((src, REPO), (str(lone), str(tmp_path))):
        res = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


# ------------------------------------------------------------ on the card --
@gpu
def test_card_server_matches_cpu_server_greedy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    from mxnet_tpu_torch.ops.paged_attention import paged_decode_attention

    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 48, size=int(rng.randint(1, 9)))
               .astype(np.int32) for _ in range(6)]
    outs = {}
    before = paged_decode_attention.launches
    for dev in ("cpu", "cuda"):
        srv = GenerationServer(
            TP, TCFG, buckets=BucketSpec(batch=(1, 2), length=(8,)),
            n_slots=2, n_pages=17, page_size=4, max_new_tokens=6,
            device=dev, name=f"TorchCard-{dev}-{time.monotonic_ns()}")
        outs[dev] = _serve(srv, prompts)
    assert paged_decode_attention.launches > before
    for a, b in zip(outs["cpu"], outs["cuda"]):
        np.testing.assert_array_equal(a, b)
