"""Port parity: speculative decoding in ``mxnet_tpu_torch`` against the
JAX package, on the CPU.

- ``causal_lm.window_logits`` / ``verify_logits`` / ``draft_config``
  against the JAX functions from the same ``params_from_jax`` weights
  (f32, ``atol=rtol=1e-5``);
- the speculative roles' keys ``fold_in(fold_in(PRNGKey(seed), pos),
  domain)``, the scalar ``jax.random.uniform(key, ())`` and the
  denormal-flushed ``log`` of the correction draw, bit for bit;
- ``build_verify_step`` as a function: ``emitted`` and ``n_accept``
  equal the JAX step's on greedy and sampling rows with a live
  copy-on-write lane, the pools agree;
- speculative servers: greedy tokens equal the JAX speculative server's
  and the JAX plain server's, seeded-sampling tokens and the acceptance
  counts equal the JAX speculative server's; the target as its own
  draft (the accept path) gives the plain tokens;
- the first emitted token follows the target's tempered top-k
  distribution whatever the draft proposes (the JAX package's
  statistical-identity test, its draws as rows of one step);
- constructor validation, and (on the card only) the paged kernel at
  the verify step's shape against its plain version.

Weights are ``test_torch_generate``'s (std 0.3, top-2 gaps asserted
where a greedy decision is compared).
"""
import gc
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mxnet_tpu.gluon.model_zoo import causal_lm as jlm
from mxnet_tpu.serving import BucketSpec as JBucketSpec
from mxnet_tpu.serving import GenerationServer as JGenerationServer
from mxnet_tpu.serving import generate as jgen
from mxnet_tpu_torch.gluon.model_zoo import causal_lm as tlm
from mxnet_tpu_torch.ops import paged_attention as tpa
from mxnet_tpu_torch.serving import BucketSpec, GenerationServer
from mxnet_tpu_torch.serving import generate as tgen

from test_torch_generate import (JCFG, JP, NP, POOL_TOL, TCFG, TP, _t,
                                 assert_gap, gpu)

JDCFG = jlm.draft_config(JCFG, n_layers=1)
TDCFG = tlm.draft_config(TCFG, n_layers=1)
LOUD = ("embed", "wqkv", "wo", "w1", "w2")


def _draft_np(seed=5, std=0.3):
    rng = np.random.RandomState(seed)
    return {k: (std * rng.randn(*np.asarray(v).shape)).astype(np.float32)
            if k in LOUD else np.asarray(v, np.float32)
            for k, v in jlm.init_causal_lm(JDCFG, seed).items()}


DNP = _draft_np()
JDP = {k: jnp.asarray(v) for k, v in DNP.items()}
TDP = tlm.params_from_jax(DNP, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    yield
    gc.collect()


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# ------------------------------------------------------ causal-LM helpers --
def test_draft_config_equals_jax():
    for kw in ({}, dict(n_layers=3), dict(n_heads=4, head_dim=4, d_ff=16)):
        j, t = jlm.draft_config(JCFG, **kw), tlm.draft_config(TCFG, **kw)
        assert (j.vocab_size, j.n_layers, j.n_heads, j.head_dim, j.d_ff) \
            == (t.vocab_size, t.n_layers, t.n_heads, t.head_dim, t.d_ff)


def test_window_logits_match_jax():
    rng = np.random.RandomState(0)
    S, W = 5, 8
    tokens = rng.randint(0, 48, size=(S, W)).astype(np.int32)
    n_valid = np.asarray([1, 3, 8, 5, 2], np.int32)
    ref = np.asarray(jlm.window_logits(JP, JCFG, *_j(tokens, n_valid)))
    out = tlm.window_logits(TP, TCFG, _t(tokens), _t(n_valid)).numpy()
    np.testing.assert_allclose(out, ref, **POOL_TOL)
    # the invalid leading entries are masked: they do not matter
    other = tokens.copy()
    other[0, :W - 1] = (other[0, :W - 1] + 7) % 48
    again = tlm.window_logits(TP, TCFG, _t(other), _t(n_valid)).numpy()
    np.testing.assert_allclose(again[0], out[0], rtol=1e-6, atol=1e-6)


def test_verify_logits_match_jax():
    """The lane-flattened stack through a cache hook that both sides
    compute the same way (``ctx = q / 2 + v``)."""
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 48, size=(3, 4)).astype(np.int32)
    seen = []

    def jattend(layer, q, k, v):
        seen.append(layer)
        return q * 0.5 + v

    ref = np.asarray(jlm.verify_logits(JP, JCFG, jnp.asarray(tokens),
                                       jattend))
    out = tlm.verify_logits(TP, TCFG, _t(tokens),
                            lambda layer, q, k, v: q * 0.5 + v).numpy()
    assert seen == [0, 1] and out.shape == (3, 4, 48)
    np.testing.assert_allclose(out, ref, **POOL_TOL)


# ---------------------------------------------------------- random streams --
@pytest.mark.parametrize("domain", [None, 1, 2, 3])
def test_domain_keys_and_scalar_uniform_equal_jax(domain):
    """``_position_keys(..., domain)`` is ``fold_in(key, domain)`` and
    ``_scalar_uniform`` is ``jax.random.uniform(key, ())`` (its [0, 1)
    transform, not the Gumbel path's [tiny, 1)), bit for bit;
    ``bits(key, ())`` is ``bits(key, (1,))[0]``."""
    rng = np.random.RandomState(2)
    seeds = np.concatenate([rng.randint(0, 2 ** 32, 200, dtype=np.int64),
                            [0, 2 ** 32 - 1]]).astype(np.uint32)
    positions = np.concatenate([rng.randint(0, 1 << 20, 200),
                                [0, 2 ** 31 - 1]]).astype(np.int32)
    jkeys = jgen._position_keys(*_j(seeds, positions), domain=domain)
    tkeys = tgen._position_keys(_t(seeds.astype(np.int64)), _t(positions),
                                domain=domain)
    np.testing.assert_array_equal(
        np.asarray(jkeys).astype(np.int64),
        np.stack([k.numpy() for k in tkeys], 1))
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(jkeys))
    np.testing.assert_array_equal(tgen._scalar_uniform(tkeys).numpy(), ju)
    jb = np.asarray(jax.vmap(lambda k: jax.random.bits(k, ()))(jkeys))
    np.testing.assert_array_equal(
        tgen._random_bits(tkeys, 1)[:, 0].numpy(), jb.astype(np.int64))
    assert ju.min() >= 0.0 and ju.max() < 1.0


def test_flushed_log_is_the_xla_cpu_value():
    """The correction draw's ``log(max(p, 1e-38))``: XLA on the CPU
    flushes denormals, so 0, 1e-38 and every denormal give ``-inf``; the
    port's ``_flushed_log`` gives the same values (and the same draws)."""
    tiny = np.finfo(np.float32).tiny
    p = np.asarray([0.0, 1e-45, 1e-39, 1e-38, tiny, 2 * tiny, 1e-10, 0.5,
                    1.0], np.float32)
    ref = np.asarray(jnp.log(jnp.maximum(jnp.asarray(p), 1e-38)))
    out = tgen._flushed_log(_t(p)).numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-6)
    assert np.isneginf(ref[:4]).all()


# ------------------------------------------------------------ verify step --
def _verify_case(seed, page=4, S=4, P=5, W=8):
    rng = np.random.RandomState(seed)
    shape = (2, 1 + S * P, page, 2, 8)
    kp = (0.5 * rng.randn(*shape)).astype(np.float32)
    vp = (0.5 * rng.randn(*shape)).astype(np.float32)
    tables = (1 + np.arange(S * P)).reshape(S, P).astype(np.int32)
    lengths = np.asarray([5, 9, 2, 3], np.int32)
    active = np.asarray([True, True, True, False])
    tokens = rng.randint(0, 48, S).astype(np.int32)
    window = rng.randint(0, 48, (S, W)).astype(np.int32)
    n_valid = np.asarray([6, 8, 3, 1], np.int32)
    # a live copy-on-write lane: slot 1's write block 2 takes page 7's
    # content before the step writes it
    cow_src = np.asarray([0, 7, 0, 0], np.int32)
    cow_dst = np.asarray([0, tables[1, 2], 0, 0], np.int32)
    seeds = np.asarray([3, 11, 2 ** 31 + 7, 4], np.uint32)
    temps = np.asarray([0.0, 0.8, 1.3, 0.0], np.float32)
    topks = np.asarray([0, 5, 0, 0], np.int32)
    return kp, vp, (tokens, window, n_valid, lengths, active, tables,
                    cow_src, cow_dst, seeds, temps, topks)


@pytest.mark.parametrize("draft", ["small", "self"])
@pytest.mark.parametrize("seed", [0, 1])
def test_verify_step_matches_jax(draft, seed):
    """``emitted`` and ``n_accept`` equal the JAX verify step's on every
    active slot — greedy rows and sampling rows, a live CoW lane — and
    the pools agree (sink page 0 excluded).  ``self``: the target's
    two layers as the draft."""
    page, k, W = 4, 3, 8
    if draft == "small":
        jd, td, jdp, tdp = JDCFG, TDCFG, JDP, TDP
    else:
        jd, td = jlm.draft_config(JCFG, n_layers=2), \
            tlm.draft_config(TCFG, n_layers=2)
        jdp, tdp = JP, TP
    kp, vp, args = _verify_case(seed, page=page, W=W)
    active = args[4]
    jstep = jax.jit(jgen.build_verify_step(JCFG, jd, page, k, W,
                                           attention_impl="jnp"))
    je, ja, jk, jv = jstep(JP, jdp, *_j(kp, vp, *args))
    targs = [_t(a) for a in args]
    targs[8] = _t(args[8].astype(np.int64))
    tk, tv = _t(kp.copy()), _t(vp.copy())
    te, ta, tk2, tv2 = tgen.build_verify_step(TCFG, td, page, k, W)(
        TP, tdp, tk, tv, *targs)
    assert tk2 is tk and tv2 is tv                 # updated in place
    assert te.dtype == ta.dtype == torch.int32
    np.testing.assert_array_equal(te.numpy()[active],
                                  np.asarray(je)[active])
    np.testing.assert_array_equal(ta.numpy()[active],
                                  np.asarray(ja)[active])
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               **POOL_TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                               **POOL_TOL)


def test_verify_step_greedy_rows_track_the_target_argmax():
    """On greedy rows every emitted token is the target's argmax given
    the tokens before it (teacher-forced over prompt + window), with
    the top-2 gap asserted."""
    page, k, W = 4, 3, 8
    kp, vp, args = _verify_case(3, page=page, W=W)
    # a cache the target wrote itself: prefill the slots' prompts
    rng = np.random.RandomState(4)
    lengths = args[3]
    prompts = [rng.randint(0, 48, int(n)).astype(np.int32)
               for n in lengths]
    tokens = np.zeros((4, 16), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    kp = np.zeros_like(kp)
    vp = np.zeros_like(vp)
    tk, tv = _t(kp), _t(vp)
    tgen.build_prefill_step(TCFG, page)(
        TP, tk, tv, _t(tokens), _t(lengths), _t(np.ones(4, bool)),
        _t(args[5]), torch.zeros(4, dtype=torch.int64),
        torch.zeros(4), torch.zeros(4, dtype=torch.int32))
    greedy = np.zeros(4, np.float32)
    zeros = np.zeros(4, np.int32)
    cur = args[0]
    targs = [_t(a) for a in (cur, args[1], args[2], lengths,
                             np.ones(4, bool), args[5], zeros, zeros)]
    e, a, _, _ = tgen.build_verify_step(TCFG, TDCFG, page, k, W)(
        TP, TDP, tk, tv, *targs, torch.arange(4), _t(greedy), _t(zeros))
    for s in range(4):
        n = int(a[s]) + 1
        full = np.concatenate([prompts[s], [cur[s]], e[s, :n].numpy()])
        lg = tlm.sequence_logits(TP, TCFG, _t(full[None]))[0].numpy()
        rows = lg[len(prompts[s]):len(prompts[s]) + n]
        assert_gap(rows)
        np.testing.assert_array_equal(rows.argmax(-1), e[s, :n].numpy())


# ------------------------------------------------------------------ servers --
PROMPTS = [np.random.RandomState(6).randint(0, 48, size=n).astype(np.int32)
           for n in (3, 8, 1, 6, 5, 7)]
KWS = [dict(), dict(temperature=0.9, seed=7), dict(),
       dict(temperature=1.2, top_k=6, seed=9), dict(),
       dict(temperature=0.5)]
GEO = dict(n_slots=4, n_pages=33, page_size=4, max_new_tokens=8, seed=0)
SPEC = dict(spec_k=3, spec_window=8)
BUCKETS = dict(batch=(1, 2), length=(8,))


def _serve(srv):
    srv.start()
    try:
        reqs = [srv.submit(p, **kw) for p, kw in zip(PROMPTS, KWS)]
        return [r.result(timeout=120) for r in reqs]
    finally:
        assert srv.drain(60)


@pytest.fixture(scope="module")
def jax_runs():
    name = f"TorchSpecJ-{time.monotonic_ns()}"
    spec = JGenerationServer(JP, JCFG, buckets=JBucketSpec(**BUCKETS),
                             attention_impl="jnp", draft=JDP,
                             draft_config=JDCFG, name=name + "-spec",
                             **GEO, **SPEC)
    out_spec = _serve(spec)
    plain = JGenerationServer(JP, JCFG, buckets=JBucketSpec(**BUCKETS),
                              attention_impl="jnp", name=name + "-plain",
                              **GEO)
    out_plain = _serve(plain)
    assert spec.jit_cache_count() == spec.census() == 2 + 2
    return out_spec, out_plain, spec.stats


def test_speculative_server_matches_jax(jax_runs):
    """Greedy tokens equal the JAX speculative server's and the JAX
    plain server's; seeded-sampling tokens, verify steps and accepted
    proposals equal the JAX speculative server's."""
    jspec, jplain, jst = jax_runs
    srv = GenerationServer(TP, TCFG, buckets=BucketSpec(**BUCKETS),
                           device="cpu", draft=DNP, draft_config=TDCFG,
                           name=f"TorchSpec-{time.monotonic_ns()}", **GEO,
                           **SPEC)
    assert srv.census() == 2 + 2 and srv.graph_count() == 0
    out = _serve(srv)
    for kw, o, js, jp in zip(KWS, out, jspec, jplain):
        assert len(o) == GEO["max_new_tokens"] and o.dtype == np.int32
        np.testing.assert_array_equal(o, js)
        if not kw:
            np.testing.assert_array_equal(o, jp)
    st = srv.stats
    for key in ("verify_steps", "spec_proposed", "spec_accepted",
                "decode_steps", "tokens_out", "completed"):
        assert st[key] == jst[key], key
    assert st["verify_steps"] > 0
    assert 0 < st["spec_accepted"] < st["spec_proposed"]
    assert srv.alloc.free_count() == srv.alloc.allocatable
    hist = srv.telemetry()["histograms"]["spec_accept_rate"]
    assert hist["count"] > 0


def test_self_draft_server_accepts_and_keeps_the_plain_tokens(jax_runs):
    """The target as its own draft (the accept path): greedy tokens are
    the plain server's and most proposals are accepted."""
    _, jplain, _ = jax_runs
    srv = GenerationServer(TP, TCFG, buckets=BucketSpec(**BUCKETS),
                           device="cpu", draft=NP,
                           draft_config=tlm.draft_config(TCFG, n_layers=2),
                           name=f"TorchSelf-{time.monotonic_ns()}", **GEO,
                           **SPEC)
    out = _serve(srv)
    for kw, o, jp in zip(KWS, out, jplain):
        if not kw:
            np.testing.assert_array_equal(o, jp)
    st = srv.stats
    assert st["spec_accepted"] > st["spec_proposed"] // 2


def test_speculative_sampling_statistical_identity():
    """The first emitted token's marginal equals the target's tempered
    top-k distribution whatever the draft proposes (the JAX package's
    test, its 600 fresh-seed calls as 600 rows of one step, each row on
    its own copy of the prefilled pages), never off-support; a repeated
    seed repeats the decision."""
    page, n_prompt, temp, topk, n = 4, 6, 1.0, 8, 600
    prompt = ((np.arange(n_prompt, dtype=np.int32) * 5) + 2) % 48
    P = 4
    pool = torch.zeros((2, 1 + P, page, 2, 8))
    kp, vp = pool.clone(), pool.clone()
    toks = np.zeros((1, 8), np.int32)
    toks[0, :n_prompt] = prompt
    t0, _, _ = tgen.build_prefill_step(TCFG, page)(
        TP, kp, vp, _t(toks), _t(np.asarray([n_prompt], np.int32)),
        _t(np.asarray([True])), _t(np.asarray([[1, 2, 3, 4]], np.int32)),
        torch.zeros(1, dtype=torch.int64), torch.zeros(1),
        torch.zeros(1, dtype=torch.int32))
    t0 = int(t0[0])
    full = np.zeros((1, n_prompt + 1), np.int32)
    full[0, :n_prompt] = prompt
    full[0, n_prompt] = t0
    z = tlm.sequence_logits(TP, TCFG, _t(full))[0, -1].numpy() / temp
    kth = np.sort(z)[-topk]
    z = np.where(z >= kth, z, -np.inf)
    p_ref = np.exp(z - z.max())
    p_ref /= p_ref.sum()
    # every row its own pages holding the prefilled prompt
    kbig = torch.zeros((2, 1 + n * P, page, 2, 8))
    vbig = torch.zeros_like(kbig)
    kbig[:, 1:] = kp[:, 1:].repeat(1, n, 1, 1, 1)
    vbig[:, 1:] = vp[:, 1:].repeat(1, n, 1, 1, 1)
    tables = (1 + np.arange(n * P)).reshape(n, P).astype(np.int32)
    window = np.zeros((n, 8), np.int32)
    window[:, -(n_prompt + 1):] = list(prompt) + [t0]
    zeros = np.zeros(n, np.int32)
    step = tgen.build_verify_step(TCFG, TDCFG, page, 2, 8)

    def run(seeds):
        m = len(seeds)
        return step(TP, TDP, kbig, vbig, *(_t(a) for a in (
            np.full(m, t0, np.int32), window[:m],
            np.full(m, n_prompt + 1, np.int32),
            np.full(m, n_prompt, np.int32), np.ones(m, bool), tables[:m],
            zeros[:m], zeros[:m], np.asarray(seeds, np.int64),
            np.full(m, temp, np.float32), np.full(m, topk, np.int32))))[0]

    first = run(np.arange(n))[:, 0].numpy()
    emp = np.bincount(first, minlength=48) / n
    assert emp[p_ref == 0].sum() == 0              # never off-support
    tv = 0.5 * np.abs(emp - p_ref).sum()
    assert tv < 0.12, tv
    a, b = run([42, 42]), run([42])
    assert torch.equal(a[0], a[1]) and torch.equal(a[0], b[0])


def test_speculative_validation_errors():
    def make(**kw):
        return GenerationServer(TP, TCFG, device="cpu",
                                buckets=BucketSpec(**BUCKETS), **kw)

    with pytest.raises(ValueError, match="draft_config"):
        make(draft=DNP)
    bad = tlm.CausalLMConfig(vocab_size=49, n_layers=1, n_heads=2,
                             head_dim=8, d_ff=32)
    with pytest.raises(ValueError, match="vocab"):
        make(draft=DNP, draft_config=bad)
    with pytest.raises(ValueError, match="spec_k"):
        make(draft=DNP, draft_config=TDCFG, spec_k=0)
    with pytest.raises(ValueError, match="spec_window"):
        make(draft=DNP, draft_config=TDCFG, spec_window=0)
    with pytest.raises(ValueError, match="spec_k"):
        tgen.build_verify_step(TCFG, TDCFG, 4, 0, 8)
    with pytest.raises(ValueError, match="vocab"):
        tgen.build_verify_step(TCFG, bad, 4, 2, 8)


def test_speculative_admission_reserves_the_lookahead():
    """The page table holds ``spec_k`` positions past the largest
    prompt bucket plus the generation budget, and admission refuses a
    request whose worst case with them does not fit."""
    srv = GenerationServer(TP, TCFG, device="cpu",
                           buckets=BucketSpec(**BUCKETS), n_pages=33,
                           page_size=4, max_new_tokens=8, draft=DNP,
                           draft_config=TDCFG, spec_k=3).start()
    try:
        assert srv.pages_per_seq == -(-(8 + 8 + 3) // 4)
        assert srv.max_context == 20
        with pytest.raises(tgen.RejectedError, match="spec_k"):
            srv.submit(np.arange(8, dtype=np.int32), max_new_tokens=10)
        assert len(srv.submit(np.arange(8, dtype=np.int32),
                              max_new_tokens=9).result(60)) == 9
    finally:
        assert srv.drain(30)


def test_partition_of_the_verify_shape():
    """The serving config's verify step: 64 slots x 4 lanes = 256 rows
    of 3 pages x 64 (64 + 64 + 3 positions): enough blocks without head
    chunks, so the heads stay whole and each row's context is cut in
    three splits, merged in order."""
    p = tpa._partition(256, 8, 64, 64, 3, 132)
    assert (p.heads_per_chunk, p.head_chunks, p.n_split, p.blocks) == (
        8, 1, 3, 768)
    assert p.ws_floats == 256 * 3 * 8 * 66


# ------------------------------------------------------------ on the card --
@gpu
def test_kernel_at_the_verify_shape_matches_plain_on_card():
    """64 slots x 4 lanes, each slot's table repeated per lane, lane i
    attending over its slot's length + i + 1 positions: the kernel
    against its plain version, every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    rng = np.random.RandomState(8)
    slots, lanes, heads, d, page, pps = 64, 4, 8, 64, 64, 3
    n_pages = 1 + slots * pps
    q = rng.randn(slots * lanes, heads, d).astype(np.float32)
    kp = rng.randn(n_pages, page, heads, d).astype(np.float32)
    vp = rng.randn(n_pages, page, heads, d).astype(np.float32)
    tables = np.repeat((1 + rng.permutation(slots * pps)).reshape(
        slots, pps).astype(np.int32), lanes, axis=0)
    base = rng.randint(4, 124, slots)
    lengths = (np.repeat(base, lanes)
               + np.tile(np.arange(lanes), slots) + 1).astype(np.int32)
    dev = [torch.from_numpy(a).cuda() for a in (q, kp, vp, tables,
                                                lengths)]
    before = tpa.paged_decode_attention.launches
    out = tpa.paged_decode_attention(*dev)
    ref = tpa.paged_decode_attention_reference(*dev)
    torch.cuda.synchronize()
    assert tpa.paged_decode_attention.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
