"""Port parity: disaggregated prefill of ``mxnet_tpu_torch.serving``
(``GenerationServer(prefill_workers=n)``) against the JAX package's, on
the CPU.

- ``build_prefill_kv_step`` against JAX's: first tokens equal, the K/V
  payload within float32 tolerance (rtol = atol = 1e-5);
- ``build_handoff_step`` against JAX's on identical pools (sink page 0
  excluded: duplicate padded writes land there in any order);
- the prefill-KV step followed by the handoff gives the fused prefill
  step's pools;
- the JAX ``GenerationServer`` and the port's, built with identical
  arguments (``attention_impl="jnp"``, the same ``prefill_workers``),
  return the same greedy tokens with 1 and 2 workers and the same
  seeded-sampling tokens in a calm run and under a preempting pool; the
  census is the bucket grid + 2 on both;
- the JAX server's disaggregation regressions: a 24-deep backlog
  drained at once resolves everything; a ``fleet.handoff`` fault fails
  only its group; a decode fault salvages through the prefill-KV path;
  ``drain(handoff=True)`` exports sequences still in the pipeline and a
  successor completes them; the span tree carries the ``handoff`` span
  and the worker's name;
- a stress run: six workers sharing two length buckets' steps with
  threads switched every microsecond give the fused server's tokens;
- on the card (``gpu`` marker): the captured disaggregated server gives
  the CPU server's tokens with ``graph_count() == census()``, with the
  graphs captured at ``start()`` and captured lazily by the workers.
"""
import gc
import sys
import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mxnet_tpu.serving import BucketSpec as JBucketSpec
from mxnet_tpu.serving import GenerationServer as JGenerationServer
from mxnet_tpu.serving import generate as jgen
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.gluon.model_zoo import causal_lm as tlm
from mxnet_tpu_torch.serving import (BucketSpec, CircuitBreaker,
                                     GenerationServer, ServerClosedError)
from mxnet_tpu_torch.serving import generate as tgen

from test_torch_generate import (CFG, JCFG, JP, POOL_TOL, TCFG, TP, _t,
                                 assert_gap, gpu)
from test_torch_prefix_sharing import oracle_greedy


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    yield
    gc.collect()


@pytest.fixture(autouse=True)
def _telemetry_off():
    yield
    telemetry.disable()


def _pools(seed, n_pages=12, page=4):
    rng = np.random.RandomState(seed)
    shape = (CFG["n_layers"], n_pages, page, CFG["n_heads"],
             CFG["head_dim"])
    return (0.5 * rng.randn(*shape)).astype(np.float32), \
        (0.5 * rng.randn(*shape)).astype(np.float32)


def _prompt_batch(seed, b=3, L=8, lengths=(8, 5, 2)):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, CFG["vocab_size"], size=(b, L)).astype(np.int32)
    return (tokens, np.asarray(lengths, np.int32),
            np.asarray([1, 2, 3], np.uint32)[:b],
            np.zeros((b,), np.float32), np.zeros((b,), np.int32))


# --------------------------------------------------------------- steps --
def test_prefill_kv_step_matches_jax():
    """First tokens equal (every decision's gap asserted) and the K/V
    payload within 1e-5, zero past each row's length on both sides."""
    tokens, lengths, seeds, temps, topks = _prompt_batch(5)
    jfirst, jk, jv = jgen.build_prefill_kv_step(JCFG)(
        JP, *(jnp.asarray(a) for a in (tokens, lengths, seeds, temps,
                                       topks)))
    tfirst, tk, tv = tgen.build_prefill_kv_step(TCFG)(
        TP, _t(tokens), _t(lengths), _t(seeds.astype(np.int64)),
        _t(temps), _t(topks))
    logits, _, _ = tlm.prefill_forward(TP, TCFG, _t(tokens), _t(lengths))
    assert_gap(logits.numpy())
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    assert tk.shape == (CFG["n_layers"], 3, 8, CFG["n_heads"],
                        CFG["head_dim"])
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **POOL_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **POOL_TOL)
    assert not tk.numpy()[:, 1, 5:].any() and not tv.numpy()[:, 2, 2:].any()


def test_handoff_step_matches_jax():
    """The same payload scattered into the same pools on both sides:
    pools allclose outside the sink page; the port writes in place."""
    page = 4
    kp, vp = _pools(6)
    rng = np.random.RandomState(7)
    B, L = 4, 12
    shape = (CFG["n_layers"], B, L, CFG["n_heads"], CFG["head_dim"])
    k_all = rng.randn(*shape).astype(np.float32)
    v_all = rng.randn(*shape).astype(np.float32)
    lengths = np.asarray([12, 5, 9, 3], np.int32)
    active = np.asarray([True, True, False, True])
    tables = np.asarray([[1, 2, 3], [4, 5, 0], [6, 7, 8], [9, 0, 0]],
                        np.int32)
    jk, jv = jgen.build_handoff_step(JCFG, page)(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k_all),
        jnp.asarray(v_all), jnp.asarray(lengths), jnp.asarray(active),
        jnp.asarray(tables))
    tk, tv = _t(kp.copy()), _t(vp.copy())
    tk2, tv2 = tgen.build_handoff_step(TCFG, page)(
        tk, tv, _t(k_all), _t(v_all), _t(lengths), _t(active), _t(tables))
    assert tk2 is tk and tv2 is tv
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:],
                               **POOL_TOL)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:],
                               **POOL_TOL)
    # the inactive lane's pages keep their content
    np.testing.assert_array_equal(tk.numpy()[:, 6:9], kp[:, 6:9])


def test_prefill_kv_then_handoff_equals_fused_prefill():
    """Disaggregation is a scheduling change, not a math change: the
    pool-free step's payload, placed in a larger staging batch (as the
    server's fixed handoff shape), scatters to the fused step's pools
    and the first tokens are the same."""
    page = 4
    kp, vp = _pools(8)
    tokens, lengths, seeds, temps, topks = _prompt_batch(9)
    active = np.asarray([True, True, True])
    tables = np.asarray([[1, 2, 3], [4, 5, 0], [6, 0, 0]], np.int32)
    fk, fv = _t(kp.copy()), _t(vp.copy())
    ffirst, _, _ = tgen.build_prefill_step(TCFG, page)(
        TP, fk, fv, *(_t(a) for a in (tokens, lengths, active, tables,
                                      seeds.astype(np.int64), temps,
                                      topks)))
    dfirst, k_all, v_all = tgen.build_prefill_kv_step(TCFG)(
        TP, _t(tokens), _t(lengths), _t(seeds.astype(np.int64)),
        _t(temps), _t(topks))
    B, L = 4, 16
    kbuf = torch.zeros((CFG["n_layers"], B, L, CFG["n_heads"],
                        CFG["head_dim"]))
    vbuf = torch.zeros_like(kbuf)
    kbuf[:, :3, :8] = k_all
    vbuf[:, :3, :8] = v_all
    dk, dv = _t(kp.copy()), _t(vp.copy())
    tgen.build_handoff_step(TCFG, page)(
        dk, dv, kbuf, vbuf, _t(np.append(lengths, 0)),
        _t(np.append(active, False)),
        _t(np.concatenate([tables, np.zeros((1, 3), np.int32)])))
    np.testing.assert_array_equal(dfirst.numpy(), ffirst.numpy())
    np.testing.assert_array_equal(dk.numpy()[:, 1:], fk.numpy()[:, 1:])
    np.testing.assert_array_equal(dv.numpy()[:, 1:], fv.numpy()[:, 1:])


# -------------------------------------------------------- server parity --
GREEDY = dict(buckets=dict(batch=(1, 2), length=(8,)), n_slots=2,
              n_pages=17, page_size=4, max_new_tokens=6, seed=0)
GREEDY_PROMPTS = [np.random.RandomState(7).randint(0, 48, size=n)
                  .astype(np.int32) for n in (3, 8, 1, 5, 2, 7)]
SAMPLED_PROMPTS = [np.asarray([1, 2, 3, 4], np.int32),
                   np.asarray([5, 6, 7], np.int32),
                   np.asarray([8, 9], np.int32)]
SAMPLED_KW = [dict(temperature=1.0, seed=11),
              dict(temperature=0.7, top_k=5),
              dict(temperature=1.3, seed=2 ** 31 + 5)]
SAMPLED = {"calm": dict(buckets=dict(batch=(1, 2), length=(8,)), n_slots=2,
                        n_pages=17, page_size=4, max_new_tokens=8, seed=3),
           "preempt": dict(buckets=dict(batch=(1,), length=(4,)), n_slots=2,
                           n_pages=8, page_size=4, max_new_tokens=20,
                           seed=3)}


def _pair(buckets, **kw):
    """The JAX server and the port's, built with IDENTICAL arguments:
    ``attention_impl="jnp"`` (the plain paged attention on both) and the
    same ``prefill_workers``."""
    name = f"TorchDisagg-{time.monotonic_ns()}"
    kw = dict(kw, attention_impl="jnp")
    js = JGenerationServer(JP, JCFG, buckets=JBucketSpec(**buckets),
                           name=name + "-jax", **kw)
    ts = GenerationServer(TP, TCFG, buckets=BucketSpec(**buckets),
                          device="cpu", name=name + "-torch", **kw)
    return js, ts


def _run(srv, prompts, kws=None):
    """Start, submit every prompt, wait, drain; returns the tokens and
    the server's census, graph count and health after the traffic."""
    kws = kws or [{}] * len(prompts)
    srv.start()
    try:
        reqs = [srv.submit(p, **kw) for p, kw in zip(prompts, kws)]
        outs = [np.asarray(r.result(timeout=120)) for r in reqs]
        health = srv.healthz()
    finally:
        assert srv.drain(60)
    return outs, health


@pytest.fixture(scope="module")
def jax_greedy():
    """The JAX server's greedy tokens with 1 and 2 prefill workers (one
    server each, run once for the module)."""
    out = {}
    for workers in (1, 2):
        js, _ = _pair(prefill_workers=workers, **GREEDY)
        out[workers] = _run(js, GREEDY_PROMPTS)[0]
        assert js.jit_cache_count() == js.census() == 2 + 2
    return out


@pytest.mark.parametrize("workers", [1, 2])
def test_disaggregated_greedy_tokens_match_jax(jax_greedy, workers):
    """Greedy tokens equal the JAX server's with the same workers; the
    census is the grid + handoff + decode; the handoff path ran; every
    page returned; the health keys are the JAX server's."""
    _, ts = _pair(prefill_workers=workers, **GREEDY)
    assert ts.census() == 2 + 2 and ts.graph_count() == 0   # the CPU
    outs, health = _run(ts, GREEDY_PROMPTS)
    for p, a, b in zip(GREEDY_PROMPTS, jax_greedy[workers], outs):
        assert b.dtype == np.int32 and len(b) == 6
        np.testing.assert_array_equal(b, a)
    st = ts.stats
    assert st["handoffs"] >= 1 and st["prefills"] >= 1
    assert st["completed"] == len(GREEDY_PROMPTS) and st["failed"] == 0
    assert ts.alloc.free_count() == ts.alloc.allocatable
    assert health["prefill_workers"] == workers
    assert health["prefill_inflight"] == 0
    assert ts.healthz()["prefill_inflight"] == 0


@pytest.fixture(scope="module")
def jax_sampled():
    """The JAX server's seeded-sampling tokens (one prefill worker), in
    a calm run and under a pool too small for both sequences."""
    out = {}
    for mode, geo in SAMPLED.items():
        js, _ = _pair(prefill_workers=1, **geo)
        out[mode] = _run(js, SAMPLED_PROMPTS, SAMPLED_KW)[0]
    return out


@pytest.mark.parametrize("mode", ["calm", "preempt"])
def test_disaggregated_seeded_sampling_matches_jax(jax_sampled, mode):
    """Seeded ``temperature > 0`` requests return the JAX server's
    tokens; under the small pool the port preempts and resumes through
    the prefill-KV path and still does."""
    _, ts = _pair(prefill_workers=1, **SAMPLED[mode])
    outs, _ = _run(ts, SAMPLED_PROMPTS, SAMPLED_KW)
    for a, b in zip(jax_sampled[mode], outs):
        assert len(b) == SAMPLED[mode]["max_new_tokens"]
        np.testing.assert_array_equal(b, a)
    st = ts.stats
    if mode == "preempt":
        assert st["preempted"] >= 1 and st["resumes"] >= 1
    assert st["handoffs"] >= 1
    assert ts.alloc.free_count() == ts.alloc.allocatable


# ------------------------------------------------------------ lifecycle --
def make_server(**kw):
    kw.setdefault("buckets", BucketSpec(batch=(1,), length=(8,)))
    kw.setdefault("n_slots", 2)
    kw.setdefault("n_pages", 33)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("prefill_workers", 1)
    return GenerationServer(TP, TCFG, device="cpu",
                            name=f"TorchDisLife-{time.monotonic_ns()}", **kw)


def test_drain_under_deep_backlog_resolves_everything():
    """``drain()`` right after a 24-deep backlog is submitted: the
    workers keep serving the groups the loop still dispatches (they
    stand down on the loop's exit, not on the drain), so every request
    is served and the drain ends."""
    srv = make_server(buckets=BucketSpec(batch=(1, 2), length=(8,)),
                      max_new_tokens=4, max_queue=64,
                      prefill_workers=2).start()
    reqs = [srv.submit(np.asarray([1 + (i % 7), 2], np.int32))
            for i in range(24)]
    assert srv.drain(60)
    assert not srv.alive()
    assert all(not t.is_alive() for t in srv._prefill_threads)
    assert all(r.done() for r in reqs)
    assert all(r.exception(0) is None for r in reqs)   # served, not swept
    assert srv.alloc.free_count() == srv.alloc.allocatable
    st = srv.stats
    assert st["admitted"] == st["completed"] + st["failed"] + st["expired"]
    assert st["completed"] == 24


def test_handoff_fault_fails_its_group_and_spares_the_bystander():
    """``fleet.handoff`` fires on the host before the scatter touches
    the pools: the staged group fails explicitly, a seated bystander
    completes with its full, correct tokens, and the server serves on."""
    srv = make_server(max_new_tokens=24).start()
    try:
        prompt = np.asarray([2, 7], np.int32)
        bystander = srv.submit(prompt)
        limit = time.monotonic() + 30          # until it is seated
        while srv.stats["handoffs"] < 1 and time.monotonic() < limit:
            time.sleep(0.002)
        assert srv.stats["handoffs"] == 1
        with tfault.inject("fleet.handoff", RuntimeError("wire lost")) as h:
            doomed = srv.submit(np.asarray([5], np.int32))
            with pytest.raises(RuntimeError, match="wire lost"):
                doomed.result(30)
        assert h.fired >= 1
        out = bystander.result(60)
        np.testing.assert_array_equal(out, oracle_greedy(prompt, 24))
        assert len(srv.submit(np.asarray([4], np.int32),
                              max_new_tokens=3).result(60)) == 3
        st = srv.stats
        assert st["failed"] == 1 and st["completed"] == 2
        assert srv.healthz()["last_error"]["type"] == "RuntimeError"
    finally:
        assert srv.drain(30)
    assert srv.alloc.free_count() == srv.alloc.allocatable


def test_prefill_fault_on_the_worker_fails_the_group_only():
    """``generate.prefill`` fires on the worker: its group fails
    explicitly and the next request is served."""
    srv = make_server().start()
    try:
        with tfault.inject("generate.prefill", RuntimeError("pf"),
                           times=1) as h:
            bad = srv.submit(np.asarray([1, 2], np.int32))
            with pytest.raises(RuntimeError, match="pf"):
                bad.result(timeout=60)
        assert h.fired == 1
        good = srv.submit(np.asarray([3], np.int32)).result(timeout=60)
        np.testing.assert_array_equal(
            good, oracle_greedy(np.asarray([3], np.int32), 6))
    finally:
        assert srv.drain(30)
    assert srv.alloc.free_count() == srv.alloc.allocatable


def test_decode_fault_salvages_through_the_prefill_kv_path():
    """A decode fault on a disaggregated server salvages the seated
    sequence; its resume re-prefills through the prefill workers and a
    second handoff, and completes greedy token-exact."""
    prompt = np.asarray([4, 1, 3], np.int32)
    srv = make_server(breaker=CircuitBreaker(threshold=4)).start()
    try:
        with tfault.inject("generate.decode", RuntimeError("injected"),
                           times=1) as h, \
                tfault.inject("generate.resume", RuntimeError("count"),
                              after_n=10 ** 9) as resumed:
            out = srv.submit(prompt).result(timeout=120)
        assert h.fired == 1 and resumed.calls >= 1   # on the worker
        np.testing.assert_array_equal(out, oracle_greedy(prompt, 6))
        st = srv.stats
        assert st["completed"] == 1 and st["resumes"] >= 1
        assert st["prefills"] >= 2 and st["handoffs"] >= 2
        assert srv.alloc.free_count() == srv.alloc.allocatable
    finally:
        assert srv.drain(30)


def test_drain_handoff_exports_the_pipeline_and_a_successor_resumes():
    """One slot and a long first sequence: the others are prefilled and
    wait in the handoff backlog.  ``drain(handoff=True)`` exports the
    seated one AND those still in the pipeline (their snapshots carry no
    tokens); a successor's ``submit_resume`` completes every one with
    the uninterrupted run's tokens."""
    prompts = [np.asarray([2, 7], np.int32), np.asarray([9, 1, 4], np.int32),
               np.asarray([5, 5, 8], np.int32)]
    a = make_server(n_slots=1, max_new_tokens=64, n_pages=65).start()
    reqs = [a.submit(p) for p in prompts]
    limit = time.monotonic() + 60
    while (a.stats["prefills"] < 3 or a.stats["tokens_out"] < 1) \
            and time.monotonic() < limit:
        time.sleep(0.001)
    assert a.drain(30, handoff=True)
    errs = [r.exception(timeout=5) for r in reqs]
    assert all(isinstance(e, ServerClosedError) for e in errs)
    assert a.stats["handoff_exports"] == 3 == len(a.exported)
    in_pipeline = [e for e in errs if not e.snapshot.out]
    assert len(in_pipeline) == 2 and a.stats["handoffs"] == 1
    for e in errs:
        assert e.tokens_generated == len(e.partial_tokens)
        assert e.snapshot.out == e.partial_tokens
    ref = make_server(n_slots=3, max_new_tokens=64, n_pages=65,
                      prefill_workers=0).start()
    try:
        want = {tuple(p): ref.submit(p).result(timeout=180)
                for p in prompts}
    finally:
        assert ref.drain(60)
    b = make_server(max_new_tokens=64, n_pages=65).start()
    try:
        got = [(tuple(s.prompt), b.submit_resume(s.to_json()))
               for s in a.exported]
        for p, r in got:
            np.testing.assert_array_equal(r.result(timeout=180), want[p])
    finally:
        assert b.drain(60)


def test_span_tree_carries_the_handoff_and_the_worker():
    """Every request's spans audit clean and include ``handoff``; the
    prefill span names the worker thread that ran it."""
    telemetry.enable(collect=True)
    srv = make_server(max_new_tokens=4)
    srv.start()
    try:
        reqs = [srv.submit(np.array([5, 6, 7], np.int32))
                for _ in range(4)]
        for r in reqs:
            r.result(60)
    finally:
        srv.drain()
    traces = telemetry.finished_traces()
    assert len(traces) == 4
    for tr in traces:
        assert telemetry.audit_spans(tr) == []
        assert {"admit", "queue", "prefill", "handoff", "decode"} \
            <= {sp.name for sp in tr.spans}
        pre = next(sp for sp in tr.spans if sp.name == "prefill")
        assert "prefill-w" in pre.attrs["worker"]
    pay = srv.telemetry()
    assert pay["counters"]["handoffs"] >= 1
    assert pay["gauges"]["prefill_workers"] == 1
    assert pay["gauges"]["prefill_inflight"] == 0
    assert pay["histograms"]["handoff_ms"]["count"] == 4


def test_workers_sharing_buckets_under_a_short_switch_interval():
    """Stress: more prefill workers than a bucket has users at a time,
    threads switched every microsecond, 40 requests over two length
    buckets — the workers share each bucket's step inputs and outputs
    (the per-bucket lock), so every request gets the fused server's
    tokens, every page returns and the counts balance."""
    rng = np.random.RandomState(13)
    prompts = [rng.randint(0, 48, size=int(rng.randint(1, 9)))
               .astype(np.int32) for _ in range(40)]
    kw = dict(buckets=BucketSpec(batch=(1, 2), length=(4, 8)), n_slots=4,
              n_pages=65, max_new_tokens=5, max_queue=64)
    want, _ = _run(make_server(prefill_workers=0, **kw), prompts)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        srv = make_server(prefill_workers=6, **kw)
        got, health = _run(srv, prompts)
    finally:
        sys.setswitchinterval(interval)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    st = srv.stats
    assert st["completed"] == 40 and st["handoffs"] >= 1
    assert st["admitted"] == st["completed"] + st["failed"] + st["expired"]
    assert srv.alloc.free_count() == srv.alloc.allocatable
    assert health["prefill_workers"] == 6
    assert all(not t.is_alive() for t in srv._prefill_threads)


def test_constructor_arguments_are_checked():
    with pytest.raises(ValueError, match="attention_impl"):
        make_server(attention_impl="flash")
    with pytest.raises(ValueError, match="needs the card"):
        make_server(attention_impl="pallas")
    with pytest.raises(ValueError, match="prefill_workers"):
        make_server(prefill_workers=-1)
    fused = make_server(prefill_workers=0, attention_impl="jnp")
    assert fused.census() == 1 + 1
    assert fused.healthz()["prefill_workers"] == 0
    assert make_server(prefill_workers=3).census() == 1 + 2


# ------------------------------------------------------------ on the card --
def _card_prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 48, size=int(rng.randint(1, 9))).astype(np.int32)
            for _ in range(12)]


@gpu
@pytest.mark.parametrize("warmup", [True, False])
def test_card_disaggregated_server_matches_cpu_server(warmup):
    """Two workers on the card, their graphs captured at ``start()`` or
    lazily by the workers while the decode loop runs: the CPU server's
    greedy tokens, at most one graph per census entry (the workers share
    a bucket's), the paged kernel launched by the decode graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    from mxnet_tpu_torch.ops.paged_attention import paged_decode_attention

    prompts = _card_prompts()
    outs = {}
    for dev in ("cpu", "cuda"):
        srv = GenerationServer(
            TP, TCFG, buckets=BucketSpec(batch=(1, 2), length=(4, 8)),
            n_slots=3, n_pages=33, page_size=4, max_new_tokens=6,
            prefill_workers=2, device=dev,
            name=f"TorchDisCard-{dev}-{time.monotonic_ns()}")
        srv.start(warmup=warmup if dev == "cuda" else True)
        if dev == "cuda":
            assert srv.graph_count() == (srv.census() if warmup else 0)
            before = paged_decode_attention.launches
        try:
            reqs = [srv.submit(p) for p in prompts]
            outs[dev] = [r.result(timeout=120) for r in reqs]
        finally:
            assert srv.drain(60)
        if dev == "cuda":
            assert paged_decode_attention.launches > before
            assert srv.graph_count() <= srv.census() == 4 + 2
            if warmup:
                assert srv.graph_count() == srv.census()
            assert srv.stats["handoffs"] >= 1
            assert srv.alloc.free_count() == srv.alloc.allocatable
    for a, b in zip(outs["cpu"], outs["cuda"]):
        np.testing.assert_array_equal(a, b)


@gpu
def test_card_concurrent_prefill_buckets_at_width_hold_the_argmax():
    """At a width where the products use cuBLAS's workspace (d_model
    512, a (4, 64) bucket), two workers replay prefill buckets on their
    streams while the decode graph replays on the loop's: every token is
    the argmax of the plain full forward over prompt + output so far (a
    shared workspace between two graphs replaying at once corrupts
    them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    cfg = tlm.CausalLMConfig(vocab_size=1024, n_layers=2, n_heads=8,
                             head_dim=64, d_ff=1024)
    params = tlm.init_causal_lm(cfg, torch.Generator().manual_seed(5),
                                device="cuda")
    rng = np.random.RandomState(29)
    prompts = [rng.randint(0, 1024, size=int(rng.randint(4, 64)))
               .astype(np.int32) for _ in range(96)]
    srv = GenerationServer(
        params, cfg, buckets=BucketSpec(batch=(1, 2, 4), length=(32, 64)),
        n_slots=16, n_pages=160, page_size=16, max_new_tokens=16,
        prefill_workers=2, device="cuda",
        name=f"TorchDisWide-{time.monotonic_ns()}")
    srv.start()
    try:
        assert srv.graph_count() == srv.census() == 6 + 2
        reqs = [srv.submit(p) for p in prompts]
        outs = [np.asarray(r.result(timeout=300)) for r in reqs]
        assert srv.graph_count() == srv.census()
    finally:
        assert srv.drain(60)
    assert srv.stats["handoffs"] >= 1
    assert srv.alloc.free_count() == srv.alloc.allocatable
    worst = 0.0
    for p, o in zip(prompts, outs):
        assert len(o) == 16
        full = np.concatenate([p, o]).astype(np.int32)
        with torch.no_grad():
            lg = tlm.sequence_logits(params, cfg,
                                     torch.from_numpy(full[None]).cuda())[0]
        rows = lg[len(p) - 1:len(full) - 1]
        chosen = rows.gather(1, torch.from_numpy(o.astype(np.int64))
                             .cuda()[:, None])[:, 0]
        worst = max(worst, float((rows.max(dim=1).values - chosen).max()))
    assert worst <= 1e-4, f"a served token trails the argmax by {worst}"
