"""Port parity: prefix sharing with copy-on-write in
``mxnet_tpu_torch.serving`` against the JAX package, on the CPU.

- ``prefix_admission_plan`` and the allocator's sharing gauges
  (``extra_refs``) equal the JAX package's;
- under shared-prefix traffic — a resident system prompt, prompts that
  end inside its last block (a superset match that takes a CoW fault at
  its first decode write) and prompts that share its first blocks plus
  a tail — the port's tokens and the stats ``cow_faults``,
  ``pages_shared_mapped`` and ``pages_charged`` equal the JAX
  server's, admission gated so both see the same groups;
- the JAX package's sharer tests: a superset sharer decodes exactly, a
  donor retiring early never frees a page a sharer holds, preempting a
  sharer recovers exactly, and after drain every refcount is zero and
  the prefix index is empty;
- ``python -m mxnet_tpu_torch.bench llm --prefix`` at a small size.
"""
import contextlib
import gc
import io
import json
import threading
import time

import numpy as np
import pytest
import jax.numpy as jnp

from mxnet_tpu.serving import BucketSpec as JBucketSpec
from mxnet_tpu.serving import GenerationServer as JGenerationServer
from mxnet_tpu.serving import generate as jgen
from mxnet_tpu_torch import bench as tbench
from mxnet_tpu_torch.gluon.model_zoo import causal_lm as tlm
from mxnet_tpu_torch.serving import (BucketSpec, GenerationServer,
                                     PageAllocator, prefix_admission_plan)
from mxnet_tpu_torch.serving import generate as tgen

from test_torch_generate import JCFG, JP, TCFG, TP, _t, assert_gap


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    yield
    gc.collect()


def oracle_greedy(prompt, steps):
    """The reference continuation: the full forward over prompt + output
    so far for every token, each decision's top-2 gap asserted."""
    seq = [int(t) for t in prompt]
    for _ in range(steps):
        lg = tlm.sequence_logits(TP, TCFG, _t(np.asarray([seq], np.int32)))
        row = lg[0, -1].numpy()
        assert_gap(row[None])
        seq.append(int(row.argmax()))
    return np.asarray(seq[len(prompt):], np.int32)


def make_server(**kw):
    kw.setdefault("buckets", BucketSpec(batch=(1, 2), length=(8,)))
    kw.setdefault("n_slots", 4)
    kw.setdefault("n_pages", 33)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_new_tokens", 6)
    return GenerationServer(TP, TCFG, device="cpu",
                            name=f"TorchShare-{time.monotonic_ns()}", **kw)


def gate_admission(srv):
    """Hold the decode loop's admission until the returned event is set,
    so every request is queued first and the groups do not depend on
    thread timing."""
    gate = threading.Event()
    admit = srv._admit
    srv._admit = lambda: gate.is_set() and admit()
    return gate


# ------------------------------------------------------------- arithmetic --
@pytest.mark.parametrize("args", [(129, 16, 192, 64, 176),
                                  (129, 16, 192, 64, 0),
                                  (129, 16, 32, 64, 10_000),
                                  (513, 64, 160, 64, 144),
                                  (5, 4, 8, 40, 8)])
def test_prefix_admission_plan_equals_jax(args):
    assert prefix_admission_plan(*args) == jgen.prefix_admission_plan(*args)


def test_prefix_admission_plan_math():
    plan = prefix_admission_plan(129, 16, 192, 64, 176)
    assert plan["pages_per_seq"] == 16 and plan["shared_pages"] == 11
    assert plan["charged_pages"] == 5
    assert plan["admissible_unshared"] == 8
    assert plan["admissible_shared"] == 23


def test_allocator_sharing_gauges_match_jax():
    ja, ta = jgen.PageAllocator(9, 4), PageAllocator(9, 4)
    for a in (ja, ta):
        pages = a.alloc(2)
        a.share(pages)
        a.share(pages[:1])
    assert ta.extra_refs() == ja.extra_refs() == 3
    assert ta.shared_pages() == ja.shared_pages() == 2
    for a in (ja, ta):
        assert a.free(pages) == []
        assert a.free(pages[:1]) == []
    assert ta.extra_refs() == ja.extra_refs() == 0
    assert sorted(ta.free(pages)) == sorted(ja.free(pages))
    assert ta.live_pages() == ja.live_pages() == 0


# ---------------------------------------------------------- against JAX --
SYSTEM = np.random.RandomState(21).randint(0, 48, size=12).astype(np.int32)


def _shared_traffic():
    """Request 0 is the system prompt (three full blocks resident); every
    third ends inside its last block (a superset match, CoW at the first
    decode write); the rest share its first two blocks plus a tail."""
    rng = np.random.RandomState(22)
    prompts = [SYSTEM.copy()]
    for i in range(1, 10):
        if i % 3 == 0:
            prompts.append(SYSTEM[:int(rng.randint(9, 12))].copy())
        else:
            tail = rng.randint(0, 48, size=int(rng.randint(1, 5)))
            prompts.append(np.concatenate([SYSTEM[:8], tail]).astype(
                np.int32))
    return prompts


def test_shared_prefix_traffic_matches_jax_tokens_and_stats():
    prompts = _shared_traffic()
    kw = dict(n_slots=4, n_pages=33, page_size=4, max_new_tokens=6, seed=0)
    buckets = dict(batch=(1, 2), length=(16,))
    name = f"TorchShareJ-{time.monotonic_ns()}"
    servers = [JGenerationServer(JP, JCFG, buckets=JBucketSpec(**buckets),
                                 attention_impl="jnp", name=name + "-jax",
                                 **kw),
               GenerationServer(TP, TCFG, buckets=BucketSpec(**buckets),
                                device="cpu", name=name + "-torch", **kw)]
    outs, stats = [], []
    for srv in servers:
        srv.start()
        gate = gate_admission(srv)
        try:
            reqs = [srv.submit(p) for p in prompts]
            gate.set()
            outs.append([r.result(timeout=120) for r in reqs])
        finally:
            assert srv.drain(60)
        stats.append(srv.stats)
        assert srv.alloc.free_count() == srv.alloc.allocatable
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)
    js, ts = stats
    for key in ("cow_faults", "pages_shared_mapped", "pages_charged",
                "prefills", "decode_steps", "completed"):
        assert ts[key] == js[key], (key, ts[key], js[key])
    assert ts["cow_faults"] >= 1 and ts["pages_shared_mapped"] > 0
    unshared = sum(-(-len(p) // 4) for p in prompts)
    assert ts["pages_charged"] < unshared + ts["cow_faults"] \
        + len(prompts) * 2
    for p, o in zip(prompts[:4], outs[1][:4]):
        np.testing.assert_array_equal(o, oracle_greedy(p, 6))


# ------------------------------------------------- the JAX sharer tests --
def test_prefix_sharing_cow_exactness_and_drain_invariants():
    """A sharer mapped onto a donor's resident pages (one of them a
    superset partial-block match, so its first divergent write takes a
    CoW fault) decodes as the unshared oracle; after drain every
    refcount is back to zero and the prefix index is empty."""
    donor = ((np.arange(8, dtype=np.int32) * 5) + 1) % 48
    sharer = donor[:6].copy()                  # 1 full block + superset tail
    srv = make_server().start()
    try:
        r1 = srv.submit(donor)                 # one prefill group of two:
        r2 = srv.submit(sharer)                # sharing is map-time
        np.testing.assert_array_equal(r1.result(timeout=60),
                                      oracle_greedy(donor, 6))
        np.testing.assert_array_equal(r2.result(timeout=60),
                                      oracle_greedy(sharer, 6))
        st = srv.stats
        assert st["pages_shared_mapped"] >= 2  # full + superset block
        assert st["cow_faults"] >= 1
        g = srv.telemetry()["gauges"]
        assert g["pages_cow_faults"] >= 1
        assert "bytes_saved_by_sharing" in g and "pages_shared" in g
    finally:
        assert srv.drain(30)
    assert srv.alloc.free_count() == srv.alloc.allocatable
    assert srv.alloc.live_pages() == 0 and srv.alloc.shared_pages() == 0
    assert srv._indexed_by_page == {} and srv._children == {}


def test_sharer_retire_never_frees_referenced_pages():
    """A donor retiring early only drops its own hold: the sharer keeps
    decoding through the shared pages while a later sequence churns the
    free list (a wrongly freed page would be rewritten under it)."""
    donor = ((np.arange(8, dtype=np.int32) * 7) + 2) % 48
    clobber = ((np.arange(8, dtype=np.int32) * 11) + 5) % 48
    srv = make_server(n_pages=17).start()
    try:
        r1 = srv.submit(donor, max_new_tokens=2)   # retires first
        r2 = srv.submit(donor, max_new_tokens=6)   # full-prompt sharer
        o1 = r1.result(timeout=60)
        r3 = srv.submit(clobber, max_new_tokens=4)
        np.testing.assert_array_equal(o1, oracle_greedy(donor, 2))
        np.testing.assert_array_equal(r2.result(timeout=60),
                                      oracle_greedy(donor, 6))
        np.testing.assert_array_equal(r3.result(timeout=60),
                                      oracle_greedy(clobber, 4))
        assert srv.stats["pages_shared_mapped"] >= 2
    finally:
        assert srv.drain(30)
    assert srv.alloc.free_count() == srv.alloc.allocatable


def test_sharer_preemption_with_shared_pages_recovers_exactly():
    """Two sequences share one prompt page; each fits the pool alone
    but not together, so the younger is evicted and restarted: both
    streams match the oracle, nothing leaks."""
    prompt = np.asarray([1, 2, 3, 4], np.int32)      # exactly one block
    srv = make_server(buckets=BucketSpec(batch=(1,), length=(4,)),
                      n_slots=2, n_pages=8, max_new_tokens=24).start()
    try:
        r1 = srv.submit(prompt, max_new_tokens=24)
        r2 = srv.submit(prompt, max_new_tokens=24)
        want = oracle_greedy(prompt, 24)
        np.testing.assert_array_equal(r1.result(timeout=120), want)
        np.testing.assert_array_equal(r2.result(timeout=120), want)
        st = srv.stats
        assert st["preempted"] >= 1 and st["pages_shared_mapped"] >= 1
    finally:
        assert srv.drain(60)
    assert srv.alloc.free_count() == srv.alloc.allocatable
    assert srv.alloc.live_pages() == 0


def test_prefill_writes_sink_on_shared_blocks():
    """A sharer's prefill writes through a table row whose shared blocks
    are page 0, so resident shared pages keep their bytes; its decode
    table holds the real pages."""
    srv = make_server()
    seq = tgen._Seq(None, np.arange(10, dtype=np.int32), 4, 0.0, 0)
    seq.pages, seq.shared_n = [5, 6, 9], 2
    row = srv._scatter_table_row(seq)
    assert row.tolist()[:4] == [0, 0, 9, 0]
    assert row.shape == (srv.pages_per_seq,)


def test_census_with_speculative_and_shared_traffic():
    """A speculative server over shared-prefix and ragged traffic,
    greedy and sampled rows: census is the grid + decode + verify, and
    the shared pages are mapped."""
    from test_torch_speculative import DNP, TDCFG

    srv = make_server(buckets=BucketSpec(batch=(1, 2), length=(8, 16)),
                      n_pages=65, draft=DNP, draft_config=TDCFG, spec_k=2,
                      max_new_tokens=4)
    assert srv.census() == 2 * 2 + 1 + 1
    srv.start()
    try:
        rng = np.random.RandomState(0)
        system = rng.randint(0, 48, size=8).astype(np.int32)
        reqs = []
        for i in range(10):
            if i % 2:
                tail = rng.randint(0, 48, size=1 + (i % 3)).astype(np.int32)
                p = np.concatenate([system, tail])
            else:
                p = rng.randint(0, 48, size=int(rng.randint(1, 15))) \
                    .astype(np.int32)
            reqs.append(srv.submit(p, temperature=float(i % 2),
                                   top_k=int(4 * (i % 2))))
        for r in reqs:
            assert len(r.result(timeout=120)) == 4
        st = srv.stats
        assert st["pages_shared_mapped"] >= 2 and st["verify_steps"] > 0
    finally:
        assert srv.drain(60)
    assert srv.alloc.free_count() == srv.alloc.allocatable


# ------------------------------------------------------------------ bench --
def test_port_bench_prefix_traffic_line():
    cfg = tlm.CausalLMConfig(vocab_size=48, n_layers=2, n_heads=2,
                             head_dim=8, d_ff=32)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tbench.main(["llm", "--device", "cpu", "--prefix"],
                         config=cfg, n_requests=8)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["sequences"] == 8 and line["value"] > 0
    assert line["prefix_shared_frac"] == 0.9
    assert line["pages_shared_mapped"] > 0
    assert line["cow_faults"] >= 0
    # 16-token pages of 2 x 2 layers x 2 heads x 8 f32: the unshared
    # worst case is 3 pages a sequence (40 + 8 tokens)
    page_bytes = 2 * 2 * 16 * 2 * 8 * 4
    assert 0 < line["page_bytes_per_seq"] < 3 * page_bytes
