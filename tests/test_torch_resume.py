"""Port parity: salvage, preemption storms, snapshots, the decode
journal and handoff drains of ``mxnet_tpu_torch.serving`` against the
JAX package, on the CPU.

- a failed decode (or verify) step salvages its seated sequences, which
  complete token-exact; past ``salvage_retries`` the error carries the
  partial tokens and a snapshot; a breaker fast-fail salvages without
  spending the budget; an injected storm leaves no refcount or prefix
  index entry behind (the JAX package's salvage tests);
- starved-pool preemption storms are token-exact, greedy and seeded
  sampling;
- ``SequenceSnapshot.to_json`` equals the JAX package's, the journal's
  records carry the JAX server's keys, and a journal written by either
  package's server is restored by the other's to the writer's tokens;
- ``drain(handoff=True)`` exports snapshots a successor resumes
  token-exact, through ``submit_resume`` and through the journal;
- the ``generate.resume`` / ``generate.salvage`` / ``generate.journal``
  fault points fire where the JAX server fires them.
"""
import gc
import json
import time

import numpy as np
import pytest

from mxnet_tpu.serving import BucketSpec as JBucketSpec
from mxnet_tpu.serving import GenerationServer as JGenerationServer
from mxnet_tpu.serving import generate as jgen
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch.serving import (BucketSpec, CircuitBreaker,
                                     GenerationServer, SequenceSnapshot,
                                     ServerClosedError)

from test_torch_generate import JCFG, JP, TCFG, TP
from test_torch_prefix_sharing import oracle_greedy


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_after_module():
    yield
    gc.collect()


def make_server(**kw):
    kw.setdefault("buckets", BucketSpec(batch=(1,), length=(8,)))
    kw.setdefault("n_slots", 2)
    kw.setdefault("n_pages", 33)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("seed", 0)
    return GenerationServer(TP, TCFG, device="cpu",
                            name=f"TorchResume-{time.monotonic_ns()}", **kw)


def make_jax_server(**kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("n_pages", 33)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("seed", 0)
    return JGenerationServer(JP, JCFG,
                             buckets=JBucketSpec(batch=(1,), length=(8,)),
                             attention_impl="jnp",
                             name=f"TorchResumeJ-{time.monotonic_ns()}",
                             **kw)


def storm_server(**kw):
    """A pool two worst-case sequences cannot share: the junior one is
    preempted mid-generation again and again."""
    kw.setdefault("n_pages", 5)              # 4 allocatable
    kw.setdefault("max_new_tokens", 10)
    return make_server(**kw)


# ----------------------------------------------------------------- salvage --
def test_decode_fault_salvages_inflight_token_exact():
    prompt = np.asarray([1, 2], np.int32)
    srv = make_server(breaker=CircuitBreaker(threshold=3)).start()
    try:
        with tfault.inject("generate.decode", RuntimeError("injected"),
                           times=1) as h:
            out = srv.submit(prompt).result(timeout=120)
        assert h.fired == 1
        np.testing.assert_array_equal(out, oracle_greedy(prompt, 6))
        st = srv.stats
        assert st["completed"] == 1 and st["failed"] == 0
        assert st["salvage_retries"] == 1
        assert st["tokens_salvaged"] >= 1 and st["resumes"] >= 1
        assert srv.alloc.free_count() == srv.alloc.allocatable
    finally:
        assert srv.drain(30)


def test_salvage_budget_exhausted_is_terminal_with_partials():
    prompt = np.asarray([1, 2], np.int32)
    srv = make_server(salvage_retries=0,
                      breaker=CircuitBreaker(threshold=3)).start()
    try:
        with tfault.inject("generate.decode", RuntimeError("injected"),
                           times=1) as h:
            err = srv.submit(prompt).exception(timeout=60)
        assert h.fired == 1
        assert err is not None and "salvage budget" in str(err)
        assert err.tokens_generated == len(err.partial_tokens) >= 1
        assert err.snapshot.out == err.partial_tokens
        assert list(err.snapshot.prompt) == [1, 2]
        st = srv.stats
        assert st["failed"] == 1 and st["completed"] == 0
        assert srv.alloc.free_count() == srv.alloc.allocatable
    finally:
        assert srv.drain(30)


def test_salvage_fault_point_resolves_with_partials():
    """``generate.salvage`` fires inside the salvage path; when it
    raises, the sequence resolves terminally with its partial tokens."""
    prompt = np.asarray([1, 2], np.int32)
    srv = make_server(breaker=CircuitBreaker(threshold=3)).start()
    try:
        with tfault.inject("generate.decode", RuntimeError("step"),
                           times=1), \
                tfault.inject("generate.salvage", RuntimeError("salv"),
                              times=1) as h:
            err = srv.submit(prompt).exception(timeout=60)
        assert h.fired == 1
        assert "salv" in str(err) and err.partial_tokens
        assert err.snapshot.out == err.partial_tokens
    finally:
        assert srv.drain(30)
    assert srv.alloc.free_count() == srv.alloc.allocatable


def test_breaker_fastfail_salvages_seated_unbudgeted():
    class _Gate:
        """Deny ``deny`` step gates once ``arm_at`` tokens are out, then
        defer to the real breaker again."""

        def __init__(self, inner, srv, arm_at, deny):
            self._inner, self._srv = inner, srv
            self._arm_at, self.deny = arm_at, deny

        def allow(self):
            if self.deny > 0 \
                    and self._srv.stats["tokens_out"] >= self._arm_at:
                self.deny -= 1
                return False
            return self._inner.allow()

        def __getattr__(self, name):
            return getattr(self._inner, name)

    prompt = np.asarray([3, 1, 2], np.int32)
    srv = make_server(max_new_tokens=10,
                      breaker=CircuitBreaker(threshold=3)).start()
    try:
        srv.breaker = _Gate(srv.breaker, srv, arm_at=2, deny=2)
        out = srv.submit(prompt).result(timeout=120)
        np.testing.assert_array_equal(out, oracle_greedy(prompt, 10))
        st = srv.stats
        assert st["completed"] == 1 and st["failed"] == 0
        assert st["resumes"] >= 1 and st["tokens_salvaged"] >= 1
        assert st["salvage_retries"] == 0    # fast-fail is unbudgeted
    finally:
        assert srv.drain(30)


def test_salvage_storm_allocator_and_prefix_index_invariants():
    base = [5, 9, 2, 6]
    prompts = [np.asarray(base + [i], np.int32) for i in range(4)]
    srv = storm_server(salvage_retries=8,
                       breaker=CircuitBreaker(threshold=6)).start()
    try:
        with tfault.inject("generate.decode", RuntimeError("injected"),
                           times=2) as h:
            reqs = [srv.submit(p) for p in prompts]
            outs = [r.result(timeout=240) for r in reqs]
        assert h.fired == 2
        st = srv.stats
        assert st["completed"] == 4 and st["failed"] == 0
        for p, o in zip(prompts, outs):
            np.testing.assert_array_equal(o, oracle_greedy(p, 10))
        assert srv.alloc.free_count() == srv.alloc.allocatable
        assert srv._indexed_by_page == {} and srv._children == {}
    finally:
        assert srv.drain(60)


def test_speculative_step_fault_salvages_token_exact():
    """The verify step shares the decode step's fault point and salvage:
    a failed verify step's sequences resume and complete with the
    plain greedy tokens."""
    from test_torch_speculative import DNP, TDCFG

    prompt = np.asarray([4, 1, 3], np.int32)
    srv = make_server(n_pages=33, draft=DNP, draft_config=TDCFG, spec_k=2,
                      max_new_tokens=8,
                      breaker=CircuitBreaker(threshold=3)).start()
    try:
        with tfault.inject("generate.decode", RuntimeError("injected"),
                           times=1) as h:
            out = srv.submit(prompt).result(timeout=120)
        assert h.fired == 1
        np.testing.assert_array_equal(out, oracle_greedy(prompt, 8))
        assert srv.stats["resumes"] >= 1 and srv.stats["failed"] == 0
    finally:
        assert srv.drain(30)


# ------------------------------------------------------------------ storms --
def test_preempt_storm_token_exact_greedy():
    prompts = [np.asarray([1, 2], np.int32), np.asarray([7, 3, 5], np.int32)]
    srv = storm_server().start()
    try:
        with tfault.inject("generate.resume", RuntimeError("count"),
                           after_n=10 ** 9) as h:     # count, never raise
            reqs = [srv.submit(p) for p in prompts]
            outs = [r.result(timeout=180) for r in reqs]
        for p, o in zip(prompts, outs):
            np.testing.assert_array_equal(o, oracle_greedy(p, 10))
        st = srv.stats
        assert st["completed"] == 2 and st["failed"] == 0
        assert st["preempted"] >= 1 and st["tokens_salvaged"] >= 1
        assert st["resumes"] >= 1 and h.calls >= 1
        assert st["salvage_retries"] == 0     # preemption is unbudgeted
        assert srv.alloc.free_count() == srv.alloc.allocatable
    finally:
        assert srv.drain(60)


def test_preempt_storm_token_exact_seeded_sampling():
    prompts = [np.asarray([1, 2], np.int32), np.asarray([7, 3, 5], np.int32)]
    seeds = [101, 202]
    ref = make_server(n_pages=33, max_new_tokens=10).start()
    try:
        expected = [ref.submit(p, temperature=0.8, top_k=4, seed=s)
                    .result(timeout=120) for p, s in zip(prompts, seeds)]
        assert ref.stats["preempted"] == 0
    finally:
        assert ref.drain(60)
    srv = storm_server().start()
    try:
        reqs = [srv.submit(p, temperature=0.8, top_k=4, seed=s)
                for p, s in zip(prompts, seeds)]
        outs = [r.result(timeout=180) for r in reqs]
        assert srv.stats["preempted"] >= 1 and srv.stats["resumes"] >= 1
        for o, e in zip(outs, expected):
            np.testing.assert_array_equal(o, e)
    finally:
        assert srv.drain(60)


# ---------------------------------------------------- snapshots + journals --
def test_snapshot_json_equals_jax():
    kw = dict(rid=7, prompt=np.asarray([1, 2, 3], np.int32), out=[4, 5],
              max_new=9, temperature=np.float32(0.7), top_k=5,
              seed=2 ** 32 - 1, priority=3, deadline_wall=1.5e9,
              tenant="t0", klass="gold")
    j, t = jgen.SequenceSnapshot(**kw), SequenceSnapshot(**kw)
    assert t.to_json() == j.to_json()
    assert json.dumps(t.to_json(), sort_keys=True) \
        == json.dumps(j.to_json(), sort_keys=True)
    back = SequenceSnapshot.from_json(json.loads(json.dumps(j.to_json())))
    assert back.to_json() == j.to_json() and repr(back) == repr(j)


def _records(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def test_journal_records_carry_the_jax_keys(tmp_path):
    """The same traffic journaled by both servers: the same record
    names in the same order, key for key (times aside)."""
    paths = []
    for make in (make_jax_server, make_server):
        path = str(tmp_path / f"{make.__name__}.jsonl")
        srv = make(journal=path, journal_every=1).start()
        try:
            srv.submit(np.asarray([1, 2, 6], np.int32)).result(60)
            srv.submit(np.asarray([8, 4], np.int32), temperature=0.9,
                       top_k=6, seed=77).result(60)
        finally:
            assert srv.drain(30)
        paths.append(path)
    jrec, trec = (_records(p) for p in paths)
    assert [r["name"] for r in trec] == [r["name"] for r in jrec]
    assert {"gen_admit", "gen_snapshot", "gen_retire"} \
        <= {r["name"] for r in trec}
    for a, b in zip(jrec, trec):
        assert sorted(a) == sorted(b)
        assert {k: v for k, v in a.items() if k not in ("ts", "mono")} \
            == {k: v for k, v in b.items() if k not in ("ts", "mono")}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_restores_across_packages(tmp_path, writer):
    """A server whose journal goes dark mid-flight (admits recorded,
    retires never): a fresh server of the OTHER package restores the
    journal and completes every sequence with the writer's tokens,
    greedy and seeded sampling."""
    jpath = str(tmp_path / "decode.jsonl")
    make_a, make_b = (make_jax_server, make_server) if writer == "jax" \
        else (make_server, make_jax_server)
    a = make_a(max_new_tokens=8, journal=jpath, journal_every=1).start()
    try:
        r1 = a.submit(np.asarray([1, 2, 6], np.int32))
        r2 = a.submit(np.asarray([8, 4], np.int32), temperature=0.9,
                      top_k=6, seed=77)
        a._journal = None     # the stop: nothing after this line lands
        expected = [np.asarray(r.result(timeout=120)) for r in (r1, r2)]
    finally:
        assert a.drain(30)
    b = make_b(max_new_tokens=8).start()
    try:
        restored = b.restore_journal(jpath)
        assert len(restored) == 2
        assert b.stats["journal_restores"] == 2
        got = sorted(tuple(int(t) for t in r.result(timeout=120))
                     for r in restored.values())
        assert got == sorted(tuple(int(t) for t in e) for e in expected)
        assert b.stats["completed"] == 2 and b.stats["failed"] == 0
    finally:
        assert b.drain(30)


def test_journal_restore_skips_torn_lines_and_reads_the_rotation(tmp_path):
    jpath = tmp_path / "decode.jsonl"
    snap = SequenceSnapshot(rid=3, prompt=[1, 2], out=[], max_new=4,
                            temperature=0.0, top_k=0, seed=5)
    rec = {"ts": 0.0, "mono": 0.0, "kind": "generate", "name": "gen_admit",
           **snap.to_json()}
    (tmp_path / "decode.jsonl.1").write_text(json.dumps(rec) + "\n")
    jpath.write_text(json.dumps({**rec, "rid": 4}) + "\n"
                     + json.dumps({"kind": "generate", "name": "gen_retire",
                                   "rid": 4}) + "\n" + '{"kind": "gen')
    b = make_server().start()
    try:
        restored = b.restore_journal(str(jpath))
        assert list(restored) == [3]
        np.testing.assert_array_equal(restored[3].result(60),
                                      oracle_greedy(np.asarray([1, 2]), 4))
    finally:
        assert b.drain(30)


def test_journal_write_failure_never_fails_serving(tmp_path):
    srv = make_server(journal=str(tmp_path / "j.jsonl")).start()
    try:
        with tfault.inject("generate.journal", OSError("disk full")) as h:
            out = srv.submit(np.asarray([1, 2], np.int32)).result(60)
        assert h.fired >= 2 and len(out) == 6
        assert srv.stats["journal_errors"] == h.fired
    finally:
        assert srv.drain(30)


def test_drain_handoff_exports_and_successor_resumes(tmp_path):
    """``drain(handoff=True)``: unfinished sequences export snapshots
    (``exported``, ``gen_handoff`` records, errors carrying them) and a
    successor completes them token-exact — through the journal, and
    through ``submit_resume`` of ``exported``."""
    jpath = str(tmp_path / "decode.jsonl")
    prompts = [np.asarray([2, 7], np.int32), np.asarray([9, 1, 4], np.int32),
               np.asarray([5, 5, 8], np.int32), np.asarray([1, 6], np.int32)]
    a = make_server(n_pages=65, max_new_tokens=24, journal=jpath,
                    journal_every=1).start()
    reqs = [a.submit(p) for p in prompts]
    limit = time.monotonic() + 60
    while a.stats["tokens_out"] < 1 and time.monotonic() < limit:
        time.sleep(0.001)
    assert a.drain(30, handoff=True)
    errs = [r.exception(timeout=5) for r in reqs]
    exported = [e for e in errs if e is not None]
    assert len(exported) >= 1
    for e in exported:
        assert isinstance(e, ServerClosedError)
        assert e.tokens_generated == len(e.partial_tokens)
        assert e.snapshot.out == e.partial_tokens
    assert a.stats["handoff_exports"] == len(exported) == len(a.exported)
    # the uninterrupted run's tokens
    ref = make_server(n_pages=65, max_new_tokens=24).start()
    try:
        want = sorted(tuple(int(t) for t in ref.submit(
            np.asarray(e.snapshot.prompt, np.int32)).result(timeout=180))
            for e in exported)
    finally:
        assert ref.drain(60)

    b = make_server(n_pages=65, max_new_tokens=24).start()
    try:
        restored = b.restore_journal(jpath)
        assert len(restored) == len(exported)
        got = sorted(tuple(int(t) for t in r.result(timeout=180))
                     for r in restored.values())
        assert got == want
    finally:
        assert b.drain(60)
    c = make_server(n_pages=65, max_new_tokens=24).start()
    try:
        reqs = [c.submit_resume(s.to_json()) for s in a.exported]
        got = sorted(tuple(int(t) for t in r.result(timeout=180))
                     for r in reqs)
        assert got == want
        assert c.stats["resumes"] >= sum(1 for s in a.exported if s.out)
    finally:
        assert c.drain(60)


def test_submit_resume_of_a_finished_snapshot_resolves_at_once():
    srv = make_server().start()
    try:
        r = srv.submit_resume(SequenceSnapshot(
            rid=0, prompt=[1], out=[3, 4, 5], max_new=3, temperature=0.0,
            top_k=0, seed=1))
        assert r.done() and r.result(0).tolist() == [3, 4, 5]
        assert srv.stats["completed"] == 1
    finally:
        assert srv.drain(30)
