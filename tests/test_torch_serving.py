"""Classifier serving of the port (``mxnet_tpu_torch.serving``:
``InferenceServer``, ``DynamicBatcher``, ``module_apply``) on the CPU.

- The cases of ``tests/test_serving.py`` rewritten against the port:
  admission and shedding, deadlines, bucket-bounded graphs, the circuit
  breaker, the all-finite row guard, drain, health, the fault points,
  ``module_apply``, the ``Module.predict``/``score`` interrupt hygiene
  and the QoS classes.  A torch doubler that counts its distinct input
  signatures (its ``_cache_size``, what a captured function's graph
  count is on the card) stands in for the jitted one, and the bucket
  grid's census is ``len(batch) * len(length or (None,))``.
- Parity with the JAX package on the same inputs: one deterministic
  client through both packages' servers over a numpy doubler gives the
  same results, ``stats`` and ``healthz()`` keys; ``module_apply`` over
  the same bound module (parameters copied by name) agrees at 1e-5;
  a server over the port's ``EvalStep`` of a small fused ResNet agrees
  with the JAX ``EvalStep`` of the same net.
- The executor behind ``module_apply`` keeps one array per fed
  signature: serving a bucket grid rebinds nothing.
- A bfloat16 output comes back as float32 rows (numpy has no bfloat16).

The ``gpu``-marked cases skip without a card; on the card they assert
that the graphs equal the census under grid traffic.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

try:
    import mxnet_tpu as jmx
except ImportError:          # the card's machine has no JAX
    jmx = None
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import fault, profiler, serving
from mxnet_tpu_torch.serving import (BucketSpec, CircuitBreaker,
                                     CircuitOpenError, DeadlineExceededError,
                                     InferenceServer, NonFiniteOutputError,
                                     QoSClass, RejectedError,
                                     ServerClosedError, TenantQoS,
                                     TenantThrottledError, TokenBucket)

pytestmark = pytest.mark.serving
chaos = pytest.mark.chaos
slo = pytest.mark.slo


gpu = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _fresh_scopes():
    if jmx is None:
        with mx.name.NameManager():
            yield
        return
    with jmx.name.NameManager(), mx.name.NameManager(), mx.cpu():
        yield


def make_apply(delay=0.0, feature=3):
    """A torch doubler that records one entry per new input signature
    (what a captured function captures a graph for); ``_cache_size``
    counts them."""
    traces = []

    def f(x):
        if (x.shape, str(x.dtype)) not in f.seen:
            f.seen.append((x.shape, str(x.dtype)))
            traces.append(x.shape)
        return torch.from_numpy(np.asarray(x)) * 2.0

    f.seen = []
    f._cache_size = lambda: len(f.seen)

    def apply(x):
        if delay:
            time.sleep(delay)
        return f(x)

    apply.traces = traces
    apply.jitted = f
    return apply


def executable_census(spec):
    """Graphs the bucket grid allows: one per (batch, length) bucket."""
    return len(spec.batch) * len(spec.length or (None,))


def grid_signatures(spec):
    return [(b, L) for b in spec.batch for L in (spec.length or (None,))]


def make_server(delay=0.0, buckets=(1, 2, 4), warm=True, **kw):
    apply = make_apply(delay)
    kw.setdefault("max_delay", 0.002)
    if warm:
        kw.setdefault("sample", np.zeros((3,), np.float32))
    srv = InferenceServer(apply, buckets=buckets, **kw)
    srv.apply_fn = apply
    srv.start(warmup=warm)
    return srv


def _ex(v, n=3):
    return np.full((n,), float(v), np.float32)


# --------------------------------------------------------------- roundtrip --
def test_submit_roundtrip():
    srv = make_server()
    try:
        out = srv(_ex(5))
        np.testing.assert_allclose(out, np.full((3,), 10.0))
        req = srv.submit(_ex(1))
        np.testing.assert_allclose(req.result(5), np.full((3,), 2.0))
        assert req.done() and req.exception(0) is None
    finally:
        srv.drain()


def test_burst_coalesces_into_batches_with_correct_routing():
    srv = make_server(delay=0.005)
    try:
        reqs = [srv.submit(_ex(i)) for i in range(12)]
        for i, r in enumerate(reqs):
            np.testing.assert_allclose(r.result(10), np.full((3,), 2.0 * i))
        st = srv.stats
        assert st["completed"] == 12
        assert st["batches"] < 12          # coalescing actually happened
    finally:
        srv.drain()


def test_multi_leaf_payloads_and_tuple_outputs():
    def apply(x, y):
        return np.asarray(x) + 1.0, np.asarray(y) * 3.0

    srv = InferenceServer(apply, buckets=(1, 2), max_delay=0.001,
                          guard_nonfinite=True)
    srv.start(warmup=False)
    try:
        a, b = srv((_ex(1), _ex(2, n=5)))
        np.testing.assert_allclose(a, np.full((3,), 2.0))
        np.testing.assert_allclose(b, np.full((5,), 6.0))
    finally:
        srv.drain()


def test_list_outputs_route_per_request():
    """A LIST of output heads must split per request exactly like a
    tuple — especially when n_heads happens to equal the batch bucket,
    where mis-stacking would silently hand each request a whole head."""
    def apply(x):
        return [np.asarray(x) * 2.0, np.asarray(x) * 3.0]   # 2 heads

    srv = InferenceServer(apply, buckets=(2,), max_delay=0.01)
    srv.start(warmup=False)
    try:
        r1, r2 = srv.submit(_ex(1)), srv.submit(_ex(5))
        a1, b1 = r1.result(10)
        a2, b2 = r2.result(10)
        np.testing.assert_allclose(a1, np.full((3,), 2.0))
        np.testing.assert_allclose(b1, np.full((3,), 3.0))
        np.testing.assert_allclose(a2, np.full((3,), 10.0))
        np.testing.assert_allclose(b2, np.full((3,), 15.0))
    finally:
        srv.drain()


# --------------------------------------------------------------- admission --
def test_queue_full_sheds_and_accepted_complete():
    srv = make_server(delay=0.05, buckets=(1,), max_queue=2)
    try:
        accepted, shed = [], 0
        for i in range(12):
            try:
                accepted.append(srv.submit(_ex(i)))
            except ServerClosedError:
                raise
            except RejectedError:
                shed += 1
        assert shed > 0                       # bounded queue actually shed
        for r in accepted:                    # every accepted one resolves
            r.result(20)
        st = srv.stats
        assert st["shed"] == shed
        assert st["completed"] == len(accepted)
        assert profiler.counter_value("InferenceServer::shed") is not None
    finally:
        srv.drain()


def test_rate_limiter_sheds():
    srv = make_server(rate=0.001, burst=1)
    try:
        srv.submit(_ex(0)).result(5)          # consumes the only token
        with pytest.raises(RejectedError, match="rate limit"):
            srv.submit(_ex(1))
        assert srv.stats["shed"] == 1
    finally:
        srv.drain()


def test_token_bucket_refills():
    tb = TokenBucket(rate=1000.0, burst=1)
    assert tb.try_acquire()
    assert not tb.try_acquire()
    time.sleep(0.01)
    assert tb.try_acquire()


def test_submit_before_start_rejected():
    srv = InferenceServer(make_apply(), buckets=(1,))
    with pytest.raises(RejectedError, match="not started"):
        srv.submit(_ex(0))


def test_oversize_length_rejected_at_admission():
    spec = BucketSpec(batch=(2,), length=(4, 8))
    srv = InferenceServer(make_apply(), buckets=spec, max_delay=0.001)
    srv.start(warmup=False)
    try:
        with pytest.raises(RejectedError, match="largest length bucket"):
            srv.submit(np.zeros((9, 2), np.float32))
        assert srv.stats["rejected"] == 1
    finally:
        srv.drain()


# --------------------------------------------------------------- deadlines --
def test_deadline_expires_in_queue_without_device_work():
    srv = make_server(delay=0.15, buckets=(1,), max_delay=0.0)
    try:
        first = srv.submit(_ex(0))            # occupies the batch thread
        doomed = srv.submit(_ex(1), deadline=0.01)
        first.result(10)
        with pytest.raises(DeadlineExceededError, match="never touched"):
            doomed.result(10)
        st = srv.stats
        assert st["expired"] == 1
        # the expired request consumed NO device work: every dispatched
        # batch belongs to a non-expired request
        assert st["batches"] == st["completed"]
    finally:
        srv.drain()


def test_default_deadline_applies():
    srv = make_server(delay=0.1, buckets=(1,), max_delay=0.0,
                      default_deadline=0.01)
    try:
        first = srv.submit(_ex(0))
        doomed = srv.submit(_ex(1))           # inherits default deadline
        with pytest.raises(DeadlineExceededError):
            doomed.result(10)
        first.result(10)
    finally:
        srv.drain()


# ----------------------------------------------------- bounded recompiles --
def test_three_bucket_load_compiles_at_most_three_executables():
    """The acceptance load test: ragged traffic over a 3-bucket
    grid compiles at most 3 distinct executables — read via the jit
    cache AND the trace-count compile counter."""
    srv = make_server(delay=0.001, buckets=(2, 4, 8))
    apply = srv.apply_fn
    try:
        rng = np.random.RandomState(0)
        reqs = []
        for i in range(60):
            reqs.append(srv.submit(_ex(i)))
            if rng.rand() < 0.3:              # ragged arrival pattern
                time.sleep(0.003)
        for r in reqs:
            r.result(20)
        assert len(set(apply.traces)) <= 3
        assert apply.jitted._cache_size() <= 3
        assert len(srv.distinct_shapes) <= 3
        assert srv.stats["completed"] == 60
        # the static executable census bounds the same number from the
        # BucketSpec alone — no traffic needed to know the ceiling
        assert executable_census(srv.buckets) == 3
        assert len(set(apply.traces)) <= executable_census(srv.buckets)
    finally:
        srv.drain()


def test_executable_census_equals_runtime_jit_count():
    """The STATIC census over the bucket grid equals
    the RUNTIME jit-compile count once warmup + full-grid traffic has
    touched every signature — 'traffic can never trigger a recompile'
    as an equality, not a comment, read through the same trace-counter
    the load test above trusts."""
    apply = make_apply()
    spec = BucketSpec(batch=(1, 2), length=(4, 8))
    census = executable_census(spec)
    assert census == 4 == len(grid_signatures(spec))
    srv = InferenceServer(apply, buckets=spec, max_delay=0.001,
                          sample=np.zeros((3, 2), np.float32))
    srv.start()      # warmup compiles the whole grid
    try:
        assert len(set(apply.traces)) == census
        assert apply.jitted._cache_size() == census
        # drive real traffic across every length bucket: count must not
        # move — the census is the ceiling AND the warmup floor
        for n in (1, 3, 4, 5, 8):
            srv(np.zeros((n, 2), np.float32))
        assert len(set(apply.traces)) == census
        assert apply.jitted._cache_size() == census
    finally:
        srv.drain()


def test_length_buckets_pad_to_grid():
    seen = []

    def apply(x):
        seen.append(x.shape)
        return np.asarray(x, np.float32).sum(axis=(1, 2), keepdims=False) \
            .reshape(x.shape[0], 1)

    spec = BucketSpec(batch=(2,), length=(4, 8))
    srv = InferenceServer(apply, buckets=spec, max_delay=0.001,
                          guard_nonfinite=False)
    srv.start(warmup=False)
    try:
        srv(np.ones((3, 2), np.float32))      # pads to length 4
        srv(np.ones((5, 2), np.float32))      # pads to length 8
        assert set(seen) == {(2, 4, 2), (2, 8, 2)}
    finally:
        srv.drain()


def test_signature_pinning_rejects_foreign_payloads_without_recompile():
    """A stray client payload (wrong width, float64 from a Python list)
    must be REFUSED at admission, not compiled: one bad client must not
    stall the device for everyone (the recompile is the availability
    killer the whole subsystem exists to prevent)."""
    srv = make_server()
    apply = srv.apply_fn
    try:
        srv(_ex(1))
        before = len(set(apply.traces))
        with pytest.raises(RejectedError, match="recompile"):
            srv.submit(np.zeros((4,), np.float32))        # wrong width
        with pytest.raises(RejectedError, match="float64"):
            srv.submit(np.zeros((3,), np.float64))        # un-cast doubles
        with pytest.raises(RejectedError, match="leaves"):
            srv.submit([0.0, 0.0, 0.0])   # a list is a MULTI-LEAF payload
        assert len(set(apply.traces)) == before           # no new compiles
        assert srv.stats["rejected"] == 3
        srv(_ex(2))                                       # still serving
    finally:
        srv.drain()


def test_pin_signature_false_allows_heterogeneous_payloads():
    srv = make_server(warm=False, pin_signature=False)
    try:
        np.testing.assert_allclose(srv(_ex(1)), np.full((3,), 2.0))
        np.testing.assert_allclose(srv(_ex(1, n=5)),
                                   np.full((5,), 2.0))    # new sig allowed
    finally:
        srv.drain()


def test_warmup_covers_the_whole_length_grid():
    """With length buckets, warmup must compile batch × length — not just
    the sample's own bucket — so no live request ever compiles."""
    apply = make_apply()
    spec = BucketSpec(batch=(1, 2), length=(4, 8))
    srv = InferenceServer(apply, buckets=spec, max_delay=0.001,
                          sample=np.zeros((3, 2), np.float32))
    srv.start()
    try:
        assert set(apply.traces) == {(1, 4, 2), (2, 4, 2),
                                     (1, 8, 2), (2, 8, 2)}
        srv(np.zeros((7, 2), np.float32))     # length-8 bucket, batch 1
        assert len(set(apply.traces)) == 4    # ...was already warm
    finally:
        srv.drain()


def test_warmup_precompiles_every_bucket_before_ready():
    apply = make_apply()
    srv = InferenceServer(apply, buckets=(1, 2, 4),
                          sample=np.zeros((3,), np.float32))
    assert not srv.ready()
    srv.start()
    try:
        assert srv.ready()
        assert len(set(apply.traces)) == 3    # all compiles happened in start
        srv(_ex(1))
        assert len(set(apply.traces)) == 3    # traffic added none
    finally:
        srv.drain()


# ----------------------------------------------------------------- breaker --
def _tripped_server(**kw):
    kw.setdefault("breaker", CircuitBreaker(threshold=2, base_delay=0.05,
                                            max_delay=0.05, jitter=0.0))
    return make_server(**kw)


@chaos
def test_breaker_trips_fast_fails_and_recovers_via_traffic():
    srv = _tripped_server(warm=False, buckets=(1,))
    try:
        with fault.inject("serving.step", RuntimeError("wedged"), times=2):
            for i in range(2):
                with pytest.raises(RuntimeError, match="wedged"):
                    srv(_ex(i))
        assert srv.breaker.state == "open" and srv.breaker.trips == 1
        assert not srv.ready()                 # readiness reflects the trip
        with pytest.raises(CircuitOpenError):  # degraded mode fast-fails
            srv.submit(_ex(9))
        assert srv.stats["rejected"] >= 1
        time.sleep(0.08)                       # backoff elapses (no sample,
        out = srv(_ex(5))                      # so traffic IS the probe)
        np.testing.assert_allclose(out, np.full((3,), 10.0))
        assert srv.breaker.state == "closed"
        assert srv.ready()
    finally:
        srv.drain()


@chaos
def test_breaker_idle_probe_recovers_without_traffic():
    srv = _tripped_server()                    # warm => sample available
    try:
        with fault.inject("serving.step", RuntimeError("wedged"), times=2):
            for i in range(2):
                with pytest.raises(RuntimeError):
                    srv(_ex(i))
        assert srv.breaker.state == "open"
        t0 = time.time()
        while srv.breaker.state != "closed" and time.time() - t0 < 3:
            time.sleep(0.01)
        assert srv.breaker.state == "closed"   # probe closed it, no traffic
        assert srv.stats["probes"] >= 1
        assert profiler.counter_value("InferenceServer::breaker_state") == 0
    finally:
        srv.drain()


@chaos
def test_breaker_failed_probe_reopens_with_backoff():
    srv = _tripped_server(warm=False, buckets=(1,))
    try:
        with fault.inject("serving.step", RuntimeError("still down"),
                          times=3):
            for i in range(2):
                with pytest.raises(RuntimeError):
                    srv(_ex(i))
            time.sleep(0.08)
            with pytest.raises(RuntimeError):  # half-open probe fails too
                srv(_ex(2))
        assert srv.breaker.state == "open" and srv.breaker.trips == 2
        time.sleep(0.15)                       # doubled backoff elapses
        srv(_ex(3))                            # injection exhausted: heals
        assert srv.breaker.state == "closed"
    finally:
        srv.drain()


def test_isolated_failure_below_threshold_does_not_trip():
    srv = make_server(warm=False, buckets=(1,),
                      breaker=CircuitBreaker(threshold=3))
    try:
        with fault.inject("serving.step", RuntimeError("blip"), times=1):
            with pytest.raises(RuntimeError):
                srv(_ex(0))
        srv(_ex(1))                            # next batch serves fine
        assert srv.breaker.state == "closed" and srv.breaker.trips == 0
    finally:
        srv.drain()


def test_malformed_output_trips_breaker():
    """An apply fn returning non-batch-major output serves NOBODY — the
    breaker must see that as step failure, or a 100%-erroring replica
    keeps reporting ready=True to its load balancer."""
    srv = InferenceServer(lambda x: np.zeros((1, 2), np.float32),
                          buckets=(2,), max_delay=0.01,
                          breaker=CircuitBreaker(threshold=2,
                                                 base_delay=5.0))
    srv.start(warmup=False)
    try:
        for _ in range(2):
            r1, r2 = srv.submit(_ex(1)), srv.submit(_ex(2))
            with pytest.raises(ValueError, match="batch-major"):
                r1.result(10)
            r2.exception(10)
        assert srv.breaker.state == "open"
        assert not srv.ready()
        with pytest.raises(CircuitOpenError):
            srv.submit(_ex(3))
    finally:
        srv.drain()


def test_entirely_nonfinite_multi_batch_counts_as_step_failure():
    """One poisoned row among good ones is a data fault (breaker stays
    closed — covered below); a MULTI-request batch where NO row is
    finite served nobody and counts toward the trip threshold.  A
    single-request dead batch does NOT (one buggy client at idle traffic
    must not trip the replica)."""
    srv = make_server(delay=0.01, warm=False, buckets=(2,),
                      breaker=CircuitBreaker(threshold=2, base_delay=5.0))
    try:
        bad = _ex(1)
        bad[:] = np.nan
        for _ in range(2):
            r1, r2 = srv.submit(bad.copy()), srv.submit(bad.copy())
            for r in (r1, r2):
                with pytest.raises(NonFiniteOutputError):
                    r.result(10)
        assert srv.breaker.state == "open"
    finally:
        srv.drain()


def test_single_request_nan_batch_is_a_data_fault():
    srv = make_server(warm=False, buckets=(1,),
                      breaker=CircuitBreaker(threshold=2, base_delay=5.0))
    try:
        bad = _ex(1)
        bad[:] = np.nan
        for _ in range(3):
            with pytest.raises(NonFiniteOutputError):
                srv(bad.copy())
        assert srv.breaker.state == "closed"   # replica stays up
        srv(_ex(2))                            # and keeps serving
    finally:
        srv.drain()


def test_queue_full_shed_refunds_rate_token():
    """A queue-full shed happens downstream of the limiter: the charged
    token must be refunded, or refused work burns the budget of clients
    the queue COULD have taken moments later."""
    srv = make_server(delay=0.1, buckets=(1,), max_queue=1,
                      rate=0.001, burst=3)                 # 3-token budget
    try:
        r1 = srv.submit(_ex(0))                # token 1: batch thread
        t0 = time.time()
        while srv.stats["queue_depth"] > 0 and time.time() - t0 < 5:
            time.sleep(0.002)                  # wait until r1 is IN the
        #                                        apply (queue truly empty)
        r2 = srv.submit(_ex(1))                # token 2: fills the queue
        with pytest.raises(RejectedError, match="queue full"):
            srv.submit(_ex(2))                 # token 3 charged... refunded
        r1.result(20)
        r2.result(20)                          # queue is free again
        r3 = srv.submit(_ex(3))                # the refunded token admits it
        r3.result(20)
        with pytest.raises(RejectedError, match="rate limit"):
            srv.submit(_ex(4))                 # budget is now truly spent
    finally:
        srv.drain()


def test_invalid_payloads_do_not_consume_rate_tokens():
    """A misbehaving client spamming unservable payloads must not starve
    valid clients of rate-limit tokens: validation runs first, tokens are
    charged only for admissible work."""
    srv = make_server(rate=0.001, burst=1)
    try:
        for _ in range(5):
            with pytest.raises(RejectedError, match="recompile"):
                srv.submit(np.zeros((9,), np.float32))
        srv.submit(_ex(0)).result(5)      # the one token is still there
        with pytest.raises(RejectedError, match="rate limit"):
            srv.submit(_ex(1))            # ...and now it is spent
    finally:
        srv.drain()


# ---------------------------------------------------------- NaN row guard --
def test_nonfinite_output_fails_one_request_not_the_batch():
    srv = make_server(delay=0.01, buckets=(4,))
    try:
        poisoned = _ex(1)
        poisoned[1] = np.nan                   # doubler propagates the NaN
        reqs = [srv.submit(_ex(2)), srv.submit(poisoned), srv.submit(_ex(3))]
        np.testing.assert_allclose(reqs[0].result(10), np.full((3,), 4.0))
        np.testing.assert_allclose(reqs[2].result(10), np.full((3,), 6.0))
        with pytest.raises(NonFiniteOutputError, match="neighbours"):
            reqs[1].result(10)
        assert srv.breaker.state == "closed"   # data fault, not server fault
        assert srv.alive()
    finally:
        srv.drain()


def test_a_members_wait_for_the_rows_before_it_is_its_deliver_span():
    """A batch's rows are handed out in order, each resolution running
    its request's callbacks (a fleet's bookkeeping and trace export): a
    later member's wait for them is its ``deliver`` span, so its tree
    accounts for its time (``audit_spans``).  A slow first callback
    (150 ms) stands for those callbacks on a loaded host; the JAX
    package leaves that wait unattributed (ROADMAP C15)."""
    from mxnet_tpu_torch import telemetry

    srv = make_server(buckets=(2,), max_delay=0.2)
    telemetry.enable(sample=1.0, collect=True)
    try:
        first = srv.submit(_ex(1))
        first.add_done_callback(lambda r: time.sleep(0.15))
        second = srv.submit(_ex(2))
        np.testing.assert_allclose(second.result(10), np.full((3,), 4.0))
        np.testing.assert_allclose(first.result(10), np.full((3,), 2.0))
        traces = telemetry.finished_traces(clear=True)
        assert len(traces) == 2
        assert [telemetry.audit_spans(tr) for tr in traces] == [[], []]
        for tr in traces:
            assert {"admit", "queue", "coalesce", "step", "deliver"} \
                <= {sp.name for sp in tr.spans}
    finally:
        telemetry.disable()
        srv.drain()


def test_bare_batcher_resolves_expired_without_server_hook():
    """DynamicBatcher used standalone (it is public API) must resolve an
    expired request itself — it left the queue, so nothing downstream
    could ever resolve it."""
    from mxnet_tpu_torch.serving import DynamicBatcher, Request

    ran = []
    b = DynamicBatcher(lambda group, padded: ran.append(len(group)),
                       buckets=(1,), max_delay=0.0)
    b.start()
    try:
        req = Request(np.zeros((2,), np.float32), deadline=0.0)
        b.offer(req)                               # already expired
        with pytest.raises(DeadlineExceededError):
            req.result(5)
        assert ran == []                           # never reached the runner
    finally:
        b.drain()


def test_predict_empty_iterator_raises_clearly():
    mod = _pred_module()
    empty = mx.io.NDArrayIter(np.zeros((0, 6), np.float32),
                              np.zeros((0,), np.float32), batch_size=8,
                              label_name="softmax_label")
    with pytest.raises(ValueError, match="no batches"):
        mod.predict(empty)


def test_all_finite_rows_helper():
    from mxnet_tpu_torch.parallel.step import all_finite_rows
    a = np.ones((4, 2), np.float32)
    a[2, 1] = np.inf
    b = np.ones((4,), np.float32)
    b[0] = np.nan
    np.testing.assert_array_equal(all_finite_rows(a),
                                  [True, True, False, True])
    np.testing.assert_array_equal(all_finite_rows([a, b]),
                                  [False, True, False, True])
    assert all_finite_rows(np.arange(6).reshape(3, 2)).all()  # int dtype


# ------------------------------------------------------------------- drain --
def test_drain_flushes_every_accepted_request():
    srv = make_server(delay=0.02, buckets=(1,))
    try:
        reqs = [srv.submit(_ex(i)) for i in range(6)]
        assert srv.drain(timeout=30)
        assert all(r.done() for r in reqs)
        for i, r in enumerate(reqs):           # flushed WITH results
            np.testing.assert_allclose(r.result(0), np.full((3,), 2.0 * i))
        with pytest.raises(ServerClosedError):
            srv.submit(_ex(0))
        assert not srv.alive() and not srv.ready()
    finally:
        srv.drain()


def test_context_manager_drains():
    with make_server() as srv:
        srv(_ex(1))
    assert not srv.alive()


@chaos
def test_drain_injection_point():
    srv = make_server()
    try:
        with fault.inject("serving.drain", RuntimeError("drain blocked")):
            with pytest.raises(RuntimeError, match="drain blocked"):
                srv.drain()
        assert srv.alive()                     # still serving: drain failed
        srv(_ex(1))                            # before admission stopped
    finally:
        assert srv.drain()


@chaos
def test_batch_injection_point_resolves_group():
    srv = make_server(delay=0.01, buckets=(4,))
    try:
        with fault.inject("serving.batch", RuntimeError("pad exploded"),
                          times=1):
            reqs = [srv.submit(_ex(i)) for i in range(3)]
            errs = [r.exception(10) for r in reqs]
        assert all(e is not None for e in errs)  # resolved, not dropped
        srv(_ex(1))                              # batcher loop survived
        st = srv.stats                           # ...and the books balance:
        assert st["completed"] + st["failed"] + st["expired"] \
            == st["admitted"]
    finally:
        srv.drain()


@chaos
def test_sigterm_serve_forever_drains_without_drops():
    srv = make_server(delay=0.01, buckets=(1, 2))
    accepted, rejected = [], [0]
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                accepted.append(srv.submit(_ex(1)))
            except RejectedError:
                rejected[0] += 1
            time.sleep(0.002)

    t = threading.Thread(target=client)
    t.start()
    try:
        timer = threading.Timer(0.1, os.kill,
                                (os.getpid(), signal.SIGTERM))
        timer.start()
        assert srv.serve_forever(poll=0.01)    # blocks until the signal
    finally:
        stop.set()
        t.join()
    assert accepted                            # load actually flowed
    assert all(r.done() for r in accepted)     # zero silently dropped
    assert all(r.exception(0) is None for r in accepted)
    assert not srv.alive()


# -------------------------------------------------- health + observability --
def test_healthz_and_counters():
    srv = make_server()
    try:
        h = srv.healthz()
        assert h["alive"] and h["ready"] and h["breaker"] == "closed"
        srv(_ex(1))
        series = profiler.counters("InferenceServer::")
        assert {"InferenceServer::queue_depth", "InferenceServer::shed",
                "InferenceServer::expired",
                "InferenceServer::batch_occupancy",
                "InferenceServer::breaker_state"} <= set(series)
    finally:
        srv.drain()
    assert srv.healthz()["alive"] is False


def test_serving_fault_points_registered():
    pts = fault.points()
    for p in ("serving.admit", "serving.batch", "serving.step",
              "serving.drain"):
        assert p in pts
    with pytest.raises(ValueError, match="unknown fault point"):
        fault.inject("serving.stpe", RuntimeError)   # the typo'd-point trap


@chaos
def test_admit_injection_point():
    srv = make_server()
    try:
        with fault.inject("serving.admit", RuntimeError("admission fault")):
            with pytest.raises(RuntimeError, match="admission fault"):
                srv.submit(_ex(0))
        srv(_ex(1))
    finally:
        srv.drain()


# ------------------------------------------------------- Module adapter --
def _mnist_like_module():
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = mx.sym.FullyConnected(act, num_hidden=4, name="fc2")
    out = mx.sym.SoftmaxOutput(fc2, name="softmax")
    mod = mx.mod.Module(out, context=mx.cpu())
    mod.bind([("data", (8, 6))], [("softmax_label", (8,))],
             for_training=False)
    mx.random.seed(0)
    mod.init_params()
    return mod


def test_module_apply_serves_bound_module():
    mod = _mnist_like_module()
    srv = InferenceServer(serving.module_apply(mod), buckets=(1, 2, 4),
                          max_delay=0.001,
                          sample=np.zeros((6,), np.float32))
    srv.start()
    try:
        x = np.random.RandomState(1).randn(6).astype(np.float32)
        got = srv(x)
        ref = mod.predict(mx.io.NDArrayIter(x[None, :].repeat(8, axis=0),
                                            batch_size=8)).asnumpy()[0]
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    finally:
        srv.drain()


def test_module_apply_requires_bound_module():
    mod = mx.mod.Module(mx.sym.Variable("data"), context=mx.cpu())
    with pytest.raises(ValueError, match="bind"):
        serving.module_apply(mod)


# ------------------------- Module.predict/score interrupt hygiene (sat. 1) --
def _thread_names():
    return [t.name for t in threading.enumerate()]


def _pred_module(batch=8):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=4, name="fc")
    out = mx.sym.SoftmaxOutput(fc, name="softmax")
    mod = mx.mod.Module(out, context=mx.cpu())
    mod.bind([("data", (batch, 6))], [("softmax_label", (batch,))],
             for_training=False)
    mod.init_params()
    return mod


class _SignalingIter(mx.io.DataIter):
    """Raises SIGTERM (or an error) from inside next() at batch k."""

    def __init__(self, base, at, error=None):
        super().__init__(base.batch_size)
        self._base, self._at, self._error = base, at, error
        self._i = 0

    @property
    def provide_data(self):
        return self._base.provide_data

    @property
    def provide_label(self):
        return self._base.provide_label

    def reset(self):
        self._base.reset()
        self._i = 0

    def next(self):
        i, self._i = self._i, self._i + 1
        batch = self._base.next()
        if i == self._at:
            if self._error is not None:
                raise self._error
            signal.raise_signal(signal.SIGTERM)
        return batch


def _prefetched(bad_at=None, error=None, n=48):
    base = mx.io.NDArrayIter(np.random.RandomState(0)
                             .randn(n, 6).astype(np.float32),
                             np.zeros((n,), np.float32), batch_size=8,
                             label_name="softmax_label")
    inner = base if bad_at is None else _SignalingIter(base, bad_at,
                                                       error=error)
    return mx.io.PrefetchingIter(inner, capacity=2)


@chaos
def test_predict_sigterm_stops_early_and_closes_feed():
    """Inside an enclosing latch (fit's preemption latch, a serving
    runtime's): SIGTERM stops predict at a batch boundary with partial
    results, the feed closes, and the OUTER latch still sees the
    signal."""
    mod = _pred_module()
    pf = _prefetched(bad_at=2)
    with fault.GracefulExit(signals=(signal.SIGTERM,)) as outer:
        out = mod.predict(pf)                  # SIGTERM inside batch 3
    assert outer.requested                     # forwarded, not swallowed
    assert 0 < out.shape[0] < 48               # partial, at a batch boundary
    assert pf._closed                          # feed closed, threads joined
    assert "PrefetchingIter-producer" not in _thread_names()


@chaos
def test_predict_bare_signal_redelivers_after_cleanup():
    """With NO enclosing latch, predict must not swallow the signal — a
    process whose operator sent SIGTERM/SIGINT has to die.  It closes the
    feed first, then re-delivers under the restored handlers (SIGINT →
    KeyboardInterrupt, so the test survives)."""
    mod = _pred_module()
    prev = signal.getsignal(signal.SIGINT)

    class _SigintIter(_SignalingIter):
        def next(self):
            i, self._i = self._i, self._i + 1
            batch = self._base.next()
            if i == self._at:
                signal.raise_signal(signal.SIGINT)
            return batch

    base = mx.io.NDArrayIter(np.zeros((48, 6), np.float32),
                             np.zeros((48,), np.float32), batch_size=8,
                             label_name="softmax_label")
    pf = mx.io.PrefetchingIter(_SigintIter(base, 2), capacity=2)
    with pytest.raises(KeyboardInterrupt):
        mod.predict(pf)
    assert pf._closed                          # cleanup happened first
    assert "PrefetchingIter-producer" not in _thread_names()
    assert signal.getsignal(signal.SIGINT) is prev


@chaos
def test_predict_error_closes_feed():
    mod = _pred_module()
    pf = _prefetched(bad_at=2, error=ValueError("corrupt shard"))
    with pytest.raises(ValueError, match="corrupt shard"):
        mod.predict(pf)
    assert pf._closed
    assert "PrefetchingIter-producer" not in _thread_names()


@chaos
def test_score_sigterm_stops_early_and_closes_feed():
    mod = _pred_module()
    pf = _prefetched(bad_at=1)
    with fault.GracefulExit(signals=(signal.SIGTERM,)) as outer:
        res = mod.score(pf, "acc")             # partial metric, clean exit
    assert outer.requested
    assert res and res[0][0] == "accuracy"
    assert pf._closed
    assert "PrefetchingIter-producer" not in _thread_names()


def test_predict_clean_run_leaves_feed_open_for_reuse():
    mod = _pred_module()
    pf = _prefetched()
    out = mod.predict(pf)
    assert out.shape[0] == 48
    assert not pf._closed                      # reusable: reset + go again
    pf.reset()
    assert mod.predict(pf).shape[0] == 48
    pf.close()


@chaos
def test_nested_graceful_exit_forwards_to_outer_latch():
    """A latch armed inside another (predict inside fit's) must forward
    the signal so the outer scope still sees the preemption."""
    with fault.GracefulExit(signals=(signal.SIGTERM,)) as outer:
        with fault.GracefulExit(signals=(signal.SIGTERM,)) as inner:
            signal.raise_signal(signal.SIGTERM)
            assert inner.requested and inner.forwarded
        assert outer.requested and outer.signum == signal.SIGTERM


@chaos
def test_graceful_exit_cascades_through_three_latches():
    """User latch around fit's latch around score's latch: the signal
    must reach ALL of them, not just one level up — the outermost owns
    the process's shutdown logic."""
    sig = (signal.SIGTERM,)
    with fault.GracefulExit(signals=sig) as user:
        with fault.GracefulExit(signals=sig) as fit_latch:
            with fault.GracefulExit(signals=sig) as score_latch:
                signal.raise_signal(signal.SIGTERM)
            assert score_latch.requested and score_latch.forwarded
        assert fit_latch.requested and fit_latch.forwarded
    assert user.requested and user.signum == signal.SIGTERM


def test_never_started_batcher_drain_resolves_queued():
    """drain() without start(): there is no loop to flush the queue, so
    drain itself must resolve the stragglers — an offered request may
    never be left pending forever."""
    from mxnet_tpu_torch.serving import DynamicBatcher, Request

    b = DynamicBatcher(lambda g, p: None, buckets=(1,))
    req = b.offer(Request(np.zeros((2,), np.float32)))
    assert b.drain(timeout=1)
    with pytest.raises(ServerClosedError):
        req.result(1)


def test_score_accepts_plain_iterable():
    """predict() grew a reset() guard for plain iterables; score must
    match (fit(eval_data=...) feeds it the same duck types)."""
    mod = _pred_module()
    x = np.random.RandomState(0).randn(8, 6).astype(np.float32)
    batches = [mx.io.DataBatch(data=[mx.nd.array(x)],
                               label=[mx.nd.array(np.zeros(8, np.float32))])]
    res = mod.score(iter(batches), "acc")
    assert res and res[0][0] == "accuracy"


# =========================================================== per-tenant QoS --
@slo
def test_qos_class_resolution_and_validation():
    qos = TenantQoS(classes=[QoSClass("gold", priority=10, deadline=0.5),
                             QoSClass("bronze", priority=0)],
                    default_class="bronze")
    assert qos.klass(None).name == "bronze"          # default class
    assert qos.klass("gold").priority == 10
    with pytest.raises(RejectedError, match="unknown priority class"):
        qos.klass("platinum")
    with pytest.raises(ValueError, match="duplicate class"):
        TenantQoS(classes=[QoSClass("a"), QoSClass("a")])
    with pytest.raises(ValueError, match="default_class"):
        TenantQoS(classes=[QoSClass("a")], default_class="b")
    with pytest.raises(ValueError, match="admit_frac"):
        QoSClass("x", admit_frac=0.0)


@slo
def test_per_tenant_buckets_isolate_and_refund():
    """One tenant's empty bucket sheds that tenant ALONE; a refunded
    token is honestly re-spendable and the shed lands in the books."""
    qos = TenantQoS(tenant_rate=1.0, tenant_burst=2)
    qc = qos.classify(tenant="abuser")
    qos.classify(tenant="abuser")
    with pytest.raises(TenantThrottledError, match="abuser"):
        qos.classify(tenant="abuser")                # burst burnt
    qos.classify(tenant="nice")                      # neighbour untouched
    qos.refund("abuser", qc)                         # downstream refusal
    qos.classify(tenant="abuser")                    # token honestly back
    snap = qos.snapshot()["default"]
    assert snap["throttled"] == 1 and snap["shed"] == 1
    # admitted column: 4 classifies + 1 refund takes one back
    assert snap["admitted"] == 3


@slo
def test_tenant_bucket_lru_bounds_cardinality():
    """A tenant-id cardinality attack must not grow host memory without
    bound: the bucket table is LRU-capped."""
    qos = TenantQoS(tenant_rate=100.0, max_tenants=4)
    for i in range(16):
        qos.classify(tenant=f"t{i}")
    assert len(qos._buckets) == 4
    assert "t15" in qos._buckets and "t0" not in qos._buckets


@slo
def test_class_stats_percentiles_and_deadline_miss():
    qos = TenantQoS(classes=[QoSClass("gold", deadline=0.01)])
    qc = qos.klass("gold")
    # resolve two tracked requests: one instant, one past the SLO target
    fast = serving.Request((None,))
    qos.track(qc, fast)
    fast.set_result(1)
    slow = serving.Request((None,))
    qos.track(qc, slow)
    time.sleep(0.03)                                 # > the 10ms target
    slow.set_result(1)
    snap = qos.snapshot()["gold"]
    assert snap["completed"] == 2
    assert snap["deadline_miss"] == 1                # SLO miss, not error
    assert snap["p50_ms"] is not None \
        and snap["p99_ms"] >= snap["p50_ms"]
    assert snap["priority"] == 0 and snap["deadline"] == 0.01


@slo
def test_server_qos_admission_and_class_deadline():
    """InferenceServer end-to-end: tenant throttling at submit, the
    class's default deadline applied, and resolutions landing in the
    per-class healthz rows."""
    qos = TenantQoS(classes=[QoSClass("gold", priority=10, deadline=5.0),
                             QoSClass("bronze", priority=0,
                                      deadline=0.0001)],
                    default_class="bronze", tenant_rate=1.0,
                    tenant_burst=2)
    srv = InferenceServer(make_apply(delay=0.05), buckets=(1,),
                          max_delay=0.0, qos=qos,
                          name="QoSServer").start()
    x = np.ones((3,), np.float32)
    try:
        np.testing.assert_allclose(srv(x, tenant="t0", klass="gold"),
                                   2.0 * x)
        # bronze's 0.1ms class deadline expires in queue: the batch
        # thread is pinned by a slow request while the doomed one waits
        blocker = srv.submit(x, tenant="t0", klass="gold")
        with pytest.raises(DeadlineExceededError):
            srv(x, tenant="t1", klass="bronze")
        blocker.result(30)
        # the abusive tenant sheds alone — and the verdict never burned
        # queue space (rejected accounting, not failed)
        srv.submit(x, tenant="abuser", klass="gold").result(10)
        srv.submit(x, tenant="abuser", klass="gold").result(10)
        with pytest.raises(TenantThrottledError):
            srv.submit(x, tenant="abuser", klass="gold")
        classes = srv.healthz()["classes"]
        assert classes["gold"]["completed"] >= 3
        assert classes["gold"]["throttled"] == 1
        assert classes["bronze"]["expired"] >= 1
        assert classes["bronze"]["deadline_miss"] >= 1
    finally:
        srv.drain()
    st = srv.stats
    assert st["admitted"] == st["completed"] + st["failed"] + st["expired"]


@slo
@chaos
def test_admission_classify_fault_point():
    """admission.classify is injectable: the verdict path itself can be
    failed deterministically, the server sheds explicitly and stays
    healthy."""
    srv = InferenceServer(make_apply(), buckets=(1, 2), max_delay=0.002,
                          name="ClassifyInj").start()
    x = np.ones((3,), np.float32)
    try:
        with fault.inject("admission.classify", RuntimeError("ldap down")):
            with pytest.raises(RuntimeError, match="ldap down"):
                srv.submit(x, tenant="t0")
        np.testing.assert_allclose(srv(x), 2.0 * x)  # healthy after
    finally:
        srv.drain()


# ============================================== parity with the JAX package --
def _numpy_doubler(x):
    return np.asarray(x) * 2.0


def _scripted_traffic(pkg, name):
    """One client, one request at a time (``max_delay`` 0): the same
    batches in the same order in either package.  Returns each
    request's result or error type, ``stats`` and ``healthz()``."""
    srv = pkg.serving.InferenceServer(_numpy_doubler, buckets=(1, 2, 4),
                                      max_delay=0.0, name=name,
                                      sample=np.zeros((3,), np.float32))
    srv.start()
    poisoned = _ex(4)
    poisoned[1] = np.nan
    payloads = [_ex(i) for i in range(6)] + [poisoned, _ex(7),
                                             np.zeros((4,), np.float32),
                                             np.zeros((3,), np.float64)]
    outs = []
    try:
        for p in payloads:
            try:
                outs.append(np.asarray(srv(p, timeout=10)))
            except Exception as exc:      # noqa: BLE001 — compared below
                outs.append(type(exc).__name__)
        return outs, srv.stats, srv.healthz()
    finally:
        srv.drain()


def test_same_traffic_same_results_stats_and_healthz_keys():
    j_outs, j_stats, j_h = _scripted_traffic(jmx, "ParityJax")
    t_outs, t_stats, t_h = _scripted_traffic(mx, "ParityPort")
    assert len(j_outs) == len(t_outs)
    for a, b in zip(j_outs, t_outs):
        if isinstance(a, str):
            assert a == b
        else:
            np.testing.assert_array_equal(b, a)
    assert t_stats == j_stats
    assert set(t_h) == set(j_h)
    assert set(t_h["classes"]) == set(j_h["classes"])
    assert set(t_h["classes"]["default"]) == \
        set(j_h["classes"]["default"])


def _mnist_like_modules():
    """The same bound module in both packages, the port's parameters
    copied by name from the JAX module's."""
    S, J = mx.sym, jmx.sym
    mods = []
    for pkg, sym in ((jmx, J), (mx, S)):
        data = sym.Variable("data")
        fc1 = sym.FullyConnected(data, num_hidden=16, name="fc1")
        act = sym.Activation(fc1, act_type="relu", name="relu1")
        fc2 = sym.FullyConnected(act, num_hidden=4, name="fc2")
        out = sym.SoftmaxOutput(fc2, name="softmax")
        mod = pkg.mod.Module(out, context=pkg.cpu())
        mod.bind([("data", (8, 6))], [("softmax_label", (8,))],
                 for_training=False)
        mods.append(mod)
    jmod, tmod = mods
    jmx.random.seed(0)
    jmod.init_params(jmx.init.Xavier(magnitude=2.0))
    arg, aux = jmod.get_params()
    tmod.init_params(arg_params={k: v.asnumpy() for k, v in arg.items()},
                     aux_params={k: v.asnumpy() for k, v in aux.items()})
    return jmod, tmod


def test_module_apply_matches_jax_over_the_grid():
    jmod, tmod = _mnist_like_modules()
    japply = jmx.serving.module_apply(jmod)
    tapply = serving.module_apply(tmod)
    rng = np.random.RandomState(3)
    for b in (1, 2, 4, 1, 2, 4, 8):
        x = rng.randn(b, 6).astype(np.float32)
        want = np.asarray(japply(x))
        got = tapply(x)
        assert isinstance(got, torch.Tensor) and got.shape == (b, 4)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_module_apply_grid_traffic_rebinds_nothing():
    """Serving a module at buckets (1, 2, 4) keeps one fed array per
    signature: a known signature is written in place, the executor's
    held set of parameter arrays (what its graphs read) never drops."""
    _jmod, tmod = _mnist_like_modules()
    apply = serving.module_apply(tmod)
    srv = InferenceServer(apply, buckets=(1, 2, 4), max_delay=0.001,
                          sample=np.zeros((6,), np.float32)).start()
    ex = tmod._exec
    try:
        held = ex._held
        tables = {n: dict(t) for n, t in ex._fed.items()}
        rng = np.random.RandomState(4)
        reqs = [srv.submit(rng.randn(6).astype(np.float32))
                for _ in range(40)]
        for r in reqs:
            r.result(10)
        assert ex._held is held
        for n, t in ex._fed.items():
            assert len(t) == 4              # the bound shape + 3 buckets
            for key, arr in tables[n].items():
                assert t[key] is arr
    finally:
        srv.drain()
    assert srv.stats["distinct_shapes"] == 3


def test_server_over_evalstep_matches_jax_evalstep():
    """A small fused ResNet (NHWC, one block a stage) behind the port's
    ``EvalStep`` and ``InferenceServer`` (plain versions of the fused
    kernel on the CPU) against the JAX ``EvalStep`` of the same net (its
    Pallas kernel in interpret mode), parameters copied by name."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_resnet import NET_TOL, _x, small_pair

    # eight rows: the JAX step shards its batch over the tests' 8-device
    # CPU mesh
    x = _x((8, 32, 32, 3), seed=5)
    jnet, tnet = small_pair(True, x)
    want = np.asarray(jmx.parallel.EvalStep(jnet)(jmx.nd.array(x))
                      .asnumpy())
    step = mx.parallel.EvalStep(tnet)
    srv = InferenceServer(step, buckets=(1, 8), max_delay=0.05,
                          sample=np.zeros((32, 32, 3), np.float32)).start()
    try:
        reqs = [srv.submit(x[i]) for i in range(8)]
        got = np.stack([r.result(30) for r in reqs])
    finally:
        srv.drain()
    assert got.shape == (8, 10)
    np.testing.assert_allclose(got, want, **NET_TOL)
    assert step.graph_count() == 0          # the CPU captures nothing


def test_bfloat16_outputs_widen_to_float32_rows():
    """numpy has no bfloat16: a bf16 output comes back as float32 rows,
    an exact widening (the JAX package returns ml_dtypes bfloat16)."""
    def apply(x):
        return torch.from_numpy(np.asarray(x)).to(torch.bfloat16) * 3

    srv = InferenceServer(apply, buckets=(1, 2), max_delay=0.001,
                          sample=np.zeros((5,), np.float32)).start()
    try:
        x = np.array([1.0, 1.0 / 3, 2.5, -7.0, 1e-3], np.float32)
        out = srv(x)
    finally:
        srv.drain()
    want = (torch.from_numpy(x).to(torch.bfloat16) * 3).float().numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, want)
    j = jmx.serving.server._to_np(np.asarray(want).astype("bfloat16"))
    np.testing.assert_array_equal(out, j.astype(np.float32))


def test_tensor_payloads_pass_signature_pinning():
    """A payload arriving as a torch tensor (or NDArray) is normalised
    to numpy before its signature is compared with the served one."""
    srv = make_server()
    try:
        np.testing.assert_allclose(srv(torch.full((3,), 2.0)),
                                   np.full((3,), 4.0))
        np.testing.assert_allclose(srv(mx.nd.array(np.ones(3, np.float32))),
                                   np.full((3,), 2.0))
        with pytest.raises(RejectedError, match="float64"):
            srv.submit(torch.zeros(3, dtype=torch.float64))
    finally:
        srv.drain()


def test_all_finite_rows_on_tensors():
    from mxnet_tpu_torch.parallel.step import all_finite_rows
    a = torch.ones(4, 2, dtype=torch.bfloat16)
    a[2, 1] = float("inf")
    b = np.ones((4,), np.float32)
    b[0] = np.nan
    np.testing.assert_array_equal(all_finite_rows([a, b]),
                                  [False, True, False, True])
    np.testing.assert_array_equal(all_finite_rows(mx.nd.array(b)),
                                  [False, True, True, True])


# ------------------------------------------------------------- on the card --
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")


def _card_traffic(srv, sample, n=48, seed=0):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        reqs.append(srv.submit(sample + rng.randn(*sample.shape)
                               .astype(np.float32)))
        if i % 5 == 0:
            time.sleep(0.003)               # ragged arrivals: every bucket
    return [r.result(30) for r in reqs]


@gpu
def test_card_evalstep_graphs_equal_the_census():
    _needs_card()
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(32, activation="relu"),
                mx.gluon.nn.Dense(4))
    net.initialize(ctx=mx.gpu(0))
    step = mx.parallel.EvalStep(net)
    spec = BucketSpec(batch=(1, 2, 4))
    sample = np.zeros((8,), np.float32)
    srv = InferenceServer(step, buckets=spec, max_delay=0.002,
                          sample=sample).start()
    try:
        assert step.graph_count() == executable_census(spec)
        _card_traffic(srv, sample)
        assert step.graph_count() == executable_census(spec)
    finally:
        srv.drain()


@gpu
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_card_module_apply_graphs_equal_the_census(quantize):
    _needs_card()
    S = mx.sym
    data = S.Variable("data")
    net = S.FullyConnected(data, num_hidden=16, name="fc1")
    net = S.Activation(net, act_type="relu", name="relu1")
    net = S.FullyConnected(net, num_hidden=4, name="fc2")
    mod = mx.mod.Module(S.SoftmaxOutput(net, name="softmax"),
                        context=mx.gpu(0))
    mod.bind([("data", (8, 6))], [("softmax_label", (8,))],
             for_training=False)
    mod.init_params(mx.init.Xavier(magnitude=2.0))
    apply = serving.module_apply(mod, quantize=quantize)
    spec = BucketSpec(batch=(1, 2, 4))
    sample = np.zeros((6,), np.float32)
    srv = InferenceServer(apply, buckets=spec, max_delay=0.002,
                          sample=sample).start()
    try:
        assert apply.jit_cache_size() == executable_census(spec)
        _card_traffic(srv, sample)
        assert apply.jit_cache_size() == executable_census(spec)
    finally:
        srv.drain()
