"""Port parity: QoS classes, request spans and the metrics exposition of
``mxnet_tpu_torch.serving.GenerationServer``, on the CPU.

- the JAX package's QoS tests: a high-priority class jumps the queue;
  an over-rate tenant sheds alone and a low class's queue cap keeps
  headroom for the classes above it — the port's per-class counts
  equal the JAX server's under the same script;
- request tracing: every request's span tree (admit, queue, prefill,
  decode) audits clean, a salvaged request carries its ``salvage``
  event, and ``trace_parent`` attaches a request under a caller's span;
- ``telemetry()``: the JAX server's counter and gauge keys (the salvage
  and sharing families included), the ``slot_pages`` histogram, the
  stamped ``mem_*`` gauges, Prometheus text.
"""
import gc
import threading
import time

import numpy as np
import pytest

from mxnet_tpu.serving import BucketSpec as JBucketSpec
from mxnet_tpu.serving import GenerationServer as JGenerationServer
from mxnet_tpu.serving import QoSClass as JQoSClass
from mxnet_tpu.serving import TenantQoS as JTenantQoS
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.serving import (BucketSpec, GenerationServer, QoSClass,
                                     RejectedError, TenantQoS,
                                     TenantThrottledError)

from test_torch_generate import JCFG, JP, TCFG, TP


@pytest.fixture(autouse=True)
def _telemetry_off():
    yield
    telemetry.disable()
    gc.collect()


def make_server(**kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("n_pages", 17)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("seed", 0)
    name = kw.pop("name", f"TorchQoS-{time.monotonic_ns()}")
    return GenerationServer(TP, TCFG, device="cpu", name=name,
                            buckets=BucketSpec(batch=(1,), length=(8,)),
                            **kw)


def test_priority_class_jumps_the_queue():
    qos = TenantQoS(classes=[QoSClass("gold", priority=10),
                             QoSClass("bronze", priority=0)],
                    default_class="bronze")
    srv = make_server(n_slots=1, max_new_tokens=24, qos=qos).start()
    order, lock = [], threading.Lock()

    def watch(tag, req):
        req.add_done_callback(
            lambda r: (lock.acquire(), order.append(tag), lock.release()))
        return req

    try:
        bronze = [watch(f"b{i}", srv.submit(np.asarray([i + 1], np.int32),
                                            klass="bronze"))
                  for i in range(4)]
        gold = watch("gold", srv.submit(np.asarray([6], np.int32),
                                        klass="gold"))
        gold.result(120)
        for r in bronze:
            r.result(120)
        # at most the bronze already seated finishes before gold
        assert order.index("gold") <= 1, order
        classes = srv.healthz()["classes"]
        assert classes["gold"]["completed"] == 1
        assert classes["bronze"]["completed"] == 4
    finally:
        assert srv.drain(30)


def _throttle_script(srv, qos_errors):
    """The JAX package's tenant-throttle / class-cap script; returns
    what each submission did."""
    seen = []

    def sub(prompt, **kw):
        try:
            r = srv.submit(np.asarray(prompt, np.int32), **kw)
            seen.append("ok")
            return r
        except qos_errors as exc:
            seen.append(type(exc).__name__)
            return None

    ab = [sub([3], tenant="abuser", klass="gold") for _ in range(3)]
    sub([5], tenant="t0", klass="gold").result(120)
    for r in ab:
        if r is not None:
            r.result(120)
    reqs = [sub([1], tenant="t1")]
    t0 = time.time()                            # wait for it to seat
    while srv.healthz()["queue_depth"] > 0 and time.time() - t0 < 30:
        time.sleep(0.005)
    reqs += [sub([i + 2], tenant=f"t{i + 2}") for i in range(2)]
    reqs.append(sub([9], tenant="t9"))
    gold = sub([7], tenant="g0", klass="gold")
    gold.result(120)
    for r in reqs:
        if r is not None:
            r.result(120)
    return seen


def test_tenant_throttle_and_class_queue_cap_match_jax():
    """An abusive tenant sheds alone; bronze at half the queue sheds
    while gold keeps its headroom.  The port's submissions and per-class
    counts equal the JAX server's under the same script."""
    from mxnet_tpu.serving import RejectedError as JRejectedError

    runs = []
    for jax_side in (True, False):
        Q, C = (JTenantQoS, JQoSClass) if jax_side else (TenantQoS,
                                                         QoSClass)
        qos = Q(classes=[C("gold", priority=10),
                         C("bronze", priority=0, admit_frac=0.5)],
                default_class="bronze", tenant_rate=1.0, tenant_burst=2)
        kw = dict(n_slots=1, n_pages=17, page_size=4, max_new_tokens=24,
                  max_queue=4, seed=0, qos=qos)
        if jax_side:
            srv = JGenerationServer(
                JP, JCFG, buckets=JBucketSpec(batch=(1,), length=(8,)),
                attention_impl="jnp", name=f"TorchQoSJ-{time.monotonic_ns()}",
                **kw).start()
            errors = JRejectedError
        else:
            srv = make_server(**kw).start()
            errors = RejectedError
        try:
            seen = _throttle_script(srv, errors)
            snap = srv.healthz()["classes"]
        finally:
            assert srv.drain(60)
        st = srv.stats
        assert st["admitted"] == st["completed"] + st["failed"] \
            + st["expired"]
        runs.append((seen, {c: {k: snap[c][k] for k in
                                ("completed", "shed", "throttled")}
                            for c in ("gold", "bronze")}))
    (jseen, jsnap), (tseen, tsnap) = runs
    assert tseen == jseen
    assert tsnap == jsnap
    assert tseen[2] == "TenantThrottledError" and "RejectedError" in tseen
    assert tsnap["bronze"]["shed"] >= 1 and tsnap["gold"]["throttled"] >= 1
    assert TenantThrottledError.__name__ in tseen


def test_generation_server_span_tree():
    telemetry.enable(collect=True)
    srv = make_server()
    srv.start()
    try:
        reqs = [srv.submit(np.array([5, 6, 7], np.int32), max_new_tokens=4)
                for _ in range(4)]
        for r in reqs:
            r.result(60)
    finally:
        srv.drain()
    traces = telemetry.finished_traces()
    assert len(traces) == 4
    for tr in traces:
        assert telemetry.audit_spans(tr) == []
        assert {"admit", "queue", "prefill", "decode"} \
            <= {sp.name for sp in tr.spans}
        pre = next(sp for sp in tr.spans if sp.name == "prefill")
        assert "worker" in pre.attrs
        dec = next(sp for sp in tr.spans if sp.name == "decode")
        assert dec.attrs["tokens"] == 4 and "slot" in dec.attrs
    pay = srv.telemetry()
    assert pay["kind"] == "generation_server"
    assert pay["histograms"]["decode_ms"]["count"] == 4
    assert pay["counters"]["retired"] == 4


def test_salvaged_request_carries_the_salvage_event():
    telemetry.enable(collect=True)
    srv = make_server()
    srv.start()
    try:
        with tfault.inject("generate.decode", RuntimeError("injected"),
                           times=1):
            srv.submit(np.array([1, 2, 3], np.int32)).result(60)
    finally:
        srv.drain()
    (tr,) = telemetry.finished_traces()
    assert telemetry.audit_spans(tr) == []
    names = [ev["name"] for sp in tr.spans for ev in sp.events]
    assert "salvage" in names and "resume" in names
    assert [sp.name for sp in tr.spans].count("prefill") == 2


def test_trace_parent_attaches_the_request_under_a_span():
    telemetry.enable(collect=True)
    root = telemetry.Trace("caller", server="test")
    parent = root.open("dispatch")
    srv = make_server().start()
    try:
        srv.submit(np.array([1, 2], np.int32), trace_parent=parent).result(60)
    finally:
        srv.drain()
    names = {sp.name for sp in root.spans}
    assert {"dispatch", "admit", "prefill", "decode"} <= names


def test_exposition_keys_equal_the_jax_servers_and_memory_gauges():
    """The salvage, resume and sharing families ride the exposition
    under the JAX server's keys; ``slot_pages`` observes each
    retirement; a memory report stamps the ``mem_*`` gauges."""
    telemetry.enable()
    report = {"argument_bytes": 1000, "peak_bytes": 2000,
              "per_device": {"argument_bytes": 125, "peak_bytes": 250}}
    srv = make_server(memory_report=report).start()
    jsrv = JGenerationServer(JP, JCFG,
                             buckets=JBucketSpec(batch=(1,), length=(8,)),
                             attention_impl="jnp", n_slots=2, n_pages=17,
                             page_size=4, max_new_tokens=6,
                             name=f"TorchExpoJ-{time.monotonic_ns()}")
    try:
        srv.submit(np.array([1, 2, 3], np.int32),
                   max_new_tokens=3).result(30)
        pay = srv.telemetry()
        jpay = jsrv.telemetry()
        missing = set(jpay["counters"]) - set(pay["counters"])
        assert missing == set(), missing
        for key in ("pages_shared", "pages_cow_faults",
                    "bytes_saved_by_sharing", "spec_k",
                    "resume_prefill_pages_remapped", "mem_argument_bytes",
                    "mem_per_device_argument_bytes"):
            assert key in pay["gauges"] and key in jpay["gauges"], key
        g = pay["gauges"]
        assert g["mem_argument_bytes"] == 1000
        assert g["mem_per_device_argument_bytes"] == 125
        srv.stamp_memory_report({"argument_bytes": 7})
        g = srv.telemetry()["gauges"]
        assert g["mem_argument_bytes"] == 7 and g["mem_peak_bytes"] == 0
        assert g["used_pages"] == 0 and g["tokens_out"] == 3
        snap = pay["histograms"]["slot_pages"]
        assert snap["count"] == 1 and snap["sum"] >= 1
        text = srv.telemetry("prom")
        assert "tokens_salvaged" in text
        assert "resume_prefill_pages_remapped" in text
    finally:
        srv.drain()
        jsrv.drain()
