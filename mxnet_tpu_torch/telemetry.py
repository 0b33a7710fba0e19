"""mx.telemetry — end-to-end request tracing + unified metrics.

(The port's own copy of ``mxnet_tpu/telemetry.py``: stdlib only, its imports
point inside ``mxnet_tpu_torch``.)

The stack spans six cooperating runtimes (``InferenceServer``,
``DynamicBatcher``, ``ServingFleet`` + autoscaler, ``GenerationServer``
with disaggregated prefill/decode, the elastic ``Supervisor``,
``TrainStep``); before this module their observability was point-wise —
profiler counters here, a per-server ``healthz()`` there, three
unrelated JSONL event logs.  TensorFlow's runtime made per-op/per-step
tracing a first-class system facility (arXiv:1605.08695), and the
reference MXNet shipped ``src/profiler`` spans for the engine's async
paths; this is the equivalent for the REQUEST path:

- **Request tracing** — a ``Trace``/``Span`` layer with ids and parent
  links, carried on ``serving.Request`` so every accepted request
  yields one complete span tree: admit → queue → batch-coalesce →
  device step → delivery of the batch's rows (→ failover hops with
  replica names → resolution) for the
  classifier path, and admit → queue → prefill (worker id) → handoff →
  decode residency → retire for generation — with preemption/requeue
  and ``fault.fire`` firings recorded as span events.  Finished traces
  export as JSONL (``JsonlSink``) AND into the profiler's Chrome-trace
  stream, so request spans land on the same timeline as the profiler's
  counters and ``TrainStep`` spans.
- **The off-switch contract** — tracing is armed per-process with
  ``enable(sample=...)`` and disarmed with ``disable()``.  Every
  instrumentation site in the serving stack is guarded by a single
  attribute check (``telemetry.ACTIVE`` at trace birth,
  ``request.trace is not None`` downstream); when off, no span object
  is ever allocated.  ``sample`` (1.0 → every request, 0.0 → none)
  bounds tracing cost under full production load.  A tracer failure
  must NEVER fail a request: every export/bookkeeping path that runs on
  a serving thread swallows its own exceptions (the request resolves;
  the trace is lost — see the failure matrix in ``docs/api.md``).
- **Unified metrics** — ``MetricsRegistry`` with ``Counter`` /
  ``Gauge`` / ``Histogram`` (fixed log-spaced buckets, mergeable
  snapshots, interpolated quantiles).  ``profiler.Counter`` is a shim
  over this registry (the two systems cannot report different values
  for one series), ``admission.ClassStats`` hosts its p50/p99 here, and
  span durations feed per-phase latency histograms
  (``<server>::<phase>_ms``) that ``bench.py`` reads.  One
  ``exposition()`` schema (JSON + Prometheus-style text via
  ``render_prometheus``) is served by ``InferenceServer.telemetry()``,
  ``GenerationServer.telemetry()``, ``ServingFleet.telemetry()``
  (aggregating replicas), ``FleetAutoscaler.telemetry()`` and
  ``elastic.Supervisor.telemetry()`` with identical key schemas.
- **Auditable by construction** — ``audit_spans`` asserts a span tree
  is complete (every span closed, parents exist, children contained,
  per-stage durations accounting for e2e within tolerance);
  ``tools/chaos_check.py --mode obs`` runs it over every request of a
  storm with faults + a replica kill, so the tracer itself regresses
  like a test.

A second part adds the runtime-introspection half — the observability that
is NOT request-scoped:

- **Compile-event stream** — ``compile_event`` is the ONE chokepoint
  every compile path reports through (``TrainStep``/``EvalStep``
  ``_prepare``, serving warmup + ``module_apply``, ``fleet.HotSwapApply``,
  the four ``serving/generate.py`` program constructors, the costguard
  entrypoint constructors).  One event per executable created (site,
  signature key, wall-ms, n_executables after); cache HITS increment a
  counter instead of emitting events, so ``sum(events) == census ==
  runtime jit-cache count`` holds by construction.  ``track_compile``
  is the guarded probe call sites wrap a possibly-compiling call in;
  ``pin_compile_census`` declares a site's post-warmup executable count,
  after which any further miss increments ``recompiles_unexpected``
  (the counter ``chaos_check --mode obs`` asserts is zero) and lands a
  ``recompile`` span event on the in-flight requests.
- **Flight recorder** — ``flight()`` is a bounded in-memory ring of the
  last N spans / fault firings / compile events / trip records;
  ``flight().dump()`` writes one JSONL post-mortem bundle (header,
  ring, final metrics snapshot) and NEVER raises — a dying process must
  not die harder for its black box.  ``flight_trip`` fires the dump
  automatically on breaker OPEN, non-finite abort, ``GracefulExit``
  latch, and unhandled (thread) death; ``elastic.Supervisor`` exports
  ``MXTPU_FLIGHT_DIR`` so per-rank bundles land in its event-log
  directory.

Like ``fault.py`` this module imports ONLY the standard library, and it
is loadable by file path outside the package (``elastic.py`` loads it
that way so the supervisor process stays jax-free).
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import random as _random
import threading
import time
import weakref

__all__ = [
    "Span", "Trace", "enable", "disable", "enabled", "config",
    "begin_request", "abort_request", "open_span", "end_span",
    "span_event", "get_span", "suppress",
    "use_spans", "push_current", "pop_current", "note_fault",
    "finished_traces", "now_us",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "log_buckets", "histogram_quantile", "merge_snapshots",
    "LATENCY_BUCKETS_S", "SPAN_MS_BUCKETS",
    "JsonlSink", "read_spans",
    "exposition", "render", "render_prometheus", "merge_payloads",
    "audit_spans", "audit_jsonl", "guard_cost",
    "compile_event", "track_compile", "compile_guard",
    "pin_compile_census",
    "compile_site_stats", "compile_stats", "compile_events",
    "compile_gauges", "reset_compiles", "memory_gauges", "ckpt_gauges",
    "FlightRecorder", "flight", "enable_flight", "flight_from_env",
    "flight_trip", "FLIGHT_ENV", "maybe_trace",
]

SCHEMA = "mxtpu.telemetry/1"


def now_us():
    """Microsecond timestamp on the profiler's timebase
    (``time.perf_counter``) so request spans and profiler events share
    one Chrome-trace timeline."""
    return time.perf_counter() * 1e6


# ===================================================================== state
class _Config:
    """Tracer configuration; one instance per process (``config()``)."""

    def __init__(self):
        self.sample = 1.0
        self.sink = None               # JsonlSink for finished spans
        self.collect = False           # keep finished Trace objects
        self.collected = collections.deque(maxlen=4096)
        self.export_profiler = True    # mirror spans into profiler events
        self.errors = 0                # tracer-internal swallowed failures


_CFG = _Config()
# THE off-switch: a single module attribute the instrumentation sites
# check before allocating anything.  False = the serving hot path pays
# one attribute read per request.
ACTIVE = False

_ids = itertools.count(1)
_tls = threading.local()               # .stack: current-span tuples


def config():
    return _CFG


def enable(sample=1.0, sink=None, collect=False, collect_limit=4096,
           export_profiler=True):
    """Arm request tracing process-wide.

    ``sample`` ∈ [0, 1] is the per-trace sampling probability (1.0 =
    every accepted request, 0.0 = none — metrics keep flowing either
    way).  ``sink`` is a ``JsonlSink`` or a path; finished traces write
    one JSONL line per span there.  ``collect=True`` additionally keeps
    finished ``Trace`` objects in memory (bounded by ``collect_limit``)
    for tests and audits.  Also installs the ``fault.fire`` observer so
    fault firings land as span events."""
    global ACTIVE
    _CFG.sample = float(sample)
    if sink is not None and not isinstance(sink, JsonlSink):
        sink = JsonlSink(sink)
    old = _CFG.sink
    if old is not None and old is not sink:
        try:                           # re-arming must not leak the
            old.close()                # previous sink's descriptor
        except Exception:
            _oops()
    _CFG.sink = sink
    _CFG.collect = bool(collect)
    _CFG.collected = collections.deque(maxlen=int(collect_limit))
    _CFG.export_profiler = bool(export_profiler)
    try:    # package mode only; standalone (launcher) has no fault twin
        from . import fault as _fault
        _fault.set_observer(note_fault)
    except ImportError:
        pass
    ACTIVE = True
    return _CFG


def disable():
    """The hard off-switch: new requests are not traced (in-flight
    traced requests still complete their trees — the audit contract
    survives a mid-storm disable)."""
    global ACTIVE
    ACTIVE = False


def enabled():
    return ACTIVE


def finished_traces(clear=False):
    """Finished ``Trace`` objects kept by ``enable(collect=True)``."""
    out = list(_CFG.collected)
    if clear:
        _CFG.collected.clear()
    return out


def _sampled():
    s = _CFG.sample
    if s >= 1.0:
        return True
    if s <= 0.0:
        return False
    return _random.random() < s


class suppress:
    """``with telemetry.suppress():`` — front-door requests submitted
    inside are NOT traced (thread-local, re-entrant).  For
    infrastructure traffic that is not a client request: the fleet's
    quarantine and rolling-update probes ride the full serving path by
    design, but their trees would pollute the per-phase latency
    histograms (a probe queued into a dead replica records its whole
    quarantine wait as ``queue_ms``) and break the trees ==
    accepted-client-requests accounting ``chaos_check --mode obs``
    audits.  Explicit ``trace_parent`` continuations are unaffected."""

    def __enter__(self):
        _tls.suppress = getattr(_tls, "suppress", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.suppress -= 1
        return False


def _suppressed():
    return getattr(_tls, "suppress", 0) > 0


def _oops():
    """Count a swallowed tracer-internal failure (never re-raised on a
    serving thread — a tracer exception must never fail a request)."""
    _CFG.errors += 1


# ====================================================================== spans
class Span:
    """One timed region of a trace.  ``t1 is None`` = still open.
    Mutated only by the thread that owns the region at the time (the
    serving handoff points are the same queue/future handoffs that
    synchronise the request itself); appends to ``events`` are
    GIL-atomic list appends."""

    __slots__ = ("trace", "sid", "parent_id", "name", "t0", "t1", "tid",
                 "attrs", "events")

    def __init__(self, trace, name, parent_id=None, t0=None, attrs=None):
        self.trace = trace
        self.sid = next(_ids)
        self.parent_id = parent_id
        self.name = name
        self.t0 = now_us() if t0 is None else t0
        self.t1 = None
        self.tid = threading.get_ident()
        self.attrs = dict(attrs) if attrs else {}
        self.events = []

    @property
    def dur_us(self):
        return None if self.t1 is None else self.t1 - self.t0

    def end(self, t1=None, **attrs):
        if self.t1 is None:
            self.t1 = now_us() if t1 is None else t1
        if attrs:
            self.attrs.update(attrs)
        return self

    def event(self, name, **attrs):
        self.events.append({"t_us": now_us(), "name": str(name),
                            **({"attrs": attrs} if attrs else {})})

    def record(self):
        """The export form — the JSONL line body and the audit input."""
        return {"kind": "span", "name": self.name, "trace": self.trace.trace_id,
                "span": self.sid, "parent": self.parent_id,
                "server": self.trace.server, "t0_us": self.t0,
                "dur_us": self.dur_us, "tid": self.tid,
                "attrs": dict(self.attrs), "events": list(self.events)}


class Trace:
    """One request's span tree.  Created by ``begin_request`` on the
    accepting server (or by hand for tests); ``finish()`` exports every
    span to the configured sink, the profiler's Chrome-trace stream,
    and the per-phase latency histograms.  Span appends are GIL-atomic
    list appends — the tracer takes no lock on the serving hot path."""

    __slots__ = ("trace_id", "server", "root", "spans", "finished")

    def __init__(self, name="request", server="", t0=None, attrs=None):
        self.trace_id = f"{os.getpid():x}-{next(_ids):x}"
        self.server = str(server)
        self.spans = []
        self.finished = False
        self.root = self.open(name, parent=None, t0=t0, **(attrs or {}))

    def open(self, name, parent=None, t0=None, **attrs):
        """Open a child span.  ``parent`` is a ``Span`` (None = a root
        for this trace — only the constructor passes that)."""
        pid = None if parent is None else parent.sid
        sp = Span(self, str(name), parent_id=pid, t0=t0, attrs=attrs)
        self.spans.append(sp)
        return sp

    def records(self):
        return [sp.record() for sp in list(self.spans)]

    def finish(self):
        """Export once.  Runs on whatever thread resolved the request;
        every failure is swallowed (tracer exceptions never fail a
        request)."""
        if self.finished:
            return
        self.finished = True
        reg = _REGISTRY
        for sp in list(self.spans):
            if sp.t1 is None:          # defensive: audit wants closure
                sp.end()
            try:
                reg.histogram(f"{self.server}::{sp.name}_ms",
                              SPAN_MS_BUCKETS).observe(sp.dur_us / 1e3)
            except Exception:
                _oops()
        sink = _CFG.sink
        if sink is not None:
            try:
                for rec in self.records():
                    sink.write(rec.pop("kind"), rec.pop("name"), **rec)
            except Exception:
                _oops()
        if _CFG.export_profiler:
            try:
                self._export_profiler()
            except Exception:
                _oops()
        if _FLIGHT.enabled:
            try:
                for rec in self.records():
                    rec.pop("kind", None)
                    _FLIGHT.record("span", rec.pop("name"), **rec)
            except Exception:
                _oops()
        if _CFG.collect:
            _CFG.collected.append(self)

    def _export_profiler(self):
        """Mirror the finished tree into the profiler's event buffer so
        request spans land on the SAME Chrome-trace timeline as the
        profiler's own spans and counters (no-op unless the profiler is
        recording)."""
        from . import profiler as _profiler
        if not _profiler.ACTIVE:
            return
        pid = os.getpid()
        events = []
        for sp in list(self.spans):
            events.append({
                "name": f"{self.server}.{sp.name}" if self.server
                else sp.name,
                "ph": "X", "ts": sp.t0, "dur": sp.dur_us, "pid": pid,
                "tid": sp.tid, "cat": "trace",
                "args": {"trace": self.trace_id, "span": sp.sid,
                         "parent": sp.parent_id, **sp.attrs}})
            for ev in sp.events:
                events.append({"name": ev["name"], "ph": "i",
                               "ts": ev["t_us"], "pid": pid,
                               "tid": sp.tid, "s": "t", "cat": "trace",
                               "args": {"trace": self.trace_id,
                                        "span": sp.sid}})
        _profiler.ingest_events(events)


def maybe_trace(name, server="", t0=None, attrs=None):
    """A fresh ``Trace`` honoring the off-switch, suppression, and the
    sampling rate — or None.  The non-request spelling of
    ``begin_request`` (training-step spans use it: there is no Request
    future to carry the trace, the emitting loop owns the whole
    lifecycle and calls ``finish()`` itself)."""
    if not ACTIVE or _suppressed() or not _sampled():
        return None
    try:
        return Trace(name, server=server, t0=t0, attrs=attrs)
    except Exception:
        _oops()
        return None


# ------------------------------------------------- request instrumentation --
# The serving stack carries trace state on ``admission.Request``:
# ``req.trace`` (the Trace, or None — THE downstream guard) and
# ``req.tspans`` (open spans by phase key; allocated only when traced).
# "_c" is the request's container: the trace root for a front-door
# request, or the fleet's dispatch span for a replica-side sub-request.

def begin_request(req, server, t0_us=None, parent=None, queue=True):
    """Start (or continue) tracing one accepted request.

    ``parent=None``: front door — a fresh ``Trace`` is born (subject to
    sampling) whose root opened at ``t0_us`` (the submit entry stamp),
    with the admission work recorded as a closed ``admit`` span and
    (``queue=True``) a ``queue`` span left open for the batch/decode
    thread to close.  ``parent=<Span>``: a fleet dispatch handing the
    payload to a replica — the replica's spans attach under that span,
    in the SAME trace, and resolution closes the dispatch span instead
    of the root.  The fleet front door passes ``queue=False`` (its
    request goes straight to routing; waits between hops are
    ``failover`` spans)."""
    try:
        if parent is None:
            if _suppressed() or not _sampled():
                return None
            tr = Trace("request", server=server, t0=t0_us)
            container = tr.root
        else:
            tr = parent.trace
            container = parent
        req.trace = tr
        now = now_us()
        tr.open("admit", parent=container,
                t0=t0_us if t0_us is not None else now).end(now)
        req.tspans = {"_c": container}
        if queue:
            req.tspans["queue"] = tr.open("queue", parent=container)
        req.add_done_callback(_request_done)
        return tr
    except Exception:
        _oops()
        return None


def abort_request(req, error=None):
    """Detach tracing from a request REFUSED after ``begin_request``
    (the admission paths that raise without ever resolving the
    future).  Open spans close now so that — when the request was
    parented into a fleet trace — nothing dangles in the caller's tree;
    an unparented (front-door) trace is simply never exported."""
    tr = req.trace
    if tr is None:
        return
    try:
        now = now_us()
        for sp in list(req.tspans.values()):
            if sp.t1 is None:
                sp.end(now)
        if error is not None:
            req.tspans["_c"].attrs.setdefault("error",
                                              type(error).__name__)
        req.trace = None               # _request_done becomes a no-op
    except Exception:
        _oops()


def _request_done(req):
    """Done-callback closing a traced request's tree: stragglers are
    auto-closed (robustness — the AUDIT checks parenting + attribution,
    the sweep guarantees closure even on error paths), the container
    gets the terminal verdict, and a root container finishes the trace
    (export)."""
    try:
        tr = req.trace
        if tr is None:
            return
        spans = req.tspans
        container = spans.get("_c")
        now = now_us()
        for key, sp in list(spans.items()):
            if key != "_c" and sp.t1 is None:
                sp.end(now)
        err = req.exception(timeout=0)
        if container.t1 is None:
            container.end(now)
        if err is not None:
            container.attrs.setdefault("error", type(err).__name__)
        if container is tr.root:
            tr.finish()
    except Exception:
        _oops()


def open_span(req, key, name=None, parent=None, **attrs):
    """Open phase span ``key`` on a traced request (no-op and None when
    the request is untraced).  Parent defaults to the request's
    container."""
    tr = req.trace
    if tr is None:
        return None
    try:
        spans = req.tspans
        if parent is None:
            parent = spans.get("_c", tr.root)
        sp = tr.open(name or key, parent=parent, **attrs)
        spans[key] = sp
        return sp
    except Exception:
        _oops()
        return None


def end_span(req, key, **attrs):
    """Close phase span ``key`` if open (no-op when untraced/absent)."""
    if req.trace is None:
        return
    try:
        sp = req.tspans.get(key)
        if sp is not None and sp.t1 is None:
            sp.end(**attrs)
    except Exception:
        _oops()


def get_span(req, key):
    if req.trace is None:
        return None
    return req.tspans.get(key)


def span_event(req, name, key="_c", **attrs):
    """Attach an instant event to a traced request's ``key`` span."""
    if req.trace is None:
        return
    try:
        sp = req.tspans.get(key) or req.tspans.get("_c")
        if sp is not None:
            sp.event(name, **attrs)
    except Exception:
        _oops()


# ------------------------------------------------------ current-span stack --
def push_current(spans):
    """Declare ``spans`` the thread's current fault-event targets (the
    batch/decode thread pushes the in-flight group's spans around the
    region whose ``fault.fire`` points should land as span events)."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(tuple(spans))


def pop_current():
    stack = getattr(_tls, "stack", None)
    if stack:
        stack.pop()


class use_spans:
    """``with use_spans([...]):`` — context-manager form of
    ``push_current``/``pop_current``."""

    def __init__(self, spans):
        self._spans = spans

    def __enter__(self):
        push_current(self._spans)
        return self

    def __exit__(self, *exc):
        pop_current()
        return False


def note_fault(point):
    """``fault.fire`` observer: record an armed fault actually firing as
    an event on every current span (installed by ``enable()``) and into
    the flight-recorder ring (the post-mortem must show what was armed
    and fired in the seconds before the trip)."""
    _FLIGHT.record("fault", point)
    stack = getattr(_tls, "stack", None)
    if not stack:
        return
    for sp in stack[-1]:
        try:
            sp.event("fault", point=point)
        except Exception:
            _oops()


def guard_cost(iters=200_000):
    """Measured per-call cost (seconds) of the off-switch guard the
    instrumentation sites pay when tracing is off — one module
    attribute read plus a branch.  ``chaos_check --mode obs`` scales
    this by the guards-per-request count to bound the off-path
    overhead (< 5% of request latency) deterministically instead of
    through noisy A/B wall-clock runs.  The best of five rounds of
    ``iters`` calls: time the process spends preempted on a loaded host
    only adds to a round."""
    g = globals()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(iters):
            if g["ACTIVE"]:
                pass
        best = min(best, time.perf_counter() - t0)
    return best / iters


# ==================================================================== metrics
def log_buckets(lo, hi, per_decade=8):
    """Fixed log-spaced histogram bucket upper bounds from ``lo`` up to
    (at least) ``hi`` — the one bucket layout of the stack, so any two
    snapshots of the same series are mergeable bucket-for-bucket."""
    import math
    if lo <= 0 or hi <= lo:
        raise ValueError(f"log_buckets: need 0 < lo < hi, got {lo}, {hi}")
    n = math.ceil(per_decade * math.log10(hi / lo))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


# seconds — admission.ClassStats latencies (0.1 ms .. 2 min)
LATENCY_BUCKETS_S = log_buckets(1e-4, 120.0)
# milliseconds — span-phase durations (1 µs .. 60 s)
SPAN_MS_BUCKETS = log_buckets(1e-3, 6e4)


class Counter:
    """Monotonic counter (thread-safe)."""

    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0

    def add(self, n=1):
        with self._lock:
            self._v += n

    inc = add

    @property
    def value(self):
        return self._v


class Gauge:
    """Point-in-time value with atomic add/set (the substrate of the
    ``profiler.Counter`` shim — its increment/decrement/set_value map
    onto ``add``/``set`` of ONE shared gauge per series name, so the
    profiler and the telemetry exposition can never disagree)."""

    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name, value=0):
        self.name = name
        self._lock = threading.Lock()
        self._v = value

    def set(self, v):
        self._v = v

    def add(self, n=1):
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v


class Histogram:
    """Fixed-bucket histogram: ``bounds`` upper edges plus an overflow
    bucket.  Snapshots are mergeable (same bounds ⇒ element-wise count
    sum) and quantiles interpolate inside the landing bucket."""

    __slots__ = ("name", "bounds", "_lock", "_counts", "_sum", "_n")

    def __init__(self, name, bounds=None):
        self.name = name
        self.bounds = tuple(bounds if bounds is not None
                            else LATENCY_BUCKETS_S)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._n = 0

    def observe(self, v):
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self):
        return self._n

    def snapshot(self):
        with self._lock:
            return {"bounds": list(self.bounds),
                    "counts": list(self._counts),
                    "sum": self._sum, "count": self._n}

    def quantile(self, q):
        return histogram_quantile(self.snapshot(), q)


def histogram_quantile(snap, q):
    """Interpolated quantile from a histogram snapshot (None when
    empty).  Linear interpolation inside the landing bucket keeps
    nearby distributions ordered even when they share buckets; the
    overflow bucket reports the largest bound."""
    counts, bounds = snap["counts"], snap["bounds"]
    total = sum(counts)
    if total == 0:
        return None
    rank = max(0.0, min(1.0, q)) * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c and cum + c >= rank:
            if i >= len(bounds):           # overflow: no upper edge
                return bounds[-1]
            lo = 0.0 if i == 0 else bounds[i - 1]
            return lo + ((rank - cum) / c) * (bounds[i] - lo)
        cum += c
    return bounds[-1]


def merge_snapshots(snaps):
    """Merge histogram snapshots of one series (same bounds ⇒ summed
    counts; a bounds mismatch keeps the larger-count side — merging
    incompatible layouts would fabricate data)."""
    snaps = [s for s in snaps if s]
    if not snaps:
        return None
    out = {"bounds": list(snaps[0]["bounds"]),
           "counts": list(snaps[0]["counts"]),
           "sum": snaps[0]["sum"], "count": snaps[0]["count"]}
    for s in snaps[1:]:
        if list(s["bounds"]) != out["bounds"]:
            if s["count"] > out["count"]:
                out = {"bounds": list(s["bounds"]),
                       "counts": list(s["counts"]),
                       "sum": s["sum"], "count": s["count"]}
            continue
        out["counts"] = [a + b for a, b in zip(out["counts"], s["counts"])]
        out["sum"] += s["sum"]
        out["count"] += s["count"]
    return out


class MetricsRegistry:
    """Name → metric-object registry with get-or-create semantics and
    prefix-scoped snapshots.  ``registry()`` is the process default the
    profiler shim, span histograms, and the server expositions share;
    tests may build private instances."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get(self, name, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name):
        return self._get(name, Gauge)

    def histogram(self, name, bounds=None):
        return self._get(name, Histogram, bounds)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def remove(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self, prefix=None):
        """Drop series (all, or names starting with ``prefix``) — the
        teardown twin of ``profiler.counters_clear``."""
        with self._lock:
            for name in [n for n in self._metrics
                         if prefix is None or n.startswith(prefix)]:
                del self._metrics[name]

    def snapshot(self, prefix=None, strip=True):
        """``{"counters": {...}, "gauges": {...}, "histograms": {...}}``
        over the (prefix-filtered) series; ``strip`` removes the prefix
        from the reported names so per-server payloads share one key
        schema."""
        with self._lock:
            items = list(self._metrics.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in items:
            if prefix is not None:
                if not name.startswith(prefix):
                    continue
                if strip:
                    name = name[len(prefix):]
            if isinstance(m, Histogram):
                out["histograms"][name] = m.snapshot()
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["counters"][name] = m.value
        return out


_REGISTRY = MetricsRegistry()


def registry():
    """The process-default ``MetricsRegistry``."""
    return _REGISTRY


# ================================================================= JSONL sink
class JsonlSink:
    """One JSONL event stream for the whole stack
    (the elastic ``EventLog``, the autoscaler log, and trace export all
    ride this).  Shared schema: every record carries ``ts`` (epoch
    seconds), ``mono`` (``time.monotonic`` — the stamp autoscale events
    previously lacked), ``kind``, and ``name``.  Writes are atomic at
    line granularity (one lock around the write+flush — interleaved
    half-lines cannot happen) and the file rotates to ``<path>.1`` when
    it exceeds ``max_bytes``."""

    def __init__(self, path=None, max_bytes=None):
        self.path = None if path is None else str(path)
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self._lock = threading.Lock()
        self._f = open(self.path, "a") if self.path else None

    def write(self, kind, name=None, **fields):
        rec = {"ts": round(time.time(), 6),
               "mono": round(time.monotonic(), 6),
               "kind": str(kind),
               "name": None if name is None else str(name)}
        rec.update(fields)
        if self._f is not None:
            line = json.dumps(rec, sort_keys=True, default=str)
            with self._lock:
                if self._f is None:      # closed under us
                    return rec
                self._f.write(line + "\n")
                self._f.flush()
                if self.max_bytes is not None \
                        and self._f.tell() >= self.max_bytes:
                    self._rotate_locked()
        return rec

    def _rotate_locked(self):
        self._f.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass                         # rotation is best-effort
        self._f = open(self.path, "a")

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def read_spans(path):
    """Parse a trace-export JSONL file back into
    ``{trace_id: [span records]}`` — the round-trip the Chrome-trace
    validity tests and ``chaos_check --mode obs`` run."""
    traces = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("kind") != "span":
                continue
            traces.setdefault(rec["trace"], []).append(rec)
    return traces


# ================================================================ exposition
def exposition(kind, name, counters=None, gauges=None, histograms=None,
               classes=None):
    """The ONE telemetry payload schema every runtime serves (identical
    keys on ``InferenceServer`` / ``GenerationServer`` / ``ServingFleet``
    / ``FleetAutoscaler`` / ``Supervisor`` — routers and scrapers never
    branch on the runtime kind)."""
    return {"schema": SCHEMA, "kind": str(kind), "name": str(name),
            "counters": dict(counters or {}), "gauges": dict(gauges or {}),
            "histograms": dict(histograms or {}),
            "classes": dict(classes or {})}


def merge_payloads(payloads):
    """Aggregate exposition payloads (a fleet over its replicas):
    counters and gauges sum, histograms merge bucket-wise."""
    counters, gauges, hists = {}, {}, {}
    for p in payloads:
        for k, v in p.get("counters", {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, v in p.get("gauges", {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                gauges[k] = gauges.get(k, 0) + v
        for k, v in p.get("histograms", {}).items():
            hists.setdefault(k, []).append(v)
    return {"counters": counters, "gauges": gauges,
            "histograms": {k: merge_snapshots(v) for k, v in hists.items()}}


def render(payload, fmt="json"):
    """Render one exposition payload — the shared tail of every
    runtime's ``telemetry()`` method: ``fmt="json"`` returns the
    payload as-is, ``fmt="prom"`` the Prometheus-style text form."""
    if fmt == "prom":
        return render_prometheus(payload)
    if fmt != "json":
        raise ValueError(f"telemetry: fmt={fmt!r} (expected 'json' or "
                         f"'prom')")
    return payload


def _prom_name(s):
    out = "".join(c if c.isalnum() else "_" for c in str(s))
    return out if not out[:1].isdigit() else "_" + out


def render_prometheus(payload, prefix="mxtpu"):
    """Prometheus-style text form of one exposition payload."""
    labels = f'kind="{payload["kind"]}",name="{payload["name"]}"'
    lines = []
    for k, v in sorted(payload["counters"].items()):
        lines.append(f"{prefix}_{_prom_name(k)}_total{{{labels}}} {v}")
    for k, v in sorted(payload["gauges"].items()):
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, (int, float)):
            lines.append(f"{prefix}_{_prom_name(k)}{{{labels}}} {v}")
    for k, h in sorted(payload["histograms"].items()):
        if not h:
            continue
        base = f"{prefix}_{_prom_name(k)}"
        cum = 0
        for bound, c in zip(h["bounds"], h["counts"]):
            cum += c
            lines.append(f'{base}_bucket{{{labels},le="{bound:g}"}} {cum}')
        cum += h["counts"][-1]
        lines.append(f'{base}_bucket{{{labels},le="+Inf"}} {cum}')
        lines.append(f"{base}_sum{{{labels}}} {h['sum']}")
        lines.append(f"{base}_count{{{labels}}} {h['count']}")
    for cname, row in sorted(payload["classes"].items()):
        clabels = f'{labels},class="{cname}"'
        for k, v in sorted(row.items()):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                lines.append(
                    f"{prefix}_class_{_prom_name(k)}{{{clabels}}} {v}")
    return "\n".join(lines) + "\n"


# ===================================================================== audit
def audit_spans(spans, rel_tol=0.25, abs_slack_us=75_000.0,
                contain_slack_us=5_000.0):
    """Audit ONE trace's span records for completeness and latency
    attribution.  Returns a list of problem strings (empty = clean):

    - exactly one root (``parent is None``), every span closed;
    - every ``parent`` id exists, children contained in their parent's
      window (± ``contain_slack_us``);
    - for every span with children, the children's summed durations
      account for the span's own duration within
      ``max(rel_tol * dur, abs_slack_us)`` — the "where did the time
      go" contract: admit + queue + coalesce + step + deliver ≈ e2e.

    ``spans`` is a list of ``Span.record()`` dicts or ``Span`` objects
    (or a ``Trace``)."""
    if isinstance(spans, Trace):
        spans = spans.records()
    recs = [s.record() if isinstance(s, Span) else s for s in spans]
    problems = []
    by_id = {r["span"]: r for r in recs}
    roots = [r for r in recs if r["parent"] is None]
    if len(roots) != 1:
        problems.append(f"expected exactly 1 root span, found "
                        f"{len(roots)} of {len(recs)}")
    children = {}
    for r in recs:
        if r["dur_us"] is None:
            problems.append(f"span {r['name']!r} (#{r['span']}) never "
                            f"closed")
            continue
        p = r["parent"]
        if p is None:
            continue
        parent = by_id.get(p)
        if parent is None:
            problems.append(f"span {r['name']!r} (#{r['span']}) parent "
                            f"#{p} does not exist in the trace")
            continue
        children.setdefault(p, []).append(r)
        if parent["dur_us"] is None:
            continue
        if r["t0_us"] < parent["t0_us"] - contain_slack_us:
            problems.append(
                f"span {r['name']!r} starts "
                f"{(parent['t0_us'] - r['t0_us']) / 1e3:.2f} ms before "
                f"its parent {parent['name']!r}")
        if r["t0_us"] + r["dur_us"] > parent["t0_us"] \
                + parent["dur_us"] + contain_slack_us:
            problems.append(
                f"span {r['name']!r} ends after its parent "
                f"{parent['name']!r}")
    for pid, kids in children.items():
        parent = by_id[pid]
        if parent["dur_us"] is None:
            continue
        covered = sum(k["dur_us"] for k in kids if k["dur_us"] is not None)
        tol = max(rel_tol * parent["dur_us"], abs_slack_us)
        if abs(covered - parent["dur_us"]) > tol:
            problems.append(
                f"span {parent['name']!r} ({parent['dur_us'] / 1e3:.2f} "
                f"ms) vs children sum {covered / 1e3:.2f} ms — "
                f"attribution off by more than "
                f"{tol / 1e3:.2f} ms ({[k['name'] for k in kids]})")
    return problems


def audit_jsonl(path, **kw):
    """``audit_spans`` over every trace in a JSONL export.  Returns
    ``{trace_id: [problems]}`` for the traces that failed."""
    bad = {}
    for tid, spans in read_spans(path).items():
        problems = audit_spans(spans, **kw)
        if problems:
            bad[tid] = problems
    return bad


# ========================================================== compile stream
# the ONE chokepoint every compile path reports through.  An
# *event* is an executable coming into existence (sum of events == the
# static census == the runtime jit-cache count); a cache HIT only bumps a
# counter — emitting per-step hit records would flood the flight ring
# with the steady state the ring exists to contextualize.

class _CompileSite:
    """Per-site compile accounting (site = one runtime's jit boundary)."""

    __slots__ = ("n", "pinned", "hits", "misses", "ms_total", "unexpected")

    def __init__(self):
        self.n = 0               # executables created at this site
        self.pinned = None       # post-warmup census; misses past it are
        self.hits = 0            # unexpected recompiles
        self.misses = 0
        self.ms_total = 0.0
        self.unexpected = 0


_COMPILE_LOCK = threading.Lock()
_COMPILE_SITES = {}
_COMPILE_EVENTS = collections.deque(maxlen=1024)


def compile_event(site, key=None, ms=None, cache_hit=False,
                  n_executables=None, **attrs):
    """Record one compile-boundary observation at ``site``.

    ``cache_hit=True`` increments the site's hit counter and returns
    None (no event record).  Otherwise one event is recorded: a new
    executable exists — ``key`` is a short signature label, ``ms`` the
    wall time of the compiling call, ``n_executables`` the site's cache
    size after (default: previous count + 1).  A miss past the site's
    ``pin_compile_census`` count is an *unexpected recompile*: it
    increments the ``compile::recompiles_unexpected`` counter and lands
    a ``recompile`` span event on the thread's current spans (the same
    channel fault firings use), because a post-warmup compile stall is
    a production incident, not bookkeeping."""
    site = str(site)
    with _COMPILE_LOCK:
        st = _COMPILE_SITES.get(site)
        if st is None:
            st = _COMPILE_SITES[site] = _CompileSite()
        if cache_hit:
            st.hits += 1
            unexpected = False
        else:
            st.misses += 1
            st.n = int(n_executables) if n_executables is not None \
                else st.n + 1
            if ms is not None:
                st.ms_total += float(ms)
            unexpected = st.pinned is not None and st.n > st.pinned
            if unexpected:
                st.unexpected += 1
        n_after = st.n
        if not cache_hit:
            rec = {"site": site, "key": key,
                   "ms": None if ms is None else round(float(ms), 3),
                   "n_executables": n_after, "unexpected": unexpected}
            if attrs:
                rec["attrs"] = attrs
            # the recent-events deque is read by scraper threads
            # (compile_events) — append under the same lock so a
            # concurrent reader never sees a mid-iteration mutation
            _COMPILE_EVENTS.append(rec)
    reg = _REGISTRY
    try:
        reg.counter("compile::cache_hits" if cache_hit
                    else "compile::cache_misses").add()
        if not cache_hit:
            # events == executables created == misses, everywhere: the
            # registry counter must agree with compile_stats()["events"]
            # and the documented sum(events) == census invariant
            reg.counter("compile::events").add()
            if ms is not None:
                reg.counter("compile::ms_total").add(float(ms))
            reg.gauge(f"compile_cache::{site}").set(n_after)
            if unexpected:
                reg.counter("compile::recompiles_unexpected").add()
    except Exception:
        _oops()
    if cache_hit:
        return None
    if unexpected:
        stack = getattr(_tls, "stack", None)
        if stack:
            for sp in stack[-1]:
                try:
                    sp.event("recompile", site=site, key=key)
                except Exception:
                    _oops()
    sink = _CFG.sink
    if sink is not None:
        try:
            sink.write("compile", site, **{k: v for k, v in rec.items()
                                           if k != "site"})
        except Exception:
            _oops()
    _FLIGHT.record("compile", site, **{k: v for k, v in rec.items()
                                       if k != "site"})
    return rec


def pin_compile_census(site, n=None):
    """Declare ``site``'s executable count final (the post-warmup
    census).  ``n=None`` pins at whatever the site has accumulated —
    the warmup-tail spelling.  Every later miss is an unexpected
    recompile (see ``compile_event``)."""
    site = str(site)
    with _COMPILE_LOCK:
        st = _COMPILE_SITES.get(site)
        if st is None:
            st = _COMPILE_SITES[site] = _CompileSite()
        st.pinned = st.n if n is None else int(n)
        return st.pinned


def compile_site_stats(site):
    """One site's compile accounting (zeros for a site never seen)."""
    with _COMPILE_LOCK:
        st = _COMPILE_SITES.get(str(site))
        if st is None:
            return {"n_executables": 0, "pinned": None, "hits": 0,
                    "misses": 0, "ms_total": 0.0, "unexpected": 0}
        return {"n_executables": st.n, "pinned": st.pinned,
                "hits": st.hits, "misses": st.misses,
                "ms_total": st.ms_total, "unexpected": st.unexpected}


def compile_stats():
    """Process-wide compile-stream totals (the BENCH-line columns)."""
    with _COMPILE_LOCK:
        sites = dict(_COMPILE_SITES)
        out = {"events": 0, "hits": 0, "misses": 0, "ms_total": 0.0,
               "unexpected": 0, "sites": {}}
        for name, st in sites.items():
            out["hits"] += st.hits
            out["misses"] += st.misses
            out["ms_total"] += st.ms_total
            out["unexpected"] += st.unexpected
            out["sites"][name] = st.n
        out["events"] = out["misses"]
        return out


def compile_events(clear=False):
    """Recent compile-event records (one per executable created)."""
    with _COMPILE_LOCK:
        out = list(_COMPILE_EVENTS)
        if clear:
            _COMPILE_EVENTS.clear()
    return out


def compile_gauges(site):
    """The ``compile_*`` gauge family one runtime's exposition serves —
    identical keys on every runtime so scrapers never branch."""
    st = compile_site_stats(site)
    return {"compile_executables": st["n_executables"],
            "compile_cache_hits": st["hits"],
            "compile_cache_misses": st["misses"],
            "compile_ms_total": round(st["ms_total"], 3),
            "recompiles_unexpected": st["unexpected"]}


def reset_compiles():
    """Forget every site, recent event, and probe high-water mark (test
    isolation; the registry counters are cleared separately via
    ``registry().clear()``)."""
    with _COMPILE_LOCK:
        _COMPILE_SITES.clear()
        _COMPILE_EVENTS.clear()
    with _PROBE_LOCK:
        _PROBE_HW.clear()


# High-water marks of probed jit caches: concurrent dispatch of an
# uncompiled signature through ONE shared jit fn (fleet replicas over a
# shared HotSwapApply, a lazy GenerationServer's prefill workers) would
# otherwise let BOTH in-flight probes observe the same cache growth and
# double-count the compile.  Weak keys: the mark dies with the fn.
_PROBE_LOCK = threading.Lock()
_PROBE_HW = weakref.WeakKeyDictionary()


class track_compile:
    """``with track_compile(site, jit_fn, key=...):`` around a call that
    may compile.  When the tracer is off this is a no-op (nothing is
    probed or recorded).  With a jit wrapper (anything exposing
    ``_cache_size``) or an explicit ``probe`` callable, the cache size
    is read before/after: growth emits one ``compile_event`` per new
    executable with the block's wall-ms split between them, no growth
    records a hit — growth another concurrent tracked block already
    claimed is deduplicated through a per-fn high-water mark (pass
    ``hw_key`` with ``probe`` to name the owning object; a ``jit_fn``
    is its own key).  Without a probe, ``assume_miss`` decides (the
    signature-tracking servers know whether a payload shape is new
    before dispatching it), except when the block raised — a failed
    dispatch proves no executable exists."""

    __slots__ = ("_site", "_key", "_assume", "_probe", "_on", "_t0",
                 "_n0", "_hw_key")

    def __init__(self, site, jit_fn=None, key=None, assume_miss=False,
                 probe=None, hw_key=None):
        self._site = site
        self._key = key
        self._assume = bool(assume_miss)
        if probe is None and jit_fn is not None:
            probe = getattr(jit_fn, "_cache_size", None)
        self._probe = probe if callable(probe) else None
        self._hw_key = hw_key if hw_key is not None else jit_fn

    def __enter__(self):
        self._on = ACTIVE
        if not self._on:
            return self
        self._t0 = time.perf_counter()
        self._n0 = None
        if self._probe is not None:
            try:
                self._n0 = int(self._probe())
            except Exception:
                self._probe = None
                _oops()
        return self

    def _probe_growth(self):
        """Cache growth this block may claim (serialized; high-water
        deduped so a concurrent observer of the same compile records a
        hit, not a second event)."""
        with _PROBE_LOCK:
            n1 = int(self._probe())
            base = self._n0
            if self._hw_key is not None:
                try:
                    hw = _PROBE_HW.get(self._hw_key, 0)
                    base = max(base, hw)
                    _PROBE_HW[self._hw_key] = max(hw, n1)
                except TypeError:      # not weakref-able: no dedupe
                    pass
            return n1 - base

    def __exit__(self, *exc):
        if not self._on:
            return False
        try:
            ms = (time.perf_counter() - self._t0) * 1e3
            if self._probe is not None and self._n0 is not None:
                # delta-based: accurate even when the call raised (a
                # compile that completed before the failure still counts)
                grew = self._probe_growth()
                if grew <= 0:
                    compile_event(self._site, key=self._key,
                                  cache_hit=True)
                else:
                    for _ in range(grew):
                        compile_event(self._site, key=self._key,
                                      ms=ms / grew)
            elif exc and exc[0] is not None:
                # probe-less + the call raised: nothing proves an
                # executable exists.  Recording the assumed miss would
                # double-count every retry of a failing new signature
                # (the caller re-assumes until a dispatch SUCCEEDS and
                # commits the signature), drifting the site count past
                # the census and falsely tripping recompiles_unexpected.
                pass
            elif self._assume:
                compile_event(self._site, key=self._key, ms=ms)
            else:
                compile_event(self._site, key=self._key, cache_hit=True)
        except Exception:
            _oops()
        return False


# one shared, stateless null context: the dark-path stand-in for
# track_compile, so untraced hot loops (per-token decode, per-step train
# dispatch) allocate NOTHING — the off-switch contract
_DARK_GUARD = contextlib.nullcontext()


def compile_guard(site, jit_fn=None, key=None):
    """``track_compile`` when the tracer is armed, one shared null
    context when it is dark — the guard every compile call site wraps
    its possibly-compiling dispatch in."""
    if ACTIVE:
        return track_compile(site, jit_fn, key=key)
    return _DARK_GUARD


def memory_gauges(report=None):
    """Flatten a costguard-style memory report (``argument_bytes`` /
    ``peak_bytes`` + the sharded ``per_device`` section) into the
    ``mem_*`` gauge family the serving expositions stamp at warmup —
    zeros when no report has been stamped, so the key schema is uniform
    whether or not a deployment wires costguard in."""
    report = report or {}
    pd = report.get("per_device") or {}

    def val(d, k):
        v = d.get(k)
        return 0 if v is None else v

    return {"mem_argument_bytes": val(report, "argument_bytes"),
            "mem_peak_bytes": val(report, "peak_bytes"),
            "mem_per_device_argument_bytes": val(pd, "argument_bytes"),
            "mem_per_device_peak_bytes": val(pd, "peak_bytes")}


def ckpt_gauges():
    """The ``ckpt_*`` gauge family every runtime's exposition
    serves — snapshot-stream health read straight off the registry, so
    the keys exist (as zeros) even before the first checkpoint:
    ``ckpt_last_snapshot_ms`` (step-loop stall of the last save — full
    write when sync, fetch only when async), ``ckpt_bytes`` (payload
    bytes of the last committed snapshot), ``ckpt_pending_writes``
    (async writes in flight), ``ckpt_verify_failures`` (integrity
    rejections), ``ckpt_snapshots_skipped`` (saves dropped by the async
    bounded queue)."""
    reg = registry()

    def val(name):
        g = reg.get(name)
        return 0 if g is None else g.value

    return {k: val(k) for k in
            ("ckpt_last_snapshot_ms", "ckpt_bytes", "ckpt_pending_writes",
             "ckpt_verify_failures", "ckpt_snapshots_skipped")}


# ========================================================= flight recorder
FLIGHT_ENV = "MXTPU_FLIGHT_DIR"


class FlightRecorder:
    """Crash flight recorder: a bounded in-memory ring of the
    last N telemetry happenings — finished spans, fault firings, compile
    events, trip records — plus ``dump()``, which writes one JSONL
    post-mortem bundle (a header line, the ring, one final metrics
    snapshot).  Recording and dumping NEVER raise: the recorder runs in
    dying processes, and the death it documents must not get worse.

    The ring is only fed while ``enabled`` (``telemetry.enable_flight``
    arms it); a disabled recorder costs one attribute read per feed
    site.  Span records of a trace whose root was evicted from the ring
    are dropped at dump time, so every trace in a bundle is complete and
    ``audit_jsonl`` applies to bundles unchanged."""

    def __init__(self, limit=2048):
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=int(limit))
        self.enabled = False
        self.directory = None
        self.dumps = 0
        self.last_path = None

    def configure(self, directory=None, limit=None, enabled=True):
        with self._lock:
            if limit is not None and int(limit) != self._ring.maxlen:
                self._ring = collections.deque(self._ring,
                                               maxlen=int(limit))
            if directory is not None:
                self.directory = str(directory)
                try:
                    os.makedirs(self.directory, exist_ok=True)
                except OSError:
                    _oops()
            self.enabled = bool(enabled)
        return self

    def record(self, kind, name=None, **fields):
        """Append one ring entry (never raises).  Appends take the
        recorder lock: ``dump()`` snapshots the ring by iterating it,
        and a lock-free concurrent append would raise "deque mutated
        during iteration" inside the one code path that must never
        fail."""
        if not self.enabled:
            return
        try:
            rec = {"ts": round(time.time(), 6),
                   "mono": round(time.monotonic(), 6),
                   "kind": str(kind),
                   "name": None if name is None else str(name)}
            rec.update(fields)
            with self._lock:
                self._ring.append(rec)
        except Exception:
            _oops()

    def records(self):
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()

    def dump(self, reason="manual", path=None, **attrs):
        """Write the post-mortem bundle; returns its path, or None on
        any failure (swallowed — see the class docstring)."""
        try:
            return self._dump(str(reason), path, attrs)
        except Exception:
            _oops()
            return None

    def _dump(self, reason, path, attrs):
        entries = self.records()
        # a trace whose root span was evicted can no longer audit —
        # drop its orphaned spans so the bundle stays audit-clean
        roots = {r.get("trace") for r in entries
                 if r.get("kind") == "span" and r.get("parent") is None}
        entries = [r for r in entries if r.get("kind") != "span"
                   or r.get("trace") in roots]
        with self._lock:
            self.dumps += 1
            n = self.dumps
        if path is None:
            rank = os.environ.get("DMLC_WORKER_ID", "")
            tag = f"-r{rank}" if rank else ""
            path = os.path.join(
                self.directory or ".",
                f"flight{tag}-{os.getpid()}-{n}.jsonl")
        stamp = {"ts": round(time.time(), 6),
                 "mono": round(time.monotonic(), 6)}
        header = {**stamp, "kind": "flight", "name": "dump",
                  "reason": reason, "pid": os.getpid(),
                  "records": len(entries), "tracer_errors": _CFG.errors}
        if attrs:
            header.update(attrs)
        try:
            snapshot = _REGISTRY.snapshot()
        except Exception:
            _oops()
            snapshot = None
        with open(path, "w") as f:
            f.write(json.dumps(header, default=str) + "\n")
            for rec in entries:
                f.write(json.dumps(rec, default=str) + "\n")
            if snapshot is not None:
                f.write(json.dumps({**stamp, "kind": "metrics",
                                    "name": "snapshot", **snapshot},
                                   default=str) + "\n")
        self.last_path = path
        return path


_FLIGHT = FlightRecorder()


def flight():
    """The process flight recorder (see ``FlightRecorder``)."""
    return _FLIGHT


_LAST_TRIP = [None, 0.0]     # (reason, monotonic) — signal-cascade dedupe


def flight_trip(reason, **attrs):
    """A trigger fired: record it and dump the bundle.  No-op while the
    recorder is disarmed; identical reasons within one second coalesce
    (a latched signal forwarding through nested ``GracefulExit`` scopes
    would otherwise dump once per scope)."""
    if not _FLIGHT.enabled:
        return None
    now = time.monotonic()
    if _LAST_TRIP[0] == reason and now - _LAST_TRIP[1] < 1.0:
        return _FLIGHT.last_path
    _LAST_TRIP[0], _LAST_TRIP[1] = reason, now
    _FLIGHT.record("trip", reason, **attrs)
    return _FLIGHT.dump(reason=reason, **attrs)


def _graceful_exit_trip(signum):
    """GracefulExit observer.  The dump runs on a short-lived thread,
    NOT in the signal handler: the handler executes on the interrupted
    main thread between bytecodes, and the recorder/registry locks it
    would need are plain (non-reentrant) locks that the very frame it
    interrupted may be holding — dumping inline could deadlock the
    snapshot-then-exit path the latch exists for.  Non-daemon, so
    interpreter shutdown waits for the (bounded, fast) dump instead of
    truncating the bundle."""
    threading.Thread(
        target=lambda: flight_trip("graceful-exit", signum=signum),
        name="flight-dump", daemon=False).start()


_FLIGHT_HOOKS = [False]


def _install_flight_hooks():
    """Chain ``sys.excepthook`` + ``threading.excepthook`` so an
    unhandled (worker-thread) death dumps the bundle before the default
    handling runs.  Installed once per process; the previous hooks
    always run afterward."""
    if _FLIGHT_HOOKS[0]:
        return
    _FLIGHT_HOOKS[0] = True
    import sys
    prev_exc = sys.excepthook

    def _exc_hook(tp, val, tb):
        flight_trip("unhandled-exception",
                    error=getattr(tp, "__name__", str(tp)))
        try:
            prev_exc(tp, val, tb)
        except Exception:
            pass

    sys.excepthook = _exc_hook
    prev_thread = threading.excepthook

    def _thread_hook(args):
        # SystemExit excluded: it is the deliberate replica-kill /
        # drain spelling, not an unhandled death
        if args.exc_type is not SystemExit:
            flight_trip("worker-death",
                        error=getattr(args.exc_type, "__name__", "?"),
                        thread=getattr(args.thread, "name", None))
        try:
            prev_thread(args)
        except Exception:
            pass

    threading.excepthook = _thread_hook


def enable_flight(directory=None, limit=None, install_hooks=True):
    """Arm the flight recorder: ring feeds start, the automatic triggers
    fire (breaker OPEN, non-finite abort, ``GracefulExit``, unhandled
    death), and bundles land under ``directory`` (default: cwd).  Also
    installs the fault observer so firings are recorded even when
    request tracing itself is off."""
    # a fresh arming is a fresh episode: the same-reason coalesce
    # window must not suppress its first trip because a PREVIOUS
    # episode tripped the same reason moments ago
    _LAST_TRIP[0], _LAST_TRIP[1] = None, 0.0
    _FLIGHT.configure(directory=directory, limit=limit, enabled=True)
    if install_hooks:
        _install_flight_hooks()
    try:    # package mode only; the standalone launcher has no fault twin
        from . import fault as _fault
        _fault.set_exit_observer(_graceful_exit_trip)
        if _fault._OBSERVER is None:
            _fault.set_observer(note_fault)
    except (ImportError, AttributeError):
        pass
    return _FLIGHT


def flight_from_env(environ=None):
    """Arm the recorder from the supervisor's env contract
    (``MXTPU_FLIGHT_DIR``), or None when unsupervised — training loops
    call this unconditionally, like ``Heartbeat.from_env``."""
    env = os.environ if environ is None else environ
    directory = env.get(FLIGHT_ENV)
    if not directory:
        return None
    return enable_flight(directory=directory)
