"""Admission-control primitives: errors, rate limiting, request futures,
and per-tenant QoS (priority classes + tenant token buckets).

(The port's own copy of ``mxnet_tpu/serving/admission.py``: stdlib
only, its imports point inside ``mxnet_tpu_torch``.)

ref: the reference stack has no serving layer at all (Module.predict is a
bare loop); the design here follows the TPU-serving literature's stance
(PAPERS.md — Ragged Paged Attention, the Gemma-on-TPU serving comparison)
that overload is a *normal* lifecycle event: a server that cannot keep up
must say so immediately (bounded queue, explicit ``RejectedError``) rather
than buffer without bound and melt every request into a timeout.

The QoS layer extends the same stance to mixed-tenant traffic:
a single shared ``TokenBucket`` lets one noisy tenant starve everyone, so
``TenantQoS`` gives every tenant its OWN bucket (the abusive tenant sheds
with ``TenantThrottledError``; its neighbours never notice) and sorts
requests into **priority classes** (``QoSClass``) that carry a default
deadline, a routing-group pin, and an admission headroom fraction.  Each
class tracks deadline misses and a sliding-window latency distribution
(``ClassStats`` — p50/p99) that servers surface through ``healthz()`` so
routers and operators see SLO state per class.

Everything here is stdlib-only; the device-facing pieces live in
``serving.server``.
"""
from __future__ import annotations

import collections
import threading
import time

from .. import fault as _fault
from .. import telemetry as _telemetry

__all__ = ["RejectedError", "CircuitOpenError", "ServerClosedError",
           "DeadlineExceededError", "NonFiniteOutputError",
           "TenantThrottledError", "TokenBucket", "Request", "QoSClass",
           "ClassStats", "TenantQoS"]


class RejectedError(RuntimeError):
    """The server refused the request at admission (queue full, rate
    limit, oversize shape).  Shedding is an explicit, immediate verdict
    the client can retry against another replica — never an unbounded
    queue.  The request did NOT touch the device."""


class CircuitOpenError(RejectedError):
    """Fast-fail: the circuit breaker is open after consecutive step
    failures; new work is refused until a half-open probe succeeds."""


class ServerClosedError(RejectedError):
    """The server is draining or has shut down — not admitting."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed — in queue (expired without
    touching the device) or mid-generation.  For generation requests
    the error carries the salvageable progress:
    ``tokens_generated`` and ``partial_tokens`` expose what was
    produced before expiry instead of silently discarding it."""

    def __init__(self, *args, tokens_generated=0, partial_tokens=None):
        super().__init__(*args)
        self.tokens_generated = int(tokens_generated)
        self.partial_tokens = [] if partial_tokens is None \
            else list(partial_tokens)


class NonFiniteOutputError(RuntimeError):
    """This request's rows of the batched output contained NaN/Inf — the
    request fails alone; batch neighbours and the server are unaffected
    (the serving counterpart of ``TrainStep(skip_nonfinite=True)``)."""


class TenantThrottledError(RejectedError):
    """THIS tenant's token bucket is empty — the request is shed for the
    tenant alone.  Other tenants' admission is untouched (per-tenant
    buckets are the isolation boundary; a shared limiter would let one
    abusive client starve everyone at zero served throughput)."""


class TokenBucket:
    """Token-bucket rate limiter: ``rate`` tokens/second refill up to a
    ``burst`` capacity; ``try_acquire`` never blocks (admission control
    sheds, it does not queue the client thread)."""

    def __init__(self, rate, burst=None):
        if rate <= 0:
            raise ValueError("TokenBucket: rate must be > 0")
        self._rate = float(rate)
        self._capacity = float(burst) if burst is not None \
            else max(1.0, self._rate)
        if self._capacity < 1.0:
            raise ValueError("TokenBucket: burst must allow >= 1 token")
        self._tokens = self._capacity
        self._stamp = time.monotonic()
        self._lock = threading.Lock()

    def try_acquire(self, n=1.0):
        """Take ``n`` tokens if available; False (no side effect) if not."""
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self._capacity,
                               self._tokens + (now - self._stamp) * self._rate)
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def refund(self, n=1.0):
        """Return tokens a request charged but never used (it was shed
        downstream of the limiter) — otherwise refused work burns the
        budget valid clients needed.  Capped at capacity."""
        with self._lock:
            self._tokens = min(self._capacity, self._tokens + n)


# --------------------------------------------------------------------- QoS --
class QoSClass:
    """One priority class of a ``TenantQoS`` policy.

    ``priority`` orders classes (higher = more important — schedulers
    serve it first, eviction spares it longest).  ``deadline`` is the
    class's default request deadline AND its SLO latency target: a
    request of this class that resolves later than ``deadline`` seconds
    after submission counts as a deadline miss even when it succeeded.
    ``admit_frac`` is an admission threshold on the server's TOTAL
    load: requests of this class are admitted only while overall
    utilization (all classes combined) is below the fraction, so the
    top ``1 - admit_frac`` of capacity is reserved exclusively for
    higher classes (a class with ``admit_frac=0.5`` sheds whenever the
    server is more than half full — under a sustained high-priority
    storm that saturates the threshold, the class yields entirely;
    this is strict priority admission, not a per-class occupancy
    quota).  ``group`` optionally pins the class to a named
    ``ServingFleet`` replica group.
    """

    __slots__ = ("name", "priority", "deadline", "admit_frac", "group")

    def __init__(self, name, priority=0, deadline=None, admit_frac=1.0,
                 group=None):
        self.name = str(name)
        self.priority = int(priority)
        self.deadline = None if deadline is None else float(deadline)
        self.admit_frac = float(admit_frac)
        if not 0.0 < self.admit_frac <= 1.0:
            raise ValueError(f"QoSClass {name!r}: admit_frac must be in "
                             f"(0, 1], got {admit_frac}")
        self.group = None if group is None else str(group)


class ClassStats:
    """SLO accounting for one priority class.

    Counters (monotonic): ``admitted`` / ``throttled`` / ``shed`` /
    ``completed`` / ``failed`` / ``expired`` / ``deadline_miss``.
    Latencies land in BOTH a sliding window of the last ``window``
    resolutions — which feeds the p50/p99 the ``snapshot()`` reports,
    so a router ranking replicas on healthz sees CURRENT behaviour (a
    recovered replica's p99 decays; a degraded one's isn't diluted by
    hours of healthy history) — and a cumulative ``telemetry.Histogram``
    (fixed log-spaced buckets,
    ``telemetry.LATENCY_BUCKETS_S``), the mergeable series the unified
    ``telemetry()`` expositions serve (scrapers window it themselves by
    differencing scrapes, Prometheus-style).  ``snapshot()`` is
    non-blocking in the healthz sense: one short lock over host
    counters and a bounded sort — no device work, no queue waits."""

    def __init__(self, window=256):
        self._lock = threading.Lock()
        self._window = collections.deque(maxlen=int(window))
        self._lat = _telemetry.Histogram("latency_s",
                                         _telemetry.LATENCY_BUCKETS_S)
        self._counts = {"admitted": 0, "throttled": 0, "shed": 0,
                        "completed": 0, "failed": 0, "expired": 0,
                        "deadline_miss": 0}

    def count(self, key, n=1):
        with self._lock:
            self._counts[key] += n

    def observe(self, latency, outcome, missed):
        """One resolved request: ``latency`` seconds, ``outcome`` in
        ``completed``/``failed``/``expired``, ``missed`` = SLO verdict."""
        latency = float(latency)
        with self._lock:
            self._counts[outcome] += 1
            if missed:
                self._counts["deadline_miss"] += 1
            self._window.append(latency)
        self._lat.observe(latency)

    def latency_snapshot(self):
        """The mergeable (cumulative) histogram snapshot (seconds) —
        served by the runtimes' ``telemetry()`` expositions as the
        ``class_<name>_latency_s`` histogram series."""
        return self._lat.snapshot()

    def snapshot(self):
        with self._lock:
            out = dict(self._counts)
            lat = sorted(self._window)
        n = len(lat)
        out["p50_ms"] = round(lat[n // 2] * 1e3, 3) if n else None
        out["p99_ms"] = round(lat[min(n - 1, (99 * n) // 100)] * 1e3,
                              3) if n else None
        return out


class TenantQoS:
    """Per-tenant token buckets + priority classes at admission.

    ``classes`` is an iterable of ``QoSClass`` (default: one class named
    ``"default"``).  ``tenant_rate``/``tenant_burst`` configure the
    per-tenant ``TokenBucket`` (``None`` rate = no tenant limiting);
    buckets are created lazily per tenant id and capped at
    ``max_tenants`` live buckets, evicting the least-recently-seen — a
    tenant-id cardinality attack must not grow host memory without
    bound.  ``classify()`` is the admission verdict (it fires the
    ``admission.classify`` fault point); ``track()`` arms SLO
    accounting on an accepted request; ``snapshot()`` is the per-class
    healthz payload.

    Thread contract: ``classify`` runs on client threads; the policy
    lock guards only the bucket/LRU dict — ``TokenBucket`` calls happen
    OUTSIDE it (the bucket has its own lock), and ``ClassStats`` guards
    itself.
    """

    def __init__(self, classes=None, default_class=None, tenant_rate=None,
                 tenant_burst=None, max_tenants=1024, window=256):
        if classes is None:
            classes = (QoSClass("default"),)
        self.classes = {}
        for qc in classes:
            if qc.name in self.classes:
                raise ValueError(f"TenantQoS: duplicate class {qc.name!r}")
            self.classes[qc.name] = qc
        if default_class is None:
            default_class = next(iter(self.classes))
        if default_class not in self.classes:
            raise ValueError(f"TenantQoS: default_class {default_class!r} "
                             f"is not one of {sorted(self.classes)}")
        self.default_class = default_class
        self._rate = None if tenant_rate is None else float(tenant_rate)
        self._burst = tenant_burst
        self._max_tenants = int(max_tenants)
        self._lock = threading.Lock()
        self._buckets = collections.OrderedDict()    # tenant -> TokenBucket
        self._stats = {name: ClassStats(window=window)
                       for name in self.classes}

    def klass(self, name=None):
        """Resolve a class name (``None`` = the default class); raises
        ``RejectedError`` for an unknown name — an unconfigured class is
        a client bug, not a new SLO tier."""
        if name is None:
            name = self.default_class
        qc = self.classes.get(name)
        if qc is None:
            raise RejectedError(
                f"unknown priority class {name!r} — configured classes: "
                f"{sorted(self.classes)}")
        return qc

    def _bucket(self, tenant):
        """This tenant's bucket (created on first sight, LRU-capped)."""
        with self._lock:
            b = self._buckets.get(tenant)
            if b is not None:
                self._buckets.move_to_end(tenant)
                return b
            b = TokenBucket(self._rate, self._burst)
            self._buckets[tenant] = b
            while len(self._buckets) > self._max_tenants:
                self._buckets.popitem(last=False)
            return b

    def classify(self, tenant=None, klass=None):
        """The admission verdict for one request: resolve its class,
        charge the tenant's bucket.  Returns the ``QoSClass``; raises
        ``RejectedError`` (unknown class) or ``TenantThrottledError``
        (this tenant is out of tokens — nobody else is affected)."""
        _fault.fire("admission.classify")
        qc = self.klass(klass)
        stats = self._stats[qc.name]
        if tenant is not None and self._rate is not None:
            bucket = self._bucket(tenant)
            if not bucket.try_acquire():
                stats.count("throttled")
                raise TenantThrottledError(
                    f"tenant {tenant!r} exceeded its rate — shedding this "
                    f"tenant only")
        stats.count("admitted")
        return qc

    def refund(self, tenant, qc):
        """A classified request was refused downstream (queue full,
        headroom): give the tenant its token back and move the admission
        to the ``shed`` column so the books stay honest."""
        if tenant is not None and self._rate is not None:
            self._bucket(tenant).refund()
        stats = self._stats[qc.name]
        stats.count("admitted", -1)
        stats.count("shed")

    def track(self, qc, req):
        """Arm SLO accounting on an accepted request: when it resolves,
        its latency/outcome/deadline-miss land in the class stats (from
        the resolving thread's done callback — no watcher thread)."""
        req.add_done_callback(lambda r: self._observe(qc, r))
        return req

    def _observe(self, qc, req):
        err = req.exception(timeout=0)            # resolved by now
        latency = time.monotonic() - req.submitted_at
        if err is None:
            outcome = "completed"
        elif isinstance(err, DeadlineExceededError):
            outcome = "expired"
        else:
            outcome = "failed"
        missed = outcome == "expired" \
            or (qc.deadline is not None and latency > qc.deadline)
        self._stats[qc.name].observe(latency, outcome, missed)

    def snapshot(self):
        """``{class: ClassStats.snapshot()}`` plus the class's static
        config — the ``healthz()["classes"]`` payload."""
        out = {}
        for name, qc in self.classes.items():
            s = self._stats[name].snapshot()
            s["priority"] = qc.priority
            s["deadline"] = qc.deadline
            out[name] = s
        return out

    def latency_snapshots(self):
        """``{class: ClassStats.latency_snapshot()}`` — the cumulative,
        mergeable per-class latency histograms the ``telemetry()``
        expositions serve (as ``class_<name>_latency_s`` series)."""
        return {name: st.latency_snapshot()
                for name, st in self._stats.items()}


class Request:
    """One accepted inference request: payload + deadline + a future.

    The client thread blocks in ``result()``; the batch thread resolves
    it with ``set_result``/``set_error``.  The handoff is the
    ``threading.Event`` — by the time ``wait()`` returns, the write is
    visible.  ``deadline`` is seconds from submission; an expired request
    is failed with ``DeadlineExceededError`` *in queue*, without touching
    the device.

    ``add_done_callback`` is the non-blocking observation channel a
    router needs: the fleet layer re-dispatches failed-over requests from
    the resolving thread's callback instead of parking a watcher thread
    per request in ``result()``.

    ``tenant``/``klass`` are the QoS labels admission stamped on the
    request (``None`` when the server runs without tenant attribution) —
    carried here so schedulers can order work and SLO accounting can
    attribute the resolution without a side table.

    ``trace``/``tspans`` are the request-tracing channel:
    ``telemetry.begin_request`` stamps an accepted request with its
    ``telemetry.Trace`` and the open phase spans; every downstream
    instrumentation site guards on the single ``trace is not None``
    attribute check, so an untraced request allocates nothing and pays
    one attribute read per site.
    """

    __slots__ = ("data", "submitted_at", "deadline", "tenant", "klass",
                 "trace", "tspans",
                 "_event", "_result", "_error", "_callbacks", "_cb_lock")

    def __init__(self, data, deadline=None, tenant=None, klass=None):
        self.data = data
        self.tenant = tenant
        self.klass = klass
        self.trace = None              # telemetry.Trace once begun
        self.tspans = None             # {phase: Span}, traced only
        self.submitted_at = time.monotonic()
        self.deadline = None if deadline is None \
            else self.submitted_at + float(deadline)
        self._event = threading.Event()
        self._result = None
        self._error = None
        self._callbacks = []
        self._cb_lock = threading.Lock()

    def expired(self, now=None):
        return self.deadline is not None and \
            (time.monotonic() if now is None else now) >= self.deadline

    # ---- resolution (batch-thread side) ----
    def set_result(self, value):
        self._result = value
        self._finish()

    def set_error(self, exc):
        self._error = exc
        self._finish()

    def _finish(self):
        # the lock closes the add-after-resolve race: a callback is
        # either in the list this drain snapshots, or added after the
        # event is visibly set (and invoked by the adder) — exactly once
        # either way.  Callbacks run OUTSIDE the lock (they are arbitrary
        # router code).
        with self._cb_lock:
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            try:
                cb(self)
            except Exception:    # noqa: BLE001 — a raising callback must
                pass             # not strand the REST of a resolving batch

    def add_done_callback(self, fn):
        """Call ``fn(request)`` once the request is resolved — on the
        resolving thread, or immediately on this one when it already is.
        Callbacks must not block (the batch thread is the caller);
        exceptions they raise are swallowed — resolution must never fail
        halfway through a batch."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    # ---- future protocol (client side) ----
    def done(self):
        return self._event.is_set()

    def exception(self, timeout=None):
        """The error this request resolved with (None on success); raises
        builtin ``TimeoutError`` if unresolved within ``timeout``."""
        if not self._event.wait(timeout):
            raise TimeoutError("Request: not resolved within "
                               f"{timeout}s")
        return self._error

    def result(self, timeout=None):
        err = self.exception(timeout)
        if err is not None:
            raise err
        return self._result
