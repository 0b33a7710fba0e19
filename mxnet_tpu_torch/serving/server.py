"""InferenceServer: the fault-hardened serving front of the stack (the
port of ``mxnet_tpu/serving/server.py``).

Turns a batched apply fn — ``parallel.EvalStep``, a hybridized Gluon
net, a bound ``Module`` via ``module_apply`` (f32 or int8), a
``graphs.captured`` function, or any function of host arrays — into a
request server with the full robustness lifecycle:

- **admission control** — bounded queue + optional token-bucket rate
  limit; overload sheds with ``RejectedError`` instead of growing a
  queue.
- **dynamic batching** — requests coalesce into fixed shape buckets
  (``serving.BucketSpec``), so on the card the apply fn's captured
  graphs are a configuration constant: one per bucket, all captured
  during warm-up, never by traffic.
- **deadlines + circuit breaker** — queued requests expire without
  touching the device; consecutive step failures trip into fast-fail with
  exponential half-open probing (``serving.CircuitBreaker``).
- **health + drain** — ``alive()``/``ready()``/``healthz()`` predicates
  (readiness flips only after warm-up has captured the whole grid),
  profiler counters, and a SIGTERM drain (``serve_forever`` on
  ``fault.GracefulExit``): stop admitting, flush every accepted request
  to a terminal state, exit.  An accepted request is NEVER silently
  dropped.

Outputs come back to the host as numpy rows (``_to_np``); a bfloat16
output becomes float32, an exact widening (numpy has no bfloat16; the
JAX package returns ``ml_dtypes`` bfloat16).

Every failure path is deterministically testable through the
``serving.admit`` / ``serving.batch`` / ``serving.step`` /
``serving.drain`` fault points (``fault.inject``).
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import fault as _fault
from .. import profiler as _profiler
from .. import telemetry as _telemetry
from .admission import (CircuitOpenError, DeadlineExceededError,
                        NonFiniteOutputError, RejectedError, Request,
                        ServerClosedError, TenantQoS, TokenBucket)
from .batcher import BucketSpec, DynamicBatcher
# one apply-fn output (a numpy array, or a torch tensor or NDArray on
# either device) as a numpy batch array on the host; bfloat16 widens to
# float32
from .batcher import host_array as _to_np
from .breaker import OPEN, CircuitBreaker

__all__ = ["InferenceServer", "module_apply"]


class InferenceServer:
    """Robust request server over a batched apply fn.

    ``apply_fn(*batch_leaves) -> batch_out | tuple`` runs on the batch
    thread only, always on shapes from the bucket grid.  Per-request
    payloads are single examples (one row of the batch; tuples for
    multi-input models).

    Lifecycle: construct → ``start()`` (warmup-compiles every batch
    bucket when ``sample`` is given, THEN flips readiness — a recompile
    stall never lands on a live request) → ``submit()``/``__call__`` →
    ``drain()`` (or ``serve_forever()`` + SIGTERM).

    Thread contract (mxlint-gated): client threads and the batch thread
    share state only through the batcher's bounded queue, ``Event``s,
    profiler ``Counter``s, the breaker's own lock, and the
    ``self._lock``-guarded stats dict.

    Profiler series (readable with the profiler off via
    ``profiler.counter_value`` / ``profiler.counters``):
    ``<name>::queue_depth``, ``<name>::shed``, ``<name>::expired``,
    ``<name>::batch_occupancy`` (percent, last dispatched batch),
    ``<name>::breaker_state`` (0 closed / 1 half-open / 2 open).
    """

    def __init__(self, apply_fn, buckets=(1, 2, 4, 8), *, max_queue=128,
                 max_delay=0.005, rate=None, burst=None, breaker=None,
                 sample=None, default_deadline=None, guard_nonfinite=True,
                 pin_signature=True, qos=None, memory_report=None,
                 name="InferenceServer"):
        self._apply = apply_fn
        # compile-event stream: when the apply fn exposes its graph count
        # (``jit_cache_size`` of module_apply and fleet.HotSwapApply,
        # ``_cache_size`` of graphs.captured, ``graph_count`` of an
        # EvalStep or a hybridized block), compile events come from REAL
        # graph growth — a fleet replica warming against a shared
        # function records hits, not phantom captures.  Otherwise the
        # dispatched-signature set stands in.
        probe = None
        for attr in ("jit_cache_size", "_cache_size", "graph_count"):
            probe = getattr(apply_fn, attr, None)
            if callable(probe):
                break
        self._cache_probe = probe if callable(probe) else None
        # the object whose graphs the probe counts (the SHARED fn for
        # HotSwapApply wrappers) — the dedupe key for concurrent growth
        self._cache_owner = getattr(apply_fn, "jit_cache_owner",
                                    apply_fn)
        # live memory gauges: per-device argument/peak bytes
        # from an already-parsed costguard report, stamped at warmup
        self._mem_gauges = _telemetry.memory_gauges(memory_report)
        # per-tenant/per-class QoS.  Always present: without an
        # explicit policy every request lands in one "default" class with
        # no tenant limiting, so healthz()["classes"] carries the SLO
        # snapshot for ANY server — the uniform key fleet routers rank on.
        self._qos = qos if qos is not None else TenantQoS()
        self.buckets = buckets if isinstance(buckets, BucketSpec) \
            else BucketSpec(buckets)
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self._limiter = None if rate is None else TokenBucket(rate, burst)
        self._default_deadline = default_deadline
        self._guard = bool(guard_nonfinite)
        # pin_signature (default on): the served example signature is
        # fixed — by ``sample``, else by the first accepted request — and
        # any later payload with a different leaf count/dtype/shape
        # (beyond the length grid) is REJECTED at admission.  Without
        # this, one stray float64 list or transposed array from a client
        # is a fresh warm-up and capture stalling the device under live
        # deadlines — the exact failure the bucket grid exists to kill.
        self._pin = bool(pin_signature)
        self._name = name
        self._sample = None if sample is None \
            else self.buckets.pad_example(sample)
        # only (shape, dtype) per leaf is ever compared — storing the
        # actual first-request arrays would pin them (and alias the
        # client's buffers) for the server's lifetime
        self._template = None if self._sample is None \
            else self._sig_of(self._sample)
        self._lock = threading.Lock()
        self._stats = {"admitted": 0, "completed": 0, "failed": 0,
                       "shed": 0, "expired": 0, "rejected": 0,
                       "batches": 0, "probes": 0}
        self._last_error = None       # (type name, monotonic stamp)
        self._shapes = set()          # distinct dispatched signatures
        self._ready = threading.Event()
        self._draining = threading.Event()
        self._c_depth = _profiler.Counter(None, f"{name}::queue_depth")
        self._c_shed = _profiler.Counter(None, f"{name}::shed")
        self._c_expired = _profiler.Counter(None, f"{name}::expired")
        self._c_occupancy = _profiler.Counter(None,
                                              f"{name}::batch_occupancy")
        self._c_breaker = _profiler.Counter(None, f"{name}::breaker_state")
        self._batcher = DynamicBatcher(
            self._run_batch, self.buckets, max_delay=max_delay,
            capacity=max_queue, on_expire=self._expire,
            on_fail=lambda req, exc: self._bump("failed"),
            idle=self._idle_probe, name=f"{name}-batcher")

    # ------------------------------------------------------------ lifecycle --
    def start(self, warmup=None):
        """Start the batch thread.  ``warmup`` (default: on when a
        ``sample`` payload was given) first pushes the sample through
        every batch bucket so EVERY executable the grid allows exists
        before readiness flips — compiles happen here, not under a live
        deadline."""
        if self._draining.is_set():
            raise ServerClosedError(f"{self._name}: already drained")
        if warmup is None:
            warmup = self._sample is not None
        if warmup:
            if self._sample is None:
                raise ValueError("start(warmup=True) needs sample= at "
                                 "construction")
            for leaves in self._sample_grid():
                for b in self.buckets.batch:
                    sig = (b,) + BucketSpec.signature(leaves)
                    self._tracked_apply(self._padded(leaves, b), sig)
                    with self._lock:
                        self._shapes.add(sig)
            # every executable the grid allows now exists: later misses
            # are UNEXPECTED recompiles (the chaos-asserted counter)
            if _telemetry.ACTIVE:
                _telemetry.pin_compile_census(self._name)
        self._batcher.start()
        self._ready.set()
        return self

    def _tracked_apply(self, padded, sig):
        """Run the apply fn through the compile-event chokepoint
       .  With a jit-cache probe the verdict is real cache
        growth; without one, a signature this server never dispatched
        counts as the compile it implies."""
        if not _telemetry.ACTIVE:
            return self._apply(*padded)
        key = f"b{sig[0]}"
        if self._cache_probe is not None:
            with _telemetry.track_compile(self._name,
                                          probe=self._cache_probe,
                                          key=key,
                                          hw_key=self._cache_owner):
                return self._apply(*padded)
        with self._lock:
            new = sig not in self._shapes
        with _telemetry.track_compile(self._name, key=key,
                                      assume_miss=new):
            return self._apply(*padded)

    def stamp_memory_report(self, report):
        """Stamp a costguard-style memory report (``argument_bytes`` /
        ``peak_bytes`` / ``per_device``) onto this server's ``mem_*``
        exposition gauges — what warmup tooling calls after compiling
        the grid (the bytes are a property of the executables, so one
        stamp is live until the program set changes)."""
        self._mem_gauges = _telemetry.memory_gauges(report)
        return self._mem_gauges

    def __enter__(self):
        if not self._batcher.alive():
            self.start()
        return self

    def __exit__(self, *exc):
        self.drain()
        return False

    def _sample_grid(self):
        """The sample resized onto every length bucket (the whole grid a
        request could dispatch as — warmup must compile all of it, not
        just the sample's own bucket)."""
        if self.buckets.length is None:
            return [self._sample]
        head, rest = self._sample[0], self._sample[1:]
        out = []
        for L in self.buckets.length:
            h = head[:L]
            if h.shape[0] < L:
                h = np.concatenate(
                    [h, np.full((L - h.shape[0],) + h.shape[1:],
                                self.buckets.pad_value, h.dtype)], axis=0)
            out.append((h,) + rest)
        return out

    @staticmethod
    def _padded(leaves, b):
        return tuple(np.stack([leaf] * b, axis=0) for leaf in leaves)

    @staticmethod
    def _sig_of(leaves):
        return tuple((tuple(l.shape), l.dtype) for l in leaves)

    def _check_signature(self, payload):
        """Admission-time signature pinning (see ``pin_signature``)."""
        if not self._pin:
            return
        sig = self._sig_of(payload)
        with self._lock:
            tpl = self._template
            if tpl is None:
                self._template = sig       # first request defines the API
                return
        if len(sig) != len(tpl):
            raise RejectedError(
                f"payload has {len(sig)} leaves, this server serves "
                f"{len(tpl)} — a new signature would recompile")
        for i, ((p_shape, p_dt), (t_shape, t_dt)) in enumerate(zip(sig,
                                                                   tpl)):
            if p_dt != t_dt:
                raise RejectedError(
                    f"payload leaf {i} dtype {p_dt} != served "
                    f"{t_dt} — a new signature would recompile (lists "
                    f"arrive float64; cast explicitly)")
            ragged = i == 0 and self.buckets.length is not None
            if (p_shape[1:] if ragged else p_shape) != \
                    (t_shape[1:] if ragged else t_shape):
                raise RejectedError(
                    f"payload leaf {i} shape {p_shape} does not match the "
                    f"served signature {t_shape}"
                    f"{' beyond the length axis' if ragged else ''} — a "
                    f"new signature would recompile")

    # ------------------------------------------------------------ admission --
    def submit(self, data, deadline=None, tenant=None, klass=None,
               trace_parent=None):
        """Admit one request; returns its ``Request`` future.

        Refusals are immediate and explicit: ``ServerClosedError`` while
        draining, ``CircuitOpenError`` while the breaker fast-fails,
        ``RejectedError`` on rate-limit, full queue, or an un-bucketable
        shape, ``TenantThrottledError`` when THIS tenant's QoS bucket is
        dry.  None of them touched the device or consumed queue space.

        ``tenant``/``klass`` are the QoS labels (see ``TenantQoS``): the
        class supplies the default deadline when ``deadline`` is None and
        the resolved request's latency lands in that class's healthz
        stats.

        ``trace_parent`` (a ``telemetry.Span``) continues an existing
        request trace under that span — the fleet router passes its
        dispatch span here so replica-side phases nest under the hop."""
        t0_us = _telemetry.now_us() if _telemetry.ACTIVE else None
        _fault.fire("serving.admit")
        if self._draining.is_set():
            self._bump("rejected")
            raise ServerClosedError(f"{self._name}: draining — "
                                    f"not admitting")
        if not self._ready.is_set():
            self._bump("rejected")
            raise RejectedError(f"{self._name}: not started")
        if not self._batcher.alive():
            self._bump("rejected")
            raise ServerClosedError(f"{self._name}: batch thread is not "
                                    f"running — not admitting")
        if self.breaker.engaged():
            self._bump("rejected")
            raise CircuitOpenError(
                f"{self._name}: circuit open after repeated step failures "
                f"— fast-failing until a probe succeeds")
        # validate BEFORE charging the rate limiter: both checks are pure
        # host work, and an unservable payload must not burn a token a
        # valid client needed (a misbehaving client would otherwise
        # starve everyone at zero served throughput)
        try:
            payload = self.buckets.pad_example(data)
            self._check_signature(payload)
        except RejectedError:
            self._bump("rejected")
            raise
        # the QoS verdict comes AFTER the structural checks (an
        # unservable payload must not burn a tenant token) and BEFORE the
        # global limiter (the per-tenant bucket is the finer sieve)
        try:
            qc = self._qos.classify(tenant=tenant, klass=klass)
        except RejectedError:
            self._bump("shed")
            self._c_shed.increment()
            raise
        if deadline is None:
            deadline = qc.deadline if qc.deadline is not None \
                else self._default_deadline
        if self._limiter is not None and not self._limiter.try_acquire():
            self._qos.refund(tenant, qc)
            self._shed("rate limit exceeded — shedding")
        req = Request(payload, deadline=deadline, tenant=tenant,
                      klass=qc.name)
        # trace BEFORE the offer — the batch thread may pop the request
        # immediately and needs the queue span already open.  A refusal
        # below leaves the request unresolved, so the trace is never
        # exported (only accepted requests yield trees).
        if trace_parent is not None or t0_us is not None:
            _telemetry.begin_request(req, self._name, t0_us=t0_us,
                                     parent=trace_parent)
        try:
            self._batcher.offer(req)
        except ServerClosedError as exc:
            if self._limiter is not None:    # the refusal served no one —
                self._limiter.refund()       # give the token back
            self._qos.refund(tenant, qc)
            _telemetry.abort_request(req, exc)
            self._bump("rejected")
            raise
        except RejectedError as exc:
            if self._limiter is not None:
                self._limiter.refund()
            self._qos.refund(tenant, qc)
            _telemetry.abort_request(req, exc)
            self._shed(str(exc))
        self._qos.track(qc, req)
        self._bump("admitted")
        self._c_depth.set_value(self._batcher.depth())
        return req

    def __call__(self, data, deadline=None, timeout=None, **kw):
        """Blocking convenience: submit + ``result()`` (``tenant`` /
        ``klass`` pass through)."""
        return self.submit(data, deadline=deadline, **kw).result(timeout)

    def _shed(self, msg):
        self._bump("shed")
        self._c_shed.increment()
        raise RejectedError(f"{self._name}: {msg}")

    def _bump(self, key, n=1):
        with self._lock:
            self._stats[key] += n

    def _note_step_failure(self, exc):
        """Remember the most recent step-level failure for ``healthz`` —
        type name + monotonic stamp, never the exception object (holding
        it would pin its traceback, and with it every frame's locals,
        for the life of the server)."""
        with self._lock:
            self._last_error = (type(exc).__name__, time.monotonic())

    # ---------------------------------------------------------- batch thread --
    def _expire(self, req):
        """Deadline passed in queue: resolve WITHOUT device work."""
        self._bump("expired")
        self._c_expired.increment()
        waited = time.monotonic() - req.submitted_at
        req.set_error(DeadlineExceededError(
            f"deadline exceeded after {waited * 1e3:.1f} ms in queue — "
            f"the request never touched the device"))

    def _run_batch(self, group, padded):
        """Execute one padded group on the batch thread: breaker gate →
        ``serving.step`` fault point → apply → per-request splitting with
        the all-finite row guard (a NaN output fails ONE request, not the
        server)."""
        if not self.breaker.allow():
            err = CircuitOpenError(
                f"{self._name}: circuit open — fast-failing queued work")
            for r in group:
                r.set_error(err)
            self._bump("failed", len(group))
            return
        target = padded[0].shape[0]
        step_spans = None
        for r in group:                # device-step span per traced member
            if r.trace is not None:
                if step_spans is None:
                    step_spans = []
                sp = _telemetry.open_span(r, "step", batch=len(group))
                if sp is not None:
                    step_spans.append(sp)
        if step_spans is not None:     # fault firings → span events
            _telemetry.push_current(step_spans)
        sig = (target,) + BucketSpec.signature(group[0].data)
        try:
            _fault.fire("serving.step")
            with _profiler.scope(f"{self._name}.step", cat="serving"):
                out = self._tracked_apply(padded, sig)
        except Exception as exc:      # noqa: BLE001 — resolved per request
            self.breaker.record_failure()
            self._note_step_failure(exc)
            self._c_breaker.set_value(self.breaker.state_code())
            err = _fault.with_context(
                exc, f"{self._name} batch of {len(group)}")
            for r in group:
                r.set_error(err)
            self._bump("failed", len(group))
            return
        finally:
            if step_spans is not None:
                _telemetry.pop_current()
        outs = tuple(_to_np(o) for o in
                     (out if isinstance(out, (tuple, list)) else (out,)))
        if step_spans is not None:     # host realization is the sync point
            for sp in step_spans:
                sp.end()
            # the rows are handed out in order below, and each resolution
            # runs its request's callbacks (a fleet's bookkeeping, trace
            # export): a member's wait for the members before it is its
            # deliver span, closed at its own resolution
            for r in group:
                _telemetry.open_span(r, "deliver")
        bad_dim = [o for o in outs if o.shape[:1] != (target,)]
        if bad_dim:
            # malformed output IS a step failure (a wedged/poisoned
            # executable that cannot serve anyone) — the breaker must see
            # it, or a replica erroring 100% of requests stays "ready"
            # and load balancers keep feeding it
            self.breaker.record_failure()
            self._c_breaker.set_value(self.breaker.state_code())
            err = ValueError(
                f"{self._name}: apply fn returned leading dim "
                f"{bad_dim[0].shape[:1]} for a batch of {target} — serving "
                f"apply fns must be batch-major")
            self._note_step_failure(err)
            for r in group:
                r.set_error(err)
            self._bump("failed", len(group))
            return
        if self._guard:
            from ..parallel.step import all_finite_rows
            mask = all_finite_rows([o[:len(group)] for o in outs])
            # SOME rows bad = poisoned inputs (data fault: neighbours are
            # served, breaker untouched).  EVERY row of a MULTI-request
            # batch bad = nothing served — step-failure territory (a
            # poisoned executable kills whole batches under load).  A
            # single-request batch is excluded: at idle traffic one
            # client's NaN input is indistinguishable from a server fault,
            # and counting it would let one buggy client trip the breaker
            # for the whole replica.
            batch_dead = len(group) > 1 and not mask.any()
        else:
            batch_dead = False
        if batch_dead:
            self.breaker.record_failure()
            self._note_step_failure(NonFiniteOutputError(
                "entirely non-finite multi-request batch"))
        else:
            self.breaker.record_success()
        self._c_breaker.set_value(self.breaker.state_code())
        with self._lock:
            self._stats["batches"] += 1
            self._shapes.add(sig)
        self._c_occupancy.set_value(int(100 * len(group) / target))
        for i, r in enumerate(group):
            if self._guard and not mask[i]:
                r.set_error(NonFiniteOutputError(
                    f"{self._name}: non-finite values in this request's "
                    f"output row — input likely corrupt; batch neighbours "
                    f"were served normally"))
                self._bump("failed")
                continue
            row = tuple(o[i] for o in outs)
            r.set_result(row[0] if len(row) == 1 else row)
            self._bump("completed")
        self._c_depth.set_value(self._batcher.depth())

    def _idle_probe(self):
        """Half-open probing without traffic: while the breaker is open
        and admission fast-fails everything, there may be no request left
        to probe with — so when the backoff expires, push the warmup
        sample through the ``serving.step`` path instead.  Runs on the
        batch thread's idle ticks; never raises."""
        if self._sample is None or self.breaker.state != OPEN:
            return
        if not self.breaker.allow():
            return                       # backoff not elapsed yet
        self._bump("probes")
        try:
            _fault.fire("serving.step")
            self._apply(*self._padded(self._sample, self.buckets.batch[0]))
        except Exception as exc:         # noqa: BLE001 — probe verdicts
            self.breaker.record_failure()
            self._note_step_failure(exc)
        else:
            self.breaker.record_success()
        self._c_breaker.set_value(self.breaker.state_code())

    # --------------------------------------------------------------- health --
    def alive(self):
        """Liveness: the batch thread is running."""
        return self._batcher.alive()

    def ready(self):
        """Readiness: started, warmed up, not draining, breaker not
        fast-failing.  False means "send traffic elsewhere", not "dead"."""
        return (self._ready.is_set() and self.alive()
                and not self._draining.is_set()
                and not self.breaker.engaged())

    def healthz(self):
        """The ``/healthz``-style snapshot a probe endpoint would serve.

        Carries everything a fleet router needs to RANK replicas without
        reaching into private state: ``breaker_state`` (0 closed /
        1 half-open / 2 open — same coding as the profiler counter),
        ``in_flight`` (accepted requests not yet resolved — queued plus
        mid-batch), ``last_error`` (``{"type", "age"}`` of the most
        recent step-level failure, monotonic seconds; ``None`` when the
        replica has never failed a step), and ``classes`` (the per-class
        SLO snapshot — deadline misses, p50/p99 latency — from
        ``TenantQoS.snapshot``; a bare server reports everything under
        ``"default"``).  The snapshot is non-blocking: one short stats
        copy under the server lock, every other field read from its own
        primitive — no device work, no queue waits."""
        with self._lock:
            s = self._stats
            in_flight = (s["admitted"] - s["completed"] - s["failed"]
                         - s["expired"])
            last = self._last_error
        return {"alive": self.alive(), "ready": self.ready(),
                "draining": self._draining.is_set(),
                "breaker": self.breaker.state,
                "breaker_state": self.breaker.state_code(),
                "queue_depth": self._batcher.depth(),
                "in_flight": max(0, in_flight),
                "classes": self._qos.snapshot(),
                "last_error": None if last is None else
                {"type": last[0], "age": time.monotonic() - last[1]}}

    @property
    def stats(self):
        with self._lock:
            out = dict(self._stats)
            out["distinct_shapes"] = len(self._shapes)
        out["queue_depth"] = self._batcher.depth()
        out["breaker"] = self.breaker.state
        return out

    @property
    def distinct_shapes(self):
        """Signatures ever dispatched (warmup included) — the executable
        count the bucket grid bounds; the load-test acceptance reads
        this next to the jit cache size."""
        with self._lock:
            return set(self._shapes)

    def telemetry(self, fmt="json"):
        """The unified metrics exposition: one
        ``telemetry.exposition`` payload — counters (the lifecycle
        totals), gauges (queue depth, in-flight, breaker state),
        per-phase latency histograms (``admit``/``queue``/``coalesce``/
        ``step``/``deliver`` span durations, ms), and the per-class SLO
        rows — under the SAME key schema every runtime serves.
        ``fmt="prom"`` renders the Prometheus-style text form.
        Non-blocking, same as ``healthz``."""
        h = self.healthz()
        with self._lock:
            counters = dict(self._stats)
        gauges = {"queue_depth": h["queue_depth"],
                  "in_flight": h["in_flight"],
                  "breaker_state": h["breaker_state"],
                  "ready": int(h["ready"]), "alive": int(h["alive"]),
                  "draining": int(h["draining"])}
        # the runtime-introspection families: jit-cache
        # behavior + stamped memory bytes, same keys on every runtime
        gauges.update(_telemetry.compile_gauges(self._name))
        gauges.update(self._mem_gauges)
        gauges.update(_telemetry.ckpt_gauges())
        snap = _telemetry.registry().snapshot(prefix=f"{self._name}::")
        # every registry gauge under this server's prefix (the profiler
        # counter series: shed/expired/batch_occupancy/...) rides the
        # exposition too — healthz-derived values win on key collision
        for k, v in snap["gauges"].items():
            gauges.setdefault(k, v)
        hist = snap["histograms"]
        for cname, csnap in self._qos.latency_snapshots().items():
            hist[f"class_{cname}_latency_s"] = csnap
        payload = _telemetry.exposition("inference_server", self._name,
                                        counters, gauges, hist,
                                        h["classes"])
        return _telemetry.render(payload, fmt)

    # ---------------------------------------------------------------- drain --
    def drain(self, timeout=None):
        """Graceful shutdown: stop admitting (submits raise
        ``ServerClosedError``), flush every queued and in-flight request
        to a terminal state — result, or an explicit error — then stop
        and join the batch thread.  After ``drain()`` every ``Request``
        ever returned by ``submit`` is ``done()``; an accepted request is
        never silently dropped.  True when the thread exited in time."""
        _fault.fire("serving.drain")
        self._draining.set()
        self._ready.clear()
        ok = self._batcher.drain(timeout)
        self._c_depth.set_value(self._batcher.depth())
        return ok

    close = drain

    def serve_forever(self, poll=0.05):
        """Block until SIGTERM/SIGINT (via ``fault.GracefulExit``), then
        drain — the preemption contract on the serving side:
        stop admitting, flush accepted work, exit clean."""
        with _fault.GracefulExit() as g:
            while not g.requested and self.alive():
                time.sleep(poll)
        return self.drain()


def _upload(leaf, device):
    """A host array (or tensor) as a tensor on ``device``, copied without
    a host sync (a pageable source is staged before the call returns)."""
    t = leaf if isinstance(leaf, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(leaf))
    return t.to(device, non_blocking=True)


def _label_shapes(module):
    exc = module._exec
    return {n: tuple(exc.arg_dict[n].shape[1:])
            for n in module._label_names if n in exc.arg_dict}


def module_apply(module, quantize=None):
    """Adapt a bound ``mx.mod.Module`` into a serving apply fn.

    Feeds batch leaves through ``Module.forward(is_train=False)`` on the
    module's own context; label arguments the symbol declares are fed
    zeros of the batch's size (inference heads ignore them — they only
    shape the executor's signature).  On the card the executor captures
    one inference graph per padded signature, so the graphs stay bounded
    by the batcher's bucket grid (``jit_cache_size`` reads the
    executor's ``graph_count``).  The returned fn gives the outputs as
    tensors on the module's device (the server copies them to the
    host); it runs on the batch thread only — it is not itself
    thread-safe.

    ``quantize="int8"`` serves the module's weights post-training
    quantized (``amp.quantize_weight``: symmetric per-channel int8 for
    every float param with ndim >= 2; bias/norm leaves stay full
    precision).  The dequantization runs INSIDE the captured graph — the
    graph's weight inputs are int8 payloads + f32 scales, ~4x fewer
    bytes than the f32 module's.  Still one graph per padded
    signature."""
    if quantize not in (None, "int8"):
        raise ValueError(f"module_apply: quantize={quantize!r} "
                         f"(expected None or 'int8')")
    if not module.binded:
        raise ValueError("module_apply: bind() the module first")
    if quantize == "int8":
        return _module_apply_int8(module)
    from ..io import DataBatch
    from ..ndarray import NDArray

    device = module._exec._device
    label_shapes = _label_shapes(module)

    def apply(*leaves):
        b = leaves[0].shape[0]
        label = [NDArray(torch.zeros((b,) + s, dtype=torch.float32,
                                     device=device))
                 for s in label_shapes.values()] or None
        module.forward(DataBatch(data=[NDArray(_upload(l, device))
                                       for l in leaves],
                                 label=label), is_train=False)
        outs = [o._data for o in module.get_outputs()]
        return outs[0] if len(outs) == 1 else tuple(outs)

    apply.jit_cache_size = lambda: module._exec.graph_count()
    apply.jit_cache_owner = module
    return apply


def _module_apply_int8(module):
    """The ``quantize="int8"`` arm of ``module_apply``: snapshot the
    bound params once, quantize the >=2-D float weights per-channel
    (axis 0 — MXNet ``(units, in_units)`` kernel layout), and run the
    module's symbol through one ``graphs.captured`` function whose
    parameters are the int8 payloads + scales, the other parameters and
    the aux states, all on the module's device.  Label args become
    in-graph zeros."""
    from ..amp.quantize import Int8Quantizer
    from ..executor import _trace
    from ..graphs import captured

    exc = module._exec
    data_names = list(module._data_names)
    label_shapes = _label_shapes(module)
    quant = Int8Quantizer(axis=0)
    args = {n: v._data.detach().clone() for n, v in exc.arg_dict.items()
            if n not in data_names and n not in label_shapes}
    params = {"args": quant.quantize(args),
              "aux": {n: v._data.detach().clone()
                      for n, v in exc.aux_dict.items()}}
    symbol, ctx, device = exc._symbol, exc._ctx, exc._device

    def body(p, *leaves):
        b = leaves[0].shape[0]
        vals = quant.dequantize(p["args"])
        for n, leaf in zip(data_names, leaves):
            vals[n] = leaf
        for n, s in label_shapes.items():
            vals[n] = torch.zeros((b,) + s, dtype=torch.float32,
                                  device=leaves[0].device)
        with ctx, torch.no_grad():
            outs, _aux_updates = _trace(symbol, vals, dict(p["aux"]),
                                        False)
        return tuple(outs)

    qapply = captured(body)

    def apply(*leaves):
        if device.type == "cuda":       # the graph copies the host leaves
            outs = qapply(params, *leaves)
        else:
            outs = qapply(params, *[_upload(l, device) for l in leaves])
        return outs[0] if len(outs) == 1 else tuple(outs)

    apply.jit_cache_size = qapply._cache_size
    apply.jit_cache_owner = qapply
    apply.params = params
    # the bytes of the graph's weight inputs (payloads, scales and the
    # parameters left in full precision)
    apply.weight_bytes = sum(t.numel() * t.element_size()
                             for t in params["args"].values())
    return apply
