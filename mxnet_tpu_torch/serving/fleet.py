"""ServingFleet: N ``InferenceServer`` replicas behind one front door
(the port of ``mxnet_tpu/serving/fleet.py``).

One process is one blast radius — a wedged batch loop, a tripped
breaker, or a weight reload takes the whole endpoint down — so serving
runs as a fleet of replicas behind a health-aware router:

- **health-aware routing** — ``submit()`` ranks replicas by their
  ``healthz()`` snapshot (ready, breaker state, queue depth) plus the
  fleet's own in-flight accounting, picks the least-loaded one, and
  enforces a per-replica in-flight cap.  Replicas whose breaker is OPEN
  or whose batch thread died are *quarantined*: no traffic until a probe
  succeeds, re-probed on the ``fault.backoff_delay`` schedule.
- **failover** — a request a replica ACCEPTED but then failed
  (batch-thread death, breaker trip, post-acceptance shed) is
  re-dispatched to a healthy replica within its original deadline.
  Inference is idempotent, so re-dispatch is safe; admission-level
  refusals (``RejectedError`` out of ``submit``) are never retried —
  shedding is the client's verdict.  Killing a replica under traffic
  drops zero accepted requests.
- **rolling weight updates** — ``WeightUpdater`` watches a
  ``CheckpointManager`` directory (``parallel.checkpoint.wait_for_new``)
  and streams each new snapshot through the fleet one replica at a
  time: quarantine → drain in-flight → hot-swap the params (same
  shapes/dtypes ⇒ the SAME captured graphs — a weight update never
  captures) → warmup probe → readmit, with automatic rollback to the
  previous weights when the post-swap probe fails.  A poisoned snapshot
  never serves a single client request.
- **fleet lifecycle** — ``drain()`` resolves every accepted request
  fleet-wide then drains replicas concurrently; ``serve_forever()``
  latches SIGTERM via ``fault.GracefulExit``.

The port's differences from the JAX fleet: the replicas of
``ServingFleet.replicated`` share one ``graphs.captured`` function, whose
graphs read one set of static parameter slots — a replica's params are
copied into them when it calls with other params than the last caller
(JAX swaps a pointer); ``validate_params`` compares numpy and torch
dtypes through one mapping (a snapshot's ``V2`` leaves are bfloat16);
``WeightUpdater`` moves a snapshot's leaves to the served params'
device once, at swap time.

Every fleet failure mode is deterministically injectable through the
``fleet.route`` / ``fleet.dispatch`` / ``fleet.swap`` / ``fleet.probe``
fault points.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time

import numpy as np
import torch

from .. import fault as _fault
from .. import profiler as _profiler
from .. import telemetry as _telemetry
from .admission import (DeadlineExceededError, NonFiniteOutputError,
                        RejectedError, Request, ServerClosedError)
from .batcher import BucketSpec
from .breaker import OPEN
from .server import InferenceServer

__all__ = ["ServingFleet", "ReplicaGroup", "HotSwapApply", "WeightUpdater",
           "SnapshotRejectedError", "SnapshotPrunedError",
           "UpdateRolledBackError", "validate_params"]

_logger = logging.getLogger(__name__)


class SnapshotRejectedError(RuntimeError):
    """A weight snapshot failed validation (leaf count / shape / dtype
    drift against the served params, or non-finite values) and was NOT
    applied to any replica.  The caller skips the snapshot — the fleet
    keeps serving the previous weights at full capacity."""


class SnapshotPrunedError(RuntimeError):
    """The snapshot path vanished between discovery and read — retention
    pruned it (``CheckpointManager._retain``) while the updater held the
    name.  STALE, not bad: retention never prunes the newest committed
    snapshot, so a newer one exists — re-poll and apply that instead of
    counting this one as skipped."""


class UpdateRolledBackError(RuntimeError):
    """A rolling update aborted: a post-swap probe failed, the affected
    replica was rolled back to its previous weights, and any replicas
    already updated were rolled back too — the fleet is back on the old
    weights at full capacity.  The snapshot is poisoned in a way
    validation could not see (finite params, non-finite outputs)."""


class HotSwapApply:
    """A serving apply fn with a hot-swappable parameter slot.

    Wraps ``fn(params, *batch_leaves)`` — typically ONE
    ``graphs.captured`` function shared by every replica of a fleet —
    plus this replica's own ``params`` container.  ``swap()`` replaces
    the whole container in a single attribute store (atomic under the
    GIL; the update protocol drains the replica first anyway) and
    returns the previous container for rollback.  As long as the new
    leaves match the old leaf-for-leaf in shape and dtype, the captured
    function keeps replaying the SAME graphs: a weight update never
    captures.

    ``quantizer`` (optional) is the ingest transform for a
    reduced-precision fleet — typically ``amp.Int8Quantizer().quantize``
    with ``fn`` built from ``Int8Quantizer.wrap``.  It maps a
    full-precision training snapshot into this fleet's served
    representation; ``WeightUpdater`` runs incoming snapshots through
    it BEFORE ``validate_params``, so an f32 training job streams
    rolling updates into an int8 fleet instead of tripping the
    dtype-drift rejection.
    """

    def __init__(self, fn, params, quantizer=None):
        self._fn = fn
        self.params = params
        self.quantizer = quantizer
        # expose the shared function's graph count so every replica's
        # InferenceServer reports REAL graph growth — replica 1's warmup
        # against graphs replica 0 already captured records hits, not
        # phantom captures.  jit_cache_owner names the SHARED fn (not
        # this per-replica wrapper) so concurrent growth observations
        # across replicas dedupe through one high-water mark.
        cache_size = getattr(fn, "_cache_size", None)
        if callable(cache_size):
            self.jit_cache_size = cache_size
            self.jit_cache_owner = fn

    def __call__(self, *leaves):
        return self._fn(self.params, *leaves)

    def swap(self, new_params):
        """Install ``new_params``; returns the previous container."""
        old, self.params = self.params, new_params
        return old


def _param_items(params):
    """``(key, leaf)`` pairs of a params container — dict keys (sorted),
    or positional indices for sequences.  The comparison space of
    ``validate_params``."""
    if isinstance(params, dict):
        return [(k, params[k]) for k in sorted(params)]
    return list(enumerate(params))


def _dtype_name(leaf):
    """One name for a leaf's dtype across numpy and torch: a torch
    dtype's, a numpy dtype's, and ``bfloat16`` for the two-byte ``V2``
    leaves a snapshot holds bfloat16 in."""
    dt = getattr(leaf, "dtype", None)
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    dt = np.asarray(leaf).dtype if dt is None else np.dtype(dt)
    return "bfloat16" if dt == np.dtype("V2") else dt.name


def _as_torch(leaf):
    """A torch tensor of a host leaf (``V2`` read as bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.ascontiguousarray(np.asarray(leaf))
    if a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _all_finite(leaf):
    """Every value of ``leaf`` finite, checked where the leaf lies."""
    if isinstance(leaf, torch.Tensor) or \
            np.asarray(leaf).dtype == np.dtype("V2"):
        return bool(torch.isfinite(_as_torch(leaf)).all())
    return bool(np.all(np.isfinite(np.asarray(leaf))))


def _served_like(new, current):
    """``new`` (validated against ``current``) with each leaf placed as
    the served leaf is: a tensor on the served tensor's device, or the
    host array as it is where the served leaf is one."""
    def place(n, c):
        if isinstance(c, torch.Tensor):
            return _as_torch(n).to(c.device)
        return n
    if isinstance(new, dict):
        return {k: place(new[k], current[k]) for k in new}
    return [place(n, c) for n, c in zip(new, current)]


def validate_params(new, current):
    """Gate a snapshot BEFORE any replica touches it: same container
    kind and keys as the served params, same shape and dtype
    leaf-for-leaf (anything else would change the graphs' signature —
    the capture the whole serving stack exists to keep off the serving
    path; numpy and torch dtypes compare by name, a ``V2`` leaf as
    bfloat16), and every new value finite (NaN/Inf weights poison every
    output they touch).  Raises ``SnapshotRejectedError``; on success
    returns ``new`` unchanged — the container shape the apply fn
    indexes by survives."""
    if isinstance(new, dict) != isinstance(current, dict):
        raise SnapshotRejectedError(
            f"snapshot params are a {type(new).__name__}, the fleet "
            f"serves a {type(current).__name__} — the apply fn's "
            f"indexing would break")
    new_items, cur_items = _param_items(new), _param_items(current)
    if len(new_items) != len(cur_items):
        raise SnapshotRejectedError(
            f"snapshot has {len(new_items)} param leaves, the fleet "
            f"serves {len(cur_items)} — structure drift would recapture")
    for (nk, n), (ck, c) in zip(new_items, cur_items):
        if nk != ck:
            raise SnapshotRejectedError(
                f"snapshot param key {nk!r} != served key {ck!r} — the "
                f"apply fn would read the wrong leaf")
        n_shape, c_shape = tuple(np.shape(n)), tuple(np.shape(c))
        if n_shape != c_shape:
            raise SnapshotRejectedError(
                f"snapshot leaf {nk!r} shape {n_shape} != served "
                f"{c_shape} — a shape change would recapture every "
                f"bucket graph")
        n_dt, c_dt = _dtype_name(n), _dtype_name(c)
        if n_dt != c_dt:
            raise SnapshotRejectedError(
                f"snapshot leaf {nk!r} dtype {n_dt} != served {c_dt} — a "
                f"dtype change would recapture every bucket graph")
        if not _all_finite(n):
            raise SnapshotRejectedError(
                f"snapshot leaf {nk!r} contains non-finite values — a "
                f"poisoned snapshot must never reach a replica")
    return new


class _Replica:
    """One fleet member.  Every mutable field is guarded by the FLEET's
    lock — the replica's own server has its own synchronisation."""

    __slots__ = ("index", "server", "apply", "group", "in_flight",
                 "quarantined", "manual", "probe_attempts", "next_probe_at",
                 "probing")

    def __init__(self, index, server, apply_fn, group="default"):
        self.index = index
        self.server = server
        self.apply = apply_fn
        self.group = group          # ReplicaGroup name, fixed for life
        self.in_flight = 0          # fleet-dispatched, not yet resolved
        self.quarantined = False
        self.manual = False         # True: an updater owns readmission
        self.probe_attempts = 0
        self.next_probe_at = 0.0
        self.probing = False


class ReplicaGroup:
    """A named partition of a fleet's replicas with its own routing set.

    Groups are how the fleet disaggregates WORKLOADS, not just load:
    requests routed to group "prefill" can never queue behind (or stall)
    group "decode" — the structural interference fix the LLM serving
    exemplars (PAPERS.md) call
    prefill/decode disaggregation.  A ``QoSClass(group=...)`` pins a
    priority class to a group; ``submit(group=...)`` pins one request.
    Each group carries its own census expectation (the bucket-grid
    executable count a member must have warmed before it may serve) and
    its own capacity arithmetic for the autoscaler.

    Constructed through ``ServingFleet`` (pass ``applies`` as a dict of
    ``{group_name: [apply_fns]}``); this object is the fleet's
    per-group view, exposed via ``ServingFleet.groups``."""

    __slots__ = ("name", "replicas")

    def __init__(self, name):
        self.name = str(name)
        self.replicas = []          # mutated only under the FLEET lock


class ServingFleet:
    """N ``InferenceServer`` replicas behind one ``submit()`` front door.

    ``applies`` is one serving apply fn per replica — for weight-updated
    fleets, ``HotSwapApply`` instances sharing one jitted
    ``fn(params, *leaves)`` (see ``ServingFleet.replicated``) — or a
    dict ``{group_name: [apply_fns]}`` to partition the fleet into named
    ``ReplicaGroup``s with disjoint routing sets.  The fleet builds its
    own replicas (``<name>-r<i>``) so each gets its own breaker, queue,
    and counters; pass ``breaker=`` a FACTORY (callable) when you want
    non-default breaker tuning — a shared instance would couple the
    replicas' failure domains, which is the opposite of a fleet.

    **Dynamic membership.**  ``add_replica()`` grows a group
    (spawn → warmup until the bucket-grid census is complete → only then
    join the routing set) and ``retire_replica()`` shrinks it
    (manual-quarantine → drain outstanding fleet work → remove, with the
    retired member's counter series cleared) — both under live traffic
    with zero dropped accepted requests.  ``FleetAutoscaler``
    (``serving.autoscale``) drives them from queue-depth/occupancy/
    deadline-miss signals.

    **Per-tenant QoS.**  Pass ``qos=TenantQoS(...)`` to put priority
    classes and per-tenant token buckets at the front door: an abusive
    tenant sheds with ``TenantThrottledError`` while its neighbours are
    untouched, a class's ``admit_frac`` reserves headroom for the
    classes above it, ``QoSClass(group=...)`` pins a class to a replica
    group, and ``healthz()["classes"]`` reports per-class deadline-miss
    and p50/p99 latency.

    Failure matrix (what a client sees):

    - routed + served        → result
    - no ready replica / all at the in-flight cap → ``RejectedError`` at
      ``submit`` (admission-level; never retried — retry another cell)
    - replica died / breaker tripped after acceptance → transparent
      re-dispatch; an error surfaces only when every healthy replica has
      been tried or the deadline passed
    - deadline passed (queue, failover wait) → ``DeadlineExceededError``
    - non-finite output row → ``NonFiniteOutputError`` (data fault —
      deterministic, so never re-dispatched)

    Thread contract (mxlint-gated): fleet state lives behind
    ``self._lock`` (plain field reads/writes only — health reads,
    ``fault.fire`` and replica calls happen OUTSIDE it); the router
    thread and client threads share work through ``queue.Queue`` /
    ``Event``s; per-replica state is fleet-lock-guarded fields on
    ``_Replica``.
    """

    _TICK = 0.02             # router housekeeping cadence

    def __init__(self, applies, *, buckets=(1, 2, 4, 8), sample=None,
                 name="Fleet", default_deadline=None, max_inflight=None,
                 max_redispatch=None, probe_base_delay=0.05,
                 probe_max_delay=2.0, probe_jitter=0.25,
                 probe_deadline=5.0, breaker=None, max_queue=128,
                 qos=None, memory_report=None, **server_kw):
        if isinstance(applies, dict):
            group_map = {str(g): list(fns) for g, fns in applies.items()}
        else:
            group_map = {"default": list(applies)}
        n_total = sum(len(fns) for fns in group_map.values())
        if n_total == 0:
            raise ValueError("ServingFleet: need at least one replica")
        self._name = name
        self.buckets = buckets if isinstance(buckets, BucketSpec) \
            else BucketSpec(buckets)
        self._sample = sample
        # live memory gauges: one stamped costguard report
        # describes every replica (same executables fleet-wide)
        self._mem_gauges = _telemetry.memory_gauges(memory_report)
        self._default_deadline = default_deadline
        self._qos = qos
        if qos is not None:
            for qc in qos.classes.values():
                if qc.group is not None and qc.group not in group_map:
                    raise ValueError(
                        f"ServingFleet: QoS class {qc.name!r} pins group "
                        f"{qc.group!r}, fleet has {sorted(group_map)}")
        # cap = one replica's total capacity: its queue plus one full
        # batch in flight.  Beyond that the replica would shed anyway —
        # the fleet's cap just makes the verdict immediate and keeps the
        # ranking honest.
        self._max_inflight = int(max_inflight) if max_inflight is not None \
            else int(max_queue) + self.buckets.max_batch
        self._max_redispatch = int(max_redispatch) \
            if max_redispatch is not None else 2 * n_total + 2
        self._probe_base = float(probe_base_delay)
        self._probe_max = float(probe_max_delay)
        self._probe_jitter = float(probe_jitter)
        self._probe_deadline = float(probe_deadline)
        self._breaker = breaker          # factory/instance, reused by scale-up
        self._max_queue = int(max_queue)
        self._server_kw = dict(server_kw)
        self.replicas = []
        self.groups = {g: ReplicaGroup(g) for g in group_map}
        self._next_index = 0
        for gname, fns in group_map.items():
            for apply_fn in fns:
                rep = self._build_replica(apply_fn, gname,
                                          self._next_index)
                self._next_index += 1
                self.replicas.append(rep)
                self.groups[gname].replicas.append(rep)
        self._lock = threading.Lock()
        self._stats = {"admitted": 0, "completed": 0, "failed": 0,
                       "expired": 0, "shed": 0, "rejected": 0,
                       "redispatched": 0, "resumed": 0, "probes": 0,
                       "swaps": 0, "rollbacks": 0, "scale_ups": 0,
                       "retired": 0}
        self._outstanding = 0
        self._retry_q = queue.Queue()
        self._started = threading.Event()
        self._draining = threading.Event()
        self._stop = threading.Event()
        self._router = threading.Thread(target=self._router_loop,
                                        name=f"{name}-router", daemon=True)
        self._c_ready = _profiler.Counter(None, f"{name}::ready_replicas")
        self._c_quar = _profiler.Counter(None, f"{name}::quarantined")
        self._c_redisp = _profiler.Counter(None, f"{name}::redispatched")
        self._c_out = _profiler.Counter(None, f"{name}::outstanding")
        self._c_swaps = _profiler.Counter(None, f"{name}::swaps")
        self._c_rollbacks = _profiler.Counter(None, f"{name}::rollbacks")

    def _build_replica(self, apply_fn, group, idx):
        """One new ``_Replica`` (server + breaker + counters) under the
        given fleet-unique index.  Does NOT insert it into the routing
        set — construction-time callers append directly, ``add_replica``
        appends only after warmup completes."""
        brk = self._breaker() if callable(self._breaker) else self._breaker
        srv = InferenceServer(
            apply_fn, buckets=self.buckets, sample=self._sample,
            breaker=brk, max_queue=self._max_queue,
            name=f"{self._name}-r{idx}", **self._server_kw)
        return _Replica(idx, srv, apply_fn, group=group)

    @property
    def grid_census(self):
        """Executables the bucket grid allows — the per-group warmup
        completeness bar: a scale-up replica joins the routing set only
        once its server has this many distinct warmed signatures (with a
        shared jitted fn they are jit-cache HITS, so growing the fleet
        never grows the fleet-wide executable census)."""
        n_len = 1 if self.buckets.length is None else len(self.buckets.length)
        return len(self.buckets.batch) * n_len

    @classmethod
    def replicated(cls, fn, params, n, quantizer=None, **kw):
        """A fleet of ``n`` replicas of one jitted ``fn(params,
        *batch_leaves)``, each with its own hot-swappable ``params``
        slot (initially shared refs — a rolling update re-points them
        one replica at a time).  One jit cache serves the whole fleet,
        so the executable census of the bucket grid covers ALL replicas,
        not each.  ``quantizer`` (see ``HotSwapApply``) makes this an
        int8 fleet that keeps accepting f32 training snapshots."""
        return cls([HotSwapApply(fn, list(params), quantizer=quantizer)
                    for _ in range(n)], **kw)

    # ------------------------------------------------------------ lifecycle --
    def start(self, warmup=None):
        """Start every replica (warmup per ``InferenceServer.start`` —
        with a shared jitted fn only the first replica compiles; the
        rest hit its cache), then the router thread."""
        if self._draining.is_set():
            raise ServerClosedError(f"{self._name}: already drained")
        started = []
        try:
            for rep in self._members():
                rep.server.start(warmup=warmup)
                started.append(rep)
        except Exception:
            # a failed bring-up must not leak the replicas that DID
            # start (their batch threads would outlive the fleet)
            for rep in started:
                rep.server.drain(timeout=5)
            raise
        if not self._started.is_set():
            self._started.set()
            self._router.start()
        return self

    def __enter__(self):
        if not self._started.is_set():
            self.start()
        return self

    def __exit__(self, *exc):
        self.drain()
        return False

    # ------------------------------------------------------------ admission --
    def _headroom_check(self, qc, group):
        """The class's ``admit_frac`` reservation: the class admits only
        while TOTAL in-flight load (all classes) on the (group's) live
        capacity is under its fraction — the top ``1 - admit_frac`` is
        reserved exclusively for higher classes.  Raises
        ``RejectedError`` when the threshold is already met."""
        if qc.admit_frac >= 1.0:
            return
        with self._lock:
            reps = self.replicas if group is None \
                else self.groups[group].replicas
            live = [rep for rep in reps if not rep.quarantined]
            used = sum(rep.in_flight for rep in live)
        capacity = max(1, len(live)) * self._max_inflight
        if used >= qc.admit_frac * capacity:
            raise RejectedError(
                f"{self._name}: class {qc.name!r} is at its admit_frac "
                f"({qc.admit_frac:.2f}) share of capacity "
                f"({used}/{capacity} in flight) — shedding to preserve "
                f"headroom for higher classes")

    def submit(self, data, deadline=None, tenant=None, klass=None,
               group=None):
        """Route one request to the best replica; returns its fleet-side
        ``Request`` future (failover is transparent — the future resolves
        exactly once, whichever replica ends up serving it).

        ``tenant``/``klass`` are the QoS labels (active when the fleet
        was built with ``qos=``): the class supplies the default
        deadline, may pin a ``ReplicaGroup``, and its ``admit_frac``
        headroom reservation is enforced here.  ``group`` pins this one
        request to a named group (routing and failover stay inside it).

        Refusals are immediate: ``ServerClosedError`` while draining,
        ``TenantThrottledError`` for an over-rate tenant,
        ``RejectedError`` when no ready replica has in-flight headroom.
        An admission-level refusal never touched any replica's queue and
        is never retried by the fleet."""
        t0_us = _telemetry.now_us() if _telemetry.ACTIVE else None
        _fault.fire("fleet.route")
        if self._draining.is_set():
            self._count("rejected")
            raise ServerClosedError(f"{self._name}: draining — "
                                    f"not admitting")
        if not self._started.is_set():
            self._count("rejected")
            raise RejectedError(f"{self._name}: not started")
        qc = None
        if self._qos is not None:
            try:
                qc = self._qos.classify(tenant=tenant, klass=klass)
            except RejectedError:
                self._count("shed")
                raise
            if group is None:
                group = qc.group
            if deadline is None:
                deadline = qc.deadline
        if group is not None and group not in self.groups:
            if qc is not None:
                self._qos.refund(tenant, qc)
            self._count("rejected")
            raise RejectedError(f"{self._name}: unknown replica group "
                               f"{group!r} — have {sorted(self.groups)}")
        if deadline is None:
            deadline = self._default_deadline
        freq = Request(data, deadline=deadline, tenant=tenant,
                       klass=None if qc is None else qc.name)
        try:
            if qc is not None:
                self._headroom_check(qc, group)
        except RejectedError:
            self._qos.refund(tenant, qc)
            self._count("shed")
            raise
        with self._lock:
            self._stats["admitted"] += 1
            self._outstanding += 1
        # trace from the fleet's front door: no queue phase (routing is
        # synchronous; waits between failover hops get their own spans)
        if t0_us is not None:
            _telemetry.begin_request(freq, self._name, t0_us=t0_us,
                                     queue=False)
        try:
            self._dispatch(freq, group, frozenset(), attempts=0,
                           from_router=False)
        except BaseException:
            # refusal accounting lives in shed/rejected (outside the
            # admitted == completed+failed+expired invariant) — the
            # exception TYPE carries the deadline-vs-shed distinction
            with self._lock:
                self._stats["admitted"] -= 1
                self._outstanding -= 1
                self._stats["shed"] += 1
            if qc is not None:
                self._qos.refund(tenant, qc)
            _telemetry.abort_request(freq)
            raise
        if qc is not None:
            self._qos.track(qc, freq)
        self._c_out.set_value(self.outstanding)
        return freq

    def __call__(self, data, deadline=None, timeout=None, **kw):
        """Blocking convenience: submit + ``result()`` (``tenant`` /
        ``klass`` / ``group`` pass through)."""
        return self.submit(data, deadline=deadline, **kw).result(timeout)

    @property
    def outstanding(self):
        """Accepted fleet requests not yet resolved."""
        with self._lock:
            return self._outstanding

    def _count(self, key, n=1):
        with self._lock:
            self._stats[key] += n

    # -------------------------------------------------------------- routing --
    def _remaining(self, freq):
        """Seconds left on the request's ORIGINAL deadline (None =
        unbounded); <= 0 means expired."""
        if freq.deadline is None:
            return None
        return freq.deadline - time.monotonic()

    def _ranked(self, excluded, group=None):
        """Ready, unquarantined, under-cap replicas of ``group`` (None =
        every group), least-loaded first: ranked on (fleet in-flight,
        replica queue depth) — both read from the replica's public
        ``healthz`` snapshot and the fleet's own books, never from
        private server state."""
        with self._lock:
            reps = self.replicas if group is None \
                else self.groups[group].replicas
            snap = [(rep, rep.in_flight, rep.quarantined)
                    for rep in reps if rep.index not in excluded]
        cands = []
        for rep, in_flight, quarantined in snap:
            if quarantined or in_flight >= self._max_inflight:
                continue
            h = rep.server.healthz()
            if not h["ready"]:
                continue
            cands.append((in_flight, h["queue_depth"], rep.index, rep))
        cands.sort(key=lambda c: c[:3])
        return [c[3] for c in cands]

    def _dispatch(self, freq, group, excluded, attempts, from_router,
                  resume=None):
        """Hand ``freq`` to the best replica of its group and register
        the completion callback.  True when a replica accepted it.  When
        none can: front-door callers get the admission verdict as a
        raise; the router gets False and keeps the request pending.

        ``resume`` is a ``SequenceSnapshot`` salvaged off a failed
        generation replica: when set and the target replica
        supports ``submit_resume``, the redispatch carries the tokens
        already generated — failover costs the remaining tokens, not a
        restart from scratch."""
        remaining = self._remaining(freq)
        if remaining is not None and remaining <= 0:
            # the deadline verdict, not an admission one: a client must
            # never read "retry elsewhere" on a request whose GLOBAL
            # deadline has passed
            raise DeadlineExceededError(
                f"{self._name}: deadline already passed at routing time")
        last_refusal = None
        for rep in self._ranked(excluded, group):
            # reserve the slot under the lock BEFORE submitting — two
            # client threads racing the same replica must not both slip
            # under the cap
            with self._lock:
                if rep.quarantined or rep.in_flight >= self._max_inflight:
                    continue
                rep.in_flight += 1
            dspan = None
            if freq.trace is not None:
                # the hop span: replica-side phases nest under it, and
                # the wait since the previous hop closes here
                _telemetry.end_span(freq, "failover")
                dspan = _telemetry.open_span(freq, "dispatch",
                                             replica=f"r{rep.index}")
            try:
                _fault.fire("fleet.dispatch")
                can_resume = resume is not None \
                    and hasattr(rep.server, "submit_resume")
                if can_resume:
                    # replica-side tracing stays suppressed either way:
                    # submit_resume has no trace_parent seam, and a
                    # partial replica-only tree would fail audit
                    with _telemetry.suppress():
                        rreq = rep.server.submit_resume(
                            resume, deadline=remaining)
                    self._count("resumed")
                elif dspan is None and _telemetry.ACTIVE:
                    # the sampling decision was made at the front door —
                    # an unsampled fleet request must not be re-sampled
                    # into a partial replica-only tree
                    with _telemetry.suppress():
                        rreq = rep.server.submit(freq.data,
                                                 deadline=remaining)
                else:
                    rreq = rep.server.submit(freq.data, deadline=remaining,
                                             trace_parent=dspan)
            except RejectedError as exc:
                with self._lock:
                    rep.in_flight -= 1
                if dspan is not None:
                    dspan.end(error=type(exc).__name__)
                last_refusal = exc
                continue
            except BaseException as exc:
                with self._lock:
                    rep.in_flight -= 1
                if dspan is not None:
                    dspan.end(error=type(exc).__name__)
                raise
            rreq.add_done_callback(
                lambda r, _rep=rep, _g=group, _ex=excluded, _at=attempts:
                self._on_replica_done(freq, _g, _rep, _ex, _at, r))
            return True
        if from_router:
            if last_refusal is not None and freq.trace is not None:
                # every hop of this pass refused and closed the failover
                # span: the wait until the router's next pass is failover
                # time too, or the tree leaves it unattributed
                _telemetry.open_span(freq, "failover",
                                     error=type(last_refusal).__name__)
            return False
        if last_refusal is not None:
            raise RejectedError(
                f"{self._name}: every ready replica refused "
                f"({last_refusal}) — shedding")
        raise RejectedError(
            f"{self._name}: no ready replica with in-flight headroom — "
            f"shedding")

    def _on_replica_done(self, freq, group, rep, excluded, attempts, rreq):
        """Replica-side resolution (runs on the replica's batch thread,
        or on the refusing thread).  Success and terminal errors resolve
        the fleet future; retryable failures go back to the router."""
        with self._lock:
            rep.in_flight -= 1
        err = rreq.exception(timeout=0)          # already resolved
        if err is None:
            self._finish(freq, result=rreq.result(0))
            return
        if isinstance(err, (DeadlineExceededError, NonFiniteOutputError)) \
                or self._stop.is_set():
            # deadline is global; a NaN output is the INPUT's fault and
            # will reproduce on any replica — never re-dispatch either
            self._finish(freq, error=err)
            return
        if freq.trace is not None:
            # the hop failed retryably: the wait until the next dispatch
            # (or the terminal verdict) is failover time, attributed
            _telemetry.open_span(freq, "failover",
                                 from_replica=f"r{rep.index}",
                                 error=type(err).__name__)
        self._retry_q.put((freq, group, frozenset(excluded) | {rep.index},
                           attempts + 1, err))

    def _finish(self, freq, result=None, error=None):
        if error is None:
            freq.set_result(result)
            key = "completed"
        else:
            freq.set_error(error)
            key = "expired" if isinstance(error, DeadlineExceededError) \
                else "failed"
        with self._lock:
            self._stats[key] += 1
            self._outstanding -= 1

    # ---------------------------------------------------------- router thread --
    def _router_loop(self):
        """Failover + quarantine housekeeping: re-dispatches failed-over
        requests, watches replica health, schedules quarantine probes.
        Exits only when the fleet stops — and never with a pending
        request unresolved."""
        pending = []
        try:
            while True:
                try:
                    item = self._retry_q.get(timeout=self._TICK)
                except queue.Empty:
                    item = None
                if item is not None:
                    pending.append(item)
                while True:          # drain whatever else arrived
                    try:
                        pending.append(self._retry_q.get_nowait())
                    except queue.Empty:
                        break
                pending = self._service_pending(pending)
                self._health_scan()
                if self._stop.is_set() and not pending \
                        and self._retry_q.empty():
                    return
        finally:
            # crashed or stopping: strand nothing
            leftovers = list(pending)
            while True:
                try:
                    leftovers.append(self._retry_q.get_nowait())
                except queue.Empty:
                    break
            for freq, _g, _ex, _at, err in leftovers:
                if not freq.done():
                    self._finish(freq, error=ServerClosedError(
                        f"{self._name}: fleet stopped before this request "
                        f"could be re-dispatched (last replica error: "
                        f"{err!r})"))

    def _service_pending(self, pending):
        """One pass over the failover backlog.  Returns what is still
        waiting for a routable replica."""
        still = []
        for entry in pending:
            freq, group, excluded, attempts, last_err = entry
            if freq.done():
                continue
            if freq.expired():
                self._finish(freq, error=DeadlineExceededError(
                    f"deadline exceeded during fleet re-dispatch (last "
                    f"replica error: {last_err!r})"))
                continue
            if attempts > self._max_redispatch:
                self._finish(freq, error=last_err)
                continue
            try:
                # a generation replica that died with salvaged tokens
                # left the snapshot on its terminal error — the next
                # replica resumes instead of regenerating
                ok = self._dispatch(freq, group, excluded, attempts,
                                    from_router=True,
                                    resume=getattr(last_err, "snapshot",
                                                   None))
            except Exception as exc:    # injected fleet.dispatch fault —
                self._finish(freq, error=exc)   # resolved, never dropped
                continue
            if ok:
                self._count("redispatched")
                self._c_redisp.increment()
                continue
            if self._draining.is_set() and not self._any_ready(group):
                self._finish(freq, error=ServerClosedError(
                    f"{self._name}: draining with no ready replica — "
                    f"request not served (last replica error: "
                    f"{last_err!r})"))
                continue
            if not self._group_alive(group):
                # every batch thread this request may route to is dead:
                # nothing in-process can ever serve it again — a
                # deadline-less request must resolve, not hang until
                # someone thinks to call drain()
                self._finish(freq, error=ServerClosedError(
                    f"{self._name}: every routable replica batch thread "
                    f"is dead — request not served (last replica error: "
                    f"{last_err!r})"))
                continue
            if excluded:
                # nothing OUTSIDE the excluded set can take it right now:
                # open the set back up (an excluded replica may have
                # healed) and bill one attempt for the failed pass, so a
                # request that keeps failing everywhere stays bounded by
                # max_redispatch instead of spinning forever
                excluded, attempts = frozenset(), attempts + 1
            still.append((freq, group, excluded, attempts, last_err))
        return still

    def _members(self, group=None):
        """Membership snapshot (list copy under the lock — replicas may
        be retired or added from other threads at any time)."""
        with self._lock:
            return list(self.replicas if group is None
                        else self.groups[group].replicas)

    def _any_ready(self, group=None):
        with self._lock:
            reps = list(self.replicas if group is None
                        else self.groups[group].replicas)
            quarantined = {rep.index for rep in reps if rep.quarantined}
        return any(rep.server.ready() for rep in reps
                   if rep.index not in quarantined)

    def _group_alive(self, group=None):
        return any(rep.server.alive() for rep in self._members(group))

    # ------------------------------------------------------------ quarantine --
    def _health_scan(self):
        """Router-tick health pass: quarantine replicas that died or
        tripped OPEN; schedule probes for auto-quarantined ones."""
        now = time.monotonic()
        n_ready, n_quar = 0, 0
        for rep in self._members():
            with self._lock:
                quarantined = rep.quarantined
                manual, probing = rep.manual, rep.probing
                next_at = rep.next_probe_at
            if not quarantined:
                if rep.server.ready():
                    n_ready += 1
                if not self._draining.is_set():
                    dead = not rep.server.alive()
                    tripped = rep.server.breaker.state == OPEN
                    if dead or tripped:
                        self.quarantine(
                            rep, manual=False,
                            reason="batch thread dead" if dead
                            else "breaker OPEN")
                        n_quar += 1
                continue
            n_quar += 1
            if manual or probing or now < next_at \
                    or self._draining.is_set():
                continue
            self._probe(rep)
        self._c_ready.set_value(n_ready)
        self._c_quar.set_value(n_quar)

    def quarantine(self, rep, manual=True, reason="manual"):
        """Take one replica out of the routing set.  ``manual=True``
        (the updater's mode) suppresses auto-readmission — the caller
        owns the replica until ``readmit``; ``manual=False`` hands it to
        the router's probe schedule."""
        rep = self._resolve(rep)
        with self._lock:
            already = rep.quarantined
            rep.quarantined = True
            rep.manual = bool(manual)
            if not already:
                rep.probe_attempts = 0
                rep.next_probe_at = time.monotonic() + _fault.backoff_delay(
                    1, self._probe_base, self._probe_max,
                    self._probe_jitter)
        if not already:
            _logger.warning("%s: replica r%d quarantined (%s)",
                            self._name, rep.index, reason)
        return rep

    def readmit(self, rep):
        """Put a quarantined replica back in the routing set."""
        rep = self._resolve(rep)
        with self._lock:
            rep.quarantined = False
            rep.manual = False
            rep.probe_attempts = 0
            rep.probing = False

    def _resolve(self, rep):
        """A replica by its fleet-unique ``index`` (NOT list position —
        retire/add shifts positions, indices are forever) or by object."""
        if not isinstance(rep, int):
            return rep
        for r in self._members():
            if r.index == rep:
                return r
        raise KeyError(f"{self._name}: no replica with index {rep} "
                       f"(retired?)")

    def wait_idle(self, rep, timeout=None, poll=0.01):
        """Block until a replica has zero fleet-dispatched work in
        flight (quarantine it first, or new work keeps arriving).  True
        when idle within ``timeout``."""
        rep = self._resolve(rep)
        t_end = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                idle = rep.in_flight == 0
            if idle:
                return True
            if t_end is not None and time.monotonic() >= t_end:
                return False
            time.sleep(poll)

    def _probe(self, rep):
        """One quarantine probe, non-blocking: push the warmup sample
        through the replica's full serving path and judge it from the
        completion callback.  Without a ``sample`` the fleet can only
        watch ``ready()`` (the replica's own idle probe does the
        healing)."""
        with self._lock:
            rep.probing = True
            self._stats["probes"] += 1
        ok_now = None
        try:
            _fault.fire("fleet.probe")
            if self._sample is None:
                ok_now = rep.server.ready()
            else:
                # infrastructure traffic, not a client request — a
                # probe's tree would pollute the per-phase histograms
                with _telemetry.suppress():
                    rreq = rep.server.submit(self._sample,
                                             deadline=self._probe_deadline)
        except Exception:        # refused (engaged breaker, dead server,
            ok_now = False       # injected fleet.probe fault): not healed
        if ok_now is not None:
            self._probe_verdict(rep, ok_now)
            return
        rreq.add_done_callback(
            lambda r: self._probe_verdict(
                rep, r.exception(0) is None and rep.server.ready()))

    def _probe_verdict(self, rep, ok):
        with self._lock:
            rep.probing = False
            if ok and not rep.manual:
                rep.quarantined = False
                rep.probe_attempts = 0
                readmitted = True
            else:
                rep.probe_attempts += 1
                rep.next_probe_at = time.monotonic() + _fault.backoff_delay(
                    rep.probe_attempts + 1, self._probe_base,
                    self._probe_max, self._probe_jitter)
                readmitted = False
        if readmitted:
            _logger.warning("%s: replica r%d readmitted after probe",
                            self._name, rep.index)

    # --------------------------------------------------- elastic membership --
    def add_replica(self, apply_fn=None, group="default", warmup=None):
        """Grow ``group`` by one replica: spawn → warmup until the
        bucket-grid census is complete → join the routing set.  The new
        replica serves NO traffic before its warmup census completes —
        it is not a fleet member until the final append, so the router,
        ``healthz`` and failover cannot see a half-warmed server.  With
        a shared jitted fn the warmup compiles nothing new (every bucket
        signature is a jit-cache hit): scaling up never grows the
        fleet-wide executable census.  Returns the new ``_Replica``.

        Raises ``ServerClosedError`` while draining and ``ValueError``
        when ``apply_fn`` is omitted and the group has no live member to
        clone (cloning needs the ``HotSwapApply`` protocol: the clone
        shares the jitted fn and starts on the group's CURRENT params,
        quantizer included)."""
        _fault.fire("fleet.scale_up")
        if self._draining.is_set():
            raise ServerClosedError(f"{self._name}: draining — not "
                                    f"scaling up")
        group = str(group)
        with self._lock:
            grp = self.groups.get(group)
            peers = [] if grp is None else list(grp.replicas)
        if apply_fn is None:
            tpl = next((p.apply for p in peers if p.server.alive()), None)
            if tpl is None or not hasattr(tpl, "swap"):
                raise ValueError(
                    f"{self._name}: add_replica(group={group!r}) needs "
                    f"apply_fn= — no live HotSwapApply peer to clone")
            params = dict(tpl.params) if isinstance(tpl.params, dict) \
                else list(tpl.params)
            apply_fn = HotSwapApply(tpl._fn, params,
                                    quantizer=tpl.quantizer)
        with self._lock:
            idx = self._next_index
            self._next_index += 1
        rep = self._build_replica(apply_fn, group, idx)
        started = self._started.is_set()
        if started:
            # warmup (the only place a compile could happen) runs OUTSIDE
            # the fleet lock and BEFORE membership — a stalled compile
            # delays the scale-up, never a live request
            rep.server.start(warmup=warmup)
            if self._sample is not None \
                    and len(rep.server.distinct_shapes) < self.grid_census:
                rep.server.drain(timeout=5)
                raise RuntimeError(
                    f"{self._name}: new replica r{rep.index} warmed "
                    f"{len(rep.server.distinct_shapes)} of "
                    f"{self.grid_census} bucket signatures — refusing to "
                    f"admit a census-incomplete replica")
        with self._lock:
            if self._draining.is_set():
                admit = False
            else:
                admit = True
                if group not in self.groups:
                    self.groups[group] = ReplicaGroup(group)
                self.groups[group].replicas.append(rep)
                self.replicas.append(rep)
                self._stats["scale_ups"] += 1
        if not admit:
            rep.server.drain(timeout=5)
            raise ServerClosedError(f"{self._name}: drained during "
                                    f"scale-up — replica discarded")
        _logger.warning("%s: replica r%d added to group %r",
                        self._name, rep.index, group)
        return rep

    def retire_replica(self, rep, timeout=30.0, force=False):
        """Shrink the fleet by one replica, dropping zero accepted
        requests: manual-quarantine (no new dispatches) → wait for its
        fleet-dispatched work to resolve (served, or failed over by the
        router) → drain its server → remove it from the routing set,
        ``healthz`` and ``stats`` → clear its profiler counter series
        (``profiler.counters_clear``) so a long-lived autoscaled process
        does not accrete dead replicas' gauges.

        Refuses (``ValueError``) to retire the last live replica of its
        group unless ``force=True`` — an accepted request must always
        have somewhere to resolve.  If the replica's in-flight work does
        not drain within ``timeout`` the retire ABORTS: the replica is
        readmitted and a ``RuntimeError`` raises (nothing was removed)."""
        _fault.fire("fleet.retire")
        rep = self._resolve(rep)
        with self._lock:
            if rep not in self.replicas:
                raise KeyError(f"{self._name}: replica r{rep.index} is "
                               f"not a fleet member")
            candidates = [r for r in self.groups[rep.group].replicas
                          if r is not rep and not r.quarantined]
        peers = [r for r in candidates if r.server.alive()]
        if not peers and not force and not self._draining.is_set():
            raise ValueError(
                f"{self._name}: r{rep.index} is the last live replica of "
                f"group {rep.group!r} — retiring it would strand traffic "
                f"(force=True overrides)")
        self.quarantine(rep, manual=True, reason="retire")
        if not self.wait_idle(rep, timeout=timeout):
            self.readmit(rep)
            raise RuntimeError(
                f"{self._name}: r{rep.index} still had fleet work in "
                f"flight after {timeout}s — retire aborted, replica "
                f"readmitted")
        rep.server.drain(timeout=timeout)
        with self._lock:
            self.replicas.remove(rep)
            self.groups[rep.group].replicas.remove(rep)
            self._stats["retired"] += 1
        # the retired member's counter series would otherwise report its
        # last values forever (and a later add_replica reusing nothing —
        # indices are unique — would still leak one series per cycle)
        _profiler.counters_clear(f"{self._name}-r{rep.index}::")
        _logger.warning("%s: replica r%d retired from group %r",
                        self._name, rep.index, rep.group)
        return rep

    def scaling_signals(self, group=None):
        """The autoscaler's input snapshot for ``group`` (None = whole
        fleet): live membership, readiness, queue depth, occupancy of
        the live in-flight capacity, and the cumulative per-class
        deadline-miss count (the policy diffs it per tick).  Non-blocking
        reads only — safe on a control-loop cadence."""
        reps = self._members(group)
        with self._lock:
            view = [(rep.quarantined, rep.in_flight) for rep in reps]
        ready = depth = 0
        for rep, (quarantined, _) in zip(reps, view):
            if not quarantined and rep.server.ready():
                ready += 1
                depth += rep.server.healthz()["queue_depth"]
        outstanding = sum(in_flight for _, in_flight in view)
        capacity = max(1, ready) * self._max_inflight
        misses = 0
        if self._qos is not None:
            misses = sum(s["deadline_miss"]
                         for s in self._qos.snapshot().values())
        return {"replicas": len(reps), "ready": ready,
                "outstanding": outstanding, "queue_depth": depth,
                "occupancy": outstanding / capacity,
                "deadline_miss": misses}

    # --------------------------------------------------------------- health --
    def alive(self):
        """Liveness: any replica's batch thread is running."""
        return any(rep.server.alive() for rep in self._members())

    def ready(self):
        """Readiness: started, not draining, and at least one
        unquarantined replica is ready."""
        return (self._started.is_set() and not self._draining.is_set()
                and self._any_ready())

    def healthz(self):
        """Fleet probe snapshot: fleet verdicts plus each replica's own
        ``healthz`` extended with the fleet's view of it (``quarantined``,
        fleet-tracked ``fleet_in_flight``), per-``ReplicaGroup`` rollups,
        and the fleet-level per-class SLO snapshot (``classes`` — present
        whenever the fleet has a ``qos=`` policy).  Membership is live:
        a retired replica's row disappears, a scale-up's appears only
        once it joined the routing set."""
        with self._lock:
            view = [(rep, rep.in_flight, rep.quarantined, rep.group)
                    for rep in self.replicas]
            group_names = list(self.groups)
            outstanding = self._outstanding
        replicas = {}
        groups = {g: {"replicas": [], "ready_replicas": 0,
                      "quarantined": 0, "in_flight": 0,
                      "census": self.grid_census} for g in group_names}
        for rep, in_flight, quarantined, gname in view:
            h = rep.server.healthz()
            h["quarantined"] = quarantined
            h["fleet_in_flight"] = in_flight
            h["group"] = gname
            replicas[f"r{rep.index}"] = h
            g = groups.setdefault(
                gname, {"replicas": [], "ready_replicas": 0,
                        "quarantined": 0, "in_flight": 0,
                        "census": self.grid_census})
            g["replicas"].append(f"r{rep.index}")
            g["in_flight"] += in_flight
            if quarantined:
                g["quarantined"] += 1
            elif h["ready"]:
                g["ready_replicas"] += 1
        return {"alive": self.alive(), "ready": self.ready(),
                "draining": self._draining.is_set(),
                "outstanding": outstanding,
                "ready_replicas": sum(
                    1 for h in replicas.values()
                    if h["ready"] and not h["quarantined"]),
                "groups": groups,
                "classes": {} if self._qos is None
                else self._qos.snapshot(),
                "replicas": replicas}

    @property
    def stats(self):
        """Fleet-level accounting.  ``admitted == completed + failed +
        expired`` once drained — an accepted request always lands in
        exactly one terminal bucket."""
        with self._lock:
            out = dict(self._stats)
            out["outstanding"] = self._outstanding
        out["replicas"] = {f"r{rep.index}": rep.server.stats
                           for rep in self._members()}
        return out

    def telemetry(self, fmt="json"):
        """The unified metrics exposition, fleet-wide: the
        router's own counters plus every replica's exposition AGGREGATED
        (counters/gauges summed under a ``replica_`` prefix, per-phase
        latency histograms merged bucket-wise — ``queue_ms`` here is the
        whole fleet's queue distribution) and the fleet-level per-class
        SLO rows.  State-code gauges where a sum is meaningless
        (``breaker_state``) aggregate as the WORST replica's value
        instead.  Same ``telemetry.exposition`` key schema as every
        other runtime; ``fmt="prom"`` renders Prometheus-style text."""
        reps = self._members()
        with self._lock:
            counters = dict(self._stats)
            outstanding = self._outstanding
            quar = [rep.quarantined for rep in reps]
        rpayloads = [rep.server.telemetry() for rep in reps]
        agg = _telemetry.merge_payloads(rpayloads)
        # sum(state codes) of 3 replicas can't tell one-open from
        # three-half-open — the degraded-replica signal telemetry
        # exists for; report the worst state across the fleet
        states = [p["gauges"]["breaker_state"] for p in rpayloads
                  if "breaker_state" in p.get("gauges", {})]
        if states:
            agg["gauges"]["breaker_state"] = max(states)
        counters.update({f"replica_{k}": v
                         for k, v in agg["counters"].items()})
        gauges = {"outstanding": outstanding,
                  "replicas": len(reps),
                  "quarantined": sum(1 for q in quar if q),
                  "ready_replicas": sum(
                      1 for rep, q in zip(reps, quar)
                      if not q and rep.server.ready()),
                  "ready": int(self.ready()), "alive": int(self.alive()),
                  "draining": int(self._draining.is_set())}
        # the runtime-introspection families: the fleet's own
        # compile site (replica sites ride the replica_ prefix) + the
        # stamped memory bytes
        gauges.update(_telemetry.compile_gauges(self._name))
        gauges.update(self._mem_gauges)
        # snapshot-stream health: the fleet is the CONSUMER
        # end of the checkpoint stream (WeightUpdater), so verify
        # failures / skip counts surface here too
        gauges.update(_telemetry.ckpt_gauges())
        gauges.update({f"replica_{k}": v
                       for k, v in agg["gauges"].items()})
        # fleet-routed traces are born under the FLEET's name, so their
        # per-phase histograms (queue/step/dispatch/failover) live under
        # this prefix — replica expositions only carry front-door-to-
        # replica traffic; merge both views
        hists = dict(agg["histograms"])
        own = _telemetry.registry().snapshot(
            prefix=f"{self._name}::")["histograms"]
        if self._qos is not None:      # fleet-level per-class latency —
            for cname, snap in self._qos.latency_snapshots().items():
                own[f"class_{cname}_latency_s"] = snap
        for k, v in own.items():
            hists[k] = v if k not in hists \
                else _telemetry.merge_snapshots([hists[k], v])
        payload = _telemetry.exposition(
            "serving_fleet", self._name, counters, gauges, hists,
            {} if self._qos is None else self._qos.snapshot())
        return _telemetry.render(payload, fmt)

    def stamp_memory_report(self, report):
        """Stamp a costguard-style memory report onto the fleet's
        ``mem_*`` exposition gauges (see
        ``InferenceServer.stamp_memory_report``; one report describes
        every replica — they share the executables)."""
        self._mem_gauges = _telemetry.memory_gauges(report)
        return self._mem_gauges

    # ---------------------------------------------------------------- drain --
    def drain(self, timeout=None):
        """Graceful fleet shutdown: stop admitting, let every accepted
        request reach a terminal state (replicas keep serving their
        queues; the router keeps failing work over while any replica is
        ready), then drain all replicas CONCURRENTLY and stop the
        router.  True when everything resolved and every thread exited
        in time."""
        self._draining.set()
        t_end = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                n = self._outstanding
            if n == 0:
                break
            if t_end is not None and time.monotonic() >= t_end:
                break
            time.sleep(self._TICK)
        threads = [threading.Thread(target=rep.server.drain,
                                    name=f"{self._name}-drain-r{rep.index}")
                   for rep in self._members()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(None if t_end is None
                   else max(0.1, t_end - time.monotonic()))
        self._stop.set()
        if self._started.is_set():
            self._router.join(None if t_end is None
                              else max(0.1, t_end - time.monotonic()))
        self._c_out.set_value(self.outstanding)
        ok = self.outstanding == 0 and not self._router.is_alive() \
            and not any(rep.server.alive() for rep in self._members())
        return ok

    close = drain

    def serve_forever(self, poll=0.05):
        """Block until SIGTERM/SIGINT (``fault.GracefulExit``), then
        drain the whole fleet — the preemption contract, one tier up."""
        with _fault.GracefulExit() as g:
            while not g.requested and self.alive():
                time.sleep(poll)
        return self.drain()


class WeightUpdater:
    """Streams training snapshots into a live fleet, zero downtime.

    Watches a checkpoint directory (a ``parallel.CheckpointManager``
    instance or a plain path written by one) through
    ``checkpoint.wait_for_new``, validates each new snapshot against the
    currently-served params (``validate_params`` — shape/dtype identity
    so executables survive, all-finite so poison never ships), then
    rolls it across the fleet one replica at a time.  A fleet whose
    applies carry a ``quantizer`` (int8 serving via
    ``amp.Int8Quantizer``) re-quantizes each full-precision snapshot
    into the served representation BEFORE validation — an f32 training
    job streams into a reduced-precision fleet without recompiles::

        quarantine → drain in-flight → hot-swap params → probe → readmit

    The fleet never loses more than one replica of capacity, and a
    request never sees a half-updated replica.  A probe failure rolls
    the replica (and any replicas already updated) back to the previous
    weights and raises ``UpdateRolledBackError`` — the fleet returns to
    full ready capacity on the old weights.  A DEAD replica (batch
    thread gone) is skipped, not fatal: it cannot serve, and a wedged
    update would be a second outage on top of the replica loss.  Replica
    apply fns must expose the ``HotSwapApply`` protocol (``params`` +
    ``swap()``).
    """

    def __init__(self, fleet, source=None, *, prefix="ckpt", poll=0.25,
                 last_seen=None, probe_deadline=10.0, drain_timeout=30.0):
        self.fleet = fleet
        directory = getattr(source, "directory", source)
        self._directory = None if directory is None else str(directory)
        self._prefix = getattr(source, "prefix", prefix)
        self._poll = float(poll)
        self._probe_deadline = float(probe_deadline)
        self._drain_timeout = float(drain_timeout)
        if last_seen is None and self._directory is not None:
            # the fleet was (typically) just initialized from the newest
            # snapshot — re-applying it would roll every replica through
            # a quarantine/drain/probe cycle for a no-op.  Stream only
            # snapshots committed AFTER this point; pass last_seen=0 (or
            # any older step) to force-apply what is already there.
            from ..parallel.checkpoint import list_checkpoints
            cks = list_checkpoints(self._directory, self._prefix)
            last_seen = cks[-1][0] if cks else None
        self.last_seen = last_seen
        self.applied = 0         # snapshots fully rolled out
        self.skipped = 0         # snapshots refused or rolled back
        self._stop = threading.Event()
        self._thread = None
        for rep in fleet.replicas:
            if not hasattr(rep.apply, "swap"):
                raise ValueError(
                    "WeightUpdater: replica apply fns must expose the "
                    "HotSwapApply protocol (.params + .swap) — build the "
                    "fleet with ServingFleet.replicated or HotSwapApply")
        if fleet._sample is None:
            raise ValueError(
                "WeightUpdater: the fleet needs a sample payload — the "
                "post-swap probe is what stands between a bad snapshot "
                "and live traffic")

    # ------------------------------------------------------------- updates --
    def update(self, snapshot):
        """Apply one snapshot fleet-wide.  ``snapshot`` is a checkpoint
        path (v1 ``save_train_step`` layout) or an already-loaded params
        sequence.  Raises ``SnapshotRejectedError`` (nothing touched) or
        ``UpdateRolledBackError`` (fleet restored to previous weights)."""
        if isinstance(snapshot, (str, os.PathLike)):
            from ..parallel.checkpoint import (CheckpointCorruptError,
                                               load_snapshot_params)
            try:
                params, _names = load_snapshot_params(str(snapshot))
            except FileNotFoundError as exc:
                # retention pruned the path after discovery: stale, not
                # bad — NOT counted in skipped (nothing was wrong with
                # the snapshot; a newer one is committed)
                raise SnapshotPrunedError(
                    f"snapshot {snapshot} pruned by retention before it "
                    f"could be read — re-poll for the newer one") from exc
            except CheckpointCorruptError as exc:
                # v1.1 integrity verdict (digest/size/container damage):
                # rejected BEFORE validate_params, before any replica
                # sees a byte of it
                self.skipped += 1
                raise SnapshotRejectedError(
                    f"snapshot {snapshot} failed integrity verification "
                    f"({exc}) — not applied to any replica") from exc
        else:
            params = snapshot            # container kind is validated
        members = self.fleet._members()
        if not members:
            raise UpdateRolledBackError(
                "no replica to update — the fleet retired them all")
        quantizer = getattr(members[0].apply, "quantizer", None)
        if quantizer is not None:
            # reduced-precision fleet: snapshots arrive full-precision
            # from the training job — re-quantize into the served
            # representation BEFORE validation, so validate_params
            # compares like for like and an f32 rolling update into an
            # int8 fleet is routine, not a dtype-drift rejection
            try:
                params = quantizer(params)
            except Exception as exc:
                self.skipped += 1
                raise SnapshotRejectedError(
                    f"snapshot failed the fleet's quantizer ({exc}) — "
                    f"not applied to any replica") from exc
        try:
            new_params = validate_params(params, members[0].apply.params)
        except SnapshotRejectedError:
            self.skipped += 1
            raise
        # onto the served params' device once, here, not at every call
        new_params = _served_like(new_params, members[0].apply.params)
        done = []                      # [(replica, its previous params)]
        try:
            live = [rep for rep in members if rep.server.alive()]
            if not live:
                raise UpdateRolledBackError(
                    "no live replica to update — the fleet is down")
            for rep in members:
                if rep not in live:
                    # a dead replica cannot serve (it is quarantined and
                    # its probes fail) — aborting the WHOLE update for it
                    # would wedge weight streaming on the first replica
                    # loss; it gets a fresh snapshot when it returns
                    _logger.warning(
                        "%s updater: skipping dead replica r%d",
                        self.fleet._name, rep.index)
                    continue
                try:
                    done.append((rep, self._swap_one(rep, new_params)))
                except Exception:
                    # a replica RETIRED (an autoscaler shrinking
                    # mid-update) or DEAD (killed after the liveness
                    # snapshot) out from under the roll is the
                    # dead-replica case, not a snapshot fault: it cannot
                    # serve, so its probe failure proves nothing about
                    # the weights — skip it, keep rolling.  A replica
                    # that is still a live member re-raises: that IS the
                    # snapshot (or replica) telling us something.
                    with self.fleet._lock:
                        member = rep in self.fleet.replicas
                    if member and rep.server.alive():
                        raise
                    _logger.warning(
                        "%s updater: replica r%d retired or died "
                        "mid-update — skipped", self.fleet._name,
                        rep.index)
        except Exception as exc:
            self.skipped += 1
            self.fleet._count("rollbacks")
            self.fleet._c_rollbacks.increment()
            for rep, old in reversed(done):
                try:
                    self._swap_one(rep, old)
                except Exception:      # noqa: BLE001 — the replica stays
                    pass               # quarantined; the rollback goes on
            if isinstance(exc, UpdateRolledBackError):
                raise
            raise UpdateRolledBackError(
                f"rolling update aborted and rolled back: {exc}") from exc
        self.applied += 1
        self.fleet._count("swaps")
        self.fleet._c_swaps.increment()
        return len(done)

    def _swap_one(self, rep, new_params):
        """One replica through the full protocol; returns its previous
        params.  On probe failure the replica is rolled back in place
        (and re-probed — only a verified replica is readmitted)."""
        _fault.fire("fleet.swap")
        self.fleet.quarantine(rep, manual=True, reason="weight update")
        swapped, old = False, None
        try:
            if not self.fleet.wait_idle(rep, timeout=self._drain_timeout):
                raise UpdateRolledBackError(
                    f"replica r{rep.index} still had in-flight work after "
                    f"{self._drain_timeout}s — update aborted before any "
                    f"swap")
            old = rep.apply.swap(dict(new_params)
                                 if isinstance(new_params, dict)
                                 else list(new_params))
            swapped = True
            self._probe(rep)
        except Exception as exc:
            if swapped:
                rep.apply.swap(old)
                try:
                    self._probe(rep)
                except Exception:
                    # even the OLD weights fail the probe: the replica
                    # itself is sick — leave it quarantined and hand it
                    # to the router's auto-probe schedule
                    with self.fleet._lock:
                        rep.manual = False
                    raise UpdateRolledBackError(
                        f"replica r{rep.index}: post-swap probe failed "
                        f"AND the rollback probe failed — replica left "
                        f"quarantined ({exc})") from exc
            self.fleet.readmit(rep)
            if isinstance(exc, UpdateRolledBackError):
                raise
            raise UpdateRolledBackError(
                f"replica r{rep.index}: post-swap probe failed — rolled "
                f"back to previous weights ({exc})") from exc
        self.fleet.readmit(rep)
        return old

    def _probe(self, rep):
        """Warmup probe through the replica's full serving path; raises
        unless the replica returns an all-finite result in time."""
        _fault.fire("fleet.probe")
        self.fleet._count("probes")
        with _telemetry.suppress():    # infrastructure, untraced
            rreq = rep.server.submit(self.fleet._sample,
                                     deadline=self._probe_deadline)
        out = rreq.result(self._probe_deadline + 1.0)
        leaves = out if isinstance(out, (tuple, list)) else (out,)
        for leaf in leaves:
            if not np.all(np.isfinite(np.asarray(leaf))):
                raise UpdateRolledBackError(
                    f"replica r{rep.index}: probe output is non-finite")

    # --------------------------------------------------------------- watch --
    def poll_once(self, timeout=0.0):
        """Check the directory once (blocking up to ``timeout`` for a
        new snapshot); applies the newest unseen one.  Returns its
        ``num_update`` or None.  A snapshot that fails (validation or
        rollback) is marked seen — a poisoned file must not be retried
        on every poll — and the error propagates.  A path PRUNED between
        discovery and read is stale, not bad: logged, ``None`` returned,
        and the next poll picks up the newer snapshot retention kept."""
        if self._directory is None:
            raise ValueError("WeightUpdater: no watch directory — "
                             "construct with source=")
        from ..parallel.checkpoint import wait_for_new
        found = wait_for_new(self._directory, last_seen=self.last_seen,
                             timeout=timeout, prefix=self._prefix,
                             poll=min(self._poll, 0.05))
        if found is None:
            return None
        num_update, path = found
        self.last_seen = num_update
        try:
            self.update(path)
        except SnapshotPrunedError as exc:
            _logger.info("%s updater: %s", self.fleet._name, exc)
            return None
        return num_update

    def start(self):
        """Watch the directory from a background thread; each new
        snapshot rolls out as it commits.  Failed snapshots are logged
        and skipped — the watcher never dies on a bad file."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._watch_loop,
            name=f"{self.fleet._name}-updater", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=None):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        return self._thread is None or not self._thread.is_alive()

    def _watch_loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once(timeout=self._poll)
            except (SnapshotRejectedError, UpdateRolledBackError) as exc:
                _logger.warning("%s updater: snapshot skipped: %s",
                                self.fleet._name, exc)
            except Exception as exc:   # noqa: BLE001 — the watcher must
                _logger.warning(       # outlive transient I/O errors
                    "%s updater: poll failed (%s) — retrying",
                    self.fleet._name, exc)
