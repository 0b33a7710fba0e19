"""Fault-tolerance runtime: injection harness, retry/backoff, graceful exit.

(The port's own copy of ``mxnet_tpu/fault.py``: stdlib only, its imports
point inside ``mxnet_tpu_torch``.)

ref: the reference stack's resilience story is spread across ps-lite (Van
resend/retry on connect), model.py epoch checkpoints, and operator-level
NaN policing left to the user.  TensorFlow (Abadi et al., PAPERS.md §)
treats user-level checkpointing plus runtime health checks as a design
axis; Cloud TPU fleets add preemption as a *normal* lifecycle event.  This
module is the shared substrate the rest of the stack builds on:

- ``inject(point, error, after_n=0, times=None)`` — deterministic fault
  injection.  Production code calls ``fire(point)`` at named points; a test
  (or ``tools/chaos_check.py``) arms a point inside a ``with`` block and
  the error is raised there, so kill-and-resume / producer-crash /
  NaN-batch scenarios are repeatable tests instead of prayers.
- ``retry_call(fn, ...)`` — exponential backoff with jitter and a deadline
  (the ps-lite Van connect-retry loop, generalised).
- ``GracefulExit`` — SIGTERM/SIGINT latch used by ``Module.fit`` to
  snapshot-then-exit instead of dying mid-step on preemption.
- ``with_context(exc, msg)`` — attach producer/worker provenance to an
  exception that crosses a thread boundary before it is re-raised.

Known injection points (``fire`` call sites; the same table is what
``points()`` returns and what ``inject`` validates against — a typo'd
point name raises instead of silently never firing):

===========================  ==============================================
point                        location
===========================  ==============================================
``io.producer``              PrefetchingIter producer thread (per batch) and
                             DataLoader host-batch production (per batch)
``prefetch.device_put``      DevicePrefetcher producer, before placement
``checkpoint.write``         save_train_step entry (before any file I/O)
``checkpoint.serialize``     checkpoint writer, after the v1.1 digests are
                             computed, before the payload is serialized
                             (catches ``BitFlipInjection`` → silent
                             corruption only the digest check can see)
``checkpoint.fsync``         checkpoint writer, after the temp payload is
                             flushed, before ``os.fsync`` makes it durable
``checkpoint.replace``       save_train_step, after the temp payload is
                             written, before ``os.replace`` commits it
``checkpoint.verify``        integrity verification entry — every digest
                             check (load paths + ``verify_checkpoint``)
``step``                     TrainStep._step entry (before batch placement)
``distributed.connect``      distributed.init, inside each connect attempt
``serving.admit``            InferenceServer.submit entry (before any
                             admission decision)
``serving.batch``            DynamicBatcher dispatch, before padding a
                             coalesced group
``serving.step``             InferenceServer batch/probe execution, before
                             the apply fn touches the device
``serving.drain``            InferenceServer.drain entry (before admission
                             stops)
``generate.prefill``         GenerationServer, before a prompt group's
                             prefill executable runs
``generate.decode``          GenerationServer, before each decode step over
                             the slot grid
``generate.evict``           GenerationServer, before preempting a
                             sequence's pages back to the pool
``generate.resume``          GenerationServer, before a prefill group
                             containing resumed sequences (salvaged
                             tokens re-entering the bucket grid) runs
``generate.salvage``         GenerationServer, inside the salvage path
                             that requeues a sequence with its tokens
                             after a step failure or breaker fast-fail
``generate.journal``         GenerationServer, before each decode-journal
                             append (write failures must never fail
                             serving)
``fleet.route``              ServingFleet.submit entry (before any routing
                             decision)
``fleet.dispatch``           ServingFleet dispatch, before handing a request
                             to the chosen replica
``fleet.swap``               WeightUpdater, before a replica's param
                             hot-swap sequence begins
``fleet.probe``              fleet quarantine/update probe, before the probe
                             request is submitted
``fleet.scale_up``           ServingFleet.add_replica entry, before the new
                             replica is built or warmed
``fleet.retire``             ServingFleet.retire_replica entry, before the
                             quarantine/drain sequence begins
``fleet.handoff``            GenerationServer, before a prefilled group's
                             KV pages + first token are scattered into the
                             decode group's pool
``admission.classify``       TenantQoS.classify, before the tenant/class
                             admission verdict
``supervisor.spawn``         elastic.Supervisor, before spawning a gang
                             attempt
``supervisor.heartbeat``     elastic.Supervisor watchdog, before each
                             heartbeat scan
``supervisor.watchdog``      elastic.Supervisor watchdog, on declaring a
                             worker hung
``supervisor.restart``       elastic.Supervisor, before relaunching the gang
                             after backoff
===========================  ==============================================

This module imports only the standard library (it is pulled in by
``distributed.py`` before the jax backend comes up).
"""
from __future__ import annotations

import random as _random
import signal as _signal
import threading
import time

__all__ = ["inject", "fire", "points", "armed", "register_point",
           "set_observer", "set_exit_observer", "retry_call",
           "backoff_delay", "GracefulExit", "with_context"]

_REGISTRY = {}            # point -> _Injection (armed faults)
_KNOWN = {}               # point -> location blurb (the documented surface)
_lock = threading.Lock()
_OBSERVER = None          # telemetry hook: called with the point name on
#                           every fault that actually FIRES (raises)
_EXIT_OBSERVER = None     # telemetry hook: called with the signum when a
#                           GracefulExit latch first catches its signal


def set_observer(fn):
    """Install ``fn(point)`` to observe every fault firing (or ``None``
    to remove it).  ``telemetry.enable()`` uses this to record firings
    as span events on the request being served; the observer runs
    OUTSIDE the registry lock, just before the armed error raises, and
    its own exceptions are swallowed — observability must never change
    what the fault harness does."""
    global _OBSERVER
    _OBSERVER = fn


def set_exit_observer(fn):
    """Install ``fn(signum)`` to observe a ``GracefulExit`` latch
    catching its FIRST signal (or ``None`` to remove it).
    ``telemetry.enable_flight()`` uses this to dump the flight-recorder
    bundle at preemption time — the handler runs it between bytecodes
    like any Python signal handler, and its exceptions are swallowed:
    observability must never break the snapshot-then-exit path."""
    global _EXIT_OBSERVER
    _EXIT_OBSERVER = fn


def register_point(point, where=""):
    """Declare ``point`` as a known ``fire()`` surface.

    ``inject`` only arms registered points — a typo'd name raises a
    ``ValueError`` immediately instead of silently never firing (the
    failure mode this registry exists to kill).  Registration is
    idempotent; subsystems with their own points (tests included) call
    this at import time.  Returns ``point`` so it can annotate a
    constant."""
    point = str(point)
    with _lock:
        _KNOWN.setdefault(point, str(where))
    return point


class _Injection:
    """One armed fault.  ``calls`` counts every ``fire(point)`` hit while
    armed; ``fired`` counts the hits that actually raised."""

    def __init__(self, point, error, after_n=0, times=None):
        # Exception only, NOT BaseException: producer threads catch
        # Exception to forward the fault to their consumer — an injected
        # SystemExit/KeyboardInterrupt would kill the thread silently and
        # deadlock the consumer on an empty queue
        if not (isinstance(error, Exception)
                or (isinstance(error, type)
                    and issubclass(error, Exception))):
            raise TypeError("error must be an Exception instance or class "
                            "(BaseException-only types would kill producer "
                            "threads without surfacing)")
        self.point = point
        self.error = error
        self.after_n = int(after_n)
        self.times = times if times is None else int(times)
        self.calls = 0
        self.fired = 0

    def _should_fire_locked(self):
        self.calls += 1
        if self.calls <= self.after_n:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        self.fired += 1
        return True

    def make_error(self):
        if isinstance(self.error, type):
            return self.error(f"fault injected at {self.point!r}")
        return self.error


class inject:
    """Arm ``point`` to raise ``error`` when production code reaches it.

    ``after_n`` fires pass through before the fault triggers; ``times``
    caps how many triggers happen (``None`` = every subsequent hit).  The
    context value exposes ``calls``/``fired`` counters for assertions::

        with fault.inject("step", RuntimeError("preempted"), after_n=4) as h:
            ...
        assert h.fired == 1

    Arming a point that is already armed replaces it for the duration and
    restores the previous injection on exit (nesting-safe).
    """

    def __init__(self, point, error, after_n=0, times=None):
        with _lock:
            known = point in _KNOWN
        if not known:
            raise ValueError(
                f"inject: unknown fault point {point!r} — it has no fire() "
                f"site and would silently never trigger.  Known points: "
                f"{sorted(_KNOWN)}; fault.register_point() declares a new "
                f"one")
        self._inj = _Injection(point, error, after_n=after_n, times=times)
        self._prev = None

    def __enter__(self):
        with _lock:
            self._prev = _REGISTRY.get(self._inj.point)
            _REGISTRY[self._inj.point] = self._inj
        return self._inj

    def __exit__(self, *exc):
        with _lock:
            if _REGISTRY.get(self._inj.point) is self._inj:
                if self._prev is None:
                    del _REGISTRY[self._inj.point]
                else:
                    _REGISTRY[self._inj.point] = self._prev
        return False


def fire(point):
    """Injection hook.  No-op (one dict lookup) unless a test armed
    ``point`` via ``inject``; then raises the armed error per its
    ``after_n``/``times`` schedule.  Thread-safe — producer threads and
    the training thread may hit points concurrently."""
    if not _REGISTRY:          # fast path: nothing armed anywhere
        return
    with _lock:
        inj = _REGISTRY.get(point)
        if inj is None or not inj._should_fire_locked():
            return
        err = inj.make_error()
    obs = _OBSERVER
    if obs is not None:
        try:
            obs(point)
        except Exception:      # noqa: BLE001 — observability must never
            pass               # change what the fault harness does
    raise err


def points():
    """Names of every REGISTERED injection point — the documented fault
    surface of the stack (the docstring table), whether or not anything
    is currently armed.  ``armed()`` gives the armed subset."""
    with _lock:
        return sorted(_KNOWN)


def armed():
    """Names of the injection points currently armed via ``inject``."""
    with _lock:
        return sorted(_REGISTRY)


# the shipped fault surface (keep in sync with the docstring table; the
# serving.* points belong to mxnet_tpu/serving, registered here so the
# surface is complete even before that package imports)
for _p, _w in (
    ("io.producer", "PrefetchingIter/DataLoader producers, per batch"),
    ("prefetch.device_put", "DevicePrefetcher producer, before placement"),
    ("checkpoint.write", "save_train_step entry, before any file I/O"),
    ("checkpoint.serialize", "checkpoint writer, after digests, before "
                             "serialization (BitFlipInjection hook)"),
    ("checkpoint.fsync", "checkpoint writer, after flush, before os.fsync"),
    ("checkpoint.replace", "save_train_step, before os.replace commits"),
    ("checkpoint.verify", "integrity verification entry, every digest "
                          "check"),
    ("step", "TrainStep._step entry, before batch placement"),
    ("distributed.connect", "distributed.init, inside each connect attempt"),
    ("serving.admit", "InferenceServer.submit entry"),
    ("serving.batch", "DynamicBatcher dispatch, before padding a group"),
    ("serving.step", "InferenceServer batch/probe apply, before the device"),
    ("serving.drain", "InferenceServer.drain entry"),
    ("generate.prefill", "GenerationServer, before a prompt group's "
                         "prefill executable runs"),
    ("generate.decode", "GenerationServer, before each decode step over "
                        "the slot grid"),
    ("generate.evict", "GenerationServer, before preempting a sequence's "
                       "pages back to the pool"),
    ("generate.resume", "GenerationServer, before a prefill group with "
                        "resumed sequences runs"),
    ("generate.salvage", "GenerationServer, inside the requeue-with-"
                         "tokens salvage path"),
    ("generate.journal", "GenerationServer, before each decode-journal "
                         "append"),
    ("fleet.route", "ServingFleet.submit entry, before routing"),
    ("fleet.dispatch", "ServingFleet dispatch, before the chosen replica"),
    ("fleet.swap", "WeightUpdater, before a replica's param hot-swap"),
    ("fleet.probe", "fleet quarantine/update probe, before submitting"),
    ("fleet.scale_up", "ServingFleet.add_replica entry, before the spawn"),
    ("fleet.retire", "ServingFleet.retire_replica entry, before the "
                     "quarantine/drain sequence"),
    ("fleet.handoff", "GenerationServer, before a prefilled group's KV "
                      "pages + first token reach a decode slot"),
    ("admission.classify", "TenantQoS.classify, before the tenant/class "
                           "admission verdict"),
    ("supervisor.spawn", "elastic.Supervisor, before spawning a gang"),
    ("supervisor.heartbeat", "elastic.Supervisor watchdog, per scan"),
    ("supervisor.watchdog", "elastic.Supervisor, on declaring a hang"),
    ("supervisor.restart", "elastic.Supervisor, before the relaunch"),
):
    register_point(_p, _w)
del _p, _w


# ------------------------------------------------------------------ retry --
def backoff_delay(attempt, base_delay=0.5, max_delay=8.0, jitter=0.5,
                  attempt_cap=32):
    """Backoff before retry ``attempt`` (1-based): ``base_delay *
    2**(attempt-1)`` capped at ``max_delay``, stretched by up to
    ``jitter`` fraction of itself.  The one exponential-backoff policy in
    the stack — ``retry_call`` consumes it as a blocking loop, the serving
    circuit breaker as a state-machine probe schedule, and the fleet
    router as the quarantine re-probe schedule (a serving thread must
    never sleep out a backoff).

    ``attempt_cap`` clamps the EXPONENT, not the delay: open-ended
    retry loops (a replica quarantined for hours keeps incrementing its
    probe attempt) would otherwise push ``2**(attempt-1)`` past float
    range and raise ``OverflowError`` on the very code path that exists
    to survive failure.  Any attempt past the cap behaves exactly like
    the cap (the delay saturated at ``max_delay`` long before); results
    for attempts <= 32 are unchanged from the uncapped form."""
    attempt = min(int(attempt), int(attempt_cap))
    delay = min(float(max_delay), float(base_delay) * 2 ** (attempt - 1))
    return delay * (1.0 + float(jitter) * _random.random())



def retry_call(fn, retries=4, base_delay=0.5, max_delay=8.0, deadline=None,
               jitter=0.5, retry_on=(Exception,), on_retry=None,
               giveup=None):
    """Call ``fn()`` with exponential backoff (the ps-lite Van retry loop).

    ``retries`` extra attempts follow the first failure; delays grow as
    ``base_delay * 2**k`` capped at ``max_delay``, each stretched by up to
    ``jitter`` fraction of itself (decorrelates a fleet of workers all
    retrying the same coordinator).  ``deadline`` (seconds, measured from
    the first attempt) bounds the whole loop: once passed, the last error
    re-raises immediately.  ``giveup(exc) -> bool`` marks an error as
    non-retryable (a misconfiguration that will fail identically every
    time): it re-raises at once instead of burning the backoff schedule.
    ``on_retry(attempt, delay, exc)`` observes each scheduled retry.
    Returns ``fn()``'s value."""
    t0 = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as exc:
            if giveup is not None and giveup(exc):
                raise
            attempt += 1
            if attempt > retries:
                raise
            delay = backoff_delay(attempt, base_delay, max_delay, jitter)
            if deadline is not None:
                remaining = deadline - (time.monotonic() - t0)
                if remaining <= 0:
                    raise
                delay = min(delay, remaining)
            if on_retry is not None:
                on_retry(attempt, delay, exc)
            time.sleep(delay)


# ---------------------------------------------------------------- signals --
class GracefulExit:
    """Latch SIGTERM/SIGINT instead of dying mid-step.

    Inside the ``with`` block the signals set ``requested`` (and remember
    which signal) rather than raising, so a training loop can finish the
    current batch, snapshot, and return cleanly — the Cloud-TPU preemption
    contract.  Handlers are restored on exit; a second signal while the
    latch is already set falls through to the previous handler (so a
    stuck snapshot can still be killed).  Outside the main thread (where
    ``signal.signal`` is illegal) the latch is inert and ``enabled`` is
    False."""

    def __init__(self, signals=(_signal.SIGTERM, _signal.SIGINT),
                 enabled=True):
        self._signals = tuple(signals)
        self._want = enabled
        self._prev = {}
        self.enabled = False
        self.requested = False
        self.signum = None
        # True when the latched signal was also delivered to an ENCLOSING
        # GracefulExit.  A scope that arms a latch purely for cleanup
        # (Module.predict/score) checks this to decide between returning
        # gracefully (an outer latch owns the lifecycle) and re-delivering
        # the signal (nobody asked for graceful handling — swallowing a
        # SIGTERM would keep a process alive its operator tried to stop).
        self.forwarded = False

    def _handler(self, signum, frame):
        if self.requested:        # second signal: escalate to the old handler
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
                return
            raise KeyboardInterrupt
        self.requested = True
        self.signum = signum
        obs = _EXIT_OBSERVER
        if obs is not None:
            try:
                obs(signum)
            except Exception:  # noqa: BLE001 — observability must never
                pass           # break the snapshot-then-exit path
        # Nested latches (Module.predict/score arm one inside fit's) must
        # not swallow the signal for the outer scope: a SIGTERM during the
        # eval pass still has to make the training loop snapshot-and-exit.
        # Forward the latch to the enclosing GracefulExit, if that is who
        # we displaced.
        prev = self._prev.get(signum)
        outer = getattr(prev, "__self__", None)
        if isinstance(outer, GracefulExit):
            if not outer.requested:
                # invoke the displaced handler rather than poking attrs:
                # IT forwards to ITS predecessor too, so the latch chain
                # cascades to any depth (user latch around fit around
                # score).  Only when the outer is un-requested — its
                # handler's requested-branch is the second-signal
                # escalation path, not a forward.
                prev(signum, frame)
            self.forwarded = True

    def __enter__(self):
        if not self._want:
            return self
        try:
            for s in self._signals:
                self._prev[s] = _signal.signal(s, self._handler)
            self.enabled = True
        except ValueError:        # not the main thread — run unlatched
            for s, prev in self._prev.items():
                _signal.signal(s, prev)
            self._prev.clear()
            self.enabled = False
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            try:
                _signal.signal(s, prev)
            except ValueError:
                pass
        self._prev.clear()
        self.enabled = False
        return False

    def __bool__(self):
        return self.requested


# ---------------------------------------------------------------- context --
def with_context(exc, msg):
    """Return ``exc`` carrying ``msg`` provenance (which producer thread /
    worker / iterator it came from), preserving the exception type so
    callers' ``except`` clauses keep matching.  When the type can be
    rebuilt from a single string the message is prefixed and the original
    chained as ``__cause__``; otherwise the note is attached to the
    original object (``fault_context`` attribute, plus ``add_note`` where
    the runtime has it)."""
    ctx = list(getattr(exc, "fault_context", ())) + [str(msg)]
    try:
        new = type(exc)(f"[{msg}] {exc}")
        new.__cause__ = exc
        new.with_traceback(exc.__traceback__)
        # a string-rebuilt OSError loses errno/filename; callers branch on
        # those (retry-on-ENOENT vs abort), so carry them over
        for attr in ("errno", "strerror", "filename", "filename2"):
            v = getattr(exc, attr, None)
            if v is not None and getattr(new, attr, None) is None:
                try:
                    setattr(new, attr, v)
                except Exception:
                    pass
    except Exception:
        new = exc
        if hasattr(new, "add_note"):      # py3.11+
            try:
                new.add_note(str(msg))
            except Exception:
                pass
    try:
        new.fault_context = ctx
    except Exception:
        pass
    return new
