"""Circuit breaker: fast-fail degraded mode with exponential half-open
probing.

(The port's own copy of ``mxnet_tpu/serving/breaker.py``: stdlib only,
its imports point inside ``mxnet_tpu_torch``.)

A TPU serving replica whose step function is failing (runtime wedge,
preempted donor core, poisoned executable cache) must stop queueing work
against a dead device: after ``threshold`` CONSECUTIVE step failures the
breaker opens, every dispatch (and new admission) fast-fails with
``CircuitOpenError``, and recovery is probed — one trial batch at a time,
on a schedule given by ``fault.backoff_delay``, the same
exponential+jitter policy ``fault.retry_call`` sleeps through, recast as
a state machine so the serving thread never blocks on a backoff.

States: CLOSED → (threshold consecutive failures) → OPEN → (probe timer
expires; next ``allow()`` caller is the trial) → HALF_OPEN → CLOSED on
success, back to OPEN with a doubled delay on failure.
"""
from __future__ import annotations

import threading
import time

from .. import fault as _fault
from .. import telemetry as _telemetry

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Thread-safe; shared between client threads (``engaged`` at
    admission) and the batch thread (``allow``/``record_*`` at dispatch).
    ``threshold=0`` disables the breaker entirely (always CLOSED)."""

    def __init__(self, threshold=3, base_delay=0.05, max_delay=2.0,
                 jitter=0.5):
        self.threshold = int(threshold)
        self._base = float(base_delay)
        self._max = float(max_delay)
        self._jitter = float(jitter)
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0       # consecutive
        self._opens = 0          # consecutive OPEN episodes → backoff attempt
        self._retry_at = 0.0
        self.trips = 0           # lifetime count of CLOSED/HALF_OPEN → OPEN

    @property
    def state(self):
        with self._lock:
            return self._state

    def state_code(self):
        """0 closed / 1 half-open / 2 open — the numeric form the
        ``::breaker_state`` profiler counter carries."""
        return _STATE_CODE[self.state]

    def engaged(self):
        """True while NEW work should fast-fail at admission: the breaker
        is open and the probe timer has not expired yet.  Once it has,
        admission lets traffic through so there is something to probe
        with."""
        with self._lock:
            return self._state == OPEN and time.monotonic() < self._retry_at

    def allow(self):
        """Dispatch-side gate.  CLOSED → go.  OPEN with the probe timer
        expired → this caller IS the half-open trial.  Otherwise
        fast-fail without touching the device."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and time.monotonic() >= self._retry_at:
                self._state = HALF_OPEN
                return True
            return False

    def record_success(self):
        with self._lock:
            self._state = CLOSED
            self._failures = 0
            self._opens = 0

    def record_failure(self):
        """One step failure.  Trips on the ``threshold``-th consecutive
        failure, or instantly from HALF_OPEN (the probe failed); each
        re-open doubles the next probe delay via ``fault.backoff_delay``.
        A fresh trip into OPEN — from CLOSED, the start of a dark
        episode — fires the flight-recorder dump: the
        seconds of spans/faults/compiles that preceded the replica
        going dark are exactly what the post-mortem needs.  Re-trips
        (failed half-open probes of a still-dark replica) do NOT dump
        again: a sustained outage probes every few seconds for hours,
        and one bundle per episode is the record, not one per probe."""
        dump = False
        with self._lock:
            self._failures += 1
            if self.threshold <= 0:
                return
            if self._state == HALF_OPEN or self._failures >= self.threshold:
                dump = self._state == CLOSED
                self._opens += 1
                self.trips += 1
                self._state = OPEN
                self._retry_at = time.monotonic() + _fault.backoff_delay(
                    self._opens, self._base, self._max, self._jitter)
        if dump:         # outside the lock: dump() does file I/O
            _telemetry.flight_trip("breaker-open", trips=self.trips)
