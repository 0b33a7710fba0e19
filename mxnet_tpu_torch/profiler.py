"""Profiler: host spans, counter series and a Chrome-trace dump.

The port's counterpart of ``mxnet_tpu/profiler.py``, cut to what the
serving path and ``telemetry`` use: ``scope`` spans, ``Counter`` series
(backed by the telemetry registry, as in the JAX package), the
``ACTIVE``/``ingest_events`` channel telemetry traces land through, and
``dump``.  Where the JAX file brackets device work with
``jax.profiler``, this one synchronises the card: with
``set_config(profile_sync=True)`` every ``scope`` waits for the device
on entry and exit, so a span over a decode step is the step's device
time and not its enqueue time.
"""
from __future__ import annotations

import json
import os
import threading
import time

import torch

from . import telemetry as _telemetry

__all__ = ["set_config", "set_state", "start", "stop", "dump", "Counter",
           "scope", "ingest_events", "record_span"]

_lock = threading.Lock()


class _ProfilerState:
    def __init__(self):
        self.active = False
        self.sync = False
        self.filename = "profile.json"
        self.events = []             # chrome trace events


_P = _ProfilerState()
ACTIVE = False


def _now_us():
    return time.perf_counter() * 1e6


def _sync():
    if _P.sync and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def set_config(filename="profile.json", profile_sync=False, **kwargs):
    """Output path and whether spans wait for the device
    (``profile_sync``).  Other JAX-package knobs are accepted and
    ignored."""
    with _lock:
        _P.filename = filename
        _P.sync = bool(profile_sync)


def set_state(state="stop"):
    """'run' | 'stop'."""
    global ACTIVE
    if state not in ("run", "stop"):
        raise ValueError("state must be 'run' or 'stop'")
    with _lock:
        _P.active = state == "run"
        ACTIVE = _P.active


def start():
    set_state("run")


def stop():
    set_state("stop")


def record_span(name, t0_us, t1_us, cat="operator"):
    """Append one completed span (µs timestamps)."""
    ev = {"name": name, "ph": "X", "ts": t0_us, "dur": t1_us - t0_us,
          "pid": os.getpid(), "tid": threading.get_ident(), "cat": cat}
    with _lock:
        _P.events.append(ev)


class scope:
    """``with profiler.scope("name"):`` — a span over any region, kept
    while the profiler runs."""

    def __init__(self, name, cat="region"):
        self._name = name
        self._cat = cat

    def __enter__(self):
        if ACTIVE:
            _sync()
        self._t0 = _now_us()
        return self

    def __exit__(self, *exc):
        if ACTIVE:
            _sync()
            record_span(self._name, self._t0, _now_us(), self._cat)


def ingest_events(events):
    """Append pre-built Chrome-trace events (``telemetry.Trace.finish``
    uses it) while the profiler records."""
    if not ACTIVE:
        return
    with _lock:
        _P.events.extend(events)


def dump():
    """Write the Chrome-trace JSON, events sorted by timestamp."""
    with _lock:
        payload = {"traceEvents": sorted(_P.events,
                                         key=lambda e: e.get("ts", 0)),
                   "displayTimeUnit": "ms"}
    d = os.path.dirname(_P.filename)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(_P.filename, "w") as f:
        json.dump(payload, f)


class Counter:
    """Numeric counter series.  The value lives in a ``telemetry.Gauge``
    of the shared registry under the same name (as in the JAX package),
    so the telemetry registry reads the same cell; a new Counter under
    an existing name starts a fresh cell."""

    def __init__(self, domain=None, name="counter", value=0):
        self.name = (name if domain is None
                     else f"{getattr(domain, 'name', domain)}::{name}")
        reg = _telemetry.registry()
        reg.remove(self.name)
        self._gauge = reg.gauge(self.name)
        self._gauge.set(value)

    @property
    def _value(self):
        return self._gauge.value

    def _emit(self):
        if not ACTIVE:
            return
        ev = {"name": self.name, "ph": "C", "ts": _now_us(),
              "pid": os.getpid(), "args": {"value": self._value}}
        with _lock:
            _P.events.append(ev)

    def set_value(self, value):
        self._gauge.set(value)
        self._emit()

    def increment(self, delta=1):
        self._gauge.add(delta)
        self._emit()
