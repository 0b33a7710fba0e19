"""Profiler: per-op aggregates, host spans, counter series and a
Chrome-trace dump (the port of ``mxnet_tpu/profiler.py``).

ref: python/mxnet/profiler.py — ``set_config``/``set_state``/``start``/
``stop``/``pause``/``resume``/``dump``/``dumps`` and the instrumentation
objects (``Domain``, ``Task``, ``Frame``, ``Event``, ``Counter``,
``Marker``).  Host spans wrap the ``nd`` dispatch (one per op, installed
as ``ndarray.ndarray._PROF`` when the profiler first runs, so an idle
profiler costs the dispatch one global read) and ``TrainStep.step``;
``dumps()`` is the aggregate table per span name.  ``Counter`` values
live in ``telemetry`` gauges of the shared registry under the same
names, so the profiler's ``counters()`` and the telemetry expositions
read the same cells.

Where the JAX file brackets device work with ``jax.profiler``, this one
synchronises the card: with ``set_config(profile_sync=True)`` every
span (each op, each ``scope``) waits for the device on entry and exit,
so a span is its work's device time and not its enqueue time.  Device
kernels by name come from ``torch.profiler`` (``chip_smoke.py`` reads
it).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

import torch

from . import telemetry as _telemetry

__all__ = ["set_config", "set_state", "start", "stop", "pause", "resume",
           "dump", "dumps", "reset", "Domain", "Task", "Frame", "Event",
           "Counter", "Marker", "scope", "counter_value", "counters",
           "counters_clear", "ingest_events", "record_span", "want_sync"]

_lock = threading.Lock()


class _ProfilerState:
    def __init__(self):
        self.active = False
        self.paused = False
        self.sync = False
        self.aggregate = True
        self.continuous_dump = False
        self.filename = "profile.json"
        self.events = []             # chrome trace events
        self.stats = {}              # name -> [count, total, min, max] µs


_P = _ProfilerState()
ACTIVE = False


def _now_us():
    return time.perf_counter() * 1e6


def _sync():
    if _P.sync and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def set_config(filename="profile.json", profile_all=False,
               aggregate_stats=True, continuous_dump=False,
               profile_sync=False, **kwargs):
    """Output path, the aggregate table (``aggregate_stats``), a dump at
    every stop (``continuous_dump``) and whether spans wait for the
    device (``profile_sync``).  The reference's other knobs (and the JAX
    package's device-trace ones) are accepted and ignored."""
    with _lock:
        _P.filename = filename
        _P.aggregate = bool(aggregate_stats or profile_all)
        _P.sync = bool(profile_sync)
        _P.continuous_dump = bool(continuous_dump)


def set_state(state="stop"):
    """'run' | 'stop'."""
    global ACTIVE
    if state not in ("run", "stop"):
        raise ValueError("state must be 'run' or 'stop'")
    dump_after = False
    with _lock:
        if state == "run":
            _P.active, _P.paused = True, False
            # the dispatch hook, installed at first use: an idle profiler
            # costs the dispatch one global read
            from .ndarray import ndarray as _nd_mod
            _nd_mod._PROF = sys.modules[__name__]
        else:
            _P.active = False
            dump_after = _P.continuous_dump
        ACTIVE = _P.active and not _P.paused
    if dump_after:           # outside _lock — dump() takes it
        dump()


def start():
    set_state("run")


def stop():
    set_state("stop")


def pause(*a, **k):
    """Stop recording until ``resume()`` (the session stays open)."""
    global ACTIVE
    with _lock:
        _P.paused = True
        ACTIVE = False


def resume(*a, **k):
    global ACTIVE
    with _lock:
        _P.paused = False
        ACTIVE = _P.active


def reset():
    """Drop the recorded events and the aggregate table."""
    with _lock:
        _P.events.clear()
        _P.stats.clear()


def want_sync():
    """Whether spans wait for the device (``profile_sync``)."""
    return _P.sync


def record_span(name, t0_us, t1_us, cat="operator"):
    """Append one completed span (µs timestamps) and aggregate it."""
    dur = t1_us - t0_us
    ev = {"name": name, "ph": "X", "ts": t0_us, "dur": dur,
          "pid": os.getpid(), "tid": threading.get_ident(), "cat": cat}
    with _lock:
        _P.events.append(ev)
        if _P.aggregate:
            st = _P.stats.get(name)
            if st is None:
                _P.stats[name] = [1, dur, dur, dur]
            else:
                st[0] += 1
                st[1] += dur
                st[2] = min(st[2], dur)
                st[3] = max(st[3], dur)


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


def dumps(reset=False):
    """The aggregate table: per span name (each ``nd`` op, each scope),
    its count and total, min, max and mean milliseconds."""
    with _lock:
        rows = sorted(_P.stats.items(), key=lambda kv: -kv[1][1])
        out = ["Profile Statistics:",
               f"{'Name':<40s}{'Count':>8s}{'Total(ms)':>12s}"
               f"{'Min(ms)':>10s}{'Max(ms)':>10s}{'Avg(ms)':>10s}"]
        for name, (cnt, tot, mn, mx) in rows:
            out.append(f"{name:<40s}{cnt:>8d}{tot / 1e3:>12.3f}"
                       f"{mn / 1e3:>10.3f}{mx / 1e3:>10.3f}"
                       f"{tot / cnt / 1e3:>10.3f}")
        if reset:
            _P.stats.clear()
    return "\n".join(out)


# ----------------------------------------------- instrumentation objects --
def _qualified(domain, name):
    return name if domain is None \
        else f"{getattr(domain, 'name', domain)}::{name}"


class Domain:
    """Grouping namespace for custom objects (ref: profiler.Domain)."""

    def __init__(self, name):
        self.name = name


class Task(scope):
    """Named task span (ref: profiler.Task); ``start()``/``stop()``."""

    def __init__(self, domain=None, name="task"):
        super().__init__(_qualified(domain, name), cat="task")

    def start(self):
        self.__enter__()

    def stop(self):
        self.__exit__(None, None, None)


class Frame(Task):
    """Frame span (ref: profiler.Frame): a task in the 'frame'
    category."""

    def __init__(self, domain=None, name="frame"):
        Task.__init__(self, domain, name)
        self._cat = "frame"


class Event(Task):
    """ref: profiler.Event."""

    def __init__(self, name="event"):
        Task.__init__(self, None, name)
        self._cat = "event"


_COUNTERS = {}   # name -> the most recent Counter of that name


def counter_value(name, default=None):
    """Current value of the most recently created Counter named ``name``,
    or ``default`` when none exists.  Values track whatever the
    profiler's state (only trace events wait for ``start()``), so health
    counters like ``TrainStep::nonfinite_skips`` read with the profiler
    off."""
    c = _COUNTERS.get(name)
    return default if c is None else c._value


def counters(prefix=None):
    """``{name: value}`` over the live Counters, optionally only names
    starting with ``prefix``; read whatever the profiler's state."""
    with _lock:
        items = list(_COUNTERS.items())
    return {n: c._value for n, c in items
            if prefix is None or n.startswith(prefix)}


def counters_clear(prefix=None):
    """Forget Counter registrations (all, or names starting with
    ``prefix``) in ``counter_value``/``counters`` AND the telemetry
    registry behind them, so a restarted component under the same names
    does not report a dead instance's values.  Live ``Counter`` objects
    keep working against their own (now detached) gauge."""
    with _lock:
        names = [n for n in _COUNTERS
                 if prefix is None or n.startswith(prefix)]
        for name in names:
            del _COUNTERS[name]
    reg = _telemetry.registry()
    for name in names:
        reg.remove(name)


class Counter:
    """Numeric counter series.  The value lives in a ``telemetry.Gauge``
    of the shared registry under the same name (as in the JAX package),
    so the telemetry registry reads the same cell; a new Counter under
    an existing name starts a fresh cell."""

    def __init__(self, domain=None, name="counter", value=0):
        self.name = _qualified(domain, name)
        reg = _telemetry.registry()
        reg.remove(self.name)
        self._gauge = reg.gauge(self.name)
        self._gauge.set(value)
        with _lock:
            _COUNTERS[self.name] = self

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

    def decrement(self, delta=1):
        self._gauge.add(-delta)
        self._emit()


class Marker:
    """Instant marker (ref: profiler.Marker)."""

    def __init__(self, domain=None, name="marker"):
        self.name = _qualified(domain, name)

    def mark(self, scope="process"):
        if not ACTIVE:
            return
        ev = {"name": self.name, "ph": "i", "ts": _now_us(),
              "pid": os.getpid(), "tid": threading.get_ident(),
              "s": {"process": "p", "thread": "t",
                    "global": "g"}.get(scope, "p")}
        with _lock:
            _P.events.append(ev)
