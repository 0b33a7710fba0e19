"""Supervised fleet autoscaling: a control loop over dynamic membership
(the port of ``mxnet_tpu/serving/autoscale.py``, host logic copied
unchanged).

The elastic supervisor keeps a TRAINING gang alive; this module is its
serving-side sibling: a ``FleetAutoscaler`` watches one ``ServingFleet``
replica group's load signals — queue depth, occupancy of the live
in-flight capacity, per-class deadline-miss rate — and drives
``ServingFleet.add_replica`` / ``retire_replica`` to track them, reusing
the supervisor idioms wholesale:

- **hysteresis, not twitching** — ``ScalingPolicy`` demands
  ``up_ticks``/``down_ticks`` CONSECUTIVE over/under-threshold
  observations before a verdict, plus a post-action cooldown; a single
  traffic spike never churns membership.
- **watchdog** — scale actions run on a helper thread the control loop
  join-polls; an action that wedges past ``watchdog_secs`` (a warm-up
  capture stall, a drain that never finishes) is declared hung, logged,
  and backed off — the control loop itself never blocks.
- **backoff** — failed or hung actions back off on the
  ``fault.backoff_delay`` schedule (the one exponential policy in the
  stack), resetting on the next success.
- **JSONL event log** — every verdict/action/failure lands in an
  ``elastic.EventLog`` stream (``scale-up`` / ``scale-down`` /
  ``scale-failed`` / ``scale-wedged`` / ``stop``), machine-parseable by
  the same tooling that reads the training supervisor's history.

The fleet methods themselves carry the safety contract (warm-up
census-complete before a scale-up serves, quarantine→drain→remove with
zero dropped accepted requests on retire — see ``serving.fleet``); the
autoscaler only decides WHEN.  Both fault points (``fleet.scale_up``,
``fleet.retire``) fire inside the fleet methods, so chaos tests drive
the autoscaler and manual scaling through the same failure surface.
"""
from __future__ import annotations

import threading
import time

from .. import fault as _fault
from .. import telemetry as _telemetry
from ..elastic import EventLog

__all__ = ["ScalingPolicy", "FleetAutoscaler"]


class ScalingPolicy:
    """Threshold + hysteresis verdicts over ``ServingFleet``
    ``scaling_signals`` snapshots.

    Scale **up** when occupancy >= ``up_occupancy`` OR queue depth >=
    ``up_queue_depth`` OR deadline misses accrued since the last tick
    exceed ``miss_budget`` — sustained for ``up_ticks`` consecutive
    ticks, membership below ``max_replicas``.  Scale **down** when
    occupancy <= ``down_occupancy`` AND the queue is empty AND no new
    misses — sustained for ``down_ticks``.  The down bound is on READY
    replicas (``min_replicas`` must stay serving after the retire), or
    on membership when the group carries dead/quarantined members — the
    autoscaler retires those first, which never reduces live capacity.
    ``cooldown`` seconds follow every action (scale effects need a beat
    to show up in the signals; acting on stale pressure
    double-scales)."""

    def __init__(self, min_replicas=1, max_replicas=8, up_occupancy=0.75,
                 down_occupancy=0.2, up_queue_depth=8, miss_budget=0,
                 up_ticks=2, down_ticks=5, cooldown=0.5):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"ScalingPolicy: need 1 <= min_replicas <= max_replicas, "
                f"got {min_replicas}..{max_replicas}")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_occupancy = float(up_occupancy)
        self.down_occupancy = float(down_occupancy)
        self.up_queue_depth = None if up_queue_depth is None \
            else int(up_queue_depth)
        self.miss_budget = int(miss_budget)
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.cooldown = float(cooldown)
        self._over = 0            # consecutive over-pressure ticks
        self._under = 0           # consecutive under-pressure ticks
        self._last_miss = None    # cumulative miss count at last tick
        self._cool_until = 0.0

    def record_action(self):
        """An action just ran (by this policy or anyone else): reset the
        streaks and start the cooldown window."""
        self._over = self._under = 0
        self._cool_until = time.monotonic() + self.cooldown

    def verdict(self, signals):
        """``"up"`` / ``"down"`` / ``None`` for one signals snapshot."""
        misses = signals.get("deadline_miss", 0)
        new_misses = 0 if self._last_miss is None \
            else max(0, misses - self._last_miss)
        self._last_miss = misses
        pressure = signals["occupancy"] >= self.up_occupancy
        if self.up_queue_depth is not None:
            pressure = pressure or \
                signals["queue_depth"] >= self.up_queue_depth
        pressure = pressure or new_misses > self.miss_budget
        calm = (signals["occupancy"] <= self.down_occupancy
                and signals["queue_depth"] == 0 and new_misses == 0)
        self._over = self._over + 1 if pressure else 0
        self._under = self._under + 1 if calm else 0
        if time.monotonic() < self._cool_until:
            return None
        if pressure and self._over >= self.up_ticks \
                and signals["replicas"] < self.max_replicas:
            return "up"
        if calm and self._under >= self.down_ticks:
            # dead/quarantined members are free to retire (they serve
            # nothing); a LIVE retire must leave min_replicas serving
            deadwood = signals["replicas"] - signals["ready"]
            if deadwood > 0 and signals["replicas"] > self.min_replicas:
                return "down"
            if signals["ready"] > self.min_replicas:
                return "down"
        return None


class FleetAutoscaler:
    """The control loop: poll ``fleet.scaling_signals(group)`` every
    ``tick`` seconds, act on the policy's verdict through
    ``fleet.add_replica`` / ``fleet.retire_replica``.

    ``make_apply`` (optional) builds the apply fn for each scale-up;
    without it the fleet clones the group's ``HotSwapApply`` template
    (shared jitted fn + current params — the zero-recompile path).
    ``event_log`` is a path or an ``elastic.EventLog``.

    Thread contract: the control loop is the only thread that launches
    actions; each action runs on its own helper thread so a wedged
    warmup/drain can be WATCHED instead of suffered (``watchdog_secs``).
    Counters and the action cell are ``self._lock``-guarded; ``stats``
    is the public, non-blocking snapshot.
    """

    def __init__(self, fleet, policy=None, group="default", *,
                 make_apply=None, tick=0.05, watchdog_secs=60.0,
                 retire_timeout=30.0, backoff_base=0.2, backoff_max=5.0,
                 event_log=None, name=None):
        self.fleet = fleet
        self.policy = policy if policy is not None else ScalingPolicy()
        self.group = str(group)
        if self.group not in fleet.groups:
            raise ValueError(f"FleetAutoscaler: fleet has no group "
                             f"{self.group!r} ({sorted(fleet.groups)})")
        self._make_apply = make_apply
        self._tick = float(tick)
        self._watchdog = float(watchdog_secs)
        self._retire_timeout = float(retire_timeout)
        self._backoff_base = float(backoff_base)
        self._backoff_max = float(backoff_max)
        self._name = name if name is not None \
            else f"{fleet._name}-autoscaler"
        self.log = event_log if isinstance(event_log, EventLog) \
            else EventLog(event_log)
        self._lock = threading.Lock()
        self._stats = {"scale_ups": 0, "scale_downs": 0, "failures": 0,
                       "wedged": 0}
        self._stop = threading.Event()
        self._thread = None
        # the one in-flight action: (thread, direction, deadline, result
        # cell) — control-loop-owned, lock-guarded for stats readers
        self._action = None
        self._attempts = 0        # consecutive failures → backoff
        self._resume_at = 0.0

    # ------------------------------------------------------------ lifecycle --
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name=self._name, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=None):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        self.log.emit("stop", name=self._name)
        return self._thread is None or not self._thread.is_alive()

    @property
    def stats(self):
        with self._lock:
            out = dict(self._stats)
            out["action_in_flight"] = self._action is not None
        return out

    def telemetry(self, fmt="json"):
        """The unified metrics exposition: the control loop's
        action counters plus liveness gauges under the SAME
        ``telemetry.exposition`` key schema every runtime serves — one
        scraper reads fleet, replicas, generation servers, supervisor,
        and this autoscaler uniformly.  ``fmt="prom"`` renders the
        Prometheus-style text form."""
        with self._lock:
            counters = dict(self._stats)
            in_flight = self._action is not None
            attempts = self._attempts
        gauges = {"action_in_flight": int(in_flight),
                  "consecutive_failures": attempts,
                  "alive": int(self._thread is not None
                               and self._thread.is_alive()),
                  "tick_secs": self._tick,
                  "min_replicas": self.policy.min_replicas,
                  "max_replicas": self.policy.max_replicas,
                  "events": len(self.log.records)}
        # the uniform gauge families (the control loop compiles
        # nothing and stamps no report — zeros, but scrapers never branch)
        gauges.update(_telemetry.compile_gauges(self._name))
        gauges.update(_telemetry.memory_gauges(None))
        gauges.update(_telemetry.ckpt_gauges())
        payload = _telemetry.exposition("fleet_autoscaler", self._name,
                                        counters, gauges)
        return _telemetry.render(payload, fmt)

    # ------------------------------------------------------------- the loop --
    def _loop(self):
        wedge_logged = False
        while not self._stop.wait(self._tick):
            with self._lock:
                action = self._action
            if action is not None:
                thread, direction, deadline, cell = action
                if thread.is_alive():
                    if time.monotonic() >= deadline and not wedge_logged:
                        # hung scale action: log once, count it as a
                        # failure for the backoff schedule, and keep
                        # watching — the loop itself must never block
                        wedge_logged = True
                        with self._lock:
                            self._stats["wedged"] += 1
                        self.log.emit("scale-wedged", direction=direction,
                                      group=self.group,
                                      watchdog_secs=self._watchdog)
                        self._note_failure()
                    continue
                # harvest the finished action
                with self._lock:
                    self._action = None
                wedge_logged = False
                err = cell.get("error")
                if err is not None:
                    with self._lock:
                        self._stats["failures"] += 1
                    self.log.emit("scale-failed", direction=direction,
                                  group=self.group, error=repr(err))
                    self._note_failure()
                else:
                    key = "scale_ups" if direction == "up" \
                        else "scale_downs"
                    with self._lock:
                        self._stats[key] += 1
                        self._attempts = 0
                    self.log.emit(f"scale-{direction}", group=self.group,
                                  replica=cell.get("replica"),
                                  signals=cell.get("signals"))
                self.policy.record_action()
                continue
            if time.monotonic() < self._resume_at:
                continue
            if self.fleet._draining.is_set():
                return
            signals = self.fleet.scaling_signals(self.group)
            direction = self.policy.verdict(signals)
            if direction is None:
                continue
            cell = {"signals": signals}
            thread = threading.Thread(
                target=self._run_action, args=(direction, cell),
                name=f"{self._name}-{direction}", daemon=True)
            with self._lock:
                self._action = (thread, direction,
                                time.monotonic() + self._watchdog, cell)
            thread.start()

    def _note_failure(self):
        self._attempts += 1
        self._resume_at = time.monotonic() + _fault.backoff_delay(
            self._attempts, self._backoff_base, self._backoff_max)

    def _run_action(self, direction, cell):
        """One scale action (helper thread — the loop watches it)."""
        try:
            if direction == "up":
                apply_fn = None if self._make_apply is None \
                    else self._make_apply()
                rep = self.fleet.add_replica(apply_fn=apply_fn,
                                             group=self.group)
                cell["replica"] = rep.index
            else:
                rep = self._retire_candidate()
                self.fleet.retire_replica(rep,
                                          timeout=self._retire_timeout)
                cell["replica"] = rep.index
        except Exception as exc:    # noqa: BLE001 — harvested by the loop
            cell["error"] = exc

    def _retire_candidate(self):
        """Dead or quarantined members first (retiring them costs zero
        live capacity — it is the cleanup a killed replica needs), then
        the least-loaded live member."""
        with self.fleet._lock:
            view = [(rep.quarantined, rep.in_flight, rep.index, rep)
                    for rep in self.fleet.groups[self.group].replicas]
        deadwood = [rep for q, _n, _i, rep in view
                    if q or not rep.server.alive()]
        if deadwood:
            return deadwood[0]
        live = sorted(((n, i, rep) for q, n, i, rep in view
                       if not q and rep.server.alive()),
                      key=lambda t: t[:2])
        if not live:
            raise RuntimeError(f"{self._name}: no retirable replica in "
                               f"group {self.group!r}")
        return live[0][2]
