"""Elastic training runtime: heartbeats, hang watchdog, gang supervisor.

(The port's own copy of ``mxnet_tpu/elastic.py``: standard library only,
its imports point inside ``mxnet_tpu_torch``.  One divergence, in the
worker env contract: ``Supervisor(platform=, devices_per_worker=)`` maps
onto ``CUDA_VISIBLE_DEVICES`` where the JAX package sets
``JAX_PLATFORMS`` and XLA's host device count — see
``Supervisor._worker_env``.)

ref: the reference's failure story ends at the dmlc tracker relaunching a
dead worker; SURVEY §5.3 names cluster-scale failure recovery as the gap
to exceed.  TensorFlow (arXiv:1605.08695) treats runtime health checks +
user-level checkpoints as a design axis, and on a preemptible fleet
preemption is the *normal* lifecycle event.  This module is both sides
of that contract:

- **Worker side** — ``Heartbeat``: each rank atomically writes
  ``{rank, attempt, global_step, monotonic_stamp, phase}`` to a per-rank
  file on a step cadence (wired into ``parallel.TrainStep`` via
  ``heartbeat=``, built from the ``MXTPU_HEARTBEAT_DIR`` env contract by
  ``Heartbeat.from_env``), plus distinguishable exit statuses
  (``EXIT_PREEMPTED`` for the snapshot-then-exit path,
  ``EXIT_NONFINITE`` for the non-finite abort) so preemption, numeric
  abort, and crash are classifiable from outside the process.
- **Supervisor side** — ``Supervisor``: spawns the gang under the DMLC_*
  env contract (``python -m mxnet_tpu_torch.launch`` is a thin CLI over
  it), a watchdog thread declares a worker hung when its heartbeat stamp
  goes stale past ``watchdog_secs``, any failure (crash / hang /
  nonfinite / preempted worker) tears down the WHOLE gang (SIGTERM first
  so healthy workers snapshot, SIGKILL after ``graceful_secs``) and
  relaunches with ``fault.backoff_delay`` between attempts.  The restart
  budget is **progress-aware**: an attempt that advanced the latest
  committed checkpoint step (``progress_dir``) refills the budget, so a
  long job survives many spread-out faults while a crash-loop pinned at
  one step exhausts it fast and exits with a post-mortem.
  Supervisor-level SIGTERM forwards to the workers, waits for their
  snapshots, and exits cleanly.  Everything lands in a JSONL event log.

Observability fault points (registered in ``fault.py``):
``supervisor.spawn`` / ``supervisor.heartbeat`` / ``supervisor.watchdog``
/ ``supervisor.restart``.  ``mxnet_tpu_torch/elastic_worker.py`` is a
worker that keeps this contract (a ResNet-50 or a small dense net under
``CheckpointManager``).

Like ``fault.py`` this module imports ONLY the standard library, and it
is loadable by file path outside the package, for a supervisor process
that must stay free of torch.  ``python -m mxnet_tpu_torch.launch``
imports it with the package (torch is imported, no card initialised),
so fault points armed on the package's ``fault`` reach the supervisor.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

try:  # normal package import (worker side, tests)
    from . import fault as _fault
    from . import telemetry as _telemetry
except ImportError:  # pragma: no cover — loaded by file path (launch.py)
    import importlib.util as _ilu

    def _load_standalone(stem):
        spec = _ilu.spec_from_file_location(
            f"_mxtpu_torch_{stem}_standalone",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         f"{stem}.py"))
        mod = _ilu.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    _fault = _load_standalone("fault")
    _telemetry = _load_standalone("telemetry")

__all__ = ["EXIT_OK", "EXIT_PREEMPTED", "EXIT_NONFINITE", "HEARTBEAT_ENV",
           "NonFiniteAbortError", "classify_exit", "Heartbeat",
           "read_heartbeats", "scan_checkpoints", "latest_checkpoint",
           "latest_committed_step", "EventLog", "Supervisor"]

# ------------------------------------------------------------ exit status --
# The worker→supervisor status channel is the process exit code (the only
# channel that survives SIGKILL of everything else).  Codes 43/44 sit
# outside the shell/python conventional range (0/1/2, 126+) so a plain
# `sys.exit(1)` crash can never masquerade as a classified status.
EXIT_OK = 0
EXIT_PREEMPTED = 43       # snapshot-then-exit (the GracefulExit path)
EXIT_NONFINITE = 44       # non-finite abort (TrainStep nonfinite_budget)

HEARTBEAT_ENV = "MXTPU_HEARTBEAT_DIR"
# rank 0's copy of the coordinator's listening socket (a descriptor
# number): ``distributed.init`` serves the TCPStore on it
STORE_FD_ENV = "MXTPU_STORE_FD"


class NonFiniteAbortError(RuntimeError):
    """TrainStep exhausted its non-finite budget.  A ``RuntimeError``
    subclass so pre-existing handlers keep matching; supervised workers
    catch it specifically and exit ``EXIT_NONFINITE`` so the supervisor
    can classify the failure from outside."""


def classify_exit(returncode):
    """Map a worker's exit code to a status string: ``ok`` /
    ``preempted`` (snapshot-then-exit) / ``nonfinite`` (numeric abort) /
    ``killed:<SIG>`` (died on a signal) / ``crash`` (anything else) /
    ``unreaped`` (``None`` — the process outlived even SIGKILL, e.g.
    wedged in uninterruptible I/O; the supervisor reports it instead of
    crashing mid-drain)."""
    if returncode is None:
        return "unreaped"
    rc = int(returncode)
    if rc == EXIT_OK:
        return "ok"
    if rc == EXIT_PREEMPTED:
        return "preempted"
    if rc == EXIT_NONFINITE:
        return "nonfinite"
    if rc < 0:
        try:
            return f"killed:{signal.Signals(-rc).name}"
        except ValueError:
            return f"killed:{-rc}"
    return "crash"


# -------------------------------------------------------------- heartbeat --
class Heartbeat:
    """Per-rank liveness stamp, written atomically on a step cadence.

    ``beat(global_step, phase)`` writes ``heartbeat-r<rank>.json`` under
    ``directory`` via tmp + ``os.replace`` — a reader never sees a torn
    record.  ``monotonic_stamp`` is ``time.monotonic()``, which on Linux
    is the boot-based system-wide clock, so the supervisor on the same
    host compares it against its own monotonic reading (the local
    launcher contract; multi-host supervisors would use file mtimes on
    the shared filesystem instead).

    The first beat always writes (it is what engages the watchdog for
    this attempt — construction deliberately does NOT write, so a slow
    first compile cannot trip a short watchdog before step 1 exists);
    after that, ``train``-phase beats are thinned to every
    ``every_n_steps``-th CALL (not step value — a pinned step counter,
    e.g. ``skip_nonfinite`` riding out corrupt batches, must still
    refresh the stamp), and phase transitions always write.

    Wiring: ``Heartbeat.from_env()`` builds one from the supervisor's
    env contract (``MXTPU_HEARTBEAT_DIR`` + ``DMLC_WORKER_ID`` +
    ``DMLC_ATTEMPT``), ``parallel.TrainStep(heartbeat=hb)`` beats
    after every completed step, and the instance is itself a batch-end
    callback (``hb(param)``; ``Module.fit`` is not ported yet).
    """

    PHASES = ("init", "train", "eval", "snapshot", "exit")

    def __init__(self, directory, rank, attempt=0, every_n_steps=1):
        self.directory = str(directory)
        self.rank = int(rank)
        self.attempt = int(attempt)
        self.every_n_steps = max(1, int(every_n_steps))
        self.path = os.path.join(self.directory,
                                 f"heartbeat-r{self.rank}.json")
        self._auto_step = 0
        self._calls = 0
        self._last_written = None
        self._last_phase = None
        self._last_compiling = False
        os.makedirs(self.directory, exist_ok=True)

    @classmethod
    def from_env(cls, environ=None):
        """Build from the supervisor's env contract, or None when this
        process is not supervised (``MXTPU_HEARTBEAT_DIR`` unset) — so
        training loops can wire heartbeats unconditionally."""
        env = os.environ if environ is None else environ
        directory = env.get(HEARTBEAT_ENV)
        if not directory:
            return None
        return cls(directory,
                   rank=int(env.get("DMLC_WORKER_ID", "0") or 0),
                   attempt=int(env.get("DMLC_ATTEMPT", "0") or 0),
                   every_n_steps=int(env.get("MXTPU_HEARTBEAT_EVERY", "1")
                                     or 1))

    def beat(self, global_step=None, phase="train", last_step_ms=None,
             compile_in_progress=False):
        """Stamp liveness; returns the record written, or None when the
        cadence thinned this step out.  ``global_step=None`` auto-counts
        calls (the batch-end-callback form).

        ``last_step_ms`` is the wall time of the just-completed step —
        the supervisor summarizes these into its fleet-wide ``step_ms``
        histogram.  ``compile_in_progress=True`` marks a
        stamp written right BEFORE a compiling call: the watchdog grants
        such a worker the startup grace instead of the steady-state
        staleness bound, so a long first compile is distinguishable from
        a hung step.  A change in the flag always writes (the watchdog
        must see it flip regardless of the cadence)."""
        if global_step is None:
            self._auto_step += 1
            global_step = self._auto_step
        else:
            global_step = int(global_step)
            self._auto_step = global_step
        # thin by CALL count, not step value: a live worker whose step
        # counter is pinned (skip_nonfinite riding out corrupt batches)
        # must still refresh its stamp, or the watchdog would declare a
        # healthy, actively-stepping worker hung.  Phase TRANSITIONS
        # always write; repeated same-phase beats (train steps, eval
        # batches) follow the cadence — the env knob exists to throttle
        # per-batch write+rename I/O, whatever the phase
        self._calls += 1
        compiling = bool(compile_in_progress)
        if (phase == self._last_phase and self._last_written is not None
                and compiling == self._last_compiling
                and self._calls % self.every_n_steps != 0):
            return None
        rec = {"rank": self.rank, "attempt": self.attempt,
               "global_step": global_step,
               "monotonic_stamp": time.monotonic(),
               "phase": str(phase), "pid": os.getpid(),
               "wall_time": time.time(),
               "last_step_ms": None if last_step_ms is None
               else round(float(last_step_ms), 3),
               "compile_in_progress": compiling}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)
        self._last_written = global_step
        self._last_phase = str(phase)
        self._last_compiling = compiling
        return rec

    def __call__(self, param=None):
        """Batch-end-callback form: one auto-counted ``train`` beat."""
        self.beat(phase="train")


def read_heartbeats(directory):
    """``{rank: record}`` for every parseable ``heartbeat-r<N>.json`` in
    ``directory``.  A record mid-replace or damaged is skipped for this
    scan (atomic writes make that a transient, not a corruption)."""
    out = {}
    pat = re.compile(r"heartbeat-r(\d+)\.json$")
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        m = pat.fullmatch(name)
        if not m:
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                out[int(m.group(1))] = json.load(f)
        except (OSError, ValueError):
            continue
    return out


# --------------------------------------------------------- progress scan --
# The one committed-checkpoint filename parser in the stack:
# parallel/checkpoint.py delegates list_checkpoints here, so the
# supervisor's progress accounting and the training-side retention /
# resume discovery can never disagree about what "committed" means.

def scan_checkpoints(directory, prefix="ckpt"):
    """``(num_update, path)`` pairs for every ``<prefix>-<n>.npz`` in
    ``directory``, ascending by step.  Orphan ``.tmp`` files (a crash
    mid-write) are ignored — they were never committed."""
    pat = re.compile(re.escape(prefix) + r"-(\d+)\.npz$")
    out = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            m = pat.fullmatch(name)
            if m:
                out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def latest_checkpoint(directory, prefix="ckpt"):
    """Newest committed ``(num_update, path)``, or None when empty."""
    cks = scan_checkpoints(directory, prefix)
    return cks[-1] if cks else None


def latest_committed_step(directory, prefix="ckpt"):
    """The newest committed snapshot's step, or None when the directory
    holds none — the supervisor's progress probe (stdlib-only; the
    framework-side spelling is ``CheckpointManager.latest_step()``)."""
    ck = latest_checkpoint(directory, prefix)
    return ck[0] if ck else None


# ---------------------------------------------------------------- events --
class EventLog:
    """Append-only JSONL event stream + in-memory record list.

    One line per event: ``{"ts": ..., "mono": ..., "kind": "event",
    "name"/"event": ..., **fields}`` — the machine-readable supervision
    history (tests parse it back).
    Hosted on ``telemetry.JsonlSink``, the ONE JSONL stream
    implementation of the stack (supervisor log, autoscaler log, and
    trace export all ride it) — atomic line writes, size rotation, and
    the shared ``ts``/``mono``/``kind``/``name`` schema, which also
    gives every event the monotonic stamp autoscale records previously
    lacked.  The legacy ``event`` key stays on every record so existing
    parsers keep working.  ``echo`` mirrors a one-line human form to a
    stream (the supervisor uses stderr).  Emit only from the owning
    thread; worker threads hand verdicts to the owner instead."""

    def __init__(self, path=None, echo=None, max_bytes=None):
        self.path = str(path) if path else None
        self.records = []
        self._sink = _telemetry.JsonlSink(self.path, max_bytes=max_bytes)
        self._echo = echo

    def emit(self, event, **fields):
        payload = dict(fields)
        payload.setdefault("event", str(event))
        if "name" in payload:          # caller-owned name field wins
            rec = self._sink.write("event", **payload)
        else:
            rec = self._sink.write("event", str(event), **payload)
        self.records.append(rec)
        if self._echo is not None:
            kv = " ".join(f"{k}={fields[k]}" for k in sorted(fields))
            print(f"[supervisor] {event} {kv}".rstrip(),
                  file=self._echo, flush=True)
        return rec

    def close(self):
        self._sink.close()


def _store_socket(host="127.0.0.1"):
    """A listening socket on a free port of ``host``: the coordinator's
    (rank 0's ``TCPStore``) port, held from the moment it is chosen.
    Rank 0 inherits it (its descriptor in ``STORE_FD_ENV``) and serves the
    store on it, so no other process (another gang's store, a listener
    gloo binds) can take the port between the launcher choosing it and
    the store serving on it."""
    s = socket.socket()
    try:
        s.bind((host, 0))
        s.listen(128)
    except OSError:
        s.close()
        raise
    return s


def _pump_lines(pipe, tag, stream):
    """Forward one worker pipe line-by-line with a ``[r<rank>]`` tag so
    interleaved gang output stays attributable.  Runs on a daemon thread
    per pipe; exits when the worker closes its end."""
    with pipe:
        for line in iter(pipe.readline, b""):
            try:
                stream.write(tag + line.decode("utf-8", "replace"))
                stream.flush()
            except ValueError:        # stream closed at interpreter exit
                return


def _stop_procs(procs, grace):
    """Gang teardown: SIGTERM (+SIGCONT — a SIGSTOPped worker, the hang
    the watchdog catches, must be resumed to run its snapshot-then-exit
    handler), wait up to ``grace`` seconds, then SIGKILL stragglers and
    reap everything — the no-leaked-worker guarantee."""
    for p in procs:
        if p.poll() is None:
            try:
                p.terminate()
                if hasattr(signal, "SIGCONT"):
                    p.send_signal(signal.SIGCONT)
            except OSError:
                pass
    deadline = time.monotonic() + max(0.0, float(grace))
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    for p in procs:
        if p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                pass


# ------------------------------------------------------------ supervisor --
class Supervisor:
    """Elastic gang supervisor (the engine under ``launch.py``).

    ``run()`` (one-shot; call from the main thread so the SIGTERM latch
    binds — ``request_stop()`` is the programmatic equivalent from any
    thread) spawns ``num_workers`` copies of ``command`` under the
    DMLC_* env contract with a fresh coordinator port per attempt, and
    supervises:

    - any worker exiting nonzero (crash / ``EXIT_PREEMPTED`` /
      ``EXIT_NONFINITE``) or going heartbeat-stale past
      ``watchdog_secs`` tears down the whole gang (a partial gang
      deadlocks in collectives) and relaunches after
      ``fault.backoff_delay``;
    - the restart budget (``max_restarts``) is progress-aware when
      ``progress_dir`` is set: an attempt that advanced the latest
      committed checkpoint step refills it, a no-progress crash-loop
      exhausts it and exits with a ``giveup`` post-mortem;
    - supervisor SIGTERM/SIGINT (or ``request_stop()``) forwards SIGTERM
      to the workers, waits ``graceful_secs`` for their snapshots, and
      returns 0.

    Worker stdout/stderr is prefixed ``[r<rank>]`` line-by-line (or teed
    to ``r<rank>.log`` under ``log_dir``); every lifecycle transition
    lands in the JSONL ``event_log``.

    ``platform`` / ``devices_per_worker`` place the workers through
    ``CUDA_VISIBLE_DEVICES``: ``"cpu"`` hides every card, ``"gpu"`` with
    ``devices_per_worker=d`` shows rank r the cards r*d .. r*d+d-1, and
    None leaves the inherited value.  A worker still names its device
    itself (``elastic_worker.py --device``); it never infers the CPU from
    a card it cannot see.
    """

    def __init__(self, command, num_workers, *, platform=None,
                 devices_per_worker=0, max_restarts=0, watchdog_secs=0.0,
                 startup_grace_secs=None, graceful_secs=10.0,
                 backoff_base=0.5, backoff_max=8.0, heartbeat_dir=None,
                 log_dir=None, event_log=None, progress_dir=None,
                 progress_prefix="ckpt", extra_env=None, prefix_output=True,
                 poll=0.05, coordinator_host="127.0.0.1"):
        self.command = list(command)
        self.num_workers = int(num_workers)
        if platform not in (None, "cpu", "gpu"):
            raise ValueError(f"Supervisor: platform={platform!r}: None, "
                             f"'cpu' or 'gpu'")
        self.platform = platform
        self.devices_per_worker = int(devices_per_worker or 0)
        self.max_restarts = int(max_restarts)
        self.watchdog_secs = float(watchdog_secs or 0.0)
        if startup_grace_secs is not None:
            self.startup_grace_secs = float(startup_grace_secs)
        elif self.watchdog_secs > 0:
            # an armed watchdog must also catch a worker that wedges
            # BEFORE its first beat (stuck import/compile/handshake) or
            # the hang it exists to kill survives bring-up; default the
            # grace to 10x the steady-state staleness bound (floor 60s —
            # bring-up is legitimately much slower than a step)
            self.startup_grace_secs = max(60.0, 10.0 * self.watchdog_secs)
        else:
            self.startup_grace_secs = None
        self.graceful_secs = float(graceful_secs)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self._hb_dir_owned = heartbeat_dir is None
        self.heartbeat_dir = heartbeat_dir or tempfile.mkdtemp(
            prefix="mxtpu_hb_")
        os.makedirs(self.heartbeat_dir, exist_ok=True)
        self.log_dir = log_dir
        self.event_log = event_log
        self.progress_dir = progress_dir
        self.progress_prefix = progress_prefix
        self.extra_env = dict(extra_env or {})
        self.prefix_output = bool(prefix_output)
        self.poll = float(poll)
        self.coordinator_host = coordinator_host
        self.restarts = 0
        self.log = None
        self._procs = []
        self._watchdog = None
        self._verdicts = queue.Queue()
        self._stop = threading.Event()
        # step-time visibility: last global_step seen per
        # rank, so each heartbeat's last_step_ms is observed into the
        # fleet-wide step_ms histogram exactly once
        self._step_seen = {}

    # ---- public observability ----
    def worker_pids(self):
        """PIDs of the current attempt's live workers (chaos harnesses
        aim their SIGKILL/SIGSTOP here; the spawn event carries the same
        list)."""
        return [p.pid for p in self._procs if p.poll() is None]

    def request_stop(self):
        """Programmatic supervisor-SIGTERM: the next loop tick forwards
        SIGTERM to the gang, waits for snapshots, and run() returns 0.
        (Signal latches only bind on the main thread; this works from
        any.)"""
        self._stop.set()

    def telemetry(self, fmt="json"):
        """The unified metrics exposition: the SAME
        ``telemetry.exposition`` key schema the serving runtimes serve
        (one scraper reads the whole stack), with the supervisor's gang
        counters and worker gauges, with the fleet-wide
        ``step_ms`` histogram (each rank's heartbeat ``last_step_ms``,
        observed by the watchdog scan once per step) plus the
        ``compiling_workers`` gauge and the uniform ``compile_*`` /
        ``mem_*`` families, so the elastic gang's step-time visibility
        sits next to its heartbeats.  ``fmt="prom"`` renders the
        Prometheus-style text form.  Works in standalone (file-path)
        mode — the telemetry twin loads the same way ``fault`` does."""
        counters = {"restarts": self.restarts,
                    "events": 0 if self.log is None
                    else len(self.log.records)}
        beats = read_heartbeats(self.heartbeat_dir)
        gauges = {"workers": self.num_workers,
                  "live_workers": len(self.worker_pids()),
                  "max_restarts": self.max_restarts,
                  "watchdog_secs": self.watchdog_secs,
                  "compiling_workers": sum(
                      1 for rec in beats.values()
                      if rec.get("compile_in_progress"))}
        gauges.update(_telemetry.compile_gauges("Supervisor"))
        gauges.update(_telemetry.memory_gauges(None))
        # snapshot-stream health: the supervisor's progress
        # accounting rides the checkpoint directory, so its exposition
        # carries the ckpt_* family too
        gauges.update(_telemetry.ckpt_gauges())
        hists = _telemetry.registry().snapshot(
            prefix="Supervisor::")["histograms"]
        payload = _telemetry.exposition("supervisor", "Supervisor",
                                        counters, gauges, hists)
        return _telemetry.render(payload, fmt)

    def _note_heartbeat(self, rank, rec):
        """Fold one heartbeat record into the supervisor's step-time
        telemetry: each NEW (rank, global_step) stamp's ``last_step_ms``
        lands in the ``Supervisor::step_ms`` histogram once.  Called
        from the watchdog scan; never raises (observability must not
        un-guard the gang)."""
        try:
            ms = rec.get("last_step_ms")
            step = rec.get("global_step")
            if ms is None or self._step_seen.get(rank) == step:
                return
            self._step_seen[rank] = step
            _telemetry.registry().histogram(
                "Supervisor::step_ms",
                _telemetry.SPAN_MS_BUCKETS).observe(float(ms))
        except Exception:  # noqa: BLE001
            pass

    # ---- the run loop ----
    def run(self):
        budget = self.max_restarts
        consecutive = 0          # no-progress failures in a row → backoff
        attempt = 0
        self.log = EventLog(self.event_log, echo=sys.stderr)
        try:
            with _fault.GracefulExit() as gexit:
                while True:
                    start_step = self._progress()
                    outcome = self._run_gang(attempt, gexit)
                    end_step = self._progress()
                    if outcome["kind"] == "stopped":
                        self.log.emit("preempted", attempt=attempt,
                                      progress=end_step,
                                      statuses=outcome["statuses"])
                        return 0
                    if outcome["kind"] == "ok":
                        self.log.emit("done", attempt=attempt,
                                      progress=end_step,
                                      restarts=self.restarts)
                        return 0
                    progressed = end_step is not None and (
                        start_step is None or end_step > start_step)
                    if progressed:
                        if budget < self.max_restarts:
                            self.log.emit("budget-refill", attempt=attempt,
                                          progress=end_step,
                                          budget=self.max_restarts)
                        budget = self.max_restarts
                        consecutive = 0
                    if budget <= 0:
                        self.log.emit(
                            "giveup", attempt=attempt, rc=outcome["rc"],
                            reason=outcome["reason"],
                            post_mortem=self._post_mortem(
                                attempt, outcome, start_step, end_step))
                        return outcome["rc"] or 1
                    budget -= 1
                    consecutive += 1
                    self.restarts += 1
                    attempt += 1
                    delay = _fault.backoff_delay(
                        consecutive, self.backoff_base, self.backoff_max)
                    self.log.emit("restart", attempt=attempt,
                                  reason=outcome["reason"],
                                  delay=round(delay, 3), budget_left=budget,
                                  progress=end_step)
                    print(f"[launch] job failed ({outcome['reason']}); "
                          f"restart {self.restarts}/{self.max_restarts} "
                          f"in {delay:.1f}s", file=sys.stderr, flush=True)
                    _fault.fire("supervisor.restart")
                    if self._sleep(delay, gexit):
                        self.log.emit("preempted", attempt=attempt,
                                      progress=end_step, statuses={})
                        return 0
        finally:
            self.log.close()
            if self._hb_dir_owned:
                # the auto-created temp dir is ours to remove (repeated
                # launches must not accumulate /tmp orphans); a
                # user-supplied --heartbeat-dir is left alone
                shutil.rmtree(self.heartbeat_dir, ignore_errors=True)

    # ---- internals ----
    def _progress(self):
        if not self.progress_dir:
            return None
        return latest_committed_step(self.progress_dir, self.progress_prefix)

    def _sleep(self, delay, gexit):
        """Backoff sleep, interruptible by stop/SIGTERM; True if stopped."""
        deadline = time.monotonic() + delay
        while time.monotonic() < deadline:
            if gexit.requested or self._stop.is_set():
                return True
            time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))
        return gexit.requested or self._stop.is_set()

    def _worker_env(self, rank, attempt, port):
        env = dict(os.environ)
        env.update(self.extra_env)
        env.update({
            "DMLC_ROLE": "worker",
            "DMLC_PS_ROOT_URI": self.coordinator_host,
            "DMLC_PS_ROOT_PORT": str(port),
            "DMLC_NUM_WORKER": str(self.num_workers),
            "DMLC_WORKER_ID": str(rank),
            "DMLC_ATTEMPT": str(attempt),
            HEARTBEAT_ENV: self.heartbeat_dir,
        })
        if self.event_log:
            # per-rank flight-recorder bundles land next to
            # the supervisor's own event log: workers arm via
            # telemetry.flight_from_env and dump on their death paths
            # (GracefulExit from the teardown SIGTERM, non-finite abort,
            # unhandled exception) — collection is the shared directory
            env[_telemetry.FLIGHT_ENV] = os.path.join(
                os.path.dirname(os.path.abspath(self.event_log)),
                "flight")
        if self.log_dir or self.prefix_output:
            # redirected stdio makes python block-buffer: progress lines
            # would lag by kilobytes and a SIGKILLed worker's final
            # output — the crash context the prefixing exists to
            # attribute — would vanish with its buffer
            env["PYTHONUNBUFFERED"] = "1"
        devices = self._visible_devices(rank)
        if devices is not None:
            env["CUDA_VISIBLE_DEVICES"] = devices
        return env

    def _visible_devices(self, rank):
        """``CUDA_VISIBLE_DEVICES`` for worker ``rank``, or None to leave
        the inherited value: ``platform="cpu"`` hides every card; with
        ``devices_per_worker=d`` rank r sees cards r*d .. r*d+d-1,
        counted in the launcher's own visible list when it has one."""
        if self.platform == "cpu":
            return ""
        d = self.devices_per_worker
        if not d:
            return None
        inherited = os.environ.get("CUDA_VISIBLE_DEVICES")
        cards = ([c.strip() for c in inherited.split(",") if c.strip()]
                 if inherited else None)
        picked = range(rank * d, rank * d + d)
        if cards is not None:
            if rank * d + d > len(cards):
                raise ValueError(
                    f"Supervisor: worker {rank} needs cards "
                    f"{rank * d}..{rank * d + d - 1}, the launcher sees "
                    f"{len(cards)} (CUDA_VISIBLE_DEVICES={inherited!r})")
            return ",".join(cards[i] for i in picked)
        return ",".join(str(i) for i in picked)

    def _run_gang(self, attempt, gexit):
        """One attempt: spawn all workers, supervise until success,
        failure (then tear the whole gang down), or stop."""
        _fault.fire("supervisor.spawn")
        store = _store_socket(self.coordinator_host)
        port = store.getsockname()[1]
        # stale stamps in a reused --heartbeat-dir (a previous run's
        # attempt-0 files carry the SAME attempt number with an ancient
        # monotonic stamp) would trip the watchdog before the new
        # workers' first beat: every attempt spawns into a clean slate
        for name in os.listdir(self.heartbeat_dir):
            if re.fullmatch(r"heartbeat-r\d+\.json(\.tmp)?", name):
                try:
                    os.remove(os.path.join(self.heartbeat_dir, name))
                except OSError:
                    pass
        procs, pumps, logfiles = [], [], []
        stop_watch = threading.Event()
        try:
            for rank in range(self.num_workers):
                env = self._worker_env(rank, attempt, port)
                held = ()
                if rank == 0:       # rank 0 serves the store on it
                    held = (store.fileno(),)
                    env[STORE_FD_ENV] = str(store.fileno())
                stdout = stderr = None
                if self.log_dir:
                    os.makedirs(self.log_dir, exist_ok=True)
                    lf = open(os.path.join(self.log_dir, f"r{rank}.log"),
                              "ab", buffering=0)
                    logfiles.append(lf)
                    stdout, stderr = lf, subprocess.STDOUT
                elif self.prefix_output:
                    stdout = stderr = subprocess.PIPE
                proc = subprocess.Popen(self.command, env=env,
                                        stdout=stdout, stderr=stderr,
                                        pass_fds=held)
                procs.append(proc)
                if rank == 0:
                    store.close()   # rank 0 holds the port now
                if stdout is subprocess.PIPE:
                    for pipe, stream in ((proc.stdout, sys.stdout),
                                         (proc.stderr, sys.stderr)):
                        t = threading.Thread(
                            target=_pump_lines,
                            args=(pipe, f"[r{rank}] ", stream), daemon=True)
                        t.start()
                        pumps.append(t)
            self._procs = procs
            self.log.emit("spawn", attempt=attempt, port=port,
                          pids=[p.pid for p in procs],
                          progress=self._progress())
            if self.watchdog_secs > 0 or self.startup_grace_secs:
                watchdog = threading.Thread(
                    target=self._watchdog_loop,
                    args=(attempt, procs, stop_watch), daemon=True)
                watchdog.start()
                self._watchdog = watchdog     # owned per attempt; joined
                try:                          # in the finally below
                    return self._wait_gang(procs, attempt, gexit)
                finally:
                    stop_watch.set()
                    watchdog.join(timeout=5)
            return self._wait_gang(procs, attempt, gexit)
        finally:
            store.close()
            stop_watch.set()
            _stop_procs(procs, self.graceful_secs)
            for t in pumps:
                t.join(timeout=5)
            for lf in logfiles:
                lf.close()
            self._procs = []
            self._drain_verdicts()

    def _reap_remaining(self, procs, pending, attempt, statuses):
        """Tear down the still-running workers and account for every one
        of them: each surviving rank gets a worker-exit event with its
        REAL post-teardown status (a SIGCONT+SIGTERM-recovered hang often
        exits ``preempted``), so the event log and the giveup post-mortem
        never under-report the gang."""
        _stop_procs(procs, self.graceful_secs)
        for i in sorted(pending):
            rc = procs[i].returncode
            statuses[i] = classify_exit(rc)
            self.log.emit("worker-exit", attempt=attempt, rank=i,
                          rc=rc, status=statuses[i])

    def _wait_gang(self, procs, attempt, gexit):
        statuses = {}
        pending = set(range(len(procs)))
        while True:
            if gexit.requested or self._stop.is_set():
                self.log.emit("forward-sigterm", attempt=attempt,
                              pids=[procs[i].pid for i in sorted(pending)])
                self._reap_remaining(procs, pending, attempt, statuses)
                return {"kind": "stopped", "rc": 0,
                        "reason": "supervisor-stop", "statuses": statuses}
            for i in sorted(pending):
                rc = procs[i].poll()
                if rc is None:
                    continue
                pending.discard(i)
                statuses[i] = classify_exit(rc)
                self.log.emit("worker-exit", attempt=attempt, rank=i,
                              rc=rc, status=statuses[i])
                if rc != 0:
                    reason = f"worker {i} {statuses[i]} (rc={rc})"
                    self.log.emit("teardown", attempt=attempt, rank=i,
                                  reason=reason)
                    self._reap_remaining(procs, pending, attempt, statuses)
                    return {"kind": "failed", "rc": rc, "reason": reason,
                            "statuses": statuses}
            if not pending:
                return {"kind": "ok", "rc": 0, "reason": "",
                        "statuses": statuses}
            verdict = self._next_verdict(self.poll)
            if verdict is None:
                continue
            kind = verdict[0]
            if kind == "error":
                raise verdict[1]
            _, rank, age = verdict
            if rank in pending:
                if kind == "no-heartbeat":
                    self.log.emit("no-heartbeat", attempt=attempt,
                                  rank=rank, waited_secs=round(age, 2),
                                  startup_grace_secs=self.startup_grace_secs)
                    reason = (f"worker {rank} hung (no heartbeat within "
                              f"{self.startup_grace_secs:.1f}s startup "
                              f"grace)")
                else:
                    self.log.emit("heartbeat-stale", attempt=attempt,
                                  rank=rank, stale_secs=round(age, 2),
                                  watchdog_secs=self.watchdog_secs)
                    reason = (f"worker {rank} hung (heartbeat stale "
                              f"{age:.1f}s > {self.watchdog_secs:.1f}s)")
                self.log.emit("teardown", attempt=attempt, rank=rank,
                              reason=reason)
                self._reap_remaining(procs, pending, attempt, statuses)
                return {"kind": "failed", "rc": 1, "reason": reason,
                        "statuses": statuses}

    def _next_verdict(self, timeout):
        try:
            return self._verdicts.get(timeout=timeout)
        except queue.Empty:
            return None

    def _drain_verdicts(self):
        while True:
            try:
                self._verdicts.get_nowait()
            except queue.Empty:
                return

    def _watchdog_loop(self, attempt, procs, stop_evt):
        """Watchdog thread: scan heartbeat files, declare a live worker
        hung when its current-attempt stamp is stale past
        ``watchdog_secs`` (or, with ``startup_grace_secs``, when it
        never produced one).  Verdicts go to the owner thread through a
        queue; an exception here is forwarded the same way (the producer
        convention — a silently dead watchdog would un-guard the gang)."""
        stale_after = self.watchdog_secs
        tick = max(0.05, min((stale_after or 1.0) / 4.0, 1.0))
        t0 = time.monotonic()
        while not stop_evt.wait(tick):
            try:
                _fault.fire("supervisor.heartbeat")
                beats = read_heartbeats(self.heartbeat_dir)
                now = time.monotonic()
                for rank in range(self.num_workers):
                    if procs[rank].poll() is not None:
                        continue          # exit classification owns it
                    rec = beats.get(rank)
                    if rec is None or int(rec.get("attempt", -1)) != attempt:
                        grace = self.startup_grace_secs
                        if grace and now - t0 > grace:
                            _fault.fire("supervisor.watchdog")
                            # keep scanning after posting: the owner may
                            # discard a verdict whose rank exited in the
                            # meantime, and a watchdog that retired on
                            # the first post would leave the REST of the
                            # gang unguarded for the attempt
                            self._verdicts.put(("no-heartbeat", rank,
                                                now - t0))
                        continue
                    self._note_heartbeat(rank, rec)
                    # NB an "exit"-phase record gets no exemption: a
                    # worker that wedges AFTER its exit beat (shutdown
                    # stuck on the coordination service) is exactly the
                    # unbounded hang this watchdog exists to kill; a
                    # clean exit leaves the stale check via poll() above
                    # long before the stamp ages out
                    if stale_after > 0:
                        age = now - float(rec.get("monotonic_stamp", now))
                        limit = stale_after
                        if rec.get("compile_in_progress"):
                            # the stamp says a compile is in flight: a
                            # long first compile is bring-up, not a hang
                            # — grant the startup grace instead of the
                            # steady-state bound (the next
                            # completed step clears the flag)
                            limit = max(stale_after,
                                        self.startup_grace_secs
                                        or 10.0 * stale_after)
                        if age > limit:
                            _fault.fire("supervisor.watchdog")
                            self._verdicts.put(("hang", rank, age))
            except Exception as exc:
                self._verdicts.put(("error", exc))
                return

    def _post_mortem(self, attempt, outcome, start_step, end_step):
        """The giveup diagnostic: what the job died of, where progress
        stalled, and each rank's last recorded heartbeat."""
        beats = {}
        now = time.monotonic()
        for rank, rec in sorted(read_heartbeats(self.heartbeat_dir).items()):
            beats[str(rank)] = {
                "global_step": rec.get("global_step"),
                "phase": rec.get("phase"),
                "attempt": rec.get("attempt"),
                "stale_secs": round(
                    now - float(rec.get("monotonic_stamp", now)), 2),
            }
        return {"attempts": attempt + 1, "restarts": self.restarts,
                "last_reason": outcome["reason"],
                "statuses": outcome["statuses"],
                "progress_at_spawn": start_step, "progress_now": end_step,
                "heartbeats": beats}
