"""Port parity: ``mxnet_tpu_torch.elastic`` (heartbeats, exit statuses,
the gang supervisor) against the JAX package's ``elastic.py``, on the
CPU.

- The cases of ``tests/test_elastic.py`` for the heartbeat, the exit
  statuses and ``latest_committed_step``, on the port's module.
- Every stub-worker supervisor leg (a gang that succeeds, fail-fast
  teardown, the watchdog, the startup grace, backoff, the progress
  refill, a crash loop, a graceful stop, the non-finite status, the
  fault points) runs under BOTH supervisors with the same stub scripts
  (they import neither package), and the two give the same event
  sequence and the same worker statuses.
- The worker env contract, where the port diverges: ``platform`` /
  ``devices_per_worker`` map onto ``CUDA_VISIBLE_DEVICES`` (the JAX
  supervisor sets ``JAX_PLATFORMS`` and XLA's host device count).
- ``TrainStep(heartbeat=)``: a beat flagged ``compile_in_progress``
  before the first call, then one per step with its milliseconds; the
  non-finite abort lets a queued snapshot commit before it raises and
  counts its skips in ``TrainStep::nonfinite_skips``.
- One rehearsal of the real thing: ``python -m mxnet_tpu_torch.launch``
  over ``python -m mxnet_tpu_torch.elastic_worker --net dense`` on the
  CPU, attempt 0 SIGKILLed after a committed snapshot, attempt 1
  resuming to the target; every step's loss is the bits of an
  uninterrupted in-process run.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from mxnet_tpu import elastic as jelastic
from mxnet_tpu import fault as jfault
from mxnet_tpu_torch import elastic, fault

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jelastic, jfault), "port": (elastic, fault)}

# Stub preamble: a heartbeat writer of the documented schema that
# imports neither package.
STUB_BEAT = """
import json, os, sys, time
HB = os.environ["MXTPU_HEARTBEAT_DIR"]
RANK = os.environ["DMLC_WORKER_ID"]
ATTEMPT = int(os.environ.get("DMLC_ATTEMPT", "0"))
def beat(step, phase="train"):
    p = os.path.join(HB, "heartbeat-r%s.json" % RANK)
    with open(p + ".tmp", "w") as f:
        json.dump({"rank": int(RANK), "attempt": ATTEMPT,
                   "global_step": step, "monotonic_stamp": time.monotonic(),
                   "phase": phase, "pid": os.getpid()}, f)
    os.replace(p + ".tmp", p)
"""


def _stub(tmp_path, body, name="stub.py"):
    path = tmp_path / name
    path.write_text(STUB_BEAT + body)
    return [sys.executable, str(path)]


def _events(sup):
    return [r["event"] for r in sup.log.records]


def _statuses(sup):
    return sorted((r["rank"], r["status"]) for r in sup.log.records
                  if r["event"] == "worker-exit")


# ------------------------------------------------------------ exit status --
def test_classify_exit():
    for el in (elastic, jelastic):
        assert el.classify_exit(0) == "ok"
        assert el.classify_exit(el.EXIT_PREEMPTED) == "preempted"
        assert el.classify_exit(el.EXIT_NONFINITE) == "nonfinite"
        assert el.classify_exit(1) == "crash"
        assert el.classify_exit(-9) == "killed:SIGKILL"
        assert el.classify_exit(-15) == "killed:SIGTERM"
        assert el.classify_exit(None) == "unreaped"
    assert (elastic.EXIT_PREEMPTED, elastic.EXIT_NONFINITE) == \
        (jelastic.EXIT_PREEMPTED, jelastic.EXIT_NONFINITE)
    assert elastic.HEARTBEAT_ENV == jelastic.HEARTBEAT_ENV
    assert issubclass(elastic.NonFiniteAbortError, RuntimeError)
    from mxnet_tpu_torch import parallel
    assert parallel.NonFiniteAbortError is elastic.NonFiniteAbortError


# -------------------------------------------------------------- heartbeat --
def test_heartbeat_schema_and_atomicity(tmp_path):
    hb = elastic.Heartbeat(tmp_path, rank=3, attempt=2)
    assert not os.path.exists(hb.path)
    rec = hb.beat(7, phase="train", last_step_ms=12.34567)
    assert rec["rank"] == 3 and rec["attempt"] == 2
    assert rec["global_step"] == 7 and rec["phase"] == "train"
    assert rec["pid"] == os.getpid() and rec["last_step_ms"] == 12.346
    on_disk = elastic.read_heartbeats(tmp_path)
    assert on_disk[3]["global_step"] == 7
    assert abs(on_disk[3]["monotonic_stamp"] - time.monotonic()) < 5
    assert not os.path.exists(hb.path + ".tmp")
    # the JAX reader reads the port's record and vice versa
    jelastic.Heartbeat(tmp_path, rank=4).beat(9)
    assert sorted(jelastic.read_heartbeats(tmp_path)) == [3, 4]
    assert elastic.read_heartbeats(tmp_path)[4]["global_step"] == 9


def test_heartbeat_cadence(tmp_path):
    hb = elastic.Heartbeat(tmp_path, rank=0, every_n_steps=5)
    assert hb.beat(1) is not None
    assert hb.beat(2) is None
    assert hb.beat(3) is None
    assert hb.beat(4) is None
    assert hb.beat(5) is not None
    assert hb.beat(6, phase="snapshot") is not None
    assert hb.beat(7, phase="snapshot", compile_in_progress=True) \
        is not None                      # a flag change always writes
    hb2 = elastic.Heartbeat(tmp_path, rank=2, every_n_steps=2)
    assert hb2.beat(7) is not None
    stamp0 = elastic.read_heartbeats(tmp_path)[2]["monotonic_stamp"]
    assert hb2.beat(7) is not None       # calls, not step values, thin
    assert elastic.read_heartbeats(tmp_path)[2]["monotonic_stamp"] \
        >= stamp0
    hb3 = elastic.Heartbeat(tmp_path, rank=1)
    hb3(None)
    hb3(None)
    assert elastic.read_heartbeats(tmp_path)[1]["global_step"] == 2


def test_heartbeat_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv(elastic.HEARTBEAT_ENV, raising=False)
    assert elastic.Heartbeat.from_env() is None
    monkeypatch.setenv(elastic.HEARTBEAT_ENV, str(tmp_path))
    monkeypatch.setenv("DMLC_WORKER_ID", "5")
    monkeypatch.setenv("DMLC_ATTEMPT", "3")
    monkeypatch.setenv("MXTPU_HEARTBEAT_EVERY", "2")
    hb = elastic.Heartbeat.from_env()
    assert (hb.rank, hb.attempt, hb.every_n_steps) == (5, 3, 2)


def test_read_heartbeats_skips_damage(tmp_path):
    elastic.Heartbeat(tmp_path, rank=0).beat(1)
    (tmp_path / "heartbeat-r1.json").write_text("{torn")
    out = elastic.read_heartbeats(tmp_path)
    assert 0 in out and 1 not in out


def test_latest_committed_step(tmp_path):
    assert elastic.latest_committed_step(tmp_path) is None
    for n in (2, 10, 6):
        (tmp_path / f"ckpt-{n:08d}.npz").touch()
    (tmp_path / "ckpt-00000099.npz.tmp").touch()
    (tmp_path / "other-00000050.npz").touch()
    assert elastic.latest_committed_step(tmp_path) == 10
    assert elastic.latest_checkpoint(tmp_path)[0] == 10
    assert [s for s, _ in elastic.scan_checkpoints(tmp_path)] == [2, 6, 10]
    assert elastic.scan_checkpoints(tmp_path) == \
        jelastic.scan_checkpoints(tmp_path)


# ------------------------------------------------------- supervisor legs --
# Each leg runs one stub gang under the given package's supervisor,
# checks what tests/test_elastic.py checks, and returns the supervisor.

def leg_success_gang(el, flt, tmp_path):
    cmd = _stub(tmp_path, 'beat(1)\nprint("rank", RANK, "done")\n'
                          'sys.exit(0)\n')
    sup = el.Supervisor(cmd, 2, graceful_secs=2,
                        heartbeat_dir=str(tmp_path / "hb"),
                        event_log=str(tmp_path / "ev.jsonl"))
    assert sup.run() == 0
    evs = _events(sup)
    assert evs.count("worker-exit") == 2 and evs[-1] == "done"
    with open(tmp_path / "ev.jsonl") as f:
        assert [json.loads(x)["event"] for x in f] == evs
    return sup


def leg_fail_fast_teardown(el, flt, tmp_path):
    cmd = _stub(tmp_path, 'if RANK == "1":\n    sys.exit(3)\nbeat(1)\n'
                          'time.sleep(600)\n')
    sup = el.Supervisor(cmd, 2, graceful_secs=1,
                        heartbeat_dir=str(tmp_path / "hb"))
    t0 = time.time()
    assert sup.run() == 3 and time.time() - t0 < 30
    assert sup.worker_pids() == []
    exits = dict(_statuses(sup))
    assert exits[1] == "crash" and exits[0] == "killed:SIGTERM"
    assert "teardown" in _events(sup) and "giveup" in _events(sup)
    return sup


def leg_watchdog_hang(el, flt, tmp_path):
    cmd = _stub(tmp_path, "beat(1)\ntime.sleep(600)\n")
    sup = el.Supervisor(cmd, 1, watchdog_secs=0.6, graceful_secs=1,
                        heartbeat_dir=str(tmp_path / "hb"))
    assert sup.run() != 0
    stale = [r for r in sup.log.records if r["event"] == "heartbeat-stale"]
    assert stale and stale[0]["stale_secs"] >= 0.6
    assert "hung" in [r for r in sup.log.records
                      if r["event"] == "giveup"][0]["reason"]
    return sup


def leg_startup_grace(el, flt, tmp_path):
    cmd = _stub(tmp_path, "time.sleep(600)\n")
    sup = el.Supervisor(cmd, 1, watchdog_secs=30, startup_grace_secs=0.5,
                        graceful_secs=1, heartbeat_dir=str(tmp_path / "hb"))
    assert sup.run() != 0
    nhb = [r for r in sup.log.records if r["event"] == "no-heartbeat"]
    assert nhb and nhb[0]["startup_grace_secs"] == 0.5
    assert el.Supervisor(cmd, 1, watchdog_secs=30).startup_grace_secs == 300
    assert el.Supervisor(cmd, 1).startup_grace_secs is None
    return sup


def leg_backoff(el, flt, tmp_path):
    cmd = _stub(tmp_path, "sys.exit(1)\n")
    sup = el.Supervisor(cmd, 1, max_restarts=2, backoff_base=0.2,
                        graceful_secs=1, heartbeat_dir=str(tmp_path / "hb"))
    assert sup.run() == 1
    restarts = [r for r in sup.log.records if r["event"] == "restart"]
    assert len(restarts) == 2
    for k, rec in enumerate(restarts, start=1):
        assert rec["delay"] >= 0.2 * 2 ** (k - 1)
    spawns = [r["ts"] for r in sup.log.records if r["event"] == "spawn"]
    assert spawns[1] - spawns[0] >= 0.2 and spawns[2] - spawns[1] >= 0.4
    return sup


def leg_progress_refill(el, flt, tmp_path):
    ckd = tmp_path / "ck"
    ckd.mkdir()
    cmd = _stub(tmp_path, """
a = ATTEMPT
open(os.path.join(os.environ["CKDIR"], "ckpt-%08d.npz" % ((a + 1) * 2)),
     "w").close()
sys.exit(0 if a >= 4 else 1)
""")
    sup = el.Supervisor(cmd, 1, max_restarts=1, backoff_base=0.05,
                        graceful_secs=1, progress_dir=str(ckd),
                        heartbeat_dir=str(tmp_path / "hb"),
                        extra_env={"CKDIR": str(ckd)})
    assert sup.run() == 0
    assert sup.restarts == 4
    assert _events(sup).count("budget-refill") == 3
    return sup


def leg_crash_loop_exhausts(el, flt, tmp_path):
    cmd = _stub(tmp_path, "beat(1)\nsys.exit(1)\n")
    sup = el.Supervisor(cmd, 1, max_restarts=1, backoff_base=0.05,
                        graceful_secs=1, progress_dir=str(tmp_path),
                        heartbeat_dir=str(tmp_path / "hb"))
    assert sup.run() == 1
    pm = [r for r in sup.log.records if r["event"] == "giveup"][0][
        "post_mortem"]
    assert pm["attempts"] == 2 and pm["restarts"] == 1
    assert "crash" in pm["last_reason"]
    assert pm["heartbeats"]["0"]["global_step"] == 1
    return sup


def leg_graceful_stop(el, flt, tmp_path):
    snaps = tmp_path / "snaps"
    snaps.mkdir()
    cmd = _stub(tmp_path, """
import signal
flag = []
signal.signal(signal.SIGTERM, lambda s, f: flag.append(s))
n = 0
while not flag:
    n += 1
    beat(n)
    time.sleep(0.02)
beat(n, phase="snapshot")
open(os.path.join(os.environ["SNAPDIR"], "snap-r" + RANK), "w").close()
sys.exit(43)
""")
    sup = el.Supervisor(cmd, 2, graceful_secs=10,
                        heartbeat_dir=str(tmp_path / "hb"),
                        extra_env={"SNAPDIR": str(snaps)})
    threading.Timer(0.6, sup.request_stop).start()
    assert sup.run() == 0
    assert sorted(os.listdir(snaps)) == ["snap-r0", "snap-r1"]
    assert [s for _, s in _statuses(sup)] == ["preempted", "preempted"]
    assert _events(sup)[-1] == "preempted"
    return sup


def leg_nonfinite_status(el, flt, tmp_path):
    cmd = _stub(tmp_path, "sys.exit(44)\n")
    sup = el.Supervisor(cmd, 1, graceful_secs=1,
                        heartbeat_dir=str(tmp_path / "hb"))
    assert sup.run() == 44
    assert _statuses(sup) == [(0, "nonfinite")]
    return sup


def leg_fault_points(el, flt, tmp_path):
    for p in ("supervisor.spawn", "supervisor.heartbeat",
              "supervisor.watchdog", "supervisor.restart"):
        assert p in flt.points()
    cmd = _stub(tmp_path, "beat(1)\ntime.sleep(600)\n")
    with flt.inject("supervisor.heartbeat",
                    RuntimeError("watchdog fault")) as h:
        sup = el.Supervisor(cmd, 1, watchdog_secs=5, graceful_secs=1,
                            heartbeat_dir=str(tmp_path / "hb"))
        with pytest.raises(RuntimeError, match="watchdog fault"):
            sup.run()
    assert h.fired == 1 and sup.worker_pids() == []
    with flt.inject("supervisor.spawn", RuntimeError("spawn fault")) as h:
        sup2 = el.Supervisor(cmd, 1, graceful_secs=1,
                             heartbeat_dir=str(tmp_path / "hb2"))
        with pytest.raises(RuntimeError, match="spawn fault"):
            sup2.run()
    assert h.fired == 1
    return sup


LEGS = {name[4:]: fn for name, fn in globals().items()
        if name.startswith("leg_")}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_supervisor_leg_same_under_both_packages(leg, tmp_path):
    """The same stub gang under the JAX and the port supervisor: each
    passes the JAX test's checks, and the two logs name the same events
    in the same order with the same worker statuses."""
    runs = {}
    for pkg, (el, flt) in PACKAGES.items():
        d = tmp_path / pkg
        d.mkdir()
        runs[pkg] = LEGS[leg](el, flt, d)
    assert _events(runs["port"]) == _events(runs["jax"])
    assert _statuses(runs["port"]) == _statuses(runs["jax"])


# ------------------------------------------------------ worker env contract --
ENV_STUB = """
with open(os.path.join(os.environ["OUT"], "env-r%s.json" % RANK), "w") as f:
    json.dump({k: os.environ.get(k) for k in
               ("DMLC_ROLE", "DMLC_NUM_WORKER", "DMLC_WORKER_ID",
                "DMLC_ATTEMPT", "MXTPU_HEARTBEAT_DIR",
                "CUDA_VISIBLE_DEVICES", "JAX_PLATFORMS")}, f)
"""


def _worker_envs(tmp_path, monkeypatch, inherited, **kw):
    out = tmp_path / f"out-{len(os.listdir(tmp_path))}"
    out.mkdir()
    if inherited is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", inherited)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    hb = str(tmp_path / "hb")
    sup = elastic.Supervisor(_stub(tmp_path, ENV_STUB), 2, graceful_secs=1,
                             heartbeat_dir=hb, extra_env={"OUT": str(out)},
                             **kw)
    assert sup.run() == 0
    envs = [json.loads((out / f"env-r{r}.json").read_text())
            for r in (0, 1)]
    for r, env in enumerate(envs):
        assert env["DMLC_ROLE"] == "worker" and env["DMLC_NUM_WORKER"] == "2"
        assert env["DMLC_WORKER_ID"] == str(r) and env["DMLC_ATTEMPT"] == "0"
        assert env["MXTPU_HEARTBEAT_DIR"] == hb
        assert env["JAX_PLATFORMS"] is None     # the port sets no JAX knob
    return [env["CUDA_VISIBLE_DEVICES"] for env in envs]


def test_supervisor_worker_env_maps_devices_to_cuda_visible_devices(
        tmp_path, monkeypatch):
    assert _worker_envs(tmp_path, monkeypatch, "0,1", platform="cpu") \
        == ["", ""]                             # no card for either
    assert _worker_envs(tmp_path, monkeypatch, None, platform="gpu",
                        devices_per_worker=2) == ["0,1", "2,3"]
    assert _worker_envs(tmp_path, monkeypatch, "4,5,6,7", platform="gpu",
                        devices_per_worker=2) == ["4,5", "6,7"]
    assert _worker_envs(tmp_path, monkeypatch, "3", platform="gpu") \
        == ["3", "3"]                           # inherited as it is
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2")
    short = elastic.Supervisor(["true"], 2, platform="gpu",
                               devices_per_worker=2,
                               heartbeat_dir=str(tmp_path / "hb"))
    with pytest.raises(ValueError, match="the launcher sees 3"):
        short._visible_devices(1)
    with pytest.raises(ValueError, match="platform"):
        elastic.Supervisor(["true"], 1, platform="tpu")


def test_launch_cli_prefixes_output_and_tees_logs(tmp_path):
    cmd = _stub(tmp_path, 'print("marker-out"); '
                          'print("marker-err", file=sys.stderr)\n')
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2", *cmd],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, (proc.stdout[-1500:], proc.stderr[-1500:])
    for r in (0, 1):
        assert f"[r{r}] marker-out" in proc.stdout
        assert f"[r{r}] marker-err" in proc.stderr
    log_dir = tmp_path / "logs"
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
         "--log-dir", str(log_dir), *cmd],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-1500:]
    for r in (0, 1):
        assert "marker-out" in (log_dir / f"r{r}.log").read_text()


def test_launch_drives_the_packages_supervisor_and_fault_points(tmp_path):
    """The launcher's supervisor is the package's ``elastic``, so a fault
    point armed on the package's ``fault`` fires inside ``main()``."""
    from mxnet_tpu_torch import launch
    assert launch.elastic is elastic
    cmd = _stub(tmp_path, "beat(1)\n")
    with fault.inject("supervisor.spawn", RuntimeError("spawn fault"),
                      times=1) as h:
        with pytest.raises(RuntimeError, match="spawn fault"):
            launch.main(["-n", "1", "--graceful-secs", "1",
                         "--heartbeat-dir", str(tmp_path / "hb"), *cmd])
    assert h.fired == 1


# ------------------------------------------------------ worker-side wiring --
class _Recorder(elastic.Heartbeat):
    """A heartbeat that also keeps every call's arguments."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = []

    def beat(self, global_step=None, phase="train", last_step_ms=None,
             compile_in_progress=False):
        self.calls.append((global_step, phase, last_step_ms,
                           compile_in_progress))
        return super().beat(global_step, phase, last_step_ms,
                            compile_in_progress)


def _dense_step(hb=None, **kw):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, parallel
    mx.random.seed(0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(4, in_units=3))
    net.initialize(ctx="cpu")
    return parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              mx.optimizer.create("sgd"), heartbeat=hb,
                              **kw)


def test_trainstep_heartbeat_wiring(tmp_path):
    hb = _Recorder(tmp_path, rank=0)
    step = _dense_step(hb)
    rng = np.random.RandomState(0)
    for _ in range(3):
        step(rng.randn(8, 3).astype(np.float32), rng.randint(0, 4, (8,)))
    rec = elastic.read_heartbeats(tmp_path)[0]
    assert rec["global_step"] == 3 and rec["phase"] == "train"
    assert rec["compile_in_progress"] is False
    # before the first (building) call, then after every step
    assert hb.calls[0] == (0, "train", None, True)
    assert [c[0] for c in hb.calls[1:]] == [1, 2, 3]
    assert all(c[2] > 0 and c[3] is False for c in hb.calls[1:])


def test_nonfinite_abort_flushes_pending_snapshots(tmp_path, monkeypatch):
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.parallel import checkpoint as ck

    real = ck._write_payload

    def slow(*a, **kw):
        time.sleep(0.5)
        return real(*a, **kw)

    monkeypatch.setattr(ck, "_write_payload", slow)
    step = _dense_step(skip_nonfinite=True, nonfinite_budget=2)
    rng = np.random.RandomState(0)
    y = rng.randint(0, 4, (8,))
    step(rng.randn(8, 3).astype(np.float32), y)
    mgr = ck.CheckpointManager(step, tmp_path, async_save=True)
    try:
        assert mgr.save() is not None
        bad = np.full((8, 3), np.nan, np.float32)
        step(bad, y)
        assert profiler.counter_value("TrainStep::nonfinite_skips") == 1
        with pytest.raises(elastic.NonFiniteAbortError):
            step(bad, y)
        # the queued write committed before the abort unwound
        assert mgr.latest_step() == 1
        assert mgr._snapshotter.pending_writes == 0
        assert profiler.counter_value("TrainStep::nonfinite_skips") == 2
    finally:
        mgr.close(timeout=30)
    ck.verify_checkpoint(mgr.checkpoints()[-1][1])


# --------------------------------------------------- the CPU rehearsal ------
def _worker_lines(text):
    """Every ``[worker] {json}`` record of the launcher's output.  A
    worker killed after writing a record but before its newline leaves
    the next attempt's line on the same line: each record is read on
    its own."""
    out = []
    dec = json.JSONDecoder()
    for line in text.splitlines():
        for part in line.split("[worker] ")[1:]:
            out.append(dec.raw_decode(part)[0])
    return out


def test_launch_rehearsal_kill_and_resume_bit_equal(tmp_path, capsys):
    """``python -m mxnet_tpu_torch.launch`` over the dense worker on the
    CPU: attempt 0 is SIGKILLed once it has a committed snapshot, the
    supervisor restarts it, attempt 1 resumes and reaches the target;
    every step's loss is the bits of an uninterrupted in-process run."""
    from mxnet_tpu_torch import elastic_worker

    target = 8
    assert elastic_worker.main(["--device", "cpu", "--net", "dense",
                                "--target-step", str(target), "--ckpt-dir",
                                str(tmp_path / "ref"), "--every", "2"]) == 0
    ref = {r["num_update"]: r["loss"]
           for r in _worker_lines(capsys.readouterr().out)
           if "num_update" in r}
    assert sorted(ref) == list(range(1, target + 1))

    ckd, hb, ev = tmp_path / "ck", tmp_path / "hb", tmp_path / "ev.jsonl"
    killed = []

    def watch():
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and not killed:
            rec = elastic.read_heartbeats(hb).get(0)
            if rec and rec["attempt"] == 0 and rec["global_step"] >= 3 \
                    and (elastic.latest_committed_step(ckd) or 0) >= 2:
                os.kill(rec["pid"], signal.SIGKILL)
                killed.append(rec["global_step"])
            time.sleep(0.02)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "1",
         "--platform", "cpu", "--max-restarts", "2", "--backoff-base",
         "0.1", "--heartbeat-dir", str(hb), "--event-log", str(ev),
         "--progress-dir", str(ckd),
         sys.executable, "-m", "mxnet_tpu_torch.elastic_worker",
         "--device", "cpu", "--net", "dense", "--target-step", str(target),
         "--ckpt-dir", str(ckd), "--every", "2", "--step-sleep", "0.3"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    watcher.join(timeout=10)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert killed, "attempt 0 was never killed"
    lines = _worker_lines(proc.stdout)
    resumed = [r["resumed_at"] for r in lines if "resumed_at" in r]
    assert resumed[0] is None and resumed[1] is not None \
        and resumed[1] >= 2
    steps = [r for r in lines if "num_update" in r]
    assert {r["num_update"] for r in steps} == set(ref)
    for r in steps:
        assert r["loss"] == ref[r["num_update"]], r
    events = [json.loads(x)["event"] for x in ev.read_text().splitlines()]
    assert events[0] == "spawn" and events[-1] == "done"
    assert "restart" in events
    exits = [json.loads(x)["status"] for x in ev.read_text().splitlines()
             if json.loads(x)["event"] == "worker-exit"]
    assert exits == ["killed:SIGKILL", "ok"]
    assert elastic.latest_committed_step(ckd) == target
