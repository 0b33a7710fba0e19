"""The serving fleet of the port (``mxnet_tpu_torch.serving``:
``ServingFleet``, ``ReplicaGroup``, ``HotSwapApply``, ``WeightUpdater``,
``validate_params``, ``FleetAutoscaler``, ``ScalingPolicy``) on the CPU.

- The cases of ``tests/test_fleet.py`` rewritten against the port:
  health-aware routing, quarantine and failover, rolling weight updates
  with rollback, the checkpoint-directory updater, drain and SIGTERM,
  the fault points, elastic membership, tenant QoS and the autoscaler.
  Every fleet shares ONE torch ``fn(params, x)`` across its replicas
  that records each new input signature (what ``graphs.captured``
  captures a graph for on the card), so the grid's census bounds the
  whole fleet, before and after weight swaps.
- Parity with the JAX package: ``validate_params`` gives the JAX
  function's verdict on the same numpy snapshots with torch served
  params; ``ScalingPolicy.verdict`` gives JAX's verdicts on one fixed
  sequence of signals; a snapshot written by the JAX package's
  ``save_train_step`` rolls into a port fleet, bits intact.
"""
import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

try:
    import mxnet_tpu as jmx
except ImportError:          # the card's machine has no JAX
    jmx = None
from mxnet_tpu_torch import fault, graphs, profiler, serving
from mxnet_tpu_torch.parallel.checkpoint import wait_for_new
from mxnet_tpu_torch.serving import (CircuitBreaker, FleetAutoscaler,
                                     HotSwapApply, QoSClass, RejectedError,
                                     ScalingPolicy, ServerClosedError,
                                     ServingFleet, SnapshotPrunedError,
                                     SnapshotRejectedError, TenantQoS,
                                     TenantThrottledError,
                                     UpdateRolledBackError, WeightUpdater)

pytestmark = pytest.mark.fleet
chaos = pytest.mark.chaos
slo = pytest.mark.slo

W0 = np.eye(4, dtype=np.float32)


def make_fn():
    """One shared torch matmul that records one entry per new input
    signature — what ``graphs.captured`` captures a graph for on the
    card; ``jitted._cache_size`` counts them."""
    traces = []

    def fwd(params, x):
        if (x.shape, str(x.dtype)) not in fwd.seen:
            fwd.seen.append((x.shape, str(x.dtype)))
            traces.append(x.shape)
        (w,) = params
        return torch.as_tensor(x) @ torch.as_tensor(w)

    fwd.seen = []
    fwd._cache_size = lambda: len(fwd.seen)

    def apply(params, x):
        return fwd(params, x)

    apply.traces = traces
    apply.jitted = fwd
    return apply


def executable_census(spec):
    """Graphs the bucket grid allows: one per (batch, length) bucket."""
    return len(spec.batch) * len(spec.length or (None,))


class FlakyApply(HotSwapApply):
    """HotSwapApply with switchable failure modes: ``fail=True`` raises
    (a step fault the breaker sees), ``dead=True`` raises SystemExit
    (the batch thread dies — a killed replica); a ``gate`` (an Event)
    holds every call until it is set."""

    def __init__(self, fn, params, delay=0.0):
        super().__init__(fn, params)
        self.fail = False
        self.dead = False
        self.delay = delay
        self.gate = None

    def __call__(self, *leaves):
        if self.gate is not None:
            self.gate.wait(30)
        if self.dead:
            raise SystemExit("replica killed")
        if self.fail:
            raise RuntimeError("replica wedged")
        if self.delay:
            time.sleep(self.delay)
        return super().__call__(*leaves)


def make_fleet(n=3, fn=None, delays=None, sample=None, **kw):
    fn = fn or make_fn()
    applies = [FlakyApply(fn, [W0], delay=(delays or [0.0] * n)[i])
               for i in range(n)]
    kw.setdefault("max_delay", 0.002)
    kw.setdefault("buckets", (1, 2, 4))
    fleet = ServingFleet(applies, sample=(sample if sample is not None
                                          else np.ones((4,), np.float32)),
                         **kw)
    fleet.apply_fns = applies
    fleet.fn = fn
    return fleet


def _ex(v, n=4):
    return np.full((n,), float(v), np.float32)


def _load(fleet, n=40, spacing=0.002):
    reqs = []
    for i in range(n):
        reqs.append(fleet.submit(_ex(i % 7)))
        time.sleep(spacing)
    return reqs


def _replica_completed(fleet):
    return {name: st["completed"]
            for name, st in fleet.stats["replicas"].items()}


# --------------------------------------------------------------- routing --
def test_fleet_roundtrip_and_books_balance():
    fleet = make_fleet(n=2, name="FleetRt").start()
    try:
        out = fleet(_ex(3))
        np.testing.assert_allclose(out, _ex(3))       # identity weights
        reqs = [fleet.submit(_ex(i)) for i in range(10)]
        for i, r in enumerate(reqs):
            np.testing.assert_allclose(r.result(10), _ex(i))
    finally:
        assert fleet.drain(timeout=30)
    st = fleet.stats
    assert st["admitted"] == 11
    assert st["completed"] + st["failed"] + st["expired"] == st["admitted"]
    assert st["outstanding"] == 0


def test_routing_skews_to_least_loaded():
    """A slow replica accumulates in-flight work and the router routes
    around it: the fast replicas take the overwhelming share."""
    fleet = make_fleet(n=3, delays=[0.08, 0.0, 0.0],
                       name="FleetSkew").start()
    try:
        for r in _load(fleet, n=45):
            r.result(20)
    finally:
        assert fleet.drain(timeout=30)
    done = _replica_completed(fleet)
    slow, fast1, fast2 = done["r0"], done["r1"], done["r2"]
    assert fast1 + fast2 > 3 * slow, done
    assert fast1 > slow and fast2 > slow, done


def test_per_replica_inflight_cap_sheds_at_the_front_door():
    """With every replica at its in-flight cap the fleet sheds
    immediately (admission-level — never retried, never queued)."""
    fleet = make_fleet(n=2, delays=[0.2, 0.2], max_inflight=1,
                       name="FleetCap").start()
    try:
        first = [fleet.submit(_ex(1)), fleet.submit(_ex(2))]
        with pytest.raises(RejectedError, match="headroom|refused"):
            fleet.submit(_ex(3))
        assert fleet.stats["shed"] == 1
        for r in first:
            r.result(20)
    finally:
        assert fleet.drain(timeout=30)


def test_submit_before_start_and_after_drain_refuse():
    fleet = make_fleet(n=1, name="FleetLC")
    with pytest.raises(RejectedError, match="not started"):
        fleet.submit(_ex(0))
    fleet.start()
    fleet(_ex(1))
    assert fleet.drain(timeout=30)
    with pytest.raises(ServerClosedError, match="draining"):
        fleet.submit(_ex(0))


# ------------------------------------------------------------ quarantine --
@chaos
def test_open_breaker_replica_quarantined_then_readmitted():
    """The quarantine contract: a replica whose breaker trips
    OPEN leaves the routing set, traffic keeps flowing on the others,
    and a successful probe readmits it."""
    fleet = make_fleet(
        n=2, name="FleetQuar",
        breaker=lambda: CircuitBreaker(threshold=2, base_delay=0.03,
                                       max_delay=0.05, jitter=0.0),
        probe_base_delay=0.02, probe_max_delay=0.05, probe_jitter=0.0)
    fleet.start()
    try:
        r0 = fleet.replicas[0]
        fleet.apply_fns[0].fail = True
        # trip r0's breaker with DIRECT submits (fleet routing would
        # dutifully fail over and hide the trip from this test)
        for _ in range(2):
            with pytest.raises(RuntimeError, match="wedged"):
                r0.server(np.ones((4,), np.float32))
        assert r0.server.breaker.state == "open"
        t0 = time.time()
        while not fleet.healthz()["replicas"]["r0"]["quarantined"] \
                and time.time() - t0 < 5:
            time.sleep(0.01)
        h = fleet.healthz()
        assert h["replicas"]["r0"]["quarantined"]
        assert h["ready"]                      # r1 still carries traffic
        for i in range(6):
            fleet(_ex(i))                      # ...and actually does
        assert _replica_completed(fleet)["r1"] >= 6

        fleet.apply_fns[0].fail = False        # replica heals
        t0 = time.time()
        while fleet.healthz()["replicas"]["r0"]["quarantined"] \
                and time.time() - t0 < 10:
            time.sleep(0.01)
        assert not fleet.healthz()["replicas"]["r0"]["quarantined"]
        assert fleet.stats["probes"] >= 1
        assert r0.server.breaker.state == "closed"
        before = _replica_completed(fleet)["r0"]
        for i in range(8):
            fleet(_ex(i))
        assert _replica_completed(fleet)["r0"] > before    # serving again
    finally:
        assert fleet.drain(timeout=30)


# --------------------------------------------------------------- failover --
@chaos
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_replica_kill_mid_traffic_drops_zero_accepted_requests():
    """Hard-kill one replica under live traffic: every request the FLEET
    accepted resolves with a RESULT — the killed replica's queued and
    mid-batch work fails over to the survivors."""
    fleet = make_fleet(n=3, delays=[0.004, 0.004, 0.004],
                       name="FleetKill").start()
    accepted, shed = [], [0]
    lock = threading.Lock()
    stop = threading.Event()

    def client(k):
        r = np.random.RandomState(k).randn(4).astype(np.float32)
        while not stop.is_set():
            try:
                req = fleet.submit(r)
                with lock:
                    accepted.append(req)
            except RejectedError:
                with lock:
                    shed[0] += 1
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.1)
        fleet.apply_fns[1].dead = True       # SystemExit on the batch thread
        time.sleep(0.3)
        # the router's health scan quarantines the dead replica on one of
        # its ticks (a loaded host may delay them): traffic keeps flowing
        # until it has
        t0 = time.time()
        while not fleet.healthz()["replicas"]["r1"]["quarantined"] \
                and time.time() - t0 < 10:
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join()
    finally:
        stop.set()
        drained = fleet.drain(timeout=60)
    assert drained
    assert len(accepted) > 50                 # load actually flowed
    assert all(r.done() for r in accepted)    # zero silently dropped
    errs = [r.exception(0) for r in accepted if r.exception(0) is not None]
    assert errs == []                         # failover, not failure
    assert fleet.stats["redispatched"] >= 1
    assert not fleet.replicas[1].server.alive()
    assert fleet.healthz()["replicas"]["r1"]["quarantined"]


@chaos
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dead_batch_group_resolves_not_hangs():
    """The batcher layer of the kill path, in isolation: a BaseException
    out of the apply fn (the thread is dying) must resolve the in-flight
    group — with a retry-safe error — not strand it."""
    fn = make_fn()
    apply = FlakyApply(fn, [W0])
    srv = serving.InferenceServer(apply, buckets=(2,), max_delay=0.01,
                                  name="DeadGroup")
    srv.start(warmup=False)
    apply.dead = True
    r1, r2 = srv.submit(_ex(1)), srv.submit(_ex(2))
    for r in (r1, r2):
        with pytest.raises(ServerClosedError, match="died mid-batch"):
            r.result(10)
    t0 = time.time()
    while srv.alive() and time.time() - t0 < 5:
        time.sleep(0.01)
    assert not srv.alive()
    srv.drain()


@chaos
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_deadline_less_request_resolves_when_whole_fleet_dies():
    """An accepted request with NO deadline whose failover finds every
    batch thread dead must resolve with an explicit error — never hang
    a client on a fleet that can no longer serve."""
    fleet = make_fleet(n=2, delays=[0.02, 0.02], name="FleetAllDead")
    fleet.start()
    try:
        for a in fleet.apply_fns:
            a.dead = True
        req = fleet.submit(_ex(1))             # accepted while both alive
        with pytest.raises(ServerClosedError, match="dead"):
            req.result(20)                     # resolves, does not hang
    finally:
        fleet.drain(timeout=30)


def test_already_expired_deadline_raises_deadline_error():
    """'Deadline passed anywhere → DeadlineExceededError' holds at the
    front door too — never a retry-elsewhere RejectedError."""
    from mxnet_tpu_torch.serving import DeadlineExceededError

    fleet = make_fleet(n=1, name="FleetExp").start()
    try:
        with pytest.raises(DeadlineExceededError):
            fleet.submit(_ex(1), deadline=-0.001)
        fleet(_ex(1))                          # fleet unharmed
    finally:
        assert fleet.drain(timeout=30)


# -------------------------------------------------- rolling weight updates --
@chaos
def test_rolling_update_under_load_zero_drops_zero_new_executables():
    """The tentpole acceptance: a rolling weight swap under continuous
    traffic drops nothing, serves the new weights afterwards, and
    compiles NOTHING new — the jit-cache census is identical before and
    after (same shapes/dtypes ⇒ same executables)."""
    fleet = make_fleet(n=3, name="FleetRoll").start()
    fn = fleet.fn
    census = executable_census(fleet.buckets)
    assert len(set(fn.traces)) == census == fn.jitted._cache_size()

    accepted = []
    lock = threading.Lock()
    stop = threading.Event()

    def client(k):
        r = np.ones((4,), np.float32)
        while not stop.is_set():
            try:
                req = fleet.submit(r)
                with lock:
                    accepted.append(req)
            except RejectedError:
                pass
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.05)
        updater = WeightUpdater(fleet, probe_deadline=10.0)
        n_swapped = updater.update([2.0 * W0])
        assert n_swapped == 3
        time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join()
        out = fleet(np.ones((4,), np.float32))
        np.testing.assert_allclose(out, np.full((4,), 2.0))  # new weights
    finally:
        stop.set()
        drained = fleet.drain(timeout=60)
    assert drained
    assert accepted and all(r.done() for r in accepted)
    assert [r for r in accepted if r.exception(0) is not None] == []
    # the census did not move: zero recompiles across the whole update
    assert len(set(fn.traces)) == census == fn.jitted._cache_size()
    assert fleet.stats["swaps"] == 1


@chaos
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_rolling_update_skips_dead_replica():
    """Losing a replica must not wedge weight streaming: the update
    rolls across the survivors and the dead one is skipped."""
    fleet = make_fleet(n=3, name="FleetDeadUp").start()
    try:
        fleet.apply_fns[2].dead = True
        with pytest.raises(Exception):
            fleet.replicas[2].server(np.ones((4,), np.float32))
        t0 = time.time()
        while fleet.replicas[2].server.alive() and time.time() - t0 < 5:
            time.sleep(0.01)
        updater = WeightUpdater(fleet)
        assert updater.update([2.0 * W0]) == 2        # survivors only
        np.testing.assert_allclose(fleet(np.ones((4,), np.float32)),
                                   np.full((4,), 2.0))
    finally:
        assert fleet.drain(timeout=30)


def test_nan_snapshot_rejected_before_any_swap():
    fleet = make_fleet(n=2, name="FleetNaN").start()
    try:
        updater = WeightUpdater(fleet)
        poisoned = [np.full((4, 4), np.nan, np.float32)]
        with pytest.raises(SnapshotRejectedError, match="non-finite"):
            updater.update(poisoned)
        for rep in fleet.replicas:            # nothing was ever swapped
            assert rep.apply.params[0] is W0
        assert fleet.healthz()["ready_replicas"] == 2
        np.testing.assert_allclose(fleet(_ex(1)), _ex(1))
        assert updater.skipped == 1 and updater.applied == 0
    finally:
        assert fleet.drain(timeout=30)


def test_shape_and_dtype_drift_rejected():
    fleet = make_fleet(n=1, name="FleetDrift").start()
    try:
        updater = WeightUpdater(fleet)
        with pytest.raises(SnapshotRejectedError, match="shape"):
            updater.update([np.eye(5, dtype=np.float32)])
        with pytest.raises(SnapshotRejectedError, match="dtype"):
            updater.update([np.eye(4, dtype=np.float64)])
        with pytest.raises(SnapshotRejectedError, match="leaves"):
            updater.update([W0, W0])
        with pytest.raises(SnapshotRejectedError, match="indexing"):
            updater.update({"w": W0})          # dict vs served list
    finally:
        assert fleet.drain(timeout=30)


def test_dict_params_survive_update_with_container_intact():
    """An apply fn that indexes params by KEY must keep getting a dict
    after a rolling update — and mismatched keys must be refused."""
    def fwd(params, x):
        return torch.as_tensor(x) @ torch.as_tensor(params["w"])

    fleet = ServingFleet(
        [HotSwapApply(lambda p, x: fwd(p, x), {"w": W0})
         for _ in range(2)],
        buckets=(1, 2), max_delay=0.002,
        sample=np.ones((4,), np.float32), name="FleetDict").start()
    try:
        updater = WeightUpdater(fleet)
        assert updater.update({"w": 2.0 * W0}) == 2
        np.testing.assert_allclose(fleet(np.ones((4,), np.float32)),
                                   np.full((4,), 2.0))
        for rep in fleet.replicas:
            assert isinstance(rep.apply.params, dict)
        with pytest.raises(SnapshotRejectedError, match="key"):
            updater.update({"v": W0})
    finally:
        assert fleet.drain(timeout=30)


@chaos
def test_poisoned_snapshot_rolls_back_and_never_serves():
    """Finite params that explode in the forward pass clear validation
    but fail the post-swap probe: the replica rolls back, the update
    aborts, the fleet returns to full ready capacity — and no client
    request was ever served by the poisoned weights."""
    fleet = make_fleet(n=2, name="FleetRb").start()
    served = []
    lock = threading.Lock()
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                with lock:
                    served.append(fleet(np.ones((4,), np.float32),
                                        timeout=30))
            except RejectedError:
                pass
            time.sleep(0.002)

    t = threading.Thread(target=client)
    try:
        t.start()
        updater = WeightUpdater(fleet, probe_deadline=10.0)
        overflow = [np.full((4, 4), 3e38, np.float32)]   # finite; x@w = inf
        with pytest.raises(UpdateRolledBackError, match="rolled back"):
            updater.update(overflow)
        time.sleep(0.05)
        stop.set()
        t.join()
        h = fleet.healthz()
        assert h["ready_replicas"] == 2        # full capacity restored
    finally:
        stop.set()
        if t.is_alive():
            t.join()
        drained = fleet.drain(timeout=30)
    assert drained
    assert served                              # traffic flowed throughout
    for out in served:                         # ...always on the OLD weights
        np.testing.assert_allclose(out, np.ones((4,)))
    assert fleet.stats["rollbacks"] == 1
    for rep in fleet.replicas:
        assert rep.apply.params[0] is W0


def _write_snapshot(directory, num_update, params, names):
    """A v1 ``save_train_step`` payload written without a TrainStep —
    same container (``p.<k>`` + embedded manifest), same atomic commit."""
    os.makedirs(directory, exist_ok=True)
    manifest = {"train_names": list(names), "aux_names": [],
                "optimizer": "SGD", "num_update": int(num_update),
                "state_counts": [0] * len(names)}
    payload = {f"p.{k}": np.asarray(a) for k, a in enumerate(params)}
    payload["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    path = os.path.join(directory, f"ckpt-{num_update:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
    return path


def test_updater_watches_checkpoint_directory(tmp_path):
    """The training→serving stream end to end: snapshots committed to a
    checkpoint directory roll onto the fleet as they appear, in order,
    via ``wait_for_new``."""
    d = str(tmp_path / "ckpts")
    _write_snapshot(d, 1, [W0], ["dense_weight"])
    fleet = make_fleet(n=2, name="FleetWatch").start()
    try:
        updater = WeightUpdater(fleet, d, last_seen=1, poll=0.05)
        assert updater.poll_once(timeout=0.2) is None    # nothing new yet
        _write_snapshot(d, 7, [3.0 * W0], ["dense_weight"])
        assert updater.poll_once(timeout=5.0) == 7
        np.testing.assert_allclose(fleet(_ex(1)), np.full((4,), 3.0))
        assert updater.last_seen == 7 and updater.applied == 1

        # the background watcher picks the next one up by itself
        updater.start()
        _write_snapshot(d, 9, [5.0 * W0], ["dense_weight"])
        t0 = time.time()
        while updater.applied < 2 and time.time() - t0 < 10:
            time.sleep(0.02)
        assert updater.stop(timeout=5)
        assert updater.applied == 2
        np.testing.assert_allclose(fleet(_ex(1)), np.full((4,), 5.0))
    finally:
        assert fleet.drain(timeout=30)


def test_updater_default_last_seen_skips_preexisting_snapshot(tmp_path):
    """Default construction must NOT re-apply the snapshot the fleet was
    (typically) just initialized from — only snapshots committed after
    the updater exists stream in."""
    d = str(tmp_path / "ckpts")
    _write_snapshot(d, 4, [W0], ["w"])
    fleet = make_fleet(n=1, name="FleetSeen").start()
    try:
        updater = WeightUpdater(fleet, d, poll=0.05)
        assert updater.last_seen == 4
        assert updater.poll_once(timeout=0.2) is None     # no no-op roll
        assert updater.applied == 0
        _write_snapshot(d, 6, [2.0 * W0], ["w"])
        assert updater.poll_once(timeout=5.0) == 6
    finally:
        assert fleet.drain(timeout=30)


def _write_snapshot_v11(directory, num_update, params, names, corrupt=False):
    """A v1.1 snapshot (manifest carries per-entry crc32 digests + byte
    sizes) without a TrainStep.  ``corrupt=True`` flips one bit in the
    largest payload entry AFTER the digests are computed — the container
    stays internally consistent (zip member CRCs match the bytes on
    disk), only the manifest digest disagrees, exactly the damage shape
    ``BitFlipInjection`` produces in the writer."""
    import zlib
    os.makedirs(directory, exist_ok=True)
    payload = {f"p.{k}": np.asarray(a) for k, a in enumerate(params)}
    digests, sizes = {}, {}
    for key, a in payload.items():
        b = np.ascontiguousarray(a).tobytes()
        digests[key] = zlib.crc32(b) & 0xFFFFFFFF
        sizes[key] = len(b)
    if corrupt:
        key = max(payload, key=lambda k: payload[k].nbytes)
        buf = bytearray(np.ascontiguousarray(payload[key]).tobytes())
        buf[len(buf) // 2] ^= 1
        payload[key] = np.frombuffer(
            bytes(buf), dtype=payload[key].dtype).reshape(payload[key].shape)
    manifest = {"format": "1.1", "train_names": list(names),
                "aux_names": [], "optimizer": "SGD",
                "num_update": int(num_update),
                "state_counts": [0] * len(names),
                "digests": digests, "sizes": sizes}
    payload["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    path = os.path.join(directory, f"ckpt-{num_update:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
    return path


def test_updater_rejects_corrupt_snapshot_without_swap(tmp_path):
    """A bit-flipped snapshot must be caught by the
    digest check BEFORE any replica quarantine/swap — the fleet keeps
    serving the old weights uninterrupted and the file is marked seen
    (counted in ``skipped``) so the poll loop moves on to the next one."""
    d = str(tmp_path / "ckpts")
    _write_snapshot_v11(d, 1, [W0], ["w"])
    fleet = make_fleet(n=2, name="FleetCorrupt").start()
    try:
        updater = WeightUpdater(fleet, d, last_seen=1, poll=0.05)
        _write_snapshot_v11(d, 5, [4.0 * W0], ["w"], corrupt=True)
        with pytest.raises(SnapshotRejectedError, match="integrity"):
            updater.poll_once(timeout=5.0)
        assert updater.skipped == 1 and updater.applied == 0
        assert updater.last_seen == 5            # marked seen, not retried
        np.testing.assert_allclose(fleet(_ex(1)), np.ones((4,)))  # old W0
        for rep in fleet.replicas:               # no replica ever swapped
            assert rep.apply.params[0] is W0

        # the next INTACT snapshot still streams through normally
        _write_snapshot_v11(d, 8, [2.0 * W0], ["w"])
        assert updater.poll_once(timeout=5.0) == 8
        np.testing.assert_allclose(fleet(_ex(1)), np.full((4,), 2.0))
    finally:
        assert fleet.drain(timeout=30)


def test_updater_pruned_snapshot_is_stale_not_rejected(tmp_path, monkeypatch):
    """A snapshot pruned by retention between
    discovery and read is STALE (re-poll), not corrupt — ``update``
    raises ``SnapshotPrunedError``, ``poll_once`` absorbs it and returns
    None, and the ``skipped`` (bad-snapshot) counter stays untouched."""
    d = str(tmp_path / "ckpts")
    _write_snapshot(d, 1, [W0], ["w"])
    fleet = make_fleet(n=1, name="FleetPrune").start()
    try:
        updater = WeightUpdater(fleet, d, last_seen=1, poll=0.05)
        gone = os.path.join(d, "ckpt-00000007.npz")
        with pytest.raises(SnapshotPrunedError, match="pruned"):
            updater.update(gone)
        assert updater.skipped == 0 and updater.applied == 0

        # poll_once: discovery finds a snapshot that vanishes before the
        # read — simulate the race by having wait_for_new hand back a
        # path that retention already deleted
        victim = _write_snapshot(d, 7, [3.0 * W0], ["w"])
        os.remove(victim)
        from mxnet_tpu_torch.parallel import checkpoint as ck
        monkeypatch.setattr(ck, "wait_for_new",
                            lambda *a, **k: (7, victim))
        assert updater.poll_once(timeout=1.0) is None
        assert updater.skipped == 0              # stale, NOT bad
    finally:
        assert fleet.drain(timeout=30)


def test_updater_requires_hot_swap_protocol_and_sample():
    fn = make_fn()
    fleet = ServingFleet([lambda x: x], sample=np.ones((4,), np.float32))
    with pytest.raises(ValueError, match="HotSwapApply"):
        WeightUpdater(fleet)
    fleet2 = ServingFleet([HotSwapApply(fn, [W0])], sample=None)
    with pytest.raises(ValueError, match="sample"):
        WeightUpdater(fleet2)


# ------------------------------------------------------------------- drain --
def test_fleet_drain_flushes_every_accepted_request():
    fleet = make_fleet(n=2, delays=[0.01, 0.01], name="FleetDrain").start()
    reqs = [fleet.submit(_ex(i)) for i in range(12)]
    assert fleet.drain(timeout=60)
    assert all(r.done() for r in reqs)
    for i, r in enumerate(reqs):               # flushed WITH results
        np.testing.assert_allclose(r.result(0), _ex(i))
    assert not fleet.alive() and not fleet.ready()
    st = fleet.stats
    assert st["completed"] + st["failed"] + st["expired"] == st["admitted"]


def test_context_manager_drains():
    with make_fleet(n=2, name="FleetCtx") as fleet:
        fleet(_ex(1))
    assert not fleet.alive()


@chaos
def test_sigterm_serve_forever_drains_fleet_without_drops():
    fleet = make_fleet(n=2, delays=[0.005, 0.005], name="FleetSig").start()
    accepted = []
    stop = threading.Event()
    lock = threading.Lock()

    def client():
        while not stop.is_set():
            try:
                req = fleet.submit(_ex(1))
                with lock:
                    accepted.append(req)
            except RejectedError:
                pass
            time.sleep(0.002)

    t = threading.Thread(target=client)
    t.start()
    try:
        timer = threading.Timer(0.12, os.kill,
                                (os.getpid(), signal.SIGTERM))
        timer.start()
        assert fleet.serve_forever(poll=0.01)
    finally:
        stop.set()
        t.join()
    assert accepted
    assert all(r.done() for r in accepted)
    assert all(r.exception(0) is None for r in accepted)
    assert not fleet.alive()


# ------------------------------------------------------------ fault points --
def test_fleet_fault_points_registered():
    pts = fault.points()
    for p in ("fleet.route", "fleet.dispatch", "fleet.swap", "fleet.probe",
              "fleet.scale_up", "fleet.retire", "fleet.handoff",
              "admission.classify"):
        assert p in pts
    with pytest.raises(ValueError, match="unknown fault point"):
        fault.inject("fleet.rotue", RuntimeError)
    with pytest.raises(ValueError, match="unknown fault point"):
        fault.inject("fleet.scale_upp", RuntimeError)


@chaos
def test_route_and_dispatch_injection_points():
    fleet = make_fleet(n=2, name="FleetInj").start()
    try:
        with fault.inject("fleet.route", RuntimeError("router down")):
            with pytest.raises(RuntimeError, match="router down"):
                fleet.submit(_ex(0))
        with fault.inject("fleet.dispatch", RuntimeError("dispatch blew")):
            with pytest.raises(RuntimeError, match="dispatch blew"):
                fleet.submit(_ex(0))
        fleet(_ex(1))                           # fleet healthy afterwards
        st = fleet.stats
        assert st["completed"] + st["failed"] + st["expired"] \
            == st["admitted"]
    finally:
        assert fleet.drain(timeout=30)


@chaos
def test_refused_redispatch_waits_are_failover_spans():
    """A failed-over request whose redispatch every replica refuses for
    a while (``fleet.dispatch`` refusals, about ten router passes): each
    wait between the router's passes is a ``failover`` span, so the
    request's tree accounts for its time (``audit_spans``).  The JAX
    package closes the failover span at the first refused pass and
    leaves the later waits unattributed (ROADMAP C15)."""
    from mxnet_tpu_torch import telemetry

    fleet = make_fleet(n=2, name="FleetRefused").start()
    telemetry.enable(sample=1.0, collect=True)
    try:
        with fault.inject("serving.step", RuntimeError("step fault"),
                          times=1), \
                fault.inject("fleet.dispatch", RejectedError("full"),
                             after_n=1, times=20) as refused:
            req = fleet.submit(_ex(3))
            np.testing.assert_allclose(req.result(30), _ex(3))
        assert refused.fired == 20
        (tr,) = telemetry.finished_traces(clear=True)
        assert telemetry.audit_spans(tr) == []
        names = [sp.name for sp in tr.spans]
        assert names.count("failover") > 2, names
    finally:
        telemetry.disable()
        assert fleet.drain(timeout=30)


@chaos
def test_swap_and_probe_injection_points():
    fleet = make_fleet(n=2, name="FleetInj2").start()
    try:
        updater = WeightUpdater(fleet)
        with fault.inject("fleet.swap", RuntimeError("swap fault"),
                          times=1):
            with pytest.raises(UpdateRolledBackError, match="swap fault"):
                updater.update([2.0 * W0])
        for rep in fleet.replicas:              # nothing swapped anywhere
            assert rep.apply.params[0] is W0
        with fault.inject("fleet.probe", RuntimeError("probe fault"),
                          times=1):
            with pytest.raises(UpdateRolledBackError):
                updater.update([2.0 * W0])
        assert fleet.healthz()["ready_replicas"] == 2    # fully recovered
        for rep in fleet.replicas:
            assert rep.apply.params[0] is W0
        np.testing.assert_allclose(fleet(_ex(1)), _ex(1))
    finally:
        assert fleet.drain(timeout=30)


# --------------------------------------------- healthz router-facing fields --
def test_healthz_exposes_router_ranking_fields():
    """The healthz contract: breaker_state / in_flight /
    last_error, rankable without private state, non-blocking."""
    fn = make_fn()
    apply = FlakyApply(fn, [W0], delay=0.05)
    srv = serving.InferenceServer(apply, buckets=(1, 2, 4), max_delay=0.002,
                                  sample=np.ones((4,), np.float32),
                                  name="HzServer")
    srv.start()
    try:
        h = srv.healthz()
        assert h["breaker_state"] == 0 and h["breaker"] == "closed"
        assert h["in_flight"] == 0
        assert h["last_error"] is None
        reqs = [srv.submit(_ex(i)) for i in range(3)]
        assert srv.healthz()["in_flight"] >= 1        # work actually queued
        for r in reqs:
            r.result(20)
        assert srv.healthz()["in_flight"] == 0
        with fault.inject("serving.step", RuntimeError("blip"), times=1):
            with pytest.raises(RuntimeError):
                srv(_ex(0))
        h = srv.healthz()
        assert h["last_error"]["type"] == "RuntimeError"
        assert 0 <= h["last_error"]["age"] < 60
    finally:
        srv.drain()


# the router-rankable key set: EVERY server kind a fleet can hold must
# serve these from healthz() so routers rank LLM and classifier replicas
# uniformly ("classes" is the per-class SLO snapshot)
_RANKING_KEYS = {"alive", "ready", "draining", "breaker", "breaker_state",
                 "queue_depth", "in_flight", "classes", "last_error"}


@slo
@pytest.mark.generate
def test_generation_server_healthz_matches_inference_server_contract():
    """The uniform-ranking contract: ``GenerationServer``
    serves the same healthz keys (per-class deadline-miss + p50/p99
    included) as ``InferenceServer``, non-blocking, so one fleet router
    ranks both replica kinds with one code path."""
    from mxnet_tpu_torch.gluon.model_zoo.causal_lm import (CausalLMConfig,
                                                           init_causal_lm)
    from mxnet_tpu_torch.serving import BucketSpec, GenerationServer
    fn = make_fn()
    srv = serving.InferenceServer(FlakyApply(fn, [W0]), buckets=(1, 2),
                                  sample=np.ones((4,), np.float32),
                                  max_delay=0.002, name="HzUniInf").start()
    cfg = CausalLMConfig(vocab_size=32, n_layers=1, n_heads=2, head_dim=4,
                         d_ff=16)
    gen = GenerationServer(init_causal_lm(cfg, device="cpu"), cfg,
                           device="cpu",
                           buckets=BucketSpec(batch=(1,), length=(8,)),
                           n_slots=2, n_pages=9, page_size=4,
                           max_new_tokens=3, name="HzUniGen").start()
    try:
        srv(_ex(1))
        gen(np.arange(4, dtype=np.int32))
        hs, hg = srv.healthz(), gen.healthz()
        assert _RANKING_KEYS <= set(hs) and _RANKING_KEYS <= set(hg)
        for h in (hs, hg):
            # a QoS-less server still reports a "default" class row with
            # the full SLO stat schema — routers never special-case
            assert set(h["classes"]) == {"default"}
            row = h["classes"]["default"]
            assert {"deadline_miss", "p50_ms", "p99_ms", "completed",
                    "throttled", "shed", "priority",
                    "deadline"} <= set(row)
            assert row["completed"] >= 1
            assert row["p99_ms"] is not None and row["p99_ms"] >= 0
        # the snapshot is non-blocking even with work in flight
        req = gen.submit(np.arange(4, dtype=np.int32))
        t0 = time.monotonic()
        gen.healthz()
        assert time.monotonic() - t0 < 0.5
        req.result(30)
    finally:
        srv.drain()
        gen.drain(timeout=30)


def test_backoff_delay_attempt_cap():
    """The quarantine-schedule satellite: unbounded attempt counts must
    saturate at max_delay, never overflow the exponent."""
    assert fault.backoff_delay(10_000, base_delay=0.1, max_delay=1.0,
                               jitter=0.0) == 1.0
    # below the cap the capped form is bit-identical to the original
    assert fault.backoff_delay(3, base_delay=0.1, jitter=0.0) == \
        fault.backoff_delay(3, base_delay=0.1, jitter=0.0, attempt_cap=32)


def test_fleet_counters_and_counters_clear():
    fleet = make_fleet(n=2, name="FleetCtr").start()
    try:
        fleet(_ex(1))
        series = profiler.counters("FleetCtr::")
        assert {"FleetCtr::ready_replicas", "FleetCtr::quarantined",
                "FleetCtr::redispatched", "FleetCtr::outstanding",
                "FleetCtr::swaps", "FleetCtr::rollbacks"} <= set(series)
    finally:
        assert fleet.drain(timeout=30)
    profiler.counters_clear("FleetCtr::")
    assert profiler.counters("FleetCtr::") == {}
    assert profiler.counter_value("FleetCtr::swaps") is None


def test_wait_for_new_polling_contract(tmp_path):
    """wait_for_new sees only committed snapshots, honors last_seen, and
    times out to None instead of blocking forever."""
    d = str(tmp_path / "ckpts")
    assert wait_for_new(d, timeout=0.05) is None
    _write_snapshot(d, 3, [W0], ["w"])
    # a .tmp orphan next to it must be invisible
    with open(os.path.join(d, "ckpt-00000009.npz.tmp"), "wb") as f:
        f.write(b"mid-write garbage")
    assert wait_for_new(d, timeout=0.5) == (3, os.path.join(
        d, "ckpt-00000003.npz"))
    assert wait_for_new(d, last_seen=3, timeout=0.05) is None

    def commit_later():
        time.sleep(0.15)
        _write_snapshot(d, 5, [W0], ["w"])

    t = threading.Thread(target=commit_later)
    t.start()
    try:
        got = wait_for_new(d, last_seen=3, timeout=10, poll=0.02)
    finally:
        t.join()
    assert got is not None and got[0] == 5


# ======================================================= SLO-aware serving --
@slo
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_retire_add_cycle_under_traffic_leaks_nothing():
    """The elastic-membership satellite: a retire→add cycle under live
    traffic leaks neither counter series (the retired member's
    ``<fleet>-r<i>::`` gauges are cleared) nor healthz rows (membership
    is live, not process-lifetime) — and drops zero accepted requests."""
    fleet = make_fleet(n=3, delays=[0.002] * 3, name="FleetCycle").start()
    accepted, stop = [], threading.Event()
    lock = threading.Lock()

    def client():
        while not stop.is_set():
            try:
                r = fleet.submit(_ex(1))
                with lock:
                    accepted.append(r)
            except RejectedError:
                pass
            time.sleep(0.002)

    threads = [threading.Thread(target=client) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.05)
        assert profiler.counters("FleetCycle-r1::")        # series exist
        gone = fleet.retire_replica(1, timeout=30)
        assert gone.index == 1
        h = fleet.healthz()
        assert "r1" not in h["replicas"]                   # row dropped
        assert profiler.counters("FleetCycle-r1::") == {}  # series cleared
        new = fleet.add_replica()              # clones a HotSwapApply peer
        assert new.index == 3                  # indices are forever, no reuse
        assert f"r{new.index}" in fleet.healthz()["replicas"]
        # the cycle's books: one retire, one scale-up, traffic still flows
        time.sleep(0.1)
    finally:
        stop.set()
        for t in threads:
            t.join()
        drained = fleet.drain(timeout=60)
    assert drained
    assert accepted and all(r.done() for r in accepted)
    assert [r for r in accepted if r.exception(0) is not None] == []
    st = fleet.stats
    assert st["retired"] == 1 and st["scale_ups"] == 1
    # no counter series outside current membership (r1 retired, r3 added)
    live = {f"FleetCycle-r{rep.index}" for rep in fleet.replicas}
    leaked = [s for s in profiler.counters("FleetCycle-r")
              if s.split("::")[0] not in live]
    assert leaked == []


@slo
@chaos
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_failover_survives_retire_and_warming_add_mid_redispatch():
    """The mid-failover membership satellite: a request whose replica
    died is re-dispatched while (a) that excluded replica is being
    RETIRED and (b) a new replica is still WARMING — it must resolve on
    the survivor within its original deadline, and the warming replica
    must be invisible to routing until its census completes."""
    fn = make_fn()
    fleet = make_fleet(n=2, fn=fn, delays=[0.05, 0.002],
                       name="FleetMidFail").start()
    gate = threading.Event()

    class GatedApply(FlakyApply):
        def __call__(self, *leaves):
            gate.wait(30)                     # warmup blocks until released
            return super().__call__(*leaves)

    try:
        # r0 (slow) accepts the request, then dies with it in flight
        req = fleet.submit(_ex(5), deadline=20.0)
        fleet.apply_fns[0].dead = True
        # concurrently: retire the excluded replica + a gated scale-up
        errs = []

        def retire():
            try:
                fleet.retire_replica(0, timeout=30)
            except Exception as exc:          # noqa: BLE001
                errs.append(exc)

        adder = threading.Thread(
            target=lambda: fleet.add_replica(GatedApply(fn, [W0])))
        retirer = threading.Thread(target=retire)
        retirer.start()
        adder.start()
        # the failover must resolve on r1 while r2 is still warming
        np.testing.assert_allclose(req.result(20), _ex(5))
        assert "r2" not in fleet.healthz()["replicas"]   # not a member yet
        gate.set()
        adder.join(30)
        retirer.join(30)
        assert errs == []
        h = fleet.healthz()["replicas"]
        assert "r0" not in h and "r2" in h    # retired gone, warmed joined
        np.testing.assert_allclose(fleet(_ex(2)), _ex(2))
    finally:
        gate.set()
        assert fleet.drain(timeout=60)


@slo
def test_scale_up_refuses_census_incomplete_replica():
    """The warmup gate: a replica whose warmup did not cover the bucket
    grid never joins the routing set (it could recompile under traffic);
    the failed scale-up leaves membership untouched."""
    fleet = make_fleet(n=1, name="FleetGate").start()
    try:
        before = [rep.index for rep in fleet.replicas]
        with pytest.raises(RuntimeError, match="census-incomplete"):
            fleet.add_replica(FlakyApply(fleet.fn, [W0]), warmup=False)
        assert [rep.index for rep in fleet.replicas] == before
        assert fleet.stats["scale_ups"] == 0
        np.testing.assert_allclose(fleet(_ex(1)), _ex(1))
    finally:
        assert fleet.drain(timeout=30)


@slo
def test_retire_last_live_replica_refused():
    fleet = make_fleet(n=2, name="FleetLast").start()
    try:
        fleet.retire_replica(0, timeout=30)
        with pytest.raises(ValueError, match="last live replica"):
            fleet.retire_replica(1)
        np.testing.assert_allclose(fleet(_ex(1)), _ex(1))  # still serving
    finally:
        assert fleet.drain(timeout=30)


@slo
@chaos
def test_scale_and_retire_fault_points_injectable():
    fleet = make_fleet(n=2, name="FleetScaleInj").start()
    try:
        with fault.inject("fleet.scale_up", RuntimeError("no capacity")):
            with pytest.raises(RuntimeError, match="no capacity"):
                fleet.add_replica()
        with fault.inject("fleet.retire", RuntimeError("retire blocked")):
            with pytest.raises(RuntimeError, match="retire blocked"):
                fleet.retire_replica(0)
        assert len(fleet.replicas) == 2        # membership untouched
        np.testing.assert_allclose(fleet(_ex(1)), _ex(1))
    finally:
        assert fleet.drain(timeout=30)


# ------------------------------------------------------------- QoS routing --
@slo
def test_tenant_isolation_abuser_sheds_alone():
    qos = TenantQoS(classes=[QoSClass("gold", priority=10),
                             QoSClass("bronze", priority=0)],
                    default_class="bronze", tenant_rate=1.0, tenant_burst=3)
    fleet = make_fleet(n=2, qos=qos, name="FleetQoS").start()
    try:
        for _ in range(3):                     # burn the abuser's burst
            fleet.submit(_ex(1), tenant="abuser")
        with pytest.raises(TenantThrottledError):
            fleet.submit(_ex(1), tenant="abuser")
        # the well-behaved neighbour never notices
        np.testing.assert_allclose(fleet(_ex(2), tenant="nice"), _ex(2))
        classes = fleet.healthz()["classes"]
        assert set(classes) == {"gold", "bronze"}
        assert classes["bronze"]["throttled"] >= 1
        with pytest.raises(RejectedError, match="unknown priority class"):
            fleet.submit(_ex(1), klass="platinum")
    finally:
        assert fleet.drain(timeout=30)


@slo
def test_admit_frac_reserves_headroom_for_higher_classes():
    """A low class at its admit_frac share sheds; the high class still
    admits into the reserved headroom."""
    qos = TenantQoS(classes=[QoSClass("gold", priority=10),
                             QoSClass("bronze", priority=0,
                                      admit_frac=0.5)],
                    default_class="bronze")
    fleet = make_fleet(n=1, delays=[0.2], qos=qos, max_inflight=4,
                       name="FleetHeadroom").start()
    try:
        slow = [fleet.submit(_ex(1), klass="bronze") for _ in range(2)]
        # bronze is now AT its 0.5 * 4 share: the next bronze sheds ...
        with pytest.raises(RejectedError, match="admit_frac"):
            fleet.submit(_ex(1), klass="bronze")
        # ... while gold admits into the reserved headroom
        gold = fleet.submit(_ex(3), klass="gold")
        np.testing.assert_allclose(gold.result(30), _ex(3))
        for r in slow:
            r.result(30)
        snap = fleet.healthz()["classes"]
        assert snap["bronze"]["shed"] >= 1
        assert snap["gold"]["completed"] >= 1
    finally:
        assert fleet.drain(timeout=60)


@slo
def test_unknown_group_refusal_refunds_tenant_token():
    """A post-classify unknown-group refusal gives the tenant its token
    back and moves the class admission to shed — repeated typo'd
    submits must not starve the tenant's legitimate traffic or leave
    the class books claiming admissions that never ran."""
    qos = TenantQoS(classes=[QoSClass("gold", priority=10)],
                    default_class="gold", tenant_rate=1.0, tenant_burst=2)
    fleet = make_fleet(n=1, qos=qos, name="FleetRefund").start()
    try:
        for _ in range(4):          # > burst: only refunds keep flowing
            with pytest.raises(RejectedError,
                               match="unknown replica group"):
                fleet.submit(_ex(0), tenant="t0", group="typo")
        np.testing.assert_allclose(fleet(_ex(1), tenant="t0"), _ex(1))
        snap = fleet.healthz()["classes"]["gold"]
        assert snap["shed"] >= 4
        assert snap["admitted"] == 1      # refunds un-booked the typos
    finally:
        assert fleet.drain(timeout=30)


@slo
def test_qos_class_pins_replica_group():
    """``QoSClass(group=...)`` confines a class's routing (and failover)
    to its group; an explicit unknown group refuses."""
    fn = make_fn()
    a, b = FlakyApply(fn, [W0]), FlakyApply(fn, [W0])
    qos = TenantQoS(classes=[QoSClass("gold", priority=10, group="alpha"),
                             QoSClass("bronze", priority=0, group="beta")],
                    default_class="bronze")
    fleet = ServingFleet({"alpha": [a], "beta": [b]}, buckets=(1, 2, 4),
                         max_delay=0.002, qos=qos,
                         sample=np.ones((4,), np.float32),
                         name="FleetGroups").start()
    try:
        for i in range(4):
            fleet(_ex(i), klass="gold")
        done = _replica_completed(fleet)
        # group census rollups + strict routing containment (r0=alpha,
        # r1=beta; the probe/warmup path never counts as completed)
        assert done["r0"] >= 4 and done["r1"] == 0
        g = fleet.healthz()["groups"]
        assert set(g) == {"alpha", "beta"}
        assert g["alpha"]["replicas"] == ["r0"]
        assert g["alpha"]["ready_replicas"] == 1
        with pytest.raises(RejectedError, match="unknown replica group"):
            fleet.submit(_ex(0), group="gamma")
        with pytest.raises(ValueError, match="pins group"):
            ServingFleet({"alpha": [FlakyApply(fn, [W0])]},
                         qos=TenantQoS(classes=[QoSClass("g", group="zz")]),
                         sample=np.ones((4,), np.float32))
    finally:
        assert fleet.drain(timeout=30)


# -------------------------------------------------------------- autoscaler --
def _signals(replicas=1, ready=None, occupancy=0.0, queue_depth=0,
             deadline_miss=0):
    ready = replicas if ready is None else ready
    return {"replicas": replicas, "ready": ready, "outstanding": 0,
            "occupancy": occupancy, "queue_depth": queue_depth,
            "deadline_miss": deadline_miss}


@slo
def test_scaling_policy_hysteresis_bounds_and_cooldown():
    pol = ScalingPolicy(min_replicas=1, max_replicas=2, up_occupancy=0.5,
                        down_occupancy=0.1, up_queue_depth=4, up_ticks=2,
                        down_ticks=2, cooldown=60.0)
    hot = _signals(replicas=1, occupancy=0.9)
    assert pol.verdict(hot) is None            # streak 1 of 2
    assert pol.verdict(hot) == "up"            # sustained pressure
    assert pol.verdict(_signals(replicas=2, occupancy=0.9)) is None \
        and pol.verdict(_signals(replicas=2, occupancy=0.9)) is None \
        # at max_replicas: never "up"
    calm = _signals(replicas=2, occupancy=0.0)
    pol2 = ScalingPolicy(min_replicas=1, max_replicas=2, down_ticks=2,
                         cooldown=0.0)
    assert pol2.verdict(calm) is None
    assert pol2.verdict(calm) == "down"
    # min bound: one ready replica must stay
    assert pol2.verdict(_signals(replicas=1, occupancy=0.0)) is None
    # deadwood (dead/quarantined member) retires even at ready == min
    pol3 = ScalingPolicy(min_replicas=1, max_replicas=4, down_ticks=1,
                         cooldown=0.0)
    assert pol3.verdict(_signals(replicas=2, ready=1,
                                 occupancy=0.0)) == "down"
    # a queue spike alone triggers pressure
    pol4 = ScalingPolicy(max_replicas=4, up_queue_depth=4, up_ticks=1,
                         cooldown=0.0)
    assert pol4.verdict(_signals(replicas=1, queue_depth=9)) == "up"
    # a deadline-miss burst alone triggers pressure (diffed per tick)
    pol5 = ScalingPolicy(max_replicas=4, up_queue_depth=None,
                         miss_budget=0, up_ticks=1, cooldown=0.0)
    assert pol5.verdict(_signals(replicas=1, deadline_miss=5)) is None
    assert pol5.verdict(_signals(replicas=1, deadline_miss=9)) == "up"
    # cooldown gags verdicts right after an action
    pol6 = ScalingPolicy(max_replicas=4, up_ticks=1, cooldown=60.0)
    pol6.record_action()
    assert pol6.verdict(_signals(replicas=1, occupancy=0.9)) is None
    with pytest.raises(ValueError, match="min_replicas"):
        ScalingPolicy(min_replicas=3, max_replicas=2)


@slo
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_autoscaler_full_cycle_with_event_log(tmp_path):
    """End-to-end supervised autoscaling: a storm scales the group up,
    calm scales it back down, and both verdicts land in the JSONL event
    log — membership safety (census-complete joins, drained retires) is
    the fleet's contract; the scaler only decides WHEN."""
    log_path = str(tmp_path / "scale.jsonl")
    fleet = make_fleet(n=1, delays=[0.004], max_inflight=8,
                       name="FleetAuto").start()
    scaler = FleetAutoscaler(
        fleet, ScalingPolicy(min_replicas=1, max_replicas=2,
                             up_occupancy=0.25, down_occupancy=0.1,
                             up_queue_depth=3, up_ticks=2, down_ticks=8,
                             cooldown=0.05),
        tick=0.01, watchdog_secs=60, event_log=log_path).start()
    stop = threading.Event()
    accepted, lock = [], threading.Lock()

    def client():
        while not stop.is_set():
            try:
                r = fleet.submit(_ex(1))
                with lock:
                    accepted.append(r)
            except RejectedError:
                pass
            time.sleep(0.001)

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        t0 = time.time()
        while scaler.stats["scale_ups"] < 1 and time.time() - t0 < 30:
            time.sleep(0.02)
    finally:
        stop.set()
        for t in threads:
            t.join()
    t0 = time.time()
    while scaler.stats["scale_downs"] < 1 and time.time() - t0 < 30:
        time.sleep(0.02)
    assert scaler.stop(timeout=10)
    st = scaler.stats
    assert st["scale_ups"] >= 1 and st["scale_downs"] >= 1
    assert fleet.drain(timeout=60)
    assert accepted and all(r.done() for r in accepted)
    with open(log_path) as f:
        events = [json.loads(line) for line in f]
    kinds = [e["event"] for e in events]
    assert "scale-up" in kinds and "scale-down" in kinds \
        and kinds[-1] == "stop"
    up = events[kinds.index("scale-up")]
    assert up["group"] == "default" and "signals" in up


@slo
@chaos
def test_autoscaler_failed_action_is_logged_and_backed_off():
    fleet = make_fleet(n=1, delays=[0.01], max_inflight=4,
                       name="FleetAutoFail").start()
    scaler = FleetAutoscaler(
        fleet, ScalingPolicy(min_replicas=1, max_replicas=2,
                             up_occupancy=0.2, up_queue_depth=2,
                             up_ticks=1, cooldown=0.0),
        tick=0.01, backoff_base=0.05, backoff_max=0.2).start()
    # the one replica is held until the scaler has ticked on its queue:
    # requests that drain before a tick make no pressure to scale on
    gate = fleet.apply_fns[0].gate = threading.Event()
    try:
        with fault.inject("fleet.scale_up", RuntimeError("capacity API "
                                                         "down")):
            reqs = []
            for _ in range(6):
                try:
                    reqs.append(fleet.submit(_ex(1)))
                except RejectedError:
                    pass                      # at the cap — pressure made
            t0 = time.time()
            while scaler.stats["failures"] < 1 and time.time() - t0 < 30:
                time.sleep(0.02)
            assert scaler.stats["failures"] >= 1
            assert len(fleet.replicas) == 1       # nothing half-added
            gate.set()
            for r in reqs:
                r.result(30)
        assert any(e["event"] == "scale-failed"
                   for e in scaler.log.records)
    finally:
        gate.set()
        scaler.stop(timeout=10)
        assert fleet.drain(timeout=60)


# ============================================== parity with the JAX package --
def _validate_cases():
    """(name, new snapshot, served params as numpy) — numpy snapshots a
    fleet may be offered, each with the served params it is held to."""
    rng = np.random.RandomState(0)
    w = rng.randn(4, 4).astype(np.float32)
    b = np.zeros(4, np.float32)
    nan = w.copy()
    nan[1, 2] = np.nan
    inf = w.copy()
    inf[0, 0] = -np.inf
    ints = np.arange(4, dtype=np.int32)
    return [
        ("same", [w * 2, b], [w, b]),
        ("shape", [np.zeros((5, 4), np.float32), b], [w, b]),
        ("dtype", [w.astype(np.float64), b], [w, b]),
        ("count", [w], [w, b]),
        ("nan", [nan, b], [w, b]),
        ("inf", [inf, b], [w, b]),
        ("int leaf", [w, ints + 1], [w, ints]),
        ("int dtype", [w, ints.astype(np.int64)], [w, ints]),
        ("dict", {"w": w, "b": b}, {"w": w, "b": b}),
        ("dict key", {"w": w, "c": b}, {"w": w, "b": b}),
        ("dict vs list", {"w": w, "b": b}, [w, b]),
    ]


def _verdict(fn, new, current):
    try:
        fn(new, current)
    except Exception as exc:          # noqa: BLE001 — compared below
        return type(exc).__name__, str(exc).split(" — ")[0].split()[0:3]
    return "ok"


@pytest.mark.parametrize("case", [c[0] for c in _validate_cases()])
def test_validate_params_verdicts_match_jax(case):
    """The same numpy snapshot gets the JAX function's verdict when the
    port serves torch tensors (on the CPU here)."""
    _, new, cur_np = next(c for c in _validate_cases() if c[0] == case)
    as_torch = {k: torch.from_numpy(v) for k, v in cur_np.items()} \
        if isinstance(cur_np, dict) else [torch.from_numpy(v)
                                          for v in cur_np]
    want = _verdict(jmx.serving.validate_params, new, cur_np)
    assert _verdict(serving.validate_params, new, as_torch) == want
    assert _verdict(serving.validate_params, new, cur_np) == want


def test_validate_params_reads_v2_leaves_as_bfloat16():
    """A snapshot's two-byte ``V2`` leaf is bfloat16 to the gate: it
    matches a bfloat16 served tensor, and a non-finite one is refused."""
    served = [torch.randn(3, 2).to(torch.bfloat16)]
    raw = served[0].view(torch.int16).numpy().view("V2")
    assert serving.validate_params([raw], served)[0] is raw
    bad = served[0].clone()
    bad[1, 1] = float("nan")
    with pytest.raises(SnapshotRejectedError, match="non-finite"):
        serving.validate_params([bad.view(torch.int16).numpy()
                                 .view("V2")], served)
    with pytest.raises(SnapshotRejectedError, match="dtype"):
        serving.validate_params([raw], [served[0].float()])


def test_scaling_policy_verdicts_match_jax():
    """One fixed sequence of signals through both packages' policies
    (no cooldown: verdicts depend on the signals alone)."""
    seq = ([_signals(replicas=1, occupancy=0.9)] * 3
           + [_signals(replicas=2, queue_depth=9)] * 2
           + [_signals(replicas=2, deadline_miss=m) for m in (0, 3, 3)]
           + [_signals(replicas=3, occupancy=0.0)] * 6
           + [_signals(replicas=3, ready=2, occupancy=0.1)] * 3
           + [_signals(replicas=4, occupancy=0.8)] * 3)
    kw = dict(min_replicas=1, max_replicas=4, up_occupancy=0.75,
              down_occupancy=0.2, up_queue_depth=8, miss_budget=1,
              up_ticks=2, down_ticks=3, cooldown=0.0)
    jpol = jmx.serving.ScalingPolicy(**kw)
    tpol = ScalingPolicy(**kw)
    got = [tpol.verdict(dict(s)) for s in seq]
    want = [jpol.verdict(dict(s)) for s in seq]
    assert got == want
    assert {"up", "down", None} <= set(got)


def test_jax_snapshot_rolls_into_a_port_fleet(tmp_path):
    """A bfloat16 Dense trained one step by the JAX package's TrainStep
    and written by its ``save_train_step``: the port's updater watching
    the directory rolls it into a fleet serving bfloat16 tensors, and
    every replica then holds the snapshot's bits."""
    import jax
    from mxnet_tpu import gluon as jgluon, parallel as jparallel
    from mxnet_tpu.parallel import checkpoint as jck
    from mxnet_tpu_torch.parallel.checkpoint import load_snapshot_params

    net = jgluon.nn.Dense(4, in_units=6)
    net.initialize()
    net.cast("bfloat16")
    step = jparallel.TrainStep(
        net, jgluon.loss.L2Loss(),
        jmx.optimizer.create("sgd", learning_rate=0.1),
        mesh=jparallel.make_mesh(dp=1, devices=jax.devices()[:1]))
    x = np.random.RandomState(0).randn(8, 6).astype(np.float32)
    step(jmx.nd.array(x).astype("bfloat16"),
         jmx.nd.zeros((8, 4)).astype("bfloat16"))
    served = [torch.zeros(4, dtype=torch.bfloat16),
              torch.zeros(4, 6, dtype=torch.bfloat16)]

    def fwd(p, v):
        v = torch.as_tensor(v).to(torch.bfloat16)
        return (v @ p[1].t() + p[0]).float()

    fleet = ServingFleet.replicated(graphs.captured(fwd), served, 2,
                                    buckets=(1, 2),
                                    sample=np.ones((6,), np.float32),
                                    max_delay=0.002, name="FleetJaxSnap")
    with fleet:
        updater = WeightUpdater(fleet, str(tmp_path), last_seen=0)
        jck.save_train_step(step, str(tmp_path / "ckpt-00000001.npz"))
        assert updater.poll_once(timeout=5.0) == 1
        raw, got_names = load_snapshot_params(
            str(tmp_path / "ckpt-00000001.npz"))
        # natural name order (the block's own prefix depends on what the
        # process built before): the bias, then the weight
        assert [n.rsplit("_", 1)[1] for n in got_names] == ["bias",
                                                            "weight"]
        for rep in fleet.replicas:
            for leaf, r in zip(rep.apply.params, raw):
                assert leaf.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    leaf.view(torch.int16).numpy(), r.view(np.int16))
        out = fleet(x[0], timeout=10)
        want = fwd([torch.from_numpy(r.view(np.int16)).view(torch.bfloat16)
                    for r in raw], x[:1]).numpy()[0]
        np.testing.assert_array_equal(out, want)


# ------------------------------------------------------------- on the card --
@pytest.mark.gpu
def test_card_replicas_share_one_captured_function():
    """Three replicas replay one shared ``graphs.captured`` function from
    their batch threads at once: every request gets its own row, the
    graphs equal the grid's census, and a rolling update captures
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    fn = graphs.captured(lambda p, x: x @ p[0])
    w = torch.eye(4, device="cuda")
    fleet = ServingFleet.replicated(fn, [w], 3, buckets=(1, 2, 4),
                                    sample=np.ones((4,), np.float32),
                                    max_delay=0.002, name="CardShared")
    results, lock = [], threading.Lock()

    def client(k):
        for i in range(40):
            x = np.full((4,), 100.0 * k + i, np.float32)
            out = fleet(x, timeout=30)
            with lock:
                results.append((x, out))

    with fleet:
        assert fn.graph_count() == fleet.grid_census
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        WeightUpdater(fleet).update([torch.eye(4)])
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert fn.graph_count() == fleet.grid_census
    assert len(results) == 160
    for x, out in results:
        np.testing.assert_array_equal(out, x)
