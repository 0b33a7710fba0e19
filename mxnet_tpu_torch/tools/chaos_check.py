"""Chaos smoke of the port: kill-and-resume (train), inject-and-drain
(serve), replica-kill + rolling-update (fleet), the LLM server under
decode faults (llm), the supervised gang (elastic), the durable
checkpoints (ckpt), the tenant SLO storm (slo) and the tracing contract
(obs) — the counterpart of ``tools/chaos_check.py`` over
``mxnet_tpu_torch``::

    python -m mxnet_tpu_torch.tools.chaos_check [--mode train] [--steps 8]
    python -m mxnet_tpu_torch.tools.chaos_check --mode llm --device cpu

Everything runs on the card (``--device cuda``, the default); without
one it raises and runs nothing.  ``--device cpu`` runs the plain
PyTorch path on the host, as the tests do.  The modes keep the
reference tool's models, traffic and timings.

``--mode train`` (default) trains a small MLP with periodic
checkpoints, injects a crash mid-run via ``fault.inject("step")``,
rediscovers the newest snapshot with ``resume_latest``, and checks that
the resumed loss trajectory matches an uninterrupted run bit for bit.

``--mode serve`` starts an ``InferenceServer`` over a
``graphs.captured`` MLP (one CUDA graph per bucket on the card), drives
it from client threads while a ``serving.step`` failure burst fires,
then lands a SIGTERM mid-flight: the drain must resolve every ACCEPTED
request (a result or an explicit error, none silently dropped) and the
breaker must have tripped and fast-failed.

``--mode fleet``: a 3-replica ``ServingFleet`` under client traffic has
one replica hard-killed, two snapshots of a real ``TrainStep`` +
``CheckpointManager`` streamed through rolling weight updates, and a
SIGTERM drain: zero dropped accepted requests, and the shared
function's graphs (``graph_count()``) within the bucket grid's census
(``fleet.grid_census``) before and after both swaps.  A second leg
boots an int8 fleet (``amp.Int8Quantizer``, dequantization inside the
captured apply) and streams an f32 snapshot through a rolling update
under traffic, re-quantized on ingest.

``--mode llm``: a ``GenerationServer(tp_shards=2,
tp_collectives="int8")`` streams generations from client threads while
a ``generate.decode`` burst fires, then takes a SIGTERM mid-decode.
The port's tensor-parallel server is a leader and followers, one
process a rank, so this leg runs as a gang of two through
``python -m mxnet_tpu_torch.launch``; the SIGTERM goes to the leader,
whose drain stops the follower.  It lands 0.3 s after the first decode
step (the reference times it from the server's start; on the card the
gang's warm-up can outlast that).  Checked on the leader: the drain
started with accepted sequences in flight and decoded them, zero dropped
accepted sequences, ``graph_count()`` the same before and after and
equal to the census of what the server captures (``census()`` for
captured steps; 0 where the steps run eagerly, as over gloo), every
page free after the drain.  On the card this leg serves the serving
configuration (vocab 4096, 4 layers, 8 heads x 64, d_ff 2048; 64
slots, 512 pages x 64; buckets (1, 2, 4) x (32, 64)) through the
hand-written paged-decode kernel, with traffic of its own (4 clients x
48 requests of 24-64 new tokens, three times the slots, so the SIGTERM
finds the card mid-decode); on the host, the reference tool's small
model and traffic.  Then, in this process, the shared-prefix + speculative
leg and the salvage leg (a starved pool under a fault burst resumes
token for token; a journaled child process is SIGKILLed and its
sequences restored token for token).

``--mode elastic``: an ``elastic.Supervisor`` drives a 2-worker
training gang (``python -m mxnet_tpu_torch.elastic_worker``) to a
target step while the harness SIGKILLs one worker, SIGSTOPs the other
to trip the watchdog, and (fresh gang) SIGTERMs the supervisor itself:
the job reaches its step, restarts stay in budget, every restart
resumes from a strictly increasing committed step, the SIGTERM ends
with every worker preempted after its snapshot, and no worker leaks.

``--mode slo``: a mixed-tenant storm (two priority classes, per-tenant
token buckets, one abusive tenant) against a grouped ``ServingFleet``
while a replica is killed, a ``FleetAutoscaler`` runs a scale-up/down
cycle and a rolling update streams through; then a disaggregated
``GenerationServer`` (two prefill workers + handoff) under a
long-prefill + decode mix: zero drops, gold p99 below bronze p99,
tenant isolation, graphs within the census.

``--mode obs``: with request tracing armed, a fleet storm (fault burst
+ replica kill) and a generation burst must give every accepted request
a complete, correctly parented span tree (``telemetry.audit_spans``),
also through the JSONL export; a breaker trip under a decode fault storm
must leave a complete flight-recorder bundle; and the tracing-off path
must cost under 5% of a request (``telemetry.guard_cost``).

``--mode ckpt``: a subprocess snapshot storm is SIGKILLed mid-write
repeatedly (every committed name verifies), a ``BitFlipInjection``
commits a digest-poisoned snapshot (verify, load and resume treat it as
damage), and a live ``WeightUpdater`` streams snapshots under
``keep_last=1`` pruning with one corrupt snapshot: resume lands on an
intact snapshot, no corrupt byte is trained on or served, no update is
dropped.

``--list-modes`` prints the registry.  Exit code 0 on success, 1 on any
mismatch.  Each mode ends with a line ``[chaos_check] launches {...}``:
the launches of the hand-written kernels the mode made on the card (the
tensor-parallel leader's included), 0 on the host.

Not here: the reference's ``lint``, ``cost`` and ``hlo`` modes audit the
JAX package's source and XLA's HLO (mxlint, costguard, hloguard).  The
port emits no HLO; an audit of its own source and captured graphs needs
a design of its own (ROADMAP A18).
"""
import argparse
import atexit
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the reference tool's LLM model for every generation leg on the host,
# and for the speculative, salvage, slo and obs legs on the card too
SMALL_LM = dict(vocab_size=64, n_layers=2, n_heads=2, head_dim=8, d_ff=32)
# ``requests``: per client thread (None: ``--requests``); ``new_tokens``:
# each request's max_new_tokens is drawn from [lo, hi)
SMALL_TP = dict(config=SMALL_LM, batch=(1, 2), length=(8, 16), n_slots=4,
                n_pages=33, page_size=8, requests=None, new_tokens=(1, 7))
# the serving configuration (bench.py's bench_llm, chip_smoke.py's serve
# phase): the llm mode's tensor-parallel leg on the card.  Its traffic is
# its own: at 23-42 ms a decode step the reference's 100 requests of 1-6
# tokens are all done 0.3 s after the first token, so 4 x 48 requests of
# 24-64 tokens (three times the 64 slots) keep the drain busy for a few
# seconds
SERVING_TP = dict(config=dict(vocab_size=4096, n_layers=4, n_heads=8,
                              head_dim=64, d_ff=2048),
                  batch=(1, 2, 4), length=(32, 64), n_slots=64,
                  n_pages=512, page_size=64, requests=48,
                  new_tokens=(24, 65))

def say(msg):
    print(f"[chaos_check] {msg}", flush=True)


def _device(name):
    """``torch.device`` of ``--device``: ``cuda`` raises without a card
    (the harness never goes on on the host)."""
    from ..context import resolve_device

    return resolve_device(name)


def _scratch(prefix):
    """A temporary directory of this run, removed when the process
    exits."""
    d = tempfile.mkdtemp(prefix=prefix)
    atexit.register(shutil.rmtree, d, True)
    return d


def _verdict(fails, passed):
    if fails:
        for f in fails:
            say(f"FAIL: {f}")
        return 1
    say(f"PASS: {passed}")
    return 0


def _breaker(**kw):
    from .. import serving

    kw.setdefault("base_delay", 0.02)
    kw.setdefault("max_delay", 0.1)
    return serving.CircuitBreaker(**kw)


def _expected_graphs(srv):
    """The graphs a started ``GenerationServer`` holds for good: its
    census where it captures its steps (the card), 0 where they run
    eagerly (the host, a tensor-parallel group over gloo)."""
    return srv.census() if srv._graphs is not None else 0


def _lm(config, seed, dev):
    from ..gluon.model_zoo.causal_lm import CausalLMConfig, init_causal_lm
    import torch

    cfg = CausalLMConfig(**config)
    return cfg, init_causal_lm(cfg, torch.Generator().manual_seed(seed),
                               device=dev)


def _join(threads):
    for t in threads:
        t.join()


def _tally(accepted):
    """(resolved, ok, errored) of accepted requests."""
    resolved = sum(1 for r in accepted if r.done())
    oks = sum(1 for r in accepted
              if r.done() and r.exception(timeout=0) is None)
    return resolved, oks, resolved - oks


# ------------------------------------------------------------------ train --
def dense_net(seed, dev):
    """The reference's MLP (8 -> 16 relu -> 4), seeded."""
    import mxnet_tpu_torch as mx
    from ..gluon import nn

    mx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8),
            nn.Dense(4, in_units=16))
    net.initialize(ctx=dev)
    return net


def dense_step(net):
    """``TrainStep`` of ``net``: softmax cross-entropy, Adam."""
    import mxnet_tpu_torch as mx
    from .. import gluon, parallel

    return parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              mx.optimizer.create("adam"))


def train_batches(steps):
    rng = np.random.RandomState(0)
    return [(rng.randn(16, 8).astype(np.float32),
             rng.randint(0, 4, (16,))) for _ in range(steps)]


def _loss(out):
    return float(out.asnumpy() if hasattr(out, "asnumpy") else out)


def reference_run(step, batches):
    """The uninterrupted trajectory: one loss a batch."""
    return [_loss(step(x, y)) for x, y in batches]


def train_mode(args):
    """Kill-and-resume: the resumed losses bit-exact to the reference."""
    from .. import fault
    from ..parallel.checkpoint import CheckpointManager, resume_latest

    dev = _device(args.device)
    crash_after = (args.crash_after if args.crash_after is not None
                   else args.steps // 2 + 1)
    batches = train_batches(args.steps)
    say(f"reference run: {args.steps} steps on {dev}")
    ref = reference_run(dense_step(dense_net(7, dev)), batches)

    d = _scratch(prefix="chaos_check_")
    say(f"victim run: checkpoints every {args.every} steps to {d}, crash "
        f"injected on step {crash_after}")
    victim = dense_step(dense_net(7, dev))
    mgr = CheckpointManager(victim, d, every_n_steps=args.every,
                            keep_last=args.keep)
    crashed = False
    with fault.inject("step", RuntimeError("injected preemption"),
                      after_n=crash_after - 1):
        try:
            for x, y in batches:
                victim(x, y)
                mgr.maybe_save()
        except RuntimeError as exc:
            crashed = True
            say(f"victim died as planned: {exc}")
    if not crashed:
        return _verdict(["injected crash never fired"], "")
    del victim, mgr

    survivor = dense_step(dense_net(99, dev))   # other init: the snapshot
    survivor(*batches[0])                       # must win; build it
    n = resume_latest(survivor, d)
    if n is None:
        return _verdict(["resume_latest found no checkpoint"], "")
    say(f"resumed from step {n}, replaying {args.steps - n} steps")
    resumed = reference_run(survivor, batches[n:])
    if resumed == ref[n:]:
        return _verdict([], f"resumed trajectory bit-exact over "
                            f"{len(resumed)} steps")
    diff = np.max(np.abs(np.array(resumed) - np.array(ref[n:])))
    say(f"  reference: {ref[n:]}")
    say(f"  resumed  : {resumed}")
    return _verdict([f"trajectories diverge (max |diff|={diff})"], "")


# ------------------------------------------------------------------ serve --
def serve_mode(args):
    """Inject-and-drain on the serving runtime."""
    import torch

    from .. import fault, graphs, serving

    dev = _device(args.device)
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(8, 4).astype(np.float32)).to(dev)
    mlp = graphs.captured(lambda p, x: x @ p[0])

    def apply(x):
        time.sleep(0.01)           # keep work in flight when SIGTERM lands
        return mlp([w], x)

    srv = serving.InferenceServer(
        apply, buckets=(1, 2, 4), max_delay=0.002, max_queue=64,
        sample=np.zeros((8,), np.float32),
        breaker=_breaker(threshold=3))
    srv.start()
    say(f"serve: warmed {len(srv.distinct_shapes)} buckets "
        f"({mlp.graph_count()} graphs), ready={srv.ready()}")

    accepted, sheds = [], [0]
    count_lock = threading.Lock()
    stop_submitting = threading.Event()

    def client(k):
        r = np.random.RandomState(k).randn(8).astype(np.float32)
        for _ in range(args.requests):
            if stop_submitting.is_set():
                return
            try:
                req = srv.submit(r)
                with count_lock:
                    accepted.append(req)
            except serving.RejectedError:
                with count_lock:
                    sheds[0] += 1
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    with fault.inject("serving.step", RuntimeError("injected step fault"),
                      after_n=5, times=4) as h:
        for t in threads:
            t.start()
        # SIGTERM lands while clients still submit and batches are in
        # flight: serve_forever must drain, not drop
        threading.Timer(0.25, os.kill, (os.getpid(), signal.SIGTERM)).start()
        drained = srv.serve_forever(poll=0.01)
    stop_submitting.set()
    _join(threads)

    resolved, oks, errs = _tally(accepted)
    say(f"serve: accepted={len(accepted)} ok={oks} errored={errs} "
        f"shed={sheds[0]} injected_fired={h.fired} "
        f"breaker_trips={srv.breaker.trips} stats={srv.stats}")
    fails = []
    if not drained:
        fails.append("drain did not complete")
    if resolved != len(accepted):
        fails.append(f"{len(accepted) - resolved} accepted requests were "
                     f"silently dropped")
    if h.fired == 0:
        fails.append("injected step faults never fired")
    if errs == 0:
        fails.append("no request surfaced the injected failure")
    if srv.alive():
        fails.append("batch thread survived the drain")
    if len(srv.distinct_shapes) > 3 or mlp.graph_count() > 3:
        fails.append(f"bucketing leaked {len(srv.distinct_shapes)} "
                     f"signatures / {mlp.graph_count()} graphs (> 3)")
    return _verdict(fails, f"drain completed with every accepted request "
                           f"resolved ({oks} served, {errs} explicitly "
                           f"errored, 0 dropped)")


# ------------------------------------------------------------------ fleet --
def _killable(fwd, params, delay):
    """A hot-swap replica apply over ``params`` that sleeps ``delay`` a
    step; setting ``.dead`` kills its batch thread (``SystemExit``)."""
    from .. import serving

    class KillableApply(serving.HotSwapApply):
        def __init__(self):
            super().__init__(fwd, params)
            self.dead = False

        def __call__(self, *leaves):
            if self.dead:
                raise SystemExit("replica killed")
            time.sleep(delay)
            return super().__call__(*leaves)
    return KillableApply()


def _mlp_indices(params):
    shapes = [tuple(p.shape) for p in params]
    return (shapes.index((16, 8)), shapes.index((16,)),
            shapes.index((4, 16)), shapes.index((4,)))


def _mlp_fn(params, traces=None):
    """The served MLP over a snapshot's leaves, ``fn(p, x)`` (torch);
    ``traces`` records each signature the body runs on."""
    import torch

    iw1, ib1, iw2, ib2 = _mlp_indices(params)

    def fwd(p, x):
        if traces is not None:
            traces.append(tuple(x.shape))
        h = torch.relu(x @ p[iw1].T + p[ib1])
        return h @ p[iw2].T + p[ib2]
    return fwd


def _on(params, dev):
    import torch

    return [torch.as_tensor(np.asarray(p)).to(dev) for p in params]


def _fleet_int8_leg(step, mgr, dev):
    """An int8 fleet ingests an f32 training snapshot through a rolling
    update under live traffic: 0 dropped, graphs within the census.
    Returns failure strings."""
    import torch

    from .. import amp, graphs, serving
    from ..parallel.checkpoint import load_snapshot_params

    params, _names = load_snapshot_params(mgr.checkpoints()[-1][1])
    fwd = _mlp_fn(params)
    quant = amp.Int8Quantizer(axis=0)      # (units, in_units) kernels
    qfn = graphs.captured(quant.wrap(fwd))
    fleet = serving.ServingFleet.replicated(
        qfn, quant.quantize(_on(params, dev)), 3,
        quantizer=quant.quantize, buckets=(1, 2, 4), max_delay=0.002,
        sample=np.ones((8,), np.float32), name="ChaosInt8Fleet")
    fleet.start()
    census = fleet.grid_census
    updater = serving.WeightUpdater(fleet, mgr, poll=0.02).start()
    n_int8 = sum(1 for p in fleet.replicas[0].apply.params
                 if p.dtype == torch.int8)
    say(f"int8 fleet: 3 replicas up, census={census}, graphs="
        f"{qfn.graph_count()}, {n_int8} int8 weight payload(s) served")

    accepted, sheds = [], [0]
    lock = threading.Lock()
    stop = threading.Event()

    def client(k):
        r = np.random.RandomState(100 + k).randn(8).astype(np.float32)
        while not stop.is_set():
            try:
                req = fleet.submit(r)
                with lock:
                    accepted.append(req)
            except serving.RejectedError:
                with lock:
                    sheds[0] += 1
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    fails = []
    try:
        time.sleep(0.1)
        # one more f32 training step -> a fresh f32 snapshot the int8
        # fleet must re-quantize on ingest
        rng = np.random.RandomState(42)
        step(rng.randn(16, 8).astype(np.float32), rng.randint(0, 4, (16,)))
        mgr.save()
        t0 = time.time()
        while updater.applied < 1 and time.time() - t0 < 30:
            time.sleep(0.01)
        if updater.applied < 1:
            fails.append(f"int8 fleet: f32 snapshot did not roll out "
                         f"within 30s (applied={updater.applied}, "
                         f"skipped={updater.skipped})")
        time.sleep(0.1)
    finally:
        stop.set()
        _join(threads)
        updater.stop(timeout=10)
        drained = fleet.drain(timeout=30)
    resolved = sum(1 for r in accepted if r.done())
    errs = [r.exception(0) for r in accepted
            if r.done() and r.exception(0) is not None]
    say(f"int8 fleet: accepted={len(accepted)} resolved={resolved} "
        f"errored={len(errs)} shed={sheds[0]} swaps={fleet.stats['swaps']} "
        f"graphs={qfn.graph_count()}")
    if not drained:
        fails.append("int8 fleet: drain did not complete")
    if resolved != len(accepted):
        fails.append(f"int8 fleet: {len(accepted) - resolved} accepted "
                     f"requests dropped")
    if errs:
        fails.append(f"int8 fleet: {len(errs)} accepted requests errored "
                     f"(first: {errs[0]!r})")
    if qfn.graph_count() > census:
        fails.append(f"int8 fleet: graph leak — {qfn.graph_count()} graphs "
                     f"> census {census}")
    if n_int8 != 2:        # both Dense kernels; biases stay f32
        fails.append(f"int8 fleet: expected 2 int8 weight payloads, "
                     f"served {n_int8}")
    # the rolled-out weights are the NEW snapshot's, re-quantized
    new_params, _ = load_snapshot_params(mgr.checkpoints()[-1][1])
    ref = quant.dequantize(quant.quantize(_on(new_params, "cpu")))
    x1 = np.ones((1, 8), np.float32)
    want = fwd([r.cpu() for r in ref], torch.from_numpy(x1)).numpy()[0]
    got = np.asarray(fleet.replicas[0].apply(x1).cpu())[0]
    if not np.allclose(got, want, atol=1e-5):
        fails.append("int8 fleet: replica 0 does not serve the "
                     "re-quantized final snapshot")
    return fails


def fleet_mode(args):
    """Replica kill + rolling updates + SIGTERM, then the int8 leg."""
    import torch

    from .. import graphs, serving
    from ..parallel.checkpoint import CheckpointManager, load_snapshot_params

    dev = _device(args.device)
    # a real training job feeding the snapshot stream
    step = dense_step(dense_net(7, dev))
    batches = train_batches(6)
    d = _scratch(prefix="chaos_fleet_")
    mgr = CheckpointManager(step, d, keep_last=5)
    for x, y in batches[:2]:
        step(x, y)
    mgr.save()
    params, _names = load_snapshot_params(mgr.checkpoints()[-1][1])
    first_seen = mgr.checkpoints()[-1][0]

    # the serving side: one shared captured forward, 3 hot-swap replicas
    traces = []
    fwd = graphs.captured(_mlp_fn(params, traces))

    # 3 ms a step keeps work in flight at kill time
    applies = [_killable(fwd, _on(params, dev), 0.003) for _ in range(3)]
    fleet = serving.ServingFleet(
        applies, buckets=(1, 2, 4), max_delay=0.002,
        sample=np.ones((8,), np.float32), name="ChaosFleet")
    fleet.start()
    census = fleet.grid_census
    warm = fwd.graph_count()
    say(f"fleet: 3 replicas warm, census={census} traced="
        f"{len(set(traces))} graphs={warm} ready={fleet.ready()}")

    updater = serving.WeightUpdater(fleet, mgr, last_seen=first_seen,
                                    poll=0.02)
    updater.start()
    accepted, sheds = [], [0]
    count_lock = threading.Lock()
    stop_submitting = threading.Event()

    def client(k):
        r = np.random.RandomState(k).randn(8).astype(np.float32)
        while not stop_submitting.is_set():
            try:
                req = fleet.submit(r)
                with count_lock:
                    accepted.append(req)
            except serving.RejectedError:
                with count_lock:
                    sheds[0] += 1
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    fails = []
    try:
        time.sleep(0.15)
        applies[1].dead = True         # hard-kill replica 1 under traffic
        time.sleep(0.15)
        for round_no in (1, 2):        # stream two snapshots through
            for x, y in batches[2 * round_no:2 * round_no + 2]:
                step(x, y)
            mgr.save()
            t0 = time.time()
            while updater.applied < round_no and time.time() - t0 < 30:
                time.sleep(0.01)
            if updater.applied < round_no:
                fails.append(f"rolling update {round_no} did not apply "
                             f"within 30s (applied={updater.applied}, "
                             f"skipped={updater.skipped})")
        # SIGTERM lands while clients are still submitting
        threading.Timer(0.1, os.kill, (os.getpid(), signal.SIGTERM)).start()
        drained = fleet.serve_forever(poll=0.01)
    finally:
        stop_submitting.set()
        _join(threads)
        updater.stop(timeout=10)

    resolved = sum(1 for r in accepted if r.done())
    errs = [r.exception(0) for r in accepted
            if r.done() and r.exception(0) is not None]
    st = fleet.stats
    say(f"fleet: accepted={len(accepted)} resolved={resolved} "
        f"errored={len(errs)} shed={sheds[0]} "
        f"redispatched={st['redispatched']} swaps={st['swaps']} "
        f"probes={st['probes']} traced={len(set(traces))} "
        f"graphs={fwd.graph_count()}")
    if not drained:
        fails.append("fleet drain did not complete")
    if resolved != len(accepted):
        fails.append(f"{len(accepted) - resolved} accepted requests were "
                     f"silently dropped")
    if errs:
        fails.append(f"{len(errs)} accepted requests errored — failover "
                     f"should have served them (first: {errs[0]!r})")
    if st["redispatched"] < 1:
        fails.append("the replica kill never exercised failover")
    if updater.applied != 2:
        fails.append(f"expected 2 applied rolling updates, got "
                     f"{updater.applied}")
    if len(set(traces)) > census or fwd.graph_count() != warm \
            or warm > census:
        fails.append(f"recompile leak: {len(set(traces))} traced / "
                     f"{fwd.graph_count()} graphs (warm {warm}) vs census "
                     f"{census}")
    if fleet.alive():
        fails.append("a replica batch thread survived the drain")
    # the survivors must serve the LAST snapshot's weights
    ones = np.ones((1, 8), np.float32)
    last = load_snapshot_params(mgr.checkpoints()[-1][1])[0]
    want = _mlp_fn(last)(_on(last, "cpu"), torch.from_numpy(ones))
    got = applies[0](ones).cpu()
    if not np.allclose(got.numpy()[0], want.numpy()[0], atol=1e-6):
        fails.append("replica 0 does not serve the final snapshot weights")
    fails += _fleet_int8_leg(step, mgr, dev)
    return _verdict(fails, f"replica kill + 2 rolling updates + SIGTERM "
                           f"with 0 dropped accepted requests, graphs "
                           f"within the census ({fwd.graph_count()}/"
                           f"{census}), {st['redispatched']} failovers; "
                           f"int8-fleet f32-snapshot rolling update clean")


# -------------------------------------------------------------------- llm --
def llm_tp_rank(outdir):
    """One rank of the llm mode's tensor-parallel leg (run by the
    launcher): every rank builds the server from ``outdir/spec.json``;
    the leader drives the chaos and checks the contract, a follower
    serves until the leader's drain stops it.  Writes
    ``outdir/rank<r>.json``."""
    from .. import distributed, graphs, serving

    with open(os.path.join(outdir, "spec.json")) as f:
        spec = json.load(f)
    r = distributed.rank()
    dev = distributed.device() if spec["device"] == "cuda" \
        else _device(spec["device"])
    leg = spec["leg"]
    cfg, params = _lm(leg["config"], 0, dev)
    srv = serving.GenerationServer(
        params, cfg, buckets=serving.BucketSpec(batch=tuple(leg["batch"]),
                                                length=tuple(leg["length"])),
        n_slots=leg["n_slots"], n_pages=leg["n_pages"],
        page_size=leg["page_size"], max_new_tokens=leg["new_tokens"][1] - 1,
        max_queue=256, seed=0,
        tp_shards=2, tp_collectives="int8", breaker=_breaker(threshold=3),
        device=dev, name="ChaosGen")
    base = graphs.launch_counts()
    srv.start()
    res = {"rank": r, "leader": srv.leader}
    if not srv.leader:
        res["drained"] = bool(srv.drain(600))
        res["alive"] = srv.alive()
        res["graphs"] = srv.graph_count()
        res["decode_steps"] = srv.stats["decode_steps"]
    else:
        res.update(_llm_tp_chaos(srv, cfg, spec["requests"],
                                 tuple(leg["new_tokens"])))
    now = graphs.launch_counts()
    res["launches"] = {k: now[k] - base[k] for k in now
                       if now[k] != base[k]}
    with open(os.path.join(outdir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    print(f"rank {r} done", flush=True)
    return 0


def _llm_tp_chaos(srv, cfg, requests, new_tokens):
    """The leader's half of the tensor-parallel leg: traffic from four
    clients, a decode-fault burst, SIGTERM 0.3 s after the first decode
    step; returns the leader's record (``fails`` among it).  The drain
    must start with accepted sequences unresolved and decode them."""
    from .. import fault, serving

    want = _expected_graphs(srv)
    warm = srv.graph_count()
    h = srv.healthz()
    say(f"llm: {srv.graph_count()} graphs after warm-up (census "
        f"{srv.census()}, {want} captured here) over tp_shards="
        f"{h['tp_shards']} ({h['tp_collectives']} decode collectives), "
        f"ready={srv.ready()}")
    accepted, sheds = [], [0]
    count_lock = threading.Lock()
    stop_submitting = threading.Event()
    vocab = cfg.vocab_size

    def client(k):
        rng = np.random.RandomState(k)
        for i in range(requests):
            if stop_submitting.is_set():
                return
            prompt = rng.randint(0, vocab, size=int(rng.randint(1, 15)))
            try:
                req = srv.submit(prompt.astype(np.int32),
                                 max_new_tokens=int(rng.randint(*new_tokens)),
                                 temperature=float(i % 2), top_k=4)
                with count_lock:
                    accepted.append(req)
            except serving.RejectedError:
                with count_lock:
                    sheds[0] += 1
            time.sleep(0.002)

    at_term = {}

    def sigterm_after_first_step():
        t0 = time.monotonic()
        while srv.stats["decode_steps"] < 1 and time.monotonic() - t0 < 300:
            time.sleep(0.005)
        time.sleep(0.3)
        with count_lock:
            at_term["in_flight"] = sum(1 for r in accepted if not r.done())
        at_term["decode_steps"] = srv.stats["decode_steps"]
        os.kill(os.getpid(), signal.SIGTERM)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    t0 = time.perf_counter()
    with fault.inject("generate.decode",
                      RuntimeError("injected decode fault"),
                      after_n=5, times=3) as hd:
        for t in threads:
            t.start()
        # SIGTERM lands while sequences are mid-decode and clients still
        # submit: serve_forever must drain, not drop
        threading.Thread(target=sigterm_after_first_step,
                         daemon=True).start()
        drained = srv.serve_forever(poll=0.01)
    stop_submitting.set()
    _join(threads)
    seconds = time.perf_counter() - t0

    resolved, oks, errs = _tally(accepted)
    st = srv.stats
    say(f"llm: accepted={len(accepted)} ok={oks} errored={errs} "
        f"shed={sheds[0]} injected_fired={hd.fired} "
        f"tokens_out={st['tokens_out']} decode_steps={st['decode_steps']} "
        f"preempted={st['preempted']} in {seconds:.2f} s; at the SIGTERM "
        f"{at_term.get('in_flight')} in flight after "
        f"{at_term.get('decode_steps')} decode steps")
    fails = []
    if not drained:
        fails.append("drain did not complete")
    if not at_term.get("in_flight"):
        fails.append(f"the drain started with no accepted sequence in "
                     f"flight ({at_term}): the SIGTERM did not land "
                     f"mid-decode")
    elif st["decode_steps"] <= at_term["decode_steps"]:
        fails.append("the drain decoded nothing of what was in flight")
    if resolved != len(accepted):
        fails.append(f"{len(accepted) - resolved} accepted sequences "
                     f"were silently dropped")
    if hd.fired == 0:
        fails.append("injected decode faults never fired")
    if errs == 0 and st["tokens_salvaged"] == 0:
        # a decode fault SALVAGES in-flight work (bounded budget):
        # visible as a budget-exhausted error or as salvaged tokens
        fails.append("injected failures neither errored nor salvaged "
                     "any sequence")
    if oks == 0:
        fails.append("no sequence was actually served")
    if srv.graph_count() != warm or warm != want:
        fails.append(f"recompile: {srv.graph_count()} graphs vs warm-up "
                     f"{warm} vs census {want}")
    if srv.alloc.free_count() != srv.alloc.allocatable:
        fails.append(f"page leak: {srv.alloc.free_count()} free of "
                     f"{srv.alloc.allocatable} after drain")
    if srv.alive():
        fails.append("decode loop survived the drain")
    return {"fails": fails, "accepted": len(accepted), "ok": oks,
            "errored": errs, "decode_steps": st["decode_steps"],
            "in_flight_at_sigterm": at_term.get("in_flight"),
            "graphs": srv.graph_count(), "census": want,
            "seconds": seconds}


def _llm_tp_leg(args, leg, timeout=600):
    """The tensor-parallel leg as a gang of two through the launcher.
    Returns failure strings; the leader's kernel launches are added to
    ``args.launches`` (the mode's launches line)."""
    outdir = _scratch(prefix="chaos_llm_tp_")
    with open(os.path.join(outdir, "spec.json"), "w") as f:
        json.dump({"device": args.device, "leg": leg,
                   "requests": leg["requests"] or args.requests}, f)
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
           "--graceful-secs", "5"]
    if args.device == "cpu":
        cmd += ["--platform", "cpu"]
    cmd += [sys.executable, "-m", "mxnet_tpu_torch.tools.chaos_check",
            "--llm-rank", outdir]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "2")     # the ranks share the cores
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    say(f"llm: the tp=2 gang exited {rc} after "
        f"{time.perf_counter() - t0:.1f} s")
    ranks = []
    for r in range(2):
        path = os.path.join(outdir, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                ranks.append(json.load(f))
    if rc != 0 or len(ranks) != 2:
        return [f"tp leg: the gang exited {rc} with {len(ranks)} of 2 "
                f"rank records"]
    lead, follow = (ranks if ranks[0]["leader"] else ranks[::-1])
    fails = list(lead["fails"])
    if not follow["drained"] or follow["alive"]:
        fails.append("tp leg: the leader's drain did not stop the "
                     "follower")
    for k, v in lead["launches"].items():
        args.launches[k] = args.launches.get(k, 0) + v
    say(f"llm: tp leader launched the paged kernel "
        f"{lead['launches'].get('paged_decode_attention', 0)} times over "
        f"{lead['decode_steps']} decode steps (+1 warm-up), follower "
        f"{follow['launches'].get('paged_decode_attention', 0)} over "
        f"{follow['decode_steps']}; leg {lead['seconds']:.2f} s from the "
        f"first request")
    # each rank's own counts, for a caller that holds them to the layers
    say("llm tp ranks " + json.dumps(
        {who: {"launches": r["launches"], "decode_steps": r["decode_steps"]}
         for who, r in (("leader", lead), ("follower", follow))}))
    return fails


def _serve_stream(srv, n, make, stop, accepted, sheds, lock):
    """A client: ``n`` submissions of ``make(i)`` (a prompt and kwargs),
    2 ms apart, until ``stop``."""
    from .. import serving

    for i in range(n):
        if stop.is_set():
            return
        prompt, kw = make(i)
        try:
            req = srv.submit(prompt, **kw)
            with lock:
                accepted.append(req)
        except serving.RejectedError:
            with lock:
                sheds[0] += 1
        time.sleep(0.002)


def _llm_spec_leg(args, dev):
    """Copy-on-write prefix sharing + speculative decoding under chaos:
    4 clients stream prompts built on ONE system prompt through a
    speculative server while a decode fault burst fires and SIGTERM
    lands mid-decode.  Returns failure strings."""
    import torch

    from .. import fault, serving
    from ..gluon.model_zoo.causal_lm import draft_config, init_causal_lm

    cfg, params = _lm(SMALL_LM, 0, dev)
    dcfg = draft_config(cfg, n_layers=1)
    draft = init_causal_lm(dcfg, torch.Generator().manual_seed(1),
                           device=dev)
    srv = serving.GenerationServer(
        params, cfg, buckets=serving.BucketSpec(batch=(1, 2), length=(16,)),
        n_slots=4, n_pages=65, page_size=4, max_new_tokens=6,
        max_queue=256, seed=0, draft=draft, draft_config=dcfg, spec_k=2,
        breaker=_breaker(threshold=3), device=dev, name="ChaosSpecGen")
    srv.start()
    want, warm = _expected_graphs(srv), srv.graph_count()
    say(f"llm spec leg: {warm} graphs (census {srv.census()}: prefill "
        f"grid + decode + verify), spec_k=2, one system prompt over 4 "
        f"clients")
    system = np.random.RandomState(7).randint(0, 64, size=8) \
        .astype(np.int32)
    accepted, sheds = [], [0]
    lock = threading.Lock()
    stop = threading.Event()

    def maker(k):
        rng = np.random.RandomState(200 + k)

        def make(i):
            tail = rng.randint(0, 64,
                               size=int(rng.randint(1, 7))).astype(np.int32)
            return np.concatenate([system, tail]), dict(
                max_new_tokens=int(rng.randint(1, 7)),
                temperature=float(i % 2), top_k=4)
        return make

    threads = [threading.Thread(target=_serve_stream, args=(
        srv, args.requests, maker(k), stop, accepted, sheds, lock))
        for k in range(4)]
    with fault.inject("generate.decode",
                      RuntimeError("injected verify fault"),
                      after_n=5, times=3) as h:
        for t in threads:
            t.start()
        threading.Timer(0.3, os.kill, (os.getpid(), signal.SIGTERM)).start()
        drained = srv.serve_forever(poll=0.01)
    stop.set()
    _join(threads)

    resolved, oks, errs = _tally(accepted)
    st = srv.stats
    recomp = srv.telemetry()["gauges"].get("recompiles_unexpected", 0)
    say(f"llm spec leg: accepted={len(accepted)} ok={oks} errored={errs} "
        f"shed={sheds[0]} injected_fired={h.fired} "
        f"verify_steps={st['verify_steps']} "
        f"spec_accepted={st['spec_accepted']}/{st['spec_proposed']} "
        f"pages_shared_mapped={st['pages_shared_mapped']} "
        f"cow_faults={st['cow_faults']}")
    fails = []
    if not drained:
        fails.append("spec leg: drain did not complete")
    if resolved != len(accepted):
        fails.append(f"spec leg: {len(accepted) - resolved} accepted "
                     f"sequences were silently dropped")
    if h.fired == 0:
        fails.append("spec leg: injected decode faults never fired")
    if errs == 0 and st["tokens_salvaged"] == 0:
        fails.append("spec leg: injected failures neither errored nor "
                     "salvaged any sequence")
    if oks == 0:
        fails.append("spec leg: no sequence was actually served")
    if st["verify_steps"] == 0:
        fails.append("spec leg: the verify step never ran")
    if st["pages_shared_mapped"] == 0:
        fails.append("spec leg: the common system prompt never shared a "
                     "page")
    if recomp != 0:
        fails.append(f"spec leg: recompiles_unexpected == {recomp}")
    if srv.graph_count() != warm or warm != want:
        fails.append(f"spec leg: {srv.graph_count()} graphs vs warm-up "
                     f"{warm} vs census {want}")
    if srv.alloc.free_count() != srv.alloc.allocatable:
        fails.append(f"spec leg: page leak — {srv.alloc.free_count()} "
                     f"free of {srv.alloc.allocatable} after drain")
    if srv.alive():
        fails.append("spec leg: decode loop survived the drain")
    return fails


SALVAGE_PROMPTS = ([3, 1, 2], [5, 4], [9, 2, 7], [1, 6])
SALVAGE_KINDS = (dict(), dict(temperature=0.9, top_k=6),
                 dict(), dict(temperature=0.7, top_k=4))
SALVAGE_SEEDS = (11, 22, 33, 44)


def salvage_oracle(params, cfg, dev):
    """The salvage leg's unfaulted oracle: a calm pool, the leg's
    prompts with explicit seeds (greedy where no temperature is given);
    each request's tokens."""
    from .. import serving

    oracle = serving.GenerationServer(
        params, cfg, buckets=serving.BucketSpec(batch=(1,), length=(8,)),
        n_slots=2, n_pages=33, page_size=4, max_new_tokens=10, seed=0,
        device=dev, name="ChaosSalvOracle")
    oracle.start()
    try:
        return [tuple(int(t) for t in oracle.submit(
            np.asarray(p, np.int32), seed=s, **kw).result(120))
            for p, kw, s in zip(SALVAGE_PROMPTS, SALVAGE_KINDS,
                                SALVAGE_SEEDS)]
    finally:
        oracle.drain(30)


_JOURNAL_CHILD = r"""
import sys, time
import numpy as np
import torch
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.context import resolve_device
from mxnet_tpu_torch.gluon.model_zoo.causal_lm import (CausalLMConfig,
                                                       init_causal_lm)
dev = resolve_device(sys.argv[2])
cfg = CausalLMConfig(**%r)
srv = serving.GenerationServer(
    init_causal_lm(cfg, torch.Generator().manual_seed(0), device=dev), cfg,
    buckets=serving.BucketSpec(batch=(1,), length=(8,)),
    n_slots=2, n_pages=33, page_size=4, max_new_tokens=32, seed=0,
    journal=sys.argv[1], journal_every=1, device=dev,
    name="ChaosJournalGen")
srv.start()
srv.submit(np.asarray([3, 1, 2], np.int32), seed=11)
srv.submit(np.asarray([5, 4], np.int32), temperature=0.9, top_k=6, seed=22)
limit = time.monotonic() + 120
while srv.stats["tokens_out"] < 2 and time.monotonic() < limit:
    time.sleep(0.002)
print("READY", flush=True)
time.sleep(300)
""" % (SMALL_LM,)


def _llm_salvage_leg(args, dev):
    """Token-exact preempt/resume under chaos: (1) a STARVED pool under
    a decode fault burst salvages every victim, which completes with the
    unfaulted oracle's tokens; (2) a journaled child process is SIGKILLed
    mid-generation and a fresh server restores its sequences token for
    token.  Returns failure strings."""
    from .. import fault, serving

    cfg, params = _lm(SMALL_LM, 0, dev)
    buckets = serving.BucketSpec(batch=(1,), length=(8,))
    fails = []
    expected = salvage_oracle(params, cfg, dev)

    # probe 1: preemption storm + fault burst on a starved pool
    srv = serving.GenerationServer(
        params, cfg, buckets=buckets, n_slots=2, n_pages=5, page_size=4,
        max_new_tokens=10, seed=0, salvage_retries=8,
        breaker=_breaker(threshold=6), device=dev, name="ChaosSalvGen")
    srv.start()
    want, warm = _expected_graphs(srv), srv.graph_count()
    with fault.inject("generate.decode",
                      RuntimeError("injected decode fault"),
                      after_n=3, times=2) as h:
        reqs = [srv.submit(np.asarray(p, np.int32), seed=s, **kw)
                for p, kw, s in zip(SALVAGE_PROMPTS, SALVAGE_KINDS,
                                    SALVAGE_SEEDS)]
        got = [tuple(int(t) for t in r.result(timeout=240)) for r in reqs]
    st = srv.stats
    recomp = srv.telemetry()["gauges"].get("recompiles_unexpected", 0)
    say(f"llm salvage leg: storm served {st['completed']}/"
        f"{len(SALVAGE_PROMPTS)} (preempted={st['preempted']} "
        f"tokens_salvaged={st['tokens_salvaged']} resumes={st['resumes']} "
        f"salvage_retries={st['salvage_retries']} injected_fired="
        f"{h.fired})")
    if h.fired == 0:
        fails.append("salvage leg: injected decode faults never fired")
    if st["completed"] != len(SALVAGE_PROMPTS) or st["failed"] != 0:
        fails.append(f"salvage leg: {st['failed']} sequences failed — "
                     f"salvage dropped accepted work")
    if st["tokens_salvaged"] == 0:
        fails.append("salvage leg: the storm salvaged no tokens")
    if st["preempted"] == 0 or st["resumes"] == 0:
        fails.append("salvage leg: the starved pool never preempted/"
                     "resumed — the storm probe probed nothing")
    if got != expected:
        fails.append("salvage leg: salvaged streams diverge from the "
                     "unfaulted oracle — resume is not token-exact")
    if recomp != 0:
        fails.append(f"salvage leg: recompiles_unexpected == {recomp}")
    if srv.graph_count() != warm or warm != want:
        fails.append(f"salvage leg: {srv.graph_count()} graphs vs warm-up "
                     f"{warm} vs census {want}")
    if srv.alloc.free_count() != srv.alloc.allocatable:
        fails.append(f"salvage leg: page leak — {srv.alloc.free_count()} "
                     f"free of {srv.alloc.allocatable} after drain")
    if not srv.drain(30):
        fails.append("salvage leg: storm server drain did not complete")
    del srv

    # probe 2: kill -9 mid-generation, restore from the journal
    jdir = _scratch(prefix="chaos_salvage_")
    jpath = os.path.join(jdir, "decode.jsonl")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen(
        [sys.executable, "-c", _JOURNAL_CHILD, jpath, args.device],
        stdout=subprocess.PIPE, text=True, env=env)
    line = child.stdout.readline()          # blocks until READY/EOF
    ready = line.strip() == "READY"
    if ready:
        os.kill(child.pid, signal.SIGKILL)  # the actual kill -9
    else:
        child.kill()
    child.wait()
    child.stdout.close()
    if not ready:
        fails.append("salvage leg: journal child never reached READY")
        return fails

    rsrv = serving.GenerationServer(
        params, cfg, buckets=buckets, n_slots=2, n_pages=33, page_size=4,
        max_new_tokens=32, seed=0, device=dev, name="ChaosRestoreGen")
    rsrv.start()
    exp = [tuple(int(t) for t in rsrv.submit(
               np.asarray([3, 1, 2], np.int32), seed=11).result(120)),
           tuple(int(t) for t in rsrv.submit(
               np.asarray([5, 4], np.int32), temperature=0.9, top_k=6,
               seed=22).result(120))]
    restored = rsrv.restore_journal(jpath)
    outs = sorted(tuple(int(t) for t in r.result(timeout=240))
                  for r in restored.values())
    rst = rsrv.stats
    say(f"llm salvage leg: kill -9 restore — journal_restores="
        f"{rst['journal_restores']} restored={len(restored)} "
        f"resumes={rst['resumes']}")
    if rst["journal_restores"] == 0 or len(restored) != 2:
        fails.append(f"salvage leg: journal restore recovered "
                     f"{len(restored)} of 2 in-flight sequences")
    if outs != sorted(exp):
        fails.append("salvage leg: restored streams diverge from the "
                     "uninterrupted oracle — journal restore is not "
                     "token-exact")
    if not rsrv.drain(30):
        fails.append("salvage leg: restore server drain did not complete")
    return fails


def llm_mode(args, leg=None):
    """The tensor-parallel leg (``leg``: its model, buckets and pool;
    the serving configuration on the card, the reference's small model
    on the host), then the speculative and salvage legs."""
    dev = _device(args.device)
    if leg is None:
        leg = SERVING_TP if dev.type == "cuda" else SMALL_TP
    say(f"llm: tp=2 leg at {leg['config']}, {leg['n_slots']} slots, "
        f"{leg['n_pages']} pages x {leg['page_size']}, buckets "
        f"{tuple(leg['batch'])} x {tuple(leg['length'])}")
    fails = _llm_tp_leg(args, leg)
    fails += _llm_spec_leg(args, dev)
    fails += _llm_salvage_leg(args, dev)
    return _verdict(fails, "drain completed with every accepted sequence "
                           "resolved over the tp=2 gang (0 dropped, graphs "
                           "== census, pages fully reclaimed); shared-prefix "
                           "+ speculative + salvage/journal legs clean")


# ---------------------------------------------------------------- elastic --
def elastic_mode(args):
    """Supervised-gang chaos: SIGKILL + SIGSTOP-hang + supervisor
    SIGTERM legs over a 2-worker training gang."""
    from .. import elastic

    fails = []

    def wait_for(pred, timeout, what):
        t0 = time.time()
        while time.time() - t0 < timeout:
            v = pred()
            if v:
                return v
            time.sleep(0.05)
        fails.append(f"timed out after {timeout}s waiting for {what}")
        return None

    def spawn_pids(sup, attempt):
        for rec in sup.log.records:
            if rec["event"] == "spawn" and rec["attempt"] == attempt:
                return rec["pids"]
        return None

    def hb_step(sup, rank, attempt):
        rec = elastic.read_heartbeats(sup.heartbeat_dir).get(rank)
        if rec and int(rec.get("attempt", -1)) == attempt:
            return int(rec["global_step"])
        return 0

    def assert_reaped(sup):
        pids = {p for r in sup.log.records if r["event"] == "spawn"
                for p in r["pids"]}
        for pid in sorted(pids):
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                continue
            fails.append(f"worker pid {pid} leaked past supervisor exit")

    def build(td, target, max_restarts):
        ckpt = os.path.join(td, "ckpt")
        return elastic.Supervisor(
            [sys.executable, "-m", "mxnet_tpu_torch.elastic_worker",
             "--device", args.device, "--net", "dense",
             "--target-step", str(target), "--ckpt-dir", ckpt,
             "--every", "2", "--step-sleep", "0.15"], 2,
            platform="cpu" if args.device == "cpu" else None,
            max_restarts=max_restarts, watchdog_secs=5.0,
            startup_grace_secs=180.0, graceful_secs=30.0,
            backoff_base=0.2, heartbeat_dir=os.path.join(td, "hb"),
            event_log=os.path.join(td, "events.jsonl"), progress_dir=ckpt,
            extra_env={"PYTHONPATH": REPO + os.pathsep +
                       os.environ.get("PYTHONPATH", "")})

    # leg A: SIGKILL one worker mid-run, SIGSTOP the other
    target = 14
    sup = build(_scratch(prefix="chaos_elastic_"), target,
                max_restarts=2)
    stopped = []

    def chaos_script():
        # SIGKILL rank 1 once attempt 0 committed real progress
        if wait_for(lambda: hb_step(sup, 1, 0) >= 5, 300,
                    "attempt 0 rank 1 to pass step 5") is None:
            sup.request_stop()
            return
        os.kill(spawn_pids(sup, 0)[1], signal.SIGKILL)
        say("elastic: SIGKILLed rank 1 mid-run")
        # SIGSTOP rank 0 of attempt 1 once it advanced further
        if wait_for(lambda: hb_step(sup, 0, 1) >= 9, 300,
                    "attempt 1 rank 0 to pass step 9") is None:
            sup.request_stop()
            return
        pid = spawn_pids(sup, 1)[0]
        os.kill(pid, signal.SIGSTOP)
        stopped.append(pid)
        say("elastic: SIGSTOPed rank 0 (watchdog bait)")

    t = threading.Thread(target=chaos_script)
    t.start()
    try:
        rc = sup.run()
    finally:
        t.join()
        for pid in stopped:        # never leave one stopped
            try:
                os.kill(pid, signal.SIGCONT)
            except ProcessLookupError:
                pass
    evs = [r["event"] for r in sup.log.records]
    final = elastic.latest_committed_step(sup.progress_dir)
    restarts = evs.count("restart")
    starts = [r["progress"] for r in sup.log.records
              if r["event"] == "spawn"]
    say(f"elastic: rc={rc} final_step={final} restarts={restarts} "
        f"spawn_progress={starts} events={evs}")
    if rc != 0:
        fails.append(f"leg A: supervisor exited rc={rc}, wanted 0")
    if final is None or final < target:
        fails.append(f"leg A: committed step {final} < target {target}")
    if restarts != 2:
        fails.append(f"leg A: expected exactly 2 restarts "
                     f"(SIGKILL + watchdog), saw {restarts}")
    if "heartbeat-stale" not in evs:
        fails.append("leg A: the SIGSTOP never tripped the watchdog")
    if "giveup" in evs:
        fails.append("leg A: supervisor gave up inside budget")
    resumes = starts[1:]
    if any(s in (None, 0) for s in resumes):
        fails.append(f"leg A: a restart resumed from step 0: {starts}")
    if resumes != sorted(resumes) or len(set(resumes)) != len(resumes):
        fails.append(f"leg A: per-attempt resume steps not strictly "
                     f"increasing: {starts}")
    with open(sup.event_log) as f:
        for line in f:
            json.loads(line)       # every event line is valid JSON
    assert_reaped(sup)

    # leg B: SIGTERM the supervisor itself
    sup2 = build(_scratch(prefix="chaos_elastic_term_"), 10_000,
                 max_restarts=1)

    def term_script():
        if wait_for(lambda: hb_step(sup2, 0, 0) >= 4 and
                    hb_step(sup2, 1, 0) >= 4, 300,
                    "leg B workers to pass step 4") is None:
            sup2.request_stop()
            return
        os.kill(os.getpid(), signal.SIGTERM)
        say("elastic: SIGTERMed the supervisor")

    t2 = threading.Thread(target=term_script)
    t2.start()
    try:
        rc2 = sup2.run()
    finally:
        t2.join()
    evs2 = [r["event"] for r in sup2.log.records]
    statuses = [r["status"] for r in sup2.log.records
                if r["event"] == "worker-exit"]
    final2 = elastic.latest_committed_step(sup2.progress_dir)
    say(f"elastic: SIGTERM leg rc={rc2} statuses={statuses} "
        f"snapshot_step={final2} events={evs2}")
    if rc2 != 0:
        fails.append(f"leg B: supervisor SIGTERM exit rc={rc2}, wanted 0")
    if "preempted" not in evs2 or "forward-sigterm" not in evs2:
        fails.append(f"leg B: missing forward-sigterm/preempted events: "
                     f"{evs2}")
    if statuses != ["preempted", "preempted"]:
        fails.append(f"leg B: workers did not snapshot-then-exit: "
                     f"{statuses}")
    if not final2:
        fails.append("leg B: no snapshot committed before exit")
    assert_reaped(sup2)
    return _verdict(fails, f"SIGKILL + SIGSTOP-hang recovered within budget "
                           f"({restarts} restarts, resumes {resumes}, "
                           f"reached step {final}); supervisor SIGTERM "
                           f"drained to {statuses} with snapshot at step "
                           f"{final2}; 0 leaked workers")


# ------------------------------------------------------------------- ckpt --
_CKPT_WORKER = r"""
import sys
from mxnet_tpu_torch.parallel.checkpoint import CheckpointManager
from mxnet_tpu_torch.tools.chaos_check import (_device, dense_net,
                                               dense_step, train_batches)

step = dense_step(dense_net(7, _device(sys.argv[2])))
x, y = train_batches(1)[0]
step(x, y)
mgr = CheckpointManager(step, sys.argv[1], every_n_steps=1, keep_last=4)
mgr.resume_latest()
while True:                     # snapshot storm until SIGKILLed
    step(x, y)
    mgr.maybe_save()
"""


def ckpt_mode(args):
    """Durable-checkpoint chaos: kill -9 mid-write storm + armed bit-flip
    corruption + retention pruning under a live WeightUpdater."""
    import torch

    from .. import fault, serving
    from ..parallel.checkpoint import (BitFlipInjection,
                                       CheckpointCorruptError,
                                       CheckpointManager, list_checkpoints,
                                       load_snapshot_params, resume_latest,
                                       verify_checkpoint)

    dev = _device(args.device)
    fails = []
    x, y = train_batches(1)[0]
    survivor = dense_step(dense_net(99, dev))
    survivor(x, y)                       # build once, reused every leg

    # leg A: kill -9 a snapshot storm, repeatedly
    d = _scratch(prefix="chaos_ckpt_")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    kills = 3

    def newest(directory):
        cks = list_checkpoints(directory)
        return cks[-1][0] if cks else 0

    for round_no in range(kills):
        # retention caps the COUNT at keep_last, so progress is the
        # newest committed num_update, not the directory's size
        before = newest(d)
        proc = subprocess.Popen(
            [sys.executable, "-c", _CKPT_WORKER, d, args.device], env=env)
        t0 = time.time()
        while newest(d) < before + 2 and \
                time.time() - t0 < 120 and proc.poll() is None:
            time.sleep(0.02)
        if proc.poll() is not None:
            fails.append(f"leg A round {round_no}: worker exited "
                         f"rc={proc.returncode} before the kill")
            break
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        cks = list_checkpoints(d)
        if newest(d) < before + 2:
            fails.append(f"leg A round {round_no}: storm advanced the "
                         f"newest snapshot from {before} to {newest(d)}, "
                         f"wanted >= {before + 2}")
        for _, path in cks:              # every COMMITTED name verifies:
            try:                         # atomic commit + fsync means a
                verify_checkpoint(path)  # kill can never corrupt one
            except Exception as exc:     # noqa: BLE001
                fails.append(f"leg A round {round_no}: committed snapshot "
                             f"{os.path.basename(path)} failed "
                             f"verification after kill -9: {exc}")
        n = resume_latest(survivor, d)
        if n is None:
            fails.append(f"leg A round {round_no}: resume found nothing")
        say(f"ckpt: kill round {round_no}: {len(cks)} committed, all "
            f"verified, resumed at step {n}")

    # leg B: fault-armed bit-flip — damage, never poison
    d2 = _scratch(prefix="chaos_ckpt_flip_")
    victim = dense_step(dense_net(7, dev))
    victim(x, y)
    mgr2 = CheckpointManager(victim, d2, keep_last=10)
    mgr2.save()                          # intact
    good = int(victim._num_update)
    victim(x, y)
    with fault.inject("checkpoint.serialize", BitFlipInjection(), times=1):
        corrupt_path = mgr2.save()       # committed but digest-poisoned
    try:
        verify_checkpoint(corrupt_path)
        fails.append("leg B: verify_checkpoint passed a bit-flipped "
                     "snapshot")
    except CheckpointCorruptError:
        pass
    try:
        load_snapshot_params(corrupt_path)
        fails.append("leg B: load_snapshot_params served corrupted bytes")
    except CheckpointCorruptError:
        pass
    n = resume_latest(survivor, d2)
    if n != good:
        fails.append(f"leg B: resume landed on step {n}, wanted the "
                     f"older intact snapshot {good}")
    say(f"ckpt: bit-flip rejected everywhere, resume fell back to intact "
        f"step {good}")

    # leg C: prune race + corrupt stream under a live updater
    d3 = _scratch(prefix="chaos_ckpt_race_")
    trainer = dense_step(dense_net(7, dev))
    trainer(x, y)
    # keep_last=1: retention prunes all but the newest — the tightest
    # race against the polling reader
    mgr3 = CheckpointManager(trainer, d3, keep_last=1)
    mgr3.save()
    params, _ = load_snapshot_params(mgr3.checkpoints()[-1][1])
    from .. import graphs
    fwd = graphs.captured(_mlp_fn(params))
    applies = [serving.HotSwapApply(fwd, _on(params, dev))
               for _ in range(2)]
    fleet = serving.ServingFleet(applies, buckets=(1, 4), max_delay=0.002,
                                 sample=np.ones((8,), np.float32),
                                 name="ChaosCkptFleet")
    fleet.start()
    updater = serving.WeightUpdater(fleet, mgr3, poll=0.01)
    updater.start()
    corrupt_round = 3
    try:
        for round_no in range(1, 6):
            trainer(x, y)
            if round_no == corrupt_round:
                with fault.inject("checkpoint.serialize",
                                  BitFlipInjection(), times=1):
                    mgr3.save()
                t0 = time.time()
                while updater.skipped < 1 and time.time() - t0 < 30:
                    time.sleep(0.01)
                if updater.skipped < 1:
                    fails.append("leg C: the corrupt snapshot was never "
                                 "rejected by the updater")
            else:
                want_applied = updater.applied + 1
                mgr3.save()
                t0 = time.time()
                while updater.applied < want_applied and \
                        time.time() - t0 < 30:
                    time.sleep(0.01)
                if updater.applied < want_applied:
                    fails.append(f"leg C: rolling update {round_no} "
                                 f"dropped (applied={updater.applied}, "
                                 f"skipped={updater.skipped})")
        # deterministic prune-vs-reader race: the path vanishes between
        # discovery and read — stale (re-poll), never a bad snapshot
        pruned = os.path.join(d3, "ckpt-99999999.npz")
        shutil.copy(mgr3.checkpoints()[-1][1], pruned)
        os.remove(pruned)
        skipped_before = updater.skipped
        try:
            updater.update(pruned)
            fails.append("leg C: updating a pruned path did not raise")
        except serving.SnapshotPrunedError:
            pass
        except Exception as exc:        # noqa: BLE001
            fails.append(f"leg C: pruned path raised {type(exc).__name__}"
                         f" instead of SnapshotPrunedError: {exc}")
        if updater.skipped != skipped_before:
            fails.append("leg C: a pruned (stale) path was counted as a "
                         "skipped snapshot")
    finally:
        updater.stop(timeout=10)
        fleet.drain(timeout=10)
    # the fleet must serve the FINAL committed snapshot's weights — the
    # corrupt round's bytes must never have reached a replica
    ones = np.ones((1, 8), np.float32)
    last = load_snapshot_params(mgr3.checkpoints()[-1][1])[0]
    want = _mlp_fn(last)(_on(last, "cpu"), torch.from_numpy(ones))
    got = applies[0](ones).cpu()
    if not np.allclose(got.numpy()[0], want.numpy()[0], atol=1e-6):
        fails.append("leg C: replica does not serve the final intact "
                     "snapshot's weights")
    say(f"ckpt: race leg applied={updater.applied} skipped="
        f"{updater.skipped} (corrupt stream rejected, prune race "
        f"re-polled)")
    return _verdict(fails, f"{kills} kill -9 rounds left only verified-"
                           f"intact committed snapshots; bit-flip rejected "
                           f"by verify/load/resume; live updater under "
                           f"keep_last=1 pruning applied {updater.applied} "
                           f"updates, rejected the corrupt one, and served "
                           f"the final intact weights")


# -------------------------------------------------------------------- slo --
def _eye_apply():
    """One shared captured ``x @ w`` over ``params = [w]`` (4 x 4)."""
    from .. import graphs

    def fwd(params, x):
        (w,) = params
        return x @ w
    return graphs.captured(fwd)


def _slo_fleet_leg(dev):
    """The fleet half of the SLO storm: gold/bronze replica groups, an
    abusive tenant, a replica kill, one autoscale up/down cycle and a
    rolling weight update, concurrently.  Returns failure strings."""
    import torch

    from .. import profiler, serving

    W = torch.eye(4, dtype=torch.float32, device=dev)
    fwd = _eye_apply()
    qos = serving.TenantQoS(
        classes=[serving.QoSClass("gold", priority=10, deadline=5.0,
                                  group="gold"),
                 serving.QoSClass("bronze", priority=0, deadline=5.0,
                                  admit_frac=0.8, group="bronze")],
        default_class="bronze", tenant_rate=200, tenant_burst=200)
    gold = [_killable(fwd, [W], 0.001)]
    bronze = [_killable(fwd, [W], 0.004) for _ in range(2)]
    fleet = serving.ServingFleet(
        {"gold": gold, "bronze": bronze}, buckets=(1, 2, 4),
        max_delay=0.002, max_inflight=16, qos=qos,
        sample=np.ones((4,), np.float32), name="SloFleet")
    fleet.start()
    census = fleet.grid_census
    warm = fwd.graph_count()
    scaler = serving.FleetAutoscaler(
        fleet, serving.ScalingPolicy(
            min_replicas=1, max_replicas=3, up_occupancy=0.25,
            down_occupancy=0.1, up_queue_depth=4, up_ticks=2,
            down_ticks=10, cooldown=0.1),
        group="bronze", tick=0.02, watchdog_secs=60).start()
    updater = serving.WeightUpdater(fleet)
    say(f"slo fleet: groups gold=1 bronze=2, census={census}, graphs="
        f"{warm}, autoscaler on bronze, ready={fleet.ready()}")

    stop = threading.Event()
    lock = threading.Lock()
    served = {}                 # tenant -> [accepted Requests]
    throttled = {}              # tenant -> count

    def client(tenant, klass, pause):
        x = np.random.RandomState(sum(map(ord, tenant)) % 97).randn(4) \
            .astype(np.float32)
        while not stop.is_set():
            try:
                r = fleet.submit(x, tenant=tenant, klass=klass)
                with lock:
                    served.setdefault(tenant, []).append(r)
            except serving.TenantThrottledError:
                with lock:
                    throttled[tenant] = throttled.get(tenant, 0) + 1
            except serving.RejectedError:
                pass
            time.sleep(pause)

    specs = [("g0", "gold", 0.008), ("g1", "gold", 0.008),
             ("b0", "bronze", 0.008), ("b1", "bronze", 0.008),
             ("abuser", "bronze", 0.0005)]    # ~2000/s — way over rate
    threads = [threading.Thread(target=client, args=s) for s in specs]
    for t in threads:
        t.start()
    fails = []
    try:
        time.sleep(0.3)
        bronze[1].dead = True       # replica kill mid-storm
        # rolling weight update mid-storm; a kill that has not hit a
        # batch yet can race the roll, so one retry is legitimate (the
        # WeightUpdater's watch loop re-polls the same way)
        try:
            updater.update([2.0 * W])
        except serving.UpdateRolledBackError:
            updater.update([2.0 * W])
        t0 = time.time()
        while scaler.stats["scale_ups"] < 1 and time.time() - t0 < 30:
            time.sleep(0.02)
        time.sleep(0.3)             # let the scaled fleet absorb the storm
    finally:
        stop.set()
        _join(threads)
    # storm over: the autoscaler should give the capacity back
    t0 = time.time()
    while scaler.stats["scale_downs"] < 1 and time.time() - t0 < 30:
        time.sleep(0.05)
    scaler.stop(timeout=10)
    drained = fleet.drain(timeout=30)
    classes = fleet.healthz()["classes"]
    all_reqs = [r for reqs in served.values() for r in reqs]
    resolved = sum(1 for r in all_reqs if r.done())
    errs = [r.exception(0) for r in all_reqs
            if r.done() and r.exception(0) is not None]
    st = scaler.stats
    say(f"slo fleet: accepted={len(all_reqs)} resolved={resolved} "
        f"errored={len(errs)} throttled={throttled} scale={st} "
        f"gold_p99={classes['gold']['p99_ms']} "
        f"bronze_p99={classes['bronze']['p99_ms']} "
        f"graphs={fwd.graph_count()}")
    if not drained:
        fails.append("slo fleet: drain did not complete")
    if resolved != len(all_reqs):
        fails.append(f"slo fleet: {len(all_reqs) - resolved} accepted "
                     f"requests silently dropped")
    if errs:
        fails.append(f"slo fleet: {len(errs)} accepted requests errored "
                     f"(first: {errs[0]!r})")
    if throttled.get("abuser", 0) < 10:
        fails.append(f"slo fleet: abusive tenant was not throttled "
                     f"({throttled})")
    for tenant in ("g0", "g1", "b0", "b1"):
        if throttled.get(tenant, 0) > 0:
            fails.append(f"slo fleet: well-behaved tenant {tenant} was "
                         f"throttled {throttled[tenant]}x — isolation "
                         f"failed")
        if not served.get(tenant):
            fails.append(f"slo fleet: tenant {tenant} had nothing served")
    if not (classes["gold"]["p99_ms"] < classes["bronze"]["p99_ms"]):
        fails.append(f"slo fleet: per-class p99 ordering failed "
                     f"(gold {classes['gold']['p99_ms']} ms >= bronze "
                     f"{classes['bronze']['p99_ms']} ms)")
    if st["scale_ups"] < 1 or st["scale_downs"] < 1:
        fails.append(f"slo fleet: no full autoscale cycle ({st})")
    if updater.applied != 1:
        fails.append(f"slo fleet: rolling update did not apply "
                     f"({updater.applied})")
    got = gold[0](np.ones((1, 4), np.float32)).cpu().numpy()[0]
    if not np.allclose(got, 2.0 * np.ones(4, np.float32)):
        fails.append("slo fleet: gold replica does not serve the rolled "
                     "weights")
    if fwd.graph_count() != warm or warm > census:
        fails.append(f"slo fleet: recompile — {fwd.graph_count()} graphs "
                     f"vs warm {warm} vs census {census}")
    # whichever bronze replica the scaler retired, the counter-leak
    # sweep proves the membership accounting held
    live = {str(rep.index) for rep in fleet.replicas}
    leaked = [s for s in profiler.counters("SloFleet-r").keys()
              if s.split("::")[0].replace("SloFleet-r", "") not in live]
    if leaked:
        fails.append(f"slo fleet: retired replicas leaked counter "
                     f"series: {leaked}")
    return fails


def _slo_llm_leg(dev):
    """The generation half: a disaggregated server (prefill worker group
    + handoff) under a long-prefill + decode mix with two priority
    classes.  Returns failure strings."""
    from .. import serving

    cfg, params = _lm(SMALL_LM, 0, dev)
    qos = serving.TenantQoS(
        classes=[serving.QoSClass("gold", priority=10, deadline=20.0),
                 serving.QoSClass("bronze", priority=0, deadline=20.0,
                                  admit_frac=0.5)],
        default_class="bronze")
    srv = serving.GenerationServer(
        params, cfg, buckets=serving.BucketSpec(batch=(1, 2), length=(8, 32)),
        n_slots=2, n_pages=41, page_size=8, max_new_tokens=8,
        max_queue=128, seed=0, prefill_workers=2, qos=qos, device=dev,
        name="SloGen")
    srv.start()
    want, warm = _expected_graphs(srv), srv.graph_count()
    say(f"slo llm: disaggregated (2 prefill workers), census "
        f"{srv.census()} (grid + handoff + decode), {warm} graphs")

    stop = threading.Event()
    lock = threading.Lock()
    accepted = {"gold": [], "bronze": []}

    def client(k, klass, long_prompts, pause):
        rng = np.random.RandomState(k)
        while not stop.is_set():
            if long_prompts:
                n, new = int(rng.randint(24, 31)), int(rng.randint(5, 9))
            else:
                n, new = int(rng.randint(1, 8)), int(rng.randint(1, 4))
            try:
                r = srv.submit(rng.randint(0, 64, size=n).astype(np.int32),
                               max_new_tokens=new, tenant=f"t{k}",
                               klass=klass)
                with lock:
                    accepted[klass].append(r)
            except serving.RejectedError:
                pass
            time.sleep(pause)

    # three bronze clients streaming LONG prompts oversubscribe the two
    # decode slots; gold's short prompts must jump that queue
    threads = [threading.Thread(target=client, args=(k, klass, lng, p))
               for k, (klass, lng, p) in enumerate(
                   [("gold", False, 0.01), ("bronze", True, 0.001),
                    ("bronze", True, 0.001), ("bronze", True, 0.001)])]
    for t in threads:
        t.start()
    time.sleep(1.2)
    stop.set()
    _join(threads)
    drained = srv.drain(timeout=60)
    classes = srv.healthz()["classes"]
    fails = []
    all_reqs = accepted["gold"] + accepted["bronze"]
    resolved, oks, _ = _tally(all_reqs)
    say(f"slo llm: accepted={len(all_reqs)} resolved={resolved} ok={oks} "
        f"gold_p99={classes['gold']['p99_ms']} "
        f"bronze_p99={classes['bronze']['p99_ms']} "
        f"handoffs={srv.stats['handoffs']} graphs={srv.graph_count()}")
    if not drained:
        fails.append("slo llm: drain did not complete")
    if resolved != len(all_reqs):
        fails.append(f"slo llm: {len(all_reqs) - resolved} accepted "
                     f"sequences silently dropped")
    if oks == 0 or not accepted["gold"] or not accepted["bronze"]:
        fails.append("slo llm: traffic did not actually flow")
    if srv.stats["handoffs"] < 1:
        fails.append("slo llm: no prefill→decode handoff happened — the "
                     "disaggregated path was not exercised")
    if srv.graph_count() != warm or warm != want:
        fails.append(f"slo llm: recompile — {srv.graph_count()} graphs vs "
                     f"warm {warm} vs census {want}")
    if srv.alloc.free_count() != srv.alloc.allocatable:
        fails.append(f"slo llm: page leak ({srv.alloc.free_count()} of "
                     f"{srv.alloc.allocatable} free)")
    if not (classes["gold"]["p99_ms"] < classes["bronze"]["p99_ms"]):
        fails.append(f"slo llm: per-class p99 ordering failed (gold "
                     f"{classes['gold']['p99_ms']} ms >= bronze "
                     f"{classes['bronze']['p99_ms']} ms)")
    return fails


def slo_mode(args):
    """Mixed-tenant SLO storm + replica kill + autoscale cycle + rolling
    update, then the disaggregated-generation leg."""
    dev = _device(args.device)
    fails = _slo_fleet_leg(dev)
    fails += _slo_llm_leg(dev)
    return _verdict(fails, "mixed-tenant storm survived — 0 dropped "
                           "accepted requests on both legs, abusive tenant "
                           "isolated, per-class p99 ordering held, full "
                           "autoscale cycle + rolling update under fire, "
                           "graphs within the census")


# -------------------------------------------------------------------- obs --
def _show_tree(tr):
    """Print a span tree that failed its audit: each span's id, parent,
    name, start after the root's and length, so the failure shows where
    the time went."""
    recs = sorted(tr.records(), key=lambda r: r["t0_us"])
    t0 = recs[0]["t0_us"]
    say(f"span tree {tr.trace_id} (id <- parent name: +start, length):")
    for r in recs:
        length = "open" if r["dur_us"] is None \
            else f"{r['dur_us'] / 1e3:.2f} ms"
        say(f"  #{r['span']} <- {r['parent']} {r['name']}: "
            f"+{(r['t0_us'] - t0) / 1e3:.2f} ms, {length} {r['attrs']}")


def _obs_fleet_leg(dev):
    """A traced 3-replica fleet under traffic with a ``serving.step``
    fault burst and one replica hard-killed: every accepted request
    resolves AND yields a complete, attribution-clean span tree.
    Returns (failure strings, accepted count)."""
    import torch

    from .. import fault, serving, telemetry

    W = torch.eye(4, dtype=torch.float32, device=dev)
    fwd = _eye_apply()
    applies = [_killable(fwd, [W], 0.002) for _ in range(3)]
    fleet = serving.ServingFleet(
        applies, buckets=(1, 2, 4), max_delay=0.002,
        sample=np.ones((4,), np.float32), name="ObsFleet")
    fleet.start()

    accepted, sheds = [], [0]
    count_lock = threading.Lock()
    stop_submitting = threading.Event()

    def client(k):
        r = np.random.RandomState(k).randn(4).astype(np.float32)
        while not stop_submitting.is_set():
            try:
                req = fleet.submit(r)
                with count_lock:
                    accepted.append(req)
            except serving.RejectedError:
                with count_lock:
                    sheds[0] += 1
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    fails = []
    for t in threads:
        t.start()
    try:
        time.sleep(0.1)
        # a fault burst the failover path absorbs; the firings must land
        # as span events on the in-flight step spans
        with fault.inject("serving.step", RuntimeError("injected storm"),
                          times=3):
            time.sleep(0.15)
        applies[1].dead = True     # hard-kill replica 1 under traffic
        time.sleep(0.2)
    finally:
        stop_submitting.set()
        _join(threads)
    fleet.drain()

    unresolved = sum(1 for r in accepted if not r.done())
    errs = [r.exception(0) for r in accepted
            if r.done() and r.exception(0) is not None]
    if unresolved:
        fails.append(f"obs fleet: {unresolved} accepted requests were "
                     f"silently dropped")
    if errs:
        fails.append(f"obs fleet: {len(errs)} accepted requests errored "
                     f"— failover should have absorbed the chaos "
                     f"(first: {errs[0]!r})")
    traces = telemetry.finished_traces(clear=True)
    if len(traces) != len(accepted):
        fails.append(f"obs fleet: {len(accepted)} accepted requests but "
                     f"{len(traces)} span trees — tracing is lossy")
    bad = fault_events = failovers = 0
    for tr in traces:
        problems = telemetry.audit_spans(tr)
        if problems:
            bad += 1
            if bad == 1:
                fails.append(f"obs fleet: incomplete/mis-attributed span "
                             f"tree {tr.trace_id}: {problems}")
                _show_tree(tr)
        for sp in tr.spans:
            failovers += sp.name == "failover"
            fault_events += sum(1 for ev in sp.events
                                if ev["name"] == "fault")
    if bad > 1:
        fails.append(f"obs fleet: {bad} of {len(traces)} span trees "
                     f"failed the audit")
    if fault_events < 1:
        fails.append("obs fleet: the injected fault burst left no span "
                     "events — fault.fire observer not wired")
    if failovers < 1:
        fails.append("obs fleet: the replica kill produced no failover "
                     "spans")
    say(f"obs fleet: accepted={len(accepted)} shed={sheds[0]} "
        f"trees={len(traces)} audit_bad={bad} failover_spans={failovers} "
        f"fault_events={fault_events} "
        f"redispatched={fleet.stats['redispatched']}")
    return fails, len(accepted)


def _obs_llm_leg(dev):
    """A traced ``GenerationServer`` streams sequences through a
    ``generate.decode`` fault burst: accepted sequences resolve (tokens
    or an explicit error) and each yields a complete admit → queue →
    prefill → decode span tree."""
    from .. import fault, serving, telemetry

    cfg, params = _lm(dict(SMALL_LM, vocab_size=48), 3, dev)
    srv = serving.GenerationServer(
        params, cfg, buckets=serving.BucketSpec(batch=(1,), length=(8,)),
        n_slots=2, n_pages=17, page_size=4, max_new_tokens=6, seed=0,
        device=dev, name="ObsGen")
    srv.start()
    accepted = []
    count_lock = threading.Lock()
    fails = []

    def client(k):
        rng = np.random.RandomState(k)
        for _ in range(4):
            prompt = rng.randint(1, 40, (3,)).astype(np.int32)
            try:
                req = srv.submit(prompt, max_new_tokens=4)
                with count_lock:
                    accepted.append(req)
            except serving.RejectedError:
                pass
            time.sleep(0.01)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    with fault.inject("generate.decode", RuntimeError("decode storm"),
                      times=2):
        _join(threads)
        srv.drain()

    unresolved = sum(1 for r in accepted if not r.done())
    if unresolved:
        fails.append(f"obs llm: {unresolved} accepted sequences were "
                     f"silently dropped")
    traces = telemetry.finished_traces(clear=True)
    if len(traces) != len(accepted):
        fails.append(f"obs llm: {len(accepted)} accepted sequences but "
                     f"{len(traces)} span trees")
    bad = 0
    for tr in traces:
        problems = telemetry.audit_spans(tr)
        if problems:
            bad += 1
            if bad == 1:
                fails.append(f"obs llm: bad span tree {tr.trace_id}: "
                             f"{problems}")
                _show_tree(tr)
        names = {sp.name for sp in tr.spans}
        if not {"admit", "queue", "prefill"} <= names:
            fails.append(f"obs llm: trace {tr.trace_id} is missing "
                         f"generation phases ({sorted(names)})")
            break
    if bad > 1:
        fails.append(f"obs llm: {bad} of {len(traces)} span trees failed "
                     f"the audit")
    errored = sum(1 for r in accepted
                  if r.done() and r.exception(0) is not None)
    say(f"obs llm: accepted={len(accepted)} errored_explicitly={errored} "
        f"trees={len(traces)} audit_bad={bad}")
    return fails


def _obs_flight_leg(dev):
    """The crash flight recorder: a traced generation worker killed
    mid-step by a decode fault storm that trips the breaker must leave a
    complete post-mortem bundle (audit-clean span trees, the fatal fault
    firing on record, compile events == the census, no unexpected
    recompile), and every accepted sequence still resolves explicitly.
    Returns failure strings."""
    from .. import fault, serving, telemetry

    d = _scratch(prefix="chaos_flight_")
    telemetry.enable_flight(directory=d, limit=4096)
    fails = []
    cfg, params = _lm(dict(SMALL_LM, vocab_size=48), 5, dev)
    srv = serving.GenerationServer(
        params, cfg, buckets=serving.BucketSpec(batch=(1,), length=(8,)),
        n_slots=2, n_pages=17, page_size=4, max_new_tokens=6, seed=0,
        # threshold=1: the FIRST mid-step death trips OPEN (prefill
        # successes interleave with decode failures)
        breaker=serving.CircuitBreaker(threshold=1, base_delay=0.5),
        device=dev, name="FlightGen")
    accepted = []
    try:
        srv.start()       # traced warm-up: compile events == census
        count_lock = threading.Lock()

        def client(k):
            rng = np.random.RandomState(k)
            for _ in range(3):
                try:
                    req = srv.submit(rng.randint(1, 40, (3,))
                                     .astype(np.int32), max_new_tokens=4)
                    with count_lock:
                        accepted.append(req)
                except (serving.RejectedError, serving.ServerClosedError):
                    pass
                time.sleep(0.01)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(3)]
        # an unbounded decode fault storm armed BEFORE traffic (two clean
        # steps, then every decode step fails) until the breaker trips
        with fault.inject("generate.decode",
                          RuntimeError("decode storm — worker killed"),
                          after_n=2):
            for t in threads:
                t.start()
            _join(threads)
            deadline = time.monotonic() + 15
            while srv.breaker.state_code() != 2 \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
    finally:
        srv.drain()

    unresolved = sum(1 for r in accepted if not r.done())
    if unresolved:
        fails.append(f"obs flight: {unresolved} accepted sequences were "
                     f"silently dropped")
    bundle = telemetry.flight().last_path
    if bundle is None:
        fails.append("obs flight: the breaker trip left no flight-recorder "
                     "bundle")
        telemetry.flight().enabled = False
        return fails
    bad = telemetry.audit_jsonl(bundle)
    if bad:
        tid, problems = next(iter(bad.items()))
        fails.append(f"obs flight: bundle has {len(bad)} bad span trees "
                     f"(e.g. {tid}: {problems})")
    with open(bundle) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    header = recs[0]
    if header.get("kind") != "flight" \
            or header.get("reason") != "breaker-open":
        fails.append(f"obs flight: bundle header is {header.get('kind')}/"
                     f"{header.get('reason')}, expected a breaker-open dump")
    fatal = [r for r in recs if r.get("kind") == "fault"
             and r.get("name") == "generate.decode"]
    if not fatal:
        fails.append("obs flight: the fatal generate.decode firing is not "
                     "in the bundle")
    if not any(r.get("kind") == "metrics" for r in recs):
        fails.append("obs flight: bundle carries no metrics snapshot")
    cs = telemetry.compile_site_stats("FlightGen")
    if cs["unexpected"] != 0:
        fails.append(f"obs flight: {cs['unexpected']} unexpected "
                     f"recompiles (must be 0)")
    if cs["misses"] != _expected_graphs(srv):
        fails.append(f"obs flight: {cs['misses']} compile events != the "
                     f"{_expected_graphs(srv)} graphs of the census")
    telemetry.flight().enabled = False
    say(f"obs flight: accepted={len(accepted)} "
        f"bundle={os.path.basename(bundle)} records={len(recs)} "
        f"fault_recs={len(fatal)} compile_events={cs['misses']} "
        f"census={_expected_graphs(srv)} recompiles_unexpected="
        f"{cs['unexpected']}")
    return fails


def _obs_overhead_leg(dev):
    """The off-switch bound: with telemetry disabled the serving stack
    pays one module-attribute read + branch per instrumentation site, so
    per-guard cost x a generous guards-per-request budget must stay
    under 5% of the measured latency of a request to an untraced
    server."""
    from .. import graphs, serving, telemetry

    telemetry.disable()
    f = graphs.captured(lambda p, x: x * p[0])
    two = _on([np.float32(2.0)], dev)
    srv = serving.InferenceServer(
        lambda x: f(two, x), buckets=(1, 2, 4), max_delay=0.002,
        sample=np.zeros((3,), np.float32), name="ObsBase")
    srv.start()
    n, wave = 200, 50                # waves stay inside the admit queue
    t0 = time.perf_counter()
    for lo in range(0, n, wave):
        reqs = [srv.submit(np.full((3,), float(i % 7), np.float32))
                for i in range(lo, lo + wave)]
        for r in reqs:
            r.result(30)
    per_request = (time.perf_counter() - t0) / n
    srv.drain()
    per_guard = telemetry.guard_cost()
    # every instrumentation site on the longest path (admit, offer,
    # queue pop, coalesce, step, resolution, done-callback...) is well
    # under this budget
    guards_per_request = 64
    frac = per_guard * guards_per_request / per_request
    say(f"obs overhead: per_guard={per_guard * 1e9:.1f}ns x "
        f"{guards_per_request} guards vs per_request="
        f"{per_request * 1e6:.0f}us -> {frac * 100:.3f}% (< 5% required)")
    if frac >= 0.05:
        return [f"obs overhead: off-switch costs {frac * 100:.2f}% of "
                f"request latency (>= 5%)"]
    return []


def obs_mode(args):
    """Traced storm + replica kill + fault burst: zero dropped accepted
    requests, complete span trees, the JSONL export audit-clean, a
    breaker-trip flight bundle, the off-switch overhead bounded."""
    from .. import telemetry

    dev = _device(args.device)
    d = _scratch(prefix="chaos_obs_")
    sink_path = os.path.join(d, "spans.jsonl")
    telemetry.enable(sample=1.0, sink=sink_path, collect=True,
                     collect_limit=65536)
    try:
        fails, _n_fleet = _obs_fleet_leg(dev)
        fails += _obs_llm_leg(dev)
        fails += _obs_flight_leg(dev)
    finally:
        telemetry.disable()
        telemetry.config().sink.close()
        telemetry.config().sink = None
        telemetry.flight().enabled = False
    # the JSONL export must reconstruct to the same clean trees
    bad_jsonl = telemetry.audit_jsonl(sink_path)
    n_exported = len(telemetry.read_spans(sink_path))
    if bad_jsonl:
        tid, problems = next(iter(bad_jsonl.items()))
        fails.append(f"obs: JSONL round-trip has {len(bad_jsonl)} bad "
                     f"trees (e.g. {tid}: {problems})")
    fails += _obs_overhead_leg(dev)
    return _verdict(fails, f"traced storm survived — 0 dropped accepted "
                           f"requests, complete span trees on all legs "
                           f"({n_exported} trees exported + JSONL audit "
                           f"clean), breaker-trip flight bundle audit-clean "
                           f"with 0 unexpected recompiles, off-switch "
                           f"overhead < 5%")


MODES = {
    "train": ("kill-and-resume training smoke", train_mode),
    "serve": ("inject-and-drain serving smoke", serve_mode),
    "fleet": ("replica-kill + rolling weight updates + SIGTERM, int8 "
              "fleet ingest", fleet_mode),
    "llm": ("decode-fault burst + SIGTERM mid-decode on the tensor-"
            "parallel LLM server; speculative and salvage legs", llm_mode),
    "elastic": ("supervised-gang SIGKILL + SIGSTOP-hang + supervisor "
                "SIGTERM", elastic_mode),
    "slo": ("mixed-tenant QoS storm + replica kill + autoscale cycle + "
            "rolling update, plus disaggregated prefill/decode", slo_mode),
    "obs": ("traced storm + replica kill + fault burst: complete span "
            "trees, flight bundle, off-switch overhead bound", obs_mode),
    "ckpt": ("kill -9 mid-write storm + armed bit-flip corruption + "
             "retention-prune race under a live WeightUpdater", ckpt_mode),
}
NOT_PORTED = ("lint", "cost", "hlo")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=tuple(MODES), default="train",
                    help="; ".join(f"{k}: {v[0]}" for k, v in MODES.items()))
    ap.add_argument("--list-modes", action="store_true",
                    help="print the mode registry and exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=8,
                    help="total training steps in the reference run")
    ap.add_argument("--every", type=int, default=2,
                    help="checkpoint cadence (steps)")
    ap.add_argument("--keep", type=int, default=2,
                    help="retention: keep-last-K snapshots")
    ap.add_argument("--crash-after", type=int, default=None,
                    help="crash on this step call (default: steps//2 + 1)")
    ap.add_argument("--requests", type=int, default=25,
                    help="serve and llm modes: requests per client thread")
    ap.add_argument("--llm-rank", metavar="OUTDIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.llm_rank:
        return llm_tp_rank(args.llm_rank)
    if args.list_modes:
        for name, (desc, _) in MODES.items():
            print(f"{name:<10} {desc}")
        print(f"(not in the port: {', '.join(NOT_PORTED)}: they audit the "
              f"JAX package's source and HLO; ROADMAP A18)")
        return 0
    _device(args.device)               # no card for cuda: raise, run nothing
    from .. import graphs

    # launches made in this process, plus those other processes of the
    # mode report into args.launches (the tensor-parallel leader's)
    args.launches = {}
    base = graphs.launch_counts()
    t0 = time.perf_counter()
    rc = MODES[args.mode][1](args)
    now = graphs.launch_counts()
    launches = {k: now[k] - base[k] + args.launches.get(k, 0) for k in now}
    say(f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    say(f"mode {args.mode}: {time.perf_counter() - t0:.1f} s, rc {rc}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
