"""A supervised training worker (the counterpart of
``tests/elastic_worker.py``, one process, no collectives).

    python -m mxnet_tpu_torch.elastic_worker --device cuda \\
        --net resnet50_fused --target-step 10 --ckpt-dir ckpts --every 2

Spawned by ``elastic.Supervisor`` (``python -m mxnet_tpu_torch.launch``):
it trains a net with ``parallel.TrainStep`` to ``--target-step`` with
asynchronous ``CheckpointManager`` snapshots every ``--every`` steps
(the last two kept), resumes from the newest committed snapshot on
every attempt, beats a heartbeat every step (``TrainStep(heartbeat=)``,
from the supervisor's env contract) and exits with the statuses the
supervisor reads from outside: ``EXIT_PREEMPTED`` after a snapshot when
SIGTERM arrives (``fault.GracefulExit``), ``EXIT_NONFINITE`` on a
non-finite abort, non-zero on a crash.

The nets: ``dense`` (8 → 16 → 4, SGD 0.05, batch 16) and
``resnet50_fused`` (``resnet50_v1(fused=True, layout="NHWC")`` cast to
bfloat16 with f32 master weights, SGD 0.1 / 0.9 / 1e-4, batch 256 of
224x224x3, 1000 classes — ``bench_resnet``'s step), both from seed 0.
Batch k is a pure function of k and the seed (drawn by a generator on
the step's device), so a resumed attempt sees the data the uninterrupted
run saw; on the card cuDNN runs its deterministic algorithms, so the
resumed steps give the same bits.  The device is ``--device``: the
worker never falls back to the CPU when it finds no card.

Each step prints one line ``[worker] {"num_update": n, "loss": x,
"wall": t}`` (``x`` the loss as a float, exact; ``t`` epoch seconds);
the first line of an attempt says where it resumed, the last how many
steps it ran and how often each hand-written kernel was launched.
"""
import argparse
import json
import os
import sys
import time

SEED = 0
KEEP_LAST = 2


def _say(**fields):
    print("[worker] " + json.dumps(fields), flush=True)


def _dense(mx, device):
    from mxnet_tpu_torch import gluon, initializer

    initializer.seed(SEED)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu", in_units=8),
            gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=device)
    opt = mx.optimizer.create("sgd", learning_rate=0.05)
    return net, opt, 16, (8,), 4, None


def _resnet50_fused(mx, device):
    import torch
    from mxnet_tpu_torch import autograd, initializer
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    initializer.seed(SEED)
    net = resnet50_v1(layout="NHWC", fused=True)
    net.initialize(ctx=device)
    net.cast("bfloat16")
    with autograd.pause():                      # deferred shapes
        net(torch.zeros((1, 224, 224, 3), device=device,
                        dtype=torch.bfloat16))
    opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                              wd=1e-4)
    return net, opt, 256, (224, 224, 3), 1000, torch.bfloat16


NETS = {"dense": _dense, "resnet50_fused": _resnet50_fused}


def batch(torch, n, size, shape, classes, dtype, device):
    """Batch ``n``: a pure function of ``n`` and the seed."""
    g = torch.Generator(device=device).manual_seed(SEED * 1_000_003 + n)
    x = torch.randn((size,) + shape, generator=g, device=device)
    y = torch.randint(0, classes, (size,), generator=g, device=device,
                      dtype=torch.int32)
    return (x if dtype is None else x.to(dtype)), y


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="the step's device (cuda, cuda:N or cpu)")
    p.add_argument("--net", choices=sorted(NETS), default="dense")
    p.add_argument("--target-step", type=int, required=True)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--every", type=int, default=2,
                   help="snapshot every N steps")
    p.add_argument("--step-sleep", type=float, default=0.0,
                   help="seconds between steps (keeps work in flight so "
                        "a harness can land a kill mid-run)")
    args = p.parse_args(argv)

    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import elastic, fault, gluon, graphs, parallel

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {args.device}: no CUDA card "
                               f"visible to this worker")
        torch.backends.cudnn.deterministic = True
    attempt = int(os.environ.get("DMLC_ATTEMPT", "0"))
    hb = elastic.Heartbeat.from_env()
    net, opt, size, shape, classes, dtype = NETS[args.net](mx, device)
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              opt, heartbeat=hb)
    mgr = parallel.CheckpointManager(step, args.ckpt_dir,
                                     every_n_steps=args.every,
                                     keep_last=KEEP_LAST, async_save=True)

    ran, base = [], graphs.launch_counts()    # the net's shape pass ran

    def run(n):
        ran.append(n)
        return step(*batch(torch, n, size, shape, classes, dtype, device))

    def end(**fields):      # the steps' launches of each hand-written kernel
        now = graphs.launch_counts()
        _say(**fields, steps=len(ran), launches={
            k: now[k] - base[k] for k in now if now[k] != base[k]})

    with fault.GracefulExit() as gexit:
        try:
            loss = run(0)       # a restore needs a built step
            resumed = mgr.resume_latest()
            _say(attempt=attempt, resumed_at=resumed)
            if resumed is None:
                _say(num_update=int(step._num_update), loss=float(loss),
                     wall=time.time())
                mgr.maybe_save()
            while step._num_update < args.target_step \
                    and not gexit.requested:
                loss = run(step._num_update)
                _say(num_update=int(step._num_update), loss=float(loss),
                     wall=time.time())
                mgr.maybe_save()
                if args.step_sleep and not gexit.requested:
                    time.sleep(args.step_sleep)
            if gexit.requested and hb is not None:
                hb.beat(int(step._num_update), phase="snapshot")
            # the last state always lands: wait out a write in flight
            # (which would make this save skip), then save and drain
            mgr.wait_until_finished()
            if mgr.latest_step() != step._num_update:
                mgr.save()
            if not parallel.checkpoint.flush_pending(timeout=600):
                raise RuntimeError("snapshot writes did not drain")
            mgr.close()
            if mgr.write_errors:
                raise RuntimeError(f"snapshot writes failed: "
                                   f"{mgr.write_errors}")
        except elastic.NonFiniteAbortError as exc:
            _say(nonfinite=str(exc))
            return elastic.EXIT_NONFINITE
        if gexit.requested:
            end(preempted_at=int(step._num_update))
            return elastic.EXIT_PREEMPTED
    if hb is not None:
        hb.beat(int(step._num_update), phase="exit")
    end(reached=int(step._num_update))
    return 0


if __name__ == "__main__":
    sys.exit(main())
