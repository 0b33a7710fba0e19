#!/usr/bin/env python3
"""bf16 ResNet-50 v1 training losses per step, three routes side by side.

    python3 resnet_loss_routes.py

Runs ``chip_smoke.py``'s ResNet training loop (batch 256 of
``RandomState(0)`` inputs, bf16 cast with f32 master weights, SGD 0.1 /
0.9 / 1e-4, WARMUP_STEPS + TIMED_STEPS steps on the same batch) from the
same parameters four times on the first CUDA device: the fused net
through the fused-conv kernels, the fused net through the kernels' plain
versions twice, and the unfused net (cuDNN convs).  The two plain runs
are the same code on the same inputs; cuDNN's f32 sums inside the plain
versions need not repeat their order, so their gap shows how far
rounding alone moves the trajectory.  A kernel route that parts from the
plain ones by far more than they part from each other points at the
kernels.  Prints each route's losses and the relative gaps per step;
fails if a loss is not finite or a route did not take the convs it
names.  Needs one card and the package beside it.
"""
from __future__ import annotations

import os
import sys

import numpy as np


def route_losses(torch, cs, net, plain_bodies):
    """The loss of every step of chip_smoke's training loop on ``net``,
    with the kernels' plain versions swapped in if ``plain_bodies``, and
    the fused-conv kernel launches the run made."""
    from mxnet_tpu_torch import gluon, optimizer, parallel
    from mxnet_tpu_torch.ops import fused_conv as fc

    opt = optimizer.create("sgd", learning_rate=0.1, momentum=0.9, wd=1e-4)
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              opt)
    rng = np.random.RandomState(0)
    xh = rng.randn(cs.TRAIN_BATCH, 224, 224, 3).astype(np.float32)
    yh = rng.randint(0, 1000, (cs.TRAIN_BATCH,)).astype(np.int32)
    x = torch.from_numpy(xh).to(cs.DEVICE).to(torch.bfloat16)
    y = torch.from_numpy(yh).to(cs.DEVICE)
    before = dict(fc.norm_relu_conv.launches)
    if plain_bodies:
        with cs.plain_versions(fc):
            losses = [float(step(x, y))
                      for _ in range(cs.WARMUP_STEPS + cs.TIMED_STEPS)]
    else:
        losses = [float(step(x, y))
                  for _ in range(cs.WARMUP_STEPS + cs.TIMED_STEPS)]
    launches = sum(fc.norm_relu_conv.launches[k] - before[k]
                   for k in cs.FUSED)
    cs.expect(all(np.isfinite(losses)), f"loss not finite {losses}")
    return losses, launches


def nets(torch, cs, fused_copies):
    """``fused_copies`` fused resnet50_v1 and the unfused one, all with
    the first fused net's seeded parameters (mapped into the unfused
    layout), cast to bf16 as chip_smoke's training run casts them."""
    fused = [cs.build_resnet50(torch, fused=True)
             for _ in range(fused_copies)]
    for net in fused[1:]:
        for p, q in zip(fused[0].collect_params().values(),
                        net.collect_params().values()):
            q.set_data(p.data())
    unfused = cs.build_resnet50(torch, fused=False)
    for f, u, perm in cs.fused_pairs(fused[0], unfused):
        u.set_data(f.tensor() if perm is None else f.tensor().permute(3, 0, 1, 2))
    return [n.cast("bfloat16") for n in fused], unfused.cast("bfloat16")


def gaps(a, b):
    return [round(abs(x - y) / max(abs(y), 1e-6), 4) for x, y in zip(a, b)]


def main():
    try:
        import torch
    except ImportError:
        print("resnet_loss_routes: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("resnet_loss_routes: no CUDA device — this run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs

    try:
        cs.build_kernels()
        (kernel_net, *plain_nets), unfused_net = nets(torch, cs, 3)
        kernels, launched = route_losses(torch, cs, kernel_net, False)
        cs.expect(launched > 0, "the kernel route launched no kernel")
        plain = []
        for net in plain_nets:
            losses, launched = route_losses(torch, cs, net, True)
            cs.expect(launched == 0, "a plain-version route launched a kernel")
            plain.append(losses)
        unfused, launched = route_losses(torch, cs, unfused_net, False)
        cs.expect(launched == 0, "the unfused net launched a fused kernel")
    except cs.SmokeError as exc:
        print(f"resnet_loss_routes: FAILED: {exc}", file=sys.stderr)
        return 1
    print(f"losses per step: fused through the kernels "
          f"{[round(v, 4) for v in kernels]}; through the plain versions "
          f"{[round(v, 4) for v in plain[0]]} and "
          f"{[round(v, 4) for v in plain[1]]}; unfused "
          f"{[round(v, 4) for v in unfused]}")
    print(f"relative gap per step: plain versions run 1 vs run 2 "
          f"{gaps(plain[0], plain[1])}; kernels vs plain versions "
          f"{gaps(kernels, plain[0])} and {gaps(kernels, plain[1])}; "
          f"kernels vs unfused {gaps(kernels, unfused)}; plain versions vs "
          f"unfused {gaps(plain[0], unfused)} and {gaps(plain[1], unfused)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
