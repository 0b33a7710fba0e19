#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one card.

    python3 chip_smoke.py

Drives the port's two paths end to end on the first CUDA device, with
random weights from a seed:

- LLM serving at the width of ``bench.py llm`` on an accelerator (vocab
  4096, 4 layers, 8 heads x 64, d_ff 2048; 64 slots, 512 pages x 64
  tokens; buckets (1, 2, 4) x (32, 64); 64 new tokens; prompts of 4-60
  tokens);
- the ResNet-50 v1 training step as ``bench.py``'s ``bench_resnet`` runs
  it (NHWC, ``fused=True``, bf16 cast with f32 master weights, SGD 0.1 /
  0.9 / 1e-4, batch 256 of 224x224x3, 1000 classes), full width and
  depth.

Phases, each of which fails the run:

1. card report (name, count, ``nvidia-smi`` name and power limit);
2. build every CUDA kernel from the sources in the checkout (one
   ``nvcc`` per source, all started together);
3. serving: the paged attention kernel against its plain version; the
   decode forward with the kernel against the plain one; a
   ``GenerationServer`` answers 256 greedy requests (tokens checked
   against a teacher-forced full forward, launches against decode steps
   x layers); the kernel timed beside its bound; a shorter serve under
   ``torch.profiler``;
4. training: each fused-conv kernel (forward, dX, dW) against its plain
   version at the eight ResNet-50 shapes (N = 8) and the other cases
   the op takes, in f32 and bf16;
5. full-width ResNet-50 (f32, batch 8): forward and backward through
   the kernels against the same through the plain versions on the
   card, from the same parameters — loss, every gradient, running
   statistics — leaf by leaf, within a multiple of the noise floor that
   the plain versions on the card show against the same net on the
   host CPU;
6. the training run: warm-up and timed steps at batch 256 (loss finite
   and falling over the run, params finite, 32 launches of each kernel
   per step), then the same with ``fused=False`` (cuDNN convs) from the
   same parameters as the yardstick (the two first losses agree);
7. each fused-conv kernel at the eight shapes at N = 256, bf16: held
   against its plain version, then timed (CUDA events, L2 flushed)
   beside its bound, its plain version and the cuDNN call for the conv
   alone; summed over a step's 32 launches;
8. one training step under ``torch.profiler``.

Prints one JSON ``kernels`` line, then the card line, then as the last
line ``{"ok": true, "device": {...}}``.  Without a card, or without the
package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# the card's published peaks (H100 SXM, NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

VOCAB, LAYERS, HEADS, HEAD_DIM, D_FF = 4096, 4, 8, 64, 2048
SLOTS, N_PAGES, PAGE_SIZE, MAX_NEW = 64, 512, 64, 64
BATCH_BUCKETS, LENGTH_BUCKETS = (1, 2, 4), (32, 64)
N_REQUESTS = 256
ATOL, RTOL = 1e-5, 1e-4          # kernel vs plain, f32
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
REPLACES = {"paged_decode_attention":
            "mxnet_tpu/ops/pallas/paged_attention.py:31",
            "fused_conv_fwd": "mxnet_tpu/ops/pallas/fused_conv.py:100",
            "fused_conv_dx": "mxnet_tpu/ops/pallas/fused_conv.py:164",
            "fused_conv_dw": "mxnet_tpu/ops/pallas/fused_conv.py:281"}
SOURCES = {"paged_decode_attention":
           "mxnet_tpu_torch/ops/cuda/paged_attention.cu",
           "fused_conv_fwd": "mxnet_tpu_torch/ops/cuda/fused_conv.cu",
           "fused_conv_dx": "mxnet_tpu_torch/ops/cuda/fused_conv.cu",
           "fused_conv_dw": "mxnet_tpu_torch/ops/cuda/fused_conv.cu"}

# ResNet-50 v1 training (bench.py bench_resnet's settings), on the card
DEVICE = "cuda"
TRAIN_BATCH, CHECK_BATCH, KERNEL_CHECK_BATCH = 256, 8, 8
WARMUP_STEPS, TIMED_STEPS = 2, 5
FUSED = ("fwd", "dx", "dw")
# per stage: (bottleneck blocks, spatial size of the fused convs, C/4, C)
RESNET50_STAGES = ((3, 56, 64, 256), (4, 28, 128, 512), (6, 14, 256, 1024),
                   (3, 7, 512, 2048))
FUSED_PER_STEP = sum(2 * blocks for blocks, *_ in RESNET50_STAGES)  # 32
# kernel vs plain: both sum the same f32 products in another order, so
# f32 results agree to ~1e-5 of their scale; a result stored in bf16
# can then round to the neighbouring bf16 value (2**-8 relative), so
# bf16 outputs get 2**-6
F32_RTOL, BF16_RTOL = 1e-4, 2 ** -6
# model check: kernel route vs plain route, per leaf, in units of the
# plain-on-card vs plain-on-host noise floor (floors under a few f32
# ulps are raised to MODEL_MIN_FLOOR)
MODEL_FLOOR_FACTOR, MODEL_MIN_FLOOR = 3.0, 1e-6


def log(msg):
    print(msg, flush=True)


class SmokeError(RuntimeError):
    pass


def expect(cond, msg):
    if not cond:
        raise SmokeError(msg)


# ------------------------------------------------------------------ inputs --
def paged_inputs(torch, rng, slots, pages_per_seq, lengths):
    """q, pools with exactly the pages the slots need (+ sink), tables
    of distinct random pages, int32 lengths — on the card."""
    n_pages = 1 + slots * pages_per_seq
    q = rng.standard_normal((slots, HEADS, HEAD_DIM), dtype=np.float32)
    kp = rng.standard_normal((n_pages, PAGE_SIZE, HEADS, HEAD_DIM),
                             dtype=np.float32)
    vp = rng.standard_normal((n_pages, PAGE_SIZE, HEADS, HEAD_DIM),
                             dtype=np.float32)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    tables = perm.reshape(slots, pages_per_seq)
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(x).to(dev) for x in
                 (q, kp, vp, tables, np.asarray(lengths, np.int32)))


def serving_lengths(rng, slots):
    """Context lengths as the serving mix gives them: a prompt of 4-60
    tokens plus 0-63 generated, plus the token being decoded."""
    return rng.integers(4, 60, slots) + rng.integers(0, MAX_NEW, slots) + 1


def attention_bound(lengths, slots, pages_per_seq):
    """Least time for one call on this card: each valid K/V row read
    once, q/tables/lengths read and the output written once; the
    operations are 4 flops per K/V element pair (q.k and p.v)."""
    ctx = pages_per_seq * PAGE_SIZE
    valid = int(np.minimum(np.maximum(lengths, 0), ctx).sum())
    row = HEADS * HEAD_DIM
    nbytes = (valid * row * 4 * 2 + 2 * slots * row * 4
              + slots * pages_per_seq * 4 + slots * 4)
    flops = 4 * valid * row
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters, flush):
    """Mean device time of ``fn()`` by CUDA events, the L2 cache
    overwritten before every launch (the decode path finds its pages
    cold: four layers of pages exceed the 50 MB L2).  The overwrite is
    large enough to keep the card busy while the host enqueues the
    launch, so host launch overhead stays out of the measured span."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in zip(starts, ends)]))


# ------------------------------------------------------------------ phases --
def card_report(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"card: {name} x{count}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    expect(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0].strip()
    return name, count, smi_line


def build_kernels():
    from mxnet_tpu_torch.ops import cuda as kcuda

    t0 = time.perf_counter()
    libs = kcuda.build_all()
    dt = time.perf_counter() - t0
    log(f"build: {sorted(libs)} in {dt:.2f} s")
    return dt


def kernel_vs_plain(torch, rng):
    from mxnet_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    worst = 0.0
    P = -(-(max(LENGTH_BUCKETS) + MAX_NEW) // PAGE_SIZE)
    cases = {
        "path": (P, np.concatenate([
            [0, 1, PAGE_SIZE - 1, PAGE_SIZE, PAGE_SIZE + 1, P * PAGE_SIZE],
            serving_lengths(rng, SLOTS - 6)])),
        "long": (32, np.concatenate([
            [0, 1, PAGE_SIZE, PAGE_SIZE + 1, 32 * PAGE_SIZE - 1,
             32 * PAGE_SIZE],
            rng.integers(1, 32 * PAGE_SIZE + 1, SLOTS - 6)])),
    }
    for label, (pps, lengths) in cases.items():
        q, kp, vp, tables, lens = paged_inputs(torch, rng, SLOTS, pps,
                                               lengths)
        out = paged_decode_attention(q, kp, vp, tables, lens)
        ref = paged_decode_attention_reference(q, kp, vp, tables, lens)
        torch.cuda.synchronize()
        act = lens > 0
        expect(bool(torch.isfinite(out).all()), f"{label}: non-finite")
        expect(bool((out[~act] == 0).all()),
               f"{label}: a length-0 slot is not zero")
        err = (out[act] - ref[act]).abs()
        tol = ATOL + RTOL * ref[act].abs()
        max_err = float(err.max())
        worst = max(worst, max_err)
        log(f"kernel vs plain [{label}: pages_per_seq {pps}, lengths "
            f"{int(lens.min())}..{int(lens.max())}]: max abs err "
            f"{max_err:.3e} (atol {ATOL}, rtol {RTOL})")
        expect(bool((err <= tol).all()),
               f"{label}: kernel disagrees with its plain version")
    return worst


def decode_parity(torch, rng, params, cfg):
    from mxnet_tpu_torch.ops.paged_attention import \
        paged_decode_attention_reference
    from mxnet_tpu_torch.serving.generate import decode_logits

    dev = torch.device("cuda")
    P = -(-(max(LENGTH_BUCKETS) + MAX_NEW) // PAGE_SIZE)
    shape = (LAYERS, N_PAGES, PAGE_SIZE, HEADS, HEAD_DIM)
    gen = torch.Generator(device=dev).manual_seed(1)
    k_pool = 0.5 * torch.randn(shape, device=dev, generator=gen)
    v_pool = 0.5 * torch.randn(shape, device=dev, generator=gen)
    lengths = np.minimum(serving_lengths(rng, SLOTS) - 1, P * PAGE_SIZE - 1)
    active = rng.random(SLOTS) < 0.9
    perm = rng.permutation(np.arange(1, N_PAGES))[:SLOTS * P]
    tables = perm.reshape(SLOTS, P).astype(np.int32)
    tokens = rng.integers(0, VOCAB, SLOTS)
    args = [torch.from_numpy(np.asarray(x)).to(dev) for x in
            (tokens.astype(np.int32), lengths.astype(np.int32), active,
             tables)]
    outs = {}
    for label, attn in (("kernel", None),
                        ("plain", paged_decode_attention_reference)):
        kc, vc = k_pool.clone(), v_pool.clone()
        with torch.no_grad():
            logits = decode_logits(params, cfg, PAGE_SIZE, kc, vc, *args,
                                   attention=attn)
        outs[label] = (logits, kc, vc)
    torch.cuda.synchronize()
    act = torch.from_numpy(active).to(dev)
    lk, lp = outs["kernel"][0][act], outs["plain"][0][act]
    err = float((lk - lp).abs().max())
    log(f"decode forward, kernel vs plain ({int(active.sum())} active of "
        f"{SLOTS} slots): max abs logit err {err:.3e} "
        f"(atol {LOGIT_ATOL}, rtol {LOGIT_RTOL})")
    expect(bool(torch.allclose(lk, lp, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)),
           "decode logits: kernel path disagrees with plain path")
    expect(bool(torch.isfinite(outs["kernel"][0]).all()),
           "decode logits not finite")
    # page 0 is the sink: inactive slots write there whatever their
    # (ignored) attention rows hold, and those rows legitimately differ
    for i in (1, 2):
        expect(bool(torch.allclose(outs["kernel"][i][:, 1:],
                                   outs["plain"][i][:, 1:],
                                   atol=LOGIT_ATOL, rtol=LOGIT_RTOL)),
               "decode K/V pool writes disagree")
    return err


def serve(torch, params, cfg):
    from mxnet_tpu_torch.gluon.model_zoo.causal_lm import sequence_logits
    from mxnet_tpu_torch.ops.paged_attention import paged_decode_attention
    from mxnet_tpu_torch.serving import BucketSpec, GenerationServer

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, VOCAB, size=int(rng.randint(4, 60)))
               .astype(np.int32) for _ in range(N_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged_decode_attention.launches = 0          # main path starts here
    srv = GenerationServer(
        params, cfg, buckets=BucketSpec(batch=BATCH_BUCKETS,
                                        length=LENGTH_BUCKETS),
        n_slots=SLOTS, n_pages=N_PAGES, page_size=PAGE_SIZE,
        max_new_tokens=MAX_NEW, max_queue=N_REQUESTS, seed=0,
        device="cuda", name="ChipSmokeGen")
    t_start = time.perf_counter()
    srv.start()
    t_ready = time.perf_counter()
    try:
        t0 = time.perf_counter()
        reqs = [srv.submit(p) for p in prompts]
        outs = [r.result(timeout=600) for r in reqs]
        dt = time.perf_counter() - t0
    finally:
        expect(srv.drain(60), "server did not drain")
    launches = paged_decode_attention.launches   # ... and ends here
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    st = srv.stats
    n_tok = sum(len(o) for o in outs)
    expect(all(len(o) == MAX_NEW for o in outs),
           "a request resolved with the wrong token count")
    expect(all(o.min() >= 0 and o.max() < VOCAB for o in outs),
           "token ids out of range")
    expect(st["completed"] == N_REQUESTS and st["failed"] == 0,
           f"server stats {st}")
    expect(launches >= st["decode_steps"] * LAYERS > 0,
           f"kernel launches {launches} < decode steps "
           f"{st['decode_steps']} x {LAYERS} layers")
    log(f"serve: {N_REQUESTS} requests, {n_tok} tokens in {dt:.3f} s = "
        f"{n_tok / dt:.1f} tokens/s; warmup {t_ready - t_start:.3f} s; "
        f"decode steps {st['decode_steps']}, prefills {st['prefills']}, "
        f"preempted {st['preempted']}; kernel launches {launches}; peak "
        f"device memory {peak / 2**20:.1f} MiB")
    # teacher-forced check: every generated token is the argmax of the
    # full forward (plain PyTorch, no kernel) over prompt + output so
    # far, up to a near-tie of 1e-4 between two logits
    worst_gap, exact, total = 0.0, 0, 0
    for p, o in zip(prompts[:16], outs[:16]):
        full = np.concatenate([p, o])
        toks = torch.from_numpy(full[None].astype(np.int32)).cuda()
        with torch.no_grad():
            lg = sequence_logits(params, cfg, toks)[0]
        rows = lg[len(p) - 1:len(full) - 1]
        chosen = rows.gather(1, torch.from_numpy(o.astype(np.int64))
                             .cuda()[:, None])[:, 0]
        gap = float((rows.max(dim=1).values - chosen).max())
        worst_gap = max(worst_gap, gap)
        exact += int((rows.argmax(dim=1).cpu().numpy() == o).sum())
        total += len(o)
    log(f"teacher-forced check of 16 requests: {exact}/{total} tokens are "
        f"the exact argmax, worst logit shortfall {worst_gap:.3e}")
    expect(worst_gap <= 1e-4, "served tokens disagree with the full forward")
    return {"tokens_per_s": n_tok / dt, "decode_steps": st["decode_steps"],
            "launches": launches, "peak_bytes": peak}


def time_kernel(torch, rng):
    from mxnet_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    P = -(-(max(LENGTH_BUCKETS) + MAX_NEW) // PAGE_SIZE)
    flush = torch.empty(1024 * 2**20, dtype=torch.uint8, device="cuda")
    res = {}
    for label, pps, lengths in (
            ("path", P, serving_lengths(rng, SLOTS)),
            ("long", 32, rng.integers(1, 32 * PAGE_SIZE + 1, SLOTS))):
        q, kp, vp, tables, lens = paged_inputs(torch, rng, SLOTS, pps,
                                               lengths)
        before = paged_decode_attention.launches
        ms = time_ms(torch, lambda: paged_decode_attention(
            q, kp, vp, tables, lens), 200, flush)
        plain_ms = time_ms(torch, lambda: paged_decode_attention_reference(
            q, kp, vp, tables, lens), 50, flush)
        paged_decode_attention.launches = before   # timing is not the path
        bound_ms, bound_by = attention_bound(lengths, SLOTS, pps)
        log(f"time [{label}: {SLOTS} slots, pages_per_seq {pps}, "
            f"{int(np.sum(lengths))} context tokens]: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), kernel at {100 * bound_ms / ms:.1f}% of bound")
        res[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by}
    log("library: no single PyTorch call computes paged attention over a "
        "page table (SDPA needs the pages gathered first), so library_ms "
        "is null")
    return res


def profile_serving(torch, params, cfg, n_requests=64):
    """Serve ``n_requests`` more under ``torch.profiler`` and print
    where the time goes — wall time per
    decode step, the device's busy and idle share (kernel time summed
    over the wall time), and the kernels that take the most device
    time."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.serving import BucketSpec, GenerationServer

    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, VOCAB, size=int(rng.randint(4, 60)))
               .astype(np.int32) for _ in range(n_requests)]
    srv = GenerationServer(
        params, cfg, buckets=BucketSpec(batch=BATCH_BUCKETS,
                                        length=LENGTH_BUCKETS),
        n_slots=SLOTS, n_pages=N_PAGES, page_size=PAGE_SIZE,
        max_new_tokens=MAX_NEW, max_queue=n_requests, seed=1,
        device="cuda", name="ChipSmokeProfile").start()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for r in [srv.submit(p) for p in prompts]:
                r.result(timeout=600)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        expect(srv.drain(60), "profiled server did not drain")
    st = srv.stats
    log(f"profile: {n_requests} requests, {st['decode_steps']} decode "
        f"steps, {st['prefills']} prefills in {wall_us / 1e3:.3f} ms = "
        f"{wall_us / 1e3 / max(st['decode_steps'], 1):.3f} ms wall per "
        f"decode step")
    print_profile(prof, wall_us, "serving")


def print_profile(prof, wall_us, what):
    """The device's busy and idle share of ``wall_us`` (the time of the
    device's own events — kernels and copies — summed; the host ops that
    launched them are left out, or their device time would count twice)
    and the 12 that take the most device time."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in rows)
    expect(busy_us > 0, "the profiler saw no device time")
    log(f"profile [{what}]: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms = {100 * busy_us / wall_us:.1f}% of wall, "
        f"idle {100 - 100 * busy_us / wall_us:.1f}%")
    for e in sorted(rows, key=dev_us, reverse=True)[:12]:
        log(f"profile:   {dev_us(e) / 1e3:9.3f} ms  "
            f"{100 * dev_us(e) / busy_us:5.1f}%  x{e.count:<6d} "
            f"{e.key[:90]}")


# ---------------------------------------------------------------- training --
def path_shapes():
    """The fused convs of ResNet-50 v1: per stage, the 3x3 C/4 -> C/4
    (f2) and the closing 1x1 C/4 -> C (f3) of each bottleneck, stride 1.
    Yields ``(label, blocks, hw, ci, co, k)``."""
    for i, (blocks, hw, c4, c) in enumerate(RESNET50_STAGES, 1):
        yield f"s{i} 3x3 {c4}->{c4} @{hw}", blocks, hw, c4, c4, 3
        yield f"s{i} 1x1 {c4}->{c} @{hw}", blocks, hw, c4, c, 1


def fused_inputs(torch, gen, n, h, ci, co, k, dtype, res=False, stride=1):
    """x, scale, shift, w (He-scaled), residual or None, dO on the card."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)
    x = randn(n, h, h, ci).to(dtype)
    scale = torch.rand(ci, generator=gen, device=DEVICE) + 0.5
    shift = 0.1 * randn(ci)
    w = (randn(k, k, ci, co) * (2.0 / (k * k * ci)) ** 0.5).to(dtype)
    r = randn(n, h, h, ci).to(dtype) if res else None
    ho = -(-h // stride)
    return x, scale, shift, w, r, randn(n, ho, ho, co).to(dtype)


def fused_bodies(fc, plain, x, sc, sh, w, r, do, k, relu, stride):
    """{kernel: [outputs]} of the three kernels, or of their plain
    versions."""
    fwd, dx, dw = fc._BODIES[plain]
    return {"fwd": [fwd(x, sc, sh, w, r, relu, stride)],
            "dx": list(dx(x, sc, sh, w, r, do, relu, stride)),
            "dw": [dw(x, sc, sh, r, do, k, relu, stride)]}


def check_outputs(torch, what, kern, got, want):
    """Hold a kernel's outputs against its plain version's: same shapes
    and types, finite, each element within F32_RTOL / BF16_RTOL of the
    output's largest magnitude plus its own.  Returns the max abs err."""
    worst = 0.0
    for a, b in zip(got, want):
        if b is None:
            expect(a is None, f"{what}: {kern} gave a dres")
            continue
        expect(a.shape == b.shape and a.dtype == b.dtype,
               f"{what}: {kern} output {tuple(a.shape)} {a.dtype} vs "
               f"{tuple(b.shape)} {b.dtype}")
        rtol = BF16_RTOL if b.dtype == torch.bfloat16 else F32_RTOL
        af, bf = a.float(), b.float()
        err = (af - bf).abs()
        ok = bool((err <= rtol * (bf.abs().max() + bf.abs())).all())
        expect(bool(torch.isfinite(af).all()) and ok,
               f"{what}: {kern} kernel disagrees with its plain version "
               f"(max abs err {float(err.max()):.3e})")
        worst = max(worst, float(err.max()))
    return worst


def fused_vs_plain(torch):
    """Every fused-conv kernel against its plain version: the eight
    ResNet-50 shapes at N = 8, then stride 2 at H = 8 and 9, the
    residual without relu, Co = 192; f32 and bf16."""
    from mxnet_tpu_torch.context import resolve_device
    from mxnet_tpu_torch.ops import fused_conv as fc

    resolve_device(DEVICE)          # f32 convs of the plain versions: no TF32
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    cases = [(label, KERNEL_CHECK_BATCH, hw, ci, co, k, 1, False, True)
             for label, _, hw, ci, co, k in path_shapes()]
    cases += [("3x3 stride 2 @8", 2, 8, 8, 16, 3, 2, False, True),
              ("3x3 stride 2 @9", 2, 9, 8, 16, 3, 2, False, True),
              ("1x1 stride 2 @9", 2, 9, 8, 16, 1, 2, False, True),
              ("3x3 residual, no relu @8", 2, 8, 8, 16, 3, 1, True, False),
              ("1x1 residual @7", 2, 7, 24, 40, 1, 1, True, True),
              ("3x3 Co=192 @4", 2, 4, 8, 192, 3, 1, False, True)]
    before = dict(fc.norm_relu_conv.launches)
    for dtype in (torch.float32, torch.bfloat16):
        for label, n, h, ci, co, k, stride, res, relu in cases:
            x, sc, sh, w, r, do = fused_inputs(torch, gen, n, h, ci, co, k,
                                               dtype, res, stride)
            got = fused_bodies(fc, False, x, sc, sh, w, r, do, k, relu,
                               stride)
            want = fused_bodies(fc, True, x, sc, sh, w, r, do, k, relu,
                                stride)
            torch.cuda.synchronize()
            what = f"{label}, N={n}, {str(dtype).split('.')[1]}"
            err = max(check_outputs(torch, what, kern, got[kern], want[kern])
                      for kern in FUSED)
            log(f"fused conv vs plain [{what}]: max abs err {err:.3e}")
    fc.norm_relu_conv.launches = before       # comparisons are not the path
    log(f"fused conv kernels agree with their plain versions (rtol f32 "
        f"{F32_RTOL}, bf16 {BF16_RTOL} of each output's scale)")


def build_resnet50(torch, fused, dtype=None, device=DEVICE):
    """resnet50_v1(layout="NHWC") on ``device``, seeded, its deferred
    shapes sized by a batch-1 forward."""
    from mxnet_tpu_torch import autograd, initializer
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    initializer.seed(0)
    net = resnet50_v1(layout="NHWC", fused=fused)
    net.initialize(ctx=device)
    if dtype is not None:
        net.cast(dtype)
    x = torch.zeros((1, 224, 224, 3), device=device,
                    dtype=getattr(torch, dtype or "float32"))
    with autograd.pause():
        net(x)
    return net


def fused_pairs(fused, plain):
    """How the fused ResNet-50's parameters sit in the unfused one:
    ``[(fused param, unfused param, permutation to the fused layout)]``
    (the NHWC Conv2D weight is OHWI, NormReluConv2D's HWIO)."""
    pairs = []

    def bn(f, u):
        for name in ("gamma", "beta", "running_mean", "running_var"):
            pairs.append((getattr(f, name), getattr(u, name), None))

    for st in range(4, 8):
        for fb, pb in zip(fused.features[st], plain.features[st]):
            body = pb.body
            pairs.append((fb.conv1.weight, body[0].weight, None))
            bn(fb.f2, body[1])
            pairs.append((fb.f2.weight, body[3].weight, (1, 2, 3, 0)))
            bn(fb.f3, body[4])
            pairs.append((fb.f3.weight, body[6].weight, (1, 2, 3, 0)))
            bn(fb.bn3, body[7])
            if pb.downsample is not None:
                pairs.append((fb.downsample[0].weight,
                              pb.downsample[0].weight, None))
                bn(fb.downsample[1], pb.downsample[1])
    pairs.append((fused.features[0].weight, plain.features[0].weight, None))
    bn(fused.features[1], plain.features[1])
    pairs += [(fused.output.weight, plain.output.weight, None),
              (fused.output.bias, plain.output.bias, None)]
    expect(len(pairs) == len(fused.collect_params()),
           "fused_pairs: a fused parameter has no unfused counterpart")
    return pairs


def forward_backward(torch, net, x, y):
    """One training forward and backward: the loss, then per parameter in
    ``collect_params`` order its gradient (trainable) or its value after
    the step (running statistics), all on the host in f64."""
    from mxnet_tpu_torch import autograd, gluon

    params = list(net.collect_params().values())
    train = [p for p in params if p.grad_req != "null"]
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y).mean()
    grads = dict(zip(map(id, train), torch.autograd.grad(
        loss, [p.data() for p in train])))
    leaves = [loss.detach()] + [grads.get(id(p), p.data().detach())
                                for p in params]
    return [t.double().cpu() for t in leaves]


def model_check(torch):
    """Full-width fused ResNet-50 in f32: one training forward and
    backward through the kernels, held leaf by leaf against the same
    through their plain versions on the card, from the same parameters
    and batch — the loss, every gradient, every running statistic.

    The gradients of this randomly initialised net carry f32 rounding
    noise of a few percent (relative L2) whatever computes them, so each
    leaf's limit comes from a noise floor: the plain versions on the
    card against the same net on the host CPU (plain versions again,
    other conv libraries and summation orders).  A leaf's relative L2
    error, kernels against plain, may be at most MODEL_FLOOR_FACTOR
    times the larger of its own floor, the median floor of its kind and
    MODEL_MIN_FLOOR.  The max-abs error over the leaf's largest
    magnitude is printed beside it."""
    from mxnet_tpu_torch.ops import fused_conv as fc

    fused = build_resnet50(torch, fused=True)
    host = build_resnet50(torch, fused=True, device="cpu")
    params = list(fused.collect_params().items())
    for (_, p), q in zip(params, host.collect_params().values()):
        q.set_data(p.data().detach().cpu())
    start = {n: p.data().detach().clone() for n, p in params
             if p.grad_req == "null"}
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(CHECK_BATCH, 224, 224, 3)
                         .astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, CHECK_BATCH))
    xd, yd = x.to(DEVICE), y.to(DEVICE)
    before = dict(fc.norm_relu_conv.launches)
    kernel = forward_backward(torch, fused, xd, yd)
    launched = {k: fc.norm_relu_conv.launches[k] - before[k] for k in FUSED}
    expect(launched == dict.fromkeys(FUSED, FUSED_PER_STEP),
           f"model check: kernel launches {launched}, expected "
           f"{FUSED_PER_STEP} each")
    for n, p in params:                 # the kernel run updated them
        if p.grad_req == "null":
            p.set_data(start[n])
    cuda_bodies = fc._BODIES[False]
    fc._BODIES[False] = fc._BODIES[True]  # CUDA tensors: plain versions
    try:
        plain = forward_backward(torch, fused, xd, yd)
    finally:
        fc._BODIES[False] = cuda_bodies
    on_host = forward_backward(torch, host, x, y)
    launched = {k: fc.norm_relu_conv.launches[k] - before[k] for k in FUSED}
    fc.norm_relu_conv.launches = before
    expect(launched == dict.fromkeys(FUSED, FUSED_PER_STEP),
           f"model check: the plain routes launched kernels ({launched})")

    def errs(a, b):
        """relative L2 error of a against b, and max abs error over b's
        largest magnitude"""
        d = a - b
        return (float(d.norm() / b.norm().clamp_min(1e-300)),
                float(d.abs().max() / b.abs().max().clamp_min(1e-300)))

    rows = {"loss": [], "gradient": [], "running statistic": []}
    names = [("loss", "loss")] + [
        (n, "gradient" if p.grad_req != "null" else "running statistic")
        for n, p in params]
    for (n, kind), k, pl, h in zip(names, kernel, plain, on_host):
        expect(bool(torch.isfinite(k).all()),
               f"model check: the kernel route's {n} is not finite")
        rows[kind].append((n,) + errs(k, pl) + errs(pl, h))
    log(f"model check: loss kernel {float(kernel[0]):.7f}, plain "
        f"{float(plain[0]):.7f}, host {float(on_host[0]):.7f}")
    bad = []
    for kind, rs in rows.items():
        floor = float(np.median([r[3] for r in rs]))
        ratio = [(r[1] / max(r[3], floor, MODEL_MIN_FLOOR), r[0]) for r in rs]
        worst = max(rs, key=lambda r: r[1])
        worst_max = max(rs, key=lambda r: r[2])
        log(f"model check [{kind}: {len(rs)}, resnet50_v1 f32, batch "
            f"{CHECK_BATCH}]: relative L2 error kernel vs plain median "
            f"{np.median([r[1] for r in rs]):.3e}, worst {worst[1]:.3e} "
            f"({worst[0]}); floor plain vs host median {floor:.3e}, worst "
            f"{max(r[3] for r in rs):.3e}; worst error/floor "
            f"{max(ratio)[0]:.3f} ({max(ratio)[1]}); max abs error over "
            f"scale, kernel vs plain worst {worst_max[2]:.3e} "
            f"({worst_max[0]}), plain vs host worst "
            f"{max(r[4] for r in rs):.3e}")
        bad += [f"{name} {r:.2f}" for r, name in ratio
                if r > MODEL_FLOOR_FACTOR]
    expect(not bad, f"model check: kernel route beyond {MODEL_FLOOR_FACTOR}x "
           f"the noise floor: {bad[:8]}")


def training_nets(torch):
    """The fused and the unfused resnet50_v1 with the same parameters
    (the fused net's, seeded, mapped into the unfused layout), both cast
    to bf16 as ``bench_resnet`` casts them."""
    fused = build_resnet50(torch, fused=True)
    plain = build_resnet50(torch, fused=False)
    for f, u, perm in fused_pairs(fused, plain):
        u.set_data(f.data() if perm is None else f.data().permute(3, 0, 1, 2))
    return fused.cast("bfloat16"), plain.cast("bfloat16")


def train_run(torch, net, fused, steps):
    """bench_resnet's loop on the card: batch 256 of RandomState(0)
    inputs, bf16, SGD 0.1/0.9/1e-4, WARMUP_STEPS then ``steps`` timed
    steps on the same batch.  Returns the numbers and the step."""
    from mxnet_tpu_torch import gluon, optimizer, parallel
    from mxnet_tpu_torch.ops.fused_conv import norm_relu_conv

    opt = optimizer.create("sgd", learning_rate=0.1, momentum=0.9, wd=1e-4)
    step = parallel.TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              opt)
    rng = np.random.RandomState(0)
    xh = rng.randn(TRAIN_BATCH, 224, 224, 3).astype(np.float32)
    yh = rng.randint(0, 1000, (TRAIN_BATCH,)).astype(np.int32)
    x = torch.from_numpy(xh).to(DEVICE).to(torch.bfloat16)
    y = torch.from_numpy(yh).to(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    norm_relu_conv.launches = dict.fromkeys(FUSED, 0)  # main path starts
    losses = [float(step(x, y)) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [step(x, y) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(norm_relu_conv.launches)           # ... and ends here
    losses += [float(v) for v in timed]
    peak = torch.cuda.max_memory_allocated()
    name = "fused" if fused else "unfused"
    expect(all(np.isfinite(losses)), f"{name}: loss not finite {losses}")
    # the loss falls over the run; with momentum 0.9 at lr 0.1 on one
    # repeated batch it overshoots and rises again within a few steps,
    # so a fall across the timed steps alone is not guaranteed
    expect(losses[-1] < losses[0] and min(losses) < losses[0],
           f"{name}: loss did not fall over the run {losses}")
    expect(all(bool(torch.isfinite(t).all()) for t in step._train),
           f"{name}: a parameter is not finite")
    want = FUSED_PER_STEP * (WARMUP_STEPS + steps) if fused else 0
    expect(launches == dict.fromkeys(FUSED, want),
           f"{name}: kernel launches {launches}, expected {want} each")
    img_s = TRAIN_BATCH * steps / dt
    log(f"train [{name} resnet50_v1, bf16, batch {TRAIN_BATCH}]: losses "
        f"{[round(v, 4) for v in losses]}; {steps} timed steps in "
        f"{dt:.3f} s = {1e3 * dt / steps:.1f} ms/step = {img_s:.1f} img/s; "
        f"peak device memory {peak / 2**30:.2f} GiB; kernel launches "
        f"{launches}")
    return {"img_s": img_s, "ms_step": 1e3 * dt / steps, "losses": losses,
            "launches": launches, "peak": peak}, step, (x, y)


def track_losses(fused, unfused):
    """The fused run's first loss equals the unfused run's from the same
    parameters and batch within 2% (the loss is a bf16 value, ~0.4%
    apart at 9, and bf16 activations round at other places on the two
    routes); the later steps are printed, not held: SGD at lr 0.1 with
    momentum grows any difference from step to step."""
    gaps = [abs(a - b) / max(abs(b), 1e-6) for a, b in zip(fused, unfused)]
    log(f"train: fused vs unfused losses from the same parameters: "
        f"relative gap per step {[round(g, 4) for g in gaps]}")
    expect(gaps[0] <= 0.02, "the fused run's first loss differs from the "
           "unfused run's")


def conv_bound(n, hw, ci, co, k, kernel):
    """Least time (ms) of one call at this shape in bf16: the larger of
    its flops (2 per multiply-add) at the bf16 dense peak and its bytes
    (each tensor read or written once: activations and weights bf16, dW
    f32, the per-channel vectors left out) at the HBM rate.  Returns
    ``(ops_ms, bytes_ms)``."""
    flops = 2.0 * n * hw * hw * co * k * k * ci
    act_in, act_out = 2 * n * hw * hw * ci, 2 * n * hw * hw * co
    weight = 2 * k * k * ci * co
    nbytes = {"fwd": act_in + weight + act_out,
              "dx": act_in + weight + act_out + act_in,
              "dw": act_in + act_out + 2 * weight}[kernel]
    return flops / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3


def time_fused(torch):
    """Each fused-conv kernel at the eight ResNet-50 shapes at N = 256,
    bf16, as the training run calls it: its outputs held against its
    plain version's (``check_outputs``), then timed beside the plain
    version, cuDNN on the already normalised input (``library``: the
    conv alone, without the prologue, the mask or the dscale/dshift
    epilogue — less work than the kernel), and the bound.  Per-step sums
    weight each shape by its blocks (32 launches); ``max_abs_err`` is
    the worst over the eight shapes."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    flush = torch.empty(1024 * 2**20, dtype=torch.uint8, device=DEVICE)
    before = dict(fc.norm_relu_conv.launches)
    sums = {k: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                              "operations", "bytes", "max_abs_err"), 0.0)
            for k in FUSED}
    for label, blocks, hw, ci, co, k in path_shapes():
        x, sc, sh, w, _, do = fused_inputs(torch, gen, TRAIN_BATCH, hw, ci,
                                           co, k, torch.bfloat16)
        xn = torch.relu(x.float() * sc + sh).to(torch.bfloat16) \
            .permute(0, 3, 1, 2)
        w4 = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        do4 = do.permute(0, 3, 1, 2)
        pad = k // 2
        f64 = torch.float64
        calls = {
            "fwd": (lambda: fc._fwd_cuda(x, sc, sh, w, None, True, 1),
                    lambda acc=torch.float32: fc._fwd_plain(
                        x, sc, sh, w, None, True, 1, acc),
                    lambda: F.conv2d(xn, w4, padding=pad)),
            "dx": (lambda: fc._dx_cuda(x, sc, sh, w, None, do, True, 1),
                   lambda acc=torch.float32: fc._dx_plain(
                       x, sc, sh, w, None, do, True, 1, acc),
                   lambda: torch.nn.grad.conv2d_input(xn.shape, w4, do4,
                                                      padding=pad)),
            "dw": (lambda: fc._dw_cuda(x, sc, sh, None, do, k, True, 1),
                   lambda acc=torch.float32: fc._dw_plain(
                       x, sc, sh, None, do, k, True, 1, acc),
                   lambda: torch.nn.grad.conv2d_weight(xn, w4.shape, do4,
                                                       padding=pad))}
        parts = []
        for kern in FUSED:
            kfn, pfn, lfn = calls[kern]
            # against the plain version summed in f64 (its f64 outputs
            # rounded to f32): dW sums N*H*W = 802816 positions here, and
            # the plain version in f32 (cuDNN's f32 wgrad) strays further
            # from f64 at the 3x3 shapes than F32_RTOL allows; its own
            # distance from f64 is printed beside the kernel's
            got, want = (list(r) if isinstance(r, tuple) else [r]
                         for r in (kfn(), pfn(f64)))
            want = [t if t is None or t.dtype != f64 else t.float()
                    for t in want]
            err = check_outputs(torch, f"{label}, N={TRAIN_BATCH}, bf16",
                                kern, got, want)
            plain = pfn()
            plain = list(plain) if isinstance(plain, tuple) else [plain]
            plain_err = max(float((a.float() - b.float()).abs().max())
                            for a, b in zip(plain, want) if b is not None)
            del got, want, plain
            ms = time_ms(torch, kfn, 10, flush)
            plain_ms = time_ms(torch, pfn, 5, flush)
            lib_ms = time_ms(torch, lfn, 10, flush)
            ops_ms, bytes_ms = conv_bound(TRAIN_BATCH, hw, ci, co, k, kern)
            bound_ms = max(ops_ms, bytes_ms)
            bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
            t = sums[kern]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            t["ms"] += blocks * ms
            t["plain_ms"] += blocks * plain_ms
            t["library_ms"] += blocks * lib_ms
            t["bound_ms"] += blocks * bound_ms
            t[bound_by] += blocks * bound_ms     # what sets the sum
            parts.append(f"{kern} {ms:.3f} ms, max abs err vs plain "
                         f"in f64 {err:.3e} (plain in f32: {plain_err:.3e})"
                         f" (plain {plain_ms:.3f}, cuDNN "
                         f"conv alone {lib_ms:.3f}, bound {bound_ms:.4f} by "
                         f"{bound_by}, {100 * bound_ms / ms:.1f}% of bound)")
        log(f"time [{label}, N={TRAIN_BATCH}, bf16, x{blocks} per step]: "
            + "; ".join(parts))
    fc.norm_relu_conv.launches = before       # timing is not the path
    for kern in FUSED:
        t = sums[kern]
        t["bound_by"] = "operations" if t.pop("operations") >= t.pop("bytes") \
            else "bytes"
        log(f"time per step [fused_conv_{kern}, 32 launches, max abs err "
            f"vs plain in f64 {t['max_abs_err']:.3e}]: kernel "
            f"{t['ms']:.2f} ms, plain {t['plain_ms']:.2f} ms, cuDNN conv "
            f"alone {t['library_ms']:.2f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['bound_by']}), kernel at "
            f"{100 * t['bound_ms'] / t['ms']:.2f}% of bound")
    return sums


def profile_step(torch, step, batch):
    """One more fused training step under ``torch.profiler``: the
    device's busy share of the step's wall time and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    print_profile(prof, wall_us, "train step (fused, batch 256)")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this run needs the card",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from mxnet_tpu_torch.gluon.model_zoo.causal_lm import (
            CausalLMConfig, init_causal_lm)
    except ImportError as exc:
        print(f"chip_smoke: the mxnet_tpu_torch package is not beside "
              f"this script ({exc})", file=sys.stderr)
        return 2

    try:
        name, count, smi_line = card_report(torch)
        build_kernels()
        rng = np.random.default_rng(0)
        max_err = kernel_vs_plain(torch, rng)
        cfg = CausalLMConfig(vocab_size=VOCAB, n_layers=LAYERS,
                             n_heads=HEADS, head_dim=HEAD_DIM, d_ff=D_FF)
        params = init_causal_lm(cfg, torch.Generator().manual_seed(0),
                                device="cuda")
        decode_parity(torch, rng, params, cfg)
        served = serve(torch, params, cfg)
        timing = time_kernel(torch, rng)
        profile_serving(torch, params, cfg)
        del params
        fused_vs_plain(torch)
        model_check(torch)
        fused_net, plain_net = training_nets(torch)
        trained, step, batch = train_run(torch, fused_net, True, TIMED_STEPS)
        profile_step(torch, step, batch)
        del step, batch, fused_net
        torch.cuda.empty_cache()
        unfused = train_run(torch, plain_net, False, TIMED_STEPS)[0]
        del plain_net
        track_losses(trained["losses"], unfused["losses"])
        log(f"train: fused {trained['img_s']:.1f} img/s "
            f"({trained['ms_step']:.1f} ms/step) vs unfused (cuDNN convs) "
            f"{unfused['img_s']:.1f} img/s ({unfused['ms_step']:.1f} "
            f"ms/step) = {trained['img_s'] / unfused['img_s']:.3f}x")
        torch.cuda.empty_cache()
        fused_times = time_fused(torch)
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    t = timing["path"]
    kernels = {"kernels": [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": SOURCES["paged_decode_attention"],
        "replaces": REPLACES["paged_decode_attention"],
        "launches": served["launches"], "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}]}
    for kern in FUSED:
        kname, t = f"fused_conv_{kern}", fused_times[kern]
        kernels["kernels"].append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname],
            "launches": trained["launches"][kern],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps(kernels), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
