#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one card.

    python3 chip_smoke.py

Drives the port's LLM serving path end to end on the first CUDA device,
at the width of ``bench.py llm`` on an accelerator (vocab 4096, 4
layers, 8 heads x 64, d_ff 2048; 64 slots, 512 pages x 64 tokens;
buckets (1, 2, 4) x (32, 64); 64 new tokens; prompts of 4-60 tokens),
with random weights from a seed.  Phases, each of which fails the run:

1. card report (name, count, ``nvidia-smi`` name and power limit);
2. build every CUDA kernel of the path from the sources in the checkout
   (one ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the
   path's shapes and at a long context, ragged lengths including 0;
4. the decode forward with the kernel against the decode forward with
   the plain version, same state, full width;
5. a ``GenerationServer`` on the card answers N greedy requests; the
   tokens are checked against a teacher-forced full forward, and the
   kernel's launch count against decode steps x layers;
6. the kernel timed with CUDA events (L2 flushed before each launch)
   beside its byte bound and its plain version's time;
7. a second, shorter serve under ``torch.profiler`` showing where the
   time goes (device busy/idle share per decode step, top kernels by
   device time).

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

VOCAB, LAYERS, HEADS, HEAD_DIM, D_FF = 4096, 4, 8, 64, 2048
SLOTS, N_PAGES, PAGE_SIZE, MAX_NEW = 64, 512, 64, 64
BATCH_BUCKETS, LENGTH_BUCKETS = (1, 2, 4), (32, 64)
N_REQUESTS = 256
ATOL, RTOL = 1e-5, 1e-4          # kernel vs plain, f32
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
REPLACES = {"paged_decode_attention":
            "mxnet_tpu/ops/pallas/paged_attention.py:31"}
SOURCES = {"paged_decode_attention":
           "mxnet_tpu_torch/ops/cuda/paged_attention.cu"}


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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in rows)
    expect(busy_us > 0, "the profiler saw no device time")
    log(f"profile: {n_requests} requests, {st['decode_steps']} decode "
        f"steps, {st['prefills']} prefills in {wall_us / 1e3:.3f} ms = "
        f"{wall_us / 1e3 / max(st['decode_steps'], 1):.3f} ms wall per "
        f"decode step; device busy {busy_us / 1e3:.3f} ms = "
        f"{100 * busy_us / wall_us:.1f}% of wall, idle "
        f"{100 - 100 * busy_us / wall_us:.1f}%")
    for e in sorted(rows, key=dev_us, reverse=True)[:12]:
        log(f"profile:   {dev_us(e) / 1e3:9.3f} ms  "
            f"{100 * dev_us(e) / busy_us:5.1f}%  x{e.count:<6d} "
            f"{e.key[:90]}")


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
    print(json.dumps(kernels), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
