"""The port's bench entry point: one JSON line per model.

    python -m mxnet_tpu_torch.bench resnet           # on the card
    python -m mxnet_tpu_torch.bench resnet --feed prefetch
    python -m mxnet_tpu_torch.bench bert [--model bert_24_1024_16]
    python -m mxnet_tpu_torch.bench llm [--prefix]
    python -m mxnet_tpu_torch.bench lstm
    python -m mxnet_tpu_torch.bench ssd
    python -m mxnet_tpu_torch.bench llm --device cpu # plain versions, small

The settings are those of the repo's ``bench.py`` (``bench_resnet``,
``bench_bert``, ``bench_lstm``, ``bench_ssd``, ``bench_llm``), run
through the port's captured steps:

- ``resnet``: ``resnet50_v1`` NHWC with ``fused=True``, cast to bf16
  (f32 master weights), SGD 0.1 / 0.9 / 1e-4 through
  ``parallel.TrainStep``, batch 256 of ``RandomState(0)`` 224x224x3
  images, 2 warm-up steps (the first captures the graph) and 20 timed.
  ``--feed prefetch`` is ``bench.py``'s ``MXTPU_BENCH_FEED=prefetch``:
  every step takes a fresh host batch (a bf16 CPU tensor and the int32
  labels) through ``parallel.DevicePrefetcher(depth=2)`` — pinned
  staging and a copy stream of its own — into a ``TrainStep`` made with
  ``donate_batch=True``, so the line measures the input pipeline's
  hand-off as well as the step; it adds ``producer_wait_s`` and
  ``consumer_wait_s`` (which side waited: the step or the feed);
- ``bert``: ``BERTModel`` (``bert_12_768_12`` by default, vocab 30522)
  with ``attention_impl="flash"`` and dropout 0.1, cast to bf16,
  masked-LM + NSP loss, LAMB 1e-3 / wd 0.01, batch 64 x 128 with 20
  masked positions, 2 warm-up and 20 timed steps.  Every row is full
  length, so ``valid_length`` is None — the same function as
  ``bench_bert``'s ``valid_length = 128``; the flash path takes no mask;
- ``lstm``: ``rnn_lm`` (vocab 10000, embed 650, hidden 650, 2 LSTM
  layers, dropout 0.5), cast to bf16, SGD at 20 / batch without
  momentum, softmax cross-entropy over ``(-1, vocab)``, batch 64 x bptt
  35 time-major int32 ids, 2 warm-up and 20 timed steps;
- ``ssd``: ``ssd_512_resnet50_v1(classes=20)`` (NCHW), cast to bf16,
  ``MultiBoxTarget`` (hard negatives 3:1) and ``SSDMultiBoxLoss``
  inside the loss, SGD 1e-3 / 0.9 / 5e-4, batch 16 of 3x512x512 images
  with 1-3 boxes each padded to 8 label rows, 2 warm-up and 10 timed
  steps;
- ``llm``: a ``GenerationServer`` (vocab 4096, 4 layers, 8 heads x 64,
  d_ff 2048; 64 slots, 512 pages x 64, buckets (1, 2, 4) x (32, 64),
  64 new tokens) answering 256 greedy requests of 4-60 random tokens.
  ``--prefix`` sends ``bench.py``'s ``MXTPU_BENCH_PREFIX=1`` traffic
  instead: every prompt is one system prompt of 90% of ``2.5 x
  page_size`` tokens (144 of 160 on the card) plus a random tail, so
  prefix sharing carries the load; on the card the length buckets gain
  192 so that 160-token prompts fit (bench.py keeps (32, 64), which
  refuses them).  The line adds ``page_bytes_per_seq`` (pool bytes
  charged per sequence), ``pages_shared_mapped`` and ``cow_faults``.

On the CPU (``--device cpu``) it runs the plain versions at the sizes
``bench.py`` uses without an accelerator: batch 8 and 2 timed steps
(resnet, lstm), batch 2 and 1 step (bert; ssd at 128x128), and
bench_llm's small server.

Each line carries ``bench.py``'s keys — ``metric`` (its metric names),
``value``, ``unit`` (per card: ``img/s/gpu``, ``tokens/s/gpu``; a CPU
run says ``/cpu``), ``vs_baseline`` — and what the run was: device,
step time, peak device memory, graphs held.  The module writes no file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import optimizer, parallel
from . import random as _random
from .context import resolve_device

__all__ = ["bench_resnet", "bench_bert", "bench_lstm", "bench_ssd",
           "bench_llm", "ssd_labels", "ssd_loss_fn", "main"]

# bench.py's metric names and baseline bars (its own copy)
METRIC_NAMES = {"resnet": "resnet50_train_throughput",
                "bert": "bert_base_pretrain_throughput",
                "lstm": "lstm_lm_train_throughput",
                "ssd": "ssd512_train_throughput",
                "llm": "llm_decode_throughput"}
BASELINE = {"resnet": 800.0, "bert": 3000.0, "lstm": 30000.0, "ssd": 40.0,
            "llm": 1000.0}
WARMUP = 2
BERT_MODELS = {"bert_12_768_12": dict(units=768, hidden_size=3072,
                                      num_layers=12, num_heads=12),
               "bert_24_1024_16": dict(units=1024, hidden_size=4096,
                                       num_layers=24, num_heads=16)}


def _on_card(device):
    return device.type == "cuda"


def _sync(device):
    if _on_card(device):
        torch.cuda.synchronize(device)


def _device_fields(device):
    if not _on_card(device):
        return {"device": "cpu", "peak_mem_GiB": None}
    return {"device": torch.cuda.get_device_name(device),
            "peak_mem_GiB": round(torch.cuda.max_memory_allocated(device)
                                  / 2 ** 30, 3)}


def _time_steps(step, device, batch, iters):
    """``WARMUP`` steps (the first captures the step's graph), then
    ``iters`` timed ones; returns the seconds and every loss."""
    losses = [float(step(*batch)) for _ in range(WARMUP)]
    _sync(device)
    t0 = time.perf_counter()
    timed = [step(*batch) for _ in range(iters)]
    _sync(device)
    dt = time.perf_counter() - t0
    losses += [float(v) for v in timed]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"bench: a loss is not finite: {losses}")
    return dt, losses


def _line(kind, value, unit, device, metric=None, **extra):
    """bench.py's keys for a ``kind`` of bench; the unit per card
    (``/gpu``), or ``/cpu`` for a run of the plain versions on the
    host."""
    return {"metric": metric or METRIC_NAMES[kind], "value": round(value, 2),
            "unit": f"{unit}/{'gpu' if _on_card(device) else 'cpu'}",
            "vs_baseline": round(value / BASELINE[kind], 4), **extra,
            **_device_fields(device)}


def _time_fed_steps(step, device, batch, iters):
    """``_time_steps`` with each batch a host batch through a
    ``DevicePrefetcher`` (depth 2); returns the seconds, every loss and
    the timed run's wait split."""
    from .parallel import DevicePrefetcher

    def host_batches(n):
        for _ in range(n):
            yield batch

    with DevicePrefetcher(host_batches(WARMUP), step=step) as feed:
        losses = [float(step(d, l)) for d, l in feed]
    _sync(device)
    t0 = time.perf_counter()
    with DevicePrefetcher(host_batches(iters), step=step, depth=2) as feed:
        timed = [step(d, l) for d, l in feed]
        _sync(device)
        dt = time.perf_counter() - t0
        waits = {k: round(feed.stats[k], 6)
                 for k in ("producer_wait_s", "consumer_wait_s")}
    losses += [float(v) for v in timed]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"bench: a loss is not finite: {losses}")
    return dt, losses, waits


def bench_resnet(device="cuda", iters=None, feed="device"):
    """ResNet-50 v1 training throughput, images/s on one card; ``feed``
    ``"device"`` (the batch already on the device) or ``"prefetch"``
    (fresh host batches through ``DevicePrefetcher``)."""
    from . import gluon
    from .gluon.model_zoo.vision import resnet50_v1

    device = resolve_device(device)
    batch = 256 if _on_card(device) else 8
    iters = iters or (20 if _on_card(device) else 2)
    net = resnet50_v1(layout="NHWC", fused=True)
    net.initialize(ctx=device)
    net.cast("bfloat16")
    if feed not in ("device", "prefetch"):
        raise ValueError(f"feed={feed!r}: 'device' or 'prefetch'")
    step = parallel.TrainStep(
        net, gluon.loss.SoftmaxCrossEntropyLoss(),
        optimizer.create("sgd", learning_rate=0.1, momentum=0.9, wd=1e-4),
        donate_batch=feed == "prefetch")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(batch, 224, 224, 3).astype(np.float32)) \
        .to(torch.bfloat16)
    y = torch.from_numpy(rng.randint(0, 1000, (batch,)).astype(np.int32))
    if _on_card(device):
        torch.cuda.reset_peak_memory_stats(device)
    waits = {}
    if feed == "prefetch":
        dt, losses, waits = _time_fed_steps(step, device, (x, y), iters)
    else:
        dt, losses = _time_steps(step, device,
                                 (x.to(device), y.to(device)), iters)
    img_s = batch * iters / dt
    return _line("resnet", img_s, "img/s", device, model="resnet50_v1",
                 batch=batch, steps=iters, feed=feed, **waits,
                 ms_per_step=round(1e3 * dt / iters, 3),
                 graphs=step.graph_count(), first_loss=losses[0],
                 last_loss=losses[-1])


def bench_bert(device="cuda", model="bert_12_768_12", iters=None):
    """BERT masked-LM + NSP pretraining throughput, tokens/s on one
    card."""
    from .gluon.model_zoo.bert import BERTModel, BERTPretrainLoss

    device = resolve_device(device)
    batch = 64 if _on_card(device) else 2
    iters = iters or (20 if _on_card(device) else 1)
    vocab, seq_len, n_pred = 30522, 128, 20
    _random.seed(0)
    net = BERTModel(vocab_size=vocab, max_length=512, dropout=0.1,
                    attention_impl="flash", **BERT_MODELS[model])
    net.initialize(ctx=device)
    net.cast("bfloat16")
    blk = BERTPretrainLoss()

    def loss_fn(out, labels):
        return blk(out[3], out[2], *labels)

    step = parallel.TrainStep(net, loss_fn, optimizer.create(
        "lamb", learning_rate=1e-3, wd=0.01))
    rng = np.random.RandomState(0)

    def dev(a):
        return torch.from_numpy(a).to(device)
    tok = dev(rng.randint(0, vocab, (batch, seq_len)).astype(np.int32))
    tt = dev(rng.randint(0, 2, (batch, seq_len)).astype(np.int32))
    mpos = dev(rng.randint(0, seq_len, (batch, n_pred)).astype(np.int32))
    mlab = dev(rng.randint(0, vocab, (batch, n_pred)).astype(np.int32))
    mw = dev(np.ones((batch, n_pred), np.float32))
    nsp = dev(rng.randint(0, 2, (batch,)).astype(np.int32))
    if _on_card(device):
        torch.cuda.reset_peak_memory_stats(device)
    dt, losses = _time_steps(step, device, ((tok, tt, None, mpos),
                                            (mlab, mw, nsp)), iters)
    tok_s = batch * seq_len * iters / dt
    return _line("bert", tok_s, "tokens/s", device,
                 metric=None if model == "bert_12_768_12"
                 else f"{model}_pretrain_throughput",
                 model=model, batch=batch, seq_len=seq_len, steps=iters,
                 ms_per_step=round(1e3 * dt / iters, 3),
                 graphs=step.graph_count(), first_loss=losses[0],
                 last_loss=losses[-1])


def bench_lstm(device="cuda", iters=None):
    """The PTB-medium LSTM language model's training throughput,
    tokens/s on one card."""
    from . import gluon
    from .gluon.model_zoo.language_model import rnn_lm

    device = resolve_device(device)
    batch = 64 if _on_card(device) else 8
    iters = iters or (20 if _on_card(device) else 2)
    bptt, vocab = 35, 10000
    _random.seed(0)
    net = rnn_lm(vocab_size=vocab, embed_size=650, hidden_size=650,
                 num_layers=2, dropout=0.5)
    net.initialize(ctx=device)
    net.cast("bfloat16")
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def loss_fn(out, label):
        return ce(out.reshape((-1, vocab)), label.reshape((-1,)))

    step = parallel.TrainStep(net, loss_fn, optimizer.create(
        "sgd", learning_rate=20.0 / batch))
    rng = np.random.RandomState(0)
    x, y = (torch.from_numpy(rng.randint(0, vocab, (bptt, batch))
                             .astype(np.int32)).to(device) for _ in range(2))
    if _on_card(device):
        torch.cuda.reset_peak_memory_stats(device)
    dt, losses = _time_steps(step, device, (x, y), iters)
    tok_s = batch * bptt * iters / dt
    return _line("lstm", tok_s, "tokens/s", device, model="rnn_lm 2x650",
                 batch=batch, bptt=bptt, steps=iters,
                 ms_per_step=round(1e3 * dt / iters, 3),
                 graphs=step.graph_count(), first_loss=losses[0],
                 last_loss=losses[-1])


def ssd_labels(rng, batch, rows=8, classes=20):
    """``bench_ssd``'s labels: 1-3 boxes an image, ``[cls, x1, y1, x2,
    y2]``, padded to ``rows`` rows of -1."""
    label = np.full((batch, rows, 5), -1.0, np.float32)
    for i in range(batch):
        for j in range(rng.randint(1, 4)):
            cls = rng.randint(0, classes)
            x1, y1 = rng.uniform(0.05, 0.5, 2)
            label[i, j] = [cls, x1, y1, x1 + rng.uniform(0.1, 0.4),
                           y1 + rng.uniform(0.1, 0.4)]
    return label


def ssd_loss_fn():
    """``bench_ssd``'s loss: ``MultiBoxTarget`` (hard negatives 3:1)
    then ``SSDMultiBoxLoss``."""
    from .gluon.model_zoo.ssd import SSDMultiBoxLoss
    from .ops import MultiBoxTarget

    box_loss = SSDMultiBoxLoss()

    def loss_fn(out, label):
        cls_pred, loc_pred, anchor = out
        bt, bm, ct = MultiBoxTarget(anchor, label, cls_pred,
                                    overlap_threshold=0.5,
                                    negative_mining_ratio=3.0,
                                    negative_mining_thresh=0.5)
        return box_loss(cls_pred, loc_pred, ct, bt, bm)
    return loss_fn


def bench_ssd(device="cuda", iters=None):
    """SSD-512 ResNet-50 training throughput, images/s on one card."""
    from .gluon.model_zoo.ssd import ssd_512_resnet50_v1

    device = resolve_device(device)
    card = _on_card(device)
    batch, size = (16, 512) if card else (2, 128)
    iters = iters or (10 if card else 1)
    _random.seed(0)
    net = ssd_512_resnet50_v1(classes=20)
    net.initialize(ctx=device)
    net.cast("bfloat16")
    step = parallel.TrainStep(net, ssd_loss_fn(), optimizer.create(
        "sgd", learning_rate=1e-3, momentum=0.9, wd=5e-4))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(batch, 3, size, size).astype(np.float32))
    x = x.to(torch.bfloat16).to(device)
    label = torch.from_numpy(ssd_labels(rng, batch)).to(device)
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    dt, losses = _time_steps(step, device, (x, label), iters)
    img_s = batch * iters / dt
    return _line("ssd", img_s, "img/s", device, model="ssd_512_resnet50_v1",
                 batch=batch, image=size, steps=iters,
                 ms_per_step=round(1e3 * dt / iters, 3),
                 graphs=step.graph_count(), first_loss=losses[0],
                 last_loss=losses[-1])


def bench_llm(device="cuda", config=None, n_requests=None, prefix=False):
    """Continuous-batching decode throughput of a ``GenerationServer``,
    generated tokens/s on one card.  ``config`` (a ``CausalLMConfig``)
    and ``n_requests`` override bench_llm's (a small run in a test);
    ``prefix`` sends the shared-prefix traffic (the module's doc)."""
    from .gluon.model_zoo.causal_lm import CausalLMConfig, init_causal_lm
    from .serving import BucketSpec, GenerationServer

    device = resolve_device(device)
    card = _on_card(device)
    cfg = config or CausalLMConfig(vocab_size=4096 if card else 256,
                                   n_layers=4 if card else 2,
                                   n_heads=8 if card else 2,
                                   head_dim=64 if card else 16,
                                   d_ff=2048 if card else 64)
    n_slots = 64 if card else 8
    n_pages, page_size = (512, 64) if card else (64, 16)
    max_new = 64 if card else 8
    n_requests = n_requests or (256 if card else 32)
    params = init_causal_lm(cfg, torch.Generator().manual_seed(0),
                            device=device)
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    rng = np.random.RandomState(0)
    lengths = (32, 64)
    if prefix:
        # one system prompt for every request: 90% of a fixed prompt
        # length covering whole pages, the 10% tail random per request
        plen = page_size * 5 // 2
        shared = rng.randint(0, cfg.vocab_size,
                             size=int(plen * 0.9)).astype(np.int32)
        prompts = [np.concatenate([shared, rng.randint(
            0, cfg.vocab_size, size=plen - len(shared)).astype(np.int32)])
            for _ in range(n_requests)]
        if plen > max(lengths):
            lengths += (192,)
    else:
        prompts = [rng.randint(0, cfg.vocab_size,
                               size=int(rng.randint(4, 60)))
                   .astype(np.int32) for _ in range(n_requests)]
    srv = GenerationServer(
        params, cfg, buckets=BucketSpec(batch=(1, 2, 4), length=lengths),
        n_slots=n_slots, n_pages=n_pages, page_size=page_size,
        max_new_tokens=max_new, max_queue=n_requests, seed=0,
        device=device, name="PortBenchGen")
    srv.start()
    try:
        t0 = time.perf_counter()
        reqs = [srv.submit(p) for p in prompts]
        for r in reqs:
            r.result(timeout=600)
        dt = time.perf_counter() - t0
    finally:
        srv.drain(60)
    st = srv.stats
    tok_s = st["tokens_out"] / dt
    extra = {}
    if prefix:
        page_bytes = (2 * cfg.n_layers * page_size * cfg.n_heads
                      * cfg.head_dim * 4)
        extra = {"prefix_shared_frac": 0.9,
                 "page_bytes_per_seq": round(
                     st["pages_charged"] * page_bytes
                     / max(st["completed"], 1)),
                 "pages_shared_mapped": st["pages_shared_mapped"],
                 "cow_faults": st["cow_faults"]}
    return _line("llm", tok_s, "tokens/s", device,
                 sequences=st["completed"], preempted=st["preempted"],
                 decode_steps=st["decode_steps"], prefills=st["prefills"],
                 graphs=srv.graph_count(), census=srv.census(), **extra)


def main(argv=None, **overrides):
    """Parse ``argv`` and print each model's line; ``overrides`` go to
    ``bench_llm`` (a small ``config`` and ``n_requests``)."""
    ap = argparse.ArgumentParser(prog="python -m mxnet_tpu_torch.bench")
    ap.add_argument("models", nargs="+", choices=sorted(METRIC_NAMES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--model", default="bert_12_768_12",
                    choices=sorted(BERT_MODELS), help="the BERT to run")
    ap.add_argument("--steps", type=int, default=None,
                    help="timed steps (default: bench.py's)")
    ap.add_argument("--prefix", action="store_true",
                    help="llm: bench.py's shared-prefix traffic")
    ap.add_argument("--feed", default="device", choices=("device",
                                                         "prefetch"),
                    help="resnet: the batch on the device, or fresh host "
                         "batches through DevicePrefetcher")
    args = ap.parse_args(argv)
    for name in args.models:
        if name == "resnet":
            line = bench_resnet(args.device, args.steps, args.feed)
        elif name == "bert":
            line = bench_bert(args.device, args.model, args.steps)
        elif name == "lstm":
            line = bench_lstm(args.device, args.steps)
        elif name == "ssd":
            line = bench_ssd(args.device, args.steps)
        else:
            line = bench_llm(args.device, prefix=args.prefix, **overrides)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
