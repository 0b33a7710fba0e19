"""The port's bench entry point: one JSON line per model.

    python -m mxnet_tpu_torch.bench resnet           # on the card
    python -m mxnet_tpu_torch.bench bert [--model bert_24_1024_16]
    python -m mxnet_tpu_torch.bench llm
    python -m mxnet_tpu_torch.bench llm --device cpu # plain versions, small

The settings are those of the repo's ``bench.py`` (``bench_resnet``,
``bench_bert``, ``bench_llm``), run through the port's captured steps:

- ``resnet``: ``resnet50_v1`` NHWC with ``fused=True``, cast to bf16
  (f32 master weights), SGD 0.1 / 0.9 / 1e-4 through
  ``parallel.TrainStep``, batch 256 of ``RandomState(0)`` 224x224x3
  images, 2 warm-up steps (the first captures the graph) and 20 timed;
- ``bert``: ``BERTModel`` (``bert_12_768_12`` by default, vocab 30522)
  with ``attention_impl="flash"`` and dropout 0.1, cast to bf16,
  masked-LM + NSP loss, LAMB 1e-3 / wd 0.01, batch 64 x 128 with 20
  masked positions, 2 warm-up and 20 timed steps.  Every row is full
  length, so ``valid_length`` is None — the same function as
  ``bench_bert``'s ``valid_length = 128``; the flash path takes no mask;
- ``llm``: a ``GenerationServer`` (vocab 4096, 4 layers, 8 heads x 64,
  d_ff 2048; 64 slots, 512 pages x 64, buckets (1, 2, 4) x (32, 64),
  64 new tokens) answering 256 greedy requests of 4-60 random tokens.

On the CPU (``--device cpu``) it runs the plain versions at the sizes
``bench.py`` uses without an accelerator: batch 8 and 2 timed steps
(resnet), batch 2 and 1 step (bert), and bench_llm's small server.

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

__all__ = ["bench_resnet", "bench_bert", "bench_llm", "main"]

# bench.py's metric names and baseline bars (its own copy)
METRIC_NAMES = {"resnet": "resnet50_train_throughput",
                "bert": "bert_base_pretrain_throughput",
                "llm": "llm_decode_throughput"}
BASELINE = {"resnet": 800.0, "bert": 3000.0, "llm": 1000.0}
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


def bench_resnet(device="cuda", iters=None):
    """ResNet-50 v1 training throughput, images/s on one card."""
    from . import gluon
    from .gluon.model_zoo.vision import resnet50_v1

    device = resolve_device(device)
    batch = 256 if _on_card(device) else 8
    iters = iters or (20 if _on_card(device) else 2)
    net = resnet50_v1(layout="NHWC", fused=True)
    net.initialize(ctx=device)
    net.cast("bfloat16")
    step = parallel.TrainStep(
        net, gluon.loss.SoftmaxCrossEntropyLoss(),
        optimizer.create("sgd", learning_rate=0.1, momentum=0.9, wd=1e-4))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(batch, 224, 224, 3).astype(np.float32)) \
        .to(device).to(torch.bfloat16)
    y = torch.from_numpy(rng.randint(0, 1000, (batch,)).astype(np.int32)) \
        .to(device)
    if _on_card(device):
        torch.cuda.reset_peak_memory_stats(device)
    dt, losses = _time_steps(step, device, (x, y), iters)
    img_s = batch * iters / dt
    return _line("resnet", img_s, "img/s", device, model="resnet50_v1",
                 batch=batch, steps=iters,
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


def bench_llm(device="cuda", config=None, n_requests=None):
    """Continuous-batching decode throughput of a ``GenerationServer``,
    generated tokens/s on one card.  ``config`` (a ``CausalLMConfig``)
    and ``n_requests`` override bench_llm's (a small run in a test)."""
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
    srv = GenerationServer(
        params, cfg, buckets=BucketSpec(batch=(1, 2, 4), length=(32, 64)),
        n_slots=n_slots, n_pages=n_pages, page_size=page_size,
        max_new_tokens=max_new, max_queue=n_requests, seed=0,
        device=device, name="PortBenchGen")
    srv.start()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(rng.randint(4, 60)))
               .astype(np.int32) for _ in range(n_requests)]
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
    return _line("llm", tok_s, "tokens/s", device,
                 sequences=st["completed"], preempted=st["preempted"],
                 decode_steps=st["decode_steps"], prefills=st["prefills"],
                 graphs=srv.graph_count(), census=srv.census())


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
    args = ap.parse_args(argv)
    for name in args.models:
        if name == "resnet":
            line = bench_resnet(args.device, args.steps)
        elif name == "bert":
            line = bench_bert(args.device, args.model, args.steps)
        else:
            line = bench_llm(args.device, **overrides)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
