"""CUDA graphs of the port's steps — the counterpart of the JAX package's
compiled programs.

The JAX package traces each step (a training step, an eval step, a
serving prefill or decode step) into one program; the port captures the
same step body into one ``torch.cuda.CUDAGraph`` over static buffers and
replays it, so one step costs the host one launch instead of thousands.

``GraphCache`` holds a step's graphs by key (an input signature, a
serving bucket): a key's first ``run`` warms up and captures, later ones
replay.  ``StepGraph`` holds one captured graph:

- ``warm_up(fn)`` runs ``fn`` eagerly on the device's capture stream
  first, so every kernel's one-time work (its library build and load,
  ``cudaFuncSetAttribute``, a launch plan's workspace, the seed
  counter of ``random``) happens outside the capture;
- ``capture(fn)`` records ``fn`` on that same stream (so a plan keyed by
  the stream is found) with the framework's CUDA generators registered,
  so the ``Dropout`` masks advance on every replay; it returns ``fn``'s
  outputs, the graph's static outputs;
- ``replay()`` launches the graph on the current stream.

The hand-written kernels count their launches on the host, in their
Python wrappers, which a replay never runs.  So ``capture`` notes how
many launches of each kernel the captured body made (and takes them
back: capturing runs no kernel), and every ``replay`` adds that count,
so the counters keep saying how often each kernel ran.

There is no fallback: a capture that fails raises.
"""
from __future__ import annotations

import importlib
import threading

import torch

from . import random as _random

__all__ = ["GraphCache", "StepGraph", "launch_counts", "capture_stream"]

_lock = threading.Lock()
_streams = {}


def _counted():
    """``(name, object holding .launches, key or None)`` for every
    hand-written kernel: flash attention and fused conv keep a dict per
    kernel, paged attention one int."""
    fa = importlib.import_module("mxnet_tpu_torch.ops.flash_attention")
    fc = importlib.import_module("mxnet_tpu_torch.ops.fused_conv")
    pa = importlib.import_module("mxnet_tpu_torch.ops.paged_attention")
    return ([(f"flash_attention_{k}", fa.flash_attention, k)
             for k in ("fwd", "dq", "dkv")]
            + [(f"fused_conv_{k}", fc.norm_relu_conv, k)
               for k in ("fwd", "dx", "dw")]
            + [("paged_decode_attention", pa.paged_decode_attention, None)])


def launch_counts():
    """Every kernel's launch counter, by kernel name."""
    return {name: (obj.launches if key is None else obj.launches[key])
            for name, obj, key in _counted()}


def _add_launches(delta, sign=1):
    for name, obj, key in _counted():
        n = sign * delta.get(name, 0)
        if key is None:
            obj.launches += n
        else:
            obj.launches[key] += n


def capture_stream(device):
    """The side stream the port warms up and captures its graphs on,
    one per device."""
    dev = torch.device(device)
    with _lock:
        s = _streams.get(dev)
        if s is None:
            s = _streams[dev] = torch.cuda.Stream(device=dev)
        return s


class StepGraph:
    """One captured step on one CUDA device (see the module's doc)."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got "
                             f"{self.device}")
        self.graph = torch.cuda.CUDAGraph()
        self.launches = {}            # kernel launches per replay

    def warm_up(self, fn):
        """``fn()`` run eagerly on the capture stream, after the current
        stream's work; the current stream then waits for it."""
        main = torch.cuda.current_stream(self.device)
        side = capture_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn()
        main.wait_stream(side)
        return out

    def capture(self, fn):
        """Record ``fn()`` into the graph; returns its outputs (static:
        each replay overwrites them)."""
        gens = _random.cuda_generators(self.device)
        if gens and not hasattr(self.graph, "register_generator_state"):
            raise RuntimeError(
                "this torch's CUDAGraph cannot register the framework's "
                "CUDA generators (register_generator_state); a captured "
                "step would repeat its dropout masks")
        for gen in gens:
            self.graph.register_generator_state(gen)
        before = launch_counts()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(
                    self.graph, stream=capture_stream(self.device)):
                out = fn()
        finally:
            after = launch_counts()
            delta = {k: after[k] - before[k] for k in after}
            _add_launches(delta, -1)      # capturing launched nothing
        self.launches = {k: n for k, n in delta.items() if n}
        return out

    def replay(self):
        """Launch the graph on the current stream and count its kernels'
        launches."""
        self.graph.replay()
        _add_launches(self.launches)


class GraphCache:
    """The captured graphs of one step body on one CUDA device, by key."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.held = {}

    def __len__(self):
        return len(self.held)

    def run(self, key, body):
        """``body()`` through the graph held under ``key``.  ``body``
        reads inputs that stay at the same addresses for the key (its
        static buffers, which the caller fills first).  A new key runs
        ``body`` eagerly on the capture stream — this call's result —
        and then captures it; a known key replays and returns the
        graph's static outputs, which the next replay overwrites."""
        entry = self.held.get(key)
        if entry is not None:
            graph, out = entry
            graph.replay()
            return out
        graph = StepGraph(self.device)
        out = graph.warm_up(body)
        main = torch.cuda.current_stream(self.device)
        for t in (out if isinstance(out, tuple) else (out,)):
            if t is not None:         # made on the capture stream
                t.record_stream(main)
        self.held[key] = (graph, graph.capture(body))
        return out
