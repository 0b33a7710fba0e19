"""CUDA graphs of the port's steps — the counterpart of the JAX package's
compiled programs.

The JAX package traces each step (a training step, an eval step, a
serving prefill or decode step) into one program; the port captures the
same step body into one ``torch.cuda.CUDAGraph`` over static buffers and
replays it, so one step costs the host one launch instead of thousands.

``GraphCache`` holds a step's graphs by key (an input signature, a
serving bucket): a key's first ``run`` warms up and captures, later ones
replay.  ``StepGraph`` holds one captured graph and the side stream it
is captured on (its capture stream):

- ``warm_up(fn)`` runs ``fn`` eagerly on the capture stream first, so
  every kernel's one-time work (its library build and load,
  ``cudaFuncSetAttribute``, a launch plan's workspace, the seed counter
  of ``random``) happens outside the capture;
- ``capture(fn)`` records ``fn`` on that same stream (so a plan keyed by
  the stream is found) with the framework's CUDA generators registered,
  so the ``Dropout`` masks advance on every replay; it returns ``fn``'s
  outputs, the graph's static outputs;
- ``replay()`` launches the graph on the current stream.

A forward and a backward graph form a pair (a hybridized block under
``autograd.record()``): the backward graph is made with
``StepGraph(device, pool_of=forward)``, so it is captured on the
forward graph's stream into the forward graph's memory pool, where the
activations the forward saved for it live.  Capture the forward first;
the backward then reads what each forward replay leaves there.

The hand-written kernels count their launches on the host, in their
Python wrappers, which a replay never runs.  So ``capture`` notes how
many launches of each kernel the captured body made (and takes them
back: capturing runs no kernel), and every ``replay`` adds that count,
so the counters keep saying how often each kernel ran.

Threads.  The disaggregated server replays prefill graphs on worker
threads, each on a stream of its own, while its decode loop replays the
decode graph on another, and with ``start(warmup=False)`` a worker's
first call of a bucket captures while the loop runs.  So:

- every graph is captured on a stream it owns (``owned_stream``): a
  non-blocking stream made for the process, not one of torch's pool of
  32 that it hands out in turn, so no two live graphs, in one cache or
  in two, and no prefill worker share one.  A graph bakes in the
  per-(thread, stream) state its body used while capturing — cuBLAS's
  workspace, a paged-kernel launch plan's — and two graphs replaying at
  once on two streams must not write the same workspace.  A freed
  graph's stream is handed to a later graph only after the device has
  synchronised once, and the plans made on it are dropped then;
- one capture at a time in the process (``_capture_lock``, held over a
  key's warm-up and capture), in ``thread_local`` capture mode, so the
  syncs and allocations other threads make meanwhile neither fail nor
  break it;
- a replay that runs while another thread captures has its launches
  kept apart from the capturing body's (``_window``), so neither
  graph's count takes the other's;
- ``GraphCache`` serialises a key's first use, but not its use: the
  caller serialises the key's static inputs and outputs (the server
  holds a lock per bucket from filling the inputs until the outputs
  are copied out);
- every capture registers the framework's CUDA generators; their
  shared state is written when a graph is captured (under the lock),
  freed, or replayed after drawing random numbers.  The serving steps
  draw none, so their replays on several threads only read it; a
  server's graphs are freed with the server.

There is no fallback: a capture that fails raises.
"""
from __future__ import annotations

import ctypes
import importlib
import threading
import weakref

import torch

from . import random as _random

__all__ = ["GraphCache", "StepGraph", "launch_counts", "owned_stream",
           "release_stream"]

_capture_lock = threading.RLock()  # one capture at a time in the process
_count_lock = threading.Lock()     # the launch counters' updates
_window = {"replayed": None}       # launches replayed during a capture
_idle = {}                         # device -> owned streams no one holds
_released = []                     # (device, stream) of freed graphs
_libcuda = []                      # libcuda, loaded once


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
    """Add ``sign * delta`` to the counters; a replay's launches during
    a capture are also noted in ``_window`` (the caller holds
    ``_count_lock``)."""
    for name, obj, key in _counted():
        n = sign * delta.get(name, 0)
        if not n:
            continue
        if key is None:
            obj.launches += n
        else:
            obj.launches[key] += n
    replayed = _window["replayed"]
    if replayed is not None and sign > 0:
        for name, n in delta.items():
            replayed[name] = replayed.get(name, 0) + n


def _create_stream(device):
    """A new non-blocking stream on ``device`` (``cuStreamCreate`` in the
    card's primary context, which torch made current on this thread)."""
    from .ops.cuda import on_card

    if not _libcuda:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuStreamCreate.argtypes = [ctypes.c_void_p, ctypes.c_uint]
        lib.cuStreamCreate.restype = ctypes.c_int
        _libcuda.append(lib)
    handle = ctypes.c_void_p()
    with on_card(device.index):
        status = _libcuda[0].cuStreamCreate(ctypes.byref(handle), 1)
    if status != 0:                   # 1: CU_STREAM_NON_BLOCKING
        raise RuntimeError(f"cuStreamCreate failed on {device}: CUDA "
                           f"error {status}")
    return torch.cuda.ExternalStream(handle.value, device=device)


def _reclaim(device):
    """Make the streams of freed graphs on ``device`` idle again: once
    the device has finished every replay they launched, the paged
    kernel's launch plans made on them are dropped (a freed graph was
    their only user) and the streams can serve a new graph."""
    mine = [r for r in list(_released) if r[0] == device]
    if not mine:
        return
    torch.cuda.synchronize(device)
    pa = importlib.import_module("mxnet_tpu_torch.ops.paged_attention")
    for r in mine:
        _released.remove(r)
        pa.drop_plans(r[1].cuda_stream)
        _idle.setdefault(device, []).append(r[1])


def owned_stream(device):
    """A CUDA stream on ``device`` that no one else holds until it is
    given back (``release_stream``, or by freeing the graph captured on
    it).  The process makes a new one when none is idle, so there is no
    cap; a stream given back is reused, never destroyed."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _capture_lock:               # never while this thread captures
        _reclaim(device)
        idle = _idle.get(device)
        return idle.pop() if idle else _create_stream(device)


def release_stream(device, stream):
    """Give back an owned stream whose holder is done with it: a later
    ``owned_stream`` takes it after the device has synchronised once."""
    _released.append((torch.device(device), stream))


class StepGraph:
    """One captured step on one CUDA device (see the module's doc)."""

    def __init__(self, device, pool_of=None):
        """``pool_of``: the forward ``StepGraph`` of a pair, whose capture
        stream and memory pool this (backward) graph shares."""
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got "
                             f"{self.device}")
        self.graph = torch.cuda.CUDAGraph()
        self._pool_of = pool_of
        if pool_of is None:
            self.stream = owned_stream(self.device)
            weakref.finalize(self, release_stream, self.stream.device,
                             self.stream)
        else:
            self.stream = pool_of.stream
        self.launches = {}            # kernel launches per replay

    def warm_up(self, fn):
        """``fn()`` run eagerly on the capture stream, after the current
        stream's work; the current stream then waits for it."""
        main = torch.cuda.current_stream(self.device)
        side = self.stream
        with _capture_lock:
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
        with _capture_lock:
            for gen in gens:
                self.graph.register_generator_state(gen)
            with _count_lock:
                before = launch_counts()
                _window["replayed"] = {}
            try:
                pool = None if self._pool_of is None \
                    else self._pool_of.graph.pool()
                with torch.cuda.device(self.device), torch.cuda.graph(
                        self.graph, pool=pool, stream=self.stream,
                        capture_error_mode="thread_local"):
                    out = fn()
            finally:
                with _count_lock:
                    after = launch_counts()
                    replayed, _window["replayed"] = _window["replayed"], None
                    delta = {k: after[k] - before[k] - replayed.get(k, 0)
                             for k in after}
                    _add_launches(delta, -1)  # capturing launched nothing
        self.launches = {k: n for k, n in delta.items() if n}
        return out

    def replay(self):
        """Launch the graph on the current stream and count its kernels'
        launches."""
        self.graph.replay()
        if self.launches:
            with _count_lock:
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
        graph's static outputs, which the next replay overwrites.  Any
        thread may call it; one call per key at a time (see the
        module's doc)."""
        entry = self.held.get(key)
        if entry is None:
            with _capture_lock:
                entry = self.held.get(key)
                if entry is None:
                    return self._capture(key, body)
        graph, out = entry
        graph.replay()
        return out

    def _capture(self, key, body):
        graph = StepGraph(self.device)
        out = graph.warm_up(body)
        main = torch.cuda.current_stream(self.device)
        for t in (out if isinstance(out, tuple) else (out,)):
            if t is not None:         # made on the capture stream
                t.record_stream(main)
        self.held[key] = (graph, graph.capture(body))
        return out
