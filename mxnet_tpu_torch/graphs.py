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

``captured(fn)`` is the counterpart of ``jax.jit`` for a function that
takes its parameters as an argument, ``fn(params, *leaves)`` (a serving
fleet's shared apply, ``amp.Int8Quantizer.wrap``): one graph per
signature of the leaves, over static input tensors and static
parameter slots that a call's parameters are copied into when they are
not the ones copied last.

There is no fallback: a capture that fails raises.
"""
from __future__ import annotations

import ctypes
import importlib
import threading
import weakref

import numpy as np
import torch

from . import random as _random

__all__ = ["GraphCache", "StepGraph", "captured", "launch_counts",
           "owned_stream", "release_stream"]

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

    def drop(self, key):
        """Free the graph held under ``key``, if any (the next ``run``
        of the key captures again)."""
        with _capture_lock:
            self.held.pop(key, None)

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


# ----------------------------------------------------------------- captured --
def _tree_leaves(x):
    """The leaves of a container of dicts (by sorted key), lists and
    tuples, in order."""
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _tree_leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _tree_leaves(v)]
    return [x]


def _tree_map(fn, x):
    """``x`` with ``fn`` applied to every leaf, its containers rebuilt."""
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(x))


class captured:
    """``fn(params, *leaves)`` replayed as one CUDA graph per signature
    (shape and dtype) of ``leaves``: the port's ``jax.jit`` of a function
    whose parameters are an argument.

    On the card the graphs read static tensors: a slot for every
    parameter leaf (``params`` is a dict, list or tuple of tensors,
    nested or not; its structure and leaf shapes are fixed at the first
    call) and a copy of each signature's leaves.  A call copies its
    parameters into the slots (one ``torch._foreach_copy_``) only when
    they are not the tensors copied in last — so replicas that share
    one set of parameters copy nothing per call — and its leaves (host
    arrays or tensors) into the signature's static copies, replays, and
    returns clones of the outputs.  One lock is held from filling the
    static inputs until the outputs are cloned: the replicas of a fleet
    call one shared function from their batch threads at once.  Where
    no parameter lies on the card (the CPU), ``fn`` runs eagerly (on the
    leaves as tensors).

    ``graph_count()`` (also ``_cache_size()``, the name the serving
    runtime probes on a jitted function) says how many graphs are held.
    """

    def __init__(self, fn):
        self.fn = fn
        self._lock = threading.Lock()
        self._graphs = None           # GraphCache, at the first card call
        self._slots = None            # static parameter tensors
        self._bound = None            # the parameter leaves copied last
        self._static = {}             # leaf signature -> static leaves

    def graph_count(self):
        return 0 if self._graphs is None else len(self._graphs)

    _cache_size = graph_count

    def __call__(self, params, *leaves):
        flat = _tree_leaves(params)
        device = next((t.device for t in flat
                       if isinstance(t, torch.Tensor) and t.is_cuda), None)
        if device is None:
            return self.fn(params, *[_as_tensor(x) for x in leaves])
        with self._lock:
            self._bind(params, flat, device)
            xs = [_as_tensor(x) for x in leaves]
            sig = tuple((tuple(x.shape), x.dtype) for x in xs)
            static = self._static.get(sig)
            if static is None:
                static = self._static[sig] = tuple(
                    torch.empty(x.shape, dtype=x.dtype, device=device)
                    for x in xs)
            for buf, x in zip(static, xs):
                buf.copy_(x, non_blocking=True)
            out = self._graphs.run(sig, lambda: self.fn(self._slots,
                                                        *static))
            return _tree_map(torch.clone, out)

    def _bind(self, params, flat, device):
        """The parameter slots, made at the first call and refilled from
        ``params`` when its leaves are not the ones copied last."""
        if self._graphs is None:
            self._graphs = GraphCache(device)
            self._slots = _tree_map(
                lambda t: _as_tensor(t).to(device, copy=True), params)
        elif len(flat) == len(self._bound) and all(
                a is b for a, b in zip(flat, self._bound)):
            return
        else:
            slots = _tree_leaves(self._slots)
            if len(slots) != len(flat) or any(
                    tuple(a.shape) != tuple(np.shape(b))
                    for a, b in zip(slots, flat)):
                raise ValueError(
                    "captured: the parameters' structure or shapes differ "
                    "from those the graphs were captured with")
            torch._foreach_copy_(slots, [_as_tensor(t) for t in flat],
                                 non_blocking=True)
        self._bound = flat
