"""DevicePrefetcher: the double-buffered host-to-device batch feed (the
port of ``mxnet_tpu/parallel/prefetch.py``, on one device).

A producer thread takes batch N+1..N+depth from the source while the
caller computes on batch N, and places each on the device:

- the source runs in the producer thread under the caller's context (the
  one current when iteration starts), so an iterator that makes
  NDArrays (``io.ImageRecordIter``) makes them where the caller would;
- on the card the producer works on the feed's CUDA stream: one per
  device for every prefetcher of the process, taken once from
  ``graphs.owned_stream`` (a stream made for the process, outside
  torch's pool of 32, which capture streams also draw from) and kept,
  so a prefetcher made per epoch (``DataLoader(pin_memory=True)``)
  costs no stream and no device sync.  A host
  leaf (a numpy array, a CPU tensor or a CPU NDArray) is copied into a
  pinned staging buffer from ``storage``'s pool first, and from there
  to the card without blocking the host; the buffer goes back to the
  pool with the CUDA event of that copy, and the pool hands it out
  again only once the event has completed.
  Whatever the source ran on the card (a transpose, a cast) runs on that
  stream too;
- the producer records one event per batch; before a batch is handed
  out, the caller's current stream waits on that event and every device
  tensor of the batch is recorded on that stream (``record_stream``), so
  a ``TrainStep`` that copies the batch into its graph's static inputs
  on the current stream reads whole batches, and the allocator does not
  hand the memory back to the producer while the step still reads it.

On the CPU (a ``cpu()`` context) the leaves become CPU NDArrays (a copy
of a numpy array, as ``nd.array``); no stream is involved.

Any iterable is a source: ``(data, label)`` tuples, ``io.DataBatch``-es,
dicts or bare arrays — the structure is walked and rebuilt, array leaves
are placed (float64 as float32 and int64 as int32, as ``nd.array``
narrows them) and other leaves pass through.  ``step=`` places batches
on a ``TrainStep``'s device; ``put=`` replaces the placement of each
leaf.  ``sharding=`` (a ``NamedSharding`` of a mesh, or the step's
``data_sharding``) places each batch as the rank's local shard on the
rank's card (``distributed.device()``), as the JAX feed places a
process's shard; the step's transfer hooks (``add_transfer_hook``) see
each leaf copied for a sharding.

``stats`` carries ``produced``/``consumed``, the live ``queue_depth``
and the wait split — ``producer_wait_s`` (the producer blocked on a
full queue: the consumer sets the pace) against ``consumer_wait_s``
(the consumer blocked on an empty queue: the feed sets the pace) — and
the same numbers are profiler counters (``DevicePrefetcher::*``).  The
fault point ``prefetch.device_put`` fires before each placement.

Usage::

    step = parallel.TrainStep(net, loss_fn, opt)
    with parallel.DevicePrefetcher(loader, step=step, depth=2) as feed:
        for data, label in feed:
            loss = step(data, label)
"""
from __future__ import annotations

import queue as _queue
import threading
import time

import numpy as np
import torch

from .. import profiler as _profiler, storage
from ..context import Context, current_context
from ..fault import fire as _fire, with_context as _with_context
from ..ndarray.ndarray import NDArray, as_tensor

__all__ = ["DevicePrefetcher"]

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}
_streams = {}                      # device -> the feed's copy stream
_streams_lock = threading.Lock()


def _copy_stream(device):
    """The feed's stream on CUDA ``device`` (made at first use)."""
    with _streams_lock:
        stream = _streams.get(device)
        if stream is None:
            from ..graphs import owned_stream
            stream = _streams[device] = owned_stream(device)
        return stream


def _map_leaves(fn, item):
    """``fn`` on every array leaf (numpy array, tensor, NDArray) of a
    batch structure, the containers (namedtuples, ``io.DataBatch``)
    rebuilt around the results."""
    from ..io import DataBatch
    if isinstance(item, (NDArray, np.ndarray, torch.Tensor)):
        return fn(item)
    if isinstance(item, DataBatch):
        return DataBatch(_map_leaves(fn, item.data),
                         _map_leaves(fn, item.label),
                         pad=item.pad, index=item.index,
                         provide_data=item.provide_data,
                         provide_label=item.provide_label,
                         bucket_key=item.bucket_key)
    if isinstance(item, tuple):
        return (type(item)(*(_map_leaves(fn, x) for x in item))
                if hasattr(item, "_fields")
                else tuple(_map_leaves(fn, x) for x in item))
    if isinstance(item, list):
        return [_map_leaves(fn, x) for x in item]
    if isinstance(item, dict):
        return {k: _map_leaves(fn, v) for k, v in item.items()}
    return item


def _tensors(item, out):
    """Every device tensor of a placed batch, into ``out``."""
    _map_leaves(lambda leaf: out.append(
        leaf._data if isinstance(leaf, NDArray) else leaf), item)
    return out


class _Placer:
    """Places one batch's host leaves on ``device`` from the producer
    thread; on the card through pinned staging buffers from
    ``storage``'s pool."""

    def __init__(self, device, sharding=None):
        self.device = device
        self.sharding = sharding
        self.handles = []          # this batch's pinned staging buffers

    def __call__(self, leaf):
        if isinstance(leaf, NDArray):
            t = leaf._data
        elif isinstance(leaf, torch.Tensor):
            t = leaf
        else:
            t = None
        if t is not None and t.device == self.device:
            return leaf if isinstance(leaf, NDArray) else NDArray(t)
        if self.sharding is not None:
            from .step import _TRANSFER_HOOKS
            for fn in _TRANSFER_HOOKS:
                fn(leaf, self.sharding)
        if self.device.type != "cuda":
            return NDArray(as_tensor(leaf if t is None else t, None,
                                     self.device))
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))
        t = t.detach()
        t = t.to(_NARROW.get(t.dtype, t.dtype))
        if t.device.type != "cpu":          # another card: a device copy
            return NDArray(t.to(self.device, non_blocking=True))
        handle = storage.Storage.get().alloc(t.numel() * t.element_size(),
                                             ctx="cpu_pinned")
        self.handles.append(handle)
        buf = handle._pinned[:handle.size].view(t.dtype).view(t.shape)
        buf.copy_(t)
        return NDArray(buf.to(self.device, non_blocking=True))

    def release(self, event):
        """Give this batch's staging buffers back to the pool with the
        event of the copies that read them (the pool hands a buffer out
        again only once its event has completed)."""
        pool = storage.Storage.get()
        for handle in self.handles:
            handle.event = event
            pool.free(handle)
        self.handles = []


class DevicePrefetcher:
    """Depth-bounded asynchronous device placement over any batch
    iterable (see the module's doc)."""

    _STOP = object()

    def __init__(self, source, step=None, sharding=None, depth=2, put=None):
        if sharding is None and step is not None:
            sharding = getattr(step, "data_sharding", None)
        self._source = source
        self._step = step
        self._sharding = sharding
        self._put = put
        self._depth = max(1, int(depth))
        self._closed = False
        self._thread = None
        self._lock = threading.Lock()
        self.stats = {"produced": 0, "consumed": 0, "queue_depth": 0,
                      "producer_wait_s": 0.0, "consumer_wait_s": 0.0}
        self._depth_counter = _profiler.Counter(
            None, "DevicePrefetcher::queue_depth")
        self._cwait_counter = _profiler.Counter(
            None, "DevicePrefetcher::consumer_wait_ms")
        self._pwait_counter = _profiler.Counter(
            None, "DevicePrefetcher::producer_wait_ms")

    # ------------------------------------------------------------ targets --
    def _target(self):
        """``(device, context)``: where batches go (the step's device, or
        the caller's context's), and the context the source runs under
        (the caller's, or the step's device's)."""
        if self._step is None:
            if self._sharding is not None:
                from .. import distributed
                device = distributed.device()
                return device, Context(device)
            ctx = current_context()
            return ctx.device, ctx
        from .step import _device_of
        device = _device_of(self._step.net)
        return device, Context(device)

    # ------------------------------------------------------------ produce --
    def _produce(self, it, q, stop, device, ctx, stream):
        if stream is None:
            self._produce_loop(it, q, stop, device, ctx, None)
            return
        from ..ops.cuda import on_card
        with on_card(device.index), torch.cuda.stream(stream):
            self._produce_loop(it, q, stop, device, ctx, stream)

    def _produce_loop(self, it, q, stop, device, ctx, stream):
        placer = _Placer(device, self._sharding)
        place = placer if self._put is None else self._put
        while not stop.is_set():
            event = None
            try:
                _fire("prefetch.device_put")
                with ctx:
                    item = _map_leaves(place, next(it))
            except StopIteration:
                item = self._STOP
            except Exception as exc:   # raised on the consumer's side,
                # tagged as the producer's (the consumer's traceback
                # otherwise points at the blameless queue get)
                item = _with_context(exc, "DevicePrefetcher producer")
            if stream is not None:
                event = torch.cuda.Event()
                event.record(stream)
            placer.release(event)
            t0 = time.perf_counter()
            enqueued = False
            while not stop.is_set():
                try:
                    q.put((item, event), timeout=0.05)
                    enqueued = True
                    break
                except _queue.Full:
                    continue
            waited = time.perf_counter() - t0
            self._pwait_counter.increment(waited * 1e3)
            with self._lock:
                self.stats["producer_wait_s"] += waited
                if enqueued and item is not self._STOP \
                        and not isinstance(item, Exception):
                    # a batch dropped by a halt is not produced: keeps
                    # produced == consumed + queue_depth
                    self.stats["produced"] += 1
                self._set_depth_locked(q)
            if item is self._STOP or isinstance(item, Exception):
                return

    def _set_depth_locked(self, q):
        depth = q.qsize()
        self.stats["queue_depth"] = depth
        self._depth_counter.set_value(depth)

    # ------------------------------------------------------------ consume --
    def __iter__(self):
        if self._closed:
            raise RuntimeError("DevicePrefetcher is closed")
        self._join()                # at most one producer at a time
        device, ctx = self._target()
        stream = _copy_stream(device) if device.type == "cuda" else None
        q = _queue.Queue(self._depth)
        stop = threading.Event()
        thread = threading.Thread(
            target=self._produce,
            args=(iter(self._source), q, stop, device, ctx, stream),
            name="DevicePrefetcher-producer", daemon=True)
        self._queue, self._stop_evt, self._thread = q, stop, thread
        thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                with _profiler.scope("DevicePrefetcher.consumer_wait",
                                     cat="wait"):
                    # poll, so that a generator resumed after a newer
                    # __iter__ superseded it (its producer joined, its
                    # queue drained) ends instead of blocking for ever
                    while True:
                        try:
                            item, event = q.get(timeout=0.05)
                            break
                        except _queue.Empty:
                            if stop.is_set():
                                item, event = self._STOP, None
                                break
                waited = time.perf_counter() - t0
                self._cwait_counter.increment(waited * 1e3)
                with self._lock:
                    self.stats["consumer_wait_s"] += waited
                    self._set_depth_locked(q)
                if item is self._STOP:
                    return
                if isinstance(item, Exception):
                    raise item
                if event is not None:
                    cur = torch.cuda.current_stream(device)
                    cur.wait_event(event)
                    for t in _tensors(item, []):
                        if t.is_cuda:
                            t.record_stream(cur)
                with self._lock:
                    self.stats["consumed"] += 1
                yield item
        finally:
            # halt and join this generator's own producer: a stale
            # generator closed late must not stop a newer iteration's
            self._halt(q, stop)
            thread.join()
            if self._thread is thread:
                self._thread = None

    # ------------------------------------------------------------ cleanup --
    @staticmethod
    def _halt(q, stop):
        stop.set()
        while True:                 # unblock a producer parked on a full q
            try:
                q.get_nowait()
            except _queue.Empty:
                break

    def _join(self):
        if self._thread is not None:
            self._halt(self._queue, self._stop_evt)
            self._thread.join()
            self._thread = None

    def close(self):
        """Stop and join the producer thread; idempotent."""
        if self._closed:
            return
        self._join()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
