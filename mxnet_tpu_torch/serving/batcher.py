"""Dynamic batcher: shape-bucketed request coalescing with a latency cap
(the port of ``mxnet_tpu/serving/batcher.py``, host logic copied
unchanged).

Why buckets: on the card every unseen input signature is a new CUDA
graph — a warm-up and a capture on the serving path, under a live
deadline.  So the batcher never dispatches a raw shape: every group of
requests is padded onto a fixed grid of (batch, length) buckets, making
the number of captured graphs a *configuration constant* — at most
``len(batch) * len(length)``, all captured up front during warm-up.
``GenerationServer`` uses ``BucketSpec`` for its prefill groups;
``InferenceServer`` runs ``DynamicBatcher`` over it.

The flush policy is the classic dynamic-batching tradeoff: a batch goes
to the device when it fills the largest bucket OR when the oldest queued
request has waited ``max_delay`` — occupancy when loaded, latency when
idle.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from .. import fault as _fault
from .. import telemetry as _telemetry
from .admission import (DeadlineExceededError, RejectedError,
                        ServerClosedError)

__all__ = ["BucketSpec", "DynamicBatcher"]


def host_array(x):
    """``x`` (a torch tensor or NDArray on any device, or anything numpy
    takes) as a numpy array on the host.  bfloat16 becomes float32, an
    exact widening: numpy has no bfloat16."""
    x = getattr(x, "_data", x)          # an NDArray's tensor
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _as_leaves(data):
    """Normalize a request payload to a tuple of per-example arrays."""
    if isinstance(data, (tuple, list)):
        return tuple(host_array(d) for d in data)
    return (host_array(data),)


class BucketSpec:
    """The fixed shape grid requests are padded onto.

    ``batch``: allowed batch sizes; a group of k requests pads up to the
    smallest bucket >= k (the batcher never gathers past the largest).
    ``length``: optional sequence-length buckets applied to axis 0 of the
    FIRST payload leaf (the token axis of a language-model request);
    shorter examples pad with ``pad_value``, an example longer than the
    largest bucket is rejected at admission — it could never be served
    without an unbounded-signature recompile.  Padded batch ROWS replicate
    the last real example, so apply fns that normalise over the batch
    still see finite values.
    """

    def __init__(self, batch=(1, 2, 4, 8), length=None, pad_value=0.0):
        batch = sorted({int(b) for b in batch})
        if not batch or batch[0] < 1:
            raise ValueError(f"BucketSpec: batch buckets must be >= 1 "
                             f"integers, got {batch}")
        self.batch = tuple(batch)
        self.length = None if length is None \
            else tuple(sorted({int(l) for l in length}))
        if self.length is not None and (not self.length
                                        or self.length[0] < 1):
            raise ValueError(f"BucketSpec: length buckets must be >= 1 "
                             f"integers, got {self.length}")
        self.pad_value = pad_value

    @property
    def max_batch(self):
        return self.batch[-1]

    def batch_bucket(self, k):
        """Smallest batch bucket that fits ``k`` examples."""
        for b in self.batch:
            if b >= k:
                return b
        return self.max_batch

    def pad_example(self, data):
        """Length-pad one request payload onto the grid; returns a tuple
        of np leaves.  Raises ``RejectedError`` for a payload no bucket
        can hold — admission-time, so an unservable request is refused
        before it occupies queue space."""
        leaves = _as_leaves(data)
        if self.length is None:
            return leaves
        head = leaves[0]
        if head.ndim < 1:
            raise RejectedError(
                "BucketSpec: length bucketing needs a >=1-D first leaf, "
                f"got a scalar")
        n = head.shape[0]
        for L in self.length:
            if L >= n:
                if L > n:
                    pad = np.full((L - n,) + head.shape[1:], self.pad_value,
                                  dtype=head.dtype)
                    head = np.concatenate([head, pad], axis=0)
                return (head,) + leaves[1:]
        raise RejectedError(
            f"request length {n} exceeds the largest length bucket "
            f"{self.length[-1]} — no executable exists for this shape")

    @staticmethod
    def signature(leaves):
        """Grouping key: padded per-example (shape, dtype) per leaf."""
        return tuple((l.shape, str(l.dtype)) for l in leaves)

    def pad_group(self, group, target):
        """Stack the group's (pre-length-padded) examples into batch
        leaves of size ``target``, replicating the last example into the
        padding rows."""
        out = []
        for i in range(len(group[0].data)):
            rows = [r.data[i] for r in group]
            while len(rows) < target:
                rows.append(rows[-1])
            out.append(np.stack(rows, axis=0))
        return tuple(out)


class DynamicBatcher:
    """Producer/consumer coalescer: a bounded request queue drained by one
    batch thread that groups same-signature requests, pads them onto the
    ``BucketSpec`` grid, and hands them to ``runner(group, padded)``.

    Admission is the producer side: ``offer`` is non-blocking and raises
    ``RejectedError`` when the queue is full (load shedding — depth is
    the declared bound, never growth).  Expired requests are resolved via
    ``on_expire`` at dequeue, without touching the device.  ``idle`` (if
    given) runs on the batch thread whenever the queue goes quiet — the
    server hooks breaker probes there.

    Thread contract (mxlint ``thread-unlocked-attr`` gated): everything
    shared between ``offer``/public readers and the batch thread travels
    through the bounded ``Queue`` and ``Event``s; ``_holdover`` (the
    one-deep foreign-signature stash) is touched by the batch thread
    only.
    """

    _IDLE_TICK = 0.05      # max latency for noticing stop / running idle

    def __init__(self, runner, buckets, max_delay=0.005, capacity=64,
                 on_expire=None, on_fail=None, idle=None,
                 name="DynamicBatcher"):
        self.buckets = buckets if isinstance(buckets, BucketSpec) \
            else BucketSpec(buckets)
        self._runner = runner
        self._on_fail = on_fail    # observes requests THIS layer errors
        self._max_delay = float(max_delay)
        if capacity < 1:
            raise ValueError("DynamicBatcher: capacity must be >= 1")
        self._q = queue.Queue(maxsize=int(capacity))
        self._on_expire = on_expire
        self._idle = idle
        # makes offer's stop-check + put ATOMIC against drain's stop-set:
        # a request is either refused, or enqueued strictly before _stop is
        # observable — and the loop only exits on (stopped AND empty), so
        # every enqueued request is flushed.  Without this, a put racing
        # drain could land after the final residue sweep and hang its
        # client forever (the one way to drop an accepted request).
        self._admit_lock = threading.Lock()
        self._stop = threading.Event()
        self._started = threading.Event()
        self._holdover = []        # batch-thread-local only
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)

    # ------------------------------------------------------ producer side --
    def start(self):
        if not self._started.is_set():
            self._started.set()
            self._thread.start()

    def offer(self, req):
        """Admit one request.  Non-blocking: a full queue sheds with
        ``RejectedError`` (the caller's cue to retry elsewhere), a
        stopped batcher refuses with ``ServerClosedError``."""
        with self._admit_lock:
            if self._stop.is_set():
                raise ServerClosedError("batcher is draining — not "
                                        "admitting")
            try:
                self._q.put_nowait(req)
            except queue.Full:
                raise RejectedError(
                    f"request queue full ({self._q.maxsize}) — shedding") \
                    from None
        return req

    def depth(self):
        return self._q.qsize()

    def alive(self):
        return self._thread.is_alive()

    def drain(self, timeout=None):
        """Stop admitting, let the batch thread flush every queued
        request to a terminal state, and join it.  True when the thread
        exited within ``timeout``."""
        with self._admit_lock:       # serialize with in-flight offer()s
            self._stop.set()
        if self._started.is_set():
            self._thread.join(timeout)
        if not self._thread.is_alive():
            # never started, or already dead: there is no loop left to
            # flush the queue — resolve any stragglers right here
            # (idempotent; safe single-threaded since the loop is gone)
            self._fail_residue()
        return not self._thread.is_alive()

    # ------------------------------------------------------ consumer side --
    def _loop(self):
        try:
            while True:
                group = self._gather()
                if group is None:
                    if self._stop.is_set() and self._q.empty() \
                            and not self._holdover:
                        return
                    if self._idle is not None and not self._stop.is_set():
                        try:
                            self._idle()
                        except Exception:
                            pass     # a probe failure is breaker state,
                            #          never a dead serving loop
                    continue
                self._dispatch(group)
        finally:
            # a crashed loop must close admission BEFORE sweeping, under
            # the same lock offer() holds — otherwise a put can land just
            # after the sweep and hang its client (same race drain()
            # closes, on the crash path)
            with self._admit_lock:
                self._stop.set()
            self._fail_residue()

    def _take(self, timeout):
        """One live request from the holdover or the queue; None on
        timeout.  Expired requests resolve via ``on_expire`` here —
        in-queue, before any padding or device work."""
        while True:
            if self._holdover:
                req = self._holdover.pop(0)
            else:
                try:
                    req = self._q.get(timeout=timeout)
                except queue.Empty:
                    return None
            if req.expired():
                if self._on_expire is not None:
                    self._on_expire(req)
                elif not req.done():
                    # no server hook: resolve here — the request left the
                    # queue, so nothing downstream would ever see it again
                    req.set_error(DeadlineExceededError(
                        "deadline exceeded in queue — the request never "
                        "touched the device"))
                continue
            if req.trace is not None:       # queue wait ends at the pop
                _telemetry.end_span(req, "queue")
                _telemetry.open_span(req, "coalesce")
            return req

    def _gather(self):
        """Collect one same-signature group: up to the largest batch
        bucket, or whatever arrived within ``max_delay`` of the first
        request.  A foreign-signature arrival is stashed (one deep) and
        flushes the current group."""
        spec = self.buckets
        first = self._take(self._IDLE_TICK)
        if first is None:
            return None
        group, sig = [first], spec.signature(first.data)
        t0 = time.monotonic()
        while len(group) < spec.max_batch:
            rem = self._max_delay - (time.monotonic() - t0)
            if rem <= 0:
                break
            if self._stop.is_set() and self._q.empty() \
                    and not self._holdover:
                break            # draining: flush now, don't wait the timer
            req = self._take(min(rem, self._IDLE_TICK))
            if req is None:
                continue
            if spec.signature(req.data) != sig:
                self._holdover.append(req)
                break
            group.append(req)
        return group

    def _dispatch(self, group):
        """Pad + run one group.  Any batching-layer failure (including an
        armed ``serving.batch`` fault) resolves every request explicitly —
        an accepted request is never left hanging."""
        tspans = None
        for r in group:                   # close the coalesce window —
            if r.trace is not None:       # padding + device work follow
                _telemetry.end_span(r, "coalesce")
                if tspans is None:
                    tspans = []
                tspans.append(r.tspans["_c"])
        if tspans is not None:            # fault firings → span events
            _telemetry.push_current(tspans)
        try:
            _fault.fire("serving.batch")
            padded = self.buckets.pad_group(
                group, self.buckets.batch_bucket(len(group)))
            self._runner(group, padded)
        except Exception as exc:      # noqa: BLE001 — resolves, then state
            for r in group:
                self._resolve_error(r, exc)
        except BaseException:
            # the batch THREAD is dying (SystemExit & co. — a killed
            # replica).  The loop's finally sweeps the queue, but this
            # group already left it: resolve it here or its clients hang
            # forever — the one way to drop an accepted request.  A
            # ServerClosedError is retry-safe, which is exactly right:
            # the batch never completed, so a fleet router may re-dispatch
            # it to a live replica.
            err = ServerClosedError(
                "batch thread died mid-batch — this request was not "
                "served")
            for r in group:
                self._resolve_error(r, err)
            raise
        finally:
            if tspans is not None:
                _telemetry.pop_current()
        for r in group:
            # a runner that forgot a request is a bug, but the client
            # must still get an answer — and an honest one: the batch DID
            # run, so this must not be a RejectedError subclass (whose
            # contract is "never touched the device, retry elsewhere")
            self._resolve_error(r, RuntimeError(
                "batch completed without resolving this request — the "
                "runner dropped it (server bug); the batch did execute"))

    def _resolve_error(self, req, exc):
        """Error-resolve a request at the batching layer, keeping the
        owner's accounting honest via ``on_fail`` (without it, requests
        this layer resolves would vanish from the server's
        completed+failed+expired totals)."""
        if req.done():
            return
        req.set_error(exc)
        if self._on_fail is not None:
            self._on_fail(req, exc)

    def _fail_residue(self):
        """On loop exit (normal drain leaves nothing; a crashed loop may):
        every still-queued request gets an explicit terminal error."""
        residue = list(self._holdover)
        self._holdover = []
        while True:
            try:
                residue.append(self._q.get_nowait())
            except queue.Empty:
                break
        for req in residue:
            self._resolve_error(req, ServerClosedError(
                "server stopped before this request was served"))
