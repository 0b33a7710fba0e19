"""DataLoader (the port of ``mxnet_tpu/gluon/data/dataloader.py``).

ref: python/mxnet/gluon/data/dataloader.py — class DataLoader,
_MultiWorkerIter (worker processes, batchify, pin_memory).

Samples are made and batchified on the host, as MXNet's workers make
them: in this process (``num_workers=0``), in a thread pool
(``thread_pool=True``) or in forked worker processes, each under the
port's ``cpu()`` scope, so a transform that builds NDArrays
(``transforms.ToTensor``) builds them on the host even where the card
is the default context — a forked child must not touch CUDA — and
every batch reaches the device once, from the parent: as NDArrays on
the caller's current context, or with ``pin_memory=True`` through a
``parallel.DevicePrefetcher``, which stages it in pinned memory and
copies it on a stream of its own while the caller computes.

Forked workers get the dataset and the batchify function when they are
forked, not pickled with every batch (a ``transform_first`` closure
cannot be pickled); only the sample indices go out and the numpy
batches come back.
"""
from __future__ import annotations

import multiprocessing as mp
import sys
import time

import numpy as np

from ...context import cpu
from ...ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (NDArrays with ``nd.stack``, tuples
    field by field, anything else as a numpy array, float64 as
    float32)."""
    if isinstance(data[0], NDArray):
        from ... import ndarray as nd
        return nd.stack(*data, axis=0)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


default_mp_batchify_fn = default_batchify_fn


def _as_numpy_sample(s):
    if isinstance(s, NDArray):
        return s.asnumpy()
    if isinstance(s, tuple):
        return tuple(_as_numpy_sample(x) for x in s)
    return s


def _host_batch(dataset, samples, batchify_fn):
    """One batch of ``samples``, made on the host."""
    with cpu():
        return batchify_fn([_as_numpy_sample(dataset[i]) for i in samples])


def _to_device_batch(batch):
    """A host batch as NDArrays on the current context (one copy per
    leaf)."""
    if isinstance(batch, np.ndarray):
        from ... import ndarray as nd
        return nd.array(batch)
    if isinstance(batch, tuple):
        return (type(batch)(*map(_to_device_batch, batch))
                if hasattr(batch, "_fields")
                else tuple(_to_device_batch(b) for b in batch))
    if isinstance(batch, list):
        return [_to_device_batch(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _to_device_batch(v) for k, v in batch.items()}
    return batch


_worker = {}       # a forked worker's dataset and batchify function


def _worker_initializer(dataset, batchify_fn):
    """Runs once in each forked worker: the dataset arrives by fork."""
    import torch
    torch.set_num_threads(1)        # one core per worker, as torch's own
    _worker["dataset"], _worker["batchify"] = dataset, batchify_fn


def _worker_fn(key, samples):
    return key, _host_batch(_worker["dataset"], samples, _worker["batchify"])


def _thread_fn(dataset, batchify_fn, key, samples):
    return key, _host_batch(dataset, samples, batchify_fn)


class DataLoader:
    """Batches of a ``Dataset`` (ref: class DataLoader)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=None, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120):
        if num_workers is None:
            # MXNET_CPU_WORKER_NTHREADS sets the default
            from ... import config as _config
            num_workers = _config.get("MXNET_CPU_WORKER_NTHREADS")
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler "
                                 "is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle and sampler are mutually exclusive")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError("batch_sampler is mutually exclusive with "
                             "batch_size/shuffle/sampler/last_batch")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._thread_pool = thread_pool
        self._pool = None
        self._issued = {}           # batch index -> the workers' AsyncResult
        self._closed = False
        if self._num_workers > 0:
            if thread_pool:
                from multiprocessing.dummy import Pool
                self._pool = Pool(self._num_workers)
            else:
                ctx = mp.get_context("fork") if sys.platform != "win32" \
                    else mp.get_context()
                self._pool = ctx.Pool(self._num_workers,
                                      initializer=_worker_initializer,
                                      initargs=(dataset, self._batchify_fn))

    def __iter__(self):
        if self._closed:
            raise RuntimeError("DataLoader is closed")
        if not self._pin_memory:
            for batch in self._host_batches():
                yield _to_device_batch(batch)
            return
        # pin_memory: the prefetcher stages batch N+1 in pinned memory and
        # copies it to the device on its own stream while the caller
        # computes on batch N; the device-side queue holds whole batches,
        # so its depth is capped apart from the host-side prefetch
        from ...parallel.prefetch import DevicePrefetcher
        with DevicePrefetcher(self._host_batches(),
                              depth=min(max(1, self._prefetch or 1),
                                        3)) as feed:
            yield from feed

    def _host_batches(self):
        """Yield batchified host (numpy) batches, from the workers when
        there are any (ref: _MultiWorkerIter — async map with bounded
        prefetch).  A worker's exception re-raises here tagged with its
        batch index, after ``close()`` has torn the pool down."""
        from ... import fault as _fault
        if self._pool is None:
            for samples in self._batch_sampler:
                _fault.fire("io.producer")
                yield _host_batch(self._dataset, samples, self._batchify_fn)
            return
        issued = self._issued = {}
        batches = list(self._batch_sampler)
        next_issue = 0
        next_yield = 0

        def _issue():
            nonlocal next_issue
            if next_issue < len(batches):
                key = next_issue
                if self._thread_pool:
                    issued[key] = self._pool.apply_async(
                        _thread_fn, (self._dataset, self._batchify_fn, key,
                                     batches[key]))
                else:
                    issued[key] = self._pool.apply_async(
                        _worker_fn, (key, batches[key]))
                next_issue += 1

        for _ in range(self._prefetch or 1):
            _issue()
        while next_yield < len(batches):
            try:
                _fault.fire("io.producer")
                _, batch = issued[next_yield].get(self._timeout)
            except mp.TimeoutError:
                # no close() here: joining a pool still stuck inside the
                # slow task would turn a prompt timeout into a hang; the
                # caller owns teardown after a timeout
                raise TimeoutError(
                    f"DataLoader worker batch {next_yield} not ready within "
                    f"timeout={self._timeout}s") from None
            except Exception as exc:
                self.close()
                raise _fault.with_context(
                    exc, f"DataLoader worker, batch {next_yield}") from exc
            del issued[next_yield]
            _issue()
            next_yield += 1
            yield batch

    def __len__(self):
        return len(self._batch_sampler)

    def close(self):
        """Shut the worker pool down; idempotent.  The loader cannot be
        iterated afterwards.  Batches still in flight land first (for at
        most ``timeout`` seconds): a worker killed while it writes a
        result holds the result queue's lock, and ``terminate()`` would
        then hang."""
        self._closed = True
        pool, self._pool = self._pool, None
        if pool is not None:
            deadline = time.monotonic() + self._timeout
            for res in list(self._issued.values()):
                res.wait(max(0.0, deadline - time.monotonic()))
            pool.terminate()
            pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
