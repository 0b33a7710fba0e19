"""Samplers (the port of ``mxnet_tpu/gluon/data/sampler.py``; ref:
python/mxnet/gluon/data/sampler.py).  ``RandomSampler`` draws from the
global ``np.random`` and ``FixedBucketSampler`` from its own
``RandomState(seed)``, as in the JAX package, so the same seeds give
the same orders in both packages."""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "IntervalSampler", "FixedBucketSampler"]


class Sampler:
    """ref: class Sampler."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """ref: class SequentialSampler."""

    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """ref: class RandomSampler."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(np.random.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class IntervalSampler(Sampler):
    """ref: class IntervalSampler."""

    def __init__(self, length, interval, rollover=True):
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        starts = range(self._interval) if self._rollover else [0]
        for start in starts:
            for i in range(start, self._length, self._interval):
                yield i

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """ref: class BatchSampler — keep/discard/rollover last partial batch."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                pass
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError("last_batch must be keep/discard/rollover")

    def __len__(self):
        n = len(self._sampler)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        return (n + len(self._prev)) // self._batch_size


class FixedBucketSampler(Sampler):
    """Batch sampler that buckets variable-length sequences (ref: the
    reference's bucketing story — BucketingModule /
    gluonnlp.data.FixedBucketSampler).  Padding every batch to the
    corpus max wastes compute, and with a captured step (``TrainStep``,
    ``hybridize``) every new shape is a new CUDA graph: fixed buckets
    give a small, closed set of shapes.

    lengths: per-sample sequence lengths.
    num_buckets: bucket boundaries are evenly spaced over the length range.
    Yields lists of sample indices; every index lands in the tightest
    bucket whose key >= its length.
    """

    def __init__(self, lengths, batch_size, num_buckets=10, shuffle=False,
                 seed=0, last_batch="keep"):
        import numpy as _np
        self._lengths = _np.asarray(lengths)
        self._batch_size = batch_size
        self._shuffle = shuffle
        self._rng = _np.random.RandomState(seed)
        lo, hi = int(self._lengths.min()), int(self._lengths.max())
        num_buckets = max(1, min(num_buckets, hi - lo + 1))
        step = max(1, -(-(hi - lo + 1) // num_buckets))
        self._keys = [min(lo + step * (i + 1) - 1, hi)
                      for i in range(num_buckets)]
        self._buckets = [[] for _ in self._keys]
        for idx, ln in enumerate(self._lengths):
            for b, key in enumerate(self._keys):
                if ln <= key:
                    self._buckets[b].append(idx)
                    break
        # Trailing partial batches bring back the per-shape graph capture
        # this sampler exists to avoid: pass last_batch="pad" (tops the tail
        # up by re-sampling from the same bucket — duplicates samples, so
        # training only) or "discard" for captured training loops.  The default
        # "keep" emits the ragged tail, preserving exact-cover semantics
        # for eval consumers.
        if last_batch not in ("pad", "discard", "keep"):
            raise ValueError("last_batch must be pad/discard/keep")
        self._batches = []
        for b in self._buckets:
            for i in range(0, len(b), batch_size):
                tail = b[i:i + batch_size]
                if len(tail) < batch_size:
                    if last_batch == "discard":
                        continue
                    if last_batch == "pad":
                        j = 0
                        while len(tail) < batch_size:
                            tail.append(b[j % len(b)])
                            j += 1
                self._batches.append(tail)

    @property
    def bucket_keys(self):
        return list(self._keys)

    def __iter__(self):
        order = list(range(len(self._batches)))
        if self._shuffle:
            self._rng.shuffle(order)
            for i in order:
                batch = list(self._batches[i])
                self._rng.shuffle(batch)
                yield batch
        else:
            for i in order:
                yield list(self._batches[i])

    def __len__(self):
        return len(self._batches)

    def stats(self):
        """Human-readable bucket fill summary (ref: FixedBucketSampler
        __repr__ statistics)."""
        lines = []
        for key, b in zip(self._keys, self._buckets):
            lines.append(f"len<={key}: {len(b)} samples")
        return "\n".join(lines)
