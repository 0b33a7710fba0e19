"""Shape buckets: the fixed (batch, length) grid requests pad onto.

The port's ``BucketSpec`` (``mxnet_tpu/serving/batcher.py``), copied
unchanged.  ``GenerationServer`` groups prompts by length bucket and
pads each group to a batch bucket, so every prefill runs one of a fixed
set of shapes that ``start()`` warms up.  The classifier-serving
``DynamicBatcher`` is not ported yet.
"""
from __future__ import annotations

import numpy as np

from .admission import RejectedError

__all__ = ["BucketSpec"]


def _as_leaves(data):
    """Normalize a request payload to a tuple of per-example arrays."""
    if isinstance(data, (tuple, list)):
        return tuple(np.asarray(d) for d in data)
    return (np.asarray(data),)


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
