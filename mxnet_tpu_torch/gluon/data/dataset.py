"""Datasets (the port of ``mxnet_tpu/gluon/data/dataset.py``).

ref: python/mxnet/gluon/data/dataset.py — Dataset, SimpleDataset,
ArrayDataset, RecordFileDataset, _LazyTransformDataset.
"""
from __future__ import annotations

import os

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """ref: class Dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """ref: Dataset.transform."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """ref: Dataset.transform_first."""
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)
        return self.transform(base_fn, lazy)

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def shard(self, num_shards, index):
        """ref: Dataset.shard — contiguous split for multi-worker input."""
        assert 0 <= index < num_shards
        n = len(self)
        per = (n + num_shards - 1) // num_shards
        lo = min(index * per, n)
        hi = min(lo + per, n)
        return SimpleDataset([self[i] for i in range(lo, hi)])


class SimpleDataset(Dataset):
    """ref: class SimpleDataset — wrap a list."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """ref: class ArrayDataset — zip of arrays/datasets."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for a in args:
            assert len(a) == self._length, "all arrays must have the same length"
            self._data.append(a)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """ref: class RecordFileDataset — raw records from a RecordIO pack."""

    def __init__(self, filename):
        from ... import recordio
        self._filename = filename
        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
