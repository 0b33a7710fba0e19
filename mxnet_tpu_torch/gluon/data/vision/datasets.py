"""Vision datasets (the port of
``mxnet_tpu/gluon/data/vision/datasets.py``).

ref: python/mxnet/gluon/data/vision/datasets.py — MNIST, FashionMNIST,
CIFAR10, CIFAR100, ImageRecordDataset, ImageFolderDataset.

Nothing is downloaded: each dataset reads its files from a local root if
they are there, and otherwise makes the JAX package's deterministic
synthetic stand-in of the same shape and dtype (``_synthetic_images``,
the same seeds, so both packages give the same arrays bit for bit).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    """ref: datasets.py — _DownloadedDataset."""

    def __init__(self, root, train, transform):
        self._transform = transform
        self._train = train
        self._root = os.path.expanduser(root)
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _synthetic_images(n, shape, num_classes, seed, proto_seed=7):
    """Deterministic class-separable synthetic images: class k gets a distinct
    mean pattern + noise, so small models can genuinely converge on it.

    The class prototypes come from ``proto_seed`` (SHARED between the train
    and test splits — otherwise the test split would be unlearnable); only
    the label draws and noise differ per split via ``seed``."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=(n,)).astype(np.int32)
    protos = np.random.RandomState(proto_seed).uniform(
        0, 255, size=(num_classes,) + shape).astype(np.float32)
    noise = rng.normal(0, 32, size=(n,) + shape).astype(np.float32)
    data = np.clip(protos[labels] * 0.5 + 64 + noise, 0, 255).astype(np.uint8)
    return data, labels


class MNIST(_DownloadedDataset):
    """ref: class MNIST — (28,28,1) uint8 images, int32 labels."""

    _shape = (28, 28, 1)
    _num_classes = 10
    _files = {True: ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
              False: ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz")}
    _synthetic_n = {True: 8192, False: 1024}

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        img_f, lbl_f = self._files[self._train]
        img_path = os.path.join(self._root, img_f)
        lbl_path = os.path.join(self._root, lbl_f)
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            with gzip.open(lbl_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                label = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
            with gzip.open(img_path, "rb") as f:
                _, n, rows, cols = struct.unpack(">IIII", f.read(16))
                data = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                    n, rows, cols, 1)
            self._data, self._label = data, label
        else:
            self._data, self._label = _synthetic_images(
                self._synthetic_n[self._train], self._shape,
                self._num_classes, seed=42 if self._train else 43)


class FashionMNIST(MNIST):
    """ref: class FashionMNIST."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """ref: class CIFAR10 — (32,32,3) uint8."""

    _shape = (32, 32, 3)
    _num_classes = 10
    _synthetic_n = {True: 8192, False: 1024}

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if self._train
                 else ["test_batch.bin"])
        paths = [os.path.join(self._root, "cifar-10-batches-bin", f)
                 for f in files]
        if all(os.path.exists(p) for p in paths):
            data_l, label_l = [], []
            for p in paths:
                raw = np.fromfile(p, dtype=np.uint8).reshape(-1, 3073)
                label_l.append(raw[:, 0].astype(np.int32))
                data_l.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                              .transpose(0, 2, 3, 1))
            self._data = np.concatenate(data_l)
            self._label = np.concatenate(label_l)
        else:
            self._data, self._label = _synthetic_images(
                self._synthetic_n[self._train], self._shape,
                self._num_classes, seed=44 if self._train else 45)


class CIFAR100(CIFAR10):
    """ref: class CIFAR100."""

    _num_classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        self._data, self._label = _synthetic_images(
            self._synthetic_n[self._train], self._shape,
            self._num_classes, seed=46 if self._train else 47)


class ImageRecordDataset(Dataset):
    """ref: class ImageRecordDataset — images packed in RecordIO."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import image as img_mod
        from .... import recordio
        raw = self._record[idx]
        header, payload = recordio.unpack(raw)
        image = img_mod.imdecode(payload, flag=self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(image, label)
        return image, label

    def __len__(self):
        return len(self._record)


class ImageFolderDataset(Dataset):
    """ref: class ImageFolderDataset — folder-per-class layout."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        self._list_images(self._root)

    def _list_images(self, root):
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith((".jpg", ".jpeg", ".png", ".npy")):
                    self.items.append((os.path.join(path, fname), label))

    def __getitem__(self, idx):
        from .... import image as img_mod
        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = np.load(path)
        else:
            img = img_mod.imread(path, flag=self._flag).asnumpy()
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
