"""``gluon.data`` of the port (``mxnet_tpu_torch/gluon/data``) against
the JAX package's: the cases of ``tests/test_dataloader.py`` on the
port, the same bits from the DataLoader (no workers, a thread pool,
forked workers, ``pin_memory``) with the same ``np.random`` seed, the
samplers, the vision datasets (MNIST's synthetic split equal to JAX's
bit for bit), the transforms (the registered image ops underneath) and
``examples/train_mnist_mlp.py``'s ``main()`` as written with the port
bound as ``mx``.  Card-only cases carry the ``gpu`` marker.
"""
import contextlib
import importlib.util
import io
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu_torch.gluon import data as tdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
gpu = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")


def _ds(pkg, n=22, d=3):
    x = np.arange(n * d, dtype=np.float32).reshape(n, d)
    y = np.arange(n, dtype=np.float32)
    return pkg.gluon.data.ArrayDataset(x, y)


def _collect(loader):
    return [(d.asnumpy(), lab.asnumpy()) for d, lab in loader]


def _same(a, b):
    assert len(a) == len(b)
    for (ad, al), (bd, bl) in zip(a, b):
        for x, y in ((ad, bd), (al, bl)):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------- DataLoader --
@pytest.mark.parametrize("thread_pool", [False, True])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_multiworker_matches_serial_in_order(thread_pool, last_batch):
    ds = _ds(tmx)
    with tmx.cpu():
        want = _collect(tdata.DataLoader(ds, batch_size=4, num_workers=0,
                                         last_batch=last_batch))
        with tdata.DataLoader(ds, batch_size=4, num_workers=2,
                              thread_pool=thread_pool,
                              last_batch=last_batch) as loader:
            got = _collect(loader)
    assert len(got) == {"keep": 6, "discard": 5, "rollover": 5}[last_batch]
    _same(got, want)
    _same(got, _collect(jdata.DataLoader(_ds(jmx), batch_size=4,
                                         last_batch=last_batch)))


class _SlowDataset(tdata.Dataset):
    def __init__(self, n=8, delay=2.0):
        self._n = n
        self._delay = delay

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        time.sleep(self._delay)
        return np.zeros(2, np.float32), np.float32(i)


def test_timeout_raises_timeout_error_not_hang():
    loader = tdata.DataLoader(_SlowDataset(delay=0.5), batch_size=4,
                              num_workers=1, thread_pool=True, timeout=0.1)
    with pytest.raises(TimeoutError, match="timeout=0.1"):
        with tmx.cpu():
            next(iter(loader))
    loader.close()


@pytest.mark.parametrize("num_workers", [0, 2])
def test_pin_memory_async_put_path(num_workers):
    ds = _ds(tmx, 16)
    with tmx.cpu():
        want = _collect(tdata.DataLoader(ds, batch_size=4, num_workers=0))
        with tdata.DataLoader(ds, batch_size=4, num_workers=num_workers,
                              thread_pool=True, pin_memory=True) as loader:
            got = _collect(loader)
            got2 = _collect(loader)     # a second pass restarts cleanly
    _same(got, want)
    _same(got2, want)


def test_pin_memory_yields_ndarrays_on_the_context():
    with tmx.cpu():
        with tdata.DataLoader(_ds(tmx, 8), batch_size=4,
                              pin_memory=True) as loader:
            d, lab = next(iter(loader))
    assert isinstance(d, tmx.nd.NDArray) and isinstance(lab, tmx.nd.NDArray)
    assert d.shape == (4, 3) and d.context == tmx.cpu()


def test_close_is_deterministic_and_idempotent():
    loader = tdata.DataLoader(_ds(tmx, 8), batch_size=4, num_workers=2,
                              thread_pool=True)
    with tmx.cpu():
        assert len(_collect(loader)) == 2
    loader.close()
    loader.close()
    assert loader._pool is None
    with pytest.raises(RuntimeError, match="closed"):
        next(iter(loader))


def test_context_manager_closes_pool():
    with tdata.DataLoader(_ds(tmx, 8), batch_size=4, num_workers=2,
                          thread_pool=True) as loader:
        with tmx.cpu():
            _collect(loader)
    assert loader._pool is None


def _mnist_tensor(pkg, train=False):
    v = pkg.gluon.data.vision
    return v.MNIST(train=train).transform_first(v.transforms.ToTensor())


WORKERS = {"none": {}, "threads": {"num_workers": 2, "thread_pool": True},
           "processes": {"num_workers": 2}, "pinned": {"pin_memory": True}}


@pytest.mark.parametrize("workers", sorted(WORKERS))
def test_mnist_totensor_batches_same_bits_as_jax(workers):
    """The example's loader — MNIST through ``ToTensor``, shuffled from
    the global ``np.random`` — gives the JAX package's batches bit for
    bit on every worker route; worker samples are made on the host."""
    np.random.seed(11)
    want = _collect(jdata.DataLoader(_mnist_tensor(jmx), batch_size=256,
                                     shuffle=True))
    np.random.seed(11)
    with tmx.cpu():
        with tdata.DataLoader(_mnist_tensor(tmx), batch_size=256,
                              shuffle=True, **WORKERS[workers]) as loader:
            got = _collect(loader)
    _same(got, want)
    assert got[0][0].shape == (256, 1, 28, 28) and got[0][1].dtype == np.int32


@gpu
@pytest.mark.parametrize("workers", sorted(WORKERS))
def test_card_batches_equal_host_batches(workers):
    """On the card (the default context) workers still make samples on
    the host — a forked worker must not touch CUDA — and the batches
    equal the in-process ones."""
    _card()
    np.random.seed(12)
    with tdata.DataLoader(_mnist_tensor(tmx), batch_size=256,
                          shuffle=True) as loader:
        want = [(d, lab) for d, lab in loader][:3]
    np.random.seed(12)
    with tdata.DataLoader(_mnist_tensor(tmx), batch_size=256, shuffle=True,
                          **WORKERS[workers]) as loader:
        got = [(d, lab) for d, lab in loader][:3]
    assert got[0][0].context == tmx.gpu(0)
    _same([(d.asnumpy(), lab.asnumpy()) for d, lab in got],
          [(d.asnumpy(), lab.asnumpy()) for d, lab in want])


def test_worker_exception_is_tagged_and_pool_closed():
    class Bad(tdata.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("sample 5")
            return np.zeros(2, np.float32)

    loader = tdata.DataLoader(Bad(), batch_size=4, num_workers=2,
                              thread_pool=True)
    with pytest.raises(KeyError, match="DataLoader worker, batch 1"):
        with tmx.cpu():
            _collect_one = [d.asnumpy() for d in loader]   # noqa: F841
    assert loader._pool is None


# ----------------------------------------------------------------- samplers --
def test_samplers_same_orders_as_jax():
    for t, j in ((tdata.SequentialSampler(7, 2), jdata.SequentialSampler(7, 2)),
                 (tdata.IntervalSampler(10, 3), jdata.IntervalSampler(10, 3)),
                 (tdata.IntervalSampler(10, 3, rollover=False),
                  jdata.IntervalSampler(10, 3, rollover=False))):
        assert list(t) == list(j) and len(t) == len(j)
    np.random.seed(5)
    t = list(tdata.RandomSampler(30))
    np.random.seed(5)
    assert t == list(jdata.RandomSampler(30))
    for last in ("keep", "discard", "rollover"):
        tb = tdata.BatchSampler(tdata.SequentialSampler(10), 3, last)
        jb = jdata.BatchSampler(jdata.SequentialSampler(10), 3, last)
        assert [list(tb), list(tb)] == [list(jb), list(jb)]
        assert len(tb) == len(jb)
    with pytest.raises(ValueError):
        list(tdata.BatchSampler(tdata.SequentialSampler(10), 3, "bogus"))


@pytest.mark.parametrize("last_batch", ["keep", "pad", "discard"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_fixed_bucket_sampler_same_as_jax(last_batch, shuffle):
    lengths = np.random.RandomState(6).randint(3, 60, 97)
    kw = dict(batch_size=8, num_buckets=5, shuffle=shuffle, seed=4,
              last_batch=last_batch)
    t = tdata.FixedBucketSampler(lengths, **kw)
    j = jdata.FixedBucketSampler(lengths, **kw)
    assert t.bucket_keys == j.bucket_keys and len(t) == len(j)
    assert [list(t), list(t)] == [list(j), list(j)]
    assert t.stats() == j.stats()


# ----------------------------------------------------------------- datasets --
@pytest.mark.parametrize("name,kw", [("MNIST", {}), ("MNIST", {"train": False}),
                                     ("FashionMNIST", {}),
                                     ("CIFAR10", {"train": False}),
                                     ("CIFAR100", {"train": False})])
def test_synthetic_datasets_equal_jax_bit_for_bit(name, kw, tmp_path):
    root = str(tmp_path / "none")            # no files: the stand-in
    t = getattr(tdata.vision, name)(root=root, **kw)
    j = getattr(jdata.vision, name)(root=root, **kw)
    assert len(t) == len(j)
    np.testing.assert_array_equal(t._data, j._data)
    np.testing.assert_array_equal(t._label, j._label)
    assert t._data.dtype == j._data.dtype == np.uint8
    x, y = t[3]
    np.testing.assert_array_equal(x, j[3][0])
    assert y == j[3][1]


def test_mnist_reads_idx_gz_files(tmp_path):
    import gzip
    import struct
    rng = np.random.RandomState(8)
    imgs = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labs = rng.randint(0, 10, 5).astype(np.uint8)
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with gzip.open(tmp_path / "t10k-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labs.tobytes())
    t = tdata.vision.MNIST(root=str(tmp_path), train=False)
    j = jdata.vision.MNIST(root=str(tmp_path), train=False)
    np.testing.assert_array_equal(t._data[..., 0], imgs)
    np.testing.assert_array_equal(t._data, j._data)
    np.testing.assert_array_equal(t._label, labs.astype(np.int32))


def test_dataset_methods_match_jax():
    t, j = _ds(tmx, 10), _ds(jmx, 10)
    for tt, jj in ((t.take(4), j.take(4)), (t.shard(3, 1), j.shard(3, 1)),
                   (t.filter(lambda s: s[1] % 2 == 0),
                    j.filter(lambda s: s[1] % 2 == 0)),
                   (t.transform(lambda x, y: (x * 2, y), lazy=False),
                    j.transform(lambda x, y: (x * 2, y), lazy=False))):
        assert len(tt) == len(jj)
        for a, b in zip(tt, jj):
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
    s = tdata.SimpleDataset([1, 2, 3]).transform(lambda v: v + 1)
    assert [s[i] for i in range(3)] == [2, 3, 4]


def test_record_file_and_image_datasets(tmp_path):
    from PIL import Image
    from mxnet_tpu_torch import recordio
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (12, 10, 3)).astype(np.uint8)
            for _ in range(3)]
    for i, img in enumerate(imgs):
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(i), i, 0),
                                         img, img_fmt=".png"))
    w.close()
    raw = tdata.RecordFileDataset(rec)
    assert len(raw) == 3 and raw[1] == jdata.RecordFileDataset(rec)[1]
    with tmx.cpu():
        ds = tdata.vision.ImageRecordDataset(rec)
        img, label = ds[2]
    np.testing.assert_array_equal(img.asnumpy(), imgs[2])
    assert label == 2.0
    root = tmp_path / "folder"
    for c in ("cat", "dog"):
        (root / c).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(imgs[i]).save(root / c / f"{i}.png")
    with tmx.cpu():
        folder = tdata.vision.ImageFolderDataset(str(root))
        assert folder.synsets == ["cat", "dog"] and len(folder) == 4
        img, label = folder[3]
    np.testing.assert_array_equal(img, imgs[1])
    assert label == 1


# --------------------------------------------------------------- transforms --
def _img(seed=0, hw=(30, 26)):
    return np.random.RandomState(seed).randint(0, 256, hw + (3,)) \
        .astype(np.uint8)


TRANSFORMS = {
    "ToTensor": lambda T: T.ToTensor(),
    "Cast": lambda T: T.Cast("float16"),
    "Normalize": lambda T: T.Compose([T.ToTensor(), T.Normalize(
        mean=(0.4, 0.5, 0.6), std=(0.2, 0.3, 0.25))]),
    "Resize": lambda T: T.Resize((20, 16)),
    "Resize up": lambda T: T.Resize(40),
    "CenterCrop": lambda T: T.CenterCrop((20, 14)),
    "CropResize": lambda T: T.CropResize(2, 3, 16, 20, size=(12, 10)),
    "Compose": lambda T: T.Compose([T.Resize(24), T.CenterCrop(16),
                                    T.ToTensor()]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    img = _img()
    want = TRANSFORMS[name](jdata.vision.transforms)(img).asnumpy()
    with tmx.cpu():
        got = TRANSFORMS[name](tdata.vision.transforms)(img)
        assert isinstance(got, tmx.nd.NDArray)
        got = got.asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.uint8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_random_transforms_hold_their_invariants():
    T = tdata.vision.transforms
    img = _img(1)
    with tmx.cpu():
        tmx.random.seed(3)
        flips = {tuple(T.RandomFlipLeftRight()(img).asnumpy()[0, :, 0])
                 for _ in range(12)}
        assert flips == {tuple(img[0, :, 0]), tuple(img[0, ::-1, 0])}
        np.random.seed(2)
        tb = {tuple(T.RandomFlipTopBottom()(img).asnumpy()[:, 0, 0])
              for _ in range(12)}
        assert tb == {tuple(img[:, 0, 0]), tuple(img[::-1, 0, 0])}
        f = img.astype(np.float32)
        out = T.RandomBrightness(0.3)(f).asnumpy()
        ratio = out[f > 0] / f[f > 0]
        assert np.allclose(ratio, ratio[0]) and 0.7 <= ratio[0] <= 1.3
        out = T.RandomContrast(0.3)(f).asnumpy()
        assert out.shape == f.shape and np.isfinite(out).all()
        np.random.seed(4)
        crop = T.RandomResizedCrop(16)(img)
        assert crop.shape == (16, 16, 3) and crop.dtype == np.uint8


# ---------------------------------------------------------- the example ----
def test_mnist_example_main_runs_as_written_on_the_port(monkeypatch):
    """``examples/train_mnist_mlp.py``'s ``main()`` unchanged, with the
    port bound as ``mxnet_tpu`` (the way chip_smoke runs it): one epoch
    on the host reaches a useful accuracy."""
    path = os.path.join(REPO, "examples", "train_mnist_mlp.py")
    monkeypatch.setitem(sys.modules, "mxnet_tpu", tmx)
    monkeypatch.setattr(sys, "argv", [path, "--epochs", "2"])
    spec = importlib.util.spec_from_file_location("_mnist_port", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.mx is tmx and mod.gluon is tmx.gluon
    out = io.StringIO()
    tmx.random.seed(0)
    np.random.seed(0)
    with tmx.cpu(), contextlib.redirect_stdout(out):
        mod.main()
    lines = out.getvalue().splitlines()
    assert len(lines) == 2 and lines[-1].startswith("epoch 1:")
    acc = float(lines[-1].split("val_acc=")[1].split()[0])
    assert acc >= 0.9, lines


def test_jax_package_forked_workers_cannot_pickle_transform_first():
    """A reference defect the port does not copy (ROADMAP queue C): the
    JAX package pickles the dataset with every batch it sends to a
    forked worker, and a ``transform_first`` dataset holds a closure
    that cannot be pickled; the port's workers get the dataset when
    they are forked."""
    with jdata.DataLoader(_mnist_tensor(jmx), batch_size=64,
                          num_workers=2) as loader:
        with pytest.raises(AttributeError, match="base_fn"):
            next(iter(loader))
    with tmx.cpu():
        with tdata.DataLoader(_mnist_tensor(tmx), batch_size=64,
                              num_workers=2) as loader:
            x, _ = next(iter(loader))
    assert x.shape == (64, 1, 28, 28)


def test_close_with_batches_in_flight_does_not_hang():
    """Closing a forked-worker loader right after its first batch, while
    the other prefetched 4 MB batches are still being written back:
    ``close()`` lets them land before it terminates the workers (a
    worker killed mid-write holds the result queue's lock, and
    ``Pool.terminate()`` then hangs).  A time-bounded stress over 20
    loaders."""
    x = np.zeros((64, 512, 512), np.float32)
    ds = tdata.ArrayDataset(x, np.arange(64, dtype=np.float32))
    for _ in range(20):
        done = []

        def body():
            with tmx.cpu():
                with tdata.DataLoader(ds, batch_size=4,
                                      num_workers=2) as loader:
                    next(iter(loader))
            done.append(True)

        th = threading.Thread(target=body, daemon=True)
        th.start()
        th.join(timeout=60)
        assert done and not th.is_alive()
