"""RecordIO and ``mx.io`` of the port (``mxnet_tpu_torch/recordio.py``,
``io.py``) against the JAX package's: the cases of
``tests/test_recordio.py`` on the port, files that cross-load between
the two packages (native and pure-Python routes; raw, JPEG and PNG
payloads; byte-identical files), the IDX reader's errors, and the same
bits from ``NDArrayIter``/``CSVIter``/``MNISTIter`` and raw-record
``ImageRecordIter`` batches (crop, mirror, normalisation; each decode
route) with the same seeds.  Card-only cases carry the ``gpu`` marker.
"""
import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrio
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
gpu = pytest.mark.gpu
ROUTES = ["native", "python"]


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """The port's reader and writer on the native route or its twin."""
    if request.param == "python":
        monkeypatch.setattr(trio, "_LIB", None)
    return request.param


def _payloads():
    return [b"hello", b"x" * 1, b"y" * 7, b"", b"z" * 4096]


def test_native_library_built():
    assert trio.native(), "librecordio did not build or load"
    assert trio._lib() is not None


def test_recordio_roundtrip(tmp_path, route):
    f = str(tmp_path / "t.rec")
    w = trio.MXRecordIO(f, "w")
    assert w.route == route
    for p in _payloads():
        w.write(p)
    w.close()
    r = trio.MXRecordIO(f, "r")
    got = []
    while True:
        rec = r.read()
        if rec is None:
            break
        got.append(rec)
    assert got == _payloads()
    r.reset()
    assert r.read() == _payloads()[0]
    r.close()


def test_python_fallback_format_compat(tmp_path, monkeypatch):
    """Native writer and pure-Python reader (and back): one format."""
    f, g = str(tmp_path / "x.rec"), str(tmp_path / "y.rec")
    w = trio.MXRecordIO(f, "w")
    w.write(b"abc123")
    w.write(b"defgh")
    w.close()
    monkeypatch.setattr(trio, "_LIB", None)
    r = trio.MXRecordIO(f, "r")
    assert r.route == "python"
    assert r.read() == b"abc123" and r.read() == b"defgh"
    r.close()
    w2 = trio.MXRecordIO(g, "w")
    w2.write(b"pure-python")
    w2.close()
    monkeypatch.undo()
    r2 = trio.MXRecordIO(g, "r")
    assert r2.route == "native" and r2.read() == b"pure-python"
    r2.close()


def test_indexed_recordio(tmp_path, route):
    f, fi = str(tmp_path / "t.rec"), str(tmp_path / "t.idx")
    w = trio.MXIndexedRecordIO(fi, f, "w")
    for i in range(10):
        w.write_idx(i, f"record-{i}".encode())
    w.close()
    r = trio.MXIndexedRecordIO(fi, f, "r")
    assert r.keys == list(range(10))
    assert r.read_idx(7) == b"record-7"
    assert r.read_idx(0) == b"record-0"
    assert r.read_idx(9) == b"record-9"
    r.close()


def test_pack_unpack_header():
    h = trio.IRHeader(0, 3.0, 42, 0)
    s = trio.pack(h, b"payload")
    assert s == jrio.pack(jrio.IRHeader(0, 3.0, 42, 0), b"payload")
    h2, p = trio.unpack(s)
    assert h2.label == 3.0 and h2.id == 42 and p == b"payload"
    h = trio.IRHeader(0, [1.0, 2.0, 3.0], 1, 0)
    s = trio.pack(h, b"xy")
    assert s == jrio.pack(jrio.IRHeader(0, [1.0, 2.0, 3.0], 1, 0), b"xy")
    h2, p = trio.unpack(s)
    np.testing.assert_allclose(h2.label, [1, 2, 3])
    assert p == b"xy"


@pytest.mark.parametrize("fmt", [".png", ".jpg", ".raw"])
def test_pack_unpack_img_matches_jax(fmt):
    img = np.random.RandomState(3).randint(0, 256, (24, 32, 3)) \
        .astype(np.uint8)
    s = trio.pack_img(trio.IRHeader(0, 5.0, 0, 0), img, img_fmt=fmt)
    assert s == jrio.pack_img(jrio.IRHeader(0, 5.0, 0, 0), img, img_fmt=fmt)
    h, back = trio.unpack_img(s)
    _, jback = jrio.unpack_img(s)
    assert h.label == 5.0
    np.testing.assert_array_equal(back, jback)
    if fmt != ".jpg":
        np.testing.assert_array_equal(back, img)   # lossless
    for iscolor in (0, 1):
        np.testing.assert_array_equal(trio.unpack_img(s, iscolor)[1],
                                      jrio.unpack_img(s, iscolor)[1])


def test_encoded_payloads_need_pil(monkeypatch):
    """Without PIL a JPEG/PNG record raises a clear ImportError; raw
    records need nothing."""
    import builtins
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real(name, *a, **k)

    png = trio.pack_img(trio.IRHeader(0, 1.0, 0, 0),
                        np.zeros((4, 4, 3), np.uint8), img_fmt=".png")
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="raw records"):
        trio.unpack_img(png)
    with pytest.raises(ImportError, match="needs PIL"):
        trio.pack_img(trio.IRHeader(0, 1.0, 0, 0),
                      np.zeros((4, 4, 3), np.uint8), img_fmt=".jpg")
    raw = trio.pack_img(trio.IRHeader(0, 1.0, 0, 0),
                        np.ones((4, 4, 3), np.uint8), img_fmt=".raw")
    assert trio.unpack_img(raw)[1].sum() == 48


# -------------------------------------------------- files across packages --
def _images(n, seed=0, hw=(24, 20)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw + (3,)).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("fmt", [".raw", ".jpg", ".png"])
def test_files_cross_load_and_are_byte_identical(tmp_path, route, fmt):
    """The port (on ``route``) and the JAX package write the same bytes
    for the same records, and each reads the other's file."""
    imgs = _images(6)
    paths = {}
    for who, rio in (("port", trio), ("jax", jrio)):
        rec, idx = str(tmp_path / f"{who}.rec"), str(tmp_path / f"{who}.idx")
        w = rio.MXIndexedRecordIO(idx, rec, "w")
        for i, img in enumerate(imgs):
            w.write_idx(i, rio.pack_img(rio.IRHeader(0, float(i), i, 0), img,
                                        img_fmt=fmt))
        w.close()
        paths[who] = (rec, idx)
    for k in (0, 1):
        assert open(paths["port"][k], "rb").read() == \
            open(paths["jax"][k], "rb").read()
    for reader, writer in ((trio, "jax"), (jrio, "port")):
        rec, idx = paths[writer]
        r = reader.MXIndexedRecordIO(idx, rec, "r")
        for i in reversed(range(len(imgs))):
            h, img = reader.unpack_img(r.read_idx(i))
            assert h.label == float(i) and h.id == i
            if fmt != ".jpg":
                np.testing.assert_array_equal(img, imgs[i])
        r.close()


# ------------------------------------------------------------- NDArrayIter --
def _collect(it):
    return [([d.asnumpy() for d in b.data],
             [lab.asnumpy() for lab in (b.label or [])], b.pad) for b in it]


def _same_batches(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        for x, y in zip(da + la, db + lb):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def test_ndarray_iter_pad_and_discard():
    x = np.arange(25, dtype=np.float32).reshape(25, 1)
    y = np.arange(25, dtype=np.float32)
    with tmx.cpu():
        it = tio.NDArrayIter(x, y, batch_size=10, last_batch_handle="pad")
        batches = list(it)
        assert len(batches) == 3 and batches[-1].pad == 5
        assert batches[0].data[0].shape == (10, 1)
        it2 = tio.NDArrayIter(x, y, batch_size=10,
                              last_batch_handle="discard")
        assert len(list(it2)) == 2
        assert len(list(it2)) == 2
    desc = it.provide_data[0]
    assert desc.name == "data" and desc.shape == (10, 1)


def test_ndarray_iter_shuffle_covers_all():
    x = np.arange(12, dtype=np.float32).reshape(12, 1)
    with tmx.cpu():
        it = tio.NDArrayIter(x, None, batch_size=4, shuffle=True)
        seen = np.concatenate([b.data[0].asnumpy().ravel() for b in it])
    assert sorted(seen.tolist()) == list(range(12))


def test_ndarray_iter_roll_over():
    x = np.arange(10, dtype=np.float32).reshape(10, 1)
    with tmx.cpu():
        it = tio.NDArrayIter(x, None, batch_size=4,
                             last_batch_handle="roll_over")
        e1 = [b.data[0].asnumpy().ravel().tolist() for b in it]
        assert e1 == [[0, 1, 2, 3], [4, 5, 6, 7]]
        e2 = [b.data[0].asnumpy().ravel().tolist() for b in it]
    assert e2[0] == [8, 9, 0, 1] and len(e2) == 3


@pytest.mark.parametrize("last", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle,seed", [(False, None), (True, 7)])
def test_ndarray_iter_same_bits_as_jax(last, shuffle, seed):
    rng = np.random.RandomState(1)
    data = {"a": rng.randn(23, 3).astype(np.float64),
            "b": rng.randint(0, 9, (23, 2)).astype(np.int64)}
    label = rng.randint(0, 5, (23,)).astype(np.float32)
    kw = dict(batch_size=5, shuffle=shuffle, last_batch_handle=last,
              seed=seed)
    jit = jio.NDArrayIter(data, label, **kw)
    with tmx.cpu():
        tit = tio.NDArrayIter(data, label, **kw)
        for _ in range(2):             # two epochs: roll_over carries over
            _same_batches(_collect(tit), _collect(jit))
    assert tit.provide_data == jit.provide_data
    assert tit.provide_label == jit.provide_label


def test_csv_iter_same_bits_as_jax(tmp_path):
    rng = np.random.RandomState(2)
    d, lab = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(d, rng.rand(10, 6), delimiter=",")
    np.savetxt(lab, rng.randint(0, 3, (10, 1)), delimiter=",")
    kw = dict(data_csv=d, data_shape=(2, 3), label_csv=lab, batch_size=3)
    with tmx.cpu():
        _same_batches(_collect(tio.CSVIter(**kw)), _collect(jio.CSVIter(**kw)))


# --------------------------------------------------------------- IDX files --
def _idx(path, dims, dtype=0x08, payload=None, magic=b"\x00\x00"):
    hdr = magic + bytes([dtype, len(dims)]) + b"".join(
        int(d).to_bytes(4, "big") for d in dims)
    body = payload if payload is not None else \
        np.arange(int(np.prod(dims)), dtype=np.uint64).astype(np.uint8) \
        .tobytes()
    with (gzip.open if str(path).endswith(".gz") else open)(path, "wb") as f:
        f.write(hdr + body)
    return str(path)


@pytest.mark.parametrize("case", ["magic", "dtype", "header", "payload",
                                  "payload_long"])
def test_corrupt_idx_raises_the_same_value_error(tmp_path, case):
    p = tmp_path / "bad-idx1-ubyte"
    if case == "magic":
        _idx(p, (4,), magic=b"\x01\x00")
    elif case == "dtype":
        _idx(p, (4,), dtype=0x0D)
    elif case == "header":
        p.write_bytes(b"\x00\x00\x08\x03\x00\x00")
    elif case == "payload":
        _idx(p, (4, 5), payload=b"\x00" * 7)
    else:
        _idx(p, (2,), payload=b"\x00" * 3)
    with pytest.raises(ValueError) as te:
        tio._read_idx(str(p))
    with pytest.raises(ValueError) as je:
        jio._read_idx(str(p))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("flat", [False, True])
def test_mnist_iter_same_bits_as_jax(tmp_path, flat):
    rng = np.random.RandomState(4)
    n = 30
    img = _idx(tmp_path / "img-idx3-ubyte.gz", (n, 28, 28),
               payload=rng.randint(0, 256, n * 784).astype(np.uint8)
               .tobytes())
    lab = _idx(tmp_path / "lab-idx1-ubyte.gz", (n,),
               payload=rng.randint(0, 10, n).astype(np.uint8).tobytes())
    kw = dict(image=img, label=lab, batch_size=8, flat=flat, seed=3)
    with tmx.cpu():
        _same_batches(_collect(tio.MNISTIter(**kw)),
                      _collect(jio.MNISTIter(**kw)))
        # no paths: the synthetic MNIST stand-in, shuffled from the seed
        t = _collect(tio.MNISTIter(batch_size=512, flat=flat, seed=1))[:3]
    _same_batches(t, _collect(jio.MNISTIter(batch_size=512, flat=flat,
                                            seed=1))[:3])
    with pytest.raises(ValueError, match="not found"):
        tio.MNISTIter(image=img, label=str(tmp_path / "nope"))


# ------------------------------------------------------------ image records --
def _write_raw(path, n=20, hw=(40, 36), seed=0, classes=10):
    rec, idx = path + ".rec", path + ".idx"
    w = trio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(seed)
    for i in range(n):
        img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
        w.write_idx(i, trio.pack_img(trio.IRHeader(0, float(i % classes), i,
                                                   0), img, img_fmt=".raw"))
    w.close()
    return rec, idx


RECORD_ROUTES = {"native": {}, "in-process": {"use_native_decode": False},
                 "workers": {"use_native_decode": False,
                             "preprocess_threads": 2}}


@pytest.mark.parametrize("decode", sorted(RECORD_ROUTES))
def test_image_record_iter_raw_same_bits_as_jax(tmp_path, decode):
    """Raw records with shuffle, random crop, mirror and mean/std
    normalisation: the same batches, bit for bit, over two epochs, on
    each decode route of both packages."""
    rec, _ = _write_raw(str(tmp_path / "r"))
    kw = dict(data_shape=(3, 32, 32), batch_size=8, shuffle=True,
              rand_crop=True, rand_mirror=True, resize=36, seed=5,
              mean_r=123.7, mean_g=116.3, mean_b=103.5, std_r=58.4,
              std_g=57.1, std_b=57.4, **RECORD_ROUTES[decode])
    jit = jio.ImageRecordIter(rec, **kw)
    with tmx.cpu():
        tit = tio.ImageRecordIter(rec, **kw)
        assert (tit._native is not None) == (decode == "native")
        assert (tit._pool is not None) == (decode == "workers")
        for _ in range(2):
            _same_batches(_collect(tit), _collect(jit))
    tit.close()
    jit.close()


def _make_img_tree(root, n_classes=2, per_class=6):
    from PIL import Image
    rng = np.random.RandomState(0)
    for c in range(n_classes):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            arr = (rng.rand(40 + c, 48, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"img{i}.png"))


def test_im2rec_and_image_record_iter(tmp_path):
    """``tools/im2rec.py`` (the JAX package's writer) packs a folder;
    the port's iterator reads it, as the JAX one does."""
    root = str(tmp_path / "imgs")
    _make_img_tree(root)
    prefix = str(tmp_path / "data")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                        "im2rec.py"),
                           prefix, root], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    kw = dict(path_imgrec=prefix + ".rec", data_shape=(3, 32, 32),
              batch_size=5, shuffle=True, rand_mirror=True)
    with tmx.cpu():
        it = tio.ImageRecordIter(**kw)
        batches = list(it)
        assert len(batches) == 3
        b = batches[0]
        assert b.data[0].shape == (5, 3, 32, 32)
        assert b.label[0].shape == (5,)
        labels = np.concatenate([b.label[0].asnumpy() for b in batches])
        assert set(labels.astype(int).tolist()) == {0, 1}
        assert len(list(it)) == 3
        _same_batches(_collect(tio.ImageRecordIter(**kw)),
                      _collect(jio.ImageRecordIter(**kw)))


def test_image_record_iter_normalisation(tmp_path):
    root = str(tmp_path / "imgs")
    _make_img_tree(root, n_classes=1, per_class=3)
    prefix = str(tmp_path / "n")
    import tools.im2rec as im2rec
    im2rec.pack(prefix, root)
    with tmx.cpu():
        it = tio.ImageRecordIter(path_imgrec=prefix + ".rec",
                                 data_shape=(3, 24, 24), batch_size=3,
                                 mean_r=127.0, mean_g=127.0, mean_b=127.0,
                                 std_r=58.0, std_g=58.0, std_b=58.0)
        v = next(iter(it)).data[0].asnumpy()
    assert abs(v.mean()) < 0.5 and 0.2 < v.std() < 3.0


def test_indexed_reads_return_their_records(tmp_path):
    """The packed-record read path over 512 records of 64 KB (the JAX
    suite's throughput smoke, without its wall-clock bound)."""
    f, fi = str(tmp_path / "t.rec"), str(tmp_path / "t.idx")
    w = trio.MXIndexedRecordIO(fi, f, "w")
    payloads = [os.urandom(64 * 1024) for _ in range(8)]
    for i in range(512):
        w.write_idx(i, payloads[i % 8])
    w.close()
    r = trio.MXIndexedRecordIO(fi, f, "r")
    assert r.route == "native"
    for i in reversed(range(512)):
        assert r.read_idx(i) == payloads[i % 8]
    r.close()


def test_image_record_iter_label_width_and_close(tmp_path):
    f, fi = str(tmp_path / "m.rec"), str(tmp_path / "m.idx")
    w = trio.MXIndexedRecordIO(fi, f, "w")
    rng = np.random.RandomState(0)
    for i in range(4):
        img = (rng.rand(16, 16, 3) * 255).astype(np.uint8)
        header = trio.IRHeader(0, [float(i), float(i * 10), 7.0], i, 0)
        w.write_idx(i, trio.pack_img(header, img, img_fmt=".png"))
    w.close()
    with tmx.cpu():
        with tio.ImageRecordIter(path_imgrec=f, data_shape=(3, 16, 16),
                                 batch_size=2, label_width=3) as it:
            b = next(iter(it))
            assert b.label[0].shape == (2, 3)
            np.testing.assert_allclose(b.label[0].asnumpy()[0], [0, 0, 7])
    assert it._rec is None
    with pytest.raises(TypeError, match="unsupported options"):
        tio.ImageRecordIter(path_imgrec=f, data_shape=(3, 16, 16),
                            batch_size=2, not_a_real_option=1)


def _held_batch_survives(tmp_path, ctx):
    rec, _ = _write_raw(str(tmp_path / "h"), n=12)
    with ctx:
        it = tio.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                                 batch_size=4)
        itr = iter(it)
        b1 = next(itr)
        snap = b1.data[0].asnumpy().copy()
        next(itr)                       # would recycle b1's buffer
        next(itr)
        np.testing.assert_array_equal(b1.data[0].asnumpy(), snap)
        it.close()
    return b1


def test_image_record_iter_batch_survives_next(tmp_path):
    _held_batch_survives(tmp_path, tmx.cpu())


@gpu
def test_image_record_iter_batch_survives_next_on_card(tmp_path):
    """On the card the batch leaves a pinned buffer by a copy that does
    not block; the buffer is reused only after that copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    b1 = _held_batch_survives(tmp_path, tmx.gpu(0))
    assert b1.data[0].context.device_type == "gpu"
    rec = str(tmp_path / "h.rec")
    with tmx.cpu():
        host = next(iter(tio.ImageRecordIter(path_imgrec=rec,
                                             data_shape=(3, 32, 32),
                                             batch_size=4)))
    np.testing.assert_array_equal(b1.data[0].asnumpy(),
                                  host.data[0].asnumpy())


def test_native_decode_matches_pil_path_and_jax(tmp_path):
    """The port's native batch decoder agrees with its PIL path on a
    deterministic config, and gives the JAX package's native decoder's
    bits."""
    assert tio._native_decoder() is not None, \
        tmx.base.native_status().get("libimagedecode")
    f, fi = str(tmp_path / "j.rec"), str(tmp_path / "j.idx")
    w = trio.MXIndexedRecordIO(fi, f, "w")
    rng = np.random.RandomState(0)
    for i in range(6):
        img = (rng.rand(40, 48, 3) * 255).astype(np.uint8)
        w.write_idx(i, trio.pack_img(trio.IRHeader(0, float(i), i, 0), img,
                                     img_fmt=".jpg", quality=95))
    w.close()
    kw = dict(path_imgrec=f, data_shape=(3, 32, 32), batch_size=6)
    with tmx.cpu():
        nat = next(iter(tio.ImageRecordIter(**kw)))
        pil = next(iter(tio.ImageRecordIter(use_native_decode=False, **kw)))
        np.testing.assert_allclose(nat.data[0].asnumpy(),
                                   pil.data[0].asnumpy(), atol=1.0)
        np.testing.assert_array_equal(nat.label[0].asnumpy(),
                                      pil.label[0].asnumpy())
        rnd = dict(kw, rand_crop=True, rand_mirror=True, seed=9)
        _same_batches(_collect(tio.ImageRecordIter(**rnd)),
                      _collect(jio.ImageRecordIter(**rnd)))


def test_raw_records_roundtrip_and_iterate(tmp_path):
    rng = np.random.RandomState(1)
    img = (rng.rand(36, 40, 3) * 255).astype(np.uint8)
    s = trio.pack_img(trio.IRHeader(0, 2.0, 0, 0), img, img_fmt=".raw")
    hdr, back = trio.unpack_img(s)
    np.testing.assert_array_equal(back, img)
    assert hdr.label == 2.0
    rec, _ = _write_raw(str(tmp_path / "r"), n=4, hw=(36, 40))
    with tmx.cpu():
        b = next(iter(tio.ImageRecordIter(path_imgrec=rec,
                                          data_shape=(3, 32, 32),
                                          batch_size=4)))
    assert b.data[0].shape == (4, 3, 32, 32)
    np.testing.assert_array_equal(b.label[0].asnumpy(), [0, 1, 2, 3])


def test_image_record_iter_num_parts(tmp_path):
    rec, _ = _write_raw(str(tmp_path / "p"), n=10, hw=(16, 16), classes=10)
    seen = []
    with tmx.cpu():
        for part in range(3):
            kw = dict(path_imgrec=rec, data_shape=(3, 16, 16), batch_size=2,
                      num_parts=3, part_index=part, round_batch=False)
            got = [lab for b in tio.ImageRecordIter(**kw)
                   for lab in b.label[0].asnumpy().astype(int).tolist()]
            want = [lab for b in jio.ImageRecordIter(**kw)
                    for lab in b.label[0].asnumpy().astype(int).tolist()]
            assert got == want
            seen.extend(got)
    assert sorted(seen) == sorted(set(seen))
    assert len(seen) >= 8
    with pytest.raises(ValueError, match="part_index"):
        tio.ImageRecordIter(path_imgrec=rec, data_shape=(3, 16, 16),
                            batch_size=2, num_parts=2, part_index=2)


def test_resize_iter_and_data_desc():
    x = np.arange(12, dtype=np.float32).reshape(12, 1)
    with tmx.cpu():
        t = _collect(tio.ResizeIter(tio.NDArrayIter(x, batch_size=4), 5))
    _same_batches(t, _collect(jio.ResizeIter(jio.NDArrayIter(
        x, batch_size=4), 5)))
    assert tio.DataDesc("d", (2, 3)) == jio.DataDesc("d", (2, 3))
