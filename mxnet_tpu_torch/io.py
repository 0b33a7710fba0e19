"""``mx.io`` — the data iterators (the port of ``mxnet_tpu/io.py``).

ref: python/mxnet/io/io.py — DataIter / DataBatch / DataDesc / NDArrayIter /
CSVIter; src/io/iter_image_recordio_2.cc — ImageRecordIter (threaded packed-
record image pipeline).  Decode and augmentation run on the host — native
JPEG decode threads (``libimagedecode``), forked worker processes, or
this process — over the RecordIO reader (``recordio``), and each batch
becomes NDArrays on the current context once, when it is read.  The
orders and random draws are the JAX package's (``np.random`` and
``RandomState(seed)`` streams), so the same seeds give the same batches
bit for bit.

``ImageRecordIter`` assembles each batch in a pooled host buffer
(``storage.Storage``).  For the card the buffer is pinned, the batch is
copied from it without blocking the host, and the buffer is recycled
with the CUDA event of that copy, so it is not written again before the
copy has read it (``storage``'s pinned pool waits on the event).
"""
from __future__ import annotations

import os
import queue as _queue
import threading
import time
from collections import namedtuple

import numpy as np

from . import recordio
from .fault import fire as _fire, with_context as _with_context
from .ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "MNISTIter", "ImageRecordIter", "ResizeIter", "PrefetchingIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """ref: io.DataDesc."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)


class DataBatch:
    """ref: io.DataBatch (bucket_key routes BucketingModule batches)."""

    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None, bucket_key=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label
        self.bucket_key = bucket_key


class DataIter:
    """ref: io.DataIter — reset/next/iter protocol."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def reset(self):
        pass

    def next(self):
        raise NotImplementedError

    def __next__(self):
        return self.next()

    def __iter__(self):
        self.reset()
        return self

    @property
    def provide_data(self):
        raise NotImplementedError

    @property
    def provide_label(self):
        raise NotImplementedError


def _to_nd(arr):
    from . import ndarray as nd
    return arr if isinstance(arr, NDArray) else nd.array(arr)


def _current_device():
    from .context import current_context
    return current_context().device


class NDArrayIter(DataIter):
    """ref: io.NDArrayIter — batches over in-memory arrays with pad/discard/
    roll_over last-batch handling and optional shuffle."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None):
        super().__init__(batch_size)
        self._data = self._init_arrays(data, data_name)
        self._label = self._init_arrays(label, label_name)
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed) if seed is not None else None
        self._last = last_batch_handle
        self._n = self._data[0][1].shape[0] if self._data else 0
        for _, a in self._data + self._label:
            assert a.shape[0] == self._n, "data/label batch axes disagree"
        self._base_order = np.arange(self._n)
        self._order = self._base_order
        self._leftover = None
        self.reset()

    @staticmethod
    def _init_arrays(data, default_name):
        if data is None:
            return []
        if isinstance(data, (np.ndarray, NDArray)):
            data = {default_name: data}
        if isinstance(data, (list, tuple)):
            data = {f"{default_name}{i if i else ''}": d
                    for i, d in enumerate(data)}
        out = []
        for k, v in data.items():
            v = v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)
            out.append((k, v))
        return out

    def reset(self):
        self._order = self._base_order.copy()
        if self._shuffle:
            (self._rng or np.random).shuffle(self._order)
        if self._last == "roll_over" and self._leftover is not None:
            # remainder from the previous pass leads this epoch (ref:
            # NDArrayIter roll_over semantics)
            self._order = np.concatenate([self._leftover, self._order])
            self._leftover = None
        self._cursor = 0

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self._data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self._label]

    def next(self):
        n = len(self._order)
        if self._cursor >= n:
            raise StopIteration
        end = self._cursor + self.batch_size
        pad = 0
        if end > n:
            if self._last == "discard":
                raise StopIteration
            if self._last == "pad":
                pad = end - n
            elif self._last == "roll_over":
                # stash the remainder; reset() prepends it next epoch
                self._leftover = self._order[self._cursor:]
                raise StopIteration
        idx = self._order[self._cursor:min(end, n)]
        if pad:
            idx = np.concatenate([idx, self._order[:pad]])
        self._cursor = end
        data = [_to_nd(v[idx]) for _, v in self._data]
        label = [_to_nd(v[idx]) for _, v in self._label]
        return DataBatch(data, label, pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


class _WrappedIter(DataIter):
    """Common NDArrayIter-delegation base for file-backed iterators
    (CSVIter, MNISTIter)."""

    _it: NDArrayIter

    def reset(self):
        self._it.reset()

    def next(self):
        return self._it.next()

    @property
    def provide_data(self):
        return self._it.provide_data

    @property
    def provide_label(self):
        return self._it.provide_label


class CSVIter(_WrappedIter):
    """ref: io.CSVIter — numeric csv rows → batches."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32, ndmin=2)
        self._inner_data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",",
                               dtype=np.float32, ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
        self._it = NDArrayIter(self._inner_data, label, batch_size,
                               last_batch_handle="discard")


def _read_idx(path):
    """Parse one IDX file (ref: the MNIST ubyte format the reference's
    MNISTIter reads), .gz or raw.

    The 4-byte magic is validated before any parsing: bytes 0-1 must be
    zero, byte 2 is the dtype code (only ``0x08`` = uint8 is supported —
    the MNIST family), byte 3 the rank; and the payload must hold exactly
    ``prod(dims)`` bytes.  A truncated download, an int32 IDX file, or a
    gzip-of-something-else raises a ``ValueError`` naming the path
    instead of being reinterpreted as uint8 garbage pixels."""
    import gzip

    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    if len(raw) < 4 or raw[0] != 0 or raw[1] != 0:
        raise ValueError(
            f"{path!r} is not an IDX file: magic bytes 0-1 must be zero "
            f"(got {raw[:2]!r})")
    if raw[2] != 0x08:
        raise ValueError(
            f"{path!r}: IDX dtype byte is 0x{raw[2]:02x}, only 0x08 "
            f"(uint8, the MNIST family) is supported — convert the file "
            f"or use NDArrayIter over your own arrays")
    ndim = raw[3]
    header_len = 4 + 4 * ndim
    if len(raw) < header_len:
        raise ValueError(
            f"{path!r}: truncated IDX header (rank {ndim} needs "
            f"{header_len} bytes, file has {len(raw)})")
    dims = [int.from_bytes(raw[4 + 4 * i:8 + 4 * i], "big")
            for i in range(ndim)]
    expect = header_len + int(np.prod(dims, dtype=np.int64))
    if len(raw) != expect:
        raise ValueError(
            f"{path!r}: IDX payload is {len(raw) - header_len} bytes but "
            f"dims {tuple(dims)} require {expect - header_len} "
            f"(truncated or corrupt download?)")
    return np.frombuffer(raw, np.uint8, offset=header_len).reshape(dims)


class MNISTIter(_WrappedIter):
    """ref: io.MNISTIter — the classic MNIST iterator.

    With explicit ``image``/``label`` IDX paths (the reference's calling
    convention) the files are parsed directly — missing paths raise, never
    silently substitute.  Without paths, the gluon MNIST dataset backs the
    iterator (real files when present, the in-tree synthetic stand-in in
    zero-egress environments)."""

    def __init__(self, image=None, label=None, batch_size=128, shuffle=True,
                 flat=False, seed=0, **kwargs):
        super().__init__(batch_size)
        import os

        if image or label:
            for p in (image, label):
                if not p or not os.path.exists(p):
                    raise ValueError(
                        f"MNISTIter: IDX file {p!r} not found; pass both "
                        f"image= and label= paths, or neither (gluon "
                        f"MNIST dataset fallback)")
            xs = _read_idx(image).astype(np.float32) / 255.0
            ys = _read_idx(label).astype(np.float32)
        else:
            from .gluon.data.vision import MNIST

            ds = MNIST(train=True)
            xs = np.asarray(ds._data, np.float32).reshape(
                len(ds), 28, 28) / 255.0
            ys = np.asarray(ds._label, np.float32)
        n = xs.shape[0]
        xs = xs.reshape(n, -1) if flat else xs.reshape(n, 1, 28, 28)  # NCHW
        self._it = NDArrayIter(xs, ys, batch_size, shuffle=shuffle,
                               seed=seed)


class AugSpec:
    """Batch-wide augmentation amplitudes shared by the native decoder
    (src/image_decode.cc AugParams — keep the float layout in sync) and
    the python fallback chain (_color_chain_np)."""

    __slots__ = ("rrc", "min_area", "max_area", "min_aspect", "max_aspect",
                 "brightness", "contrast", "saturation", "hue", "pca_noise")

    def __init__(self, rrc=False, min_area=1.0, max_area=1.0,
                 min_aspect=1.0, max_aspect=1.0, brightness=0.0,
                 contrast=0.0, saturation=0.0, hue=0.0, pca_noise=0.0):
        self.rrc = rrc
        self.min_area, self.max_area = min_area, max_area
        self.min_aspect, self.max_aspect = min_aspect, max_aspect
        self.brightness, self.contrast = brightness, contrast
        self.saturation, self.hue = saturation, hue
        self.pca_noise = pca_noise

    @property
    def any_color(self):
        return (self.brightness > 0 or self.contrast > 0
                or self.saturation > 0 or self.hue > 0 or self.pca_noise > 0)

    @property
    def active(self):
        return self.rrc or self.any_color

    def to_array(self):
        return np.array([1.0 if self.rrc else 0.0, self.min_area,
                         self.max_area, self.min_aspect, self.max_aspect,
                         self.brightness, self.contrast, self.saturation,
                         self.hue, self.pca_noise], np.float32)


def _color_chain_np(x, aug, rng):
    """Python twin of src/image_decode.cc color_chain: brightness ->
    contrast -> saturation -> hue -> pca lighting on HWC float32 0-255.
    The math lives once, in image.py's jitter_* kernels; this only draws
    the per-image alphas (from ``rng``, a RandomState, rather than the
    native per-image xorshift — the bit-level oracle lives in
    tests/test_image_native_aug.py)."""
    from . import image as img_mod
    if aug.brightness > 0:
        x = img_mod.jitter_brightness(
            x, 1 + (2 * rng.rand() - 1) * aug.brightness)
    if aug.contrast > 0:
        x = img_mod.jitter_contrast(
            x, 1 + (2 * rng.rand() - 1) * aug.contrast)
    if aug.saturation > 0:
        x = img_mod.jitter_saturation(
            x, 1 + (2 * rng.rand() - 1) * aug.saturation)
    if aug.hue > 0:
        x = img_mod.jitter_hue(x, (2 * rng.rand() - 1) * aug.hue)
    if aug.pca_noise > 0:
        x = img_mod.pca_lighting(
            x, rng.normal(0, aug.pca_noise, size=(3,)).astype(np.float32))
    return x


def _native_decoder():
    """``libimagedecode`` (``src/image_decode.cc``: the decode threads of
    the reference's iter_image_recordio_2.cc), built at first use like
    the other host natives, with its argument types; None when it cannot
    be built (no compiler, no libjpeg headers: ``base.native_status()``
    says why) — the iterator then decodes in Python."""
    import ctypes

    from .base import load_native_lib
    lib = load_native_lib("libimagedecode")
    if lib is None or not hasattr(lib, "mxtpu_decode_batch_aug"):
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    for name, extra in (("mxtpu_decode_batch_aug",
                         [ctypes.POINTER(ctypes.c_float)]),
                        ("mxtpu_decode_batch", [])):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.POINTER(ctypes.c_char_p),
                        ctypes.POINTER(ctypes.c_long), ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, ip, ip, u8p,
                        ctypes.POINTER(ctypes.c_uint32)] + extra
                       + [u8p, u8p, ctypes.c_int])
    return lib


class ImageRecordIter(DataIter):
    """Packed-record image pipeline (ref: iter_image_recordio_2.cc —
    ImageRecordIOParser2; API: mx.io.ImageRecordIter).

    Decode paths, fastest available first:
      * native (default when built): one ctypes call per batch decodes
        every JPEG record in ``preprocess_threads`` NATIVE threads (no
        GIL, no fork/IPC) with in-thread resize-short/crop/mirror —
        ``use_native_decode=False`` opts out;
      * raw records (``pack_img(img_fmt=".raw")``) skip decode entirely
        (numpy crop/mirror — the pre-decoded uint8 fast path);
      * PIL, in ``preprocess_threads`` forked worker processes,
        otherwise (raw records take that route too when the native
        decoder is not built).
    Then mean/std normalisation, yielding NCHW float batches.
    """

    def __init__(self, path_imgrec, data_shape, batch_size, path_imgidx=None,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, resize=-1, preprocess_threads=0, seed=0,
                 round_batch=True, label_width=1, use_native_decode=None,
                 num_parts=1, part_index=0,
                 random_resized_crop=False, min_random_area=1.0,
                 max_random_area=1.0, min_aspect_ratio=None,
                 max_aspect_ratio=0.0, random_h=0, random_s=0, random_l=0,
                 max_random_contrast=0.0, max_random_illumination=0.0,
                 pca_noise=0.0, **kwargs):
        super().__init__(batch_size)
        _IGNORED_OK = {"prefetch_buffer", "data_name", "label_name",
                       "verify_decode",
                       "shuffle_chunk_size", "shuffle_chunk_seed",
                       "inter_method", "dtype", "ctx", "device_id"}
        unknown = set(kwargs) - _IGNORED_OK
        if unknown:
            raise TypeError(f"ImageRecordIter: unsupported options "
                            f"{sorted(unknown)} (supported reference "
                            f"options with no meaning here are accepted "
                            f"silently: {sorted(_IGNORED_OK)})")
        self._label_width = int(label_width)
        self._shape = tuple(data_shape)  # (C, H, W)
        assert len(self._shape) == 3
        if path_imgidx is None:
            path_imgidx = os.path.splitext(path_imgrec)[0] + ".idx"
        self._rec_path = path_imgrec
        self._idx_path = path_imgidx
        self._rec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
        self._keys = list(self._rec.keys)
        if not self._keys:
            raise IOError(f"empty or unindexed record file {path_imgrec!r}")
        # data sharding (ref: ImageRecordIter num_parts/part_index — one
        # iterator per worker/loader process reads a disjoint key slice;
        # this is also how the raw path scales across host cores)
        if not 0 <= part_index < num_parts:
            raise ValueError(f"part_index {part_index} outside "
                             f"num_parts {num_parts}")
        if num_parts > 1:
            self._keys = self._keys[part_index::num_parts]
            if not self._keys:
                raise IOError(
                    f"part {part_index}/{num_parts} of {path_imgrec!r} "
                    f"is empty")
        self._shuffle = shuffle
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._resize = resize
        # Color/geometry augmentation amplitudes (ref: image_aug_default.cc
        # DefaultImageAugmentParam).  HSL knob mapping onto the RGB-space
        # jitter chain: random_h (degrees, 0-180) -> hue amplitude h/180;
        # random_s (0-255) -> saturation s/255; random_l and
        # max_random_illumination (0-255) -> brightness factor l/255.
        if random_resized_crop:
            if not rand_crop:
                rand_crop = self._rand_crop = True
            if min_aspect_ratio is None:
                min_aspect_ratio = (1.0 / max_aspect_ratio
                                    if max_aspect_ratio > 1.0 else 3.0 / 4.0)
            if max_aspect_ratio <= 0:
                max_aspect_ratio = 4.0 / 3.0
        self._aug = AugSpec(
            rrc=bool(random_resized_crop),
            min_area=float(min_random_area), max_area=float(max_random_area),
            min_aspect=float(min_aspect_ratio or 1.0),
            max_aspect=float(max_aspect_ratio or 1.0),
            brightness=max(float(random_l) / 255.0,
                           float(max_random_illumination) / 255.0),
            contrast=float(max_random_contrast),
            saturation=float(random_s) / 255.0,
            hue=float(random_h) / 180.0,
            pca_noise=float(pca_noise))
        c = self._shape[0]
        self._mean = np.array([mean_r, mean_g, mean_b][:c] or [mean_r],
                              np.float32)
        self._std = np.array([std_r, std_g, std_b][:c] or [std_r],
                             np.float32)
        self._rng = np.random.RandomState(seed)
        self._round = round_batch
        self._inflight = None  # previous batch's pooled buffer handle
        self._pending = None   # (keys, future/AsyncResult) prefetched batch
        self._pool = None
        self._native = None
        self._executor = None  # lazy single prefetch thread (native path)
        self._nthreads = max(int(preprocess_threads or 0), 1)
        if use_native_decode is not False and self._shape[0] == 3:
            self._native = _native_decoder()
        if use_native_decode is True and self._native is None:
            if self._shape[0] != 3:
                raise RuntimeError(
                    "use_native_decode=True: the native decode path only "
                    "produces 3-channel output (got data_shape "
                    f"{self._shape})")
            from .base import native_status
            raise RuntimeError(
                "use_native_decode=True but libimagedecode could not be "
                "built: " + str(native_status().get("libimagedecode", {})
                                .get("error")))
        if self._native is None and preprocess_threads \
                and preprocess_threads > 1:
            import multiprocessing as mp
            self._pool = mp.get_context("fork").Pool(preprocess_threads)
        self.reset()

    def _decode_executor(self):
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor
            self._executor = ThreadPoolExecutor(1)
        return self._executor

    def _decode(self, key):
        s = self._rec.read_idx(key)
        header, img = recordio.unpack_img(
            s, iscolor=0 if self._shape[0] == 1 else 1)
        return header, img

    def _augment(self, img, rng=None):
        return _augment_img(img, self._shape, self._resize, self._rand_crop,
                            self._rand_mirror, self._mean, self._std,
                            rng if rng is not None else self._rng,
                            aug=self._aug)

    def _native_batch(self, keys, rng):
        """Whole-batch decode through src/image_decode.cc: JPEG records in
        native threads, raw records via numpy; non-JPEG/non-raw (PNG) and
        JPEGs libjpeg cannot convert (CMYK) fall back to PIL per image.
        Returns (headers, (n,C,H,W) uint8).  ``rng`` is a per-batch
        RandomState so a prefetch thread never races the iterator's."""
        import ctypes
        c, h, w = self._shape
        n = len(keys)
        out = np.empty((n, c, h, w), np.uint8)
        headers = [None] * n
        blobs, jpeg_idx = [], []
        for i, k in enumerate(keys):
            hdr, payload = recordio.unpack(self._rec.read_idx(k))
            headers[i] = hdr
            if payload[:3] == b"\xff\xd8\xff":
                jpeg_idx.append(i)
                blobs.append(payload)
            else:
                # raw or PNG: the python path handles both cheaply
                img = recordio.img_from_payload(payload, iscolor=1)
                out[i] = _crop_aug_u8(img, self._shape, self._resize,
                                      self._rand_crop, self._rand_mirror,
                                      rng, aug=self._aug)
        if jpeg_idx:
            lib = self._native
            m = len(blobs)
            # bytes are immutable and the C side is const: pass their
            # buffers directly, no per-blob copy (blobs stays alive here)
            ptrs = (ctypes.c_char_p * m)(*blobs)
            sizes = (ctypes.c_long * m)(*[len(b) for b in blobs])
            cxv = -2 if self._rand_crop else -1
            mrv = 2 if self._rand_mirror else 0
            cx = (ctypes.c_int * m)(*([cxv] * m))
            cy = (ctypes.c_int * m)(*([cxv] * m))
            mir = (ctypes.c_uint8 * m)(*([mrv] * m))
            seeds = (ctypes.c_uint32 * m)(
                *[int(s) for s in rng.randint(1, 2 ** 31, size=m)])
            dec = np.empty((m, c, h, w), np.uint8)
            ok = np.empty((m,), np.uint8)
            aug_arr = self._aug.to_array() if self._aug.active else None
            lib.mxtpu_decode_batch_aug(
                ptrs, sizes, m, h, w, self._resize, cx, cy, mir, seeds,
                None if aug_arr is None else
                aug_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                dec.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._nthreads)
            for j, i in enumerate(jpeg_idx):
                if ok[j]:
                    out[i] = dec[j]
                else:
                    # e.g. CMYK JPEG: PIL's convert("RGB") handles what
                    # libjpeg's colorspace conversion won't
                    img = recordio.img_from_payload(blobs[j], iscolor=1)
                    out[i] = _crop_aug_u8(img, self._shape, self._resize,
                                          self._rand_crop,
                                          self._rand_mirror, rng,
                                          aug=self._aug)
        return headers, out

    def _drain_pending(self):
        """Wait out an in-flight prefetch: the native path's future, so
        the stateful record reader is never used from two threads, and
        the worker pool's batch, so no worker is still writing it when
        the pool is terminated (a worker killed while it writes a
        result holds the result queue's lock, and ``terminate()`` then
        hangs)."""
        pend = getattr(self, "_pending", None)
        if pend is None:
            return
        if hasattr(pend[1], "result"):
            try:
                pend[1].result()
            except Exception:       # its error belongs to a dropped batch
                pass
        else:
            pend[1].wait()

    def reset(self):
        self._drain_pending()
        self._order = list(self._keys)
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0
        self._pending = None  # drop any prefetched batch from a past epoch

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self._shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self._label_width == 1 \
            else (self.batch_size, self._label_width)
        return [DataDesc("softmax_label", shape)]

    def close(self):
        """Release the record reader and the worker pool."""
        self._drain_pending()
        self._pending = None
        if getattr(self, "_inflight", None) is not None:
            from . import storage
            storage.Storage.get().free(self._inflight)
            self._inflight = None
        if getattr(self, "_pool", None) is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
        if getattr(self, "_executor", None) is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        if getattr(self, "_rec", None) is not None:
            self._rec.close()
            self._rec = None

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _keys_at(self, cursor):
        """Keys (padded) for the batch starting at ``cursor``, or None."""
        if cursor >= len(self._order):
            return None, 0
        keys = self._order[cursor:cursor + self.batch_size]
        pad = self.batch_size - len(keys)
        if pad and not self._round:
            return None, 0
        while len(keys) < self.batch_size:
            keys = keys + self._order[:self.batch_size - len(keys)]
        return keys, pad

    def _issue(self, keys):
        """Kick off decode+augment of ``keys`` in the worker pool; the
        workers do the whole per-image pipeline (ref:
        ImageRecordIOParser2's decode threads) — the parent only
        assembles.  Per-item seeds keep augmentation deterministic."""
        iscolor = 0 if self._shape[0] == 1 else 1
        seeds = self._rng.randint(0, 2 ** 31, size=len(keys))
        aug_arr = tuple(float(v) for v in self._aug.to_array()) \
            if self._aug.active else None
        args = [(self._idx_path, self._rec_path, k, iscolor, self._shape,
                 self._resize, self._rand_crop, self._rand_mirror,
                 int(s), aug_arr) for k, s in zip(keys, seeds)]
        return self._pool.map_async(_decode_augment_one, args)

    def next(self):
        keys, pad = self._keys_at(self._cursor)
        if keys is None:
            raise StopIteration
        self._cursor += self.batch_size
        pooled = self._pool is not None
        u8_batch = None
        if self._native is not None:
            # double-buffering like the pool path: the ctypes call
            # releases the GIL, so a single prefetch thread decodes batch
            # N+1 while the training step consumes batch N
            if self._pending is not None and self._pending[0] == keys:
                headers, u8_batch = self._pending[1].result()
            else:
                self._drain_pending()  # the reader is stateful: never
                # let the prefetch thread and this one seek concurrently
                headers, u8_batch = self._native_batch(
                    keys, np.random.RandomState(self._rng.randint(2 ** 31)))
            self._pending = None
            nxt, _ = self._keys_at(self._cursor)
            if nxt is not None:
                self._pending = (nxt, self._decode_executor().submit(
                    self._native_batch, nxt,
                    np.random.RandomState(self._rng.randint(2 ** 31))))
            decoded = list(zip(headers, u8_batch))
        elif pooled:
            # async double-buffering: this batch was (usually) issued at
            # the END of the previous next(), so the workers decoded it
            # while the training step consumed that batch; workers return
            # uint8 (4× lighter IPC), normalisation happens below
            if self._pending is not None and self._pending[0] == keys:
                decoded = self._pending[1].get()
            else:
                decoded = self._issue(keys).get()
            self._pending = None
            nxt, _ = self._keys_at(self._cursor)
            if nxt is not None:
                self._pending = (nxt, self._issue(nxt))
        else:
            decoded = []
            for k in keys:
                hdr, img = self._decode(k)
                decoded.append((hdr, self._augment(img)))
        # Batch buffers come from the pooled host allocator (ref:
        # iter_batchloader.h out_ double-buffer): the PREVIOUS batch's
        # buffer recycles now.  On the host nd.array copies, so it is free
        # at once; for the card the buffer is pinned and the copy does not
        # block, so the pool hands it out again only after that copy's
        # event (storage's pinned pool).
        from . import storage
        c, h, w = self._shape
        device = _current_device()
        card = device.type == "cuda"
        if self._inflight is not None:
            storage.Storage.get().free(self._inflight)
            self._inflight = None
        nbytes = self.batch_size * c * h * w * 4
        handle = storage.Storage.get().alloc(
            nbytes, ctx="cpu_pinned" if card else None)
        imgs = handle.dptr.view(np.float32).reshape(
            (self.batch_size, c, h, w))
        if u8_batch is not None or pooled:
            # one vectorised normalisation pass over the whole uint8 batch
            # straight into the pooled buffer (the ufunc casts u8→f32
            # during the subtract — no batch-sized f32 temp)
            u8 = u8_batch if u8_batch is not None \
                else np.stack([chw for _, chw in decoded])
            np.subtract(u8, self._mean.reshape(1, -1, 1, 1), out=imgs)
            np.divide(imgs, self._std.reshape(1, -1, 1, 1), out=imgs)
        else:
            for i, (_, chw) in enumerate(decoded):
                imgs[i] = chw
        lw = self._label_width

        def lab(h):
            v = np.asarray(h.label, np.float32).ravel()
            if v.size < lw:
                raise ValueError(
                    f"record label has {v.size} values but label_width={lw}")
            return v[0] if lw == 1 else v[:lw]

        labels = np.stack([lab(h) for h, _ in decoded]).astype(np.float32)
        if card:
            import torch
            pinned = handle._pinned[:handle.size].view(torch.float32)
            data = NDArray(pinned.reshape(imgs.shape).to(device,
                                                         non_blocking=True))
            handle.event = torch.cuda.Event()
            handle.event.record()
        else:
            data = _to_nd(imgs)
        batch = DataBatch([data], [_to_nd(labels)], pad=pad,
                          provide_data=self.provide_data,
                          provide_label=self.provide_label)
        self._inflight = handle
        return batch


_worker_rec = {}


def _pil_resize(img, size):
    """``Image.fromarray(img).resize(size)`` (``size`` = (w, h)) as an
    array.  PIL returns a copy when the size does not change, so that
    case needs no PIL (the machine may have none); any other size
    raises a clear ``ImportError`` without it."""
    if (img.shape[1], img.shape[0]) == tuple(size):
        return img.copy()
    from .recordio import _require_pil
    image = _require_pil("resizing an image record")
    return np.asarray(image.fromarray(img).resize(tuple(size)))


def _crop_aug_u8(img, shape, resize, rand_crop, rand_mirror, rng, aug=None):
    """resize-short → crop (or random-area/aspect crop) → mirror → color
    jitter chain → CHW **uint8** (ref: image_aug_default.cc
    DefaultImageAugmenter).  Stays uint8 so the worker→parent IPC ships
    4× fewer bytes; the float conversion + mean/std normalisation runs
    vectorised over the whole batch in the parent (one SIMD pass into
    the pooled buffer).  Resizes are PIL's, as in the JAX package."""
    c, h, w = shape
    if aug is not None and aug.rrc:
        from .image import draw_rrc_box
        ih, iw = img.shape[:2]
        y0, x0, ch, cw = draw_rrc_box(ih, iw, (aug.min_area, aug.max_area),
                                      (aug.min_aspect, aug.max_aspect), rng)
        img = _pil_resize(img[y0:y0 + ch, x0:x0 + cw], (w, h))
    else:
        if resize > 0:
            short = min(img.shape[1], img.shape[0])
            scale = resize / short
            img = _pil_resize(img, (max(1, round(img.shape[1] * scale)),
                                    max(1, round(img.shape[0] * scale))))
        ih, iw = img.shape[:2]
        if ih < h or iw < w:
            img = _pil_resize(img, (max(w, iw), max(h, ih)))
            ih, iw = img.shape[:2]
        if rand_crop:
            y0 = rng.randint(0, ih - h + 1)
            x0 = rng.randint(0, iw - w + 1)
        else:
            y0, x0 = (ih - h) // 2, (iw - w) // 2
        img = img[y0:y0 + h, x0:x0 + w]
    if rand_mirror and rng.rand() < 0.5:
        img = img[:, ::-1]
    if img.ndim == 2:
        img = np.stack([img] * c, axis=-1)
    if aug is not None and aug.any_color and img.ndim == 3 \
            and img.shape[-1] == 3:
        x = _color_chain_np(img.astype(np.float32), aug, rng)
        img = np.clip(x, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(img.transpose(2, 0, 1))  # CHW uint8


def _augment_img(img, shape, resize, rand_crop, rand_mirror, mean, std,
                 rng, aug=None):
    """Full per-image pipeline incl. normalisation → CHW float32 (the
    single-process path)."""
    chw = _crop_aug_u8(img, shape, resize, rand_crop, rand_mirror, rng,
                       aug=aug)
    mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
    std = np.asarray(std, np.float32).reshape(-1, 1, 1)
    return (chw.astype(np.float32) - mean) / std


def _decode_augment_one(args):
    """Pool worker: full per-image pipeline — record read, JPEG decode,
    augment — so the parent only assembles batches (ref:
    iter_image_recordio_2.cc decode thread pool).  Each process opens its
    own reader lazily (fds don't survive fork safely for concurrent
    seeks)."""
    (idx_path, rec_path, key, iscolor, shape, resize, rand_crop,
     rand_mirror, seed, aug_arr) = args
    rec = _worker_rec.get(rec_path)
    if rec is None:
        rec = recordio.MXIndexedRecordIO(idx_path, rec_path, "r")
        _worker_rec[rec_path] = rec
    header, img = recordio.unpack_img(rec.read_idx(key), iscolor=iscolor)
    aug = None
    if aug_arr is not None:
        a = list(aug_arr)
        aug = AugSpec(bool(a[0]), *a[1:])
    chw = _crop_aug_u8(img, shape, resize, rand_crop, rand_mirror,
                       np.random.RandomState(seed), aug=aug)
    return header, chw


class PrefetchingIter(DataIter):
    """ref: io.PrefetchingIter — asynchronous double-buffering over one or
    more DataIters.

    Each wrapped iterator gets a producer thread and a bounded queue of
    ``capacity`` batches, so ``next()`` on this iterator overlaps decode /
    host work for batch N+1..N+capacity with whatever the consumer does with
    batch N (the training step).  ``reset()`` is clean across epoch
    boundaries: producer threads are stopped and joined, prefetched-but-
    unconsumed batches are dropped, the wrapped iterators reset, and fresh
    producers start — no thread ever leaks across epochs or iterator
    teardown (``close()`` / ``with`` joins them deterministically).

    Observability: ``stats`` holds ``produced``/``consumed`` batch counts,
    the current ``queue_depth``, and the cumulative wait-time split —
    ``producer_wait_s`` (producers blocked on a full queue: the pipeline is
    step-bound) vs ``consumer_wait_s`` (``next()`` blocked on an empty
    queue: the pipeline is input-bound).  The same numbers are emitted as
    profiler counters/spans when the profiler is running.

    The producers run under the context current when the first
    ``next()`` starts them (the port's contexts are per thread), so the
    wrapped iterators' NDArrays land where the caller's would.

    With multiple iterators the reference semantics apply: one batch is
    taken from each per ``next()`` and the data/label lists concatenate;
    ``rename_data``/``rename_label`` (list of dicts, one per iterator, or a
    single dict) remap the DataDesc names.
    """

    _STOP = object()   # producer→consumer sentinel: wrapped iter exhausted

    def __init__(self, iters, rename_data=None, rename_label=None,
                 capacity=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if not iters:
            raise ValueError("PrefetchingIter needs at least one iterator")
        super().__init__(getattr(iters[0], "batch_size", 0))
        self._iters = list(iters)
        self._rename_data = self._norm_rename(rename_data, len(iters))
        self._rename_label = self._norm_rename(rename_label, len(iters))
        self._capacity = max(1, int(capacity))
        self._closed = False
        self._lock = threading.Lock()
        self.stats = {"produced": 0, "consumed": 0, "queue_depth": 0,
                      "producer_wait_s": 0.0, "consumer_wait_s": 0.0}
        from . import profiler as _profiler
        self._depth_counter = _profiler.Counter(
            None, "PrefetchingIter::queue_depth")
        # producers start lazily on the first next(): construction and
        # back-to-back resets (an explicit reset() followed by the one
        # DataIter.__iter__ issues) then cost no decoded-and-dropped
        # batches and no thread churn
        self._started = False
        self._exhausted = False
        self._queues = []
        self._threads = []
        self._stop_evt = threading.Event()

    @staticmethod
    def _norm_rename(rename, n):
        if rename is None:
            return None
        if isinstance(rename, dict):
            rename = [rename] * n
        if len(rename) != n:
            raise ValueError("rename list must have one dict per iterator")
        return list(rename)

    # ----------------------------------------------------------- threads --
    def _start(self):
        from .context import current_context
        ctx = current_context()      # the caller's, for the producers
        self._stop_evt = threading.Event()
        self._queues = [_queue.Queue(self._capacity) for _ in self._iters]
        self._threads = []
        for idx, (it, q) in enumerate(zip(self._iters, self._queues)):
            t = threading.Thread(target=self._produce,
                                 args=(idx, it, q, ctx),
                                 name="PrefetchingIter-producer", daemon=True)
            t.start()
            self._threads.append(t)
        self._exhausted = False
        self._started = True

    def _produce(self, idx, it, q, ctx):
        stop = self._stop_evt
        while not stop.is_set():
            try:
                _fire("io.producer")
                with ctx:            # NDArrays land where the caller's do
                    batch = it.next()
            except StopIteration:
                batch = self._STOP
            except Exception as exc:  # surface in the consumer, then die —
                # tagged with WHICH wrapped iterator raised (with several
                # iterators merged, the bare traceback does not say)
                batch = _with_context(
                    exc, f"PrefetchingIter producer, iter {idx} "
                         f"({type(it).__name__})")
            t0 = time.perf_counter()
            enqueued = False
            while not stop.is_set():
                try:
                    q.put(batch, timeout=0.05)
                    enqueued = True
                    break
                except _queue.Full:
                    continue  # bounded queue: block until consumer drains
            wait = time.perf_counter() - t0
            with self._lock:
                self.stats["producer_wait_s"] += wait
                if enqueued and batch is not self._STOP \
                        and not isinstance(batch, Exception):
                    # a batch dropped by a shutdown is NOT produced: keeps
                    # produced == consumed + queue_depth honest
                    self.stats["produced"] += 1
                self._set_depth_locked()
            if batch is self._STOP or isinstance(batch, Exception):
                return  # epoch over: the thread exits; reset() restarts

    def _set_depth_locked(self):
        depth = sum(q.qsize() for q in self._queues)
        self.stats["queue_depth"] = depth
        self._depth_counter.set_value(depth)

    # ---------------------------------------------------------- protocol --
    def reset(self):
        """Stop + join producers, DROP any prefetched-but-unconsumed
        batches, reset the wrapped iterators.  Fresh producers start
        lazily on the next ``next()``."""
        if self._closed:
            raise RuntimeError("PrefetchingIter is closed")
        self._shutdown()
        for it in self._iters:
            it.reset()
        self._exhausted = False

    def _shutdown(self):
        if not self._started:
            return
        self._started = False
        self._stop_evt.set()
        for q in self._queues:  # unblock a producer parked on a full queue
            while True:
                try:
                    q.get_nowait()
                except _queue.Empty:
                    break
        for t in self._threads:
            t.join()
        with self._lock:
            self._set_depth_locked()

    def next(self):
        if self._closed:
            raise RuntimeError("PrefetchingIter is closed")
        if self._exhausted:
            raise StopIteration
        if not self._started:
            self._start()
        from . import profiler as _profiler
        parts = []
        for q in self._queues:
            t0 = time.perf_counter()
            with _profiler.scope("PrefetchingIter.consumer_wait", cat="wait"):
                batch = q.get()
            with self._lock:
                self.stats["consumer_wait_s"] += time.perf_counter() - t0
                self._set_depth_locked()
            if isinstance(batch, Exception):
                self._exhausted = True
                self._shutdown()  # join THIS and sibling producers: a
                # failed iterator must never leak threads.  NOT close() —
                # the iterator stays usable: reset() retries the epoch
                # (transient error), or re-wrap the still-open wrapped
                # iterators to continue mid-epoch past the bad batch
                raise batch
            if batch is self._STOP:
                self._exhausted = True
            else:
                parts.append(batch)
        if self._exhausted:
            # with unequal-length iterators the longer ones are still
            # producing: stop + join them now, not at gc/close time
            self._shutdown()
            raise StopIteration
        with self._lock:
            self.stats["consumed"] += 1
        if len(parts) == 1:
            return parts[0]
        return DataBatch(sum((b.data for b in parts), []),
                         sum((b.label or [] for b in parts), []) or None,
                         pad=parts[0].pad, index=parts[0].index,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    # ------------------------------------------------------------- descs --
    def _descs(self, attr, rename):
        out = []
        for i, it in enumerate(self._iters):
            for d in getattr(it, attr):
                if rename is not None:
                    d = DataDesc(rename[i].get(d.name, d.name), d.shape,
                                 d.dtype, d.layout)
                out.append(d)
        return out

    @property
    def provide_data(self):
        return self._descs("provide_data", self._rename_data)

    @property
    def provide_label(self):
        return self._descs("provide_label", self._rename_label)

    # ----------------------------------------------------------- cleanup --
    def close(self):
        """Join producer threads; idempotent.  The wrapped iterators are
        NOT closed (the caller may not own them)."""
        if self._closed:
            return
        self._shutdown()
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


class ResizeIter(DataIter):
    """ref: io.ResizeIter — cap/extend an iterator to ``size`` batches."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self._it = data_iter
        self._size = size
        self._reset_internal = reset_internal
        self._i = 0

    def reset(self):
        self._i = 0
        if self._reset_internal:
            self._it.reset()

    def next(self):
        if self._i >= self._size:
            raise StopIteration
        self._i += 1
        try:
            return self._it.next()
        except StopIteration:
            self._it.reset()
            return self._it.next()

    @property
    def provide_data(self):
        return self._it.provide_data

    @property
    def provide_label(self):
        return self._it.provide_label
