"""``mx.image`` — the legacy image API (the port of ``mxnet_tpu/image.py``).

ref: python/mxnet/image/image.py — imdecode/imread/imresize/resize_short/
fixed_crop/center_crop/random_crop/color_normalize, the Augmenter classes
+ CreateAugmenter, and class ImageIter (raw-file or RecordIO backed).

Decoding and resizing run on the host through PIL, as in the JAX
package (the reference uses OpenCV on the host); without PIL they raise
a clear ``ImportError``.  Arrays are HWC uint8/float NDArrays on the
current context, and ImageIter yields NCHW float batches.  The color
jitter kernels are plain numpy, shared with ``io``'s Python decode path
and held against the native decoder (``src/image_decode.cc``).
"""
from __future__ import annotations

import io as _pyio
import os

import numpy as np

from .ndarray import NDArray
from . import ndarray as nd

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "color_normalize", "Augmenter",
           "ResizeAug", "ForceResizeAug", "HorizontalFlipAug", "CastAug",
           "ColorNormalizeAug", "RandomCropAug", "CenterCropAug",
           "RandomSizedCropAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "ColorJitterAug",
           "LightingAug", "CreateAugmenter", "ImageIter",
           "IMAGENET_EIGVAL", "IMAGENET_EIGVEC"]


def _pil():
    from .recordio import _require_pil
    return _require_pil("mx.image decoding and resizing")


def _to_np(img):
    return img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)


def imdecode(buf, flag=1, to_rgb=True, **kwargs):
    """Decode an image byte buffer → HWC uint8 NDArray (ref: imdecode)."""
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    im = _pil().open(_pyio.BytesIO(bytes(buf)))
    im = im.convert("RGB" if flag else "L")
    arr = np.asarray(im)
    if not flag:
        arr = arr[..., None]
    elif not to_rgb:
        arr = arr[..., ::-1]  # BGR like OpenCV default
    return nd.array(np.ascontiguousarray(arr).astype(np.uint8))


def imread(filename, flag=1, to_rgb=True):
    """Read an image file (ref: imread)."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=1):
    """Resize HWC image to (w, h) (ref: imresize)."""
    arr = _to_np(src)
    squeeze = arr.shape[-1] == 1
    im = _pil().fromarray(arr[..., 0] if squeeze else arr.astype(np.uint8))
    im = im.resize((int(w), int(h)))
    out = np.asarray(im)
    if squeeze:
        out = out[..., None]
    return nd.array(out.astype(arr.dtype))


def resize_short(src, size, interp=1):
    """Resize so the SHORT side equals ``size`` (ref: resize_short)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    """Crop a fixed region, optionally resizing (ref: fixed_crop)."""
    arr = _to_np(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    out_nd = nd.array(np.ascontiguousarray(out))
    if size is not None and (w, h) != tuple(size):
        out_nd = imresize(out_nd, size[0], size[1], interp)
    return out_nd


def center_crop(src, size, interp=1):
    """→ (cropped, (x0, y0, w, h)) (ref: center_crop)."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    cw, ch = size
    x0 = max(0, (w - cw) // 2)
    y0 = max(0, (h - ch) // 2)
    cw, ch = min(cw, w), min(ch, h)
    return fixed_crop(src, x0, y0, cw, ch, size, interp), (x0, y0, cw, ch)


def random_crop(src, size, interp=1, rng=None):
    """→ (cropped, (x0, y0, w, h)) (ref: random_crop)."""
    rng = rng or np.random
    arr = _to_np(src)
    h, w = arr.shape[:2]
    cw, ch = min(size[0], w), min(size[1], h)
    x0 = int(rng.randint(0, w - cw + 1))
    y0 = int(rng.randint(0, h - ch + 1))
    return fixed_crop(src, x0, y0, cw, ch, size, interp), (x0, y0, cw, ch)


def color_normalize(src, mean, std=None):
    """(src - mean) / std on HWC float (ref: color_normalize)."""
    out = src.astype("float32") if isinstance(src, NDArray) \
        else nd.array(_to_np(src).astype(np.float32))
    mean = mean if isinstance(mean, NDArray) else nd.array(np.asarray(mean))
    out = out - mean
    if std is not None:
        std = std if isinstance(std, NDArray) else nd.array(np.asarray(std))
        out = out / std
    return out


# --- augmenters (ref: class Augmenter + subclasses) -------------------------


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError

    def dumps(self):
        import json
        return json.dumps([type(self).__name__,
                           {k: (list(v) if isinstance(v, tuple) else v)
                            for k, v in self._kwargs.items()
                            if isinstance(v, (int, float, str, tuple, list))}])


class ResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self._size, self._interp = size, interp

    def __call__(self, src):
        return resize_short(src, self._size, self._interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self._size, self._interp = size, interp

    def __call__(self, src):
        return imresize(src, self._size[0], self._size[1], self._interp)


class HorizontalFlipAug(Augmenter):
    def __init__(self, p, rng=None):
        super().__init__(p=p)
        self._p = p
        self._rng = rng or np.random

    def __call__(self, src):
        if self._rng.rand() < self._p:
            return nd.array(np.ascontiguousarray(_to_np(src)[:, ::-1]))
        return src


class CastAug(Augmenter):
    def __init__(self, dtype="float32"):
        super().__init__(dtype=dtype)
        self._dtype = dtype

    def __call__(self, src):
        return src.astype(self._dtype) if isinstance(src, NDArray) \
            else nd.array(_to_np(src).astype(self._dtype))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self._mean, self._std = mean, std

    def __call__(self, src):
        return color_normalize(src, self._mean, self._std)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1, rng=None):
        super().__init__(size=size)
        self._size, self._interp = size, interp
        self._rng = rng

    def __call__(self, src):
        return random_crop(src, self._size, self._interp, self._rng)[0]


def draw_rrc_box(h, w, area, ratio, rng):
    """Draw a random-area/aspect crop box: (y0, x0, ch, cw).  Single draw
    + clamp instead of the reference's retry loop, matching the native
    decoder's deterministic draw count (src/image_decode.cc process_one).
    The ONE python implementation of this geometry — RandomSizedCropAug
    and io.py's fallback both call it."""
    ua, ur = rng.rand(), rng.rand()
    target = (area[0] + ua * (area[1] - area[0])) * h * w
    lo, hi = np.log(ratio[0]), np.log(ratio[1])
    r = float(np.exp(lo + ur * (hi - lo)))
    cw = max(1, min(int(round(np.sqrt(target * r))), w))
    ch = max(1, min(int(round(np.sqrt(target / r))), h))
    x0 = int(rng.randint(0, w - cw + 1))
    y0 = int(rng.randint(0, h - ch + 1))
    return y0, x0, ch, cw


class RandomSizedCropAug(Augmenter):
    """Random-area/aspect crop resized to ``size`` (ref: image.py
    RandomSizedCropAug; the Inception-style crop)."""

    def __init__(self, size, area, ratio, interp=1, rng=None):
        super().__init__(size=size, area=area, ratio=ratio)
        self._size = size          # (w, h)
        self._area = area if isinstance(area, (tuple, list)) else (area, 1.0)
        self._ratio = ratio
        self._interp = interp
        self._rng = rng or np.random

    def __call__(self, src):
        img = _to_np(src)
        h, w = img.shape[:2]
        y0, x0, ch, cw = draw_rrc_box(h, w, self._area, self._ratio,
                                      self._rng)
        crop = img[y0:y0 + ch, x0:x0 + cw]
        return imresize(nd.array(crop), self._size[0], self._size[1],
                        self._interp)


# Pure-numpy jitter kernels — the single python implementation of the
# color math, shared by the Augmenter classes below and the io.py
# fallback chain (the native twin is src/image_decode.cc color_chain,
# bit-level-checked by tests/test_image_native_aug.py).
_GRAY_COEF = np.array([0.299, 0.587, 0.114], np.float32)
_TYIQ = np.array([[0.299, 0.587, 0.114],
                  [0.596, -0.274, -0.321],
                  [0.211, -0.523, 0.311]], np.float32)
_ITYIQ = np.array([[1.0, 0.956, 0.621],
                   [1.0, -0.272, -0.647],
                   [1.0, -1.107, 1.705]], np.float32)


def jitter_brightness(x, alpha):
    """x * alpha (x: HWC float32)."""
    return x * np.float32(alpha)


def jitter_contrast(x, alpha):
    """Blend with the image's mean gray level."""
    alpha = np.float32(alpha)
    per_px = (x * _GRAY_COEF).sum(-1, dtype=np.float32)
    gray = np.float32(per_px.sum(dtype=np.float64) / per_px.size) \
        * (np.float32(1) - alpha)
    return alpha * x + gray


def jitter_saturation(x, alpha):
    """Blend each pixel with its own gray value."""
    alpha = np.float32(alpha)
    gray = (x * _GRAY_COEF).sum(-1, keepdims=True, dtype=np.float32) \
        * (np.float32(1) - alpha)
    return alpha * x + gray


def jitter_hue(x, alpha):
    """YIQ-rotation hue shift ("Gil's method"; pure RGB matrix math)."""
    u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
    bt = np.array([[1, 0, 0], [0, u, -w], [0, w, u]], np.float32)
    t = (_ITYIQ @ bt @ _TYIQ).T.astype(np.float32)
    return x @ t


def pca_lighting(x, alpha3, eigval=None, eigvec=None):
    """AlexNet-style PCA lighting shift; alpha3: 3 gaussian draws."""
    ev = IMAGENET_EIGVAL if eigval is None else np.asarray(eigval, np.float32)
    evec = IMAGENET_EIGVEC if eigvec is None \
        else np.asarray(eigvec, np.float32)
    return x + (evec * np.asarray(alpha3, np.float32)) @ ev


class BrightnessJitterAug(Augmenter):
    """src *= alpha, alpha ~ U[1-b, 1+b] (ref: image.py
    BrightnessJitterAug)."""

    def __init__(self, brightness, rng=None):
        super().__init__(brightness=brightness)
        self._b = brightness
        self._rng = rng or np.random

    def __call__(self, src):
        alpha = 1.0 + (2.0 * self._rng.rand() - 1.0) * self._b
        return nd.array(jitter_brightness(
            _to_np(src).astype(np.float32), alpha))


class ContrastJitterAug(Augmenter):
    """Blend with the mean gray level (ref: image.py ContrastJitterAug)."""

    def __init__(self, contrast, rng=None):
        super().__init__(contrast=contrast)
        self._c = contrast
        self._rng = rng or np.random

    def __call__(self, src):
        alpha = 1.0 + (2.0 * self._rng.rand() - 1.0) * self._c
        return nd.array(jitter_contrast(
            _to_np(src).astype(np.float32), alpha))


class SaturationJitterAug(Augmenter):
    """Blend each pixel with its own gray value (ref: image.py
    SaturationJitterAug)."""

    def __init__(self, saturation, rng=None):
        super().__init__(saturation=saturation)
        self._s = saturation
        self._rng = rng or np.random

    def __call__(self, src):
        alpha = 1.0 + (2.0 * self._rng.rand() - 1.0) * self._s
        return nd.array(jitter_saturation(
            _to_np(src).astype(np.float32), alpha))


class HueJitterAug(Augmenter):
    """YIQ-rotation hue shift, alpha ~ U[-h, h] (ref: image.py
    HueJitterAug — "Gil's method")."""

    def __init__(self, hue, rng=None):
        super().__init__(hue=hue)
        self._h = hue
        self._rng = rng or np.random

    def __call__(self, src):
        alpha = (2.0 * self._rng.rand() - 1.0) * self._h
        return nd.array(jitter_hue(_to_np(src).astype(np.float32), alpha))


class ColorJitterAug(Augmenter):
    """Brightness+contrast+saturation in that fixed order (ref: image.py
    ColorJitterAug — the reference applies them in a random order; the
    fixed order here matches the native decoder so seeded runs agree)."""

    def __init__(self, brightness, contrast, saturation, rng=None):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self._augs = [a for a in (
            BrightnessJitterAug(brightness, rng) if brightness > 0 else None,
            ContrastJitterAug(contrast, rng) if contrast > 0 else None,
            SaturationJitterAug(saturation, rng) if saturation > 0 else None)
            if a is not None]

    def __call__(self, src):
        for a in self._augs:
            src = a(src)
        return src


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise (ref: image.py LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec, rng=None):
        super().__init__(alphastd=alphastd)
        self._std = alphastd
        self._eigval = np.asarray(eigval, np.float32)
        self._eigvec = np.asarray(eigvec, np.float32)
        self._rng = rng or np.random

    def __call__(self, src):
        alpha = self._rng.normal(0, self._std, size=(3,)).astype(np.float32)
        return nd.array(pca_lighting(_to_np(src).astype(np.float32), alpha,
                                     self._eigval, self._eigvec))


# ImageNet PCA basis (RGB 0-255) — the standard AlexNet lighting values
# (kept identical to src/image_decode.cc kEigval/kEigvec).
IMAGENET_EIGVAL = np.array([55.46, 4.794, 1.148], np.float32)
IMAGENET_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]], np.float32)


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self._size, self._interp = size, interp

    def __call__(self, src):
        return center_crop(src, self._size, self._interp)[0]


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    min_random_area=0.08, max_random_area=1.0,
                    min_aspect_ratio=3.0 / 4.0, max_aspect_ratio=4.0 / 3.0,
                    **kwargs):
    """Standard augmenter list (ref: CreateAugmenter; unsupported reference
    options are accepted and ignored, matching its permissive kwargs).
    Augmenter order matches the native decoder's fixed chain
    (src/image_decode.cc): geometry -> mirror -> brightness -> contrast ->
    saturation -> hue -> pca lighting -> cast -> normalize."""
    auglist = []
    crop = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop, "rand_resize requires rand_crop"
        if resize > 0:  # reference order: resize-short, THEN area crop —
            auglist.append(ResizeAug(resize))  # area is drawn post-resize
        auglist.append(RandomSizedCropAug(
            crop, (min_random_area, max_random_area),
            (min_aspect_ratio, max_aspect_ratio)))
    else:
        if resize > 0:
            auglist.append(ResizeAug(resize))
        if rand_crop:
            auglist.append(RandomCropAug(crop))
        else:
            auglist.append(CenterCropAug(crop))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise:
        auglist.append(LightingAug(pca_noise, IMAGENET_EIGVAL,
                                   IMAGENET_EIGVEC))
    auglist.append(CastAug())
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53], np.float32)
    if std is True:
        std = np.array([58.395, 57.12, 57.375], np.float32)
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """ref: image.ImageIter — batches from RecordIO or an imglist.

    RecordIO mode (``path_imgrec``): delegates record reading to
    ``mx.io.ImageRecordIter``'s machinery is NOT used — this class applies
    its own ``aug_list`` per reference semantics.
    imglist mode: ``imglist`` = [[label, relpath], ...] under ``path_root``.
    """

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imgidx=None, imglist=None, path_root="",
                 shuffle=False, aug_list=None, label_width=1, seed=0,
                 **kwargs):
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self._label_width = label_width
        self._rng = np.random.RandomState(seed)
        self._aug = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape)
        self._shuffle = shuffle
        self._rec = None
        if path_imgrec is not None:
            from . import recordio
            if path_imgidx is None:
                path_imgidx = os.path.splitext(path_imgrec)[0] + ".idx"
            self._rec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec,
                                                   "r")
            self._items = list(self._rec.keys)
        elif imglist is not None:
            self._items = [(float(l[0]) if not isinstance(l[0], (list, tuple))
                            else np.asarray(l[0], np.float32),
                            os.path.join(path_root, l[1])) for l in imglist]
        else:
            raise ValueError("need path_imgrec or imglist")
        self.reset()

    def reset(self):
        self._order = list(range(len(self._items)))
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cur = 0

    def _read(self, i):
        if self._rec is not None:
            from . import recordio
            s = self._rec.read_idx(self._items[i])
            hdr, img = recordio.unpack_img(s)
            label = np.asarray(hdr.label, np.float32).ravel()
            return label, nd.array(img.astype(np.uint8))
        label, path = self._items[i]
        return np.asarray(label, np.float32).ravel(), imread(path)

    def next(self):
        if self._cur >= len(self._order):
            raise StopIteration
        idxs = self._order[self._cur:self._cur + self.batch_size]
        pad = self.batch_size - len(idxs)
        while len(idxs) < self.batch_size:  # datasets smaller than a batch
            idxs = idxs + self._order[:self.batch_size - len(idxs)]
        self._cur += self.batch_size
        datas, labels = [], []
        for i in idxs:
            label, img = self._read(i)
            for aug in self._aug:
                img = aug(img)
            arr = _to_np(img).astype(np.float32)
            datas.append(arr.transpose(2, 0, 1))  # HWC → CHW
            labels.append(label[0] if self._label_width == 1
                          else label[:self._label_width])
        from .io import DataBatch
        return DataBatch([nd.array(np.stack(datas))],
                         [nd.array(np.stack(labels).astype(np.float32))],
                         pad=pad)

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self

    def close(self):
        if self._rec is not None:
            self._rec.close()
            self._rec = None
