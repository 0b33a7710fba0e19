"""Vision transforms (the port of
``mxnet_tpu/gluon/data/vision/transforms.py``).

ref: python/mxnet/gluon/data/vision/transforms.py — Compose, Cast, ToTensor,
Normalize, Resize, CenterCrop, RandomResizedCrop, RandomFlipLeftRight, ...
Transforms are Blocks on HWC uint8 images (numpy or NDArray): a numpy
image becomes an NDArray on the current context (``nd.array``), and the
transform runs the registered image ops (``ops/image.py``) there and
returns an NDArray.  In a ``DataLoader`` the samples are made under the
``cpu()`` scope, so they run on the host.  ``RandomResizedCrop`` and
``RandomFlipTopBottom`` draw from the global ``np.random``, as in the JAX
package; the ``Random*`` ops draw from the port's device streams.
"""
from __future__ import annotations

import numpy as np

from ....ndarray import NDArray
from ....ops import image as _image
from ...block import Block, HybridBlock
from ...nn.basic_layers import HybridSequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "CropResize", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast"]


def _to_nd(x):
    from .... import ndarray as nd
    if isinstance(x, np.ndarray):
        return nd.array(x, dtype=x.dtype if x.dtype != np.float64
                        else np.float32)
    return x


class _Transform:
    """Numpy in, NDArray out: the image becomes an NDArray before the
    block runs (a Block returns NDArrays for NDArrays in)."""

    def __call__(self, x, *args):
        return super().__call__(_to_nd(x), *args)


class Compose(HybridSequential):
    """ref: class Compose."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)

    def __call__(self, x, *args):
        x = _to_nd(x)
        for b in self._children.values():
            x = b(x)
        return (x,) + args if args else x


class Cast(_Transform, HybridBlock):
    """ref: class Cast."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def infer_shape(self, *a):
        pass

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(_Transform, HybridBlock):
    """ref: class ToTensor — HWC uint8 [0,255] -> CHW float32 [0,1]."""

    def infer_shape(self, *a):
        pass

    def __call__(self, x, *args):
        out = super().__call__(x)
        return (out,) + args if args else out

    def hybrid_forward(self, F, x):
        return F.image_to_tensor(x)


class Normalize(_Transform, HybridBlock):
    """ref: class Normalize — (x - mean) / std per channel, CHW."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def infer_shape(self, *a):
        pass

    def hybrid_forward(self, F, x):
        return F.image_normalize(x, mean=self._mean, std=self._std)


class Resize(_Transform, Block):
    """ref: class Resize — bilinear HWC resize."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)

    def forward(self, x):
        return _image.image_resize(x, size=self._size)


class CenterCrop(_Transform, Block):
    """ref: class CenterCrop."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[-3], x.shape[-2]
        y0 = max((H - h) // 2, 0)
        x0 = max((W - w) // 2, 0)
        return _image.image_crop(x, x=x0, y=y0, width=min(w, W),
                                 height=min(h, H))


class CropResize(_Transform, Block):
    """ref: class CropResize."""

    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._args = (x, y, width, height)
        self._size = size

    def forward(self, data):
        x, y, w, h = self._args
        out = _image.image_crop(data, x=x, y=y, width=w, height=h)
        if self._size:
            out = _image.image_resize(out, size=self._size)
        return out


class RandomResizedCrop(_Transform, Block):
    """ref: class RandomResizedCrop — random area+ratio crop then resize."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        H, W = x.shape[-3], x.shape[-2]
        area = H * W
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            log_ratio = (np.log(self._ratio[0]), np.log(self._ratio[1]))
            ar = np.exp(np.random.uniform(*log_ratio))
            w = int(round(np.sqrt(target_area * ar)))
            h = int(round(np.sqrt(target_area / ar)))
            if w <= W and h <= H:
                x0 = np.random.randint(0, W - w + 1)
                y0 = np.random.randint(0, H - h + 1)
                out = _image.image_crop(x, x=x0, y=y0, width=w, height=h)
                return _image.image_resize(out, size=self._size)
        return _image.image_resize(x, size=self._size)


class RandomFlipLeftRight(_Transform, HybridBlock):
    """ref: class RandomFlipLeftRight."""

    def infer_shape(self, *a):
        pass

    def hybrid_forward(self, F, x):
        return F.image_random_flip_left_right(x)


class RandomFlipTopBottom(_Transform, Block):
    """ref: class RandomFlipTopBottom."""

    def forward(self, x):
        if np.random.rand() < 0.5:
            return _image._flip_tb(x)
        return x


class RandomBrightness(_Transform, HybridBlock):
    """ref: class RandomBrightness."""

    def __init__(self, brightness):
        super().__init__()
        self._args = (max(0, 1 - brightness), 1 + brightness)

    def infer_shape(self, *a):
        pass

    def hybrid_forward(self, F, x):
        return F.image_random_brightness(x, min_factor=self._args[0],
                                         max_factor=self._args[1])


class RandomContrast(_Transform, HybridBlock):
    """ref: class RandomContrast."""

    def __init__(self, contrast):
        super().__init__()
        self._args = (max(0, 1 - contrast), 1 + contrast)

    def infer_shape(self, *a):
        pass

    def hybrid_forward(self, F, x):
        return F.image_random_contrast(x, min_factor=self._args[0],
                                       max_factor=self._args[1])
