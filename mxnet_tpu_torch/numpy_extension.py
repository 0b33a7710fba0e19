"""``mx.npx`` — the numpy-extension namespace (the port of
``mxnet_tpu/numpy_extension.py``; ref: python/mxnet/numpy_extension/
and python/mxnet/util.py ``set_np``).

The neural-network ops that plain numpy lacks (softmax, batch_norm,
convolution...) with ``mx.np`` arrays in and out, over the same
registry as ``mx.nd`` (``invoke`` gives its outputs the array type of
its inputs),
and the ``set_np()`` switch: one process-wide flag, which
``util.use_np`` sets and restores.  While it is on,
``Parameter.data()`` hands out ``mx.np.ndarray`` (the same object,
retyped in place) and Gluon blocks return ``mx.np`` arrays, hybridized
or not.
"""
from __future__ import annotations

import sys

from .context import current_context  # noqa: F401  (the JAX module's name)
from .ndarray.ndarray import NDArray, invoke  # noqa: F401
from .numpy import ndarray as np_ndarray

_np_active = False


def set_np(shape=True, array=True):
    """Make ``mx.np.ndarray`` the frontend's array type (``array=True``).
    ``shape`` is accepted for API parity: shapes are numpy's always."""
    global _np_active
    _np_active = bool(array)


def reset_np():
    global _np_active
    _np_active = False


def is_np_array():
    return _np_active


def is_np_shape():
    return _np_active


# neural ops with numpy arrays in and out, over the registry of mx.nd
_NPX_OPS = {
    "activation": "Activation", "batch_norm": "BatchNorm",
    "convolution": "Convolution", "deconvolution": "Deconvolution",
    "dropout": "Dropout", "embedding": "Embedding",
    "fully_connected": "FullyConnected", "layer_norm": "LayerNorm",
    "rms_norm": "RMSNorm", "group_norm": "GroupNorm",
    "instance_norm": "InstanceNorm", "leaky_relu": "LeakyReLU",
    "log_softmax": "log_softmax", "softmax": "softmax",
    "softmin": "softmin", "one_hot": "one_hot", "pick": "pick",
    "pooling": "Pooling", "rnn": "RNN", "roi_pooling": "ROIPooling",
    "sequence_mask": "SequenceMask", "reshape_like": "reshape_like",
    "smooth_l1": "smooth_l1", "topk": "topk", "gather_nd": "gather_nd",
    "scatter_nd": "scatter_nd", "sigmoid": None, "relu": None,
    "gelu": None, "erf": "erf", "erfinv": "erfinv",
    "multibox_prior": "MultiBoxPrior", "multibox_target": "MultiBoxTarget",
    "multibox_detection": "MultiBoxDetection", "box_nms": "_contrib_box_nms",
    "box_iou": "_contrib_box_iou", "ctc_loss": "CTCLoss",
    "sequence_last": "SequenceLast", "sequence_reverse": "SequenceReverse",
}

_this = sys.modules[__name__]


def _make(name, op_name):
    if op_name is None:
        def fn(data, **kwargs):
            return invoke("Activation", data, act_type=name)
    else:
        def fn(*args, **kwargs):
            return invoke(op_name, *args, **kwargs)
    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = (f"npx.{name} -> {op_name or 'Activation:' + name} "
                  f"(numpy arrays in and out)")
    return fn


for _n, _op in _NPX_OPS.items():
    setattr(_this, _n, _make(_n, _op))


def save(fname, arrays):
    """``nd.save``'s container."""
    from . import ndarray as nd
    nd.save(fname, arrays)


def load(fname):
    """``nd.load``, the arrays as ``mx.np.ndarray``."""
    from . import ndarray as nd
    out = nd.load(fname)
    if isinstance(out, dict):
        return {k: np_ndarray(v._data) for k, v in out.items()}
    return [np_ndarray(v._data) for v in out]


def waitall():
    from . import engine
    engine.waitall()


__all__ = (["set_np", "reset_np", "is_np_array", "is_np_shape",
            "save", "load", "waitall"] + list(_NPX_OPS))
