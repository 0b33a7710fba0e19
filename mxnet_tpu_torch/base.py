"""Small shared helpers of the port: dtype names, the framework's error
type and the numeric types (the port of ``mxnet_tpu/base.py``'s
``MXNetError``, ``dtype_np``, ``dtype_name``, ``string_types`` and
``numeric_types``)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "dtype_torch", "dtype_np", "dtype_name",
           "string_types", "numeric_types"]


class MXNetError(RuntimeError):
    """Framework error type."""


string_types = (str,)
numeric_types = (float, int, np.generic)

_NAMES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16, "float64": torch.float64,
          "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
          "int16": torch.int16, "uint8": torch.uint8, "bool": torch.bool}
_TORCH_NAMES = {v: k for k, v in _NAMES.items()}


def dtype_torch(dtype):
    """A dtype name (``"bfloat16"``...), numpy dtype or torch dtype as a
    ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype
    elif getattr(dtype, "__name__", None) == "bfloat16" or \
            str(getattr(dtype, "name", "")) == "bfloat16":
        name = "bfloat16"           # ml_dtypes' bfloat16, type or dtype
    else:
        name = np.dtype(dtype).name
    if name not in _NAMES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _NAMES[name]


def dtype_name(dtype) -> str:
    """The canonical name (``"float32"``, ``"bfloat16"``) of a dtype
    given as a name, numpy dtype or torch dtype."""
    return _TORCH_NAMES[dtype_torch(dtype)]


def dtype_np(dtype):
    """A dtype spec (name, numpy dtype, torch dtype; None is float32) as
    a ``numpy.dtype``.  bfloat16 is ``ml_dtypes``' type, which numpy
    needs for it; without that package a bfloat16 request raises."""
    if dtype is None:
        return np.dtype(np.float32)
    name = dtype_name(dtype)
    if name == "bfloat16":
        try:
            import ml_dtypes
        except ImportError:
            raise TypeError("a numpy bfloat16 array needs the ml_dtypes "
                            "package, which is not installed") from None
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)
