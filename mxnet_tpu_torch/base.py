"""Small shared helpers of the port."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["dtype_torch"]

_NAMES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16, "float64": torch.float64,
          "int32": torch.int32, "int64": torch.int64}


def dtype_torch(dtype):
    """A dtype name (``"bfloat16"``...), numpy dtype or torch dtype as a
    ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _NAMES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _NAMES[name]
