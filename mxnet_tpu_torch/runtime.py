"""mx.runtime — build/runtime feature detection (the port of
``mxnet_tpu/runtime.py``).

ref: python/mxnet/runtime.py — ``Features()`` says which optional
capabilities this build has.  The keys are the JAX package's; the
values are the port's own: ``CUDA`` and ``CUDNN`` come from torch,
``TPU`` and ``PALLAS`` are false (the port's kernels are CUDA C++),
the native flags say whether the host natives of ``src/`` load,
``ONNX`` is true (``onnx``: export and import, no onnx package
needed), and ``DIST_KVSTORE`` stays false until the multi-card port
comes."""
from __future__ import annotations

import torch

__all__ = ["Feature", "Features", "feature_list"]


class Feature:
    __slots__ = ("name", "enabled")

    def __init__(self, name, enabled):
        self.name = name
        self.enabled = bool(enabled)

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _detect():
    feats = {}

    def add(name, enabled):
        feats[name] = Feature(name, enabled)

    cuda = torch.cuda.is_available()
    add("TPU", False)
    add("CPU", True)
    add("CUDA", cuda)
    add("CUDNN", cuda and torch.backends.cudnn.is_available())
    add("MKLDNN", False)
    add("BF16", True)
    add("INT8", True)           # ops/quantization.py
    add("PALLAS", False)
    from .base import load_native_lib
    add("RECORDIO_NATIVE", load_native_lib("librecordio") is not None)
    add("STORAGE_POOL_NATIVE", load_native_lib("libstoragepool") is not None)
    add("DIST_KVSTORE", False)
    add("ONNX", True)            # onnx/
    add("PROFILER", True)
    return feats


class Features(dict):
    """ref: runtime.Features — dict of Feature with is_enabled()."""

    def __init__(self):
        super().__init__(_detect())

    def is_enabled(self, name):
        f = self.get(name)
        if f is None:
            raise RuntimeError(f"unknown feature {name!r}; known: "
                               f"{sorted(self)}")
        return f.enabled

    def __repr__(self):
        return " ".join(repr(f) for f in self.values())


def feature_list():
    """ref: libinfo.features."""
    return list(Features().values())
