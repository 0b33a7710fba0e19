"""Small shared helpers of the port: dtype names, the framework's error
type, the numeric types and the build of the host natives (the port of
``mxnet_tpu/base.py``'s ``MXNetError``, ``dtype_np``, ``dtype_name``,
``string_types``, ``numeric_types`` and ``load_native_lib``).

The host natives are the repo's C++ sources in ``src/``:
``recordio.cc`` (``librecordio``, the RecordIO reader and writer),
``storage_pool.cc`` (``libstoragepool``, the host staging pool) and
``image_decode.cc`` (``libimagedecode``, the batch JPEG decoder).
``load_native_lib`` compiles one of them with ``g++`` at its first use
(never at import) into ``mxnet_tpu_torch/_build/``, beside the CUDA
kernels, under a name that hashes the source and the flags, and loads it
with ``ctypes``.  It writes through a temporary file and ``os.replace``,
so processes building at once never see half a library.  The JAX
package builds the same sources with ``make -C src`` into its own
``_lib/``; the port never writes there.  Where no compiler or no header
is found the load fails, ``native_status()`` says why, and each caller
runs its pure-Python twin and says so (``recordio.native()``,
``storage.pool_info()["native"]``).  ``hashed_lib_path`` and
``compile_native`` (the compile and the rename) also build the C ABI
and its C clients (``capi``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["MXNetError", "dtype_torch", "dtype_np", "dtype_name",
           "string_types", "numeric_types", "load_native_lib",
           "native_status", "NATIVE_LIBS", "hashed_lib_path",
           "compile_native"]


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


# ------------------------------------------------------------ host natives --
SRC_DIR = Path(__file__).resolve().parents[1] / "src"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# src/Makefile's flags, per source
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
NATIVE_LIBS = {"librecordio": ("recordio.cc", ()),
               "libstoragepool": ("storage_pool.cc", ()),
               "libimagedecode": ("image_decode.cc", ("-ljpeg", "-lpthread"))}

_native_lock = threading.Lock()
_native = {}          # name -> CDLL or None, failures included
_native_info = {}     # name -> {"loaded", "path", "seconds", "error"}


def hashed_lib_path(name, sources, flags, suffix=".so"):
    """``BUILD_DIR/<name>-<hash><suffix>``, the hash over every source's
    bytes and the flags, so an edited source or another flag rebuilds."""
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}{suffix}"


# language -> (environment variable naming the compiler, the default)
_COMPILERS = {"C++": ("CXX", "g++"), "C": ("CC", "cc")}


def compile_native(out, sources, flags, libs=(), what=None, lang="C++"):
    """Compile ``sources`` (``lang``: ``"C++"`` with ``$CXX`` or g++,
    ``"C"`` with ``$CC`` or cc) with ``flags`` into ``out``, a shared
    library or a program, unless it is built; returns ``out``.  Writes a
    temporary file and renames it into place, so processes building at
    once never see half a file.  Raises ``RuntimeError`` with the
    compiler's words when it fails."""
    if out.exists():
        return out
    env, default = _COMPILERS[lang]
    cc = os.environ.get(env) or shutil.which(default)
    if not cc:
        raise RuntimeError(f"no {lang} compiler ({default}) found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    res = subprocess.run([cc, *flags, "-o", str(tmp),
                          *(str(s) for s in sources), *libs],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cc} failed for {what or sources[0]} (exit "
                           f"{res.returncode}): {res.stderr.strip()}")
    os.replace(tmp, out)       # atomic: a reader never sees half a file
    return out


def _native_path(name):
    source, libs = NATIVE_LIBS[name]
    src = SRC_DIR / source
    return src, libs, hashed_lib_path(name, [src], CXX_FLAGS + libs)


def _build_native(name):
    """Compile ``name`` unless built; returns its path.  Raises
    ``RuntimeError`` with the compiler's words when it fails."""
    src, libs, out = _native_path(name)
    return compile_native(out, [src], CXX_FLAGS, libs, f"src/{src.name}")


def load_native_lib(name):
    """The ``ctypes.CDLL`` of host native ``name`` (a key of
    ``NATIVE_LIBS``), built first if needed, or None when it cannot be
    built or loaded (``native_status()[name]["error"]`` says why).  The
    outcome is kept, so a failed build is not retried per call."""
    with _native_lock:
        if name in _native:
            return _native[name]
        t0 = time.perf_counter()
        info = {"loaded": False, "path": None, "error": None}
        lib = None
        try:
            if not (SRC_DIR / NATIVE_LIBS[name][0]).is_file():
                raise RuntimeError(f"source src/{NATIVE_LIBS[name][0]} "
                                   f"not found")
            path = _build_native(name)
            lib = ctypes.CDLL(str(path))
            info.update(loaded=True, path=str(path))
        except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
            info["error"] = str(exc)
        info["seconds"] = time.perf_counter() - t0
        _native[name], _native_info[name] = lib, info
        return lib


def native_status():
    """What each host native's load gave so far: ``{name: {"loaded",
    "path", "seconds", "error"}}`` (names not asked for yet are
    absent)."""
    with _native_lock:
        return {k: dict(v) for k, v in _native_info.items()}
