"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``<name>.cu`` file in this directory with a plain C
entry point.  At first use it is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``mxnet_tpu_torch/_build/``
(named by a hash of the source, the shared ``*.cuh`` headers and the
flags, so an edited source or header rebuilds) and loaded with
``ctypes``.  Nothing here runs at import: the CPU test
suite imports every module on machines without ``nvcc``.

``build_all()`` starts one ``nvcc`` per source at once and waits for
them all — the way a fresh checkout pays for its builds in parallel.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["KERNELS", "build_all", "check", "load", "nvcc_path"]

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# kernel name -> C entry points with their ctypes argument types
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "paged_attention": {
        # q, pools, tables, lengths, out, workspace, counters, the call's
        # constant arguments (shapes, partition, scale), stream
        "paged_decode_attention_f32": (_P,) * 10,
        "paged_decode_attention_smem_bytes": (),
    },
    "fused_conv": {
        # dtype, 6 pointers, 11 geometry ints + relu, stream
        "fused_conv_fwd": (_I,) + (_P,) * 6 + (_I,) * 12 + (_P,),
        # dtype, 12 pointers, 11 geometry ints + relu, stream
        "fused_conv_dx": (_I,) + (_P,) * 12 + (_I,) * 12 + (_P,),
        # dtype, 7 pointers, 11 geometry ints + relu, splits, chunk, stream
        "fused_conv_dw": (_I,) + (_P,) * 7 + (_I,) * 14 + (_P,),
    },
    "flash_attention": {
        # dtype, pointers, bh, S, D, scale, causal, dropout, 1/(1-dropout),
        # the seed's device pointer (an int32), stream
        "flash_attention_fwd":
            (_I,) + (_P,) * 5 + (_I,) * 3 + (_F, _I, _F, _F, _P, _P),
        "flash_attention_dq":
            (_I,) + (_P,) * 7 + (_I,) * 3 + (_F, _I, _F, _F, _P, _P),
        "flash_attention_dkv":
            (_I,) + (_P,) * 8 + (_I,) * 3 + (_F, _I, _F, _F, _P, _P),
    },
}

_lock = threading.Lock()
_libs = {}


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``; raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels of mxnet_tpu_torch "
                       "are built with the CUDA toolkit at first use")


def _lib_path(name):
    """The source of one kernel and its library's path, named by a hash
    of the source, every header (``*.cuh``) beside it and the flags."""
    src = SRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(SRC_DIR.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name):
    """Start ``nvcc`` for one kernel; returns ``(process, tmp, out)`` or
    None when the library is already built."""
    src, out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name, started):
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: a reader never sees half a file


def _bind(name):
    _src, out = _lib_path(name)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in KERNELS[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def build_all(names=None):
    """Build every kernel (or ``names``) that is not built yet, one
    ``nvcc`` process per source, all started together; then load them.
    Returns ``{name: CDLL}``."""
    names = list(KERNELS) if names is None else list(names)
    with _lock:
        started = {n: _start_build(n) for n in names if n not in _libs}
        try:
            for n, st in started.items():
                if st is not None:
                    _finish_build(n, st)
        finally:
            for st in started.values():
                if st is not None and st[0].poll() is None:
                    st[0].kill()
                    st[0].wait()
        for n in started:
            _libs[n] = _bind(n)
        return {n: _libs[n] for n in names}


def load(name):
    """The loaded library of one kernel, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all([name])[name]
    return lib


_thread = threading.local()


def bound(index):
    """True once card ``index``'s context is current on this thread."""
    return index in getattr(_thread, "cards", ())


@contextlib.contextmanager
def on_card(index):
    """``torch.cuda.device(index)`` with that card's primary context
    current on this thread.  The kernel libraries carry their own CUDA
    runtime, which finds no context in a thread whose first CUDA work
    they are — a fresh thread, or autograd's worker when a kernel's
    backward is the first node it runs — and fails the launch
    (cudaErrorInvalidValue); ``torch.cuda.set_device`` binds it, once
    per thread and card."""
    with torch.cuda.device(index):
        if not bound(index):
            torch.cuda.set_device(index)
            _thread.__dict__.setdefault("cards", set()).add(index)
        yield


def check(status, what):
    """Raise when a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")

