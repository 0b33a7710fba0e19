"""The port's C ABI: ``libmxtpu_capi`` over ``mxnet_tpu_torch`` (the port
of the JAX package's ``src/c_api.cc`` and ``src/mxtpu_capi.h``).

``mxtpu_capi.h`` declares the JAX ABI's functions with the same names and
signatures, and one more, ``mxtpu_init_device("cuda" | "cuda:N" |
"cpu")``; ``c_api.cc`` embeds CPython and drives the port's op registry,
autograd, kvstore and ``nd`` file I/O on the device it names (the card
unless the caller asks for the host).  ``c_api_smoke.c`` is a C client
that trains an MLP and reaches the hand-written kernels through
``mxtpu_invoke``.

``load()`` loads it into this process with ``ctypes``, every function's
argument and result types declared (``SIGNATURES``), as a Python caller
that drives the ABI itself does.

``build()`` compiles the library with ``g++`` at first use (never at
import) into ``mxnet_tpu_torch/_build/``, named by a hash of the source,
the header and the flags, through ``base.compile_native`` (a temporary
file renamed into place).  It is built as a Python extension module is,
without ``-lpython``: its Python symbols resolve from the process that
loads it.  ``build_client()`` compiles a C client against it, linked to
libpython as an embedding program is; ``client_env()`` is the
environment such a client runs in (``PYTHONPATH``: the repo root and
this interpreter's site-packages, where torch and numpy live).

    import mxnet_tpu_torch.capi as capi
    lib = capi.build()                        # path of libmxtpu_capi-*.so
    exe = capi.build_client()                 # c_api_smoke.c, linked
    subprocess.run([str(exe), "cpu"], env=capi.client_env(), check=True)
    lib = capi.load()                         # ctypes, in this process
    assert lib.mxtpu_init_device(b"cpu") == 0
"""
from __future__ import annotations

import ctypes
import os
import sys
import sysconfig
from pathlib import Path

from .. import base

__all__ = ["HEADER", "SOURCE", "SMOKE_CLIENT", "SIGNATURES",
           "KERNEL_INPUTS", "KERNEL_OUTPUTS", "build", "build_client",
           "client_env", "load"]

DIR = Path(__file__).resolve().parent
SOURCE = DIR / "c_api.cc"
HEADER = DIR / "mxtpu_capi.h"
SMOKE_CLIENT = DIR / "c_api_smoke.c"
REPO = DIR.parents[1]
C_FLAGS = ("-O1", "-Wall")
# the keys of c_api_smoke.c's kernel section: the arrays its inputs file
# holds (flash_heads: one int32, the heads of flash_attention) and those
# it saves
KERNEL_INPUTS = ("conv_x", "conv_w", "conv_gamma", "conv_beta",
                 "conv_moving_mean", "conv_moving_var", "conv_dout",
                 "flash_q", "flash_k", "flash_v", "flash_dout", "flash_heads",
                 "paged_q", "paged_k_pages", "paged_v_pages",
                 "paged_page_tables", "paged_lengths")
KERNEL_OUTPUTS = ("conv_out", "conv_new_moving_mean", "conv_new_moving_var",
                  "conv_dx", "conv_dw", "conv_dgamma", "conv_dbeta",
                  "flash_out", "flash_dq", "flash_dk", "flash_dv",
                  "paged_out", "paged_plain")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_S = ctypes.c_char_p
_PP, _LP, _SP = (ctypes.POINTER(t) for t in (_P, _L, _S))
# every function of mxtpu_capi.h: (result type, argument types)
SIGNATURES = {
    "mxtpu_init_device": (_I, [_S]),
    "mxtpu_init": (_I, []),
    "mxtpu_shutdown": (_I, []),
    "mxtpu_last_error": (_S, []),
    "mxtpu_ndarray_create_dtype": (_P, [_P, _LP, _I, _S]),
    "mxtpu_ndarray_create": (_P, [_P, _LP, _I]),
    "mxtpu_ndarray_free": (_I, [_P]),
    "mxtpu_ndarray_ndim": (_I, [_P]),
    "mxtpu_ndarray_shape": (_I, [_P, _LP]),
    "mxtpu_ndarray_dtype": (_I, [_P, _P, _I]),
    "mxtpu_ndarray_to_host": (_I, [_P, _P, _L]),
    "mxtpu_ndarray_to_host_bytes": (_L, [_P, _P, _L]),
    "mxtpu_invoke": (_P, [_S, _PP, _I, _S]),
    "mxtpu_invoke_n": (_I, [_S, _PP, _I, _S, _PP, _I]),
    "mxtpu_autograd_set_recording": (_I, [_I]),
    "mxtpu_ndarray_attach_grad": (_I, [_P]),
    "mxtpu_backward": (_I, [_P]),
    "mxtpu_ndarray_grad": (_P, [_P]),
    "mxtpu_kvstore_create": (_P, [_S]),
    "mxtpu_kvstore_free": (_I, [_P]),
    "mxtpu_kvstore_init": (_I, [_P, _S, _P]),
    "mxtpu_kvstore_push": (_I, [_P, _S, _P]),
    "mxtpu_kvstore_pull": (_P, [_P, _S]),
    "mxtpu_kvstore_pushpull": (_P, [_P, _S, _P]),
    "mxtpu_kvstore_set_optimizer": (_I, [_P, _S, _S]),
    "mxtpu_version": (_I, []),
    "mxtpu_num_devices": (_I, []),
    "mxtpu_device_platform": (_L, [_P, _L]),
    "mxtpu_random_seed": (_I, [_I]),
    "mxtpu_wait_all": (_I, []),
    "mxtpu_list_ops": (_L, [_P, _L]),
    "mxtpu_op_doc": (_L, [_S, _P, _L]),
    "mxtpu_ndarray_save": (_I, [_S, _SP, _PP, _I]),
    "mxtpu_ndarray_load": (_I, [_S, _PP, _I, _P, _L]),
}


def _python_include():
    inc = sysconfig.get_paths()["include"]
    if not (Path(inc) / "Python.h").is_file():
        raise RuntimeError(f"Python.h not found in {inc}: the C ABI builds "
                           f"against this interpreter's headers")
    return inc


def build():
    """The path of ``libmxtpu_capi``, compiled first if needed; raises
    ``RuntimeError`` with the compiler's words when that fails."""
    flags = base.CXX_FLAGS + ("-Wall", f"-I{_python_include()}")
    out = base.hashed_lib_path("libmxtpu_capi", [SOURCE, HEADER], flags)
    return base.compile_native(out, [SOURCE], flags,
                               what="mxnet_tpu_torch/capi/c_api.cc")


def load():
    """The library (``build()``) loaded into this process with
    ``ctypes``, each function's types declared from ``SIGNATURES``.  Its
    calls take the interpreter lock themselves (``ctypes.CDLL`` releases
    it around a call)."""
    lib = ctypes.CDLL(str(build()))
    for name, (res, args) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _embed_flags():
    """The link flags of a program that embeds this interpreter (what
    ``python3-config --embed --ldflags`` gives, from ``sysconfig``, which
    a venv always has), its Python symbols exported to the libraries it
    loads, libpython's directory on the run path."""
    v = sysconfig.get_config_var
    flags = [f"-L{d}" for d in (v("LIBDIR"), v("LIBPL")) if d]
    flags.append(f"-lpython{v('LDVERSION')}")
    for key in ("LIBS", "SYSLIBS", "LINKFORSHARED"):
        flags += (v(key) or "").split()
    if v("LIBDIR"):
        flags.append(f"-Wl,-rpath,{v('LIBDIR')}")
    return flags


def build_client(source=SMOKE_CLIENT):
    """The path of C client ``source`` compiled with ``cc`` against the
    library (``build()``), built first if needed."""
    lib = build()
    source = Path(source)
    libs = (str(lib), "-lm", *_embed_flags())
    out = base.hashed_lib_path(source.stem, [source, HEADER, lib],
                               C_FLAGS + libs, suffix="")
    return base.compile_native(out, [source], (*C_FLAGS, f"-I{DIR}"), libs,
                               what=str(source), lang="C")


def client_env(first=()):
    """``os.environ`` with ``PYTHONPATH`` set for an embedding client:
    the paths ``first``, the repo root, then this interpreter's
    site-packages (an embedded interpreter does not find a venv's)."""
    sites = [p for p in sys.path if os.path.basename(p) in
             ("site-packages", "dist-packages") and os.path.isdir(p)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([*map(str, first), str(REPO),
                                         *sites])
    return env
