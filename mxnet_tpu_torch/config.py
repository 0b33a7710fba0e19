"""Environment-variable configuration: the ``MXNET_*`` knobs (the port of
``mxnet_tpu/config.py``).

One registry: each knob declares its type, default and what it does in
the port.  Knobs of the reference that mean nothing here (engine
bulking, parameter-server bounds, per-GPU worker threads) are accepted
with ``wired=False``, so launch scripts written for MXNet run
unchanged; setting them changes nothing.  ``describe()`` prints the
table; ``_apply_startup()`` runs at package import for the knobs that
act at process start.
"""
from __future__ import annotations

import os

__all__ = ["get", "describe", "naive_engine", "KNOBS"]


class Knob:
    __slots__ = ("name", "default", "type", "doc", "wired")

    def __init__(self, name, default, type_, doc, wired=True):
        self.name = name
        self.default = default
        self.type = type_
        self.doc = doc
        self.wired = wired


def _as_bool(v):
    return str(v).lower() in ("1", "true", "yes", "on")


KNOBS = {k.name: k for k in [
    # --- live knobs ----------------------------------------------------
    Knob("MXNET_CPU_WORKER_NTHREADS", 0, int,
         "Default DataLoader worker-process count when num_workers is not "
         "passed (0 = in-process loading)."),
    Knob("MXNET_PROFILER_AUTOSTART", 0, int,
         "1 = start the profiler at import; dump to MXNET_PROFILER_FILENAME "
         "at exit."),
    Knob("MXNET_PROFILER_FILENAME", "profile.json", str,
         "Trace output path for the autostarted profiler."),
    Knob("MXNET_SEED", None, int,
         "Global random seed applied at import (mx.random.seed)."),
    Knob("MXNET_GPU_MEM_POOL_RESERVE", 5, int,
         "Percent of MXNET_HOST_MEM_POOL_LIMIT_MB kept out of the host "
         "staging-buffer pool (card memory is torch's caching allocator's; "
         "see mxnet_tpu_torch/storage.py)."),
    Knob("MXNET_GPU_MEM_POOL_TYPE", "Naive", str,
         "Host staging-buffer pool strategy: Naive (exact-size buckets), "
         "Round (pow2 buckets below the linear cutoff), or Unpooled "
         "(ref: pooled_storage_manager.h; card memory stays with torch's "
         "caching allocator)."),
    Knob("MXNET_GPU_MEM_POOL_ROUND_LINEAR_CUTOFF", 24, int,
         "Round-pool strategy: sizes below 2^cutoff round to a power of "
         "two; above, to a page multiple."),
    Knob("MXNET_HOST_MEM_POOL_LIMIT_MB", 256, int,
         "Upper bound on host staging buffers retained by the pool."),
    Knob("MXNET_STORAGE_ACCOUNTING", 1, int,
         "1 = every NDArray registers its storage's bytes with the storage "
         "manager (mx.storage.stats()); 0 disables."),
    Knob("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice", str,
         "Execution engine, read at import.  'NaiveEngine' is synchronous "
         "dispatch (the reference's race-bisect debugging mode): every nd "
         "dispatch waits for its kernels on the card.  Anything else: "
         "the CUDA stream's asynchronous order."),
    # --- accepted for compatibility (no effect in the port) -------------
    Knob("MXNET_STORAGE_FALLBACK_LOG_VERBOSE", 1, int,
         "No silent sparse->dense fallback exists here: the port's arrays "
         "are dense and sparse requests raise.", wired=False),
    Knob("MXNET_KVSTORE_BIGARRAY_BOUND", 1000000, int,
         "Server-side big-array sharding bound: the port has no parameter "
         "servers.", wired=False),
    Knob("MXNET_EXEC_BULK_EXEC_TRAIN", 1, int,
         "Engine bulking: a captured CUDA graph (TrainStep, hybridize) "
         "holds the whole step instead.", wired=False),
    Knob("MXNET_EXEC_BULK_EXEC_INFERENCE", 1, int,
         "Engine bulking: a captured CUDA graph holds the whole forward.",
         wired=False),
    Knob("MXNET_ENGINE_TRACK_BYTES_MB", 64, int,
         "Byte budget of the reference's waitall tracking ring: the port's "
         "waitall synchronises the card instead.", wired=False),
    Knob("MXNET_TPU_HBM_CAPACITY_MB", 16384, int,
         "Assumed device memory when the runtime reports none: the port "
         "reads the card's memory (torch.cuda.mem_get_info).", wired=False),
    Knob("MXNET_CUDNN_AUTOTUNE_DEFAULT", 1, int,
         "cuDNN algorithm search: the port leaves "
         "torch.backends.cudnn.benchmark as torch sets it.", wired=False),
    Knob("MXNET_ENFORCE_DETERMINISM", 0, int,
         "Deterministic kernels: use torch.use_deterministic_algorithms; "
         "the port's own kernels sum in a fixed order.", wired=False),
    Knob("MXNET_SAFE_ACCUMULATION", 1, int,
         "Wide-accumulator reductions: always on (the norm ops accumulate "
         "in f32 whatever the input dtype; see ops/nn.py).", wired=False),
    Knob("MXNET_GPU_WORKER_NTHREADS", 2, int,
         "Per-GPU worker threads: the port issues work on CUDA streams.",
         wired=False),
]}


def get(name, default=None):
    """Typed read of a knob (the environment wins over the default)."""
    knob = KNOBS.get(name)
    raw = os.environ.get(name)
    if knob is None:
        return raw if raw is not None else default
    if raw is None:
        return knob.default if default is None else default
    if knob.type is int:
        try:
            return int(raw)
        except ValueError:
            return knob.default
    if knob.type is bool:
        return _as_bool(raw)
    return raw


def describe():
    """The knob table (ref: env_var.md)."""
    out = [f"{'variable':<38s}{'default':<26s}{'wired':<7s}description"]
    for k in KNOBS.values():
        out.append(f"{k.name:<38s}{str(k.default):<26s}"
                   f"{'yes' if k.wired else 'n/a':<7s}{k.doc}")
    return "\n".join(out)


def _apply_startup():
    """Run once at package import: the knobs that act at process start."""
    seed = get("MXNET_SEED")
    if seed is not None:
        from . import random as _random
        _random.seed(int(seed))
    if not get("MXNET_STORAGE_ACCOUNTING"):
        from . import storage
        storage.set_accounting(False)
    if naive_engine():
        from . import engine
        engine.set_naive(True)
    if get("MXNET_PROFILER_AUTOSTART"):
        import atexit

        from . import profiler
        profiler.set_config(filename=get("MXNET_PROFILER_FILENAME"))
        profiler.start()
        atexit.register(lambda: (profiler.stop(), profiler.dump()))


def naive_engine():
    """True when MXNET_ENGINE_TYPE=NaiveEngine (synchronous dispatch)."""
    return get("MXNET_ENGINE_TYPE") == "NaiveEngine"
