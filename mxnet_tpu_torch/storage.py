"""Storage manager: memory accounting and pooled host staging buffers
(the port of ``mxnet_tpu/storage.py``).

1. **Accounting.**  Every NDArray registers the bytes of its tensor's
   storage here (``NDArray.__init__`` calls ``on_create``), per device
   key (``"gpu(0)"``, ``"cpu(0)"``), so ``stats()``/``live_bytes()``
   report the framework's live and peak bytes, allocation and free
   counts.  The key is the storage (its device and data pointer), not
   the wrapper: a rebound NDArray, a re-wrapped tensor (``detach()``)
   and views of one storage count once, and the bytes go when the last
   tensor holding an entry is collected (its weak reference's callback
   queues it; the queue is drained under the lock by the next call).
   Torch's caching allocator keeps its own numbers
   (``Context.memory_info``); these are the tensors the framework holds.
   ``set_accounting(False)`` (the knob ``MXNET_STORAGE_ACCOUNTING=0``)
   turns it off: it costs a weak reference per new tensor.

2. **Host staging buffers.**  The data pipeline reuses page-sized host
   buffers instead of allocating one per batch.  ``Storage.alloc`` takes
   them from ``libstoragepool`` (``src/storage_pool.cc``, built at first
   use by ``base.load_native_lib``) or, where it cannot be built, from
   its pure-Python twin ``_HostPool``; ``pool_info()["native"]`` says
   which.  The strategies are the reference's (``MXNET_GPU_MEM_POOL_TYPE``):
   ``Naive`` (exact page-rounded sizes), ``Round`` (powers of two below
   ``2**MXNET_GPU_MEM_POOL_ROUND_LINEAR_CUTOFF``) and ``Unpooled``; the
   pool keeps at most ``(100 - MXNET_GPU_MEM_POOL_RESERVE)%`` of
   ``MXNET_HOST_MEM_POOL_LIMIT_MB``.

   ``alloc(size, ctx="cpu_pinned")`` gives page-locked memory (a pinned
   torch tensor) from a pool of its own, for copies to the card that do
   not block the host.  Such a buffer carries ``handle.event``, the CUDA
   event of the last copy that read it (the caller sets it); a freed
   pinned buffer goes back to its free list at once, and ``alloc`` hands
   out one whose copy has finished, or waits on the oldest's event, so a
   buffer is never overwritten while a copy still reads it.  The data
   pipeline's staging buffers (``io.ImageRecordIter`` on the card,
   ``parallel.DevicePrefetcher``) all come from this pool.
"""
from __future__ import annotations

import ctypes
import threading
import weakref

import numpy as np
import torch

__all__ = ["Storage", "Handle", "stats", "reset_peak", "pool_info",
           "release_all", "on_create", "live_bytes", "set_accounting"]


# --------------------------------------------------------------- accounting --
class _DeviceStats:
    __slots__ = ("live_bytes", "peak_bytes", "num_allocs", "num_frees",
                 "live_arrays")

    def __init__(self):
        self.live_bytes = 0
        self.peak_bytes = 0
        self.num_allocs = 0
        self.num_frees = 0
        self.live_arrays = 0

    def as_dict(self):
        return {"live_bytes": self.live_bytes,
                "peak_bytes": self.peak_bytes,
                "num_allocs": self.num_allocs,
                "num_frees": self.num_frees,
                "live_arrays": self.live_arrays}


_lock = threading.Lock()
_by_device: dict = {}
# storage data pointer -> [device key, bytes, tensors holding the entry]
# (host and device addresses never coincide under CUDA's unified
# addressing, so the pointer alone names a storage)
_registered: dict = {}
_held: dict = {}      # id() of a tensor holding an entry -> its pointer
_refs: dict = {}      # id() of the weak reference to such a tensor ->
                      # (the reference, the tensor's id())
# Weak references of collected tensors, appended by the reference's own
# callback (``list.append``: no Python frame, no lock) and drained under
# the lock.  A callback can fire on any thread at any point, including
# inside ``_lock`` on the thread that holds it (a collection running
# there), so it must never take the lock itself.
_dead: list = []
_enabled = True


def set_accounting(enabled: bool):
    """Turn per-NDArray accounting on or off (``MXNET_STORAGE_ACCOUNTING``)."""
    global _enabled
    _enabled = bool(enabled)


_devkeys = {-1: "cpu(0)"}    # tensor.get_device() -> device key


def _devkey(t):
    idx = t.get_device()
    key = _devkeys.get(idx)
    if key is None:
        key = _devkeys[idx] = f"gpu({idx})"
    return key


def _drain_locked():
    """Drop the holds of collected tensors, and each entry's bytes with
    its last hold (the caller holds ``_lock``).  A reference leaves
    ``_dead`` only after its hold is gone, so an empty ``_dead`` means
    every id in ``_held`` is a live tensor's (``on_create``'s unlocked
    check)."""
    while _dead:
        _, tid = _refs.pop(id(_dead[0]))
        ptr = _held.pop(tid)
        del _dead[0]            # callbacks only append: the head is ours
        ent = _registered[ptr]
        ent[2] -= 1
        if ent[2]:
            continue
        del _registered[ptr]
        st = _by_device[ent[0]]
        st.live_bytes -= ent[1]
        st.num_frees += 1
        st.live_arrays -= 1


def on_create(nd) -> None:
    """Register the storage behind a new NDArray (its ``__init__``
    calls this; it must stay cheap: a lookup when the tensor holds an
    entry already, else a lookup and a weak reference)."""
    if not _enabled:
        return
    t = nd._data
    tid = id(t)
    if not _dead and tid in _held:
        return                      # this tensor holds an entry already
    st = t.untyped_storage()
    ptr = st.data_ptr()
    if not ptr:
        return                      # zero-size: no buffer
    with _lock:
        if _dead:
            _drain_locked()         # a dead tensor's id may be reused
        if tid in _held:
            return                  # another thread registered it
        ent = _registered.get(ptr)
        if ent is None:
            devkey, nbytes = _devkey(t), st.nbytes()
            _registered[ptr] = [devkey, nbytes, 1]
            s = _by_device.get(devkey)
            if s is None:
                s = _by_device[devkey] = _DeviceStats()
            s.live_bytes += nbytes
            s.num_allocs += 1
            s.live_arrays += 1
            if s.live_bytes > s.peak_bytes:
                s.peak_bytes = s.live_bytes
        else:
            ent[2] += 1
        _held[tid] = ptr
        ref = weakref.ref(t, _dead.append)
        _refs[id(ref)] = (ref, tid)


def _key(device):
    return device if isinstance(device, str) else str(device)


def stats(device=None):
    """``stats()`` -> ``{device key: {live_bytes, peak_bytes, num_allocs,
    num_frees, live_arrays}}``; ``stats(ctx or key)`` -> that device's
    dict (zeros if unseen)."""
    with _lock:
        _drain_locked()
        if device is None:
            return {k: v.as_dict() for k, v in _by_device.items()}
        s = _by_device.get(_key(device))
        return s.as_dict() if s is not None else _DeviceStats().as_dict()


def live_bytes(device=None) -> int:
    with _lock:
        _drain_locked()
        if device is None:
            return sum(s.live_bytes for s in _by_device.values())
        s = _by_device.get(_key(device))
        return s.live_bytes if s is not None else 0


def reset_peak():
    """Reset every peak to the current live bytes."""
    with _lock:
        _drain_locked()
        for s in _by_device.values():
            s.peak_bytes = s.live_bytes


# ---------------------------------------------------- host staging buffers --
class Handle:
    """An allocated host buffer: ``dptr`` (a numpy uint8 view of
    ``size`` bytes), ``size``, ``ctx``; for a pinned buffer ``event``,
    the CUDA event of the last copy that read it."""

    __slots__ = ("dptr", "size", "ctx", "event", "_bucket", "_ptr", "_fin",
                 "_pinned", "__weakref__")

    def __init__(self, dptr, size, ctx, bucket, ptr=None, pinned=None):
        self.dptr = dptr
        self.size = size
        self.ctx = ctx
        self.event = None
        self._bucket = bucket     # rounded size the pool keeps it under
        self._ptr = ptr           # native pool address (None: not native)
        self._fin = None          # returns a dropped native buffer
        self._pinned = pinned     # the pinned tensor behind dptr


def _pool_config():
    """(strategy, round cutoff, limit in bytes) from the knobs."""
    from . import config
    strategy = str(config.get("MXNET_GPU_MEM_POOL_TYPE") or "Naive")
    cutoff = int(config.get("MXNET_GPU_MEM_POOL_ROUND_LINEAR_CUTOFF") or 24)
    reserve = int(config.get("MXNET_GPU_MEM_POOL_RESERVE") or 5)
    limit_mb = int(config.get("MXNET_HOST_MEM_POOL_LIMIT_MB") or 256)
    return strategy, cutoff, limit_mb * (1 << 20) * max(0, 100 - reserve) \
        // 100


class _HostPool:
    """Free lists of page-rounded numpy buffers: the pure-Python twin of
    ``libstoragepool`` (and, with ``pinned=True``, the pool of pinned
    buffers)."""

    PAGE = 4096

    def __init__(self, pinned=False):
        self._free: dict = {}
        self._held = 0
        self._hits = 0
        self._misses = 0
        self._lock = threading.Lock()
        self._pinned = pinned
        self._strategy, self._cutoff, self._limit = _pool_config()

    def _bucket_of(self, nbytes: int) -> int:
        if self._strategy == "Round":
            if nbytes <= 0:
                return self.PAGE
            if nbytes < (1 << self._cutoff):
                return 1 << max(nbytes - 1, 1).bit_length()
        return -(-max(nbytes, 1) // self.PAGE) * self.PAGE

    def _new(self, nbytes):
        if self._pinned:
            t = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            return t.numpy(), t
        return np.empty(nbytes, dtype=np.uint8), None

    def alloc(self, nbytes: int, ctx=None) -> Handle:
        if self._strategy == "Unpooled":
            buf, t = self._new(max(nbytes, 1))
            return Handle(buf[:nbytes], nbytes, ctx, -1, pinned=t)
        bucket = self._bucket_of(nbytes)
        with self._lock:
            lst = self._free.get(bucket)
            if lst:
                # the newest buffer whose last copy has finished, else
                # the oldest (its copy was issued first)
                i = next((k for k in range(len(lst) - 1, -1, -1)
                          if lst[k][2] is None or lst[k][2].query()), 0)
                buf, t, event = lst.pop(i)
                self._held -= bucket
                self._hits += 1
            else:
                buf = t = event = None
                self._misses += 1
        if buf is None:
            buf, t = self._new(bucket)
        elif event is not None:
            event.synchronize()     # the last copy from it has finished
        return Handle(buf[:nbytes], nbytes, ctx, bucket, pinned=t)

    def free(self, handle: Handle):
        with self._lock:
            if handle._bucket < 0:
                return
            buf = (handle.dptr.base if handle.dptr.base is not None
                   else handle.dptr)
            bucket, handle._bucket = handle._bucket, -1
            entry = (buf, handle._pinned, handle.event)
            handle.dptr = handle._pinned = handle.event = None
            if self._held + bucket > self._limit:
                return              # over the cap: back to the allocator
            self._free.setdefault(bucket, []).append(entry)
            self._held += bucket

    def direct_free(self, handle: Handle):
        with self._lock:
            handle._bucket = -1     # the garbage collector reclaims it

    def release_all(self):
        with self._lock:
            self._free.clear()
            self._held = 0

    def info(self):
        with self._lock:
            return {"strategy": self._strategy, "native": False,
                    "held_bytes": self._held, "limit_bytes": self._limit,
                    "hits": self._hits, "misses": self._misses,
                    "buckets": {k: len(v) for k, v in self._free.items()}}


class _NativePool:
    """ctypes binding over ``libstoragepool`` (``src/storage_pool.cc``),
    with ``_HostPool``'s interface."""

    def __init__(self, lib):
        self._lib = lib
        self._lock = threading.Lock()
        self._strategy, cutoff, self._limit = _pool_config()
        self._pool = lib.sp_create(1 if self._strategy == "Round" else 0,
                                   self._limit, cutoff)

    def alloc(self, nbytes: int, ctx=None) -> Handle:
        if self._strategy == "Unpooled":
            buf = np.empty(max(nbytes, 1), dtype=np.uint8)
            return Handle(buf[:nbytes], nbytes, ctx, -1)
        bucket = ctypes.c_int64(0)
        ptr = self._lib.sp_alloc(self._pool, max(nbytes, 1),
                                 ctypes.byref(bucket))
        if not ptr:
            raise MemoryError(f"native pool: alloc({nbytes}) failed")
        cbuf = (ctypes.c_uint8 * bucket.value).from_address(ptr)
        arr = np.frombuffer(cbuf, dtype=np.uint8, count=bucket.value)
        handle = Handle(arr[:nbytes], nbytes, ctx, bucket.value, ptr)
        # a dropped handle returns its block through the base view's
        # finalizer: a view made from dptr keeps ``arr`` alive, so the
        # block is never freed under a live view; free()/direct_free()
        # detach it (the caller holds no view then)
        handle._fin = weakref.finalize(arr, self._lib.sp_free, self._pool,
                                       ptr, bucket.value)
        return handle

    def _sever(self, handle: Handle):
        """Detach the handle (under the lock); ``(ptr, bucket)``, or
        ``(None, -1)`` when another thread freed it first."""
        with self._lock:
            fin, handle._fin = handle._fin, None
            if fin is not None:
                fin.detach()        # before dptr goes: see alloc
            ptr, handle._ptr = handle._ptr, None
            bucket, handle._bucket = handle._bucket, -1
            handle.dptr = None
            return ptr, bucket

    def free(self, handle: Handle):
        ptr, bucket = self._sever(handle)
        if ptr is not None:
            self._lib.sp_free(self._pool, ptr, bucket)

    def direct_free(self, handle: Handle):
        ptr, _ = self._sever(handle)
        if ptr is not None:
            self._lib.sp_free(self._pool, ptr, -1)

    def release_all(self):
        self._lib.sp_release_all(self._pool)

    def info(self):
        held, hits, misses = (ctypes.c_int64(0), ctypes.c_int64(0),
                              ctypes.c_int64(0))
        self._lib.sp_info(self._pool, ctypes.byref(held), ctypes.byref(hits),
                          ctypes.byref(misses))
        return {"strategy": self._strategy, "native": True,
                "held_bytes": held.value, "limit_bytes": self._limit,
                "hits": hits.value, "misses": misses.value,
                "buckets": {}}      # the native pool keeps no per-bucket fill


def _load_native_pool():
    """A ``_NativePool`` over ``libstoragepool`` (built if needed), or
    None when it cannot be built or loaded."""
    from .base import load_native_lib
    lib = load_native_lib("libstoragepool")
    if lib is None:
        return None
    lib.sp_create.restype = ctypes.c_void_p
    lib.sp_create.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int]
    lib.sp_alloc.restype = ctypes.c_void_p
    lib.sp_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                             ctypes.POINTER(ctypes.c_int64)]
    lib.sp_free.restype = None
    lib.sp_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.sp_release_all.restype = None
    lib.sp_release_all.argtypes = [ctypes.c_void_p]
    lib.sp_info.restype = None
    lib.sp_info.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_int64)] * 3
    lib.sp_destroy.restype = None
    lib.sp_destroy.argtypes = [ctypes.c_void_p]
    return _NativePool(lib)


_pools = {}
_pools_lock = threading.Lock()


def _pool(pinned=False):
    """The process's host pool (native when it loads) or its pinned
    pool, made at first use."""
    pool = _pools.get(pinned)
    if pool is None:
        with _pools_lock:
            pool = _pools.get(pinned)
            if pool is None:
                pool = _HostPool(pinned=True) if pinned \
                    else (_load_native_pool() or _HostPool())
                _pools[pinned] = pool
    return pool


def _is_pinned(ctx):
    return str(ctx).startswith("cpu_pinned")


class Storage:
    """The reference's ``Storage::Get()`` facade."""

    _instance = None

    @classmethod
    def get(cls) -> "Storage":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def alloc(self, size: int, ctx=None) -> Handle:
        """A host buffer of ``size`` bytes; ``ctx="cpu_pinned"`` for
        page-locked memory."""
        return _pool(_is_pinned(ctx)).alloc(size, ctx)

    def free(self, handle: Handle):
        _pool(handle._pinned is not None).free(handle)

    def direct_free(self, handle: Handle):
        """Bypass the pool (``Storage::DirectFree``)."""
        _pool(handle._pinned is not None).direct_free(handle)

    def release_all(self, ctx=None):
        _pool(_is_pinned(ctx)).release_all()

    def stats(self, device=None):
        return stats(device)

    def pool_info(self):
        return _pool().info()


def pool_info():
    """The host pool's numbers; ``"native"`` says whether
    ``libstoragepool`` serves it."""
    return _pool().info()


def release_all():
    _pool().release_all()
