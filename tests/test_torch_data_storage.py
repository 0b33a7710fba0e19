"""The port's storage manager, ``MXNET_*`` knobs and host natives
(``mxnet_tpu_torch/storage.py``, ``config.py``, ``base.load_native_lib``)
against the JAX package's: the cases of ``tests/test_storage.py`` and
``tests/test_config.py`` on the port, the knob registry and the pool's
numbers held to the JAX module's, and the natives built from ``src/``
into ``mxnet_tpu_torch/_build/`` (never ``mxnet_tpu/_lib/``),
atomically under concurrent builds.  Card-only cases carry the ``gpu``
marker.
"""
import gc
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import config as jconfig
from mxnet_tpu import storage as jstorage
from mxnet_tpu_torch import base, config, storage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
gpu = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")


# ------------------------------------------------------------ accounting --
def test_ndarray_accounting_live_and_peak():
    with tmx.cpu():
        before = storage.live_bytes()
        xs = [tmx.nd.array(np.ones((64, 64), np.float32)) for _ in range(4)]
        live = storage.live_bytes()
        assert live >= before + 4 * 64 * 64 * 4
        st = storage.stats()
        assert any(v["peak_bytes"] >= v["live_bytes"] for v in st.values())
        del xs
        gc.collect()
        assert storage.live_bytes() <= live - 4 * 64 * 64 * 4


def test_detach_does_not_double_count():
    with tmx.cpu():
        x = tmx.nd.array(np.ones((256, 256), np.float32))
        live = storage.live_bytes()
        y = x.detach()                  # a new tensor on the same storage
        assert storage.live_bytes() == live
        del x
        gc.collect()
        assert storage.live_bytes() == live   # y still holds the storage
        del y
        gc.collect()
        assert storage.live_bytes() <= live - 256 * 256 * 4


def test_rewrapped_tensor_and_views_count_once():
    with tmx.cpu():
        gc.collect()
        base_live = storage.live_bytes()
        x = tmx.nd.array(np.ones((32, 32), np.float32))
        again = tmx.nd.NDArray(x._data)             # the same tensor
        view = x.reshape((1024,))                   # the same storage
        assert storage.live_bytes() == base_live + 32 * 32 * 4
        del x, again
        gc.collect()
        assert storage.live_bytes() == base_live + 32 * 32 * 4
        del view
        gc.collect()
        assert storage.live_bytes() == base_live


def test_inplace_ops_do_not_corrupt_accounting():
    """``a += 1`` rebinds ``a``; the temporaries are collected and the
    count stays exact (the JAX test's regression)."""
    with tmx.cpu():
        gc.collect()
        base_live = storage.live_bytes()
        a = tmx.nd.array(np.ones((128, 128), np.float32))
        nbytes = 128 * 128 * 4
        for _ in range(3):
            a += 1.0
        gc.collect()
        live = storage.live_bytes()
        assert base_live + nbytes <= live <= base_live + 2 * nbytes
        del a
        gc.collect()
        assert storage.live_bytes() <= live - nbytes


def test_tensor_collected_inside_the_lock_does_not_deadlock():
    """A tensor collected while this thread holds the accounting lock (a
    garbage collection can run inside it, e.g. at a Python call) queues
    its release through its weak reference's callback instead of taking
    the lock again; the bytes go at the next read."""
    done = []

    def body():
        with tmx.cpu():
            x = tmx.nd.array(np.ones(1024, np.float32))
        live = storage.live_bytes()
        with storage._lock:
            del x                   # the last reference: the callback fires
        assert storage.live_bytes() <= live - 4096
        done.append(True)

    th = threading.Thread(target=body, daemon=True)
    th.start()
    th.join(timeout=60)
    assert done and not th.is_alive()


def test_accounting_per_device_keys_match_jax():
    with tmx.cpu():
        x = tmx.nd.array(np.ones(8, np.float32))
    jx = jmx.nd.array(np.ones(8, np.float32))
    key = str(x.context)
    assert key == str(jx.context) == "cpu(0)"
    assert storage.stats(key)["live_bytes"] > 0
    assert storage.stats(key)["num_allocs"] > 0
    assert set(storage.stats(key)) == set(jstorage.stats(key))
    assert storage.stats("nowhere(3)") == jstorage.stats("nowhere(3)")


def test_reset_peak():
    with tmx.cpu():
        x = tmx.nd.array(np.ones((128, 128), np.float32))
    key = str(x.context)
    storage.reset_peak()
    st = storage.stats(key)
    assert st["peak_bytes"] == st["live_bytes"]
    del x


def test_accounting_toggle():
    storage.set_accounting(False)
    before = storage.stats()
    try:
        with tmx.cpu():
            x = tmx.nd.array(np.ones((32, 32), np.float32))
        key = str(x.context)
        assert storage.stats(key)["num_allocs"] == \
            before.get(key, {"num_allocs": 0})["num_allocs"]
    finally:
        storage.set_accounting(True)


def test_context_memory_info_framework_keys():
    with tmx.cpu():
        x = tmx.nd.array(np.ones(16, np.float32))
    info = x.context.memory_info()
    jinfo = jmx.nd.array(np.ones(16, np.float32)).context.memory_info()
    for k in ("framework_live_bytes", "framework_peak_bytes"):
        assert k in info and k in jinfo
    assert info["framework_live_bytes"] > 0
    del x


@gpu
def test_card_accounting_and_memory_info():
    _card()
    x = tmx.nd.array(np.ones((64, 64), np.float32), ctx=tmx.gpu(0))
    assert storage.stats("gpu(0)")["live_bytes"] >= 64 * 64 * 4
    free, total = tmx.gpu_memory_info(0)
    assert total > 0 and 0 <= free <= total
    info = x.context.memory_info()
    assert info["framework_live_bytes"] >= 64 * 64 * 4
    assert "allocated_bytes.all.current" in info


# ------------------------------------------------------------- host pool --
def _buf_identity(h):
    if h._ptr is not None:
        return h._ptr
    return id(h.dptr.base if h.dptr.base is not None else h.dptr)


def test_pool_is_native_and_says_so():
    info = storage.pool_info()
    assert info["native"] is True
    assert storage.Storage.get().pool_info()["native"] is True
    assert set(info) == set(jstorage.pool_info())
    assert info["limit_bytes"] == jstorage._pool_config()[2]


def test_host_pool_naive_reuse():
    s = storage.Storage.get()
    h1 = s.alloc(10000)
    ident1 = _buf_identity(h1)
    assert h1.size == 10000
    s.free(h1)
    h2 = s.alloc(10000)
    assert _buf_identity(h2) == ident1
    s.free(h2)
    assert storage.pool_info()["hits"] >= 1


@pytest.mark.parametrize("pool_of", [storage._HostPool, jstorage._HostPool])
def test_host_pool_round_strategy(monkeypatch, pool_of):
    monkeypatch.setenv("MXNET_GPU_MEM_POOL_TYPE", "Round")
    pool = pool_of()
    h = pool.alloc(5000)
    assert h._bucket == 8192
    pool.free(h)
    h2 = pool.alloc(6000)
    assert h2._bucket == 8192
    assert pool.info()["hits"] == 1
    big = pool.alloc((1 << 24) + 5)
    assert big._bucket % 4096 == 0 and big._bucket >= (1 << 24) + 5


def test_host_pool_respects_limit(monkeypatch):
    monkeypatch.setenv("MXNET_HOST_MEM_POOL_LIMIT_MB", "1")
    monkeypatch.setenv("MXNET_GPU_MEM_POOL_RESERVE", "0")
    pool = storage._HostPool()
    h = pool.alloc(2 << 20)
    pool.free(h)
    assert pool.info()["held_bytes"] == 0


def test_unpooled_strategy(monkeypatch):
    monkeypatch.setenv("MXNET_GPU_MEM_POOL_TYPE", "Unpooled")
    pool = storage._HostPool()
    h = pool.alloc(4096)
    pool.free(h)
    assert pool.info()["held_bytes"] == 0


def test_double_free_is_harmless():
    s = storage.Storage.get()
    h = s.alloc(4096)
    s.free(h)
    s.free(h)
    h1 = s.alloc(4096)
    h2 = s.alloc(4096)
    assert _buf_identity(h1) != _buf_identity(h2)
    s.free(h1)
    s.free(h2)


def test_direct_free():
    s = storage.Storage.get()
    h = s.alloc(4096)
    held0 = storage.pool_info()["held_bytes"]
    s.direct_free(h)
    s.free(h)
    assert storage.pool_info()["held_bytes"] == held0


def test_storage_release_all():
    s = storage.Storage.get()
    h = s.alloc(8192)
    s.free(h)
    storage.release_all()
    assert storage.pool_info()["held_bytes"] == 0


def test_native_pool_loaded_and_roundtrips():
    pool = storage._load_native_pool()
    assert pool is not None
    h = pool.alloc(5000)
    assert h._ptr is not None and h._ptr % 4096 == 0
    h.dptr[:] = 7
    assert int(h.dptr[4999]) == 7
    addr = h._ptr
    pool.free(h)
    assert h.dptr is None and h._ptr is None
    h2 = pool.alloc(6000)
    assert h2._ptr == addr
    assert pool.info()["native"] and pool.info()["hits"] == 1
    pool.direct_free(h2)
    assert pool.info()["held_bytes"] == 0


def test_native_pool_dropped_handle_does_not_leak():
    pool = storage._load_native_pool()
    h = pool.alloc(7000)
    addr = h._ptr
    del h
    gc.collect()
    h2 = pool.alloc(7000)
    assert h2._ptr == addr
    pool.free(h2)


def test_image_record_iter_uses_pool(tmp_path):
    """The iterator's staging buffers recycle through the pool (the
    port's ``nd.array`` copies)."""
    from PIL import Image
    import io as _io
    from mxnet_tpu_torch import io as mio, recordio

    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(0)
    for i in range(8):
        buf = _io.BytesIO()
        Image.fromarray(rng.randint(0, 255, (40, 40, 3), np.uint8)) \
            .save(buf, format="PNG")
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i % 4), i, 0),
                                     buf.getvalue()))
    w.close()
    hits0 = storage.pool_info()["hits"]
    with tmx.cpu():
        it = mio.ImageRecordIter(rec, data_shape=(3, 32, 32), batch_size=4,
                                 path_imgidx=idx)
        batches = list(it)
    assert len(batches) == 2 and batches[0].data[0].shape == (4, 3, 32, 32)
    assert storage.pool_info()["hits"] >= hits0 + 1
    it.close()


@gpu
def test_pinned_buffer_reused_only_after_its_copy():
    """A pinned staging buffer freed with the event of the copy that
    reads it is handed out again only once that copy has finished: the
    copy's destination holds the first contents."""
    _card()
    s = storage.Storage.get()
    n = 64 << 20
    h = s.alloc(n, ctx="cpu_pinned")
    assert h._pinned is not None and h._pinned.is_pinned()
    h.dptr[:] = 1
    dev = torch.device("cuda", 0)
    torch.cuda._sleep(50_000_000)          # the copy waits behind ~25 ms
    out = h._pinned[:n].to(dev, non_blocking=True)
    h.event = torch.cuda.Event()
    h.event.record()
    addr = h._pinned.data_ptr()
    s.free(h)
    h2 = s.alloc(n, ctx="cpu_pinned")
    assert h2._pinned.data_ptr() == addr   # the same buffer, recycled
    assert h.event is None                 # freed: the pool holds it
    h2.dptr[:] = 2
    torch.cuda.synchronize()
    assert int(out.min()) == 1 and int(out.max()) == 1
    s.free(h2)


# ---------------------------------------------------------------- config --
def test_registry_and_typed_get(monkeypatch):
    assert config.get("MXNET_CPU_WORKER_NTHREADS") == 0
    monkeypatch.setenv("MXNET_CPU_WORKER_NTHREADS", "3")
    assert config.get("MXNET_CPU_WORKER_NTHREADS") == 3
    monkeypatch.setenv("MXNET_CPU_WORKER_NTHREADS", "junk")
    assert config.get("MXNET_CPU_WORKER_NTHREADS") == 0
    monkeypatch.setenv("MXNET_SOMETHING_ELSE", "abc")
    assert config.get("MXNET_SOMETHING_ELSE") == "abc"


def test_knobs_are_the_jax_packages():
    """Every JAX knob is accepted with its default; the port's texts
    name no XLA, PJRT or TPU; the knobs the port cannot act on are
    unwired, and the HBM capacity knob among them (the port reads the
    card's memory)."""
    assert set(config.KNOBS) == set(jconfig.KNOBS)
    for name, knob in config.KNOBS.items():
        assert knob.default == jconfig.KNOBS[name].default, name
        assert knob.type is jconfig.KNOBS[name].type, name
        for word in ("XLA", "PJRT", "TPU", "jit"):
            assert word not in knob.doc, (name, word)
    unwired = {k for k, v in config.KNOBS.items() if not v.wired}
    assert "MXNET_TPU_HBM_CAPACITY_MB" in unwired
    assert {"MXNET_CPU_WORKER_NTHREADS", "MXNET_SEED",
            "MXNET_STORAGE_ACCOUNTING", "MXNET_GPU_MEM_POOL_TYPE",
            "MXNET_PROFILER_AUTOSTART"}.isdisjoint(unwired)


def test_describe_lists_all_knobs():
    table = config.describe()
    for name in config.KNOBS:
        assert name in table
    assert "NaiveEngine" in table


def _run_port(code, **env):
    e = dict(os.environ, PYTHONPATH=REPO, **env)
    p = subprocess.run([sys.executable, "-c", code], env=e,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, (p.stdout, p.stderr)
    return p.stdout


def test_profiler_autostart_subprocess(tmp_path):
    import json
    f = str(tmp_path / "auto.json")
    _run_port("import mxnet_tpu_torch as mx\n"
              "with mx.profiler.scope('probe_span'):\n"
              "    pass\n", MXNET_PROFILER_AUTOSTART="1",
              MXNET_PROFILER_FILENAME=f)
    with open(f) as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"]}
    assert "probe_span" in names


def test_seed_and_accounting_knobs_subprocess():
    code = ("import mxnet_tpu_torch as mx\n"
            "from mxnet_tpu_torch import storage\n"
            "with mx.cpu():\n"
            "    x = mx.nd.random.uniform(shape=(3,))\n"
            "print(x.asnumpy().tolist(), storage.stats())\n")
    outs = [_run_port(code, MXNET_SEED="1234",
                      MXNET_STORAGE_ACCOUNTING="0") for _ in range(2)]
    assert outs[0] == outs[1]              # same seed, same stream
    assert outs[0].strip().endswith("{}")  # nothing accounted


def test_dataloader_workers_default(monkeypatch):
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    ds = ArrayDataset(np.arange(8, dtype=np.float32).reshape(8, 1))
    monkeypatch.setenv("MXNET_CPU_WORKER_NTHREADS", "0")
    assert DataLoader(ds, batch_size=4)._num_workers == 0
    monkeypatch.setenv("MXNET_CPU_WORKER_NTHREADS", "2")
    with DataLoader(ds, batch_size=4, thread_pool=True) as dl:
        assert dl._num_workers == 2
        with tmx.cpu():
            got = [d.asnumpy() for d in dl]
    np.testing.assert_array_equal(np.concatenate(got).ravel(), np.arange(8))


# --------------------------------------------------------------- natives --
@pytest.mark.parametrize("name", sorted(base.NATIVE_LIBS))
def test_natives_build_into_the_ports_build_dir(name):
    jlib = os.path.join(REPO, "mxnet_tpu", "_lib")
    before = {f: os.stat(os.path.join(jlib, f)).st_mtime_ns
              for f in os.listdir(jlib)} if os.path.isdir(jlib) else {}
    lib = base.load_native_lib(name)
    st = base.native_status()[name]
    assert lib is not None and st["loaded"], st
    assert os.path.dirname(st["path"]) == str(base.BUILD_DIR)
    assert os.path.basename(st["path"]).startswith(name + "-")
    after = {f: os.stat(os.path.join(jlib, f)).st_mtime_ns
             for f in os.listdir(jlib)} if os.path.isdir(jlib) else {}
    assert after == before                 # nothing written there
    assert base.load_native_lib(name) is lib   # kept, not rebuilt


def test_concurrent_builds_are_atomic(tmp_path, monkeypatch):
    """Threads building one library into an empty build directory at
    once each write a file of their own and rename it into place: every
    one loads the finished library, and no temporary file is left."""
    monkeypatch.setattr(base, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(base._build_native("librecordio"))
        except Exception as exc:          # reported below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors and len(set(paths)) == 1
    import ctypes
    ctypes.CDLL(str(paths[0])).rio_open
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]


def test_failed_build_is_reported_not_silent(monkeypatch):
    monkeypatch.setitem(base.NATIVE_LIBS, "libmissing",
                        ("no_such_source.cc", ()))
    try:
        assert base.load_native_lib("libmissing") is None
        st = base.native_status()["libmissing"]
        assert not st["loaded"] and "no_such_source.cc" in st["error"]
    finally:
        base._native.pop("libmissing", None)
        base._native_info.pop("libmissing", None)
