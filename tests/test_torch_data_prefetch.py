"""The port's asynchronous feed (``mxnet_tpu_torch/parallel/prefetch.py``
``DevicePrefetcher``, ``io.PrefetchingIter``, ``ImageRecordIter``'s
prefetching) against the JAX package's: the
``DevicePrefetcher``/``PrefetchingIter``/``ImageRecordIter`` cases of
``tests/test_prefetch.py``, each source run through both packages on
the CPU, with the structure, dtypes and values of every batch, the
``stats`` counters and the errors compared.  Overlap is held by the
``stats`` wait split, never by a wall-clock bound.  On the card: the
feed's stream, pinned staging buffers and events, held by batches that
carry their own index into a captured step.  Also ``python -m
mxnet_tpu_torch.bench resnet --feed prefetch`` on the CPU.
"""
import importlib
import io as pyio
import json
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import fault, gluon, parallel, profiler
from mxnet_tpu_torch import io as mio

gpu = pytest.mark.gpu
STATS = {"produced", "consumed", "queue_depth", "producer_wait_s",
         "consumer_wait_s"}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")


def _throttled(pkg, n, delay, batch_size=2):
    """A ``pkg.io.DataIter`` of ``n`` batches (each filled with its
    number), each taking ``delay`` seconds to make."""
    class Throttled(pkg.io.DataIter):
        def __init__(self):
            super().__init__(batch_size)
            self._i = 0

        def reset(self):
            self._i = 0

        @property
        def provide_data(self):
            return [pkg.io.DataDesc("data", (batch_size, 4))]

        @property
        def provide_label(self):
            return []

        def next(self):
            if self._i >= n:
                raise StopIteration
            self._i += 1
            time.sleep(delay)
            return pkg.io.DataBatch([np.full((batch_size, 4), self._i,
                                             np.float32)])
    return Throttled()


def _host(item):
    """A placed batch as plain Python: NDArrays as numpy arrays, the
    containers (``DataBatch`` as a tagged tuple) rebuilt around them."""
    if hasattr(item, "asnumpy"):
        return item.asnumpy()
    if type(item).__name__ == "DataBatch":
        return ("DataBatch", _host(item.data), _host(item.label), item.pad,
                item.index, [tuple(d) for d in item.provide_data or []])
    if isinstance(item, (tuple, list)):
        return type(item)(_host(x) for x in item)
    if isinstance(item, dict):
        return {k: _host(v) for k, v in item.items()}
    return item


def _same(got, want):
    """The same structure, leaf types, dtypes, shapes and bits."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), type(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    else:
        assert got == want


def _both(run):
    """``run(pkg)`` on the port (under ``cpu()``) and on the JAX
    package: ``(port result, JAX result)``."""
    with tmx.cpu():
        got = run(tmx)
    return got, run(jmx)


# ------------------------------------------------------- PrefetchingIter --
def test_prefetching_iter_matches_serial():
    x = np.arange(80, dtype=np.float32).reshape(20, 4)
    y = np.arange(20, dtype=np.float32)

    def run(pkg):
        serial = [_host(b) for b in pkg.io.NDArrayIter(x, y, batch_size=4)]
        with pkg.io.PrefetchingIter(pkg.io.NDArrayIter(x, y, batch_size=4),
                                    capacity=3) as pf:
            epochs = [[_host(b) for b in pf] for _ in range(2)]
            stats = dict(pf.stats)
        return serial, epochs, stats

    (serial, got, gstats), (jserial, want, wstats) = _both(run)
    _same(serial, jserial)
    _same(got, want)
    _same(got, [serial, serial])
    assert set(gstats) == set(wstats) == STATS
    assert gstats["consumed"] == wstats["consumed"] == 2 * len(serial)
    assert gstats["produced"] == wstats["produced"]


def test_prefetching_iter_multi_iter_and_rename():
    x1 = np.ones((8, 2), np.float32)
    x2 = np.zeros((8, 3), np.float32)

    def run(pkg):
        it = pkg.io.PrefetchingIter(
            [pkg.io.NDArrayIter(x1, batch_size=4, data_name="a"),
             pkg.io.NDArrayIter(x2, batch_size=4, data_name="b")],
            rename_data=[{"a": "left"}, {"b": "right"}])
        descs = [tuple(d) for d in it.provide_data]
        batches = [_host(b) for b in it]
        it.close()
        return descs, batches

    got, want = _both(run)
    _same(got, want)
    descs, batches = got
    assert [d[0] for d in descs] == ["left", "right"]
    assert len(batches) == 2
    assert batches[0][1][0].shape == (4, 2)
    assert batches[0][1][1].shape == (4, 3)


def test_prefetching_iter_unequal_iters_join_producers_on_exhaustion():
    def run(pkg):
        it = pkg.io.PrefetchingIter(
            [pkg.io.NDArrayIter(np.ones((4, 2), np.float32), batch_size=4),
             pkg.io.NDArrayIter(np.zeros((40, 2), np.float32),
                                batch_size=4)],
            capacity=2)
        batches = [_host(b) for b in it]
        leaked = any(t.name == "PrefetchingIter-producer"
                     for t in threading.enumerate())
        it.close()
        return batches, leaked

    got, want = _both(run)
    _same(got, want)
    assert len(got[0]) == 1 and not got[1]


def test_prefetching_iter_reset_drops_prefetched_batches():
    x = np.arange(32, dtype=np.float32).reshape(8, 4)

    def run(pkg):
        pf = pkg.io.PrefetchingIter(pkg.io.NDArrayIter(x, batch_size=2),
                                    capacity=4)
        first = _host(pf.next())
        deadline = time.time() + 10
        while pf.stats["produced"] <= pf.stats["consumed"] \
                and time.time() < deadline:
            time.sleep(0.01)
        ahead = pf.stats["produced"] > pf.stats["consumed"]
        pf.reset()
        again = _host(pf.next())
        rest = [_host(b) for b in pf]
        pf.close()
        return first, again, rest, ahead

    got, want = _both(run)
    _same(got, want)
    first, again, rest, ahead = got
    assert ahead and len(rest) == 4
    _same(again, first)


def test_prefetching_iter_no_thread_leak():
    x = np.zeros((8, 2), np.float32)

    def run(pkg):
        leaks = []
        for _ in range(5):
            it = pkg.io.PrefetchingIter(pkg.io.NDArrayIter(x, batch_size=4),
                                        capacity=2)
            it.next()
            it.reset()
            it.close()
            leaks.append(any(t.name == "PrefetchingIter-producer"
                             for t in threading.enumerate()))
        with pytest.raises(RuntimeError) as err:
            it.next()
        return leaks, str(err.value)

    got, want = _both(run)
    _same(got, want)
    assert got[0] == [False] * 5


def test_prefetching_iter_propagates_producer_error():
    def run(pkg):
        class Boom(pkg.io.DataIter):
            def __init__(self):
                super().__init__(2)
                self._i = 0

            def reset(self):
                self._i = 0

            def next(self):
                self._i += 1
                if self._i > 2:
                    raise ValueError("decode failed")
                return pkg.io.DataBatch(
                    [pkg.io._to_nd(np.zeros((2, 2), np.float32))])

        pf = pkg.io.PrefetchingIter(Boom())
        batches = [_host(pf.next()), _host(pf.next())]
        with pytest.raises(ValueError, match="decode failed") as err:
            pf.next()
        pf.close()
        return batches, type(err.value), str(err.value)

    got, want = _both(run)
    _same(got, want)


def _prefetcher(pkg, kind, source):
    if kind == "PrefetchingIter":
        return pkg.io.PrefetchingIter(source, capacity=2)
    return pkg.parallel.DevicePrefetcher(iter(source), depth=2)


@pytest.mark.parametrize("kind", ["PrefetchingIter", "DevicePrefetcher"])
def test_wait_split_says_which_side_sets_the_pace(kind):
    """A slow producer makes the consumer wait (consumer_wait_s large,
    producer_wait_s small); a slow consumer the reverse, in both
    packages, over the same batches.  The split reads the bottleneck
    without a wall-clock bound."""
    def run(pkg):
        with _prefetcher(pkg, kind, _throttled(pkg, 10, 0.02)) as pf:
            fed = [_host(b) for b in pf]
            slow_feed = dict(pf.stats)
        with _prefetcher(pkg, kind, _throttled(pkg, 10, 0.0)) as pf:
            for _ in pf:
                time.sleep(0.02)
            slow_step = dict(pf.stats)
        return fed, slow_feed, slow_step

    (fed, slow_feed, slow_step), (jfed, jslow_feed, jslow_step) = _both(run)
    _same(fed, jfed)
    assert len(fed) == 10
    for feed, step in ((slow_feed, slow_step), (jslow_feed, jslow_step)):
        assert set(feed) == set(step) == STATS
        assert feed["consumed"] == step["consumed"] == 10
        assert feed["produced"] == step["produced"] == 10
        assert feed["consumer_wait_s"] > 5 * feed["producer_wait_s"]
        assert step["producer_wait_s"] > 5 * step["consumer_wait_s"]


@pytest.mark.parametrize("kind", ["PrefetchingIter", "DevicePrefetcher"])
def test_profiler_sees_queue_depth_and_wait_split(tmp_path, kind):
    """Both packages' traces carry the same prefetch counters and spans,
    and the queue depth rises above 0."""
    def run(pkg):
        trace = str(tmp_path / f"trace_{pkg.__name__}.json")
        pkg.profiler.set_config(filename=trace)
        pkg.profiler.start()
        try:
            with _prefetcher(pkg, kind, _throttled(pkg, 6, 0.005)) as pf:
                for _ in pf:
                    time.sleep(0.005)
        finally:
            pkg.profiler.stop()
        pkg.profiler.dump()
        events = [e for e in json.load(open(trace))["traceEvents"]
                  if str(e.get("name", "")).startswith(kind)]
        depth = max(e["args"]["value"] for e in events
                    if e["name"] == f"{kind}::queue_depth")
        return {e["name"] for e in events}, depth > 0

    got, want = _both(run)
    _same(got, want)
    names, deep = got
    assert deep and {f"{kind}::queue_depth",
                     f"{kind}.consumer_wait"} <= names


# ------------------------------------------------------ DevicePrefetcher --
def _tiny_step(pkg, seed=0):
    """A Dense(3) over 4 inputs under SGD, the same weights in both
    packages."""
    rng = np.random.RandomState(seed)
    w = rng.randn(3, 4).astype(np.float32)
    net = pkg.gluon.nn.Dense(3, in_units=4)
    opt = pkg.optimizer.create("sgd", learning_rate=0.1)
    if pkg is tmx:
        net.initialize(ctx=tmx.cpu())
        net.weight.set_data(w)
        net.bias.set_data(np.zeros(3, np.float32))
        return parallel.TrainStep(net, gluon.loss.L2Loss(), opt)
    import jax
    net.initialize()
    net.weight.set_data(jmx.nd.array(w))
    net.bias.set_data(jmx.nd.zeros((3,)))
    mesh = jmx.parallel.make_mesh(dp=1, devices=jax.devices()[:1])
    return jmx.parallel.TrainStep(net, jmx.gluon.loss.L2Loss(), opt,
                                  mesh=mesh)


def test_device_prefetcher_feeds_train_step():
    """Batches through the prefetcher give the port's step the losses
    of the same batches given directly, and the JAX step fed through
    its own prefetcher the same losses."""
    rng = np.random.RandomState(1)
    batches = [(rng.randn(8, 4).astype(np.float32),
                rng.randn(8, 3).astype(np.float32)) for _ in range(4)]
    direct = _tiny_step(tmx)
    want = [float(direct(x, y)) for x, y in batches]

    def run(pkg):
        step = _tiny_step(pkg)
        with pkg.parallel.DevicePrefetcher(iter(batches), step=step,
                                           depth=2) as feed:
            losses = [float(np.asarray(_host(step(d, lab))))
                      for d, lab in feed]
            return losses, feed.stats["produced"], feed.stats["consumed"]

    (got, produced, consumed), (jgot, jproduced, jconsumed) = _both(run)
    assert got == want
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-6)
    assert produced == consumed == jproduced == jconsumed == 4


def test_device_prefetcher_structures_and_default_put():
    """Every array leaf becomes an NDArray with the JAX package's dtype
    (float64 as float32, int64 as int32), other leaves pass through, and
    a ``DataBatch`` is rebuilt with its fields; a torch tensor (the
    port's own leaf type) already where it goes passes through as it
    is, as a ``jax.Array`` does in the JAX package."""
    def batches(pkg):
        return [{"x": np.ones((2, 2), np.float32), "meta": "keep-me",
                 "pair": (np.zeros(3, np.float64), [np.arange(2)])},
                pkg.io.DataBatch([np.ones((2, 2), np.float32)],
                                 [np.zeros(2)], pad=1, index=np.arange(2))]

    def run(pkg):
        with pkg.parallel.DevicePrefetcher(batches(pkg)) as feed:
            out = list(feed)
        leaves = [out[0]["x"], out[0]["pair"][0], out[0]["pair"][1][0],
                  out[1].data[0], out[1].label[0]]
        assert all(isinstance(v, pkg.nd.NDArray) for v in leaves)
        return [_host(o) for o in out]

    got, want = _both(run)
    _same(got, want)
    assert got[0]["pair"][0].dtype == np.float32
    assert got[0]["pair"][1][0].dtype == np.int32
    with tmx.cpu():
        with parallel.DevicePrefetcher(
                [{"t": torch.ones(2, dtype=torch.int64)}]) as feed:
            t = next(iter(feed))["t"]
    assert isinstance(t, tmx.nd.NDArray) and t.dtype == np.int64


def test_device_prefetcher_stale_generator_close_keeps_new_iter_alive():
    src = [(np.full((2, 2), i, np.float32),) for i in range(4)]

    def run(pkg):
        pf = pkg.parallel.DevicePrefetcher(src, depth=1)
        it1 = iter(pf)
        next(it1)
        it2 = iter(pf)
        first = _host(next(it2))
        it1.close()
        rest = [_host(b) for b in it2]
        pf.close()
        return first, rest

    got, want = _both(run)
    _same(got, want)
    first, rest = got
    assert float(first[0][0, 0]) == 0.0 and len(rest) == 3


def test_device_prefetcher_superseded_generator_resumes_and_ends():
    src = [(np.zeros((2, 2), np.float32),)] * 3

    def run(pkg):
        pf = pkg.parallel.DevicePrefetcher(src, depth=1)
        it1 = iter(pf)
        next(it1)
        it2 = iter(pf)
        next(it2)
        stale = len(list(it1))
        rest = [_host(b) for b in it2]
        pf.close()
        return stale <= 1, rest

    got, want = _both(run)
    _same(got, want)
    assert got[0] and len(got[1]) == 2


def test_device_prefetcher_no_thread_leak_and_close():
    src = [(np.zeros((2, 2), np.float32),)] * 3

    def run(pkg):
        pf = pkg.parallel.DevicePrefetcher(src, depth=1)
        for _ in pf:
            break
        pf.close()
        leaked = any(t.name == "DevicePrefetcher-producer"
                     for t in threading.enumerate())
        with pytest.raises(RuntimeError) as err:
            iter(pf).__next__()
        return leaked, str(err.value)

    got, want = _both(run)
    _same(got, want)
    assert not got[0]


def test_device_prefetcher_sharding_is_a15_and_fault_point_fires():
    """A sharding is a mesh's (A15) in the port.  The fault point fires
    before a placement in both packages, and the consumer gets the same
    error, tagged as the producer's, after the same batches."""
    with pytest.raises(NotImplementedError, match="A15"):
        parallel.DevicePrefetcher([], sharding=object())
    src = [(np.full((2, 2), i, np.float32),) for i in range(3)]

    def run(pkg):
        with pkg.fault.inject("prefetch.device_put", RuntimeError,
                              after_n=1, times=1):
            with pkg.parallel.DevicePrefetcher(src, depth=1) as pf:
                it = iter(pf)
                first = _host(next(it))
                with pytest.raises(RuntimeError,
                                   match="DevicePrefetcher") as err:
                    next(it)
                stats = (pf.stats["produced"], pf.stats["consumed"])
        return first, type(err.value), str(err.value), stats

    got, want = _both(run)
    _same(got, want)
    assert got[3] == (1, 1)


# ------------------------------------- ImageRecordIter's own prefetching --
def _write_jpeg_rec(tmp_path, n=8, hw=24):
    from PIL import Image
    from mxnet_tpu_torch import recordio
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        buf = pyio.BytesIO()
        Image.fromarray(rng.randint(0, 255, (hw, hw, 3), np.uint8)) \
            .save(buf, format="JPEG", quality=90)
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i), i, 0),
                                     buf.getvalue()))
    w.close()
    return rec, idx


def test_image_record_iter_reset_drops_pending_pool(tmp_path):
    """The worker-pool route: a reset drops the batch in flight, and the
    batches before and after it are the JAX package's."""
    rec, idx = _write_jpeg_rec(tmp_path)

    def run(pkg):
        it = pkg.io.ImageRecordIter(rec, data_shape=(3, 24, 24),
                                    batch_size=4, path_imgidx=idx,
                                    preprocess_threads=2,
                                    use_native_decode=False)
        first = _host(it.next())
        pending = it._pending is not None
        it.reset()
        dropped = it._pending is None
        again = _host(it.next())
        rest = []
        while True:
            try:
                rest.append(_host(it.next()))
            except StopIteration:
                break
        it.close()
        return first, again, rest, pending, dropped

    got, want = _both(run)
    _same(got, want)
    first, again, rest, pending, dropped = got
    assert pending and dropped and len(rest) == 1
    _same(again, first)


def test_image_record_iter_native_prefetch_thread_lifecycle(tmp_path):
    """The native-decode route: three iterators made, reset and closed
    in turn leave no decode thread, and their batches are the JAX
    package's native route's."""
    assert mio._native_decoder() is not None
    rec, idx = _write_jpeg_rec(tmp_path)

    def run(pkg):
        out = []
        for _ in range(3):
            it = pkg.io.ImageRecordIter(rec, data_shape=(3, 24, 24),
                                        batch_size=4, path_imgidx=idx,
                                        use_native_decode=True)
            first = _host(it.next())
            pending = it._pending is not None
            it.reset()
            dropped = it._pending is None
            again = _host(it.next())
            executor = it._executor
            it.close()
            closed = it._executor is None and (executor is None or not any(
                t for t in threading.enumerate()
                if t in getattr(executor, "_threads", ())))
            out.append((first, again, pending, dropped, closed))
        return out

    got, want = _both(run)
    _same(got, want)
    for first, again, pending, dropped, closed in got:
        assert pending and dropped and closed
        _same(again, first)


# ------------------------------------------------------------------ bench --
def test_bench_resnet_feed_prefetch_on_cpu(capsys):
    """``python -m mxnet_tpu_torch.bench resnet --feed prefetch --device
    cpu``: batch 8, 2 steps, the line carries the feed, the wait split
    and ms/step."""
    bench = importlib.import_module("mxnet_tpu_torch.bench")
    assert bench.main(["resnet", "--device", "cpu", "--feed",
                       "prefetch"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["feed"] == "prefetch" and line["batch"] == 8
    assert line["steps"] == 2 and line["unit"] == "img/s/cpu"
    assert line["producer_wait_s"] >= 0 and line["consumer_wait_s"] >= 0
    assert line["ms_per_step"] > 0 and np.isfinite(line["last_loss"])


# ------------------------------------------------------------ on the card --
@gpu
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("sleep", [0.0, 0.02])
def test_card_every_step_sees_its_own_batch(depth, sleep):
    """Host batches filled with their index go through pinned staging
    buffers from the pool (reused after their copy's event) and the
    feed's stream into a captured step that copies them into
    its static input on the current stream and sums them: every step
    sees exactly its own index, with a fast and a slow consumer."""
    _card()
    from mxnet_tpu_torch.graphs import GraphCache
    dev = torch.device("cuda", 0)
    shape = (32, 3, 224, 224)
    static = torch.zeros(shape, device=dev)
    graphs = GraphCache(dev)
    n = 12

    def source():
        for i in range(n):
            yield (torch.full(shape, float(i)),)

    seen = []
    with parallel.DevicePrefetcher(source(), depth=depth) as pf:
        for (x,) in pf:
            static.copy_(x._data)
            seen.append(graphs.run("sum", lambda: static.double().sum())
                        .clone())
            if sleep:
                time.sleep(sleep)
    numel = float(np.prod(shape))
    assert [float(v) / numel for v in seen] == [float(i) for i in range(n)]


@gpu
def test_card_prefetched_train_step_equals_direct():
    """A captured ``TrainStep`` on the card fed through the prefetcher
    gives the losses of the same batches given directly."""
    _card()
    rng = np.random.RandomState(2)
    batches = [(rng.randn(64, 4).astype(np.float32),
                rng.randn(64, 3).astype(np.float32)) for _ in range(6)]

    def net():
        n = gluon.nn.Dense(3, in_units=4)
        n.initialize(ctx=tmx.gpu(0))
        n.weight.set_data(np.random.RandomState(0).randn(3, 4)
                          .astype(np.float32))
        return n

    def step_of(n):
        return parallel.TrainStep(n, gluon.loss.L2Loss(),
                                  tmx.optimizer.create("sgd",
                                                       learning_rate=0.1))

    direct = step_of(net())
    want = [float(direct(x, y)) for x, y in batches]
    step = step_of(net())
    with parallel.DevicePrefetcher(iter(batches), step=step) as feed:
        got = [float(step(d, lab)) for d, lab in feed]
    assert step.graph_count() == 1 and got == want


@gpu
def test_card_record_iter_through_prefetcher_equals_host(tmp_path):
    """The example's ``--rec`` loop body in the producer thread (the
    iterator's pinned hand-off, the NHWC transpose and the bf16 cast on
    the feed's stream) gives the host's batches."""
    _card()
    from mxnet_tpu_torch import recordio
    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(3)
    for i in range(16):
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(i), i, 0),
                                         rng.randint(0, 256, (40, 40, 3))
                                         .astype(np.uint8), img_fmt=".raw"))
    w.close()
    kw = dict(data_shape=(3, 32, 32), batch_size=4, shuffle=True,
              rand_crop=True, rand_mirror=True, mean_r=120.0, std_r=50.0)

    def batches(it):
        for b in it:
            yield b.data[0].transpose((0, 2, 3, 1)).astype("bfloat16"), \
                b.label[0]

    with parallel.DevicePrefetcher(batches(mio.ImageRecordIter(rec, **kw)),
                                   depth=2) as feed:
        card = [(x.asnumpy(), y.asnumpy()) for x, y in feed]
    with tmx.cpu():
        host = [(x.asnumpy(), y.asnumpy())
                for x, y in batches(mio.ImageRecordIter(rec, **kw))]
    assert len(card) == len(host) == 4
    for (cx, cy), (hx, hy) in zip(card, host):
        np.testing.assert_array_equal(cx, hx)
        np.testing.assert_array_equal(cy, hy)
