"""Port parity: ``mxnet_tpu_torch.profiler`` against the JAX package's
``profiler.py``, on the cases of ``tests/test_profiler.py`` — the dump
holds a span per ``nd`` op, the aggregate table counts them,
pause/resume, nothing recorded while off, the ``TrainStep.step`` span
(one device, no mesh), the custom objects and counters, and
``profile_sync`` — plus the counter namespace
(``counter_value``/``counters``/``counters_clear``) the step's
``TrainStep::nonfinite_skips`` and the feed's wait counters live in.

Each case runs the same ``nd`` ops, scopes, custom objects and counters
through both profilers on the CPU and compares what they recorded: the
span names with their ``ph``/``cat``, the header and count column of
``dumps()``, the counter values and the trace roots' attributes.  Times
differ between the packages and are not compared.  The literal checks
of ``tests/test_profiler.py`` hold on each package as well."""
import importlib
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PACKAGES = {"jax": jmx, "port": tmx}


def _sub(mx, name):
    return importlib.import_module(f"{mx.__name__}.{name}")


@pytest.fixture(autouse=True)
def _clean():
    for mx in PACKAGES.values():
        mx.profiler.reset()
    yield
    for mx in PACKAGES.values():
        mx.profiler.set_state("stop")
        mx.profiler.set_config()
        mx.profiler.reset()


def _both(scenario, *args):
    """``{package: scenario(mx, package, *args)}``, each on the host."""
    out = {}
    for key, mx in PACKAGES.items():
        with mx.cpu():
            out[key] = scenario(mx, key, *args)
    return out


def _events(path):
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def _kinds(evs):
    """The recorded spans, counters and markers without their times."""
    return sorted({(e["name"], e["ph"], e.get("cat")) for e in evs})


def _table(text):
    """``dumps()``'s two header lines and its count column by name."""
    lines = text.splitlines()
    return lines[:2], {l.split()[0]: int(l.split()[1]) for l in lines[2:]}


def _same(results):
    assert results["port"] == results["jax"]
    return results["port"]


def _op_events(mx, key, tmp_path):
    f = str(tmp_path / f"profile_{key}.json")
    mx.profiler.set_config(filename=f, aggregate_stats=True)
    mx.profiler.start()
    a = mx.nd.ones((8, 8))
    b = mx.nd.dot(a, a)
    c = mx.nd.softmax(b)
    c.asnumpy()
    mx.profiler.stop()
    mx.profiler.dump()
    evs = _events(f)
    dot = next(e for e in evs if e["name"] == "dot")
    return _kinds(evs), sorted(dot), _table(mx.profiler.dumps())


def test_dump_contains_op_events(tmp_path):
    kinds, dot_keys, table = _same(_both(_op_events, tmp_path))
    names = {k[0] for k in kinds}
    assert "dot" in names and "softmax" in names
    assert ("dot", "X", "operator") in kinds
    assert {"ts", "dur"} <= set(dot_keys)
    assert table[1] == {"dot": 1, "softmax": 1}


def _aggregate(mx, key):
    mx.profiler.set_config(filename="unused.json", aggregate_stats=True)
    mx.profiler.start()
    a = mx.nd.ones((4, 4))
    for _ in range(3):
        a = mx.nd.dot(a, a)
    a.asnumpy()
    mx.profiler.stop()
    return (mx.profiler.dumps(), mx.profiler.dumps(reset=True),
            mx.profiler.dumps())


def test_aggregate_stats_table():
    results = _both(_aggregate)
    _same({k: [_table(t) for t in r] for k, r in results.items()})
    for table, before_reset, after_reset in results.values():
        assert "Profile Statistics" in table
        line = next(l for l in table.splitlines() if l.startswith("dot"))
        assert line.split()[1] == "3"            # the count column
        assert _table(before_reset)[1] == {"dot": 3}
        assert _table(after_reset)[1] == {}      # reset cleared it


def _pause_resume(mx, key):
    mx.profiler.set_config(filename="unused.json")
    mx.profiler.start()
    mx.nd.ones((2, 2)).asnumpy()
    mx.profiler.pause()
    mx.nd.dot(mx.nd.ones((2, 2)), mx.nd.ones((2, 2))).asnumpy()
    mx.profiler.resume()
    mx.nd.softmax(mx.nd.ones((2, 2))).asnumpy()
    mx.profiler.stop()
    return _table(mx.profiler.dumps())


def test_pause_resume():
    header, counts = _same(_both(_pause_resume))
    assert "dot" not in counts                   # paused
    assert counts == {"softmax": 1}              # resumed


def _off(mx, key):
    x = mx.nd.dot(mx.nd.ones((2, 2)), mx.nd.ones((2, 2)))
    x.asnumpy()
    return _table(mx.profiler.dumps())


def test_off_by_default_no_recording():
    header, counts = _same(_both(_off))
    assert header[0] == "Profile Statistics:"
    assert counts == {}


def _train_step(mx, key, tmp_path):
    gluon, parallel = _sub(mx, "gluon"), _sub(mx, "parallel")
    telemetry = _sub(mx, "telemetry")
    profiler = mx.profiler
    net = gluon.nn.Dense(4, in_units=4)
    net.initialize(ctx=mx.cpu())
    step = parallel.TrainStep(net, gluon.loss.L2Loss(),
                              mx.optimizer.create("sgd", learning_rate=0.1))
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.randn(8, 4).astype(np.float32))
    y = mx.nd.array(rng.randn(8, 4).astype(np.float32))
    step(x, y)                                  # build outside the profile
    f = str(tmp_path / f"prof_{key}.json")
    profiler.set_config(filename=f)
    profiler.start()
    wait = profiler.Counter(None, "DevicePrefetcher::consumer_wait_ms", 5)
    telemetry.enable()
    try:
        float(step(x, y))
        wait.set_value(12.5)                   # a feed waited 7.5 ms
        float(step(x, y))
    finally:
        telemetry.disable()
        profiler.counters_clear("DevicePrefetcher::")
    profiler.stop()
    profiler.dump()
    evs = _events(f)
    roots = [(e["args"]["num_update"], e["args"]["feed_wait_ms"])
             for e in evs if e["name"] == "TrainStep.step"
             and e["cat"] == "trace"]
    return _kinds(evs), roots, _table(profiler.dumps())[1]


def test_train_step_span(tmp_path):
    kinds, roots, counts = _same(_both(_train_step, tmp_path))
    cats = {c for n, _, c in kinds if n == "TrainStep.step"}
    assert "step" in cats                       # the profiler's scope
    assert "trace" in cats                      # the telemetry trace root
    assert roots == [(2, 0.0), (3, 7.5)]
    assert {"TrainStep.h2d", "TrainStep.compute"} <= {k[0] for k in kinds}
    assert counts == {"TrainStep.step": 2}


def _custom(mx, key, tmp_path):
    profiler = mx.profiler
    f = str(tmp_path / f"prof_{key}.json")
    profiler.set_config(filename=f)
    profiler.start()
    d = profiler.Domain("app")
    t = profiler.Task(d, "load")
    t.start()
    t.stop()
    fr = profiler.Frame(d, "frame0")
    fr.start()
    fr.stop()
    ev = profiler.Event("ev")
    ev.start()
    ev.stop()
    with profiler.scope("my_region"):
        pass
    ctr = profiler.Counter(d, "items", 0)
    ctr.increment(5)
    ctr.decrement(2)
    m = profiler.Marker(d, "tick")
    m.mark()
    profiler.stop()
    profiler.dump()
    evs = _events(f)
    values = [e["args"]["value"] for e in evs if e["name"] == "app::items"]
    tick = next(e for e in evs if e["name"] == "app::tick")
    return _kinds(evs), values, tick["s"], _table(profiler.dumps())[1]


def test_custom_objects_and_counters(tmp_path):
    kinds, values, tick_scope, counts = _same(_both(_custom, tmp_path))
    names = {k[0] for k in kinds}
    assert {"app::load", "app::frame0", "ev", "my_region", "app::items",
            "app::tick"} <= names
    cats = {k[0]: k[2] for k in kinds}
    assert cats["app::load"] == "task" and cats["app::frame0"] == "frame"
    assert cats["ev"] == "event"
    assert ("app::items", "C", None) in kinds and values == [5, 3]
    assert ("app::tick", "i", None) in kinds and tick_scope == "p"
    assert counts == {"app::load": 1, "app::frame0": 1, "ev": 1,
                      "my_region": 1}


def _sync_mode(mx, key):
    mx.profiler.set_config(filename="unused.json", profile_sync=True)
    wants = mx.profiler.want_sync()
    mx.profiler.start()
    a = mx.nd.ones((64, 64))
    mx.nd.dot(a, a).asnumpy()
    mx.profiler.stop()
    return wants, _table(mx.profiler.dumps())[1]


def test_profile_sync_mode():
    wants, counts = _same(_both(_sync_mode))
    assert wants is True
    assert counts == {"dot": 1}


def _namespace(mx, key):
    profiler = mx.profiler
    c = profiler.Counter(None, "ProfTest::a", 1)
    c.increment(2)
    c.decrement()
    profiler.Counter(profiler.Domain("ProfTest"), "b", 7)
    seen = (profiler.counter_value("ProfTest::a"),
            profiler.counters("ProfTest::"))
    profiler.counters_clear("ProfTest::")
    return seen + (profiler.counter_value("ProfTest::a", default=-1),
                   profiler.counters("ProfTest::"))


def test_counter_namespace_reads_with_the_profiler_off():
    value, live, cleared, after = _same(_both(_namespace))
    assert value == 2
    assert live == {"ProfTest::a": 2, "ProfTest::b": 7}
    assert cleared == -1 and after == {}
