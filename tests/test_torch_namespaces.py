"""The public names of the port against the JAX package's: ``dir()`` of
the top level, ``nd``, ``gluon``, ``gluon.model_zoo``, ``optimizer``,
``sym``, ``mod``, ``serving``, ``np``, ``np.random``, ``np.linalg``,
``npx``, ``nd.sparse``, ``onnx``, ``parallel``, ``kv`` and
``distributed``.  Every public name of the JAX package is in the port,
but for those in the named lists below: the modules still in queue A of
ROADMAP.md (A15b's first half is ported: none of its names is missing
any longer), the TPU-only names, and the JAX modules' own imports of
their implementation.
"""
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

A15b = set()
A15b_PARALLEL = set()
TPU_ONLY = {"tpu", "num_tpus"}
JAX_IMPORTS = {"jax", "jnp", "dtype_np"}
MAY_BE_MISSING = {
    "": A15b | TPU_ONLY,
    "nd": TPU_ONLY | JAX_IMPORTS,
    "gluon": set(),
    "gluon.model_zoo": set(),
    "optimizer": set(),
    "sym": A15b,
    "mod": set(),
    "serving": set(),
    "np": JAX_IMPORTS,
    "np.random": JAX_IMPORTS,
    "np.linalg": JAX_IMPORTS,
    "npx": set(),
    "nd.sparse": JAX_IMPORTS,
    "onnx": set(),
    "parallel": A15b_PARALLEL,
    "kv": set(),
    "distributed": JAX_IMPORTS,
}


def _walk(pkg, path):
    for part in filter(None, path.split(".")):
        pkg = getattr(pkg, part)
    return pkg


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


@pytest.mark.parametrize("path", sorted(MAY_BE_MISSING),
                         ids=lambda p: p or "top")
def test_namespace_has_the_jax_packages_names(path):
    missing = _public(_walk(jmx, path)) - _public(_walk(tmx, path))
    assert missing <= MAY_BE_MISSING[path], sorted(
        missing - MAY_BE_MISSING[path])


def test_listed_gaps_are_still_gaps():
    """Each named list holds only names the port still lacks, so a list
    shrinks as queue A is done."""
    listed = set().union(*MAY_BE_MISSING.values())
    missing = set()
    for path in MAY_BE_MISSING:
        missing |= _public(_walk(jmx, path)) - _public(_walk(tmx, path))
    assert listed <= missing, sorted(listed - missing)


def test_amp_has_the_int8_quantization():
    names = {"quantize_weight", "dequantize_weight", "Int8Quantizer"}
    assert names <= _public(jmx.amp) and names <= _public(tmx.amp)
    assert tmx.amp.quantize_weight is tmx.amp.quantize.quantize_weight


def test_c9_names_resolve_to_the_ported_code():
    assert tmx.waitall is tmx.engine.waitall
    assert tmx.NDArray is tmx.nd.NDArray
    assert tmx.MXNetError is tmx.base.MXNetError
    assert tmx.nd.ElementWiseSum is tmx.nd.add_n
    assert tmx.gluon.model_zoo.get_model is \
        tmx.gluon.model_zoo.vision.get_model
    assert tmx.optimizer.FactorScheduler is tmx.lr_scheduler.FactorScheduler
    ctx = tmx.cpu_pinned()
    assert str(ctx) == "cpu_pinned(0)" and ctx.device.type == "cpu"
    assert tmx.sym is tmx.symbol and tmx.mod is tmx.module
    assert tmx.mon is tmx.monitor and tmx.viz is tmx.visualization
    assert tmx.AttrScope is tmx.attribute.AttrScope
    assert hasattr(tmx.serving, "GenerationServer")
    tmx.waitall()
    with tmx.cpu():
        s = tmx.nd.ElementWiseSum(tmx.nd.ones((2,)), tmx.nd.ones((2,)))
    assert s.asnumpy().tolist() == [2.0, 2.0]
