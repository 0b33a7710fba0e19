"""Every registered op of the port's elementwise, reduce, matrix, nn,
loss and optimizer-update families (``mxnet_tpu_torch/ops``) against
the JAX package's op of the same name, through each package's own
dispatch (``nd.invoke``) and autograd.

Each case makes its inputs from a seeded ``RandomState`` (the seed from
the op's name), runs the op in both packages (the port on the CPU), and
compares every output's values and dtype, then the gradient of every
differentiable input under a seeded cotangent per output.  Tolerances
(rtol, atol) in float32: 1e-5 / 1e-6 for elementwise ops, 1e-4 / 1e-4
for reductions, products, normalisations and losses; 1e-2 in bfloat16.

The unary and binary tables of ``tests/test_operator.py`` give the
input ranges of the ops they list.  ``test_registry_census`` holds the
port's registry to the JAX one, name for name.
"""
import inspect
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.ndarray import invoke as jinvoke
from mxnet_tpu.ops import elementwise as jelementwise
from mxnet_tpu.ops.registry import OPS as JOPS
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.ndarray import invoke as tinvoke
from mxnet_tpu_torch.ops import OPS as TOPS
from test_operator import BINARY, UNARY

EW = (1e-5, 1e-6)
RED = (1e-4, 1e-4)
BF16 = (1e-2, 1e-2)

# The JAX op modules this port covers: elementwise, reduce, matrix, nn,
# loss and optimizer_ops (the binary ops registered as ``jnp`` functions
# come from elementwise's ``_BINARY`` table).
ROW_MODULES = tuple(f"mxnet_tpu.ops.{m}" for m in (
    "elementwise", "reduce", "matrix", "nn", "loss", "optimizer_ops"))


def _jax_row_names():
    binary = set(map(id, jelementwise._BINARY.values()))
    names = set()
    for name, fn in JOPS.items():
        mod = inspect.getmodule(fn)
        if (mod is not None and mod.__name__ in ROW_MODULES) or \
                id(fn) in binary:
            names.add(name)
    return names


ROW_NAMES = _jax_row_names()


def test_registry_census():
    """The port registers every JAX name of these six op modules (252
    with aliases); beyond them, only the names of the op modules ported
    since (image, attention and paged attention: 30 names,
    ``tests/test_torch_data_image.py``; rnn, sequence and multibox: 25,
    ``tests/test_torch_rnn.py`` and ``tests/test_torch_multibox.py``;
    the symbol frontend's ``_scalar``, ``tests/test_torch_symbol.py``;
    random, quantization and control flow: 39,
    ``tests/test_torch_random_ops.py``,
    ``tests/test_torch_quantization.py`` and
    ``tests/test_torch_control_flow.py``)."""
    assert len(ROW_NAMES) == 252
    assert ROW_NAMES <= set(TOPS)
    later = set(TOPS) - ROW_NAMES
    assert len(later) == 95
    assert {JOPS[n].__module__ for n in later} == {
        "mxnet_tpu.ops.image", "mxnet_tpu.ops.attention",
        "mxnet_tpu.ops.paged_attention", "mxnet_tpu.ops.rnn",
        "mxnet_tpu.ops.sequence", "mxnet_tpu.ops.multibox",
        "mxnet_tpu.symbol", "mxnet_tpu.ops.random_ops",
        "mxnet_tpu.ops.quantization", "mxnet_tpu.ops.control_flow"}


def test_nd_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default context is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmx.nd.array([1.0, 2.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmx.nd.zeros((2, 3))
    assert tmx.nd.array([1.0], ctx=tmx.cpu()).context == tmx.cpu()


def test_one_hot_takes_a_positional_depth():
    """A deliberate superset: ``nd.one_hot(idx, 6)`` with a positional
    depth works in the port and equals ``depth=6``; the JAX package's
    ``invoke`` traces the positional depth and ``jax.nn.one_hot`` then
    raises.  With ``depth=6`` both packages agree."""
    import jax

    idx = np.asarray([0, 2, 5, 1], np.int32)
    t = tmx.nd.array(idx, ctx=tmx.cpu())
    positional = tmx.nd.one_hot(t, 6).asnumpy()
    keyword = tmx.nd.one_hot(t, depth=6).asnumpy()
    np.testing.assert_array_equal(positional, keyword)
    np.testing.assert_array_equal(positional, np.eye(6, dtype=np.float32)[idx])
    j = jmx.nd.array(idx)
    np.testing.assert_array_equal(jmx.nd.one_hot(j, depth=6).asnumpy(),
                                  keyword)
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jmx.nd.one_hot(j, 6)


# ------------------------------------------------------------------ cases --
def _rng(name):
    return np.random.RandomState(zlib.crc32(name.encode()))


def _u(rng, shape, lo=-2.0, hi=2.0):
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def _ints(rng, shape, lo, hi):
    return rng.randint(lo, hi, size=shape).astype(np.int32)


def _case(inputs, kw=None, grad=(), tol=EW):
    return dict(inputs=inputs, kw=kw or {}, grad=tuple(grad), tol=tol)


_UNARY_RANGES = {n: (lo, hi, diff) for n, (_, (lo, hi), diff)
                 in UNARY.items()}
_UNARY_RANGES.update({"rsqrt": (0.5, 3.0, True), "sqrt": (0.5, 3.0, True),
                      "isnan": (-2, 2, False), "isinf": (-2, 2, False),
                      "isfinite": (-2, 2, False)})
_BINARY_RANGES = {n.replace("broadcast_", ""): (a, b, diff)
                  for n, (_, a, b, diff) in BINARY.items()}
_BINARY_RANGES.update({"subtract": ((-2, 2), (-2, 2), True),
                       "multiply": ((-2, 2), (-2, 2), True),
                       "divide": ((-2, 2), (0.5, 2), True),
                       "mod": ((1, 5), (0.7, 2), True),
                       "power": ((0.5, 2), (-1, 2), True)})
_SPECIAL = np.array([[1.0, np.inf, -np.inf, np.nan],
                     [0.0, -1.5, 2.0, np.nan]], np.float32)


def _unary(name):
    rng = _rng(name)
    lo, hi, diff = _UNARY_RANGES.get(name, (-2.0, 2.0, True))
    if name in ("isnan", "isinf", "isfinite"):
        return _case([_SPECIAL])
    x = _u(rng, (3, 4), lo, hi)
    if name in ("relu", "abs", "sign"):
        x = np.where(np.abs(x) < 0.05, x + 0.1, x).astype(np.float32)
    if name in ("floor", "ceil", "round", "rint", "trunc", "fix"):
        x = (np.round(x * 4) / 4 + 0.1).astype(np.float32)
    return _case([x], grad=(0,) if diff else ())


def _binary(name):
    rng = _rng(name)
    (alo, ahi), (blo, bhi), diff = _BINARY_RANGES[name]
    a, b = _u(rng, (3, 4), alo, ahi), _u(rng, (1, 4), blo, bhi)
    if not diff:     # comparisons and logic: ties and zeros on purpose
        a = _ints(rng, (3, 4), 0, 3).astype(np.float32)
        b = _ints(rng, (1, 4), 0, 3).astype(np.float32)
    return _case([a, b], grad=(0, 1) if diff else ())


def _creation(name):
    return {
        "_zeros": _case([], {"shape": (2, 3), "ctx": "cpu"}),
        "_ones": _case([], {"shape": (2, 3), "dtype": "int32",
                            "ctx": "cpu"}),
        "_full": _case([], {"shape": (3,), "value": 2.5, "ctx": "cpu"}),
        "_arange": _case([], {"start": 1.0, "stop": 7.0, "step": 1.5,
                              "repeat": 2, "ctx": "cpu"}),
    }[name]


def _elementwise_other(name):
    rng = _rng(name)
    a, b, t = _u(rng, (3, 4)), _u(rng, (3, 4)), _u(rng, (3, 4), 0, 1)
    return {
        "copy": _case([a], grad=(0,)),
        "stop_gradient": _case([a], grad=(0,)),
        "clip": _case([a], {"a_min": -1.0, "a_max": 1.0}, grad=(0,)),
        "where": _case([(a > 0).astype(np.float32), a, b], grad=(1, 2)),
        "cast": _case([a], {"dtype": "int32"}),
        "amp_cast": _case([a], {"dtype": "float16"}, tol=BF16),
        "smooth_l1": _case([a], {"scalar": 1.0}, grad=(0,)),
        "lerp": _case([a, b, t], grad=(0, 1, 2)),
        "zeros_like": _case([a]),
        "ones_like": _case([a]),
    }[name]


def _reduce(name):
    rng = _rng(name)
    a = _u(rng, (3, 4, 5), 0.5, 2.0)
    nan = a.copy()
    nan[0, 0, 0] = nan[1, 2, 3] = np.nan
    sq = _u(rng, (3, 7))
    return {
        "sum": _case([a], {"axis": 1}, (0,), RED),
        "mean": _case([a], {"axis": (0, 2), "keepdims": True}, (0,), RED),
        "prod": _case([a], {"axis": 1}, (0,), RED),
        "max": _case([a], {"axis": -1}, (0,), RED),
        "min": _case([a], {"axis": 0, "exclude": True}, (0,), RED),
        "nansum": _case([nan], {"axis": 0}, tol=RED),
        "nanprod": _case([nan], {"axis": 0}, tol=RED),
        "norm": _case([a], {"axis": 1}, (0,), RED),
        "argmax": _case([sq], {"axis": 1}),
        "argmin": _case([sq], {"axis": 0}),
        "argmax_channel": _case([sq]),
        "topk": _case([sq], {"axis": 1, "k": 3, "ret_typ": "both"}, (0,)),
        "sort": _case([sq], {"axis": 1, "is_ascend": False}, (0,)),
        "argsort": _case([sq], {"axis": 1, "is_ascend": False}),
        "cumsum": _case([a], {"axis": 1}, (0,), RED),
        "cumprod": _case([a], {"axis": 2}, (0,), RED),
        "L2Normalization": _case([_u(rng, (2, 3, 4))], {"mode": "channel"},
                                 (0,), RED),
    }[name]


def _matrix(name):
    rng = _rng(name)
    a, b = _u(rng, (3, 4), -1, 1), _u(rng, (4, 5), -1, 1)
    ba, bb = _u(rng, (2, 3, 4), -1, 1), _u(rng, (2, 5, 4), -1, 1)
    m = _u(rng, (3, 3), -1, 1)
    spd = (m @ m.T + 3 * np.eye(3)).astype(np.float32)
    low = (np.tril(m) + 3 * np.eye(3)).astype(np.float32)
    x4 = _u(rng, (1, 4, 2, 2))
    big = _u(rng, (4, 5, 6))
    w = _u(rng, (6, 4))
    idx = np.array([[0, 5, 9], [-1, 2, 7]], np.int32)
    gidx = np.array([[0, 1, 2], [1, 3, 0]], np.int32)
    return {
        "dot": _case([_u(rng, (2, 3, 4)), b], grad=(0, 1), tol=RED),
        "batch_dot": _case([ba, bb], {"transpose_b": True}, (0, 1), RED),
        "linalg_gemm2": _case([ba, bb], {"transpose_b": True, "alpha": 2.0},
                              (0, 1), RED),
        "linalg_gemm": _case([ba, bb, _u(rng, (2, 3, 5))],
                             {"transpose_b": True, "alpha": 1.5,
                              "beta": 0.5}, (0, 1, 2), RED),
        "linalg_potrf": _case([spd], grad=(0,), tol=RED),
        "linalg_trsm": _case([low, _u(rng, (4, 3))],
                             {"rightside": True, "transpose": True,
                              "alpha": 2.0}, (0, 1), RED),
        "linalg_syrk": _case([a], {"transpose": True, "alpha": 2.0}, (0,),
                             RED),
        "linalg_extractdiag": _case([spd], {"offset": 1}, (0,)),
        "linalg_sumlogdiag": _case([spd], grad=(0,), tol=RED),
        "reshape": _case([_u(rng, (2, 3, 4, 6))],
                         {"shape": (0, -3, -4, 2, -1)}, (0,)),
        "reshape_like": _case([_u(rng, (2, 3, 4)), _u(rng, (4, 6))],
                              grad=(0,)),
        "shape_array": _case([a]),
        "size_array": _case([a]),
        "transpose": _case([ba], {"axes": (2, 0, 1)}, (0,)),
        "swapaxes": _case([ba], {"dim1": 0, "dim2": 2}, (0,)),
        "expand_dims": _case([a], {"axis": -1}, (0,)),
        "squeeze": _case([_u(rng, (2, 1, 3, 1))], {"axis": 1}, (0,)),
        "flatten": _case([ba], grad=(0,)),
        "broadcast_to": _case([_u(rng, (1, 3, 4))], {"shape": (2, 0, 4)},
                              (0,)),
        "broadcast_like": _case([_u(rng, (1, 3, 1)), ba], grad=(0,)),
        "broadcast_axis": _case([_u(rng, (2, 1, 4))],
                                {"axis": 1, "size": 3}, (0,)),
        "tile": _case([a], {"reps": (2, 1, 3)}, (0,)),
        "repeat": _case([a], {"repeats": 2, "axis": 1}, (0,)),
        "flip": _case([ba], {"axis": (0, 2)}, (0,)),
        "pad": _case([x4], {"mode": "reflect",
                            "pad_width": (0, 0, 0, 0, 1, 1, 1, 1)}, (0,)),
        "concat": _case([a, _u(rng, (3, 2))], {"dim": 1}, (0, 1)),
        "stack": _case([a, a + 1], {"axis": 1}, (0, 1)),
        "split": _case([big], {"num_outputs": 5, "axis": 1,
                               "squeeze_axis": True}, (0,)),
        "split_v2": _case([big], {"indices": (1, 3), "axis": 2}, (0,)),
        "slice": _case([big], {"begin": (3, None, 1), "end": (0, 4, None),
                               "step": (-2, 1, 2)}, (0,)),
        "slice_axis": _case([big], {"axis": 1, "begin": 1, "end": -1},
                            (0,)),
        "slice_like": _case([big, _u(rng, (2, 3, 4))], {"axes": (0, 2)},
                            (0,)),
        "take": _case([w, idx], {"mode": "wrap"}, (0,)),
        "Embedding": _case([idx, w], {"input_dim": 6, "output_dim": 4},
                           (1,)),
        "pick": _case([_u(rng, (3, 5)), np.array([0, 7, -1], np.int32)],
                      {"axis": 1, "keepdims": True}, (0,)),
        "gather_nd": _case([_u(rng, (3, 5)), gidx], grad=(0,)),
        "scatter_nd": _case([_u(rng, (3,)), gidx], {"shape": (3, 5)}, (0,)),
        "one_hot": _case([np.array([1, 0, 5, -1], np.int32)],
                         {"depth": 4, "on_value": 2.0, "off_value": -1.0}),
        "diag": _case([ba], {"k": 1, "axis1": 1, "axis2": 2}, (0,)),
        "depth_to_space": _case([x4], {"block_size": 2}, (0,)),
        "space_to_depth": _case([_u(rng, (1, 2, 4, 4))], {"block_size": 2},
                                (0,)),
        "meshgrid_like": _case([ba], {"axis": 1, "start": 2.0, "step": 0.5}),
        "masked_fill": _case([a, (a > 0).astype(np.float32)], {"value": 9.0},
                             (0,)),
    }[name]


def _nn(name):
    rng = _rng(name)
    x = _u(rng, (2, 3, 7, 6))
    g, bta = _u(rng, (3,), 0.5, 1.5), _u(rng, (3,), -0.5, 0.5)
    mm, mv = _u(rng, (3,), -0.2, 0.2), _u(rng, (3,), 0.5, 1.5)
    return {
        "FullyConnected": _case([_u(rng, (4, 2, 3)), _u(rng, (5, 6)),
                                 _u(rng, (5,))], {"num_hidden": 5},
                                (0, 1, 2), RED),
        "Convolution": _case([x, _u(rng, (4, 3, 3, 2)), _u(rng, (4,))],
                             {"kernel": (3, 2), "stride": (2, 1),
                              "pad": (1, 0), "dilate": (1, 2),
                              "num_filter": 4, "no_bias": False},
                             (0, 1, 2), RED),
        "Deconvolution": _case([x, _u(rng, (3, 2, 3, 3)), _u(rng, (2,))],
                               {"kernel": (3, 3), "stride": (2, 2),
                                "pad": (1, 1), "adj": (1, 0),
                                "num_filter": 2, "no_bias": False},
                               (0, 1, 2), RED),
        "Pooling": _case([x], {"kernel": (3, 3), "stride": (2, 2),
                               "pad": (1, 1), "pool_type": "avg",
                               "pooling_convention": "full",
                               "count_include_pad": False}, (0,), RED),
        "BatchNorm": _case([x, g, bta, mm, mv],
                           {"fix_gamma": False, "training": True,
                            "eps": 1e-3}, (0, 1, 2), RED),
        "FusedNormReluConv": _case(
            [_u(rng, (2, 5, 5, 8)), _u(rng, (3, 3, 8, 8), -0.3, 0.3),
             _u(rng, (8,), 0.5, 1.5), _u(rng, (8,), -0.5, 0.5),
             _u(rng, (8,), -0.2, 0.2), _u(rng, (8,), 0.5, 1.5),
             _u(rng, (2, 5, 5, 8))], {"training": True}, (0, 1, 2, 3, 6),
            RED),
        "LayerNorm": _case([_u(rng, (2, 3, 6)), _u(rng, (6,)),
                            _u(rng, (6,))], {"output_mean_var": True},
                           (0, 1, 2), RED),
        "RMSNorm": _case([_u(rng, (2, 3, 6)), _u(rng, (6,))], {}, (0, 1),
                         RED),
        "GroupNorm": _case([_u(rng, (2, 4, 3, 3)), _u(rng, (4,)),
                            _u(rng, (4,))], {"num_groups": 2}, (0, 1, 2),
                           RED),
        "InstanceNorm": _case([x, g, bta], {}, (0, 1, 2), RED),
        "Activation": _case([x], {"act_type": "softrelu"}, (0,)),
        "LeakyReLU": _case([x, _u(rng, (3,))], {"act_type": "prelu"},
                           (0, 1)),
        "gelu_tanh": _case([x], grad=(0,)),
        "silu": _case([x], grad=(0,)),
        "softmax": _case([_u(rng, (2, 3, 5))],
                         {"axis": 1, "temperature": 2.0}, (0,), RED),
        "log_softmax": _case([_u(rng, (2, 5))], {"axis": 0}, (0,), RED),
        "softmin": _case([_u(rng, (2, 5))], {"temperature": 0.5}, (0,),
                         RED),
        "Dropout": _case([x], {"p": 0.5}, (0,)),
        "SoftmaxOutput": _case([_u(rng, (2, 3, 4)), _u(rng, (2, 4))],
                               {"multi_output": True}, tol=RED),
    }[name]


def _loss(name):
    rng = _rng(name)
    logits = _u(rng, (6, 5, 4))
    label = np.array([[1, 2, 0], [3, 3, 1], [2, 0, 0], [1, 1, 0],
                      [3, 0, 0]], np.int32)
    return {
        "softmax_cross_entropy": _case([_u(rng, (4, 5)),
                                        _ints(rng, (4,), 0, 5)], grad=(0,),
                                       tol=RED),
        "LinearRegressionOutput": _case([_u(rng, (3, 2)), _u(rng, (3, 2))],
                                        grad=(0,)),
        "MAERegressionOutput": _case([_u(rng, (3, 2)), _u(rng, (3, 2))],
                                     grad=(0,)),
        "LogisticRegressionOutput": _case([_u(rng, (3, 2)),
                                           _u(rng, (3, 2))], grad=(0,)),
        "CTCLoss": _case([logits, label], grad=(0,), tol=RED),
        "make_loss": _case([_u(rng, (3, 4))], {"grad_scale": 2.0,
                                              "normalization": "valid",
                                              "valid_thresh": 0.1},
                           (0,)),
    }[name]


def _optimizer(name):
    rng = _rng(name)
    w, g = _u(rng, (3, 4)), _u(rng, (3, 4))
    s1, s2, s3 = _u(rng, (3, 4)), _u(rng, (3, 4), 0.1, 1), _u(rng, (3, 4))
    pos = _u(rng, (3, 4), 0.1, 1)
    kw = {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 0.8}
    w16 = w.astype(jmx.base.dtype_np("bfloat16"))
    return {
        "sgd_update": _case([w, g], kw),
        "sgd_mom_update": _case([w, g, s1], dict(kw, momentum=0.9)),
        "nag_mom_update": _case([w, g, s1], dict(kw, momentum=0.9)),
        "adam_update": _case([w, g, s1, pos], dict(kw, beta1=0.8,
                                                   beta2=0.9)),
        "adamw_update": _case([w, g, s1, pos], dict(kw, eta=0.7)),
        "rmsprop_update": _case([w, g, pos], dict(kw, clip_weights=0.5)),
        "rmspropalex_update": _case([w, g, pos + 1, s1 * 0.1, s3],
                                    dict(kw, momentum=0.9)),
        "ftrl_update": _case([w, g, s1, pos], dict(kw, lamda1=0.05)),
        "signsgd_update": _case([w, g], kw),
        "signum_update": _case([w, g, s1], dict(kw, momentum=0.9,
                                                wd_lh=0.01)),
        "adagrad_update": _case([w, g, pos], kw),
        "adadelta_update": _case([w, g, pos, s2], kw),
        "lamb_update_phase1": _case([w, g, s1, pos],
                                    {"t": 3, "wd": 0.01, "beta1": 0.8,
                                     "rescale_grad": 0.5}),
        "lamb_update_phase2": _case([w, g, np.array(2.0, np.float32),
                                     np.array(0.5, np.float32)],
                                    {"lr": 0.1, "lower_bound": 2.5}),
        "mp_sgd_update": _case([w16, g.astype(w16.dtype), w], kw, tol=BF16),
        "mp_sgd_mom_update": _case([w16, g.astype(w16.dtype), s1, w],
                                   dict(kw, momentum=0.9), tol=BF16),
        "multi_sgd_update": _case([w, g, s1, s3],
                                  {"lrs": (0.1, 0.2), "wds": 0.01,
                                   "num_weights": 2}),
        "multi_mp_sgd_update": _case([w16, g.astype(w16.dtype), w],
                                     {"lrs": 0.1, "wds": 0.01}, tol=BF16),
    }[name]


_BUILDERS = []
for _names, _fn in [
        (list(jelementwise._BINARY), _binary),
        ([n for n in jelementwise._UNARY], _unary),
        (["_zeros", "_ones", "_full", "_arange"], _creation),
        (["copy", "stop_gradient", "clip", "where", "cast", "amp_cast",
          "smooth_l1", "lerp", "zeros_like", "ones_like"],
         _elementwise_other)]:
    _BUILDERS += [(n, _fn) for n in _names]
_BUILDERS += [(n, _reduce) for n in (
    "sum", "mean", "prod", "max", "min", "nansum", "nanprod", "norm",
    "argmax", "argmin", "argmax_channel", "topk", "sort", "argsort",
    "cumsum", "cumprod", "L2Normalization")]
_BUILDERS += [(n, _matrix) for n in (
    "dot", "batch_dot", "linalg_gemm2", "linalg_gemm", "linalg_potrf",
    "linalg_trsm", "linalg_syrk", "linalg_extractdiag", "linalg_sumlogdiag",
    "reshape", "reshape_like", "shape_array", "size_array", "transpose",
    "swapaxes", "expand_dims", "squeeze", "flatten", "broadcast_to",
    "broadcast_like", "broadcast_axis", "tile", "repeat", "flip", "pad",
    "concat", "stack", "split", "split_v2", "slice", "slice_axis",
    "slice_like", "take", "Embedding", "pick", "gather_nd", "scatter_nd",
    "one_hot", "diag", "depth_to_space", "space_to_depth", "meshgrid_like",
    "masked_fill")]
_BUILDERS += [(n, _nn) for n in (
    "FullyConnected", "Convolution", "Deconvolution", "Pooling", "BatchNorm",
    "FusedNormReluConv", "LayerNorm", "RMSNorm", "GroupNorm", "InstanceNorm",
    "Activation", "LeakyReLU", "gelu_tanh", "silu", "softmax", "log_softmax",
    "softmin", "Dropout", "SoftmaxOutput")]
_BUILDERS += [(n, _loss) for n in (
    "softmax_cross_entropy", "LinearRegressionOutput", "MAERegressionOutput",
    "LogisticRegressionOutput", "CTCLoss", "make_loss")]
_BUILDERS += [(n, _optimizer) for n in (
    "sgd_update", "sgd_mom_update", "nag_mom_update", "adam_update",
    "adamw_update", "rmsprop_update", "rmspropalex_update", "ftrl_update",
    "signsgd_update", "signum_update", "adagrad_update", "adadelta_update",
    "lamb_update_phase1", "lamb_update_phase2", "mp_sgd_update",
    "mp_sgd_mom_update", "multi_sgd_update", "multi_mp_sgd_update")]
CANONICAL = dict(_BUILDERS)


def _canonical(name):
    """The name whose case ``name`` runs: itself, or the canonical name
    registered with the same function in both registries."""
    if name in CANONICAL:
        return name
    for c in CANONICAL:
        if TOPS.get(c) is TOPS[name] and JOPS[c] is JOPS[name]:
            return c
    raise KeyError(name)


def test_every_name_has_a_case():
    missing = []
    for name in sorted(ROW_NAMES):
        try:
            _canonical(name)
        except KeyError:
            missing.append(name)
    assert not missing


# -------------------------------------------------------------- running --
def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _run_jax(name, case, cots):
    args = [jmx.nd.array(a, dtype=a.dtype) if isinstance(a, np.ndarray)
            else a for a in case["inputs"]]
    if not case["grad"]:
        return [o.asnumpy() for o in _as_list(
            jinvoke(name, *args, **case["kw"]))], []
    for i in case["grad"]:
        args[i].attach_grad()
    with jag.record():
        outs = _as_list(jinvoke(name, *args, **case["kw"]))
    jag.backward(outs, [jmx.nd.array(c, dtype=c.dtype) for c in cots(outs)])
    return ([o.asnumpy() for o in outs],
            [args[i].grad.asnumpy() for i in case["grad"]])


def _run_port(name, case, cots):
    with tmx.cpu():
        args = [tmx.nd.array(a, dtype=a.dtype) if isinstance(a, np.ndarray)
                else a for a in case["inputs"]]
        if not case["grad"]:
            return [o.asnumpy() for o in _as_list(
                tinvoke(name, *args, **case["kw"]))], []
        for i in case["grad"]:
            args[i].attach_grad()
        with tag.record():
            outs = _as_list(tinvoke(name, *args, **case["kw"]))
        tag.backward(outs, [tmx.nd.array(c, dtype=c.dtype)
                            for c in cots(outs)])
        return ([o.asnumpy() for o in outs],
                [args[i].grad.asnumpy() for i in case["grad"]])


def _cotangents(name):
    def make(outs):
        rng = _rng("cot:" + name)
        return [np.asarray(rng.randn(*o.shape)).astype(o.dtype)
                for o in outs]
    return make


def _close(got, want, tol, what):
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=tol[0],
                               atol=tol[1], err_msg=what)


@pytest.mark.parametrize("name", sorted(ROW_NAMES))
def test_op_matches_jax(name):
    """Forward outputs (values, dtype) and input gradients of ``name``
    in the port equal the JAX op's."""
    case = CANONICAL[_canonical(name)](_canonical(name))
    if name in ("Dropout", "dropout"):
        # the packages draw other masks: hold the predict-mode identity
        # and the gradient through it
        case["kw"]["training"] = False
    cots = _cotangents(name)
    j_out, j_grad = _run_jax(name, case, cots)
    t_out, t_grad = _run_port(name, case, cots)
    assert len(t_out) == len(j_out)
    for k, (t, j) in enumerate(zip(t_out, j_out)):
        _close(t, j, case["tol"], f"{name} output {k}")
    for i, t, j in zip(case["grad"], t_grad, j_grad):
        _close(t, j, case["tol"], f"{name} d input {i}")
