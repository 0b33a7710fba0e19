"""``mx.np`` of the port against the JAX package's: every name of the
JAX frontend's delegation lists (``_UNARY``, ``_BINARY``, ``_SHAPE``,
``_OTHER``, ``_REDUCE``, ``_CONCAT``, ``_EXTRA``, ``_PASSTHROUGH``, less
what its ``jax.numpy`` lacks) runs through both packages on the same
seeded numpy inputs; values within 1e-5 (the case's own tolerance where
it says), shapes and dtypes equal.  This file holds the case table and
runs the elementwise, shape, reduction and concatenation names;
``test_torch_numpy_other.py`` runs ``_OTHER`` and ``_EXTRA``.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import np as jnp_
from mxnet_tpu import npx as jnpx
from mxnet_tpu.numpy import (_BINARY, _CONCAT, _EXTRA, _OTHER,
                             _PASSTHROUGH, _REDUCE, _SHAPE, _UNARY)
from mxnet_tpu_torch import np as tnp_
from mxnet_tpu_torch import npx as tnpx


@pytest.fixture(autouse=True)
def _cpu_and_reset():
    """On the host; ``set_np`` and AMP off again in both packages after
    each test (both are process-wide)."""
    with tmx.cpu():
        yield
    jnpx.reset_np()
    tnpx.reset_np()
    jmx.amp._deinit_for_tests()
    tmx.amp._deinit_for_tests()


R = onp.random.RandomState(0)
A = R.randn(4, 5).astype(onp.float32)
B = R.randn(4, 5).astype(onp.float32)
P = onp.abs(A) + 0.5
Q = onp.abs(B) + 0.5
U = (R.rand(4, 5).astype(onp.float32) - 0.5) * 1.8
I = R.randint(0, 10, (4, 5)).astype(onp.int32)
J = R.randint(1, 6, (4, 5)).astype(onp.int32)
BO = R.rand(4, 5) > 0.5
BO2 = R.rand(4, 5) > 0.5
V = (R.rand(6) + 0.5).astype(onp.float32)
M = R.randn(5, 3).astype(onp.float32)
A3 = R.randn(2, 3, 4).astype(onp.float32)
A6 = R.randn(4, 6).astype(onp.float32)
SQ = R.randn(4, 4).astype(onp.float32)
SM = R.randn(2, 2).astype(onp.float32)
N = A.copy()
N[0, 1] = N[2, 3] = onp.nan
INFS = A.copy()
INFS[0, 0], INFS[1, 1], INFS[2, 2] = onp.inf, -onp.inf, onp.nan
S = onp.sort(R.randn(8).astype(onp.float32))
IDX = onp.array([0, 2, 3], onp.int32)
IDX2 = R.randint(0, 5, (4, 2)).astype(onp.int32)
C3 = R.randn(4, 3).astype(onp.float32)
D3 = R.randn(4, 3).astype(onp.float32)
W5 = (R.rand(5) + 0.1).astype(onp.float32)
PHASE = onp.cumsum(R.rand(10).astype(onp.float32) * 2.5)
Z = onp.array([0, 0, 1, 2, 0, 3, 0], onp.float32)
U8 = R.randint(0, 256, (3, 2)).astype(onp.uint8)
P1 = onp.array([1.0, -2.0, 3.0], onp.float32)
P2 = onp.array([0.5, 4.0], onp.float32)
W3 = onp.array([0.2, 0.5, -1.0], onp.float32)
XS = onp.linspace(-1, 1, 9).astype(onp.float32)
YS = (2 * XS ** 2 - XS + 0.5).astype(onp.float32)
V7 = R.randn(7).astype(onp.float32)


def _f(x):
    return x * 2 + 1


def _f_axes(x, axis):
    return x.sum(axis=axis, keepdims=True)


# name -> (a function making (args, kwargs) from the package's array function,
#          tolerance); several cases of one name carry a suffix "#k"
CASES = {
    # ---- unary
    **{n: (lambda a: ((a(A),), {}), 1e-5) for n in (
        "exp", "expm1", "cbrt", "square", "abs", "absolute", "sign",
        "negative", "sin", "cos", "tan", "arctan", "sinh", "cosh", "tanh",
        "arcsinh", "degrees", "radians", "floor", "ceil")},
    **{n: (lambda a: ((a(P),), {}), 1e-5) for n in (
        "log", "log2", "log10", "log1p", "sqrt", "reciprocal")},
    **{n: (lambda a: ((a(U),), {}), 1e-5) for n in (
        "arcsin", "arccos", "arctanh")},
    "arccosh": (lambda a: ((a(P + 1),), {}), 1e-5),
    **{n: (lambda a: ((a(A * 3),), {}), 1e-5) for n in (
        "rint", "trunc", "fix")},
    "logical_not": (lambda a: ((a(BO),), {}), 0),
    **{n: (lambda a: ((a(INFS),), {}), 0) for n in (
        "isnan", "isinf", "isfinite", "isneginf", "isposinf")},
    # ---- binary
    **{n: (lambda a: ((a(P), a(Q)), {}), 1e-5) for n in (
        "add", "subtract", "multiply", "divide", "true_divide", "maximum",
        "minimum", "hypot", "arctan2", "logaddexp")},
    "add#scalar": (lambda a: ((a(A), 2.0), {}), 1e-6),
    "multiply#int": (lambda a: ((a(I), 3), {}), 0),
    "true_divide#int": (lambda a: ((a(I), a(J)), {}), 1e-6),
    "power": (lambda a: ((a(P), a(B)), {}), 1e-5),
    "copysign": (lambda a: ((a(A), a(B)), {}), 0),
    **{n: (lambda a: ((a(A * 3), a(Q)), {}), 1e-5) for n in (
        "floor_divide", "mod", "remainder", "fmod")},
    "mod#int": (lambda a: ((a(I - 5), a(J)), {}), 0),
    **{n: (lambda a: ((a(A), a(B)), {}), 0) for n in (
        "equal", "not_equal", "greater", "greater_equal", "less",
        "less_equal")},
    **{n: (lambda a: ((a(BO), a(BO2)), {}), 0) for n in (
        "logical_and", "logical_or", "logical_xor")},
    **{n: (lambda a: ((a(I), a(J)), {}), 0) for n in (
        "bitwise_and", "bitwise_or", "bitwise_xor", "left_shift",
        "right_shift", "gcd", "lcm")},
    # ---- shape
    "reshape": (lambda a: ((a(A), (5, 4)), {}), 0),
    "ravel": (lambda a: ((a(A),), {}), 0),
    "moveaxis": (lambda a: ((a(A3), 0, -1), {}), 0),
    "swapaxes": (lambda a: ((a(A), 0, 1), {}), 0),
    "expand_dims": (lambda a: ((a(A), 1), {}), 0),
    "expand_dims#tuple": (lambda a: ((a(A), (0, 3)), {}), 0),
    "squeeze": (lambda a: ((a(A[None, :, None]),), {}), 0),
    "squeeze#axis": (lambda a: ((a(A[None]),), {"axis": 0}), 0),
    "broadcast_to": (lambda a: ((a(V), (3, 6)), {}), 0),
    "flip": (lambda a: ((a(A), 0), {}), 0),
    "flip#all": (lambda a: ((a(A),), {}), 0),
    "fliplr": (lambda a: ((a(A),), {}), 0),
    "flipud": (lambda a: ((a(A),), {}), 0),
    "roll": (lambda a: ((a(A), 2), {}), 0),
    "roll#axis": (lambda a: ((a(A), -1), {"axis": 1}), 0),
    "rot90": (lambda a: ((a(A),), {}), 0),
    "rot90#k": (lambda a: ((a(A3), 3), {"axes": (1, 2)}), 0),
    "tile": (lambda a: ((a(A), (2, 1)), {}), 0),
    "repeat": (lambda a: ((a(A), 2), {"axis": 1}), 0),
    "repeat#flat": (lambda a: ((a(V), 3), {}), 0),
    "atleast_1d": (lambda a: ((a(onp.float32(2.0)),), {}), 0),
    "atleast_2d": (lambda a: ((a(V),), {}), 0),
    "atleast_3d": (lambda a: ((a(V),), {}), 0),
    "transpose": (lambda a: ((a(A3),), {}), 0),
    "transpose#axes": (lambda a: ((a(A3), (1, 0, 2)), {}), 0),
    # ---- other
    "where": (lambda a: ((a(BO), a(A), a(B)), {}), 0),
    "where#scalar": (lambda a: ((a(BO), a(A), 0.0), {}), 0),
    "clip": (lambda a: ((a(A), -0.5, 0.5), {}), 0),
    "tril": (lambda a: ((a(A),), {}), 0),
    "triu": (lambda a: ((a(A), 1), {}), 0),
    "diag": (lambda a: ((a(V),), {}), 0),
    "diag#matrix": (lambda a: ((a(A), 1), {}), 0),
    "trace": (lambda a: ((a(SQ),), {}), 1e-5),
    "sort": (lambda a: ((a(A),), {"axis": 1}), 0),
    "sort#flat": (lambda a: ((a(A),), {"axis": None}), 0),
    "argsort": (lambda a: ((a(A),), {"axis": 1}), 0),
    "searchsorted": (lambda a: ((a(S), a(V - 1)), {}), 0),
    "searchsorted#right": (lambda a: ((a(S), a(S[2:5])),
                                      {"side": "right"}), 0),
    "unique": (lambda a: ((a(I),), {}), 0),
    "unique#all": (lambda a: ((a(I),), {"return_index": True,
                                        "return_inverse": True,
                                        "return_counts": True}), 0),
    "cumsum": (lambda a: ((a(A),), {"axis": 1}), 1e-5),
    "cumsum#int": (lambda a: ((a(I),), {}), 0),
    "cumprod": (lambda a: ((a(P),), {"axis": 0}), 1e-5),
    "diff": (lambda a: ((a(A),), {"axis": 1}), 1e-6),
    "diff#n2": (lambda a: ((a(V),), {"n": 2}), 1e-6),
    "ediff1d": (lambda a: ((a(V),), {}), 1e-6),
    "nan_to_num": (lambda a: ((a(INFS),), {}), 0),
    "around": (lambda a: ((a(A * 10), 1), {}), 1e-5),
    "round": (lambda a: ((a(A * 10),), {}), 0),
    "real": (lambda a: ((a(A),), {}), 0),
    "imag": (lambda a: ((a(A),), {}), 0),
    "interp": (lambda a: ((a(XS * 1.3), a(XS), a(YS)), {}), 1e-5),
    "take": (lambda a: ((a(A), a(IDX)), {}), 0),
    "take#axis": (lambda a: ((a(A), a(IDX2)), {"axis": 1}), 0),
    "take_along_axis": (lambda a: ((a(A), a(IDX2), 1), {}), 0),
    "nonzero": (lambda a: ((a(BO),), {}), 0),
    "count_nonzero": (lambda a: ((a(I),), {"axis": 0}), 0),
    "allclose": (lambda a: ((a(A), a(A + 1e-7)), {}), 0),
    "array_equal": (lambda a: ((a(A), a(A)), {}), 0),
    "isclose": (lambda a: ((a(A), a(B)), {}), 0),
    "histogram": (lambda a: ((a(A),), {"bins": 4}), 1e-5),
    "bincount": (lambda a: ((a(I.ravel()),), {}), 0),
    "bincount#weights": (lambda a: ((a(I.ravel()),),
                                    {"weights": a(A.ravel())}), 1e-5),
    "pad": (lambda a: ((a(A), 1), {}), 0),
    "pad#edge": (lambda a: ((a(A), ((1, 0), (0, 2))), {"mode": "edge"}), 0),
    "pad#reflect": (lambda a: ((a(A), 2), {"mode": "reflect"}), 0),
    "pad#wrap": (lambda a: ((a(A), ((0, 1), (2, 1))), {"mode": "wrap"}), 0),
    "insert": (lambda a: ((a(V), 2, 9.0), {}), 0),
    "insert#axis": (lambda a: ((a(A), 1, a(onp.arange(4, dtype=onp.float32))),
                               {"axis": 1}), 0),
    "delete": (lambda a: ((a(V), a(onp.array([1, 3], onp.int32))), {}), 0),
    "delete#axis": (lambda a: ((a(A), 2), {"axis": 1}), 0),
    "flatnonzero": (lambda a: ((a(BO),), {}), 0),
    "tensordot": (lambda a: ((a(A), a(M)), {"axes": ([1], [0])}), 1e-5),
    "dot": (lambda a: ((a(A), a(M)), {}), 1e-5),
    "dot#vec": (lambda a: ((a(V), a(V)), {}), 1e-5),
    "dot#nd": (lambda a: ((a(A3), a(A6)), {}), 1e-5),
    "matmul": (lambda a: ((a(A), a(M)), {}), 1e-5),
    "inner": (lambda a: ((a(A), a(B)), {}), 1e-5),
    "outer": (lambda a: ((a(V), a(V)), {}), 1e-5),
    "vdot": (lambda a: ((a(A), a(B)), {}), 1e-5),
    "kron": (lambda a: ((a(SM), a(SM)), {}), 1e-6),
    "cross": (lambda a: ((a(C3), a(D3)), {}), 1e-5),
    "einsum": (lambda a: (("ij,jk->ik", a(A), a(M)), {}), 1e-5),
    "average": (lambda a: ((a(A),), {"axis": 1, "weights": a(W5)}), 1e-5),
    "average#plain": (lambda a: ((a(A),), {}), 1e-5),
    # ---- reductions
    "sum": (lambda a: ((a(A),), {}), 1e-5),
    "sum#axis": (lambda a: ((a(A),), {"axis": 1, "keepdims": True}), 1e-5),
    "sum#int": (lambda a: ((a(I),), {}), 0),
    "sum#bool": (lambda a: ((a(BO),), {"axis": 0}), 0),
    "prod": (lambda a: ((a(P),), {"axis": 0}), 1e-5),
    "mean": (lambda a: ((a(A),), {}), 1e-5),
    "mean#int": (lambda a: ((a(I),), {"axis": 1}), 1e-5),
    "std": (lambda a: ((a(A),), {"axis": 0}), 1e-5),
    "var": (lambda a: ((a(A),), {}), 1e-5),
    "var#ddof": (lambda a: ((a(A),), {"axis": 1, "ddof": 1}), 1e-5),
    "max": (lambda a: ((a(A),), {}), 0),
    "min": (lambda a: ((a(A),), {"axis": 0}), 0),
    "amax": (lambda a: ((a(A),), {"axis": 1}), 0),
    "amin": (lambda a: ((a(A),), {"axis": (0, 1)}), 0),
    "argmax": (lambda a: ((a(A),), {}), 0),
    "argmax#axis": (lambda a: ((a(A),), {"axis": 1}), 0),
    "argmin": (lambda a: ((a(A),), {"axis": 0}), 0),
    "all": (lambda a: ((a(BO),), {}), 0),
    "any": (lambda a: ((a(BO),), {"axis": 1}), 0),
    "nansum": (lambda a: ((a(N),), {}), 1e-5),
    "nanprod": (lambda a: ((a(N),), {"axis": 1}), 1e-5),
    "nanmean": (lambda a: ((a(N),), {"axis": 0}), 1e-5),
    "nanmax": (lambda a: ((a(N),), {"axis": 1}), 0),
    "nanmin": (lambda a: ((a(N),), {}), 0),
    "median": (lambda a: ((a(A),), {}), 1e-6),
    "median#axis": (lambda a: ((a(A),), {"axis": 1}), 1e-6),
    "percentile": (lambda a: ((a(A), 30),), 1e-5),
    "quantile": (lambda a: ((a(A), a(onp.array([0.25, 0.75],
                                                onp.float32))),
                            {"axis": 0}), 1e-5),
    "ptp": (lambda a: ((a(A),), {"axis": 1}), 1e-6),
    # ---- concatenation and splits
    "concatenate": (lambda a: (([a(A), a(B)],), {"axis": 0}), 0),
    "concatenate#flat": (lambda a: (([a(A), a(V)],), {"axis": None}), 0),
    "stack": (lambda a: (([a(A), a(B)],), {"axis": 1}), 0),
    "vstack": (lambda a: (([a(A), a(B)],), {}), 0),
    "hstack": (lambda a: (([a(A), a(B)],), {}), 0),
    "dstack": (lambda a: (([a(A), a(B)],), {}), 0),
    "column_stack": (lambda a: (([a(V), a(V)],), {}), 0),
    "split": (lambda a: ((a(A6), 3), {"axis": 1}), 0),
    "split#indices": (lambda a: ((a(A6), [1, 3]), {"axis": 1}), 0),
    "array_split": (lambda a: ((a(A), 3), {"axis": 1}), 0),
    "vsplit": (lambda a: ((a(A6), 2), {}), 0),
    "hsplit": (lambda a: ((a(A6), 3), {}), 0),
    "dsplit": (lambda a: ((a(A3), 2), {}), 0),
    # ---- the long tail
    "logspace": (lambda a: ((0.0, 2.0, 5), {}), 1e-5),
    "indices": (lambda a: (((2, 3),), {}), 0),
    "tri": (lambda a: ((3, 4, 1), {}), 0),
    "diagonal": (lambda a: ((a(A3), 0, 1, 2), {}), 0),
    "positive": (lambda a: ((a(A),), {}), 0),
    "heaviside": (lambda a: ((a(onp.round(A)), 0.5), {}), 0),
    "angle": (lambda a: ((a(A),), {}), 1e-6),
    "conj": (lambda a: ((a(A),), {}), 0),
    "conjugate": (lambda a: ((a(A),), {}), 0),
    "unwrap": (lambda a: ((a(PHASE),), {}), 1e-4),
    "sinc": (lambda a: ((a(A),), {}), 1e-5),
    "nanstd": (lambda a: ((a(N),), {}), 1e-5),
    "nanvar": (lambda a: ((a(N),), {"axis": 0}), 1e-5),
    "nanargmax": (lambda a: ((a(N),), {"axis": 1}), 0),
    "nanargmin": (lambda a: ((a(N),), {}), 0),
    "nancumsum": (lambda a: ((a(N),), {"axis": 1}), 1e-5),
    "nancumprod": (lambda a: ((a(N * 0.5),), {"axis": 1}), 1e-5),
    "digitize": (lambda a: ((a(V), a(onp.array([0.6, 0.9, 1.2],
                                                 onp.float32))), {}), 0),
    "digitize#right": (lambda a: ((a(V), a(onp.array([0.6, 0.9, 1.2],
                                                       onp.float32))),
                                  {"right": True}), 0),
    "lexsort": (lambda a: (((a(I[0]), a(I[1])),), {}), 0),
    "union1d": (lambda a: ((a(I[0]), a(I[1])), {}), 0),
    "intersect1d": (lambda a: ((a(I[0]), a(I[1])), {}), 0),
    "setdiff1d": (lambda a: ((a(I[0]), a(I[1])), {}), 0),
    "setxor1d": (lambda a: ((a(I[0]), a(I[1])), {}), 0),
    "isin": (lambda a: ((a(I), a(onp.array([1, 2, 3], onp.int32))), {}), 0),
    "broadcast_arrays": (lambda a: ((a(V), a(V[:3, None])), {}), 0),
    "append": (lambda a: ((a(A), a(B)), {"axis": 0}), 0),
    "append#flat": (lambda a: ((a(V), a(P1)), {}), 0),
    "resize": (lambda a: ((a(V), (3, 4)), {}), 0),
    "trim_zeros": (lambda a: ((a(Z),), {}), 0),
    "gradient": (lambda a: ((a(V),), {}), 1e-5),
    "gradient#2d": (lambda a: ((a(A),), {}), 1e-5),
    "iscomplex": (lambda a: ((a(A),), {}), 0),
    "isreal": (lambda a: ((a(A),), {}), 0),
    "iscomplexobj": (lambda a: ((a(A),), {}), 0),
    "isrealobj": (lambda a: ((a(A),), {}), 0),
    "nextafter": (lambda a: ((a(A), a(B)), {}), 0),
    "spacing": (lambda a: ((a(A),), {}), 0),
    "ldexp": (lambda a: ((a(A), a(J)), {}), 0),
    "frexp": (lambda a: ((a(A),), {}), 0),
    "modf": (lambda a: ((a(A * 3),), {}), 1e-6),
    "deg2rad": (lambda a: ((a(A),), {}), 1e-6),
    "rad2deg": (lambda a: ((a(A),), {}), 1e-5),
    "invert": (lambda a: ((a(I),), {}), 0),
    "invert#bool": (lambda a: ((a(BO),), {}), 0),
    "argwhere": (lambda a: ((a(BO),), {}), 0),
    "extract": (lambda a: ((a(BO), a(A)), {}), 0),
    "choose": (lambda a: ((a(I % 3), [a(A), a(B), a(P)]), {}), 0),
    "compress": (lambda a: ((a(onp.array([True, False, True, True])),
                             a(A)), {"axis": 0}), 0),
    "select": (lambda a: (([a(BO), a(~BO2)], [a(A), a(B)]),
                          {"default": 0.5}), 0),
    "signbit": (lambda a: ((a(A),), {}), 0),
    "float_power": (lambda a: ((a(P), 2.5), {}), 1e-5),
    "divmod": (lambda a: ((a(A * 3), a(Q)), {}), 1e-5),
    "cov": (lambda a: ((a(A),), {}), 1e-5),
    "cov#cols": (lambda a: ((a(A),), {"rowvar": False, "bias": True}),
                 1e-5),
    "corrcoef": (lambda a: ((a(A),), {}), 1e-5),
    "convolve": (lambda a: ((a(V), a(W3)), {}), 1e-5),
    "convolve#same": (lambda a: ((a(V), a(W3)), {"mode": "same"}), 1e-5),
    "convolve#valid": (lambda a: ((a(W3), a(V)), {"mode": "valid"}), 1e-5),
    "correlate": (lambda a: ((a(V), a(W3)), {}), 1e-5),
    "correlate#full": (lambda a: ((a(V), a(W3)), {"mode": "full"}), 1e-5),
    "correlate#same": (lambda a: ((a(V), a(W3)), {"mode": "same"}), 1e-5),
    "empty_like": (lambda a: ((a(A),), {}), 0),
    "copy": (lambda a: ((a(A),), {}), 0),
    "rollaxis": (lambda a: ((a(A3), 2), {}), 0),
    "rollaxis#start": (lambda a: ((a(A3), 0, 2), {}), 0),
    "block": (lambda a: (([[a(SM), a(SM * 2)], [a(SM * 3), a(SM)]],), {}),
              0),
    "apply_along_axis": (lambda a: ((_f, 1, a(A)), {}), 1e-6),
    "apply_over_axes": (lambda a: ((_f_axes, a(A3), [0, 2]), {}), 1e-5),
    "triu_indices": (lambda a: ((4, 1), {}), 0),
    "tril_indices": (lambda a: ((4,), {}), 0),
    "triu_indices_from": (lambda a: ((a(SQ),), {}), 0),
    "tril_indices_from": (lambda a: ((a(SQ), -1), {}), 0),
    "diag_indices": (lambda a: ((3,), {}), 0),
    "diag_indices_from": (lambda a: ((a(SQ),), {}), 0),
    "unravel_index": (lambda a: ((a(onp.array([3, 7, 11], onp.int32)),
                                  (3, 4)), {}), 0),
    "ravel_multi_index": (lambda a: (((a(onp.array([1, 2], onp.int32)),
                                       a(onp.array([0, 3], onp.int32))),
                                      (3, 4)), {}), 0),
    "ix_": (lambda a: ((a(onp.array([0, 1], onp.int32)),
                        a(onp.array([2, 3], onp.int32))), {}), 0),
    "packbits": (lambda a: ((a(BO),), {}), 0),
    "packbits#axis": (lambda a: ((a(BO),), {"axis": 1}), 0),
    "unpackbits": (lambda a: ((a(U8),), {}), 0),
    "poly": (lambda a: ((a(P1),), {}), 1e-5),
    "polyadd": (lambda a: ((a(P1), a(P2)), {}), 0),
    "polysub": (lambda a: ((a(P1), a(P2)), {}), 0),
    "polymul": (lambda a: ((a(P1), a(P2)), {}), 1e-6),
    "polyder": (lambda a: ((a(P1),), {}), 0),
    "polyint": (lambda a: ((a(P1),), {}), 1e-6),
    "polyval": (lambda a: ((a(P1), a(V)), {}), 1e-5),
    "polyfit": (lambda a: ((a(XS), a(YS), 2), {}), 1e-3),
    "meshgrid": (lambda a: ((a(V[:3]), a(V[:2])), {}), 0),
}
# numpy guarantees only the kth element and the sides of a partition
PARTITION = ("partition", "argpartition")
PASSTHROUGH_DTYPES = ("float16", "float64", "uint16", "uint32", "uint64",
                      "int16", "complex64", "complex128")
DELEGATED = [n for n in (_UNARY + _BINARY + _SHAPE + _OTHER + _REDUCE
                         + _CONCAT + _EXTRA) if hasattr(jnp_, n)]


def test_the_names_are_the_jax_packages():
    """Exactly the JAX frontend's names that resolve, and a case each."""
    want = set(DELEGATED) | {n for n in _PASSTHROUGH if hasattr(jnp_, n)}
    have = {n for n in tnp_.__all__ if n in set(
        _UNARY + _BINARY + _SHAPE + _OTHER + _REDUCE + _CONCAT + _EXTRA
        + _PASSTHROUGH)}
    assert have == want, sorted(have ^ want)
    covered = {k.split("#")[0] for k in CASES} | set(PARTITION)
    assert set(DELEGATED) <= covered, sorted(set(DELEGATED) - covered)


def _values(x):
    """A result as nested lists of numpy arrays / Python values."""
    if isinstance(x, (tuple, list)) or type(x).__name__ in (
            "UniqueAllResult",):
        return [_values(v) for v in x]
    if isinstance(x, jmx.nd.NDArray):
        return onp.asarray(x._data)
    if isinstance(x, tmx.nd.NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "dtype") and hasattr(x, "shape"):
        return onp.asarray(x)
    return x


def _same(got, want, tol, where):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for k, (g, w) in enumerate(zip(got, want)):
            _same(g, w, tol, f"{where}[{k}]")
        return
    if not isinstance(want, onp.ndarray):
        assert got == want, (where, got, want)
        return
    assert isinstance(got, onp.ndarray), (where, type(got))
    assert got.shape == want.shape, (where, got.shape, want.shape)
    assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
    if tol:
        onp.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                    equal_nan=True, err_msg=where)
    else:
        onp.testing.assert_array_equal(got, want, err_msg=where)


OTHER_NAMES = set(_OTHER + _EXTRA + ["meshgrid", "transpose"])


def run_case(case):
    name = case.split("#")[0]
    build, tol = CASES[case][0], CASES[case][-1]
    # the JAX frontend's delegation passes a nested list of its arrays
    # through unconverted: its block gets numpy arrays
    jargs = build(onp.asarray if name == "block" else jnp_.array)
    targs = build(tnp_.array)
    jargs, jkw = (jargs[0], jargs[1]) if len(jargs) == 2 else (jargs[0], {})
    targs, tkw = (targs[0], targs[1]) if len(targs) == 2 else (targs[0], {})
    want = _values(getattr(jnp_, name)(*jargs, **jkw))
    got = getattr(tnp_, name)(*targs, **tkw)
    leaves = got if isinstance(got, (tuple, list)) else [got]
    for leaf in leaves:
        if isinstance(leaf, tmx.nd.NDArray):
            assert isinstance(leaf, tnp_.ndarray), (case, type(leaf))
    _same(_values(got), want, tol, case)


@pytest.mark.parametrize("case", sorted(
    c for c in CASES if c.split("#")[0] not in OTHER_NAMES))
def test_delegated_name_matches_jax(case):
    run_case(case)


def test_passthrough_names():
    for n in PASSTHROUGH_DTYPES:
        assert onp.dtype(getattr(tnp_, n)) == onp.dtype(getattr(jnp_, n)), n
    assert tnp_.promote_types("int32", "float32") == \
        jnp_.promote_types("int32", "float32")
    assert tnp_.can_cast("int32", "float32") == \
        jnp_.can_cast("int32", "float32")
    tv = tnp_.vectorize(lambda x, y: x * y + 1)(tnp_.array(A), tnp_.array(B))
    jv = jnp_.vectorize(lambda x, y: x * y + 1)(jnp_.array(A).\
                                                 _data, jnp_.array(B)._data)
    onp.testing.assert_allclose(tv.asnumpy(), onp.asarray(jv), rtol=1e-6)
