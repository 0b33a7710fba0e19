"""Public test utilities (the port of ``mxnet_tpu/test_utils.py``).

ref: python/mxnet/test_utils.py — ``check_numeric_gradient`` (finite
differences vs the autograd path), ``check_consistency`` (same op across
dtypes), ``assert_almost_equal`` with per-dtype tolerances; SURVEY.md §4
calls this "the single most load-bearing test utility".

The autograd side is torch autograd behind ``autograd.record()`` and the
op side the eager ``invoke`` dispatch, so a check exercises the code a
user's training step runs.  Every array is made on ``ctx``: None is the
caller's current context (``with mx.cpu():``, else the card).
"""
from __future__ import annotations

import numpy as np

from . import autograd
from .context import current_context
from .ndarray import NDArray, invoke
from .ndarray import array as nd_array

__all__ = ["default_tols", "assert_almost_equal", "check_numeric_gradient",
           "check_consistency", "rand_ndarray"]

_DTYPE_TOLS = {
    np.dtype(np.float64): (1e-9, 1e-11),
    np.dtype(np.float32): (1e-4, 1e-5),
    np.dtype(np.float16): (1e-2, 1e-2),
    # bfloat16 has 8 mantissa bits
    "bfloat16": (3e-2, 3e-2),
}


def default_tols(dtype):
    """(rtol, atol) for a dtype (ref: test_utils.py — default_tols)."""
    key = str(dtype)
    if key == "bfloat16":
        return _DTYPE_TOLS["bfloat16"]
    return _DTYPE_TOLS.get(np.dtype(key), (1e-4, 1e-5))


def _to_np(x):
    if isinstance(x, NDArray):
        x = x.asnumpy()
    return np.asarray(x)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """ref: test_utils.py — assert_almost_equal with per-dtype tolerances
    (tolerance chosen from the least precise of the two dtypes)."""
    a_dt = str(getattr(a, "dtype", "float32"))
    b_dt = str(getattr(b, "dtype", "float32"))
    a, b = _to_np(a), _to_np(b)
    # ml_dtypes (bfloat16, ...) report numpy kind 'V'; route them to the
    # float comparison path at their declared tolerance
    if a.dtype.kind == "V":
        a = a.astype(np.float32)
    if b.dtype.kind == "V":
        b = b.astype(np.float32)
    if rtol is None or atol is None:
        ra, aa = default_tols(a_dt)
        rb, ab = default_tols(b_dt)
        rtol = rtol if rtol is not None else max(ra, rb)
        atol = atol if atol is not None else max(aa, ab)
    if a.dtype.kind not in "fc":
        np.testing.assert_array_equal(a, b,
                                      err_msg=f"{names[0]} != {names[1]}")
        return
    np.testing.assert_allclose(
        a.astype(np.float64), b.astype(np.float64), rtol=rtol, atol=atol,
        equal_nan=equal_nan, err_msg=f"{names[0]} != {names[1]}")


def rand_ndarray(shape, low=-1.0, high=1.0, dtype="float32", seed=None,
                 ctx=None):
    rng = np.random.RandomState(seed)
    return nd_array(rng.uniform(low, high, size=shape).astype(dtype),
                    ctx=ctx or current_context())


def _call(op, inputs, kwargs):
    if callable(op) and not isinstance(op, str):
        out = op(*inputs, **kwargs)
    else:
        out = invoke(op, *inputs, **kwargs)
    return out if isinstance(out, (tuple, list)) else (out,)


def _is_float(a):
    return str(a.dtype) == "bfloat16" or \
        np.issubdtype(np.dtype(str(a.dtype)), np.floating)


def check_numeric_gradient(op, inputs, kwargs=None, grad_inputs=None,
                           eps=None, rtol=2e-2, atol=2e-3, n_samples=8,
                           seed=0, ctx=None):
    """Finite differences vs the autograd path (ref: test_utils.py —
    check_numeric_gradient).

    op: registered op name (str) or a callable over NDArrays.
    inputs: list of numpy arrays; float arrays participate in the check
    unless ``grad_inputs`` (indices) narrows the set.  The multi-output /
    tensor-output case is reduced to a scalar by projecting every float
    output against a fixed random cotangent, so one backward pass checks all
    input gradients at once.  ``n_samples`` coordinates per input are probed
    (central differences) instead of the full O(numel) sweep.
    """
    kwargs = kwargs or {}
    ctx = ctx or current_context()
    rng = np.random.RandomState(seed)
    inputs = [np.asarray(a) for a in inputs]
    if grad_inputs is None:
        grad_inputs = [i for i, a in enumerate(inputs)
                       if np.issubdtype(a.dtype, np.floating)]
    eps = eps if eps is not None else 1e-3

    nds = [nd_array(a, ctx=ctx) for a in inputs]
    for i in grad_inputs:
        nds[i].attach_grad()

    projs = None

    def scalar_loss(nd_list):
        nonlocal projs
        outs = _call(op, nd_list, kwargs)
        f_outs = [o for o in outs if isinstance(o, NDArray) and _is_float(o)]
        if projs is None:
            projs = [nd_array(rng.uniform(-1, 1, size=o.shape)
                              .astype(np.float32), ctx=ctx) for o in f_outs]
        total = None
        for o, p in zip(f_outs, projs):
            term = (o.astype("float32") * p).sum()
            total = term if total is None else total + term
        return total

    with autograd.record():
        loss = scalar_loss(nds)
    loss.backward()
    analytic = {i: nds[i].grad.asnumpy().astype(np.float64)
                for i in grad_inputs}

    for i in grad_inputs:
        flat = inputs[i].ravel()
        n = flat.size
        idxs = (np.arange(n) if n <= n_samples
                else rng.choice(n, size=n_samples, replace=False))
        scale = max(1e-2, float(np.abs(flat).mean()))
        h = eps * scale
        for j in idxs:
            plus = [a.copy() for a in inputs]
            minus = [a.copy() for a in inputs]
            plus[i].ravel()[j] += h
            minus[i].ravel()[j] -= h
            with autograd.pause():
                lp = float(scalar_loss([nd_array(a, ctx=ctx)
                                        for a in plus]).asnumpy())
                lm = float(scalar_loss([nd_array(a, ctx=ctx)
                                        for a in minus]).asnumpy())
            numeric = (lp - lm) / (2 * h)
            got = analytic[i].ravel()[j]
            denom = max(abs(numeric), abs(got), 1.0)
            if abs(numeric - got) > atol + rtol * denom:
                raise AssertionError(
                    f"numeric gradient mismatch for op {op!r} input {i} "
                    f"elem {j}: numeric={numeric:.6g} autograd={got:.6g} "
                    f"(rtol={rtol}, atol={atol})")


def check_consistency(op, inputs, kwargs=None, dtypes=("float32", "bfloat16"),
                      rtol=None, atol=None, ctx=None):
    """Run an op at several dtypes and compare against the highest-precision
    run (ref: test_utils.py — check_consistency across ctx/dtype pairs; here
    the axis is dtype, on one device)."""
    kwargs = kwargs or {}
    ctx = ctx or current_context()
    inputs = [np.asarray(a) for a in inputs]
    results = {}
    for dt in dtypes:
        nds = [nd_array(a, ctx=ctx).astype(dt)
               if np.issubdtype(a.dtype, np.floating)
               else nd_array(a, ctx=ctx) for a in inputs]
        outs = _call(op, nds, kwargs)
        results[dt] = [o.astype("float32").asnumpy()
                       if isinstance(o, NDArray) and _is_float(o)
                       else (o.asnumpy() if isinstance(o, NDArray) else o)
                       for o in outs]
    base = results[dtypes[0]]
    for dt in dtypes[1:]:
        dr, da = default_tols(dt)
        r = rtol if rtol is not None else dr
        a = atol if atol is not None else da
        for o_base, o_dt in zip(base, results[dt]):
            np.testing.assert_allclose(
                np.asarray(o_base, np.float64), np.asarray(o_dt, np.float64),
                rtol=r, atol=a,
                err_msg=f"op {op!r} inconsistent between "
                        f"{dtypes[0]} and {dt}")
