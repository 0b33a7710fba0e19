"""Elementwise and broadcast ops (the port of
``mxnet_tpu/ops/elementwise.py``).

Binary ops take two tensors or a tensor and a Python scalar, either way
round, and broadcast.  Python scalars are weakly typed, as in JAX: a
float scalar keeps a float tensor's dtype and turns an integer tensor
float32, an int scalar keeps the tensor's dtype.  Comparisons and
logical ops return the first operand's float dtype (float32 for an
integer or scalar first operand), not bool, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import dtype_torch
from .registry import alias_op, register_op

__all__ = []


def _res_dtype(a):
    if isinstance(a, torch.Tensor) and a.is_floating_point():
        return a.dtype
    return torch.float32


def _tensors(a, b):
    """Both operands as tensors, a Python scalar made a 0-d tensor of
    the dtype JAX's weak typing gives it beside the other operand."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a, b
    if isinstance(a, torch.Tensor):
        return a, _scalar(b, a)
    return _scalar(a, b), b


def _scalar(s, like):
    dt = like.dtype
    if isinstance(s, float) and not like.is_floating_point():
        dt = torch.float32
    return torch.full((), s, dtype=dt, device=like.device)


def _compare(fn):
    return lambda a, b: fn(a, b).to(_res_dtype(a))


def _logical(fn):
    def op(a, b):
        a2, b2 = _tensors(a, b)
        return fn(a2, b2).to(_res_dtype(a))
    return op


def _both(fn):
    def op(x1, x2):
        return fn(*_tensors(x1, x2))
    return op


def _ufunc(fn):
    """Two inputs taken as ``*args``, the JAX registry's signature for
    these ops (numpy's ufuncs), so a symbol builder maps positionals as
    the JAX package's does."""
    def op(*args):
        a, b = args
        return fn(a, b)
    return op


# ---------------------------------------------------------------- binary ----
_BINARY = {
    "add": _ufunc(lambda a, b: a + b),
    "subtract": _ufunc(lambda a, b: a - b),
    "multiply": _ufunc(lambda a, b: a * b),
    "divide": lambda x1, x2: x1 / x2,
    "mod": lambda x1, x2: x1 % x2,
    "power": lambda x1, x2: x1 ** x2,
    "maximum": _ufunc(_both(torch.maximum)),
    "minimum": _ufunc(_both(torch.minimum)),
    "hypot": _both(torch.hypot),
    "arctan2": _both(torch.atan2),
    "equal": _compare(lambda a, b: a == b),
    "not_equal": _compare(lambda a, b: a != b),
    "greater": _compare(lambda a, b: a > b),
    "greater_equal": _compare(lambda a, b: a >= b),
    "lesser": _compare(lambda a, b: a < b),
    "lesser_equal": _compare(lambda a, b: a <= b),
    "logical_and": _logical(torch.logical_and),
    "logical_or": _logical(torch.logical_or),
    "logical_xor": _logical(torch.logical_xor),
}

for _name, _fn in _BINARY.items():
    register_op(_name, _fn)

for _name in ("add", "subtract", "multiply", "divide", "mod", "power",
              "maximum", "minimum", "hypot", "equal", "not_equal", "greater",
              "greater_equal", "lesser", "lesser_equal", "logical_and",
              "logical_or", "logical_xor"):
    alias_op(f"broadcast_{_name}", _name)
alias_op("broadcast_sub", "subtract")
alias_op("broadcast_mul", "multiply")
alias_op("broadcast_div", "divide")
alias_op("broadcast_plus", "add")
alias_op("broadcast_minus", "subtract")
alias_op("elemwise_add", "add")
alias_op("elemwise_sub", "subtract")
alias_op("elemwise_mul", "multiply")
alias_op("elemwise_div", "divide")


# ----------------------------------------------------------------- unary ----
def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


_UNARY = {
    "abs": torch.abs,
    "sign": torch.sign,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log1p": torch.log1p,
    "log2": torch.log2,
    "log10": torch.log10,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "round": torch.round,
    "rint": torch.round,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "negative": torch.neg,
    "reciprocal": torch.reciprocal,
    "sigmoid": torch.sigmoid,
    "softsign": F.softsign,
    "relu": torch.relu,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "logical_not": lambda x: torch.logical_not(x).to(_res_dtype(x)),
    "isnan": lambda x: torch.isnan(x).to(_res_dtype(x)),
    "isinf": lambda x: torch.isinf(x).to(_res_dtype(x)),
    "isfinite": lambda x: torch.isfinite(x).to(_res_dtype(x)),
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
}

for _name, _fn in _UNARY.items():
    register_op(_name)(lambda x, _f=_fn: _f(x))


@register_op("copy", aliases=("identity", "_copy"))
def _copy(x):
    return x.clone()


@register_op("stop_gradient", aliases=("BlockGrad", "block_grad"))
def _stop_gradient(x):
    return x.detach()


@register_op("clip")
def _clip(x, a_min=None, a_max=None):
    return torch.clamp(x, a_min, a_max)


@register_op("where")
def _where(cond, a, b):
    return torch.where(cond if cond.dtype == torch.bool else cond != 0, a, b)


@register_op("cast", aliases=("Cast", "astype"))
def _cast(x, dtype="float32"):
    return x.to(dtype_torch(dtype))


@register_op("amp_cast")
def _amp_cast(x, dtype="float16"):
    # a float16 request is bfloat16, as in the JAX package
    if str(dtype) == "float16":
        dtype = "bfloat16"
    return x.to(dtype_torch(dtype))


@register_op("smooth_l1")
def _smooth_l1(x, scalar=1.0):
    sigma2 = scalar * scalar
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / sigma2, 0.5 * sigma2 * x * x,
                       absx - 0.5 / sigma2)


@register_op("lerp")
def _lerp(a, b, t):
    return a + (b - a) * t


@register_op("zeros_like")
def _zeros_like(x):
    return torch.zeros_like(x)


@register_op("ones_like")
def _ones_like(x):
    return torch.ones_like(x)


# ---- creation ops: registry ops so a frontend without arrays can make
# constants; ``mx.nd`` keeps its own creation functions ----
def _shape_tuple(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _device(ctx):
    """``ctx``'s device; ``meta`` while a shape inference traces."""
    from ..context import resolve_device, tracing_shapes
    return torch.device("meta") if tracing_shapes() else resolve_device(ctx)


@register_op("_zeros", aliases=("zeros",))
def _zeros_op(shape=(1,), dtype="float32", ctx=None):
    return torch.zeros(_shape_tuple(shape), dtype=dtype_torch(dtype),
                       device=_device(ctx))


@register_op("_ones", aliases=("ones",))
def _ones_op(shape=(1,), dtype="float32", ctx=None):
    return torch.ones(_shape_tuple(shape), dtype=dtype_torch(dtype),
                      device=_device(ctx))


@register_op("_full", aliases=("full",))
def _full_op(shape=(1,), value=0.0, dtype="float32", ctx=None, val=None):
    """``value`` is the reference op's name; ``val`` (``mx.nd.full``'s
    spelling) is accepted too."""
    if val is not None:
        value = val
    return torch.full(_shape_tuple(shape), value, dtype=dtype_torch(dtype),
                      device=_device(ctx))


@register_op("_arange", aliases=("arange",))
def _arange_op(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
               dtype="float32", ctx=None):
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=dtype_torch(dtype),
                       device=_device(ctx))
    if repeat != 1:
        out = torch.repeat_interleave(out, repeat)
    return out
