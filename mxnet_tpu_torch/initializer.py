"""Weight initializers (the port of ``mxnet_tpu/initializer.py``).

Values are drawn on the host from one explicit ``torch.Generator``
(``seed(s)`` resets it, as ``mx.random.seed`` reseeds the JAX package's
key), in float32, then cast; ``Parameter`` moves them to its device.
The JAX package's draws come from threefry keys, so the same seed gives
other numbers here: parity tests copy parameters across instead
(``gluon.model_zoo.vision.params_from_jax``).  The name-suffix dispatch
of the JAX ``Initializer.__call__`` is kept: ``gamma``/``running_var``
start at one, ``beta``/``running_mean``/``bias`` at zero.
"""
from __future__ import annotations

import math

import torch

from .base import dtype_torch

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Xavier", "MSRAPrelu", "TruncNorm", "Orthogonal", "LSTMBias",
           "Bilinear", "register", "create", "seed"]

_REGISTRY = {}
_GEN = torch.Generator().manual_seed(0)


def seed(value):
    """Reseed the generator every initializer draws from."""
    _GEN.manual_seed(int(value))


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init, **kwargs):
    """An initializer from an instance, a registered name or None (the
    default ``Uniform(0.07)``)."""
    if init is None:
        return Uniform(0.07)
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        name = {"zeros": "zero", "ones": "one"}.get(init.lower(),
                                                   init.lower())
        if name not in _REGISTRY:
            raise ValueError(f"unknown initializer '{init}'")
        return _REGISTRY[name](**kwargs)
    raise TypeError(f"cannot create initializer from {init!r}")


class Initializer:
    """Base initializer: ``init(name, shape, dtype)`` -> a CPU tensor."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, shape, dtype="float32"):
        if name.endswith(("gamma", "running_var", "var")):
            return torch.ones(shape, dtype=dtype_torch(dtype))
        if name.endswith(("beta", "running_mean", "mean", "bias")):
            return torch.zeros(shape, dtype=dtype_torch(dtype))
        return self.init_array(shape, dtype)

    def init_array(self, shape, dtype="float32"):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


@register
class Zero(Initializer):
    def init_array(self, shape, dtype="float32"):
        return torch.zeros(shape, dtype=dtype_torch(dtype))


@register
class One(Initializer):
    def init_array(self, shape, dtype="float32"):
        return torch.ones(shape, dtype=dtype_torch(dtype))


@register
class Constant(Initializer):
    """Every element ``value``, whatever the parameter's name."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def init_array(self, shape, dtype="float32"):
        return torch.full(shape, self.value, dtype=dtype_torch(dtype))

    def __call__(self, name, shape, dtype="float32"):
        return self.init_array(shape, dtype)


def _uniform(shape, scale):
    return (torch.rand(shape, generator=_GEN) * 2.0 - 1.0) * scale


@register
class Uniform(Initializer):
    """U(-scale, scale): the default for weights."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def init_array(self, shape, dtype="float32"):
        return _uniform(shape, self.scale).to(dtype_torch(dtype))


@register
class Normal(Initializer):
    """N(0, sigma**2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def init_array(self, shape, dtype="float32"):
        return (torch.randn(shape, generator=_GEN) * self.sigma).to(
            dtype_torch(dtype))


def _fan(shape):
    """fan_in/fan_out with the receptive-field scaling of the JAX
    ``_fan``: dims past the first two multiply both."""
    if len(shape) < 2:
        fan = shape[0] if shape else 1
        return fan, fan
    hw = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
    return shape[1] * hw, shape[0] * hw


@register
class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def init_array(self, shape, dtype="float32"):
        fan_in, fan_out = _fan(shape)
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise ValueError("factor_type must be avg/in/out")
        scale = math.sqrt(self.magnitude / max(factor, 1e-12))
        if self.rnd_type == "uniform":
            a = _uniform(shape, scale)
        elif self.rnd_type == "gaussian":
            a = torch.randn(shape, generator=_GEN) * scale
        else:
            raise ValueError("rnd_type must be uniform/gaussian")
        return a.to(dtype_torch(dtype))


@register
class MSRAPrelu(Xavier):
    """He initialisation for a PReLU of negative slope ``slope``:
    gaussian Xavier with magnitude ``2 / (1 + slope**2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class TruncNorm(Initializer):
    """Normal(mean, stdev) truncated at +-2 stdev (BERT's init), drawn by
    inverting the normal CDF on a uniform between the two cut points,
    as ``jax.random.truncated_normal`` draws it."""

    def __init__(self, mean=0.0, stdev=0.01):
        super().__init__(mean=mean, stdev=stdev)
        self.mean = mean
        self.stdev = stdev

    def init_array(self, shape, dtype="float32"):
        lo, hi = (0.5 * (1.0 + math.erf(c / math.sqrt(2.0)))
                  for c in (-2.0, 2.0))
        u = lo + torch.rand(shape, generator=_GEN, dtype=torch.float64) \
            * (hi - lo)
        x = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-2.0, 2.0)
        return (x.float() * self.stdev + self.mean).to(dtype_torch(dtype))


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal matrix (the SVD factor of a draw,
    uniform in [-1, 1] or normal, of shape ``(shape[0], prod(rest))``),
    reshaped to ``shape``."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def init_array(self, shape, dtype="float32"):
        nout = shape[0]
        nin = math.prod(shape[1:]) if len(shape) > 1 else 1
        if self.rand_type == "uniform":
            tmp = _uniform((nout, nin), 1.0)
        else:
            tmp = torch.randn((nout, nin), generator=_GEN)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        return (self.scale * q.reshape(shape)).to(dtype_torch(dtype))


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter (gate order i, f, g, o) at
    ``forget_bias``, whatever the parameter's name."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def __call__(self, name, shape, dtype="float32"):
        b = torch.zeros(shape, dtype=dtype_torch(dtype))
        n = shape[0] // 4
        b[n:2 * n] = self.forget_bias
        return b

    def init_array(self, shape, dtype="float32"):
        return self("", shape, dtype)


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernels for a deconvolution weight (the last
    two dims the kernel's)."""

    def init_array(self, shape, dtype="float32"):
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = torch.arange(math.prod(shape), dtype=torch.float64)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        w = (1 - (x / f - c).abs()) * (1 - (y / f - c).abs())
        return w.reshape(shape).to(dtype_torch(dtype))
