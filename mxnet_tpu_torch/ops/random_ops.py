"""Random sampling operators, registered in the op registry (the port of
``mxnet_tpu/ops/random_ops.py``).

ref: src/operator/random/sample_op.cc — the reference registers its
sampler family (``_random_uniform``, ``_random_normal``, ...) as NNVM ops
so every frontend draws through one dispatch path; here they are
registry ops, so ``nd.invoke``, ``mx.sym`` and the generated wrappers
(``nd.uniform``, ``nd.normal``, ``nd.randint``, ``nd.shuffle``) reach
the same functions.

Every draw comes from the port's seeded per-device generator
(``random.generator``) of the device it lands on: a ``_random_*`` op's
``ctx`` (None: the current context, the card by default), a
``_sample_*`` op's parameter tensors' device.  A CUDA draw runs on the
card from the card's generator; nothing is drawn on the host for a card
tensor.  Inside a captured CUDA graph the framework's generators are
registered (``graphs``), so every replay draws anew.  The JAX package
splits threefry keys: the same seed gives other numbers here (the
declared divergence of ``random``), and parity is held by each
sampler's invariants.

The parameterisation is the JAX package's: ``beta`` of the gamma is
its scale, ``lam`` of the exponential and Poisson the rate, and the
negative binomials are gamma-Poisson mixtures.

The ``_sample_*`` variants (ref: src/operator/random/multisample_op.cc)
draw per row: parameter arrays of shape ``(B,)`` give ``(B, *shape)``.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..base import dtype_torch
from .registry import register_op


def _norm_shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _device(ctx):
    """``ctx``'s device; ``meta`` while a shape inference traces."""
    from ..context import resolve_device, tracing_shapes
    return torch.device("meta") if tracing_shapes() else resolve_device(ctx)


def _gen(device):
    return None if device.type == "meta" else _random.generator(device)


def _gamma(alpha, device, gen):
    """Standard gamma draws of shape ``alpha.shape`` (f32 rates)."""
    if device.type == "meta":
        return torch.empty(alpha.shape, device=device)
    return torch._standard_gamma(alpha, generator=gen)


def _poisson(lam, device, gen):
    if device.type == "meta":
        return torch.empty(lam.shape, device=device)
    return torch.poisson(lam, generator=gen)


def _exponential(shape, device, gen):
    return torch.empty(shape, device=device).exponential_(1.0, generator=gen)


@register_op("_random_uniform", aliases=("uniform", "random_uniform"),
             needs_rng=True)
def _random_uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", ctx=None):
    """ref: sample_op.cc — _random_uniform over ``[low, high)``."""
    dev = _device(ctx)
    u = torch.rand(_norm_shape(shape), generator=_gen(dev), device=dev,
                   dtype=dtype_torch(dtype))
    return low + u * (high - low)


@register_op("_random_normal", aliases=("normal", "random_normal"),
             needs_rng=True)
def _random_normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", ctx=None):
    """ref: sample_op.cc — _random_normal."""
    dev = _device(ctx)
    return loc + scale * torch.randn(_norm_shape(shape), generator=_gen(dev),
                                     device=dev, dtype=dtype_torch(dtype))


@register_op("_random_gamma", aliases=("random_gamma",), needs_rng=True)
def _random_gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", ctx=None):
    """ref: sample_op.cc — _random_gamma; ``beta`` is the scale."""
    dev = _device(ctx)
    a = torch.full(_norm_shape(shape), float(alpha), device=dev)
    return (beta * _gamma(a, dev, _gen(dev))).to(dtype_torch(dtype))


@register_op("_random_exponential", aliases=("random_exponential",),
             needs_rng=True)
def _random_exponential(lam=1.0, shape=(1,), dtype="float32", ctx=None):
    """ref: sample_op.cc — _random_exponential (rate ``lam``)."""
    dev = _device(ctx)
    e = _exponential(_norm_shape(shape), dev, _gen(dev))
    return (e / lam).to(dtype_torch(dtype))


@register_op("_random_poisson", aliases=("random_poisson",), needs_rng=True)
def _random_poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None):
    """ref: sample_op.cc — _random_poisson; counts in ``dtype``."""
    dev = _device(ctx)
    rate = torch.full(_norm_shape(shape), float(lam), device=dev)
    return _poisson(rate, dev, _gen(dev)).to(dtype_torch(dtype))


@register_op("_random_negative_binomial",
             aliases=("random_negative_binomial",), needs_rng=True)
def _random_negative_binomial(k=1, p=0.5, shape=(1,), dtype="float32",
                              ctx=None):
    """ref: sample_op.cc — failures before the ``k``-th success at success
    probability ``p``: lam ~ Gamma(k, (1-p)/p), out ~ Poisson(lam)."""
    dev = _device(ctx)
    gen = _gen(dev)
    a = torch.full(_norm_shape(shape), float(k), device=dev)
    lam = _gamma(a, dev, gen) * ((1.0 - p) / p)
    return _poisson(lam, dev, gen).to(dtype_torch(dtype))


@register_op("_random_generalized_negative_binomial",
             aliases=("random_generalized_negative_binomial",),
             needs_rng=True)
def _random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,),
                                          dtype="float32", ctx=None):
    """ref: sample_op.cc — the (mu, alpha) mean/dispersion form:
    Gamma(1/alpha, mu*alpha) mixed through Poisson."""
    dev = _device(ctx)
    gen = _gen(dev)
    a = torch.full(_norm_shape(shape), 1.0 / alpha, device=dev)
    lam = _gamma(a, dev, gen) * (mu * alpha)
    return _poisson(lam, dev, gen).to(dtype_torch(dtype))


@register_op("_random_randint", aliases=("random_randint", "randint"),
             needs_rng=True)
def _random_randint(low=0, high=2, shape=(1,), dtype="int32", ctx=None):
    """ref: sample_op.cc — _random_randint over ``[low, high)``."""
    dev = _device(ctx)
    return torch.randint(int(low), int(high), _norm_shape(shape),
                         generator=_gen(dev), device=dev,
                         dtype=dtype_torch(dtype))


# ---- per-row parameterised sampling (ref: multisample_op.cc) --------------
def _rows(param, shape):
    """``param`` (B,) viewed against per-row draw shape, and that shape."""
    extra = _norm_shape(shape)
    return param.reshape(param.shape + (1,) * len(extra)), extra


def _f32(t):
    return t if t.dtype == torch.float32 else t.float()


@register_op("_sample_uniform", aliases=("sample_uniform",), needs_rng=True)
def _sample_uniform(low, high, shape=(), dtype="float32"):
    """ref: multisample_op.cc — _sample_uniform: row i from
    ``[low[i], high[i])``."""
    lo, extra = _rows(low, shape)
    hi, _ = _rows(high, shape)
    u = torch.rand(low.shape + extra, generator=_gen(low.device),
                   device=low.device, dtype=dtype_torch(dtype))
    return lo + u * (hi - lo)


@register_op("_sample_normal", aliases=("sample_normal",), needs_rng=True)
def _sample_normal(mu, sigma, shape=(), dtype="float32"):
    """ref: multisample_op.cc — _sample_normal."""
    m, extra = _rows(mu, shape)
    s, _ = _rows(sigma, shape)
    z = torch.randn(mu.shape + extra, generator=_gen(mu.device),
                    device=mu.device, dtype=dtype_torch(dtype))
    return m + s * z


@register_op("_sample_gamma", aliases=("sample_gamma",), needs_rng=True)
def _sample_gamma(alpha, beta, shape=(), dtype="float32"):
    """ref: multisample_op.cc — _sample_gamma (alpha shape, beta scale)."""
    a, extra = _rows(alpha, shape)
    b, _ = _rows(beta, shape)
    dev = alpha.device
    g = _gamma(_f32(a).expand(alpha.shape + extra).contiguous(), dev,
               _gen(dev))
    return b * g.to(dtype_torch(dtype))


@register_op("_sample_exponential", aliases=("sample_exponential",),
             needs_rng=True)
def _sample_exponential(lam, shape=(), dtype="float32"):
    """ref: multisample_op.cc — _sample_exponential (rates ``lam``)."""
    l, extra = _rows(lam, shape)
    e = _exponential(lam.shape + extra, lam.device, _gen(lam.device))
    return e.to(dtype_torch(dtype)) / l


@register_op("_sample_poisson", aliases=("sample_poisson",), needs_rng=True)
def _sample_poisson(lam, shape=(), dtype="float32"):
    """ref: multisample_op.cc — _sample_poisson."""
    l, extra = _rows(lam, shape)
    rate = _f32(l).expand(lam.shape + extra).contiguous()
    return _poisson(rate, lam.device, _gen(lam.device)) \
        .to(dtype_torch(dtype))


@register_op("_sample_multinomial", aliases=("sample_multinomial",),
             needs_rng=True)
def _sample_multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """ref: src/operator/random/sample_multinomial_op.cc — categorical
    draws from probability rows ``(..., K)``.  The output is batch_shape +
    shape; the unspecified default is one draw squeezed to batch_shape
    (the reference's ``shape=_Null``), while an explicit ``shape=1`` keeps
    the trailing axis.  ``get_prob=True`` also returns the log
    probability of each draw (f32), as the reference's two-output form.

    ``nd.random.multinomial`` is this op."""
    extra = _norm_shape(shape)
    n = math.prod(extra)
    batch = tuple(data.shape[:-1])
    logp = torch.log(torch.clamp_min(_f32(data), 1e-30))
    rows = logp.reshape(-1, data.shape[-1])
    if data.device.type == "meta":
        idx = torch.empty((rows.shape[0], n), dtype=torch.int64,
                          device=data.device)
    else:
        # the softmax of the clamped log probabilities: the categorical
        # distribution the JAX op draws from (rows need not sum to 1)
        idx = torch.multinomial(torch.softmax(rows, dim=-1), n,
                                replacement=True,
                                generator=_gen(data.device))
    out = idx.reshape(batch + extra).to(dtype_torch(dtype))
    if get_prob:
        lp = torch.gather(rows, 1, idx)
        return out, lp.reshape(batch + extra)
    return out


@register_op("_shuffle", aliases=("shuffle",), needs_rng=True)
def _shuffle(data):
    """ref: src/operator/random/shuffle_op.cc — permute along axis 0."""
    if data.device.type == "meta":
        return torch.empty_like(data)
    perm = torch.randperm(data.shape[0], generator=_gen(data.device),
                          device=data.device)
    return data[perm]
