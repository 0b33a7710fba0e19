"""Quantized gradient collectives (the port of
``mxnet_tpu/parallel/quantize.py``).

- **Chunked symmetric quantization** (``quantize_chunked`` /
  ``dequantize_chunked``): int8 payloads with one f32 scale per
  ``chunk`` elements (amax / 127).  Rounding is stochastic when a
  ``torch.Generator`` is given as ``key`` (``floor(x/scale + u)``,
  ``u ~ U[0,1)``: unbiased), else to nearest, half to even (the JAX
  package's ``jnp.round``, bit for bit).
- **Stochastic bf16 cast** (``cast_bf16``): 16 random low bits added to
  the f32 bit pattern before truncation.
- **The reduction stage** (``reduce_gradients``), called inside a
  ``shard_map`` over the data-parallel axis with the rank's local
  gradients: ``"f32"`` one all-reduce, ``"bf16"`` the stochastically
  cast payload all-reduced in bf16, ``"int8"`` the two-phase exchange —
  each rank's gradient cut into one slice per rank, quantized, the
  slices exchanged (all-to-all: int8 payload and f32 scales), each rank
  dequantizes and sums the slice it owns, requantizes it once, and every
  owned slice is gathered (all-gather, int8 and f32 again) and
  dequantized alike on every rank, so the result is bit-identical across
  ranks.  The leaves of one call share each collective: their payloads
  are laid side by side in one buffer per phase (the chunks stay each
  leaf's own), so a step makes four collectives, not four per leaf.

A NaN chunk keeps its NaN scale, so a non-finite gradient stays
non-finite through the exchange and ``TrainStep(skip_nonfinite=True)``
sees it on every rank.
"""
from __future__ import annotations

import math

import torch

from . import mesh as _mesh

__all__ = ["GRAD_REDUCE_MODES", "ACTIVATION_REDUCE_MODES",
           "quantize_chunked", "dequantize_chunked", "cast_bf16",
           "reduce_gradients", "all_reduce_activations"]

#: the TrainStep ``grad_reduce=`` vocabulary
GRAD_REDUCE_MODES = ("f32", "bf16", "int8")

#: the serving ``tp_collectives=`` vocabulary
ACTIVATION_REDUCE_MODES = ("f32", "int8")

#: default elements per quantization chunk
DEFAULT_CHUNK = 256


def _blocks(x, chunk):
    """``(..., L)`` -> ``(..., nc, c)`` zero-padded chunk view,
    ``c = min(chunk, L)``."""
    L = x.shape[-1]
    c = max(1, min(int(chunk), L))
    nc = -(-L // c)
    pad = nc * c - L
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(tuple(x.shape[:-1]) + (nc, c))


def quantize_chunked(x, chunk=DEFAULT_CHUNK, key=None):
    """Symmetric per-chunk int8 quantization over the last axis.

    Returns ``(q, scales)``: ``q`` int8 of shape ``(..., nc, c)`` and
    ``scales`` f32 of shape ``(..., nc)``.  ``key`` (a
    ``torch.Generator`` on ``x``'s device) makes the rounding
    stochastic."""
    xb = _blocks(x.float(), chunk)
    amax = xb.abs().amax(dim=-1)
    # != 0, not > 0: a NaN amax must keep its NaN scale
    scales = torch.where(amax != 0, amax / 127.0, torch.ones_like(amax))
    y = xb / scales[..., None]
    if key is None:
        q = torch.round(y)
    else:
        q = torch.floor(y + torch.rand(y.shape, generator=key,
                                       device=y.device))
    return q.clamp(-127.0, 127.0).to(torch.int8), scales


def dequantize_chunked(q, scales, length, dtype=torch.float32):
    """Inverse of ``quantize_chunked``: ``(..., nc, c)`` int8 + scales ->
    ``(..., length)`` in ``dtype`` (padding stripped)."""
    y = q.float() * scales[..., None]
    y = y.reshape(tuple(y.shape[:-2]) + (-1,))
    return y[..., :length].to(dtype)


def cast_bf16(x, key=None):
    """bf16 cast; stochastic (unbiased) when ``key`` is given: 16 random
    low bits carry into the kept mantissa with probability equal to the
    truncated remainder."""
    x32 = x.float()
    if key is None:
        return x32.to(torch.bfloat16)
    u = x32.contiguous().view(torch.int32)
    r = torch.randint(0, 1 << 16, x32.shape, generator=key,
                      device=x32.device, dtype=torch.int32)
    hi = ((u + r) >> 16) & 0xFFFF          # the top 16 bits, as uint16
    hi = torch.where(hi >= 1 << 15, hi - (1 << 16), hi)
    return hi.to(torch.int16).view(torch.bfloat16)


def _flat_slices(g, n_dev):
    """``g`` as f32, zero-padded to ``n_dev * m`` and cut into ``(n_dev,
    m)``: one slice per rank."""
    n = g.numel()
    m = -(-n // n_dev)
    flat = g.float().reshape(-1)
    if n_dev * m != n:
        flat = torch.nn.functional.pad(flat, (0, n_dev * m - n))
    return flat.reshape(n_dev, m), m


def _reduce_int8(leaves, axis_name, n_dev, key, chunk, mean):
    """The two-phase int8 reduction of every leaf in ``leaves``."""
    metas, qs, ss = [], [], []
    for g in leaves:
        x, m = _flat_slices(g, n_dev)
        q, s = quantize_chunked(x, chunk, key)
        metas.append((g, m, q.shape[1:], s.shape[1:]))
        qs.append(q.reshape(n_dev, -1))
        ss.append(s.reshape(n_dev, -1))
    # phase 1: slice j of every leaf to rank j, int8 and f32 on the wire
    q_in = _mesh.all_to_all(torch.cat(qs, dim=1), axis_name)
    s_in = _mesh.all_to_all(torch.cat(ss, dim=1), axis_name)
    q2s, s2s, qo, so = [], [], 0, 0
    for g, m, qshape, sshape in metas:
        nq, ns = math.prod(qshape), math.prod(sshape)
        q = q_in[:, qo:qo + nq].reshape((n_dev,) + tuple(qshape))
        s = s_in[:, so:so + ns].reshape((n_dev,) + tuple(sshape))
        qo, so = qo + nq, so + ns
        owned = dequantize_chunked(q, s, m).sum(dim=0)         # (m,)
        if mean:
            owned = owned / n_dev
        q2, s2 = quantize_chunked(owned, chunk, key)
        q2s.append(q2.reshape(-1))
        s2s.append(s2.reshape(-1))
    # phase 2: every rank's owned slices to every rank
    q_all = _mesh.all_gather(torch.cat(q2s), axis_name)        # (n, ...)
    s_all = _mesh.all_gather(torch.cat(s2s), axis_name)
    out, qo, so = [], 0, 0
    for (g, m, _qs, _ss), q2, s2 in zip(metas, q2s, s2s):
        nq, ns = q2.numel(), s2.numel()
        q = q_all[:, qo:qo + nq].reshape(n_dev, ns, -1)
        s = s_all[:, so:so + ns]
        qo, so = qo + nq, so + ns
        full = dequantize_chunked(q, s, m).reshape(-1)[:g.numel()]
        out.append(full.reshape(g.shape).to(g.dtype))
    return out


def _psum_flat(leaves, axis_name):
    """One all-reduce over every leaf of one dtype, side by side."""
    flat = torch.cat([g.reshape(-1) for g in leaves])
    red = _mesh.psum(flat, axis_name)
    out, o = [], 0
    for g in leaves:
        out.append(red[o:o + g.numel()].reshape(g.shape))
        o += g.numel()
    return out


def all_reduce_activations(x, axis_name, n_dev, mode="int8", key=None,
                           chunk=DEFAULT_CHUNK):
    """Cross-rank SUM of one activation tensor with a compressed wire
    format (``"f32"``: a plain all-reduce; ``"int8"``: the two-phase
    exchange, to nearest unless ``key``)."""
    if mode not in ACTIVATION_REDUCE_MODES:
        raise ValueError(f"all_reduce_activations: mode {mode!r} not in "
                         f"{ACTIVATION_REDUCE_MODES}")
    if mode == "f32":
        return _mesh.psum(x, axis_name)
    return _reduce_int8([x], axis_name, n_dev, key, chunk, mean=False)[0]


def reduce_gradients(grads, axis_name, n_dev, mode="int8", key=None,
                     reduce="mean", chunk=DEFAULT_CHUNK):
    """Cross-rank gradient reduction with a compressed wire format.

    Call inside a ``shard_map`` (or ``MeshScope``) over ``axis_name``
    with ``grads`` the rank's local, full-size gradient leaves.  Returns
    the reduced leaves — the mean (``reduce="mean"``) or sum — in each
    leaf's dtype, identical on every rank.  ``key`` (a
    ``torch.Generator``, a stream of this rank's own) drives the
    stochastic rounding; ``key=None`` rounds to nearest."""
    if mode not in GRAD_REDUCE_MODES:
        raise ValueError(f"reduce_gradients: mode {mode!r} not in "
                         f"{GRAD_REDUCE_MODES}")
    if reduce not in ("mean", "sum"):
        raise ValueError(f"reduce_gradients: reduce {reduce!r} not in "
                         f"('mean', 'sum')")
    mean = reduce == "mean"
    grads = list(grads)
    if not grads:
        return []
    if mode == "int8":
        return _reduce_int8(grads, axis_name, n_dev, key, chunk, mean)
    out = [None] * len(grads)
    by_dtype = {}
    for i, g in enumerate(grads):
        if mode == "bf16":
            h = cast_bf16(g.float() / n_dev if mean else g, key)
        else:
            h = g
        by_dtype.setdefault(h.dtype, []).append((i, h))
    for items in by_dtype.values():
        reduced = _psum_flat([h for _, h in items], axis_name)
        for (i, _h), r in zip(items, reduced):
            g = grads[i]
            if mode == "f32" and mean:
                r = r / n_dev
            out[i] = r.to(g.dtype)
    return out
