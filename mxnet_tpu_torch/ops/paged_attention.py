"""Paged decode attention — single-query attention over a paged KV cache.

The port of ``mxnet_tpu/ops/paged_attention.py``.  Every in-flight
sequence keeps its K/V in fixed-size pages of one shared pool
``[n_pages, page_size, heads, head_dim]`` per layer, addressed through a
per-slot page table; this op computes, for each decode slot, attention
of its one query token over its own ragged-length cached context.

Two bodies, chosen by where the tensors lie — never by a fallback:

- ``paged_decode_attention_reference``, the plain PyTorch version (the
  JAX package's jnp path): gather each slot's pages by table, mask past
  its length, softmax.  It runs for CPU tensors.
- the hand-written CUDA kernel ``ops/cuda/paged_attention.cu`` (the
  port of the Pallas kernel ``ops/pallas/paged_attention.py``): one
  thread block per (slot, head) streams only the slot's valid positions,
  online softmax in f32.  It runs for CUDA tensors.

``paged_decode_attention`` dispatches: all-CPU inputs take the plain
version, all-CUDA inputs launch the kernel (or raise on what it does not
take), a mix raises.  ``paged_decode_attention.launches`` counts kernel
launches.

One known difference: a slot of length 0 (an inactive slot) gets zeros
from the kernel, as from the Pallas kernel, and uniform weights over
its (masked) context from the plain version, as from the jnp path.
Both are finite and callers ignore such rows.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["paged_decode_attention", "paged_decode_attention_reference",
           "dense_decode_attention"]

_NEG = -1e30


def _scale(head_dim):
    """``1 / sqrt(head_dim)`` rounded to float32, as the JAX package
    computes it (``1.0 / jnp.sqrt(jnp.asarray(head_dim, q.dtype))``)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def _masked_softmax(scores, valid):
    """Softmax over the key axis with invalid keys masked by ``-1e30``
    (not ``-inf``): a slot with ZERO valid keys degrades to uniform
    weights, never NaN."""
    scores = torch.where(valid, scores,
                         torch.tensor(_NEG, dtype=scores.dtype,
                                      device=scores.device))
    return torch.softmax(scores, dim=-1)


def paged_decode_attention_reference(q, k_pages, v_pages, page_tables,
                                     lengths):
    """The plain PyTorch version (any device).

    Args:
      q:           ``[slots, heads, head_dim]``, one query per slot.
      k_pages:     ``[n_pages, page_size, heads, head_dim]`` pool.
      v_pages:     same shape as ``k_pages``.
      page_tables: ``[slots, pages_per_seq]`` int page ids (page 0 is the
                   allocator's write sink; unused entries are masked by
                   length).
      lengths:     ``[slots]`` valid KV tokens per slot, including the
                   just-written current token; 0 marks an inactive slot.

    Page ids are clamped into the pool before the gather: JAX clamps an
    out-of-range gather index where torch would raise, and the two must
    read the same rows.  Returns ``[slots, heads, head_dim]``."""
    n_pages, page_size, heads, head_dim = k_pages.shape
    slots, pages_per_seq = page_tables.shape
    ctx = pages_per_seq * page_size
    idx = page_tables.long().clamp(0, n_pages - 1)
    k_ctx = k_pages[idx].reshape(slots, ctx, heads, head_dim)
    v_ctx = v_pages[idx].reshape(slots, ctx, heads, head_dim)
    scale = _scale(head_dim)
    scores = torch.einsum("shd,schd->shc", q * scale, k_ctx)
    pos = torch.arange(ctx, device=q.device)
    valid = pos[None, None, :] < lengths.to(q.device)[:, None, None]
    w = _masked_softmax(scores, valid)
    return torch.einsum("shc,schd->shd", w, v_ctx)


def _check_cuda_args(q, k_pages, v_pages, page_tables, lengths):
    if q.dtype != torch.float32 or k_pages.dtype != torch.float32 \
            or v_pages.dtype != torch.float32:
        raise TypeError(f"paged_decode_attention kernel takes float32 q "
                        f"and pools, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if page_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"paged_decode_attention kernel takes int32 "
                        f"tables and lengths, got {page_tables.dtype}/"
                        f"{lengths.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or page_tables.dim() != 2 \
            or lengths.dim() != 1:
        raise ValueError("paged_decode_attention: expected q [S, H, D], "
                         "pools [n_pages, page_size, H, D], tables "
                         "[S, P], lengths [S]")
    slots, _, head_dim = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != q.shape[1:]:
        raise ValueError(f"paged_decode_attention: pool shapes "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if page_tables.shape[0] != slots or lengths.shape[0] != slots:
        raise ValueError("paged_decode_attention: tables/lengths rows "
                         "must match the slot count of q")
    lanes = head_dim // 4
    if head_dim % 4 or lanes < 1 or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"paged_decode_attention kernel: head_dim "
                         f"{head_dim} must be 4 x a power of two, <= 128")
    devs = {t.device for t in (q, k_pages, v_pages, page_tables, lengths)}
    if len(devs) != 1:
        raise ValueError(f"paged_decode_attention: inputs on several "
                         f"devices {sorted(map(str, devs))}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_tables", page_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"contiguous")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"16-byte aligned (float4 loads)")


def _paged_decode_attention_cuda(q, k_pages, v_pages, page_tables,
                                 lengths):
    from .cuda import check, load

    _check_cuda_args(q, k_pages, v_pages, page_tables, lengths)
    lib = load("paged_attention")
    slots, heads, head_dim = q.shape
    n_pages, page_size = k_pages.shape[:2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        status = lib.paged_decode_attention_f32(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            slots, heads, head_dim, n_pages, page_size,
            page_tables.shape[1],
            ctypes.c_float(_scale(head_dim)),
            stream)
    check(status, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, page_tables, lengths):
    """Single-query attention over a paged KV cache (arguments as in
    ``paged_decode_attention_reference``).  CPU tensors run the plain
    version; CUDA tensors launch the hand-written kernel, which takes
    float32 q/pools, int32 tables/lengths, contiguous, and raises on
    anything else.  Returns ``[slots, heads, head_dim]`` in q's dtype."""
    kinds = {t.device.type for t in (q, k_pages, v_pages, page_tables,
                                     lengths)}
    if kinds == {"cpu"}:
        return paged_decode_attention_reference(q, k_pages, v_pages,
                                                page_tables, lengths)
    if kinds == {"cuda"}:
        return _paged_decode_attention_cuda(q, k_pages, v_pages,
                                            page_tables, lengths)
    raise ValueError(f"paged_decode_attention: inputs must all lie on the "
                     f"CPU or all on one CUDA device, got {sorted(kinds)}")


paged_decode_attention.launches = 0


def dense_decode_attention(q, k_cache, v_cache, lengths):
    """The dense max-length-cache reference: every slot owns a
    ``[max_ctx, H, D]`` stripe of ``[slots, max_ctx, H, D]`` caches.
    Same masking and length semantics as the plain paged version."""
    ctx, head_dim = k_cache.shape[1], k_cache.shape[3]
    scale = _scale(head_dim)
    scores = torch.einsum("shd,schd->shc", q * scale, k_cache)
    pos = torch.arange(ctx, device=q.device)
    valid = pos[None, None, :] < lengths.to(q.device)[:, None, None]
    w = _masked_softmax(scores, valid)
    return torch.einsum("shc,schd->shd", w, v_cache)
