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
  port of the Pallas kernel ``ops/pallas/paged_attention.py``): each
  slot's context is cut into splits of ``span`` positions (and its heads
  into chunks, where contexts are short), a block each (bulk async
  copies of a page's rows into a ring of stages, online softmax in f32);
  a block past its slot's length exits at once, and the partials of a
  slot with several splits are merged in split order.  The partition
  comes from static shapes only (``_partition``), so the wrapper never
  reads the lengths or tables on the host.  It runs for CUDA tensors.

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
import functools
from typing import NamedTuple

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
                         torch.full((), _NEG, dtype=scores.dtype,
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
    devs = {t.get_device() for t in (q, k_pages, v_pages, page_tables,
                                     lengths)}
    if len(devs) != 1:
        raise ValueError(f"paged_decode_attention: inputs on several "
                         f"devices {sorted(devs)}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_tables", page_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"contiguous")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"16-byte aligned (bulk copies, float4 loads)")


# The kernel's fixed sizes (ops/cuda/paged_attention.cu checks every
# partition it is given against its own copies of the first two).
_STAGE_BYTES = 32768    # K and V of one ring stage, at most
_ROW_FLOATS = 1024      # heads x head_dim a block takes per position
_MIN_STAGES = 8         # a split spans at least this many stages
_MIN_ROW_BYTES = 512    # a head chunk's row copy, at least


class Partition(NamedTuple):
    """How one call's work is cut, from static shapes only.

    ``heads_per_chunk`` heads' rows of a position are copied together
    (one contiguous span of the pool when it is all the heads);
    ``stage_positions`` positions fill one ring stage; a split is
    ``span`` positions of a slot's context and the longest context has
    ``n_split`` of them; the grid has ``blocks`` blocks, one per (slot,
    split, head chunk); ``ws_floats`` and ``counters`` size the workspace
    (partials and per-(slot, head chunk) arrival counters)."""
    heads_per_chunk: int
    head_chunks: int
    stage_positions: int
    span: int
    n_split: int
    blocks: int
    ws_floats: int
    counters: int


@functools.lru_cache(maxsize=256)
def _partition(slots, heads, head_dim, page_size, pages_per_seq, sms):
    """The split of one call over ``sms`` SMs.  A split spans about
    ``ctx / sms`` positions (at least ``_MIN_STAGES`` stages), so ONE slot
    at full length already covers every SM: a few long slots among idle
    ones spread over the card as well as many full ones do.  Where even
    full slots would give fewer blocks than SMs (short contexts), the
    heads are cut into chunks, halved while a row copy keeps
    ``_MIN_ROW_BYTES``: chunks write disjoint outputs, so they add blocks
    without merges.  Nothing here reads lengths or tables."""
    ctx = pages_per_seq * page_size

    def split(hc):
        tc = max(1, _STAGE_BYTES // (2 * hc * head_dim * 4))
        ctx_stages = -(-ctx // tc)
        span_stages = min(max(_MIN_STAGES, -(-ctx // (sms * tc))), ctx_stages)
        return tc, span_stages * tc, -(-ctx // (span_stages * tc))

    hc = min(heads, _ROW_FLOATS // head_dim)
    tc, span, n_split = split(hc)
    while (slots * -(-heads // hc) * n_split < sms
           and hc // 2 * head_dim * 4 >= _MIN_ROW_BYTES):
        hc //= 2
        tc, span, n_split = split(hc)
    n_hc = -(-heads // hc)
    ws = slots * n_split * heads * (head_dim + 2) if n_split > 1 else 0
    return Partition(hc, n_hc, tc, span, n_split, slots * n_hc * n_split,
                     ws, slots * n_hc)


class _Call(ctypes.Structure):
    """The entry point's constant arguments for one launch plan (one
    pointer instead of eleven ctypes conversions a call)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "slots", "heads", "head_dim", "n_pages", "page_size",
        "pages_per_seq", "heads_per_chunk", "stage_positions", "span",
        "n_split")] + [("scale", ctypes.c_float)]


_SMS = {}
_PLANS = {}
_MAX_PLANS = 64


def _sm_count(device):
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _plan(q, k_pages, v_pages, page_tables, lengths, device, stream):
    """The launch plan of one set of shapes on one (device, stream): its
    shapes checked, the partition's arguments and its own workspace —
    partials, and arrival counters zeroed once here, which the kernel
    leaves zero (launches on one stream never overlap).  A captured
    graph bakes the plan's pointers in, so the plan of the capturing
    stream must exist before the capture: making one during it raises.
    A graph's replays use the plan of the stream it was captured on, so
    they must not overlap other launches with that plan (the port's
    steps run one at a time).
    Returns ``(workspace pointer, counters pointer, _Call pointer)``."""
    key = (q.shape, k_pages.shape, v_pages.shape, page_tables.shape,
           lengths.shape, device, stream)
    plan = _PLANS.get(key)
    if plan is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_decode_attention: no launch plan for these shapes on "
                "the capturing stream; a plan allocates and zeroes its "
                "workspace, so it is made before a capture (run the step "
                "once on that stream first)")
        _check_cuda_args(q, k_pages, v_pages, page_tables, lengths)
        slots, heads, head_dim = q.shape
        n_pages, page_size = k_pages.shape[:2]
        pages_per_seq = page_tables.shape[1]
        part = _partition(slots, heads, head_dim, page_size, pages_per_seq,
                          _sm_count(device))
        ws = torch.empty(max(part.ws_floats, 4), dtype=torch.float32,
                         device=q.device)
        counters = torch.zeros(part.counters, dtype=torch.int32,
                               device=q.device)
        call = _Call(slots, heads, head_dim, n_pages, page_size,
                     pages_per_seq, part.heads_per_chunk,
                     part.stage_positions, part.span, part.n_split,
                     _scale(head_dim))
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        plan = _PLANS[key] = (ws.data_ptr(), counters.data_ptr(),
                              ctypes.addressof(call), (ws, counters, call))
    return plan


def _paged_decode_attention_cuda(q, k_pages, v_pages, page_tables,
                                 lengths):
    from .cuda import check, load

    qp, kp, vp = q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()
    dev = q.get_device()
    # the per-tensor checks in one expression; the full check raises
    # with the reason (the shapes' checks run once, with the plan)
    if (q.dtype is not torch.float32 or k_pages.dtype is not torch.float32
            or v_pages.dtype is not torch.float32
            or page_tables.dtype is not torch.int32
            or lengths.dtype is not torch.int32 or (qp | kp | vp) & 15
            or not (q.is_contiguous() and k_pages.is_contiguous()
                    and v_pages.is_contiguous()
                    and page_tables.is_contiguous()
                    and lengths.is_contiguous())
            or not (dev == k_pages.get_device() == v_pages.get_device()
                    == page_tables.get_device() == lengths.get_device())):
        _check_cuda_args(q, k_pages, v_pages, page_tables, lengths)
    fn = load("paged_attention").paged_decode_attention_f32
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws, counters, call, _ = _plan(q, k_pages, v_pages, page_tables, lengths,
                                  dev, stream)
    out = torch.empty_like(q)
    args = (qp, kp, vp, page_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), ws, counters, call, stream)
    if dev == torch.cuda.current_device():
        status = fn(*args)
    else:
        with torch.cuda.device(dev):
            status = fn(*args)
    check(status, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, page_tables, lengths):
    """Single-query attention over a paged KV cache (arguments as in
    ``paged_decode_attention_reference``).  CPU tensors run the plain
    version; CUDA tensors launch the hand-written kernel, which takes
    float32 q/pools, int32 tables/lengths, contiguous, and raises on
    anything else.  Returns ``[slots, heads, head_dim]`` in q's dtype."""
    ts = (q, k_pages, v_pages, page_tables, lengths)
    if all(t.is_cuda for t in ts):
        return _paged_decode_attention_cuda(*ts)
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return paged_decode_attention_reference(*ts)
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
