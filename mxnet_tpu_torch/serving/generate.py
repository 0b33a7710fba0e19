"""Continuous-batching LLM serving: paged KV cache + fixed-shape decode.

The port of ``mxnet_tpu/serving/generate.py`` (its single-device core).
An autoregressive LM batches at the token level: sequences join and
leave the in-flight batch at every decode step.

- **Paged KV cache** — one fixed pool ``[n_layers, n_pages, page_size,
  heads, head_dim]`` per K and V; sequences hold pages through a page
  table and a host-side refcounted free list (``PageAllocator``).  The
  pools are **updated in place**: where the JAX programs donate them and
  return new ones, the port's steps write into the tensors they are
  given and return the same objects.
- **One fixed-shape decode step** — every decode step, whatever the mix
  of sequence lengths and sampling modes, runs the same step over the
  fixed slot grid; slot mask, page table and lengths are arguments.
  Attention over the pages is the hand-written CUDA kernel on the card
  (``ops.paged_decode_attention``) and its plain version on the CPU.
- **Prefix sharing with copy-on-write** — a prompt's leading full
  blocks already resident in the prefix index map onto the resident
  pages (a refcount, no pool cost); a final partial block may map onto
  a resident full block whose leading tokens match, and the sequence's
  first write into a shared block takes a CoW fault: a fresh page, and
  the step's copy lanes (``cow_src``/``cow_dst``) copy the page on the
  device before the step writes.
- **Speculative decoding** — with a ``draft`` model the server runs
  ``build_verify_step`` instead of the decode step: the draft proposes
  ``spec_k`` tokens from a right-aligned token window, the target
  scores all ``spec_k + 1`` positions in one pass over ``S * (spec_k +
  1)`` lanes of the paged kernel, and a leading run is accepted (greedy:
  while the draft equals the target's argmax; sampling: the
  Leviathan/Chen rejection scheme), so the output is the target's
  distribution exactly.
- **Captured steps** — on the card the decode (or verify) step and each
  prefill bucket's step run as CUDA graphs (``graphs.GraphCache``), the
  port's counterpart of the JAX server's jitted programs: captured at
  ``start()`` (one prefill graph per (batch, length) bucket plus the
  decode graph, plus the handoff graph when disaggregated and the
  verify graph with a draft: ``census()``;
  ``graph_count()`` counts those held) over static device buffers.  A
  step call writes its slot arrays into one pinned host buffer, copies
  it to the device with one non-blocking copy, replays, and copies the
  tokens back into pinned memory: one sync a step.  ``capture=False``
  runs the same step bodies eagerly; on the CPU they always run
  eagerly.
- **Continuous-batching scheduler** (``GenerationServer``) — prompts
  prefill through ``BucketSpec`` length buckets (each warmed up before
  readiness), highest QoS class first; sequences are seated in fixed
  decode slots, retire per step on EOS/max-tokens/deadline (pages freed
  and queued sequences admitted the same step), and pool exhaustion
  preempts the youngest sequence back onto the queue with its tokens
  kept; it resumes by re-prefilling prompt + generated and continues the
  same stream.
- **Disaggregated prefill** — with ``prefill_workers >= 1`` prefill
  runs on a group of worker threads through pool-free steps
  (``build_prefill_kv_step``: the first token and the prompt's K/V,
  no pool argument) while the decode loop keeps stepping; a finished
  prefill hands its K/V payload and first token to the loop, which
  scatters any mix of payloads into the pools with one fixed-shape
  step (``build_handoff_step``) and seats the sequences.  A long
  prompt no longer stalls the in-flight decodes for its prefill, and a
  prefill-side failure cannot touch the pools.  Two stream roles on
  the card: each worker replays its prefill graphs on a CUDA stream of
  its own (``graphs.owned_stream``: no graph and no other worker uses
  it; the graph of a bucket is shared by the workers, one at a
  time: a lock per bucket from filling its inputs until its outputs
  are copied out, on the worker's stream, and the first tokens read
  back); the decode loop's stream is the only one that writes the
  pools (handoff, decode and verify graphs).  A payload is read by the
  loop's stream only after the worker's read-back synchronised it, and
  is marked used on that stream (``record_stream``) before it is
  freed.
- **Salvage, snapshots and the journal** — a failed step requeues its
  sequences with their tokens (``salvage_retries`` per sequence; past
  it the error carries the partial tokens and a ``SequenceSnapshot``);
  ``drain(handoff=True)`` exports every unfinished sequence as a
  snapshot, ``submit_resume`` completes one token-exact, and the decode
  journal (``journal=``, JSONL records the JAX server's key for key) is
  restored by ``restore_journal`` in either package.

Sampling is greedy (``temperature == 0``) or temperature/top-k.  The
noise for a token is a pure function of (sequence seed, absolute
position, vocabulary index) — never of slot or step — in Gumbel-max
form (``_sample_tokens``): a plain-PyTorch port of the JAX server's
draw, ``categorical(fold_in(PRNGKey(seed), position), logits)`` with
threefry-2x32 bits computed in int64 tensors, so seeded samples are the
JAX server's tokens and preemption, salvage and resume repeat them.

- **Tensor parallelism** (``tp_shards=N``, ``tp_collectives=``) —
  a gang of N ranks (one process and one card each; ``parallel.mesh``)
  serves one model: each rank holds its Megatron blocks of the params
  (``causal_lm.tp_shard_params``) and ``n_heads / N`` heads of the K/V
  pools, the paged kernel runs on those heads, and the two partial
  products of a layer are summed over the ``tp`` axis
  (``parallel.quantize.all_reduce_activations``, f32 or int8 on the
  decode and verify steps, f32 on prefill).  The port's design is a
  **leader and followers**: every rank builds the server with the same
  arguments; the rank at tp index 0 leads and runs the whole scheduler
  (admission, QoS, prefix sharing, salvage, journal) unchanged, and
  before each step it broadcasts a header over the tp group — which
  program runs (a prefill bucket, decode, verify, or stop) — and the
  step's one staged argument buffer.  The ``PageAllocator`` is
  layout-free (a page id addresses every rank's share of the page), so
  those host arrays are the same on every rank.  A follower's
  ``start()`` runs that loop and nothing else; ``submit()`` on it
  raises; the leader's ``drain()`` sends stop.  Over NCCL (one card a
  rank) each step is captured with its collectives inside, as on one
  card; over gloo (ranks sharing a card, or the CPU) the steps run
  eagerly (``graph_count()`` 0).  With ``prefill_workers``, the
  leader's workers announce each pool-free prefill over a second group
  of the same ranks (one prefill at a time over it, so the two groups'
  collectives never interleave), every follower runs it on a thread of
  its own and keeps its payload by id, and the leader's handoff header
  names the ids of its lanes.

Fault points ``generate.prefill`` / ``generate.decode`` /
``generate.evict`` / ``generate.resume`` / ``generate.salvage`` /
``generate.journal`` / ``fleet.handoff`` fire where the JAX server
fires them.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from .. import distributed as _dist
from .. import fault as _fault
from .. import profiler as _profiler
from .. import telemetry as _telemetry
from ..context import resolve_device
from ..graphs import GraphCache, owned_stream, release_stream
from ..gluon.model_zoo.causal_lm import (_local_heads, decode_hidden,
                                         lm_logits, prefill_forward,
                                         verify_logits, window_logits)
from ..ops.paged_attention import (dense_decode_attention,
                                   paged_decode_attention,
                                   paged_decode_attention_reference)
from .admission import (CircuitOpenError, DeadlineExceededError,
                        RejectedError, Request, ServerClosedError,
                        TenantQoS, TokenBucket)
from .batcher import BucketSpec
from .breaker import CircuitBreaker

__all__ = ["PageAllocator", "PoolExhaustedError", "GenerationServer",
           "SequenceSnapshot", "build_decode_step", "build_prefill_step",
           "build_prefill_kv_step", "build_handoff_step",
           "build_dense_decode_step", "build_verify_step", "decode_logits",
           "prefix_admission_plan"]


class PoolExhaustedError(RuntimeError):
    """The page pool has no free page.  Internal scheduler signal — the
    decode loop preempts a sequence and retries; it never reaches a
    client, who instead sees either admission-time ``RejectedError``
    (a request whose worst case could never fit) or a later result."""


class PageAllocator:
    """Host-side REFCOUNTED free list over the fixed page pool.

    Page 0 is reserved as the *write sink*: masked/inactive lanes of the
    prefill and decode steps scatter their K/V there, so the steps never
    branch on occupancy.  Pages ``1..n_pages-1`` are allocatable.  All
    methods are thread-safe (one lock, no blocking under it); the free
    list is LIFO, so a freed sequence's pages are immediately reused —
    any free page serves any sequence, so there is nothing contiguous to
    fragment.

    Every live page carries a refcount: ``alloc`` hands out pages at
    refcount 1, ``share`` maps additional holders onto live pages (the
    prefix-sharing mapping), and ``free`` decrements — a page returns to
    the free list only when its LAST holder lets go.  ``free`` on a page
    that is not live (double-free, or an id never allocated) raises
    ``ValueError`` instead of silently corrupting the free list."""

    def __init__(self, n_pages, page_size):
        if n_pages < 2:
            raise ValueError("PageAllocator: need >= 2 pages (page 0 is "
                             "the reserved write sink)")
        if page_size < 1:
            raise ValueError("PageAllocator: page_size must be >= 1")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        self._free = list(range(1, self.n_pages))   # LIFO tail = next out
        self._refs = {}                             # page -> live refcount

    @property
    def allocatable(self):
        """Pages a sequence can ever hold (pool minus the sink)."""
        return self.n_pages - 1

    def free_count(self):
        with self._lock:
            return len(self._free)

    def pages_for(self, n_tokens):
        """Pages needed to hold ``n_tokens`` cache entries."""
        return -(-int(n_tokens) // self.page_size)

    def alloc(self, n_pages):
        """Take ``n_pages`` pages or raise ``PoolExhaustedError`` (taking
        nothing — allocation is all-or-nothing so a half-admitted
        sequence can never strand pages).  Fresh pages start at
        refcount 1."""
        n = int(n_pages)
        if n <= 0:
            return []     # a fully shared prompt allocates nothing
        with self._lock:
            if n > len(self._free):
                raise PoolExhaustedError(
                    f"need {n} pages, {len(self._free)} free "
                    f"(pool {self.allocatable})")
            taken, self._free[-n:] = self._free[-n:], []
            for p in taken:
                self._refs[p] = 1
            return taken

    def share(self, pages):
        """Add one holder to each of ``pages`` (all must be live).
        Raises ``ValueError`` on a page that is not live (the prefix
        index may only hand out pages somebody still holds)."""
        with self._lock:
            for p in pages:
                if p not in self._refs:
                    raise ValueError(
                        f"PageAllocator.share: page {p} is not live — "
                        f"the prefix index handed out a freed page")
            for p in pages:
                self._refs[p] += 1
        return list(pages)

    def refcount(self, page):
        """Live holders of ``page`` (0 when free/unknown)."""
        with self._lock:
            return self._refs.get(int(page), 0)

    def shared_pages(self):
        """Pages currently held by MORE than one holder."""
        with self._lock:
            return sum(1 for c in self._refs.values() if c > 1)

    def extra_refs(self):
        """Total holders beyond the first, over all live pages — the
        page copies prefix sharing made unnecessary
        (``bytes_saved_by_sharing`` = this x page bytes)."""
        with self._lock:
            return sum(c - 1 for c in self._refs.values() if c > 1)

    def live_pages(self):
        """Count of live (allocated, refcount >= 1) pages."""
        with self._lock:
            return len(self._refs)

    def free(self, pages):
        """Drop one holder from each of ``pages``; a page whose LAST
        holder lets go returns to the LIFO free list.  Returns the pages
        actually released (the prefix index drops exactly those).  A
        page with no live refcount raises ``ValueError`` with nothing
        freed."""
        with self._lock:
            drops = {}
            for p in pages:
                drops[p] = drops.get(p, 0) + 1
            for p, n in drops.items():
                if self._refs.get(p, 0) < n:
                    raise ValueError(
                        f"PageAllocator.free: page {p} is not live "
                        f"(double free, or never allocated) — refusing "
                        f"to corrupt the free list")
            released = []
            for p in pages:
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    del self._refs[p]
                    self._free.append(p)
                    released.append(p)
            return released


# --------------------------------------------------------------- samplers --
_M32 = 0xFFFFFFFF
_NEG = -1e30


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA
_F32_TINY = float(np.finfo(np.float32).tiny)


def _threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds, Salmon et al. 2011) as
    JAX computes it (``jax._src.prng._threefry2x32_lowering``): key
    ``(k0, k1)``, counter ``(x0, x1)`` -> two words.  Operands are int64
    tensors (or ints) holding uint32 values; every sum is masked back to
    32 bits, so the arithmetic is exact on any device."""
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _position_keys(seeds, positions, domain=None):
    """Row ``i``'s key ``fold_in(PRNGKey(seeds[i]), positions[i])`` as
    the JAX server derives it, as two int64 tensors of uint32 words.
    ``PRNGKey`` of a 32-bit seed is the word pair ``(0, seed)``;
    ``fold_in(key, p)`` hashes the counter ``(0, p)`` under ``key``.
    ``domain`` folds in once more (``fold_in(key, domain)``): the
    disjoint streams of the speculative roles at one position — draft
    proposal (1), acceptance uniform (2), correction draw (3)."""
    seeds = seeds.to(torch.int64) & _M32
    positions = positions.to(torch.int64) & _M32
    k0, k1 = _threefry2x32(torch.zeros_like(seeds), seeds,
                           torch.zeros_like(positions), positions)
    if domain is None:
        return k0, k1
    return _threefry2x32(k0, k1, 0, int(domain) & _M32)


def _random_bits(keys, vocab):
    """``jax.random.bits(key, (vocab,))`` per row, uint32 values in int64
    ``[rows, vocab]``: with ``jax_threefry_partitionable`` (JAX's default)
    element ``j`` hashes the counter ``(0, j)`` and xors the two words.
    ``bits(key, ())`` is ``bits(key, (1,))[0]``."""
    k0, k1 = keys
    idx = torch.arange(vocab, dtype=torch.int64, device=k0.device)
    y0, y1 = _threefry2x32(k0[:, None], k1[:, None],
                           torch.zeros_like(idx)[None, :], idx[None, :])
    return y0 ^ y1


def _unit_floats(bits):
    """The top 23 bits of uint32 ``bits`` as the mantissa of a float in
    ``[1, 2)``, minus one: ``jax.random.uniform``'s float transform,
    in ``[0, 1)``."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def _uniform(bits):
    """``jax.random.uniform(minval=tiny, maxval=1)`` in float32 from
    uint32 bits: ``_unit_floats`` scaled by ``1 - tiny`` (exactly 1.0 in
    float32, so left out), plus ``tiny``, and floored at ``tiny``."""
    return torch.clamp_min(_unit_floats(bits) + _F32_TINY, _F32_TINY)


def _scalar_uniform(keys):
    """``jax.random.uniform(key, ())`` per row (``minval`` 0, ``maxval``
    1): one word of bits through ``_unit_floats``, in ``[0, 1)``."""
    return _unit_floats(_random_bits(keys, 1)[:, 0])


def _gumbel(keys, vocab):
    """Gumbel(0, 1) noise ``[rows, vocab]`` equal to what
    ``jax.random.categorical(key, ...)`` adds to row ``i``'s logits:
    ``gumbel(key, (vocab,))`` in its default "low" mode,
    ``-log(-log(u))``.  The bits are JAX's bit for bit; the two ``log``s
    are the device's, which may differ from XLA's in the last place."""
    return -torch.log(-torch.log(_uniform(_random_bits(keys, vocab))))


def _gumbel_noise(seeds, positions, vocab):
    """The noise of ``_gumbel`` under the position keys of row ``i``:
    ``fold_in(PRNGKey(seeds[i]), positions[i])``."""
    return _gumbel(_position_keys(seeds, positions), vocab)


def _categorical(keys, logits):
    """``jax.random.categorical(key, logits)`` per row: Gumbel-max with
    ``_gumbel``'s noise; ``argmax`` takes the first maximum, as
    ``jnp.argmax`` does."""
    return (logits + _gumbel(keys, logits.shape[-1])).argmax(dim=-1)


def _scaled_masked(logits, temps, topks):
    """Temperature-scaled, top-k-masked logits: ``softmax`` of this is
    each row's sampling distribution (``topks == 0``: no cut).  The
    speculative verify step evaluates it twice (the draft's ``q`` and
    the target's ``p``) for an exact acceptance ratio."""
    vocab = logits.shape[-1]
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    order = scaled.sort(dim=-1, descending=True).values
    kidx = (topks.to(torch.int64) - 1).clamp(0, vocab - 1)
    thr = order.gather(1, kidx[:, None])
    cut = (topks[:, None] > 0) & (scaled < thr)
    return torch.where(cut, torch.full((), _NEG, dtype=scaled.dtype,
                                       device=scaled.device), scaled)


def _sample_tokens(logits, seeds, positions, temps, topks):
    """Per-slot next token: greedy where ``temps == 0``, else a draw
    from ``softmax(_scaled_masked(...))`` by Gumbel-max with the
    position-keyed noise of ``_gumbel_noise``, as
    ``jax.random.categorical`` draws.  Both arms always compute, as in
    the JAX program, so every mix of greedy and sampling rows is one
    fixed-shape step with no host sync (a captured graph holds it); the
    greedy rows take the ``argmax`` whatever the noise."""
    greedy = logits.argmax(dim=-1)
    masked = _scaled_masked(logits, temps, topks)
    drawn = _categorical(_position_keys(seeds, positions), masked)
    return torch.where(temps > 0.0, drawn, greedy).to(torch.int32)


def _flushed_log(p):
    """``log(max(p, 1e-38))`` as XLA on the CPU computes it: it flushes
    denormals to zero, so 1e-38 (a float32 denormal) and every denormal
    ``p`` read as 0 and give ``-inf``.  The port takes that value on
    every device: an entry below float32's smallest normal gets ``-inf``
    (where an unflushed ``log`` gives about -87.5), so the Gumbel-max
    over the log draws among the same finite entries as the JAX
    step."""
    return torch.where(p >= _F32_TINY, torch.log(p.clamp_min(_F32_TINY)),
                       torch.full((), float("-inf"), dtype=p.dtype,
                                  device=p.device))


def _repeat(x, n):
    """``jnp.repeat(x, n, axis=0)`` as a contiguous tensor, by expand and
    reshape (no host sync, unlike a repeat count the runtime checks)."""
    return x[:, None].expand(x.shape[0], n, *x.shape[1:]).reshape(
        x.shape[0] * n, *x.shape[1:])


# ------------------------------------------------------------------ steps --
def decode_logits(params, config, page_size, k_pool, v_pool, tokens,
                  lengths, active, tables, attention=None, reduce=None):
    """The decode forward of one token per slot: write each active
    slot's K/V at position ``lengths[s]`` (page
    ``tables[s, lengths[s] // page_size]``; inactive slots write to sink
    page 0) **in place** into the pools, attend over ``lengths[s] + 1``
    positions, and return the next-token logits ``[S, vocab]``.
    Writes that share a (page, offset) — inactive slots — land only on
    sink page 0, so their order (undefined for a torch index write, as
    for a JAX scatter) never matters; a block index past the table is
    clamped, as a JAX gather clamps it.  ``attention`` defaults to
    ``ops.paged_decode_attention`` (the kernel on the card); any
    function with its signature may stand in, e.g. its plain version to
    hold the kernel against it.  Under tensor parallelism (``reduce``,
    the sum over the tp axis) the params are this rank's blocks and the
    pools hold this rank's heads (their count comes from ``wqkv``)."""
    attention = paged_decode_attention if attention is None else attention
    slots = tokens.shape[0]
    head_dim = config.head_dim
    heads = _local_heads(params, config)
    pages_per_seq = tables.shape[1]
    h = params["embed"][tokens.long()]                  # [S, d]
    pos = lengths.long()
    # JAX clamps an out-of-range gather index where torch raises
    blk = (pos // page_size).clamp(0, pages_per_seq - 1)
    page = tables.long().gather(1, blk[:, None])[:, 0]
    page = torch.where(active, page, 0)                 # sink inactive
    off = pos % page_size
    att_len = torch.where(active, lengths + 1, 0).to(torch.int32)
    for layer in range(config.n_layers):
        def attend(q, k, v, _l=layer):
            # duplicate (page, off) pairs only ever hit sink page 0
            k_pool[_l, page, off] = k.reshape(slots, heads, head_dim)
            v_pool[_l, page, off] = v.reshape(slots, heads, head_dim)
            return attention(q.reshape(slots, heads, head_dim).contiguous(),
                             k_pool[_l], v_pool[_l], tables, att_len)
        h = decode_hidden(params, layer, h, attend, reduce=reduce)
    return lm_logits(params, h)


def _cow_copy(k_pool, v_pool, cow_src, cow_dst):
    """The copy-on-write lanes: page ``cow_src[s]`` onto ``cow_dst[s]``
    in both pools, gathered first so a lane reads the pre-step page.
    Slots without a fault pass ``(0, 0)``, a self-copy of the sink."""
    k_pool[:, cow_dst.long()] = k_pool[:, cow_src.long()]
    v_pool[:, cow_dst.long()] = v_pool[:, cow_src.long()]


def _second_group(mesh, axis):
    """A second process group over this rank's ranks of ``axis`` (every
    rank of the world makes every such group, in the same order)."""
    from torch import distributed as dist

    if mesh.shape[axis] == _dist.num_workers():
        return dist.new_group(list(range(_dist.num_workers())))
    names = list(mesh.axis_names)
    rows = np.moveaxis(mesh.devices, names.index(axis), -1).reshape(
        -1, mesh.shape[axis])
    mine = None
    for row in rows:
        g = dist.new_group([int(r) for r in row])
        if _dist.rank() in row:
            mine = g
    return mine


def _tp_pieces(config, mesh, axis):
    """Shared tensor-parallel plumbing of the step builders: the shard
    count (the mesh's ``axis``, validated against the architecture) and
    the local head count."""
    from ..gluon.model_zoo.causal_lm import tp_validate

    shards = int(mesh.shape[axis])
    tp_validate(config, shards)
    return shards, config.n_heads // shards


def _tp_reduce(mesh, axis, mode="f32"):
    """The ``reduce`` hook of a step over ``mesh`` (None without one):
    the sum over ``axis`` through ``parallel.quantize.
    all_reduce_activations`` in the ``mode`` wire format — ``"int8"``
    gives every rank the same bits (the owned slices are quantized once
    and all-gathered)."""
    if mesh is None:
        return None
    from ..parallel.quantize import all_reduce_activations

    shards = int(mesh.shape[axis])

    def reduce(x):
        return all_reduce_activations(x, axis, shards, mode=mode)
    return reduce


def _check_collectives(mode, where=""):
    """The JAX package's ``tp_collectives`` check and text (``where``:
    the server's ``"<name>: "`` prefix)."""
    from ..parallel.quantize import ACTIVATION_REDUCE_MODES

    if mode not in ACTIVATION_REDUCE_MODES:
        raise ValueError(f"{where}tp_collectives={mode!r} not in "
                         f"{ACTIVATION_REDUCE_MODES}")


def _on_mesh(step, mesh):
    """``step`` run inside ``MeshScope(mesh)`` (its collectives are named
    by axis over that mesh); ``step`` itself without a mesh."""
    if mesh is None:
        return step
    from ..parallel.mesh import MeshScope

    def run(*args):
        with MeshScope(mesh):
            return step(*args)
    return run


def build_decode_step(config, page_size, attention=None, mesh=None,
                      tp_axis="tp", tp_collectives="f32"):
    """The decode step every in-flight mix of sequences runs over the
    fixed slot grid.

    Signature (tensors on one device; shapes configuration constants):
      ``(params, k_pool, v_pool, tokens[S], lengths[S], active[S],
      tables[S, P], cow_src[S], cow_dst[S], seeds[S], temps[S],
      topks[S])`` → ``(next_tokens[S] int32, k_pool, v_pool)``.

    ``lengths[s]`` is the slot's cache occupancy BEFORE this step; the
    input token's K/V is written at position ``lengths[s]``, inactive
    slots sink to page 0, and attention covers ``lengths[s] + 1``
    positions.  The pools are updated in place and returned.  The next
    token (absolute position ``lengths[s] + 1``) is drawn with slot
    ``s``'s seed at that position.  ``cow_src``/``cow_dst`` are the
    copy-on-write lanes (``_cow_copy``), applied before anything else:
    the host has already remapped ``tables`` onto the fresh page.
    ``attention`` as in ``decode_logits``.

    With ``mesh`` (a mesh with a ``tp_axis``), run on every rank of the
    axis: ``params`` are the rank's blocks (``causal_lm.
    tp_shard_params``), the pools hold its ``n_heads / shards`` heads
    (``[n_layers, n_pages, page_size, heads_l, head_dim]``), the paged
    attention runs on those heads, and the two partial-product sums of
    a layer go through ``parallel.quantize.all_reduce_activations`` over
    the axis in the ``tp_collectives`` wire format (``"f32"`` |
    ``"int8"``).  The slot arguments and the sampled tokens are the same
    on every rank."""
    _check_collectives(tp_collectives)
    reduce = None
    if mesh is not None:
        _tp_pieces(config, mesh, tp_axis)
        reduce = _tp_reduce(mesh, tp_axis, tp_collectives)

    def decode_step(params, k_pool, v_pool, tokens, lengths, active,
                    tables, cow_src, cow_dst, seeds, temps, topks):
        _cow_copy(k_pool, v_pool, cow_src, cow_dst)
        logits = decode_logits(params, config, page_size, k_pool, v_pool,
                               tokens, lengths, active, tables,
                               attention=attention, reduce=reduce)
        nxt = _sample_tokens(logits, seeds, lengths + 1, temps, topks)
        return nxt, k_pool, v_pool

    return _on_mesh(decode_step, mesh)


def build_prefill_step(config, page_size, mesh=None, tp_axis="tp"):
    """One prefill step for any ``(batch, length)`` bucket: the whole
    prompt forward (``causal_lm.prefill_forward``), K/V scattered **in
    place** into the paged pools by page table, and the FIRST new token
    sampled (absolute position ``lengths[i]``).  Padded rows/positions
    sink their writes to page 0 (the only place duplicate writes land);
    a block index past the table is clamped, as a JAX gather clamps
    it.  The server passes a table row whose shared blocks are zeroed
    (``_scatter_table_row``), so a resident shared page is never
    rewritten.

    Signature: ``(params, k_pool, v_pool, tokens[b, L], lengths[b],
    active[b], tables[b, P], seeds[b], temps[b], topks[b])`` →
    ``(first[b] int32, k_pool, v_pool)``.

    With ``mesh`` the forward is Megatron-sharded as in the decode step
    and each rank scatters its own heads' K/V into its pools; prefill's
    sums stay f32 (the prompt forward is compute-bound, the
    ``tp_collectives`` trade is the decode path's)."""
    reduce = None
    if mesh is not None:
        _tp_pieces(config, mesh, tp_axis)
        reduce = _tp_reduce(mesh, tp_axis)

    def prefill_step(params, k_pool, v_pool, tokens, lengths, active,
                     tables, seeds, temps, topks):
        logits, k_all, v_all = prefill_forward(params, config, tokens,
                                               lengths, reduce=reduce)
        _scatter_prompt_kv(k_pool, v_pool, k_all, v_all, lengths, active,
                           tables, page_size)
        first = _sample_tokens(logits, seeds, lengths, temps, topks)
        return first, k_pool, v_pool

    return _on_mesh(prefill_step, mesh)


def _scatter_prompt_kv(k_pool, v_pool, k_all, v_all, lengths, active,
                       tables, page_size):
    """Write prompt K/V ``[n_layers, b, L, H, D]`` into the pools by page
    table, in place: row ``i``'s position ``p`` goes to page
    ``tables[i, p // page_size]``; inactive rows and positions past
    ``lengths`` sink to page 0 (the only place duplicate writes land); a
    block index past the table is clamped, as a JAX gather clamps it."""
    b, L = k_all.shape[1], k_all.shape[2]
    pos = torch.arange(L, device=k_all.device)
    valid = (pos[None, :] < lengths[:, None]) & active[:, None]
    blk = (pos // page_size).clamp(0, tables.shape[1] - 1)
    page = torch.where(valid, tables.long()[:, blk], 0)         # [b, L]
    off = (pos % page_size)[None, :].expand(b, L)
    for layer in range(k_all.shape[0]):
        k_pool[layer, page, off] = k_all[layer]
        v_pool[layer, page, off] = v_all[layer]


def build_prefill_kv_step(config, mesh=None, tp_axis="tp"):
    """The disaggregated prefill step (one per ``(batch, length)``
    bucket): the whole-prompt forward returning the first sampled token
    and the prompt's K/V, with NO pool argument, so a prefill worker can
    run it beside the decode loop's step and a failed prefill cannot
    touch the pools.  Attention is dense-causal, as in the fused prefill
    step.  The K/V is the payload ``build_handoff_step`` scatters.

    Signature: ``(params, tokens[b, L], lengths[b], seeds[b], temps[b],
    topks[b])`` → ``(first[b] int32, k_all, v_all)``, K/V stacked
    ``[n_layers, b, L, heads, head_dim]`` float32 and zero past
    ``lengths``.  With ``mesh`` the forward is Megatron-sharded (f32
    sums, as ``build_prefill_step``) and the K/V is this rank's heads."""
    reduce = None
    if mesh is not None:
        _tp_pieces(config, mesh, tp_axis)
        reduce = _tp_reduce(mesh, tp_axis)

    def prefill_kv_step(params, tokens, lengths, seeds, temps, topks):
        logits, k_all, v_all = prefill_forward(params, config, tokens,
                                               lengths, reduce=reduce)
        first = _sample_tokens(logits, seeds, lengths, temps, topks)
        L = tokens.shape[1]
        valid = (torch.arange(L, device=tokens.device)[None, :]
                 < lengths[:, None])[None, :, :, None, None]
        zero = torch.zeros((), dtype=k_all.dtype, device=k_all.device)
        return first, torch.where(valid, k_all, zero), \
            torch.where(valid, v_all, zero)

    return _on_mesh(prefill_kv_step, mesh)


def build_handoff_step(config, page_size, mesh=None, tp_axis="tp"):
    """The one handoff step of a disaggregated server: scatter a batch of
    prefilled sequences' K/V (``[n_layers, B, L, H, D]``, a FIXED
    ``(B, L)`` staging shape) into the pools by page table, in place.
    Inactive lanes and positions past ``lengths`` sink to page 0.  The
    shapes are configuration constants, so however sequences are
    re-packed across handoffs it is one step (one graph on the card).

    Signature: ``(k_pool, v_pool, k_all, v_all, lengths[B], active[B],
    tables[B, P])`` → ``(k_pool, v_pool)``.  With ``mesh`` each rank
    scatters its own heads' payload into its own pools (no collective:
    the shapes come from the payload)."""
    if mesh is not None:
        _tp_pieces(config, mesh, tp_axis)

    def handoff_step(k_pool, v_pool, k_all, v_all, lengths, active,
                     tables):
        _scatter_prompt_kv(k_pool, v_pool, k_all, v_all, lengths, active,
                           tables, page_size)
        return k_pool, v_pool

    return handoff_step


def build_dense_decode_step(config, max_ctx):
    """The dense max-length-cache decode variant, a test reference:
    identical model and sampling, but every slot owns a
    ``[max_ctx, H, D]`` stripe of ``[n_layers, slots, max_ctx, H, D]``
    caches (updated in place).  Signature ``(params, k_cache, v_cache,
    tokens, lengths, active, seeds, temps, topks)`` →
    ``(next_tokens, k_cache, v_cache)``."""
    heads, head_dim = config.n_heads, config.head_dim

    def dense_step(params, k_cache, v_cache, tokens, lengths, active,
                   seeds, temps, topks):
        slots = tokens.shape[0]
        h = params["embed"][tokens.long()]
        row = torch.arange(slots, device=tokens.device)
        pos = lengths.long().clamp(0, max_ctx - 1)
        att_len = torch.where(active, lengths + 1, 0)
        for layer in range(config.n_layers):
            def attend(q, k, v, _l=layer):
                k_cache[_l, row, pos] = k.reshape(slots, heads, head_dim)
                v_cache[_l, row, pos] = v.reshape(slots, heads, head_dim)
                return dense_decode_attention(
                    q.reshape(slots, heads, head_dim), k_cache[_l],
                    v_cache[_l], att_len)
            h = decode_hidden(params, layer, h, attend)
        nxt = _sample_tokens(lm_logits(params, h), seeds, lengths + 1,
                             temps, topks)
        return nxt, k_cache, v_cache

    return dense_step


def build_verify_step(config, draft_cfg, page_size, spec_k, window,
                      attention=None, mesh=None, tp_axis="tp",
                      tp_collectives="f32"):
    """The speculative-decoding step: a small draft LM proposes
    ``spec_k`` tokens and the target scores all ``spec_k + 1``
    positions in the same fixed-shape step, so a captured server holds
    one more graph whatever the traffic.

    Signature (tensors on one device; shapes configuration constants):
      ``(params, draft_params, k_pool, v_pool, tokens[S],
      window[S, W], n_valid[S], lengths[S], active[S], tables[S, P],
      cow_src[S], cow_dst[S], seeds[S], temps[S], topks[S])`` →
      ``(emitted[S, spec_k + 1] int32, n_accept[S] int32, k_pool,
      v_pool)``; the pools are updated in place.

    Per slot: (1) the copy-on-write lanes, as in ``build_decode_step``;
    (2) the draft runs ``spec_k`` times over a right-aligned token window
    (``window``/``n_valid``, no pool), proposal ``d_i`` drawn from the
    same tempered/top-k family as the target, keyed at position
    ``lengths + 1 + i`` in domain 1; (3) one target forward over
    ``S * (spec_k + 1)`` flattened lanes — lane ``(s, i)`` writes its
    K/V at ``lengths[s] + i`` (all lanes write before any attends) and
    attends over ``lengths[s] + i + 1`` positions through
    ``ops.paged_decode_attention``, its slot's page table repeated per
    lane; (4) a leading run of proposals is accepted: greedy rows while
    ``d_i`` is the target's argmax, sampling rows while ``u_i <=
    p_i(d_i) / q_i(d_i)`` (``u_i`` keyed in domain 2); then the
    correction at the first rejection (from ``normalize(max(p - q,
    0))``) or the bonus token (from ``p_k``), keyed in domain 3.  Both
    arms always compute and nothing reads a device value on the host,
    so the step is one captured graph.

    ``emitted[s, :n_accept[s] + 1]`` are the step's tokens (the last is
    the correction or bonus, the next pending token); later entries are
    dead lanes.  K/V written past the accepted run is stale but masked
    (``lengths`` advances over accepted tokens only).

    With ``mesh`` the target runs Megatron-sharded on the rank's heads
    as in ``build_decode_step`` (``tp_collectives`` on its sums); the
    draft stays whole on every rank, so every rank proposes, accepts
    and emits the same tokens."""
    _check_collectives(tp_collectives)
    if int(spec_k) < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    if draft_cfg.vocab_size != config.vocab_size:
        raise ValueError(
            f"draft vocab {draft_cfg.vocab_size} != target vocab "
            f"{config.vocab_size} — speculative acceptance compares "
            f"distributions over the SAME token space")
    attention = paged_decode_attention if attention is None else attention
    k = int(spec_k)
    K1 = k + 1
    heads, head_dim = config.n_heads, config.head_dim
    reduce = None
    if mesh is not None:
        heads = _tp_pieces(config, mesh, tp_axis)[1]
        reduce = _tp_reduce(mesh, tp_axis, tp_collectives)

    def verify_step(params, draft_params, k_pool, v_pool, tokens, window,
                    n_valid, lengths, active, tables, cow_src, cow_dst,
                    seeds, temps, topks):
        S = tokens.shape[0]
        W = window.shape[1]
        dev = tokens.device
        _cow_copy(k_pool, v_pool, cow_src, cow_dst)

        # (2) draft proposals, q_i the proposal distribution
        drafts, qprobs = [], []
        win, nv = window, n_valid
        for i in range(k):
            lg = window_logits(draft_params, draft_cfg, win, nv)
            masked = _scaled_masked(lg, temps, topks)
            qprobs.append(torch.softmax(masked, dim=-1))
            drawn = _categorical(
                _position_keys(seeds, lengths + 1 + i, domain=1), masked)
            d_i = torch.where(temps > 0.0, drawn,
                              lg.argmax(dim=-1)).to(torch.int32)
            drafts.append(d_i)
            win = torch.cat([win[:, 1:], d_i[:, None]], dim=1)
            nv = torch.clamp(nv + 1, max=W)

        # (3) one target forward over S * K1 lanes
        T = torch.stack([tokens.to(torch.int32)] + drafts, dim=1)
        lanes = S * K1
        steps = torch.arange(K1, device=dev)
        pos_l = (lengths.long()[:, None] + steps[None, :]).reshape(lanes)
        tables_l = _repeat(tables, K1)                    # [lanes, P]
        active_l = _repeat(active, K1)
        blk = (pos_l // page_size).clamp(0, tables.shape[1] - 1)
        page_l = tables_l.long().gather(1, blk[:, None])[:, 0]
        page_l = torch.where(active_l, page_l, 0)          # sink inactive
        off_l = pos_l % page_size
        att_len = torch.where(active_l, pos_l + 1, 0).to(torch.int32)

        def attend(layer, q, kk, vv):
            # every lane writes before any attends; duplicate (page,
            # off) pairs only ever hit sink page 0
            k_pool[layer, page_l, off_l] = kk.reshape(lanes, heads, head_dim)
            v_pool[layer, page_l, off_l] = vv.reshape(lanes, heads, head_dim)
            return attention(q.reshape(lanes, heads, head_dim).contiguous(),
                             k_pool[layer], v_pool[layer], tables_l, att_len)
        logits = verify_logits(params, config, T, attend,
                               reduce=reduce)              # [S, K1, V]

        # (4) leading-run acceptance, both arms always computed
        vocab = logits.shape[-1]
        d_all = torch.stack(drafts, dim=1).long()          # [S, k]
        q_all = torch.stack(qprobs, dim=1)                 # [S, k, V]
        masked_all = _scaled_masked(
            logits.reshape(lanes, vocab), _repeat(temps, K1),
            _repeat(topks, K1)).reshape(S, K1, vocab)
        p_all = torch.softmax(masked_all, dim=-1)
        tgt_greedy = logits.argmax(dim=-1).to(torch.int32)  # [S, K1]
        a_greedy = torch.cumprod(
            (d_all == tgt_greedy[:, :k]).to(torch.int32), dim=1).sum(dim=1)
        p_d = p_all[:, :k].gather(2, d_all[:, :, None])[..., 0]
        q_d = q_all.gather(2, d_all[:, :, None])[..., 0]
        prop_pos = (lengths.long()[:, None] + 1
                    + steps[None, :k]).reshape(S * k)
        u = _scalar_uniform(_position_keys(_repeat(seeds, k), prop_pos,
                                           domain=2)).reshape(S, k)
        a_sample = torch.cumprod(
            (u <= p_d / q_d.clamp_min(1e-30)).to(torch.int32),
            dim=1).sum(dim=1)
        a = torch.where(temps > 0.0, a_sample, a_greedy).to(torch.int32)

        # the correction at the first rejection (the residual p - q,
        # renormalised; a zero residual means p == q there: p), the
        # bonus from p_k when every proposal was accepted
        resid = (p_all[:, :k] - q_all).clamp_min(0.0)
        rsum = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(rsum > 0.0, resid / rsum.clamp_min(1e-30),
                            p_all[:, :k])
        corr_dist = torch.cat([resid, p_all[:, k:]], dim=1)
        corr_pos = (lengths.long()[:, None] + 1
                    + steps[None, :]).reshape(lanes)
        corr_drawn = _categorical(
            _position_keys(_repeat(seeds, K1), corr_pos, domain=3),
            _flushed_log(corr_dist.reshape(lanes, vocab))).reshape(S, K1)
        corr = torch.where(temps[:, None] > 0.0, corr_drawn.to(torch.int32),
                           tgt_greedy)
        d_ext = torch.cat([d_all.to(torch.int32),
                           torch.zeros((S, 1), dtype=torch.int32,
                                       device=dev)], dim=1)
        emitted = torch.where(steps[None, :] < a[:, None], d_ext, corr)
        return emitted.to(torch.int32), a, k_pool, v_pool

    return _on_mesh(verify_step, mesh)


def _decode_attention(impl, device, name):
    """The decode and verify steps' paged attention for the JAX server's
    ``attention_impl``: None → ``ops.paged_decode_attention`` (the
    hand-written kernel on the card, its plain version on the CPU);
    ``"pallas"`` → the same, and only on the card; ``"jnp"`` → the plain
    version on any device.  Returns the ``attention`` argument of
    ``build_decode_step`` (None for the default)."""
    if impl not in (None, "jnp", "pallas"):
        raise ValueError(f"{name}: attention_impl={impl!r} (expected None, "
                         f"'jnp', or 'pallas')")
    if impl == "jnp":
        return paged_decode_attention_reference
    if impl == "pallas" and device.type != "cuda":
        raise ValueError(f"{name}: attention_impl='pallas' is the "
                         f"hand-written kernel, which needs the card, not "
                         f"{device}")
    return None


def prefix_admission_plan(n_pages, page_size, prompt_len, max_new,
                          shared_prefix_len):
    """Worst-case-fit admission arithmetic under prefix sharing (the
    JAX package's function).  A sequence's worst case is
    ``pages_for(prompt_len + max_new)`` pages; with a resident shared
    prefix of ``shared_prefix_len`` tokens its leading FULL blocks map
    onto resident pages at no cost, so admission charges only
    ``charged_pages`` — the first holder still pays in full.  Returns
    the per-sequence page counts and the admissible concurrent
    sequences with and without sharing at this pool size."""
    ps = int(page_size)
    pool = int(n_pages) - 1                   # page 0 is the write sink
    total = -(-(int(prompt_len) + int(max_new)) // ps)
    shared = min(int(shared_prefix_len) // ps,
                 int(prompt_len) // ps)
    charged = total - shared
    unshared = pool // total if total else 0
    if pool < total:
        with_sharing = 0
    elif charged == 0:
        with_sharing = pool                   # every follower is free
    else:
        with_sharing = 1 + (pool - total) // charged
    return {"pages_per_seq": total, "shared_pages": shared,
            "charged_pages": charged, "admissible_unshared": unshared,
            "admissible_shared": with_sharing,
            "multiplier": with_sharing / max(unshared, 1)}


class SequenceSnapshot:
    """Resumable state of one in-flight generation, JSON-serializable
    (the decode journal's record shape, the JAX package's key for key).

    Because sampling is position-keyed, this is all the state resume
    needs: re-prefilling ``prompt + out`` reconstructs the KV cache and
    every later draw is the uninterrupted run's.  ``deadline_wall`` is
    the absolute wall-clock expiry (``time.time()`` base), turned back
    into seconds from now at ``submit_resume``."""

    __slots__ = ("rid", "prompt", "out", "max_new", "temperature",
                 "top_k", "seed", "priority", "deadline_wall", "tenant",
                 "klass")

    def __init__(self, rid, prompt, out, max_new, temperature, top_k,
                 seed, priority=0, deadline_wall=None, tenant=None,
                 klass=None):
        self.rid = int(rid)
        self.prompt = [int(t) for t in prompt]
        self.out = [int(t) for t in out]
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.priority = int(priority)
        self.deadline_wall = None if deadline_wall is None \
            else float(deadline_wall)
        self.tenant = tenant
        self.klass = klass

    def to_json(self):
        return {name: getattr(self, name) for name in self.__slots__}

    @classmethod
    def from_json(cls, d):
        return cls(**{name: d[name] for name in cls.__slots__
                      if name in d})

    def __repr__(self):
        return (f"SequenceSnapshot(rid={self.rid}, "
                f"prompt_len={len(self.prompt)}, "
                f"generated={len(self.out)}/{self.max_new}, "
                f"seed={self.seed})")


# the programs a tensor-parallel leader announces to its followers
_STOP, _PREFILL, _DECODE, _VERIFY, _PREFILL_KV, _HANDOFF, _DROP = range(7)

# ---------------------------------------------------------------- staging --
_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.bool_): torch.bool}


class _Staged:
    """A step's host arguments and their device copies, each set in one
    buffer: ``host[name]`` are numpy views of one host buffer (pinned on
    the card) that the scheduler writes; ``dev[name]`` are views of one
    device buffer that the step reads; ``upload()`` copies the one into
    the other with a single non-blocking copy."""

    _ALIGN = 16

    def __init__(self, fields, device):
        spans, total = [], 0
        for name, shape, dtype in fields:
            dtype = np.dtype(dtype)
            nbytes = int(np.prod(shape)) * dtype.itemsize
            spans.append((name, shape, dtype, total, nbytes))
            total += -(-nbytes // self._ALIGN) * self._ALIGN
        self._host = torch.zeros(total, dtype=torch.uint8,
                                 pin_memory=device.type == "cuda")
        self._dev = torch.zeros(total, dtype=torch.uint8, device=device)
        raw = self._host.numpy()
        self.host = {name: raw[off:off + n].view(dtype).reshape(shape)
                     for name, shape, dtype, off, n in spans}
        self.dev = {name: self._dev[off:off + n].view(_TORCH_DTYPES[dtype])
                    .view(shape) for name, shape, dtype, off, n in spans}

    def upload(self):
        self._dev.copy_(self._host, non_blocking=True)


def _host_tokens(shape, device):
    """Where a step's int32 tokens land on the host (pinned on the
    card)."""
    return torch.zeros(shape, dtype=torch.int32,
                       pin_memory=device.type == "cuda")


# ---------------------------------------------------------------- scheduler --
class _Seq:
    """Decode-loop-private state of one admitted sequence."""

    __slots__ = ("req", "prompt", "max_new", "temp", "top_k", "slot",
                 "pages", "cached", "out", "stamp", "ran", "priority",
                 "shared_n", "seed", "rid", "salvage", "replay")

    def __init__(self, req, prompt, max_new, temp, top_k, priority=0):
        self.req = req
        self.prompt = prompt
        self.max_new = max_new
        self.temp = temp
        self.top_k = top_k
        self.priority = priority  # QoS class priority — scheduling order
        self.slot = None
        self.pages = []
        self.cached = 0          # tokens whose K/V is in the pool
        self.out = []            # generated token ids (EOS excluded)
        self.stamp = 0.0         # admission order — eviction picks youngest
        self.ran = False         # ever prefilled (survives preemption)
        self.shared_n = 0        # leading pages mapped from the prefix index
        self.seed = 0            # per-sequence sampling seed
        self.rid = -1            # admission ordinal — the journal's key
        self.salvage = 0         # failure-salvage retries consumed
        self.replay = []         # recorded tokens still to force post-resume


class GenerationServer:
    """Continuous-batching autoregressive generation server.

    Lifecycle: construct → ``start()`` (allocates the pools on the
    device and warms up every prefill bucket, the handoff step when
    disaggregated, the decode step and, with a draft, the verify step)
    → ``submit()``/``__call__`` → ``drain()``
    or ``serve_forever()``.  ``submit`` returns a ``Request`` future
    resolving to the generated token ids (``np.int32``, EOS excluded) or
    an explicit error.

    ``params`` is the causal LM's param dict (tensors or arrays; e.g.
    ``causal_lm.params_from_jax`` of a JAX param dict); it is moved to
    ``device`` as float32 (so is ``draft``).  ``device`` defaults to
    ``"cuda"``: without a card the constructor raises unless
    ``device="cpu"`` is asked for.  On the card the steps run as
    captured CUDA graphs unless ``capture=False``; ``capture=True`` on
    the CPU raises.

    ``tp_shards`` / ``tp_collectives``: tensor parallelism over the
    ``tp`` axis of the current mesh (else ``make_mesh(tp=<world>)``),
    whose size must be ``tp_shards``; the leader-and-followers design
    of the module's doc: every rank of the gang builds the server with
    the same arguments and calls ``start()`` and ``drain()``, only the
    leader (tp index 0) takes requests.

    The JAX server's arguments, as it defines them: ``attention_impl``
    (the decode and verify steps' paged attention: None, the
    hand-written kernel on the card and its plain version on the CPU;
    ``"pallas"``, the kernel, which needs the card; ``"jnp"``, the plain
    version on any device), ``prefill_workers`` (disaggregated prefill,
    see the module's doc), ``draft`` / ``draft_config`` / ``spec_k`` /
    ``spec_window`` (speculative decoding), ``qos`` (a ``TenantQoS``:
    priority classes, per-tenant buckets, ``healthz()["classes"]``),
    ``salvage_retries`` (per sequence, for step failures), ``journal`` /
    ``journal_every`` (the decode journal's path and snapshot period),
    ``memory_report`` (the ``mem_*`` gauges of ``telemetry()``).

    One decode loop thread owns all device state (pools, slot arrays,
    allocator traffic, the prefix index); client threads touch only the
    admission deque, the lock-guarded stats and ``Request`` futures.
    Prefill workers (``prefill_workers``) touch the sequences of the
    group they hold, their bucket's step inputs and the handoff queue,
    never the pools, the allocator or the slot arrays.

    Profiler series: ``<name>::tokens_out``, ``<name>::page_occupancy``
    (percent of allocatable pages held), ``<name>::preempted``,
    ``<name>::retired``; histograms ``<name>::slot_pages`` (pages a
    sequence held at retirement) and ``<name>::spec_accept_rate``.
    """

    _IDLE_TICK = 0.005

    def __init__(self, params, config, *, buckets=None, n_slots=8,
                 n_pages=64, page_size=16, max_context=None,
                 max_queue=128, rate=None, burst=None, breaker=None,
                 default_deadline=None, max_new_tokens=32, eos_id=None,
                 seed=0, attention_impl=None, prefill_workers=0,
                 qos=None, tp_shards=1, tp_collectives="f32", draft=None,
                 draft_config=None, spec_k=3, spec_window=16,
                 salvage_retries=2, journal=None, journal_every=8,
                 memory_report=None, device="cuda", capture=None,
                 name="GenerationServer"):
        self.device = resolve_device(device)
        if self.device.type != "cuda" and capture:
            raise ValueError(f"{name}: capture=True needs the card, not "
                             f"{self.device}; pass capture=None or False")
        attention = _decode_attention(attention_impl, self.device, name)
        self._n_prefill_workers = int(prefill_workers)
        if self._n_prefill_workers < 0:
            raise ValueError(f"{name}: prefill_workers must be >= 0")
        self.tp_shards = int(tp_shards)
        _check_collectives(tp_collectives, f"{name}: ")
        self.tp_collectives = tp_collectives
        self._mesh, self._tp_group, self.leader = None, None, True
        self._pf_group = self._pf_mesh = None
        if self.tp_shards > 1:
            self._tp_setup(config, name)
        host_comm = self._mesh is not None and _dist.backend() == "gloo"
        self._graphs = GraphCache(self.device) \
            if self.device.type == "cuda" and capture is not False \
            and not host_comm else None
        if host_comm and capture:
            raise ValueError(f"{name}: capture=True: the tp group runs over "
                             f"gloo (ranks share a card), whose collectives "
                             f"go through the host and cannot be captured; "
                             f"pass capture=None or False")
        self.config = config
        self._spec_k = int(spec_k)
        self._spec_window = int(spec_window)
        self._draft_cfg = draft_config
        if draft is not None:
            if draft_config is None:
                raise ValueError(f"{name}: draft= needs draft_config= "
                                 f"(the draft's CausalLMConfig)")
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError(
                    f"{name}: draft vocab {draft_config.vocab_size} != "
                    f"target vocab {config.vocab_size}")
            if self._spec_k < 1:
                raise ValueError(f"{name}: spec_k must be >= 1")
            if self._spec_window < 1:
                raise ValueError(f"{name}: spec_window must be >= 1")
        if buckets is None:
            buckets = BucketSpec(batch=(1, 2), length=(16, 32))
        self.buckets = buckets if isinstance(buckets, BucketSpec) \
            else BucketSpec(buckets)
        if self.buckets.length is None:
            raise ValueError(f"{name}: buckets must define length "
                             f"buckets — prompts are sequences")
        self.n_slots = int(n_slots)
        self.alloc = PageAllocator(n_pages, page_size)
        # per-sequence page-table width: the longest prompt bucket plus
        # the default generation budget (a configuration constant); the
        # verify step writes spec_k lookahead positions past the pending
        # token
        if max_context is None:
            max_context = max(self.buckets.length) + int(max_new_tokens) \
                + (self._spec_k if draft is not None else 0)
        if max_context < max(self.buckets.length) + 1:
            raise ValueError(
                f"{name}: max_context {max_context} cannot hold the "
                f"largest length bucket {max(self.buckets.length)} plus "
                f"one generated token")
        self.pages_per_seq = self.alloc.pages_for(max_context)
        self.max_context = self.pages_per_seq * self.alloc.page_size
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self._limiter = None if rate is None else TokenBucket(rate, burst)
        self._qos = qos if qos is not None else TenantQoS()
        self._default_deadline = default_deadline
        self._max_new = int(max_new_tokens)
        self._eos = None if eos_id is None else int(eos_id)
        self._name = name
        self._max_queue = int(max_queue)

        self._params = self._on_device(params)
        tp = dict(mesh=self._mesh)
        if self._mesh is not None:
            from ..gluon.model_zoo.causal_lm import tp_shard_params
            self._params = tp_shard_params(self._params, config, self._mesh)
        self._decode = build_decode_step(
            config, self.alloc.page_size, attention=attention,
            tp_collectives=tp_collectives, **tp)
        if self._n_prefill_workers > 0:
            # disaggregated: the pool-free prefill grid + ONE handoff
            self._prefill = build_prefill_kv_step(
                config, **(tp if self._pf_mesh is None
                           else dict(mesh=self._pf_mesh)))
            self._handoff = build_handoff_step(config, self.alloc.page_size,
                                               **tp)
        else:
            self._prefill = build_prefill_step(config, self.alloc.page_size,
                                               **tp)
            self._handoff = None
        if draft is not None:
            self._draft_params = self._on_device(draft)
            self._verify = build_verify_step(
                config, draft_config, self.alloc.page_size, self._spec_k,
                self._spec_window, attention=attention,
                tp_collectives=tp_collectives, **tp)
        else:
            self._draft_params = None
            self._verify = None
        # the server seed only salts the per-sequence seed derivation
        # (admission ordinal → splitmix); sampling noise is a pure
        # function of (sequence seed, token position)
        self._seed_root = int(seed) & 0xFFFFFFFFFFFFFFFF
        self._admit_ord = 0                 # _admit_lock-guarded
        self._salvage_retries = max(0, int(salvage_retries))
        self._journal = None if journal is None \
            else _telemetry.JsonlSink(journal)
        self._journal_every = max(1, int(journal_every))
        self._jsteps = 0                    # decode-loop-private
        self._handoff_exit = threading.Event()
        self.exported = []                  # SequenceSnapshots from handoff

        # decode-loop-private device + slot state (pools made in start()):
        # the slot arrays are host views of the decode (and verify)
        # step's one staging buffer
        self._k_pool = self._v_pool = None
        self._seqs = {}                                  # slot -> _Seq
        self._decode_in = _Staged(self._step_fields(self.n_slots),
                                  self.device)
        self._decode_out = _host_tokens(self.n_slots, self.device)
        self._verify_out = _host_tokens(
            (self.n_slots, self._spec_k + 2), self.device) \
            if self._verify is not None else None
        self._prefill_io = {}         # (batch, length) -> (_Staged, out)
        # a bucket's step inputs and outputs are shared by the prefill
        # workers: one user at a time, from filling to copying out
        self._prefill_locks = {(b, L): threading.Lock()
                               for b in self.buckets.batch
                               for L in self.buckets.length}
        # the handoff step's arguments: the K/V staging buffers (made
        # with the pools) and one staging buffer of the rest; the event
        # marks the last upload of its host half
        self._hand_k = self._hand_v = None
        B = self.buckets.max_batch
        self._handoff_in = _Staged(
            [("lengths", (B,), np.int32), ("active", (B,), np.bool_),
             ("tables", (B, self.pages_per_seq), np.int32)]
            + ([("ids", (B, 2), np.int64)] if self._mesh is not None
               else []),
            self.device) if self._handoff is not None else None
        self._handoff_done = None
        d = self._decode_in.host
        self._tokens, self._lengths = d["tokens"], d["lengths"]
        self._active, self._tables = d["active"], d["tables"]
        self._temps, self._topks = d["temps"], d["topks"]
        self._seeds = d["seeds"]
        # CoW fault lanes, reset each step; (0, 0) = inert sink self-copy
        self._cow_src, self._cow_dst = d["cow"][0], d["cow"][1]
        # the draft's context: right-aligned token windows
        if self._verify is not None:
            self._window, self._nvalid = d["window"], d["nvalid"]
        else:
            self._window = np.zeros((self.n_slots, self._spec_window),
                                    np.int32)
            self._nvalid = np.zeros((self.n_slots,), np.int32)
        self._nvalid[:] = 1
        # prefix index (decode-loop-private): parent page (0 = root) →
        # {full-block token tuple: resident page}, plus the reverse map
        # releases use
        self._children = {}
        self._indexed_by_page = {}

        self._pending = collections.deque()
        self._admit_lock = threading.Lock()
        self._lock = threading.Lock()
        self._stats = {"admitted": 0, "completed": 0, "failed": 0,
                       "expired": 0, "rejected": 0, "retired": 0,
                       "preempted": 0, "tokens_out": 0, "prefills": 0,
                       "handoffs": 0, "decode_steps": 0, "active_slots": 0,
                       "verify_steps": 0, "spec_proposed": 0,
                       "spec_accepted": 0, "cow_faults": 0,
                       "pages_charged": 0, "pages_shared_mapped": 0,
                       "tokens_salvaged": 0, "resumes": 0,
                       "salvage_retries": 0, "journal_restores": 0,
                       "journal_errors": 0, "resume_pages_remapped": 0,
                       "handoff_exports": 0}
        self._last_error = None
        self._ready = threading.Event()
        self._draining = threading.Event()
        self._stop = threading.Event()
        self._loop_exited = threading.Event()
        self._started = threading.Event()
        self._thread = threading.Thread(
            target=self._loop if self.leader else self._follow, name=name,
            daemon=True)
        self._follower_done = {}       # a follower's last upload, by group
        # disaggregated under tp: the prefill programs' own group and
        # header, one prefill at a time over it, their ordinal; a
        # follower's payloads by (ordinal, row) until the leader's
        # handoff (or drop) takes them
        self._pf_lock = threading.Lock()
        self._pf_cond = threading.Condition()
        self._pf_ord = 0
        self._pf_payloads, self._pf_dropped = {}, set()
        self._pf_thread = threading.Thread(
            target=self._follow_prefill, name=f"{name}-prefill-follower",
            daemon=True) if not self.leader and self._pf_group is not None \
            else None
        # disaggregated plumbing: the prefill group's work queue (bounded
        # — the decode loop is its only producer and checks full() first,
        # so put_nowait cannot race), the handoff queue (workers → decode
        # loop), the flight registry (groups a worker holds, swept on
        # loop exit so a dying worker never strands its group) and the
        # decode-loop-private backlog of payloads waiting for slots/pages
        self._prefill_q = queue.Queue(
            maxsize=max(2, 2 * self._n_prefill_workers))
        self._handoff_q = queue.Queue()
        self._prefill_flight = {}          # id(group) -> group, _lock-guarded
        self._handoff_backlog = []         # decode-loop-private
        self._prefill_threads = [
            threading.Thread(target=self._prefill_worker,
                             name=f"{name}-prefill-w{i}", daemon=True)
            for i in range(self._n_prefill_workers)]
        self._c_tokens = _profiler.Counter(None, f"{name}::tokens_out")
        self._c_pages = _profiler.Counter(None, f"{name}::page_occupancy")
        self._c_preempted = _profiler.Counter(None, f"{name}::preempted")
        self._c_retired = _profiler.Counter(None, f"{name}::retired")
        self._mem_gauges = _telemetry.memory_gauges(memory_report)
        self._h_slot_pages = _telemetry.registry().histogram(
            f"{name}::slot_pages",
            _telemetry.log_buckets(1.0, 4096.0, per_decade=4))
        self._h_accept = _telemetry.registry().histogram(
            f"{name}::spec_accept_rate", [i / 8 for i in range(1, 9)])

    def _tp_setup(self, config, name):
        """The tensor-parallel gang: the mesh (the current one, else
        ``make_mesh(tp=<world>)``) whose ``tp`` axis has ``tp_shards``
        ranks, this rank's role (the rank at tp index 0 leads) and the
        group the leader's headers go over."""
        from ..gluon.model_zoo.causal_lm import tp_validate
        from ..parallel.mesh import current_mesh, make_mesh

        tp_validate(config, self.tp_shards)
        mesh = current_mesh()
        if mesh is None or "tp" not in mesh.shape:
            mesh = make_mesh(tp=_dist.num_workers())
        visible = int(mesh.shape["tp"])
        if self.tp_shards > visible:
            raise ValueError(
                f"{name}: tp_shards={self.tp_shards} exceeds the {visible} "
                f"visible devices (the ranks of the gang's tp axis, one "
                f"card each)")
        if self.tp_shards != visible:
            raise ValueError(
                f"{name}: tp_shards={self.tp_shards}, but the gang's tp "
                f"axis has {visible} ranks: run tp_shards ranks on it")
        self._mesh = mesh
        self._tp_group = mesh.group("tp")
        self.leader = mesh.coords()["tp"] == 0
        wire = "cpu" if _dist.backend() == "gloo" else self.device
        self._header = torch.zeros(4, dtype=torch.int64, device=wire)
        if self._n_prefill_workers > 0:
            # the prefill workers' programs and headers go over a second
            # group of the same ranks, so they never interleave with the
            # decode loop's on the tp group
            self._pf_group = _second_group(mesh, "tp")
            self._pf_mesh = mesh.on_groups({"tp": self._pf_group})
            self._pf_header = torch.zeros(4, dtype=torch.int64, device=wire)

    def _on_device(self, params):
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.array(v, dtype=np.float32)))
                .to(device=self.device, dtype=torch.float32)
                for k, v in params.items()}

    # ------------------------------------------------------------ lifecycle --
    def start(self, warmup=True):
        """Allocate the zeroed pools on the device and (by default) run
        every prefill bucket shape, the handoff step (disaggregated),
        the decode step and (with a draft) the verify step once with
        inert all-inactive arguments (writes sink to page 0, the
        allocator is untouched) before readiness flips — on the card
        this also builds and loads the attention kernel, makes its
        launch plans and captures every step's graph (``graph_count()
        == census()`` after it).  ``warmup=False`` captures each graph
        at its first call instead, a prefill bucket's on the worker
        that first runs it.

        A follower of a tensor-parallel gang allocates its pools and
        starts its loop (which runs what the leader announces, its
        warm-up included) and returns."""
        if self._draining.is_set():
            raise ServerClosedError(f"{self._name}: already drained")
        c, npg, psz = self.config, self.alloc.n_pages, self.alloc.page_size
        heads = c.n_heads // self.tp_shards          # this rank's heads
        shape = (c.n_layers, npg, psz, heads, c.head_dim)
        self._k_pool = torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)
        self._v_pool = torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)
        if self._handoff is not None:
            shape = (c.n_layers, self.buckets.max_batch,
                     max(self.buckets.length), heads, c.head_dim)
            self._hand_k = torch.zeros(shape, dtype=torch.float32,
                                       device=self.device)
            self._hand_v = torch.zeros(shape, dtype=torch.float32,
                                       device=self.device)
        if not self.leader:
            self._started.set()
            self._thread.start()
            if self._pf_thread is not None:
                self._pf_thread.start()
            return self
        if warmup:
            for b in self.buckets.batch:
                for L in self.buckets.length:
                    zeros = np.zeros((b,), np.int32)
                    if self._handoff is not None:
                        self._run_prefill_kv(
                            np.zeros((b, L), np.int32), zeros,
                            np.zeros((b,), np.int64),
                            np.zeros((b,), np.float32), zeros)
                        continue
                    self._run_prefill(
                        np.zeros((b, L), np.int32), zeros,
                        np.zeros((b,), bool),
                        np.zeros((b, self.pages_per_seq), np.int32),
                        np.zeros((b,), np.int64),
                        np.zeros((b,), np.float32), zeros)
            if self._handoff is not None:
                self._run_handoff([])
            self._run_decode()
            if self._verify is not None:
                self._run_verify()
            # every graph of the census exists now: a later capture at
            # this site is an UNEXPECTED recompile (the counter the obs
            # chaos mode holds at zero); a warmup=False server captures
            # lazily by choice, so nothing is pinned
            if _telemetry.ACTIVE:
                _telemetry.pin_compile_census(self._name)
        self._started.set()
        self._thread.start()
        for t in self._prefill_threads:
            t.start()
        self._ready.set()
        return self

    def __enter__(self):
        if not self._started.is_set():
            self.start()
        return self

    def __exit__(self, *exc):
        self.drain()
        return False

    def census(self):
        """The step programs the server runs: one prefill graph per
        (batch, length) bucket plus THE decode graph, plus THE handoff
        graph when disaggregated (``prefill_workers >= 1``: the workers
        share a bucket's graph) and THE verify graph with a draft, as
        the JAX server's ``census()``.  ``graph_count()`` equals it after
        ``start()`` on the card, forever."""
        grid = len(self.buckets.batch) * len(self.buckets.length)
        return grid + 1 + (1 if self._handoff is not None else 0) \
            + (1 if self._verify is not None else 0)

    def graph_count(self):
        """CUDA graphs captured so far (the JAX server's
        ``jit_cache_count``); 0 where the steps run eagerly."""
        return 0 if self._graphs is None else len(self._graphs)

    # ------------------------------------------------------------ admission --
    def _refuse_closed(self):
        """The refusals ``submit`` and ``submit_resume`` share: a
        follower of a tensor-parallel gang, draining, not started, loop
        dead, breaker open."""
        if not self.leader:
            raise RejectedError(
                f"{self._name}: rank {_dist.rank()} follows the tensor-"
                f"parallel leader (tp index 0) and takes no requests: "
                f"submit to the leader")
        if self._draining.is_set():
            self._bump("rejected")
            raise ServerClosedError(f"{self._name}: draining — "
                                    f"not admitting")
        if not self._ready.is_set():
            self._bump("rejected")
            raise RejectedError(f"{self._name}: not started")
        if not self._thread.is_alive():
            self._bump("rejected")
            raise ServerClosedError(f"{self._name}: decode loop is not "
                                    f"running — not admitting")
        if self.breaker.engaged():
            self._bump("rejected")
            raise CircuitOpenError(
                f"{self._name}: circuit open after repeated step failures "
                f"— fast-failing until a probe succeeds")

    def submit(self, tokens, *, max_new_tokens=None, temperature=0.0,
               top_k=0, deadline=None, tenant=None, klass=None,
               seed=None, trace_parent=None):
        """Admit one prompt; returns a ``Request`` future resolving to
        the generated ``np.int32`` token ids (EOS excluded).

        ``tenant``/``klass`` are the QoS labels (``TenantQoS``): the
        class supplies the default deadline, its priority orders
        seating, and the resolution lands in ``healthz()["classes"]``.
        ``seed`` pins this sequence's sampling seed (any uint32); by
        default it derives from the server seed and the admission
        ordinal.  ``trace_parent`` (a ``telemetry`` span) attaches the
        request's spans under it.

        Refusals are immediate and explicit: ``ServerClosedError``
        draining, ``CircuitOpenError`` fast-fail, ``RejectedError`` for
        rate limit / full queue / a prompt no length bucket holds / a
        worst case that could never fit the page pool,
        ``TenantThrottledError`` for an over-rate tenant.  None of them
        touched the device."""
        t0_us = _telemetry.now_us() if _telemetry.ACTIVE else None
        self._refuse_closed()
        raw = np.asarray(tokens)
        if not np.issubdtype(raw.dtype, np.integer):
            raise ValueError(
                f"{self._name}: prompt dtype {raw.dtype} is not an "
                f"integer token array — casting would silently "
                f"truncate; tokenize first")
        prompt = raw.astype(np.int32)
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            raise ValueError(f"{self._name}: prompt must be a 1-D, "
                             f"non-empty int sequence")
        max_new = self._max_new if max_new_tokens is None \
            else int(max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if float(temperature) < 0.0 or int(top_k) < 0:
            raise ValueError("temperature must be >= 0 and top_k >= 0")
        n = prompt.shape[0]
        try:
            if n > max(self.buckets.length):
                raise RejectedError(
                    f"prompt length {n} exceeds the largest length bucket "
                    f"{max(self.buckets.length)} — no prefill shape "
                    f"exists for it")
            # speculative mode verifies spec_k lookahead positions past
            # the pending token — the worst case must hold them too
            spare = self._spec_k if self._verify is not None else 0
            if n + max_new + spare > self.max_context:
                raise RejectedError(
                    f"prompt {n} + max_new_tokens {max_new}"
                    + (f" + spec_k {spare}" if spare else "")
                    + f" exceeds the page capacity {self.max_context} "
                    f"per sequence")
            if self.alloc.pages_for(n + max_new + spare) \
                    > self.alloc.allocatable:
                raise RejectedError(
                    f"worst case needs "
                    f"{self.alloc.pages_for(n + max_new + spare)} "
                    f"pages, pool holds {self.alloc.allocatable} — this "
                    f"request could never be served")
        except RejectedError:
            self._bump("rejected")
            raise
        # the QoS verdict after the structural checks (an unservable
        # prompt must not burn a tenant token), before the global limiter
        try:
            qc = self._qos.classify(tenant=tenant, klass=klass)
        except RejectedError:
            self._bump("rejected")
            raise
        if deadline is None:
            deadline = qc.deadline if qc.deadline is not None \
                else self._default_deadline
        if self._limiter is not None and not self._limiter.try_acquire():
            self._qos.refund(tenant, qc)
            self._bump("rejected")
            raise RejectedError(f"{self._name}: rate limit exceeded — "
                                f"shedding")
        req = Request((prompt,), deadline=deadline, tenant=tenant,
                      klass=qc.name)
        seq = _Seq(req, prompt, max_new, float(temperature), int(top_k),
                   priority=qc.priority)
        seq.stamp = time.monotonic()
        # a class's admit_frac caps the TOTAL queue depth at which its
        # work is still admitted, keeping the rest for higher classes
        queue_cap = self._max_queue if qc.admit_frac >= 1.0 \
            else int(qc.admit_frac * self._max_queue)
        # trace before joining the queue: the decode loop may pop the
        # sequence at once and needs the queue span open
        if trace_parent is not None or t0_us is not None:
            _telemetry.begin_request(req, self._name, t0_us=t0_us,
                                     parent=trace_parent)
        with self._admit_lock:
            admitted = not self._stop.is_set() \
                and len(self._pending) < queue_cap
            if admitted:
                seq.rid = self._admit_ord
                self._admit_ord += 1
                seq.seed = self._derive_seed(seq.rid) if seed is None \
                    else int(seed) & 0xFFFFFFFF
                self._pending.append(seq)
            else:
                stopped = self._stop.is_set()
        if not admitted:
            if self._limiter is not None:
                self._limiter.refund()
            self._qos.refund(tenant, qc)
            self._bump("rejected")
            _telemetry.abort_request(req)
            if stopped:
                raise ServerClosedError(f"{self._name}: draining — "
                                        f"not admitting")
            raise RejectedError(
                f"{self._name}: request queue at class "
                f"{qc.name!r}'s cap ({queue_cap} of "
                f"{self._max_queue}) — shedding")
        self._qos.track(qc, req)
        self._bump("admitted")
        self._journal_admit(seq)
        return req

    def submit_resume(self, snapshot, *, deadline=None):
        """Admit a ``SequenceSnapshot`` (or its JSON dict): the sequence
        re-enters the queue with its generated-so-far tokens and its
        ORIGINAL seed, re-prefills prompt + generated through the bucket
        grid and completes token-exact with what the uninterrupted run
        would have produced.  ``deadline`` (seconds from now) overrides
        the snapshot's wall-clock expiry; with neither there is none.
        QoS classification is not re-applied; the snapshot's priority
        orders seating.  Refusals as ``submit``'s."""
        t0_us = _telemetry.now_us() if _telemetry.ACTIVE else None
        if isinstance(snapshot, dict):
            snapshot = SequenceSnapshot.from_json(snapshot)
        self._refuse_closed()
        prompt = np.asarray(snapshot.prompt, np.int32)
        n = prompt.shape[0]
        max_new = int(snapshot.max_new)
        spare = self._spec_k if self._verify is not None else 0
        try:
            if n < 1:
                raise RejectedError("snapshot prompt is empty")
            if n > max(self.buckets.length):
                raise RejectedError(
                    f"snapshot prompt length {n} exceeds the largest "
                    f"length bucket {max(self.buckets.length)} on this "
                    f"server — no prefill shape exists")
            if n + max_new + spare > self.max_context \
                    or self.alloc.pages_for(n + max_new + spare) \
                    > self.alloc.allocatable:
                raise RejectedError(
                    f"snapshot worst case ({n} + {max_new} new) does not "
                    f"fit this server's page capacity")
        except RejectedError:
            self._bump("rejected")
            raise
        if deadline is None and snapshot.deadline_wall is not None:
            deadline = snapshot.deadline_wall - time.time()
        req = Request((prompt,), deadline=deadline,
                      tenant=snapshot.tenant, klass=snapshot.klass)
        seq = _Seq(req, prompt, max_new, float(snapshot.temperature),
                   int(snapshot.top_k), priority=snapshot.priority)
        seq.out = [int(t) for t in snapshot.out]
        seq.stamp = time.monotonic()
        if len(seq.out) >= max_new:
            # already complete (journaled between its last token and
            # its retirement record): resolve without work
            self._bump("admitted")
            req.set_result(np.asarray(seq.out[:max_new], np.int32))
            self._bump("completed")
            self._bump("retired")
            return req
        if t0_us is not None:
            _telemetry.begin_request(req, self._name, t0_us=t0_us)
        with self._admit_lock:
            admitted = not self._stop.is_set() \
                and len(self._pending) < self._max_queue
            if admitted:
                seq.rid = self._admit_ord
                self._admit_ord += 1
                seq.seed = int(snapshot.seed) & 0xFFFFFFFF
                self._pending.append(seq)
            else:
                stopped = self._stop.is_set()
        if not admitted:
            self._bump("rejected")
            _telemetry.abort_request(req)
            if stopped:
                raise ServerClosedError(f"{self._name}: draining — "
                                        f"not admitting")
            raise RejectedError(f"{self._name}: request queue full "
                                f"({self._max_queue}) — shedding")
        self._bump("admitted")
        self._journal_admit(seq)
        return req

    def restore_journal(self, path):
        """Import a stopped server's decode journal (either package's):
        replay ``gen_admit`` / ``gen_snapshot`` / ``gen_handoff`` /
        ``gen_retire`` records in order, and ``submit_resume`` every
        sequence that was admitted and never retired — this server then
        completes them token-exact (position-keyed sampling and the
        journaled seed; a stale snapshot only means more tokens to
        regenerate).  Reads the rotated ``<path>.1`` first, then
        ``path``; a torn tail line is skipped.  Returns ``{rid:
        Request}`` keyed by the journal's rids."""
        live = {}
        for p in (str(path) + ".1", str(path)):
            if not os.path.exists(p):
                continue
            with open(p, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue               # torn tail line
                    if rec.get("kind") != "generate":
                        continue
                    nm, rid = rec.get("name"), rec.get("rid")
                    if rid is None:
                        continue
                    if nm in ("gen_admit", "gen_handoff"):
                        live[rid] = dict(rec)
                    elif nm == "gen_snapshot" and rid in live:
                        live[rid]["out"] = list(rec.get("out", []))
                    elif nm == "gen_retire":
                        live.pop(rid, None)
        restored = {}
        for rid, rec in live.items():
            restored[rid] = self.submit_resume(
                SequenceSnapshot.from_json(rec))
            self._bump("journal_restores")
        return restored

    def __call__(self, tokens, timeout=None, **kw):
        """Blocking convenience: submit + ``result()``."""
        return self.submit(tokens, **kw).result(timeout)

    def _bump(self, key, n=1):
        with self._lock:
            self._stats[key] += n

    def _note_step_failure(self, exc):
        with self._lock:
            self._last_error = (type(exc).__name__, time.monotonic())

    # ---------------------------------------------------- snapshots + journal --
    def _snapshot_of(self, seq):
        """One sequence's resumable state (at a step boundary)."""
        dw = None
        if seq.req.deadline is not None:
            dw = time.time() + (seq.req.deadline - time.monotonic())
        return SequenceSnapshot(
            rid=seq.rid, prompt=seq.prompt, out=seq.out,
            max_new=seq.max_new, temperature=seq.temp, top_k=seq.top_k,
            seed=seq.seed, priority=seq.priority, deadline_wall=dw,
            tenant=seq.req.tenant, klass=seq.req.klass)

    def _journal_event(self, name, **fields):
        """Append one record to the decode journal.  A write failure
        only bumps ``journal_errors``: the journal must never fail
        serving (``generate.journal`` is the fault point)."""
        if self._journal is None:
            return
        try:
            _fault.fire("generate.journal")
            self._journal.write("generate", name=name, **fields)
        except Exception:   # noqa: BLE001 — journaling must not fail serving
            self._bump("journal_errors")

    def _journal_admit(self, seq):
        """One ``gen_admit`` record per accepted sequence: its whole
        snapshot (a resumed admission carries its tokens)."""
        if self._journal is not None:
            self._journal_event("gen_admit",
                                **self._snapshot_of(seq).to_json())

    def _journal_tick(self):
        """In-flight snapshots every ``journal_every`` successful steps:
        they bound how many tokens a restore regenerates."""
        if self._journal is None:
            return
        self._jsteps += 1
        if self._jsteps % self._journal_every:
            return
        for seq in self._seqs.values():
            self._journal_event("gen_snapshot", rid=seq.rid,
                                out=list(seq.out))

    # ----------------------------------------------------------- decode loop --
    def _derive_seed(self, ordinal):
        """The per-sequence sampling seed: a splitmix64-style mix of the
        server seed and the admission ordinal (the JAX server's
        derivation).  ``submit(seed=)`` overrides it per request."""
        x = (self._seed_root
             + (int(ordinal) + 1) * 0x9E3779B97F4A7C15) \
            & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return (x ^ (x >> 31)) & 0xFFFFFFFF

    def _step_fields(self, rows, length=None):
        """The staged arguments of a step over ``rows`` slots (decode
        and verify) or a ``(rows, length)`` prefill bucket (the pool-free
        step of a disaggregated server takes no ``active``/``tables``).
        ``cow`` holds the decode step's two copy-on-write lanes (src,
        dst)."""
        pool = [("active", (rows,), np.bool_),
                ("tables", (rows, self.pages_per_seq), np.int32)]
        if length is not None and self._handoff is not None:
            pool = []
        fields = [("tokens", (rows,) if length is None else (rows, length),
                   np.int32), ("lengths", (rows,), np.int32)] + pool + [
                  ("seeds", (rows,), np.int64),
                  ("temps", (rows,), np.float32),
                  ("topks", (rows,), np.int32)]
        if length is None:
            fields.append(("cow", (2, rows), np.int32))
            if self._verify is not None:
                fields += [("window", (rows, self._spec_window), np.int32),
                           ("nvalid", (rows,), np.int32)]
        return fields

    def _run_graph(self, key, body):
        """``body()`` — a step reading the staged device arguments —
        through its graph (captured at its first call, which runs it
        eagerly first) or eagerly, on the current stream."""
        with torch.no_grad():
            if self._graphs is None:
                return body()
            if not _telemetry.ACTIVE:
                return self._graphs.run(key, body)
            # a capture is this server's compile event (the graph count
            # grows by one); a replay is a hit
            with _telemetry.track_compile(self._name, key=str(key),
                                          probe=self.graph_count,
                                          hw_key=self._graphs):
                return self._graphs.run(key, body)

    def _read_back(self, tok, out):
        """Copy a step's int32 tokens into the pinned ``out`` and return
        them on the host after the one sync of the step (on the current
        stream: all of its earlier work is done too)."""
        out.copy_(tok, non_blocking=True)
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()       # the token read-back: the step's sync
        return out.numpy().copy()

    def _run_step(self, key, body, out):
        """``body()`` — returning its int32 tokens — through
        ``_run_graph``; returns the tokens on the host."""
        return self._read_back(self._run_graph(key, body), out)

    def _prefill_staging(self, b, L):
        io = self._prefill_io.get((b, L))
        if io is None:
            io = self._prefill_io[(b, L)] = (
                _Staged(self._step_fields(b, L), self.device),
                _host_tokens(b, self.device))
        return io

    def _run_prefill(self, tokens, lengths, active, tables, seeds, temps,
                     topks):
        """One prefill step (pools updated in place); returns the
        first sampled tokens on the host."""
        b, L = tokens.shape
        staged, out = self._prefill_staging(b, L)
        h = staged.host
        for name, arr in (("tokens", tokens), ("lengths", lengths),
                          ("active", active), ("tables", tables),
                          ("seeds", seeds), ("temps", temps),
                          ("topks", topks)):
            h[name][...] = arr
        staged.upload()
        self._announce(_PREFILL, staged, b, L)
        return self._run_step(("prefill", b, L), self._prefill_body(staged),
                              out)

    def _prefill_body(self, staged):
        d = staged.dev

        def body():
            return self._prefill(
                self._params, self._k_pool, self._v_pool, d["tokens"],
                d["lengths"], d["active"], d["tables"], d["seeds"],
                d["temps"], d["topks"])[0]
        return body

    def _run_prefill_kv(self, tokens, lengths, seeds, temps, topks):
        """One POOL-FREE prefill step (disaggregated; any prefill worker,
        on its own stream).  Holds the bucket's lock from filling its
        inputs until its outputs are copied out and the first tokens
        read back — the next user of the bucket overwrites both.
        Returns the first tokens on the host and, per row with a
        positive length, its K/V ``[n_layers, lengths[i], H, D]``, a
        copy on this stream that the read-back's sync completed.  Under
        tensor parallelism one prefill runs at a time over the prefill
        group (announced to the followers first), and each payload
        carries its ``(ordinal, row)`` as ``_tp_id``."""
        b, L = tokens.shape
        gang = self._pf_lock if self._pf_group is not None \
            else contextlib.nullcontext()
        with gang, self._prefill_locks[(b, L)]:
            staged, out = self._prefill_staging(b, L)
            h = staged.host
            for name, arr in (("tokens", tokens), ("lengths", lengths),
                              ("seeds", seeds), ("temps", temps),
                              ("topks", topks)):
                h[name][...] = arr
            staged.upload()
            ordinal = self._pf_ord
            self._pf_ord += 1
            self._announce(_PREFILL_KV, staged, b, L, ordinal,
                           group=self._pf_group)
            first, payload = self._prefill_kv_body(staged, b, L, lengths)
            for j, (k_seq, _v) in enumerate(payload):
                k_seq._tp_id = (ordinal, j)
            return self._read_back(first, out), payload

    def _prefill_kv_body(self, staged, b, L, lengths):
        """The pool-free step on ``staged`` through the bucket's graph;
        its first tokens (on the card) and each row's K/V."""
        d = staged.dev

        def body():
            return self._prefill(self._params, d["tokens"], d["lengths"],
                                 d["seeds"], d["temps"], d["topks"])
        first, k_all, v_all = self._run_graph(("prefill", b, L), body)
        return first, [(k_all[:, i, :n].clone(), v_all[:, i, :n].clone())
                       for i, n in enumerate(int(n) for n in lengths)
                       if n > 0]

    def _run_handoff(self, entries):
        """One handoff step (decode loop): ``entries`` are ``(table row,
        k, v)`` per lane, at most ``buckets.max_batch``; each payload is
        copied into the K/V staging buffers on this stream, marked used
        here before it is freed, and the step scatters every lane into
        the pools (the rest sink to page 0).  Under tensor parallelism
        the lanes' payload ids go to the followers, whose own payloads
        (their heads) the same step scatters."""
        if self._handoff_done is not None:
            self._handoff_done.synchronize()  # last upload read the host
        h = self._handoff_in.host
        h["lengths"][:] = 0
        h["active"][:] = False
        h["tables"][:] = 0
        for j, (row, k_seq, v_seq) in enumerate(entries):
            self._stage_lane(j, k_seq, v_seq)
            h["lengths"][j] = k_seq.shape[1]
            h["active"][j] = True
            h["tables"][j] = row
            if "ids" in h:
                h["ids"][j] = k_seq._tp_id
        self._handoff_in.upload()
        self._announce(_HANDOFF, self._handoff_in)
        self._run_graph(("handoff",), self._handoff_body())
        if self.device.type == "cuda":
            self._handoff_done = torch.cuda.Event()
            self._handoff_done.record()

    def _stage_lane(self, j, k_seq, v_seq):
        """Lane ``j``'s payload into the handoff's K/V staging buffers,
        on this stream (marked used here before it is freed)."""
        n = k_seq.shape[1]
        self._hand_k[:, j, :n].copy_(k_seq, non_blocking=True)
        self._hand_v[:, j, :n].copy_(v_seq, non_blocking=True)
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            k_seq.record_stream(stream)
            v_seq.record_stream(stream)

    def _handoff_body(self):
        d = self._handoff_in.dev

        def body():
            self._handoff(self._k_pool, self._v_pool, self._hand_k,
                          self._hand_v, d["lengths"], d["active"],
                          d["tables"])
        return body

    def _run_decode(self):
        """One decode step over the full slot grid (pools updated in
        place); returns the next tokens on the host."""
        self._decode_in.upload()
        self._announce(_DECODE, self._decode_in)
        return self._run_step(("decode",), self._decode_body(),
                              self._decode_out)

    def _decode_body(self):
        d = self._decode_in.dev

        def body():
            return self._decode(
                self._params, self._k_pool, self._v_pool, d["tokens"],
                d["lengths"], d["active"], d["tables"], d["cow"][0],
                d["cow"][1], d["seeds"], d["temps"], d["topks"])[0]
        return body

    def _run_verify(self):
        """One verify step over the full slot grid (speculative mode's
        decode step; pools updated in place); returns ``(emitted [S,
        spec_k + 1], n_accept [S])`` on the host, read back together."""
        self._decode_in.upload()
        self._announce(_VERIFY, self._decode_in)
        both = self._run_step(("verify",), self._verify_body(),
                              self._verify_out)
        return both[:, :-1], both[:, -1]

    def _verify_body(self):
        d = self._decode_in.dev

        def body():
            emitted, n_acc, _, _ = self._verify(
                self._params, self._draft_params, self._k_pool,
                self._v_pool, d["tokens"], d["window"], d["nvalid"],
                d["lengths"], d["active"], d["tables"], d["cow"][0],
                d["cow"][1], d["seeds"], d["temps"], d["topks"])
            return torch.cat([emitted, n_acc[:, None]], dim=1)
        return body

    # ------------------------------------------------- tensor-parallel gang --
    def _announce(self, kind, staged=None, a=0, b=0, c=0, group=None):
        """The leader's header before a program runs: which program (and
        its arguments: a prefill bucket ``(a, b)``, a prefill's ordinal
        ``c``, a dropped payload's id ``(a, b)``), then the program's
        staged argument buffer — the host half over gloo, the card half
        (already uploaded) over NCCL — broadcast over the tp group (the
        prefill group for ``group``).  A no-op without a gang."""
        if self._tp_group is None:
            return
        group = self._tp_group if group is None else group
        header = self._header if group is self._tp_group \
            else self._pf_header
        header.copy_(torch.tensor([kind, a, b, c], dtype=torch.int64))
        _dist.broadcast_(header, root=0, group=group)
        if staged is not None:
            _dist.broadcast_(self._wire_half(staged), root=0, group=group)

    def _wire_half(self, staged):
        return staged._host if self._header.device.type == "cpu" \
            else staged._dev

    def _heard(self, group):
        """A follower's next header over ``group``: its four ints."""
        header = self._header if group is self._tp_group \
            else self._pf_header
        _dist.broadcast_(header, root=0, group=group)
        return [int(v) for v in header.tolist()]

    def _receive(self, staged, group=None):
        """A follower's copy of the leader's staged buffer, on the card
        (the host half uploaded over gloo)."""
        group = self._tp_group if group is None else group
        done = self._follower_done.get(id(group))
        if done is not None:
            done.synchronize()                  # the last upload read it
        _dist.broadcast_(self._wire_half(staged), root=0, group=group)
        if self._header.device.type == "cpu":
            staged.upload()
            if self.device.type == "cuda":
                done = self._follower_done[id(group)] = torch.cuda.Event()
                done.record()

    def _follow(self):
        """A follower's loop: run each program the leader announces, on
        this rank's blocks and pools, until the leader's stop."""
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while True:
                kind, a, b, _ = self._heard(self._tp_group)
                if kind == _STOP:
                    return
                if kind == _PREFILL:
                    staged, _ = self._prefill_staging(a, b)
                    self._receive(staged)
                    self._run_graph(("prefill", a, b),
                                    self._prefill_body(staged))
                elif kind == _DECODE:
                    self._receive(self._decode_in)
                    self._run_graph(("decode",), self._decode_body())
                    self._bump("decode_steps")
                elif kind == _VERIFY:
                    self._receive(self._decode_in)
                    self._run_graph(("verify",), self._verify_body())
                    self._bump("verify_steps")
                elif kind == _HANDOFF:
                    self._follow_handoff()
                elif kind == _DROP:
                    self._take_payload((a, b), wait=False)
                else:
                    raise RuntimeError(f"{self._name}: unknown program "
                                       f"{kind} from the tp leader")
        except BaseException as exc:
            self._note_step_failure(exc)
            raise
        finally:
            self._loop_exited.set()

    def _follow_handoff(self):
        """A follower's handoff: the leader's lanes, each filled from this
        rank's payload of the same id, scattered by the same step."""
        self._receive(self._handoff_in)
        d = self._handoff_in.dev
        active = d["active"].cpu().numpy()
        ids = d["ids"].cpu().numpy()
        for j in np.flatnonzero(active):
            k_seq, v_seq = self._take_payload(tuple(int(x) for x in ids[j]))
            self._stage_lane(j, k_seq, v_seq)
        self._run_graph(("handoff",), self._handoff_body())
        self._bump("handoffs")

    def _take_payload(self, pid, wait=True):
        """This follower's payload ``pid`` (``(ordinal, row)``), taken out
        of the store: waited for (its prefill runs on the prefill
        follower's thread); without ``wait`` (a drop), marked so that a
        late one is discarded."""
        with self._pf_cond:
            while wait and pid not in self._pf_payloads:
                if not self._pf_thread.is_alive():
                    raise RuntimeError(
                        f"{self._name}: the prefill follower stopped "
                        f"before payload {pid} arrived")
                self._pf_cond.wait(1.0)
            hit = self._pf_payloads.pop(pid, None)
            if hit is None:
                self._pf_dropped.add(pid)
            return hit

    def _follow_prefill(self):
        """A follower's prefill loop (disaggregated under tp): each
        prefill the leader's workers announce over the prefill group, run
        on this rank's heads on a stream of its own; the payloads kept
        by id for the leader's handoff."""
        own = None
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                own = owned_stream(self.device)
            with (torch.cuda.stream(own) if own is not None
                  else contextlib.nullcontext()):
                while True:
                    kind, b, L, ordinal = self._heard(self._pf_group)
                    if kind == _STOP:
                        return
                    with self._prefill_locks[(b, L)]:
                        staged, _ = self._prefill_staging(b, L)
                        self._receive(staged, group=self._pf_group)
                        lengths = staged.dev["lengths"].cpu().numpy()
                        _, payload = self._prefill_kv_body(staged, b, L,
                                                           lengths)
                        if own is not None:
                            own.synchronize()  # complete before handed on
                    with self._pf_cond:
                        for j, kv in enumerate(payload):
                            if (ordinal, j) in self._pf_dropped:
                                self._pf_dropped.discard((ordinal, j))
                            else:
                                self._pf_payloads[(ordinal, j)] = kv
                        self._pf_cond.notify_all()
        except BaseException as exc:
            self._note_step_failure(exc)
            raise
        finally:
            if own is not None:
                release_stream(own.device, own)
            with self._pf_cond:
                self._pf_cond.notify_all()

    def _pipeline_idle(self):
        """True when the disaggregated prefill pipeline holds no work
        (always in fused mode).  Flight is checked FIRST: a group stays
        in ``_prefill_flight`` until after its payloads are on the
        handoff queue, so checking the queues first races a worker
        finishing between the two checks, and the stale verdict would
        let a drain strand a prefilled sequence."""
        if self._handoff is None:
            return True
        with self._lock:
            if self._prefill_flight:
                return False
        return not self._handoff_backlog and self._handoff_q.empty() \
            and self._prefill_q.empty()

    def _loop(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while True:
                if self._stop.is_set() and self._handoff_exit.is_set():
                    # handoff drain: export unfinished work for a
                    # successor instead of generating to completion
                    self._export_all()
                    return
                if self._stop.is_set() and not self._seqs \
                        and not self._pending and self._pipeline_idle():
                    return
                worked = self._retire_expired()
                if self._draining.is_set() and self.breaker.engaged():
                    # drain must terminate: an open breaker during drain
                    # cannot half-open through traffic it refuses, so
                    # everything still accepted resolves explicitly now
                    # (handoff mode exports instead)
                    if self._handoff_exit.is_set():
                        self._export_all()
                        return
                    self._fail_everything(CircuitOpenError(
                        f"{self._name}: circuit open during drain — "
                        f"fast-failing accepted work"))
                    return
                if self._handoff is not None:
                    worked = self._drain_handoffs() or worked
                    worked = self._dispatch_prefill() or worked
                else:
                    worked = self._admit() or worked
                if self._seqs:
                    if self._verify is not None:
                        self._verify_once()
                    else:
                        self._decode_once()
                    worked = True
                if not worked and not self._seqs:
                    time.sleep(self._IDLE_TICK)
        finally:
            with self._admit_lock:
                self._stop.set()
            # only now may the prefill group stand down: drain() sets
            # _stop while the loop still feeds queued work through the
            # workers, so they key off _loop_exited, set strictly after
            # the loop stopped producing.  They stop BEFORE the residue
            # sweep (a worker mid-prefill could otherwise stage its
            # payload after the sweep and strand its client); the
            # sentinels are a fast path, the timed get the guarantee.
            self._loop_exited.set()
            for _ in self._prefill_threads:
                try:
                    self._prefill_q.put_nowait(None)
                except queue.Full:
                    break
            for t in self._prefill_threads:
                t.join(timeout=30)
            try:
                if self._pf_group is not None:    # the prefill follower's
                    with self._pf_lock:
                        self._announce(_STOP, group=self._pf_group)
                self._announce(_STOP)     # every follower's loop ends
            finally:
                self._fail_residue()

    # ---- prefix sharing ----
    def _drop_index_entry(self, page):
        ent = self._indexed_by_page.pop(page, None)
        if ent is not None:
            parent, toks = ent
            kids = self._children.get(parent)
            if kids is not None:
                kids.pop(toks, None)
                if not kids:
                    self._children.pop(parent, None)

    def _release(self, pages):
        """Drop one hold on ``pages`` and withdraw the prefix-index
        entries of every page that left residency — the only way the
        scheduler returns pages (a bare ``alloc.free`` would leave the
        index advertising free pages)."""
        released = self.alloc.free(pages)
        for p in released:
            self._drop_index_entry(p)
        for p in released:
            # a released parent takes its child table with it (its
            # children were released in the same call)
            self._children.pop(p, None)
        return released

    def _deindex(self, page):
        """Withdraw one page's prefix-index entry (its sole holder is
        about to write it: the advertised block content would lie)."""
        self._drop_index_entry(int(page))

    def _match_prefix(self, prompt):
        """Resident pages a new prompt's leading blocks can map onto:
        walk the index chain from the root matching FULL token blocks
        exactly; the final PARTIAL block may also map onto a resident
        full block whose leading tokens match (a superset — the extra
        tokens are masked by ``lengths``, and the sequence's first write
        into that page takes the CoW fault).  Returns the (possibly
        empty) list of resident page ids, in prefix order."""
        ps = self.alloc.page_size
        n = int(prompt.shape[0])
        shared, parent = [], 0
        for b in range(-(-n // ps)):
            kids = self._children.get(parent)
            if not kids:
                break
            chunk = prompt[b * ps:(b + 1) * ps]
            if chunk.shape[0] == ps:
                page = kids.get(tuple(int(t) for t in chunk))
                if page is None:
                    break
                shared.append(page)
                parent = page
            else:
                r = chunk.shape[0]
                part = tuple(int(t) for t in chunk)
                for toks, page in kids.items():
                    if toks[:r] == part:
                        shared.append(page)     # superset: CoW on write
                        break
                break
        return shared

    def _index_prompt(self, seq):
        """Publish a sequence's FULL prompt blocks to the prefix index
        (first writer wins — a block already resident elsewhere keeps
        its page).  Only full blocks: their content is complete and,
        since decode writes land past the prompt, fixed while
        resident."""
        ps = self.alloc.page_size
        parent = 0
        for b in range(int(seq.prompt.shape[0]) // ps):
            toks = tuple(int(t) for t in seq.prompt[b * ps:(b + 1) * ps])
            page = seq.pages[b]
            kids = self._children.get(parent)
            cur = None if kids is None else kids.get(toks)
            if cur is None:
                if kids is None:
                    kids = self._children.setdefault(parent, {})
                kids[toks] = page
                self._indexed_by_page[page] = (parent, toks)
                cur = page
            if cur != page:
                # a twin indexed first: its pages serve future matches
                break
            parent = page

    def _map_pages(self, seq):
        """Hand one admitted sequence its prompt pages: leading blocks
        resident in the prefix index are SHARED (a refcount, no pool
        cost); only the rest is allocated — all or nothing, so
        ``PoolExhaustedError`` leaves nothing taken.  Indexed at once:
        the prefill that maps these pages fills them, so a later member
        of the same group can already share them (a failed prefill
        releases them, which withdraws the entries)."""
        ptoks = self._prefill_tokens(seq)
        n = int(ptoks.shape[0])
        shared = self._match_prefix(ptoks)
        own = self.alloc.alloc(self.alloc.pages_for(n) - len(shared))
        self.alloc.share(shared)
        seq.pages = shared + own
        seq.shared_n = len(shared)
        self._bump("pages_charged", len(own))
        if shared:
            self._bump("pages_shared_mapped", len(shared))
            if seq.out:
                # a resume re-maps onto still-resident pages
                self._bump("resume_pages_remapped", len(shared))
        self._index_prompt(seq)

    def _scatter_table_row(self, seq):
        """The page-table row a PREFILL writes through: shared blocks are
        zeroed so their writes sink to page 0 — a resident shared page
        is never rewritten (a superset-shared page holds more tokens
        than this prompt claims, and the step zero-pads past
        ``lengths``).  The decode table keeps the real ids: attention
        reads the resident prefix."""
        row = np.zeros((self.pages_per_seq,), np.int32)
        row[:len(seq.pages)] = seq.pages
        row[:seq.shared_n] = 0
        return row

    # ---- retirement ----
    def _vacate(self, seq):
        """Release a sequence's slot + pages (no request resolution)."""
        if seq.req.trace is not None:
            _telemetry.end_span(seq.req, "decode", tokens=len(seq.out))
        if seq.slot is not None:
            s = seq.slot
            self._bump("active_slots", -1)
            self._active[s] = False
            self._lengths[s] = 0
            self._tokens[s] = 0
            self._tables[s, :] = 0
            self._temps[s] = 0.0
            self._topks[s] = 0
            self._cow_src[s] = 0
            self._cow_dst[s] = 0
            self._window[s, :] = 0
            self._nvalid[s] = 1
            self._seqs.pop(s, None)
            seq.slot = None
        if seq.pages:
            self._release(seq.pages)
            seq.pages = []
        seq.shared_n = 0
        self._note_occupancy()

    def _note_occupancy(self):
        total = self.alloc.allocatable
        held = total - self.alloc.free_count()
        self._c_pages.set_value(int(100 * held / total))

    def _retire(self, seq, error=None, stat="completed"):
        """Terminal retirement: vacate, resolve the future, account,
        journal — except in handoff-drain mode, where a retire record
        would erase the handoff record the successor reads."""
        if seq.pages:
            self._h_slot_pages.observe(len(seq.pages))
        self._vacate(seq)
        if error is None:
            seq.req.set_result(np.asarray(seq.out, np.int32))
        else:
            seq.req.set_error(error)
        if not self._handoff_exit.is_set():
            self._journal_event("gen_retire", rid=seq.rid, status=stat)
        self._bump(stat)
        self._bump("retired")
        self._c_retired.increment()

    def _retire_expired(self):
        """Deadline sweep: queued sequences expire without device work,
        in-flight ones mid-generation (pages freed either way; the
        error carries the partial tokens)."""
        worked = False
        now = time.monotonic()
        for seq in [s for s in self._seqs.values()
                    if s.req.expired(now)]:
            self._retire(seq, DeadlineExceededError(
                f"deadline exceeded mid-generation after "
                f"{len(seq.out)} of {seq.max_new} tokens — pages freed, "
                f"partial output on the error",
                tokens_generated=len(seq.out),
                partial_tokens=[int(t) for t in seq.out]),
                stat="expired")
            worked = True
        with self._admit_lock:
            queued = [s for s in self._pending if s.req.expired(now)]
            for s in queued:
                self._pending.remove(s)
        for seq in queued:
            self._retire(seq, DeadlineExceededError(
                "deadline exceeded in queue after preemption — partial "
                "tokens on the error" if seq.ran else
                "deadline exceeded in queue — the request never touched "
                "the device",
                tokens_generated=len(seq.out),
                partial_tokens=[int(t) for t in seq.out]),
                stat="expired")
            worked = True
        return worked

    # ---- admission into slots ----
    def _free_slots(self):
        return [s for s in range(self.n_slots) if s not in self._seqs]

    def _bucket_len(self, n):
        return next(L for L in self.buckets.length if L >= n)

    def _prefill_len(self, seq):
        """Tokens a (re-)prefill of this sequence runs through the
        bucket grid.  Fresh sequence: the prompt.  Resumed (``seq.out``
        non-empty): prompt + generated-so-far minus the pending token,
        capped at the largest length bucket; the overflow tail becomes
        ``seq.replay``, forced one token per step through the decode or
        verify step — no new step shape."""
        n = int(seq.prompt.shape[0])
        if not seq.out:
            return n
        return min(n + len(seq.out) - 1, max(self.buckets.length))

    def _prefill_tokens(self, seq):
        """The token array a (re-)prefill feeds the bucket grid."""
        if not seq.out:
            return seq.prompt
        full = np.concatenate([seq.prompt, np.asarray(seq.out, np.int32)])
        return full[:self._prefill_len(seq)]

    def _take_prefill_group(self, need_resources=True):
        """Pop one same-length-bucket group of queued sequences, highest
        QoS priority first (FIFO by admission stamp within a class).
        With ``need_resources`` (the fused path) the group is capped by
        free slots and budgeted against free pages — charging only the
        pages the prefix index cannot map; the disaggregated path
        prefills ahead of seats (its flow control is the bounded prefill
        queue).  Returns [] when nothing can start."""
        limit = self.buckets.max_batch
        if need_resources:
            limit = min(len(self._free_slots()), limit)
        if limit == 0:
            return []
        with self._admit_lock:
            if not self._pending:
                return []
            ordered = sorted(self._pending,
                             key=lambda s: (-s.priority, s.stamp))
            bucket = self._bucket_len(self._prefill_len(ordered[0]))
            group, budget = [], self.alloc.free_count()
            for seq in ordered:
                if len(group) >= limit:
                    break
                if self._bucket_len(self._prefill_len(seq)) != bucket:
                    continue
                if need_resources:
                    need = self.alloc.pages_for(self._prefill_len(seq)) \
                        - len(self._match_prefix(self._prefill_tokens(seq)))
                    if need > budget:
                        break   # keep order: don't starve the big one
                    budget -= need
                group.append(seq)
            for seq in group:
                self._pending.remove(seq)
        return group

    def _admit(self):
        """Admit queued sequences into free decode slots (prefill).
        While the breaker fast-fails nothing is admitted; once its probe
        timer expires a SINGLE group goes through as the trial."""
        if self.breaker.engaged():
            return False
        cautious = self.breaker.state_code() != 0
        worked = False
        while True:
            group = self._take_prefill_group()
            if not group:
                return worked
            worked = True
            self._prefill_group(group)
            if cautious:
                return worked

    # ---- disaggregated prefill group ----
    def _dispatch_prefill(self):
        """Feed queued sequences to the prefill workers (the bounded
        queue is the flow control; only the decode loop produces, so
        ``full()`` then ``put_nowait`` cannot race).  ``_admit``'s
        breaker stance: nothing while engaged, a single trial group
        while cautious."""
        if self.breaker.engaged():
            return False
        cautious = self.breaker.state_code() != 0
        worked = False
        while not self._prefill_q.full() \
                and len(self._handoff_backlog) <= self.n_slots:
            group = self._take_prefill_group(need_resources=False)
            if not group:
                return worked
            for seq in group:          # queue ends at dispatch; prefill
                if seq.req.trace is not None:   # covers the worker leg
                    _telemetry.end_span(seq.req, "queue")
                    _telemetry.open_span(seq.req, "prefill")
            with self._lock:
                self._prefill_flight[id(group)] = group
            self._prefill_q.put_nowait(group)
            worked = True
            if cautious:
                return worked
        return worked

    def _prefill_worker(self):
        """One prefill worker: pull a group, run the pool-free prefill on
        this thread's own stream, put the payloads on the handoff queue.
        Never touches the pools, the allocator or the slot arrays."""
        if self.device.type != "cuda":
            self._serve_prefill_queue()
            return
        torch.cuda.set_device(self.device)
        own = owned_stream(self.device)
        try:
            with torch.cuda.stream(own):
                self._serve_prefill_queue()
        finally:
            release_stream(own.device, own)

    def _serve_prefill_queue(self):
        """The worker's loop, until its sentinel or the loop's exit."""
        while True:
            try:
                group = self._prefill_q.get(timeout=self._IDLE_TICK * 4)
            except queue.Empty:
                # not _stop: drain() sets it while the loop still
                # dispatches queued work through this group
                if self._loop_exited.is_set():
                    return
                continue
            if group is None:          # drain sentinel, one per worker
                return
            try:
                self._do_prefill_kv(group)
            finally:
                with self._lock:
                    self._prefill_flight.pop(id(group), None)

    def _do_prefill_kv(self, group):
        """Run one group through the pool-free prefill and hand off its
        per-sequence payloads.  Resumed members run prompt + generated
        through the same buckets.  A failure resolves the whole group
        explicitly (the breaker sees it; resumed members are salvaged
        against their budget); the pools are untouched either way."""
        k = len(group)
        bucket = self._bucket_len(max(self._prefill_len(s) for s in group))
        b = self.buckets.batch_bucket(k)
        tokens = np.zeros((b, bucket), np.int32)
        lengths = np.zeros((b,), np.int32)
        seeds = np.zeros((b,), np.int64)
        temps = np.zeros((b,), np.float32)
        topks = np.zeros((b,), np.int32)
        pspans = None
        worker = threading.current_thread().name
        for i, seq in enumerate(group):
            ptoks = self._prefill_tokens(seq)
            n = ptoks.shape[0]
            tokens[i, :n] = ptoks
            lengths[i] = n
            seeds[i] = seq.seed
            temps[i] = seq.temp
            topks[i] = seq.top_k
            if seq.req.trace is not None:
                sp = _telemetry.get_span(seq.req, "prefill")
                if sp is not None:
                    sp.attrs["worker"] = worker     # who ran the prefill
                    if pspans is None:
                        pspans = []
                    pspans.append(sp)
        if pspans is not None:
            _telemetry.push_current(pspans)
        try:
            _fault.fire("generate.prefill")
            if any(s.out for s in group):
                _fault.fire("generate.resume")
            with _profiler.scope(f"{self._name}.prefill", cat="serving"):
                first, payload = self._run_prefill_kv(tokens, lengths, seeds,
                                                      temps, topks)
        except Exception as exc:    # noqa: BLE001 — resolved per sequence
            self.breaker.record_failure()
            self._note_step_failure(exc)
            err = _fault.with_context(exc, f"{self._name} prefill of {k}")
            for seq in group:
                if seq.out:
                    self._requeue_salvaged(seq, err)
                else:
                    self._retire(seq, err, stat="failed")
            return
        finally:
            if pspans is not None:
                _telemetry.pop_current()
        self.breaker.record_success()
        self._bump("prefills")
        for i, seq in enumerate(group):
            if seq.req.trace is not None:   # handoff wait + scatter next
                _telemetry.end_span(seq.req, "prefill")
                _telemetry.open_span(seq.req, "handoff")
            self._handoff_q.put((seq, int(first[i])) + payload[i])

    def _drain_handoffs(self):
        """Seat prefilled sequences: pack every seatable payload (a free
        slot and pages, deadline not passed) into ONE fixed-shape
        handoff batch, scatter it into the pools, seat the sequences.
        Payloads that cannot seat yet stay in the backlog for the next
        tick — slots free every step as sequences retire."""
        backlog = self._handoff_backlog
        self._handoff_backlog = []
        while True:
            try:
                backlog.append(self._handoff_q.get_nowait())
            except queue.Empty:
                break
        if not backlog:
            return False
        worked = False
        batch, still = [], []
        now = time.monotonic()
        free_slots = self._free_slots()
        budget = self.alloc.free_count()
        for entry in backlog:
            seq = entry[0]
            if seq.req.expired(now):
                self._drop_payload(entry[2])
                self._retire(seq, DeadlineExceededError(
                    "deadline exceeded before the prefilled sequence "
                    "reached a decode slot — pages never held",
                    tokens_generated=len(seq.out),
                    partial_tokens=[int(t) for t in seq.out]),
                    stat="expired")
                worked = True
                continue
            need = self.alloc.pages_for(self._prefill_len(seq)) \
                - len(self._match_prefix(self._prefill_tokens(seq)))
            if len(batch) >= min(len(free_slots), self.buckets.max_batch) \
                    or need > budget:
                still.append(entry)
                continue
            budget -= need
            batch.append(entry)
        self._handoff_backlog = still
        if not batch:
            return worked
        hspans = None
        for entry in batch:
            if entry[0].req.trace is not None:
                sp = _telemetry.get_span(entry[0].req, "handoff")
                if sp is not None:
                    if hspans is None:
                        hspans = []
                    hspans.append(sp)
        if hspans is not None:
            _telemetry.push_current(hspans)
        try:
            _fault.fire("fleet.handoff")
            lanes = []
            for seq, _tok, k_seq, v_seq in batch:
                self._map_pages(seq)
                lanes.append((self._scatter_table_row(seq), k_seq, v_seq))
            with _profiler.scope(f"{self._name}.handoff", cat="serving"):
                self._run_handoff(lanes)
        except Exception as exc:    # noqa: BLE001 — resolved per sequence
            self.breaker.record_failure()
            self._note_step_failure(exc)
            err = _fault.with_context(
                exc, f"{self._name} handoff of {len(batch)}")
            for seq, _tok, k_seq, _v in batch:
                self._drop_payload(k_seq)
                if seq.out:
                    self._requeue_salvaged(seq, err)
                else:
                    self._retire(seq, err, stat="failed")
            return True
        finally:
            if hspans is not None:
                _telemetry.pop_current()
        self._bump("handoffs")
        slots = self._free_slots()
        for j, (seq, tok, _k, _v) in enumerate(batch):
            self._seat(seq, slots[j], tok)
        self._note_occupancy()
        return True

    def _drop_payload(self, k_seq):
        """Under tp, tell the followers that the payload of ``k_seq``'s
        id will never be handed off (they free theirs)."""
        pid = getattr(k_seq, "_tp_id", None)
        if pid is not None:
            self._announce(_DROP, a=pid[0], b=pid[1])

    def _prefill_group(self, group):
        """Prefill one bucket-aligned group and seat it in decode slots.
        Resumed members run prompt + generated through the same bucket
        shapes; their pending token is forced at seat time."""
        k = len(group)
        bucket = self._bucket_len(max(self._prefill_len(s) for s in group))
        b = self.buckets.batch_bucket(k)
        slots = self._free_slots()[:k]
        pspans = None
        worker = threading.current_thread().name
        for seq in group:              # queue ended at the pop; prefill
            if seq.req.trace is not None:   # covers mapping + the step
                _telemetry.end_span(seq.req, "queue")
                sp = _telemetry.open_span(seq.req, "prefill",
                                          worker=worker)
                if sp is not None:
                    if pspans is None:
                        pspans = []
                    pspans.append(sp)
        try:
            for seq in group:
                self._map_pages(seq)
        except PoolExhaustedError:
            # _take_prefill_group budgeted against the free count and
            # nothing else allocates; defensive re-queue
            for seq in group:
                self._vacate(seq)
                if seq.req.trace is not None:
                    _telemetry.end_span(seq.req, "prefill")
                    _telemetry.open_span(seq.req, "queue", requeued=True)
            with self._admit_lock:
                self._pending.extendleft(reversed(group))
            return
        tokens = np.zeros((b, bucket), np.int32)
        lengths = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        tables = np.zeros((b, self.pages_per_seq), np.int32)
        seeds = np.zeros((b,), np.int64)
        temps = np.zeros((b,), np.float32)
        topks = np.zeros((b,), np.int32)
        for i, seq in enumerate(group):
            ptoks = self._prefill_tokens(seq)
            n = ptoks.shape[0]
            tokens[i, :n] = ptoks
            lengths[i] = n
            active[i] = True
            tables[i] = self._scatter_table_row(seq)
            seeds[i] = seq.seed
            temps[i] = seq.temp
            topks[i] = seq.top_k
        if pspans is not None:
            _telemetry.push_current(pspans)
        try:
            _fault.fire("generate.prefill")
            if any(s.out for s in group):
                _fault.fire("generate.resume")
            with _profiler.scope(f"{self._name}.prefill", cat="serving"):
                first = self._run_prefill(tokens, lengths, active, tables,
                                          seeds, temps, topks)
        except Exception as exc:    # noqa: BLE001 — resolved per sequence
            self.breaker.record_failure()
            self._note_step_failure(exc)
            err = _fault.with_context(exc, f"{self._name} prefill of {k}")
            for seq in group:
                if seq.out:
                    # a resumed member's tokens survive the failed
                    # re-prefill: salvage against its retry budget
                    self._requeue_salvaged(seq, err)
                else:
                    self._retire(seq, err, stat="failed")
            return
        finally:
            if pspans is not None:
                _telemetry.pop_current()
        self.breaker.record_success()
        self._bump("prefills")
        for i, seq in enumerate(group):
            if seq.req.trace is not None:
                _telemetry.end_span(seq.req, "prefill")
            self._seat(seq, slots[i], int(first[i]))
        self._note_occupancy()

    def _seat(self, seq, slot, tok):
        """Seat one prefilled sequence in a decode slot.  A RESUMED
        sequence (``seq.out`` non-empty) re-enters after its re-prefill
        covered ``full[:H]`` (``full`` = prompt ++ generated,
        ``H = _prefill_len``): the pending token is forced to the
        recorded ``full[H]``, recorded tokens past ``H`` replay one per
        step, and only then does sampling continue."""
        if seq.req.trace is not None:
            _telemetry.end_span(seq.req, "handoff")   # no-op when fused
            _telemetry.open_span(seq.req, "decode", slot=slot)
        seq.cached = seq.prompt.shape[0]
        seq.ran = True
        s = seq.slot = slot
        self._seqs[s] = seq
        self._bump("active_slots")
        self._tables[s, :] = 0
        # the real table, shared pages included: decode attention reads
        # the resident prefix (the prefill's row sank their writes)
        self._tables[s, :len(seq.pages)] = seq.pages
        self._temps[s] = seq.temp
        self._topks[s] = seq.top_k
        self._seeds[s] = seq.seed
        self._active[s] = True
        self._cow_src[s] = 0
        self._cow_dst[s] = 0
        if seq.out:
            full = np.concatenate([seq.prompt,
                                   np.asarray(seq.out, np.int32)])
            H = self._prefill_len(seq)
            seq.cached = H
            seq.replay = [int(t) for t in full[H + 1:]]
            self._tokens[s] = int(full[H])
            self._lengths[s] = H
            self._bump("resumes")
            if seq.req.trace is not None:
                _telemetry.span_event(seq.req, "resume",
                                      tokens=len(seq.out),
                                      replay=len(seq.replay))
            if self._verify is not None:
                self._refresh_window(seq)
            return
        if not self._finish_token(seq, tok) and self._verify is not None:
            self._refresh_window(seq)

    def _finish_token(self, seq, tok):
        """Account one newly generated token; True if the sequence
        retired (EOS or max-tokens).  A continuing sequence's slot state
        advances so the next step consumes ``tok``."""
        if self._eos is not None and tok == self._eos:
            self._retire(seq)
            return True
        seq.out.append(tok)
        self._bump("tokens_out")
        self._c_tokens.increment()
        if len(seq.out) >= seq.max_new:
            self._retire(seq)
            return True
        s = seq.slot
        self._tokens[s] = tok
        self._lengths[s] = seq.cached
        return False

    # ---- decode ----
    def _ensure_capacity(self, seq, lookahead=0):
        """Guarantee pages for this step's write positions (the pending
        token plus ``lookahead`` speculative candidates), then arm the
        slot's CoW fault if the write block is shared.  When the pool is
        dry, eviction is strictly seniority-ordered: a sequence may only
        preempt YOUNGER neighbours (later admission stamp, kept across
        preemptions); with no younger neighbour it yields ITSELF back to
        the queue.  The oldest in-flight sequence is never evicted,
        which with admission's worst-case-fit check is the global
        progress guarantee.  Returns False when ``seq`` yielded."""
        while True:
            try:
                while self.alloc.pages_for(seq.cached + 1 + lookahead) \
                        > len(seq.pages):
                    seq.pages.extend(self.alloc.alloc(1))
                    self._tables[seq.slot, len(seq.pages) - 1] = \
                        seq.pages[-1]
                self._cow_guard(seq)
                return True
            except PoolExhaustedError:
                victims = [s for s in self._seqs.values()
                           if s is not seq and s.stamp > seq.stamp]
                if victims:
                    self._preempt(max(victims, key=lambda s: s.stamp))
                elif len(self._seqs) > 1:
                    self._preempt(seq)     # we are the youngest: yield
                    return False
                else:
                    raise     # alone and dry: admission math was violated

    def _cow_guard(self, seq):
        """Copy-on-write check of this step's write block.  Only the
        block holding position ``seq.cached`` can be shared (shared
        blocks are prompt blocks and writes land at or past the prompt's
        tail; lookahead positions past it are in fresh pages), so one
        check a slot a step suffices.  On a fault: a fresh page
        (``PoolExhaustedError`` goes to the caller's preemption loop),
        our hold on the shared page dropped, table and page list
        remapped, and the step's copy lanes armed.  A sole holder's
        write into a still-indexed page withdraws its index entry."""
        s = seq.slot
        blk = seq.cached // self.alloc.page_size
        page = seq.pages[blk]
        if self.alloc.refcount(page) > 1:
            fresh = self.alloc.alloc(1)[0]
            self._release([page])          # others still hold it
            seq.pages[blk] = fresh
            seq.shared_n = min(seq.shared_n, blk)
            self._tables[s, blk] = fresh
            self._cow_src[s] = page
            self._cow_dst[s] = fresh
            self._bump("cow_faults")
        elif page in self._indexed_by_page:
            self._deindex(page)

    def _refresh_window(self, seq):
        """Right-align the draft's context: the last ``spec_window``
        tokens through the PENDING token (the draft proposes its
        successors).  During resume replay the pending token sits at
        position ``seq.cached`` and later recorded tokens stay out of
        the draft's view."""
        s = seq.slot
        W = self._spec_window
        toks = np.concatenate(
            [seq.prompt,
             np.asarray(seq.out, np.int32)])[:seq.cached + 1][-W:]
        self._window[s, :] = 0
        self._window[s, W - len(toks):] = toks
        self._nvalid[s] = len(toks)

    def _preempt(self, victim):
        """Evict a sequence to free its pages (pool exhaustion) and
        requeue it at the FRONT with its generated tokens: re-admission
        re-prefills prompt + generated and the position-keyed sampler
        continues the same stream, so it costs latency, never work.
        Preemption is scheduling, not failure: it spends no salvage
        budget."""
        _fault.fire("generate.evict")
        self._vacate(victim)
        victim.cached = 0
        victim.replay = []
        if victim.out:
            self._bump("tokens_salvaged", len(victim.out))
        self._bump("preempted")
        self._c_preempted.increment()
        self._journal_event("gen_snapshot", rid=victim.rid,
                            out=list(victim.out))
        if victim.req.trace is not None:
            _telemetry.span_event(victim.req, "preempt",
                                  tokens_salvaged=len(victim.out))
            _telemetry.open_span(victim.req, "queue", requeued=True)
        with self._admit_lock:
            self._pending.appendleft(victim)

    def _terminal(self, seq, err, msg):
        """``err`` with ``msg`` and the resume payload: the partial
        tokens and a snapshot, for a router to redispatch."""
        terminal = _fault.with_context(err, msg)
        terminal.tokens_generated = len(seq.out)
        terminal.partial_tokens = [int(t) for t in seq.out]
        terminal.snapshot = self._snapshot_of(seq)
        return terminal

    def _requeue_salvaged(self, seq, err, budgeted=True):
        """Salvage one accepted sequence off a failure: keep its tokens
        and requeue it for a token-exact resume.  A ``budgeted`` failure
        (the sequence sat in the failing step) spends one of its
        ``salvage_retries``; past the budget it retires with a terminal
        error carrying ``tokens_generated``, ``partial_tokens`` and
        ``snapshot``.  Unbudgeted salvage (breaker fast-fail) keeps the
        work without charging the sequence.  Returns True when the
        sequence was requeued."""
        if budgeted:
            seq.salvage += 1
            if seq.salvage > self._salvage_retries:
                self._retire(seq, self._terminal(
                    seq, err, f"{self._name}: salvage budget "
                    f"({self._salvage_retries}) exhausted after "
                    f"{len(seq.out)} of {seq.max_new} tokens — partial "
                    f"output and a resume snapshot ride the error"),
                    stat="failed")
                return False
            self._bump("salvage_retries")
        try:
            _fault.fire("generate.salvage")
        except Exception as sexc:   # noqa: BLE001 — salvage path faulted
            self._retire(seq, self._terminal(
                seq, sexc, f"{self._name}: salvage of sequence {seq.rid} "
                f"failed — resolving with partial output"), stat="failed")
            return False
        self._vacate(seq)
        seq.cached = 0
        seq.replay = []
        self._bump("tokens_salvaged", len(seq.out))
        self._journal_event("gen_snapshot", rid=seq.rid, out=list(seq.out))
        if seq.req.trace is not None:
            _telemetry.end_span(seq.req, "prefill")
            _telemetry.end_span(seq.req, "handoff")
            _telemetry.span_event(seq.req, "salvage",
                                  tokens_salvaged=len(seq.out),
                                  retry=seq.salvage)
            _telemetry.open_span(seq.req, "queue", requeued=True)
        with self._admit_lock:
            self._pending.appendleft(seq)
        return True

    def _salvage_seated(self, err, budgeted=True):
        """Requeue every seated sequence with its tokens intact (a failed
        step, or a breaker fast-fail).  The pools need no recovery: the
        steps update them in place, a failed step leaves them standing,
        and the requeued sequences re-prefill."""
        for seq in list(self._seqs.values()):
            self._requeue_salvaged(seq, err, budgeted=budgeted)

    def _step_spans(self):
        """Push the seated sequences' decode spans as the current spans
        (fault firings become span events); returns whether it did."""
        dspans = []
        for seq in self._seqs.values():
            if seq.req.trace is not None:
                sp = _telemetry.get_span(seq.req, "decode")
                if sp is not None:
                    dspans.append(sp)
        if dspans:
            _telemetry.push_current(dspans)
        return bool(dspans)

    def _prepare_step(self, lookahead):
        """Capacity and breaker before a decode or verify step: the CoW
        lanes re-armed, pages for every seated sequence's writes (oldest
        first: seniors claim pages, evicting juniors if the pool is dry,
        before juniors decide whether to yield).  Returns False when no
        step runs."""
        self._cow_src[:] = 0        # fault lanes re-arm per step
        self._cow_dst[:] = 0
        try:
            for seq in sorted(self._seqs.values(), key=lambda s: s.stamp):
                if seq.slot is None:
                    continue     # preempted by an earlier neighbour
                self._ensure_capacity(seq, lookahead)
        except PoolExhaustedError as exc:
            # unreachable via admission's worst-case check; resolve
            # rather than wedge if it ever happens
            self._fail_everything(_fault.with_context(
                exc, f"{self._name} page pool wedged"))
            return False
        if not self._seqs:
            return False
        if not self.breaker.allow():
            # breaker fast-fail: salvage, don't destroy — unbudgeted, the
            # open breaker is not this sequence's failure
            self._salvage_seated(CircuitOpenError(
                f"{self._name}: circuit open — fast-failing in-flight "
                f"generation"), budgeted=False)
            return False
        return True

    def _step(self, what, run):
        """Run one decode or verify step ``run()`` under its fault point,
        profiler scope and the sequences' spans; a failure salvages the
        seated sequences against their budgets.  Returns the step's
        outputs, or None when it failed."""
        pushed = self._step_spans()
        try:
            _fault.fire("generate.decode")
            with _profiler.scope(f"{self._name}.{what}", cat="serving"):
                return run()
        except Exception as exc:    # noqa: BLE001 — resolved per sequence
            self.breaker.record_failure()
            self._note_step_failure(exc)
            self._salvage_seated(_fault.with_context(
                exc, f"{self._name} {what} step over "
                f"{len(self._seqs)} sequences"))
            return None
        finally:
            if pushed:
                _telemetry.pop_current()

    def _decode_once(self):
        """One token for every in-flight sequence: capacity, the decode
        step, then per-slot retirement/advance."""
        if not self._prepare_step(0):
            return
        nxt = self._step("decode", self._run_decode)
        if nxt is None:
            return
        self.breaker.record_success()
        self._bump("decode_steps")
        for seq in list(self._seqs.values()):
            seq.cached += 1          # this step wrote the input token
            if seq.replay:
                # resume replay: advance the slot from the record —
                # never re-append to seq.out
                tok = seq.replay.pop(0)
                self._tokens[seq.slot] = tok
                self._lengths[seq.slot] = seq.cached
                continue
            self._finish_token(seq, int(nxt[seq.slot]))
        self._journal_tick()

    def _verify_once(self):
        """One SPECULATIVE step for every in-flight sequence: capacity
        with ``spec_k`` lookahead, the verify step, then 1..spec_k + 1
        accepted tokens per slot.  The same failure, breaker and span
        semantics (and fault point) as ``_decode_once``."""
        if not self._prepare_step(self._spec_k):
            return
        res = self._step("verify", self._run_verify)
        if res is None:
            return
        emitted, n_acc = res
        self.breaker.record_success()
        self._bump("decode_steps")
        self._bump("verify_steps")
        k = self._spec_k
        for seq in list(self._seqs.values()):
            s = seq.slot
            if seq.replay:
                # resume replay: one recorded token per step, no
                # speculative accounting (the draft window stops at the
                # pending position)
                seq.cached += 1
                self._tokens[s] = seq.replay.pop(0)
                self._lengths[s] = seq.cached
                self._refresh_window(seq)
                continue
            a = int(n_acc[s])
            self._bump("spec_proposed", k)
            self._bump("spec_accepted", a)
            self._h_accept.observe(a / k)
            # positions 0..a hold real K/V (pending + accepted drafts);
            # emitted[a] is the correction/bonus, the next pending token
            for j in range(a + 1):
                seq.cached += 1
                if self._finish_token(seq, int(emitted[s, j])):
                    break
            else:
                self._refresh_window(seq)
        self._journal_tick()

    def _export_error(self, seq):
        """Export one sequence (handoff drain): its snapshot goes to
        ``exported`` and the journal (``gen_handoff``), and rides — with
        the partial tokens — the ``ServerClosedError`` its request
        resolves with, for a successor to resume token-exact."""
        snap = self._snapshot_of(seq)
        self.exported.append(snap)
        self._journal_event("gen_handoff", **snap.to_json())
        self._bump("handoff_exports")
        err = ServerClosedError(
            f"{self._name}: drained with handoff after {len(seq.out)} "
            f"of {seq.max_new} tokens — resume snapshot exported")
        err.tokens_generated = len(seq.out)
        err.partial_tokens = [int(t) for t in seq.out]
        err.snapshot = snap
        return err

    def _export_all(self):
        """Handoff-drain sweep: every accepted sequence still alive —
        seated or queued — exports instead of finishing.  The
        disaggregated pipeline's residue is swept by ``_fail_residue``,
        which exports it the same way in handoff mode."""
        for seq in list(self._seqs.values()):
            self._retire(seq, self._export_error(seq), stat="failed")
        with self._admit_lock:
            residue = list(self._pending)
            self._pending.clear()
        for seq in residue:
            self._retire(seq, self._export_error(seq), stat="failed")

    def _fail_everything(self, err, queued=True):
        """Explicitly resolve every in-flight (and optionally queued)
        sequence with ``err`` — nothing is silently dropped."""
        for seq in list(self._seqs.values()):
            self._retire(seq, err, stat="failed")
        if not queued:
            return
        with self._admit_lock:
            residue = list(self._pending)
            self._pending.clear()
        for seq in residue:
            self._retire(seq, err, stat="failed")

    def _fail_residue(self):
        """Loop-exit sweep (a clean drain leaves nothing; a crashed loop
        may): every accepted-but-unresolved sequence gets an explicit
        terminal error (an export in handoff mode) — wherever it was
        parked, the disaggregated prefill queue, flight, handoff queue
        and backlog included (the caller joined the workers first, so
        these have no producer)."""
        residue = list(self._seqs.values())
        self._seqs = {}
        with self._admit_lock:
            residue += list(self._pending)
            self._pending.clear()
        while True:
            try:
                item = self._prefill_q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                residue += list(item)
        while True:
            try:
                residue.append(self._handoff_q.get_nowait()[0])
            except queue.Empty:
                break
        residue += [entry[0] for entry in self._handoff_backlog]
        self._handoff_backlog = []
        with self._lock:
            flight = list(self._prefill_flight.values())
            self._prefill_flight = {}
        for group in flight:
            residue += list(group)
        for seq in residue:
            if seq.slot is not None:
                seq.slot = None
                self._bump("active_slots", -1)
            if seq.req.done():
                continue
            if seq.pages:
                self._release(seq.pages)
                seq.pages = []
                seq.shared_n = 0
            if self._handoff_exit.is_set():
                seq.req.set_error(self._export_error(seq))
            else:
                seq.req.set_error(ServerClosedError(
                    "server stopped before this sequence finished"))
            self._bump("failed")
            self._bump("retired")

    # ---------------------------------------------------------------- health --
    def alive(self):
        return self._thread.is_alive()

    def ready(self):
        return (self._ready.is_set() and self.alive()
                and not self._draining.is_set()
                and not self.breaker.engaged())

    def healthz(self):
        """Router-rankable snapshot (the JAX server's keys, minus those
        of the features not ported): breaker state, queue depth,
        in-flight and seated counts, page gauges, the disaggregation
        gauges (``prefill_workers``, ``prefill_inflight``: groups a
        worker holds), per-class SLO rows (``classes``), last error.
        Non-blocking."""
        with self._admit_lock:
            depth = len(self._pending)
        with self._lock:
            s = self._stats
            in_flight = (s["admitted"] - s["completed"] - s["failed"]
                         - s["expired"])
            active = s["active_slots"]
            last = self._last_error
            prefill_flight = len(self._prefill_flight)
        return {"alive": self.alive(), "ready": self.ready(),
                "draining": self._draining.is_set(),
                "breaker": self.breaker.state,
                "breaker_state": self.breaker.state_code(),
                "queue_depth": depth,
                "in_flight": max(0, in_flight),
                "active_slots": active,
                "free_pages": self.alloc.free_count(),
                "total_pages": self.alloc.allocatable,
                "pages_shared": self.alloc.shared_pages(),
                "speculative": int(self._verify is not None),
                "prefill_workers": self._n_prefill_workers,
                "prefill_inflight": prefill_flight,
                "tp_shards": self.tp_shards,
                "tp_collectives": self.tp_collectives,
                "device": str(self.device),
                "classes": self._qos.snapshot(),
                "last_error": None if last is None else
                {"type": last[0], "age": time.monotonic() - last[1]}}

    def _page_bytes(self):
        """Device bytes one page id addresses across BOTH pools on this
        rank (f32 K + V, every layer, its heads)."""
        c = self.config
        return (2 * c.n_layers * self.alloc.page_size
                * (c.n_heads // self.tp_shards) * c.head_dim * 4)

    @property
    def stats(self):
        with self._lock:
            out = dict(self._stats)
        out["free_pages"] = self.alloc.free_count()
        out["pages_shared"] = self.alloc.shared_pages()
        out["breaker"] = self.breaker.state
        return out

    def stamp_memory_report(self, report):
        """Stamp a memory report (``argument_bytes`` / ``peak_bytes`` /
        ``per_device``) onto this server's ``mem_*`` gauges."""
        self._mem_gauges = _telemetry.memory_gauges(report)
        return self._mem_gauges

    def telemetry(self, fmt="json"):
        """The metrics exposition (``telemetry.exposition``'s schema):
        lifecycle counters, paging and sharing gauges, the per-phase
        span histograms and ``slot_pages``/``spec_accept_rate``, and the
        per-class SLO rows.  ``fmt="prom"`` renders Prometheus text."""
        h = self.healthz()
        with self._lock:
            counters = dict(self._stats)
        counters.pop("active_slots", None)     # a gauge, reported below
        gauges = {"queue_depth": h["queue_depth"],
                  "in_flight": h["in_flight"],
                  "breaker_state": h["breaker_state"],
                  "active_slots": h["active_slots"],
                  "free_pages": h["free_pages"],
                  "used_pages": h["total_pages"] - h["free_pages"],
                  "total_pages": h["total_pages"],
                  "pages_shared": h["pages_shared"],
                  "pages_cow_faults": counters.get("cow_faults", 0),
                  "bytes_saved_by_sharing":
                      self.alloc.extra_refs() * self._page_bytes(),
                  "spec_k": self._spec_k if self._verify is not None
                      else 0,
                  "resume_prefill_pages_remapped":
                      counters.get("resume_pages_remapped", 0),
                  "prefill_workers": h["prefill_workers"],
                  "prefill_inflight": h["prefill_inflight"],
                  "ready": int(h["ready"]), "alive": int(h["alive"]),
                  "draining": int(h["draining"])}
        gauges.update(_telemetry.compile_gauges(self._name))
        gauges.update(self._mem_gauges)
        gauges.update(_telemetry.ckpt_gauges())
        snap = _telemetry.registry().snapshot(prefix=f"{self._name}::")
        for k, v in snap["gauges"].items():
            gauges.setdefault(k, v)
        hist = snap["histograms"]
        for cname, csnap in self._qos.latency_snapshots().items():
            hist[f"class_{cname}_latency_s"] = csnap
        payload = _telemetry.exposition("generation_server", self._name,
                                        counters, gauges, hist,
                                        h["classes"])
        return _telemetry.render(payload, fmt)

    # ----------------------------------------------------------------- drain --
    def drain(self, timeout=None, handoff=False):
        """Graceful shutdown: stop admitting (submits raise
        ``ServerClosedError``), finish EVERY accepted sequence — queued
        ones included — then stop the loop.  After ``drain()`` every
        ``Request`` ever returned is ``done()``.  True when the loop
        exited in time.

        ``handoff=True``: instead of finishing, EXPORT every unfinished
        sequence as a ``SequenceSnapshot`` — into ``self.exported`` and
        the journal (``gen_handoff``) — and resolve its request with a
        ``ServerClosedError`` carrying the snapshot and partial tokens;
        a successor completes them token-exact (``submit_resume`` /
        ``restore_journal``)."""
        if handoff:
            self._handoff_exit.set()
        self._draining.set()
        self._ready.clear()
        with self._admit_lock:
            self._stop.set()
        if self._started.is_set():
            self._thread.join(timeout)
            if self._pf_thread is not None:
                self._pf_thread.join(timeout)
        if not self._thread.is_alive():
            self._fail_residue()
        return not self._thread.is_alive()

    close = drain

    def serve_forever(self, poll=0.05, handoff=False):
        """Block until SIGTERM/SIGINT (``fault.GracefulExit``), then
        drain (``handoff=True``: export unfinished work instead)."""
        with _fault.GracefulExit() as g:
            while not g.requested and self.alive():
                time.sleep(poll)
        return self.drain(handoff=handoff)
