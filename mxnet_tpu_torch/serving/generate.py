"""Continuous-batching LLM serving: paged KV cache + fixed-shape decode.

The port of ``mxnet_tpu/serving/generate.py`` (its single-device core).
An autoregressive LM batches at the token level: sequences join and
leave the in-flight batch at every decode step.

- **Paged KV cache** — one fixed pool ``[n_layers, n_pages, page_size,
  heads, head_dim]`` per K and V; sequences hold pages through a page
  table and a host-side free list (``PageAllocator``).  The pools are
  **updated in place**: where the JAX programs donate them and return
  new ones, the port's prefill and decode steps write into the tensors
  they are given and return the same objects.
- **One fixed-shape decode step** — every decode step, whatever the mix
  of sequence lengths and sampling modes, runs the same step over the
  fixed slot grid; slot mask, page table and lengths are arguments.
  Attention over the pages is the hand-written CUDA kernel on the card
  (``ops.paged_decode_attention``) and its plain version on the CPU.
- **Continuous-batching scheduler** (``GenerationServer``) — prompts
  prefill through ``BucketSpec`` length buckets (each warmed up before
  readiness), sequences are seated in fixed decode slots, retire per step
  on EOS/max-tokens/deadline (pages freed and queued sequences admitted
  the same step), and pool exhaustion preempts the youngest sequence
  back onto the queue with its tokens kept; it resumes by re-prefilling
  prompt + generated and continues the same stream.

Sampling is greedy (``temperature == 0``) or temperature/top-k.  The
noise for a token is a pure function of (sequence seed, absolute
position, vocabulary index) — never of slot or step — in Gumbel-max
form (``_sample_tokens``): a plain-PyTorch port of the JAX server's
draw, ``categorical(fold_in(PRNGKey(seed), position), logits)`` with
threefry-2x32 bits computed in int64 tensors, so seeded samples are the
JAX server's tokens and preemption and resume repeat them.

Left for later slices (constructor arguments absent here): tensor
parallelism, disaggregated prefill, speculative decoding, prefix sharing
with copy-on-write (the decode step keeps its inert CoW lanes), QoS
classes, the decode journal, snapshots and resume across servers, and
salvage of a failed step's sequences (a failed step here resolves them
with the error).

Fault points ``generate.prefill`` / ``generate.decode`` /
``generate.evict`` fire where the JAX server fires them.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from .. import fault as _fault
from .. import profiler as _profiler
from ..context import resolve_device
from ..gluon.model_zoo.causal_lm import (decode_hidden, lm_logits,
                                         prefill_forward)
from ..ops.paged_attention import (dense_decode_attention,
                                   paged_decode_attention)
from .admission import (CircuitOpenError, DeadlineExceededError,
                        RejectedError, Request, ServerClosedError,
                        TokenBucket)
from .batcher import BucketSpec
from .breaker import CircuitBreaker

__all__ = ["PageAllocator", "PoolExhaustedError", "GenerationServer",
           "build_decode_step", "build_prefill_step",
           "build_dense_decode_step", "decode_logits"]


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
    refcount 1, ``share`` maps additional holders onto live pages, and
    ``free`` decrements — a page returns to the free list only when its
    LAST holder lets go.  ``free`` on a page that is not live
    (double-free, or an id never allocated) raises ``ValueError``
    instead of silently corrupting the free list."""

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
            return []
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
        Raises ``ValueError`` on a page that is not live."""
        with self._lock:
            for p in pages:
                if p not in self._refs:
                    raise ValueError(
                        f"PageAllocator.share: page {p} is not live")
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

    def live_pages(self):
        """Count of live (allocated, refcount >= 1) pages."""
        with self._lock:
            return len(self._refs)

    def free(self, pages):
        """Drop one holder from each of ``pages``; a page whose LAST
        holder lets go returns to the LIFO free list.  Returns the pages
        actually released.  A page with no live refcount raises
        ``ValueError`` with nothing freed."""
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


def _position_keys(seeds, positions):
    """Row ``i``'s key ``fold_in(PRNGKey(seeds[i]), positions[i])`` as
    the JAX server derives it, as two int64 tensors of uint32 words.
    ``PRNGKey`` of a 32-bit seed is the word pair ``(0, seed)``;
    ``fold_in(key, p)`` hashes the counter ``(0, p)`` under ``key``."""
    seeds = seeds.to(torch.int64) & _M32
    positions = positions.to(torch.int64) & _M32
    return _threefry2x32(torch.zeros_like(seeds), seeds,
                         torch.zeros_like(positions), positions)


def _random_bits(keys, vocab):
    """``jax.random.bits(key, (vocab,))`` per row, uint32 values in int64
    ``[rows, vocab]``: with ``jax_threefry_partitionable`` (JAX's default)
    element ``j`` hashes the counter ``(0, j)`` and xors the two words."""
    k0, k1 = keys
    idx = torch.arange(vocab, dtype=torch.int64, device=k0.device)
    y0, y1 = _threefry2x32(k0[:, None], k1[:, None],
                           torch.zeros_like(idx)[None, :], idx[None, :])
    return y0 ^ y1


def _uniform(bits):
    """``jax.random.uniform(minval=tiny, maxval=1)`` in float32 from
    uint32 bits: the top 23 bits become the mantissa of a float in
    ``[1, 2)``, minus one, scaled by ``1 - tiny`` (exactly 1.0 in
    float32, so left out), plus ``tiny``, and floored at ``tiny``."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    return torch.clamp_min(floats + _F32_TINY, _F32_TINY)


def _gumbel_noise(seeds, positions, vocab):
    """Gumbel(0, 1) noise ``[rows, vocab]`` equal to what the JAX
    server's ``jax.random.categorical`` adds to the logits of row ``i``:
    ``gumbel(fold_in(PRNGKey(seeds[i]), positions[i]), (vocab,))`` in its
    default "low" mode, ``-log(-log(u))``.  The bits are JAX's bit for
    bit; the two ``log``s are the device's, which may differ from XLA's
    in the last place."""
    u = _uniform(_random_bits(_position_keys(seeds, positions), vocab))
    return -torch.log(-torch.log(u))


def _scaled_masked(logits, temps, topks):
    """Temperature-scaled, top-k-masked logits: ``softmax`` of this is
    each row's sampling distribution (``topks == 0``: no cut)."""
    vocab = logits.shape[-1]
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    order = scaled.sort(dim=-1, descending=True).values
    kidx = (topks.to(torch.int64) - 1).clamp(0, vocab - 1)
    thr = order.gather(1, kidx[:, None])
    cut = (topks[:, None] > 0) & (scaled < thr)
    return torch.where(cut, torch.tensor(_NEG, dtype=scaled.dtype,
                                         device=scaled.device), scaled)


def _sample_tokens(logits, seeds, positions, temps, topks):
    """Per-slot next token: greedy where ``temps == 0``, else a draw
    from ``softmax(_scaled_masked(...))`` by Gumbel-max with the
    position-keyed noise of ``_gumbel_noise``, as
    ``jax.random.categorical`` draws.  An all-greedy batch skips the
    noise; otherwise both arms compute, so a mixed greedy/sampling batch
    is one fixed-shape step.
    ``argmax`` takes the first maximum, as ``jnp.argmax`` does."""
    greedy = logits.argmax(dim=-1)
    if not bool((temps > 0.0).any()):      # one host sync: an all-greedy
        return greedy.to(torch.int32)      # batch draws no noise
    masked = _scaled_masked(logits, temps, topks)
    noise = _gumbel_noise(seeds, positions, logits.shape[-1])
    drawn = (masked + noise).argmax(dim=-1)
    return torch.where(temps > 0.0, drawn, greedy).to(torch.int32)


# ------------------------------------------------------------------ steps --
def decode_logits(params, config, page_size, k_pool, v_pool, tokens,
                  lengths, active, tables, attention=None):
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
    hold the kernel against it."""
    attention = paged_decode_attention if attention is None else attention
    slots = tokens.shape[0]
    heads, head_dim = config.n_heads, config.head_dim
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
        h = decode_hidden(params, layer, h, attend)
    return lm_logits(params, h)


def build_decode_step(config, page_size, attention=None):
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
    copy-on-write lanes of the JAX signature: page ``cow_src[s]`` is
    copied onto ``cow_dst[s]`` in both pools first; the server passes
    ``(0, 0)`` everywhere, an inert self-copy of the sink page (prefix
    sharing is not ported yet).  ``attention`` as in
    ``decode_logits``."""

    def decode_step(params, k_pool, v_pool, tokens, lengths, active,
                    tables, cow_src, cow_dst, seeds, temps, topks):
        # gather first, then write: a lane reads the pre-step page
        k_pool[:, cow_dst.long()] = k_pool[:, cow_src.long()]
        v_pool[:, cow_dst.long()] = v_pool[:, cow_src.long()]
        logits = decode_logits(params, config, page_size, k_pool, v_pool,
                               tokens, lengths, active, tables,
                               attention=attention)
        nxt = _sample_tokens(logits, seeds, lengths + 1, temps, topks)
        return nxt, k_pool, v_pool

    return decode_step


def build_prefill_step(config, page_size):
    """One prefill step for any ``(batch, length)`` bucket: the whole
    prompt forward (``causal_lm.prefill_forward``), K/V scattered **in
    place** into the paged pools by page table, and the FIRST new token
    sampled (absolute position ``lengths[i]``).  Padded rows/positions
    sink their writes to page 0 (the only place duplicate writes land);
    a block index past the table is clamped, as a JAX gather clamps
    it.

    Signature: ``(params, k_pool, v_pool, tokens[b, L], lengths[b],
    active[b], tables[b, P], seeds[b], temps[b], topks[b])`` →
    ``(first[b] int32, k_pool, v_pool)``."""

    def prefill_step(params, k_pool, v_pool, tokens, lengths, active,
                     tables, seeds, temps, topks):
        b, L = tokens.shape
        logits, k_all, v_all = prefill_forward(params, config, tokens,
                                               lengths)
        pos = torch.arange(L, device=tokens.device)
        valid = (pos[None, :] < lengths[:, None]) & active[:, None]
        blk = (pos // page_size).clamp(0, tables.shape[1] - 1)
        page = torch.where(valid, tables.long()[:, blk], 0)     # [b, L]
        off = (pos % page_size)[None, :].expand(b, L)
        for layer in range(config.n_layers):
            k_pool[layer, page, off] = k_all[layer]
            v_pool[layer, page, off] = v_all[layer]
        first = _sample_tokens(logits, seeds, lengths, temps, topks)
        return first, k_pool, v_pool

    return prefill_step


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


# ---------------------------------------------------------------- scheduler --
class _Seq:
    """Decode-loop-private state of one admitted sequence."""

    __slots__ = ("req", "prompt", "max_new", "temp", "top_k", "slot",
                 "pages", "cached", "out", "stamp", "ran", "seed", "rid",
                 "replay")

    def __init__(self, req, prompt, max_new, temp, top_k):
        self.req = req
        self.prompt = prompt
        self.max_new = max_new
        self.temp = temp
        self.top_k = top_k
        self.slot = None
        self.pages = []
        self.cached = 0          # tokens whose K/V is in the pool
        self.out = []            # generated token ids (EOS excluded)
        self.stamp = 0.0         # admission order — eviction picks youngest
        self.ran = False         # ever prefilled (survives preemption)
        self.seed = 0            # per-sequence sampling seed
        self.rid = -1            # admission ordinal
        self.replay = []         # recorded tokens still to force post-resume


class GenerationServer:
    """Continuous-batching autoregressive generation server.

    Lifecycle: construct → ``start()`` (allocates the pools on the
    device and warms up every prefill bucket and the decode step) →
    ``submit()``/``__call__`` → ``drain()`` or ``serve_forever()``.
    ``submit`` returns a ``Request`` future resolving to the generated
    token ids (``np.int32``, EOS excluded) or an explicit error.

    ``params`` is the causal LM's param dict (tensors or arrays; e.g.
    ``causal_lm.params_from_jax`` of a JAX param dict); it is moved to
    ``device`` as float32.  ``device`` defaults to ``"cuda"``: without a
    card the constructor raises unless ``device="cpu"`` is asked for.

    One decode loop thread owns all device state (pools, slot arrays,
    allocator traffic); client threads touch only the admission deque,
    the lock-guarded stats and ``Request`` futures.

    Profiler series: ``<name>::tokens_out``, ``<name>::page_occupancy``
    (percent of allocatable pages held), ``<name>::preempted``,
    ``<name>::retired``.
    """

    _IDLE_TICK = 0.005

    def __init__(self, params, config, *, buckets=None, n_slots=8,
                 n_pages=64, page_size=16, max_context=None,
                 max_queue=128, rate=None, burst=None, breaker=None,
                 default_deadline=None, max_new_tokens=32, eos_id=None,
                 seed=0, device="cuda", name="GenerationServer"):
        self.device = resolve_device(device)
        self.config = config
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
        # the default generation budget (a configuration constant)
        if max_context is None:
            max_context = max(self.buckets.length) + int(max_new_tokens)
        if max_context < max(self.buckets.length) + 1:
            raise ValueError(
                f"{name}: max_context {max_context} cannot hold the "
                f"largest length bucket {max(self.buckets.length)} plus "
                f"one generated token")
        self.pages_per_seq = self.alloc.pages_for(max_context)
        self.max_context = self.pages_per_seq * self.alloc.page_size
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self._limiter = None if rate is None else TokenBucket(rate, burst)
        self._default_deadline = default_deadline
        self._max_new = int(max_new_tokens)
        self._eos = None if eos_id is None else int(eos_id)
        self._name = name
        self._max_queue = int(max_queue)

        self._params = {
            k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v, dtype=np.float32)))
            .to(device=self.device, dtype=torch.float32)
            for k, v in params.items()}
        self._decode = build_decode_step(config, self.alloc.page_size)
        self._prefill = build_prefill_step(config, self.alloc.page_size)
        # the server seed only salts the per-sequence seed derivation
        # (admission ordinal → splitmix); sampling noise is a pure
        # function of (sequence seed, token position)
        self._seed_root = int(seed) & 0xFFFFFFFFFFFFFFFF
        self._admit_ord = 0                 # _admit_lock-guarded

        # decode-loop-private device + slot state (pools made in start())
        self._k_pool = self._v_pool = None
        self._seqs = {}                                  # slot -> _Seq
        self._tokens = np.zeros((self.n_slots,), np.int32)
        self._lengths = np.zeros((self.n_slots,), np.int32)
        self._active = np.zeros((self.n_slots,), bool)
        self._tables = np.zeros((self.n_slots, self.pages_per_seq),
                                np.int32)
        self._temps = np.zeros((self.n_slots,), np.float32)
        self._topks = np.zeros((self.n_slots,), np.int32)
        self._seeds = np.zeros((self.n_slots,), np.int64)
        # CoW lanes of the decode signature: always (0, 0), inert
        self._cow = np.zeros((self.n_slots,), np.int32)

        self._pending = collections.deque()
        self._admit_lock = threading.Lock()
        self._lock = threading.Lock()
        self._stats = {"admitted": 0, "completed": 0, "failed": 0,
                       "expired": 0, "rejected": 0, "retired": 0,
                       "preempted": 0, "tokens_out": 0, "prefills": 0,
                       "decode_steps": 0, "active_slots": 0,
                       "tokens_salvaged": 0, "resumes": 0}
        self._last_error = None
        self._ready = threading.Event()
        self._draining = threading.Event()
        self._stop = threading.Event()
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._c_tokens = _profiler.Counter(None, f"{name}::tokens_out")
        self._c_pages = _profiler.Counter(None, f"{name}::page_occupancy")
        self._c_preempted = _profiler.Counter(None, f"{name}::preempted")
        self._c_retired = _profiler.Counter(None, f"{name}::retired")

    # ------------------------------------------------------------ lifecycle --
    def start(self, warmup=True):
        """Allocate the zeroed pools on the device and (by default) run
        every prefill bucket shape plus the decode step once with inert
        all-inactive arguments (writes sink to page 0, the allocator is
        untouched) before readiness flips — on the card this also builds
        and loads the attention kernel."""
        if self._draining.is_set():
            raise ServerClosedError(f"{self._name}: already drained")
        c, npg, psz = self.config, self.alloc.n_pages, self.alloc.page_size
        shape = (c.n_layers, npg, psz, c.n_heads, c.head_dim)
        self._k_pool = torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)
        self._v_pool = torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)
        if warmup:
            for b in self.buckets.batch:
                for L in self.buckets.length:
                    self._run_prefill(
                        np.zeros((b, L), np.int32),
                        np.zeros((b,), np.int32),
                        np.zeros((b,), bool),
                        np.zeros((b, self.pages_per_seq), np.int32),
                        np.zeros((b,), np.int64),
                        np.zeros((b,), np.float32),
                        np.zeros((b,), np.int32))
            self._run_decode()
        self._started.set()
        self._thread.start()
        self._ready.set()
        return self

    def __enter__(self):
        if not self._started.is_set():
            self.start()
        return self

    def __exit__(self, *exc):
        self.drain()
        return False

    # ------------------------------------------------------------ admission --
    def submit(self, tokens, *, max_new_tokens=None, temperature=0.0,
               top_k=0, deadline=None, seed=None):
        """Admit one prompt; returns a ``Request`` future resolving to
        the generated ``np.int32`` token ids (EOS excluded).

        ``seed`` pins this sequence's sampling seed (any uint32); by
        default it derives from the server seed and the admission
        ordinal.

        Refusals are immediate and explicit: ``ServerClosedError``
        draining, ``CircuitOpenError`` fast-fail, ``RejectedError`` for
        rate limit / full queue / a prompt no length bucket holds / a
        worst case that could never fit the page pool.  None of them
        touched the device."""
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
            if n + max_new > self.max_context:
                raise RejectedError(
                    f"prompt {n} + max_new_tokens {max_new} exceeds the "
                    f"page capacity {self.max_context} per sequence")
            if self.alloc.pages_for(n + max_new) > self.alloc.allocatable:
                raise RejectedError(
                    f"worst case needs {self.alloc.pages_for(n + max_new)}"
                    f" pages, pool holds {self.alloc.allocatable} — this "
                    f"request could never be served")
        except RejectedError:
            self._bump("rejected")
            raise
        if deadline is None:
            deadline = self._default_deadline
        if self._limiter is not None and not self._limiter.try_acquire():
            self._bump("rejected")
            raise RejectedError(f"{self._name}: rate limit exceeded — "
                                f"shedding")
        req = Request((prompt,), deadline=deadline)
        seq = _Seq(req, prompt, max_new, float(temperature), int(top_k))
        seq.stamp = time.monotonic()
        with self._admit_lock:
            admitted = not self._stop.is_set() \
                and len(self._pending) < self._max_queue
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
            self._bump("rejected")
            if stopped:
                raise ServerClosedError(f"{self._name}: draining — "
                                        f"not admitting")
            raise RejectedError(f"{self._name}: request queue full "
                                f"({self._max_queue}) — shedding")
        self._bump("admitted")
        return req

    def __call__(self, tokens, timeout=None, **kw):
        """Blocking convenience: submit + ``result()``."""
        return self.submit(tokens, **kw).result(timeout)

    def _bump(self, key, n=1):
        with self._lock:
            self._stats[key] += n

    def _note_step_failure(self, exc):
        with self._lock:
            self._last_error = (type(exc).__name__, time.monotonic())

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

    def _dev(self, arr):
        """Host array → tensor on the server's device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _run_prefill(self, tokens, lengths, active, tables, seeds, temps,
                     topks):
        """One prefill step (pools updated in place); returns the
        first sampled tokens on the host."""
        with torch.no_grad():
            first, _, _ = self._prefill(
                self._params, self._k_pool, self._v_pool, self._dev(tokens),
                self._dev(lengths), self._dev(active), self._dev(tables),
                self._dev(seeds), self._dev(temps), self._dev(topks))
            return first.cpu().numpy()

    def _run_decode(self):
        """One decode step over the full slot grid (pools updated in
        place); returns the next tokens on the host."""
        with torch.no_grad():
            nxt, _, _ = self._decode(
                self._params, self._k_pool, self._v_pool,
                self._dev(self._tokens), self._dev(self._lengths),
                self._dev(self._active), self._dev(self._tables),
                self._dev(self._cow), self._dev(self._cow),
                self._dev(self._seeds), self._dev(self._temps),
                self._dev(self._topks))
            return nxt.cpu().numpy()

    def _loop(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while True:
                if self._stop.is_set() and not self._seqs \
                        and not self._pending:
                    return
                worked = self._retire_expired()
                if self._draining.is_set() and self.breaker.engaged():
                    # drain must terminate: an open breaker during drain
                    # cannot half-open through traffic it refuses, so
                    # everything still accepted resolves explicitly now
                    self._fail_everything(CircuitOpenError(
                        f"{self._name}: circuit open during drain — "
                        f"fast-failing accepted work"))
                    return
                worked = self._admit() or worked
                if self._seqs:
                    self._decode_once()
                    worked = True
                if not worked and not self._seqs:
                    time.sleep(self._IDLE_TICK)
        finally:
            with self._admit_lock:
                self._stop.set()
            self._fail_residue()

    # ---- retirement ----
    def _vacate(self, seq):
        """Release a sequence's slot + pages (no request resolution)."""
        if seq.slot is not None:
            s = seq.slot
            self._bump("active_slots", -1)
            self._active[s] = False
            self._lengths[s] = 0
            self._tokens[s] = 0
            self._tables[s, :] = 0
            self._temps[s] = 0.0
            self._topks[s] = 0
            self._seqs.pop(s, None)
            seq.slot = None
        if seq.pages:
            self.alloc.free(seq.pages)
            seq.pages = []
        self._note_occupancy()

    def _note_occupancy(self):
        total = self.alloc.allocatable
        held = total - self.alloc.free_count()
        self._c_pages.set_value(int(100 * held / total))

    def _retire(self, seq, error=None, stat="completed"):
        """Terminal retirement: vacate, resolve the future, account."""
        self._vacate(seq)
        if error is None:
            seq.req.set_result(np.asarray(seq.out, np.int32))
        else:
            seq.req.set_error(error)
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
        bucket grid.  Fresh sequence: the prompt.  Resumed after
        preemption (``seq.out`` non-empty): prompt + generated-so-far
        minus the pending token, capped at the largest length bucket;
        the overflow tail becomes ``seq.replay``, forced one token per
        step through the decode step."""
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

    def _take_prefill_group(self):
        """Pop one same-length-bucket group of queued sequences, oldest
        admission first, capped by free slots and budgeted against free
        pages.  Returns [] when nothing can start."""
        limit = min(len(self._free_slots()), self.buckets.max_batch)
        if limit == 0:
            return []
        with self._admit_lock:
            if not self._pending:
                return []
            ordered = sorted(self._pending, key=lambda s: s.stamp)
            bucket = self._bucket_len(self._prefill_len(ordered[0]))
            group, budget = [], self.alloc.free_count()
            for seq in ordered:
                if len(group) >= limit:
                    break
                if self._bucket_len(self._prefill_len(seq)) != bucket:
                    continue
                need = self.alloc.pages_for(self._prefill_len(seq))
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

    def _prefill_group(self, group):
        """Prefill one bucket-aligned group and seat it in decode slots.
        Resumed members run prompt + generated through the same bucket
        shapes; their pending token is forced at seat time."""
        k = len(group)
        bucket = self._bucket_len(max(self._prefill_len(s) for s in group))
        b = self.buckets.batch_bucket(k)
        slots = self._free_slots()[:k]
        try:
            for seq in group:
                seq.pages = self.alloc.alloc(
                    self.alloc.pages_for(self._prefill_len(seq)))
        except PoolExhaustedError:
            # _take_prefill_group budgeted against the free count and
            # nothing else allocates; defensive re-queue
            for seq in group:
                self._vacate(seq)
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
            tables[i, :len(seq.pages)] = seq.pages
            seeds[i] = seq.seed
            temps[i] = seq.temp
            topks[i] = seq.top_k
        try:
            _fault.fire("generate.prefill")
            with _profiler.scope(f"{self._name}.prefill", cat="serving"):
                first = self._run_prefill(tokens, lengths, active, tables,
                                          seeds, temps, topks)
        except Exception as exc:    # noqa: BLE001 — resolved per sequence
            self.breaker.record_failure()
            self._note_step_failure(exc)
            err = _fault.with_context(exc, f"{self._name} prefill of {k}")
            for seq in group:
                self._retire(seq, err, stat="failed")
            return
        self.breaker.record_success()
        self._bump("prefills")
        for i, seq in enumerate(group):
            self._seat(seq, slots[i], int(first[i]))
        self._note_occupancy()

    def _seat(self, seq, slot, tok):
        """Seat one prefilled sequence in a decode slot.  A RESUMED
        sequence (``seq.out`` non-empty) re-enters after its re-prefill
        covered ``full[:H]`` (``full`` = prompt ++ generated,
        ``H = _prefill_len``): the pending token is forced to the
        recorded ``full[H]``, recorded tokens past ``H`` replay one per
        step, and only then does sampling continue."""
        seq.cached = seq.prompt.shape[0]
        seq.ran = True
        s = seq.slot = slot
        self._seqs[s] = seq
        self._bump("active_slots")
        self._tables[s, :] = 0
        self._tables[s, :len(seq.pages)] = seq.pages
        self._temps[s] = seq.temp
        self._topks[s] = seq.top_k
        self._seeds[s] = seq.seed
        self._active[s] = True
        if seq.out:
            full = np.concatenate([seq.prompt,
                                   np.asarray(seq.out, np.int32)])
            H = self._prefill_len(seq)
            seq.cached = H
            seq.replay = [int(t) for t in full[H + 1:]]
            self._tokens[s] = int(full[H])
            self._lengths[s] = H
            self._bump("resumes")
            return
        self._finish_token(seq, tok)

    def _finish_token(self, seq, tok):
        """Account one newly generated token; True if the sequence
        retired (EOS or max-tokens).  A continuing sequence's slot state
        advances so the next decode step consumes ``tok``."""
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
    def _ensure_capacity(self, seq):
        """Guarantee a page exists for this step's write position.  When
        the pool is dry, eviction is strictly seniority-ordered: a
        sequence may only preempt YOUNGER neighbours (later admission
        stamp, kept across preemptions); with no younger neighbour it
        yields ITSELF back to the queue.  The oldest in-flight sequence
        is never evicted, which with admission's worst-case-fit check is
        the global progress guarantee.  Returns False when ``seq``
        yielded."""
        while True:
            try:
                while self.alloc.pages_for(seq.cached + 1) > len(seq.pages):
                    seq.pages.extend(self.alloc.alloc(1))
                    self._tables[seq.slot, len(seq.pages) - 1] = \
                        seq.pages[-1]
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

    def _requeue(self, seq):
        """Vacate a seated sequence and put it back at the FRONT of the
        queue WITH its generated tokens: re-admission re-prefills
        prompt + generated and the position-keyed sampler continues the
        same stream, so it costs latency, never work."""
        self._vacate(seq)
        seq.cached = 0
        seq.replay = []
        if seq.out:
            self._bump("tokens_salvaged", len(seq.out))
        with self._admit_lock:
            self._pending.appendleft(seq)

    def _preempt(self, victim):
        """Evict a sequence to free its pages (pool exhaustion).  The
        request future is untouched: preemption is invisible to the
        client beyond latency."""
        _fault.fire("generate.evict")
        self._requeue(victim)
        self._bump("preempted")
        self._c_preempted.increment()

    def _decode_once(self):
        """One token for every in-flight sequence: capacity, the decode
        step, then per-slot retirement/advance."""
        try:
            # oldest first: seniors claim pages (evicting juniors if the
            # pool is dry) before juniors decide whether to yield
            for seq in sorted(self._seqs.values(), key=lambda s: s.stamp):
                if seq.slot is None:
                    continue     # preempted by an earlier neighbour
                self._ensure_capacity(seq)
        except PoolExhaustedError as exc:
            # unreachable via admission's worst-case check; resolve
            # rather than wedge if it ever happens
            self._fail_everything(_fault.with_context(
                exc, f"{self._name} page pool wedged"))
            return
        if not self._seqs:
            return
        if not self.breaker.allow():
            # breaker fast-fail: seated work goes back to the queue with
            # its tokens and re-seats when the probe succeeds
            for seq in list(self._seqs.values()):
                self._requeue(seq)
            return
        try:
            _fault.fire("generate.decode")
            with _profiler.scope(f"{self._name}.decode", cat="serving"):
                nxt = self._run_decode()
        except Exception as exc:    # noqa: BLE001 — resolved per sequence
            self.breaker.record_failure()
            self._note_step_failure(exc)
            err = _fault.with_context(
                exc, f"{self._name} decode step over "
                f"{len(self._seqs)} sequences")
            self._fail_everything(err, queued=False)
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
        terminal error."""
        residue = list(self._seqs.values())
        self._seqs = {}
        with self._admit_lock:
            residue += list(self._pending)
            self._pending.clear()
        for seq in residue:
            if seq.slot is not None:
                seq.slot = None
                self._bump("active_slots", -1)
            if seq.req.done():
                continue
            if seq.pages:
                self.alloc.free(seq.pages)
                seq.pages = []
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
        """Router-rankable snapshot (the JAX server's keys, minus the
        features not ported): breaker state, queue depth, in-flight and
        seated counts, page gauges, last error.  Non-blocking."""
        with self._admit_lock:
            depth = len(self._pending)
        with self._lock:
            s = self._stats
            in_flight = (s["admitted"] - s["completed"] - s["failed"]
                         - s["expired"])
            active = s["active_slots"]
            last = self._last_error
        return {"alive": self.alive(), "ready": self.ready(),
                "draining": self._draining.is_set(),
                "breaker": self.breaker.state,
                "breaker_state": self.breaker.state_code(),
                "queue_depth": depth,
                "in_flight": max(0, in_flight),
                "active_slots": active,
                "free_pages": self.alloc.free_count(),
                "total_pages": self.alloc.allocatable,
                "device": str(self.device),
                "last_error": None if last is None else
                {"type": last[0], "age": time.monotonic() - last[1]}}

    @property
    def stats(self):
        with self._lock:
            out = dict(self._stats)
        out["free_pages"] = self.alloc.free_count()
        out["breaker"] = self.breaker.state
        return out

    # ----------------------------------------------------------------- drain --
    def drain(self, timeout=None):
        """Graceful shutdown: stop admitting (submits raise
        ``ServerClosedError``), finish EVERY accepted sequence — queued
        ones included — then stop the loop.  After ``drain()`` every
        ``Request`` ever returned is ``done()``.  True when the loop
        exited in time."""
        self._draining.set()
        self._ready.clear()
        with self._admit_lock:
            self._stop.set()
        if self._started.is_set():
            self._thread.join(timeout)
        if not self._thread.is_alive():
            self._fail_residue()
        return not self._thread.is_alive()

    close = drain

    def serve_forever(self, poll=0.05):
        """Block until SIGTERM/SIGINT (``fault.GracefulExit``), then
        drain."""
        with _fault.GracefulExit() as g:
            while not g.requested and self.alive():
                time.sleep(poll)
        return self.drain()
