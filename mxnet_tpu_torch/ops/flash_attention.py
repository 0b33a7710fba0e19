"""Flash attention: ``softmax(scale * Q K^T [causal]) V`` on ``(B*H, S, D)``.

The port of ``mxnet_tpu/ops/pallas/flash_attention.py``.  The forward
returns O and keeps the per-row log-sum-exp ``lse``; the backward
recomputes the probabilities from ``lse`` (``delta = rowsum(O * dO)``
in f32 outside the kernels, as ``_flash_bwd`` computes it), then runs
dQ, then dK/dV.  Attention-probability dropout is drawn inside every
kernel from a counter hash of ``(bh, q position, k position, seed)``
(``_uniform01``, bit for bit the JAX package's), so forward and
backward regenerate the same mask and none is stored; ``lse`` is the
normaliser before dropout, and ``ds`` uses the unmasked ``p``.

Three kernels, each with its plain PyTorch version beside it — the
dense math of the TPU kernel with the same hash mask:

- forward ``_fwd`` (``_fwd_plain``): ``(O in q.dtype, lse)``;
- ``_dq`` (``_dq_plain``): ``dQ`` in q's dtype;
- ``_dkv`` (``_dkv_plain``): ``(dK, dV)`` in k's and v's dtype.

A plain version sums in f32 for f32/bf16 inputs and in f64 for f64
(``acc=torch.float64`` asks for f64 sums of f32/bf16 inputs: a reference
for the kernels on the card); ``lse`` and ``delta`` are in that type.

Which body runs is decided by where the tensors lie, never by a
fallback: CPU tensors run the plain versions; CUDA tensors launch the
hand-written kernels of ``ops/cuda/flash_attention.cu`` (float32 or
bfloat16, contiguous, D = 64 or 128; bf16 16-byte aligned) or raise.
In bf16 all three kernels multiply on the tensor cores (``p`` and ``ds``
as two bf16 pieces each, summed in f32) and read and write their tiles
by TMA; f32 inputs run SIMT f32 bodies.
The kernels read the dropout seed from device memory (a 0-d int32
tensor): ``ops.flash_attention`` passes a fresh one from
``random.next_seed_tensor`` per call, so a captured CUDA graph of a step
draws new masks on every replay; an int seed is written into such a
tensor first.  The plain versions take either.
``flash_attention.launches`` counts kernel launches per kernel
(``"fwd"``, ``"dq"``, ``"dkv"``).  The kernels tile S by 64 and mask the
tail, so S need not divide by any block; ``block_q``/``block_k`` are
accepted for API parity and change nothing (the hash uses absolute
positions).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

__all__ = ["flash_attention", "uniform01", "seed_tensor"]

_NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


# ------------------------------------------------------------ the hash ----
def _mul32(x, c):
    """``(x * c) mod 2**32`` for int64 ``0 <= x < 2**32`` and a uint32
    constant ``c``, in two halves so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def uniform01(h_idx, q_pos, k_pos, seed):
    """``_uniform01`` of the TPU kernels: U[0, 1) per (head, q, k) from a
    SplitMix32-style hash in uint32 arithmetic (wrapping mod 2**32),
    here in int64 tensors masked to 32 bits.  ``h_idx`` is the flattened
    ``b*H + h`` row of ``(B*H, S, D)``; ``seed`` an int32 whose bits are
    used.  Arguments are ints or integer tensors that broadcast; returns
    float32."""
    def u32(t):
        return torch.as_tensor(t, dtype=torch.int64) & _M32

    x = (_mul32(u32(q_pos), 0x9E3779B9) + _mul32(u32(k_pos), 0x85EBCA6B)
         + _mul32(u32(h_idx), 0xC2B2AE35) + u32(seed)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _f32(x):
    """A Python float rounded to float32, as JAX rounds a weak scalar."""
    return float(np.float32(x))


def _keep(bh, s, seed, dropout, device):
    """The ``(bh, s, s)`` keep mask: ``uniform01 >= dropout`` in f32."""
    ar = torch.arange(s, device=device)
    u = uniform01(torch.arange(bh, device=device)[:, None, None],
                  ar[None, :, None], ar[None, None, :], seed)
    return u >= _f32(dropout)


# ------------------------------------------------------- plain versions ----
def _acc(dtype, acc):
    return acc if acc is not None else torch.promote_types(dtype,
                                                           torch.float32)


def _scores(q, k, scale, causal, acc):
    """``(q * scale) k^T`` in ``acc``, causal entries at ``-1e30``."""
    s = torch.matmul(q.to(acc) * scale, k.to(acc).transpose(1, 2))
    if causal:
        n = s.shape[-1]
        tri = torch.ones((n, n), dtype=torch.bool, device=s.device).tril()
        s = torch.where(tri, s, torch.full((), _NEG_INF, dtype=acc,
                                           device=s.device))
    return s


def _drop(x, keep, dropout):
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device)) \
        * _f32(1.0 / (1.0 - dropout))


def _fwd_plain(q, k, v, scale, causal, dropout, seed, acc=None):
    """The forward kernel's function: ``(O, lse)``, O in ``q.dtype``."""
    acc = _acc(q.dtype, acc)
    s = _scores(q, k, scale, causal, acc)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)         # before dropout, as lse needs
    if dropout > 0.0:
        p = _drop(p, _keep(q.shape[0], q.shape[1], seed, dropout, q.device),
                  dropout)
    o = torch.matmul(p, v.to(acc)) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _bwd_terms(q, k, v, do, lse, delta, scale, causal, dropout, seed, acc):
    """``(mask(p), ds)`` of the backward kernels, in ``acc``."""
    p = torch.exp(_scores(q, k, scale, causal, acc)
                  - lse.to(acc)[..., None])
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(1, 2))
    pd = p
    if dropout > 0.0:
        keep = _keep(q.shape[0], q.shape[1], seed, dropout, q.device)
        pd, dp = _drop(p, keep, dropout), _drop(dp, keep, dropout)
    return pd, p * (dp - delta.to(acc)[..., None])


def _dq_plain(q, k, v, do, lse, delta, scale, causal, dropout, seed,
              acc=None):
    """The dQ kernel's function: ``ds K * scale`` in ``q.dtype``."""
    acc = _acc(q.dtype, acc)
    _, ds = _bwd_terms(q, k, v, do, lse, delta, scale, causal, dropout,
                       seed, acc)
    return (torch.matmul(ds, k.to(acc)) * scale).to(q.dtype)


def _dkv_plain(q, k, v, do, lse, delta, scale, causal, dropout, seed,
               acc=None):
    """The dK/dV kernel's function: ``(ds^T Q * scale, mask(p)^T dO)``."""
    acc = _acc(q.dtype, acc)
    pd, ds = _bwd_terms(q, k, v, do, lse, delta, scale, causal, dropout,
                        seed, acc)
    dk = torch.matmul(ds.transpose(1, 2), q.to(acc)) * scale
    dv = torch.matmul(pd.transpose(1, 2), do.to(acc))
    return dk.to(k.dtype), dv.to(v.dtype)


# -------------------------------------------------------- CUDA wrappers ----
def _check_cuda(what, tensors, rows=()):
    """Types, shapes, devices and layout the kernels take; raises on the
    rest.  ``tensors`` share q's (B*H, S, D) shape and dtype; ``rows``
    are f32 (B*H, S) (lse, delta)."""
    q = tensors[0]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.dim() != 3 or q.shape[2] not in _HEAD_DIMS:
        raise ValueError(f"{what} kernel takes (B*H, S, D) with D in "
                         f"{_HEAD_DIMS}, got {tuple(q.shape)}")
    for t in tensors:
        if t.dtype != q.dtype or t.shape != q.shape:
            raise TypeError(f"{what} kernel: inputs must share q's "
                            f"{q.dtype} {tuple(q.shape)}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    for t in rows:
        if t.dtype != torch.float32 or t.shape != q.shape[:2]:
            raise TypeError(f"{what} kernel: lse/delta must be float32 "
                            f"{tuple(q.shape[:2])}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    every = list(tensors) + list(rows)
    if len({t.device for t in every}) != 1:
        raise ValueError(f"{what}: inputs on several devices")
    for t in every:
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous "
                             f"(make the (B*H, S, D) views contiguous)")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in tensors):
        raise ValueError(f"{what}: bf16 inputs must start at 16-byte "
                         f"aligned addresses (the kernels read them by TMA)")


def seed_tensor(seed, device):
    """``seed`` as the 0-d int32 tensor on ``device`` the kernels read:
    a tensor as it is (checked), an int's low 32 bits written into a new
    one (a fill on the device, no copy from the host)."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int32 or seed.numel() != 1 \
                or seed.device != torch.device(device):
            raise TypeError(f"flash_attention: a seed tensor must be one "
                            f"int32 on {device}, got {seed.dtype} "
                            f"{tuple(seed.shape)} on {seed.device}")
        return seed
    seed = int(seed) & _M32
    seed = seed - (1 << 32) if seed >= 1 << 31 else seed   # as an int32
    return torch.full((), seed, dtype=torch.int32, device=device)


def _launch(what, fn, q, ptrs, scale, causal, dropout, seed):
    """Call one C entry point on q's device and stream with the
    pointers ``ptrs`` and the shared trailing arguments (the seed a
    device tensor, or an int written into one; none at dropout 0); raise
    on a CUDA error, count the launch."""
    from .cuda import check, on_card

    bh, s, d = q.shape
    drop_scale = _f32(1.0 / (1.0 - dropout)) if dropout > 0.0 else 1.0
    seed = seed_tensor(seed, q.device) if dropout > 0.0 else None
    with on_card(q.device.index):
        check(fn(_DTYPE_CODES[q.dtype], *ptrs, bh, s, d,
                 ctypes.c_float(scale), int(causal), ctypes.c_float(dropout),
                 ctypes.c_float(drop_scale),
                 None if seed is None else seed.data_ptr(),
                 torch.cuda.current_stream(q.device).cuda_stream), what)
    flash_attention.launches[what.rsplit("_", 1)[1]] += 1


def _fwd_cuda(q, k, v, scale, causal, dropout, seed):
    from .cuda import load

    _check_cuda("flash_attention_fwd", (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", load("flash_attention").flash_attention_fwd,
            q, (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr()), scale, causal, dropout, seed)
    return o, lse


def _dq_cuda(q, k, v, do, lse, delta, scale, causal, dropout, seed):
    from .cuda import load

    _check_cuda("flash_attention_dq", (q, k, v, do), (lse, delta))
    dq = torch.empty_like(q)
    _launch("flash_attention_dq", load("flash_attention").flash_attention_dq,
            q, (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            scale, causal, dropout, seed)
    return dq


def _dkv_cuda(q, k, v, do, lse, delta, scale, causal, dropout, seed):
    from .cuda import load

    _check_cuda("flash_attention_dkv", (q, k, v, do), (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_dkv",
            load("flash_attention").flash_attention_dkv, q,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            scale, causal, dropout, seed)
    return dk, dv


def _use_plain(tensors):
    """True for CPU tensors and for ``meta`` ones (a shape inference's
    trace: the plain body gives the shapes, and runs nothing), False for
    CUDA tensors; raises on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds in ({"cpu"}, {"meta"}, {"cuda"}):
        return kinds != {"cuda"}
    raise ValueError(f"flash_attention: inputs must all lie on the CPU or "
                     f"all on one CUDA device, got {sorted(kinds)}")


# (forward, dQ, dK/dV) bodies: the plain versions or the kernels
_BODIES = {True: (_fwd_plain, _dq_plain, _dkv_plain),
           False: (_fwd_cuda, _dq_cuda, _dkv_cuda)}


# ----------------------------------------------------------- public api ----
class _FlashAttention(torch.autograd.Function):
    """Forward = the forward kernel (saving q, k, v, seed, O, lse);
    backward = delta in f32, then the dQ kernel, then the dK/dV kernel
    (the JAX module's ``_flash_attention_core`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, dropout, seed):
        ctx.bodies = _BODIES[_use_plain((q, k, v))]
        if q.is_cuda and dropout > 0.0:
            seed = seed_tensor(seed, q.device)   # one tensor for all three
        ctx.args = (scale, causal, dropout, seed)
        o, lse = ctx.bodies[0](q, k, v, scale, causal, dropout, seed)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        _, dq_body, dkv_body = ctx.bodies
        do = do.to(q.dtype).contiguous()
        delta = (o.to(lse.dtype) * do.to(lse.dtype)).sum(dim=-1)
        dq = dq_body(q, k, v, do, lse, delta, *ctx.args)
        dk, dv = dkv_body(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, scale=None, causal=False, block_q=128,
                    block_k=128, dropout=0.0, seed=None):
    """``softmax(scale * Q K^T [causal]) V`` on ``(B*H, S, D)`` without
    materialising ``S x S`` on the card.  ``scale`` defaults to
    ``1/sqrt(D)``; ``dropout`` drops attention probabilities inside the
    kernels, the mask drawn from ``seed`` (an int32, or a 0-d int32
    tensor on q's device whose value is read when the kernels run; None:
    0).  ``block_q`` and ``block_k`` are accepted for API parity and do
    not change the result.  Differentiable in q, k, v.  Returns O in q's
    dtype."""
    del block_q, block_k
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must share one "
                         f"(B*H, S, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    scale = 1.0 / (q.shape[-1] ** 0.5) if scale is None else float(scale)
    if seed is None:
        seed = 0
    elif not isinstance(seed, torch.Tensor):
        seed = int(seed)
    if is_fake(q):      # traced by torch.export: record the custom op
        if dropout > 0.0:
            raise ValueError("torch.export records inference: "
                             "flash_attention's dropout must be 0")
        return torch.ops.mxnet_tpu_torch.flash_attention(q, k, v, scale,
                                                         bool(causal))
    return _FlashAttention.apply(q, k, v, scale, bool(causal),
                                 float(dropout), seed)


flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}


@torch.library.custom_op(
    "mxnet_tpu_torch::flash_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float scale, bool causal) "
           "-> Tensor")
def _flash_attention_op(q, k, v, scale, causal):
    """``flash_attention`` without dropout as one op for
    ``torch.export`` (see ``fused_conv._norm_relu_conv_op``)."""
    return flash_attention(q, k, v, scale=scale, causal=causal)


@_flash_attention_op.register_fake
def _flash_attention_shape(q, k, v, scale, causal):
    return torch.empty_like(q)
