"""Small causal (decoder-only) transformer LM for the serving decode loop.

The port of ``mxnet_tpu/gluon/model_zoo/causal_lm.py`` (single-device
path: no tensor-parallel ``reduce`` hook).  The model is functional —
params are a flat dict of tensors with per-layer weights stacked on a
leading ``[n_layers, ...]`` axis, exactly the JAX package's layout, so
``params_from_jax`` copies a JAX param dict across by name.  Pre-LN
layers with a fused QKV projection, a GELU FFN, a causal mask and a
weight-tied LM head.

Numerics kept equal to the JAX reference:

- ``jax.nn.gelu`` defaults to the tanh approximation, so the FFN uses
  ``F.gelu(approximate="tanh")``;
- ``_ln`` uses eps ``1e-6`` (torch's layer norm default is ``1e-5``) and
  the same two-pass mean/variance expression;
- the last-position gather clamps ``lengths - 1`` into range, as a JAX
  gather would clamp an out-of-range index where torch raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ...context import resolve_device
from ...ops.attention import multi_head_attention

__all__ = ["CausalLMConfig", "init_causal_lm", "params_from_jax",
           "prefill_forward", "sequence_logits", "decode_hidden",
           "lm_logits", "draft_config", "window_logits", "verify_logits"]


@dataclasses.dataclass(frozen=True)
class CausalLMConfig:
    """Static architecture hyperparameters."""
    vocab_size: int = 256
    n_layers: int = 2
    n_heads: int = 2
    head_dim: int = 16
    d_ff: int = 64

    @property
    def d_model(self) -> int:
        return self.n_heads * self.head_dim


def init_causal_lm(config: CausalLMConfig, generator=None, device="cuda",
                   std=0.02) -> dict:
    """Random-init params, a flat dict of float32 tensors on ``device``
    with per-layer weights stacked on axis 0.  ``generator`` is a CPU
    ``torch.Generator`` (default: one seeded with 0); weights are drawn
    on the host from it and then moved, so a seed gives the same weights
    on every device.  (The JAX package draws from ``jax.random``; its
    numbers differ — copy them with ``params_from_jax`` for parity.)"""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    c = config
    d, ff, L = c.d_model, c.d_ff, c.n_layers

    def norm(*shape):
        return std * torch.randn(*shape, generator=generator,
                                 dtype=torch.float32)

    def zeros(*shape):
        return torch.zeros(*shape, dtype=torch.float32)

    def ones(*shape):
        return torch.ones(*shape, dtype=torch.float32)

    params = {
        "embed": norm(c.vocab_size, d),
        "wqkv": norm(L, d, 3 * d), "bqkv": zeros(L, 3 * d),
        "wo": norm(L, d, d), "bo": zeros(L, d),
        "ln1_s": ones(L, d), "ln1_b": zeros(L, d),
        "ln2_s": ones(L, d), "ln2_b": zeros(L, d),
        "w1": norm(L, d, ff), "b1": zeros(L, ff),
        "w2": norm(L, ff, d), "b2": zeros(L, d),
        "lnf_s": ones(d), "lnf_b": zeros(d),
    }
    return {k: v.to(dev) for k, v in params.items()}


def params_from_jax(np_params, device="cuda") -> dict:
    """The JAX package's param dict (values as numpy arrays, e.g.
    ``{k: np.asarray(v)}`` of ``mxnet_tpu``'s ``init_causal_lm``) as the
    port's params: same names, same layouts, float32 tensors on
    ``device``.  Both packages then compute the same function."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in np_params.items()}


def _ln(x, scale, bias, eps=1e-6):
    """Layer norm with the JAX reference's eps (1e-6) and expression."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _ffn(x, w1, b1, w2, b2):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ w1 + b1, approximate="tanh") @ w2 + b2


def _layer_tail(params, layer, h, ctx):
    """Residual + output projection + FFN tail of one layer, shared by
    the decode and whole-sequence paths (``ctx`` merged to
    ``[..., d_model]``)."""
    h = h + ctx @ params["wo"][layer] + params["bo"][layer]
    return h + _ffn(_ln(h, params["ln2_s"][layer], params["ln2_b"][layer]),
                    params["w1"][layer], params["b1"][layer],
                    params["w2"][layer], params["b2"][layer])


def lm_logits(params, h):
    """Weight-tied LM head: hidden → vocab logits through the
    embedding matrix."""
    return _ln(h, params["lnf_s"], params["lnf_b"]) @ params["embed"].T


def decode_hidden(params, layer, h, attend):
    """One pre-LN layer for a SINGLE token position.  ``h`` is
    ``[slots, d_model]``; ``attend(q, k, v) -> ctx`` is the caller's
    cache hook: it gets this layer's new per-slot q/K/V
    (``[slots, d_model]`` each), writes K/V into its cache and returns
    the attention context over it."""
    x = _ln(h, params["ln1_s"][layer], params["ln1_b"][layer])
    qkv = x @ params["wqkv"][layer] + params["bqkv"][layer]
    q, k, v = qkv.chunk(3, dim=-1)
    slots = h.shape[0]
    ctx = attend(q, k, v)
    return _layer_tail(params, layer, h, ctx.reshape(slots, -1))


def _stack_forward(params, config: CausalLMConfig, tokens, lengths):
    """The whole-sequence stack: causal attention with positions beyond
    a row's ``lengths`` masked as keys (``lengths=None``: all valid).
    Returns ``(h [b, L, d], k_all, v_all)`` with K/V stacked
    ``[n_layers, b, L, heads, head_dim]``."""
    c = config
    b, L = tokens.shape
    heads = c.n_heads
    h = params["embed"][tokens.long()]                    # [b, L, d]
    if lengths is None:
        mask = torch.ones((b, 1, 1, L), dtype=torch.float32,
                          device=h.device)
    else:
        mask = (torch.arange(L, device=h.device)[None, :]
                < lengths.to(h.device)[:, None]).to(
                    torch.float32)[:, None, None, :]
    ks, vs = [], []
    for layer in range(c.n_layers):
        x = _ln(h, params["ln1_s"][layer], params["ln1_b"][layer])
        qkv = x @ params["wqkv"][layer] + params["bqkv"][layer]
        q, k, v = qkv.chunk(3, dim=-1)                  # each [b, L, d]
        ks.append(k.reshape(b, L, heads, c.head_dim))
        vs.append(v.reshape(b, L, heads, c.head_dim))
        ctx = multi_head_attention(q, k, v, mask=mask, heads=heads,
                                   causal=True)
        h = _layer_tail(params, layer, h, ctx)
    return h, torch.stack(ks), torch.stack(vs)


def prefill_forward(params, config: CausalLMConfig, tokens, lengths):
    """Whole-prompt forward: ``tokens [b, L]`` int, ``lengths [b]``.
    Returns ``(logits_last [b, vocab], k_all, v_all)``, K/V stacked
    ``[n_layers, b, L, heads, head_dim]``; the last hidden state is
    gathered at ``lengths - 1``, clamped into ``[0, L - 1]``."""
    b, L = tokens.shape
    h, ks, vs = _stack_forward(params, config, tokens, lengths)
    last = (lengths.to(h.device).long() - 1).clamp(0, L - 1)
    h_last = h[torch.arange(b, device=h.device), last]    # [b, d]
    return lm_logits(params, h_last), ks, vs


def draft_config(config: CausalLMConfig, *, n_layers=1, n_heads=None,
                 head_dim=None, d_ff=None) -> CausalLMConfig:
    """The draft model's config for speculative decoding: the target's
    family and vocabulary (the acceptance test compares distributions
    over the same tokens, so the vocabulary is not a parameter), by
    default one layer; the width arguments override the target's."""
    return CausalLMConfig(
        vocab_size=config.vocab_size,
        n_layers=int(n_layers),
        n_heads=config.n_heads if n_heads is None else int(n_heads),
        head_dim=config.head_dim if head_dim is None else int(head_dim),
        d_ff=config.d_ff if d_ff is None else int(d_ff))


def window_logits(params, config: CausalLMConfig, tokens, n_valid):
    """Next-token logits at the last position of a RIGHT-ALIGNED token
    window ``tokens [S, W]`` whose ``n_valid [S]`` trailing entries are
    valid: the draft's forward in the speculative verify step, with no
    KV cache.  The ``W - n_valid`` leading positions are masked as keys
    and the causal mask lies on top, so the last position attends to
    exactly the valid suffix.  Returns ``[S, vocab]``."""
    S, W = tokens.shape
    heads = config.n_heads
    h = params["embed"][tokens.long()]                    # [S, W, d]
    mask = (torch.arange(W, device=h.device)[None, :]
            >= (W - n_valid.to(h.device))[:, None]).to(
                torch.float32)[:, None, None, :]
    for layer in range(config.n_layers):
        x = _ln(h, params["ln1_s"][layer], params["ln1_b"][layer])
        qkv = x @ params["wqkv"][layer] + params["bqkv"][layer]
        q, k, v = qkv.chunk(3, dim=-1)
        ctx = multi_head_attention(q, k, v, mask=mask, heads=heads,
                                   causal=True)
        h = _layer_tail(params, layer, h, ctx)
    return lm_logits(params, h[:, -1])


def verify_logits(params, config: CausalLMConfig, tokens, attend):
    """Next-token logits at EVERY position of a candidate block
    ``tokens [S, K1]``: the target's forward in the speculative verify
    step.  The ``S * K1`` lanes go through one ``decode_hidden`` pass
    per layer; ``attend(layer, q, k, v) -> ctx`` is the caller's cache
    hook over the flattened lanes (it writes the pools and masks each
    lane causally by its attention length).  Returns
    ``[S, K1, vocab]``."""
    S, K1 = tokens.shape
    h = params["embed"][tokens.long()].reshape(S * K1, -1)
    for layer in range(config.n_layers):
        h = decode_hidden(params, layer, h,
                          lambda q, k, v, _l=layer: attend(_l, q, k, v))
    return lm_logits(params, h).reshape(S, K1, -1)


def sequence_logits(params, config: CausalLMConfig, tokens, lengths=None):
    """Next-token logits for EVERY position, ``[b, L, vocab]``."""
    h, _, _ = _stack_forward(params, config, tokens, lengths)
    return lm_logits(params, h)
