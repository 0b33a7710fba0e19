"""Sequence/context parallelism (the port of ``mxnet_tpu/parallel/
sequence.py``): ring attention and Ulysses over the ``sp`` mesh axis.

Both take the ``(B, S, H*D)`` projections every rank of ``sp`` holds
alike (the batch is split over ``dp``/``fsdp`` only), take this rank's
block of the sequence (``scatter_to``: the gradients of the blocks are
gathered back), and return the whole ``(B, S, H*D)`` output gathered
over ``sp`` (``gather_from``: the gradient of this rank's block passed
back — not summed over the ranks, whose consumers downstream are
replicated).

- ``ring_attention``: the online softmax over K/V blocks passed round
  the ring by ``ppermute`` (point to point), one hop a step, each rank
  keeping its Q block (Liu et al., Ring Attention).
- ``ulysses_attention``: two all-to-alls re-split sequence <-> heads so
  each rank runs full-sequence attention for its head group (DeepSpeed
  Ulysses); ``heads % sp`` must be 0.

The blocks are dense f32 ``torch.matmul``s, as the JAX ring's einsums
are: no kernel of its own.  Dropout draws from the rank's own stream
(``random``), after the softmax, as the dense op drops.
"""
from __future__ import annotations

import torch

from . import mesh as _mesh

__all__ = ["ring_attention", "ulysses_attention", "sp_attention"]


def _mesh_for(mesh, what):
    mesh = mesh if mesh is not None else _mesh.current_mesh()
    if mesh is None:
        raise ValueError(f"{what} needs a mesh: pass mesh= or enter a "
                         f"parallel.MeshScope")
    return mesh


def _to_bhsd(x, heads):
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).permute(0, 2, 1, 3)


def _from_bhsd(x):
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d)


def _drop(p, rate):
    keep = torch.rand(p.shape, device=p.device) >= rate
    return torch.where(keep, p / (1.0 - rate), torch.zeros((), dtype=p.dtype,
                                                            device=p.device))


def _ring_body(q, k, v, axis, n, causal, scale, dropout):
    """The per-rank ring loop over ``(B, H, S_loc, D)`` blocks.  The
    normaliser sums the undropped weights and the output the dropped
    ones, so the result is ``sum_j drop(softmax(s))_j v_j``."""
    idx = _mesh.axis_index(axis)
    s_loc = q.shape[2]
    q32 = q.float() * scale
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:3], float("-inf"), device=q.device)
    l = torch.zeros(q.shape[:3], device=q.device)
    perm = [(j, (j + 1) % n) for j in range(n)]
    q_pos = idx * s_loc + torch.arange(s_loc, device=q.device)
    neg = torch.full((), -1e30, device=q.device)
    for step in range(n):
        # after `step` hops this rank holds block (idx - step) mod n
        src = (idx - step) % n
        s_blk = torch.matmul(q32, k.float().transpose(-1, -2))
        if causal:
            k_pos = src * s_loc + torch.arange(s_loc, device=q.device)
            allow = q_pos[:, None] >= k_pos[None, :]
            s_blk = torch.where(allow[None, None], s_blk, neg)
        m_new = torch.maximum(m, s_blk.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s_blk - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        p_eff = _drop(p, dropout) if dropout > 0.0 else p
        o = o * corr[..., None] + torch.matmul(p_eff, v.float())
        m = m_new
        if step != n - 1:
            k = _mesh.ppermute(k, axis, perm)
            v = _mesh.ppermute(v, axis, perm)
    # rows with no allowed key yet (causal) have l == 0
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def ring_attention(q, k, v, heads, mesh=None, axis="sp", batch_axis="dp",
                   causal=False, dropout=0.0, training=False):
    """Attention over ``(B, S, H*D)`` projections with the sequence
    split over ``axis``; returns the whole ``(B, S, H*D)``."""
    mesh = _mesh_for(mesh, "ring_attention")
    n = mesh.shape[axis]
    scale = 1.0 / ((q.shape[-1] // heads) ** 0.5)
    drop = dropout if training else 0.0
    with _mesh.MeshScope(mesh):
        ql, kl, vl = (_mesh.scatter_to(t, axis, 1) for t in (q, k, v))
        out = _ring_body(_to_bhsd(ql, heads), _to_bhsd(kl, heads),
                         _to_bhsd(vl, heads), axis, n, causal, scale, drop)
        return _mesh.gather_from(_from_bhsd(out), axis, 1)


def ulysses_attention(q, k, v, heads, mesh=None, axis="sp", batch_axis="dp",
                      causal=False, dropout=0.0, training=False):
    """Ulysses: all-to-all sequence -> heads, full-sequence attention for
    this rank's head group, all-to-all back.  ``heads`` must divide by
    the axis size."""
    mesh = _mesh_for(mesh, "ulysses_attention")
    n = mesh.shape[axis]
    if heads % n != 0:
        raise ValueError(f"ulysses needs heads ({heads}) divisible by "
                         f"mesh axis '{axis}' ({n})")
    d = q.shape[-1] // heads
    scale = 1.0 / (d ** 0.5)
    drop = dropout if training else 0.0
    with _mesh.MeshScope(mesh):
        ql, kl, vl = (_mesh.scatter_to(t, axis, 1) for t in (q, k, v))
        b, s_loc, _ = ql.shape

        def gather_seq(x):      # (B, S_loc, H, D) -> (B, S, H/n, D)
            x = x.reshape(b, s_loc, n, heads // n, d).permute(2, 0, 1, 3, 4)
            x = _mesh.all_to_all_grad(x.contiguous(), axis)
            return x.permute(1, 0, 2, 3, 4).reshape(b, n * s_loc,
                                                    heads // n, d)

        def scatter_seq(x):     # (B, S, H/n, D) -> (B, S_loc, H, D)
            x = x.reshape(b, n, s_loc, heads // n, d).permute(1, 0, 2, 3, 4)
            x = _mesh.all_to_all_grad(x.contiguous(), axis)
            return x.permute(1, 2, 0, 3, 4).reshape(b, s_loc, heads, d)

        qh, kh, vh = (gather_seq(t.reshape(b, s_loc, heads, d))
                      for t in (ql, kl, vl))
        qt = qh.permute(0, 2, 1, 3).float() * scale
        kt = kh.permute(0, 2, 1, 3).float()
        vt = vh.permute(0, 2, 1, 3).float()
        s_blk = torch.matmul(qt, kt.transpose(-1, -2))
        if causal:
            sq = s_blk.shape[-1]
            allow = torch.ones((sq, sq), dtype=torch.bool,
                               device=q.device).tril()
            s_blk = torch.where(allow[None, None], s_blk,
                                torch.full((), -1e30, device=q.device))
        attn = torch.softmax(s_blk, dim=-1)
        if drop > 0.0:
            attn = _drop(attn, drop)
        out = torch.matmul(attn, vt).to(ql.dtype).permute(0, 2, 1, 3)
        out = scatter_seq(out).reshape(b, s_loc, heads * d)
        return _mesh.gather_from(out, axis, 1)


def sp_attention(q, k, v, heads, impl="ring", **kwargs):
    """Dispatch helper: ``impl`` in {'ring', 'ulysses'}."""
    if impl == "ring":
        return ring_attention(q, k, v, heads, **kwargs)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, heads, **kwargs)
    raise ValueError(f"unknown sequence-parallel impl '{impl}'")
