"""The mixture-of-experts op: GShard top-k routing with capacity and the
expert FFN on whole weights (the registry's ``moe_ffn``, whose JAX
counterpart is registered in ``mxnet_tpu/parallel/moe.py``).

``parallel.moe`` builds the expert-parallel layer (``MoEFFN``) on these
pieces: ``route`` and ``experts`` are shared with its ``ep``-sharded
path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register_op

__all__ = ["moe_dispatch", "route", "experts", "moe_ffn"]


def moe_dispatch(gate_logits, num_experts, capacity, k=2, valid=None):
    """GShard-style top-k routing with fixed capacity.

    ``gate_logits``: ``(N, E)``.  ``valid``: optional ``(N,)`` bool —
    padded tokens are left out of dispatch, capacity and the aux-loss
    statistics.  Returns ``(dispatch (N, E, C), combine (N, E, C),
    aux_loss)``.  Top-k gates are normalised over the k chosen experts
    before capacity drops (mass routed to an overflowed expert is lost,
    not re-assigned); ``k == 1`` keeps the raw gate (Switch)."""
    n, e = gate_logits.shape
    dev = gate_logits.device
    probs = torch.softmax(gate_logits.float(), dim=-1)           # (N, E)
    valid_f = torch.ones((n,), device=dev) if valid is None \
        else valid.float()
    n_valid = torch.clamp(valid_f.sum(), min=1.0)

    # aux load-balancing loss (Switch/GShard) over the valid tokens
    top1 = torch.argmax(probs, dim=-1)
    f = (F.one_hot(top1, e).float() * valid_f[:, None]).sum(0) / n_valid
    p_mean = (probs * valid_f[:, None]).sum(0) / n_valid
    aux_loss = e * torch.sum(f * p_mean)

    # pass 1: the top-k experts of each token and their pre-drop gates
    remaining = probs
    selections = []
    gate_sum = torch.zeros((n,), device=dev)
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)                    # (N,)
        gate = torch.gather(remaining, 1, idx[:, None])[:, 0]
        onehot = F.one_hot(idx, e).to(torch.int32)
        mask = onehot * valid_f[:, None].to(torch.int32)         # (N, E)
        selections.append((gate, mask))
        gate_sum = gate_sum + gate
        remaining = remaining * (1.0 - onehot)
    # pass 2: capacity-bounded slots, gates normalised before the drops
    dispatch = torch.zeros((n, e, capacity), device=dev)
    combine = torch.zeros((n, e, capacity), device=dev)
    occupancy = torch.zeros((e,), dtype=torch.int32, device=dev)
    for gate, mask in selections:
        if k > 1:
            gate = gate / torch.clamp(gate_sum, min=1e-9)
        pos = torch.cumsum(mask, dim=0) - mask + occupancy[None, :]
        pos_tok = (pos * mask).sum(-1)                           # (N,)
        keep = pos_tok < capacity
        onehot_pos = F.one_hot(pos_tok.clamp(0, capacity - 1).long(),
                               capacity).float() \
            * (pos_tok < capacity)[:, None]
        d = (mask.float()[:, :, None] * onehot_pos[:, None, :]
             * keep[:, None, None])
        dispatch = dispatch + d
        combine = combine + d * gate[:, None, None]
        occupancy = occupancy + (mask * keep[:, None]).sum(0).to(torch.int32)
    return dispatch, combine, aux_loss


def route(tokens, gate_w, num_experts, capacity, k, group_size):
    """``(N, D)`` tokens in groups of ``group_size`` (the last padded):
    ``(groups (G, n_g, D), dispatch, combine (G, n_g, E, C_g), aux)``,
    the aux loss weighed by each group's valid tokens."""
    n, d = tokens.shape
    gs = group_size if group_size and group_size < n else n
    g = -(-n // gs)
    pad = g * gs - n
    if pad:
        tokens = torch.cat([tokens, tokens.new_zeros((pad, d))], dim=0)
    tg = tokens.reshape(g, gs, d)
    valid = (torch.arange(g * gs, device=tokens.device) < n).reshape(g, gs)
    logits = tg.float() @ gate_w.float()                       # (G, gs, E)
    routed = [moe_dispatch(logits[i], num_experts, capacity, k=k,
                           valid=valid[i]) for i in range(g)]
    dispatch = torch.stack([r[0] for r in routed])
    combine = torch.stack([r[1] for r in routed])
    aux = torch.stack([r[2] for r in routed])
    # a padded tail group must not dilute the statistics
    nv = torch.clamp(valid.float().sum(1), min=1.0)
    return tg, dispatch, combine, (aux * nv).sum() / nv.sum()


def experts(x, w1, b1, w2, b2, act):
    """``(G, E, C, D)`` expert inputs through each expert's FFN."""
    h = torch.einsum("gecd,edh->gech", x, w1) + b1[None, :, None, :]
    h = F.gelu(h, approximate="tanh") if act == "gelu" else F.relu(h)
    return torch.einsum("gech,ehd->gecd", h, w2) + b2[None, :, None, :]


@register_op("moe_ffn")
def moe_ffn(tokens, gate_w, w1, b1, w2, b2, num_experts=1, capacity=1, k=2,
            act="gelu", group_size=0):
    """The MoE FFN on ``(N, C)`` tokens -> ``((N, C), aux_loss)``, routed
    in groups of ``group_size`` tokens with a capacity per group
    (dispatch/combine ``(G, n_g, E, C_g)``)."""
    n, d = tokens.shape
    tg, dispatch, combine, aux = route(tokens, gate_w, num_experts,
                                       capacity, k, group_size)
    exp_in = torch.einsum("gnec,gnd->gecd", dispatch.to(tokens.dtype), tg)
    out_e = experts(exp_in, w1, b1, w2, b2, act)
    out = torch.einsum("gnec,gecd->gnd", combine.to(tokens.dtype), out_e)
    return out.reshape(-1, d)[:n], aux
