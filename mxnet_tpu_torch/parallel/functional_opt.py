"""Optimizer updates for the training step (the port of
``mxnet_tpu/parallel/functional_opt.py``'s SGD and LAMB rules).

The JAX functions are pure: ``(w, g, state, t) -> (w', state')``.  Here
the update writes **in place** into the step's tensors (called under
``torch.no_grad()``), with the same arithmetic in the same order; ``t``
is the 1-based step count (LAMB's bias correction reads it).  For
half-precision weights the f32 master weight rides as the LAST state
element, as in the JAX step: the rule updates the master from the f32
gradient and the weight becomes the master cast back.

Two forms of each rule:

- ``multi_update`` — what ``TrainStep`` runs: one ``torch._foreach_*``
  op per arithmetic step over all the weights of a group (same
  multi-precision mode and ``lr_mult``/``wd_mult``), LAMB's two norms per
  tensor by ``torch._foreach_norm``.  The step count ``t`` and the base
  learning rate may be 0-d device tensors, so a captured step reads
  their current values on every replay (``1 - beta**t`` is computed on
  the device in f32, as the JAX rule does); ``lr_mult``/``wd_mult`` are
  per-tensor constants.  With ``finite`` (a 0-d bool tensor) every
  weight and state keeps its old value where it is False — the JAX
  step's all-finite guard as a select, without a branch or a sync.
- ``pure_update`` — one tensor at a time, the oracle the multi-tensor
  form is held to.
"""
from __future__ import annotations

import torch

__all__ = ["pure_update", "multi_update", "state_template"]


def _bias_correction(beta, t, device):
    """``1 - beta**t`` as the JAX rule takes it: a 0-d f32 tensor on
    ``device``, the power in f32 (``t`` an int or a 0-d tensor on
    ``device``; made by fills, never copied from the host, so a graph
    can hold it)."""
    f32 = torch.float32
    t = t.to(f32) if isinstance(t, torch.Tensor) \
        else torch.full((), t, dtype=f32, device=device)
    return 1 - torch.pow(torch.full((), beta, dtype=f32, device=device), t)


# ------------------------------------------------------------ per tensor --
def _prep(opt, w, g, wd):
    g = g * opt.rescale_grad
    if opt.clip_gradient is not None:
        g = g.clamp(-opt.clip_gradient, opt.clip_gradient)
    return g + wd * w


def _sgd(opt, w, g, state, t, lr, wd):
    g = _prep(opt, w, g, wd)
    if opt.momentum == 0.0:
        w.sub_(lr * g)
        return
    (mom,) = state
    mom.mul_(opt.momentum).sub_(lr * g)
    w.add_(mom)


def _lamb(opt, w, g, state, t, lr, wd):
    g = g * opt.rescale_grad
    if opt.clip_gradient is not None:
        g = g.clamp(-opt.clip_gradient, opt.clip_gradient)
    m, v = state
    m.mul_(opt.beta1).add_((1 - opt.beta1) * g)
    v.mul_(opt.beta2).add_((1 - opt.beta2) * g * g)
    if opt.bias_correction:
        m_hat = m / _bias_correction(opt.beta1, t, m.device)
        v_hat = v / _bias_correction(opt.beta2, t, m.device)
    else:
        m_hat, v_hat = m, v
    upd = m_hat / (torch.sqrt(v_hat) + opt.epsilon) + wd * w
    r1 = torch.linalg.vector_norm(w.float())
    if opt.lower_bound is not None:
        r1 = r1.clamp_min(opt.lower_bound)
    if opt.upper_bound is not None:
        r1 = r1.clamp_max(opt.upper_bound)
    r2 = torch.linalg.vector_norm(upd.float())
    trust = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    w.sub_(lr * trust * upd.to(w.dtype))


_DISPATCH = {"SGD": _sgd, "LAMB": _lamb}


def _is_mp(opt, dtype):
    return bool(opt._mp_for(dtype))


def _rule(opt, table):
    fn = table.get(type(opt).__name__)
    if fn is None:
        raise NotImplementedError(
            f"the port's train step has no update rule for "
            f"{type(opt).__name__} (ported: {sorted(table)})")
    return fn


def pure_update(opt, w, g, state, t, lr, wd):
    """Update ``w`` (and ``state``) in place from the gradient ``g`` at
    step ``t`` (1-based)."""
    fn = _rule(opt, _DISPATCH)
    if _is_mp(opt, w.dtype):
        master = state[-1]
        fn(opt, master, g.float(), state[:-1], t, lr, wd)
        w.copy_(master)
    else:
        fn(opt, w, g, state, t, lr, wd)


# ---------------------------------------------------------- multi-tensor --
def _scaled_multi(opt, gs):
    gs = torch._foreach_mul(gs, opt.rescale_grad)
    if opt.clip_gradient is not None:
        torch._foreach_clamp_min_(gs, -opt.clip_gradient)
        torch._foreach_clamp_max_(gs, opt.clip_gradient)
    return gs


def _sgd_multi(opt, ws, gs, states, bc, lr, wd):
    gs = _scaled_multi(opt, gs)
    torch._foreach_add_(gs, torch._foreach_mul(ws, wd))
    step = torch._foreach_mul(gs, lr)
    if opt.momentum == 0.0:
        torch._foreach_sub_(ws, step)
        return
    moms = [s[0] for s in states]
    torch._foreach_mul_(moms, opt.momentum)
    torch._foreach_sub_(moms, step)
    torch._foreach_add_(ws, moms)


def _lamb_multi(opt, ws, gs, states, bc, lr, wd):
    gs = _scaled_multi(opt, gs)
    ms, vs = [s[0] for s in states], [s[1] for s in states]
    torch._foreach_mul_(ms, opt.beta1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - opt.beta1))
    torch._foreach_mul_(vs, opt.beta2)
    g2 = torch._foreach_mul(gs, 1 - opt.beta2)
    torch._foreach_mul_(g2, gs)
    torch._foreach_add_(vs, g2)
    if opt.bias_correction:
        m_hat = torch._foreach_div(ms, bc[0])
        v_hat = torch._foreach_div(vs, bc[1])
    else:
        m_hat, v_hat = ms, vs
    den = torch._foreach_sqrt(v_hat)
    torch._foreach_add_(den, opt.epsilon)
    upd = torch._foreach_div(m_hat, den)
    torch._foreach_add_(upd, torch._foreach_mul(ws, wd))
    r1 = torch.stack(torch._foreach_norm([w.float() for w in ws]))
    if opt.lower_bound is not None:
        r1 = r1.clamp_min(opt.lower_bound)
    if opt.upper_bound is not None:
        r1 = r1.clamp_max(opt.upper_bound)
    r2 = torch.stack(torch._foreach_norm([u.float() for u in upd]))
    trust = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    scale = (lr * trust).unbind(0)
    torch._foreach_sub_(ws, torch._foreach_mul(
        [u.to(w.dtype) for u, w in zip(upd, ws)], list(scale)))


_MULTI = {"SGD": _sgd_multi, "LAMB": _lamb_multi}


def multi_update(opt, ws, gs, states, t, lr, lr_mults, wd_mults,
                 finite=None):
    """Update every weight of ``ws`` (and its state in ``states``) in
    place from its gradient in ``gs`` at step ``t`` (1-based; an int or
    a 0-d device tensor) with base learning rate ``lr`` (a float or a
    0-d f32 device tensor) times each weight's ``lr_mults`` entry and
    weight decay ``opt.wd`` times its ``wd_mults`` entry.  ``finite``:
    None, or a 0-d bool tensor — where it is False every weight and
    state is left as it was."""
    fn = _rule(opt, _MULTI)
    if not ws:
        return
    device = ws[0].device
    bc = None
    if type(opt).__name__ == "LAMB" and opt.bias_correction:
        bc = (_bias_correction(opt.beta1, t, device),
              _bias_correction(opt.beta2, t, device))
    groups = {}
    for k, w in enumerate(ws):
        key = (_is_mp(opt, w.dtype), lr_mults[k], wd_mults[k])
        groups.setdefault(key, []).append(k)
    for (mp, lr_mult, wd_mult), idx in groups.items():
        if mp:
            ws_g = [states[k][-1] for k in idx]          # the masters
            gs_g = [gs[k].float() for k in idx]
            st_g = [states[k][:-1] for k in idx]
        else:
            ws_g = [ws[k] for k in idx]
            gs_g = [gs[k] for k in idx]
            st_g = [states[k] for k in idx]
        held = ws_g + [s for st in st_g for s in st]
        old = None if finite is None else [x.clone() for x in held]
        fn(opt, ws_g, gs_g, st_g, bc, lr * lr_mult, opt.wd * wd_mult)
        if old is not None:
            for x, o in zip(held, old):
                torch.where(finite, x, o, out=x)
        if mp:
            torch._foreach_copy_([ws[k] for k in idx], ws_g)


def state_template(opt, weight):
    """Zero state tuple for one weight: SGD's momentum (when used) or
    the Adam family's (m, v), then the f32 master weight for
    half-precision weights."""
    mp = _is_mp(opt, weight.dtype)
    base = weight.detach().float() if mp else weight.detach()
    name = type(opt).__name__
    if name == "SGD":
        s = (torch.zeros_like(base),) if opt.momentum != 0.0 else ()
    elif name in ("Adam", "AdamW", "LAMB"):
        s = (torch.zeros_like(base), torch.zeros_like(base))
    else:
        raise NotImplementedError(name)
    return s + (base.clone(),) if mp else s
