"""Optimizer updates for the training step (the port of
``mxnet_tpu/parallel/functional_opt.py``: SGD, NAG, Adam, AdamW, LAMB,
LARS, RMSProp (plain and centred), AdaGrad and Signum).

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
  per-tensor constants; LARS's trust ratio per tensor from
  ``torch._foreach_norm`` too.  With ``finite`` (a 0-d bool tensor) every
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
def _prep(opt, w, g, wd, decoupled=False):
    g = g * opt.rescale_grad
    if opt.clip_gradient is not None:
        g = g.clamp(-opt.clip_gradient, opt.clip_gradient)
    return g if decoupled else g + wd * w


def _sgd(opt, w, g, state, t, lr, wd):
    g = _prep(opt, w, g, wd)
    if opt.momentum == 0.0:
        w.sub_(lr * g)
        return
    (mom,) = state
    mom.mul_(opt.momentum).sub_(lr * g)
    w.add_(mom)


def _nag(opt, w, g, state, t, lr, wd):
    g = _prep(opt, w, g, wd)
    (mom,) = state
    mom.mul_(opt.momentum).sub_(lr * g)
    w.add_(opt.momentum * mom).sub_(lr * g)


def _adam(opt, w, g, state, t, lr, wd, decoupled=False):
    g = _prep(opt, w, g, wd, decoupled)
    m, v = state
    m.mul_(opt.beta1).add_((1 - opt.beta1) * g)
    v.mul_(opt.beta2).add_((1 - opt.beta2) * g * g)
    lr_t = lr * torch.sqrt(_bias_correction(opt.beta2, t, m.device)) \
        / _bias_correction(opt.beta1, t, m.device)
    upd = lr_t * m / (torch.sqrt(v) + opt.epsilon)
    if decoupled:
        upd = upd + lr * wd * w
    w.sub_(upd)


def _adamw(opt, w, g, state, t, lr, wd):
    _adam(opt, w, g, state, t, lr, wd, decoupled=True)


def _lars(opt, w, g, state, t, lr, wd):
    g = g * opt.rescale_grad
    if opt.clip_gradient is not None:
        g = g.clamp(-opt.clip_gradient, opt.clip_gradient)
    w_norm = torch.linalg.vector_norm(w.float())
    g_norm = torch.linalg.vector_norm(g.float())
    trust = torch.where((w_norm > 0) & (g_norm > 0),
                        opt.eta * w_norm / (g_norm + wd * w_norm
                                            + opt.epsilon),
                        torch.ones_like(w_norm))
    g = g + wd * w
    if state:
        (mom,) = state
        mom.mul_(opt.momentum).add_(trust * lr * g)
        w.sub_(mom)
    else:
        w.sub_(trust * lr * g)


def _rmsprop(opt, w, g, state, t, lr, wd):
    g = _prep(opt, w, g, wd)
    n = state[0]
    n.mul_(opt.rho).add_((1 - opt.rho) * g * g)
    if opt.centered:
        _, mg, delta = state
        mg.mul_(opt.rho).add_((1 - opt.rho) * g)
        delta.mul_(opt.momentum).sub_(
            lr * g / torch.sqrt(n - mg * mg + opt.epsilon))
        w.add_(delta)
    else:
        w.sub_(lr * g / (torch.sqrt(n) + opt.epsilon))


def _adagrad(opt, w, g, state, t, lr, wd):
    g = _prep(opt, w, g, wd)
    (hist,) = state
    hist.add_(g * g)
    w.sub_(lr * g / (torch.sqrt(hist) + opt.float_stable_eps))


def _signum(opt, w, g, state, t, lr, wd):
    g = _prep(opt, w, g, wd)
    decay = 1.0 - lr * opt.wd_lh
    if state:
        (mom,) = state
        mom.mul_(opt.momentum).sub_((1 - opt.momentum) * g)
        w.mul_(decay).add_(lr * torch.sign(mom))
    else:
        w.mul_(decay).sub_(lr * torch.sign(g))


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


_DISPATCH = {"SGD": _sgd, "NAG": _nag, "Adam": _adam, "AdamW": _adamw,
             "LAMB": _lamb, "LARS": _lars, "RMSProp": _rmsprop,
             "AdaGrad": _adagrad, "Signum": _signum}


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


def _prep_multi(opt, ws, gs, wd, decoupled=False):
    gs = _scaled_multi(opt, gs)
    if not decoupled:
        torch._foreach_add_(gs, torch._foreach_mul(ws, wd))
    return gs


def _sgd_multi(opt, ws, gs, states, bc, lr, wd):
    gs = _prep_multi(opt, ws, gs, wd)
    step = torch._foreach_mul(gs, lr)
    if opt.momentum == 0.0:
        torch._foreach_sub_(ws, step)
        return
    moms = [s[0] for s in states]
    torch._foreach_mul_(moms, opt.momentum)
    torch._foreach_sub_(moms, step)
    torch._foreach_add_(ws, moms)


def _nag_multi(opt, ws, gs, states, bc, lr, wd):
    gs = _prep_multi(opt, ws, gs, wd)
    step = torch._foreach_mul(gs, lr)
    moms = [s[0] for s in states]
    torch._foreach_mul_(moms, opt.momentum)
    torch._foreach_sub_(moms, step)
    torch._foreach_add_(ws, torch._foreach_mul(moms, opt.momentum))
    torch._foreach_sub_(ws, step)


def _adam_multi(opt, ws, gs, states, bc, lr, wd, decoupled=False):
    gs = _prep_multi(opt, ws, gs, wd, decoupled)
    ms, vs = [s[0] for s in states], [s[1] for s in states]
    torch._foreach_mul_(ms, opt.beta1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1 - opt.beta1))
    torch._foreach_mul_(vs, opt.beta2)
    g2 = torch._foreach_mul(gs, 1 - opt.beta2)
    torch._foreach_mul_(g2, gs)
    torch._foreach_add_(vs, g2)
    lr_t = lr * torch.sqrt(bc[1]) / bc[0]
    den = torch._foreach_sqrt(vs)
    torch._foreach_add_(den, opt.epsilon)
    upd = torch._foreach_mul(ms, lr_t)
    torch._foreach_div_(upd, den)
    if decoupled:
        torch._foreach_add_(upd, torch._foreach_mul(ws, lr * wd))
    torch._foreach_sub_(ws, upd)


def _adamw_multi(opt, ws, gs, states, bc, lr, wd):
    _adam_multi(opt, ws, gs, states, bc, lr, wd, decoupled=True)


def _lars_multi(opt, ws, gs, states, bc, lr, wd):
    gs = _scaled_multi(opt, gs)
    wn = torch.stack(torch._foreach_norm([w.float() for w in ws]))
    gn = torch.stack(torch._foreach_norm([g.float() for g in gs]))
    trust = torch.where((wn > 0) & (gn > 0),
                        opt.eta * wn / (gn + wd * wn + opt.epsilon),
                        torch.ones_like(wn))
    torch._foreach_add_(gs, torch._foreach_mul(ws, wd))
    step = torch._foreach_mul(gs, list((trust * lr).unbind(0)))
    if states[0]:
        moms = [s[0] for s in states]
        torch._foreach_mul_(moms, opt.momentum)
        torch._foreach_add_(moms, step)
        torch._foreach_sub_(ws, moms)
    else:
        torch._foreach_sub_(ws, step)


def _rmsprop_multi(opt, ws, gs, states, bc, lr, wd):
    gs = _prep_multi(opt, ws, gs, wd)
    ns = [s[0] for s in states]
    torch._foreach_mul_(ns, opt.rho)
    g2 = torch._foreach_mul(gs, 1 - opt.rho)
    torch._foreach_mul_(g2, gs)
    torch._foreach_add_(ns, g2)
    step = torch._foreach_mul(gs, lr)
    if opt.centered:
        mgs, deltas = [s[1] for s in states], [s[2] for s in states]
        torch._foreach_mul_(mgs, opt.rho)
        torch._foreach_add_(mgs, torch._foreach_mul(gs, 1 - opt.rho))
        den = torch._foreach_sub(ns, torch._foreach_mul(mgs, mgs))
        torch._foreach_add_(den, opt.epsilon)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(step, den)
        torch._foreach_mul_(deltas, opt.momentum)
        torch._foreach_sub_(deltas, step)
        torch._foreach_add_(ws, deltas)
    else:
        den = torch._foreach_sqrt(ns)
        torch._foreach_add_(den, opt.epsilon)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(ws, step)


def _adagrad_multi(opt, ws, gs, states, bc, lr, wd):
    gs = _prep_multi(opt, ws, gs, wd)
    hists = [s[0] for s in states]
    torch._foreach_add_(hists, torch._foreach_mul(gs, gs))
    den = torch._foreach_sqrt(hists)
    torch._foreach_add_(den, opt.float_stable_eps)
    step = torch._foreach_mul(gs, lr)
    torch._foreach_div_(step, den)
    torch._foreach_sub_(ws, step)


def _signum_multi(opt, ws, gs, states, bc, lr, wd):
    gs = _prep_multi(opt, ws, gs, wd)
    torch._foreach_mul_(ws, 1.0 - lr * opt.wd_lh)
    if states[0]:
        moms = [s[0] for s in states]
        torch._foreach_mul_(moms, opt.momentum)
        torch._foreach_sub_(moms, torch._foreach_mul(gs, 1 - opt.momentum))
        step = torch._foreach_sign(moms)
        torch._foreach_mul_(step, lr)
        torch._foreach_add_(ws, step)
    else:
        step = torch._foreach_sign(gs)
        torch._foreach_mul_(step, lr)
        torch._foreach_sub_(ws, step)


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


_MULTI = {"SGD": _sgd_multi, "NAG": _nag_multi, "Adam": _adam_multi,
          "AdamW": _adamw_multi, "LAMB": _lamb_multi, "LARS": _lars_multi,
          "RMSProp": _rmsprop_multi, "AdaGrad": _adagrad_multi,
          "Signum": _signum_multi}


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
    name = type(opt).__name__
    if name in ("Adam", "AdamW") or (name == "LAMB" and
                                     opt.bias_correction):
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
    """Zero state tuple for one weight, in the JAX step's layout: the
    momentum of SGD, LARS and Signum (when used) and of NAG; the Adam
    family's (m, v); RMSProp's n (and, centred, mean g and delta);
    AdaGrad's history — then the f32 master weight for half-precision
    weights."""
    mp = _is_mp(opt, weight.dtype)
    base = weight.detach().float() if mp else weight.detach()
    name = type(opt).__name__
    n = {"NAG": 1, "Adam": 2, "AdamW": 2, "LAMB": 2, "AdaGrad": 1,
         "RMSProp": 3 if getattr(opt, "centered", False) else 1}.get(name)
    if name in ("SGD", "LARS", "Signum"):
        n = 1 if opt.momentum != 0.0 else 0
    if n is None:
        raise NotImplementedError(
            f"the port's train step has no update rule for {name} "
            f"(ported: {sorted(_MULTI)})")
    s = tuple(torch.zeros_like(base) for _ in range(n))
    return s + (base.clone(),) if mp else s
